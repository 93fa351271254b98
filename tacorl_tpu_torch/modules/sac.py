"""Online SAC with the env stepped inside the train step (port of
tacorl_tpu/modules/sac.py; reference: modules/sac/sac_lightning.py:32-468,
sac_agent.py:12-83).

The update is the CQL update without the conservative penalty
(``use_conservative = False``, ``modules/cql.py``); SAC defaults
``with_lagrange`` to False, so its state has no ``log_alpha_prime``. The
online part runs on the host around the update: one env step with the
parameters as they were before the update (``play_step``), the replay
buffer, the warm-start fill (``populate``, in parallel over a
``ThreadedVecEnv`` with ``num_parallel_envs > 1``) and the buffer's snapshot
beside each checkpoint (``save_checkpoint_extras``).

Fill strategies: ``stochastic`` and ``deterministic`` act with the policy
(the observation augmented with ``train=True``, as the JAX play step does),
``random`` draws uniform actions in [-1, 1] from numpy's
``default_rng(seed)`` (bit-equal to the JAX package's; the gripper too is
continuous), ``zeros`` acts with zeros.

Randomness enters as data: the train step's ``draws["play"]`` (optional)
holds the play step's draws, ``{"aug": <the DeviceTransforms draws, nested
as the observation>, "action": {"eps", "gumbel_u"}}``, the JAX play key's
(``jax.random.split(_play_key)``); what is missing comes from the module's
generator. The env needs the action on the host, so each play step makes
the host wait for the device once, for one copy into a page-locked buffer.

Data-parallel (W ranks): every rank plays the same seeded env stream, so
the play step's draws are whole on every rank (not a rank's rows), every
rank keeps the same buffer, and the loader gives each rank its rows of one
global sample (``data/online_datamodule.py``). Rank 0 alone writes the
buffer's files; every rank has loaded them before any rank writes.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from tacorl_tpu_torch.config import instantiate
from tacorl_tpu_torch.data.replay_buffer import ReplayBuffer
from tacorl_tpu_torch.evaluation.agents import batch_of_one
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.parallel.mesh import BatchShard, barrier, rank, sharded_draws

__all__ = ["SACModule"]


class SACModule(CQLModule):
    name = "sac"
    use_conservative = False
    # the train step plays an env step on the host: the trainer runs it one
    # step at a time under any steps_per_call, as the JAX trainer does
    supports_scan = False

    def build(self) -> None:
        cfg = self.cfg
        cfg.setdefault("with_lagrange", False)
        super().build()
        self.replay_buffer = ReplayBuffer(int(cfg.get("replay_buffer_size", 5_000_000)))
        self.replay_buffer_path = cfg.get("replay_buffer_path")
        self.warm_start_steps = int(cfg.get("warm_start_steps", 1000))
        self.fill_strategy = cfg.get("fill_strategy", "random")
        self.populate_replay_buffer = bool(cfg.get("populate_replay_buffer", True))
        self.env = None
        if cfg.get("env"):
            self.env = instantiate(cfg["env"]) if isinstance(cfg["env"], dict) else cfg["env"]
        self._observation = None
        self._episode_return = 0.0
        self._episode_length = 0
        self.episodes_returns: deque = deque(maxlen=10)
        self.episodes_lengths: deque = deque(maxlen=10)
        # the episode cadence the rollout callback probes
        # (callbacks/rollout.py: episode_number / episode_done)
        self.episode_number = 0
        self.episode_done = False
        self.accuracies: deque = deque(maxlen=10)
        self._rng = np.random.default_rng(int(cfg.get("seed", 0)))
        self._host_buffer = None

    def attach_env(self, env) -> None:
        self.env = env

    # -- env interaction (sac_agent.py:38-83) ------------------------------------

    def _host(self, action: torch.Tensor) -> np.ndarray:
        """The action of a batch of 1 on the host: on a card one copy into a
        page-locked buffer and one wait for the stream."""
        if self.device.type != "cuda":
            return action[0].numpy().copy()
        if self._host_buffer is None:
            self._host_buffer = torch.empty(action.shape[1:], dtype=action.dtype, pin_memory=True)
        self._host_buffer.copy_(action[0], non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._host_buffer.numpy().copy()

    @torch.no_grad()
    def get_action(
        self, net, observation, strategy: str = "stochastic", draws: Optional[Dict] = None
    ) -> np.ndarray:
        """One action for a single-env observation; ``net`` is the state's
        ``CQLNet`` (unused by ``random`` and ``zeros``)."""
        if strategy in ("stochastic", "deterministic"):
            draws = draws or {}
            net.eval()
            obs_t = self.transforms(
                batch_of_one(observation, self.device), train=True, draws=draws.get("aug"),
                generator=self.generator,
            )
            action, _ = net.actor.get_actions(
                obs_t, draws.get("action"), deterministic=strategy == "deterministic",
                generator=self.generator,
            )
            return self._host(action)
        if strategy == "random":
            return self._rng.uniform(-1.0, 1.0, self.action_dim).astype(np.float32)
        if strategy == "zeros":
            return np.zeros(self.action_dim, dtype=np.float32)
        raise ValueError(f"unknown strategy {strategy!r}")

    def play_step(self, net, strategy: str = "stochastic", draws: Optional[Dict] = None) -> Dict[str, Any]:
        """One env step and its transition appended to the buffer
        (sac_agent.py:38-59)."""
        if self.env is None:
            raise RuntimeError("attach_env() before online training")
        if self._observation is None:
            self._observation = self.env.reset()
        action = self.get_action(net, self._observation, strategy, draws)
        next_observation, reward, done, info = self.env.step(action)
        self.replay_buffer.add_transition(
            self._observation, action, next_observation, float(reward), bool(done)
        )
        self._observation = next_observation
        self._episode_return += float(reward)
        self._episode_length += 1
        out = {"reward": float(reward), "done": bool(done)}
        self.episode_done = bool(done)
        if done:
            self.episode_number += 1
            self.accuracies.append(int(bool(info.get("success", False))))
            self.episodes_returns.append(self._episode_return)
            self.episodes_lengths.append(self._episode_length)
            out.update(
                episode_return=self._episode_return,
                episode_length=self._episode_length,
                success=bool(info.get("success", False)),
            )
            self._episode_return, self._episode_length = 0.0, 0
            self._observation = self.env.reset()
        return out

    def populate(self, net, steps: Optional[int] = None) -> None:
        """The warm-start fill (sac_lightning.py:352-376): load the buffer
        from ``replay_buffer_path`` if it holds transitions, else (with
        ``populate_replay_buffer`` and an empty buffer) take ``steps``
        (``warm_start_steps``) env steps, in parallel with
        ``num_parallel_envs > 1`` and an env config, and save them there.
        Without a net only ``random`` and ``zeros`` can act: any other
        strategy falls back to ``random``."""
        loaded = self.replay_buffer.load(self.replay_buffer_path)
        barrier()  # every rank has read the files before rank 0 writes
        if loaded:
            return
        if not self.populate_replay_buffer or len(self.replay_buffer) > 0:
            return
        strategy = self.fill_strategy
        if net is None and strategy not in ("random", "zeros"):
            strategy = "random"
        steps = steps if steps is not None else self.warm_start_steps
        n_parallel = int(self.cfg.get("num_parallel_envs", 1))
        if n_parallel > 1 and self.cfg.get("env"):
            self._populate_parallel(net, steps, strategy, n_parallel)
        else:
            for _ in range(steps):
                self.play_step(net, strategy)
        if rank() == 0:
            self.replay_buffer.save(self.replay_buffer_path)

    def _populate_parallel(self, net, steps, strategy, n_parallel) -> None:
        """``n_parallel`` envs from the env config stepped together until
        ``steps`` transitions are in (the last round may add up to
        ``n_parallel - 1`` more); a done env's transition ends at its
        terminal observation."""
        from tacorl_tpu_torch.envs.vec_env import ThreadedVecEnv

        env_cfg = self.cfg["env"]
        vec = ThreadedVecEnv([lambda: instantiate(env_cfg) for _ in range(n_parallel)])
        observations = vec.reset()
        filled = 0
        while filled < steps:
            actions = [self.get_action(net, obs, strategy) for obs in observations]
            next_obs, rewards, dones, infos = vec.step(actions)
            for i, done in enumerate(dones):
                terminal = infos[i]["terminal_observation"] if done else next_obs[i]
                self.replay_buffer.add_transition(
                    observations[i], actions[i], terminal, float(rewards[i]), bool(done)
                )
                filled += 1
            observations = next_obs
        vec.close()

    # -- training: the env step, then the update ----------------------------------

    def make_train_step(self):
        inner = super().make_train_step()

        def train_step(state, batch, scalars=None, *, draws=None):
            """One env step with the parameters as they were before the
            update, then the update in place on ``state``; ``draws`` as in
            ``modules/cql.py``, plus ``draws["play"]``."""
            draws = draws or {}
            # the env stream is every rank's: its draws are whole
            with record_function("sac/play_step"), sharded_draws(BatchShard()):
                self.play_step(state.net, "stochastic", draws.get("play"))
            return inner(state, batch, scalars, draws=draws)

        return train_step

    def save_checkpoint_extras(self) -> None:
        """The transitions added since the last snapshot, to
        ``replay_buffer_path`` (sac_lightning.py:446-451), by rank 0."""
        if rank() == 0:
            self.replay_buffer.save(self.replay_buffer_path)
