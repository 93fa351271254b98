"""Policy agents (port of tacorl_tpu/evaluation/agents.py): the bridge
between trained modules and host-side env stepping.

Each agent takes ``(module, state)`` and acts with ``state.net`` in eval
mode under ``torch.inference_mode()``. Observations arrive as single-env
numpy dicts and go to the module's device as a batch of 1 (through pinned
memory on a card, so the upload does not make the host wait); the decoder
carry stays on the device, opaque, and is cleared on replan. An agent
returns a numpy action: that one device-to-host copy per env step is the
only host wait of the loop.

Randomness: every call takes ``draws`` (explicit random inputs, as the
module functions take them) and the rollout manager's ``generator``, from
which whatever is missing is drawn. With CEM refinement (``use_cem``) the
flat and TACO-RL agents take ``draws["cem_eps"]``, the CEM's standard
normals (``modules/cem.py``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from tacorl_tpu_torch.modules.cem import cem_optimize
from tacorl_tpu_torch.utils import resolve_device

__all__ = [
    "FlatPolicyAgent",
    "LatentPlanAgent",
    "TACORLAgent",
    "LatentPlanD4RLAgent",
    "TACORLD4RLAgent",
    "RILAgent",
    "OracleSubgoalAgent",
    "ScriptedExpertAgent",
    "make_agent",
    "make_d4rl_agent",
]


def batch_of_one(obs: Any, device: torch.device) -> Any:
    """A numpy observation (dict) as a batch of 1 on ``device``, through
    page-locked memory on a card, so the upload does not make the host
    wait."""
    if isinstance(obs, dict):
        return {k: batch_of_one(v, device) for k, v in obs.items()}
    x = torch.from_numpy(np.ascontiguousarray(obs)[None])
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x


def make_agent(module, state, use_cem: bool = False, cem_cfg: dict = None):
    """Agent and rollout-manager class by module family."""
    from tacorl_tpu_torch.evaluation import rollout_manager as rm

    name = module.name
    if name in ("cql", "sac", "cql_online"):
        return FlatPolicyAgent(module, state, use_cem, cem_cfg), rm.RLRollout
    if name == "tacorl":
        return TACORLAgent(module, state, use_cem, cem_cfg), rm.TACORLRollout
    if name == "play_lmp":
        return LatentPlanAgent(module, state), rm.LatentPlanRollout
    if name == "ril":
        return RILAgent(module, state), rm.RILRollout
    raise ValueError(f"no agent mapping for module {name!r}")


class _ModuleAgent:
    """Shared plumbing: the net in eval mode with contiguous RNN weights,
    uploads of observations and draws, the action's download."""

    def __init__(self, module, state):
        self.module = module
        self.device = resolve_device(module.device)
        self.net = state.net
        self.net.eval()
        # a deep-copied or moved nn.RNN holds its weights apart; cuDNN would
        # copy them into one buffer on every step. Each call repacks the
        # weights into a new buffer, which a graphed train step follows
        # (core/graphs.py: StepGraph compares the addresses)
        for m in self.net.modules():
            if isinstance(m, nn.RNNBase):
                m.flatten_parameters()
        self.carry = None

    def reset(self) -> None:
        self.net.eval()
        self.carry = None

    def _batched(self, obs: Any) -> Any:
        return batch_of_one(obs, self.device)

    def _draws(self, draws: Optional[Dict]) -> Optional[Dict]:
        if draws is None:
            return None
        return {k: torch.as_tensor(v).to(self.device) for k, v in draws.items()}

    @staticmethod
    def _action(action: torch.Tensor) -> np.ndarray:
        return action[0].cpu().numpy()


class _CEMAgent(_ModuleAgent):
    """Optional CEM refinement of a deterministic output (an action, or a
    latent plan) against min(Q1, Q2) of the module's critics
    (``modules/cem.py``); ``cem_cfg`` holds its ``num_iterations``,
    ``population_size``, ``num_elites`` and ``init_std``."""

    def __init__(self, module, state, use_cem: bool = False, cem_cfg: dict = None):
        super().__init__(module, state)
        self.use_cem = use_cem
        self.cem_cfg = dict(cem_cfg or {})

    def _refine(self, batched, initial, draws, generator, discrete_gripper=False):
        """The CEM mean seeded by ``initial`` (B, A), each critic's
        embedding of the observation computed once and tiled over the
        population."""
        net = self.net
        obs_t = self.module.transforms(batched, train=False)
        emb1 = net.q1.get_emb_representation(obs_t)
        emb2 = net.q2.get_emb_representation(obs_t)

        def q_min(actions):
            reps = actions.shape[0] // emb1.shape[0]
            q1 = net.q1.critic(emb1.repeat(reps, 1), actions)
            q2 = net.q2.critic(emb2.repeat(reps, 1), actions)
            return torch.minimum(q1, q2)

        return cem_optimize(
            q_min, initial, discrete_gripper=discrete_gripper,
            eps=(draws or {}).get("cem_eps"), generator=generator, **self.cem_cfg,
        )


class FlatPolicyAgent(_CEMAgent):
    """Deterministic flat policy (reference RLRollout, rollout_manager.py:
    81-180), optionally CEM-refined against min(Q1, Q2); a discrete gripper
    is snapped to +-1 in every population."""

    def __init__(self, module, state, use_cem: bool = False, cem_cfg: dict = None):
        super().__init__(module, state, use_cem, cem_cfg)
        self._policy = module.make_policy_fn(deterministic=True)

    @torch.inference_mode()
    def act(self, obs: Dict, draws=None, generator=None) -> np.ndarray:
        batched, draws = self._batched(obs), self._draws(draws)
        action = self._policy(self.net, batched, draws, generator)
        if self.use_cem:
            action = self._refine(
                batched, action, draws, generator, self.net.actor.actor.discrete_gripper
            )
        return self._action(action)


class LatentPlanAgent(_ModuleAgent):
    """Play-LMP rollout policy (LatentPlanRollout, rollout_manager.py:
    183-307): sample a plan from the proposal prior (``draws["eps"]``, the
    standard normal), stream the decoder for plan_duration steps
    (``draws["u_mix"]``, ``draws["u"]``), replan."""

    @torch.inference_mode()
    def propose_plan(self, obs: Dict, draws=None, generator=None) -> torch.Tensor:
        transforms = self.module.transforms
        obs_t = transforms(self._batched(obs["observation"]), train=False)
        goal_t = transforms(self._batched(obs["goal"]), train=False)
        self.carry = None  # clear_hidden_state (:250)
        eps = (self._draws(draws) or {}).get("eps")
        return self.net.propose_plan(obs_t, goal_t).sample(generator, eps=eps)

    @torch.inference_mode()
    def decode_step(self, obs: Dict, plan, draws=None, generator=None) -> np.ndarray:
        obs_t = self.module.transforms(self._batched(obs["observation"]), train=False)
        action, self.carry = self.net.decode_action(
            plan, obs_t, self.carry, draws=self._draws(draws), generator=generator
        )
        return self._action(action)


class TACORLAgent(_CEMAgent):
    """TACO-RL rollout policy (rollout_manager.py:310-431): the RL actor
    emits a deterministic latent plan, optionally CEM-refined against the
    latent-plan critics (clipped to [-1, 1], as the JAX CEM clips it); the
    LMP decoder streams actions."""

    def __init__(self, module, state, use_cem: bool = False, cem_cfg: dict = None):
        super().__init__(module, state, use_cem, cem_cfg)
        self._propose, self._decode = module.make_plan_and_decode_fns()

    @torch.inference_mode()
    def propose_plan(self, obs: Dict, draws=None, generator=None) -> torch.Tensor:
        batched, draws = self._batched(obs), self._draws(draws)
        plan = self._propose(self.net, batched, draws, generator)
        if self.use_cem:
            plan = self._refine(batched, plan, draws, generator)
        self.carry = None
        return plan

    @torch.inference_mode()
    def decode_step(self, obs: Dict, plan, draws=None, generator=None) -> np.ndarray:
        action, self.carry = self._decode(
            self.net, plan, self._batched(obs["observation"]), self.carry,
            self._draws(draws), generator,
        )
        return self._action(action)


class LatentPlanD4RLAgent(_ModuleAgent):
    """State-based Play-LMP rollout policy (rollout_manager_d4rl.py:
    107-170): a plan sampled from the prior given (obs, goal xy)
    (``draws["eps"]``), the decoder streamed over the observation vectors
    (``draws["u_mix"]``, ``draws["u"]``)."""

    @torch.inference_mode()
    def propose_plan_d4rl(self, obs, goal_xy, draws=None, generator=None) -> torch.Tensor:
        self.carry = None
        eps = (self._draws(draws) or {}).get("eps")
        dist = self.net.propose_plan(self._vector(obs), self._vector(goal_xy))
        return dist.sample(generator, eps=eps)

    @torch.inference_mode()
    def decode_step(self, obs: Dict, plan, draws=None, generator=None) -> np.ndarray:
        action, self.carry = self.net.decode_action(
            plan, self._vector(obs["observation"]), self.carry, self._draws(draws), generator
        )
        return self._action(action)

    def _vector(self, x) -> torch.Tensor:
        return self._batched(np.asarray(x, dtype=np.float32))


class TACORLD4RLAgent(LatentPlanD4RLAgent):
    """State-based TACO-RL rollout policy (rollout_manager_d4rl.py:173-250):
    the RL actor's deterministic plan from concat(obs, goal xy), the
    (finetuned) decoder streamed over the observation vectors."""

    def __init__(self, module, state):
        super().__init__(module, state)
        self._propose, self._decode = module.make_plan_and_decode_fns()

    @torch.inference_mode()
    def propose_plan_d4rl(self, obs, goal_xy, draws=None, generator=None) -> torch.Tensor:
        self.carry = None
        return self._propose(
            self.net, self._vector(np.concatenate([obs, goal_xy])), self._draws(draws), generator
        )

    @torch.inference_mode()
    def decode_step(self, obs: Dict, plan, draws=None, generator=None) -> np.ndarray:
        action, self.carry = self._decode(
            self.net, plan, self._vector(obs["observation"]), self.carry, self._draws(draws), generator
        )
        return self._action(action)


def make_d4rl_agent(module, state, plan_duration: int = 15, draw_source=None):
    """Agent and rollout manager (an instance, seed 0, as the JAX one) for a
    D4RL module: the hierarchical agents for ``play_lmp_d4rl`` and
    ``tacorl_d4rl``, else the flat policy on concat(obs, goal)
    (``scripts/evaluate_d4rl.py:28-43``). ``draw_source`` goes to the
    manager."""
    from tacorl_tpu_torch.evaluation import rollout_manager_d4rl as rm

    if module.name == "play_lmp_d4rl":
        return LatentPlanD4RLAgent(module, state), rm.LatentPlanRolloutD4RL(plan_duration, draw_source=draw_source)
    if module.name == "tacorl_d4rl":
        return TACORLD4RLAgent(module, state), rm.TACORLRolloutD4RL(plan_duration, draw_source=draw_source)
    return FlatPolicyAgent(module, state), rm.RLRolloutD4RL(draw_source=draw_source)


class RILAgent(_ModuleAgent):
    """Relay-imitation-learning rollout policy (rollout_manager.py:
    434-557): the high level emits a deterministic latent subgoal at each
    replan, the low level acts on it at every step. Neither draws."""

    def __init__(self, module, state):
        super().__init__(module, state)
        self._high, self._low = module.make_policy_fns()

    @torch.inference_mode()
    def propose_plan(self, obs: Dict, draws=None, generator=None) -> torch.Tensor:
        return self._high(
            self.net, self._batched(obs["observation"]), self._batched(obs["goal"])
        )

    @torch.inference_mode()
    def decode_step(self, obs: Dict, subgoal, draws=None, generator=None) -> np.ndarray:
        return self._action(self._low(self.net, self._batched(obs["observation"]), subgoal))


class OracleSubgoalAgent(RILAgent):
    """RIL low-level probe: a ground-truth high level for the hierarchical
    rollout, which isolates the low level from the learned high level.

    At every replan a deep copy of the live env (its random state copied,
    not shared) is rolled ``lookahead`` steps forward with the scripted
    expert, stopping early on success, and the reached state is embedded
    through the module's own goal path (``RILNet.encode_goal``, the
    embedding training used for ``low_level_goal``). The live env is left
    as it was. Since the oracle replans from the policy's current state, its
    subgoals stay reachable after the low level drifts."""

    def __init__(self, module, state, env, lookahead: int = 12, gain: float = 1.0):
        super().__init__(module, state)
        self.env = env
        self.lookahead = lookahead
        self.gain = gain

    @torch.inference_mode()
    def propose_plan(self, obs: Dict, draws=None, generator=None) -> torch.Tensor:
        sim = copy.deepcopy(self.env)
        for _ in range(self.lookahead):
            if sim._success():
                break
            sim.step(sim.expert_action(gain=self.gain))
        goal = self._batched(sim._obs_dict(self.module.ll_mods))
        return self.net.encode_goal(self.module.transforms(goal, train=False))


class ScriptedExpertAgent:
    """Protocol-ceiling probe: drives the fake env's scripted expert through
    the same rollout managers and evaluation protocols learned policies use,
    so it measures what the protocol itself permits (compounding resets,
    goal diffing, step budgets) independent of any learned policy.

    Host-side only: ``act`` ignores the draws and asks the env for its
    expert action, so it plugs into ``RLRollout`` unchanged."""

    def __init__(self, env, gain: float = 1.0):
        self.env = env
        self.gain = gain

    def reset(self) -> None:
        pass

    def act(self, obs: Dict, draws=None, generator=None) -> np.ndarray:
        return self.env.expert_action(gain=self.gain)
