"""Rollout managers: drive one agent through one episode of a host-side env
(port of tacorl_tpu/evaluation/rollout_manager.py; reference:
evaluation/rollout_manager.py:13-557).

Four manager shapes, matching the reference:
  * RLRollout          — flat policy, action per env step
  * LatentPlanRollout  — sample plan from prior, stream decoder for
                         plan_duration steps, replan
  * TACORLRollout      — RL actor emits the plan, decoder streams actions
  * RILRollout         — high-level subgoal, low-level goal-conditioned policy

All managers return {"episode_length", "episode_return", "success"
[, "successful_tasks"]}.

Randomness: the JAX manager splits one key per agent call. This one holds a
``torch.Generator`` seeded from ``seed`` on the agent's device and passes it
to every agent call (``agent.act(obs, draws, generator)``,
``agent.propose_plan(obs, draws, generator)``, ``agent.decode_step(obs, plan,
draws, generator)``). An optional ``draw_source`` is called once per agent
call, in the JAX manager's order, with the call's kind ("act", "propose" or
"decode"); its result is that call's ``draws``, which take the place of the
generator's (a parity test builds it from the JAX key chain).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from tacorl_tpu_torch.evaluation.video import VideoRecorder

__all__ = ["RLRollout", "LatentPlanRollout", "TACORLRollout", "RILRollout"]

DrawSource = Callable[[str], Optional[Dict]]


def _extract_img(obs: Dict) -> Optional[np.ndarray]:
    """First available image by modality priority (utils/misc.py:163-172)."""
    if isinstance(obs, dict) and "observation" in obs:
        return _extract_img(obs["observation"])
    for m in ("rgb_static", "depth_static", "rgb_gripper", "depth_gripper"):
        if isinstance(obs, dict) and m in obs:
            return obs[m]
    return None


def _device_of(agent) -> torch.device:
    device = torch.device(getattr(agent, "device", "cpu"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class _BaseRolloutManager:
    def __init__(self, seed: int = 0, draw_source: Optional[DrawSource] = None):
        self.seed = seed
        self.draw_source = draw_source
        self._generator: Optional[torch.Generator] = None

    def _rng(self, agent) -> torch.Generator:
        """The manager's generator on the agent's device, seeded once."""
        device = _device_of(agent)
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device).manual_seed(self.seed)
        return self._generator

    def _next_draws(self, call: str) -> Optional[Dict]:
        return None if self.draw_source is None else self.draw_source(call)

    def episode_rollout(self, agent, env, reset_info=None, **kwargs) -> Dict:
        raise NotImplementedError

    # -- shared episode bookkeeping -------------------------------------------

    def _start_recording(self, observation, recorder, task):
        if recorder is not None:
            recorder.new_video(_extract_img(observation), task=task)

    def _record(self, observation, recorder):
        if recorder is not None:
            recorder.update(_extract_img(observation))

    def _finish(
        self, observation, recorder, video_path, step, episode_return, info
    ) -> Dict:
        if recorder is not None:
            if isinstance(observation, dict) and observation.get("goal"):
                recorder.add_goal_thumbnail(_extract_img(observation["goal"]))
            if video_path is not None:
                recorder.save(video_path)
        out = {
            "episode_length": step,
            "episode_return": episode_return,
            "success": bool(info.get("success", False)),
        }
        if "successful_tasks" in info:
            out["successful_tasks"] = info["successful_tasks"]
        return out


class RLRollout(_BaseRolloutManager):
    def episode_rollout(
        self,
        agent,
        env,
        reset_info: Optional[dict] = None,
        recorder: Optional[VideoRecorder] = None,
        video_path=None,
        task: Optional[str] = None,
    ) -> Dict:
        agent.reset()
        gen = self._rng(agent)
        observation = env.reset(**(reset_info or {}))
        self._start_recording(observation, recorder, task)
        episode_return, info = 0.0, {}
        for step in range(1, env.max_episode_steps + 1):
            action = agent.act(observation, self._next_draws("act"), gen)
            observation, reward, done, info = env.step(action)
            episode_return += reward
            self._record(observation, recorder)
            if done:
                break
        return self._finish(
            observation, recorder, video_path, step, episode_return, info
        )


class _PlanDecodeRollout(_BaseRolloutManager):
    """Shared replanning loop: propose a plan every plan_duration env steps,
    stream the decoder between replans."""

    def __init__(
        self, plan_duration: int = 16, seed: int = 0, draw_source: Optional[DrawSource] = None
    ):
        super().__init__(seed, draw_source)
        self.plan_duration = plan_duration

    def episode_rollout(
        self,
        agent,
        env,
        reset_info: Optional[dict] = None,
        recorder: Optional[VideoRecorder] = None,
        video_path=None,
        task: Optional[str] = None,
    ) -> Dict:
        agent.reset()
        gen = self._rng(agent)
        observation = env.reset(**(reset_info or {}))
        self._start_recording(observation, recorder, task)
        episode_return, info = 0.0, {}
        step, done = 0, False
        while not done and step < env.max_episode_steps:
            plan = agent.propose_plan(observation, self._next_draws("propose"), gen)
            for _ in range(self.plan_duration):
                action = agent.decode_step(
                    observation, plan, self._next_draws("decode"), gen
                )
                observation, reward, done, info = env.step(action)
                episode_return += reward
                step += 1
                self._record(observation, recorder)
                if done or step >= env.max_episode_steps:
                    break
        return self._finish(
            observation, recorder, video_path, step, episode_return, info
        )


class LatentPlanRollout(_PlanDecodeRollout):
    """Play-LMP rollout (rollout_manager.py:183-307). The replanning loop is
    the same for every manager shape upstream; the behaviour differences
    live in the agent: LMP samples the plan stochastically from the proposal
    prior and clears the decoder's hidden state on replan (see
    LatentPlanAgent.propose_plan)."""


class TACORLRollout(_PlanDecodeRollout):
    """TACO-RL rollout (rollout_manager.py:310-431): the actor emits the plan
    deterministically; the decoder carry is cleared on replan (see
    TACORLAgent)."""


class RILRollout(_PlanDecodeRollout):
    """Relay-IL rollout (rollout_manager.py:434-557): the subgoal renews on
    the plan_duration cadence; the high level is deterministic and the low
    level a stateless per-step policy, with no carry to clear (see
    RILAgent and OracleSubgoalAgent)."""
