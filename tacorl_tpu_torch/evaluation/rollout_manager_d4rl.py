"""D4RL rollout managers: the three policy shapes over state vectors, with
the normalized score in the rollout info (port of
tacorl_tpu/evaluation/rollout_manager_d4rl.py; reference:
evaluation/rollout_manager_d4rl.py:8-250).

All managers return {"episode_length", "episode_return", "score",
"success"}. Randomness as in ``rollout_manager.py``: each manager holds a
``torch.Generator`` on the agent's device, seeded once from ``seed`` (the
JAX manager splits ``jax.random.key(seed)``), and passes it to every agent
call; an optional ``draw_source(call)`` ("act", "propose" or "decode")
supplies a call's draws instead, in the JAX manager's order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tacorl_tpu_torch.evaluation.rollout_manager import _BaseRolloutManager

__all__ = ["RLRolloutD4RL", "LatentPlanRolloutD4RL", "TACORLRolloutD4RL"]


def _goal_of(env) -> np.ndarray:
    if hasattr(env, "target_goal"):
        return np.asarray(env.target_goal, dtype=np.float32)
    return np.asarray(env.goal_locations[0], dtype=np.float32)


def _summary(env, step: int, episode_return: float, info: Dict) -> Dict:
    return {
        "episode_length": step,
        "episode_return": episode_return,
        "score": float(env.get_normalized_score(episode_return)),
        "success": bool(info.get("success", False)),
    }


class RLRolloutD4RL(_BaseRolloutManager):
    """Flat policy on concat(obs, goal) (rollout_manager_d4rl.py:46-104)."""

    def episode_rollout(self, agent, env, reset_info=None, **kw) -> Dict:
        agent.reset()
        gen = self._rng(agent)
        obs = env.reset()
        goal = _goal_of(env)
        episode_return, info = 0.0, {}
        for step in range(1, env.max_episode_steps + 1):
            obs_goal = np.concatenate([obs, goal]).astype(np.float32)
            action = agent.act(obs_goal, self._next_draws("act"), gen)
            obs, reward, done, info = env.step(action)
            episode_return += reward
            if done:
                break
        return _summary(env, step, episode_return, info)


class _PlanDecodeD4RL(_BaseRolloutManager):
    """Propose a plan from (obs, goal xy) every plan_duration env steps,
    stream the decoder between replans."""

    def __init__(self, plan_duration: int = 16, seed: int = 0, draw_source=None):
        super().__init__(seed, draw_source)
        self.plan_duration = plan_duration

    def episode_rollout(self, agent, env, reset_info=None, **kw) -> Dict:
        agent.reset()
        gen = self._rng(agent)
        obs = env.reset()
        goal = _goal_of(env)
        episode_return, info = 0.0, {}
        step, done = 0, False
        while not done and step < env.max_episode_steps:
            plan = agent.propose_plan_d4rl(obs, goal, self._next_draws("propose"), gen)
            for _ in range(self.plan_duration):
                action = agent.decode_step({"observation": obs}, plan, self._next_draws("decode"), gen)
                obs, reward, done, info = env.step(action)
                episode_return += reward
                step += 1
                if done or step >= env.max_episode_steps:
                    break
        return _summary(env, step, episode_return, info)


class LatentPlanRolloutD4RL(_PlanDecodeD4RL):
    """Plan sampled from the proposal prior given (obs, goal xy)
    (rollout_manager_d4rl.py:107-170)."""


class TACORLRolloutD4RL(_PlanDecodeD4RL):
    """Plan from the RL actor on concat(obs, goal)
    (rollout_manager_d4rl.py:173-250)."""
