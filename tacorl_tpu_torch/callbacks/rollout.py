"""In-training rollout evaluation callbacks (port of
tacorl_tpu/callbacks/rollout.py; reference: utils/callbacks/rollout.py:
22-547, utils/callbacks/rollout_long_horizon.py:13-132,
utils/callbacks/rollout_d4rl.py:17-182).

  * cadence by epochs, episodes (online RL), or batches, plus
    ``skip_first_n_epochs``; the batch cadence's position is the
    callback's ``state_dict``, so a resumed run keeps it;
  * eval strategies ``all_tasks`` (per-task rollouts from
    start_end_tasks.json), ``env_tasks`` (the env's stored start/goal
    pairs), ``plain`` (N unconditioned episodes) and ``flat`` (a capped
    flat task list);
  * static vs dynamic "block" task aggregation: per-task metrics, the group
    means, and an overall score that averages the two groups;
  * ``val_accuracy`` / ``val_episode_return`` / ``val_episode_length`` for
    the checkpoint monitor.

``RolloutD4RLCallback`` scores a D4RL module with N plain episodes of its
state env into ``val_accuracy`` and ``val_score`` (the normalized return).

Each run builds the module's agent over ``trainer.state``
(``evaluation/agents.py:make_agent``) and a fresh rollout manager
(``evaluation/rollout_manager.py``, its generator seeded anew). The agents
act under ``torch.inference_mode()`` on the training net and leave it in
eval mode; the train steps set their own modes.

Data-parallel: the episodes are sharded round-robin over the ranks of the
process group (``parallel/mesh.py``), with the goal list padded so every
rank evaluates ceil(k / world) episodes (rollout.py:161-170), and
``_log`` averages each metric over the ranks, as the JAX callback's
``process_allgather`` does: equal counts make that the global metric, the
same on every rank. The D4RL callback gathers every rank's episodes and
takes their mean.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, List, Optional

import numpy as np

from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.config import instantiate
from tacorl_tpu_torch.evaluation.agents import make_agent, make_d4rl_agent
from tacorl_tpu_torch.evaluation.rollout_generator import (
    LongHorizonRolloutGenerator,
    SingleTaskRolloutGenerator,
)
from tacorl_tpu_torch.parallel.mesh import gather_objects, rank, world

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["RolloutCallback", "RolloutLongHorizonCallback", "RolloutD4RLCallback"]


class _BaseRolloutCallback(Callback):
    def __init__(
        self,
        env: Any,
        data_dir: Optional[str] = None,
        start_end_tasks: Optional[str] = None,
        num_rollouts: int = 16,
        every_n_epochs: Optional[int] = None,
        every_n_episodes: Optional[int] = None,
        every_n_batches: Optional[int] = None,
        skip_first_n_epochs: int = 0,
        plan_duration: int = 15,
        use_cem: bool = False,
        min_seq_len: int = 16,
        max_seq_len: int = 64,
        strategy: str = "shortest",
    ):
        self.env = instantiate(env) if isinstance(env, dict) else env
        self.data_dir = data_dir
        self.start_end_tasks = start_end_tasks
        self.num_rollouts = num_rollouts
        # the reference asserts one cadence is set (rollout.py:53-57); the
        # default is every epoch so epoch-only configs stay terse
        if every_n_epochs is None and every_n_episodes is None and every_n_batches is None:
            every_n_epochs = 1
        self.every_n_epochs = every_n_epochs
        self.every_n_episodes = every_n_episodes
        self.every_n_batches = every_n_batches
        self.skip_first_n_epochs = skip_first_n_epochs
        self.plan_duration = plan_duration
        self.use_cem = use_cem
        self.gen_kwargs = dict(
            data_dir=data_dir,
            start_end_tasks=start_end_tasks,
            min_seq_len=min_seq_len,
            max_seq_len=max_seq_len,
            strategy=strategy,
        )
        self._generator = None
        self._last_batch_fire = -1

    def state_dict(self) -> Dict[str, Any]:
        if self.every_n_batches is None:
            return {}
        return {"last_batch_fire": self._last_batch_fire}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if "last_batch_fire" in state:
            self._last_batch_fire = int(state["last_batch_fire"])

    def _agent_and_manager(self, trainer, module):
        from tacorl_tpu_torch.evaluation.rollout_manager import RLRollout

        agent, manager_cls = make_agent(module, trainer.state, use_cem=self.use_cem)
        if manager_cls is RLRollout:
            return agent, manager_cls()
        return agent, manager_cls(plan_duration=self.plan_duration)

    # -- cadence (rollout.py:498-535) -------------------------------------

    def _epoch_cadence_hit(self, module, epoch: int) -> bool:
        if epoch < self.skip_first_n_epochs:
            return False
        episode_cond = (
            self.every_n_episodes is not None
            and getattr(module, "episode_done", False)
            and getattr(module, "episode_number", 0) % self.every_n_episodes == 0
        )
        epoch_cond = self.every_n_epochs is not None and epoch % self.every_n_epochs == 0
        return episode_cond or epoch_cond

    def on_train_batch_end(self, trainer, module, metrics, step) -> None:
        if self.every_n_batches is None or trainer.epoch < self.skip_first_n_epochs:
            return
        # fire whenever a cadence boundary was crossed since the last fire
        fire_idx = step // self.every_n_batches
        if fire_idx > self._last_batch_fire:
            self._last_batch_fire = fire_idx
            self._run(trainer, module, trainer.epoch, prefix="batch_val")

    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        if self._epoch_cadence_hit(module, epoch):
            self._run(trainer, module, epoch, prefix="validation")

    def _run(self, trainer, module, epoch: int, prefix: str) -> None:
        raise NotImplementedError

    def _goal_list(self, num_rollouts: int, num_available: int) -> List[int]:
        """This process's share of rollout indices, padded so every process
        evaluates ceil(k/world) episodes (rollout.py:161-170)."""
        r, w = rank(), world()
        num_goals = w * math.ceil(num_rollouts / w)
        goals = [g for g in range(num_goals) if g % w == r]
        if num_available <= 0:
            return []
        return [g % num_available for g in goals]

    def _log(self, trainer, metrics: Dict[str, float]) -> None:
        if world() > 1:
            keys = sorted(metrics)
            mean = np.mean([[m[k] for k in keys] for m in gather_objects(metrics)], axis=0)
            metrics = dict(zip(keys, mean.tolist()))
        trainer.sink.log(metrics, trainer.global_step)
        trainer._last_val_metrics.update(metrics)


def _summarize(episodes: List[Dict[str, float]]) -> Dict[str, float]:
    return {
        "accuracy": float(np.mean([e["success"] for e in episodes])),
        "avg_episode_return": float(np.mean([e["episode_return"] for e in episodes])),
        "avg_episode_length": float(np.mean([e["episode_length"] for e in episodes])),
    }


class RolloutCallback(_BaseRolloutCallback):
    """Single-task rollouts -> val_accuracy / val_episode_return
    (rollout.py:22-547); ``eval_strategy`` as in the module docstring, with
    ``num_rollouts_per_task`` episodes per task for ``all_tasks``."""

    EVAL_STRATEGIES = ("all_tasks", "env_tasks", "plain", "flat")

    def __init__(
        self,
        *args,
        eval_strategy: str = "all_tasks",
        num_rollouts_per_task: int = 3,
        **kwargs,
    ):
        super().__init__(*args, **kwargs)
        if eval_strategy not in self.EVAL_STRATEGIES:
            raise ValueError(
                f"unknown eval_strategy {eval_strategy!r}; "
                f"expected one of {self.EVAL_STRATEGIES}"
            )
        self.eval_strategy = eval_strategy
        self.num_rollouts_per_task = num_rollouts_per_task

    def _need_generator(self):
        if self._generator is None:
            self._generator = SingleTaskRolloutGenerator(**self.gen_kwargs)
        return self._generator

    def _rollout(self, agent, manager, reset_info, task=None) -> Dict:
        out = manager.episode_rollout(agent, self.env, reset_info, task=task)
        return {
            "success": float(out["success"]),
            "episode_return": float(out["episode_return"]),
            "episode_length": float(out["episode_length"]),
        }

    def _evaluate_task_groups(
        self, trainer, agent, manager, task_specs, prefix: str
    ) -> Optional[Dict[str, float]]:
        """Per-task metrics plus the static/dynamic split keyed on "block"
        in the task name (rollout.py:196-259)."""
        groups: Dict[str, List[Dict]] = {"static": [], "dynamic": []}
        per_task: Dict[str, float] = {}
        total = 0
        for task, reset_infos in task_specs:
            episodes = [self._rollout(agent, manager, ri, task=task) for ri in reset_infos]
            if not episodes:
                continue
            total += len(episodes)
            for k, v in _summarize(episodes).items():
                per_task[f"{prefix}/{task}/{k}"] = v
            groups["dynamic" if "block" in task else "static"].extend(episodes)
        if total == 0:
            return None
        metrics = dict(per_task)
        group_summaries = {}
        for name, episodes in groups.items():
            if not episodes:
                continue
            group_summaries[name] = _summarize(episodes)
            for k, v in group_summaries[name].items():
                metrics[f"{prefix}/{name}/{k}"] = v
        # overall: the unweighted mean of the group scores (rollout.py:446-460)
        overall = {
            k: float(np.mean([s[k] for s in group_summaries.values()]))
            for k in ("accuracy", "avg_episode_return", "avg_episode_length")
        }
        self._log(trainer, metrics)
        return overall

    def _run_all_tasks(self, trainer, agent, manager, prefix):
        gen = self._need_generator()
        task_specs = []
        for task, entries in gen.get_rollout_tasks().items():
            goal_list = self._goal_list(self.num_rollouts_per_task, len(entries))
            task_specs.append((task, [gen.get_reset_info(task, g) for g in goal_list]))
        return self._evaluate_task_groups(trainer, agent, manager, task_specs, prefix)

    def _run_env_tasks(self, trainer, agent, manager, prefix):
        task_specs = []
        for task, num_goals in self.env.get_possible_tasks().items():
            goal_list = self._goal_list(num_goals, num_goals)
            task_specs.append(
                (task, [{"task_info": {"task": task, "index": g}} for g in goal_list])
            )
        return self._evaluate_task_groups(trainer, agent, manager, task_specs, prefix)

    def _run_plain(self, trainer, agent, manager, prefix):
        episodes = [
            self._rollout(agent, manager, None)
            for _ in self._goal_list(self.num_rollouts, self.num_rollouts)
        ]
        return _summarize(episodes) if episodes else None

    def _run_flat(self, trainer, agent, manager, prefix):
        gen = self._need_generator()
        episodes = [
            (task, idx)
            for task, entries in gen.get_rollout_tasks().items()
            for idx in range(len(entries))
        ]
        episodes = episodes[rank()::world()][: self.num_rollouts]
        if not episodes:
            return None
        return _summarize([
            self._rollout(agent, manager, gen.get_reset_info(task, idx), task=task)
            for task, idx in episodes
        ])

    def _run(self, trainer, module, epoch: int, prefix: str) -> None:
        agent, manager = self._agent_and_manager(trainer, module)
        if self.eval_strategy == "all_tasks":
            overall = self._run_all_tasks(trainer, agent, manager, prefix)
        elif self.eval_strategy == "env_tasks":
            if hasattr(self.env, "get_possible_tasks"):
                overall = self._run_env_tasks(trainer, agent, manager, prefix)
            else:
                logger.warning(
                    "eval_strategy=env_tasks but %s has no get_possible_tasks; "
                    "falling back to plain episodes", type(self.env).__name__,
                )
                overall = self._run_plain(trainer, agent, manager, prefix)
        elif self.eval_strategy == "flat":
            overall = self._run_flat(trainer, agent, manager, prefix)
        else:
            overall = self._run_plain(trainer, agent, manager, prefix)
        if overall is None:
            return
        if prefix == "validation":
            # checkpoint monitor metrics (rollout.py:542-546)
            self._log(trainer, {
                "val_accuracy": overall["accuracy"],
                "val_episode_return": overall["avg_episode_return"],
                "val_episode_length": overall["avg_episode_length"],
            })
            # online RL snapshots its replay buffer after each rollout
            # evaluation (rollout.py:530-532, sac_lightning.py:446-451)
            if hasattr(module, "save_checkpoint_extras"):
                module.save_checkpoint_extras()
        else:
            self._log(trainer, {f"{prefix}/{k}": v for k, v in overall.items()})
        logger.info(
            "rollout eval [%s/%s]: accuracy %.3f", prefix, self.eval_strategy, overall["accuracy"]
        )


class RolloutLongHorizonCallback(_BaseRolloutCallback):
    """Long-horizon chains -> per-depth LH_{i}_accuracy
    (rollout_long_horizon.py:13-132)."""

    def __init__(self, tasks_per_rollout: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.tasks_per_rollout = tasks_per_rollout

    def _run(self, trainer, module, epoch: int, prefix: str) -> None:
        if self._generator is None:
            self._generator = LongHorizonRolloutGenerator(
                tasks_per_rollout=self.tasks_per_rollout, **self.gen_kwargs
            )
        agent, manager = self._agent_and_manager(trainer, module)
        n_available = len(self._generator.get_rollout_tasks())
        tasks = self._goal_list(min(self.num_rollouts, max(n_available, 1)), n_available)
        if not tasks:
            return
        accum = np.zeros(self.tasks_per_rollout)
        for idx in tasks:
            out = manager.episode_rollout(agent, self.env, self._generator.get_reset_info(idx))
            accum[: len(out.get("successful_tasks", []))] += 1
        self._log(trainer, {
            f"LH_{i + 1}_accuracy": float(accum[i] / len(tasks))
            for i in range(self.tasks_per_rollout)
        })


class RolloutD4RLCallback(Callback):
    """In-training D4RL evaluation: ``num_rollouts`` episodes of ``env``
    every ``every_n_epochs`` epochs -> ``val_accuracy`` (the success rate)
    and ``val_score`` (the mean normalized return), for the checkpoint
    monitor. The env persists across evaluations (its goal draws run on);
    each evaluation builds a fresh rollout manager, whose generator starts
    anew from seed 0, as the JAX callback's manager restarts its key."""

    def __init__(
        self,
        env: Any,
        num_rollouts: int = 10,
        every_n_epochs: int = 1,
        plan_duration: int = 15,
    ):
        self.env = instantiate(env) if isinstance(env, dict) else env
        self.num_rollouts = num_rollouts
        self.every_n_epochs = every_n_epochs
        self.plan_duration = plan_duration

    def on_validation_end(self, trainer, module, metrics, outputs, epoch):
        if epoch % self.every_n_epochs != 0:
            return
        agent, manager = make_d4rl_agent(module, trainer.state, self.plan_duration)
        successes, scores = [], []
        for _ in list(range(self.num_rollouts))[rank()::world()]:
            out = manager.episode_rollout(agent, self.env)
            successes.append(float(out["success"]))
            scores.append(float(out["score"]))
        if world() > 1:
            shares = gather_objects((successes, scores))
            successes = [x for share, _ in shares for x in share]
            scores = [x for _, share in shares for x in share]
        if not successes:
            return
        result = {"val_accuracy": float(np.mean(successes)), "val_score": float(np.mean(scores))}
        trainer.sink.log(result, trainer.global_step)
        trainer._last_val_metrics.update(result)
