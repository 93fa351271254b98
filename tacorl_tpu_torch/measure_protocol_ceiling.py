"""Measure the evaluation protocols' CEILING with the scripted expert
(mirrors scripts/measure_protocol_ceiling.py).

Runs the fake env's scripted expert (the same controller that generated the
demonstrations, at full gain and without noise) through the port's
evaluation protocols: single-task, long-horizon and sequential long-horizon
(reference: scripts/evaluate.py:114-181, :43-112, :183-253), so every
learned-policy number has a measured upper bound beside it. The expert is
host code: nothing runs on a device.

Usage:
    python -m tacorl_tpu_torch.measure_protocol_ceiling data_dir=/path/validation \
        out_dir=results/r5 lh_seq_depth=3 lh_depth=2 max_episode_steps=112
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation.agents import ScriptedExpertAgent
from tacorl_tpu_torch.evaluation.manager import EvaluationManager
from tacorl_tpu_torch.evaluation.rollout_generator import (
    LongHorizonRolloutGenerator,
    LongHorizonSequentialRolloutGenerator,
    SingleTaskRolloutGenerator,
)
from tacorl_tpu_torch.evaluation.rollout_manager import RLRollout

__all__ = ["main"]


def main(argv=None) -> dict:
    args = dict(a.split("=", 1) for a in (argv if argv is not None else sys.argv[1:]))
    data_dir = Path(args["data_dir"]).expanduser()
    out_dir = Path(args.get("out_dir", "results/ceiling")).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    lh_depth = int(args.get("lh_depth", 2))
    lh_seq_depth = int(args.get("lh_seq_depth", 3))
    max_steps = int(args.get("max_episode_steps", 112))
    image_hw = int(args.get("image_hw", 64))

    env = FakeCalvinEnv(
        image_hw=image_hw,
        max_episode_steps=max_steps,
        task_set=args.get("task_set", "hard"),
        modalities=["rgb_static"],
        goal_modalities=["rgb_static"],
    )
    agent = ScriptedExpertAgent(env, gain=float(args.get("gain", 1.0)))
    gen_kw = dict(
        data_dir=data_dir,
        start_end_tasks=data_dir / "start_end_tasks.json",
        min_seq_len=int(args.get("min_seq_len", 1)),
        max_seq_len=int(args.get("max_seq_len", 400)),
    )
    manager = EvaluationManager(
        agent,
        env,
        RLRollout(),
        single_task_generator=SingleTaskRolloutGenerator(**gen_kw),
        lh_generator=LongHorizonRolloutGenerator(tasks_per_rollout=lh_depth, **gen_kw),
        lh_seq_generator=LongHorizonSequentialRolloutGenerator(tasks_per_rollout=lh_seq_depth, **gen_kw),
    )

    results = {
        "short_horizon": manager.evaluate_all_tasks(filename=str(out_dir / "expert_short_horizon.json")),
        "long_horizon": manager.evaluate_lh_tasks(filename=str(out_dir / "expert_lh.json")),
        "long_horizon_sequential": manager.evaluate_lh_seq_tasks(filename=str(out_dir / "expert_lh_seq.json")),
    }

    def headline(rows):
        return {k: v for k, v in rows.items() if k.startswith("lh_") or k in ("avg_len", "num_rollouts")}

    summary = {
        "short_horizon": {t: r["accuracy"] for t, r in results["short_horizon"].items()},
        "long_horizon": headline(results["long_horizon"]),
        "long_horizon_sequential": headline(results["long_horizon_sequential"]),
    }
    with open(out_dir / "expert_ceiling_summary.json", "w") as f:
        json.dump(summary, f, indent=4)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
