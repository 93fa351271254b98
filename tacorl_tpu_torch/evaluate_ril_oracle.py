"""Score a trained RIL module's low level under a ground-truth high level
(mirrors scripts/evaluate_ril_oracle.py).

The oracle high level (``OracleSubgoalAgent``) replans from the policy's
current env state: it deep-copies the live env, rolls the scripted expert
``lookahead`` steps forward and embeds the reached state through the
module's own goal path. Success means the low level follows reachable,
in-distribution subgoals; failure points at the low level.

Usage:
    python -m tacorl_tpu_torch.evaluate_ril_oracle module_path=runs/ril_fake_state \
        data_dir=/path/validation lookahead=12 plan_duration=8 filename=out.json \
        [learned_hl=true]

``learned_hl=true`` scores the learned high level (``RILAgent``) through the
same protocol, so the two numbers compare directly. The run goes on the
card; ``+device=cpu`` runs it on the CPU (``configs/evaluate.yaml`` has no
``device`` key, so it is added). Without a card and without that override
it raises.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from tacorl_tpu_torch.config import compose, instantiate
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.evaluation.agents import OracleSubgoalAgent, RILAgent
from tacorl_tpu_torch.evaluation.manager import EvaluationManager
from tacorl_tpu_torch.evaluation.rollout_generator import SingleTaskRolloutGenerator
from tacorl_tpu_torch.evaluation.rollout_manager import RILRollout
from tacorl_tpu_torch.utils import resolve_device

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def main(argv=None) -> dict:
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "evaluate", overrides)
    device = resolve_device(cfg.get("device", "cuda"))

    epoch = cfg.get("epoch", -1)
    module, state = load_module_from_checkpoint(
        cfg["module_path"], step=epoch if epoch == "best" else int(epoch), device=device
    )
    if module.name != "ril":
        raise ValueError(f"{cfg['module_path']} holds a {module.name!r} module, not 'ril'")
    env = instantiate(cfg["env"])
    if cfg.get("learned_hl"):
        agent = RILAgent(module, state)
    else:
        agent = OracleSubgoalAgent(module, state, env, lookahead=int(cfg.get("lookahead", 12)))
    data_dir = Path(cfg["data_dir"]).expanduser()
    manager = EvaluationManager(
        agent,
        env,
        RILRollout(plan_duration=int(cfg.get("plan_duration", 8))),
        single_task_generator=SingleTaskRolloutGenerator(
            data_dir=cfg["data_dir"],
            start_end_tasks=data_dir / "start_end_tasks.json",
            strategy=cfg.get("strategy", "longest"),
            min_seq_len=int(cfg.get("min_seq_len", 1)),
            max_seq_len=int(cfg.get("max_seq_len", 400)),
        ),
    )
    results = manager.evaluate_all_tasks(
        filename=cfg.get("filename") or "ril_oracle_tasks.json",
        max_rollouts_per_task=int(cfg.get("max_rollouts", 50)),
    )
    overall = sum(r["accuracy"] * r["num_rollouts"] for r in results.values())
    n = sum(r["num_rollouts"] for r in results.values())
    print(
        f"overall accuracy: {overall / max(n, 1):.3f} over {n} rollouts "
        f"({'learned' if cfg.get('learned_hl') else 'oracle'} high level)"
    )
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
