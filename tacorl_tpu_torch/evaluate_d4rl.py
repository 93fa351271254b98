"""D4RL evaluation entry point of the port (mirrors scripts/evaluate_d4rl.py;
reference: scripts/evaluate_d4rl.py:21-84): N rollouts of a D4RL module ->
accuracy and normalized score JSON.

Usage:
    python -m tacorl_tpu_torch.evaluate_d4rl module_path=runs/tacorl_d4rl \
        env=fake_d4rl num_rollouts=20

``module_path`` holds a port checkpoint of ``play_lmp_d4rl``,
``tacorl_d4rl`` or a flat (``state_based``) CQL module; ``epoch`` is
``best`` (ranked by the run's ``ckpt_mode``), a step, or -1 for the latest;
``plan_duration`` (default 15) is the hierarchical agents' replanning
period; ``filename`` defaults to ``d4rl_results.json``. The run goes on the
card; ``+device=cpu`` runs it on the CPU (``configs/evaluate_d4rl.yaml``
has no ``device`` key, so it is added). Without a card and without that
override it raises.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import numpy as np

from tacorl_tpu_torch.config import compose, instantiate
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.evaluation.agents import make_d4rl_agent
from tacorl_tpu_torch.utils import resolve_device

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def main(argv=None, draw_source=None):
    """Compose, load, roll out, write the summary JSON; returns it.
    ``draw_source`` goes to the rollout manager (explicit draws per agent
    call, as a parity test supplies them)."""
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "evaluate_d4rl", overrides)
    device = resolve_device(cfg.get("device", "cuda"))
    epoch = cfg.get("epoch", -1)
    module, state = load_module_from_checkpoint(
        cfg["module_path"], step=epoch if epoch == "best" else int(epoch), device=device
    )
    env = instantiate(cfg["env"])
    agent, manager = make_d4rl_agent(
        module, state, int(cfg.get("plan_duration", 15)), draw_source=draw_source
    )

    n = int(cfg.get("num_rollouts", 100))
    returns, scores, successes = [], [], 0
    for _ in range(n):
        out = manager.episode_rollout(agent, env)
        returns.append(out["episode_return"])
        scores.append(out["score"])
        successes += int(out["success"])
    summary = {
        "accuracy": successes / n,
        "avg_normalized_score": float(np.mean(scores)),
        "avg_episode_return": float(np.mean(returns)),
        "num_rollouts": n,
    }
    filename = cfg.get("filename") or "d4rl_results.json"
    with open(filename, "w") as f:
        json.dump(summary, f, indent=4)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
