"""Real-robot goal-image evaluation of the port (mirrors
scripts/evaluate_real_world.py; reference: scripts/evaluate_real_world.py
:12-53): load a port checkpoint, read a goal image from disk, run one
rollout on the Franka Panda through the robot_io env.

Usage:
    python -m tacorl_tpu_torch.evaluate_real_world module_path=runs/tacorl \
        img_path=/path/to/goal.png

The module runs on the card; ``+device=cpu`` runs it on the CPU (the
shared ``configs/evaluate_real_world.yaml`` has no ``device`` key).
Without a card and without that override it raises.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from tacorl_tpu_torch.config import compose, instantiate
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.evaluation.agents import make_agent
from tacorl_tpu_torch.utils import resolve_device

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["load_agent", "main"]


def load_agent(cfg):
    """(agent, rollout manager, env) of an ``evaluate_real_world`` config."""
    device = resolve_device(cfg.get("device", "cuda"))
    epoch = cfg.get("epoch", -1)
    module, state = load_module_from_checkpoint(
        cfg["module_path"], step=epoch if epoch == "best" else int(epoch), device=device,
    )
    env = instantiate(cfg["env"])
    agent, manager_cls = make_agent(module, state)
    return agent, manager_cls(plan_duration=int(cfg.get("plan_duration", 15))), env


def main(argv=None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "evaluate_real_world", overrides)
    agent, manager, env = load_agent(cfg)

    import cv2

    img = cv2.imread(str(cfg["img_path"]))
    assert img is not None, f"could not read goal image {cfg['img_path']}"
    goal = {"rgb_static": img[:, :, ::-1].copy()}
    logger.info("starting real-world evaluation rollout")
    out = manager.episode_rollout(agent, env, {"goal": goal})
    logger.info("rollout finished: %s", out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
