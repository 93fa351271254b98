"""Goal-image evaluation entry point of the port (mirrors
scripts/evaluate.py; reference: scripts/evaluate.py:256-270).

Usage:
    python -m tacorl_tpu_torch.evaluate module_path=runs/tacorl \
        eval_type=short_horizon data_dir=/path/to/calvin/validation env=fake_calvin

eval_type: short_horizon | long_horizon | long_horizon_sequential

``module_path`` holds a port checkpoint (``core/checkpoint.py``). The run
goes on the card; ``+device=cpu`` runs it on the CPU (``configs/evaluate.yaml``
has no ``device`` key, so it is added). Without a card and without that
override it raises.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from tacorl_tpu_torch.config import compose, get_class, instantiate
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.evaluation import rollout_manager as rm
from tacorl_tpu_torch.evaluation.manager import EvaluationManager
from tacorl_tpu_torch.evaluation.rollout_generator import (
    LongHorizonRolloutGenerator,
    LongHorizonSequentialRolloutGenerator,
    SingleTaskRolloutGenerator,
)
from tacorl_tpu_torch.utils import resolve_device

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"

# module family -> (agent class, rollout manager); online SAC and CQL score
# with the flat agent, as evaluation/agents.py:make_agent maps them (the
# table of scripts/evaluate.py lacks them)
AGENTS = {
    "cql": ("tacorl_tpu_torch.evaluation.agents.FlatPolicyAgent", "RLRollout"),
    "sac": ("tacorl_tpu_torch.evaluation.agents.FlatPolicyAgent", "RLRollout"),
    "cql_online": ("tacorl_tpu_torch.evaluation.agents.FlatPolicyAgent", "RLRollout"),
    "tacorl": ("tacorl_tpu_torch.evaluation.agents.TACORLAgent", "TACORLRollout"),
    "play_lmp": ("tacorl_tpu_torch.evaluation.agents.LatentPlanAgent", "LatentPlanRollout"),
    "ril": ("tacorl_tpu_torch.evaluation.agents.RILAgent", "RILRollout"),
}


def build_agent_and_manager(module, state, cfg):
    if module.name not in AGENTS:
        raise NotImplementedError(f"no port agent for module {module.name!r} yet (see ROADMAP.md)")
    agent_cls_name, manager_name = AGENTS[module.name]
    kwargs = {}
    if module.name in ("cql", "sac", "cql_online", "tacorl"):
        kwargs = {
            "use_cem": bool(cfg.get("use_cem", False)),
            "cem_cfg": cfg.get("cem") or {},
        }
    agent = get_class(agent_cls_name)(module, state, **kwargs)
    manager_cls = getattr(rm, manager_name)
    if manager_name == "RLRollout":
        manager = manager_cls()
    else:
        manager = manager_cls(plan_duration=int(cfg.get("plan_duration", 15)))
    return agent, manager


def main(argv=None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "evaluate", overrides)
    device = resolve_device(cfg.get("device", "cuda"))

    # a step number, -1 for the latest, or "best" (the manager's best_step)
    epoch = cfg.get("epoch", -1)
    module, state = load_module_from_checkpoint(
        cfg["module_path"],
        step=epoch if epoch == "best" else int(epoch),
        # `+overwrite_module_cfg.play_lmp_dir=...` re-points the grafted LMP
        # run at eval time (reference README.md:93-96)
        overwrite_cfg=cfg.get("overwrite_module_cfg") or None,
        device=device,
    )
    env = instantiate(cfg["env"])
    agent, rollout_manager = build_agent_and_manager(module, state, cfg)

    data_dir = Path(cfg["data_dir"]).expanduser()
    start_end_tasks = cfg.get("start_end_tasks", str(data_dir / "start_end_tasks.json"))
    gen_kwargs = dict(
        data_dir=data_dir,
        start_end_tasks=start_end_tasks,
        strategy=cfg.get("strategy", "longest"),
        min_seq_len=int(cfg.get("min_seq_len", 16)),
        max_seq_len=int(cfg.get("max_seq_len", 64)),
    )
    manager = EvaluationManager(
        agent=agent,
        env=env,
        rollout_manager=rollout_manager,
        single_task_generator=SingleTaskRolloutGenerator(**gen_kwargs),
        lh_generator=LongHorizonRolloutGenerator(
            tasks_per_rollout=int(cfg.get("lh_tasks_per_rollout", 2)), **gen_kwargs
        ),
        lh_seq_generator=LongHorizonSequentialRolloutGenerator(
            tasks_per_rollout=int(cfg.get("lh_seq_tasks_per_rollout", 5)), **gen_kwargs
        ),
    )
    eval_type = cfg.get("eval_type", "short_horizon")
    filename = cfg.get("filename") or f"{eval_type}_results.json"
    if eval_type == "short_horizon":
        results = manager.evaluate_all_tasks(
            filename, max_rollouts_per_task=int(cfg.get("max_rollouts", 50))
        )
    elif eval_type == "long_horizon":
        results = manager.evaluate_lh_tasks(
            filename, max_rollouts=int(cfg.get("max_rollouts", 1000))
        )
    elif eval_type == "long_horizon_sequential":
        results = manager.evaluate_lh_seq_tasks(
            filename, max_rollouts=int(cfg.get("max_rollouts", 500))
        )
    else:
        raise ValueError(f"unknown eval_type {eval_type!r}")
    print(f"wrote {filename}")
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
