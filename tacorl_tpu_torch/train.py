"""Training entry point of the port (mirrors scripts/train.py; reference:
scripts/train.py).

Usage:
    python -m tacorl_tpu_torch.train experiment=play_lmp_for_rl \
        data_dir=/path/to/calvin run_dir=runs/lmp trainer.max_steps=1000

Composes configs/train.yaml with the overrides, builds the datamodule, the
module, the checkpoint manager (``ckpt_max_to_keep``, ``ckpt_monitor``,
``ckpt_mode``) and the callbacks, and fits; the run auto-resumes from the
latest checkpoint in ``run_dir`` and saves the composed config beside the
checkpoints (``config.json``), which the stage-2 graft and
``python -m tacorl_tpu_torch.evaluate`` read.

The run goes on the card; ``+device=cpu`` runs it on the CPU (the shared
configs have no ``device`` key, so it is added). A config's ``platform:``
key (the fake experiments set ``platform: cpu``) picks a JAX backend in
scripts/train.py and is ignored here: it never moves the port to the CPU.
``trainer.steps_per_call`` sets the trainer's K-step dispatch (on the card,
CUDA-graph replays of the train step; ``core/trainer.py``).

Data-parallel training: under a launcher, ``torchrun --nproc_per_node=W -m
tacorl_tpu_torch.train ...`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
the rendezvous address in the environment), each rank joins the process
group (NCCL on its card ``cuda:<LOCAL_RANK>``, gloo with ``+device=cpu``)
and trains its rows of every global batch: ``datamodule.batch_size`` is
the global batch, as in the JAX package, and a W-rank run computes what
one rank computes on it (``core/trainer.py``, ``parallel/mesh.py``). A
caller that made its own process group keeps it. ``+multihost=true``
(``jax.distributed.initialize`` in scripts/train.py) means the same, and
without a launcher's environment it raises. The group is left at the end
of a run, after the step graph is freed (its captured collectives hold
NCCL's communicator); the returned trainer's ``step_graph`` keeps its
counts, not its graph.

A dataset's ``statistics.yaml`` action bounds go to the action decoder
only when its class takes them: the Gaussian MDN decoder has none, and
scripts/train.py, which passes them to any decoder, fails there with a
TypeError (ROADMAP Queue 3, repaired on the port's side).
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Sequence

import torch.distributed as dist

from tacorl_tpu_torch.config import compose, get_class, instantiate
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.logging import MetricsSink
from tacorl_tpu_torch.core.trainer import Trainer
from tacorl_tpu_torch.data.datamodule import BasicDataModule
from tacorl_tpu_torch.networks.action_decoder import ActionDecoderLogistic
from tacorl_tpu_torch.parallel.mesh import destroy_distributed, init_distributed, launched
from tacorl_tpu_torch.utils import resolve_device

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs"


def build_callbacks(cfg: dict) -> list:
    callbacks = []
    for cb_cfg in (cfg.get("callbacks") or {}).values():
        if isinstance(cb_cfg, dict) and "_target_" in cb_cfg:
            callbacks.append(instantiate(cb_cfg))
    return callbacks


def _takes_action_bounds(decoder_cfg) -> bool:
    """Whether the action decoder the config builds takes action bounds:
    the logistic decoder (the default) does, the Gaussian one does not."""
    if decoder_cfg is None:
        return False
    target = decoder_cfg.get("_target_", "tacorl_tpu.networks.action_decoder.ActionDecoderLogistic")
    return issubclass(get_class(target), ActionDecoderLogistic)


def main(argv=None, callbacks: Sequence = ()) -> Trainer:
    """Compose, build and fit; ``callbacks`` are added after the
    configured ones. Returns the trainer."""
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, "train", overrides)
    device = resolve_device(cfg.get("device", "cuda"))
    made_group = False
    if cfg.get("multihost") or launched() or dist.is_initialized():
        made_group = init_distributed(device.type)
    trainer = _fit(cfg, device, callbacks)
    if made_group:
        # NCCL holds a communicator until every CUDA graph that captured its
        # collectives is gone: free the step graph first, or leaving waits
        # forever (a failed run exits without leaving: the launcher ends it)
        if trainer.step_graph is not None:
            trainer.step_graph.release()
        destroy_distributed()
    return trainer


def _fit(cfg: dict, device, callbacks: Sequence) -> Trainer:
    dm_cfg = dict(cfg["datamodule"])
    dm_cls = get_class(dm_cfg.pop("_target_")) if "_target_" in dm_cfg else BasicDataModule
    datamodule = dm_cls(**dm_cfg)

    # statistics.yaml action bounds override the configured defaults
    # (reference: action_decoder_logistic.py:140-158)
    stats = getattr(datamodule, "statistics", None)
    if stats and "act_max_bound" in stats and _takes_action_bounds(cfg["module"].get("action_decoder")):
        cfg["module"]["action_decoder"]["act_max_bound"] = stats["act_max_bound"]
        cfg["module"]["action_decoder"]["act_min_bound"] = stats["act_min_bound"]

    module_cls = get_class(cfg["module"]["_target_"])
    module = module_cls(cfg["module"], full_config=cfg, device=device)

    run_dir = Path(cfg["run_dir"]).expanduser()
    ckpt = CheckpointManager(
        run_dir,
        max_to_keep=int(cfg.get("ckpt_max_to_keep", 3)),
        monitor=cfg.get("ckpt_monitor", "validation/total_loss"),
        mode=cfg.get("ckpt_mode", "min"),
        config=cfg,
    )
    sink = MetricsSink(run_dir, **(cfg.get("logger") or {}))
    trainer = Trainer(
        ckpt_manager=ckpt,
        sink=sink,
        callbacks=build_callbacks(cfg) + list(callbacks),
        seed=int(cfg.get("seed", 0)),
        device=device,
        **dict(cfg.get("trainer") or {}),
    )
    try:
        trainer.fit(module, datamodule, resume=bool(cfg.get("resume", True)))
    finally:
        sink.close()
    return trainer


if __name__ == "__main__":
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    main()
