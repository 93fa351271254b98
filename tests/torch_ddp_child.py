"""The ranks of the two-rank gloo tests (tests/test_torch_ddp*.py), spawned
by ``torch.multiprocessing``: each joins a process group through a file
store, runs its job and writes what it saw beside the job's spec. This
module imports only torch, numpy and ``tacorl_tpu_torch``."""

from __future__ import annotations

import importlib
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from tacorl_tpu_torch.core.graphs import seed_generators
from tacorl_tpu_torch.parallel import mesh

SEED = 0


def _join(rank: int, world: int, root: Path) -> None:
    dist.init_process_group("gloo", init_method=f"file://{root / 'rendezvous'}", rank=rank, world_size=world)


def _run(job, rank: int, world: int, root: str) -> None:
    root = Path(root)
    torch.set_num_threads(1)  # two ranks beside the test runner's other workers
    _join(rank, world, root)
    try:
        job(rank, root)
    except BaseException:
        (root / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        mesh.destroy_distributed()


# -- train steps ------------------------------------------------------------------------


def shard_draws(tree, shard: mesh.BatchShard, n: int, path=()):
    """A rank's rows of a step's explicit draws, given at the global batch's
    shape: the n-sample draws (``curr_n``, ``next_n``) on their second axis,
    the conservative term's ``rand`` as its n-major (n, B) rows, the online
    play step's draws whole, every other draw on its first axis."""
    if isinstance(tree, dict):
        if path and path[-1] == "play":
            return tree
        return {k: shard_draws(v, shard, n, path + (k,)) for k, v in tree.items()}
    if path[-1] == "rand":
        a = tree.shape[-1]
        return shard.take(tree.reshape(n, -1, a), axis=1).reshape(-1, a)
    return shard.take(tree, axis=1 if {"curr_n", "next_n"} & set(path) else 0)


def _module(spec):
    module_path, name = spec["cls"].rsplit(".", 1)
    module = getattr(importlib.import_module(module_path), name)(dict(spec["cfg"]), device="cpu")
    if spec.get("populate"):
        module.populate(None, steps=spec["populate"])
    return module


def run_steps(spec: dict, given: bool, shard: mesh.BatchShard, perturb: bool = False):
    """The spec's train steps on ``shard``'s rows of its global batches,
    with its draws (``given``) or the module's own; each step's metrics
    averaged over the ranks (a dict of floats), and the final state dict.
    ``perturb`` moves this rank's initial weights off the spec's before the
    state is broadcast from rank 0."""
    module = _module(spec)
    state = module.init_state(SEED)
    state.net.load_state_dict(spec["sd0"])
    if perturb:
        with torch.no_grad():
            for p in state.net.parameters():
                p.add_(1.0)
    mesh.replicate(state)
    replicated = all(torch.equal(v, spec["sd0"][k]) for k, v in state.net.state_dict().items())
    step = module.make_train_step()
    rows = []
    for g, batch in enumerate(spec["batches"]):
        local = mesh.shard_batch(batch, mesh.Mesh(dp=shard.count, rank=shard.index))
        kwargs = shard_draws(spec["draws"][g], shard, spec["n"]) if given else {}
        seed_generators(module, module.device, SEED, g)
        with mesh.sharded_draws(shard):
            state, metrics = step(state, local, spec["scalars"], **kwargs)
        rows.append({k: float(v) for k, v in mesh.sync_metrics(metrics).items()})
    # the val step on the first batch, with the module's own draws (the
    # trainer seeds a validation batch i from (seed + 1, i))
    local = mesh.shard_batch(spec["batches"][0], mesh.Mesh(dp=shard.count, rank=shard.index))
    seed_generators(module, module.device, SEED + 1, 0)
    with mesh.sharded_draws(shard):
        val, _ = module.make_val_step()(state, local, spec["scalars"])
    return {"rows": rows, "val": {k: float(v) for k, v in mesh.sync_metrics(val).items()},
            "sd": {k: v.clone() for k, v in state.net.state_dict().items()}, "replicated": replicated}


def steps_job(rank: int, root: Path) -> None:
    specs = torch.load(root / "specs.pt", weights_only=False)
    shard = mesh.batch_sharding()
    out = {
        (name, mode): run_steps(spec, mode == "given", shard, perturb=rank == 1)
        for name, spec in specs.items() for mode in spec["modes"]
    }
    torch.save(out, root / f"steps_{rank}.pt")


def run_steps_job(rank: int, world: int, root: str) -> None:
    _run(steps_job, rank, world, root)


# -- train.main ---------------------------------------------------------------------------


class _ConstantWindows:
    """One window, 16 times: every epoch's batches are the same, so a run
    resumed at any step sees what the uninterrupted run sees."""

    def __init__(self, item):
        self.item = item

    def __len__(self):
        return 16

    def sample(self, idx, rng):
        return self.item


class _ConstantDataModule:
    def __init__(self, item):
        self.item = item

    def setup(self):
        self.train_dataset = _ConstantWindows(self.item)

    def train_loader(self):
        from tacorl_tpu_torch.data.loader import DataLoader

        return DataLoader(self.train_dataset, batch_size=4, seed=0)

    def val_loader(self):
        return None


def _fit_constant(spec, run_dir: Path, max_steps: int):
    """Play-LMP (the spec's config, dropout on) for ``max_steps`` steps of
    the constant data module, resuming from ``run_dir``'s checkpoints."""
    from tacorl_tpu_torch.core.checkpoint import CheckpointManager
    from tacorl_tpu_torch.core.trainer import Trainer
    from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule

    trainer = Trainer(max_steps=max_steps, ckpt_manager=CheckpointManager(run_dir), seed=SEED,
                      device="cpu", log_every_n_steps=100)
    state = trainer.fit(PlayLMPModule(dict(spec["constant_cfg"]), device="cpu"),
                        _ConstantDataModule(spec["constant_item"]))
    return {"step": state.step, "sd": {k: v.clone() for k, v in state.net.state_dict().items()},
            "exp_avg_sq": [s["exp_avg_sq"].clone() for s in state.optimizer.state.values()]}


def train_job(rank: int, root: Path) -> None:
    from tacorl_tpu_torch import train
    from tacorl_tpu_torch.callbacks.rollout import _BaseRolloutCallback

    spec = torch.load(root / "train.pt", weights_only=False)
    out = {}
    for name, argv in spec["runs"].items():
        trainer = train.main(argv)
        out[name] = {
            "step": trainer.global_step,
            "sd": {k: v.clone() for k, v in trainer.state.net.state_dict().items()},
            "writes": (trainer.sink.is_main, trainer.ckpt.is_main),
            "val": dict(trainer._last_val_metrics),
        }
    # kill and resume on a constant data module, dropout on
    out["whole"] = _fit_constant(spec, root / "whole", 4)
    _fit_constant(spec, root / "killed", 2)
    out["resumed"] = _fit_constant(spec, root / "killed", 4)
    # the rollout callbacks' rank sharding (rollout.py:161-170) and their
    # rank-averaged metrics
    cb = _BaseRolloutCallback.__new__(_BaseRolloutCallback)

    class _Sink:
        def log(self, metrics, step, prefix=None):
            self.logged = dict(metrics)

    class _Trainer:
        sink, global_step, _last_val_metrics = _Sink(), 0, {}

    fake = _Trainer()
    cb._log(fake, {"val_accuracy": float(rank), "val_episode_return": 2.0 * rank})
    out["rollout"] = {"goals": cb._goal_list(10, 10), "padded": cb._goal_list(5, 5),
                      "logged": fake.sink.logged, "monitor": fake._last_val_metrics}
    torch.save(out, root / f"train_{rank}.pt")


def run_train_job(rank: int, world: int, root: str) -> None:
    _run(train_job, rank, world, root)
