"""The ranks of the tensor-parallel tests (tests/test_torch_tensor_parallel.py),
spawned by ``torch.multiprocessing`` onto a ``(dp, mp)`` mesh of gloo
ranks: the mesh's layout and collectives, the tiny Play-LMP's steps with
``PLAY_LMP_RULES`` sharding it, checkpoints across mp, and the trainer on
an mp mesh. Each rank writes what it saw beside the job's spec. This
module imports only torch, numpy and ``tacorl_tpu_torch``."""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.graphs import seed_generators
from tacorl_tpu_torch.core.trainer import Trainer
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.networks.layers import TorchDense
from tacorl_tpu_torch.parallel import mesh
from tacorl_tpu_torch.parallel.tensor_parallel import PLAY_LMP_RULES, shard_of, shard_params_by_rule
from tests import torch_ddp_child as ddp_child

SEED = 0


def val_loss(module, state, batch, shard: mesh.BatchShard) -> float:
    """The val step's ``total_loss`` on ``shard``'s rows of ``batch`` (the
    trainer's seeding of validation batch 0), averaged over dp."""
    local = mesh.shard_batch(batch, mesh.Mesh(dp=shard.count, rank=shard.index))
    seed_generators(module, module.device, SEED + 1, 0)
    with mesh.sharded_draws(shard):
        metrics, _ = module.make_val_step()(state, local, {"kl_beta": 1e-3})
    return float(mesh.sync_metrics({"loss": metrics["total_loss"]})["loss"])


def run_steps(spec: dict, m: mesh.Mesh, state, module) -> list:
    """The spec's train steps with its (global) draws on this rank's dp rows;
    each step's metrics averaged over dp."""
    shard = mesh.batch_sharding(m)
    step = module.make_train_step()
    rows = []
    for g, batch in enumerate(spec["batches"]):
        local = mesh.shard_batch(batch, m)
        kwargs = ddp_child.shard_draws(spec["draws"][g], shard, 1)
        seed_generators(module, module.device, SEED, g)
        with mesh.sharded_draws(shard):
            state, metrics = step(state, local, spec["scalars"], **kwargs)
        rows.append({k: float(v) for k, v in mesh.sync_metrics(metrics).items()})
    return rows


def _layout(m: mesh.Mesh, rank: int) -> dict:
    """Where this rank sits, its groups, and what the collectives and
    seeding give it."""
    return {
        "dp_index": m.dp_index, "mp_index": m.mp_index,
        "dp_ranks": dist.get_process_group_ranks(m.dp_group),
        "mp_ranks": dist.get_process_group_ranks(m.mp_group),
        "rows_of_8": mesh.shard_batch(np.arange(8), m).tolist(),
        "fold": mesh.fold_rank(123),
        "mean": mesh.all_reduce_mean([torch.tensor([float(rank)])])[0].item(),
        "metrics": mesh.sync_metrics({"m": torch.tensor(float(rank))})["m"].item(),
    }


def _replicate_offsets(state, rank: int) -> dict:
    """Every parameter and Adam moment moved by +rank on this rank, then
    ``replicate``: what each now holds over what it held before the move (0
    where rank 0's copy came; mp_index where the shard of dp row 0's rank
    ``mp_index`` came, the same shard moved by that rank's number)."""
    tensors = dict(state.net.named_parameters())
    for p in list(tensors.values()):
        for k, v in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim():
                tensors[f"{k}:{next(n for n, q in state.net.named_parameters() if q is p)}"] = v
    before = {k: v.detach().clone() for k, v in tensors.items()}
    with torch.no_grad():
        for v in tensors.values():
            v.add_(float(rank))
    mesh.replicate(state)
    return {k: sorted({round(x, 4) for x in (v.detach() - before[k]).flatten().tolist()}) for k, v in tensors.items()}


def _layers(m: mesh.Mesh) -> dict:
    """A column-parallel TorchDense (weight and bias sharded) into a
    row-parallel one, against the same layers whole: the output, the
    input's gradient and the gathered weight gradients' largest
    differences."""
    torch.manual_seed(3)
    whole = torch.nn.ModuleDict({"col": TorchDense(6, 8), "row": TorchDense(8, 4)})
    parts = copy.deepcopy(whole)
    shard_params_by_rule(parts, m, [(r"^col\.weight$", ("mp", None)), (r"^col\.bias$", ("mp",)),
                                    (r"^row\.weight$", (None, "mp"))])
    x = torch.randn(5, 6)
    errs = {}
    got = []
    for net in (whole, parts):
        xi = x.clone().requires_grad_(True)
        y = net["row"](torch.relu(net["col"](xi)))
        (y.square() * torch.arange(4.0)).sum().backward()
        got.append((y.detach(), xi.grad))
    errs["y"] = (got[0][0] - got[1][0]).abs().max().item()
    errs["x_grad"] = (got[0][1] - got[1][1]).abs().max().item()
    for name, p in parts.named_parameters():
        grad = shard_of(p).gather(p.grad) if shard_of(p) is not None else p.grad
        errs[f"{name}.grad"] = (grad - dict(whole.named_parameters())[name].grad).abs().max().item()
    errs["kinds"] = (parts["col"].tp.kind, parts["row"].tp.kind)
    return errs


def tp_job(rank: int, root: Path) -> None:
    spec = torch.load(root / "tp.pt", weights_only=False)
    m = mesh.create_mesh(dp=spec["dp"], mp=spec["mp"])
    out = {"layout": _layout(m, rank), "layers": _layers(m)}
    module = PlayLMPModule(dict(spec["cfg"]), device="cpu")
    state = module.init_state(SEED)
    state.net.load_state_dict(spec["sd0"])
    out["plan"] = shard_params_by_rule(state.net, m, PLAY_LMP_RULES, optimizer=state.optimizer)
    out["shards"] = {n: tuple(p.shape) for n, p in state.net.named_parameters() if shard_of(p) is not None}
    # Adam's moments exist after a step; the replicate check moves them too
    run_steps(dict(spec, batches=spec["batches"][:1]), m, state, module)
    out["replicate"] = _replicate_offsets(state, rank)
    # back to the spec's weights and a fresh Adam: full tensors cut to the shards
    state = module.init_state(SEED)
    state.load_state_dict({"step": 0, "net": spec["sd0"], "optimizer": state.optimizer.state_dict()})
    out["rows"] = run_steps(spec, m, state, module)
    out["local"] = {k: v.clone() for k, v in state.net.state_dict().items()}
    full = state.state_dict()
    out["full"], out["full_optimizer"] = full["net"], full["optimizer"]
    shard = mesh.batch_sharding(m)
    out["val"] = val_loss(module, state, spec["val_batch"], shard)
    CheckpointManager(root / "ckpt").save(len(spec["batches"]), state)
    # a checkpoint of one rank, loaded into a fresh module and sharded
    other = PlayLMPModule(dict(spec["cfg"]), device="cpu")
    loaded = other.restore_state(CheckpointManager(spec["ckpt_in"]))
    saved = torch.load(Path(spec["ckpt_in"]) / "ckpts" / str(loaded.step) / "state.pt", weights_only=True)
    shard_params_by_rule(loaded.net, m, PLAY_LMP_RULES, optimizer=loaded.optimizer)
    out["val_in"] = val_loss(other, loaded, spec["val_batch"], shard)
    params = [p for group in loaded.optimizer.param_groups for p in group["params"]]
    moments = loaded.optimizer.state_dict()["state"]
    cut = [(i, p) for i, p in enumerate(params) if shard_of(p) is not None]
    out["moments_in"] = bool(cut) and all(
        torch.equal(v, shard_of(p).take(saved["optimizer"]["state"][i][k]))
        for i, p in cut for k, v in moments[i].items() if v.dim()
    )
    if spec.get("trainer"):
        out["trainer"] = _fit(spec, m, root / "trainer")
    torch.save(out, root / f"tp_{rank}.pt")


def _fit(spec: dict, m: mesh.Mesh, run_dir: Path) -> dict:
    """Play-LMP (dropout on) for 3 steps of the constant data module under
    ``Trainer(mesh=m)``: the state replicated over mp."""
    trainer = Trainer(max_steps=3, ckpt_manager=CheckpointManager(run_dir), seed=SEED, device="cpu",
                      log_every_n_steps=100, mesh=m)
    state = trainer.fit(PlayLMPModule(dict(spec["constant_cfg"]), device="cpu"),
                        ddp_child._ConstantDataModule(spec["constant_item"]))
    return {"step": state.step, "sd": {k: v.clone() for k, v in state.net.state_dict().items()},
            "mesh": trainer.mesh.shape, "shard": (trainer._loader(trainer.datamodule.train_loader()).shard)}


def run_tp_job(rank: int, world: int, root: str) -> None:
    ddp_child._run(tp_job, rank, world, root)
