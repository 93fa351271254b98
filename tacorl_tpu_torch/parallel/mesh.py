"""The (dp, mp) mesh over ``torch.distributed`` (port of
tacorl_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``(dp, mp)`` device mesh: a
batch is sharded over ``dp``, the state is replicated (or, for the layers
``shard_params_by_rule`` names, sharded over ``mp``), and XLA inserts the
collectives. The port runs one process per card (a rank), and this module
holds what each rank needs to compute what one process computes on the
whole global batch:

  * ``init_distributed`` joins the process group a launcher describes
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and the rendezvous address in
    the environment, as ``torchrun`` sets them): NCCL on the card, gloo on
    the CPU. ``rank()`` and ``world()`` are 0 and 1 without a group.
  * ``create_mesh(dp, mp)`` lays the W ranks out as JAX's
    ``np.asarray(devices).reshape(dp, mp)``: rank r sits at
    ``(dp_index, mp_index) = (r // mp, r % mp)``. With ``mp`` > 1 it makes
    two sets of sub-groups (every rank makes every group, in one order):
    the dp group of a rank holds the ranks of its mp index (its column),
    the mp group the ranks of its dp index (its row). The last mesh made
    is the one the functions below use when given none
    (``current_mesh``); without one it is the world's ``(W, 1)``.
  * ``batch_sharding`` (this rank's ``BatchShard``): a global batch of B
    rows gives the ranks of dp index d the rows ``[d B/dp, (d+1) B/dp)``,
    the same rows on every rank of a row (JAX's ``P("dp")``, replicated
    over mp); a B that dp does not divide raises, as JAX's sharded
    ``device_put`` does. ``shard_batch`` takes a rank's rows of a batch.
  * ``sharded_draws`` and ``draw_rows``: inside the block, a batch-shaped
    random draw is drawn at the global shape and sliced to the rank's rows,
    so with every rank's generator seeded alike a rank's rows draw what
    the one-process run draws for them. Outside it (rollouts, the online
    play step) a draw is whole.
  * Collectives, and the group each uses: ``all_reduce_mean`` (a gradient
    group's mean, one collective a dtype) and ``sync_metrics`` (a step's
    metrics' mean) reduce over the dp group and divide by ``dp``: the mp
    ranks of a row hold the same rows, so their gradients and metrics are
    already the row's. ``replicate`` broadcasts the state from rank 0 over
    the world, except an mp shard (and its Adam moments), which rank
    ``mp_index`` broadcasts over its dp group. ``gather_objects`` /
    ``barrier`` run on a host group (gloo) of every rank. The mp group
    carries the sharded layers' own collectives
    (``parallel/tensor_parallel.py``: the column-parallel all-gather and
    the input gradient's all-reduce, the sharded leaves' share of a global
    norm, a checkpoint's gathered shards).
  * ``fold_rank`` folds the dp index into a dropout seed at dp > 1: the mp
    ranks of a row draw the same masks, as they compute one forward pass.

With no process group every function is the identity, and at a world of
one the collectives run and change nothing (a sum of one rank divided by
1.0), so a one-rank run computes bit for bit what a run without a group
computes.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from tacorl_tpu_torch.parallel.tensor_parallel import shard_of, shard_params_by_rule

__all__ = [
    "BatchShard",
    "Mesh",
    "all_reduce_mean",
    "backend",
    "barrier",
    "batch_sharding",
    "create_mesh",
    "current_mesh",
    "destroy_distributed",
    "draw_rows",
    "fold_rank",
    "gather_objects",
    "init_distributed",
    "launched",
    "local_mesh_devices",
    "local_rank",
    "rank",
    "replicate",
    "shard_batch",
    "shard_params_by_rule",
    "sharded_draws",
    "sync_metrics",
    "world",
]

LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")
# how long a collective or the rendezvous waits for a rank before raising
GROUP_TIMEOUT = datetime.timedelta(seconds=600)

# the host-side group (gloo) beside a NCCL default group; the default
# group itself when that is gloo
_host_group = None


# -- the process group ---------------------------------------------------------------


def launched() -> bool:
    """Whether a launcher's environment names this process's rank."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK``, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(device_type: str) -> bool:
    """Join the process group of a launcher's environment (``env://``): NCCL
    for ``device_type`` "cuda", bound to the rank's card, else gloo. Returns
    whether this call made the group (False with a group already made, by
    a caller that made its own). Without a launcher's environment it
    raises. A failed rendezvous or NCCL init raises."""
    if dist.is_initialized():
        _ensure_host_group()
        return False
    if not launched():
        raise RuntimeError(
            "multihost / data-parallel training needs a launcher: run "
            "`torchrun --nproc_per_node=W -m tacorl_tpu_torch.train ...` "
            f"(it sets {', '.join(LAUNCHER_ENV)} and the rendezvous address)"
        )
    if device_type == "cuda":
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl", init_method="env://", timeout=GROUP_TIMEOUT, device_id=device
        )
    else:
        dist.init_process_group("gloo", init_method="env://", timeout=GROUP_TIMEOUT)
    _ensure_host_group()
    return True


def _ensure_host_group() -> None:
    global _host_group
    if _host_group is None:
        _host_group = (
            dist.new_group(backend="gloo") if dist.get_backend() != "gloo" else dist.group.WORLD
        )


def destroy_distributed() -> None:
    """Leave the process group (``init_distributed``'s) and forget its
    mesh."""
    global _host_group, _mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = _mesh = None


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def barrier() -> None:
    """Every rank waits here for the others (host group); nothing without a
    group."""
    if dist.is_initialized():
        _ensure_host_group()
        dist.barrier(group=_host_group)


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (host group, pickled); ``[obj]``
    without a group."""
    if not dist.is_initialized():
        return [obj]
    _ensure_host_group()
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj, group=_host_group)
    return out


# -- the mesh ------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp`` x ``mp`` ranks; ``rank`` is this process's, at ``(dp_index,
    mp_index) = (rank // mp, rank % mp)``. ``dp_group`` and ``mp_group`` are
    this rank's sub-groups (None: the default group of a ``(W, 1)`` mesh,
    and no mp group)."""

    dp: int = 1
    mp: int = 1
    rank: int = 0
    dp_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    mp_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def dp_index(self) -> int:
        return self.rank // self.mp

    @property
    def mp_index(self) -> int:
        return self.rank % self.mp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "mp": self.mp}


# the mesh the collectives use when given none: the last one create_mesh made
_mesh: Optional[Mesh] = None


def local_mesh_devices(
    n_devices: Optional[int] = None, device: Union[str, torch.device] = "cuda"
) -> List[torch.device]:
    """The cards of this host, the first ``n_devices`` of them. Without a
    card this raises, as every entry point does, unless the caller asks
    for the CPU (``device="cpu"``: the one CPU device)."""
    if torch.device(device).type == "cpu":
        devices = [torch.device("cpu")]
    elif not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    return devices


def create_mesh(dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """The (dp, mp) mesh of the process group (``dp=None`` takes the world
    over ``mp``), made the mesh the collectives use. A world that ``mp``
    does not divide, or a shape that is not the world's, raises
    ``ValueError`` (JAX's messages). With ``mp`` > 1 every rank makes every
    sub-group: a collective call on every rank."""
    global _mesh
    n, mp = world(), int(mp)
    if dp is None:
        if n % mp:
            raise ValueError(f"{n} ranks not divisible by mp={mp}")
        dp = n // mp
    dp = int(dp)
    if dp * mp != n:
        raise ValueError(f"mesh shape (dp={dp}, mp={mp}) needs {dp * mp} ranks, the group has {n}")
    dp_group = mp_group = None
    if mp > 1:
        dp_group, _ = dist.new_subgroups_by_enumeration(
            [[d * mp + m for d in range(dp)] for m in range(mp)], timeout=GROUP_TIMEOUT
        )
        mp_group, _ = dist.new_subgroups_by_enumeration(
            [[d * mp + m for m in range(mp)] for d in range(dp)], timeout=GROUP_TIMEOUT
        )
    _mesh = Mesh(dp=dp, mp=mp, rank=rank(), dp_group=dp_group, mp_group=mp_group)
    return _mesh


def current_mesh() -> Mesh:
    """The mesh the collectives use: the last ``create_mesh``'s in this
    process group, else every rank on ``dp``."""
    if _mesh is not None and dist.is_initialized():
        return _mesh
    return Mesh(dp=world(), mp=1, rank=rank())


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rank ``index`` of ``count`` on the batch axis."""

    index: int = 0
    count: int = 1

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global`` rows."""
        if n_global % self.count:
            raise ValueError(
                f"a global batch of {n_global} rows does not split over {self.count} ranks"
            )
        n = n_global // self.count
        return slice(self.index * n, (self.index + 1) * n)

    def take(self, x, axis: int = 0):
        """This rank's rows of ``x`` (a tensor or an array) on ``axis``."""
        if self.count == 1:
            return x
        rows = self.rows(x.shape[axis])
        if torch.is_tensor(x):
            return x.narrow(axis, rows.start, rows.stop - rows.start)
        return x[(slice(None),) * axis + (rows,)]


def batch_sharding(mesh: Optional[Mesh] = None) -> BatchShard:
    """This rank's shard of the batch axis: its dp index of ``dp``."""
    mesh = current_mesh() if mesh is None else mesh
    return BatchShard(mesh.dp_index, mesh.dp)


def shard_batch(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """This rank's rows of every leaf of a (nested dict) batch, on the
    leading axis."""
    shard = batch_sharding(mesh)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return shard.take(batch)


# -- draws ---------------------------------------------------------------------------

_DRAWS: contextvars.ContextVar = contextvars.ContextVar("tacorl_draw_shard", default=BatchShard())


@contextlib.contextmanager
def sharded_draws(shard: Optional[BatchShard] = None):
    """Inside: ``draw_rows`` draws at the global shape and keeps ``shard``'s
    rows (by default this rank's)."""
    token = _DRAWS.set(batch_sharding() if shard is None else shard)
    try:
        yield
    finally:
        _DRAWS.reset(token)


def draw_rows(draw: Callable[[tuple], Tensor], shape: Sequence[int], axis: int = 0) -> Tensor:
    """``draw(shape)``; inside ``sharded_draws`` of W ranks, ``draw`` of the
    global shape (``shape[axis] * W``) and this rank's rows of it on
    ``axis``."""
    shard = _DRAWS.get()
    shape = tuple(int(s) for s in shape)
    if shard.count == 1:
        return draw(shape)
    full = shape[:axis] + (shape[axis] * shard.count,) + shape[axis + 1:]
    return shard.take(draw(full), axis).contiguous()


# -- collectives ---------------------------------------------------------------------


def all_reduce_mean(tensors: Sequence[Tensor]) -> List[Tensor]:
    """Each tensor replaced in place by its mean over the dp group of the
    current mesh (every rank on a ``(W, 1)`` mesh), through one flat buffer
    a dtype: one collective a dtype, between a step's gradients and its
    update. In place, so what reads the tensors next (the clip's norms, the
    optimizer) runs on the tensors it would read without a group, which at
    one rank keeps the step bit for bit. An mp shard's gradient is reduced
    with the same shard of the other rows. Returns the tensors; nothing
    happens without a process group. ``all_reduce_mean.calls`` counts the
    collectives it issues from Python (a CUDA graph's replay issues its
    captured ones without a call)."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return tensors
    mesh = current_mesh()
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.dp_group)
        all_reduce_mean.calls += 1
        flat.div_(float(mesh.dp))
        pieces = flat.split([t.numel() for t in group])
        torch._foreach_copy_(group, [piece.view(t.shape) for t, piece in zip(group, pieces)])
    return tensors


all_reduce_mean.calls = 0


def sync_metrics(metrics: Dict[str, Any]) -> Dict[str, Tensor]:
    """The mean over the dp group of each metric (device tensors of any
    shape that is the same on every rank), in one collective; unchanged
    without a process group. A metric must be a mean of per-row values over
    a rank's equal share of rows, or equal on every rank, for its mean to
    be the global one."""
    if not dist.is_initialized() or not metrics:
        return dict(metrics)
    values = [torch.as_tensor(v).detach().float().clone() for v in metrics.values()]
    return dict(zip(metrics, all_reduce_mean(values)))


@torch.no_grad()
def replicate(state) -> None:
    """Broadcast a train state's parameters, buffers and the optimizer's
    device tensors, in place (the JAX ``replicated_sharding``'s one copy),
    so a fresh, resumed or grafted state is the same on every rank: from
    rank 0 over the world, but an mp shard of a parameter
    (``shard_of``) and the optimizer's tensors of its shape
    from rank ``mp_index`` (dp index 0) over the dp group, so each row
    keeps its own shard. Nothing without a process group."""
    if not dist.is_initialized():
        return
    from tacorl_tpu_torch.core.optimizers import torch_optimizers

    mesh = current_mesh()
    shards = {id(p) for p in state.net.parameters() if shard_of(p) is not None}
    entries = list(state.net.state_dict(keep_vars=True).values())
    tensors = [t for t in entries if id(t) not in shards]
    sharded = [t for t in entries if id(t) in shards]
    device = entries[0].device if entries else None
    for opt in torch_optimizers(state.optimizer):
        for p, s in opt.state.items():
            for v in s.values():
                if torch.is_tensor(v) and v.device == device:
                    (sharded if id(p) in shards and v.shape == p.shape else tensors).append(v)
    for group, src, pg in ((tensors, 0, None), (sharded, mesh.mp_index, mesh.dp_group)):
        for dtype in dict.fromkeys(t.dtype for t in group):
            same = [t for t in group if t.dtype == dtype]
            flat = torch.cat([t.detach().reshape(-1) for t in same])
            dist.broadcast(flat, src=src, group=pg)
            for t, piece in zip(same, flat.split([t.numel() for t in same])):
                t.detach().copy_(piece.view(t.shape))


def fold_rank(seed: int) -> int:
    """A seed with the dp index folded in on a mesh of more than one row
    (the per-row dropout streams: the mp ranks of a row draw alike);
    ``seed`` itself at dp = 1."""
    mesh = current_mesh()
    if mesh.dp == 1:
        return seed
    return int(np.random.SeedSequence([seed, mesh.dp_index]).generate_state(1, np.uint64)[0] >> 1)
