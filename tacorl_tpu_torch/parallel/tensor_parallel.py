"""Model-parallel layers over the mesh's ``mp`` axis: the port of the JAX
package's ``shard_params_by_rule`` (tacorl_tpu/parallel/mesh.py).

The JAX function places a parameter tree on a ``(dp, mp)`` mesh: a leaf
whose '/'-joined path a rule's regex ``search``es takes that rule's
``PartitionSpec`` (the first rule wins), every other leaf is replicated,
and XLA's SPMD partitioner inserts the collectives, so the step computes
the function an unsharded step computes. The port has no partitioner: a
sharded layer carries its own collectives over the rank's mp group
(``Mesh.mp_group``), written as ``torch.autograd.Function``s; the products
stay ``torch.matmul`` (``F.linear``), as in the JAX package, where they
are XLA's GEMMs and no Pallas kernel.

``shard_params_by_rule(net, mesh, rules)`` matches the rules against the
net's ``named_parameters()`` names (``plan_recognition.fc.weight``); a
spec is a tuple with one entry per dim of the torch tensor, ``"mp"`` or
None (a shorter spec is padded with None, as a ``PartitionSpec`` is). It
supports a ``TorchDense`` (``nn.Linear``) weight, torch layout (out, in):

  * ``("mp", None)``, column-parallel (JAX's ``P(None, "mp")`` of a flax
    (in, out) kernel): rank m keeps output rows ``[m out/mp, (m+1)
    out/mp)``. Forward ``x @ W_m.T``, the columns all-gathered over mp, the
    bias added whole; backward ``grad W_m`` from the rank's own columns of
    the output gradient, and the input gradient as the mp all-reduce (sum)
    of ``grad_y_m @ W_m``. A bias ``("mp",)`` beside it is added to the
    rank's columns before the gather.
  * ``(None, "mp")``, row-parallel: rank m keeps input columns ``[m in/mp,
    (m+1) in/mp)`` and multiplies its slice of ``x``'s features; the
    products are all-reduced (sum) over mp, the bias added after; the
    input gradient is all-reduced over mp.

Any other spec, or a leaf of another kind (a conv, an embedding, an RNN,
the attention's projections), raises ``NotImplementedError(UNSUPPORTED)``;
a dim that ``mp`` does not divide raises ``ValueError``; a rule that
matches fewer than ``min_hits`` leaves raises ``ValueError`` ("renamed"),
as JAX's does. On a mesh of ``mp`` = 1 nothing is sharded.

Sharding swaps a parameter's data for its shard in place: the
``nn.Parameter`` (and so every optimizer and ``StepGraph`` that holds it)
stays the same object. An optimizer's state of the full shape is sharded
with it when the optimizer is given; Adam is elementwise, so a shard's
update is the slice of the whole one. Shard before the first capture of a
step graph (a capture after it would capture again: the data moved).

What else knows about shards: ``core/optimizers.py:global_norm`` sums a
shard's squares over mp; ``parallel/mesh.py:replicate`` broadcasts a shard
over its dp group; ``core/train_state.py:TrainState`` saves the gathered
full tensors (``gathered_state_dict``) and loads full tensors into shards
(``local_state_dict``), so a checkpoint has the unsharded layout at any
``mp``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor, nn

from tacorl_tpu_torch.networks.layers import TorchDense

if TYPE_CHECKING:  # parallel/mesh.py imports this module
    from tacorl_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "LinearShard",
    "PLAY_LMP_RULES",
    "Shard",
    "UNSUPPORTED",
    "gathered_state_dict",
    "local_state_dict",
    "shard_of",
    "shard_params_by_rule",
]

UNSUPPORTED = (
    "shard_params_by_rule shards a TorchDense (nn.Linear) weight as ('mp', None) or "
    "(None, 'mp') and a bias as ('mp',) beside a column-parallel weight; other specs and "
    "leaves are not supported (ROADMAP Queue 3, 'tensor parallelism: the specs the port "
    "supports')"
)

# the JAX package's dryrun rules (__graft_entry__.py:dryrun_multichip), in the
# port's names: the posterior's fc and each encoder layer's linear1, and the
# decoder's three mixture heads, column-parallel
PLAY_LMP_RULES: List[Tuple[str, Tuple]] = [
    (r"^plan_recognition\.(fc|transformer_encoder\.layers\.\d+\.linear1)\.weight$", ("mp", None)),
    (r"^action_decoder\.mean_fc\.weight$", ("mp", None)),
    (r"^action_decoder\.log_scale_fc\.weight$", ("mp", None)),
    (r"^action_decoder\.prob_fc\.weight$", ("mp", None)),
]


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter's share of its full tensor: ``dim`` split over the
    mesh's mp ranks, this rank's part ``mesh.mp_index``."""

    dim: int
    mesh: Mesh
    full: Tuple[int, ...]

    def take(self, full: Tensor) -> Tensor:
        """This rank's part of a full tensor (a copy)."""
        n = self.full[self.dim] // self.mesh.mp
        return full.narrow(self.dim, self.mesh.mp_index * n, n).clone()

    def gather(self, part: Tensor) -> Tensor:
        """The full tensor from every mp rank's part (a collective of the mp
        group)."""
        stacked = _all_gather(part.detach().contiguous(), self.mesh.mp_group, self.mesh.mp)
        return torch.cat(list(stacked.unbind(0)), dim=self.dim)


def _all_gather(x: Tensor, group, size: int) -> Tensor:
    """Every mp rank's ``x`` stacked on a new leading dim: NCCL's one
    all-gather into one buffer (a CUDA graph captures it), gloo's list of
    tensors (gloo has no all-gather into one tensor of a card)."""
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((size,) + tuple(x.shape))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def shard_of(p: Tensor) -> Optional[Shard]:
    """The ``Shard`` of a sharded parameter, else None."""
    return getattr(p, "_mp_shard", None)


# -- the collectives, with their gradients ---------------------------------------------


class _CopyToMP(torch.autograd.Function):
    """Identity forward; the gradient summed over the mp group (the input
    of a sharded layer feeds every rank's part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromMP(torch.autograd.Function):
    """Every mp rank's columns (last dim) side by side; the gradient is this
    rank's columns of the output's (the rest of the step is the same on
    every rank of the row)."""

    @staticmethod
    def forward(ctx, y, group, size, index):
        ctx.index, ctx.n = index, y.shape[-1]
        stacked = _all_gather(y.contiguous(), group, size)  # (size, ..., n)
        return stacked.movedim(0, -2).reshape(y.shape[:-1] + (size * ctx.n,))

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.index * ctx.n, ctx.n).contiguous(), None, None, None


class _ReduceFromMP(torch.autograd.Function):
    """The sum over the mp group; the gradient passes through."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(frozen=True)
class LinearShard:
    """How a ``TorchDense`` computes with a sharded weight
    (``TorchDense.forward`` hands it the input, in the weight's dtype)."""

    kind: str  # "column" or "row"
    mesh: Mesh
    bias_sharded: bool = False

    def __call__(self, x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
        mesh = self.mesh
        x = _CopyToMP.apply(x, mesh.mp_group)
        if self.kind == "column":
            y = F.linear(x, weight, bias if self.bias_sharded else None)
            y = _GatherFromMP.apply(y, mesh.mp_group, mesh.mp, mesh.mp_index)
        else:
            n = weight.shape[1]
            y = _ReduceFromMP.apply(F.linear(x.narrow(-1, mesh.mp_index * n, n), weight), mesh.mp_group)
        return y if bias is None or self.bias_sharded else y + bias


# -- shard_params_by_rule ---------------------------------------------------------------


def _spec(spec, p: Tensor, name: str) -> Tuple:
    spec = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
    if len(spec) > p.dim() or any(s not in (None, "mp") for s in spec):
        raise ValueError(f"{name}: spec {spec} for a tensor of shape {tuple(p.shape)}")
    return spec + (None,) * (p.dim() - len(spec))


def shard_params_by_rule(
    net: nn.Module, mesh: Mesh, rules: Sequence[Tuple[str, Any]], min_hits: int = 1, optimizer=None
) -> Dict[str, Tuple]:
    """Shard the parameters of ``net`` whose name a rule's regex
    ``search``es over ``mesh``'s mp axis; everything else stays replicated.
    ``rules``: (regex, spec) pairs, the first match wins; every rule must
    match at least ``min_hits`` parameters. ``optimizer`` (a train state's:
    one torch optimizer or a ``GroupOptimizer``) has its state of those
    parameters sharded too. Returns name -> spec of the parameters a rule
    matched (all of them, sharded or not)."""
    compiled = [(re.compile(pattern), spec) for pattern, spec in rules]
    hits = [0] * len(compiled)
    owners = dict(net.named_modules())
    plan: Dict[str, Tuple] = {}
    for name, p in net.named_parameters():
        for i, (pattern, spec) in enumerate(compiled):
            if pattern.search(name):
                hits[i] += 1
                plan[name] = _spec(spec, p, name)
                break
    for (pattern, _spec_), n in zip(compiled, hits):
        if n < min_hits:
            raise ValueError(
                f"sharding rule {pattern.pattern!r} matched {n} params (expected >= {min_hits}) "
                "- was a submodule renamed?"
            )
    layers: Dict[str, Dict[str, Tuple]] = {}
    for name, spec in plan.items():
        if "mp" not in spec:
            continue
        owner, _, leaf = name.rpartition(".")
        layer = owners.get(owner)
        if not isinstance(layer, TorchDense) or leaf not in ("weight", "bias"):
            raise NotImplementedError(f"{name} ({type(layer).__name__}, spec {spec}): {UNSUPPORTED}")
        layers.setdefault(owner, {})[leaf] = spec
    kinds = {}
    for owner, specs in layers.items():
        kind = {("mp", None): "column", (None, "mp"): "row"}.get(specs.get("weight"))
        if kind is None or ("bias" in specs and kind != "column"):
            raise NotImplementedError(f"{owner} ({specs}): {UNSUPPORTED}")
        kinds[owner] = kind
        for leaf, spec in specs.items():
            p = getattr(owners[owner], leaf)
            if shard_of(p) is not None:
                raise ValueError(f"{owner}.{leaf} is sharded already")
            dim = spec.index("mp")
            if p.shape[dim] % mesh.mp:
                raise ValueError(f"{owner}.{leaf}: dim {dim} of {tuple(p.shape)} does not split over mp={mesh.mp}")
    if mesh.mp == 1:
        return plan
    from tacorl_tpu_torch.core.optimizers import torch_optimizers

    states = [opt.state for opt in torch_optimizers(optimizer)] if optimizer is not None else []
    with torch.no_grad():
        for owner, specs in layers.items():
            layer = owners[owner]
            for leaf, spec in specs.items():
                p = getattr(layer, leaf)
                shard = Shard(spec.index("mp"), mesh, tuple(p.shape))
                for state in states:
                    for k, v in state.get(p, {}).items():
                        if torch.is_tensor(v) and v.shape == p.shape:
                            state[p][k] = shard.take(v)
                p.data = shard.take(p.data)
                p._mp_shard = shard
            layer.tp = LinearShard(kinds[owner], mesh, "bias" in specs)
    return plan


# -- checkpoints: full tensors on disk -------------------------------------------------


def _sharded(net: nn.Module) -> Dict[str, Shard]:
    return {name: shard_of(p) for name, p in net.named_parameters() if shard_of(p) is not None}


def _optimizer_states(optimizer, state_dict) -> List[Tuple[List[Tensor], dict]]:
    """(parameters in the state dict's index order, the state dict) of each
    torch optimizer of ``optimizer``."""
    from tacorl_tpu_torch.core.optimizers import GroupOptimizer

    pairs = (
        [(g.optimizer, state_dict[name]) for name, g in optimizer.groups.items()]
        if isinstance(optimizer, GroupOptimizer) else [(optimizer, state_dict)]
    )
    return [([p for group in opt.param_groups for p in group["params"]], sd) for opt, sd in pairs]


def _map_optimizer(optimizer, state_dict, fn):
    """A copy of an optimizer's state dict with ``fn(shard, tensor,
    parameter)`` applied to the state tensors (not the step count) of each
    sharded parameter."""
    from tacorl_tpu_torch.core.optimizers import GroupOptimizer

    out = []
    for params, sd in _optimizer_states(optimizer, state_dict):
        state = {}
        for i, s in sd["state"].items():
            shard = shard_of(params[i])
            state[i] = {k: fn(shard, v, params[i]) if shard is not None and torch.is_tensor(v) and v.dim() else v
                        for k, v in s.items()}
        out.append(dict(sd, state=state))
    if isinstance(optimizer, GroupOptimizer):
        return dict(zip(optimizer.groups, out))
    return out[0]


def gathered_state_dict(net: nn.Module, optimizer, net_sd: dict, opt_sd: dict) -> Tuple[dict, dict]:
    """The net's and optimizer's state dicts with every mp shard gathered
    into its full tensor (a collective of each mp group: every rank calls
    it); the state dicts themselves without a shard."""
    shards = _sharded(net)
    if not shards:
        return net_sd, opt_sd
    net_sd = {k: shards[k].gather(v) if k in shards else v for k, v in net_sd.items()}
    return net_sd, _map_optimizer(optimizer, opt_sd, lambda shard, v, p: shard.gather(v))


def local_state_dict(net: nn.Module, optimizer, net_sd: dict, opt_sd: dict) -> Tuple[dict, dict]:
    """Full tensors of a state dict (a checkpoint of any ``mp``) cut to this
    rank's shards of a sharded net; the state dicts themselves without a
    shard."""
    shards = _sharded(net)
    if not shards:
        return net_sd, opt_sd

    def cut(shard, v, p=None):
        return shard.take(v) if tuple(v.shape) == shard.full else v

    net_sd = {k: cut(shards[k], v) if k in shards else v for k, v in net_sd.items()}
    return net_sd, _map_optimizer(optimizer, opt_sd, cut)
