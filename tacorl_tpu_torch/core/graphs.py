"""The train step as a CUDA graph, replayed once per step: the card's
counterpart of the JAX package's scanned K-step dispatch
(``tacorl_tpu/modules/base.py:make_scanned_train_step``).

``StepGraph`` captures one train step of a module at the shapes and dtypes
of a batch (and of the step's explicit draws), with static input buffers
for every tensor leaf and a 0-d device tensor for every step scalar, and
replays it: before each replay the step's batch, draws and scalars are
copied into the static buffers and the module's generator and the
device's default generator are seeded from ``(seed, index)``, as the
trainer seeds an eager step. Philox reads a registered generator's seed
and offset when a graph is replayed, so a replay draws what the eager step
draws after the same seeding: one graph replayed K times keeps the draws of
K eager steps (a graph of K steps would share one seed).

Capture: the step runs twice on a side stream first (lazy state: the
optimizer's moments, cached device tables, the kernels' one-time occupancy
checks, cuBLAS and cuDNN workspaces), then parameters, buffers and
optimizer state are restored in place and one step is captured into a
private memory pool. The optimizers are switched to ``capturable=True``
(their step counts live on the device). A batch of other shapes or dtypes,
other draws or other scalar names captures again; it never runs eagerly.
So do parameters or buffers that moved since the capture: the graph holds
their addresses, and an eager step between replays can move them (a
validation pass made cuDNN repack a biRNN's weights into a new buffer, and
the replays after it trained memory the net no longer read). Two rollout
agents in a row can move an RNN's weights and move them back (each
``flatten_parameters()`` repacks them into a new buffer, and the allocator
can hand the first one back): the addresses are then the capture's, and
the replay trains what a new capture would, bit for bit
(results/torch_r16_stage2_hold/).
Any failure of the warm-up, the capture or a replay raises, naming the
module and what failed.

Under a process group the step's gradient all-reduce
(``parallel/mesh.py:all_reduce_mean``) is captured in the graph, so a
chunk stays one replay a step on each rank: every rank runs the same two
warm-up steps (their collectives in the same order, after the state's
broadcast made the communicator) and captures the same step. Only NCCL
collectives can be captured: under a gloo group (the CPU tests, two ranks
sharing one card) a capture raises, naming the reason, and such a run
takes ``trainer.steps_per_call=1``. On a ``(dp, mp)`` mesh with
mp-sharded layers (``parallel/tensor_parallel.py``) the mp collectives
(each sharded layer's all-gather and input-gradient all-reduce, the global
norm's mp sum) are captured the same way; shard before the first capture,
or the moved parameters make the next call capture again.

``seed_generators`` and ``step_seed`` are the per-step seeding both paths
share (``core/trainer.py``).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tacorl_tpu_torch.core.optimizers import set_capturable, torch_optimizers
from tacorl_tpu_torch.data.loader import flatten, unflatten
from tacorl_tpu_torch.parallel.mesh import backend, fold_rank

__all__ = ["StepGraph", "seed_generators", "step_seed"]

WARMUP_STEPS = 2


def step_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed from (seed, index)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def seed_generators(module, device: torch.device, seed: int, index: int) -> None:
    """Seed the module's generator and the device's default generator (which
    dropout draws from) from (seed, index). At more than one rank the
    default generator's seed has the rank folded in: dropout cannot draw
    the global batch's masks, so each rank draws its own (ROADMAP Queue 3)."""
    s = step_seed(seed, index)
    if getattr(module, "generator", None) is not None:
        module.generator.manual_seed(s)
    if device.type == "cuda":
        torch.cuda.default_generators[device.index or torch.cuda.current_device()].manual_seed(fold_rank(s))
    else:
        torch.default_generator.manual_seed(fold_rank(s))


def _inputs(batch, draws) -> List[Tuple[Tuple, Any]]:
    """The (path, leaf) pairs of a step's batch and draws, numpy arrays as
    tensors (a static input each, keyed like one)."""
    pairs = flatten({"batch": batch, "draws": draws or {}})
    return [(p, torch.as_tensor(x) if isinstance(x, np.ndarray) else x) for p, x in pairs]


def _signature(pairs) -> Tuple:
    """What a capture is specific to: each tensor leaf's path, shape and
    dtype, and each other leaf's value."""
    return tuple(
        (p, tuple(x.shape), x.dtype) if torch.is_tensor(x) else (p, repr(x)) for p, x in pairs
    )


class StepGraph:
    """``step_fn(state, batch, scalars, **draws) -> (state, metrics)`` of
    ``module`` as a CUDA graph; ``captures`` and ``replays`` count what it
    did, ``batch`` is the static batch (the last replayed step's)."""

    def __init__(self, module, step_fn):
        self.module, self.step_fn = module, step_fn
        self.name = type(module).__name__
        self.device = module.device
        self.key = self.addresses = None
        self.graph = self.batch = None
        self.captures = self.replays = 0

    def release(self) -> None:
        """Free the captured graph (its memory pool and, under NCCL, its
        hold on the communicator); ``captures`` and ``replays`` stay. The
        next call captures again."""
        self.graph = self.metrics = self.batch = self.key = self.addresses = None

    def _fail(self, what: str, err: Exception) -> RuntimeError:
        return RuntimeError(f"{self.name}: CUDA graph {what} of the train step failed: {err}")

    def __call__(self, state, batch, scalars: Dict[str, Any], draws: Optional[Dict], seed: int, index: int):
        """One step at ``index``: the graph's metrics (overwritten by the next
        replay). ``state.step`` becomes ``index + 1``."""
        pairs = _inputs(batch, draws)
        key = (_signature(pairs), tuple(scalars))
        if key != self.key or _addresses(state) != self.addresses:
            self._capture(state, pairs, scalars, key)
        try:
            for static, (_, x) in zip(self.inputs, pairs):
                if static is not None:
                    static.copy_(x, non_blocking=True)
            for name, static in self.scalars.items():
                value = scalars[name]
                static.copy_(value) if torch.is_tensor(value) else static.fill_(float(value))
            seed_generators(self.module, self.device, seed, index)
            self.graph.replay()
        except Exception as err:
            raise self._fail("replay", err) from err
        self.replays += 1
        state.step = index + 1
        return self.metrics

    # -- capture ---------------------------------------------------------------

    def _capture(self, state, pairs, scalars, key) -> None:
        if backend() not in (None, "nccl"):
            raise RuntimeError(
                f"{self.name}: a CUDA graph of the train step cannot capture {backend()} "
                "collectives (the gradient all-reduce); train with NCCL or with "
                "trainer.steps_per_call=1"
            )
        self.graph = self.metrics = self.batch = None
        self.inputs = [
            torch.empty(x.shape, dtype=x.dtype, device=self.device) if torch.is_tensor(x) else None
            for _, x in pairs
        ]
        for static, (_, x) in zip(self.inputs, pairs):
            if static is not None:
                static.copy_(x)
        self.scalars = {
            k: torch.zeros((), dtype=torch.float32, device=self.device) for k in scalars
        }
        for name, static in self.scalars.items():
            static.fill_(float(scalars[name]))
        tree = unflatten([(p, s if s is not None else x) for s, (p, x) in zip(self.inputs, pairs)])
        batch, draws = tree["batch"], tree.get("draws") or {}
        step0 = state.step
        set_capturable(state.optimizer, True)
        saved = _snapshot(state)
        try:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side), warnings.catch_warnings():
                # capturable optimizers warn when they step outside a capture
                warnings.simplefilter("ignore", UserWarning)
                for _ in range(WARMUP_STEPS):
                    self.step_fn(state, batch, self.scalars, **draws)
            torch.cuda.current_stream(self.device).wait_stream(side)
        except Exception as err:
            raise self._fail("warm-up", err) from err
        finally:
            _restore(state, saved)
            state.step = step0
        graph = torch.cuda.CUDAGraph()
        try:
            if getattr(self.module, "generator", None) is not None:
                graph.register_generator_state(self.module.generator)
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                _, metrics = self.step_fn(state, batch, self.scalars, **draws)
        except Exception as err:
            raise self._fail("capture", err) from err
        finally:
            state.step = step0
        self.graph, self.metrics, self.key, self.batch = graph, metrics, key, batch
        self.addresses = _addresses(state)
        self.captures += 1


def _addresses(state) -> Tuple[int, ...]:
    """Where the net's parameters and buffers live. The graph reads and
    writes them at the addresses it was captured with; a step outside it
    can move them (cuDNN repacks an RNN's weights into a new buffer when it
    finds them changed), and a graph replayed after such a move would
    update memory the net no longer reads."""
    net = state.net
    return tuple(t.data_ptr() for t in net.parameters()) + tuple(t.data_ptr() for t in net.buffers())


def _snapshot(state) -> Dict[str, Any]:
    """Copies of the net's parameters and buffers and of the optimizer
    state that exists."""
    return {
        "net": {k: v.detach().clone() for k, v in state.net.state_dict().items()},
        "optimizer": [
            {p: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)} for p, s in opt.state.items()}
            for opt in torch_optimizers(state.optimizer)
        ],
    }


@torch.no_grad()
def _restore(state, saved) -> None:
    """Put the snapshot back in place (the graph holds these addresses);
    optimizer state the warm-up created is zeroed, which is what a fresh
    optimizer's first step starts from."""
    for k, v in state.net.state_dict().items():
        v.copy_(saved["net"][k])
    for opt, before in zip(torch_optimizers(state.optimizer), saved["optimizer"]):
        for p, s in opt.state.items():
            for k, v in s.items():
                if torch.is_tensor(v):
                    v.copy_(before[p][k]) if p in before else v.zero_()
