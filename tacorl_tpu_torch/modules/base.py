"""Algorithm-module base (port of tacorl_tpu/modules/base.py): config-driven
construction on an explicit device. A module owns its network definition,
the train step it makes, and host-side schedule state (e.g. ``kl_beta``).

``make_scanned_train_step`` is the counterpart of the JAX package's scanned
K-step dispatch: K train steps over a stacked (K, B, ...) batch with one
``scalars`` dict, returning the last step's metrics. On a CPU device it
loops the eager step (the plain version); on a card each step is a replay
of the step's CUDA graph (``core/graphs.py``)."""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Union

import torch

from tacorl_tpu_torch.core.graphs import StepGraph, seed_generators
from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.data.loader import flatten, tree_map
from tacorl_tpu_torch.utils import resolve_device

__all__ = ["AlgorithmModule", "seeded_init", "step_scalar"]


class AlgorithmModule:
    name: str = "module"

    def __init__(
        self,
        cfg: Dict[str, Any],
        full_config: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.cfg = dict(cfg)
        self.full_config = full_config or {}
        self.device = resolve_device(device)
        self.build()

    # subclasses implement ------------------------------------------------
    def build(self) -> None:
        raise NotImplementedError

    def init_state(self, seed: int = 0) -> TrainState:
        raise NotImplementedError

    def make_train_step(self):
        raise NotImplementedError

    def make_val_step(self):
        raise NotImplementedError

    # scalar schedule values passed into each train step (e.g. kl_beta
    # annealing); callbacks mutate these host attributes
    def step_scalars(self) -> Dict[str, float]:
        return {}

    # pure train steps may run K to a dispatch; online modules, which step
    # the env inside their train step, set this to False
    supports_scan: bool = True

    def make_scanned_train_step(self):
        """``scanned(state, stacked_batch, scalars=None, *, seed=0,
        draw_source=None) -> (state, metrics)``: K train steps over a batch
        whose leaves are (K, B, ...), returning the last step's metrics. Step
        i of a chunk that starts at ``g = state.step`` is seeded from
        ``(seed, g + i)`` and takes ``draw_source("train", g + i)`` as its
        draws, as K single steps of the trainer are. The callable's
        ``graph`` is the ``StepGraph`` on a card, else None."""
        if not self.supports_scan:
            raise RuntimeError(
                f"{type(self).__name__} interacts with the environment "
                "inside its train step and cannot be scanned"
            )
        step = self.make_train_step()
        graph = StepGraph(self, step) if self.device.type == "cuda" else None

        def scanned(
            state: TrainState,
            stacked_batch: Dict[str, Any],
            scalars: Optional[Dict[str, Any]] = None,
            *,
            seed: int = 0,
            draw_source: Optional[Callable[[str, int], Optional[Dict[str, Any]]]] = None,
        ):
            scalars = self.step_scalars() if scalars is None else scalars
            k = len(flatten(stacked_batch)[0][1])
            start, metrics = int(state.step), {}
            for i in range(k):
                batch = tree_map(lambda x: x[i], stacked_batch)
                draws = (draw_source("train", start + i) if draw_source else None) or {}
                if graph is None:
                    seed_generators(self, self.device, seed, start + i)
                    state, metrics = step(state, batch, scalars, **draws)
                else:
                    metrics = graph(state, batch, scalars, draws, seed, start + i)
            if graph is not None:
                # the graph's outputs: the next replay overwrites them
                metrics = {name: v.clone() for name, v in metrics.items()}
            return state, metrics

        scanned.graph = graph
        return scanned

    def restore_state(self, manager, step: int = -1) -> TrainState:
        """A fresh state (``init_state``) with a checkpoint's weights,
        optimizer moments and step loaded into it."""
        state = self.init_state(0)
        state.load_state_dict(manager.restore(step, map_location=self.device))
        return state


@contextlib.contextmanager
def seeded_init(seed: int, device: torch.device):
    """Layer inits drawn from ``seed``: torch's CPU generator and, for a
    module on a card, the card's default generator (a part copied from a
    loaded module, as stage 2's from stage 1's, is reset there), both
    restored afterwards."""
    cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[device] if cuda else []):
        torch.default_generator.manual_seed(seed)
        if cuda:
            torch.cuda.default_generators[device.index or torch.cuda.current_device()].manual_seed(seed)
        yield


def step_scalar(value):
    """A step scalar as a step uses it: a tensor as it is (on a card, a
    CUDA graph's static input, read when the graph is replayed), anything
    else as a Python float. A float taken from a device tensor would be
    frozen into a graph when it is captured."""
    return value if torch.is_tensor(value) else float(value)

