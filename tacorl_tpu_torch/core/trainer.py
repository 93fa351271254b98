"""Training orchestration (port of tacorl_tpu/core/trainer.py): the epoch and
step loop on one explicit device, validation, checkpoints with auto-resume,
callbacks.

What the JAX trainer does, the port does the same way:
  * the online-RL hooks, in the JAX order: ``datamodule.set_module(module)``
    and ``module.populate(None)`` (the replay buffer's warm-start fill)
    before ``datamodule.setup()``, and ``module.save_checkpoint_extras()``
    (the buffer's snapshot) after each checkpoint;
  * init, or auto-resume from the latest checkpoint; a resumed run starts
    at epoch 0 with ``global_step`` from the checkpoint (so its loader
    replays epoch 0's order, as the JAX trainer's does);
  * ``set_epoch`` and the callback hooks around each epoch, the module's
    ``step_scalars`` passed into every step;
  * batches reach the step already on the device: the loader's threads pin
    them (on a card), ``data/loader.py:DevicePut`` copies them on a side
    stream ``prefetch_to_device`` batches ahead;
  * the step's metrics stay on the device; a logging step copies them to
    the host in one batch, so only logging steps wait for the device;
  * the loader's own spans (``utils/profiling.RECORDER``) are kept while a
    ``torch.profiler`` session runs: each step and each epoch's end call
    ``follow_profiler``, so a profile of ``fit`` holds the loader threads'
    phases beside the ``trainer/*`` ranges;
  * ``validate`` (``limit_val_batches``) after every ``val_every_n_epochs``
    epochs, a checkpoint after every ``ckpt_every_n_epochs`` and at the stop,
    callback state beside the checkpoints keyed by class name (the legacy
    positional list format still loads).

K-step dispatch (``steps_per_call = K > 1``), as the JAX trainer does it:
a module that ``supports_scan`` runs K steps a call through
``make_scanned_train_step`` (on a card, K replays of the step's CUDA graph;
on the CPU, the eager step K times); K is clamped to the epoch's batch
count; K host batches make one chunk (a trailing partial chunk is dropped
and logged), stacked to (K, B, ...) leaves on the device; ``step_scalars``
is read once a chunk; ``global_step`` advances by K; the logging condition
is unchanged, so a chunk logs its last step's metrics when the step it ends
on is a multiple of ``log_every_n_steps``; ``on_train_batch_end`` (which
gets the stacked chunk as ``_current_batch``) and the stop check run once a
chunk, so ``max_steps`` may be overshot by up to K - 1. Online modules
(``supports_scan = False``) train one step at a time under any K.

Data-parallel (W ranks under a process group, ``parallel/mesh.py``), as
the JAX trainer's one controller over a mesh (``mesh``: a ``(dp, mp)``
mesh from ``create_mesh``, by default every rank on ``dp``; the state is
replicated over ``mp``, as JAX's ``replicated_sharding`` does, and the
ranks of one dp index take the same rows): ``batch_size`` is the
global batch, and each rank's loader gives it its dp rows of every global
batch (train and validation; ``limit_val_batches`` counts global batches);
the state is broadcast from rank 0 after init or resume; the steps run
inside ``sharded_draws``, so a rank's draws are its rows of the global
batch's; the steps average their gradients over the ranks; a logging
step's metrics and the validation means are averaged over the dp ranks
before they reach the host, so every rank logs, ranks checkpoints and
stops on the same numbers; rank 0 alone writes (``core/logging.py``,
``core/checkpoint.py``, the callbacks' state). At one rank each of these
changes nothing.

Randomness: the JAX train step folds its key with ``state.step``, so a
resumed run draws what an uninterrupted one draws. The port gets the same:
before each train step the module's ``torch.Generator`` and the device's
default generator (which dropout draws from) are seeded from
``(seed, global_step)`` (``core/graphs.py:seed_generators``; step i of a
chunk from ``(seed, global_step + i)``), before each validation batch from
``(seed + 1, i)``. An optional ``draw_source(split, index)`` ("train" with
the global step, "validation" with the batch index) returns extra keyword
arguments for that call of the step, e.g. the JAX key chain's draws in the
parity tests.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.profiler import record_function

from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.graphs import seed_generators, step_seed
from tacorl_tpu_torch.core.logging import MetricsSink
from tacorl_tpu_torch.core.optimizers import set_capturable
from tacorl_tpu_torch.data.loader import DevicePut, device_prefetch
from tacorl_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    create_mesh,
    current_mesh,
    rank,
    replicate,
    sharded_draws,
    sync_metrics,
)
from tacorl_tpu_torch.utils import resolve_device
from tacorl_tpu_torch.utils.profiling import follow_profiler

logger = logging.getLogger("tacorl_tpu_torch")

__all__ = ["Trainer", "step_seed"]

DrawSource = Callable[[str, int], Optional[Dict[str, Any]]]


def _chunks(batch_iter, k: int):
    """Group K per-step batches into one list (``DevicePut`` stacks it to
    (K, B, ...) leaves); a trailing partial chunk is dropped and logged,
    as the JAX trainer's ``_stack_chunks`` does."""
    chunk = []
    for batch in batch_iter:
        chunk.append(batch)
        if len(chunk) == k:
            yield chunk
            chunk = []
    if chunk:
        logger.info(
            "scanned dispatch dropped a trailing partial chunk of %d/%d "
            "batches this epoch",
            len(chunk),
            k,
        )


def _host_floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Every metric as a Python float, in one device-to-host copy."""
    if not metrics:
        return {}
    values = torch.stack([torch.as_tensor(v).detach().float().reshape(()) for v in metrics.values()])
    return dict(zip(metrics, values.cpu().tolist()))


class Trainer:
    def __init__(
        self,
        max_epochs: Optional[int] = None,
        max_steps: Optional[int] = None,
        val_every_n_epochs: int = 1,
        limit_val_batches: Optional[int] = None,
        ckpt_manager: Optional[CheckpointManager] = None,
        sink: Optional[MetricsSink] = None,
        callbacks: Sequence[Any] = (),
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        ckpt_every_n_epochs: int = 1,
        prefetch_to_device: int = 1,
        log_every_n_steps: int = 50,
        steps_per_call: int = 1,
        draw_source: Optional[DrawSource] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        # None: create_mesh() when fit starts (the process group may be
        # joined after the trainer is made)
        self.mesh = mesh
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.val_every_n_epochs = val_every_n_epochs
        self.limit_val_batches = limit_val_batches
        self.ckpt = ckpt_manager
        self.sink = sink or MetricsSink()
        self.callbacks = list(callbacks)
        self.seed = seed
        self.ckpt_every_n_epochs = ckpt_every_n_epochs
        self.prefetch_to_device = prefetch_to_device
        self.log_every_n_steps = log_every_n_steps
        self.steps_per_call = steps_per_call
        self.draw_source = draw_source
        self.global_step = 0
        self.epoch = 0
        self.datamodule = None
        self.state = None
        self._last_val_metrics: Dict[str, float] = {}
        self._current_batch = None
        # the StepGraph of a K-step run on a card (captures, replays and
        # static inputs), else None
        self.step_graph = None
        # host-side measurements: ms the training thread waited for each
        # batch (loader + copy enqueue), and each checkpoint save's
        # (step, bytes, ms)
        self.batch_wait_ms: List[float] = []
        self.saves: List[tuple] = []

    # -- helpers -----------------------------------------------------------

    def _cb(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def _should_stop(self) -> bool:
        return self.max_steps is not None and self.global_step >= self.max_steps

    def _draws(self, split: str, index: int) -> Dict[str, Any]:
        if self.draw_source is None:
            return {}
        return self.draw_source(split, index) or {}

    def _loader(self, loader):
        """The loader as this trainer runs it: pinned on a card, and giving
        this rank its rows of each global batch (a ``batch_size`` the ranks
        do not divide raises)."""
        loader.pin_memory = self.device.type == "cuda"
        loader.shard = batch_sharding()
        loader.shard.rows(loader.batch_size)
        return loader

    # -- main loop -----------------------------------------------------------

    def fit(self, module, datamodule, resume: bool = True) -> Any:
        if resolve_device(module.device) != self.device:
            raise ValueError(f"module on {module.device}, trainer on {self.device}")
        self.datamodule = datamodule
        if self.mesh is None:
            self.mesh = create_mesh()
        elif self.mesh is not current_mesh():
            raise ValueError("the trainer's mesh is not the last one create_mesh made, which the collectives use")
        online = hasattr(datamodule, "set_module")
        if online:
            datamodule.set_module(module)
        if hasattr(module, "populate"):
            module.populate(None)  # the warm-start fill (random strategy)
        datamodule.setup()
        train_loader = self._loader(datamodule.train_loader())

        if resume and self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.state = module.restore_state(self.ckpt)
            self.global_step = int(self.state.step)
            logger.info("resumed from step %d", self.global_step)
        else:
            if online:
                # the JAX trainer initializes from one batch of the loader
                # it trains with; the replay-buffer loader's generator moves
                # on by that draw, so an online run draws and drops it too
                next(iter(train_loader))
            self.state = module.init_state(self.seed)
        replicate(self.state)
        use_scan = self.steps_per_call > 1 and getattr(module, "supports_scan", False)
        if use_scan:
            # never more steps a call than an epoch gives (partial chunks are
            # dropped; a larger K would silently train nothing)
            self.steps_per_call = max(1, min(self.steps_per_call, len(train_loader)))
            use_scan = self.steps_per_call > 1
        if use_scan:
            train_step = module.make_scanned_train_step()
            self.step_graph = train_step.graph
        else:
            train_step = module.make_train_step()
        if self.step_graph is None:
            # a checkpoint of a graphed run loads in capturable mode; the
            # step graph puts the optimizer in that mode when it captures
            set_capturable(self.state.optimizer, False)
        val_step = module.make_val_step()
        put = DevicePut(self.device)

        self._load_callback_states()
        self._cb("on_fit_start", module)
        epoch = self.epoch
        while not self._should_stop() and (self.max_epochs is None or epoch < self.max_epochs):
            self.epoch = epoch
            if hasattr(module, "set_epoch"):
                module.set_epoch(epoch)
            self._cb("on_epoch_start", module, epoch)
            t_epoch = time.time()
            n_batches = 0
            host_batches = iter(train_loader)
            chunks = _chunks(host_batches, self.steps_per_call) if use_scan else host_batches
            batches = device_prefetch(chunks, put, self.prefetch_to_device)
            while True:
                follow_profiler()
                t0 = time.perf_counter()
                with record_function("trainer/next_batch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                self.batch_wait_ms.append((time.perf_counter() - t0) * 1e3)
                self._current_batch = batch  # callbacks may probe it
                if use_scan:
                    with record_function("trainer/train_step"), sharded_draws():
                        self.state, metrics = train_step(
                            self.state, batch, module.step_scalars(), seed=self.seed,
                            draw_source=self.draw_source,
                        )
                    step_inc = self.steps_per_call
                else:
                    seed_generators(module, self.device, self.seed, self.global_step)
                    draws = self._draws("train", self.global_step)
                    with record_function("trainer/train_step"), sharded_draws():
                        self.state, metrics = train_step(
                            self.state, batch, module.step_scalars(), **draws
                        )
                    step_inc = 1
                self.global_step += step_inc
                n_batches += step_inc
                if self.global_step % self.log_every_n_steps == 0:
                    with record_function("trainer/log"):
                        self.sink.log(_host_floats(sync_metrics(metrics)), self.global_step, prefix="train")
                self._cb("on_train_batch_end", module, metrics, self.global_step)
                if self._should_stop():
                    break
            batches.close()
            host_batches.close()  # a stop mid-epoch cancels the loader's queued batches
            follow_profiler()
            graph = self.step_graph
            logger.info(
                "epoch %d: %d steps in %.1fs%s", epoch, n_batches, time.time() - t_epoch,
                "" if graph is None else f", step graph captures {graph.captures} replays {graph.replays}",
            )
            if n_batches == 0:
                raise RuntimeError(
                    "epoch produced zero train steps: empty dataset or "
                    "steps_per_call larger than the epoch"
                )

            if (epoch + 1) % self.val_every_n_epochs == 0:
                self.validate(module, datamodule, val_step)
            self._cb("on_epoch_end", module, epoch)
            if self.ckpt is not None and (
                (epoch + 1) % self.ckpt_every_n_epochs == 0 or self._should_stop()
            ):
                self._save(module)
            epoch += 1
        self._cb("on_fit_end", module)
        return self.state

    def _save(self, module) -> None:
        t0 = time.perf_counter()
        self.ckpt.save(self.global_step, self.state, metrics=self._last_val_metrics)
        ms = (time.perf_counter() - t0) * 1e3
        path = self.ckpt.ckpt_dir / str(self.global_step) / "state.pt"
        nbytes = path.stat().st_size if path.is_file() else 0
        self.saves.append((self.global_step, nbytes, ms))
        logger.info("saved step %d: %d bytes in %.1f ms", self.global_step, nbytes, ms)
        self._save_callback_states()
        if hasattr(module, "save_checkpoint_extras"):
            module.save_checkpoint_extras()

    # -- callback state rides next to the checkpoints -------------------------

    def _callback_state_path(self):
        return self.ckpt.dir / "callbacks_state.json" if self.ckpt else None

    def _callback_key(self, cb) -> str:
        """The class name; duplicates of one class as "Name#i" by their
        order among the callbacks of that class."""
        name = type(cb).__name__
        same = [c for c in self.callbacks if type(c).__name__ == name]
        if len(same) == 1:
            return name
        return f"{name}#{same.index(cb)}"

    def _save_callback_states(self) -> None:
        path = self._callback_state_path()
        if path is None:
            return
        states = {}
        for cb in self.callbacks:
            state = cb.state_dict()
            if state:
                states[self._callback_key(cb)] = state
        if states and rank() == 0:
            path.write_text(json.dumps(states))

    def _load_callback_states(self) -> None:
        path = self._callback_state_path()
        if path is None or not path.exists():
            return
        states = json.loads(path.read_text())
        if isinstance(states, list):  # legacy positional format
            for cb, state in zip(self.callbacks, states):
                cb.load_state_dict(state)
            return
        for cb in self.callbacks:
            # the exact (possibly #-suffixed) key, else the bare class name
            state = states.get(self._callback_key(cb)) or states.get(type(cb).__name__)
            if state:
                cb.load_state_dict(state)

    # -- validation ------------------------------------------------------------

    def validate(self, module, datamodule, val_step=None) -> Dict[str, float]:
        """A validation pass; returns the ``validation/``-prefixed mean
        metrics plus what rollout callbacks added (e.g. ``val_accuracy``),
        the dict the checkpoint monitor sees. Per-batch metrics stay on the
        device and reach the host in one copy at the end; ``outputs`` (the
        val step's, one dict per batch) stay on the device."""
        val_loader = datamodule.val_loader()
        if val_loader is None:
            self._last_val_metrics = {}
            self._cb("on_validation_end", module, {}, [], self.epoch)
            return dict(self._last_val_metrics)
        if val_step is None:
            val_step = module.make_val_step()
        put = DevicePut(self.device)
        per_batch: Dict[str, List[torch.Tensor]] = {}
        outputs = []
        with record_function("trainer/validate"):
            for i, batch in enumerate(self._loader(val_loader)):
                if self.limit_val_batches is not None and i >= self.limit_val_batches:
                    break
                seed_generators(module, self.device, self.seed + 1, i)
                with sharded_draws():
                    metrics, out = val_step(
                        self.state, put.ready(put(batch)), module.step_scalars(),
                        **self._draws("validation", i),
                    )
                for k, v in metrics.items():
                    per_batch.setdefault(k, []).append(torch.as_tensor(v).detach().float().reshape(()))
                outputs.append(out)
        mean_metrics = {}
        if per_batch:
            stacked = torch.stack([torch.stack(v) for v in per_batch.values()])
            stacked = sync_metrics({"all": stacked})["all"].cpu().numpy()
            mean_metrics = {k: float(np.mean(row.astype(np.float64))) for k, row in zip(per_batch, stacked)}
        self.sink.log(mean_metrics, self.global_step, prefix="validation")
        self._last_val_metrics = {f"validation/{k}": v for k, v in mean_metrics.items()}
        self._cb("on_validation_end", module, mean_metrics, outputs, self.epoch)
        return dict(self._last_val_metrics)
