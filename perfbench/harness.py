"""One run of one cell: set-up, the measured window, the check that the
timed path computed what the reference computes, and the result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``); the configuration names its reference
(``reference/<name>.py``) and its operation count (``flops/<config>.py``);
``BENCHMARK.json`` names the metrics, each read by
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric.

The run drives ``tacorl_tpu_torch.train.main``, the user's entry point,
with the configuration's experiment and the cell's trainer settings, and
rides it with ``Probe``, a trainer callback (the port's ``Callback``):

* at fit start it loads the weights the benchmark made from the seed into
  the program's network, turns checkpoints off (no save falls in the
  window) and listens to the trainer's per-step ``draw_source`` call,
  which the trainer makes before each step of a K-step chunk;
* before steps 2, 3 and 4 it copies what the steps before left: each
  step's loss from the step graph's outputs, the Adam moments after step 1
  and the parameters after step 3 (on the CPU, which has no step graph,
  the cell runs at K = 1 and the copies are taken at each step's end);
* after ``warm_chunks`` chunks it synchronises and opens the window; the
  window closes at the synchronise after the first chunk that ends
  ``--seconds`` later (``--trace 1``: after ``trace_chunks`` chunks, the
  profiler started a chunk before the window opens), and the probe sets
  ``trainer.max_steps`` to stop the run there;
* on a card, it records a CUDA event on the training stream at the
  ``draw_source`` call of each window chunk's first step (once the chunk's
  batch is on the card, before its first step's input copies) and another
  at the chunk's end, so that ``chunk_ms`` holds each chunk's time on the
  card with the waits for the loader between chunks left out.

After the run the program's state is freed and the reference trains the
first three steps again, on batches it reads from the data set's files
itself, from the same weights; ``compare.judge`` decides ``correct``.

A cell on more than one chip runs one process a card (``launch.py`` starts
them, each calling ``run`` as rank ``RANK`` of ``WORLD_SIZE``), and
``train.main`` joins the process group through the program's own
``init_distributed``. Every rank warms the same chunks; at the first step
of each window chunk the ranks meet at a barrier of the program's host
group before the start event, so a peer's late batch falls between
chunks and not in the chunk's first all-reduce; at each window chunk's end
rank 0's decision to close goes to every rank, so all stop at one step.
After step 3 each rank's parameters are held against rank 0's (the
norms of their differences go to rank 0, ``rank_gap``). Rank 0 alone
profiles, runs the reference (the W ranks' shares of each global batch,
``reference/<name>.py``) and makes the result.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from perfbench import compare, data, faults, peaks, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tacorl_tpu")
SNAP_STEPS = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """A module from a file of the benchmark, by path (metric names may
    hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The reader of ``metric`` (``metrics/<metric>.py``)."""
    return load_file(HERE / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}")


def cell(name: str) -> tuple:
    """(workload, configuration) of the cell ``name``."""
    workload = load_json(HERE / "workloads" / f"{name}.json")
    return workload, load_json(HERE / "configs" / f"{workload['config']}.json")


def benchmark_metrics(cell_name: str, trace_on: bool) -> List[dict]:
    """The metrics ``BENCHMARK.json`` asks of this cell in this kind of
    run: end-to-end without the trace, per-layer with it."""
    spec = load_json(ROOT / "BENCHMARK.json")
    group = spec["per_layer"] if trace_on else spec["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = ROOT / "build" / "perfbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event() -> torch.cuda.Event:
    """A timing event recorded on the current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


def _optimizers(optimizer) -> list:
    groups = getattr(optimizer, "groups", None)
    return [g.optimizer for g in groups.values()] if groups else [optimizer]


class Record:
    """What a run measured, as the metric readers see it."""

    def __init__(self, workload: dict, config: dict):
        self.workload, self.config = workload, config
        self.setup_s = self.window_s = None
        self.world = 1
        self.steps = self.closed_at = 0
        self.batch_wait_ms: List[float] = []
        # each window chunk's milliseconds on the card (CUDA events)
        self.chunk_ms: List[float] = []
        self.trace: Optional[trace.Trace] = None
        self.step_flops: Dict[str, float] = {}

    @property
    def windows(self) -> int:
        """Training windows (batch rows, all ranks) trained in the window."""
        return self.steps * int(self.workload["batch_size"])

    def least_step_s(self) -> float:
        """The least time of one step at the card's peaks, each op class at
        the precision the configuration states."""
        by_precision: Dict[str, float] = {}
        for op, flops in self.step_flops.items():
            p = self.config["precision"][op]
            by_precision[p] = by_precision.get(p, 0.0) + flops
        return peaks.least_seconds(by_precision)


def make_probe(base):
    """The probe, a subclass of the port's ``Callback`` ``base``."""

    class Probe(base):
        def __init__(self, weights, record: Record, seconds: float, traced: bool, t0: float,
                     loss_names, device: torch.device):
            self.weights, self.record, self.seconds, self.traced = weights, record, seconds, traced
            self.t0, self.loss_names, self.device = t0, tuple(loss_names), device
            w = record.workload
            self.warm, self.trace_chunks = int(w["warm_chunks"]), int(w["trace_chunks"])
            self.chunks, self.opened, self.closed = 0, None, False
            self.losses: Dict[int, Dict[str, torch.Tensor]] = {}
            self.moments = self.params = None
            self.profiler = None
            self.timing = device.type == "cuda"
            self.chunk_start = None
            self.chunk_events: List[tuple] = []
            self.rank_norms = None

        def on_fit_start(self, trainer, module):
            from tacorl_tpu_torch.parallel import mesh

            self.mesh = mesh
            self.rank, self.world = mesh.rank(), mesh.world()
            self.record.world = self.world
            # the profiler and the window's marker on rank 0 alone
            self.profiled = self.traced and self.rank == 0
            trainer.ckpt = None
            net = trainer.state.net
            unknown = set(self.weights) - set(net.state_dict())
            if unknown:
                raise KeyError(f"the program's network has no {sorted(unknown)[:5]}")
            with torch.no_grad():
                net.load_state_dict(self.weights, strict=len(self.weights) == len(net.state_dict()))
            trainer.draw_source = self._before_step
            self.trainer = trainer

        # -- the first steps -------------------------------------------------

        def _before_step(self, split: str, index: int):
            if split != "train":
                return None
            if self.opened is None:
                graph = self.trainer.step_graph
                if getattr(graph, "metrics", None) is not None:
                    self._copy(index, graph.metrics)
            elif self.chunk_start is None:
                if self.world > 1:
                    self.mesh.barrier()
                if self.timing:
                    self.chunk_start = _event()
            return None

        def _copy(self, done: int, metrics) -> None:
            """Copies of what ``done`` finished steps left."""
            if not 1 <= done <= SNAP_STEPS or done in self.losses:
                return
            self.losses[done] = {k: metrics[k].detach().float().clone() for k in self.loss_names}
            net = self.trainer.state.net
            if done == 1:
                state = {}
                for opt in _optimizers(self.trainer.state.optimizer):
                    state.update(opt.state)
                self.moments = {n: state[p]["exp_avg"].detach().clone() for n, p in net.named_parameters()
                                if p in state}
                self.beta1 = _optimizers(self.trainer.state.optimizer)[0].param_groups[0]["betas"][0]
            if done == SNAP_STEPS:
                self.params = {n: p.detach().clone() for n, p in net.named_parameters()}
                if self.world > 1:
                    self._hold_ranks()

        def _hold_ranks(self) -> None:
            """The norm of each leaf's difference from rank 0's after step 3,
            on every rank, gathered to rank 0 (``rank_norms``, in rank
            order): rank 0's parameters broadcast over a gloo group of the
            ranks, on the host."""
            import torch.distributed as dist

            names = list(self.params)
            mine = torch.cat([self.params[n].reshape(-1).float().cpu() for n in names])
            zero = mine.clone()
            dist.broadcast(zero, src=0, group=dist.new_group(backend="gloo"))
            pieces = (mine - zero).split([self.params[n].numel() for n in names])
            norms = {n: compare.norm(d) for n, d in zip(names, pieces)}
            self.rank_norms = self.mesh.gather_objects(norms)

        # -- the window ------------------------------------------------------------

        def on_train_batch_end(self, trainer, module, metrics, step):
            if trainer.step_graph is None:
                self._copy(step, metrics)
            self.chunks += 1
            if self.chunk_start is not None:
                self.chunk_events.append((self.chunk_start, _event()))
                self.chunk_start = None
            if self.profiled and self.chunks == self.warm - 1:
                self._start_profiler()
            if self.opened is None:
                if self.chunks >= self.warm and len(self.losses) == SNAP_STEPS:
                    self._open(trainer)
                return
            if self.traced:
                done = self.chunks - self.opened >= self.trace_chunks
            else:
                done = time.perf_counter() - self.t_open >= self.seconds
            if self.world > 1:
                done = self.mesh.gather_objects(done)[0]
            if done:
                self._close(trainer)

        def _start_profiler(self) -> None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.start()

        def _open(self, trainer) -> None:
            if self.profiled and self.profiler is None:
                self._start_profiler()
            _sync(self.device)
            if self.profiled:
                self.marker = torch.profiler.record_function(trace.WINDOW)
                self.marker.__enter__()
            self.t_open = time.perf_counter()
            self.record.setup_s = self.t_open - self.t0
            self.opened, self.step0, self.wait0 = self.chunks, trainer.global_step, len(trainer.batch_wait_ms)

        def _close(self, trainer) -> None:
            _sync(self.device)
            t = time.perf_counter()
            if self.profiled:
                self.marker.__exit__(None, None, None)
                self.profiler.stop()
            self.record.window_s = t - self.t_open
            self.record.steps = trainer.global_step - self.step0
            self.record.batch_wait_ms = list(trainer.batch_wait_ms[self.wait0:])
            if self.timing:
                if len(self.chunk_events) != self.chunks - self.opened:
                    raise RuntimeError(f"{len(self.chunk_events)} timed chunks in a window of "
                                       f"{self.chunks - self.opened}")
                self.record.chunk_ms = [s.elapsed_time(e) for s, e in self.chunk_events]
            print(f"perfbench: window {self.record.window_s:.4f} s, {self.record.steps} steps, "
                  f"{self.record.windows / self.record.window_s:.4f} windows/s", file=sys.stderr)
            self.closed = True
            self.record.closed_at = trainer.max_steps = trainer.global_step

    return Probe


def train_argv(workload: dict, config: dict, data_dir: Path, run_dir: Path, seed: int, device: str) -> List[str]:
    argv = [
        f"experiment={config['experiment']}", f"data_dir={data_dir}", f"run_dir={run_dir}",
        f"seed={seed}", f"+datamodule.seed={seed}",
        f"datamodule.batch_size={workload['batch_size']}",
        f"trainer.steps_per_call={workload['steps_per_call'] if device == 'cuda' else 1}",
        f"trainer.log_every_n_steps={workload['log_every_n_steps']}",
        "trainer.max_steps=1000000000000", "trainer.val_every_n_epochs=1000000000",
        "trainer.ckpt_every_n_epochs=1000000000",
    ]
    if device != "cuda":
        argv.append(f"+device={device}")
    return argv + list(config.get("overrides", [])) + list(workload.get("overrides", []))


def reference_steps(reference, store: Path, workload: dict, sizes: dict, seed: int, weights, mode: str,
                    world: int) -> dict:
    """The reference's first ``SNAP_STEPS`` steps in ``mode`` on the cell's
    global batches, read again from the set's files; at ``world`` ranks
    each step is the ranks' shares of its global batch."""
    device = next(iter(weights.values())).device
    batches = reference.batches(store, dict(sizes, batch_size=int(workload["batch_size"])), seed, SNAP_STEPS, device)
    return reference.train_steps(weights, batches, sizes, seed, 0, mode, ranks=world)


def write_graft(config: dict, weights: Dict[str, torch.Tensor], run_dir: Path, store: Path, device: str) -> Path:
    """A stage-1 run directory as a user's stage-1 run leaves it, written
    through the port (its module and ``CheckpointManager``): the composed
    configuration and one checkpoint holding ``weights``."""
    from tacorl_tpu_torch.config import compose, get_class
    from tacorl_tpu_torch.core.checkpoint import CheckpointManager
    from tacorl_tpu_torch.train import CONFIG_DIR

    graft = config["graft"]
    argv = [f"experiment={graft['experiment']}", f"data_dir={store}", f"run_dir={run_dir}", *graft["overrides"]]
    if device != "cuda":
        argv.append(f"+device={device}")
    cfg = compose(CONFIG_DIR, "train", argv)
    module = get_class(cfg["module"]["_target_"])(cfg["module"], full_config=cfg, device=device)
    state = module.init_state(0)
    with torch.no_grad():
        state.net.load_state_dict(weights, strict=True)
    CheckpointManager(run_dir, config=cfg).save(0, state)
    return run_dir


def run(cell_name: str, seed: int, seconds: float, traced: bool, t0: float, *, device: str = "cuda",
        workload: Optional[dict] = None, config: Optional[dict] = None, data_cache: Optional[Path] = None,
        metrics: Optional[List[dict]] = None, fault: Optional[str] = None, evidence: bool = False,
        scratch: Optional[Path] = None) -> dict:
    """One run; returns the result line's object, with every number that
    ``compare.numbers`` gave under ``numbers`` (those without a limit too).
    ``workload``, ``config``, ``data_cache`` and ``metrics`` replace the
    cell's files (tests run a cell at small sizes on the CPU); ``fault``
    plants a fault in the timed path (``faults.py``) to show that
    ``correct`` catches it; ``evidence`` adds what was compared
    (``program``, ``reference``, ``start``) under ``evidence``.

    A cell on more than one chip is run by as many processes, each a rank
    of the launcher's environment (``launch.py``) calling this; the set
    was written and warmed before they started, and ``scratch`` is the
    directory the ranks share for the run's directory, which the launcher
    removes. Rank 0 returns the result
    with the step its window closed at (``closed_at``), another rank only
    ``closed_at`` and its ``memory_peak_bytes``."""
    if workload is None or config is None:
        files = cell(cell_name)
        workload, config = workload or files[0], config or files[1]
    chips = int(workload["chips"])
    if chips > 1 and int(os.environ.get("WORLD_SIZE", 1)) != chips:
        raise RuntimeError(f"{cell_name} asks for {chips} chips: run it through perfbench/launch.py")
    if metrics is None:
        metrics = benchmark_metrics(cell_name, traced)
    dev = torch.device(device)
    if chips > 1 and dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
    flops = load_file(HERE / "flops" / f"{workload['config']}.py", f"perfbench_flops_{workload['config']}")
    sizes = config["sizes"]
    record = Record(workload, config)
    record.step_flops = flops.step_flops(sizes)

    store = data.ensure_store(config["dataset"], **({"cache": data_cache} if data_cache else {}))
    if chips == 1:
        data.warm(store)
    made = reference.weights(sizes, seed, dev)
    weights = made["full"]
    inject = {k: v for k, v in weights.items() if k.startswith(tuple(made["inject"]))}

    from tacorl_tpu_torch import train
    from tacorl_tpu_torch.callbacks.base import Callback

    probe = make_probe(Callback)(inject, record, seconds, traced, t0, reference.LOSSES, dev)
    tmp = Path(scratch) if scratch else Path(tempfile.mkdtemp(prefix="perfbench_run_"))
    try:
        argv = train_argv(workload, config, store, tmp / "run", seed, device)
        if "graft" in made:
            argv.append(f"play_lmp_dir={write_graft(config, made['graft'], tmp / 'stage1', store, device)}")
        del made
        with faults.planted(fault):
            trainer = train.main(argv, callbacks=[probe])
        if not probe.closed:
            raise RuntimeError("the run ended before its window closed")
        # the captured graph holds memory and, under NCCL, the communicator
        if trainer.step_graph is not None:
            trainer.step_graph.release()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        if probe.profiler is not None:
            record.trace = trace.reduce(probe.profiler)
        program = {"losses": probe.losses, "moments": probe.moments, "beta1": probe.beta1, "params": probe.params,
                   "rank_norms": probe.rank_norms}
        rank = probe.rank
        del trainer, probe
    finally:
        if not scratch:
            shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded modules of JAX or the JAX package: {found}")
    if rank != 0:
        return {"closed_at": record.closed_at, "memory_peak_bytes": int(peak)}

    ref = reference_steps(reference, store, workload, sizes, seed, weights, "f32", record.world)
    checks = compare.numbers(program, ref, weights)
    verdict = compare.judge(checks, {**config["limits"], **workload.get("limits", {})})

    values = {}
    for m in metrics:
        value = reader(m["name"]).read(record)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": verdict["correct"], "attempted": record.steps, "failed": 0, "metrics": values,
        "device": device_info(dev, chips, peak, record),
    }
    if traced and record.trace is not None:
        result["breakdown"] = {"device_ops": record.trace.top_ops(), "idle_gaps": record.trace.idle_gaps()}
    if evidence:
        result["evidence"] = {"program": program, "reference": ref, "start": weights}
    if chips > 1:
        result["closed_at"] = record.closed_at
    result["numbers"] = checks
    result["checks"] = verdict["checks"]
    return result


def device_info(dev: torch.device, chips: int, peak: int, record: Record) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}
    if record.trace is not None:
        info["busy_s"] = record.trace.busy_s
        info["window_s"] = record.trace.window_s
    return info
