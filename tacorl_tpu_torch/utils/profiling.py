"""Profiling and tracing (port of tacorl_tpu/utils/profiling.py):
``torch.profiler`` traces viewable in TensorBoard or Perfetto, plus
host-side step timing.

The program's own spans and counters (``spans``, ``count``): a
``record_function`` range reaches the profiler's trace only from the thread
that enabled the profiler, so the loader's pool threads record nothing
there. ``RECORDER`` keeps such spans in memory instead, stamped on the
profiler's host clock (``clock``), so they share a timeline with the
device trace; ``trace`` writes them into its trace file. It is off by
default, and then ``spans`` costs one attribute test. ``record`` switches
it; ``follow_profiler`` (called by the trainer each step) keeps it on while
a ``torch.profiler`` session runs.

``start_server``: the JAX package starts ``jax.profiler``'s live-capture
server. PyTorch has none of its own (dynolog, which serves on-demand
traces, is a separate daemon and not a dependency), so it raises; ROADMAP
Queue 3 records the deviation.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional

import torch

__all__ = [
    "trace", "StepTimer", "start_server", "NO_LIVE_SERVER",
    "RECORDER", "spans", "count", "record", "follow_profiler", "last_ids",
]

NO_LIVE_SERVER = (
    "start_server: PyTorch has no live-capture profiling server; trace a span with "
    "utils.profiling.trace instead (ROADMAP Queue 3, 'no live profiling server')"
)


@contextlib.contextmanager
def trace(log_dir, steps_context: str = "train") -> Iterator[torch.profiler.profile]:
    """Capture a trace of the host and, where a card is present, of the
    card: ``with trace(run_dir / 'profile'): ...``. The span is one
    ``record_function(steps_context)`` range. On exit the trace is written
    into ``log_dir`` as ``<host>.<pid>.pt.trace.json`` (TensorBoard's
    profile plugin reads it); the profiler is yielded, so a caller can read
    ``key_averages()``."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    write = torch.profiler.tensorboard_trace_handler(str(log_dir))

    def ready(prof) -> None:
        before = set(log_dir.iterdir())
        write(prof)
        for path in sorted(set(log_dir.iterdir()) - before):
            _write_spans(path, prof, steps_context)

    record(True)
    try:
        with torch.profiler.profile(activities=activities, on_trace_ready=ready) as prof:
            if cuda:
                warm = torch.zeros(1, device="cuda")
                for _ in range(WARMUP_KERNELS):
                    warm.add_(1)
                _settle()
            with torch.profiler.record_function(steps_context):
                yield prof
            if cuda:
                _settle()
    finally:
        record(False)


# On an H100 host the device trace can lose the first kernels it records:
# a span opened as the profiler started lost its first 36 kernels in 1
# trace of 12 (results/torch_r14_tp/trace_window.py), and spans opened
# 50 ms and 250 ms after the start, the latter after one kernel, lost
# their first 40 or so (ROADMAP Queue 3): a count, not a time. So
# WARMUP_KERNELS small kernels run on the card before the span opens, and
# the span opens, and the profiler stops, SETTLE_S away from the window's
# edges (a device event's timestamp, moved onto the host's clock, was seen
# landing a few ms early, and the profiler drops one outside its window).
SETTLE_S = 0.05
WARMUP_KERNELS = 512


def _settle() -> None:
    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def _write_spans(path: Path, prof, anchor: str) -> None:
    """Add the recorder's spans to the Chrome trace at ``path`` as complete
    events on the threads that made them, and its counters as counter
    events. The trace's time base is found from the range ``anchor``, which
    the file and the profiler's host events both hold."""
    spans, counts = list(RECORDER.spans), list(RECORDER.counts)
    if not spans and not counts:
        return
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    mark = next(e for e in events if e.get("name") == anchor and e.get("ph") == "X"
                and e.get("cat") != "gpu_user_annotation")
    host = torch.autograd.DeviceType.CPU
    start_ns = next(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == anchor and e.device_type() == host)
    offset_ns = mark["ts"] * 1e3 - start_ns
    pid = mark["pid"]
    for name, tid, start, end, ids, parent in spans:
        events.append({"ph": "X", "cat": "program_span", "name": name, "pid": pid, "tid": tid,
                       "ts": (start + offset_ns) * 1e-3, "dur": (end - start) * 1e-3,
                       "args": {**ids, "parent": parent}})
    for name, value, at, ids in counts:
        events.append({"ph": "C", "name": name, "pid": pid, "ts": (at + offset_ns) * 1e-3,
                       "args": {"value": value}})
    path.write_text(json.dumps(doc))


# -- the program's own spans and counters ------------------------------------

# The profiler's host clock: kineto stamps its host events with the
# nanoseconds of the system clock, as ``time.time_ns`` reads it
# (tests/test_torch_loader_spans.py holds the two together).
clock = time.time_ns


class Recorder:
    """Spans and counters in memory. ``on`` is the one attribute ``spans``
    tests; ``record`` switches it."""

    def __init__(self) -> None:
        self.on = False
        # switched on by follow_profiler, which then switches it off too
        self.by_profiler = False
        # (name, thread id, start_ns, end_ns, ids, enclosing span's name)
        self.spans: List[tuple] = []
        # (name, value, time_ns, ids)
        self.counts: List[tuple] = []
        self.local = threading.local()

    def mine(self) -> threading.local:
        """The calling thread's state: ``stack``, its open spans, and
        ``last``, the ids of the last span it kept under each name."""
        local = self.local
        if not hasattr(local, "stack"):
            local.stack, local.last = [], {}
        return local


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "ids", "parent", "start")

    def __init__(self, name: str, ids: dict) -> None:
        self.name, self.ids, self.parent = name, ids, None

    def __enter__(self) -> "_Span":
        stack = RECORDER.mine().stack
        if stack:
            self.parent = stack[-1]
            if not self.ids:
                self.ids = self.parent.ids
        stack.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc) -> None:
        end = clock()
        mine = RECORDER.mine()
        mine.stack.pop()
        mine.last[self.name] = self.ids
        parent = self.parent.name if self.parent is not None else None
        RECORDER.spans.append((self.name, threading.get_native_id(), self.start, end, self.ids, parent))


def spans(name: str, **ids):
    """A span ``name`` around a ``with`` block, kept when the recorder is on.
    ``ids`` name the work it belongs to (the loader's batch: ``epoch``,
    ``batch``); a span given none takes its enclosing span's."""
    if not RECORDER.on:
        return _OFF
    return _Span(name, ids)


def count(name: str, value, **ids) -> None:
    """A counter reading, kept when the recorder is on."""
    if RECORDER.on:
        RECORDER.counts.append((name, value, clock(), ids))


def record(on: bool) -> None:
    """Switch the recorder on (emptied) or off (what it kept stays readable
    until it is switched on again)."""
    if on:
        RECORDER.spans, RECORDER.counts = [], []
    RECORDER.by_profiler = False
    RECORDER.on = on


def follow_profiler() -> None:
    """Switch the recorder on when a ``torch.profiler`` session is running,
    and off once the session that switched it on has stopped; a recorder
    switched on by ``record`` is left alone."""
    running = torch.autograd.profiler._is_profiler_enabled
    if running and not RECORDER.on:
        record(True)
        RECORDER.by_profiler = True
    elif not running and RECORDER.by_profiler:
        record(False)


def last_ids(name: str) -> dict:
    """The ids of the last span ``name`` the calling thread kept while the
    recorder was on ({} when there is none)."""
    return RECORDER.mine().last.get(name, {})


def start_server(port: int = 9999):
    """The JAX package's live profiling server has no PyTorch counterpart."""
    raise NotImplementedError(NO_LIVE_SERVER)


class StepTimer:
    """Rolling steps/sec with compile-step exclusion."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._count = 0
        self._rate = 0.0

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._count += 1
        if self._count >= self.window:
            self._rate = self._count / (now - self._t0)
            self._t0, self._count = now, 0
            return self._rate
        return None

    @property
    def steps_per_sec(self) -> float:
        return self._rate
