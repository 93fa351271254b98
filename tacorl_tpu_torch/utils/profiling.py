"""Profiling and tracing (port of tacorl_tpu/utils/profiling.py):
``torch.profiler`` traces viewable in TensorBoard or Perfetto, plus
host-side step timing.

``start_server``: the JAX package starts ``jax.profiler``'s live-capture
server. PyTorch has none of its own (dynolog, which serves on-demand
traces, is a separate daemon and not a dependency), so it raises; ROADMAP
Queue 3 records the deviation.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

__all__ = ["trace", "StepTimer", "start_server", "NO_LIVE_SERVER"]

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
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    ) as prof:
        if cuda:
            warm = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_KERNELS):
                warm.add_(1)
            _settle()
        with torch.profiler.record_function(steps_context):
            yield prof
        if cuda:
            _settle()


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
