"""Reduction of a ``torch.profiler`` trace of the measured window to what
the per-layer metrics read: the device operations inside the window, the
union of their intervals (busy time), the longest idle gaps named by the
``trainer/*`` range open on the training thread, and the host ranges of
the trainer."""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW = "perfbench/window"
# host ranges the trainer opens around its calls (core/trainer.py)
TRAINER = ("trainer/next_batch", "trainer/train_step", "trainer/log", "trainer/validate")


@dataclasses.dataclass
class Trace:
    window_ns: Tuple[int, int]
    # device operations clipped to the window: (name, start_ns, end_ns)
    device_ops: List[Tuple[str, int, int]]
    # host ranges of the training thread: name -> [(start_ns, end_ns)]
    host_ranges: Dict[str, List[Tuple[int, int]]]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def kernels(self, substring: str = "") -> List[Tuple[str, int, int]]:
        """Kernels (not copies or sets) whose name holds ``substring``."""
        return [op for op in self.device_ops if not op[0].startswith(("Memcpy", "Memset")) and substring in op[0]]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for _, s, e in sorted(self.device_ops, key=lambda op: op[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def top_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = collections.Counter()
        for name, s, e in self.device_ops:
            total[name[:200]] += e - s
        return [[name, ns * 1e-9] for name, ns in total.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps inside the window, each named by the
        trainer range open at its middle on the training thread."""
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            name = next((k for k, rs in self.host_ranges.items() if any(a <= mid < b for a, b in rs)), "other")
            out.append([name, (e - s) * 1e-9])
        return out


def _is_device(event) -> bool:
    return "CUDA" in str(event.device_type())


def reduce(prof) -> Optional[Trace]:
    """The trace of a ``torch.profiler.profile`` that recorded the window
    marker, or None when the trace has no marker."""
    events = prof.profiler.kineto_results.events()
    marker = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not marker:
        return None
    lo, hi = marker[0].start_ns(), marker[0].end_ns()
    thread = marker[0].start_thread_id()
    ops, ranges = [], collections.defaultdict(list)
    for e in events:
        name = e.name()
        if _is_device(e):
            if e.is_user_annotation() or "/" in name.split("<")[0].split("(")[0]:
                continue  # a host range mirrored on the device timeline
            s, t = max(e.start_ns(), lo), min(e.end_ns(), hi)
            if t > s:
                ops.append((name, s, t))
        elif name in TRAINER and e.start_thread_id() == thread:
            ranges[name].append((e.start_ns(), e.end_ns()))
    return Trace((lo, hi), ops, dict(ranges))
