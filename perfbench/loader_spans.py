"""The loader's spans and counters in the traced window, as the program
keeps them (``tacorl_tpu_torch/utils/profiling.py``: ``RECORDER``, which the
trainer keeps on while the probe's profiler runs; ``data/loader.py`` names
each span). They are read after the run from the program's recorder, on
the profiler's host clock, against the traced window of the card: a
program without the recorder, or a trace without device operations (the
CPU), gives nothing, and the readers of the loader's spans are silent.

A span is ``(name, thread id, start_ns, end_ns, ids, parent)``, a counter
reading ``(name, value, time_ns, ids)``; a batch is named by its ids'
``(epoch, batch)``. The window's batches are those whose
``loader/produce`` ends inside the window."""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]


def recorded(record) -> Optional[tuple]:
    """(spans, counts, (lo, hi)) of the run's traced window, or None."""
    t = record.trace
    if t is None or not t.device_ops:
        return None
    try:
        from tacorl_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None or not recorder.spans:
        return None
    return list(recorder.spans), list(recorder.counts), t.window_ns


def batch_key(ids: dict) -> Optional[tuple]:
    if "epoch" not in ids or "batch" not in ids:
        return None
    return ids["epoch"], ids["batch"]


def window_batches(spans: list, lo: int, hi: int) -> set:
    return {batch_key(s[4]) for s in spans if s[0] == "loader/produce" and lo <= s[3] <= hi} - {None}


def phase_ms(record, name: str) -> Optional[float]:
    """The mean milliseconds a window's batch spends in ``name``, over the
    window's batches that have such a span."""
    got = recorded(record)
    if got is None:
        return None
    spans, _, (lo, hi) = got
    batches = window_batches(spans, lo, hi)
    per: Dict[tuple, int] = collections.defaultdict(int)
    for s in spans:
        key = batch_key(s[4])
        if s[0] == name and key in batches:
            per[key] += s[3] - s[2]
    if not per:
        return None
    return sum(per.values()) * 1e-6 / len(per)


def clipped(spans: list, name: str, lo: int, hi: int) -> List[Interval]:
    """The spans ``name`` cut to [lo, hi], merged, in order."""
    cut = sorted((max(s[2], lo), min(s[3], hi)) for s in spans if s[0] == name and s[3] > lo and s[2] < hi)
    merged: List[List[int]] = []
    for s, e in cut:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: List[Interval], lo: int, hi: int) -> List[Interval]:
    """[lo, hi] less the ordered, disjoint intervals ``busy``."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def overlap_ns(a: List[Interval], b: List[Interval]) -> int:
    """The length of the intersection of two ordered, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
