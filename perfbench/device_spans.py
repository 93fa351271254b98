"""The program's device spans in the traced window: marker kernels of one
thread that the program launches on the training stream before and after
a span's work (``tacorl_tpu_torch/ops/device_span.py``), named
``tacorl_span_begin_<span>`` and ``tacorl_span_end_<span>``. A CUDA graph
replays them with the span's kernels, where no host range covers those, so
the device trace shows each span in eager steps and in replays alike. A
program without the markers gives no span, and the readers of its spans
are silent."""

from __future__ import annotations

from typing import List, Optional


def intervals(record, span: str) -> Optional[tuple]:
    """(spans, markers): the span's time on the card each time it ran in
    the traced window (the end marker's start less the begin marker's end,
    in ns, for each begin followed by its end), and the number of times it
    began or ended, the larger; None without a trace or markers."""
    t = record.trace
    if t is None:
        return None
    begin, end = f"tacorl_span_begin_{span}", f"tacorl_span_end_{span}"
    marks = sorted((s, e, name == begin) for name, s, e in t.device_ops if name in (begin, end))
    if not marks:
        return None
    out: List[int] = []
    opened = None
    for s, e, is_begin in marks:
        if is_begin:
            opened = e
        elif opened is not None:
            out.append(s - opened)
            opened = None
    n_begin = sum(1 for m in marks if m[2])
    return out, max(n_begin, len(marks) - n_begin)


def ms_per_step(record, span: str) -> Optional[float]:
    """The span's milliseconds on the card a trained step: its mean time
    over the whole spans of the window, times the times it ran a step."""
    got = intervals(record, span)
    if got is None or not got[0] or not record.steps:
        return None
    spans, runs = got
    return sum(spans) / len(spans) * 1e-6 * runs / record.steps
