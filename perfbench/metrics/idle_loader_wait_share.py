"""The share of the card's idle time in the traced window (the window less
the union of the device operations, ``Trace.busy_intervals``) that falls
inside a ``loader/wait`` span, the training thread waiting for its next
batch: the program's spans and the device trace on one clock."""

from perfbench import loader_spans


def read(record):
    got = loader_spans.recorded(record)
    if got is None:
        return None
    spans, _, (lo, hi) = got
    idle = loader_spans.gaps(record.trace.busy_intervals(), lo, hi)
    waits = loader_spans.clipped(spans, "loader/wait", lo, hi)
    total = sum(e - s for s, e in idle)
    if not waits or not total:
        return None
    return 100.0 * loader_spans.overlap_ns(idle, waits) / total
