"""The share of the traced window's hand-outs of a batch to the training
thread at which at least one queued batch was done (the counter
``loader/ready``; 0 means the training thread was about to wait)."""

from perfbench import loader_spans


def read(record):
    got = loader_spans.recorded(record)
    if got is None:
        return None
    _, counts, (lo, hi) = got
    ready = [c[1] for c in counts if c[0] == "loader/ready" and lo <= c[2] <= hi]
    if not ready:
        return None
    return 100.0 * sum(v >= 1 for v in ready) / len(ready)
