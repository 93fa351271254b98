"""Host milliseconds a trained step spends in ``loader/put`` (the
enqueue of a chunk's copies to the card and its event, on the training
thread) inside the traced window, over the window's steps."""

from perfbench import loader_spans


def read(record):
    got = loader_spans.recorded(record)
    if got is None or not record.steps:
        return None
    spans, _, (lo, hi) = got
    puts = loader_spans.clipped(spans, "loader/put", lo, hi)
    if not puts:
        return None
    return sum(e - s for s, e in puts) * 1e-6 / record.steps
