"""The share of a batch's bytes that the loader wrote straight into
page-locked memory (the counter ``loader/in_place``, one reading a batch),
in percent, the mean over the traced window's batches; a program without
the counter gives nothing."""

from perfbench import loader_spans


def read(record):
    got = loader_spans.recorded(record)
    if got is None:
        return None
    spans, counts, (lo, hi) = got
    batches = loader_spans.window_batches(spans, lo, hi)
    shares = [c[1] for c in counts if c[0] == "loader/in_place" and loader_spans.batch_key(c[3]) in batches]
    if not shares:
        return None
    return 100.0 * sum(shares) / len(shares)
