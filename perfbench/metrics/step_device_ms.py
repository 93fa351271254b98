"""Device kernel milliseconds a trained step takes, summed over the traced
window's kernels."""


def read(record):
    t = record.trace
    ks = t.kernels() if t else []
    if not ks or not record.steps:
        return None
    return sum(e - s for _, s, e in ks) * 1e-6 / record.steps
