"""Device kernels a trained step runs, counted in the traced window."""


def read(record):
    t = record.trace
    n = len(t.kernels()) if t else 0
    return n / record.steps if n and record.steps else None
