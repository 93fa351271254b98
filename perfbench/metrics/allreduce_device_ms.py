"""Device milliseconds of NCCL kernels a trained step, in rank 0's traced
replays (the gradient all-reduce captured in the step graph, and the
logging steps' metric mean where one falls in the window)."""


def read(record):
    t = record.trace
    ks = t.kernels("nccl") if t else []
    if not ks or not record.steps:
        return None
    return sum(e - s for _, s, e in ks) * 1e-6 / record.steps
