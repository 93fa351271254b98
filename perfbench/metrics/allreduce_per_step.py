"""NCCL kernels a trained step runs, counted in rank 0's traced window:
one while the gradients go in one flat float32 buffer."""


def read(record):
    t = record.trace
    n = len(t.kernels("nccl")) if t else 0
    return n / record.steps if n and record.steps else None
