"""Kernel 1 (``jitter_normalize``, ``csrc/jitter_normalize.cu``) against
its bytes bound: the least time of a step's calls (peaks.py's byte count
of each call shape the configuration lists, over the HBM rate), over the
device time the traced window's calls take per step."""

from perfbench.peaks import HBM_BYTES_PER_S, jitter_normalize_bytes


def read(record):
    t = record.trace
    shapes = record.config.get("kernels", {}).get("jitter_normalize")
    calls = t.kernels("jitter_normalize") if t else []
    if not calls or not shapes:
        return None
    bound_s = sum(jitter_normalize_bytes(s) for s in shapes) / HBM_BYTES_PER_S
    measured_s = sum(e - s for _, s, e in calls) * 1e-9 / len(calls) * len(shapes)
    return 100.0 * bound_s / measured_s
