"""The gradient all-reduce's bus bandwidth in rank 0's traced window, as
NCCL's tests define it for a ring: 2 (W - 1) / W times the buffer's bytes
(every trained parameter of the reference network in float32) over the
median NCCL kernel's time, in GB/s. A rate, not a share of a peak: the
cards' links are not in ``peaks.py``."""

import importlib
import statistics


def read(record):
    t = record.trace
    ks = t.kernels("nccl") if t else []
    if not ks or record.world < 2:
        return None
    reference = importlib.import_module(f"perfbench.reference.{record.config['reference']}")
    net = reference.make(record.config["sizes"])
    nbytes = 4 * sum(p.numel() for p in net.parameters() if p.requires_grad)
    seconds = statistics.median(e - s for _, s, e in ks) * 1e-9
    return 2.0 * (record.world - 1) / record.world * nbytes / seconds * 1e-9
