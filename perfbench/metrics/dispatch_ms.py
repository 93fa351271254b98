"""Host milliseconds a trained step spends in the trainer's
``trainer/train_step`` ranges (the static inputs' copies, the reseeding,
the replays' launches), from the profiler's host events."""


def read(record):
    t = record.trace
    ranges = t.host_ranges.get("trainer/train_step") if t else None
    if not ranges or not record.steps:
        return None
    lo, hi = t.window_ns
    ns = sum(min(e, hi) - max(s, lo) for s, e in ranges if e > lo and s < hi)
    return ns * 1e-6 / record.steps
