"""The share of the traced window in which no operation ran on the device
(one minus the union of the device operations' intervals)."""


def read(record):
    t = record.trace
    if t is None or not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
