"""The train step's share of the card's peak on the device: the least time
of the traced steps at each op class's published peak (flops/<config>.py,
peaks.py), over the device kernel time of those steps (the sum that
step_device_ms reads). Unlike ``mfu`` it leaves out the host's waits, so
it moves with the step's kernels alone."""


def read(record):
    t = record.trace
    ks = t.kernels() if t else []
    if not ks or not record.steps or not record.step_flops:
        return None
    return 100.0 * record.least_step_s() * record.steps / (sum(e - s for _, s, e in ks) * 1e-9)
