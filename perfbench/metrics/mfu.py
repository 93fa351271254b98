"""The whole step's share of the cards' peak over the window: the least
time of the window's steps at each op class's published peak
(flops/<config>.py, peaks.py), over the window's host-clock seconds."""


def read(record):
    if not record.window_s or not record.step_flops:
        return None
    return 100.0 * record.least_step_s() * record.steps / record.window_s
