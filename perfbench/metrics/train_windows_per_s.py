"""Training windows (batch rows, all ranks) trained in the window, over
the window's host-clock seconds."""


def read(record):
    return record.windows / record.window_s if record.window_s else None
