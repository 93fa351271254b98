"""The share of the window the training thread waited for its next batch
or chunk (``Trainer.batch_wait_ms``: the loader and the copy's enqueue)."""


def read(record):
    if not record.window_s:
        return None
    return 100.0 * sum(record.batch_wait_ms) * 1e-3 / record.window_s
