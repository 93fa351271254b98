"""Milliseconds a batch of the traced window spends in ``loader/pin``
(``perfbench/loader_spans.py``), the mean over the window's batches."""

from perfbench import loader_spans


def read(record):
    return loader_spans.phase_ms(record, "loader/pin")
