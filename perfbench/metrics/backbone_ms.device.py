"""Milliseconds of the card a trained step spends in the frozen visual
backbone (the program's device span ``encoder_backbone``, around R3M's
trunk: its preprocessing, convolutions, BatchNorm, ReLU and pools), over
the traced window (``perfbench/device_spans.py``)."""

from perfbench import device_spans


def read(record):
    return device_spans.ms_per_step(record, "encoder_backbone")
