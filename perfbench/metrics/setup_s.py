"""Seconds from the start of the process to the opening of the window:
imports, data, weights, the trainer's set-up, capture and warm chunks."""


def read(record):
    return record.setup_s
