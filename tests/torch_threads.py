"""Torch's CPU threads for the port's tests under pytest-xdist.

Torch sizes its intra-op thread pool to the machine's cores, in every
process. Under ``pytest -n W`` each of the W workers does, so a machine
runs W times as many busy threads as it has cores, and torch's spinning
threads then take turns: a Play-LMP train step of the tiny test configs ran
some 10-40 times slower beside five other workers than alone. ``share_cores``
gives each worker its share of the cores (at least one thread). It acts on
the whole worker process: pytest imports every test module when it
collects, so the first port test module that calls it sets it for all.
Outside xdist it changes nothing. Each run of a test uses one thread count
throughout, so what it compares (bit for bit, or within a tolerance) is
computed as before, in another summation order at most."""

import os

import torch


def share_cores() -> int:
    """Set and return this worker's torch CPU threads: the cores over
    ``PYTEST_XDIST_WORKER_COUNT``; without xdist, torch's own choice."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()
