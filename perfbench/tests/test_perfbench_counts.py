"""The benchmark's arithmetic: each configuration's FLOP count against
``torch.utils.flop_counter.FlopCounterMode`` on its reference at tiny
widths, and kernel 1's byte count per call shape."""

import importlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import data, harness, peaks
from perfbench.tests.tiny import lmp_cell, tacorl_cell

# stage 2's count runs 0.006 % above the counter's at the tiny widths (the
# counter books the eval-mode posterior's attention and the actor's
# backward slightly differently); stage 1's is exact
CELLS = [(lmp_cell, 0.0), (tacorl_cell, 2e-4)]


@pytest.mark.parametrize("cell,rtol", CELLS, ids=["play_lmp_calvin", "tacorl_calvin"])
def test_the_flop_count_agrees_with_the_counter_on_the_reference(tiny_store, cell, rtol):
    workload, config = cell()
    sizes = config["sizes"]
    reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
    flops = harness.load_file(harness.HERE / "flops" / f"{workload['config']}.py", "flops_under_test")
    store = data.ensure_store(config["dataset"], cache=tiny_store)
    cpu = torch.device("cpu")
    weights = reference.weights(sizes, 5, cpu)["full"]
    batches = reference.batches(store, sizes, 5, 1, cpu)
    torch.backends.mha.set_fastpath_enabled(False)  # the counter cannot see inside the fused path
    try:
        with FlopCounterMode(display=False) as counter:
            reference.train_steps(weights, batches, sizes, 5, 0)
    finally:
        torch.backends.mha.set_fastpath_enabled(True)
    assert sum(flops.step_flops(sizes).values()) == pytest.approx(counter.get_total_flops(), rel=rtol, abs=0)


@pytest.mark.parametrize("shape,megabytes", [((1024, 3, 128, 128), 201.4), ((64, 3, 128, 128), 12.6)])
def test_kernel_1_moves_each_image_once_each_way(shape, megabytes):
    assert round(peaks.jitter_normalize_bytes(shape) / 1e6, 1) == megabytes


def test_production_counts_and_least_times():
    for name in ("lmp_k16_b64", "tacorl_k8_b64"):
        workload, config = harness.cell(name)
        flops = harness.load_file(harness.HERE / "flops" / f"{workload['config']}.py", "flops_prod").step_flops(
            config["sizes"])
        assert set(flops) == set(config["precision"])
        record = harness.Record(workload, config)
        record.step_flops = flops
        assert 0 < record.least_step_s() < 5e-3


def test_device_ms_per_step_is_the_chunks_time_on_the_card_over_the_steps():
    workload, config = harness.cell("tacorl_k8_b64")
    record = harness.Record(workload, config)
    read = harness.reader("device_ms_per_step").read
    assert read(record) is None  # no card, no events: the metric is left out
    record.steps, record.chunk_ms = 16, [150.0, 170.0]
    assert read(record) == 20.0
