"""On the card, at each cell's own sizes: a sound run is correct, and the
control (the reference one step lower in precision, put in the program's
place) is not. Run with ``python3 -m pytest perfbench/tests -m chip``.

Stage 1's control is not caught: no number the program exposes separates
it from sound runs by three times (PERF.md, Open questions), so its
limits come from the planted faults alone and only stage 2's control is
held here."""

import time

import pytest

from perfbench import compare, harness, readings

CELLS = ["lmp_k16_b64", "tacorl_k8_b64"]
CONTROL_CAUGHT = ["tacorl_k8_b64"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CONTROL_CAUGHT)
def test_the_control_comes_out_not_correct(card, cell):
    workload, config = harness.cell(cell)
    harness.set_cache_dirs()
    values = readings.control_numbers(workload, config, 20221018, card)
    assert not compare.judge(values, config["limits"])["correct"], values


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(card, cell):
    workload, config = harness.cell(cell)
    harness.set_cache_dirs()
    r = harness.run(cell, 4294967311, 0.0, False, time.perf_counter(), workload=dict(workload, warm_chunks=1),
                    config=config, metrics=[])
    assert r["correct"], r["checks"]
