"""On the card, at each cell's own sizes: a sound run is correct, and the
control (the reference one step lower in precision, put in the program's
place) is not. Run with ``python3 -m pytest perfbench/tests -m chip``.

The one-card stage-1 cell's control is not caught: none of its numbers
separates it from sound runs by three times (PERF.md, Open questions), so
its limits come from the planted faults alone. The four-card cell's
control fails ``grad_diff.median``, computed on one card from the four
ranks' shares; its sound run needs four cards."""

import time

import pytest

from perfbench import compare, harness, launch, readings

CELLS = ["lmp_k16_b64", "tacorl_k8_b64"]
FOUR_CARD_CELLS = ["lmp_k16_b256_dp4"]
CONTROL_CAUGHT = ["tacorl_k8_b64", "lmp_k16_b256_dp4"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CONTROL_CAUGHT)
def test_the_control_comes_out_not_correct(card, cell):
    workload, config = harness.cell(cell)
    harness.set_cache_dirs()
    values = readings.control_numbers(workload, config, 20221018, card)
    # the control runs in one process: it reads no rank_gap
    limits = {k: v for k, v in {**config["limits"], **workload.get("limits", {})}.items() if k in values}
    assert not compare.judge(values, limits)["correct"], values


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(card, cell):
    workload, config = harness.cell(cell)
    harness.set_cache_dirs()
    r = harness.run(cell, 4294967311, 0.0, False, time.perf_counter(), workload=dict(workload, warm_chunks=1),
                    config=config, metrics=[])
    assert r["correct"], r["checks"]


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("fewer than four CUDA cards on this machine")


@pytest.mark.chip
@pytest.mark.parametrize("cell", FOUR_CARD_CELLS)
def test_a_sound_run_on_four_cards_is_correct(four_cards, cell):
    workload, config = harness.cell(cell)
    harness.set_cache_dirs()
    done = launch.launch(cell, [4294967311], 0.0, False, time.perf_counter(), 4,
                         overrides={"workload": dict(workload, warm_chunks=1), "metrics": []})
    assert done["rc"] == 0
    r = launch.merge(done["runs"][0])
    assert r["correct"] and r["device"]["count"] == 4, r["checks"]
