"""A cell on more than one chip on the CPU: two ranks of the stage-1 cell
at tiny widths (``tiny.py``) launched as the four-card cell launches them
(``launch.py``, under ``torchrun``), over gloo at K = 1; and the
reference's rank shares against one plain step on the global batch."""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from perfbench import harness, launch
from perfbench.reference import play_lmp
from perfbench.tests.tiny import lmp_cell

CELL = "lmp_k16_b256_dp4"
TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}
RANKS = 2


def _launch(tiny_store, fault=None, seconds=0.5, workdir=None, seed=12345678901, seeds=None):
    workload, config = lmp_cell(chips=RANKS, batch_size=8 * RANKS)
    workload["limits"] = {"rank_gap": harness.cell(CELL)[0]["limits"]["rank_gap"]}
    config["limits"] = dict(TIGHT)
    overrides = {"workload": workload, "config": config, "data_cache": str(tiny_store),
                 "metrics": harness.benchmark_metrics(CELL, False)}
    return launch.launch(CELL, seeds or [seed], seconds, False, time.perf_counter(), RANKS, device="cpu",
                         fault=fault, overrides=overrides, workdir=workdir)


@pytest.fixture(scope="module")
def sound(tiny_store):
    return _launch(tiny_store)


def test_two_ranks_make_one_result_line_that_is_correct(sound):
    assert sound["rc"] == 0
    r = launch.merge(sound["runs"][0])
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == RANKS and "setup_s" in r["metrics"]
    assert r["checks"]["rank_gap"]["value"] == 0.0
    # only rank 0 makes the result; the others give their step and peak
    assert set(sound["runs"][0][1]) == {"closed_at", "memory_peak_bytes"}


def test_every_ranks_window_closes_at_the_same_step(sound):
    ranks = sound["runs"][0]
    steps = [r["closed_at"] for r in ranks]
    assert len(set(steps)) == 1 and steps[0] > 0
    with pytest.raises(RuntimeError, match="different steps"):
        launch.merge([dict(ranks[0]), dict(ranks[1], closed_at=steps[0] + 1)])


def test_the_exchange_left_out_makes_the_run_incorrect_by_rank_gap(tiny_store):
    done = _launch(tiny_store, fault="no_exchange")
    r = launch.merge(done["runs"][0])
    assert not r["correct"]
    assert r["checks"]["rank_gap"]["value"] > r["checks"]["rank_gap"]["limit"]


def test_a_rank_killed_mid_run_ends_the_launch(tiny_store, tmp_path):
    done = {}
    run = threading.Thread(target=lambda: done.update(_launch(tiny_store, seconds=600.0, workdir=tmp_path)))
    run.start()
    pid = tmp_path / "pid1"
    deadline = time.monotonic() + 120.0
    while not pid.exists() and time.monotonic() < deadline:
        time.sleep(0.2)
    time.sleep(10.0)
    os.kill(int(pid.read_text()), signal.SIGKILL)
    killed = time.monotonic()
    run.join(timeout=120.0)
    assert not run.is_alive() and time.monotonic() - killed < 60.0
    assert done["runs"] is None and done["rc"] != 0
    for rank in range(RANKS):
        with pytest.raises(ProcessLookupError):
            os.kill(int((tmp_path / f"pid{rank}").read_text()), 0)


def test_one_launch_runs_each_seed_in_one_process_group(tiny_store):
    """The readings' launch: each seed a whole run of the program, the
    ranks keeping the group they made between the runs."""
    seeds = [12345678901, 23456789012]
    done = _launch(tiny_store, seeds=seeds)
    assert done["rc"] == 0 and len(done["runs"]) == len(seeds)
    results = [launch.merge(list(ranks)) for ranks in done["runs"]]
    assert all(r["correct"] for r in results), [r["checks"] for r in results]
    assert results[0]["numbers"]["loss_gap"] != results[1]["numbers"]["loss_gap"]


def test_run_exits_2_without_the_cards_the_cell_asks_for():
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", CELL, "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode == 2 and p.stdout.strip() == ""


def test_a_rank_outside_a_launch_is_refused():
    workload, config = harness.cell(CELL)
    with pytest.raises(RuntimeError, match="launch"):
        harness.run(CELL, 1, 1.0, False, 0.0, device="cpu", workload=workload, config=config, metrics=[])


def test_the_ranks_averaged_shares_are_one_plain_step_on_the_global_batch(tiny_store):
    """Without dropout the W shares' mean gradient is the gradient of the
    global batch's mean loss: the reference's split keeps the plain
    step's semantics, and only dropout's streams are the ranks' own."""
    _, config = lmp_cell()
    sizes = dict(config["sizes"], dropout_p=0.0)
    cpu = torch.device("cpu")
    weights = play_lmp.weights(sizes, 5, cpu)["full"]
    store = harness.data.ensure_store(config["dataset"], cache=tiny_store)
    batches = play_lmp.batches(store, dict(sizes, batch_size=4 * sizes["batch_size"]), 5, 2, cpu)
    plain = play_lmp.train_steps(weights, batches, sizes, 5, 0)
    shares = play_lmp.train_steps(weights, batches, sizes, 5, 0, ranks=4)
    for n, g in plain["grads"].items():
        torch.testing.assert_close(shares["grads"][n], g, rtol=1e-4, atol=1e-7, msg=n)
    for n, p in plain["params"].items():
        moved = float((p - weights[n]).abs().max())
        torch.testing.assert_close(shares["params"][n], p, rtol=0, atol=1e-2 * moved + 1e-9, msg=n)
