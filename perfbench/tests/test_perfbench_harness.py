"""The harness on the CPU at tiny widths (``tiny.py``): the result line's
schema, ``correct`` against the reference, the faults it has to catch,
and the card check of ``run.py``."""

import json
import subprocess
import sys
import time

import pytest

from perfbench import faults, harness
from perfbench.tests.tiny import lmp_cell

TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}


def _run(tiny_store, trace=False, fault=None, seed=12345678901):
    workload, config = lmp_cell()
    config["limits"] = dict(TIGHT)
    metrics = harness.benchmark_metrics("lmp_k16_b64", trace)
    return harness.run("lmp_k16_b64", seed, 0.5, trace, time.perf_counter(), device="cpu", workload=workload,
                       config=config, data_cache=tiny_store, metrics=metrics, fault=fault)


def _check_schema(r, trace):
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["attempted"] > 0 and r["failed"] == 0
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev and "window_s" in dev) == trace
    if trace:
        for key in ("device_ops", "idle_gaps"):
            assert len(r["breakdown"][key]) <= 10
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("trace", [False, True], ids=["end_to_end", "traced"])
def test_a_run_prints_the_contracts_line_and_agrees_with_the_reference(tiny_store, trace):
    r = _run(tiny_store, trace)
    _check_schema(r, trace)
    assert r["correct"], r["checks"]
    asked = {m["name"] for m in harness.benchmark_metrics("lmp_k16_b64", trace)}
    if not trace:
        assert asked == {"device_ms_per_step", "setup_s"}
        # the CPU has no CUDA events: the time on the card is silent
        assert set(r["metrics"]) == {"setup_s"}
    else:
        # the CPU has no device trace: the readers of device metrics are silent
        assert {"train_windows_per_s.host", "mfu.host"} <= set(r["metrics"])
        assert set(r["metrics"]) <= asked - {"kernels_per_step.device", "step_device_ms.device", "step_mfu.device",
                                            "jitter_roofline.device", "device_idle_share.device"}


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_each_fault_of_the_timed_path_makes_the_run_incorrect(tiny_store, fault):
    r = _run(tiny_store, fault=fault)
    assert not r["correct"], r["checks"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "lmp_k16_b64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
