"""The benchmark is driven by data: BENCHMARK.json keeps to the contract's
shape, every cell resolves by name to its configuration, reference,
operation count and metric readers, and a cell and a metric are added with
new files and new entries only (shown in a copy)."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REFERENCE_API = ("LOSSES", "make", "weights", "held_at_zero", "train_steps", "batches")


def test_the_file_keeps_to_the_contracts_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, run_seconds + 60 each,
    # 2 x 90 s of compiling a cell and 1,200 s spare, in 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_resolves_by_name(cell):
    workload, config = harness.cell(cell)
    entry = next(c for c in SPEC["configs"] if c["name"] == workload["config"])
    assert (ROOT / entry["file"]).resolve() == (harness.HERE / "configs" / f"{workload['config']}.json").resolve()
    assert set(entry["reduced"]) <= set(config) | {"dataset"}
    flops = harness.load_file(harness.HERE / "flops" / f"{workload['config']}.py", "flops_resolved")
    assert set(flops.step_flops(config["sizes"])) == set(config["precision"])
    reference = __import__(f"perfbench.reference.{config['reference']}", fromlist=["x"])
    assert all(hasattr(reference, a) for a in REFERENCE_API)
    assert set(config["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}
    for trace in (False, True):
        for m in harness.benchmark_metrics(cell, trace):
            reader = harness.load_file(harness.HERE / "metrics" / f"{m['name']}.py", "reader")
            assert callable(reader.read)


ADD = textwrap.dedent('''
    import json, sys, time
    from perfbench import harness
    from perfbench.tests.tiny import lmp_cell
    workload, config = lmp_cell()
    added = json.loads((harness.HERE / "workloads" / "lmp_k8_b64.json").read_text())
    workload = dict(workload, steps_per_call=added["steps_per_call"])
    config["limits"] = {k: 1e-4 for k in config["limits"]}
    r = harness.run("lmp_k8_b64", 3, 0.2, False, time.perf_counter(), device="cpu", workload=workload,
                    config=config, data_cache=sys.argv[1],
                    metrics=harness.benchmark_metrics("lmp_k8_b64", False))
    print(json.dumps(r))
''')


def test_a_cell_and_a_metric_are_added_with_new_files_and_entries_only(tmp_path, tiny_store):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.HERE, copy / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(copy): p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    # the new cell: a data file; the new metric: a reader of its own
    cell = dict(json.loads((harness.HERE / "workloads" / "lmp_k16_b64.json").read_text()), steps_per_call=8)
    (copy / "perfbench" / "workloads" / "lmp_k8_b64.json").write_text(json.dumps(cell))
    (copy / "perfbench" / "metrics" / "windows_per_step.py").write_text(
        "def read(record):\n    return record.windows / record.steps if record.steps else None\n")
    spec["workloads"].append({"name": "lmp_k8_b64", "config": "play_lmp_calvin", "traffic": "lmp_k8_b64",
                              "chips": 1, "why": "the stage-1 step at K = 8"})
    spec["end_to_end"].append({"name": "windows_per_step", "unit": "windows", "better": "higher", "bound": 0.01,
                               "source": "host_clock", "workloads": ["lmp_k8_b64"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p.relative_to(copy): p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())
    env = {"PYTHONPATH": f"{copy}:{ROOT}", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    p = subprocess.run([sys.executable, "-c", ADD, str(tiny_store)], cwd=copy, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["windows_per_step"]["value"] == 8.0


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "lmp_k16_b64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""
