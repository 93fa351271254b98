"""The loader's own spans and counters (``utils/profiling.py``: ``spans``,
``count``, ``RECORDER``) on a packed synthetic CALVIN set: nothing is read
or kept while the recorder is off; each batch's phases on the pool threads,
inside its ``loader/produce``; the consumer's waits, ready counts and
device puts; each batch's share of bytes written in place; the batches
unchanged by the recorder; the spans on the profiler's clock and in
``profiling.trace``'s file; the trainer following a ``torch.profiler``
session; and an abandoned pooled iterator that closes silently, its queued
batches cancelled."""

import collections
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tacorl_tpu_torch.data import loader, play_dataset, storage
from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin
from tacorl_tpu_torch.utils import profiling
from tests.test_torch_envs import assert_same

ROOT = Path(__file__).resolve().parents[1]
MODALITIES = ["rgb_static", "rel_actions_world"]
PHASES = ("loader/draws", "loader/gather", "loader/pad", "loader/pin")
GOALS = {"none": {}, "both": {"include_goal": True, "num_nn": 8}}


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans_data")
    generate_synthetic_calvin(root / "frames", 2, 1, 48, 32)
    storage.pack_frames(root / "frames" / "training", root / "packed")
    return root


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.record(False)
    yield
    profiling.record(True)  # empties it
    profiling.record(False)


def _dataset(packed, goals="both"):
    return play_dataset.PlayWindowDataset(
        packed / "packed", MODALITIES, min_window_size=4, max_window_size=8,
        nn_steps_from_step_path=packed / "nn.json", **GOALS[goals])


def _loader(packed, goals="both", **kwargs):
    return loader.DataLoader(_dataset(packed, goals), batch_size=5, seed=3, num_threads=2, **kwargs)


def _key(span):
    return span[4]["epoch"], span[4]["batch"]


def test_the_recorder_off_reads_no_clock_and_keeps_nothing(packed, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with the recorder off")

    monkeypatch.setattr(profiling, "clock", no_clock)
    assert profiling.spans("a", epoch=1) is profiling.spans("b")  # one shared no-op context
    put = loader.DevicePut("cpu")
    chunks = [[b, b] for b in _loader(packed)]
    assert len(list(loader.device_prefetch(iter(chunks), put, depth=1))) == len(chunks) > 2
    profiling.count("loader/ready", 1)
    assert profiling.RECORDER.spans == [] and profiling.RECORDER.counts == []


@pytest.mark.parametrize("goals", list(GOALS))
def test_each_batch_has_one_span_of_each_phase_on_a_pool_thread_inside_its_produce(packed, monkeypatch, goals):
    # the CPU build has no page-locked allocator: plain tensors stand in
    monkeypatch.setattr(loader, "_pinned_empty",
                        lambda shape, dtype: torch.empty(shape, dtype=loader._torch_dtype(dtype)))
    dl = _loader(packed, goals, pin_memory=True)
    main = threading.get_native_id()
    profiling.record(True)
    n = len(list(dl))
    by_batch = collections.defaultdict(list)
    for span in profiling.RECORDER.spans:
        if span[0] != "loader/wait":
            by_batch[_key(span)].append(span)
    assert sorted(by_batch) == [(1, b) for b in range(n)]
    for key, batch_spans in by_batch.items():
        names = collections.Counter(s[0] for s in batch_spans)
        assert names == collections.Counter(("loader/produce",) + PHASES), (key, names)
        produce = next(s for s in batch_spans if s[0] == "loader/produce")
        assert produce[1] != main and produce[5] is None
        for name, tid, start, end, ids, parent in batch_spans:
            assert tid == produce[1] and parent == (None if name == "loader/produce" else "loader/produce")
            assert produce[2] <= start <= end <= produce[3], (key, name)


@pytest.mark.parametrize("pin", [False, True], ids=["numpy", "page_locked"])
@pytest.mark.parametrize("goals", list(GOALS))
def test_each_batch_has_one_in_place_reading_of_the_share_of_its_bytes_written_page_locked(packed, monkeypatch,
                                                                                           goals, pin):
    made = set()

    def stand_in(shape, dtype):
        # the CPU build has no page-locked allocator: plain tensors stand in, and count as page-locked
        t = torch.empty(shape, dtype=loader._torch_dtype(dtype))
        made.add(t.data_ptr())
        return t

    monkeypatch.setattr(loader, "_pinned_empty", stand_in)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a: self.data_ptr() in made)
    dl = _loader(packed, goals, pin_memory=pin)
    profiling.record(True)
    batches = list(dl)
    readings = [c for c in profiling.RECORDER.counts if c[0] == "loader/in_place"]
    assert sorted((c[3]["epoch"], c[3]["batch"]) for c in readings) == [(1, b) for b in range(len(batches))]
    # the numpy batch's bytes less those of the leaves that are not windows or goal frames
    want = _dataset(packed, goals).sample_batch(np.arange(5), np.random.default_rng(0))
    total = sum(x.nbytes for _, x in loader.flatten(want))
    small = sum(want[k].nbytes for k in ("idx", "window_size", "disp") if k in want)
    for reading in readings:
        assert reading[1] == (pytest.approx(1 - small / total, rel=1e-12) if pin else 0.0)
    if pin:
        assert 0.99 < readings[0][1] < 1


def test_the_batches_are_bit_equal_with_the_recorder_on_and_off(packed):
    off = [list(_loader(packed)) for _ in range(2)]
    profiling.record(True)
    on = [list(_loader(packed)) for _ in range(2)]
    assert profiling.RECORDER.spans
    assert_same(on, off)


def test_every_hand_out_has_one_wait_and_one_ready_and_each_put_names_its_chunk(packed):
    dl = _loader(packed, "none")
    main = threading.get_native_id()
    put = loader.DevicePut("cpu")
    profiling.record(True)
    chunks = []
    for batch in dl:
        chunks.append(batch)
        if len(chunks) == 2:
            put(chunks)
            chunks = []
    n = len(dl)
    waits = [s for s in profiling.RECORDER.spans if s[0] == "loader/wait"]
    ready = [c for c in profiling.RECORDER.counts if c[0] == "loader/ready"]
    assert [_key(s) for s in waits] == [(1, b) for b in range(n)]
    assert all(s[1] == main for s in waits)
    assert [(c[3]["epoch"], c[3]["batch"]) for c in ready] == [(1, b) for b in range(n)]
    assert all(0 <= c[1] <= dl.prefetch + dl.num_threads for c in ready)
    puts = [s for s in profiling.RECORDER.spans if s[0] == "loader/put"]
    assert [(s[4]["epoch"], s[4]["first"], s[4]["last"]) for s in puts] == [
        (1, b, b + 1) for b in range(0, n - 1, 2)]
    assert all(s[1] == main for s in puts)
    # a put follows the waits of its chunk
    for p in puts:
        last_wait = next(s for s in waits if _key(s) == (1, p[4]["last"]))
        assert last_wait[3] <= p[2]


def test_a_span_and_a_record_function_range_share_the_profilers_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.record(True)
        with profiling.spans("clock/span"), torch.profiler.record_function("clock/range"):
            time.sleep(0.02)
    span = next(s for s in profiling.RECORDER.spans if s[0] == "clock/span")
    event = next(e for e in prof.profiler.kineto_results.events() if e.name() == "clock/range")
    assert abs(event.start_ns() - span[2]) < 1_000_000
    assert abs(event.end_ns() - span[3]) < 1_000_000
    assert profiling.clock is time.time_ns


def test_trace_writes_the_loader_spans_on_the_loader_threads(packed, tmp_path):
    dl = _loader(packed)
    with profiling.trace(tmp_path / "profile", steps_context="epoch"):
        n = len(list(dl))
    assert not profiling.RECORDER.on
    files = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    mark = next(e for e in events if e.get("name") == "epoch" and e.get("cat") == "user_annotation")
    ours = [e for e in events if e.get("cat") == "program_span"]
    main = threading.get_native_id()
    for name in ("loader/produce",) + PHASES[:3]:
        found = [e for e in ours if e["name"] == name]
        assert len(found) == n and all(e["tid"] != main for e in found), name
    waits = [e for e in ours if e["name"] == "loader/wait"]
    assert len(waits) == n and all(e["tid"] == main for e in waits)
    # on the trace's time base: inside the span that wraps the epoch
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    assert all(lo - 1000 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1000 for e in waits)
    assert sum(e.get("ph") == "C" and e["name"] == "loader/ready" for e in events) == n


def test_the_recorder_follows_a_profiler_session_and_leaves_an_explicit_switch_alone():
    profiling.follow_profiler()
    assert not profiling.RECORDER.on
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        profiling.follow_profiler()
        assert profiling.RECORDER.on
        with profiling.spans("kept"):
            pass
    profiling.follow_profiler()
    assert not profiling.RECORDER.on
    assert [s[0] for s in profiling.RECORDER.spans] == ["kept"]  # readable after the session
    profiling.record(True)
    profiling.follow_profiler()
    assert profiling.RECORDER.on


class _Gated:
    """Batch 0 is made at once; every later batch waits for ``gate``."""

    def __init__(self):
        self.gate = threading.Event()
        self.started = []

    def __len__(self):
        return 10

    def sample(self, idx, rng):
        self.started.append(idx)
        if idx > 0:
            assert self.gate.wait(timeout=10)
        return {"x": np.full(2, idx)}


def test_closing_an_abandoned_iterator_cancels_its_queued_batches():
    ds = _Gated()
    it = iter(loader.DataLoader(ds, batch_size=1, shuffle=False, num_threads=2, prefetch=2))
    assert int(next(it)["x"][0, 0]) == 0
    # batches 1-3 are queued behind two threads, one of them held at batch 1
    it.close()
    ds.gate.set()
    time.sleep(0.3)
    assert 3 not in ds.started and set(ds.started) <= {0, 1, 2}


ABANDON = """
import time
import numpy as np
from tacorl_tpu_torch.data.loader import DataLoader

class Slow:
    def __len__(self):
        return 400

    def sample(self, idx, rng):
        time.sleep(0.01)
        return {"x": np.full(3, idx)}

it = iter(DataLoader(Slow(), batch_size=4, num_threads=2))
next(it)
# held by a module that the interpreter tears down late, so the iterator
# is closed after concurrent.futures' globals were cleared
np._abandoned_loader = it
del it
print("exiting")
"""


def test_an_iterator_left_open_at_exit_closes_silently():
    p = subprocess.run([sys.executable, "-c", ABANDON], capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0 and p.stdout.strip() == "exiting", p.stderr[-2000:]
    assert "Exception ignored" not in p.stderr and "Traceback" not in p.stderr, p.stderr[-2000:]
