"""The readers of the loader's spans (``loader_spans.py``,
``metrics/loader_*``, ``metrics/idle_loader_wait_share.py``) against values
worked out by hand on a hand-built ``Record``, and the tiny CPU cell traced
with the program's recorder on and off: every reader the benchmark had
before reads the same."""

import time

import pytest

from perfbench import harness, trace
from perfbench.tests.tiny import lmp_cell

NEW = ["loader_draws_ms", "loader_gather_ms", "loader_pad_ms", "loader_pin_ms", "loader_put_ms",
       "loader_ready_share", "idle_loader_wait_share"]
MS = 1_000_000  # ns


@pytest.fixture
def recorder():
    from tacorl_tpu_torch.utils import profiling

    profiling.record(False)
    yield profiling
    profiling.record(True)  # empties it
    profiling.record(False)


def _span(name, start_ms, end_ms, batch=None, tid=7, **ids):
    if batch is not None:
        ids = {"epoch": 2, "batch": batch, **ids}
    return (name, tid, int(start_ms * MS), int(end_ms * MS), ids, None)


def _record(profiling, spans, counts, busy_ms, window_ms=(100, 200), steps=4):
    """A Record of a traced window ``window_ms`` whose card was busy in
    ``busy_ms``, and the program's recorder holding ``spans`` and ``counts``."""
    workload, config = harness.cell("lmp_k16_b64")
    record = harness.Record(workload, config)
    record.steps = steps
    lo, hi = (int(t * MS) for t in window_ms)
    ops = [("kernel", int(s * MS), int(e * MS)) for s, e in busy_ms]
    record.trace = trace.Trace((lo, hi), ops, {})
    profiling.record(True)
    profiling.RECORDER.spans.extend(spans)
    profiling.RECORDER.counts.extend((n, v, int(t * MS), ids) for n, v, t, ids in counts)
    profiling.record(False)
    return record


def _batch(b, start_ms, phases_ms):
    """A batch's produce span from ``start_ms`` and its phases in turn."""
    spans, at = [], start_ms
    for name, ms in zip(("draws", "gather", "pad", "pin"), phases_ms):
        spans.append(_span(f"loader/{name}", at, at + ms, b))
        at += ms
    return [_span("loader/produce", start_ms, at + 0.5, b)] + spans


def test_each_reader_returns_the_value_worked_out_by_hand(recorder):
    spans = (
        _batch(0, 60, (1, 20, 2, 30))        # ends at 113.5: in the window
        + _batch(1, 110, (3, 30, 4, 40))     # ends at 187.5: in the window
        + _batch(2, 170, (5, 40, 6, 50))     # ends at 271.5: after it
        + [_span("loader/wait", 95, 120, 0, tid=1), _span("loader/wait", 150, 190, 1, tid=1),
           _span("loader/put", 90, 104, tid=1, epoch=2, first=0, last=1),
           _span("loader/put", 195, 210, tid=1, epoch=2, first=2, last=3)]
    )
    counts = [("loader/ready", 0, 105, {}), ("loader/ready", 2, 150, {}), ("loader/ready", 1, 160, {}),
              ("loader/ready", 0, 230, {})]
    # busy 100-110 and 130-160: idle 110-130 and 160-200 (60 ms), 10 + 30 of them in a wait
    record = _record(recorder, spans, counts, busy_ms=[(90, 110), (130, 160)])
    want = {
        "loader_draws_ms": (1 + 3) / 2, "loader_gather_ms": (20 + 30) / 2, "loader_pad_ms": (2 + 4) / 2,
        "loader_pin_ms": (30 + 40) / 2, "loader_put_ms": (4 + 5) / 4,
        "loader_ready_share": 100 * 2 / 3, "idle_loader_wait_share": 100 * 40 / 60,
    }
    for name, value in want.items():
        assert harness.reader(name).read(record) == pytest.approx(value, rel=1e-12), name
        assert harness.reader(name + ".device").read(record) == pytest.approx(value, rel=1e-12), name


def test_the_readers_are_silent_without_the_recorders_spans_or_the_cards_trace(recorder):
    spans = _batch(0, 120, (1, 2, 3, 4)) + [_span("loader/wait", 110, 120, 0, tid=1)]
    record = _record(recorder, [], [], busy_ms=[(100, 110)])
    assert all(harness.reader(name).read(record) is None for name in NEW)  # an empty recorder
    record = _record(recorder, spans, [], busy_ms=[])
    assert all(harness.reader(name).read(record) is None for name in NEW)  # no device operations
    record.trace = None
    assert all(harness.reader(name).read(record) is None for name in NEW)


def test_the_tiny_cells_readers_read_the_same_with_the_recorder_on_and_off(tiny_store, recorder, monkeypatch):
    records = []

    class Kept(harness.Record):
        def __init__(self, *args):
            super().__init__(*args)
            records.append(self)

    monkeypatch.setattr(harness, "Record", Kept)
    old = [m for m in harness.benchmark_metrics("lmp_k16_b64", True) if m["name"].removesuffix(".device") not in NEW]

    def run():
        workload, config = lmp_cell()
        harness.run("lmp_k16_b64", 23456789012, 0.5, True, time.perf_counter(), device="cpu", workload=workload,
                    config=config, data_cache=tiny_store, metrics=[])
        return records[-1]

    def values(record):
        return {m["name"]: harness.reader(m["name"]).read(record) for m in old}

    on = run()
    # the trainer kept the recorder on while the probe's profiler ran
    assert not recorder.RECORDER.on
    kept = {s[0] for s in recorder.RECORDER.spans}
    assert {"loader/produce", "loader/draws", "loader/gather", "loader/pad", "loader/wait", "loader/put"} <= kept
    with_spans = values(on)
    recorder.record(True)
    recorder.record(False)
    assert values(on) == with_spans
    assert set(on.trace.host_ranges) <= set(trace.TRAINER)
    # a run in which the recorder never comes on: the same readers read
    import tacorl_tpu_torch.core.trainer as trainer

    monkeypatch.setattr(trainer, "follow_profiler", lambda: None)
    off = run()
    assert recorder.RECORDER.spans == []
    assert {k for k, v in values(off).items() if v is not None} == {k for k, v in with_spans.items() if v is not None}
    assert set(off.trace.host_ranges) == set(on.trace.host_ranges)
