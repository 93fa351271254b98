"""The reader of the loader's in-place share (``metrics/loader_in_place_share.py``
and its ``.device`` twin) against values worked out by hand on a hand-built
``Record``: the mean of the counter ``loader/in_place`` over the traced
window's batches, and nothing from a program without the counter or a run
without the card's trace."""

import pytest

from perfbench import harness
from perfbench.tests.test_perfbench_loader_spans import _batch, _record, recorder  # noqa: F401

NAMES = ("loader_in_place_share", "loader_in_place_share.device")


def _in_place(batch, share, at_ms):
    return ("loader/in_place", share, at_ms, {"epoch": 2, "batch": batch})


def _spans():
    return (_batch(0, 60, (1, 20, 2, 30))       # ends at 113.5: in the window
            + _batch(1, 110, (3, 30, 4, 40))    # ends at 187.5: in the window
            + _batch(2, 170, (5, 40, 6, 50)))   # ends at 271.5: after it


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shares, want", [
    ((1.0, 0.999, 0.0), 100 * (1.0 + 0.999) / 2),  # batch 2 ends after the window
    ((0.0, 0.0, 1.0), 0.0),                         # the numpy path
    ((1.0, 1.0, 1.0), 100.0),
])
def test_the_share_is_the_mean_over_the_windows_batches(recorder, name, shares, want):  # noqa: F811
    counts = [_in_place(b, s, 80 + 60 * b) for b, s in enumerate(shares)]
    record = _record(recorder, _spans(), counts, busy_ms=[(100, 150)])
    assert harness.reader(name).read(record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_the_reader_is_silent_without_the_counter_or_the_cards_trace(recorder, name):  # noqa: F811
    # a program without the counter (the parent of the change that adds it)
    record = _record(recorder, _spans(), [("loader/ready", 1, 105, {})], busy_ms=[(100, 150)])
    assert harness.reader(name).read(record) is None
    # readings only of batches outside the window
    record = _record(recorder, _spans(), [_in_place(2, 1.0, 200)], busy_ms=[(100, 150)])
    assert harness.reader(name).read(record) is None
    record = _record(recorder, _spans(), [_in_place(0, 1.0, 80)], busy_ms=[])
    assert harness.reader(name).read(record) is None
    record.trace = None
    assert harness.reader(name).read(record) is None
