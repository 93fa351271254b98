"""A batch of packed play windows assembled in place (``sample_batch`` with
an allocator, ``native.gather_windows``/``gather_rows`` with ``out``,
``native.pad_windows``): byte for byte the numpy path's batch and the
per-item ``sample()`` + ``collate`` batch; the native pad fill against the
Python loop it replaced; the destinations the native code refuses; and the
loader's pinning, which passes page-locked leaves through.

``test_on_the_card_*`` needs a CUDA card and skips without one: the loader's
page-locked batches through ``DevicePut`` against the numpy path, with the
copies held back on their stream so that a block handed to a later batch
too early would show. Run it on the card with
``python -m pytest --noconftest tests/test_torch_loader_in_place.py -k card``
(this file imports nothing of the JAX package)."""

import json

import numpy as np
import pytest
import torch

from tacorl_tpu_torch.data import loader, native, play_dataset, storage
from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin
from tacorl_tpu_torch.utils import profiling

POISON = 77  # what a destination holds before the gather: a row left unwritten shows


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    root = tmp_path_factory.mktemp("in_place_data")
    generate_synthetic_calvin(root / "frames", 2, 1, 48, 16)
    storage.pack_frames(root / "frames" / "training", root / "packed")
    return root


def _poisoned(shape, dtype):
    """A plain CPU tensor standing in for a page-locked one."""
    return torch.full(shape, POISON, dtype=loader._torch_dtype(dtype))


def _same(a, b, where="batch"):
    """Equal keys in order, and leaves of equal dtype, shape and bytes
    (numpy arrays and CPU tensors alike)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), where


def _leaves(batch):
    return [x for _, x in loader.flatten(batch)]


CASES = {
    "relative_actions": dict(),
    "absolute_actions": dict(modalities=["rgb_static", "robot_obs", "actions"], action_type="actions"),
    "no_pad": dict(pad=False),
    "goals": dict(include_goal=True, num_nn=8),
    "rank_rows": dict(rows=slice(3, 7)),
    "goals_rank_rows": dict(include_goal=True, num_nn=8, rows=slice(5, 10)),
    "all_full_length": dict(min_window_size=16),
    "short_windows": dict(min_window_size=1, max_window_size=9),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_batch_in_tensors_equals_the_numpy_path_and_per_item_samples(packed, case, tmp_path):
    kwargs = dict(CASES[case])
    rows = kwargs.pop("rows", slice(None))
    kwargs = {"modalities": ["rgb_static", "rel_actions_world"], "min_window_size": 8, "max_window_size": 16,
              "nn_steps_from_step_path": tmp_path / "nn.json", **kwargs}
    ds = play_dataset.PlayWindowDataset(packed / "packed", **kwargs)
    indices = np.arange(len(ds))[::3][:12]
    in_place = ds.sample_batch(indices, np.random.default_rng(5), rows, alloc=_poisoned)
    numpy_path = ds.sample_batch(indices, np.random.default_rng(5), rows)
    _same(in_place, numpy_path)
    assert all(isinstance(x, torch.Tensor) for x in _leaves({k: in_place[k] for k in ("states", "actions")}))
    assert all(isinstance(x, np.ndarray) for x in _leaves(numpy_path))
    if rows != slice(None):
        whole = ds.sample_batch(indices, np.random.default_rng(5))
        _same(in_place, loader.tree_map(lambda x: x[rows], whole))
    if not ds.pad and ds.min_window_size < ds.max_window_size:
        return  # unpadded windows of several lengths do not collate: the batch reads them at full length
    if ds.include_goal:
        # the per-item path draws each goal beside its window: compare all but the goals,
        # each item at the batch's window size
        ws = ds.sample_batch(indices, np.random.default_rng(5))["window_size"]
        items = [ds.sample(int(i), np.random.default_rng(0), window_size=int(w)) for i, w in zip(indices, ws)]
    else:
        rng = np.random.default_rng(5)
        items = [ds.sample(int(i), rng) for i in indices]
    per_item = loader.tree_map(lambda x: x[rows], loader.collate(items))
    for key in ("goal", "disp"):
        per_item.pop(key, None)
        in_place.pop(key, None)
    _same(in_place, per_item)


def _pad_loop(x, lengths, relative):
    """The Python pad fix-up ``sample_batch`` ran before the native fill."""
    for i, ws in enumerate(lengths):
        if relative:
            x[i, ws:, :-1] = 0
            x[i, ws:, -1:] = x[i, ws - 1, -1:]
        else:
            x[i, ws:] = x[i, ws - 1]
    return x


@pytest.mark.parametrize("dest", ["numpy", "tensor"])
@pytest.mark.parametrize("relative", [False, True], ids=["repeat", "relative"])
@pytest.mark.parametrize("shape, dtype", [
    ((7, 9, 5, 4, 3), np.uint8), ((7, 9, 7), np.float32), ((7, 9, 24), np.float64), ((7, 12, 3, 2), np.float32),
], ids=["frames", "actions", "states", "two_axis_rows"])
def test_the_native_pad_fill_equals_the_python_loop(shape, dtype, relative, dest):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 50).astype(dtype)
    lengths = rng.integers(1, shape[1] + 1, size=shape[0])
    lengths[:2] = (1, shape[1])  # a one-row window and a full one
    want = _pad_loop(x.copy(), lengths, relative)
    got = x.copy() if dest == "numpy" else torch.from_numpy(x.copy())
    assert native.pad_windows(got, lengths, relative=relative) is None
    _same(got, want)


def _array():
    return np.arange(40 * 3 * 2, dtype=np.uint8).reshape(40, 3, 2)


REFUSED = {  # a destination for ``shape`` of uint8 that the native code must not write
    "shape": lambda shape: np.empty((shape[0] + 1,) + shape[1:], np.uint8),
    "dtype": lambda shape: np.empty(shape, np.float32),
    "tensor_dtype": lambda shape: torch.empty(shape, dtype=torch.int8),
    "not_contiguous": lambda shape: np.empty(shape[::-1], np.uint8).T,
    "tensor_not_contiguous": lambda shape: torch.empty(shape[::-1], dtype=torch.uint8).permute(
        *reversed(range(len(shape)))),
    "read_only": lambda shape: np.broadcast_to(np.empty((1,) + shape[1:], np.uint8), shape),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_native_gather_refuses_a_destination_of_the_wrong_kind(case):
    with pytest.raises(ValueError):
        native.gather_windows(_array(), [0, 3, 9, 30], 5, out=REFUSED[case]((4, 5, 3, 2)))
    with pytest.raises(ValueError):
        native.gather_rows(_array(), [0, 3, 9, 30], out=REFUSED[case]((4, 3, 2)))


@pytest.mark.parametrize("lengths", [[0, 5, 5, 5], [5, 6, 5, 5], [5, 5, 5]], ids=["zero", "beyond", "count"])
def test_the_native_gather_and_pad_refuse_lengths_outside_a_window(lengths):
    with pytest.raises(ValueError):
        native.gather_windows(_array(), [0, 3, 9, 30], 5, lengths=lengths)
    with pytest.raises(ValueError):
        native.pad_windows(np.zeros((4, 5, 3, 2), np.uint8), lengths)


def test_the_gather_writes_only_each_windows_real_rows_into_the_given_tensor():
    lengths = [5, 1, 3, 4]
    full = native.gather_windows(_array(), [0, 3, 9, 30], 5)  # every row of every window
    out = torch.full((4, 7, 3, 2), POISON, dtype=torch.uint8)
    assert native.gather_windows(_array(), [0, 3, 9, 30], 5, 2, out=out, lengths=lengths) is out
    for w, n in enumerate(lengths):
        _same(out[w], np.concatenate([full[w, :n], np.repeat(full[w, n - 1:n], 7 - n, axis=0)]))
    out = torch.full((4, 5, 3, 2), POISON, dtype=torch.uint8)
    native.gather_windows(_array(), [0, 3, 9, 30], 5, out=out, lengths=lengths)
    for w, n in enumerate(lengths):
        _same(out[w, :n], full[w, :n])
        assert (out[w, n:] == POISON).all()  # left for the pad fill
    rows = torch.full((3, 3, 2), POISON, dtype=torch.uint8)
    assert native.gather_rows(_array(), [39, 0, 7], out=rows) is rows
    _same(rows, _array()[[39, 0, 7]])


def test_pinning_passes_page_locked_tensors_through_and_copies_the_rest(monkeypatch):
    locked = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    unlocked = torch.arange(5, dtype=torch.int64)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self, *a: self is locked)
    made = []

    def stand_in(shape, dtype):
        made.append(torch.empty(shape, dtype=loader._torch_dtype(dtype)))
        return made[-1]

    monkeypatch.setattr(loader, "_pinned_empty", stand_in)
    host = np.arange(6, dtype=np.int64) * 7
    batch = {"states": {"rgb": locked}, "idx": host, "other": unlocked}
    pinned = loader.tree_map(loader._pinned, batch)
    assert pinned["states"]["rgb"] is locked and len(made) == 2
    for key, src in (("idx", host), ("other", unlocked)):
        assert pinned[key] is not src and any(pinned[key] is t for t in made)
        _same(pinned[key], src)
    host[0] = -1
    assert int(pinned["idx"][0]) == 0  # a copy, not a view of the numpy leaf
    assert loader._in_place_share(batch) == pytest.approx(48 / (48 + 48 + 40), rel=1e-12)
    assert loader._in_place_share({"idx": host}) == 0.0


# -- on the card -------------------------------------------------------------------------

K = 16
LMP = {"batch": 64, "hw": 200, "episodes": 2, "episode_len": 1040, "epochs": 10}  # 32 batches an epoch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def _lmp_store(root, seed=0):
    """A packed set in the stage-1 cell's keys and shapes (200x200 frames,
    8-16-step windows), written straight into the packed layout."""
    rng = np.random.default_rng(seed)
    n = LMP["episodes"] * LMP["episode_len"]
    shapes = {"rgb_static": ((200, 200, 3), np.uint8), "robot_obs": ((15,), np.float32),
              "scene_obs": ((24,), np.float32), "rel_actions_world": ((7,), np.float32)}
    root.mkdir(parents=True)
    for key, (shape, dtype) in shapes.items():
        array = np.lib.format.open_memmap(root / f"{key}.npy", mode="w+", dtype=dtype, shape=(n,) + shape)
        for lo in range(0, n, 256):
            hi = min(n, lo + 256)
            if dtype == np.uint8:
                array[lo:hi] = rng.integers(0, 256, size=(hi - lo,) + shape, dtype=np.uint8)
            else:
                array[lo:hi] = rng.standard_normal((hi - lo,) + shape).astype(dtype)
        array.flush()
        del array
    np.save(root / "steps.npy", np.arange(n, dtype=np.int64))
    ends = [(e * LMP["episode_len"], (e + 1) * LMP["episode_len"] - 1) for e in range(LMP["episodes"])]
    np.save(root / "ep_start_end_ids.npy", np.asarray(ends))
    meta = {"keys": list(shapes), "n_steps": n, "shapes": {k: list(s) for k, (s, _) in shapes.items()},
            "dtypes": {k: np.dtype(d).name for k, (_, d) in shapes.items()}}
    (root / storage.PackedStorage.META).write_text(json.dumps(meta))
    return root


def test_on_the_card_each_device_batch_equals_the_numpy_batch_through_recycled_pinned_memory(card, tmp_path):
    from tacorl_tpu_torch.core.trainer import _chunks

    data = _lmp_store(tmp_path / "lmp")
    ds = play_dataset.PlayWindowDataset(data, ["rgb_static", "rel_actions_world"], min_window_size=8,
                                        max_window_size=16)
    pinned = loader.DataLoader(ds, batch_size=LMP["batch"], seed=9, num_threads=2, prefetch=2, pin_memory=True)
    plain = loader.DataLoader(ds, batch_size=LMP["batch"], seed=9, num_threads=2, prefetch=2)
    assert len(pinned) == 32
    put = loader.DevicePut(card)
    checked, leaves_pinned = 0, []

    def host_batches(it):
        for batch in it:
            leaves_pinned.append(all(x.is_pinned() for x in _leaves(batch)))
            # the batch's own leaves went to the card: assembled in place, not copied again
            assert batch["states"]["rgb_static"].is_pinned()
            yield batch

    def held_back(chunk):
        # hold the copies back on their stream (~2 ms), so a block handed to a later
        # batch before its copy ran would be overwritten under the copy
        with torch.cuda.stream(put.stream):
            torch.cuda._sleep(3_000_000)
        return put(chunk)

    held_back.ready = put.ready
    profiling.record(True)
    try:
        for _ in range(LMP["epochs"]):
            chunks = loader.device_prefetch(_chunks(host_batches(iter(pinned)), K), held_back, depth=1)
            want = iter(plain)
            for on_card in chunks:
                for k in range(K):
                    expected = next(want)
                    _same(loader.tree_map(lambda t: t[k].cpu(), on_card), expected)
                    checked += 1
            assert next(want, None) is None
    finally:
        profiling.record(False)
    assert checked == 320 and all(leaves_pinned) and len(leaves_pinned) == 320
    shares = [c[1] for c in profiling.RECORDER.counts if c[0] == "loader/in_place"]
    assert len(shares) == 640  # both loaders: the pinned one's batches in place, the numpy one's not
    assert sorted(shares)[:320] == [0.0] * 320 and min(sorted(shares)[320:]) > 0.999
    print(f"on {torch.cuda.get_device_name(card)}: {checked} device batches equal to the numpy path's; "
          f"in-place share {min(sorted(shares)[320:]):.6f}-{max(shares):.6f}")
