"""The port's training data path held against the JAX package's, bit for
bit, on a synthetic CALVIN set (frame-dir and packed): the synthetic
generator, the native gathers, the batched packed reads, the k-NN goal
index and its JSON cache, PlayWindowDataset (sample and sample_batch,
padding, both goal strategies), DataLoader (shuffle, percentage, drop_last,
thread pool against sequential, surfaced errors), BasicDataModule, and the
CPU side of the device put."""

import numpy as np
import pytest
import torch

from tacorl_tpu.data import datamodule as jax_datamodule
from tacorl_tpu.data import knn as jax_knn
from tacorl_tpu.data import loader as jax_loader
from tacorl_tpu.data import native as jax_native
from tacorl_tpu.data import play_dataset as jax_play
from tacorl_tpu.data import storage as jax_storage
from tacorl_tpu.data.synthetic import generate_synthetic_calvin as jax_generate
from tacorl_tpu_torch.data import datamodule, knn, loader, native, play_dataset, storage
from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin
from tests.test_torch_envs import _dir_contents, assert_same

KEYS = ("rgb_static", "robot_obs", "scene_obs", "rel_actions_world")
MODALITIES = ["rgb_static", "rel_actions_world"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """One synthetic set written by the JAX generator, frame-dir and packed
    (each split packed by the JAX package)."""
    root = tmp_path_factory.mktemp("data")
    jax_generate(root / "frames", 2, 1, 48, 32, keys=KEYS)
    for split in ("training", "validation"):
        jax_storage.pack_frames(root / "frames" / split, root / "packed" / split)
    return root


def test_synthetic_generator_writes_what_jax_writes(tmp_path):
    generate_synthetic_calvin(tmp_path / "port", 2, 1, 20, 16)
    jax_generate(tmp_path / "jax", 2, 1, 20, 16)
    assert_same(_dir_contents(tmp_path / "port"), _dir_contents(tmp_path / "jax"))


# -- native gathers and batched reads ---------------------------------------------


@pytest.mark.parametrize("pad_rows", [0, 3])
@pytest.mark.parametrize("key", ["rgb_static", "robot_obs"])
def test_native_gather_windows_matches_jax(data, key, pad_rows):
    array = np.load(data / "packed" / "training" / f"{key}.npy", mmap_mode="r")
    starts = [0, 5, 17, 40, 3]
    got = native.gather_windows(array, starts, 7, pad_rows)
    assert_same(got, jax_native.gather_windows(array, starts, 7, pad_rows))
    assert_same(got[2, :7], np.asarray(array[17:24]))


def test_native_gather_rows_matches_jax(data):
    array = np.load(data / "packed" / "training" / "rgb_static.npy", mmap_mode="r")
    rows = [95, 0, 17, 17, 60]
    assert_same(native.gather_rows(array, rows), jax_native.gather_rows(array, rows))


def test_native_gather_refuses_rows_outside_the_array(data):
    array = np.load(data / "packed" / "training" / "robot_obs.npy", mmap_mode="r")
    with pytest.raises(IndexError):
        native.gather_windows(array, [len(array) - 3], 7)
    with pytest.raises(IndexError):
        native.gather_rows(array, [-1])


@pytest.mark.parametrize("pad_rows", [0, 2])
def test_read_window_batch_matches_jax(data, pad_rows):
    path = data / "packed" / "training"
    port, ref = storage.open_storage(path), jax_storage.open_storage(path)
    starts = [0, 10, 48, 60]
    assert_same(port.read_window_batch(starts, 8, list(KEYS), pad_rows),
                ref.read_window_batch(starts, 8, list(KEYS), pad_rows))


def test_read_frame_batch_matches_jax(data):
    path = data / "packed" / "training"
    port, ref = storage.open_storage(path), jax_storage.open_storage(path)
    steps = [3, 95, 50, 3]
    assert_same(port.read_frame_batch(steps, list(KEYS)), ref.read_frame_batch(steps, list(KEYS)))
    with pytest.raises(KeyError):
        port.read_frame_batch([10_000], ["robot_obs"])


# -- k-NN goal index ------------------------------------------------------------------


def test_knn_l2_matches_jax():
    rs = np.random.RandomState(0)
    db = rs.randn(300, 15).astype(np.float32)
    q = rs.randn(70, 15).astype(np.float32)
    got = knn.knn_l2(q, db, 9, block_size=32)
    assert_same(got, jax_knn.knn_l2(q, db, 9, block_size=32))
    exact = np.argsort(((q[:, None] - db[None]) ** 2).sum(-1), axis=1)[:, :9]
    assert (got[:, 0] == exact[:, 0]).all()


def test_nn_index_and_json_cache_match_jax(tmp_path):
    rs = np.random.RandomState(1)
    steps = list(range(100, 180))
    vectors = rs.randn(len(steps), 15).astype(np.float32)
    got = knn.build_nn_steps_from_step(steps, vectors, num_nn=8, margin=4)
    assert got == jax_knn.build_nn_steps_from_step(steps, vectors, num_nn=8, margin=4)
    for name, mod in (("port", knn), ("jax", jax_knn)):
        for split in ("train", "validation"):
            index = mod.load_or_build_nn_index(
                tmp_path / f"{name}.json", split, steps, lambda: vectors, num_nn=8, margin=4
            )
            assert index == got
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    # a cached split is read back, not rebuilt
    again = knn.load_or_build_nn_index(tmp_path / "port.json", "train", steps, None, num_nn=8)
    assert again == got


# -- the play-window dataset ----------------------------------------------------------

GOALS = {
    "none": {},
    "geometric": {"include_goal": True, "goal_strategy_prob": {"geometric": 1.0},
                  "goal_augmentation": True},
    "both": {"include_goal": True, "num_nn": 8},
}


def _datasets(data, layout, train, goals, tmp_path):
    path = data / layout / ("training" if train else "validation")
    kwargs = dict(modalities=MODALITIES, min_window_size=4, max_window_size=8, train=train,
                  **GOALS[goals])
    return (
        play_dataset.PlayWindowDataset(path, nn_steps_from_step_path=tmp_path / "port_nn.json", **kwargs),
        jax_play.PlayWindowDataset(path, nn_steps_from_step_path=tmp_path / "jax_nn.json", **kwargs),
    )


@pytest.mark.parametrize("goals", list(GOALS))
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_sample_matches_jax(data, tmp_path, layout, train, goals):
    port, ref = _datasets(data, layout, train, goals, tmp_path)
    assert len(port) == len(ref) > 0
    for idx in (0, 7, len(ref) - 1):
        got = port.sample(idx, np.random.default_rng((3, idx)))
        assert_same(got, ref.sample(idx, np.random.default_rng((3, idx))))
        # padded windows repeat the last frame and zero the relative actions
        ws = int(got["window_size"])
        if ws < 8:
            assert (got["states"]["rgb_static"][ws:] == got["states"]["rgb_static"][ws - 1]).all()
            assert (got["actions"][ws:, :-1] == 0).all()
    if goals != "none":
        assert (tmp_path / "port_nn.json").exists() == (goals == "both")


@pytest.mark.parametrize("goals", list(GOALS))
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_sample_batch_matches_jax(data, tmp_path, train, goals):
    port, ref = _datasets(data, "packed", train, goals, tmp_path)
    assert port.supports_batch() and ref.supports_batch()
    indices = np.arange(len(ref))[::3]
    assert_same(port.sample_batch(indices, np.random.default_rng(5)),
                ref.sample_batch(indices, np.random.default_rng(5)))


# -- the loader -------------------------------------------------------------------------

LOADERS = {
    "shuffled": dict(batch_size=5),
    "sequential": dict(batch_size=5, shuffle=False),
    "partial_last": dict(batch_size=7, drop_last=False),
    "percentage": dict(batch_size=4, percentage=0.5),
    "no_threads": dict(batch_size=5, prefetch=0),
    "one_thread": dict(batch_size=5, num_threads=1),
    "four_threads": dict(batch_size=5, num_threads=4),
}


def _epochs(dl, n=2):
    return [list(dl) for _ in range(n)]


@pytest.mark.parametrize("kind", list(LOADERS))
@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_loader_batches_match_jax(data, tmp_path, layout, kind):
    port_ds, ref_ds = _datasets(data, layout, True, "both", tmp_path)
    got = _epochs(loader.DataLoader(port_ds, seed=7, **LOADERS[kind]))
    want = _epochs(jax_loader.DataLoader(ref_ds, seed=7, **LOADERS[kind]))
    assert len(got[0]) == len(loader.DataLoader(port_ds, seed=7, **LOADERS[kind]))
    assert_same(got, want)


def test_loader_threads_do_not_change_the_batches(data, tmp_path):
    ds, _ = _datasets(data, "packed", True, "both", tmp_path)
    pooled = _epochs(loader.DataLoader(ds, batch_size=5, seed=2, num_threads=4))
    assert_same(pooled, _epochs(loader.DataLoader(ds, batch_size=5, seed=2, prefetch=0)))


class _Failing:
    def __len__(self):
        return 20

    def sample(self, idx, rng):
        if idx == 13:
            raise ValueError("bad frame 13")
        return {"x": np.full(2, idx)}


@pytest.mark.parametrize("threads", [1, 3])
def test_loader_surfaces_dataset_errors(threads):
    dl = loader.DataLoader(_Failing(), batch_size=4, shuffle=False, num_threads=threads)
    with pytest.raises(ValueError, match="bad frame 13"):
        list(dl)


def test_datamodule_matches_jax(data):
    cfg = dict(data_dir=str(data / "packed"), batch_size=6, val_percentage=0.5, seed=3,
               dataset={"_target_": "tacorl_tpu.data.play_dataset.PlayWindowDataset",
                        "modalities": MODALITIES, "min_window_size": 4, "max_window_size": 8})
    port, ref = datamodule.BasicDataModule(**cfg), jax_datamodule.BasicDataModule(**cfg)
    assert port.statistics == ref.statistics
    port.setup()
    ref.setup()
    assert type(port.train_dataset) is play_dataset.PlayWindowDataset
    assert_same(_epochs(port.train_loader()), _epochs(ref.train_loader()))
    assert_same(_epochs(port.val_loader()), _epochs(ref.val_loader()))
    with pytest.raises(FileNotFoundError):
        datamodule.BasicDataModule(str(data / "nowhere"), {})


def test_device_put_on_the_cpu_is_as_tensor():
    put = loader.DevicePut("cpu")
    batch = {"a": np.arange(6, dtype=np.uint8).reshape(2, 3), "b": {"c": np.ones(2)}}
    got = list(loader.device_prefetch(iter([batch, batch, batch]), put, depth=1))
    assert len(got) == 3
    assert got[0]["a"].dtype == torch.uint8 and got[0]["b"]["c"].dtype == torch.float64
    assert torch.equal(got[2]["a"], torch.from_numpy(batch["a"]))
