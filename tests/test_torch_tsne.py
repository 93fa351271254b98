"""The port's t-SNE plan plot (``callbacks/tsne_plot.py``) on the CPU at
N <= 100 points: the window labels equal the JAX callback's, P equals
scikit-learn's exact ``_joint_probabilities`` at atol 1e-6, the final KL is
within 1.25x of scikit-learn's exact method's on the same data (the two
optimise the same objective from different random starts), and the
callback writes a 600x600x3 PNG. Also: the callback resolves from a
config's JAX target, and moves device-held states to the host."""

import zlib

import numpy as np
import pytest
import torch

from tacorl_tpu.callbacks.tsne_plot import TSNEPlotCallback as JaxTSNEPlotCallback
from tacorl_tpu.envs.fake_calvin import FakeTasks as JaxFakeTasks
from tacorl_tpu_torch.callbacks import tsne_plot
from tacorl_tpu_torch.callbacks.tsne_plot import TSNEPlotCallback
from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.envs.fake_calvin import FakeTasks

KL_RATIO = 1.25


def _outputs(seed=0, batches=2, n=12, as_torch=False):
    """Validation outputs: latents, and start/end scene states in which
    some windows opened the drawer, some moved the slider, some both (then
    skipped) and some nothing."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        scene_start = np.zeros((n, 24), np.float32)
        scene_end = np.zeros((n, 24), np.float32)
        scene_end[: n // 2, 0] = 1.0
        scene_end[n // 3: n // 2 + 2, 1] = 0.5
        batch = {
            "sampled_plan_pp": rs.randn(n, 8).astype(np.float32),
            "idx": np.arange(n),
            "state_info_initial": {"robot_obs": np.zeros((n, 15), np.float32), "scene_obs": scene_start},
            "state_info_final": {"robot_obs": np.zeros((n, 15), np.float32), "scene_obs": scene_end},
        }
        if as_torch:
            batch = {
                k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict) else torch.from_numpy(v))
                for k, v in batch.items()
            }
        out.append(batch)
    return out


def test_labels_equal_the_jax_callbacks():
    got_plans, got = TSNEPlotCallback(task_differ=FakeTasks())._labels_for(_outputs(as_torch=True))
    want_plans, want = JaxTSNEPlotCallback(task_differ=JaxFakeTasks())._labels_for(_outputs())
    assert got == want and -1 in got and len(set(got)) >= 3
    np.testing.assert_array_equal(torch.stack(got_plans).numpy(), np.stack(want_plans))


def _clusters(n=90, d=8, seed=0):
    rs = np.random.RandomState(seed)
    centres = rs.randn(3, d) * 4.0
    return (centres[np.arange(n) % 3] + rs.randn(n, d)).astype(np.float32)


@pytest.mark.parametrize("perplexity", [5.0, 30.0])
def test_p_equals_sklearns_joint_probabilities(perplexity):
    from scipy.spatial.distance import squareform
    from sklearn.manifold import _t_sne
    from sklearn.metrics import pairwise_distances

    x = _clusters()
    want = _t_sne._joint_probabilities(pairwise_distances(x, squared=True), perplexity, 0)
    got = tsne_plot.joint_probabilities(torch.from_numpy(x), perplexity)
    assert torch.equal(got, got.T) and float(got.diagonal().abs().max()) == 0.0
    np.testing.assert_allclose(squareform(got.numpy(), checks=False), want, rtol=0, atol=1e-6)


def test_final_kl_is_near_sklearns_exact_method():
    from sklearn.manifold import TSNE
    from threadpoolctl import threadpool_limits

    x = _clusters(n=100, seed=1)
    with threadpool_limits(1):  # beside the other test workers
        ref = TSNE(perplexity=30.0, init="random", method="exact", random_state=0).fit(x)
    xy, kl = tsne_plot.tsne(torch.from_numpy(x), perplexity=30.0, seed=0)
    assert xy.shape == (100, 2) and xy.dtype == torch.float32 and torch.isfinite(xy).all()
    assert ref.kl_divergence_ / KL_RATIO <= kl <= ref.kl_divergence_ * KL_RATIO, (kl, ref.kl_divergence_)
    # the clusters stay apart in the embedding
    labels = np.arange(100) % 3
    means = np.stack([xy.numpy()[labels == c].mean(axis=0) for c in range(3)])
    spread = max(xy.numpy()[labels == c].std(axis=0).max() for c in range(3))
    assert min(np.linalg.norm(means[a] - means[b]) for a, b in ((0, 1), (0, 2), (1, 2))) > 2 * spread


def _read_png(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        crc = int.from_bytes(data[pos + 8 + length:pos + 12 + length], "big")
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc
        if kind == b"IHDR":
            shape = (int.from_bytes(body[4:8], "big"), int.from_bytes(body[:4], "big"))
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], 1 + shape[1] * 3)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(shape[0], shape[1], 3)


class _Sink:
    def __init__(self):
        self.images = {}

    def log_image(self, name, image, step):
        self.images[name] = image


class _Trainer:
    def __init__(self, directory):
        self.sink = _Sink()
        self.global_step = 7

        class Ckpt:
            dir = directory

        self.ckpt = Ckpt()


def test_the_callback_writes_a_600_by_600_rgb_png(tmp_path):
    cb = get_class("tacorl_tpu.callbacks.tsne_plot.TSNEPlotCallback")(
        task_differ={"_target_": "tacorl_tpu.envs.fake_calvin.FakeTasks"}, perplexity=5.0
    )
    assert isinstance(cb, TSNEPlotCallback) and isinstance(cb.task_differ, FakeTasks)
    trainer = _Trainer(tmp_path)
    cb.on_validation_end(trainer, None, {}, _outputs(as_torch=True), epoch=0)
    image = trainer.sink.images["tsne_plan_space"]
    assert image.shape == (600, 600, 3) and image.dtype == np.uint8
    np.testing.assert_array_equal(_read_png(tmp_path / "tsne_plan_space_7.png"), image)
    # white ground, and each label's colour drawn (grey: no task)
    assert (image[0, 0] == 255).all()
    colours = np.unique(image.reshape(-1, 3), axis=0).astype(np.float64)
    _, labels = cb._labels_for(_outputs(as_torch=True))
    for label in set(labels):
        colour = tsne_plot.TAB10[label] if label >= 0 else np.full(3, 127.0)
        assert (np.abs(colours - (0.3 * 255 + 0.7 * colour)).max(axis=1) <= 1).any(), label
    assert cb.last["n"] == len(labels) and np.isfinite(cb.last["kl"]) and cb.last["device"] == "cpu"


def test_too_few_windows_or_off_epochs_draw_nothing(tmp_path):
    cb = TSNEPlotCallback(task_differ=FakeTasks(), every_n_epochs=2)
    trainer = _Trainer(tmp_path)
    cb.on_validation_end(trainer, None, {}, _outputs(as_torch=True), epoch=0)
    cb.every_n_epochs = 1
    cb.on_validation_end(trainer, None, {}, _outputs(batches=1, n=6, as_torch=True), epoch=0)
    assert not trainer.sink.images and not list(tmp_path.glob("*.png"))
