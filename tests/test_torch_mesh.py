"""``tacorl_tpu_torch/parallel/mesh.py`` in one process, no group: the mesh
and its refusals, a rank's rows of a batch, the draws of each layout the
train steps make (a rank's draw is its rows of the one-process draw), the
loader's rows of a global batch, and the collectives as identities."""

import numpy as np
import pytest
import torch

from tacorl_tpu_torch import train
from tacorl_tpu_torch.core.distributions import DiagNormal, TanhNormal, gumbel_softmax_sample
from tacorl_tpu_torch.data.loader import DataLoader
from tacorl_tpu_torch.data.play_dataset import PlayWindowDataset
from tacorl_tpu_torch.data.storage import pack_frames
from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin
from tacorl_tpu_torch.data.transforms import DeviceTransforms
from tacorl_tpu_torch.modules.play_lmp import uniform_pm1
from tacorl_tpu_torch.networks import action_decoder
from tacorl_tpu_torch.networks.critic import dropout_keep_mask
from tacorl_tpu_torch.ops.jitter_aug import sample_jitter_factors
from tacorl_tpu_torch.parallel import mesh
from tacorl_tpu_torch.parallel.mesh import BatchShard, Mesh
from tests.test_torch_envs import assert_same


def test_without_a_group_one_rank_of_one():
    assert (mesh.rank(), mesh.world(), mesh.backend()) == (0, 1, None)
    assert mesh.create_mesh() == Mesh(dp=1, mp=1, rank=0)
    assert mesh.batch_sharding() == BatchShard(0, 1)
    assert mesh.gather_objects({"a": 1}) == [{"a": 1}]
    mesh.barrier()
    assert mesh.fold_rank(123) == 123
    assert mesh.local_mesh_devices(device="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="requested 2 devices"):
        mesh.local_mesh_devices(2, device="cpu")


def test_local_mesh_devices_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        mesh.local_mesh_devices()


@pytest.mark.parametrize(
    "kwargs, error, match",
    [({"mp": 2}, ValueError, "not divisible by mp=2"), ({"dp": 2}, ValueError, "needs 2 ranks")],
)
def test_create_mesh_refuses(kwargs, error, match):
    with pytest.raises(error, match=match):
        mesh.create_mesh(**kwargs)


def test_init_without_a_launcher_raises(monkeypatch):
    for key in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    assert not mesh.launched()
    with pytest.raises(RuntimeError, match="needs a launcher"):
        mesh.init_distributed("cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_batch_shard_rows_cover_the_batch(world):
    x = np.arange(24 * 3).reshape(24, 3)
    t = torch.as_tensor(x).T.contiguous()  # rows on axis 1
    parts = [BatchShard(r, world) for r in range(world)]
    assert [p.rows(24) for p in parts] == [slice(r * 24 // world, (r + 1) * 24 // world) for r in range(world)]
    np.testing.assert_array_equal(np.concatenate([p.take(x) for p in parts]), x)
    assert torch.equal(torch.cat([p.take(t, axis=1) for p in parts], dim=1), t)
    with pytest.raises(ValueError, match="does not split over"):
        BatchShard(0, world).rows(24 + 1)


def test_shard_batch_takes_every_leaf():
    batch = {"states": {"rgb": np.arange(16).reshape(8, 2)}, "actions": torch.arange(8)}
    got = mesh.shard_batch(batch, Mesh(dp=4, rank=3))
    np.testing.assert_array_equal(got["states"]["rgb"], batch["states"]["rgb"][6:8])
    assert torch.equal(got["actions"], torch.arange(6, 8))
    assert mesh.shard_batch(batch) is not batch and mesh.shard_batch(batch)["actions"] is batch["actions"]


def _draw(fn, shard: BatchShard, seed: int = 3):
    """``fn(generator)`` on a generator seeded ``seed``, inside the draws of
    ``shard``."""
    g = torch.Generator().manual_seed(seed)
    with mesh.sharded_draws(shard):
        return fn(g)


B, T, N = 8, 3, 5


def _layouts():
    mean, std = torch.zeros(B, 4), torch.ones(B, 4)
    logits = torch.zeros(N, B, 2)
    means = torch.zeros(B, T, 2, 4)
    gauss = (torch.zeros(B, T, 3), torch.ones(B, T, 3, 2), torch.zeros(B, T, 3, 2))
    return {
        # name: (draw of the local shape, axis the rows are on in the result)
        "plan_eps": (lambda g, b: DiagNormal(mean[:b], std[:b]).sample(g), 0),
        "n_samples": (lambda g, b: TanhNormal(mean[:b], std[:b]).sample(g, (N,)), 1),
        "gumbel_n": (lambda g, b: gumbel_softmax_sample(logits[:, :b], g, axis=1), 1),
        "uniform_pm1": (lambda g, b: uniform_pm1(None, (b, 4), mean, g), 0),
        "jitter_factors": (lambda g, b: sample_jitter_factors(b * T, g, prob=0.5), 0),
        "logistic_u": (lambda g, b: action_decoder._uniform(means[:b].shape, means, g), 0),
        "gaussian": (lambda g, b: action_decoder.ActionDecoderGaussian._sample(
            None, gauss[0][:b], gauss[1][:b], gauss[2][:b], generator=g), 0),
        "mask_rows": (lambda g, b: dropout_keep_mask((b, 6), 0.3, "cpu", g), 0),
        "mask_n_major": (lambda g, b: dropout_keep_mask((N, b, 6), 0.3, "cpu", g).reshape(N * b, 6), None),
    }


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout", list(_layouts()))
def test_a_rank_draws_its_rows_of_the_whole_draw(layout, world):
    fn, axis = _layouts()[layout]
    whole = _draw(lambda g: fn(g, B), BatchShard())
    # outside the block a draw is whole
    assert torch.equal(fn(torch.Generator().manual_seed(3), B), whole)
    shares = [_draw(lambda g: fn(g, B // world), BatchShard(r, world)) for r in range(world)]
    if axis is None:  # n-major rows: (N, B) flattened
        whole, shares = whole.reshape(N, B, -1), [s.reshape(N, B // world, -1) for s in shares]
        axis = 1
    assert torch.equal(torch.cat(shares, dim=axis), whole)


def test_transforms_draw_a_ranks_frames():
    """A (B, T) window of images through the rgb train transform: rank r's
    frames are rows [r B/W T, (r+1) B/W T) of the one-process output."""
    cfg = {"rgb_static": {"kind": "rgb", "size": [16, 16], "pad": 2, "jitter_prob": 0.5},
           "robot_obs": {"kind": "vector", "noise_std": 0.1}}
    transforms = DeviceTransforms(cfg, device="cpu")
    rs = np.random.RandomState(0)
    states = {"rgb_static": torch.as_tensor(rs.randint(0, 255, (B, T, 20, 20, 3), dtype=np.uint8)),
              "robot_obs": torch.as_tensor(rs.randn(B, T, 5).astype(np.float32))}
    whole = _draw(lambda g: transforms(states, train=True, generator=g), BatchShard())
    for r in range(2):
        local = {k: v[r * B // 2:(r + 1) * B // 2] for k, v in states.items()}
        got = _draw(lambda g: transforms(local, train=True, generator=g), BatchShard(r, 2))
        for k in states:
            assert torch.equal(got[k], whole[k][r * B // 2:(r + 1) * B // 2]), k


@pytest.fixture(scope="module")
def play_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("play")
    generate_synthetic_calvin(root / "frames", 2, 1, 40, 16,
                              keys=("rgb_static", "robot_obs", "scene_obs", "rel_actions_world"))
    pack_frames(root / "frames" / "training", root / "packed" / "training")
    return root


@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_loader_gives_a_rank_its_rows_of_each_global_batch(play_data, layout):
    """Per-item gathers (frame dirs) and the native batched gather (packed):
    rank r's batches are rows of the one-process batches, goals included."""
    ds = PlayWindowDataset(play_data / layout / "training", modalities=["rgb_static", "rel_actions_world"],
                           min_window_size=4, max_window_size=8, include_goal=True,
                           goal_strategy_prob={"geometric": 0.5, "similar_robot_obs": 0.5},
                           nn_steps_from_step_path=play_data / f"{layout}_nn.json")
    assert ds.supports_batch() == (layout == "packed")

    def batches(shard):
        loader = DataLoader(ds, batch_size=8, seed=4, num_threads=1)
        loader.shard = shard
        return list(loader)

    whole = batches(BatchShard())
    for r in range(4):
        got = batches(BatchShard(r, 4))
        assert len(got) == len(whole) > 1
        for g, w in zip(got, whole):
            assert_same(g, mesh.shard_batch(w, Mesh(dp=4, rank=r)))


def test_collectives_are_identities_without_a_group():
    a, b = torch.randn(3, 2), torch.randn(4)
    got = mesh.all_reduce_mean([a, b])
    assert got[0] is a and got[1] is b
    metrics = {"loss": torch.tensor(1.5)}
    assert mesh.sync_metrics(metrics) == metrics


def test_multihost_without_a_launcher_raises(tmp_path, monkeypatch):
    for key in mesh.LAUNCHER_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="needs a launcher"):
        train.main(["+device=cpu", "experiment=play_lmp_for_rl", f"data_dir={tmp_path}",
                    f"run_dir={tmp_path}", "+multihost=true"])
