"""The port's D4RL data path and fake env held against the JAX package on
the CPU, bit for bit: both .npz generators, the episode bounds, the items
of both datasets for the same ``rng`` (padded windows, the geometric goal,
goal augmentation, the reached flag), the D4RLDataModule's loader batches
over 2 epochs, and FakeD4RLEnv episodes under the same actions."""

import numpy as np
import pytest

from tacorl_tpu.data import d4rl_dataset as jax_ds
from tacorl_tpu.data.d4rl_datamodule import D4RLDataModule as JaxD4RLDataModule
from tacorl_tpu.envs.fake_d4rl import FakeD4RLEnv as JaxFakeD4RLEnv
from tacorl_tpu_torch.data import d4rl_dataset as ds
from tacorl_tpu_torch.data.d4rl_datamodule import D4RLDataModule
from tacorl_tpu_torch.envs.fake_d4rl import FakeD4RLEnv, make_d4rl_env

OBS_DIM, ACT_DIM = 8, 4


def _load(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def assert_trees_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_trees_equal(got[k], want[k], f"{where}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=where)


GENERATORS = {
    "synthetic": ("generate_synthetic_d4rl", dict(n_steps=400, episode_len=100, seed=3)),
    "synthetic_antmaze_shapes": ("generate_synthetic_d4rl", dict(n_steps=300, obs_dim=29, act_dim=8)),
    "expert": ("generate_expert_d4rl", dict(n_episodes=6, legs_per_episode=3, seed=1)),
    "expert_wide": ("generate_expert_d4rl", dict(n_episodes=3, obs_dim=29, act_dim=8, seed=2)),
}


@pytest.mark.parametrize("case", list(GENERATORS))
def test_generators_write_the_jax_npz(tmp_path, case):
    name, kw = GENERATORS[case]
    got = _load(getattr(ds, name)(tmp_path / "port" / "d.npz", **kw))
    want = _load(getattr(jax_ds, name)(tmp_path / "jax" / "d.npz", **kw))
    assert_trees_equal(got, want)


def test_expert_set_of_the_learning_run(tmp_path):
    """The learning run's data: 40 episodes of 4 legs, seed 0, 2,103
    transitions in both packages."""
    got = _load(ds.generate_expert_d4rl(tmp_path / "port.npz", n_episodes=40, legs_per_episode=4, seed=0))
    want = _load(jax_ds.generate_expert_d4rl(tmp_path / "jax.npz", n_episodes=40, legs_per_episode=4, seed=0))
    assert_trees_equal(got, want)
    assert len(got["observations"]) == 2103 and int(got["timeouts"].sum()) == 40


@pytest.mark.parametrize("min_len", [1, 5, 12])
def test_episode_bounds_match_jax(min_len):
    rs = np.random.RandomState(min_len)
    timeouts, terminals = rs.rand(200) < 0.05, rs.rand(200) < 0.03
    got = ds.episode_bounds_from_markers(timeouts, terminals, min_len)
    assert got == jax_ds.episode_bounds_from_markers(timeouts, terminals, min_len)
    assert got


def test_live_datasets_need_d4rl_in_both_packages():
    for loader in (ds.load_d4rl_dataset, jax_ds.load_d4rl_dataset):
        with pytest.raises(ImportError, match="d4rl/gym"):
            loader("antmaze-large-diverse-v0")
    with pytest.raises(ImportError, match="d4rl/gym"):
        make_d4rl_env("antmaze-large-diverse-v0")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return ds.generate_expert_d4rl(
        tmp_path_factory.mktemp("d4rl") / "expert.npz", n_episodes=5, legs_per_episode=3, seed=4
    )


PLAY_CASES = {
    "padded_goal": dict(min_window_size=8, max_window_size=16, include_goal=True),
    "augmented_goal": dict(min_window_size=8, max_window_size=12, include_goal=True, goal_augmentation=True),
    "fixed_window": dict(min_window_size=10, max_window_size=10, include_goal=True, goal_sampling_prob=0.5),
    "no_goal_no_pad": dict(min_window_size=6, max_window_size=9, pad=False),
}


@pytest.mark.parametrize("case", list(PLAY_CASES))
def test_play_dataset_items_match_jax(npz, case):
    kw = PLAY_CASES[case]
    port, jax = ds.D4RLPlayDataset(dataset_path=npz, **kw), jax_ds.D4RLPlayDataset(dataset_path=npz, **kw)
    assert len(port) == len(jax) > 0
    np.testing.assert_array_equal(port.episode_lookup, jax.episode_lookup)
    for idx in range(0, len(port), 7):
        got = port.sample(idx, np.random.default_rng((5, idx)))
        want = jax.sample(idx, np.random.default_rng((5, idx)))
        assert_trees_equal(got, want, f"{case} item {idx}")
    if kw.get("include_goal"):
        assert {"goal", "goal_reached"} <= set(got)


def test_transition_dataset_items_match_jax(npz):
    port, jax = ds.D4RLTransitionDataset(dataset_path=npz), jax_ds.D4RLTransitionDataset(dataset_path=npz)
    assert len(port) == len(jax) > 0
    rewards = []
    for idx in range(0, len(port), 3):
        got = port.sample(idx, np.random.default_rng((2, idx)))
        assert_trees_equal(got, jax.sample(idx, np.random.default_rng((2, idx))), f"item {idx}")
        rewards.append(float(got["rewards"]))
    assert got["observations"].shape == (OBS_DIM + 2,)
    assert 0.0 < np.mean(rewards) < 1.0  # both outcomes of the relabelling occur


@pytest.mark.parametrize("dataset", ["D4RLPlayDataset", "D4RLTransitionDataset"])
def test_datamodule_batches_match_jax_over_two_epochs(npz, dataset):
    cfg = {"_target_": f"tacorl_tpu.data.d4rl_dataset.{dataset}", "dataset_path": str(npz)}
    if dataset == "D4RLPlayDataset":
        cfg.update(min_window_size=8, max_window_size=16, include_goal=True)
    port, jax = D4RLDataModule(dict(cfg), batch_size=16, seed=3), JaxD4RLDataModule(dict(cfg), batch_size=16, seed=3)
    port.setup()
    jax.setup()
    assert type(port.train_dataset).__module__ == "tacorl_tpu_torch.data.d4rl_dataset"
    assert port.val_loader() is None and jax.val_loader() is None
    port_loader, jax_loader = port.train_loader(), jax.train_loader()
    n = 0
    for epoch in range(2):
        port_batches, jax_batches = list(port_loader), list(jax_loader)
        assert len(port_batches) == len(jax_batches) == len(port_loader) > 0
        for i, (got, want) in enumerate(zip(port_batches, jax_batches)):
            assert_trees_equal(got, want, f"epoch {epoch} batch {i}")
            n += 1
    assert n == 2 * len(port_loader)


@pytest.mark.parametrize("dims", [(OBS_DIM, ACT_DIM), (29, 8)], ids=["fake", "antmaze_shapes"])
def test_fake_env_matches_jax_under_the_same_actions(dims):
    obs_dim, act_dim = dims
    port = FakeD4RLEnv(obs_dim=obs_dim, act_dim=act_dim, max_episode_steps=25, seed=7)
    jax = JaxFakeD4RLEnv(obs_dim=obs_dim, act_dim=act_dim, max_episode_steps=25, seed=7)
    rs = np.random.RandomState(0)
    assert port.action_dim == act_dim and port._max_episode_steps == 25
    successes = 0
    for episode in range(4):
        np.testing.assert_array_equal(port.reset(), jax.reset())
        np.testing.assert_array_equal(port.target_goal, jax.target_goal)
        np.testing.assert_array_equal(port.goal_locations[0], jax.goal_locations[0])
        done = False
        while not done:
            # the expert half the time, so some episodes succeed
            np.testing.assert_array_equal(port.expert_action(), jax.expert_action())
            action = port.expert_action() if episode % 2 else rs.uniform(-1.5, 1.5, act_dim).astype(np.float32)
            got, want = port.step(action), jax.step(action)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            done = got[2]
        successes += got[3]["success"]
        assert port.get_normalized_score(got[1]) == jax.get_normalized_score(want[1])
    assert successes >= 1
