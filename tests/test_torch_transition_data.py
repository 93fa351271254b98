"""The port's flat-RL data path held against the JAX package's, bit for
bit, on the CPU: GoalCondTransitionDataset (each of the seven goal
strategies, the horizon curriculum hooks, the zero-probability drop, the
lang-annotation task filter) over expert play in both storage layouts, the
DataLoader's batches of it over 2 epochs, SavedTransitionDataset over
files the JAX ReplayBuffer writes, and the core/obs.py helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.core import obs as jax_obs
from tacorl_tpu.data import loader as jax_loader
from tacorl_tpu.data import saved_transitions as jax_saved
from tacorl_tpu.data import storage as jax_storage
from tacorl_tpu.data import transition_dataset as jax_td
from tacorl_tpu.data.replay_buffer import ReplayBuffer
from tacorl_tpu_torch.core import obs
from tacorl_tpu_torch.data import loader, saved_transitions, transition_dataset
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tests.test_torch_envs import assert_same

MODALITIES = ["robot_obs", "scene_obs", "rel_actions_world"]
STRATEGIES = ("random", "geometric", "increasing_horizon", "similar_robot_obs",
              "next_state", "episode_future", "task_future")
TASKS = {"language": {"task": ["open_drawer", "lift_block", "open_drawer"]},
         "info": {"indx": [(0, 12), (30, 44), (70, 90)]}}


@pytest.fixture(scope="module")
def play(tmp_path_factory):
    """Expert play (frame dirs) with lang annotations on the training
    split, and the same set packed by the JAX package."""
    root = tmp_path_factory.mktemp("play")
    generate_expert_play(root / "frames", n_train_episodes=3, n_val_episodes=1,
                         tasks_per_episode=2, seed=7)
    ann_dir = root / "frames" / "training" / "lang_annotations"
    ann_dir.mkdir()
    np.save(ann_dir / "auto_lang_ann.npy", TASKS)
    for split in ("training", "validation"):
        jax_storage.pack_frames(root / "frames" / split, root / "packed" / split)
    (root / "packed" / "training" / "lang_annotations").mkdir()
    np.save(root / "packed" / "training" / "lang_annotations" / "auto_lang_ann.npy", TASKS)
    return root


def _datasets(root, tmp_path, layout="frames", train=True, **kw):
    split = root / layout / ("training" if train else "validation")
    kw.setdefault("initial_horizon", 4)
    return (
        transition_dataset.GoalCondTransitionDataset(
            split, MODALITIES, train=train, nn_steps_from_step_path=str(tmp_path / "port_nn.json"), **kw
        ),
        jax_td.GoalCondTransitionDataset(
            split, MODALITIES, train=train, nn_steps_from_step_path=str(tmp_path / "jax_nn.json"), **kw
        ),
    )


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_goal_strategy_matches_jax(play, tmp_path, strategy):
    port, ref = _datasets(play, tmp_path, goal_strategy_prob={strategy: 1.0}, num_nn=4)
    assert port.possible_steps == ref.possible_steps
    for idx in range(0, len(ref), 3):
        step = ref.possible_steps[idx]
        got = port.get_goal_step(np.random.default_rng((1, idx)), step, strategy)
        want = ref.get_goal_step(np.random.default_rng((1, idx)), step, strategy)
        assert got == want, (strategy, step)
        assert_same(port.sample(idx, np.random.default_rng(idx)), ref.sample(idx, np.random.default_rng(idx)))
    if strategy == "next_state":
        item = port.sample(0, np.random.default_rng(0))
        assert item["rewards"] == item["terminals"] == np.float32(1.0)
    if strategy == "similar_robot_obs":
        assert (tmp_path / "port_nn.json").read_bytes() == (tmp_path / "jax_nn.json").read_bytes()


def test_curriculum_hooks_match_jax(play, tmp_path):
    mix = {"geometric": 0.5, "increasing_horizon": 0.5, "similar_robot_obs": 0.0}
    port, ref = _datasets(play, tmp_path, goal_strategy_prob=mix, horizon_step=4, max_horizon=20)
    # a zero-probability strategy is dropped, and with it the k-NN index
    assert port.goal_strategy_prob == ref.goal_strategy_prob == {"geometric": 0.5, "increasing_horizon": 0.5}
    assert not (tmp_path / "port_nn.json").exists()
    for hook, arg in (("increase_horizon", 2), ("increase_horizon", 9), ("increase_horizon_to", 13),
                      ("increase_horizon_to", 10_000)):
        getattr(port, hook)(arg)
        getattr(ref, hook)(arg)
        assert port.current_horizon == ref.current_horizon
        got = [port.sample(i, np.random.default_rng(i)) for i in range(len(ref))]
        assert_same(got, [ref.sample(i, np.random.default_rng(i)) for i in range(len(ref))])
    assert port.current_horizon == 20


@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_task_filter_matches_jax(play, tmp_path, layout):
    port, ref = _datasets(play, tmp_path, layout, goal_strategy_prob={"task_future": 1.0},
                          filter_by_tasks=True, tasks=["open_drawer"])
    assert port.possible_steps == ref.possible_steps
    assert set(port.possible_steps) <= set(range(0, 13)) | set(range(70, 91))
    assert_same([port.sample(i, np.random.default_rng(i)) for i in range(len(ref))],
                [ref.sample(i, np.random.default_rng(i)) for i in range(len(ref))])


def test_bad_configurations_are_refused(play, tmp_path):
    split = play / "frames" / "training"
    with pytest.raises(ValueError, match="modalities"):
        transition_dataset.GoalCondTransitionDataset(split, ["robot_obs"])
    with pytest.raises(ValueError, match="sum to 1"):
        transition_dataset.GoalCondTransitionDataset(split, MODALITIES, goal_strategy_prob={"geometric": 0.5})
    ds = transition_dataset.GoalCondTransitionDataset(split, MODALITIES, goal_strategy_prob={"geometric": 1.0})
    with pytest.raises(ValueError, match="unknown goal strategy"):
        ds.get_goal_step(np.random.default_rng(0), 0, "nearest")


MIX = {"geometric": 0.7, "increasing_horizon": 0.3, "similar_robot_obs": 0.0}


@pytest.mark.parametrize("layout", ["frames", "packed"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_loader_batches_match_jax_over_two_epochs(play, tmp_path, layout, train):
    port, ref = _datasets(play, tmp_path, layout, train, goal_strategy_prob=MIX)
    kw = dict(batch_size=8, seed=3, shuffle=train)
    port_dl, ref_dl = loader.DataLoader(port, **kw), jax_loader.DataLoader(ref, **kw)
    got = [list(port_dl) for _ in range(2)]
    want = [list(ref_dl) for _ in range(2)]
    assert len(got[0]) == len(ref_dl) > 1
    assert_same(got, want)
    assert got[0][0]["observations"]["goal"]["scene_obs"].shape == (8, 24)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Transitions written by the JAX ReplayBuffer: array states and dict
    states."""
    root = tmp_path_factory.mktemp("saved")
    rs = np.random.RandomState(0)
    for kind in ("array", "dict"):
        buf = ReplayBuffer(100)
        for i in range(12):
            state = rs.randn(5).astype(np.float32)
            next_state = rs.randn(5).astype(np.float32)
            if kind == "dict":
                state, next_state = {"robot_obs": state}, {"robot_obs": next_state}
            buf.add_transition(state, rs.randn(7).astype(np.float32), next_state,
                               float(i % 3 == 0), bool(i % 4 == 0))
        buf.save(root / kind)
    return root


@pytest.mark.parametrize("kind", ["array", "dict"])
@pytest.mark.parametrize("train,val_percentage", [(True, 0.25), (False, 0.25), (True, 0.0), (False, 0.05)])
def test_saved_transitions_match_jax(saved, kind, train, val_percentage):
    port = saved_transitions.SavedTransitionDataset(saved / kind, train, val_percentage)
    ref = jax_saved.SavedTransitionDataset(saved / kind, train, val_percentage)
    assert port.files == ref.files and len(port) == len(ref) > 0
    for i in range(len(ref)):
        assert_same(port.sample(i), ref.sample(i))


def test_saved_transitions_need_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="no transition files"):
        saved_transitions.SavedTransitionDataset(tmp_path)


# -- core/obs.py -------------------------------------------------------------------------


def _obs_tree(rs, lead=(3,)):
    return {
        "observation": {"robot_obs": rs.randn(*lead, 5).astype(np.float32),
                        "rgb_static": rs.randint(0, 255, lead + (4, 4, 3)).astype(np.uint8)},
        "goal": {"scene_obs": rs.randn(*lead, 2).astype(np.float32)},
    }


def _as(tree, fn):
    return jax.tree.map(fn, tree)


def _check(got, want):
    assert_same(_as(got, lambda x: x.numpy()), _as(want, np.asarray))


@pytest.mark.parametrize("reshape", [True, False])
def test_expand_obs_matches_jax(reshape):
    tree = _obs_tree(np.random.RandomState(0))
    _check(obs.expand_obs(_as(tree, torch.from_numpy), 4, reshape),
           jax_obs.expand_obs(_as(tree, jnp.asarray), 4, reshape))


def test_obs_helpers_match_jax():
    tree = _obs_tree(np.random.RandomState(1), lead=(2, 3))
    t, j = _as(tree, torch.from_numpy), _as(tree, jnp.asarray)
    assert obs.batch_size_of(t) == jax_obs.batch_size_of(j) == 2
    flat_t, flat_j = obs.flatten_obs_time(t), jax_obs.flatten_obs_time(j)
    _check(flat_t, flat_j)
    _check(obs.unflatten_obs_time(flat_t, 2, 3), jax_obs.unflatten_obs_time(flat_j, 2, 3))
    _check(obs.index_obs(flat_t, torch.tensor([4, 0])), jax_obs.index_obs(flat_j, jnp.asarray([4, 0])))
    _check(obs.obs_map(lambda x: x[:1] * 2, t), jax_obs.obs_map(lambda x: x[:1] * 2, j))
