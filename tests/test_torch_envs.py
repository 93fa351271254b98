"""The port's host-side copies held against the JAX package's: the fake
CALVIN envs (observations, rewards, dones, infos, the stored start/goal
table and the scripted expert, bit for bit), the episode storage, the three
rollout-task generators, and the expert-play data generator."""

import json

import numpy as np
import pytest

from tacorl_tpu.data import expert_play as jax_expert_play
from tacorl_tpu.data import storage as jax_storage
from tacorl_tpu.data.synthetic import generate_synthetic_calvin
from tacorl_tpu.envs import fake_calvin as jax_fake_calvin
from tacorl_tpu.evaluation import rollout_generator as jax_generators
from tacorl_tpu_torch.data import expert_play, storage
from tacorl_tpu_torch.envs import fake_calvin
from tacorl_tpu_torch.evaluation import rollout_generator as generators


def assert_same(a, b, where="root"):
    """Equal structure, types, dtypes and values, bit for bit."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, (where, a, b)


# -- envs ------------------------------------------------------------------------

RESETS = {
    "random": {},
    "stored_pair": {"task_info": {"task": "turn_on_led", "index": 1}},
    "start_and_goal": "start_and_goal",  # built from the env's own table
    "state": "state",
}


def _reset_kwargs(env, kind):
    if kind == "start_and_goal":
        pair = env.initial_and_goal_states["open_drawer"][0]
        return {"task_info": {"start_info": pair["start_info"], "goal_info": pair["goal_info"]}}
    if kind == "state":
        rs = np.random.RandomState(5)
        return {"robot_obs": rs.uniform(-0.5, 0.5, 15), "scene_obs": rs.uniform(-0.2, 0.2, 24)}
    return RESETS[kind]


def _trace(module, cls, task_set, reset_kind, steps=40):
    """The env's stored table, its reset, then ``steps`` steps that mix the
    scripted expert with uniform actions from one numpy stream; then a
    goal-only reset (state carried) and a few more steps."""
    env = getattr(module, cls)(task_set=task_set, seed=3, max_episode_steps=30)
    out = {"table": env.initial_and_goal_states, "possible": env.get_possible_tasks()}
    out["reset"] = env.reset(**_reset_kwargs(env, reset_kind))
    rs = np.random.RandomState(7)
    records = []
    for i in range(steps):
        expert = env.expert_action(gain=0.8)
        action = expert if i % 3 else rs.uniform(-1, 1, 7)
        records.append((expert, env.step(action)))
    out["steps"] = records
    goal = env.initial_and_goal_states["lift_block"][2]["goal_info"]
    out["goal_only_reset"] = env.reset(task_info={"goal_info": goal, "tasks": ["lift_block"]})
    out["after"] = [env.step(env.expert_action()) for _ in range(5)]
    out["state"] = (env.robot_obs, env.scene_obs, env.selected_tasks, env.start_info)
    return out


@pytest.mark.parametrize("reset_kind", list(RESETS))
@pytest.mark.parametrize("task_set", ["default", "hard"])
@pytest.mark.parametrize("cls", ["FakeCalvinEnv", "FakePlayTableEnv"])
def test_env_matches_jax_bit_for_bit(cls, task_set, reset_kind):
    port = _trace(fake_calvin, cls, task_set, reset_kind)
    ref = _trace(jax_fake_calvin, cls, task_set, reset_kind)
    assert_same(port, ref)
    if task_set == "default" and cls == "FakeCalvinEnv" and reset_kind == "stored_pair":
        # the expert completes the stored task inside the trace
        assert any(rec[1][3]["success"] for rec in port["steps"])


def test_task_sets_and_expert_action_match():
    assert_same(fake_calvin.TASK_SETS, jax_fake_calvin.TASK_SETS)
    for gain in (0.5, 1.0):
        envs = [m.FakeCalvinEnv(task_set="hard", seed=1) for m in (fake_calvin, jax_fake_calvin)]
        for env in envs:
            env.reset(task_info={"task": "open_drawer", "index": 0})
        assert_same(envs[0].expert_action(gain), envs[1].expert_action(gain))


# -- data: storage and the expert-play generator -----------------------------------


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    root = tmp_path_factory.mktemp("syncalvin")
    generate_synthetic_calvin(root, n_train_episodes=1, n_val_episodes=2, episode_len=40, image_hw=32)
    return root / "validation"


@pytest.fixture(scope="module")
def packed(synthetic, tmp_path_factory):
    dst = tmp_path_factory.mktemp("packed")
    jax_storage.pack_frames(synthetic, dst)
    return dst


@pytest.mark.parametrize("layout", ["frames", "packed"])
def test_storage_reads_match_jax(synthetic, packed, layout):
    data_dir = synthetic if layout == "frames" else packed
    port, ref = storage.open_storage(data_dir), jax_storage.open_storage(data_dir)
    assert type(port).__name__ == type(ref).__name__
    assert port.keys == ref.keys
    ids = jax_storage.load_ep_start_end_ids(data_dir, train=False)
    assert_same(storage.load_ep_start_end_ids(data_dir, train=False), ids)
    assert_same(storage.load_statistics(data_dir), jax_storage.load_statistics(data_dir))
    for start, end in ids:
        assert_same(port.read_frame(int(start), port.keys), ref.read_frame(int(start), ref.keys))
        assert_same(
            port.read_window(int(start), int(start) + 8, ["rgb_static", "actions"]),
            ref.read_window(int(start), int(start) + 8, ["rgb_static", "actions"]),
        )


def test_port_packs_frames_as_jax_does(synthetic, packed, tmp_path):
    port = storage.pack_frames(synthetic, tmp_path)
    ref = jax_storage.PackedStorage(packed)
    assert port.meta == ref.meta
    assert_same(port.steps, ref.steps)
    assert_same(port.read_window(int(ref.steps[0]), int(ref.steps[0]) + 5, ref.keys),
                ref.read_window(int(ref.steps[0]), int(ref.steps[0]) + 5, ref.keys))


@pytest.mark.parametrize("method", ["read_window_batch", "read_frame_batch"])
def test_native_batched_reads_name_their_roadmap_item(packed, method):
    """The batched reads, once stubs naming ROADMAP item 6, now gather
    through the native loader as the JAX package's do."""
    store, ref = storage.open_storage(packed), jax_storage.open_storage(packed)
    start = int(ref.steps[0])
    args = ([start, start + 3], 4, ["actions"]) if method == "read_window_batch" else ([start], ["actions"])
    assert_same(getattr(store, method)(*args), getattr(ref, method)(*args))


def _dir_contents(root):
    """Every file under ``root`` by relative path: npz files as their
    arrays, everything else as bytes."""
    out = {}
    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = str(path.relative_to(root))
        if path.suffix == ".npz":
            with np.load(path) as data:
                out[rel] = {k: data[k] for k in data.files}
        elif path.suffix == ".npy":
            out[rel] = np.load(path)
        else:
            out[rel] = path.read_bytes()
    return out


@pytest.mark.parametrize("distinct", [False, True])
def test_expert_play_generator_matches_jax(tmp_path, distinct):
    kwargs = dict(
        n_train_episodes=1, n_val_episodes=2, tasks_per_episode=3, image_hw=48,
        idle_steps=(3, 7), seed=11, distinct_tasks=distinct,
    )
    expert_play.generate_expert_play(tmp_path / "port", **kwargs)
    jax_expert_play.generate_expert_play(tmp_path / "jax", **kwargs)
    port, ref = _dir_contents(tmp_path / "port"), _dir_contents(tmp_path / "jax")
    assert list(port) == list(ref) and len(port) > 10
    assert_same(port, ref)
    spans = json.loads(port["validation/start_end_tasks.json"])
    assert spans, "no verified spans in the fixture"


# -- rollout-task generators ---------------------------------------------------------


@pytest.fixture(scope="module")
def chain_table(tmp_path_factory):
    """tests/test_evaluation.py's crafted chain table: monotone completed
    counts from 10, a jump straight to three tasks from 50."""
    root = tmp_path_factory.mktemp("chains")
    table = {
        "10": {"20": ["a"], "30": ["a", "b"], "40": ["a", "b", "c"]},
        "50": {"60": ["a", "b", "c"]},
    }
    data_dir = root / "frames"
    data_dir.mkdir()
    rs = np.random.RandomState(0)
    for step in (10, 20, 30, 40, 50, 60):
        np.savez(data_dir / f"episode_{step:07d}.npz",
                 robot_obs=rs.randn(15), scene_obs=rs.randn(24))
    (root / "tasks.json").write_text(json.dumps(table))
    return data_dir, root / "tasks.json"


def _generator_views(module, name, data_dir, table, strategy, **kw):
    gen = getattr(module, name)(
        data_dir=data_dir, start_end_tasks=table, strategy=strategy,
        min_seq_len=kw.pop("min_seq_len", 2), max_seq_len=64, seed=4, **kw,
    )
    tasks = gen.get_rollout_tasks()
    if name == "SingleTaskRolloutGenerator":
        infos = [gen.get_reset_info(t, i) for t in tasks for i in range(gen.get_num_rollouts_from_task(t))]
    elif name == "LongHorizonRolloutGenerator":
        infos = [gen.get_reset_info(i) for i in range(len(tasks))]
    else:
        infos = [
            [gen.get_state_info_from_step(int(s))] + [gen.get_state_info_from_step(int(e)) for e in ends]
            for s, ends in tasks.items()
        ]
    return tasks, infos


# the synthetic table holds single-task spans only, so its long-horizon
# generators take chains of one task; the chain table's take three
GENERATORS = [
    ("SingleTaskRolloutGenerator", {}),
    ("LongHorizonRolloutGenerator", {"tasks_per_rollout": 1}),
    ("LongHorizonSequentialRolloutGenerator", {"tasks_per_rollout": 1}),
]


@pytest.mark.parametrize("strategy", ["longest", "shortest", "random"])
@pytest.mark.parametrize("name, kw", GENERATORS, ids=[g[0] for g in GENERATORS])
@pytest.mark.parametrize("data", ["synthetic", "chain_table"])
def test_generators_match_jax(request, data, name, kw, strategy):
    if data == "synthetic":
        data_dir = request.getfixturevalue("synthetic")
        table = data_dir / "start_end_tasks.json"
    else:
        data_dir, table = request.getfixturevalue("chain_table")
        kw = {"min_seq_len": 1} if name == "SingleTaskRolloutGenerator" else {"tasks_per_rollout": 3}
    port = _generator_views(generators, name, data_dir, table, strategy, **dict(kw))
    ref = _generator_views(jax_generators, name, data_dir, table, strategy, **dict(kw))
    assert_same(port, ref)
    assert port[0], "the generator found no rollout tasks"
