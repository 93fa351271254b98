"""The port's real-robot pieces held against the JAX package's on the CPU,
over the mock ``robot_io`` of tests/test_env_adapters.py (its camera made
to show a different frame each step): ``RealWorldEnv`` (the same reset
arguments, observations and robot actions), ``python -m
tacorl_tpu_torch.evaluate_real_world`` against scripts/evaluate_real_world.py
and one ``rollout_proposal`` of the dataset-driven entry point against the
JAX script's loop body, each on a RIL checkpoint converted from one
Lightning file by both packages (a deterministic agent: the same robot
actions at atol 1e-5), ``StartGoalProposer``'s proposals, and
``python -m tacorl_tpu_torch.measure_protocol_ceiling`` against
scripts/measure_protocol_ceiling.py (equal JSON)."""

import json

import numpy as np
import pytest

from scripts import evaluate_real_world as jax_erw
from scripts import evaluate_real_world_from_dataset as jax_erwd
from scripts import measure_protocol_ceiling as jax_ceiling
from tacorl_tpu.envs.real_world import RealWorldEnv as JaxRealWorldEnv
from tacorl_tpu_torch import evaluate_real_world, evaluate_real_world_from_dataset, measure_protocol_ceiling
from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.envs import real_world
from tacorl_tpu_torch.envs.real_world import MAX_REL_ORN, MAX_REL_POS, RealWorldEnv
from tests.test_env_adapters import MockRobotEnv, mock_robot_io  # noqa: F401
from tests.test_torch_lightning_convert import RIL_CFG, _convert_both, reference_model, write_lightning

ATOL = 1e-5


class MovingCameraRobotEnv(MockRobotEnv):
    """The mock robot env, its camera showing a new seeded frame each
    call; every instance is kept, so a test reads the actions sent."""

    made = []

    def __init__(self, robot=None, **kwargs):
        super().__init__(robot, **kwargs)
        rs = np.random.RandomState(0)  # each env, either package's, sees the same frames
        self.camera_manager.get_images = lambda: {"rgb_static": rs.randint(0, 256, (32, 32, 3)).astype(np.uint8)}
        MovingCameraRobotEnv.made.append(self)


@pytest.fixture
def moving_robot_io(mock_robot_io, monkeypatch):  # noqa: F811
    monkeypatch.setattr(mock_robot_io, "RobotEnv", MovingCameraRobotEnv)
    MovingCameraRobotEnv.made = []
    return mock_robot_io


def test_real_world_env_matches_the_jax_adapter(moving_robot_io):
    assert get_class("tacorl_tpu.envs.real_world.RealWorldEnv") is RealWorldEnv
    assert (MAX_REL_POS, MAX_REL_ORN) == (0.02, 0.05)
    goal = {"rgb_static": np.ones((32, 32, 3), np.uint8)}
    robot_obs = np.concatenate([[0.1, 0.2, 0.3], [0.4, 0.0, -0.1], np.zeros(8), [-1.0]])
    actions = np.random.RandomState(0).uniform(-1.5, 1.5, (4, 7))
    runs = []
    for cls in (RealWorldEnv, JaxRealWorldEnv):
        env = cls(modalities=["rgb_static", "robot_obs"], max_episode_steps=4)
        obs = [env.reset(goal=goal, robot_obs=robot_obs)]
        obs += [env.step(a)[0] for a in actions]
        env.reset(goal=goal, reset_to_neutral=True)
        runs.append((env._env, obs))
    (port_env, port_obs), (jax_env, jax_obs) = runs
    assert port_env.reset_kwargs[0]["gripper_state"] == "closed"
    for a, b in zip(port_env.reset_kwargs, jax_env.reset_kwargs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(port_env.steps, jax_env.steps):
        assert a["ref"] == b["ref"] == "rel" and a["motion"][2] == b["motion"][2]
        np.testing.assert_array_equal(a["motion"][0], b["motion"][0])
        np.testing.assert_array_equal(a["motion"][1], b["motion"][1])
    for a, b in zip(port_obs, jax_obs):
        assert a["goal"] is goal and b["goal"] is goal
        for k in ("rgb_static", "robot_obs"):
            np.testing.assert_array_equal(a["observation"][k], b["observation"][k])


def test_without_robot_io_the_error_names_it(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def deny(name, *a, **kw):
        if name.startswith("robot_io"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", deny)
    with pytest.raises(ImportError, match="robot_io is required"):
        real_world.RealWorldEnv()


@pytest.fixture(scope="module")
def ril_runs(tmp_path_factory):
    """One Lightning RIL checkpoint converted by both packages, with the
    evaluation transforms a camera frame needs."""
    root = tmp_path_factory.mktemp("ril")
    cfg = dict(RIL_CFG, transforms={"rgb_static": {"kind": "rgb", "size": [48, 48]}})
    ckpt = write_lightning(reference_model("ril"), root / "ril.ckpt")
    return _convert_both("ril", ckpt, cfg, cfg, root)


def _robot_actions(env):
    return np.array([np.concatenate([m["motion"][0], m["motion"][1], [m["motion"][2]]]) for m in env.steps])


def test_evaluate_real_world_sends_the_jax_scripts_robot_actions(moving_robot_io, ril_runs, tmp_path):
    import cv2

    jax_dir, port_dir = ril_runs
    img = tmp_path / "goal.png"
    cv2.imwrite(str(img), np.random.RandomState(9).randint(0, 256, (32, 32, 3)).astype(np.uint8))
    common = [f"img_path={img}", "plan_duration=2", "env.max_episode_steps=5"]
    port_out = evaluate_real_world.main(["+device=cpu", f"module_path={port_dir}"] + common)
    jax_out = jax_erw.main([f"module_path={jax_dir}"] + common)
    assert port_out == jax_out and port_out["episode_length"] == 5
    port_env, jax_env = MovingCameraRobotEnv.made
    np.testing.assert_allclose(_robot_actions(port_env), _robot_actions(jax_env), atol=ATOL)
    assert np.abs(np.diff(_robot_actions(port_env)[:, :6], axis=0)).max() > 0  # the frames moved the policy


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    root = tmp_path_factory.mktemp("recording")
    generate_expert_play(root, n_train_episodes=1, n_val_episodes=1, tasks_per_episode=2,
                         idle_steps=(2, 3), seed=6, image_hw=32)
    return root / "training"


def test_start_goal_proposals_equal_the_jax_proposers(recording):
    table = {"open_drawer": [(0, 5), (3, 9)], "move_slider_left": [(2, 4)]}
    port = evaluate_real_world_from_dataset.StartGoalProposer(recording, task_table=table)
    jax = jax_erwd.StartGoalProposer(recording, task_table=table)
    assert port.proposals == jax.proposals and len(port) == len(jax) == 3
    for _ in range(4):  # wraps around
        (pt, pr, pg), (jt, jr, jg) = port.next(), jax.next()
        assert pt == jt
        np.testing.assert_array_equal(pr, jr)
        np.testing.assert_array_equal(pg["rgb_static"], jg["rgb_static"])
    # frame directories need a table, in both packages
    for cls in (evaluate_real_world_from_dataset.StartGoalProposer, jax_erwd.StartGoalProposer):
        with pytest.raises(ValueError, match="task_table required"):
            cls(recording, spacing=4)


def test_start_goal_proposals_without_a_table_on_packed_storage(recording, tmp_path):
    from tacorl_tpu_torch.data.storage import pack_frames

    packed = tmp_path / "packed"
    pack_frames(recording, packed)
    port = evaluate_real_world_from_dataset.StartGoalProposer(packed, spacing=4)
    jax = jax_erwd.StartGoalProposer(packed, spacing=4)
    assert port.proposals == jax.proposals and len(port) > 1
    (pt, pr, pg), (jt, jr, jg) = port.next(), jax.next()
    assert pt == jt == "unnamed"
    np.testing.assert_array_equal(pr, jr)
    np.testing.assert_array_equal(pg["rgb_static"], jg["rgb_static"])


def test_one_proposal_rollout_sends_the_jax_loops_robot_actions(moving_robot_io, ril_runs, recording):
    from tacorl_tpu.config import compose as jax_compose
    from tacorl_tpu.config import instantiate as jax_instantiate
    from tacorl_tpu.core.checkpoint import load_module_from_checkpoint as jax_load
    from tacorl_tpu.evaluation.agents import make_agent as jax_make_agent
    from tacorl_tpu_torch.config import compose

    jax_dir, port_dir = ril_runs
    table = {"open_drawer": [(1, 8)]}
    over = ["img_path=unused", "plan_duration=3", "env.max_episode_steps=4"]
    cfg = compose(evaluate_real_world.CONFIG_DIR, "evaluate_real_world",
                  ["+device=cpu", f"module_path={port_dir}"] + over)
    agent, manager, env = evaluate_real_world.load_agent(cfg)
    task, robot_obs, goal = evaluate_real_world_from_dataset.StartGoalProposer(recording, table).next()
    port_out = evaluate_real_world_from_dataset.rollout_proposal(manager, agent, env, task, robot_obs, goal)

    # the JAX script's loop body for the same proposal
    jcfg = jax_compose(evaluate_real_world.CONFIG_DIR, "evaluate_real_world", [f"module_path={jax_dir}"] + over)
    jmodule, jstate = jax_load(jcfg["module_path"])
    jagent, jmanager_cls = jax_make_agent(jmodule, jstate)
    _, jrobot_obs, jgoal = jax_erwd.StartGoalProposer(recording, table).next()
    jax_out = jmanager_cls(plan_duration=3).episode_rollout(
        jagent, jax_instantiate(jcfg["env"]), {"goal": jgoal, "robot_obs": jrobot_obs}
    )
    assert port_out == jax_out
    port_env, jax_env = MovingCameraRobotEnv.made
    np.testing.assert_array_equal(port_env.reset_kwargs[0]["target_pos"], robot_obs[:3])
    np.testing.assert_allclose(_robot_actions(port_env), _robot_actions(jax_env), atol=ATOL)


def test_measure_protocol_ceiling_writes_the_jax_scripts_json(tmp_path):
    generate_expert_play(tmp_path / "data", n_train_episodes=1, n_val_episodes=2, tasks_per_episode=2,
                         idle_steps=(2, 3), seed=7, image_hw=32)
    common = [f"data_dir={tmp_path / 'data' / 'validation'}", "lh_depth=2", "lh_seq_depth=2",
              "max_episode_steps=48", "image_hw=32"]
    got = measure_protocol_ceiling.main(common + [f"out_dir={tmp_path / 'port'}"])
    want = jax_ceiling.main(common + [f"out_dir={tmp_path / 'jax'}"])
    assert got == want and got["long_horizon"]["num_rollouts"] > 0
    for name in ("expert_ceiling_summary", "expert_short_horizon", "expert_lh", "expert_lh_seq"):
        assert json.loads((tmp_path / "port" / f"{name}.json").read_text()) == \
            json.loads((tmp_path / "jax" / f"{name}.json").read_text()), name
