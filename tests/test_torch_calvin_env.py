"""The port's real-CALVIN adapter (``envs/calvin.py``) and its frame helpers
(``utils/geometry.py``) held against the JAX package's on the CPU, under
the mock ``calvin_env`` of tests/test_env_adapters.py (the simulator is not
installed): ``reset`` and ``step`` of both classes give bit-equal
observations, rewards, dones and infos, and drive the simulator with
bit-equal actions, for the ``abs``, ``rel_world`` and ``rel_tcp`` frames
(a tilted TCP, as euler angles and as a quaternion), the micro-repeat loop,
every reset path and the dense reward; the missing-package error; the
geometry functions at atol 1e-12 on seeded random inputs."""

import sys
import types

import numpy as np
import pytest

from tacorl_tpu.envs import calvin as jax_calvin
from tacorl_tpu.utils import geometry as jax_geometry
from tacorl_tpu_torch.envs import calvin
from tacorl_tpu_torch.utils import geometry
from tests.test_env_adapters import MockPlayTableSimEnv, MockRobot, MockTasks

# -- the geometry helpers ---------------------------------------------------------


def _geometry_inputs(seed=0, n=16):
    rs = np.random.RandomState(seed)
    eulers = list(rs.uniform(-np.pi, np.pi, (n, 3)))
    eulers += [np.array([0.3, np.pi / 2, -0.2]), np.array([0.1, -np.pi / 2, 0.4])]  # gimbal lock
    quats = list(rs.randn(n, 4)) + [np.zeros(4)]
    return rs, eulers, quats


def test_euler_to_matrix_matches_jax():
    _, eulers, _ = _geometry_inputs()
    for e in eulers:
        np.testing.assert_allclose(geometry.euler_to_matrix(e), jax_geometry.euler_to_matrix(e), atol=1e-12)


def test_matrix_to_euler_matches_jax():
    _, eulers, quats = _geometry_inputs()
    mats = [jax_geometry.euler_to_matrix(e) for e in eulers] + [jax_geometry.quat_to_matrix(q) for q in quats]
    for m in mats:
        np.testing.assert_allclose(geometry.matrix_to_euler(m), jax_geometry.matrix_to_euler(m), atol=1e-12)
    # a round trip away from the gimbal lock
    for e in eulers[:16]:
        np.testing.assert_allclose(
            geometry.euler_to_matrix(geometry.matrix_to_euler(geometry.euler_to_matrix(e))),
            geometry.euler_to_matrix(e), atol=1e-9,
        )


def test_quat_to_matrix_matches_jax():
    _, _, quats = _geometry_inputs()
    for q in quats:
        np.testing.assert_allclose(geometry.quat_to_matrix(q), jax_geometry.quat_to_matrix(q), atol=1e-12)


@pytest.mark.parametrize("orn", ["euler", "quat"])
def test_to_world_frame_matches_jax(orn):
    rs, eulers, quats = _geometry_inputs(1)
    for e, q in zip(eulers, quats):
        pos, rel_orn = rs.uniform(-0.02, 0.02, 3), rs.uniform(-0.05, 0.05, 3)
        tcp = e if orn == "euler" else q
        for got, want in zip(geometry.to_world_frame(pos, rel_orn, tcp), jax_geometry.to_world_frame(pos, rel_orn, tcp)):
            np.testing.assert_allclose(got, want, atol=1e-12)


# -- the adapter under the mock simulator -------------------------------------------------


TCP_ORN = {"identity": np.zeros(3), "euler": np.array([0.4, -0.3, 1.1]),
           "quat": np.array([0.2, -0.1, 0.3, 0.9])}


def _mock(monkeypatch, orn="identity"):
    """calvin_env with the mock simulator of tests/test_env_adapters.py; its
    robot reports the TCP orientation ``TCP_ORN[orn]``."""

    class Robot(MockRobot):
        def get_observation(self):
            robot_obs, info = super().get_observation()
            info["tcp_orn"] = TCP_ORN[orn].copy()
            return robot_obs, info

    class Sim(MockPlayTableSimEnv):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.robot = Robot()

    pkg = types.ModuleType("calvin_env")
    envs = types.ModuleType("calvin_env.envs")
    pt = types.ModuleType("calvin_env.envs.play_table_env")
    tasks = types.ModuleType("calvin_env.envs.tasks")
    pt.PlayTableSimEnv, tasks.Tasks = Sim, MockTasks
    pkg.envs, envs.play_table_env, envs.tasks = envs, pt, tasks
    for name, mod in [("calvin_env", pkg), ("calvin_env.envs", envs),
                      ("calvin_env.envs.play_table_env", pt), ("calvin_env.envs.tasks", tasks)]:
        monkeypatch.setitem(sys.modules, name, mod)


def _pair(cls_name, **kw):
    """The JAX and the port adapter over two simulators built alike."""
    return getattr(jax_calvin, cls_name)(**kw), getattr(calvin, cls_name)(**kw)


def assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)


def _states(pos):
    return {"robot_obs": np.concatenate([pos, np.zeros(12)]), "scene_obs": np.zeros(24)}


def _episode(jenv, penv, reset_kw, steps, seed=0):
    """Reset both, then step both with the same random actions (large
    enough that the micro-repeat loop applies several times)."""
    assert_same(penv.reset(**reset_kw), jenv.reset(**reset_kw), "reset")
    rs = np.random.RandomState(seed)
    for i in range(steps):
        action = rs.uniform(-1, 1, 7)
        got, want = penv.step(action), jenv.step(action)
        assert_same(got, want, f"step {i}")
        if want[2]:
            break
    assert_same(penv.sim.robot.applied, jenv.sim.robot.applied, "applied actions")
    assert_same(penv.sim.reset_calls, jenv.sim.reset_calls, "sim resets")
    return jenv


MODS = {"modalities": ["rgb_static", "robot_obs", "scene_obs"], "goal_modalities": ["rgb_static", "scene_obs"]}


@pytest.mark.parametrize("action_type,orn", [
    ("abs", "identity"), ("rel_world", "identity"), ("rel_world", "euler"),
    ("rel_tcp", "identity"), ("rel_tcp", "euler"), ("rel_tcp", "quat"),
])
def test_steps_are_bit_equal_to_jax(monkeypatch, action_type, orn):
    _mock(monkeypatch, orn)
    jenv, penv = _pair("CalvinGoalConditionedEnv", action_type=action_type, max_episode_steps=6,
                       tasks=MockTasks([]), **MODS)
    jenv = _episode(jenv, penv, {"robot_obs": np.full(15, 0.1), "scene_obs": np.zeros(24)}, 6)
    # the micro-repeat applied more than once per step, at most 4 times
    assert 6 < len(jenv.sim.robot.applied) <= 24


@pytest.mark.parametrize("reset", ["start_and_goal", "goal_only", "stored_index", "random_stored"])
def test_reset_paths_are_bit_equal_to_jax(monkeypatch, reset):
    """Goal resets from complete or goal-only state info, a stored (task,
    index) pair, and a random stored pair (numpy's global generator)."""
    _mock(monkeypatch)
    table = {"open_drawer": [{"initial": _states(np.zeros(3)), "goal": _states(np.ones(3))},
                             {"initial": _states(np.full(3, 0.2)), "goal": _states(np.full(3, -0.5))}],
             "move_slider_left": [{"initial": _states(np.full(3, 0.3)), "goal": _states(np.zeros(3))}]}
    kw = {"max_episode_steps": 5, "tasks": MockTasks(["open_drawer"]), "initial_and_goal_states": table, **MODS}
    reset_kw = {
        "start_and_goal": {"task_info": {"tasks": [], "goal_info": _states(np.ones(3)),
                                         "start_info": _states(np.zeros(3))}},
        "goal_only": {"task_info": {"tasks": ["open_drawer"], "goal_info": _states(np.ones(3))}},
        "stored_index": {"task_info": {"task": "open_drawer", "index": 1}},
        "random_stored": {},
    }[reset]
    jenv, penv = _pair("CalvinGoalConditionedEnv", **kw)
    np.random.seed(3)
    want = jenv.reset(**reset_kw)
    np.random.seed(3)
    assert_same(penv.reset(**reset_kw), want)
    assert penv.selected_tasks == jenv.selected_tasks and penv.selected_tasks
    assert_same(penv.start_info, jenv.start_info)
    for i in range(5):
        action = np.random.RandomState(i).uniform(-1, 1, 7)
        assert_same(penv.step(action), jenv.step(action), f"step {i}")
    assert_same(penv.sim.reset_calls, jenv.sim.reset_calls)


@pytest.mark.parametrize("dense", [True, False])
def test_play_table_reward_is_bit_equal_to_jax(monkeypatch, dense):
    _mock(monkeypatch)
    kw = {"task": "open_drawer", "dense_reward": dense, "target_value": 0.3, "scene_dim": 5,
          "max_episode_steps": 4, "tasks": MockTasks(["open_drawer"] if not dense else []), **MODS}
    jenv, penv = _pair("CalvinPlayTableEnv", **kw)
    assert penv.selected_tasks == jenv.selected_tasks == ["open_drawer"]
    jenv = _episode(jenv, penv, {"robot_obs": np.zeros(15), "scene_obs": np.zeros(24)}, 4)
    if dense:
        _, reward, _, _ = penv.step(np.zeros(7))
        assert reward == -abs(5 / 24.0 - 0.3)


def test_unknown_action_type_raises_as_in_jax(monkeypatch):
    _mock(monkeypatch)
    for env in _pair("CalvinGoalConditionedEnv", action_type="nope", tasks=MockTasks([]), **MODS):
        env.reset(robot_obs=np.zeros(15), scene_obs=np.zeros(24))
        with pytest.raises(ValueError, match="unknown action_type"):
            env.step(np.zeros(7))


def test_missing_calvin_env_names_the_fake_env(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def deny_calvin(name, *a, **kw):
        if name.startswith("calvin_env"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", deny_calvin)
    for mod in list(sys.modules):
        if mod.startswith("calvin_env"):
            monkeypatch.delitem(sys.modules, mod)
    for cls in (calvin.CalvinGoalConditionedEnv, calvin.CalvinPlayTableEnv):
        with pytest.raises(ImportError, match="calvin_env is required") as err:
            cls()
        assert "tacorl_tpu_torch.envs.fake_calvin.FakeCalvinEnv" in str(err.value)
