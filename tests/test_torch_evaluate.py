"""The port's evaluation layer held against the JAX package on the CPU:
config composition of configs/evaluate.yaml, the three evaluation protocols
driven by the scripted expert (equal result JSON, the protocol ceiling of
tests/test_evaluation.py included), rollout videos, and
``python -m tacorl_tpu_torch.evaluate`` against scripts/evaluate.py on one
tiny Play-LMP checkpoint (the same weights in both formats) and one
expert-play validation set."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from scripts.evaluate import main as jax_evaluate
from tacorl_tpu import config as jax_config
from tacorl_tpu.data.expert_play import generate_expert_play as jax_generate_expert_play
from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.evaluation import agents as jax_agents
from tacorl_tpu.evaluation import manager as jax_manager
from tacorl_tpu.evaluation import rollout_generator as jax_generators
from tacorl_tpu.evaluation import rollout_manager as jax_rm
from tacorl_tpu.evaluation.video import VideoRecorder as JaxVideoRecorder
from tacorl_tpu_torch import config
from tacorl_tpu_torch import evaluate
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation import agents, manager, rollout_generator as generators
from tacorl_tpu_torch.evaluation import rollout_manager as rm
from tacorl_tpu_torch.evaluation.video import VideoRecorder
from tests.test_torch_tacorl import lmp_dirs  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"


# -- config composition -----------------------------------------------------------

PRESETS = [[], ["evaluation=lmp_easy"], ["evaluation=tacorl_lh_seq_easy"]]


@pytest.mark.parametrize("preset", PRESETS, ids=["alone", "lmp_easy", "tacorl_lh_seq_easy"])
def test_compose_matches_jax_on_evaluate_yaml(preset):
    overrides = preset + ["module_path=/runs/lmp", "data_dir=/data/validation", "env.image_hw=32"]
    got = config.compose(CONFIGS, "evaluate", overrides)
    assert got == jax_config.compose(CONFIGS, "evaluate", overrides)
    assert got["module_path"] == "/runs/lmp" and got["env"]["image_hw"] == 32
    # the port's device key is added, not a key of the shared file
    assert config.compose(CONFIGS, "evaluate", overrides + ["+device=cpu"]) == {**got, "device": "cpu"}


def test_compose_rejects_an_unknown_group_option():
    with pytest.raises(ValueError, match="has no option"):
        config.compose(CONFIGS, "evaluate", ["evaluation=no_such_preset"])


def test_instantiate_resolves_jax_targets_to_the_port():
    cfg = config.compose(CONFIGS, "evaluate", ["module_path=x", "data_dir=y"])
    env = config.instantiate(cfg["env"])
    assert type(env) is FakeCalvinEnv and env.image_hw == 64 and env.max_episode_steps == 180


def test_env_without_a_port_counterpart_is_named():
    """``env=calvin`` resolves to the port's adapter, which names the
    missing simulator package and the port's fake env (the simulator is
    not installed here)."""
    from tacorl_tpu_torch.envs.calvin import CalvinGoalConditionedEnv

    cfg = config.compose(CONFIGS, "evaluate", ["module_path=x", "data_dir=y", "env=calvin"])
    assert config.get_class(cfg["env"]["_target_"]) is CalvinGoalConditionedEnv
    with pytest.raises(ImportError, match="calvin_env is required") as err:
        config.instantiate(cfg["env"])
    assert "tacorl_tpu_torch.envs.fake_calvin.FakeCalvinEnv" in str(err.value)


# -- the protocols, driven by the scripted expert ------------------------------------


@pytest.fixture(scope="module")
def expert_data(tmp_path_factory):
    """tests/test_evaluation.py's ceiling data, written by each package's
    generator."""
    root = tmp_path_factory.mktemp("expert")
    kwargs = dict(n_train_episodes=1, n_val_episodes=4, tasks_per_episode=3,
                  idle_steps=(3, 7), seed=11, distinct_tasks=True)
    generate_expert_play(root / "port", **kwargs)
    jax_generate_expert_play(root / "jax", **kwargs)
    return root


PROTOCOLS = {
    "all_tasks": ("SingleTaskRolloutGenerator", {}, "evaluate_all_tasks"),
    "lh": ("LongHorizonRolloutGenerator", {"tasks_per_rollout": 2}, "evaluate_lh_tasks"),
    "lh_seq": ("LongHorizonSequentialRolloutGenerator", {"tasks_per_rollout": 3}, "evaluate_lh_seq_tasks"),
}
GEN_ARGS = {
    "SingleTaskRolloutGenerator": "single_task_generator",
    "LongHorizonRolloutGenerator": "lh_generator",
    "LongHorizonSequentialRolloutGenerator": "lh_seq_generator",
}


def _run_protocol(pkg, data_dir, protocol, out):
    gen_mod, env_cls, agent_mod, rm_mod, mgr_mod = pkg
    gen_name, kw, method = PROTOCOLS[protocol]
    env = env_cls(image_hw=64, max_episode_steps=112, task_set="hard")
    gen = getattr(gen_mod, gen_name)(
        data_dir=data_dir, start_end_tasks=data_dir / "start_end_tasks.json",
        min_seq_len=1, max_seq_len=400, **kw,
    )
    evaluation = mgr_mod.EvaluationManager(
        agent=agent_mod.ScriptedExpertAgent(env, gain=1.0), env=env,
        rollout_manager=rm_mod.RLRollout(), **{GEN_ARGS[gen_name]: gen},
    )
    getattr(evaluation, method)(filename=str(out))
    return out.read_text()


PORT = (generators, FakeCalvinEnv, agents, rm, manager)
JAX = (jax_generators, JaxFakeCalvinEnv, jax_agents, jax_rm, jax_manager)


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_protocols_write_the_jax_results(expert_data, tmp_path, protocol):
    got = _run_protocol(PORT, expert_data / "port" / "validation", protocol, tmp_path / "port.json")
    want = _run_protocol(JAX, expert_data / "jax" / "validation", protocol, tmp_path / "jax.json")
    assert got == want
    results = json.loads(got)
    assert results
    if protocol == "lh_seq":
        # the protocol ceiling: the expert completes every depth
        assert results["num_rollouts"] > 0
        for depth in (1, 2, 3):
            assert results[f"lh_{depth}_accuracy"] == 1.0, results
        assert results["avg_len"] == 3.0


def test_rollout_video_matches_jax(tmp_path):
    frames = {}
    for name, env_cls, rm_mod, agent_mod, recorder_cls in (
        ("port", FakeCalvinEnv, rm, agents, VideoRecorder),
        ("jax", JaxFakeCalvinEnv, jax_rm, jax_agents, JaxVideoRecorder),
    ):
        env = env_cls(max_episode_steps=30)
        recorder = recorder_cls()
        out = rm_mod.RLRollout().episode_rollout(
            agent_mod.ScriptedExpertAgent(env), env, {"task_info": {"task": "open_drawer", "index": 0}},
            recorder=recorder, video_path=tmp_path / f"{name}.gif", task="open_drawer",
        )
        assert out["success"] and (tmp_path / f"{name}.gif").is_file()
        frames[name] = recorder.stacked()
    np.testing.assert_array_equal(frames["port"], frames["jax"])


# -- the entry point ------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("evaldata")
    generate_expert_play(root, n_train_episodes=1, n_val_episodes=3, tasks_per_episode=3,
                         idle_steps=(3, 7), seed=11, distinct_tasks=True)
    return root / "validation"


def _common(eval_type, data_dir, out):
    return [
        f"data_dir={data_dir}", f"eval_type={eval_type}", f"filename={out}",
        "min_seq_len=1", "max_seq_len=400", "max_rollouts=2", "plan_duration=3",
        "env.max_episode_steps=6", "lh_tasks_per_rollout=2", "lh_seq_tasks_per_rollout=2",
    ]


def _shape(results, eval_type):
    """The result JSON's keys and rollout counts."""
    if eval_type == "short_horizon":
        return {task: (sorted(row), row["num_rollouts"]) for task, row in results.items()}
    info = results["tasks_info"]
    if eval_type == "long_horizon":
        counts = {chain: len(rollouts) for chain, rollouts in info.items()}
    else:  # rollouts per task, whether they succeeded or failed
        counts = {t: info["success"].get(t, 0) + info["failed"].get(t, 0)
                  for t in set(info["success"]) | set(info["failed"])}
    return sorted(results), results["num_rollouts"], counts


@pytest.mark.parametrize("eval_type", ["short_horizon", "long_horizon", "long_horizon_sequential"])
def test_entry_point_writes_what_scripts_evaluate_writes(lmp_dirs, eval_data, tmp_path, eval_type):  # noqa: F811
    jax_dir, port_dir = lmp_dirs
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    port_args = ["+device=cpu", f"module_path={port_dir}"] + _common(eval_type, eval_data, port_out)
    if eval_type == "short_horizon":
        # the command a user runs
        proc = subprocess.run(
            [sys.executable, "-m", "tacorl_tpu_torch.evaluate"] + port_args,
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert f"wrote {port_out}" in proc.stdout
    else:
        evaluate.main(port_args)
    jax_evaluate([f"module_path={jax_dir}"] + _common(eval_type, eval_data, jax_out))
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert _shape(got, eval_type) == _shape(want, eval_type)
    if eval_type == "short_horizon":
        assert got and all(row["num_rollouts"] > 0 for row in got.values())
    else:
        assert got["num_rollouts"] > 0


def test_entry_point_refuses_best_epoch(lmp_dirs, eval_data, tmp_path):  # noqa: F811
    """``epoch=best``, refused until the checkpoint manager had best_step,
    now scores the best kept step: here the only one, as the latest."""
    args = ["+device=cpu", f"module_path={lmp_dirs[1]}"]
    best = evaluate.main(args + ["epoch=best"] + _common("short_horizon", eval_data, tmp_path / "best.json"))
    latest = evaluate.main(args + _common("short_horizon", eval_data, tmp_path / "latest.json"))
    assert best and best == latest


def test_entry_point_names_a_missing_env(lmp_dirs, eval_data, tmp_path):  # noqa: F811
    """``env=calvin`` reaches the port's adapter, which raises for the
    simulator package that is not installed."""
    args = ["+device=cpu", f"module_path={lmp_dirs[1]}", "env=calvin"]
    with pytest.raises(ImportError, match="calvin_env is required"):
        evaluate.main(args + _common("short_horizon", eval_data, tmp_path / "x.json"))
    assert not (tmp_path / "x.json").exists()
