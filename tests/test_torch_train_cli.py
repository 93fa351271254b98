"""``python -m tacorl_tpu_torch.train`` on the CPU: the port composes
configs/train.yaml as the JAX package does, chains stage 1 into stage 2 on
synthetic data at tiny widths, trains play_lmp_fake (the biRNN posterior,
held against the JAX one) with the rollout callback feeding the checkpoint
monitor, and never reads a config's ``platform:`` as a request for the
CPU."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu import config as jax_config
from tacorl_tpu.networks import plan_recognition as jax_pr
from tacorl_tpu_torch import config, evaluate, train
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.data.storage import pack_frames
from tacorl_tpu_torch.data.synthetic import generate_synthetic_calvin
from tacorl_tpu_torch.networks import plan_recognition as pr
from tacorl_tpu_torch.utils.convert import plan_recognition_state_dict
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "configs"


@pytest.mark.parametrize(
    "experiment",
    ["play_lmp_for_rl", "tacorl", "play_lmp_fake", "cql_fake", "cql_fake_state", "tacorl_fake",
     "play_lmp_d4rl", "tacorl_d4rl", "cql_d4rl", "play_lmp_d4rl_fake", "tacorl_d4rl_fake",
     "ril", "ril_fake", "ril_fake_state", "sac_online", "sac_online_fake", "cql_online",
     "cql_online_fake"],
)
def test_compose_matches_jax_on_train_yaml(experiment):
    overrides = [f"experiment={experiment}", "data_dir=/data", "play_lmp_dir=/runs/lmp",
                 "trainer.max_steps=7", "callbacks/kl_schedule=linear"]
    got = config.compose(CONFIGS, "train", overrides)
    assert got == jax_config.compose(CONFIGS, "train", overrides)
    assert got["trainer"]["max_steps"] == 7
    assert config.compose(CONFIGS, "train", overrides + ["+device=cpu"]) == {**got, "device": "cpu"}


@pytest.mark.parametrize("cls", ["PlanRecognitionBiRNN", "PlanRecognitionTanhBiRNN"])
def test_birnn_posterior_matches_jax(cls):
    x = np.random.RandomState(0).randn(3, 6, 10).astype(np.float32)
    jnet = getattr(jax_pr, cls)(state_dim=10, latent_plan_dim=4, hidden_size=12, num_layers=2)
    variables = jnet.init(jax.random.key(0), jnp.asarray(x))
    want = jnet.apply(variables, jnp.asarray(x))
    net = getattr(pr, cls)(10, 4, hidden_size=12, num_layers=2)
    net.load_state_dict(plan_recognition_state_dict(jax.tree.map(np.asarray, variables["params"])))
    got = net(torch.from_numpy(x))
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_allclose(got.mean.detach().numpy(), np.asarray(want.mean), atol=1e-5)
    np.testing.assert_allclose(got.std.detach().numpy(), np.asarray(want.std), atol=1e-5)
    assert not any(p.requires_grad for n, p in net.named_parameters() if n.startswith("birnn_model.bias_hh"))


TINY = [
    "+device=cpu",
    "module.perceptual_encoder.networks.rgb_static.latent_dim=16",
    "module.perceptual_encoder.networks.rgb_static.hidden_dim=32",
    "module.goal_encoder.hidden_size=32",
    "module.plan_recognition.num_heads=4", "module.plan_recognition.num_layers=1",
    "module.plan_recognition.encoder_hidden_size=32", "module.plan_recognition.fc_hidden_size=32",
    "module.plan_proposal.policy.hidden_dim=32",
    "module.action_decoder.hidden_size=32", "module.action_decoder.num_layers=1",
    "module.action_decoder.n_mixtures=4",
    "transforms.rgb_static.size=[48,48]", "transforms.rgb_static.pad=2",
    "datamodule.batch_size=8", "datamodule.val_percentage=1.0",
    "datamodule.dataset.min_window_size=4", "datamodule.dataset.max_window_size=8",
    "trainer.log_every_n_steps=1",
]


@pytest.fixture(scope="module")
def calvin(tmp_path_factory):
    root = tmp_path_factory.mktemp("calvin")
    generate_synthetic_calvin(root / "frames", 2, 1, 24, 56,
                              keys=("rgb_static", "robot_obs", "scene_obs", "rel_actions_world"))
    for split in ("training", "validation"):
        pack_frames(root / "frames" / split, root / "packed" / split)
    return root / "packed"


def _rows(run):
    return [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]


def test_stage_one_chains_into_stage_two(calvin, tmp_path):
    lmp, rl = tmp_path / "lmp", tmp_path / "tacorl"
    t1 = train.main(TINY + ["experiment=play_lmp_for_rl", f"data_dir={calvin}", f"run_dir={lmp}",
                            "trainer.max_steps=5", "ckpt_max_to_keep=2"])
    assert t1.device == torch.device("cpu") and t1.global_step == 5
    assert CheckpointManager(lmp).all_steps() == [4, 5]  # an epoch is 4 steps; the stop saves too
    saved = json.loads((lmp / "config.json").read_text())
    assert saved["module"]["action_decoder"]["act_max_bound"] == [1.0] * 7  # statistics.yaml
    rows = _rows(lmp)
    assert [r["step"] for r in rows if "train/total_loss" in r] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["train/total_loss"]) for r in rows if "train/total_loss" in r)
    assert sum("validation/total_loss" in r for r in rows) == 2

    t2 = train.main(TINY + ["experiment=tacorl", f"data_dir={calvin}", f"run_dir={rl}",
                            f"play_lmp_dir={lmp}", "trainer.max_steps=2",
                            "module.q_network.hidden_dim=16", "+datamodule.dataset.num_nn=8"])
    assert t2.global_step == 2 and type(t2.callbacks[0]).__name__ == "IncreaseHorizonLinear"
    keys = set().union(*_rows(rl))
    assert {"train/q1_loss", "train/action_loss", "validation/q1_loss"} <= keys
    # the datamodule drew goals from both strategies
    assert set(t2.datamodule.train_dataset.goal_strategy_prob) == {"geometric", "similar_robot_obs"}


def test_play_lmp_fake_trains_with_the_rollout_monitor(tmp_path):
    data = tmp_path / "play"
    generate_expert_play(data, n_train_episodes=2, n_val_episodes=2, seed=3)
    run = tmp_path / "run"
    trainer = train.main([
        "+device=cpu", "experiment=play_lmp_fake", f"data_dir={data}", f"run_dir={run}",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "datamodule.batch_size=8",
        "module.plan_recognition.hidden_size=16", "module.action_decoder.hidden_size=16",
        "module.perceptual_encoder.networks.rgb_static.hidden_dim=16",
        "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=4",
    ])
    assert type(trainer.callbacks[-1]).__name__ == "RolloutCallback"
    accs = [r["val_accuracy"] for r in _rows(run) if "val_accuracy" in r]
    assert len(accs) == 2
    manager = CheckpointManager(run, monitor="val_accuracy", mode="max")
    assert manager.best_step() in manager.all_steps()
    results = evaluate.main([
        "+device=cpu", f"module_path={run}", "epoch=best", f"data_dir={data / 'validation'}",
        "min_seq_len=1", "max_seq_len=400", "max_rollouts=1", "plan_duration=2",
        "env.max_episode_steps=4", f"filename={tmp_path / 'best.json'}",
    ])
    assert results and all(0.0 <= r["accuracy"] <= 1.0 for r in results.values())


VECTOR_ENV = ["env.modalities=[robot_obs,scene_obs]", "env.goal_modalities=[robot_obs,scene_obs]"]


def test_cql_fake_state_trains_and_scores(tmp_path):
    """Flat CQL on robot_obs/scene_obs vectors: 2 epochs with the linear
    horizon and the rollout monitor, then ``evaluate epoch=best`` with the
    vector env overrides."""
    data = tmp_path / "play"
    generate_expert_play(data, n_train_episodes=2, n_val_episodes=2, tasks_per_episode=2, seed=3)
    run = tmp_path / "run"
    trainer = train.main([
        "+device=cpu", "experiment=cql_fake_state", f"data_dir={data}", f"run_dir={run}",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "datamodule.batch_size=8",
        "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16",
        "module.goal_encoder.hidden_size=16", "module.bc_epochs=1",
        "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=6",
    ])
    assert [type(cb).__name__ for cb in trainer.callbacks] == ["IncreaseHorizonLinear", "RolloutCallback"]
    assert trainer.state.net.q1.encoder.networks.keys() == set()  # vectors pass through
    rows = _rows(run)
    assert [r["train/goal_horizon"] for r in rows if "train/goal_horizon" in r] == [16.0, 24.0]
    assert all(np.isfinite(r["train/q1_loss"]) for r in rows if "train/q1_loss" in r)
    assert len([r for r in rows if "val_accuracy" in r]) == 2
    results = evaluate.main([
        "+device=cpu", f"module_path={run}", "epoch=best", f"data_dir={data / 'validation'}",
        "eval_type=short_horizon", "env.image_hw=64", "env.max_episode_steps=6",
        "env.task_set=hard", *VECTOR_ENV, "min_seq_len=1", "max_seq_len=64", "max_rollouts=2",
        f"filename={tmp_path / 'best.json'}",
    ])
    assert results and all(0.0 <= r["accuracy"] <= 1.0 for r in results.values())


RIL_TINY = ["module.high_level_policy.hidden_dim=16", "module.low_level_policy.hidden_dim=16",
            "module.goal_encoder.hidden_size=16"]


def test_ril_fake_state_trains_and_scores(tmp_path):
    """Relay IL on robot_obs/scene_obs vectors: 2 epochs with the rollout
    monitor driving the RIL agent, then ``evaluate epoch=best`` and
    ``evaluate_ril_oracle`` with both high levels."""
    from tacorl_tpu_torch import evaluate_ril_oracle

    data = tmp_path / "play"
    generate_expert_play(data, n_train_episodes=2, n_val_episodes=2, tasks_per_episode=2, seed=3)
    run = tmp_path / "run"
    trainer = train.main([
        "+device=cpu", "experiment=ril_fake_state", f"data_dir={data}", f"run_dir={run}",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "datamodule.batch_size=8",
        *RIL_TINY, "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=6",
    ])
    assert [type(cb).__name__ for cb in trainer.callbacks] == ["RolloutCallback"]
    net = trainer.state.net
    assert type(net).__name__ == "RILNet" and net.perceptual_encoder.networks.keys() == set()
    assert net.low_level_policy.discrete_gripper and net.goal_encoder.mlp[-1].out_features == 64
    rows = _rows(run)
    losses = [r["train/total_loss"] for r in rows if "train/total_loss" in r]
    assert len(losses) == trainer.global_step > 2 and np.all(np.isfinite(losses))
    assert sum("validation/high_level_loss" in r for r in rows) == 2
    assert len([r for r in rows if "val_accuracy" in r]) == 2
    common = [f"data_dir={data / 'validation'}", "env.max_episode_steps=6", "env.task_set=hard",
              *VECTOR_ENV, "min_seq_len=1", "max_seq_len=64", "max_rollouts=2", "plan_duration=3"]
    results = evaluate.main(["+device=cpu", f"module_path={run}", "epoch=best",
                             f"filename={tmp_path / 'best.json'}", *common])
    assert results and all(0.0 <= r["accuracy"] <= 1.0 for r in results.values())
    for learned in ("false", "true"):
        scored = evaluate_ril_oracle.main(["+device=cpu", f"module_path={run}", "lookahead=4",
                                           f"learned_hl={learned}", f"filename={tmp_path / learned}.json",
                                           *common])
        assert scored.keys() == results.keys()


@pytest.mark.parametrize("experiment", ["ril", "ril_fake"])
def test_visual_ril_trains(calvin, tmp_path, experiment):
    """The visual RIL experiments at tiny widths on synthetic frames:
    ``ril`` with its offline-RL callbacks (the linear horizon is a no-op on
    a RILDataset), ``ril_fake`` with the fake transforms."""
    run = tmp_path / "run"
    trainer = train.main([
        "+device=cpu", f"experiment={experiment}", f"data_dir={calvin}", f"run_dir={run}",
        "trainer.max_steps=3", "trainer.log_every_n_steps=1", "datamodule.batch_size=8",
        "datamodule.val_percentage=1.0", *RIL_TINY,
        "module.perceptual_encoder.networks.rgb_static.latent_dim=16",
        "module.perceptual_encoder.networks.rgb_static.hidden_dim=32",
        "transforms.rgb_static.size=[48,48]", "datamodule.dataset.max_low_level_window=4",
        "datamodule.dataset.max_high_level_window=12",
        *(["~callbacks.rollout"] if experiment == "ril_fake" else []),
    ])
    names = [type(cb).__name__ for cb in trainer.callbacks]
    assert names == (["IncreaseHorizonLinear"] if experiment == "ril" else [])
    assert type(trainer.datamodule.train_dataset).__name__ == "RILDataset"
    rows = _rows(run)
    assert [r["step"] for r in rows if "train/total_loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["train/low_level_loss"]) for r in rows if "train/low_level_loss" in r)
    assert "train/goal_horizon" not in set().union(*rows)


def test_state_based_cql_trains_on_saved_transitions(tmp_path):
    """``state_based: true`` (experiment=cql_d4rl's module) on flat
    transitions that the port's SavedTransitionDataset reads."""
    rs = np.random.RandomState(0)
    for split, n in (("training", 24), ("validation", 8)):
        (tmp_path / "data" / split).mkdir(parents=True)
        for i in range(n):
            np.savez(tmp_path / "data" / split / f"transition_{i:09d}.npz",
                     state=rs.randn(31).astype(np.float32), action=rs.uniform(-1, 1, 8).astype(np.float32),
                     next_state=rs.randn(31).astype(np.float32), reward=float(i % 5 == 0), done=i % 7 == 0)
    run = tmp_path / "run"
    trainer = train.main([
        "+device=cpu", "experiment=cql_d4rl", f"run_dir={run}", "~datamodule._target_",
        f"+datamodule.data_dir={tmp_path / 'data'}", "+datamodule.val_percentage=1.0",
        "datamodule.batch_size=8", "+datamodule.dataset.val_percentage=0.0",
        "datamodule.dataset._target_=tacorl_tpu.data.saved_transitions.SavedTransitionDataset",
        "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1",
    ])
    assert trainer.global_step == 6
    assert not any("encoder" in k for k in trainer.state.net.state_dict())
    rows = _rows(run)
    assert all(np.isfinite(r["train/q1_loss"]) for r in rows if "train/q1_loss" in r)
    assert sum("validation/q1_loss" in r for r in rows) == 2


# the D4RL fake experiments at tiny widths, on a small expert .npz
D4RL_TINY = [
    "+device=cpu", "datamodule.batch_size=16", "trainer.log_every_n_steps=1",
    "callbacks.rollout.num_rollouts=2", "callbacks.rollout.env.max_episode_steps=6",
]


@pytest.fixture(scope="module")
def d4rl_npz(tmp_path_factory):
    from tacorl_tpu_torch.data.d4rl_dataset import generate_expert_d4rl

    return generate_expert_d4rl(tmp_path_factory.mktemp("d4rl") / "expert.npz", n_episodes=4,
                                legs_per_episode=2, seed=0)


def test_d4rl_stage_one_chains_into_stage_two(d4rl_npz, tmp_path):
    """play_lmp_d4rl_fake -> tacorl_d4rl_fake through train.main: the
    rollout callback logs val_accuracy and val_score each epoch (the
    datamodule has no val split), the monitored checkpoint keeps a best
    step, stage 2 grafts stage 1's latest step and trains the BC warm-start
    then CQL (bc_epochs: 1), and evaluate_d4rl scores both runs."""
    from tacorl_tpu_torch import evaluate_d4rl

    lmp, rl = tmp_path / "lmp", tmp_path / "rl"
    t1 = train.main(D4RL_TINY + [
        "experiment=play_lmp_d4rl_fake", f"dataset_path={d4rl_npz}", f"run_dir={lmp}",
        "trainer.max_epochs=3", "module.plan_recognition.encoder_hidden_size=16",
        "module.plan_recognition.fc_hidden_size=16", "module.action_decoder.hidden_size=16",
    ])
    assert t1.device == torch.device("cpu") and t1.datamodule.val_loader() is None
    assert [type(cb).__name__ for cb in t1.callbacks] == ["KLLinearSchedule", "RolloutD4RLCallback"]
    rows = _rows(lmp)
    evals = [r for r in rows if "val_accuracy" in r]
    assert len(evals) == 3 and all({"val_accuracy", "val_score"} <= set(r) for r in evals)
    assert not any(k.startswith("validation/") for r in rows for k in r)
    assert all(np.isfinite(r["train/random_plan_action_loss"]) for r in rows if "train/total_loss" in r)
    manager = CheckpointManager(lmp, monitor="val_accuracy", mode="max")
    assert manager.best_step() in manager.all_steps()
    assert json.loads((lmp / "ckpts" / "metrics.json").read_text())  # monitored values were saved

    t2 = train.main(D4RL_TINY + [
        "experiment=tacorl_d4rl_fake", f"dataset_path={d4rl_npz}", f"play_lmp_dir={lmp}",
        f"run_dir={rl}", "trainer.max_epochs=2", "module.q_network.hidden_dim=16",
    ])
    grafted = t2.state.net.plan_recognition.state_dict()
    latest = CheckpointManager(lmp).restore(-1)["net"]
    assert all(torch.equal(v, latest[f"plan_recognition.{k}"]) for k, v in grafted.items())
    rows = _rows(rl)
    assert sum("val_accuracy" in r for r in rows) == 2
    actor_losses = [r["train/actor_loss"] for r in rows if "train/actor_loss" in r]
    assert actor_losses and all(np.isfinite(actor_losses))
    for run in (lmp, rl):
        summary = evaluate_d4rl.main(["+device=cpu", f"module_path={run}", "epoch=best", "num_rollouts=2",
                                      "env.max_episode_steps=6", f"filename={tmp_path / 'e.json'}"])
        assert summary["num_rollouts"] == 2 and 0.0 <= summary["accuracy"] <= 1.0


def test_cql_d4rl_trains_on_a_d4rl_npz(d4rl_npz, tmp_path):
    """experiment=cql_d4rl (the state_based module) on goal-relabelled
    transitions of an .npz through the D4RL datamodule, then the flat agent
    scored by evaluate_d4rl on the 8-wide fake env."""
    from tacorl_tpu_torch import evaluate_d4rl

    run = tmp_path / "run"
    trainer = train.main([
        "+device=cpu", "experiment=cql_d4rl", f"dataset_path={d4rl_npz}", f"run_dir={run}",
        "module.state_dim=8", "module.action_dim=4", "datamodule.batch_size=32",
        "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16",
        "trainer.max_epochs=2", "trainer.log_every_n_steps=1",
    ])
    assert type(trainer.datamodule.train_dataset).__name__ == "D4RLTransitionDataset"
    rows = _rows(run)
    q1 = [r["train/q1_loss"] for r in rows if "train/q1_loss" in r]
    assert len(q1) == trainer.global_step > 0 and all(np.isfinite(q1))
    summary = evaluate_d4rl.main(["+device=cpu", f"module_path={run}", "num_rollouts=2",
                                  "env.max_episode_steps=6", f"filename={tmp_path / 'e.json'}"])
    assert summary["num_rollouts"] == 2


def test_platform_key_does_not_pick_the_cpu(tmp_path):
    """play_lmp_fake sets ``platform: cpu`` (a JAX backend choice): the port
    still runs on the card, so without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    cfg = config.compose(CONFIGS, "train", ["experiment=play_lmp_fake"])
    assert cfg["platform"] == "cpu" and "device" not in cfg
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["experiment=play_lmp_fake", f"data_dir={tmp_path}", f"run_dir={tmp_path}"])


@pytest.mark.parametrize(
    "override, error, match",
    [
        # multihost = data-parallel training, which needs a launcher's environment
        ("+multihost=true", RuntimeError, "needs a launcher"),
    ],
)
def test_unported_options_raise(calvin, tmp_path, override, error, match):
    with pytest.raises(error, match=match):
        train.main(TINY + ["experiment=play_lmp_for_rl", f"data_dir={calvin}",
                           f"run_dir={tmp_path}", override])


def test_steps_per_call_composes_and_trains(calvin, tmp_path):
    """trainer.steps_per_call=4 reaches the trainer: an epoch of 4 batches is
    one chunk of 4 steps, logged at its last step."""
    trainer = train.main(TINY + ["experiment=play_lmp_for_rl", f"data_dir={calvin}",
                                 f"run_dir={tmp_path}", "trainer.steps_per_call=4", "trainer.max_steps=8"])
    assert trainer.steps_per_call == 4 and trainer.global_step == trainer.state.step == 8
    assert [r["step"] for r in _rows(tmp_path) if "train/total_loss" in r] == [4, 8]
    assert CheckpointManager(tmp_path).all_steps() == [4, 8]


def test_train_command_runs(calvin, tmp_path):
    """The command a user runs."""
    proc = subprocess.run(
        [sys.executable, "-m", "tacorl_tpu_torch.train", *TINY, "experiment=play_lmp_for_rl",
         f"data_dir={calvin}", f"run_dir={tmp_path}", "trainer.max_steps=1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert CheckpointManager(tmp_path).all_steps() == [1]


CQL_TINY = [
    "+device=cpu", "module.actor_encoder.networks.rgb_static.latent_dim=8",
    "module.actor_encoder.networks.rgb_static.hidden_dim=16",
    "module.critic_encoder.networks.rgb_static.latent_dim=8",
    "module.critic_encoder.networks.rgb_static.hidden_dim=16", "module.goal_encoder.hidden_size=16",
    "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16", "module.n_action_samples=2",
    "transforms.rgb_static.size=[48,48]", "transforms.rgb_static.pad=2", "datamodule.batch_size=4",
    "trainer.log_every_n_steps=1",
]
VARIANTS = {
    "gaussian_decoder": (TINY, "play_lmp_for_rl", ["networks/action_decoder=gaussian",
                                                   "module.action_decoder.hidden_size=16",
                                                   "+module.add_random_plan_loss=true"],
                         "action_decoder", "ActionDecoderGaussian"),
    "densenet_plan_proposal": (TINY, "play_lmp_for_rl", ["networks/policy=densenet"],
                               "plan_proposal.policy", "DenseNetPolicy"),
    "d2rl_policy_densenet_critic": (CQL_TINY, "cql", ["networks/policy=d2rl", "networks/q_network=densenet"],
                                    "q1.critic.Q", "DenseNetQNetwork"),
    "d2rl_critic": (CQL_TINY, "cql", ["networks/q_network=d2rl"], "q1.critic.Q", "D2RLQNetwork"),
}


def test_gaussian_decoder_on_a_dataset_with_action_bounds_fails_in_jax(calvin, tmp_path):
    """scripts/train.py hands a dataset's statistics.yaml action bounds to
    any action decoder; the Gaussian MDN head takes none (ROADMAP Queue 3;
    the port passes them only to a decoder that takes them)."""
    from scripts.train import main as jax_main

    with pytest.raises(TypeError, match="act_max_bound"):
        jax_main(["platform=cpu", "experiment=play_lmp_for_rl", "networks/action_decoder=gaussian",
                  f"data_dir={calvin}", f"run_dir={tmp_path}", "trainer.max_steps=1"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_network_variants_compose_and_train(calvin, tmp_path, variant):
    """A config group the JAX package ships (tests/test_config_tree.py)
    composes and trains 2 steps through the port's train.main."""
    tiny, experiment, overrides, path, cls = VARIANTS[variant]
    trainer = train.main(tiny + [f"experiment={experiment}", *overrides, f"data_dir={calvin}",
                                 f"run_dir={tmp_path}", "trainer.max_steps=2",
                                 "+datamodule.dataset.num_nn=8" if experiment == "cql" else "trainer.max_epochs=1"])
    assert trainer.global_step == 2
    net = trainer.state.net
    for part in path.split("."):
        net = getattr(net, part)
    assert type(net).__name__ == cls
    loss = "train/total_loss" if experiment != "cql" else "train/q1_loss"
    values = [r[loss] for r in _rows(tmp_path) if loss in r]
    assert len(values) == 2 and all(np.isfinite(values))
    if variant == "gaussian_decoder":
        assert "train/random_plan_action_loss" in _rows(tmp_path)[0]
