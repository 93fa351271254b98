"""The port's K-step trainer against the JAX package's on the CPU, for the
vector experiments and the online ones, through ``train.main`` and
``scripts/train.py`` (test_torch_trainer_k_step.py has the harness):

  * ``experiment=cql_fake_state`` at ``trainer.steps_per_call=64``: both
    trainers clamp K to the epoch's batch count; 2 epochs with the linear
    horizon and the rollout monitor, the JAX step's draws at every step:
    the same logged steps and metrics (rtol 1e-5) and kept checkpoints;
  * ``experiment=ril_fake_state`` at ``trainer.steps_per_call=4`` (no
    draws: vector transforms draw nothing): the same;
  * ``experiment=sac_online_fake`` at ``trainer.steps_per_call=4`` trains
    one step at a time, in both packages (SAC steps the env inside its
    train step): the port's run equals its K = 1 run, and logs the JAX
    run's steps.
"""

import jax
import numpy as np
import pytest

from scripts.train import main as jax_main
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu_torch import train
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax, ril_state_dict_from_jax
from tests.test_torch_cql import cql_draws, np_tree
from tests.test_torch_train_cli import RIL_TINY, VECTOR_ENV, _rows
from tests.test_torch_trainer_k_step import SEED, assert_rows_match, run_pair

B, N_ACT = 8, 4  # configs/module/cql_fake.yaml's n_action_samples


@pytest.fixture(scope="module")
def play(tmp_path_factory):
    root = tmp_path_factory.mktemp("play")
    generate_expert_play(root, n_train_episodes=2, n_val_episodes=2, tasks_per_episode=2, seed=3)
    return root


FLAT = ["trainer.max_epochs=2", "trainer.max_steps=1000", "datamodule.batch_size=8",
        "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=6", *VECTOR_ENV]


def cql_source(split, index):
    key = jax.random.fold_in(jax.random.key(SEED if split == "train" else SEED + 1), index)
    return {"draws": cql_draws(key, B, N_ACT, 7, discrete_gripper=True)}


@pytest.fixture(scope="module")
def cql_pair(play, tmp_path_factory):
    root = tmp_path_factory.mktemp("cql_k")
    overrides = [
        "experiment=cql_fake_state", f"data_dir={play}", *FLAT, "trainer.steps_per_call=64",
        "trainer.log_every_n_steps=1", "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16",
        "module.goal_encoder.hidden_size=16", "module.bc_epochs=1",
    ]
    convert = lambda s: cql_state_dict_from_jax(np_tree(s.params), np_tree(s.aux), ())  # noqa: E731
    jax_dir, trainer, _, _ = run_pair(root, overrides, convert, cql_source)
    return jax_dir, trainer


def test_both_trainers_clamp_k_to_the_epoch(cql_pair):
    jax_dir, trainer = cql_pair
    epoch = len(trainer.datamodule.train_loader())
    assert 1 < epoch < 64 and trainer.steps_per_call == epoch
    want = _rows(jax_dir)
    # one chunk an epoch, each the whole epoch
    assert [r["step"] for r in want if "train/q1_loss" in r] == [epoch, 2 * epoch]
    assert trainer.global_step == 2 * epoch


def test_k_step_cql_logs_and_keeps_what_the_jax_trainer_does(cql_pair):
    jax_dir, trainer = cql_pair
    want = _rows(jax_dir)
    assert_rows_match(_rows(trainer.ckpt.dir), want)
    assert sum("val_accuracy" in r for r in want) == 2
    assert [r["train/goal_horizon"] for r in want if "train/goal_horizon" in r] == [16.0, 24.0]
    assert trainer.ckpt.all_steps() == JaxCheckpointManager(jax_dir).all_steps()


@pytest.fixture(scope="module")
def ril_pair(play, tmp_path_factory):
    root = tmp_path_factory.mktemp("ril_k")
    overrides = ["experiment=ril_fake_state", f"data_dir={play}", *FLAT, *RIL_TINY,
                 "trainer.steps_per_call=4", "trainer.log_every_n_steps=4"]
    convert = lambda s: ril_state_dict_from_jax(np_tree(s.params), ())  # noqa: E731
    jax_dir, trainer, jax_lines, port_lines = run_pair(root, overrides, convert, lambda split, i: {})
    return jax_dir, trainer, jax_lines, port_lines


def test_k_step_ril_logs_and_keeps_what_the_jax_trainer_does(ril_pair):
    jax_dir, trainer, jax_lines, port_lines = ril_pair
    want = _rows(jax_dir)
    assert_rows_match(_rows(trainer.ckpt.dir), want)
    epoch = len(trainer.datamodule.train_loader())
    steps = (epoch // 4) * 4  # a trailing partial chunk is dropped each epoch
    assert trainer.global_step == 2 * steps
    drops = [line for line in jax_lines if line.startswith("scanned dispatch dropped")]
    assert drops == [line for line in port_lines if line.startswith("scanned dispatch dropped")]
    assert len(drops) == (2 if epoch % 4 else 0)
    assert trainer.ckpt.all_steps() == JaxCheckpointManager(jax_dir).all_steps()


ONLINE = ["experiment=sac_online_fake", "module.goal_encoder.hidden_size=16", "module.policy.hidden_dim=16",
          "module.q_network.hidden_dim=16", "module.warm_start_steps=16", "datamodule.batch_size=8",
          "datamodule.steps_per_epoch=3", "trainer.log_every_n_steps=1", "callbacks.rollout.num_rollouts=2",
          "env.max_episode_steps=8", "trainer.max_steps=6"]


def test_online_runs_train_single_steps_at_k4(tmp_path):
    at_k4 = train.main(["+device=cpu", *ONLINE, f"run_dir={tmp_path / 'k4'}", "trainer.steps_per_call=4"])
    at_k1 = train.main(["+device=cpu", *ONLINE, f"run_dir={tmp_path / 'k1'}"])
    assert at_k4.steps_per_call == 4 and at_k4.global_step == 6
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"} for r in rows]  # noqa: E731
    assert strip(_rows(tmp_path / "k4")) == strip(_rows(tmp_path / "k1"))
    assert [r["step"] for r in _rows(tmp_path / "k4") if "train/actor_loss" in r] == [1, 2, 3, 4, 5, 6]
    sa, sb = at_k4.state.net.state_dict(), at_k1.state.net.state_dict()
    assert all(np.array_equal(sa[k].numpy(), sb[k].numpy()) for k in sa)
    jax_main([*ONLINE, f"run_dir={tmp_path / 'jax'}", "trainer.steps_per_call=4", "platform=cpu"])
    assert [r["step"] for r in _rows(tmp_path / "jax")] == [r["step"] for r in _rows(tmp_path / "k4")]
