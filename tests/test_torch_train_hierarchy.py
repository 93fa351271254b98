"""The visual TACO-RL hierarchy through ``python -m tacorl_tpu_torch.train``
on the CPU at tiny widths: ``play_lmp_fake``, then ``tacorl_fake`` grafted
from its latest step, on a small expert-play set with depth-2 chains
(2 batches an epoch). Stage 2 fires ``rollout`` and ``rollout_lh`` after
every epoch and trains one BC epoch (``bc_epochs: 1``), so its second
epoch is the CQL phase.

Checked: stage 2 at ``trainer.steps_per_call=2`` equals K = 1 bit for bit
across the rollouts (every row the K = 2 run logs, the kept checkpoints
and the final weights); and ``scripts/train.py`` on the same set with the
same recipe, stage 2 at the same K, logs the same metric keys at the same
steps (the rollout and ``rollout_lh`` rows included) and keeps the same
checkpoint steps."""

import pytest
import torch

from scripts.train import main as jax_main
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tests.test_torch_train_cli import _rows
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

EPOCHS = {"lmp": 1, "rl": 2}
BATCHES = 2  # an epoch of the set below at batch 16
LMP = [
    "experiment=play_lmp_fake", "datamodule.batch_size=16", "trainer.log_every_n_steps=1",
    f"trainer.max_epochs={EPOCHS['lmp']}",
    "module.plan_recognition.hidden_size=16", "module.action_decoder.hidden_size=16",
    "module.perceptual_encoder.networks.rgb_static.hidden_dim=16",
    "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=4",
]
RL = [
    "experiment=tacorl_fake", "datamodule.batch_size=16", "trainer.log_every_n_steps=1",
    f"trainer.max_epochs={EPOCHS['rl']}", "module.q_network.hidden_dim=16", "module.bc_epochs=1",
    "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=4",
    "callbacks.rollout_lh.every_n_epochs=1", "callbacks.rollout_lh.num_rollouts=2",
    "callbacks.rollout_lh.env.max_episode_steps=6",
]


class BCPhase(Callback):
    """``bc_phase`` at each epoch start."""

    def __init__(self):
        self.phases = []

    def on_epoch_start(self, trainer, module, epoch):
        self.phases.append(module.step_scalars()["bc_phase"])


@pytest.fixture(scope="module")
def play(tmp_path_factory):
    """Expert play with distinct depth-2 chains, which rollout_lh needs."""
    root = tmp_path_factory.mktemp("play")
    generate_expert_play(root, n_train_episodes=2, n_val_episodes=2, tasks_per_episode=2, seed=0,
                         distinct_tasks=True)
    return root


@pytest.fixture(scope="module")
def port(play, tmp_path_factory):
    """The port's stage 1, then stage 2 grafted from it at K = 1 and K = 2."""
    root = tmp_path_factory.mktemp("port")
    runs = {"lmp": train.main(["+device=cpu", *LMP, f"data_dir={play}", f"run_dir={root / 'lmp'}"])}
    for k in (1, 2):
        phases = BCPhase()
        runs[k] = train.main(["+device=cpu", *RL, f"data_dir={play}", f"play_lmp_dir={root / 'lmp'}",
                              f"run_dir={root / f'rl_k{k}'}", f"trainer.steps_per_call={k}"], callbacks=[phases])
        runs[f"phases_{k}"] = phases.phases
    return root, runs


@pytest.fixture(scope="module")
def jax_lmp(play, tmp_path_factory):
    run = tmp_path_factory.mktemp("jax") / "lmp"
    jax_main([*LMP, f"data_dir={play}", f"run_dir={run}"])
    return run


@pytest.fixture(scope="module")
def jax_rl(play, jax_lmp):
    run = jax_lmp.parent / "rl"
    jax_main([*RL, f"data_dir={play}", f"play_lmp_dir={jax_lmp}", f"run_dir={run}", "trainer.steps_per_call=2"])
    return run


def _keys_by_step(run_dir):
    """step -> the metric keys its rows logged."""
    keys = {}
    for row in _rows(run_dir):
        keys.setdefault(row["step"], set()).update(k for k in row if k not in ("step", "time"))
    return keys


def test_stage_two_fires_both_rollouts_and_trains_the_cql_phase(port):
    root, runs = port
    trainer = runs[1]
    assert trainer.global_step == trainer.state.step == EPOCHS["rl"] * BATCHES
    names = [type(cb).__name__ for cb in trainer.callbacks]
    assert names == ["IncreaseHorizonLinear", "RolloutCallback", "RolloutLongHorizonCallback", "BCPhase"]
    assert runs["phases_1"] == runs["phases_2"] == [1.0, 0.0]  # the BC epoch, then CQL
    rows = _rows(root / "rl_k1")
    assert [r["step"] for r in rows if "val_accuracy" in r] == [BATCHES, 2 * BATCHES]
    assert [r["step"] for r in rows if "LH_2_accuracy" in r] == [BATCHES, 2 * BATCHES]
    grafted = trainer.state.net.plan_recognition.state_dict()
    latest = CheckpointManager(root / "lmp").restore(-1)["net"]
    assert all(torch.equal(v, latest[f"plan_recognition.{k}"]) for k, v in grafted.items())


def test_k2_equals_k1_bit_for_bit_across_the_rollouts(port):
    root, runs = port
    strip = lambda r: {k: v for k, v in r.items() if k != "time"}  # noqa: E731
    k1 = {}
    for r in _rows(root / "rl_k1"):
        k1.setdefault(r["step"], []).append(strip(r))
    k2 = [strip(r) for r in _rows(root / "rl_k2")]
    assert [r["step"] for r in k2 if "train/q1_loss" in r] == [2, 4]
    assert sum("LH_1_accuracy" in r for r in k2) == EPOCHS["rl"]
    for r in k2:
        assert r in k1[r["step"]], r
    assert CheckpointManager(root / "rl_k1").all_steps() == CheckpointManager(root / "rl_k2").all_steps()
    a, b = runs[1].state.net.state_dict(), runs[2].state.net.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_stage_one_logs_and_keeps_what_the_jax_trainer_does(port, jax_lmp):
    root, _ = port
    got = _keys_by_step(root / "lmp")
    assert got == _keys_by_step(jax_lmp)
    assert sorted(s for s, keys in got.items() if "val_accuracy" in keys) == [BATCHES]
    assert CheckpointManager(root / "lmp").all_steps() == JaxCheckpointManager(jax_lmp).all_steps()


def test_stage_two_logs_and_keeps_what_the_jax_trainer_does(port, jax_rl):
    root, _ = port
    got = _keys_by_step(root / "rl_k2")
    assert got == _keys_by_step(jax_rl)
    rollouts = {"val_accuracy", "LH_1_accuracy", "LH_2_accuracy"}
    assert sorted(s for s, keys in got.items() if rollouts <= keys) == [BATCHES, 2 * BATCHES]
    assert CheckpointManager(root / "rl_k2").all_steps() == JaxCheckpointManager(jax_rl).all_steps()
