"""Stage 2's CQL phase held against the JAX trainer over many steps, on the
CPU: ``train.main`` against ``scripts/train.py`` on ``experiment=tacorl_fake``
(the TACO-RL module at the visual hierarchy's recipe: ``with_lagrange``,
``deterministic_backup``, ``reward_scale`` 10, ``discount`` 0.95, the
decoder finetuned) at tiny widths, each grafted from a stage-1 checkpoint
of the same weights in its own format, both resuming from one step-0
checkpoint, the port with the JAX step's draws at every global step.

One BC epoch (``module.bc_epochs=1``), then two CQL epochs: an epoch has 4
batches of 8 windows of 4-8 frames, so 8 of the 12 steps run at
``bc_phase`` 0, with Adam's moments, alpha and the Lagrange alpha' moving,
the Polyak targets drifting and the switch from BC to CQL between epochs.
``rollout`` fires after every epoch in both trainers; its rows are not
compared (the draws differ), but the training state a firing leaves must
be JAX's: every train row (each step logs) and validation row within rtol
1e-5, the parameters within atol 2.5 lr a step.

The BC-phase ``actor_loss`` is the difference of two log-densities,
alpha log pi(a|s) of the actor's own sample and log pi(plan|s) of the
posterior's plan, each about -5.5 here, that cancel to about 0.5: it is
held at rtol 1e-5 of the two terms' magnitudes (the plan term read from the
port's step), which is what float32 gives it (5.4e-6 of them at most in
this run, 1.9e-4 of the difference itself). The JAX steps run their Pallas
jitter tail in interpret mode."""

import contextlib
import shutil

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.config import compose as jax_compose
from tacorl_tpu.config import get_class as jax_get_class
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.data.datamodule import BasicDataModule as JaxDataModule
from scripts.train import main as jax_main
from tacorl_tpu_torch import train
from tacorl_tpu_torch.config import compose, get_class
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.data.storage import pack_frames
from tacorl_tpu_torch.networks.actor import Actor
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax, tacorl_state_dict_from_jax
from tests.test_torch_cql import aug_draws, cql_draws, leaf_key, np_tree
from tests.test_torch_train_cli import CONFIGS, _rows
from tests.test_torch_train_hierarchy import BCPhase
from tests.test_torch_trainer_k_step import (
    SEED,
    Draws,
    _t,
    interpret_pallas,
    step0_checkpoints,
)
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

B, MAX_WS, LATENT, N_ACT = 8, 8, 8, 4  # batch, window; tacorl_fake's latent_plan_dim, n_action_samples
EPOCHS, BATCHES, K = 3, 4, 1
STEPS = EPOCHS * BATCHES
LR = 3e-4  # configs/module/tacorl.yaml: the largest learning rate (critics, decoder)
TINY = [
    "+device=cpu",  # the JAX trainer ignores the key
    "datamodule.batch_size=8",
    "module.perceptual_encoder.networks.rgb_static.hidden_dim=16",
    "+module.perceptual_encoder.networks.rgb_static.compute_dtype=null",
    "module.goal_encoder.hidden_size=16", "module.plan_recognition.hidden_size=16",
    "module.plan_proposal.policy.hidden_dim=16", "module.action_decoder.hidden_size=16",
    "module.action_decoder.n_mixtures=2",
    # the fused route in both packages: the card's route, the Pallas tail in JAX
    "+transforms.rgb_static.use_pallas=true",
]
LMP = TINY + ["experiment=play_lmp_fake"]
RL = TINY + [
    "experiment=tacorl_fake", "module.q_network.hidden_dim=16", "module.bc_epochs=1", "~callbacks.rollout_lh",
    "datamodule.dataset.min_window_size=4", f"datamodule.dataset.max_window_size={MAX_WS}",
    "datamodule.train_percentage=0.7", "trainer.limit_val_batches=2",  # 4 train batches an epoch
    f"trainer.max_steps={STEPS}", f"trainer.steps_per_call={K}", f"trainer.log_every_n_steps={K}",
    "callbacks.rollout.num_rollouts_per_task=1", "env.max_episode_steps=4",
]
ROLLOUT_KEYS = ("val_", "LH_")
RTOL = 1e-5


def tacorl_draws(key, train: bool):
    """The draws of JAX's TACO-RL update from its key (a train step's key is
    folded with the step first); the fake transforms shift by 0."""
    k_aug, k_plan, k_cql = jax.random.split(key, 3)
    draws = cql_draws(k_cql, B, N_ACT, LATENT, discrete_gripper=False)
    if train:
        draws["aug_states"] = {"rgb_static": aug_draws(leaf_key(k_aug, "rgb_static"), B * MAX_WS, 0)}
        draws["aug_goal"] = {"rgb_static": aug_draws(leaf_key(jax.random.fold_in(k_aug, 1), "rgb_static"), B, 0)}
    draws["plan_eps"] = _t(jax.random.normal(k_plan, (B, LATENT)))
    return {"draws": draws}


def source(split, index):
    if split == "train":
        return tacorl_draws(jax.random.fold_in(jax.random.key(SEED), index), True)
    return tacorl_draws(jax.random.fold_in(jax.random.key(SEED + 1), index), False)


def play_set(root):
    """A small expert-play set with depth-2 chains, packed as
    make_flagship_data packs the recipe's set."""
    play = root / "play"
    generate_expert_play(root / "frames", n_train_episodes=2, n_val_episodes=2, tasks_per_episode=2, seed=0,
                         distinct_tasks=True)
    for split in ("training", "validation"):
        pack_frames(root / "frames" / split, play / split)
        for aux in (root / "frames" / split).glob("*.json"):
            shutil.copy(aux, play / split / aux.name)
    return play


def _lmp_checkpoints(root, play):
    """One stage-1 state in the JAX format and, converted, in the port's."""
    overrides = LMP + [f"data_dir={play}"]
    cfg = jax_compose(CONFIGS, "train", overrides)
    dm_cfg = dict(cfg["datamodule"])
    dm_cfg.pop("_target_", None)
    dm = JaxDataModule(**dm_cfg)
    dm.setup()
    jmod = jax_get_class(cfg["module"]["_target_"])(dict(cfg["module"]))
    with interpret_pallas():
        jstate = jax.jit(jmod.init_state)(jax.random.key(2), next(iter(dm.train_loader())))
    JaxCheckpointManager(root / "jax_lmp", config=cfg).save(0, jstate)
    port_cfg = compose(CONFIGS, "train", overrides)
    pmod = get_class(port_cfg["module"]["_target_"])(dict(port_cfg["module"]), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(np_tree(jstate.params)))
    CheckpointManager(root / "port_lmp", config=port_cfg).save(0, pstate)
    return root / "jax_lmp", root / "port_lmp"


@contextlib.contextmanager
def plan_terms():
    """The mean log-density of the posterior's plan under the actor, the BC
    loss's second term, at each train step (the one ``Actor.log_prob`` call
    a step makes with gradients on)."""
    terms, log_prob = [], Actor.log_prob

    def recorded(self, obs_emb, actions):
        out = log_prob(self, obs_emb, actions)
        if torch.is_grad_enabled():
            terms.append(float(out.detach().mean()))
        return out

    Actor.log_prob = recorded
    try:
        yield terms
    finally:
        Actor.log_prob = log_prob


@pytest.fixture(scope="module")
def cql_phase(tmp_path_factory):
    root = tmp_path_factory.mktemp("cql_phase")
    play = play_set(root)
    jax_lmp, port_lmp = _lmp_checkpoints(root, play)
    convert = lambda s: tacorl_state_dict_from_jax(np_tree(s.params), np_tree(s.aux))  # noqa: E731
    overrides = RL + [f"data_dir={play}"]
    jax_dir, port_dir = step0_checkpoints(root, overrides, convert, [f"play_lmp_dir={jax_lmp}"],
                                          [f"play_lmp_dir={port_lmp}"])
    with interpret_pallas():
        jax_main(overrides + [f"play_lmp_dir={jax_lmp}", f"run_dir={jax_dir}", "platform=cpu"])
    phases = BCPhase()
    with plan_terms() as terms:
        trainer = train.main([*overrides, f"play_lmp_dir={port_lmp}", f"run_dir={port_dir}"],
                             callbacks=[Draws(source), phases])
    raw = JaxCheckpointManager(jax_dir).restore(-1)
    return dict(jax_dir=jax_dir, trainer=trainer, phases=phases.phases, plan_terms=terms,
                jax_params=tacorl_state_dict_from_jax(np_tree(raw["params"]), np_tree(raw["aux"])))


def _split(rows):
    """(train and validation rows, the steps of the rollout rows)."""
    rollout = lambda r: any(k.startswith(ROLLOUT_KEYS) or k.count("/") == 2 for k in r)  # noqa: E731
    return [r for r in rows if not rollout(r)], sorted({r["step"] for r in rows if rollout(r)})


def test_the_cql_phase_runs_after_a_bc_epoch_with_rollouts_between_epochs(cql_phase):
    trainer = cql_phase["trainer"]
    assert trainer.global_step == trainer.state.step == STEPS
    assert cql_phase["phases"] == [1.0, 0.0, 0.0]  # 8 of the 12 steps at bc_phase 0
    assert [type(cb).__name__ for cb in trainer.callbacks][1:] == ["RolloutCallback", "Draws", "BCPhase"]
    got, want = _rows(trainer.ckpt.dir), _rows(cql_phase["jax_dir"])
    ends = [BATCHES * (e + 1) for e in range(EPOCHS)]
    assert _split(got)[1] == _split(want)[1] == ends  # both fired after every epoch
    assert sum("val_accuracy" in r for r in got) == sum("val_accuracy" in r for r in want) == EPOCHS
    cql = [r for r in want if "train/alpha_prime" in r and r["step"] > BATCHES]
    # what the CQL phase moves: alpha and the Lagrange alpha' on every logged step
    for key in ("train/alpha", "train/alpha_prime"):
        assert len({r[key] for r in cql}) == len(cql) == (STEPS - BATCHES) // K, key


def test_every_train_and_validation_row_matches_the_jax_trainer(cql_phase):
    got, _ = _split(_rows(cql_phase["trainer"].ckpt.dir))
    want, _ = _split(_rows(cql_phase["jax_dir"]))
    terms = cql_phase["plan_terms"]
    assert len(terms) == STEPS
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ("step", "time"):
                continue
            atol = 1e-6
            if k == "train/actor_loss" and w["step"] <= BATCHES:  # bc_phase 1: a difference of two terms
                plan = terms[w["step"] - 1]
                atol = RTOL * (abs(w[k] + plan) + abs(plan))
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=atol, err_msg=f"step {w['step']} {k}")
    assert [r["step"] for r in want if "train/q1_loss" in r] == list(range(K, STEPS + 1, K))
    assert [r["step"] for r in want if "validation/q1_loss" in r] == [BATCHES * (e + 1) for e in range(EPOCHS)]


def test_the_parameters_match_the_jax_trainer_after_the_cql_phase(cql_phase):
    trainer = cql_phase["trainer"]
    sd, want = trainer.state.net.state_dict(), cql_phase["jax_params"]
    assert set(want) == set(sd)
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), atol=STEPS * 2.5 * LR, rtol=0, err_msg=name)
    # the Adam moments the CQL phase stepped with
    moments = [s["exp_avg"] for s in trainer.state.optimizer.groups["q1"].optimizer.state.values()]
    assert moments and all(m.abs().sum() > 0 for m in moments)
