"""Stage 2 through the port's K-step trainer against the JAX package's on
the CPU: ``train.main`` against ``scripts/train.py`` on
``experiment=tacorl`` at tiny widths and ``trainer.steps_per_call=2``,
each grafted from a stage-1 checkpoint of the same weights in its own
format, both resuming from one step-0 checkpoint, the port with the JAX
step's draws at every global step (test_torch_trainer_k_step.py). An
epoch has 4 batches, 2 chunks; 2 epochs with ``bc_phase`` 1 (the BC
warm-start epochs): the same logged steps and metrics (rtol 1e-5), kept
checkpoints and params (atol 2.5 lr per step)."""

import jax
import numpy as np
import pytest

from tacorl_tpu.config import compose as jax_compose
from tacorl_tpu.config import get_class as jax_get_class
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.data.datamodule import BasicDataModule as JaxDataModule
from tacorl_tpu_torch.config import compose, get_class
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax, tacorl_state_dict_from_jax
from tests.test_torch_cql import aug_draws, cql_draws, leaf_key, np_tree
from tests.test_torch_train_cli import CONFIGS, _rows, calvin  # noqa: F401 (a fixture)
from tests.test_torch_trainer_k_step import (
    B,
    LATENT,
    LMP,
    MAX_WS,
    PAD,
    SEED,
    _t,
    assert_rows_match,
    interpret_pallas,
    run_pair,
)

N_ACT, LR, STEPS = 4, 3e-4, 8  # configs/module/tacorl.yaml: n_action_samples, the largest lr


def tacorl_draws(key, train: bool):
    """The draws of JAX's TACO-RL update from its key (a train step's key is
    folded with the step first)."""
    k_aug, k_plan, k_cql = jax.random.split(key, 3)
    draws = cql_draws(k_cql, B, N_ACT, LATENT, discrete_gripper=False)
    if train:
        draws["aug_states"] = {"rgb_static": aug_draws(leaf_key(k_aug, "rgb_static"), B * MAX_WS, PAD)}
        draws["aug_goal"] = {"rgb_static": aug_draws(leaf_key(jax.random.fold_in(k_aug, 1), "rgb_static"), B, PAD)}
    draws["plan_eps"] = _t(jax.random.normal(k_plan, (B, LATENT)))
    return {"draws": draws}


def source(split, index):
    if split == "train":
        return tacorl_draws(jax.random.fold_in(jax.random.key(SEED), index), True)
    return tacorl_draws(jax.random.fold_in(jax.random.key(SEED + 1), index), False)


def _lmp_checkpoints(root, calvin_dir):
    """One stage-1 state in the JAX format and, converted, in the port's."""
    overrides = LMP + [f"data_dir={calvin_dir}"]
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


@pytest.fixture(scope="module")
def tacorl_pair(calvin, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("tacorl_k2")
    jax_lmp, port_lmp = _lmp_checkpoints(root, calvin)
    overrides = LMP + [
        "experiment=tacorl", f"data_dir={calvin}", "module.q_network.hidden_dim=16",
        "+datamodule.dataset.num_nn=8", "trainer.steps_per_call=2", f"trainer.max_steps={STEPS}",
        "trainer.log_every_n_steps=2",
    ]
    convert = lambda s: tacorl_state_dict_from_jax(np_tree(s.params), np_tree(s.aux))  # noqa: E731
    jax_dir, trainer, _, _ = run_pair(
        root, overrides, convert, source, jax_extra=[f"play_lmp_dir={jax_lmp}"],
        port_extra=[f"play_lmp_dir={port_lmp}"],
    )
    raw = JaxCheckpointManager(jax_dir).restore(-1)
    return dict(jax_dir=jax_dir, trainer=trainer,
                jax_params=tacorl_state_dict_from_jax(np_tree(raw["params"]), np_tree(raw["aux"])))


def test_k_step_stage2_logs_what_the_jax_trainer_logs(tacorl_pair):
    got, want = _rows(tacorl_pair["trainer"].ckpt.dir), _rows(tacorl_pair["jax_dir"])
    assert_rows_match(got, want)
    assert [r["step"] for r in want if "train/q1_loss" in r] == [2, 4, 6, 8]
    assert sum("validation/q1_loss" in r for r in want) == 2


def test_k_step_stage2_keeps_what_the_jax_trainer_keeps(tacorl_pair):
    trainer = tacorl_pair["trainer"]
    assert trainer.global_step == trainer.state.step == STEPS and trainer.steps_per_call == 2
    assert trainer.ckpt.all_steps() == JaxCheckpointManager(tacorl_pair["jax_dir"]).all_steps()


def test_k_step_stage2_params_match_the_jax_trainer(tacorl_pair):
    sd = tacorl_pair["trainer"].state.net.state_dict()
    want = tacorl_pair["jax_params"]
    assert set(want) == set(sd)
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), atol=STEPS * 2.5 * LR, rtol=0, err_msg=name)
