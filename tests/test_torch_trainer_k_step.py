"""The port's K-step trainer (``trainer.steps_per_call = K > 1``) held
against the JAX package's on the CPU, through the commands a user runs:
``python -m tacorl_tpu_torch.train`` (``train.main``) against
``scripts/train.py`` on ``experiment=play_lmp_for_rl`` at tiny widths.

Both runs resume from one step-0 checkpoint (the same weights written in
each format); the port takes a draw source that re-makes the JAX step's
draws at every global step (the JAX scan folds its key with
``state.step``). An epoch has 4 batches: at K = 3 one chunk trains and a
trailing chunk of 1 is dropped and logged; ``max_steps=5`` stops after the
second epoch's chunk, at step 6; the linear KL schedule moves kl_beta at
each epoch. Checked: the logged steps and every metric (rtol 1e-5), the
dropped chunk's log line, the overshoot, the kept checkpoints and the
params; then, on the port alone, K = 2 against K = 1 across the kl_beta
changes (bit-equal), K clamped to the epoch, and a resume from a K = 1
checkpoint at K = 4 and back.

The JAX steps run their Pallas jitter tail in interpret mode."""

import contextlib
import functools
import logging

import jax
import numpy as np
import pytest
import torch

from scripts.train import main as jax_main
from tacorl_tpu.config import compose as jax_compose
from tacorl_tpu.config import get_class as jax_get_class
from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.data.datamodule import BasicDataModule as JaxDataModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.config import compose, get_class
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax
from tests.test_torch_cql import np_tree
from tests.test_torch_train_cli import CONFIGS, TINY, _rows, calvin  # noqa: F401 (a fixture)
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

SEED = 42  # configs/train.yaml's: it comes after the experiment
B, MAX_WS, PAD, LATENT = 8, 8, 2, 16
LR = 1e-4
LMP = TINY + [
    "experiment=play_lmp_for_rl",
    # float32 on both sides and no posterior dropout: one deterministic function
    "transforms.rgb_static.aug_dtype=float32",
    "+module.perceptual_encoder.networks.rgb_static.compute_dtype=null",
    "module.plan_recognition.dropout_p=0.0",
    "callbacks/kl_schedule=linear", "callbacks.kl_schedule.start_epoch=0",
    "callbacks.kl_schedule.end_epoch=2",
]


@contextlib.contextmanager
def interpret_pallas():
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        yield
    finally:
        pallas_aug.pallas_augment_tail = tail


def _t(x):
    return torch.from_numpy(np.array(x))


def lmp_train_draws(step, n=B * MAX_WS, b=B):
    """The draws JAX's Play-LMP train step makes at ``step``."""
    k_aug, _, k_loss = jax.random.split(jax.random.fold_in(jax.random.key(SEED), step), 3)
    k_shift, k_jit = jax.random.split(jax.random.fold_in(k_aug, stable_fold("rgb_static")))
    return {
        "aug_draws": {"rgb_static": {
            "shifts": _t(jax.random.randint(k_shift, (n, 2), 0, 2 * PAD + 1)),
            "factors": _t(pallas_aug.sample_jitter_factors(k_jit, n)),
        }},
        "eps": _t(jax.random.normal(jax.random.split(k_loss, 6)[0], (b, LATENT))),
    }


def lmp_val_draws(index, b=B):
    """k_plan and k_pp of JAX's val step on batch ``index``."""
    _, k_loss = jax.random.split(jax.random.fold_in(jax.random.key(SEED + 1), index))
    keys = jax.random.split(k_loss, 6)
    return {"eps": _t(jax.random.normal(keys[0], (b, LATENT))),
            "pp_eps": _t(jax.random.normal(keys[5], (b, LATENT)))}


def lmp_source(split, index):
    return lmp_train_draws(index) if split == "train" else lmp_val_draws(index)


class Draws(Callback):
    """Hands the trainer a draw source."""

    def __init__(self, source):
        self.source = source

    def on_fit_start(self, trainer, module):
        trainer.draw_source = self.source


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def logged(*names):
    handler = LogLines()
    loggers = [logging.getLogger(n) for n in names]
    levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
    try:
        yield handler.lines
    finally:
        for lg, level in zip(loggers, levels):
            lg.removeHandler(handler)
            lg.setLevel(level)


def step0_checkpoints(root, overrides, convert, jax_extra=(), port_extra=()):
    """JAX's initial state saved at step 0 in the JAX format and, converted,
    in the port's; returns the two run directories."""
    cfg = jax_compose(CONFIGS, "train", overrides + list(jax_extra))
    dm_cfg = dict(cfg["datamodule"])
    dm_cls = jax_get_class(dm_cfg.pop("_target_")) if "_target_" in dm_cfg else JaxDataModule
    dm = dm_cls(**dm_cfg)
    dm.setup()
    example = next(iter(dm.train_loader()))
    jmod = jax_get_class(cfg["module"]["_target_"])(dict(cfg["module"]))
    with interpret_pallas():
        jstate = jax.jit(jmod.init_state)(jax.random.key(1), example)
    jax_dir, port_dir = root / "jax", root / "port"
    JaxCheckpointManager(jax_dir, config=cfg).save(0, jstate)
    port_cfg = compose(CONFIGS, "train", overrides + list(port_extra))
    pmod = get_class(port_cfg["module"]["_target_"])(dict(port_cfg["module"]), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(convert(jstate))
    CheckpointManager(port_dir, config=port_cfg).save(0, pstate)
    return jax_dir, port_dir


def run_pair(root, overrides, convert, source, jax_extra=(), port_extra=()):
    """scripts/train.py and train.main from one step-0 checkpoint; returns
    (jax run dir, port trainer, the log lines of each)."""
    jax_dir, port_dir = step0_checkpoints(root, overrides, convert, jax_extra, port_extra)
    with interpret_pallas(), logged("tacorl_tpu") as jax_lines:
        jax_main(overrides + list(jax_extra) + [f"run_dir={jax_dir}", "platform=cpu"])
    with logged("tacorl_tpu_torch") as port_lines:
        trainer = train.main(["+device=cpu", *overrides, *port_extra, f"run_dir={port_dir}"],
                             callbacks=[Draws(source)])
    return jax_dir, trainer, jax_lines, port_lines


def assert_rows_match(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k not in ("step", "time"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=f"step {w['step']} {k}")


DROPPED = "scanned dispatch dropped a trailing partial chunk of 1/3 batches this epoch"


@pytest.fixture(scope="module")
def lmp_pair(calvin, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("lmp_k3")
    overrides = LMP + [f"data_dir={calvin}", "trainer.steps_per_call=3", "trainer.max_steps=5",
                       "ckpt_max_to_keep=2"]
    convert = lambda s: play_lmp_state_dict_from_jax(np_tree(s.params))  # noqa: E731
    jax_dir, trainer, jax_lines, port_lines = run_pair(root, overrides, convert, lmp_source)
    jax_params = play_lmp_state_dict_from_jax(np_tree(JaxCheckpointManager(jax_dir).restore(-1)["params"]))
    return dict(jax_dir=jax_dir, trainer=trainer, jax_lines=jax_lines, port_lines=port_lines,
                jax_params=jax_params)


def test_k_step_trainer_logs_what_the_jax_trainer_logs(lmp_pair):
    got, want = _rows(lmp_pair["trainer"].ckpt.dir), _rows(lmp_pair["jax_dir"])
    assert_rows_match(got, want)
    train_rows = [r for r in want if "train/total_loss" in r]
    # one chunk an epoch: steps 3 and 6 (6 overshoots max_steps 5 by K - 1 at most)
    assert [r["step"] for r in train_rows] == [3, 6]
    # the linear schedule's kl_beta of epochs 0 and 1 reached every step of each chunk
    assert train_rows[0]["train/kl_loss_scaled"] == 0.0
    np.testing.assert_allclose(train_rows[1]["train/kl_loss_scaled"], 0.5e-3 * train_rows[1]["train/kl_loss"],
                               rtol=1e-5)
    assert sum("validation/total_loss" in r for r in want) == 2


def test_both_trainers_drop_the_trailing_chunk_and_say_so(lmp_pair):
    # in both epochs: the prefetch reads one chunk ahead, so the loader of
    # the second epoch runs out before its first chunk trains and stops
    assert lmp_pair["jax_lines"].count(DROPPED) == lmp_pair["port_lines"].count(DROPPED) == 2
    assert "epoch 0: 3 steps" in " ".join(lmp_pair["port_lines"])


def test_k_step_trainer_overshoots_and_keeps_what_jax_keeps(lmp_pair):
    trainer = lmp_pair["trainer"]
    assert trainer.global_step == trainer.state.step == 6 and trainer.steps_per_call == 3
    assert trainer.ckpt.all_steps() == JaxCheckpointManager(lmp_pair["jax_dir"]).all_steps() == [0, 6]
    assert [s for s, _, _ in trainer.saves] == [3, 6]


def test_k_step_params_match_the_jax_trainer(lmp_pair):
    sd = lmp_pair["trainer"].state.net.state_dict()
    for name, want in lmp_pair["jax_params"].items():
        # the step tests' 2.5 lr per step, over 6 steps
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=6 * 2.5 * LR, rtol=0, err_msg=name)


# -- the port alone ---------------------------------------------------------------------


def _port_run(run_dir, calvin_dir, k, *extra):  # noqa: F811
    return train.main(["+device=cpu", *LMP, f"data_dir={calvin_dir}", f"run_dir={run_dir}",
                       f"trainer.steps_per_call={k}", "trainer.log_every_n_steps=2", *extra],
                      callbacks=[Draws(lmp_source)])


def _same_state(a, b):
    sa, sb = a.state.net.state_dict(), b.state.net.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.state.optimizer.state_dict()["state"], b.state.optimizer.state_dict()["state"]
    assert all(torch.equal(oa[i]["exp_avg_sq"], ob[i]["exp_avg_sq"]) for i in oa)


def test_k_steps_equal_k_single_steps_across_kl_beta_changes(calvin, tmp_path):  # noqa: F811
    """3 epochs of 4 batches (kl_beta 0, 5e-4, 1e-3): K = 2 trains what
    K = 1 trains, bit for bit, and logs the same rows at the steps both
    log."""
    single = _port_run(tmp_path / "k1", calvin, 1, "trainer.max_epochs=3", "trainer.max_steps=100")
    chunked = _port_run(tmp_path / "k2", calvin, 2, "trainer.max_epochs=3", "trainer.max_steps=100")
    assert single.global_step == chunked.global_step == 12
    _same_state(single, chunked)
    got = [{k: v for k, v in r.items() if k != "time"} for r in _rows(tmp_path / "k2")]
    want = [{k: v for k, v in r.items() if k != "time"} for r in _rows(tmp_path / "k1")]
    assert got == want
    kl = [r["train/kl_loss_scaled"] / r["train/kl_loss"] for r in got if "train/kl_loss" in r]
    np.testing.assert_allclose(kl[::2], [0.0, 5e-4, 1e-3], rtol=1e-6)


def test_k_is_clamped_to_the_epoch(calvin, tmp_path):  # noqa: F811
    trainer = _port_run(tmp_path / "run", calvin, 16, "trainer.max_steps=8")
    assert trainer.steps_per_call == 4 and trainer.global_step == 8
    assert [r["step"] for r in _rows(tmp_path / "run") if "train/total_loss" in r] == [4, 8]


def test_a_k1_checkpoint_resumes_at_k4_and_back(calvin, tmp_path):  # noqa: F811
    """2 steps at K = 1, then K = 4 to step 6, then K = 1 to step 8: bit-equal
    to the same three legs at K = 1 (a resumed run starts again at epoch
    0's batches, as the JAX trainer's does: the legs train batches 0-1,
    0-3 and 0-1)."""
    whole_dir, legs_dir = tmp_path / "whole", tmp_path / "legs"
    _port_run(legs_dir, calvin, 1, "trainer.max_steps=2")
    resumed = _port_run(legs_dir, calvin, 4, "trainer.max_steps=6")
    assert resumed.global_step == 6 and resumed.ckpt.latest_step() == 6
    back = _port_run(legs_dir, calvin, 1, "trainer.max_steps=8")
    assert back.global_step == 8
    # the same legs at K = 1 throughout
    for max_steps in (2, 6, 8):
        single = _port_run(whole_dir, calvin, 1, f"trainer.max_steps={max_steps}")
    _same_state(back, single)
