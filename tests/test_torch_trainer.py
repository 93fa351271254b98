"""The port's trainer held against the JAX package's on the CPU:

  * Play-LMP's val step against JAX's, with JAX's k_plan / k_pp draws;
  * the port Trainer against the JAX Trainer on one synthetic dataset: both
    resume from one step-0 checkpoint (written in each format), the port
    takes a draw source rebuilt from the JAX key chain; 3 steps across 2
    epochs with validation and checkpoints give the same metrics.jsonl
    steps and keys, values at rtol 1e-5, the same kept checkpoints and
    final parameters within the step tests' tolerance times the steps;
  * the port alone: 2 steps, a kill and 2 more give bit-equal parameters
    to 4 uninterrupted steps, with dropout on;
  * callback state round-trips by class name and in the legacy list format.

The JAX steps run their Pallas jitter tail in interpret mode."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.core.logging import MetricsSink as JaxMetricsSink
from tacorl_tpu.core.trainer import Trainer as JaxTrainer
from tacorl_tpu.data.datamodule import BasicDataModule as JaxDataModule
from tacorl_tpu.data.storage import pack_frames
from tacorl_tpu.data.synthetic import generate_synthetic_calvin
from tacorl_tpu.modules.play_lmp import PlayLMPModule as JaxPlayLMPModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.core.logging import MetricsSink
from tacorl_tpu_torch.core.trainer import Trainer, step_seed
from tacorl_tpu_torch.data.datamodule import BasicDataModule
from tacorl_tpu_torch.data.loader import DataLoader
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax
from tests.test_torch_play_lmp import LR, PAD, _batch, _cfg, _np_tree
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

LATENT, B, MAX_WS, RAW = 16, 8, 5, 56  # batch 8: the JAX test mesh has 8 devices
SEED = 3


@pytest.fixture
def interpret_pallas():
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    yield
    pallas_aug.pallas_augment_tail = tail


def _t(x):
    return torch.from_numpy(np.array(x))


def train_draws(seed, step, n):
    """The draws JAX's make_train_step makes at ``step``: the key folded
    with the step, split into (k_aug, k_drop, k_loss)."""
    k_aug, _, k_loss = jax.random.split(jax.random.fold_in(jax.random.key(seed), step), 3)
    k_shift, k_jit = jax.random.split(jax.random.fold_in(k_aug, stable_fold("rgb_static")))
    return {
        "aug_draws": {"rgb_static": {
            "shifts": _t(jax.random.randint(k_shift, (n, 2), 0, 2 * PAD + 1)),
            "factors": _t(pallas_aug.sample_jitter_factors(k_jit, n)),
        }},
        "eps": _t(jax.random.normal(jax.random.split(k_loss, 6)[0], (n // MAX_WS, LATENT))),
    }


def val_draws(key, b):
    """k_plan and k_pp of JAX's val step on ``key``."""
    _, k_loss = jax.random.split(key)
    keys = jax.random.split(k_loss, 6)
    return {
        "eps": _t(jax.random.normal(keys[0], (b, LATENT))),
        "pp_eps": _t(jax.random.normal(keys[5], (b, LATENT))),
    }


# -- the val step ------------------------------------------------------------------


def test_val_step_matches_jax(interpret_pallas):
    batch = _batch(1)
    b = batch["actions"].shape[0]
    batch["idx"] = np.arange(b, dtype=np.int64)
    rs = np.random.RandomState(2)
    batch["state_info"] = {"robot_obs": rs.randn(b, 5, 15).astype(np.float32)}
    jmod = JaxPlayLMPModule(_cfg())
    jstate = jmod.init_state(jax.random.key(1), batch)
    key = jax.random.key(7)
    jmetrics, jout = jmod.make_val_step()(jstate, batch, key, {"kl_beta": jnp.asarray(1e-3)})

    pmod = PlayLMPModule(_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(_np_tree(jstate.params)))
    pmetrics, pout = pmod.make_val_step()(pstate, batch, **val_draws(key, b))
    assert set(pmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(pmetrics[k]), float(jmetrics[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(pout["sampled_plan_pp"].numpy(), np.asarray(jout["sampled_plan_pp"]), atol=1e-5)
    assert np.array_equal(np.asarray(pout["idx"]), np.asarray(jout["idx"]))
    for part in ("state_info_initial", "state_info_final"):
        assert np.array_equal(np.asarray(pout[part]["robot_obs"]), np.asarray(jout[part]["robot_obs"]))
    assert not pmod.net.training


def test_train_step_still_returns_what_it_did():
    pmod = PlayLMPModule(_cfg(), device="cpu")
    _, metrics = pmod.make_train_step()(pmod.init_state(0), _batch())
    assert set(metrics) == {"kl_loss", "kl_loss_scaled", "action_loss", "gripper_accuracy",
                            "total_loss", "grad_norm"}


# -- the trainer against the JAX trainer ------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """One training episode of 24 frames (19 windows: 2 batches of 8) and
    one validation episode, packed."""
    root = tmp_path_factory.mktemp("trainer_data")
    generate_synthetic_calvin(root / "frames", 1, 1, 24, RAW,
                              keys=("rgb_static", "robot_obs", "scene_obs", "rel_actions_world"))
    for split in ("training", "validation"):
        pack_frames(root / "frames" / split, root / "packed" / split)
    return root / "packed"


def _dm_kwargs(data_dir):
    return dict(
        data_dir=str(data_dir), batch_size=B, val_percentage=1.0, seed=SEED,
        dataset={"_target_": "tacorl_tpu.data.play_dataset.PlayWindowDataset",
                 "modalities": ["rgb_static", "rel_actions_world"],
                 "min_window_size": 3, "max_window_size": MAX_WS},
    )


TRAINER = dict(max_steps=3, val_every_n_epochs=1, limit_val_batches=1, log_every_n_steps=1,
               ckpt_every_n_epochs=1, seed=SEED)


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def trainer_pair(dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_runs")
    cfg = _cfg()
    cfg["plan_recognition"]["max_position_embeddings"] = MAX_WS
    kw = dict(max_to_keep=2, monitor="validation/total_loss", mode="min")

    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jdm = JaxDataModule(**_dm_kwargs(dataset))
        jdm.setup()
        jmod = JaxPlayLMPModule(cfg)
        jstate = jmod.init_state(jax.random.key(1), next(iter(jdm.train_loader())))
        params0 = _np_tree(jstate.params)
        JaxCheckpointManager(root / "jax", **kw).save(0, jstate)
        jtrainer = JaxTrainer(ckpt_manager=JaxCheckpointManager(root / "jax", **kw),
                              sink=JaxMetricsSink(root / "jax"), **TRAINER)
        jfinal = jtrainer.fit(jmod, JaxDataModule(**_dm_kwargs(dataset)))
        jparams = play_lmp_state_dict_from_jax(_np_tree(jfinal.params))
    finally:
        pallas_aug.pallas_augment_tail = tail

    pmod = PlayLMPModule(cfg, device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(params0))
    CheckpointManager(root / "port", **kw).save(0, pstate)

    def source(split, index):
        if split == "train":
            return train_draws(SEED, index, B * MAX_WS)
        return val_draws(jax.random.fold_in(jax.random.key(SEED + 1), index), B)

    ptrainer = Trainer(ckpt_manager=CheckpointManager(root / "port", **kw), sink=MetricsSink(root / "port"),
                       device="cpu", draw_source=source, **TRAINER)
    pfinal = ptrainer.fit(PlayLMPModule(cfg, device="cpu"), BasicDataModule(**_dm_kwargs(dataset)))
    return root, (jtrainer, jparams), (ptrainer, pfinal)


def test_trainer_logs_what_the_jax_trainer_logs(trainer_pair):
    root, _, _ = trainer_pair
    got, want = _rows(root / "port"), _rows(root / "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 2, 3, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k not in ("step", "time"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=f"step {w['step']} {k}")


def test_trainer_keeps_what_the_jax_trainer_keeps(trainer_pair):
    root, (jtrainer, _), (ptrainer, _) = trainer_pair
    # the step-0 save has no metric (NaN), which the JAX retention ranks
    # best in min mode: it is kept over step 2
    assert ptrainer.ckpt.all_steps() == jtrainer.ckpt.all_steps() == [0, 3]
    assert ptrainer.ckpt.best_step() == jtrainer.ckpt.best_step()
    got = json.loads((root / "port" / "ckpts" / "metrics.json").read_text())
    want = json.loads((root / "jax" / "ckpts" / "metrics.json").read_text())
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-5)
    assert ptrainer.global_step == jtrainer.global_step == 3
    assert [s for s, _, _ in ptrainer.saves] == [2, 3]


def test_trainer_params_match_the_jax_trainer(trainer_pair):
    _, (_, jparams), (_, pfinal) = trainer_pair
    sd = pfinal.net.state_dict()
    assert pfinal.step == 3 and set(sd) == set(jparams)
    for name, want in jparams.items():
        # the step tests' 2.5 lr per step, over 3 steps
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=3 * 2.5 * LR, rtol=0, err_msg=name)


# -- the port alone ----------------------------------------------------------------------


class _ConstantWindows:
    """Every index samples the same window, so a resumed run, which starts
    its loader at epoch 0 again (as the JAX trainer's does), sees what an
    uninterrupted run sees."""

    def __init__(self):
        batch = _batch(4)
        self.item = {"states": {"rgb_static": batch["states"]["rgb_static"][0]},
                     "actions": batch["actions"][0]}

    def __len__(self):
        return 16

    def sample(self, idx, rng):
        return self.item


class _ConstantDataModule:
    def setup(self):
        self.train_dataset = _ConstantWindows()

    def train_loader(self):
        return DataLoader(self.train_dataset, batch_size=4, seed=0)

    def val_loader(self):
        return None


def _dropout_cfg():
    cfg = _cfg()
    cfg["plan_recognition"]["dropout_p"] = 0.1
    return cfg


def _fit(run_dir, max_steps, seed=SEED):
    trainer = Trainer(max_steps=max_steps, ckpt_manager=CheckpointManager(run_dir), seed=seed,
                      device="cpu", log_every_n_steps=100)
    state = trainer.fit(PlayLMPModule(_dropout_cfg(), device="cpu"), _ConstantDataModule())
    return state


def test_kill_and_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    whole = _fit(tmp_path / "whole", 4)
    _fit(tmp_path / "killed", 2)
    resumed = _fit(tmp_path / "killed", 4)
    assert whole.step == resumed.step == 4
    a, b = whole.net.state_dict(), resumed.net.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    opt_a, opt_b = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert all(torch.equal(opt_a[i]["exp_avg_sq"], opt_b[i]["exp_avg_sq"]) for i in opt_a)
    # the draws (dropout included) follow the seed: another seed trains apart
    other = _fit(tmp_path / "other", 4, seed=SEED + 1).net.state_dict()
    assert any(not torch.equal(a[k], other[k]) for k in a)


def test_step_seed_depends_on_both_parts():
    seeds = {step_seed(s, i) for s in (0, 1) for i in (0, 1, 2)}
    assert len(seeds) == 6 and all(0 <= s < 2**63 for s in seeds)


# -- callback state -----------------------------------------------------------------------


class _Counter(Callback):
    def __init__(self, n=0):
        self.n = n

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, state):
        self.n = state["n"]


class _Other(_Counter):
    pass


class _Stateless(Callback):
    pass


def _callbacks(a=0, b=0, c=0):
    return [_Counter(a), _Stateless(), _Other(b), _Counter(c)]


def test_callback_state_round_trips_by_class_name(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    Trainer(ckpt_manager=CheckpointManager(port_dir), callbacks=_callbacks(1, 2, 3),
            device="cpu")._save_callback_states()
    JaxTrainer(ckpt_manager=JaxCheckpointManager(jax_dir), callbacks=_callbacks(1, 2, 3))._save_callback_states()
    saved = json.loads((port_dir / "callbacks_state.json").read_text())
    assert saved == json.loads((jax_dir / "callbacks_state.json").read_text())
    assert saved == {"_Counter#0": {"n": 1}, "_Other": {"n": 2}, "_Counter#1": {"n": 3}}
    # reordered in the config: each state still reaches its own callback
    fresh = [_Other(), _Counter(), _Counter()]
    Trainer(ckpt_manager=CheckpointManager(port_dir), callbacks=fresh, device="cpu")._load_callback_states()
    assert [cb.n for cb in fresh] == [2, 1, 3]


@pytest.mark.parametrize("layout", ["legacy_list", "bare_name"])
def test_callback_state_loads_older_layouts(tmp_path, layout):
    (tmp_path / "ckpts").mkdir()
    states = [{"n": 5}, {}, {"n": 6}] if layout == "legacy_list" else {"_Other": {"n": 6}}
    (tmp_path / "callbacks_state.json").write_text(json.dumps(states))
    cbs = [_Counter(), _Stateless(), _Other()]
    Trainer(ckpt_manager=CheckpointManager(tmp_path), callbacks=cbs, device="cpu")._load_callback_states()
    assert [cbs[0].n, cbs[2].n] == ([5, 6] if layout == "legacy_list" else [0, 6])


def test_scanned_dispatch_is_refused():
    """K-step dispatch is ported: the trainer takes any steps_per_call, and
    only a module that steps an env inside its train step refuses to scan
    (the trainer then runs it one step at a time, as the JAX trainer does)."""
    from tacorl_tpu_torch.modules.sac import SACModule
    from tests.test_torch_cql_flat import state_cfg

    assert Trainer(steps_per_call=4, device="cpu").steps_per_call == 4
    assert PlayLMPModule(_cfg(), device="cpu").make_scanned_train_step().graph is None
    with pytest.raises(RuntimeError, match="SACModule interacts with the environment"):
        SACModule(state_cfg(), device="cpu").make_scanned_train_step()


def test_trainer_refuses_a_module_on_another_device():
    from types import SimpleNamespace

    with pytest.raises(ValueError, match="module on"):
        Trainer(device="cpu").fit(SimpleNamespace(device="meta"), None)
