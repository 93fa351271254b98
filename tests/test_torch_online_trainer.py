"""Online RL through the port's trainer and command against the JAX
package's, on the CPU:

  * ``train.main`` on ``experiment=sac_online_fake`` and ``cql_online_fake``
    (``+device=cpu``, narrow widths, 2 epochs of 3 steps with the rollout
    monitor) against ``scripts/train.py`` from the same initial weights
    (JAX's fresh init, converted) and with JAX's draws (the step keys and
    the play key chain): every logged metric at rtol 1e-5, the same steps,
    keys and kept checkpoints; the JAX trainer's example draw reproduced;
  * the three hooks fire in the JAX order, and the replay buffer's files
    follow each save;
  * a resume with ``replay_buffer_path`` set reloads the buffer and does not
    refill it;
  * ``python -m tacorl_tpu_torch.evaluate`` scores an online checkpoint
    through FlatPolicyAgent;
  * the four online experiments compose as in the JAX package, and the two
    visual ones train through ``train.main`` at narrow widths.
"""

import json

import jax
import numpy as np
import pytest

import tacorl_tpu.core.checkpoint as jax_checkpoint
import tacorl_tpu.data.online_datamodule as jax_online_dm
import tacorl_tpu.modules.sac as jax_sac
import tacorl_tpu_torch.core.checkpoint as port_checkpoint
import tacorl_tpu_torch.data.online_datamodule as port_online_dm
import tacorl_tpu_torch.modules.sac as port_sac
from scripts.train import main as jax_main
from tacorl_tpu.config import compose as jax_compose
from tacorl_tpu.config import get_class as jax_get_class
from tacorl_tpu_torch import evaluate, train
from tacorl_tpu_torch.callbacks.base import Callback
from tacorl_tpu_torch.config import compose
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import actor_draws, cql_draws, np_tree
from tests.test_torch_train_cli import CONFIGS

B, STEPS = 8, 6  # batch 8: the JAX trainer shards it over the test mesh's 8 devices
TINY = [
    "module.goal_encoder.hidden_size=16", "module.policy.hidden_dim=16",
    "module.q_network.hidden_dim=16", "module.warm_start_steps=16", "datamodule.batch_size=8",
    "datamodule.steps_per_epoch=3", "trainer.log_every_n_steps=1",
    "callbacks.rollout.num_rollouts=2", "env.max_episode_steps=8",
]
HOOKS = (("dm", "set_module"), ("dm", "setup"), ("module", "populate"), ("module", "init_state"),
         ("ckpt", "save"), ("module", "save_checkpoint_extras"))


def _rows(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _record_hooks(monkeypatch, owners, calls, run_dir):
    """Wrap each hook so that it appends its name (and, for the buffer's
    snapshot, the files on disk against the transitions in the buffer)."""
    for owner, name in HOOKS:
        cls = owners[owner]
        orig = getattr(cls, name)

        def hook(self, *a, _orig=orig, _name=name, **kw):
            out = _orig(self, *a, **kw)
            entry = _name
            if _name == "save_checkpoint_extras":
                files = len(list((run_dir / "rb").glob("*.npz")))
                entry = (_name, files, len(self.replay_buffer))
            calls.append(entry)
            return out

        monkeypatch.setattr(cls, name, hook)


class _JaxStart(Callback):
    """Loads JAX's fresh initial weights into the port's state and hands
    the trainer a draw source that re-makes JAX's draws."""

    def __init__(self, sd0, source):
        self.sd0, self.source = sd0, source

    def on_fit_start(self, trainer, module):
        trainer.state.net.load_state_dict(self.sd0)
        trainer.draw_source = self.source


def _jax_start(experiment, overrides):
    """The JAX trainer's fresh init (fold_in(key(seed), 0), shapes from any
    batch) converted, and a draw source for the port: the step keys
    fold_in(key(seed), step) and the module's play key chain."""
    cfg = jax_compose(CONFIGS, "train", [f"experiment={experiment}", *overrides])
    seed = int(cfg["seed"])  # configs/train.yaml's 42: it comes after the experiment
    jmod = jax_get_class(cfg["module"]["_target_"])(cfg["module"])
    jmod.populate(None, steps=2)
    state = jmod.init_state(jax.random.fold_in(jax.random.key(seed), 0), jmod.replay_buffer.sample(2))
    sd0 = cql_state_dict_from_jax(np_tree(state.params), np_tree(state.aux), ())
    n = int(cfg["module"].get("n_action_samples", 10))
    play_keys, key = [], jax.random.key(seed + 17)
    for _ in range(STEPS + 3):
        key, sub = jax.random.split(key)
        play_keys.append(sub)

    def source(split, index):
        assert split == "train"
        draws = cql_draws(jax.random.fold_in(jax.random.key(seed), index), B, n, 7, True)
        draws["play"] = {"action": actor_draws(play_keys[index], (1,), 7, True)}
        return {"draws": draws}

    return sd0, source


@pytest.fixture(scope="module", params=["sac_online_fake", "cql_online_fake"])
def runs(request, tmp_path_factory):
    experiment = request.param
    root = tmp_path_factory.mktemp(experiment)
    mp = pytest.MonkeyPatch()
    out = {"experiment": experiment, "root": root}
    try:
        for side in ("jax", "port"):
            run_dir = root / side
            args = [f"experiment={experiment}", f"run_dir={run_dir}", f"module.replay_buffer_path={run_dir}/rb",
                    f"trainer.max_steps={STEPS}", *TINY]
            calls = []
            if side == "jax":
                owners = {"dm": jax_online_dm.OnlineRLDataModule, "module": jax_sac.SACModule,
                          "ckpt": jax_checkpoint.CheckpointManager}
                _record_hooks(mp, owners, calls, run_dir)
                jax_main(args + ["platform=cpu"])
            else:
                owners = {"dm": port_online_dm.OnlineRLDataModule, "module": port_sac.SACModule,
                          "ckpt": port_checkpoint.CheckpointManager}
                _record_hooks(mp, owners, calls, run_dir)
                sd0, source = _jax_start(experiment, TINY)
                out["trainer"] = train.main(["+device=cpu", *args], callbacks=[_JaxStart(sd0, source)])
            mp.undo()
            out[side] = {"rows": _rows(run_dir), "calls": calls, "dir": run_dir}
    finally:
        mp.undo()
    return out


def test_online_trainer_logs_what_the_jax_trainer_logs(runs):
    got, want = runs["port"]["rows"], runs["jax"]["rows"]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert sum("val_episode_return" in r for r in want) == 2
    assert sum("train/actor_loss" in r for r in want) == STEPS
    conservative = runs["experiment"] == "cql_online_fake"
    assert any("train/conservative_q1_gap" in r for r in want) == conservative
    assert any("train/alpha_prime" in r for r in want) == conservative
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k not in ("step", "time"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6, err_msg=f"step {w['step']} {k}")


def test_online_trainer_keeps_what_the_jax_trainer_keeps(runs):
    trainer = runs["trainer"]
    jax_ckpt = jax_checkpoint.CheckpointManager(runs["jax"]["dir"], monitor="val_episode_return", mode="max")
    assert trainer.ckpt.all_steps() == jax_ckpt.all_steps() == [3, 6]
    assert trainer.global_step == STEPS and trainer.state.step == STEPS
    assert ("log_alpha_prime" in trainer.state.net.state_dict()) == (runs["experiment"] == "cql_online_fake")


def test_the_hooks_fire_in_the_jax_order(runs):
    """set_module, populate, setup, init, then per epoch the rollout
    monitor's snapshot and the checkpoint's save and snapshot; after each
    snapshot every transition of the buffer is on disk."""
    got, want = runs["port"]["calls"], runs["jax"]["calls"]
    assert got == want
    names = [c if isinstance(c, str) else c[0] for c in got]
    assert names[:4] == ["set_module", "populate", "setup", "init_state"]
    assert names.count("save") == 2 and names.count("save_checkpoint_extras") == 4
    assert [c[1:] for c in got if isinstance(c, tuple)] == [(19, 19), (19, 19), (22, 22), (22, 22)]


def test_a_resume_reloads_the_buffer_and_does_not_refill_it(runs):
    """One more epoch in the same run directory, in both packages: the
    buffer comes back from replay_buffer_path (no warm start), the run
    goes on from step 6 and snapshots the new transitions after them."""
    seen = {}

    class Probe(Callback):
        def on_fit_start(self, trainer, module):
            seen.update(loaded=len(module.replay_buffer), unsaved=module.replay_buffer.unsaved_transitions,
                        episodes=module.episode_number, step=trainer.global_step)

    experiment, run_dir = runs["experiment"], runs["port"]["dir"]
    args = [f"experiment={experiment}", f"run_dir={run_dir}", f"module.replay_buffer_path={run_dir}/rb",
            f"trainer.max_steps={STEPS + 3}", *TINY]
    trainer = train.main(["+device=cpu", *args], callbacks=[Probe()])
    assert seen == {"loaded": 22, "unsaved": 0, "episodes": 0, "step": STEPS}
    assert trainer.global_step == STEPS + 3
    module_files = sorted((run_dir / "rb").glob("*.npz"))
    assert len(module_files) == 25

    jdir = runs["jax"]["dir"]
    jax_main([f"experiment={experiment}", f"run_dir={jdir}", f"module.replay_buffer_path={jdir}/rb",
              f"trainer.max_steps={STEPS + 3}", *TINY, "platform=cpu"])
    assert sorted(p.name for p in (jdir / "rb").glob("*.npz")) == [p.name for p in module_files]
    got, want = _rows(run_dir), _rows(jdir)
    assert [r["step"] for r in got] == [r["step"] for r in want]


def test_evaluate_scores_an_online_checkpoint(runs, tmp_path):
    """The FlatPolicyAgent route of ``python -m tacorl_tpu_torch.evaluate``
    on the vector env, from an expert-play validation set."""
    from tacorl_tpu_torch.data.expert_play import generate_expert_play

    data = tmp_path / "play"
    generate_expert_play(data, n_train_episodes=1, n_val_episodes=2, tasks_per_episode=2, seed=3)
    results = evaluate.main([
        "+device=cpu", f"module_path={runs['port']['dir']}", "epoch=best", f"data_dir={data / 'validation'}",
        "eval_type=short_horizon", "env.image_hw=64", "env.max_episode_steps=6", "env.task_set=hard",
        "env.modalities=[robot_obs,scene_obs]", "env.goal_modalities=[robot_obs,scene_obs]",
        "min_seq_len=1", "max_seq_len=64", "max_rollouts=2", f"filename={tmp_path / 'best.json'}",
    ])
    assert results and all(0.0 <= r["accuracy"] <= 1.0 for r in results.values())


@pytest.mark.parametrize("experiment", ["sac_online", "sac_online_fake", "cql_online", "cql_online_fake"])
def test_online_experiments_compose_to_the_port_classes(experiment):
    from tacorl_tpu_torch.config import get_class, instantiate

    cfg = compose(CONFIGS, "train", [f"experiment={experiment}"])
    assert cfg == jax_compose(CONFIGS, "train", [f"experiment={experiment}"])
    module_cls = get_class(cfg["module"]["_target_"])
    assert module_cls.__module__.startswith("tacorl_tpu_torch.modules.")
    assert module_cls.use_conservative == experiment.startswith("cql")
    assert get_class(cfg["datamodule"]["_target_"]) is port_online_dm.OnlineRLDataModule
    env = instantiate(cfg["env"])
    assert type(env).__module__ == "tacorl_tpu_torch.envs.fake_calvin"


VISUAL_TINY = [
    "module.actor_encoder.networks.rgb_static.latent_dim=8",
    "module.actor_encoder.networks.rgb_static.hidden_dim=16",
    "module.critic_encoder.networks.rgb_static.latent_dim=8",
    "module.critic_encoder.networks.rgb_static.hidden_dim=16",
    "module.goal_encoder.hidden_size=16", "module.policy.hidden_dim=16", "module.q_network.hidden_dim=16",
    "module.warm_start_steps=12", "datamodule.batch_size=4", "datamodule.steps_per_epoch=2",
    "env.image_hw=48", "transforms.rgb_static.size=[48,48]", "transforms.rgb_static.pad=2",
    "trainer.log_every_n_steps=1",
]


@pytest.mark.parametrize("experiment", ["sac_online", "cql_online"])
def test_visual_online_experiments_train(experiment, tmp_path):
    """The visual experiments through ``train.main`` at narrow widths: the
    warm start, 2 epochs of env steps and updates, 2 saves; no rollout
    monitor, so no val metrics."""
    run = tmp_path / "run"
    trainer = train.main(["+device=cpu", f"experiment={experiment}", f"run_dir={run}",
                          "trainer.max_steps=4", *VISUAL_TINY])
    module = trainer.datamodule.module
    assert trainer.global_step == 4 and len(module.replay_buffer) == 12 + 4
    assert trainer.ckpt.all_steps() == [2, 4] and not trainer.callbacks
    rows = _rows(run)
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(v) for r in rows for k, v in r.items() if k.startswith("train/"))
    assert any("train/conservative_q1_gap" in r for r in rows) == (experiment == "cql_online")
