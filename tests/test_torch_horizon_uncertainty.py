"""The uncertainty-gated goal horizon of the port held against the JAX
package on the CPU: the MC-dropout std of both critics equal to JAX's for
the same dropout masks (read out of the JAX applies), and the counterparts
of tests/test_horizon_curriculum.py through ``python -m
tacorl_tpu_torch.train``: linear growth on ``experiment=cql_fake``, and
uncertainty growth that persists across a resume, where the BC warm-start
runs again from epoch 0 as it does in the JAX trainer."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.callbacks.horizon_uncertainty import (
    IncreaseHorizonUncertainty as JaxIncreaseHorizonUncertainty,
)
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch import train
from tacorl_tpu_torch.callbacks import Callback, IncreaseHorizonUncertainty
from tacorl_tpu_torch.data.expert_play import generate_expert_play
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import np_tree
from tests.test_torch_cql_flat import jax_dropout_mask, vector_batch, vector_cfg
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

PASSES = 3


@pytest.fixture(scope="module")
def mc_pair():
    jmod = JaxCQLModule(vector_cfg(dropout=True))
    batch = vector_batch(seed=3)
    jstate = jmod.init_state(jax.random.key(2), batch)
    key = jax.random.key(11)
    jcb = JaxIncreaseHorizonUncertainty(forward_passes=PASSES)
    want = float(jcb._build_mc_fn(jmod)(jstate.params, batch, key))
    # the JAX callback's key for pass i of critic `name`
    masks = [
        jax_dropout_mask(
            jmod, jstate.params[name], jax.random.fold_in(key, i * 2 + stable_fold(name) % 97), 3
        )
        for i in range(PASSES) for name in ("q1", "q2")
    ]
    pmod = CQLModule(vector_cfg(dropout=True), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux), ()))
    return pmod, pstate, batch, masks, want


def test_mc_std_matches_jax_for_the_same_masks(mc_pair):
    pmod, pstate, batch, masks, want = mc_pair
    cb = IncreaseHorizonUncertainty(forward_passes=PASSES)
    got = cb.mc_std(pmod, pstate.net, batch, masks=masks)
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_mc_std_draws_a_mask_per_forward(mc_pair):
    pmod, pstate, batch, masks, _ = mc_pair
    cb = IncreaseHorizonUncertainty(forward_passes=PASSES)
    one_mask = cb.mc_std(pmod, pstate.net, batch, masks=[masks[0]] * len(masks))
    drawn = cb.mc_std(pmod, pstate.net, batch, generator=torch.Generator().manual_seed(0))
    # the same mask for every forward leaves only the two critics' spread
    assert 0 < float(one_mask) < float(drawn)
    again = cb.mc_std(pmod, pstate.net, batch, generator=torch.Generator().manual_seed(0))
    assert float(again) == float(drawn)


# -- through python -m tacorl_tpu_torch.train ---------------------------------------


def _series(run_dir, key):
    vals = []
    with open(Path(run_dir) / "metrics.jsonl") as f:
        for line in f:
            d = json.loads(line)
            if key in d:
                vals.append((d["step"], d[key]))
    return vals


@pytest.fixture(scope="module")
def tiny_play(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny_play")
    generate_expert_play(root, n_train_episodes=3, n_val_episodes=2, tasks_per_episode=2, seed=7)
    return root


TINY_NETS = [
    "+device=cpu",
    "module.actor_encoder.networks.rgb_static.latent_dim=8",
    "module.actor_encoder.networks.rgb_static.hidden_dim=16",
    "module.critic_encoder.networks.rgb_static.latent_dim=8",
    "module.critic_encoder.networks.rgb_static.hidden_dim=16",
    "module.policy.hidden_dim=16",
    "module.policy.num_layers=2",
    "module.q_network.hidden_dim=16",
    "module.q_network.num_layers=2",
    "module.goal_encoder.hidden_size=16",
    "module.bc_epochs=1",
    "datamodule.batch_size=8",
    "trainer.log_every_n_steps=5",
    "callbacks.rollout.num_rollouts_per_task=1",
    "callbacks.rollout.max_seq_len=16",
    "env.max_episode_steps=12",
]


def test_linear_horizon_grows_in_real_training(tiny_play, tmp_path):
    run_dir = tmp_path / "run"
    train.main([
        "experiment=cql_fake", f"data_dir={tiny_play}", f"run_dir={run_dir}",
        "trainer.max_steps=40", "datamodule.dataset.initial_horizon=4",
        "datamodule.dataset.horizon_step=4", *TINY_NETS,
    ])
    horizons = [h for _, h in _series(run_dir, "train/goal_horizon")]
    assert horizons[0] == 4.0, horizons
    assert horizons[1] - horizons[0] == 4.0, horizons
    assert horizons[-1] > horizons[0], horizons
    assert _series(run_dir, "val_accuracy"), "the rollout monitor did not run"


class _EpochProbe(Callback):
    """Each epoch's (epoch, bc_phase) as the module sees it."""

    def __init__(self):
        self.seen = []

    def on_epoch_start(self, trainer, module, epoch):
        self.seen.append((epoch, module.step_scalars()["bc_phase"]))


def test_uncertainty_horizon_persists_across_resume(tiny_play, tmp_path):
    run_dir = tmp_path / "run"
    overrides = [
        "experiment=cql_fake", f"data_dir={tiny_play}", f"run_dir={run_dir}",
        "callbacks/increase_horizon=uncertainty",
        "callbacks.increase_horizon.std_threshold=1e9",
        "callbacks.increase_horizon.forward_passes=2",
        "module.q_network.with_dropout=true", "module.q_network.dropout_p=0.5",
        "datamodule.dataset.initial_horizon=4", "datamodule.dataset.horizon_step=4",
        *TINY_NETS,
    ]
    first_probe, resumed_probe = _EpochProbe(), _EpochProbe()
    trainer = train.main(overrides + ["trainer.max_steps=20"], callbacks=[first_probe])
    assert type(trainer.callbacks[0]).__name__ == "IncreaseHorizonUncertainty"
    first = [h for _, h in _series(run_dir, "train/goal_horizon")]
    assert first and first[0] == 4.0 and first[-1] > 4.0, first
    assert all(s > 0 for _, s in _series(run_dir, "train/Q_avg_std"))
    state = json.loads((run_dir / "callbacks_state.json").read_text())
    assert state["IncreaseHorizonUncertainty"]["current_horizon"] == first[-1] + 4.0

    train.main(overrides + ["trainer.max_steps=40"], callbacks=[resumed_probe])
    after = [h for _, h in _series(run_dir, "train/goal_horizon")][len(first):]
    assert after and after[0] >= first[-1], (first, after)
    assert after[-1] > after[0], after
    # both trainers count epochs from 0 again on a resume: the BC warm-start
    # (bc_epochs=1) runs again, as in the JAX package
    assert first_probe.seen[:2] == [(0, 1.0), (1, 0.0)]
    assert resumed_probe.seen[0] == (0, 1.0)
