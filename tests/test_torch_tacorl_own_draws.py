"""The TACO-RL step with the port's own draws against the JAX step with its
own, on the CPU. The parity tests hand the port JAX's draws; a run on the
card draws from the module's Philox generator instead. Here both packages
take the same weights and batch (``experiment=tacorl_fake`` at tiny
widths, the critics' heads scaled so that Q depends on the action) and each
runs its validation step at 100 seeds of its own: every metric's mean over
the seeds must agree within 4 standard errors, and its spread within a
factor of 1.5. This covers every sampling site of the step: the
posterior's plan, the actor's current and next actions, the n
conservative samples on each observation, and the random actions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.config import compose as jax_compose
from tacorl_tpu.config import get_class as jax_get_class
from tacorl_tpu.data.datamodule import BasicDataModule as JaxDataModule
from tacorl_tpu_torch.config import compose, get_class
from tacorl_tpu_torch.core.graphs import seed_generators
from tacorl_tpu_torch.utils.convert import tacorl_state_dict_from_jax
from tests.test_torch_cql import np_tree
from tests.test_torch_tacorl_cql_phase import RL, _lmp_checkpoints, play_set
from tests.test_torch_train_cli import CONFIGS
from tests.test_torch_trainer_k_step import interpret_pallas
from tests.torch_threads import share_cores

share_cores()  # the xdist workers share the cores

SEEDS = 100
OVERRIDES = RL + ["module.q_network.hidden_dim=64", "+module.q_network.init_w=1.0"]


@pytest.fixture(scope="module")
def metrics(tmp_path_factory):
    root = tmp_path_factory.mktemp("own_draws")
    play = play_set(root)
    jax_lmp, port_lmp = _lmp_checkpoints(root, play)
    jcfg = jax_compose(CONFIGS, "train", OVERRIDES + [f"data_dir={play}", f"play_lmp_dir={jax_lmp}"])
    dm_cfg = dict(jcfg["datamodule"])
    dm_cfg.pop("_target_", None)
    dm = JaxDataModule(**dm_cfg)
    dm.setup()
    batch = next(iter(dm.train_loader()))
    jmod = jax_get_class(jcfg["module"]["_target_"])(dict(jcfg["module"]))
    scalars = {"bc_phase": jnp.asarray(0.0)}
    with interpret_pallas():
        jstate = jmod.init_state(jax.random.key(7), batch)
        jval = jmod.make_val_step()
        want = [jval(jstate, batch, jax.random.key(1000 + i), scalars)[0] for i in range(SEEDS)]
    pcfg = compose(CONFIGS, "train", OVERRIDES + [f"data_dir={play}", f"play_lmp_dir={port_lmp}"])
    pmod = get_class(pcfg["module"]["_target_"])(dict(pcfg["module"]), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(tacorl_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux)))
    pval = pmod.make_val_step()
    got = []
    for i in range(SEEDS):
        seed_generators(pmod, torch.device("cpu"), 1000, i)  # as the trainer seeds a validation batch
        got.append(pval(pstate, batch, {"bc_phase": 0.0})[0])
    keys = sorted(want[0])
    assert sorted(got[0]) == keys
    return {k: (np.array([float(m[k]) for m in got]), np.array([float(m[k]) for m in want])) for k in keys}


def test_every_metric_has_the_jax_steps_distribution(metrics):
    drawn = 0
    for key, (got, want) in metrics.items():
        se = np.sqrt(got.var() / SEEDS + want.var() / SEEDS)
        if want.std() == 0:  # drawn from nothing: alpha, alpha', the batch's success rate
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=key)
            continue
        drawn += 1
        assert abs(got.mean() - want.mean()) < 4 * se, (key, got.mean(), want.mean(), se)
        assert 1 / 1.5 < got.std() / want.std() < 1.5, (key, got.std(), want.std())
    assert drawn >= 15  # the action loss, the actor loss and every critic term
