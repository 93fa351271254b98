"""The CQL options the main test leaves out, held against the JAX package
on the CPU: the DR3 feature-dot regularizer and the soft (non-
deterministic) Bellman backup, in one train step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import (
    ACTION_DIM,
    B,
    LR,
    METRICS,
    N_ACT,
    _batch,
    _cfg,
    assert_params_agree,
    cql_draws,
    nested_aug_draws,
    np_tree,
)

DR3_METRICS = METRICS + ["q1_dr3_loss", "q2_dr3_loss"]


def _dr3_cfg():
    cfg = _cfg()
    cfg.update(with_dr3=True, dr3_coefficient=0.5, deterministic_backup=False)
    return cfg


@pytest.fixture(scope="module")
def step_pair():
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxCQLModule(_dr3_cfg())
        batch = _batch(seed=1)
        jstate = jmod.init_state(jax.random.key(3), batch)
        params0, aux0 = np_tree(jstate.params), np_tree(jstate.aux)
        rng = jax.random.key(4)
        jstate1, jmetrics = jmod.make_train_step()(
            jstate, batch, rng, {"bc_phase": jnp.asarray(0.0)}
        )
    finally:
        pallas_aug.pallas_augment_tail = tail

    step_key = jax.random.fold_in(rng, 0)
    k_aug = jax.random.split(step_key, 7)[0]
    draws = cql_draws(step_key, B, N_ACT, ACTION_DIM, discrete_gripper=True)
    draws["aug_obs"] = nested_aug_draws(k_aug, B)
    draws["aug_next_obs"] = nested_aug_draws(jax.random.fold_in(k_aug, 1), B)
    pmod = CQLModule(_dr3_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(params0, aux0))
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"bc_phase": 0.0}, draws=draws)
    return {
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "port_sd1": pstate.net.state_dict(),
        "jax_sd1": cql_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux)),
    }


def test_the_port_reports_the_jax_metrics(step_pair):
    assert set(step_pair["port"]) == set(step_pair["jax"]) == set(DR3_METRICS)


@pytest.mark.parametrize("name", DR3_METRICS)
def test_metric_matches_jax(step_pair, name):
    np.testing.assert_allclose(step_pair["port"][name], step_pair["jax"][name], rtol=1e-5, atol=1e-7)


def test_post_step_params_match_jax(step_pair):
    for name, want in step_pair["jax_sd1"].items():
        np.testing.assert_allclose(
            step_pair["port_sd1"][name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name
        )
    assert_params_agree(step_pair["port_sd1"], step_pair["jax_sd1"], LR)
