"""The CQL validation step (evaluation transforms, no update) of the
PyTorch port held against the JAX package's on the CPU, from the same
params and with JAX's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax
from tests.test_torch_cql import ACTION_DIM, B, METRICS, N_ACT, _batch, _cfg, cql_draws, np_tree

# the alpha' step is an update: the validation step reports no loss for it
VAL_METRICS = [m for m in METRICS if m != "alpha_prime_loss"]


@pytest.fixture(scope="module")
def val_pair():
    jmod = JaxCQLModule(_cfg())
    batch = _batch(seed=2)
    jstate = jmod.init_state(jax.random.key(5), batch)
    params0 = cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux))
    rng = jax.random.key(6)
    jmetrics, _ = jmod.make_val_step()(jstate, batch, rng, {"bc_phase": jnp.asarray(0.0)})

    pmod = CQLModule(_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(params0)
    # the validation step splits the key it is given (no fold-in of the step)
    pmetrics, outputs = pmod.make_val_step()(
        pstate, batch, {"bc_phase": 0.0},
        draws=cql_draws(rng, B, N_ACT, ACTION_DIM, discrete_gripper=True),
    )
    return {
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "outputs": outputs,
        "state": pstate,
        "params0": params0,
    }


def test_the_port_reports_the_jax_metrics(val_pair):
    assert set(val_pair["port"]) == set(val_pair["jax"]) == set(VAL_METRICS)


@pytest.mark.parametrize("name", VAL_METRICS)
def test_val_metric_matches_jax(val_pair, name):
    np.testing.assert_allclose(val_pair["port"][name], val_pair["jax"][name], rtol=1e-5, atol=1e-7)


def test_val_step_changes_nothing(val_pair):
    state = val_pair["state"]
    assert state.step == 0 and val_pair["outputs"] == {}
    sd = state.net.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in val_pair["params0"].items())
