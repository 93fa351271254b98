"""One whole CQL train step of the PyTorch port held against the JAX
package at a tiny visual config with a discrete gripper and the Lagrange
alpha' (``__graft_entry__._cql_module`` with float32 convolutions): the
same initial params (carried across by tacorl_tpu_torch/utils/convert.py),
the same batch, and JAX's own random draws (DrQ shifts and jitter factors
of every image leaf, the actor's normals and Gumbel uniforms of each key,
the random actions) injected into the port; once in the BC phase and once
in the Q phase.

The JAX step runs its Pallas jitter tail in interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax

B, HW, PAD, N_ACT, LR = 3, 48, 2, 3, 1e-3
ACTION_DIM = 7


def _cfg():
    enc = {
        "networks": {
            "rgb_static": {
                "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
                "latent_dim": 8, "hidden_dim": 16, "compute_dtype": None,
            }
        }
    }
    return {
        "action_dim": ACTION_DIM,
        "actor_lr": LR,
        "critic_lr": LR,
        "obs_modalities": ["rgb_static"],
        "goal_modalities": ["rgb_static"],
        "actor_encoder": enc,
        "critic_encoder": enc,
        "goal_encoder": {"hidden_size": 16},
        "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "n_action_samples": N_ACT,
        "with_lagrange": True,
        "reward_scale": 10.0,
        "bc_epochs": 0,
        "transforms": {
            "rgb_static": {"kind": "rgb", "size": [HW, HW], "pad": PAD, "use_pallas": True}
        },
    }


def _batch(seed=0):
    """__graft_entry__._cql_batch with one reward and one terminal set."""
    rs = np.random.RandomState(seed)
    img = lambda: rs.randint(0, 256, (B, HW, HW, 3), dtype=np.uint8)  # noqa: E731
    goal = img()
    return {
        "observations": {"observation": {"rgb_static": img()}, "goal": {"rgb_static": goal}},
        "actions": np.clip(rs.randn(B, ACTION_DIM), -1, 1).astype(np.float32),
        "next_observations": {
            "observation": {"rgb_static": img()}, "goal": {"rgb_static": goal},
        },
        "rewards": np.asarray([1.0, 0.0, 0.0], np.float32),
        "terminals": np.asarray([0.0, 1.0, 0.0], np.float32),
    }


def _t(x):
    return torch.from_numpy(np.array(x))


def aug_draws(key, n, pad=PAD):
    """The draws DeviceTransforms._pallas_rgb_train makes from a leaf key."""
    k_shift, k_jit = jax.random.split(key)
    return {
        "shifts": _t(jax.random.randint(k_shift, (n, 2), 0, 2 * pad + 1)),
        "factors": _t(pallas_aug.sample_jitter_factors(k_jit, n)),
    }


def leaf_key(key, *path):
    """DeviceTransforms' per-leaf key: one stable fold per path element."""
    for p in path:
        key = jax.random.fold_in(key, stable_fold(p))
    return key


def nested_aug_draws(key, n, pad=PAD):
    return {
        part: {"rgb_static": aug_draws(leaf_key(key, part, "rgb_static"), n, pad)}
        for part in ("observation", "goal")
    }


def actor_draws(key, shape, action_dim, discrete_gripper):
    """The normals (and Gumbel uniforms) networks/actor.py draws from key."""
    if not discrete_gripper:
        return {"eps": _t(jax.random.normal(key, shape + (action_dim,)))}
    k1, k2 = jax.random.split(key)
    return {
        "eps": _t(jax.random.normal(k1, shape + (action_dim - 1,))),
        "gumbel_u": _t(jax.random.uniform(k2, shape + (2,), minval=1e-6, maxval=1.0 - 1e-6)),
    }


def cql_draws(k_cql, bs, n, action_dim, discrete_gripper):
    """The draws CQLModule._compute_update makes from its step key."""
    _, k_curr, k_next_bellman, k_curr_n, k_next_n, k_rand, _ = jax.random.split(k_cql, 7)
    return {
        "curr": actor_draws(k_curr, (bs,), action_dim, discrete_gripper),
        "next_bellman": actor_draws(k_next_bellman, (bs,), action_dim, discrete_gripper),
        "curr_n": actor_draws(k_curr_n, (n, bs), action_dim, discrete_gripper),
        "next_n": actor_draws(k_next_n, (n, bs), action_dim, discrete_gripper),
        "rand": _t(jax.random.uniform(k_rand, (bs * n, action_dim), minval=-1.0, maxval=1.0)),
    }


def np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX module, its initial state and its jitted train step, built
    once; the Pallas tail runs in interpret mode."""
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxCQLModule(_cfg())
        jstate = jmod.init_state(jax.random.key(1), _batch())
        yield jmod, jstate, jmod.make_train_step()
    finally:
        pallas_aug.pallas_augment_tail = tail


@pytest.fixture(scope="module", params=[1.0, 0.0], ids=["bc_phase", "q_phase"])
def step_pair(request, jax_side):
    jmod, jstate0, jstep = jax_side
    bc_phase = request.param
    batch = _batch()
    params0, aux0 = np_tree(jstate0.params), np_tree(jstate0.aux)
    jstate = jax.tree.map(jnp.copy, jstate0)
    rng = jax.random.key(0)
    jstate1, jmetrics = jstep(jstate, batch, rng, {"bc_phase": jnp.asarray(bc_phase)})

    step_key = jax.random.fold_in(rng, 0)
    k_aug = jax.random.split(step_key, 7)[0]
    draws = cql_draws(step_key, B, N_ACT, ACTION_DIM, discrete_gripper=True)
    draws["aug_obs"] = nested_aug_draws(k_aug, B)
    draws["aug_next_obs"] = nested_aug_draws(jax.random.fold_in(k_aug, 1), B)

    pmod = CQLModule(_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(params0, aux0))
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"bc_phase": bc_phase}, draws=draws)
    return {
        "jax_metrics": {k: float(v) for k, v in jmetrics.items()},
        "jax_params1": cql_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux)),
        "port_metrics": {k: float(v) for k, v in pmetrics.items()},
        "port_state": pstate,
    }


METRICS = ["alpha", "alpha_loss", "actor_loss", "alpha_prime", "alpha_prime_loss"] + [
    m.format(q)
    for q in ("q1", "q2")
    for m in (
        "{}_data", "bellman_{}_loss", "{}_random", "{}_policy",
        "conservative_{}_loss", "conservative_{}_gap", "{}_loss",
    )
]


def test_the_port_reports_the_jax_metrics(step_pair):
    assert set(step_pair["port_metrics"]) == set(step_pair["jax_metrics"]) == set(METRICS)


@pytest.mark.parametrize("name", METRICS)
def test_train_step_metric_matches_jax(step_pair, name):
    # rtol 1e-5: float32 sums taken in another order
    np.testing.assert_allclose(
        step_pair["port_metrics"][name], step_pair["jax_metrics"][name], rtol=1e-5, atol=1e-7
    )


@pytest.mark.parametrize(
    "group", ["actor", "q1", "q2", "target_q1", "target_q2", "log_alpha", "log_alpha_prime"]
)
def test_post_step_params_match_jax(step_pair, group):
    state = step_pair["port_state"]
    assert state.step == 1
    sd = state.net.state_dict()
    expected = {k: v for k, v in step_pair["jax_params1"].items() if k.split(".")[0] == group}
    assert expected and set(expected) == {k for k in sd if k.split(".")[0] == group}
    for name, want in expected.items():
        # Adam's first step moves each weight by about +-lr
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name)


def test_post_step_params_agree_far_below_the_step(step_pair):
    """A weight whose gradient is near zero may step the other way on
    rounding; all but a few must agree to a hundredth of a step."""
    assert_params_agree(step_pair["port_state"].net.state_dict(), step_pair["jax_params1"], LR)


def assert_params_agree(port_sd, jax_sd, lr):
    diff = np.concatenate([np.abs(port_sd[k].numpy() - v.numpy()).ravel() for k, v in jax_sd.items()])
    assert np.mean(diff > lr / 100) < 1e-3, (diff.max(), np.mean(diff > lr / 100))
