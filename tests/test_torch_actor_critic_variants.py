"""The port's D2RL and DenseNet policies and Q-networks held against the
JAX package on the CPU: the trunks' in-features (D2RL: hidden + input
after the first layer; DenseNet: input + i * hidden, the heads input +
num_layers * hidden), the forwards, the gradients, the actor's samples
under JAX's draws, and the MC-dropout critics under the keep masks the JAX
apply drew. Weights are flax's, randomized and carried across by
tacorl_tpu_torch/utils/convert.py.

Tolerances: forwards atol 1e-5; gradients rtol 1e-4 (atol 1e-5)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.networks import actor as j_actor
from tacorl_tpu.networks import critic as j_critic
from tacorl_tpu_torch.networks import actor as t_actor
from tacorl_tpu_torch.networks import critic as t_critic
from tacorl_tpu_torch.utils import convert
from tests.test_torch_cql import actor_draws

ATOL = 1e-5
BS, IN, HID, ACT = 4, 9, 12, 7


def _randomized(params, seed=0, scale=0.3):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (rs.randn(*np.shape(x)) * scale).astype(np.float32), params)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=1e-5)


def _grads(jloss, params, tmod, tloss, convert_fn):
    jg = convert_fn(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    tmod.zero_grad()
    tloss().backward()
    named = dict(tmod.named_parameters())
    assert set(named) == set(jg)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), jg[name].numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


POLICIES = [("D2RLPolicy", False), ("D2RLPolicy", True), ("DenseNetPolicy", False), ("DenseNetPolicy", True)]


@pytest.mark.parametrize("name,gripper", POLICIES, ids=[f"{n}-{'grip' if g else 'cont'}" for n, g in POLICIES])
def test_policy_matches_jax(name, gripper):
    x = np.random.RandomState(1).randn(BS, IN).astype(np.float32)
    kw = dict(action_dim=ACT, num_layers=3, hidden_dim=HID, discrete_gripper=gripper)
    jpol = getattr(j_actor, name)(**kw)
    params = _randomized(jax.eval_shape(jpol.init, jax.random.key(0), jnp.asarray(x))["params"], 2)
    tpol = getattr(t_actor, name)(input_dim=IN, **kw)
    tpol.load_state_dict(convert.mlp_policy_state_dict(params))
    want_in = [IN, HID + IN, HID + IN] if name == "D2RLPolicy" else [IN, IN + HID, IN + 2 * HID]
    assert [fc.in_features for fc in tpol.fc_layers] == want_in
    assert tpol.fc_mean.in_features == (HID if name == "D2RLPolicy" else IN + 3 * HID)
    jout = jpol.apply({"params": params}, jnp.asarray(x))
    tout = tpol(torch.from_numpy(x))
    for g, w in zip(tout, jout):
        _close(g, w)
    w = [np.random.RandomState(3 + i).randn(*o.shape).astype(np.float32) for i, o in enumerate(jout)]
    _grads(
        lambda p: sum(jnp.sum(o * wi) for o, wi in zip(jpol.apply({"params": p}, jnp.asarray(x)), w)),
        params, tpol, lambda: sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(tpol(torch.from_numpy(x)), w)),
        convert.mlp_policy_state_dict,
    )

    # the actor's reparameterised sample and log-density under JAX's draws
    jact = j_actor.Actor(policy=jpol, action_dim=ACT, discrete_gripper=gripper)
    tact = t_actor.Actor(tpol, ACT, discrete_gripper=gripper)
    key = jax.random.key(5)
    ja, jlp = jact.apply({"params": {"policy": params}}, jnp.asarray(x), key, False, True, method="get_actions")
    ta, tlp = tact.get_actions(torch.from_numpy(x), actor_draws(key, (BS,), ACT, gripper), reparameterize=True)
    _close(ta, ja)
    _close(tlp, jlp, atol=1e-4)


CRITICS = ["D2RLQNetwork", "DenseNetQNetwork"]


def _dropout_out(jq, params, q_in, key):
    """The JAX critic's output and its Dropout's output (a zero marks a
    dropped unit: the trunk's outputs and inputs are non-zero)."""
    out, inter = jq.apply(
        {"params": params}, jnp.asarray(q_in), rngs={"dropout": key},
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout), mutable=["intermediates"],
    )
    return out, np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0])


@pytest.mark.parametrize("name", CRITICS)
@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "mc_dropout"])
def test_q_network_matches_jax(name, dropout):
    q_in = np.random.RandomState(6).randn(BS, IN + ACT).astype(np.float32)
    kw = dict(hidden_dim=HID, num_layers=2, with_dropout=dropout)
    jq = getattr(j_critic, name)(**kw)
    rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1)}
    params = _randomized(jax.eval_shape(jq.init, rngs, jnp.asarray(q_in))["params"], 7)
    tq = getattr(t_critic, name)(input_dim=IN + ACT, **kw)
    tq.load_state_dict(convert.q_network_state_dict(params))
    trunk = HID if name == "D2RLQNetwork" else IN + ACT + 2 * HID
    assert tq.trunk_dim == trunk == tq.out.in_features
    key = jax.random.key(8)
    if dropout:
        jout, dropped = _dropout_out(jq, params, q_in, key)
        mask = torch.from_numpy(dropped != 0)
        assert mask.shape == (BS, trunk) and 0 < mask.float().mean() < 1
    else:
        jout, mask = jq.apply({"params": params}, jnp.asarray(q_in)), None
    _close(tq(torch.from_numpy(q_in), mask), jout)
    w = np.random.RandomState(9).randn(BS, 1).astype(np.float32)
    rngs = {"rngs": {"dropout": key}} if dropout else {}
    _grads(
        lambda p: jnp.sum(jq.apply({"params": p}, jnp.asarray(q_in), **rngs) * w),
        params, tq, lambda: (tq(torch.from_numpy(q_in), mask) * torch.from_numpy(w)).sum(),
        convert.q_network_state_dict,
    )
