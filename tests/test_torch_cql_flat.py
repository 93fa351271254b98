"""Flat goal-conditioned CQL of the port held against the JAX package on
the CPU, one train step and one validation step per case, from the same
converted weights and with JAX's draws:

  * ``state_based``: flat concatenated observations, no encoders;
  * ``vector``: the ``experiment=cql_fake_state`` layout, robot_obs and
    scene_obs vectors through the LateFusion path with ``rgb_static``
    encoders configured but unused, at tiny widths;
  * ``dropout``: the visual ``experiment=cql_fake`` layout with MC-dropout
    critics, the JAX step's dropout masks read out of its own critic
    applies and passed to the port.

Tolerances: metrics rtol 1e-5, gradients atol 1e-5 + rtol 1e-4, post-Adam
params atol 2.5 lr. Also the VIB encoder head, the VIB regularizer (the
JAX step's refusal, the port's term against the JAX one), and
FlatPolicyAgent on vector observations."""

import functools

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.envs.fake_calvin import FakeCalvinEnv as JaxFakeCalvinEnv
from tacorl_tpu.evaluation import agents as jax_agents
from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.networks.encoders import LMPVisionEncoder as JaxLMPVisionEncoder
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.envs.fake_calvin import FakeCalvinEnv
from tacorl_tpu_torch.evaluation import agents, rollout_manager
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.networks.encoders import LMPVisionEncoder
from tacorl_tpu_torch.utils.convert import (
    cql_state_dict_from_jax,
    visual_actor_state_dict,
    visual_critic_state_dict,
    vision_encoder_state_dict,
)
from tests.test_torch_cql import METRICS, _t, _cfg, cql_draws, nested_aug_draws, np_tree

B, N_ACT, LR, ACTION_DIM = 3, 3, 1e-3, 7
VAL_METRICS = [m for m in METRICS if m != "alpha_prime_loss"]
VECTOR_DIMS = {"robot_obs": 15, "scene_obs": 24}


def _small(cfg):
    cfg.update(
        action_dim=ACTION_DIM, actor_lr=LR, critic_lr=LR, n_action_samples=N_ACT,
        with_lagrange=True, reward_scale=10.0, bc_epochs=0,
        policy={"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
        q_network={"num_layers": 2, "hidden_dim": 16},
    )
    return cfg


def state_cfg():
    return _small({"state_based": True, "state_dim": 6, "goal_dim": 3})


def vector_cfg(dropout=False):
    enc = {"networks": {"rgb_static": {
        "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
        "latent_dim": 8, "hidden_dim": 16, "compute_dtype": None,
    }}}
    cfg = _small({
        "obs_modalities": ["robot_obs", "scene_obs"],
        "goal_modalities": ["robot_obs", "scene_obs"],
        "vector_dims": dict(VECTOR_DIMS),
        "actor_encoder": enc, "critic_encoder": enc,
        "goal_encoder": {"hidden_size": 16},
        "transforms": {"robot_obs": {"kind": "vector"}, "scene_obs": {"kind": "vector"}},
    })
    cfg["q_network"]["with_dropout"] = dropout
    return cfg


def dropout_cfg():
    cfg = _cfg()
    cfg["q_network"] = {"num_layers": 2, "hidden_dim": 16, "with_dropout": True}
    return cfg


def _transition(obs_fn, seed):
    rs = np.random.RandomState(seed)
    goal = obs_fn(rs)
    return {
        "observations": {"observation": obs_fn(rs), "goal": goal},
        "actions": np.clip(rs.randn(B, ACTION_DIM), -1, 1).astype(np.float32),
        "next_observations": {"observation": obs_fn(rs), "goal": goal},
        "rewards": np.asarray([1.0, 0.0, 0.0], np.float32),
        "terminals": np.asarray([1.0, 0.0, 0.0], np.float32),
    }


def vector_batch(seed=0):
    return _transition(
        lambda rs: {k: rs.randn(B, d).astype(np.float32) for k, d in VECTOR_DIMS.items()}, seed
    )


def state_batch(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "observations": rs.randn(B, 9).astype(np.float32),
        "actions": np.clip(rs.randn(B, ACTION_DIM), -1, 1).astype(np.float32),
        "next_observations": rs.randn(B, 9).astype(np.float32),
        "rewards": np.asarray([1.0, 0.0, 0.0], np.float32),
        "terminals": np.asarray([1.0, 0.0, 0.0], np.float32),
    }


def image_batch(seed=0):
    from tests.test_torch_cql import _batch

    return _batch(seed)


# case -> (config, batch, image modalities of the LateFusion, JAX augmentation)
CASES = {
    "state_based": (state_cfg, state_batch, (), False),
    "vector": (vector_cfg, vector_batch, (), False),
    "dropout": (dropout_cfg, image_batch, ("rgb_static",), True),
}


def jax_dropout_mask(jmod, q_params, key, rows):
    """The keep mask flax's Dropout draws in a critic apply of ``rows`` rows
    with dropout key ``key``, read out of the apply itself: a probe whose
    last trunk layer outputs silu(1) everywhere, so a zero marks a drop."""
    q = dict(q_params["critic"]["q_network"])
    last = f"fc{sum(k.startswith('fc') for k in q) - 1}"
    q[last] = {"kernel": jnp.zeros_like(q[last]["kernel"]), "bias": jnp.ones_like(q[last]["bias"])}
    probe = flax.core.unfreeze(dict(q_params))
    probe["critic"] = {"q_network": q}
    in_dim = q["fc0"]["kernel"].shape[0]
    _, inter = jmod.critic_net.apply(
        {"params": probe},
        jnp.zeros((rows, in_dim - ACTION_DIM)), jnp.zeros((rows, ACTION_DIM)),
        method=lambda net, e, a: net.critic(e, a),
        rngs={"dropout": key},
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout),
        mutable=["intermediates"],
    )
    out = inter["intermediates"]["critic"]["q_network"]["Dropout_0"]["__call__"][0]
    return torch.from_numpy(np.asarray(out) != 0)


def step_draws(jmod, params0, key, aug: bool):
    """The draws of one JAX CQL update from its key (after the step's
    fold-in), dropout masks included when the critics have dropout."""
    draws = cql_draws(key, B, N_ACT, ACTION_DIM, discrete_gripper=True)
    if aug:
        k_aug = jax.random.split(key, 7)[0]
        draws["aug_obs"] = nested_aug_draws(k_aug, B)
        draws["aug_next_obs"] = nested_aug_draws(jax.random.fold_in(k_aug, 1), B)
    if jmod._has_critic_dropout:
        k_drop = jax.random.split(key, 7)[6]
        draws["dropout"] = {
            rows: jax_dropout_mask(jmod, params0["q1"], k_drop, rows) for rows in (B, N_ACT * B)
        }
    return draws


def _group_grads(tree, name, mods):
    if name == "actor":
        return visual_actor_state_dict(tree, mods)
    if name in ("q1", "q2"):
        return visual_critic_state_dict(tree, mods)
    return {"": torch.from_numpy(np.asarray(tree, np.float32).reshape(1))}


def _port_group_names(net, name):
    if name in ("actor", "q1", "q2"):
        return [n for n, p in getattr(net, name).named_parameters() if p.requires_grad]
    return [""]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cfg_fn, batch_fn, mods, aug = CASES[request.param]
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxCQLModule(cfg_fn())
        batch = batch_fn()
        jstate = jmod.init_state(jax.random.key(1), batch)
        params0, aux0 = np_tree(jstate.params), np_tree(jstate.aux)
        jgrads = {}
        update_group = jmod.optimizer.update_group

        def recording(name, grads, opt_state, params):
            jax.debug.callback(lambda g: jgrads.__setitem__(name, np_tree(g)), grads)
            return update_group(name, grads, opt_state, params)

        jmod.optimizer.update_group = recording
        rng, val_rng = jax.random.key(0), jax.random.key(7)
        jval, _ = jmod.make_val_step()(jstate, batch, val_rng, {"bc_phase": jnp.asarray(0.0)})
        jstate1, jmetrics = jmod.make_train_step()(
            jax.tree.map(jnp.copy, jstate), batch, rng, {"bc_phase": jnp.asarray(0.0)}
        )
        jax.block_until_ready(jstate1.params)
    finally:
        pallas_aug.pallas_augment_tail = tail

    pmod = CQLModule(cfg_fn(), device="cpu")
    pstate = pmod.init_state(0)
    sd0 = cql_state_dict_from_jax(params0, aux0, mods)
    pmod.net.load_state_dict(sd0)
    pval, _ = pmod.make_val_step()(
        pstate, batch, {"bc_phase": 0.0}, draws=step_draws(jmod, params0, val_rng, aug=False)
    )
    pgrads = {}
    step_group = pstate.optimizer.step_group

    def recording_port(name, grads):
        pgrads[name] = dict(zip(_port_group_names(pmod.net, name), [g.clone() for g in grads]))
        return step_group(name, grads)

    pstate.optimizer.step_group = recording_port
    draws = step_draws(jmod, params0, jax.random.fold_in(rng, 0), aug)
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"bc_phase": 0.0}, draws=draws)
    return {
        "name": request.param,
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax_val": {k: float(v) for k, v in jval.items()},
        "port_val": {k: float(v) for k, v in pval.items()},
        "jax_grads": {k: _group_grads(v, k, mods) for k, v in jgrads.items()},
        "port_grads": pgrads,
        "jax_sd1": cql_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux), mods),
        "port_sd1": pstate.net.state_dict(),
        "sd0": sd0,
        "draws": draws,
    }


def test_the_port_builds_the_jax_parameter_set(case):
    """Same keys and shapes as the converted JAX tree: unused rgb_static
    encoders add nothing, a state-based net has no encoders."""
    got = {k: tuple(v.shape) for k, v in case["port_sd1"].items()}
    want = {k: tuple(v.shape) for k, v in case["sd0"].items()}
    assert got == want
    if case["name"] != "dropout":
        assert not any(".encoder." in k for k in got)
    if case["name"] == "state_based":
        assert not any("goal_encoder" in k for k in got)


def test_dropout_masks_come_from_the_jax_step(case):
    if case["name"] != "dropout":
        assert "dropout" not in case["draws"]
        return
    masks = case["draws"]["dropout"]
    assert set(masks) == {B, N_ACT * B}
    for rows, mask in masks.items():
        assert mask.shape == (rows, 16) and 0 < mask.float().mean() < 1


@pytest.mark.parametrize("name", METRICS)
def test_train_step_metric_matches_jax(case, name):
    assert set(case["port"]) == set(case["jax"]) == set(METRICS)
    np.testing.assert_allclose(case["port"][name], case["jax"][name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", VAL_METRICS)
def test_val_step_metric_matches_jax(case, name):
    assert set(case["port_val"]) == set(case["jax_val"]) == set(VAL_METRICS)
    np.testing.assert_allclose(case["port_val"][name], case["jax_val"][name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("group", ["actor", "q1", "q2", "log_alpha", "log_alpha_prime"])
def test_train_step_grads_match_jax(case, group):
    want, got = case["jax_grads"][group], case["port_grads"][group]
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_post_step_params_match_jax(case):
    for name, want in case["jax_sd1"].items():
        np.testing.assert_allclose(
            case["port_sd1"][name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name
        )


# -- the VIB head and the VIB regularizer -------------------------------------


def test_vib_head_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.rand(2, 48, 48, 3).astype(np.float32)
    jenc = JaxLMPVisionEncoder(latent_dim=8, vib=True, compute_dtype=None)
    key = jax.random.key(2)
    variables = jenc.init({"params": key, "sample": key}, jnp.asarray(x))
    jdist = jenc.apply(variables, jnp.asarray(x), method="get_dist")
    k_sample = jax.random.key(3)
    # the explicit key is the one DiagNormal.sample draws eps from
    jsample = jenc.apply(variables, jnp.asarray(x), rng=k_sample)
    eps = _t(jax.random.normal(k_sample, jdist.mean.shape))

    penc = LMPVisionEncoder(latent_dim=8, vib=True, compute_dtype=None)
    sd = vision_encoder_state_dict(np_tree(variables["params"]))
    assert {"fc_mean.weight", "fc_mean.bias", "fc_log_std.weight", "fc_log_std.bias"} <= set(sd)
    penc.load_state_dict(sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        pdist = penc.get_dist(xt)
        psample = penc(xt, eps=eps)
    np.testing.assert_allclose(pdist.mean.numpy(), np.asarray(jdist.mean), atol=1e-5)
    np.testing.assert_allclose(pdist.std.numpy(), np.asarray(jdist.std), atol=1e-5)
    np.testing.assert_allclose(psample.numpy(), np.asarray(jsample), atol=1e-5)


def _vib_cfg():
    cfg = _cfg()
    cfg["with_vib"] = True
    cfg["critic_encoder"]["networks"]["rgb_static"]["vib"] = True
    return cfg


def test_vib_regularizer_raises_in_both_packages():
    """The JAX package supplies no "sample" rng to the VIB encoder's
    applies, so its train step cannot run. The port supplies the draw
    (ROADMAP Queue 3, repaired on the port's side) and its regularizer is
    the JAX one: a validation step's ``q1_vib_loss`` / ``q2_vib_loss``
    equal ``vib_coefficient * KL(get_vib_distribution(obs) || N(0, I))``
    of the JAX critics on the same weights and observations (rtol 1e-5);
    ``tests/test_torch_cql_variants.py`` holds a whole step."""
    from tacorl_tpu.core.distributions import DiagNormal, kl_diag_normal
    from tests.test_torch_cql import _batch

    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxCQLModule(_vib_cfg())
        jstate = jmod.init_state(jax.random.key(0), _batch())
        with pytest.raises(flax.errors.InvalidRngError, match="sample"):
            jmod.make_train_step()(jstate, _batch(), jax.random.key(1), {"bc_phase": jnp.asarray(0.0)})
    finally:
        pallas_aug.pallas_augment_tail = tail
    obs = jmod.transforms(jax.random.key(2), _batch()["observations"], train=False)
    want = {}
    for q in ("q1", "q2"):
        dist = jmod.critic_net.apply({"params": jstate.params[q]}, obs, method="get_vib_distribution")
        prior = DiagNormal(jnp.zeros_like(dist.mean), jnp.ones_like(dist.std))
        want[q] = float(0.01 * kl_diag_normal(dist, prior).mean())

    pmod = CQLModule(_vib_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux)))
    metrics, _ = pmod.make_val_step()(pstate, _batch(), {"bc_phase": 0.0})
    for q, value in want.items():
        assert value > 0
        np.testing.assert_allclose(float(metrics[f"{q}_vib_loss"]), value, rtol=1e-5)


# -- the flat agent on vector observations ------------------------------------


@pytest.fixture(scope="module")
def vector_agents():
    jmod = JaxCQLModule(vector_cfg())
    jstate = jmod.init_state(jax.random.key(4), vector_batch())
    pmod = CQLModule(vector_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(np_tree(jstate.params), np_tree(jstate.aux), ()))
    return jax_agents.FlatPolicyAgent(jmod, jstate), agents.make_agent(pmod, pstate)


def _vector_env(cls, steps=20):
    mods = ["robot_obs", "scene_obs"]
    return cls(image_hw=64, max_episode_steps=steps, modalities=mods, goal_modalities=mods, seed=0)


def test_flat_agent_on_vector_observations_matches_jax(vector_agents):
    jagent, (pagent, manager_cls) = vector_agents
    assert manager_cls is rollout_manager.RLRollout
    env = _vector_env(JaxFakeCalvinEnv)
    obs = env.reset(task_info={"task": "open_drawer", "index": 0})
    for i in range(12):
        want = jagent.act(obs, jax.random.key(i))
        got = pagent.act(obs)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=f"step {i}")
        obs, _, done, _ = env.step(want)
        if done:
            break


def test_rl_rollout_runs_on_a_vector_env(vector_agents):
    _, (pagent, manager_cls) = vector_agents
    out = manager_cls(seed=0).episode_rollout(
        pagent, _vector_env(FakeCalvinEnv, 10), {"task_info": {"task": "lift_block", "index": 1}}
    )
    assert out["episode_length"] <= 10
