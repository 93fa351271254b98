"""One whole visual CQL train step of the port with a ``D2RLPolicy`` actor,
``DenseNetQNetwork`` critics and the VIB regularizer (``with_vib`` on a
``vib: true`` critic encoder), held against the JAX package's step at a
tiny config: the same initial params (carried across by
tacorl_tpu_torch/utils/convert.py), the same batch and JAX's own draws.

The JAX module cannot run VIB: it supplies no ``"sample"`` rng to the
VIB encoder's critic applies (ROADMAP Queue 3; ``test_torch_cql_flat.py``
shows the error). ``VibCQLModule`` below supplies one key a step, the
repair the port makes on its side, and the port gets the normals flax
derives from it: the same for every critic apply of the step (the path
and the call order within an apply fix them), one for the observation's
encoding and one for the goal's, read back from the encoder's samples.
The Pallas jitter tail runs in interpret mode.

Tolerances: metrics rtol 1e-5; gradients rtol 1e-4 (atol 1e-5);
post-step params atol 2.5 lr."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.modules.cql import CQLModule as JaxCQLModule
from tacorl_tpu.networks.encoders import LMPVisionEncoder as JaxLMPVisionEncoder
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu_torch.modules.cql import CQLModule
from tacorl_tpu_torch.utils.convert import cql_state_dict_from_jax, visual_actor_state_dict, visual_critic_state_dict
from tests.test_torch_cql import ACTION_DIM, LR, METRICS, N_ACT, B, _batch, _cfg, cql_draws, nested_aug_draws, np_tree

MODS = ("rgb_static",)


class VibCQLModule(JaxCQLModule):
    """The JAX CQL module with the ``"sample"`` rng its VIB critic applies
    lack: one key a step, ``fold_in(step key, 99)``."""

    _sample_key = None

    def _compute_update(self, state, batch, rng, scalars, optimize, apply_transforms=True):
        self._sample_key = jax.random.fold_in(rng, 99)
        try:
            return super()._compute_update(state, batch, rng, scalars, optimize, apply_transforms)
        finally:
            self._sample_key = None

    def _critic_rngs(self):
        rngs = dict(super()._critic_rngs().get("rngs", {}))
        rngs["sample"] = self._sample_key
        return {"rngs": rngs}


def variant_cfg():
    cfg = _cfg()
    cfg["policy"]["_target_"] = "tacorl_tpu.networks.actor.D2RLPolicy"
    cfg["q_network"]["_target_"] = "tacorl_tpu.networks.critic.DenseNetQNetwork"
    cfg["critic_encoder"] = {"networks": {"rgb_static": {**cfg["critic_encoder"]["networks"]["rgb_static"],
                                                         "vib": True}}}
    cfg["with_vib"] = True
    cfg["vib_coefficient"] = 0.05
    return cfg


def vib_draws(jmod, q_params, obs, key):
    """The normals of the VIB encoder's two samples in a critic apply with
    ``"sample"`` key ``key`` (observation, then goal): each sample less the
    head's mean, over its std."""
    samples = jmod.critic_net.apply(
        {"params": q_params}, obs, method="get_emb_representation", rngs={"sample": key},
        capture_intermediates=lambda mdl, _: isinstance(mdl, JaxLMPVisionEncoder), mutable=["intermediates"],
    )[1]["intermediates"]["encoder"]["encoders_0_1"]["__call__"]
    out = {}
    for part, sample in zip(("observation", "goal"), samples):
        dist = jmod.critic_net.apply(
            {"params": q_params}, obs[part]["rgb_static"],
            method=lambda net, x: net.encoder.networks["rgb_static"].get_dist(x),
        )
        out[part] = {"rgb_static": torch.from_numpy(np.array((sample - dist.mean) / dist.std))}
    return out


@pytest.fixture(scope="module")
def step_pair():
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = VibCQLModule(variant_cfg())
        batch = _batch()
        jstate = jmod.init_state(jax.random.key(1), batch)
        params0, aux0 = np_tree(jstate.params), np_tree(jstate.aux)
        jgrads, update_group = {}, jmod.optimizer.update_group

        def recording(name, grads, opt_state, params):
            jax.debug.callback(lambda g: jgrads.__setitem__(name, np_tree(g)), grads)
            return update_group(name, grads, opt_state, params)

        jmod.optimizer.update_group = recording
        rng = jax.random.key(0)
        jstate1, jmetrics = jmod.make_train_step()(jax.tree.map(jnp.copy, jstate), batch, rng,
                                                   {"bc_phase": jnp.asarray(0.0)})
        jax.block_until_ready(jstate1.params)
        step_key = jax.random.fold_in(rng, 0)
        k_aug = jax.random.split(step_key, 7)[0]
        obs = jmod.transforms(k_aug, batch["observations"], train=False)
        vib = vib_draws(jmod, jstate.params["q1"], obs, jax.random.fold_in(step_key, 99))
    finally:
        pallas_aug.pallas_augment_tail = tail

    draws = cql_draws(step_key, B, N_ACT, ACTION_DIM, discrete_gripper=True)
    draws["aug_obs"] = nested_aug_draws(k_aug, B)
    draws["aug_next_obs"] = nested_aug_draws(jax.random.fold_in(k_aug, 1), B)
    draws["vib"] = vib
    pmod = CQLModule(variant_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(cql_state_dict_from_jax(params0, aux0))
    pgrads, step_group = {}, pstate.optimizer.step_group

    def recording_port(name, grads):
        names = [n for n, p in getattr(pmod.net, name).named_parameters() if p.requires_grad] \
            if name in ("actor", "q1", "q2") else [""]
        pgrads[name] = dict(zip(names, [g.clone() for g in grads]))
        return step_group(name, grads)

    pstate.optimizer.step_group = recording_port
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"bc_phase": 0.0}, draws=draws)
    return {
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax_grads": jgrads,
        "port_grads": pgrads,
        "jax_sd1": cql_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux)),
        "port_sd1": pstate.net.state_dict(),
        "vib": vib,
    }


VIB_METRICS = METRICS + ["q1_vib_loss", "q2_vib_loss"]


def test_the_port_reports_the_jax_metrics(step_pair):
    assert set(step_pair["port"]) == set(step_pair["jax"]) == set(VIB_METRICS)
    assert step_pair["jax"]["q1_vib_loss"] > 0
    eps = step_pair["vib"]
    assert eps["observation"]["rgb_static"].shape == (B, 8)
    assert not torch.allclose(eps["observation"]["rgb_static"], eps["goal"]["rgb_static"])


@pytest.mark.parametrize("name", VIB_METRICS)
def test_train_step_metric_matches_jax(step_pair, name):
    np.testing.assert_allclose(step_pair["port"][name], step_pair["jax"][name], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("group", ["actor", "q1", "q2"])
def test_train_step_grads_match_jax(step_pair, group):
    convert = visual_actor_state_dict if group == "actor" else visual_critic_state_dict
    want, got = convert(step_pair["jax_grads"][group], MODS), step_pair["port_grads"][group]
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=1e-5, rtol=1e-4, err_msg=name)


def test_post_step_params_match_jax(step_pair):
    assert set(step_pair["port_sd1"]) == set(step_pair["jax_sd1"])
    for name, want in step_pair["jax_sd1"].items():
        np.testing.assert_allclose(step_pair["port_sd1"][name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0,
                                   err_msg=name)
