"""One whole Play-LMP train step of the port with the Gaussian MDN decoder
(an LSTM, ``networks/action_decoder=gaussian``'s head at tiny width) and
the random-plan loss (``add_random_plan_loss``), held against
the JAX package's step at a tiny config: the same initial params (carried
across by tacorl_tpu_torch/utils/convert.py), the same batch, and JAX's
own draws (DrQ shifts and jitter factors, the posterior's normals, the
uniform random plan and goal, and each decoder sample's Gumbel noise and
normals, whose last column the gripper accuracy reads) injected into the
port. The JAX step runs its Pallas jitter tail in interpret mode.

Tolerances: metrics rtol 1e-5 (the total, a difference of two near-equal
action losses, at rtol 1e-5 of those terms); gradients rtol 1e-4 (atol
1e-5); post-Adam params atol 2.5 lr."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.modules.play_lmp import PlayLMPModule as JaxPlayLMPModule
from tacorl_tpu.ops import pallas_aug
from tacorl_tpu.utils import stable_fold
from tacorl_tpu_torch.modules.play_lmp import PlayLMPModule
from tacorl_tpu_torch.utils.convert import play_lmp_state_dict_from_jax
from tests.test_torch_play_lmp import LR, PAD, B, T, _batch
from tests.test_torch_play_lmp import _cfg as _logistic_cfg

K, LATENT = 3, 16


def _cfg():
    cfg = _logistic_cfg()
    cfg["action_decoder"] = {
        "_target_": "tacorl_tpu.networks.action_decoder.ActionDecoderGaussian",
        "hidden_size": 16, "num_layers": 1, "n_mixtures": K, "rnn_model": "lstm_decoder",
    }
    cfg["add_random_plan_loss"] = True
    return cfg


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _decoder_draws(key):
    """ActionDecoderGaussian._sample's draws over the window minus its goal
    frame."""
    k1, k2 = jax.random.split(key)
    return {"gumbel": _t(jax.random.gumbel(k1, (B, T - 1, K))), "eps": _t(jax.random.normal(k2, (B, T - 1, 7)))}


@pytest.fixture(scope="module")
def step_pair():
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxPlayLMPModule(_cfg())
        batch = _batch()
        rng = jax.random.key(0)
        jstate = jmod.init_state(jax.random.key(1), batch)
        params0 = _np_tree(jstate.params)

        k_aug, _, k_loss = jax.random.split(jax.random.fold_in(rng, 0), 3)
        k_shift, k_jit = jax.random.split(jax.random.fold_in(k_aug, stable_fold("rgb_static")))
        k_plan, k_dec, k_rand_plan, k_rand_goal, k_rand_dec, _ = jax.random.split(k_loss, 6)
        aug = {"rgb_static": {
            "shifts": _t(jax.random.randint(k_shift, (B * T, 2), 0, 2 * PAD + 1)),
            "factors": _t(pallas_aug.sample_jitter_factors(k_jit, B * T)),
        }}
        draws = {
            "random_plan": _t(jax.random.uniform(k_rand_plan, (B, LATENT), minval=-1.0, maxval=1.0)),
            "random_goal": _t(jax.random.uniform(k_rand_goal, (B, LATENT), minval=-1.0, maxval=1.0)),
            "decoder": _decoder_draws(k_dec),
            "random_decoder": _decoder_draws(k_rand_dec),
        }
        # the step's own gradients, read where it hands them to Adam
        jgrads, adam = {}, jmod.optimizer

        class Recording:
            init = staticmethod(adam.init)

            @staticmethod
            def update(grads, opt_state, params=None):
                jax.debug.callback(lambda g: jgrads.update(_np_tree(g)), grads)
                return adam.update(grads, opt_state, params)

        jmod.optimizer = Recording()
        jstate1, jmetrics = jmod.make_train_step()(jstate, batch, rng, {"kl_beta": jnp.asarray(1e-3)})
        jax.block_until_ready(jstate1.params)
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        params1 = _np_tree(jstate1.params)
    finally:
        pallas_aug.pallas_augment_tail = tail

    pmod = PlayLMPModule(_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(params0))
    pstate, pmetrics = pmod.make_train_step()(
        pstate, batch, aug_draws=aug, eps=_t(jax.random.normal(k_plan, (B, LATENT))), draws=draws
    )
    return {
        "jax_metrics": jmetrics,
        "jax_grads": play_lmp_state_dict_from_jax(jgrads),
        "jax_params1": play_lmp_state_dict_from_jax(params1),
        "port_metrics": {k: float(v) for k, v in pmetrics.items()},
        "port_net": pmod.net,
    }


METRICS = ["total_loss", "kl_loss", "kl_loss_scaled", "action_loss", "gripper_accuracy",
           "random_plan_action_loss", "random_plan_gripper_accuracy", "grad_norm"]


def _atol(metrics, name):
    """The total is a difference of two near-equal action losses, so its
    tolerance is rtol 1e-5 of those terms."""
    if name != "total_loss":
        return 1e-7
    return 1e-5 * max(abs(metrics["action_loss"]), abs(metrics["random_plan_action_loss"]))


def test_the_port_reports_the_jax_metrics(step_pair):
    assert set(step_pair["port_metrics"]) == set(step_pair["jax_metrics"]) == set(METRICS)
    m = step_pair["jax_metrics"]
    # the random plan's loss is subtracted (the JAX package's sign)
    np.testing.assert_allclose(m["total_loss"], m["kl_loss_scaled"] + m["action_loss"]
                               - m["random_plan_action_loss"], rtol=0, atol=_atol(m, "total_loss"))


@pytest.mark.parametrize("name", METRICS)
def test_train_step_metric_matches_jax(step_pair, name):
    want = step_pair["jax_metrics"]
    np.testing.assert_allclose(step_pair["port_metrics"][name], want[name], rtol=1e-5, atol=_atol(want, name))


def test_train_step_grads_match_jax(step_pair):
    checked = frozen = 0
    for name, p in step_pair["port_net"].named_parameters():
        expected = step_pair["jax_grads"][name].numpy()
        if p.grad is None:
            # the LSTM's input-side bias: flax's cell has none
            assert name.startswith("action_decoder.rnn.bias_ih") and not p.requires_grad, name
            np.testing.assert_array_equal(expected, 0.0)
            frozen += 1
            continue
        np.testing.assert_allclose(p.grad.numpy(), expected, atol=1e-5, rtol=1e-4, err_msg=name)
        checked += 1
    assert frozen == 1 and checked == len(step_pair["jax_grads"]) - frozen


def test_train_step_adam_update_matches_jax(step_pair):
    sd = step_pair["port_net"].state_dict()
    assert set(sd) == set(step_pair["jax_params1"])
    for name, expected in step_pair["jax_params1"].items():
        np.testing.assert_allclose(sd[name].numpy(), expected.numpy(), atol=2.5 * LR, rtol=0, err_msg=name)
