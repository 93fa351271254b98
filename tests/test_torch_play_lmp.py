"""One whole Play-LMP train step of the PyTorch port held against the JAX
package at a tiny config: the same initial params (carried across by
tacorl_tpu_torch/utils/convert.py), the same batch, and JAX's own random
draws (DrQ shifts, jitter factors, posterior eps) injected into the port.

The JAX step runs its Pallas jitter tail in interpret mode (its
non-interpret ``pallas_call`` cannot run on the CPU)."""

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

B, T, RAW, SIZE, PAD = 3, 5, 56, 48, 2
LR = 1e-4


def _cfg():
    """__graft_entry__._module(tiny=True) with float32 convolutions and no
    dropout (both sides then compute the same deterministic function)."""
    return {
        "lr": LR,
        "kl_beta": 1e-3,
        "latent_plan_dim": 16,
        "plan_proposal_obs_modalities": ["rgb_static"],
        "plan_proposal_goal_modalities": ["rgb_static"],
        "plan_recognition_modalities": ["rgb_static"],
        "action_decoder_modalities": ["rgb_static"],
        "perceptual_encoder": {
            "networks": {
                "rgb_static": {
                    "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
                    "latent_dim": 16,
                    "hidden_dim": 32,
                    "compute_dtype": None,
                }
            }
        },
        "goal_encoder": {"hidden_size": 32},
        "plan_recognition": {
            "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32,
            "fc_hidden_size": 32, "max_position_embeddings": 8,
            "dropout_p": 0.0,
        },
        "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 32}},
        "action_decoder": {"hidden_size": 32, "num_layers": 1, "n_mixtures": 4},
        "transforms": {
            "rgb_static": {
                "kind": "rgb", "size": [SIZE, SIZE], "pad": PAD,
                "use_pallas": True,
            }
        },
    }


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "states": {
            "rgb_static": rs.randint(0, 256, (B, T, RAW, RAW, 3), dtype=np.uint8)
        },
        # clipped normals put some actions exactly on the +-1 bounds
        "actions": np.clip(rs.randn(B, T, 7), -1, 1).astype(np.float32),
    }


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def step_pair():
    """Runs one JAX step and one port step; returns what the tests hold
    against each other."""
    tail = pallas_aug.pallas_augment_tail
    pallas_aug.pallas_augment_tail = functools.partial(tail, interpret=True)
    try:
        jmod = JaxPlayLMPModule(_cfg())
        batch = _batch()
        rng = jax.random.key(0)
        jstate = jmod.init_state(jax.random.key(1), batch)
        params0 = _np_tree(jstate.params)

        # the draws JAX's make_train_step makes at step 0
        k_aug, _, k_loss = jax.random.split(jax.random.fold_in(rng, 0), 3)
        leaf_key = jax.random.fold_in(k_aug, stable_fold("rgb_static"))
        k_shift, k_jit = jax.random.split(leaf_key)
        n = B * T
        shifts = jax.random.randint(k_shift, (n, 2), 0, 2 * PAD + 1)
        factors = pallas_aug.sample_jitter_factors(k_jit, n)
        eps = jax.random.normal(jax.random.split(k_loss, 6)[0], (B, 16))

        # JAX gradients on the same augmented states
        states = jmod.transforms(k_aug, batch["states"], train=True)
        actions = jnp.asarray(batch["actions"])

        def loss_fn(params):
            total, metrics, _ = jmod.net.apply(
                {"params": params}, k_loss, states, actions, jnp.asarray(1e-3),
                True, method="compute_loss",
            )
            return total, metrics

        (_, jmetrics_grad), jgrads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True)
        )(jstate.params)
        jgrads = _np_tree(jgrads)

        # the JAX train step itself: loss, metrics and post-Adam params
        jstate1, jmetrics = jmod.make_train_step()(
            jstate, batch, rng, {"kl_beta": jnp.asarray(1e-3)}
        )
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
        params1 = _np_tree(jstate1.params)
    finally:
        pallas_aug.pallas_augment_tail = tail

    pmod = PlayLMPModule(_cfg(), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_state_dict_from_jax(params0))
    pstate, pmetrics = pmod.make_train_step()(
        pstate,
        batch,
        aug_draws={
            "rgb_static": {
                "shifts": torch.from_numpy(np.array(shifts)),
                "factors": torch.from_numpy(np.array(factors)),
            }
        },
        eps=torch.from_numpy(np.array(eps)),
    )
    return {
        "jax_metrics": jmetrics,
        "jax_grad_metrics": {k: float(v) for k, v in jmetrics_grad.items()},
        "jax_grads": play_lmp_state_dict_from_jax(jgrads),
        "jax_params1": play_lmp_state_dict_from_jax(params1),
        "port_metrics": {k: float(v) for k, v in pmetrics.items()},
        "port_net": pmod.net,
        "port_step": pstate.step,
    }


METRICS = [
    "total_loss", "kl_loss", "kl_loss_scaled", "action_loss",
    "gripper_accuracy", "grad_norm",
]


@pytest.mark.parametrize("name", METRICS)
def test_train_step_metric_matches_jax(step_pair, name):
    # rtol 1e-5: float32 sums taken in another order
    np.testing.assert_allclose(
        step_pair["port_metrics"][name], step_pair["jax_metrics"][name],
        rtol=1e-5, atol=1e-7,
    )


def test_reconstructed_jax_loss_is_the_step_loss(step_pair):
    """The gradients below come from the same loss the JAX step took."""
    np.testing.assert_allclose(
        step_pair["jax_grad_metrics"]["total_loss"],
        step_pair["jax_metrics"]["total_loss"], rtol=1e-6,
    )


def test_train_step_grads_match_jax(step_pair):
    net = step_pair["port_net"]
    checked = 0
    for name, p in net.named_parameters():
        expected = step_pair["jax_grads"][name].numpy()
        if p.grad is None:
            # the frozen recurrent bias: the JAX layer has none
            assert name.startswith("action_decoder.rnn.bias_hh"), name
            assert not p.requires_grad
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), expected, atol=1e-5, rtol=1e-4, err_msg=name
        )
        checked += 1
    assert checked == len(step_pair["jax_grads"]) - 1


def test_train_step_adam_update_matches_jax(step_pair):
    assert step_pair["port_step"] == 1
    sd = step_pair["port_net"].state_dict()
    assert set(sd) == set(step_pair["jax_params1"])
    for name, expected in step_pair["jax_params1"].items():
        # Adam's first step moves each weight by about +-lr; a near-zero
        # gradient whose sign flips by rounding moves it the other way
        np.testing.assert_allclose(
            sd[name].numpy(), expected.numpy(), atol=2.5 * LR, rtol=0, err_msg=name
        )
