"""The PyTorch port's Play-LMP networks held against the JAX package: each
flax network is initialized, its params are randomized (so no head sits at
its tiny init) and carried across by tacorl_tpu_torch/utils/convert.py, and
the forwards are compared on the same numpy inputs at atol 1e-5 (float32
convolutions, no dropout)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.networks import action_decoder as j_ad
from tacorl_tpu.networks import actor as j_actor
from tacorl_tpu.networks import encoders as j_enc
from tacorl_tpu.networks import goal_encoder as j_goal
from tacorl_tpu.networks import layers as j_layers
from tacorl_tpu.networks import plan_recognition as j_pr
from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.networks import action_decoder as t_ad
from tacorl_tpu_torch.networks import actor as t_actor
from tacorl_tpu_torch.networks import encoders as t_enc
from tacorl_tpu_torch.networks import goal_encoder as t_goal
from tacorl_tpu_torch.networks import plan_recognition as t_pr
from tacorl_tpu_torch.networks.late_fusion import build_late_fusion
from tacorl_tpu_torch.networks.layers import MLP, TorchConv, TorchDense
from tacorl_tpu_torch.utils import convert

ATOL = 1e-5


def _randomized(params, seed=0, scale=0.3):
    """Replace every leaf by scaled normals (same shapes)."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (rs.randn(*np.shape(x)) * scale).astype(np.float32), params
    )


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=1e-5
    )


def _load(module, sd):
    module.load_state_dict(sd)
    return module.eval()


@pytest.mark.parametrize("normalize", [False, True])
def test_spatial_soft_argmax_matches_jax(normalize):
    rs = np.random.RandomState(1)
    x = rs.randn(3, 6, 7, 5).astype(np.float32)
    j_mod = j_enc.SpatialSoftArgmax(None, normalize)
    params = {"temperature": np.asarray([0.7], np.float32)}
    want = j_mod.apply({"params": params}, jnp.asarray(x))
    t_mod = _load(
        t_enc.SpatialSoftArgmax(None, normalize),
        {"temperature": torch.tensor([0.7])},
    )
    _close(t_mod(torch.from_numpy(x.transpose(0, 3, 1, 2))), want)


def test_lmp_vision_encoder_matches_jax():
    rs = np.random.RandomState(2)
    x = rs.uniform(-1, 1, (4, 52, 52, 3)).astype(np.float32)
    j_mod = j_enc.LMPVisionEncoder(latent_dim=16, hidden_dim=32, compute_dtype=None)
    params = _randomized(j_mod.init(jax.random.key(0), jnp.asarray(x))["params"], 2, 0.1)
    want = j_mod.apply({"params": params}, jnp.asarray(x))
    t_mod = _load(
        t_enc.LMPVisionEncoder(latent_dim=16, hidden_dim=32, compute_dtype=None),
        convert.vision_encoder_state_dict(params),
    )
    _close(t_mod(torch.from_numpy(x.transpose(0, 3, 1, 2))), want)


def test_lmp_vision_encoder_rejects_collapsed_input():
    enc = t_enc.LMPVisionEncoder(latent_dim=8, hidden_dim=16, compute_dtype=None)
    with pytest.raises(ValueError, match="collapsed"):
        enc(torch.zeros(1, 3, 32, 32))


def test_goal_encoder_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(5, 12).astype(np.float32)
    j_mod = j_goal.VisualGoalEncoder(out_features=12, hidden_size=24)
    params = _randomized(j_mod.init(jax.random.key(0), jnp.asarray(x))["params"], 3)
    want = j_mod.apply({"params": params}, jnp.asarray(x))
    t_mod = _load(
        t_goal.VisualGoalEncoder(12, out_features=12, hidden_size=24),
        convert.goal_encoder_state_dict(params),
    )
    _close(t_mod(torch.from_numpy(x)), want)


@pytest.mark.parametrize(
    "state_dim, small",
    [
        (16, False),
        (14, False),  # zero-pad to 16 for 4 heads
        # input, positions and first attention ~1e-3: the first LayerNorm
        # sees variance ~1e-5, where its epsilon (flax 1e-6) shows
        (16, True),
    ],
)
def test_plan_recognition_transformer_matches_jax(state_dim, small):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 6, state_dim).astype(np.float32) * (0.003 if small else 1.0)
    kw = dict(
        state_dim=state_dim, latent_plan_dim=8, num_heads=4, num_layers=2,
        encoder_hidden_size=32, fc_hidden_size=24, max_position_embeddings=8,
        dropout_p=0.0,
    )
    j_mod = j_pr.PlanRecognitionTransformer(**kw)
    params = _randomized(j_mod.init(jax.random.key(0), jnp.asarray(x))["params"], 4)
    if small:
        layer0 = params["_PostLNEncoderLayer_0"]
        layer0["MultiHeadDotProductAttention_0"] = _randomized(
            layer0["MultiHeadDotProductAttention_0"], 5, 0.003
        )
        params["Embed_0"] = _randomized(params["Embed_0"], 6, 0.003)
    want = j_mod.apply({"params": params}, jnp.asarray(x))
    t_mod = _load(
        t_pr.PlanRecognitionTransformer(**kw),
        convert.plan_recognition_state_dict(params),
    )
    got = t_mod(torch.from_numpy(x))
    _close(got.mean, want.mean)
    _close(got.std, want.std)


def test_actor_get_dist_matches_jax():
    rs = np.random.RandomState(5)
    state = rs.randn(4, 10).astype(np.float32)
    goal = rs.randn(4, 6).astype(np.float32)
    j_mod = j_actor.Actor(
        policy=j_actor.MLPPolicy(action_dim=8, num_layers=2, hidden_dim=20),
        action_dim=8,
    )
    params = _randomized(
        j_mod.init(jax.random.key(0), jnp.asarray(state), jnp.asarray(goal))["params"], 5
    )
    want = j_mod.apply(
        {"params": params}, jnp.asarray(state), jnp.asarray(goal), method="get_dist"
    )
    t_mod = t_actor.Actor(
        policy=t_actor.MLPPolicy(action_dim=8, input_dim=16, num_layers=2, hidden_dim=20),
        action_dim=8,
    )
    t_mod.policy.load_state_dict(convert.mlp_policy_state_dict(params["policy"]))
    got = t_mod.get_dist(torch.from_numpy(state), torch.from_numpy(goal))
    _close(got.mean, want.mean)
    _close(got.std, want.std)
    _close(got.mode, want.mode)


def test_stacked_rnn_matches_jax():
    rs = np.random.RandomState(6)
    x = rs.randn(3, 5, 10).astype(np.float32)
    j_mod = j_ad.StackedRNN("rnn", 16, num_layers=2)
    params = _randomized(j_mod.init(jax.random.key(0), jnp.asarray(x))["params"], 6)
    want, j_carry = j_mod.apply({"params": params}, jnp.asarray(x))
    sd = convert.action_decoder_state_dict({"rnn": params})
    t_mod = _load(
        t_ad.StackedRNN("rnn", 10, 16, num_layers=2),
        {k[len("rnn."):]: v for k, v in sd.items()},
    )
    got, carry = t_mod(torch.from_numpy(x))
    _close(got, want)
    for i in range(2):
        _close(carry[i], j_carry[i])


def _decoder_pair(rs):
    plan = rs.randn(3, 6).astype(np.float32)
    emb = rs.randn(3, 5, 8).astype(np.float32)
    kw = dict(state_dim=8, latent_plan_dim=6, hidden_size=16, num_layers=2, n_mixtures=4)
    j_mod = j_ad.ActionDecoderLogistic(**kw)
    params = _randomized(
        j_mod.init(jax.random.key(0), jnp.asarray(plan), jnp.asarray(emb))["params"], 7
    )
    t_mod = _load(
        t_ad.ActionDecoderLogistic(**kw), convert.action_decoder_state_dict(params)
    )
    return plan, emb, j_mod, params, t_mod


def test_action_decoder_heads_match_jax():
    plan, emb, j_mod, params, t_mod = _decoder_pair(np.random.RandomState(7))
    want = j_mod.apply({"params": params}, jnp.asarray(plan), jnp.asarray(emb))
    got = t_mod(torch.from_numpy(plan), torch.from_numpy(emb))
    for g, w in zip(got[:4], want[:4]):
        _close(g, w)


def test_action_decoder_loss_and_gripper_match_jax():
    rs = np.random.RandomState(8)
    plan, emb, j_mod, params, t_mod = _decoder_pair(rs)
    actions = np.clip(rs.randn(3, 5, 7), -1, 1).astype(np.float32)
    actions[0, :, :] = 1.0  # both action bounds
    actions[1, :, :] = -1.0
    j_loss, j_pred = j_mod.apply(
        {"params": params}, jax.random.key(3), jnp.asarray(plan), jnp.asarray(emb),
        jnp.asarray(actions), method="loss_and_act",
    )
    t_loss, t_grip = t_mod.loss_and_act(
        torch.from_numpy(plan), torch.from_numpy(emb), torch.from_numpy(actions)
    )
    _close(t_loss, j_loss)
    np.testing.assert_array_equal(t_grip.numpy(), np.asarray(j_pred)[..., -1])


def test_late_fusion_builds_port_classes_from_jax_targets():
    enc = build_late_fusion(
        {"rgb_static": {
            "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
            "latent_dim": 8, "hidden_dim": 16,
        }},
        ["rgb_static", "robot_obs"],
        {"robot_obs": 15},
    )
    assert type(enc.networks["rgb_static"]) is t_enc.LMPVisionEncoder
    assert enc.calc_state_dim(["rgb_static", "robot_obs"]) == 23
    out = enc.encode(
        {"rgb_static": torch.zeros(2, 3, 48, 48), "robot_obs": torch.ones(2, 15)},
        ["rgb_static", "robot_obs"],
    )
    assert out.shape == (2, 23)


@pytest.mark.parametrize(
    "target, cls",
    [
        ("tacorl_tpu.networks.goal_encoder.VisualGoalEncoder", t_goal.VisualGoalEncoder),
        ("tacorl_tpu_torch.networks.actor.MLPPolicy", t_actor.MLPPolicy),
    ],
)
def test_get_class_swaps_the_package_prefix(target, cls):
    assert get_class(target) is cls


def test_layer_init_bounds():
    dense = TorchDense(64, 32)
    head = TorchDense(64, 4, init_w=1e-3)
    conv = TorchConv(3, 8, 4)
    assert dense.weight.abs().max() <= 1 / 8 and dense.bias.abs().max() <= 1 / 8
    assert head.weight.abs().max() <= 1e-3 and head.bias.abs().max() <= 1e-3
    bound = 1 / np.sqrt(3 * 4 * 4)
    assert conv.weight.abs().max() <= bound and conv.bias.abs().max() <= bound


def test_mlp_matches_jax():
    rs = np.random.RandomState(9)
    x = rs.randn(4, 7).astype(np.float32)
    j_mod = j_layers.MLP(hidden=(12, 10), activation="SiLU", out_features=3,
                         activate_last=True)
    params = _randomized(j_mod.init(jax.random.key(0), jnp.asarray(x))["params"], 9)
    want = j_mod.apply({"params": params}, jnp.asarray(x))
    sd = {}
    for i, name in enumerate(["hidden.0", "hidden.1", "out"]):
        p = params[f"TorchDense_{i}"]
        sd[f"{name}.weight"] = torch.from_numpy(np.array(p["kernel"]).T)
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"]))
    t_mod = _load(
        MLP(7, (12, 10), activation="SiLU", out_features=3, activate_last=True), sd
    )
    _close(t_mod(torch.from_numpy(x)), want)
