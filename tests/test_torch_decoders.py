"""The port's decoder options held against the JAX package on the CPU:
``StackedRNN`` in its GRU, LSTM and MLP modes (the whole window, the same
window streamed one step at a time through the carry, and gradients), the
Gaussian MDN head (loss, log-density and samples under JAX's draws), and
the ReLU RNN's ``bf16_matmul`` recurrence. Weights are flax's, randomized
so no head sits at its tiny init, carried across by
tacorl_tpu_torch/utils/convert.py.

Tolerances: forwards atol 1e-5; gradients rtol 1e-4 (atol 1e-6); the
bf16 decoder against the JAX bf16 decoder at rtol 2e-2, each within bf16
tolerance (2e-2 relative to the output's scale) of its own float32 path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.networks import action_decoder as j_ad
from tacorl_tpu_torch.networks import action_decoder as t_ad
from tacorl_tpu_torch.utils import convert

ATOL = 1e-5
B, T, D, H = 3, 5, 6, 8


def _randomized(params, seed=0, scale=0.3):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda x: (rs.randn(*np.shape(x)) * scale).astype(np.float32), params)


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=atol, rtol=rtol)


def _carry_to_torch(rnn_type, carry):
    """The JAX carry (per layer (B, H), or (c, h) for the LSTM) in the
    port's layout."""
    if rnn_type == "mlp":
        return ()
    if rnn_type == "lstm":
        return (torch.stack([torch.from_numpy(np.array(h)) for _, h in carry]),
                torch.stack([torch.from_numpy(np.array(c)) for c, _ in carry]))
    return torch.stack([torch.from_numpy(np.array(h)) for h in carry])


@pytest.fixture(scope="module", params=["gru", "lstm", "mlp"])
def rnn_pair(request):
    rnn_type = request.param
    x = np.random.RandomState(1).randn(B, T, D).astype(np.float32)
    jmod = j_ad.StackedRNN(rnn_type, H, num_layers=2)
    params = _randomized(jmod.init(jax.random.key(0), jnp.asarray(x))["params"], 2)
    tmod = t_ad.StackedRNN(rnn_type, D, H, num_layers=2)
    tmod.load_state_dict(convert.rnn_state_dict(params))
    return rnn_type, x, jmod, params, tmod


def test_stacked_rnn_builds_its_type(rnn_pair):
    rnn_type, _, _, _, tmod = rnn_pair
    torch_cls = {"gru": torch.nn.GRU, "lstm": torch.nn.LSTM, "mlp": torch.nn.Module}[rnn_type]
    assert isinstance(tmod, torch_cls) and type(tmod) is t_ad._RNN_TYPES[rnn_type]
    assert isinstance(t_ad.StackedRNN("rnn", D, H), torch.nn.RNN)
    with pytest.raises(ValueError, match="unknown rnn_type"):
        t_ad.StackedRNN("transformer", D, H)


def test_stacked_rnn_window_matches_jax(rnn_pair):
    rnn_type, x, jmod, params, tmod = rnn_pair
    want, jcarry = jmod.apply({"params": params}, jnp.asarray(x))
    got, carry = tmod(torch.from_numpy(x))
    _close(got, want)
    if rnn_type == "lstm":
        for g, w in zip(carry, _carry_to_torch(rnn_type, jcarry)):
            _close(g, w)
    elif rnn_type == "gru":
        _close(carry, _carry_to_torch(rnn_type, jcarry))
    else:
        assert carry == () and jcarry == ()


def test_stacked_rnn_streams_through_its_carry(rnn_pair):
    """One step at a time, the carry fed back, gives the window's outputs
    and the JAX stream's carry at every step."""
    rnn_type, x, jmod, params, tmod = rnn_pair
    whole, _ = tmod(torch.from_numpy(x))
    carry, jcarry = None, None
    for t in range(T):
        out, carry = tmod(torch.from_numpy(x[:, t : t + 1]), carry)
        jout, jcarry = jmod.apply({"params": params}, jnp.asarray(x[:, t : t + 1]), jcarry)
        _close(out[:, 0], whole[:, t].detach())
        _close(out, jout)
    want = _carry_to_torch(rnn_type, jcarry)
    pairs = {"lstm": zip(carry, want), "gru": [(carry, want)], "mlp": []}[rnn_type]
    for g, w in pairs:
        _close(g, w)


def test_stacked_rnn_grads_match_jax(rnn_pair):
    rnn_type, x, jmod, params, tmod = rnn_pair
    w = np.random.RandomState(3).randn(B, T, H).astype(np.float32)

    def loss(p):
        return jnp.sum(jmod.apply({"params": p}, jnp.asarray(x))[0] * w)

    jgrads = convert.rnn_state_dict(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    tmod.zero_grad()
    (tmod(torch.from_numpy(x))[0] * torch.from_numpy(w)).sum().backward()
    checked = 0
    for name, p in tmod.named_parameters():
        want = jgrads[name].numpy()
        if not p.requires_grad:
            # the LSTM's input-side bias: flax's cell has none
            assert rnn_type == "lstm" and name.startswith("bias_ih")
            continue
        # the GRU's r and z recurrent biases take a zero gradient (the hook)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-6, err_msg=name)
        checked += 1
    assert checked == {"gru": 8, "lstm": 6, "mlp": 6}[rnn_type]


def test_gru_r_z_biases_stay_zero_through_adam_and_a_copy():
    import copy

    tmod = t_ad.StackedRNN("gru", D, H, num_layers=1)
    tmod.reset_parameters()
    twin = copy.deepcopy(tmod)
    for mod in (tmod, twin):
        opt = torch.optim.Adam(mod.parameters(), lr=0.1)
        for _ in range(3):
            opt.zero_grad()
            mod(torch.randn(B, T, D))[0].square().sum().backward()
            opt.step()
        bias = mod.bias_hh_l0.detach()
        assert torch.all(bias[: 2 * H] == 0) and torch.any(bias[2 * H :] != 0)


# -- the Gaussian MDN head ------------------------------------------------------

GAUSS = dict(state_dim=D, latent_plan_dim=4, hidden_size=H, num_layers=2, n_mixtures=3, out_features=7)


@pytest.fixture(scope="module")
def gaussian_pair():
    rs = np.random.RandomState(4)
    plan = rs.randn(B, 4).astype(np.float32)
    emb = rs.randn(B, T, D).astype(np.float32)
    actions = np.clip(rs.randn(B, T, 7), -1, 1).astype(np.float32)
    jmod = j_ad.ActionDecoderGaussian(**GAUSS)
    params = _randomized(jmod.init(jax.random.key(0), jnp.asarray(plan), jnp.asarray(emb))["params"], 5)
    tmod = t_ad.ActionDecoderGaussian(**GAUSS)
    tmod.load_state_dict(convert.action_decoder_state_dict(params))
    return plan, emb, actions, jmod, params, tmod.eval()


def _t(x):
    return torch.from_numpy(np.array(x))


def _gaussian_draws(key, b, t, k, o):
    """What ActionDecoderGaussian._sample draws from ``key``."""
    k1, k2 = jax.random.split(key)
    return {"gumbel": _t(jax.random.gumbel(k1, (b, t, k))), "eps": _t(jax.random.normal(k2, (b, t, o)))}


def test_gaussian_heads_and_log_prob_match_jax(gaussian_pair):
    plan, emb, actions, jmod, params, tmod = gaussian_pair
    jlog_pi, jsigma, jmu, _ = jmod.apply({"params": params}, jnp.asarray(plan), jnp.asarray(emb))
    log_pi, sigma, mu, _ = tmod(_t(plan), _t(emb))
    for g, w in ((log_pi, jlog_pi), (sigma, jsigma), (mu, jmu)):
        _close(g, w)
    jlp = jmod.apply({"params": params}, jlog_pi, jsigma, jmu, jnp.asarray(actions), method="_mixture_log_prob")
    _close(tmod.log_prob(log_pi, sigma, mu, _t(actions)), jlp)


def test_gaussian_loss_and_samples_match_jax(gaussian_pair):
    plan, emb, actions, jmod, params, tmod = gaussian_pair
    key = jax.random.key(9)
    jloss, jpred = jmod.apply(
        {"params": params}, key, jnp.asarray(plan), jnp.asarray(emb), jnp.asarray(actions), method="loss_and_act"
    )
    loss, pred = tmod.loss_and_act(_t(plan), _t(emb), _t(actions), draws=_gaussian_draws(key, B, T, 3, 7))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tmod.loss(_t(plan), _t(emb), _t(actions)).detach()), float(jloss), rtol=1e-5)
    _close(pred, jpred)


def test_gaussian_component_choice_is_jax_categorical():
    """The argmax over log_pi plus the Gumbel draws picks the components
    ``jax.random.categorical`` picks on the same key."""
    key = jax.random.key(11)
    log_pi = jax.nn.log_softmax(jax.random.normal(jax.random.key(12), (64, 5, 4)), axis=-1)
    want = np.asarray(jax.random.categorical(key, log_pi, axis=-1))
    got = torch.argmax(_t(log_pi) + _t(jax.random.gumbel(key, log_pi.shape)), dim=-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 4


def test_gaussian_act_streams_the_lstm_carry(gaussian_pair):
    plan, emb, _, jmod, params, tmod = gaussian_pair
    carry, jcarry = None, None
    for t in range(T):
        key = jax.random.key(20 + t)
        jact, jcarry = jmod.apply(
            {"params": params}, key, jnp.asarray(plan), jnp.asarray(emb[:, t : t + 1]), None, jcarry, method="act"
        )
        act, carry = tmod.act(_t(plan), _t(emb[:, t : t + 1]), None, carry, draws=_gaussian_draws(key, B, 1, 3, 7))
        _close(act, jact)
    for g, w in zip(carry, _carry_to_torch("lstm", jcarry)):
        _close(g, w)


def test_gaussian_default_draws_come_from_the_generator(gaussian_pair):
    plan, emb, _, _, _, tmod = gaussian_pair
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a1, _ = tmod.act(_t(plan), _t(emb), generator=g1)
    a2, _ = tmod.act(_t(plan), _t(emb), generator=g2)
    assert a1.shape == (B, T, 7) and torch.equal(a1, a2)


# -- bf16_matmul ------------------------------------------------------------------

LOGISTIC = dict(state_dim=D, latent_plan_dim=4, hidden_size=32, num_layers=2, n_mixtures=3)


def test_bf16_recurrence_matches_the_jax_bf16_path():
    rs = np.random.RandomState(6)
    plan = rs.randn(B, 4).astype(np.float32)
    emb = rs.randn(B, 16, D).astype(np.float32)
    outs = {}
    for bf16 in (False, True):
        jmod = j_ad.ActionDecoderLogistic(**LOGISTIC, bf16_matmul=bf16)
        params = _randomized(jmod.init(jax.random.key(0), jnp.asarray(plan), jnp.asarray(emb))["params"], 7)
        tmod = t_ad.ActionDecoderLogistic(**LOGISTIC, bf16_matmul=bf16)
        tmod.load_state_dict(convert.action_decoder_state_dict(params))
        assert tmod.rnn.bf16_matmul is bf16
        jout = jmod.apply({"params": params}, jnp.asarray(plan), jnp.asarray(emb))
        tout = tmod(_t(plan), _t(emb))
        outs[bf16] = (np.asarray(jout[2]), tout[2].detach().numpy())
        if not bf16:
            _close(tout[2], jout[2])
    scale = np.abs(outs[False][0]).max()
    jb, tb = outs[True]
    np.testing.assert_allclose(tb, jb, rtol=2e-2, atol=2e-2 * scale)
    for side in (0, 1):
        np.testing.assert_allclose(outs[True][side], outs[False][side], rtol=2e-2, atol=2e-2 * scale)
    assert not np.array_equal(tb, outs[False][1])  # the bf16 path really ran


def test_bf16_decoder_grads_match_jax_grad():
    """The mixed-precision product's own backward against ``jax.grad`` of
    the JAX ``bf16_matmul=True`` decoder, from the same converted weights:
    every trained parameter's gradient at rtol 2e-2 (atol 2e-2 of that
    gradient's largest value). Rounding the carry to bfloat16 at each of
    16 steps moves both packages' gradients well away from their float32
    paths (by up to 44 % of a gradient's scale in JAX at these weights), so
    the port's bf16 gradient is held to be no farther from the float32
    gradient than JAX's is, plus the same 2e-2 of the scale."""
    rs = np.random.RandomState(9)
    plan = rs.randn(B, 4).astype(np.float32)
    emb = rs.randn(B, 16, D).astype(np.float32)
    w = rs.randn(B, 16, 6, 3).astype(np.float32)  # the means of 6 continuous columns, 3 mixtures
    params = None
    grads = {}
    for bf16 in (False, True):
        jmod = j_ad.ActionDecoderLogistic(**LOGISTIC, bf16_matmul=bf16)
        if params is None:
            params = _randomized(jmod.init(jax.random.key(0), jnp.asarray(plan), jnp.asarray(emb))["params"], 10)

        def loss(p, jmod=jmod):
            return jnp.sum(jmod.apply({"params": p}, jnp.asarray(plan), jnp.asarray(emb))[2] * w)

        jgrads = convert.action_decoder_state_dict(jax.tree.map(np.asarray, jax.grad(loss)(params)))
        tmod = t_ad.ActionDecoderLogistic(**LOGISTIC, bf16_matmul=bf16)
        tmod.load_state_dict(convert.action_decoder_state_dict(params))
        (tmod(_t(plan), _t(emb))[2] * _t(w)).sum().backward()
        grads[bf16] = {
            # the heads other than the means take no gradient from this loss
            n: (jgrads[n].numpy(), p.grad.numpy()) for n, p in tmod.named_parameters() if p.grad is not None
        }
        assert all(g.dtype == np.float32 and np.isfinite(g).all() for _, g in grads[bf16].values())
    assert "rnn.weight_hh_l0" in grads[True] and "rnn.bias_hh_l0" not in grads[True]
    for name, (jg, tg) in grads[True].items():
        scale = np.abs(jg).max()
        np.testing.assert_allclose(tg, jg, rtol=2e-2, atol=2e-2 * scale, err_msg=name)
        jf, tf = grads[False][name]
        np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-6 * np.abs(jf).max(), err_msg=name)
        assert np.abs(tg - tf).max() <= np.abs(jg - jf).max() + 2e-2 * scale, name
    wh = "rnn.weight_hh_l1"
    assert not np.array_equal(grads[True][wh][1], grads[False][wh][1])  # the bf16 backward really ran


def test_bf16_recurrence_trains():
    """The mixed-precision product's own backward: float32 gradients for
    every trained weight, finite, close to the float32 path's."""
    rs = np.random.RandomState(8)
    x = _t(rs.randn(B, 8, D).astype(np.float32))
    grads = {}
    for bf16 in (False, True):
        torch.manual_seed(0)
        rnn = t_ad.StackedRNN("rnn", D, 32, num_layers=2, bf16_matmul=bf16)
        rnn(x)[0].square().mean().backward()
        grads[bf16] = {n: p.grad for n, p in rnn.named_parameters() if p.requires_grad}
    for name, g in grads[True].items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        ref = grads[False][name]
        assert (g - ref).abs().max() <= 5e-2 * ref.abs().max(), name
