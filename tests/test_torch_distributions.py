"""The port's distributions held against tacorl_tpu.core.distributions:
values and gradients on the same numpy inputs (float32, atol 1e-5 on
values, 1e-5 relative on gradients)."""

import jax
import numpy as np
import pytest
import torch

from tacorl_tpu.core import distributions as jd
from tacorl_tpu_torch.core import distributions as td


def _tensors(*arrays):
    return [torch.tensor(a, requires_grad=True) for a in arrays]


def _close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol
    )


def _normal_params(rs, shape):
    return (
        rs.randn(*shape).astype(np.float32),
        np.exp(rs.randn(*shape) * 0.5).astype(np.float32),
    )


@pytest.mark.parametrize("alpha", [0.8, 0.5])
def test_balanced_kl_values_and_grads(alpha):
    rs = np.random.RandomState(0)
    pm, ps = _normal_params(rs, (4, 6))
    qm, qs = _normal_params(rs, (4, 6))

    def j_fn(pm, ps, qm, qs):
        return jd.balanced_kl(jd.DiagNormal(pm, ps), jd.DiagNormal(qm, qs), alpha).sum()

    j_val, j_grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2, 3))(pm, ps, qm, qs)
    args = _tensors(pm, ps, qm, qs)
    t_val = td.balanced_kl(
        td.DiagNormal(args[0], args[1]), td.DiagNormal(args[2], args[3]), alpha
    ).sum()
    t_val.backward()
    _close(t_val, j_val)
    for a, g in zip(args, j_grads):
        _close(a.grad, g)


def test_kl_and_diag_normal_log_prob():
    rs = np.random.RandomState(1)
    pm, ps = _normal_params(rs, (3, 5))
    qm, qs = _normal_params(rs, (3, 5))
    x = rs.randn(3, 5).astype(np.float32)
    t = [torch.from_numpy(a) for a in (pm, ps, qm, qs, x)]
    _close(
        td.kl_diag_normal(td.DiagNormal(t[0], t[1]), td.DiagNormal(t[2], t[3])),
        jd.kl_diag_normal(jd.DiagNormal(pm, ps), jd.DiagNormal(qm, qs)),
    )
    _close(td.DiagNormal(t[0], t[1]).log_prob(t[4]), jd.DiagNormal(pm, ps).log_prob(x))


@pytest.mark.parametrize("with_pretanh", [False, True])
def test_tanh_normal_log_prob_values_and_grads(with_pretanh):
    rs = np.random.RandomState(2)
    m, s = _normal_params(rs, (4, 6))
    z = rs.randn(4, 6).astype(np.float32) * 2.0
    value = np.tanh(z).astype(np.float32)
    value[0, :2] = [1.0, -1.0]  # clipped to +-0.999 without the pre-tanh value

    def j_fn(m, s):
        dist = jd.TanhNormal(m, s)
        return dist.log_prob(value, z if with_pretanh else None)

    j_val = j_fn(m, s)
    j_grads = jax.grad(lambda m, s: j_fn(m, s).sum(), argnums=(0, 1))(m, s)
    tm, ts = _tensors(m, s)
    t_val = td.TanhNormal(tm, ts).log_prob(
        torch.from_numpy(value), torch.from_numpy(z) if with_pretanh else None
    )
    assert t_val.shape == (4, 1)
    t_val.sum().backward()
    _close(t_val, j_val, rtol=1e-5, atol=1e-4)  # log-densities up to ~1e2
    _close(tm.grad, j_grads[0], rtol=1e-5, atol=1e-4)
    _close(ts.grad, j_grads[1], rtol=1e-5, atol=1e-4)


def test_tanh_normal_sample_with_injected_eps():
    rs = np.random.RandomState(3)
    m, s = _normal_params(rs, (2, 4))
    key = jax.random.key(7)
    eps = np.array(jax.random.normal(key, (2, 4)))
    want = jd.TanhNormal(m, s).sample(key)
    got = td.TanhNormal(torch.from_numpy(m), torch.from_numpy(s)).sample(
        eps=torch.from_numpy(eps)
    )
    _close(got, want, atol=1e-6)


def _mixture_inputs(seed):
    """Actions on both bounds and inside; some components far from the
    action with small scales, so cdf_delta <= 1e-5 takes the mid-bin pdf."""
    rs = np.random.RandomState(seed)
    b, t, a, k = 3, 4, 6, 5
    actions = np.clip(rs.randn(b, t, a), -1, 1).astype(np.float32)
    actions[0, 0] = 1.0
    actions[0, 1] = -1.0
    logit_probs = rs.randn(b, t, a, k).astype(np.float32)
    means = rs.uniform(-1, 1, (b, t, a, k)).astype(np.float32)
    log_scales = rs.uniform(-6, 0, (b, t, a, k)).astype(np.float32)
    means[1, :, :, :2] = actions[1, :, :, None] + 0.6
    log_scales[1, :, :, :2] = -4.9
    lo = np.full((a, 1), -1.0, np.float32)
    hi = np.full((a, 1), 1.0, np.float32)
    return actions, logit_probs, means, log_scales, lo, hi


@pytest.mark.parametrize("seed", [0, 1])
def test_logistic_mixture_log_prob_values_and_grads(seed):
    actions, lp, mu, ls, lo, hi = _mixture_inputs(seed)

    def j_fn(lp, mu, ls):
        return jd.logistic_mixture_log_prob(actions, lp, mu, ls, lo, hi, 10, -5.0)

    j_val = j_fn(lp, mu, ls)
    j_grads = jax.grad(lambda *a: j_fn(*a).sum(), argnums=(0, 1, 2))(lp, mu, ls)
    t_lp, t_mu, t_ls = _tensors(lp, mu, ls)
    t_val = td.logistic_mixture_log_prob(
        torch.from_numpy(actions), t_lp, t_mu, t_ls,
        torch.from_numpy(lo), torch.from_numpy(hi), 10, -5.0,
    )
    t_val.sum().backward()
    _close(t_val, j_val, atol=1e-4)  # log-probs down to ~-1e2
    for a, g in zip((t_lp, t_mu, t_ls), j_grads):
        _close(a.grad, g, atol=1e-4)


def test_logistic_mixture_cdf_edge_branches_are_exercised():
    actions, lp, mu, ls, lo, hi = _mixture_inputs(0)
    ls = np.clip(ls, -5.0, None)
    centered = actions[..., None] - mu
    inv = np.exp(-ls)
    half = 1.0 / 9
    sigmoid = lambda v: torch.sigmoid(torch.from_numpy(v)).numpy()  # noqa: E731
    delta = sigmoid(inv * (centered + half)) - sigmoid(inv * (centered - half))
    inner = (actions[..., None] > -1 + 1e-3) & (actions[..., None] < 1 - 1e-3)
    assert (inner & (delta <= 1e-5)).any()  # mid-bin pdf branch
    assert (actions <= -1 + 1e-3).any() and (actions >= 1 - 1e-3).any()


def test_logistic_mixture_sample_with_injected_uniforms():
    _, lp, mu, ls, _, _ = _mixture_inputs(2)
    key = jax.random.key(11)
    want = jd.logistic_mixture_sample(key, lp, mu, ls)
    # the draws jd.logistic_mixture_sample makes internally
    k_mix, k_u = jax.random.split(key)
    u_mix = jax.random.uniform(k_mix, mu.shape, minval=1e-5, maxval=1 - 1e-5)
    u = jax.random.uniform(k_u, mu.shape[:-1], minval=1e-5, maxval=1 - 1e-5)
    got = td.logistic_mixture_sample(
        *(torch.from_numpy(np.array(x)) for x in (lp, mu, ls, u_mix, u))
    )
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("rows", [3, 5])
def test_gumbel_class_log_prob_reads_indices(rows):
    """Class indices of a two-class gripper: the JAX log-density reads them
    as indices (at row counts other than the class count), and so does the
    port's at every row count."""
    rs = np.random.RandomState(1)
    logits = rs.randn(rows, 2).astype(np.float32)
    idx = np.arange(rows) % 2
    want = jd.gumbel_softmax_log_prob(logits, idx)
    _close(td.gumbel_class_log_prob(torch.from_numpy(logits), torch.from_numpy(idx)), want)
    _close(td.gumbel_class_log_prob(torch.from_numpy(logits), torch.from_numpy(idx).float() + 0.5), want)


def test_gumbel_log_prob_of_two_rows_is_the_reference_fault():
    """At two rows (a rank's share of a global batch of 4 at two ranks) the
    JAX function's shape test reads the index vector as one one-hot row
    (ROADMAP Queue 3): row 0 scores class 0 for an index of 1. The port's
    actor reads indices there too."""
    logits = np.asarray([[0.3, -1.2], [2.0, 0.1]], np.float32)
    idx = np.asarray([1, 0])
    log_softmax = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    got = td.gumbel_class_log_prob(torch.from_numpy(logits), torch.from_numpy(idx))
    _close(got[:, 0], log_softmax[np.arange(2), idx])
    jax_value = np.asarray(jd.gumbel_softmax_log_prob(logits, idx))[:, 0]
    np.testing.assert_allclose(jax_value, log_softmax[:, 0], atol=1e-6)  # class 0 for both rows
    assert not np.allclose(jax_value, log_softmax[np.arange(2), idx])
