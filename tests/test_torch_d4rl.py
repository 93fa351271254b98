"""The port's D4RL branch held against the JAX package on the CPU at tiny
widths (tests/test_d4rl.py's LMP_CFG), with weights carried across by
tacorl_tpu_torch/utils/convert.py and JAX's own draws passed in:

* the continuous decoder (``discrete_gripper=False``): its key set, the
  mixture NLL, ``loss_and_act``'s and the streaming ``act``'s samples for
  JAX's uniforms, the carry;
* ``PlayLMPD4RLModule``'s train and val steps (metrics with
  ``random_plan_action_loss``, gradients, post-Adam parameters, the prior's
  sample), also with ``add_random_plan_loss`` and with a state width that
  the posterior pads to its head count;
* ``TACORLD4RLModule`` grafted from a converted JAX stage 1, with and
  without ``finetune_action_decoder``: metrics, post-step parameters, the
  frozen posterior bit-unchanged; grafting at the latest step;
* (the rollouts and ``evaluate_d4rl``: tests/test_torch_d4rl_rollout.py).

The JAX draws: a train step folds its key with the step, splits it into
k_drop, k_loss, and k_loss into k_plan (the posterior's normal), k_rand
(the uniform plan on [-1, 1)) and k_pp (the prior's normal, used by the val
step); stage 2 splits the step key into k_plan and the CQL key."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacorl_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from tacorl_tpu.data.d4rl_dataset import D4RLPlayDataset as JaxPlayDataset
from tacorl_tpu.data.loader import DataLoader as JaxDataLoader
from tacorl_tpu.modules.play_lmp_d4rl import PlayLMPD4RLModule as JaxPlayLMPD4RLModule
from tacorl_tpu.modules.tacorl_d4rl import TACORLD4RLModule as JaxTACORLD4RLModule
from tacorl_tpu.networks.action_decoder import ActionDecoderLogistic as JaxDecoder
from tacorl_tpu_torch.core.checkpoint import CheckpointManager
from tacorl_tpu_torch.data.d4rl_dataset import generate_synthetic_d4rl
from tacorl_tpu_torch.modules.play_lmp_d4rl import PlayLMPD4RLModule
from tacorl_tpu_torch.modules.tacorl_d4rl import TACORLD4RLModule
from tacorl_tpu_torch.networks.action_decoder import ActionDecoderLogistic
from tacorl_tpu_torch.utils.convert import (
    action_decoder_state_dict,
    play_lmp_d4rl_state_dict_from_jax,
    tacorl_d4rl_state_dict_from_jax,
)
from tests.test_torch_cql import assert_params_agree, cql_draws, np_tree

OBS_DIM, ACT_DIM, LATENT, K = 8, 4, 8, 4
B, WINDOW, N_ACT, LR = 4, 12, 3, 1e-3
R1, R2 = 1e-5, 1.0 - 1e-5
ATOL = 1e-5
LMP_TARGET = "tacorl_tpu.modules.play_lmp_d4rl.PlayLMPD4RLModule"


def _t(x):
    return torch.from_numpy(np.array(x))


def lmp_cfg(state_dim=OBS_DIM, **extra):
    """tests/test_d4rl.py's LMP_CFG without the posterior's dropout (both
    sides then compute the same function)."""
    cfg = {
        "_target_": LMP_TARGET,
        "lr": LR,
        "latent_plan_dim": LATENT,
        "state_dim": state_dim,
        "action_dim": ACT_DIM,
        "plan_recognition": {
            "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 32,
            "fc_hidden_size": 32, "max_position_embeddings": WINDOW, "dropout_p": 0.0,
        },
        "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 32}},
        "action_decoder": {"hidden_size": 32, "num_layers": 1, "n_mixtures": K},
    }
    cfg.update(extra)
    return cfg


def _batch(state_dim=OBS_DIM, seed=0, tmp=None):
    """A loader batch of D4RL play windows (padded, with goals)."""
    path = generate_synthetic_d4rl(Path(tmp) / f"d{state_dim}.npz", n_steps=400, episode_len=100,
                                   obs_dim=state_dim, act_dim=ACT_DIM, seed=seed)
    ds = JaxPlayDataset(dataset_path=path, min_window_size=8, max_window_size=WINDOW, include_goal=True)
    return next(iter(JaxDataLoader(ds, batch_size=B, seed=seed)))


# -- the continuous decoder ------------------------------------------------------------

DEC = dict(state_dim=OBS_DIM, latent_plan_dim=5, hidden_size=16, num_layers=2, n_mixtures=K,
           out_features=ACT_DIM, discrete_gripper=False,
           act_max_bound=[1.0] * ACT_DIM, act_min_bound=[-1.0] * ACT_DIM)


@pytest.fixture(scope="module")
def decoders():
    jdec = JaxDecoder(**DEC)
    params = jdec.init(jax.random.key(3), jnp.zeros((2, DEC["latent_plan_dim"])), jnp.zeros((2, 3, OBS_DIM)))["params"]
    pdec = ActionDecoderLogistic(**DEC)
    pdec.load_state_dict(action_decoder_state_dict(np_tree(params)))
    return jdec, params, pdec.eval()


def _uniforms(key, b, t):
    k_mix, k_u = jax.random.split(key)
    return {
        "u_mix": _t(jax.random.uniform(k_mix, (b, t, ACT_DIM, K), minval=R1, maxval=R2)),
        "u": _t(jax.random.uniform(k_u, (b, t, ACT_DIM), minval=R1, maxval=R2)),
    }


def test_continuous_decoder_has_no_gripper_head(decoders):
    _, params, pdec = decoders
    assert "gripper_fc" not in params and pdec.gripper_fc is None
    assert not any(k.startswith("gripper_fc") for k in pdec.state_dict())
    assert pdec.cont_features == ACT_DIM
    # the bf16 recurrence builds the same head and computes the JAX bf16
    # decoder's function (rtol 2e-2, bf16 operands)
    jdec = JaxDecoder(**{**DEC, "bf16_matmul": True})
    bdec = ActionDecoderLogistic(**{**DEC, "bf16_matmul": True})
    assert bdec.gripper_fc is None and bdec.rnn.bf16_matmul
    bdec.load_state_dict(action_decoder_state_dict(np_tree(params)))
    rs = np.random.RandomState(2)
    plan, emb = rs.randn(2, DEC["latent_plan_dim"]).astype(np.float32), rs.randn(2, 4, OBS_DIM).astype(np.float32)
    want = jdec.apply({"params": params}, jnp.asarray(plan), jnp.asarray(emb))
    with torch.no_grad():
        got = bdec(_t(plan), _t(emb))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-2, atol=2e-2 * float(np.abs(w).max()))


def test_continuous_decoder_loss_and_samples_match_jax(decoders):
    jdec, params, pdec = decoders
    rs = np.random.RandomState(1)
    plan = rs.randn(3, DEC["latent_plan_dim"]).astype(np.float32)
    emb = rs.randn(3, 6, OBS_DIM).astype(np.float32)
    # clipped normals put some actions exactly on the +-1 bounds
    actions = np.clip(rs.randn(3, 6, ACT_DIM), -1, 1).astype(np.float32)
    key = jax.random.key(9)
    jloss, jpred = jdec.apply({"params": params}, key, plan, emb, actions, method="loss_and_act")
    with torch.no_grad():
        loss = pdec.loss(_t(plan), _t(emb), _t(actions))
        loss2, pred = pdec.loss_and_act(_t(plan), _t(emb), _t(actions), draws=_uniforms(key, 3, 6))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(loss2) == float(loss)
    assert pred.shape == (3, 6, ACT_DIM)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=ATOL)


def test_continuous_decoder_act_streams_like_jax(decoders):
    jdec, params, pdec = decoders
    rs = np.random.RandomState(0)
    plan = rs.randn(2, DEC["latent_plan_dim"]).astype(np.float32)
    jcarry, pcarry = None, None
    for t in range(5):
        emb = rs.randn(2, 1, OBS_DIM).astype(np.float32)
        key = jax.random.key(t)
        jact, jcarry = jdec.apply({"params": params}, key, plan, emb, None, jcarry, method="act")
        with torch.no_grad():
            pact, pcarry = pdec.act(_t(plan), _t(emb), None, pcarry, _uniforms(key, 2, 1))
        assert pact.shape == (2, 1, ACT_DIM)
        np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(pcarry.numpy(), np.stack([np.asarray(c) for c in jcarry]), atol=ATOL)


# -- stage 1: PlayLMPD4RLModule -----------------------------------------------------------

LMP_CASES = {
    "default": (OBS_DIM, {}),
    "random_plan_loss": (OBS_DIM, {"add_random_plan_loss": True, "kl_balancing": False}),
    # 6 state columns at 4 heads: the posterior pads d_model to 8
    "padded_d_model": (6, {}),
}
LMP_METRICS = ["kl_loss", "kl_loss_scaled", "action_loss", "random_plan_action_loss", "total_loss"]


@pytest.fixture(scope="module", params=list(LMP_CASES))
def lmp_pair(request, tmp_path_factory):
    state_dim, extra = LMP_CASES[request.param]
    cfg = lmp_cfg(state_dim, **extra)
    batch = _batch(state_dim, tmp=tmp_path_factory.mktemp("lmp"))
    kl_beta = 1e-2
    jmod = JaxPlayLMPD4RLModule(dict(cfg))
    jstate = jmod.init_state(jax.random.key(1), batch)
    params0 = np_tree(jstate.params)
    rng = jax.random.key(0)

    # the JAX step's draws at step 0
    _, k_loss = jax.random.split(jax.random.fold_in(rng, 0))
    k_plan, k_rand, _ = jax.random.split(k_loss, 3)
    draws = {"eps": _t(jax.random.normal(k_plan, (B, LATENT))),
             "random_plan": _t(jax.random.uniform(k_rand, (B, LATENT), minval=-1.0, maxval=1.0))}
    obs, actions = jnp.asarray(batch["observations"]), jnp.asarray(batch["actions"])

    def loss_fn(params):
        total, metrics, _ = jmod.net.apply(
            {"params": params}, k_loss, obs, actions, jnp.asarray(kl_beta), True, method="compute_loss"
        )
        return total, metrics

    jgrads = np_tree(jax.grad(lambda p: loss_fn(p)[0])(jstate.params))
    jval, jval_out = jmod.make_val_step()(jstate, batch, jax.random.key(5), {"kl_beta": jnp.asarray(kl_beta)})
    k_vplan, k_vrand, k_vpp = jax.random.split(jax.random.key(5), 3)
    val_draws = {"eps": _t(jax.random.normal(k_vplan, (B, LATENT))),
                 "random_plan": _t(jax.random.uniform(k_vrand, (B, LATENT), minval=-1.0, maxval=1.0)),
                 "pp_eps": _t(jax.random.normal(k_vpp, (B, LATENT)))}
    jstate1, jmetrics = jmod.make_train_step()(jstate, batch, rng, {"kl_beta": jnp.asarray(kl_beta)})

    pmod = PlayLMPD4RLModule(dict(cfg), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_d4rl_state_dict_from_jax(params0))
    pval, pval_out = pmod.make_val_step()(pstate, batch, {"kl_beta": kl_beta}, **val_draws)
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"kl_beta": kl_beta}, **draws)
    return {
        "case": request.param,
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax_val": {k: float(v) for k, v in jval.items()},
        "port_val": {k: float(v) for k, v in pval.items()},
        "jax_val_out": jval_out, "port_val_out": pval_out,
        "jax_grads": play_lmp_d4rl_state_dict_from_jax(jgrads),
        "jax_params1": play_lmp_d4rl_state_dict_from_jax(np_tree(jstate1.params)),
        "port_module": pmod, "port_state": pstate, "batch": batch,
    }


def test_lmp_reports_the_jax_metrics(lmp_pair):
    assert set(lmp_pair["port"]) == set(lmp_pair["jax"]) == set(LMP_METRICS)
    assert set(lmp_pair["port_val"]) == set(lmp_pair["jax_val"]) == set(LMP_METRICS)


def _atol(metrics, name, case):
    """1e-7, except for the total with the random-plan loss subtracted: a
    difference of two losses of nearly equal size, held at 1e-5 of its
    operands (each operand itself at rtol 1e-5)."""
    if name == "total_loss" and case == "random_plan_loss":
        return 1e-5 * (abs(metrics["action_loss"]) + abs(metrics["random_plan_action_loss"]))
    return 1e-7


@pytest.mark.parametrize("name", LMP_METRICS)
def test_lmp_train_step_metric_matches_jax(lmp_pair, name):
    want = lmp_pair["jax"]
    np.testing.assert_allclose(lmp_pair["port"][name], want[name], rtol=1e-5,
                               atol=_atol(want, name, lmp_pair["case"]))


@pytest.mark.parametrize("name", LMP_METRICS)
def test_lmp_val_step_metric_matches_jax(lmp_pair, name):
    want = lmp_pair["jax_val"]
    np.testing.assert_allclose(lmp_pair["port_val"][name], want[name], rtol=1e-5,
                               atol=_atol(want, name, lmp_pair["case"]))


def test_lmp_total_loss_takes_the_random_plan_loss_only_when_asked(lmp_pair):
    m = lmp_pair["port"]
    base = m["kl_loss_scaled"] + m["action_loss"]
    want = base - m["random_plan_action_loss"] if lmp_pair["case"] == "random_plan_loss" else base
    # float32 sums: 1e-6 of the operands
    scale = abs(m["kl_loss_scaled"]) + abs(m["action_loss"]) + abs(m["random_plan_action_loss"])
    np.testing.assert_allclose(m["total_loss"], want, rtol=0, atol=1e-6 * scale)


def test_lmp_val_outputs_match_jax(lmp_pair):
    np.testing.assert_allclose(lmp_pair["port_val_out"]["sampled_plan_pp"].numpy(),
                               np.asarray(lmp_pair["jax_val_out"]["sampled_plan_pp"]), atol=ATOL)
    np.testing.assert_array_equal(np.asarray(lmp_pair["port_val_out"]["idx"]),
                                  np.asarray(lmp_pair["jax_val_out"]["idx"]))


def test_lmp_grads_match_jax(lmp_pair):
    net, checked = lmp_pair["port_state"].net, 0
    for name, p in net.named_parameters():
        expected = lmp_pair["jax_grads"][name].numpy()
        if p.grad is None:
            # the frozen recurrent bias: the JAX layer has none
            assert name.startswith("action_decoder.rnn.bias_hh") and not p.requires_grad, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), expected, atol=1e-5, rtol=1e-4, err_msg=name)
        checked += 1
    assert checked == len(lmp_pair["jax_grads"]) - 1


def test_lmp_adam_update_matches_jax(lmp_pair):
    state = lmp_pair["port_state"]
    assert state.step == 1
    sd = state.net.state_dict()
    assert set(sd) == set(lmp_pair["jax_params1"])
    assert not any("gripper_fc" in k for k in sd)
    for name, want in lmp_pair["jax_params1"].items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name)
    assert_params_agree(sd, lmp_pair["jax_params1"], LR)


def test_lmp_random_plan_loss_builds_a_graph_only_when_added(lmp_pair):
    module, batch = lmp_pair["port_module"], lmp_pair["batch"]
    obs = torch.as_tensor(batch["observations"])
    acts = torch.as_tensor(batch["actions"])
    _, metrics, _ = module.net.compute_loss(obs, acts, 0.0, generator=module.generator)
    assert metrics["random_plan_action_loss"].requires_grad == module.net.add_random_plan_loss
    assert metrics["action_loss"].requires_grad


# -- stage 2: TACORLD4RLModule ----------------------------------------------------------------


def tacorl_cfg(lmp_dir, finetune=True):
    """tests/test_d4rl.py's TACO-RL config with the learning rates at LR."""
    return {
        "_target_": "tacorl_tpu.modules.tacorl_d4rl.TACORLD4RLModule",
        "play_lmp_dir": str(lmp_dir),
        "finetune_action_decoder": finetune,
        "action_decoder_lr": LR, "actor_lr": LR, "critic_lr": LR,
        "discount": 0.95, "with_lagrange": True, "reward_scale": 10.0,
        "n_action_samples": N_ACT, "deterministic_backup": True,
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "target_entropy": -float(ACT_DIM),
    }


@pytest.fixture(scope="module")
def lmp_dirs(tmp_path_factory):
    """A tiny JAX Play-LMP D4RL checkpoint (the posterior keeps its default
    dropout) and the same weights as a port checkpoint."""
    cfg = lmp_cfg()
    cfg["plan_recognition"] = {k: v for k, v in cfg["plan_recognition"].items() if k != "dropout_p"}
    batch = _batch(tmp=tmp_path_factory.mktemp("data"))
    jmod = JaxPlayLMPD4RLModule(dict(cfg))
    jstate = jmod.init_state(jax.random.key(2), batch)
    jax_dir = tmp_path_factory.mktemp("jax_lmp")
    JaxCheckpointManager(jax_dir, config={"module": dict(cfg)}).save(int(jstate.step), jstate)
    port_dir = tmp_path_factory.mktemp("port_lmp")
    pmod = PlayLMPD4RLModule(dict(cfg), device="cpu")
    pstate = pmod.init_state(0)
    pmod.net.load_state_dict(play_lmp_d4rl_state_dict_from_jax(np_tree(jstate.params)))
    CheckpointManager(port_dir, config={"module": cfg}).save(0, pstate)
    return jax_dir, port_dir, batch


TACORL_METRICS = [
    "action_loss", "rl_batch_success_rate", "alpha", "alpha_loss", "actor_loss", "alpha_prime",
    "alpha_prime_loss",
] + [m.format(q) for q in ("q1", "q2") for m in (
    "{}_data", "bellman_{}_loss", "{}_random", "{}_policy", "conservative_{}_loss",
    "conservative_{}_gap", "{}_loss",
)]


@pytest.fixture(scope="module", params=[True, False], ids=["finetune", "frozen_decoder"])
def tacorl_pair(request, lmp_dirs):
    jax_dir, port_dir, batch = lmp_dirs
    finetune = request.param
    jmod = JaxTACORLD4RLModule(tacorl_cfg(jax_dir, finetune))
    jstate = jmod.init_state(jax.random.key(1), batch)
    params0, aux0 = np_tree(jstate.params), np_tree(jstate.aux)
    rng = jax.random.key(0)
    jstate1, jmetrics = jmod.make_train_step()(jstate, batch, rng, {"bc_phase": jnp.asarray(0.0)})

    k_plan, k_cql = jax.random.split(jax.random.fold_in(rng, 0))
    draws = cql_draws(k_cql, B, N_ACT, LATENT, discrete_gripper=False)
    draws["plan_eps"] = _t(jax.random.normal(k_plan, (B, LATENT)))

    pmod = TACORLD4RLModule(tacorl_cfg(port_dir, finetune), device="cpu")
    pstate = pmod.init_state(0)
    grafted = {k: v.clone() for k, v in pmod.net.state_dict().items()}
    pmod.net.load_state_dict(tacorl_d4rl_state_dict_from_jax(params0, aux0))
    before = {k: v.clone() for k, v in pmod.net.state_dict().items()}
    pstate, pmetrics = pmod.make_train_step()(pstate, batch, {"bc_phase": 0.0}, draws=draws)
    return {
        "finetune": finetune,
        "jax": {k: float(v) for k, v in jmetrics.items()},
        "port": {k: float(v) for k, v in pmetrics.items()},
        "jax_params0": tacorl_d4rl_state_dict_from_jax(params0, aux0),
        "jax_params1": tacorl_d4rl_state_dict_from_jax(np_tree(jstate1.params), np_tree(jstate1.aux)),
        "port_state": pstate, "grafted": grafted, "before": before,
    }


def test_tacorl_reports_the_jax_metrics(tacorl_pair):
    assert set(tacorl_pair["port"]) == set(tacorl_pair["jax"]) == set(TACORL_METRICS)


@pytest.mark.parametrize("name", TACORL_METRICS)
def test_tacorl_train_step_metric_matches_jax(tacorl_pair, name):
    np.testing.assert_allclose(tacorl_pair["port"][name], tacorl_pair["jax"][name], rtol=1e-5, atol=1e-7)


def test_tacorl_grafts_what_jax_grafts(tacorl_pair):
    grafted, jax0 = tacorl_pair["grafted"], tacorl_pair["jax_params0"]
    assert set(grafted) == set(jax0)
    keys = [k for k in jax0 if k.split(".")[0] in ("actor", "plan_recognition", "action_decoder")]
    assert keys and not any(".encoder." in k or "goal_encoder" in k or "gripper_fc" in k for k in jax0)
    for k in keys:
        assert torch.equal(grafted[k], jax0[k]), k


@pytest.mark.parametrize(
    "group", ["actor", "q1", "q2", "target_q1", "target_q2", "log_alpha", "log_alpha_prime", "action_decoder"]
)
def test_tacorl_post_step_params_match_jax(tacorl_pair, group):
    state = tacorl_pair["port_state"]
    assert state.step == 1
    sd = state.net.state_dict()
    expected = {k: v for k, v in tacorl_pair["jax_params1"].items() if k.split(".")[0] == group}
    assert expected
    for name, want in expected.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), atol=2.5 * LR, rtol=0, err_msg=name)
    assert_params_agree(sd, tacorl_pair["jax_params1"], LR)


def test_tacorl_posterior_is_frozen_and_the_decoder_moves_only_when_finetuned(tacorl_pair):
    state, before = tacorl_pair["port_state"], tacorl_pair["before"]
    net, after = state.net, state.net.state_dict()
    assert not any(p.requires_grad for p in net.plan_recognition.parameters())
    assert "plan_recognition" not in state.optimizer.groups
    pr = [k for k in after if k.startswith("plan_recognition.")]
    assert pr and all(torch.equal(after[k], before[k]) for k in pr)
    moved = [k for k in before if k.startswith("action_decoder.") and not torch.equal(before[k], after[k])]
    if tacorl_pair["finetune"]:
        assert moved and all("bias_hh" not in k for k in moved)
        assert "action_decoder" in state.optimizer.groups
    else:
        assert not moved and "action_decoder" not in state.optimizer.groups


def test_stage2_grafts_the_latest_lmp_step_by_default(lmp_dirs, tmp_path):
    """lmp_epoch_to_load -1 (the default) is the latest step, whatever the
    monitor ranks best; an explicit step grafts that step."""
    _, port_dir, _ = lmp_dirs
    cfg = CheckpointManager(port_dir).load_config()
    lmp = PlayLMPD4RLModule(cfg["module"], device="cpu")
    manager = CheckpointManager(tmp_path / "lmp", monitor="val_accuracy", mode="max", config=cfg)
    weights = {}
    for step, acc in ((1, 1.0), (2, 0.0)):
        state = lmp.init_state(step)
        weights[step] = {k: v.clone() for k, v in lmp.net.plan_proposal.state_dict().items()}
        manager.save(step, state, {"val_accuracy": acc})
    assert manager.best_step() == 1 and manager.latest_step() == 2
    for load, want in ((None, 2), (1, 1)):
        tcfg = tacorl_cfg(tmp_path / "lmp")
        if load is not None:
            tcfg["lmp_epoch_to_load"] = load
        module = TACORLD4RLModule(tcfg, device="cpu")
        module.init_state(0)
        got = module.net.actor.actor.state_dict()
        assert all(torch.equal(got[k], weights[want][k]) for k in got)
        assert module.action_dim == LATENT
