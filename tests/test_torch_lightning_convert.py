"""Reference PyTorch-Lightning checkpoints converted by the port
(``utils/torch_convert.py``, ``python -m tacorl_tpu_torch.convert_checkpoint``)
held against the JAX package's converter (``scripts/convert_checkpoint.py``
and ``tacorl_tpu/utils/torch_convert.py``).

Each checkpoint is written by the test itself from the reference-layout
modules of ``tests/torch_ref.py`` (the decoder's ``nn.RNN`` swapped for an
``nn.GRU`` or ``nn.LSTM`` where the case says so), with every recurrent bias
nonzero. Tolerances: the state_dict is bit for bit the one
``*_state_dict_from_jax(assemble_*(sd))`` gives; the forwards of the two
converted checkpoints agree at rtol 1e-5 (atol 1e-6 beside it for values
near zero)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn as tnn

from scripts import convert_checkpoint as jax_convert_script
from tacorl_tpu.config import save_yaml
from tacorl_tpu.core.checkpoint import load_module_from_checkpoint as jax_load
from tacorl_tpu_torch import convert_checkpoint
from tacorl_tpu_torch.core.checkpoint import load_module_from_checkpoint
from tacorl_tpu_torch.utils import convert as from_jax
from tacorl_tpu_torch.utils import torch_convert

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_ref import TRIL, TPlayLMP, build_cql_torch  # noqa: E402

MODS = ["rgb_static"]
HW = 48
LP = 8
RTOL, ATOL = 1e-5, 1e-6
ENC = {"networks": {"rgb_static": {
    "_target_": "tacorl_tpu.networks.encoders.LMPVisionEncoder",
    "latent_dim": 8, "hidden_dim": 16, "compute_dtype": None,
}}}
RNN_CLS = {"rnn": None, "gru": tnn.GRU, "lstm": tnn.LSTM}


def lmp_cfg(rnn="rnn"):
    """The port's and the JAX package's Play-LMP at ``TPlayLMP``'s widths."""
    return {
        "_target_": "tacorl_tpu.modules.play_lmp.PlayLMPModule",
        "latent_plan_dim": LP,
        "perceptual_encoder": ENC,
        "goal_encoder": {"hidden_size": 16},
        "plan_recognition": {
            "num_heads": 4, "num_layers": 1, "encoder_hidden_size": 16, "fc_hidden_size": 16,
            "max_position_embeddings": 16, "dropout_p": 0.0,
        },
        "plan_proposal": {"policy": {"num_layers": 2, "hidden_dim": 16}},
        "action_decoder": {"hidden_size": 16, "num_layers": 1, "n_mixtures": 4, "rnn_model": f"{rnn}_decoder"},
        "transforms": None,
    }


CQL_CFG = {
    "_target_": "tacorl_tpu.modules.cql.CQLModule",
    "action_dim": 7, "obs_modalities": MODS, "goal_modalities": MODS,
    "actor_encoder": ENC, "critic_encoder": ENC, "goal_encoder": {"hidden_size": 16},
    "policy": {"num_layers": 2, "hidden_dim": 16, "discrete_gripper": True},
    "q_network": {"num_layers": 2, "hidden_dim": 16},
    "with_lagrange": True, "n_action_samples": 2, "transforms": None,
}
RIL_CFG = {
    "_target_": "tacorl_tpu.modules.ril.RILModule",
    "perceptual_encoder": ENC, "goal_encoder": {"hidden_size": 16, "out_features": 8},
    "high_level_policy": {"num_layers": 2, "hidden_dim": 16},
    "low_level_policy": {"num_layers": 2, "hidden_dim": 16},
    "action_dim": 7, "transforms": None,
}


def tacorl_cfg(lmp_dir, rnn="rnn"):
    return {
        "_target_": "tacorl_tpu.modules.tacorl.TACORLModule",
        "play_lmp_dir": str(lmp_dir),
        "with_lagrange": True, "n_action_samples": 2,
        # the Play-LMP parts' widths, which the converters read here
        "policy": {"num_layers": 2},
        "plan_recognition": {"num_heads": 4, "num_layers": 1},
        "q_network": {"num_layers": 2, "hidden_dim": 16},
        "action_decoder": {"num_layers": 1, "rnn_model": f"{rnn}_decoder"},
        "transforms": None,
    }


def _nonzero_recurrent_biases(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".bias_ih_" in name or ".bias_hh_" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return model


def reference_play_lmp(rnn="rnn", seed=0):
    torch.manual_seed(seed)
    model = TPlayLMP(MODS)
    if RNN_CLS[rnn] is not None:
        model.action_decoder.rnn = RNN_CLS[rnn](LP + 8, 16, 1, batch_first=True)
    return _nonzero_recurrent_biases(model, seed)


def reference_tacorl(rnn="rnn", seed=0):
    lmp = reference_play_lmp(rnn, seed)
    torch.manual_seed(seed + 1)
    cql = build_cql_torch(MODS, action_dim=LP, plan_space=True)

    class TTACORL(tnn.Module):
        def __init__(self):
            super().__init__()
            for name in ("actor", "q1", "q2", "target_q1", "target_q2"):
                setattr(self, name, getattr(cql, name))
            self.log_alpha, self.log_alpha_prime = cql.log_alpha, cql.log_alpha_prime
            for name in ("perceptual_encoder", "plan_recognition", "goal_encoder", "action_decoder"):
                setattr(self, name, getattr(lmp, name))

    return TTACORL()


def reference_model(kind, rnn="rnn", seed=0):
    if kind == "play_lmp":
        return reference_play_lmp(rnn, seed)
    if kind == "tacorl":
        return reference_tacorl(rnn, seed)
    torch.manual_seed(seed)
    return build_cql_torch(MODS, action_dim=7) if kind == "cql" else TRIL(MODS, goal_out=8)


def write_lightning(model, path):
    """What Lightning's ModelCheckpoint writes, cut to what a loader reads."""
    torch.save({"epoch": 3, "global_step": 120, "state_dict": model.state_dict(),
                "optimizer_states": [], "hyper_parameters": {}}, path)
    return path


def jax_state_dict(kind, sd_np, cfg):
    """The JAX converter's trees, carried to the port layout."""
    params, aux = jax_convert_script.convert(kind, sd_np, cfg)
    if kind == "play_lmp":
        return from_jax.play_lmp_state_dict_from_jax(params)
    if kind == "cql":
        return from_jax.cql_state_dict_from_jax(params, aux)
    if kind == "tacorl":
        return from_jax.tacorl_state_dict_from_jax(params, aux)
    return from_jax.ril_state_dict_from_jax(params)


CASES = [("play_lmp", "rnn"), ("play_lmp", "gru"), ("play_lmp", "lstm"), ("cql", "rnn"),
         ("tacorl", "rnn"), ("tacorl", "gru"), ("tacorl", "lstm"), ("ril", "rnn")]


@pytest.mark.parametrize("kind, rnn", CASES, ids=[f"{k}-{r}" for k, r in CASES])
def test_the_converter_equals_the_jax_converter_bit_for_bit(kind, rnn, tmp_path):
    path = write_lightning(reference_model(kind, rnn), tmp_path / "ref.ckpt")
    cfg = {"play_lmp": lmp_cfg(rnn), "cql": CQL_CFG, "ril": RIL_CFG,
           "tacorl": tacorl_cfg("unused", rnn)}[kind]
    from tacorl_tpu.utils.torch_convert import load_lightning_state_dict as jax_load_sd

    got = torch_convert.convert(kind, torch_convert.load_lightning_state_dict(path), cfg)
    want = jax_state_dict(kind, jax_load_sd(path), cfg)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == torch.float32, key
        assert torch.equal(got[key], want[key]), key
    if rnn != "rnn" or kind in ("play_lmp", "tacorl"):  # the fold moved a nonzero bias
        held = "bias_ih_l0" if rnn == "lstm" else "bias_hh_l0"
        zeroed = got[f"action_decoder.rnn.{held}"]
        assert (zeroed[: 2 * 16] if rnn == "gru" else zeroed).abs().max() == 0
        assert torch_convert.load_lightning_state_dict(path)[f"action_decoder.rnn.{held}"].abs().max() > 0


def test_a_checkpoint_of_other_depth_or_gates_is_refused(tmp_path):
    sd = torch_convert.load_lightning_state_dict(write_lightning(reference_play_lmp("gru"), tmp_path / "g.ckpt"))
    with pytest.raises(ValueError, match="gates a layer"):
        torch_convert.convert("play_lmp", sd, lmp_cfg("lstm"))
    deeper = lmp_cfg("gru")
    deeper["action_decoder"]["num_layers"] = 2
    with pytest.raises(ValueError, match="1 recurrent layers, the config 2"):
        torch_convert.convert("play_lmp", sd, deeper)
    with pytest.raises(ValueError, match="unknown kind"):
        torch_convert.convert("sac", sd, {})


# -- the entry points, then the forwards ------------------------------------------------


def _convert_both(kind, ckpt, cfg_jax, cfg_port, root):
    jax_cfg, port_cfg = root / f"{kind}_jax.yaml", root / f"{kind}_port.yaml"
    save_yaml({"module": cfg_jax}, jax_cfg)
    save_yaml({"module": cfg_port}, port_cfg)
    jax_out, port_out = root / f"{kind}_jax", root / f"{kind}_port"
    argv = sys.argv
    sys.argv = ["convert_checkpoint.py", "--ckpt", str(ckpt), "--module-config", str(jax_cfg),
                "--out", str(jax_out), "--kind", kind]
    try:
        jax_convert_script.main()
    finally:
        sys.argv = argv
    convert_checkpoint.main(["--ckpt", str(ckpt), "--module-config", str(port_cfg), "--out", str(port_out),
                             "--kind", kind, "--device", "cpu"])
    return jax_out, port_out


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def _obs(rs, b=3):
    frames = {k: rs.rand(b, HW, HW, 3).astype(np.float32) for k in ("observation", "goal")}
    port = {k: {"rgb_static": torch.from_numpy(v).permute(0, 3, 1, 2)} for k, v in frames.items()}
    return port, {k: {"rgb_static": jax.numpy.asarray(v)} for k, v in frames.items()}


def _lmp_loss_pair(jmod, jstate, pmod, seed=0, b=2, t=5):
    """compute_loss of both converted Play-LMP nets, in evaluation mode on
    the same window, the posterior's draw JAX's."""
    rs = np.random.RandomState(seed)
    frames = rs.rand(b, t, HW, HW, 3).astype(np.float32)
    actions = np.clip(rs.randn(b, t, 7), -1, 1).astype(np.float32)
    key = jax.random.key(seed)
    loss = jax.jit(lambda p, k, s, a: jmod.net.apply({"params": p}, k, s, a, 1e-3, False, method="compute_loss"))
    _, jmetrics, _ = loss(jstate.params, key, {"rgb_static": jax.numpy.asarray(frames)}, jax.numpy.asarray(actions))
    eps = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key, 6)[0], (b, LP))))
    pmod.net.eval()
    with torch.no_grad():
        _, pmetrics, _ = pmod.net.compute_loss(
            {"rgb_static": torch.from_numpy(frames).permute(0, 1, 4, 2, 3)}, torch.from_numpy(actions),
            1e-3, eps=eps,
        )
    return jmetrics, pmetrics


@pytest.fixture(scope="module")
def converted_lmps(tmp_path_factory):
    """play_lmp checkpoints of each decoder, converted by both entry points."""
    out = {}
    for rnn in ("rnn", "gru", "lstm"):
        root = tmp_path_factory.mktemp(f"lmp_{rnn}")
        ckpt = write_lightning(reference_play_lmp(rnn), root / "play_lmp.ckpt")
        out[rnn] = (ckpt,) + _convert_both("play_lmp", ckpt, lmp_cfg(rnn), lmp_cfg(rnn), root)
    return out


@pytest.mark.parametrize("rnn", ["rnn", "gru", "lstm"])
def test_play_lmp_converted_by_both_computes_the_same_loss(converted_lmps, rnn):
    _, jax_out, port_out = converted_lmps[rnn]
    jmod, jstate = jax_load(jax_out)
    pmod, pstate = load_module_from_checkpoint(port_out, device="cpu")
    assert pstate.step == 0 and pstate.optimizer.state_dict()["state"] == {}
    jmetrics, pmetrics = _lmp_loss_pair(jmod, jstate, pmod)
    for name in ("kl_loss", "action_loss", "total_loss"):
        _close(pmetrics[name], jmetrics[name])


def test_cql_converted_by_both_computes_the_same_q_and_actions(tmp_path):
    ckpt = write_lightning(reference_model("cql"), tmp_path / "cql.ckpt")
    jax_out, port_out = _convert_both("cql", ckpt, CQL_CFG, CQL_CFG, tmp_path)
    jmod, jstate = jax_load(jax_out)
    pmod, pstate = load_module_from_checkpoint(port_out, device="cpu")
    port_obs, jax_obs = _obs(np.random.RandomState(1))
    actions = np.random.RandomState(2).uniform(-1, 1, (3, 7)).astype(np.float32)
    for name in ("q1", "q2"):
        want = jmod.critic_net.apply({"params": jstate.params[name]}, jax_obs, jax.numpy.asarray(actions))
        with torch.no_grad():
            _close(getattr(pmod.net, name)(port_obs, torch.from_numpy(actions)), want)
    want, _ = jmod.actor_net.apply({"params": jstate.params["actor"]}, jax_obs, None, True, False,
                                   method="get_actions")
    with torch.no_grad():
        got, _ = pmod.net.actor.get_actions(port_obs, deterministic=True)
    _close(got, want)


def test_ril_converted_by_both_computes_the_same_actions(tmp_path):
    ckpt = write_lightning(reference_model("ril"), tmp_path / "ril.ckpt")
    jax_out, port_out = _convert_both("ril", ckpt, RIL_CFG, RIL_CFG, tmp_path)
    jmod, jstate = jax_load(jax_out)
    pmod, _ = load_module_from_checkpoint(port_out, device="cpu")
    port_obs, jax_obs = _obs(np.random.RandomState(3))
    j_sub = jmod.net.apply({"params": jstate.params}, jax_obs["observation"], jax_obs["goal"],
                           method="high_level_action")
    j_act = jmod.net.apply({"params": jstate.params}, jax_obs["observation"], j_sub, method="low_level_action")
    with torch.no_grad():
        p_sub = pmod.net.high_level_action(port_obs["observation"], port_obs["goal"])
        p_act = pmod.net.low_level_action(port_obs["observation"], p_sub)
    _close(p_sub, j_sub)
    _close(p_act, j_act)


def test_tacorl_converted_by_both_computes_the_same_q_and_plans(converted_lmps, tmp_path):
    _, jax_lmp, port_lmp = converted_lmps["gru"]
    ckpt = write_lightning(reference_tacorl("gru"), tmp_path / "tacorl.ckpt")
    jax_out, port_out = _convert_both(
        "tacorl", ckpt, tacorl_cfg(jax_lmp, "gru"), tacorl_cfg(port_lmp, "gru"), tmp_path
    )
    jmod, jstate = jax_load(jax_out)
    pmod, _ = load_module_from_checkpoint(port_out, device="cpu")
    port_obs, jax_obs = _obs(np.random.RandomState(4))
    plans = np.random.RandomState(5).uniform(-1, 1, (3, LP)).astype(np.float32)
    want = jmod.critic_net.apply({"params": jstate.params["q1"]}, jax_obs, jax.numpy.asarray(plans))
    with torch.no_grad():
        _close(pmod.net.q1(port_obs, torch.from_numpy(plans)), want)
    want, _ = jmod.actor_net.apply({"params": jstate.params["actor"]}, jax_obs, None, True, False,
                                   method="get_actions")
    with torch.no_grad():
        got, _ = pmod.net.actor.get_actions(port_obs, deterministic=True)
    _close(got, want)
    # the converted decoder is the checkpoint's, not the grafted Play-LMP's
    ref = torch_convert.load_lightning_state_dict(ckpt)
    folded = pmod.net.state_dict()["action_decoder.rnn.bias_ih_l0"]
    torch.testing.assert_close(folded[:32], ref["action_decoder.rnn.bias_ih_l0"][:32]
                               + ref["action_decoder.rnn.bias_hh_l0"][:32], rtol=0, atol=0)


@pytest.fixture(scope="module")
def eval_set(tmp_path_factory):
    from tacorl_tpu_torch.data.expert_play import generate_expert_play

    root = tmp_path_factory.mktemp("eval_set")
    generate_expert_play(root, n_train_episodes=1, n_val_episodes=2, tasks_per_episode=2,
                         idle_steps=(3, 5), seed=3, distinct_tasks=True)
    return root / "validation"


def _convert_for_evaluate(kind, root):
    """A Lightning checkpoint of ``kind`` converted by the port, its module
    config given the evaluation transforms a camera frame needs (a tacorl
    one names a converted Play-LMP); returns the run directory."""
    rgb = {"rgb_static": {"kind": "rgb", "size": [HW, HW]}}
    if kind == "tacorl":
        lmp = _convert_for_evaluate("play_lmp", root)
        cfg = tacorl_cfg(lmp, "lstm")
    else:
        cfg = {"play_lmp": lmp_cfg("lstm"), "cql": CQL_CFG, "ril": RIL_CFG}[kind]
    cfg = dict(cfg, transforms=rgb)
    ckpt = write_lightning(reference_model(kind, "lstm"), root / f"{kind}.ckpt")
    save_yaml(cfg, root / f"{kind}.yaml")  # a bare module config is read as well
    convert_checkpoint.main(["--ckpt", str(ckpt), "--module-config", str(root / f"{kind}.yaml"),
                             "--out", str(root / kind), "--kind", kind, "--device", "cpu"])
    return root / kind


@pytest.mark.parametrize("kind", ["play_lmp", "cql", "tacorl", "ril"])
def test_evaluate_scores_a_converted_checkpoint(eval_set, tmp_path, kind):
    """``python -m tacorl_tpu_torch.evaluate`` loads what the converter
    wrote (step 0) and scores it with the short-horizon protocol."""
    import json

    from tacorl_tpu_torch import evaluate

    run = _convert_for_evaluate(kind, tmp_path)
    out = tmp_path / "results.json"
    evaluate.main([
        "+device=cpu", f"module_path={run}", f"data_dir={eval_set}",
        "eval_type=short_horizon", f"filename={out}", "min_seq_len=1", "max_seq_len=400",
        "max_rollouts=1", "plan_duration=3", "env.max_episode_steps=4",
    ])
    results = json.loads(out.read_text())
    assert results and all(row["num_rollouts"] == 1 for row in results.values())
