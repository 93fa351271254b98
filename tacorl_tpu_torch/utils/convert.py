"""JAX param trees -> port state_dicts.

``play_lmp_state_dict_from_jax`` turns the JAX ``PlayLMPNet`` param tree
(nested dicts of numpy arrays) into the port's ``PlayLMPNet`` state_dict,
the inverse of ``tacorl_tpu/utils/torch_convert.py:assemble_play_lmp``;
``cql_state_dict_from_jax`` and ``tacorl_state_dict_from_jax`` do the same
for the CQL and TACO-RL params and target critics (the inverses of
``assemble_cql`` and ``assemble_tacorl``);
``play_lmp_d4rl_state_dict_from_jax`` and ``tacorl_d4rl_state_dict_from_jax``
do it for the D4RL branch's state-based modules (no encoders; the
continuous decoder has no ``gripper_fc``); ``ril_state_dict_from_jax`` for
the RIL net (the inverse of ``assemble_ril``); the per-network functions do it
for one network's subtree. The keys are
the reference TACO-RL layout, so the same state_dict is what a released
reference checkpoint holds. Layouts:

  * dense (in, out) -> (out, in); conv HWIO -> OIHW
  * attention query/key/value (d, heads, hd) -> rows of ``in_proj_weight``;
    out (heads, hd, d) -> ``out_proj.weight``
  * ``Embed_0`` -> ``position_embeddings``; LayerNorm ``scale`` -> ``weight``
  * the hoisted RNN's ``cell{i}/i`` -> ``weight_ih_l{i}``/``bias_ih_l{i}``,
    ``cell{i}/h`` -> ``weight_hh_l{i}``; ``bias_hh_l{i}`` = 0 (the JAX layer
    has no recurrent bias)
  * late fusion ``encoders_{i}_1`` -> ``networks.<i-th image modality>``;
    ``modalities`` names the image modalities only: vector modalities have
    no encoder and no parameters, and a state-based CQL net (flat arrays)
    has neither an encoder nor a goal encoder
  * the VIB head of ``LMPVisionEncoder`` (``vib: true``): ``fc_mean``,
    ``fc_log_std`` in place of ``fc1``/``fc2``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "vision_encoder_state_dict",
    "goal_encoder_state_dict",
    "plan_recognition_state_dict",
    "mlp_policy_state_dict",
    "action_decoder_state_dict",
    "q_network_state_dict",
    "visual_actor_state_dict",
    "visual_critic_state_dict",
    "play_lmp_state_dict_from_jax",
    "cql_state_dict_from_jax",
    "tacorl_state_dict_from_jax",
    "play_lmp_d4rl_state_dict_from_jax",
    "tacorl_d4rl_state_dict_from_jax",
    "ril_state_dict_from_jax",
]

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(p: Mapping, prefix: str) -> StateDict:
    sd = {f"{prefix}weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        sd[f"{prefix}bias"] = _t(p["bias"])
    return sd


def _conv(p: Mapping, prefix: str) -> StateDict:
    sd = {f"{prefix}weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))}
    if "bias" in p:
        sd[f"{prefix}bias"] = _t(p["bias"])
    return sd


def _layernorm(p: Mapping, prefix: str) -> StateDict:
    return {f"{prefix}weight": _t(p["scale"]), f"{prefix}bias": _t(p["bias"])}


def _attention(p: Mapping, prefix: str) -> StateDict:
    d = np.asarray(p["query"]["kernel"]).shape[0]
    qkv = ("query", "key", "value")
    return {
        f"{prefix}in_proj_weight": _t(
            np.concatenate([np.asarray(p[k]["kernel"]).reshape(d, d).T for k in qkv])
        ),
        f"{prefix}in_proj_bias": _t(
            np.concatenate([np.asarray(p[k]["bias"]).reshape(d) for k in qkv])
        ),
        f"{prefix}out_proj.weight": _t(np.asarray(p["out"]["kernel"]).reshape(d, d).T),
        f"{prefix}out_proj.bias": _t(p["out"]["bias"]),
    }


def _prefixed(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def vision_encoder_state_dict(p: Mapping) -> StateDict:
    """``LMPVisionEncoder``: conv1-3 -> ``model.{0,2,4}``, ssam ->
    ``model.6``, fc1/fc2 -> ``fc_layers.{0,3}`` (or the VIB head's
    ``fc_mean``/``fc_log_std``)."""
    sd: StateDict = {}
    for j, name in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
        sd.update(_conv(p[name], f"model.{j}."))
    if "ssam" in p:
        sd["model.6.temperature"] = _t(p["ssam"]["temperature"])
    if "fc_mean" in p:
        sd.update(_dense(p["fc_mean"], "fc_mean."))
        sd.update(_dense(p["fc_log_std"], "fc_log_std."))
    else:
        sd.update(_dense(p["fc1"], "fc_layers.0."))
        sd.update(_dense(p["fc2"], "fc_layers.3."))
    if "layernorm" in p:
        sd.update(_layernorm(p["layernorm"], "layernorm."))
    return sd


def goal_encoder_state_dict(p: Mapping) -> StateDict:
    sd: StateDict = {}
    for j, k in enumerate((0, 2, 4)):
        sd.update(_dense(p[f"TorchDense_{j}"], f"mlp.{k}."))
    if "LayerNorm_0" in p:
        sd.update(_layernorm(p["LayerNorm_0"], "layernorm."))
    return sd


def _birnn_posterior(p: Mapping) -> StateDict:
    """``PlanRecognition(Tanh)BiRNN``: the cells ``SimpleCell_{2l}`` (layer
    l forward) and ``SimpleCell_{2l+1}`` (backward) -> ``birnn_model``;
    ``TorchDense_0/1`` -> ``mean_fc``/``variance_fc``."""
    sd: StateDict = {}
    cells = p["_BiRNN_0"]
    i = 0
    while f"SimpleCell_{i}" in cells:
        cell = cells[f"SimpleCell_{i}"]
        key = f"l{i // 2}" + ("_reverse" if i % 2 else "")
        sd[f"birnn_model.weight_ih_{key}"] = _t(np.asarray(cell["i"]["kernel"]).T)
        sd[f"birnn_model.bias_ih_{key}"] = _t(cell["i"]["bias"])
        wh = np.asarray(cell["h"]["kernel"]).T
        sd[f"birnn_model.weight_hh_{key}"] = _t(wh)
        sd[f"birnn_model.bias_hh_{key}"] = torch.zeros(wh.shape[0])
        i += 1
    sd.update(_dense(p["TorchDense_0"], "mean_fc."))
    sd.update(_dense(p["TorchDense_1"], "variance_fc."))
    return sd


def plan_recognition_state_dict(p: Mapping) -> StateDict:
    if "_BiRNN_0" in p:
        return _birnn_posterior(p)
    if any(k.startswith("LayerNorm") for k in p):
        raise NotImplementedError(
            "positional/encoder LayerNorms of the posterior are not mapped yet"
        )
    sd = {"position_embeddings.weight": _t(p["Embed_0"]["embedding"])}
    sd.update(_dense(p["TorchDense_0"], "fc."))
    sd.update(_dense(p["TorchDense_1"], "mean_fc."))
    sd.update(_dense(p["TorchDense_2"], "variance_fc."))
    i = 0
    while f"_PostLNEncoderLayer_{i}" in p:
        layer = p[f"_PostLNEncoderLayer_{i}"]
        lp = f"transformer_encoder.layers.{i}."
        sd.update(_attention(layer["MultiHeadDotProductAttention_0"], f"{lp}self_attn."))
        sd.update(_dense(layer["TorchDense_0"], f"{lp}linear1."))
        sd.update(_dense(layer["TorchDense_1"], f"{lp}linear2."))
        sd.update(_layernorm(layer["LayerNorm_0"], f"{lp}norm1."))
        sd.update(_layernorm(layer["LayerNorm_1"], f"{lp}norm2."))
        i += 1
    return sd


def mlp_policy_state_dict(p: Mapping) -> StateDict:
    sd: StateDict = {}
    i = 0
    while f"fc{i}" in p:
        sd.update(_dense(p[f"fc{i}"], f"fc_layers.{i}."))
        i += 1
    for name in ("fc_mean", "fc_log_std", "gripper_action"):
        if name in p:
            sd.update(_dense(p[name], f"{name}."))
    return sd


def action_decoder_state_dict(p: Mapping) -> StateDict:
    """``ActionDecoderLogistic``: the RNN cells, the mixture heads and, with
    a discrete gripper, ``gripper_fc`` (the continuous decoder has none)."""
    sd: StateDict = {}
    rnn = p["rnn"]
    i = 0
    while f"cell{i}" in rnn:
        cell = rnn[f"cell{i}"]
        sd[f"rnn.weight_ih_l{i}"] = _t(np.asarray(cell["i"]["kernel"]).T)
        sd[f"rnn.bias_ih_l{i}"] = _t(cell["i"]["bias"])
        wh = np.asarray(cell["h"]["kernel"]).T
        sd[f"rnn.weight_hh_l{i}"] = _t(wh)
        sd[f"rnn.bias_hh_l{i}"] = torch.zeros(wh.shape[0])
        i += 1
    for name in ("mean_fc", "log_scale_fc", "prob_fc", "gripper_fc"):
        if name in p:
            sd.update(_dense(p[name], f"{name}."))
    return sd


def q_network_state_dict(p: Mapping) -> StateDict:
    """``MLPQNetwork``: ``fc{i}`` -> ``fc_layers.{i}``, ``out``."""
    sd: StateDict = {}
    i = 0
    while f"fc{i}" in p:
        sd.update(_dense(p[f"fc{i}"], f"fc_layers.{i}."))
        i += 1
    sd.update(_dense(p["out"], "out."))
    return sd


def _late_fusion(p: Mapping, modalities: Sequence[str]) -> StateDict:
    sd: StateDict = {}
    for i, modality in enumerate(modalities):
        sd.update(_prefixed(
            f"networks.{modality}.", vision_encoder_state_dict(p[f"encoders_{i}_1"])
        ))
    return sd


def _wrapper_encoders(p: Mapping, modalities: Sequence[str]) -> StateDict:
    """A wrapper's ``encoder.*`` and ``goal_encoder.*``, where it has them."""
    sd = _prefixed("encoder.", _late_fusion(p.get("encoder", {}), modalities))
    if "goal_encoder" in p:
        sd.update(_prefixed("goal_encoder.", goal_encoder_state_dict(p["goal_encoder"])))
    return sd


def visual_critic_state_dict(p: Mapping, modalities: Sequence[str] = ("rgb_static",)) -> StateDict:
    """``VisualCriticWrapper``: ``encoder.networks.*``, ``goal_encoder.mlp.*``,
    ``critic.Q.*`` (the inverse of ``convert_visual_critic``)."""
    sd = _wrapper_encoders(p, modalities)
    sd.update(_prefixed("critic.Q.", q_network_state_dict(p["critic"]["q_network"])))
    return sd


def visual_actor_state_dict(p: Mapping, modalities: Sequence[str] = ("rgb_static",)) -> StateDict:
    """``VisualActorWrapper``: ``encoder.networks.*``, ``goal_encoder.mlp.*``,
    ``actor.policy.*`` (the inverse of ``convert_visual_actor``)."""
    sd = _wrapper_encoders(p, modalities)
    sd.update(_prefixed("actor.policy.", mlp_policy_state_dict(p["actor"]["policy"])))
    return sd


def cql_state_dict_from_jax(
    params: Mapping[str, Any], aux: Mapping[str, Any],
    modalities: Sequence[str] = ("rgb_static",),
) -> StateDict:
    """JAX ``CQLModule`` params and aux (the target critics) -> port
    ``CQLNet`` state_dict (the inverse of ``assemble_cql``). The same tree
    serves ``SACModule`` and ``CQLOnlineModule``: ``log_alpha_prime`` is
    carried exactly when the JAX state has one (SAC defaults
    ``with_lagrange`` to False, ``configs/module/cql_online.yaml`` sets
    it)."""
    sd = _prefixed("actor.", visual_actor_state_dict(params["actor"], modalities))
    for name, tree in (("q1", params["q1"]), ("q2", params["q2"]),
                       ("target_q1", aux["target_q1"]), ("target_q2", aux["target_q2"])):
        sd.update(_prefixed(f"{name}.", visual_critic_state_dict(tree, modalities)))
    sd["log_alpha"] = _t(np.asarray(params["log_alpha"]).reshape(1))
    if "log_alpha_prime" in params:
        sd["log_alpha_prime"] = _t(np.asarray(params["log_alpha_prime"]).reshape(1))
    return sd


def tacorl_state_dict_from_jax(
    params: Mapping[str, Any], aux: Mapping[str, Any],
    modalities: Sequence[str] = ("rgb_static",),
) -> StateDict:
    """JAX ``TACORLModule`` params and aux -> port ``TACORLNet`` state_dict
    (the inverse of ``assemble_tacorl``): the CQL keys and the frozen LMP
    parts and decoder at top level."""
    sd = cql_state_dict_from_jax(params, aux, modalities)
    sd.update(_prefixed(
        "perceptual_encoder.", _late_fusion(params["perceptual_encoder"], modalities)
    ))
    sd.update(_prefixed(
        "plan_recognition.", plan_recognition_state_dict(params["plan_recognition"])
    ))
    sd.update(_prefixed("goal_encoder.", goal_encoder_state_dict(params["goal_encoder"])))
    sd.update(_prefixed(
        "action_decoder.", action_decoder_state_dict(params["action_decoder"])
    ))
    return sd


def play_lmp_state_dict_from_jax(
    params: Mapping[str, Any], image_modalities: Sequence[str] = ("rgb_static",)
) -> StateDict:
    """JAX ``PlayLMPNet`` params -> port ``PlayLMPNet`` state_dict.
    ``image_modalities`` are the image modalities in the order the JAX
    LateFusion numbered its encoders (``encoders_{i}_1``)."""
    sd = _prefixed(
        "perceptual_encoder.", _late_fusion(params["perceptual_encoder"], image_modalities)
    )
    sd.update(_prefixed("goal_encoder.", goal_encoder_state_dict(params["goal_encoder"])))
    sd.update(_prefixed(
        "plan_recognition.", plan_recognition_state_dict(params["plan_recognition"])
    ))
    sd.update(_prefixed(
        "plan_proposal.policy.", mlp_policy_state_dict(params["plan_proposal"]["policy"])
    ))
    sd.update(_prefixed(
        "action_decoder.", action_decoder_state_dict(params["action_decoder"])
    ))
    return sd


def play_lmp_d4rl_state_dict_from_jax(params: Mapping[str, Any]) -> StateDict:
    """JAX ``PlayLMPD4RLNet`` params -> port ``PlayLMPD4RLNet`` state_dict:
    ``plan_recognition.*``, ``plan_proposal.policy.*``, ``action_decoder.*``."""
    sd = _prefixed("plan_recognition.", plan_recognition_state_dict(params["plan_recognition"]))
    sd.update(_prefixed(
        "plan_proposal.policy.", mlp_policy_state_dict(params["plan_proposal"]["policy"])
    ))
    sd.update(_prefixed("action_decoder.", action_decoder_state_dict(params["action_decoder"])))
    return sd


def tacorl_d4rl_state_dict_from_jax(params: Mapping[str, Any], aux: Mapping[str, Any]) -> StateDict:
    """JAX ``TACORLD4RLModule`` params and aux -> port ``TACORLD4RLNet``
    state_dict: the flat CQL keys (no encoders), the frozen posterior and
    the decoder."""
    sd = cql_state_dict_from_jax(params, aux, modalities=())
    sd.update(_prefixed("plan_recognition.", plan_recognition_state_dict(params["plan_recognition"])))
    sd.update(_prefixed("action_decoder.", action_decoder_state_dict(params["action_decoder"])))
    return sd


def ril_state_dict_from_jax(
    params: Mapping[str, Any], image_modalities: Sequence[str] = ("rgb_static",)
) -> StateDict:
    """JAX ``RILNet`` params -> port ``RILNet`` state_dict:
    ``perceptual_encoder.*``, ``goal_encoder.*``, ``high_level_policy.policy.*``
    and ``low_level_policy.policy.*`` (the inverse of ``assemble_ril``).
    ``image_modalities`` as for ``play_lmp_state_dict_from_jax``; a net over
    vector modalities alone has no encoder parameters."""
    sd = _prefixed(
        "perceptual_encoder.", _late_fusion(params.get("perceptual_encoder", {}), image_modalities)
    )
    sd.update(_prefixed("goal_encoder.", goal_encoder_state_dict(params["goal_encoder"])))
    for level in ("high_level_policy", "low_level_policy"):
        sd.update(_prefixed(f"{level}.policy.", mlp_policy_state_dict(params[level]["policy"])))
    return sd
