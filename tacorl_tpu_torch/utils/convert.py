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
  * the decoder's GRU cells ``ir/iz/in``, ``hr/hz/hn`` -> the r, z, n
    thirds of torch's packed ``weight_ih``/``weight_hh``/``bias_ih``,
    ``bias_hh`` = (0, 0, ``hn`` bias); the LSTM cells ``ii/if/ig/io``
    (no bias) and ``hi/hf/hg/ho`` -> the i, f, g, o quarters,
    ``bias_ih`` = 0; the MLP stand-in ``mlp{0,1,2}`` as they are
  * the other encoders (``encoder_state_dict`` tells them apart by their
    layer names): flax's auto-named ``TorchConv_{i}``, ``TorchDense_{i}``,
    ``BatchNorm_{i}``, ``LayerNorm_0`` -> the port's named layers; ResNet-18's
    ``stem_*`` / ``stage{s}_block{b}`` / ``head`` -> torchvision's keys.
    BatchNorm ``scale`` -> ``weight`` and, when the ``batch_stats``
    collection is given, ``mean``/``var`` -> ``running_mean``/``running_var``
  * the posterior's top-level ``LayerNorm_{0,1}`` -> ``positional_norm``
    and ``encoder_norm``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "vision_encoder_state_dict",
    "encoder_state_dict",
    "rnn_state_dict",
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


def plan_recognition_state_dict(p: Mapping, positional_normalize: Optional[bool] = None) -> StateDict:
    """A posterior's keys. The transformer's top-level LayerNorms are
    numbered in the order flax made them: with both options ``LayerNorm_0``
    is the positional one and ``LayerNorm_1`` the encoder's; with one,
    ``positional_normalize`` says which it is."""
    if "_BiRNN_0" in p:
        return _birnn_posterior(p)
    sd = {"position_embeddings.weight": _t(p["Embed_0"]["embedding"])}
    norms = sorted(k for k in p if k.startswith("LayerNorm_"))
    if len(norms) == 2:
        names = ["positional_norm", "encoder_norm"]
    elif norms and positional_normalize is None:
        raise ValueError(
            "the posterior has one LayerNorm: pass positional_normalize to say "
            "whether it is the positional or the encoder LayerNorm"
        )
    else:
        names = ["positional_norm" if positional_normalize else "encoder_norm"][: len(norms)]
    for key, name in zip(norms, names):
        sd.update(_layernorm(p[key], f"{name}."))
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


def _kernel_t(p: Mapping) -> np.ndarray:
    return np.asarray(p["kernel"]).T


def rnn_state_dict(p: Mapping) -> StateDict:
    """A ``StackedRNN`` subtree (``cell{i}``, or ``mlp{0,1,2}``) -> torch's
    ``nn.RNN`` / ``nn.GRU`` / ``nn.LSTM`` keys (or the MLP's)."""
    if "mlp0" in p:
        sd: StateDict = {}
        for name in ("mlp0", "mlp1", "mlp2"):
            sd.update(_dense(p[name], f"{name}."))
        return sd
    sd = {}
    i = 0
    while f"cell{i}" in p:
        cell = p[f"cell{i}"]
        if "ir" in cell:  # GRU: gates r, z, n
            gates = ("r", "z", "n")
            w_ih = np.concatenate([_kernel_t(cell[f"i{g}"]) for g in gates])
            b_ih = np.concatenate([np.asarray(cell[f"i{g}"]["bias"]) for g in gates])
            w_hh = np.concatenate([_kernel_t(cell[f"h{g}"]) for g in gates])
            h = w_hh.shape[1]
            b_hh = np.concatenate([np.zeros(2 * h, np.float32), np.asarray(cell["hn"]["bias"])])
        elif "ii" in cell:  # LSTM: gates i, f, g, o, biases on the h side
            gates = ("i", "f", "g", "o")
            w_ih = np.concatenate([_kernel_t(cell[f"i{g}"]) for g in gates])
            w_hh = np.concatenate([_kernel_t(cell[f"h{g}"]) for g in gates])
            b_ih = np.zeros(w_hh.shape[0], np.float32)
            b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
        else:  # ReLU RNN: no recurrent bias
            w_ih, b_ih = _kernel_t(cell["i"]), np.asarray(cell["i"]["bias"])
            w_hh = _kernel_t(cell["h"])
            b_hh = np.zeros(w_hh.shape[0], np.float32)
        for name, value in (("weight_ih", w_ih), ("bias_ih", b_ih), ("weight_hh", w_hh), ("bias_hh", b_hh)):
            sd[f"{name}_l{i}"] = _t(value)
        i += 1
    return sd


def action_decoder_state_dict(p: Mapping) -> StateDict:
    """``ActionDecoderLogistic`` (the RNN, the mixture heads and, with a
    discrete gripper, ``gripper_fc``; the continuous decoder has none) or
    ``ActionDecoderGaussian`` (the RNN, ``pi_fc``, ``log_var_fc``,
    ``mu_fc``)."""
    sd = _prefixed("rnn.", rnn_state_dict(p["rnn"]))
    for name in ("mean_fc", "log_scale_fc", "prob_fc", "gripper_fc", "pi_fc", "log_var_fc", "mu_fc"):
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


def _batchnorm(p: Mapping, stats: Optional[Mapping], prefix: str) -> StateDict:
    sd = {f"{prefix}weight": _t(p["scale"]), f"{prefix}bias": _t(p["bias"])}
    if stats is not None:
        sd[f"{prefix}running_mean"] = _t(stats["mean"])
        sd[f"{prefix}running_var"] = _t(stats["var"])
    return sd


def _numbered(p: Mapping, stem: str):
    i = 0
    while f"{stem}_{i}" in p:
        yield i, p[f"{stem}_{i}"]
        i += 1


def _custom_encoder(p: Mapping, vib: Optional[bool]) -> StateDict:
    sd: StateDict = {}
    for i, conv in _numbered(p, "TorchConv"):
        sd.update(_conv(conv, f"convs.{i}."))
    heads = ("fc_mean", "fc_log_std") if _vib_head(p, vib) else ("fc1", "fc2")
    for (_, dense), name in zip(_numbered(p, "TorchDense"), heads):
        sd.update(_dense(dense, f"{name}."))
    if "LayerNorm_0" in p:
        sd.update(_layernorm(p["LayerNorm_0"], "layernorm."))
    return sd


def _vib_head(p: Mapping, vib: Optional[bool]) -> bool:
    """Whether a CustomEncoder's two denses are the VIB head (both read the
    flattened features, both as wide as the latent) rather than fc1 -> fc2
    (the second reads the first's output). ``vib`` says which; without it
    the shapes decide, and where they fit both (a latent or a hidden layer
    as wide as the features) the converter refuses to guess."""
    (f_in, d0_out), (d1_in, d1_out) = (np.shape(p[f"TorchDense_{i}"]["kernel"]) for i in (0, 1))
    fits = {True: d1_in == f_in and d1_out == d0_out and "LayerNorm_0" not in p, False: d1_in == d0_out}
    if vib is not None:
        if not fits[vib]:
            raise ValueError(f"a CustomEncoder with vib={vib} has no denses of shapes {(f_in, d0_out)}, {(d1_in, d1_out)}")
        return vib
    if fits[True] == fits[False]:
        raise ValueError(
            f"CustomEncoder denses {(f_in, d0_out)}, {(d1_in, d1_out)} fit both the VIB head and fc1 -> fc2: "
            "pass vib= to encoder_state_dict"
        )
    return fits[True]


def _resnet_rl_encoder(p: Mapping) -> StateDict:
    sd: StateDict = {}
    for i, conv in _numbered(p, "TorchConv"):
        sd.update(_conv(conv, f"conv{i + 1}."))
    for i, block in _numbered(p, "_ResidualBlock"):
        sd.update(_conv(block["TorchConv_0"], f"res_blocks.{i}.conv1."))
        sd.update(_conv(block["TorchConv_1"], f"res_blocks.{i}.conv2."))
    sd["ssam.temperature"] = _t(p["SpatialSoftArgmax_0"]["temperature"])
    sd.update(_dense(p["TorchDense_0"], "fc."))
    if "LayerNorm_0" in p:
        sd.update(_layernorm(p["LayerNorm_0"], "layernorm."))
    return sd


def _deep_spatial_encoder(p: Mapping, stats: Optional[Mapping]) -> StateDict:
    sd: StateDict = {}
    for i, conv in _numbered(p, "TorchConv"):
        sd.update(_conv(conv, f"convs.{i}."))
    for i, bn in _numbered(p, "BatchNorm"):
        sd.update(_batchnorm(bn, None if stats is None else stats[f"BatchNorm_{i}"], f"bns.{i}."))
    if "SpatialSoftArgmax_0" in p:
        sd["ssam.temperature"] = _t(p["SpatialSoftArgmax_0"]["temperature"])
    return sd


def _resnet18(p: Mapping, stats: Optional[Mapping]) -> StateDict:
    """``ResNet18Encoder`` -> torchvision's resnet18 keys."""
    st = stats or {}
    sd = _conv(p["stem_conv"], "conv1.")
    sd.update(_batchnorm(p["stem_bn"], st.get("stem_bn"), "bn1."))
    for name, block in p.items():
        if not name.startswith("stage"):
            continue
        stage, b = (int(v) for v in name[len("stage"):].split("_block"))
        prefix, bst = f"layer{stage + 1}.{b}.", st.get(name, {})
        for layer in ("conv1", "conv2"):
            sd.update(_conv(block[layer], f"{prefix}{layer}."))
        for layer in ("bn1", "bn2"):
            sd.update(_batchnorm(block[layer], bst.get(layer), f"{prefix}{layer}."))
        if "downsample_conv" in block:
            sd.update(_conv(block["downsample_conv"], f"{prefix}downsample.0."))
            sd.update(_batchnorm(block["downsample_bn"], bst.get("downsample_bn"), f"{prefix}downsample.1."))
    sd.update(_dense(p["head"], "fc."))
    return sd


def encoder_state_dict(
    p: Mapping, batch_stats: Optional[Mapping] = None, vib: Optional[bool] = None
) -> StateDict:
    """Any encoder of ``networks/encoders.py`` or ``networks/resnet.py``,
    told apart by its layer names; ``batch_stats`` is the encoder's
    ``batch_stats`` collection, where it has BatchNorm (without it the
    running statistics keep the port's initial 0 and 1). ``vib`` is a
    CustomEncoder's option, needed only where its shapes leave it open."""
    if "conv1" in p:
        return vision_encoder_state_dict(p)
    if "stem_conv" in p:
        return _resnet18(p, batch_stats)
    if "backbone" in p:
        sd = _prefixed("backbone.", _resnet18(p["backbone"], (batch_stats or {}).get("backbone")))
        sd.update(_dense(p["head1"], "head1."))
        sd.update(_dense(p["head2"], "head2."))
        return sd
    if "TorchConv_0" in p and "TorchDense_0" not in p:
        return _deep_spatial_encoder(p, batch_stats)
    if "SpatialSoftArgmax_0" in p:
        return _resnet_rl_encoder(p)
    if "TorchConv_0" in p:
        return _custom_encoder(p, vib)
    sd = {}
    for i, dense in _numbered(p, "TorchDense"):
        sd.update(_dense(dense, f"fc_layers.{i}."))
    return sd


def _late_fusion(p: Mapping, modalities: Sequence[str]) -> StateDict:
    sd: StateDict = {}
    for i, modality in enumerate(modalities):
        sd.update(_prefixed(f"networks.{modality}.", encoder_state_dict(p[f"encoders_{i}_1"])))
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
