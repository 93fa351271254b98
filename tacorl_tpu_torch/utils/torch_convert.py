"""Reference PyTorch-Lightning checkpoints -> port state_dicts (port of
tacorl_tpu/utils/torch_convert.py).

The port's networks keep the reference TACO-RL ``state_dict`` layout
(``utils/convert.py``), so a released checkpoint's tensors load under their
own keys. Three things differ, and the functions here handle them:

  * A Lightning ``.ckpt`` holds more than the network: ``ckpt["state_dict"]``
    is read (``load_lightning_state_dict``) and only the keys of the kind's
    networks are kept.
  * The port's recurrent layers compute the JAX package's flax cells, whose
    biases sit on fewer terms than torch's. The biases the flax cell lacks
    are held at zero and take no gradient in the port. So the recurrent
    biases are folded as the JAX converter folds them (``convert_rnn``):
    ReLU RNN, ``bias_hh`` into ``bias_ih`` and ``bias_hh`` = 0; GRU, the r
    and z thirds of ``bias_hh`` into ``bias_ih``, the n third kept; LSTM,
    ``bias_ih`` into ``bias_hh`` and ``bias_ih`` = 0. The sums add into the
    same pre-activations, so the function is the same. The biRNN
    posteriors' ``bias_hh`` fold like the ReLU RNN's.
  * Every tensor is float32; ``log_alpha`` and ``log_alpha_prime`` are (1,).

One function a released kind: ``play_lmp_state_dict_from_lightning``,
``cql_state_dict_from_lightning`` and ``tacorl_state_dict_from_lightning``
(with the target critics, which the JAX converter returns as ``aux``) and
``ril_state_dict_from_lightning``. Each takes the module config, from which
it reads the decoder's recurrent type and depth, as
``scripts/convert_checkpoint.py`` reads the widths. ``convert`` picks one by
kind. The result equals ``*_state_dict_from_jax`` of the JAX converter's
``assemble_*`` output key for key.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch

__all__ = [
    "KINDS",
    "load_lightning_state_dict",
    "fold_rnn_biases",
    "play_lmp_state_dict_from_lightning",
    "cql_state_dict_from_lightning",
    "tacorl_state_dict_from_lightning",
    "ril_state_dict_from_lightning",
    "convert",
]

StateDict = Dict[str, torch.Tensor]

KINDS = ("play_lmp", "tacorl", "cql", "ril")

_CQL = ("actor.", "q1.", "q2.", "target_q1.", "target_q2.", "log_alpha", "log_alpha_prime")
_LMP_PARTS = ("perceptual_encoder.", "goal_encoder.", "plan_recognition.", "action_decoder.")
_PREFIXES = {
    "play_lmp": _LMP_PARTS + ("plan_proposal.policy.",),
    "cql": _CQL,
    "tacorl": _CQL + _LMP_PARTS,
    "ril": ("perceptual_encoder.", "goal_encoder.", "high_level_policy.policy.", "low_level_policy.policy."),
}
_GATES = {"rnn": 1, "gru": 3, "lstm": 4}


def _float32(value: Any) -> torch.Tensor:
    if torch.is_tensor(value):
        return value.detach().to(device="cpu", dtype=torch.float32).clone()
    return torch.from_numpy(np.array(value, dtype=np.float32))


def load_lightning_state_dict(ckpt_path) -> StateDict:
    """A PyTorch-Lightning ``.ckpt``'s ``state_dict`` (or the file itself
    when it is a bare state_dict), read on the CPU. A Lightning checkpoint
    pickles more than tensors (hyper-parameters, loop state), so the file
    is unpickled in full, as the JAX package reads it: convert only
    checkpoints from a source you trust."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def fold_rnn_biases(sd: Mapping[str, torch.Tensor], prefix: str, rnn_type: str, num_layers: int) -> StateDict:
    """The ``prefix``-ed recurrent layer's biases folded onto the terms the
    flax cell has (module docstring); ``rnn_type`` is ``rnn``, ``gru`` or
    ``lstm``. Raises when the checkpoint's depth or gate count is not the
    config's."""
    out: StateDict = {}
    found = sum(1 for k in sd if k.startswith(f"{prefix}bias_ih_l") and not k.endswith("_reverse"))
    if found != num_layers:
        raise ValueError(f"{prefix}: the checkpoint has {found} recurrent layers, the config {num_layers}")
    for i in range(num_layers):
        b_ih, b_hh = _float32(sd[f"{prefix}bias_ih_l{i}"]), _float32(sd[f"{prefix}bias_hh_l{i}"])
        h = _float32(sd[f"{prefix}weight_hh_l{i}"]).shape[1]
        if b_ih.shape[0] != _GATES[rnn_type] * h:
            raise ValueError(f"{prefix}: {b_ih.shape[0] // h} gates a layer, not a {rnn_type}'s {_GATES[rnn_type]}")
        if rnn_type == "rnn":
            b_ih, b_hh = b_ih + b_hh, torch.zeros_like(b_hh)
        elif rnn_type == "gru":
            b_ih = torch.cat([b_ih[: 2 * h] + b_hh[: 2 * h], b_ih[2 * h:]])
            b_hh = torch.cat([torch.zeros(2 * h), b_hh[2 * h:]])
        else:
            b_ih, b_hh = torch.zeros_like(b_ih), b_ih + b_hh
        out[f"{prefix}bias_ih_l{i}"], out[f"{prefix}bias_hh_l{i}"] = b_ih, b_hh
    return out


def _fold_birnn(sd: Mapping[str, torch.Tensor], prefix: str) -> StateDict:
    """A biRNN posterior's ``bias_hh_*`` folded into its ``bias_ih_*``."""
    out: StateDict = {}
    for key in [k for k in sd if k.startswith(f"{prefix}bias_hh_")]:
        ih = key.replace("bias_hh_", "bias_ih_")
        out[ih] = _float32(sd[ih]) + _float32(sd[key])
        out[key] = torch.zeros_like(out[ih])
    return out


def _select(sd: Mapping[str, Any], prefixes: Sequence[str]) -> StateDict:
    out = {
        k: _float32(v) for k, v in sd.items()
        if any(k == p or (p.endswith(".") and k.startswith(p)) for p in prefixes)
    }
    for name in ("log_alpha", "log_alpha_prime"):
        if name in out:
            out[name] = out[name].reshape(1)
    return out


def _decoder_type(module_cfg: Mapping[str, Any]):
    """(rnn type, depth) of the action decoder, read from the config as
    ``scripts/convert_checkpoint.py:_lmp_kwargs`` reads them."""
    ad_cfg = module_cfg.get("action_decoder", {}) or {}
    return str(ad_cfg.get("rnn_model", "rnn_decoder")).replace("_decoder", ""), int(ad_cfg.get("num_layers", 2))


def _lmp_parts(sd: Mapping[str, Any], module_cfg: Mapping[str, Any], prefixes) -> StateDict:
    out = _select(sd, prefixes)
    rnn_type, num_layers = _decoder_type(module_cfg)
    if rnn_type in _GATES:  # the MLP stand-in has no recurrent biases
        out.update(fold_rnn_biases(out, "action_decoder.rnn.", rnn_type, num_layers))
    out.update(_fold_birnn(out, "plan_recognition.birnn_model."))
    return out


def play_lmp_state_dict_from_lightning(sd: Mapping[str, Any], module_cfg: Mapping[str, Any]) -> StateDict:
    """A reference PlayLMP checkpoint's state_dict -> the port
    ``PlayLMPNet``'s (the counterpart of ``assemble_play_lmp``)."""
    return _lmp_parts(sd, module_cfg, _PREFIXES["play_lmp"])


def cql_state_dict_from_lightning(sd: Mapping[str, Any], module_cfg: Mapping[str, Any]) -> StateDict:
    """A reference CQL_Offline checkpoint -> the port ``CQLNet``'s
    state_dict: actor, critics, target critics, ``log_alpha`` and, with the
    Lagrange term, ``log_alpha_prime`` (``assemble_cql``'s params and
    aux)."""
    return _select(sd, _PREFIXES["cql"])


def tacorl_state_dict_from_lightning(sd: Mapping[str, Any], module_cfg: Mapping[str, Any]) -> StateDict:
    """A reference TACORL checkpoint -> the port ``TACORLNet``'s state_dict:
    the CQL keys and the frozen Play-LMP parts with the decoder
    (``assemble_tacorl``'s params and aux)."""
    return _lmp_parts(sd, module_cfg, _PREFIXES["tacorl"])


def ril_state_dict_from_lightning(sd: Mapping[str, Any], module_cfg: Mapping[str, Any]) -> StateDict:
    """A reference RelayImitationLearning checkpoint -> the port
    ``RILNet``'s state_dict (``assemble_ril``)."""
    return _select(sd, _PREFIXES["ril"])


_CONVERTERS: Dict[str, Callable[[Mapping[str, Any], Mapping[str, Any]], StateDict]] = {
    "play_lmp": play_lmp_state_dict_from_lightning,
    "cql": cql_state_dict_from_lightning,
    "tacorl": tacorl_state_dict_from_lightning,
    "ril": ril_state_dict_from_lightning,
}


def convert(kind: str, sd: Mapping[str, Any], module_cfg: Mapping[str, Any]) -> StateDict:
    """The port state_dict of a released checkpoint of ``kind``."""
    if kind not in _CONVERTERS:
        raise ValueError(f"unknown kind {kind!r}; choose from {list(KINDS)}")
    return _CONVERTERS[kind](sd, module_cfg)
