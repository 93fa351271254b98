"""Plan-recognition posteriors (port of
tacorl_tpu/networks/plan_recognition.py): the transformer and the
bidirectional ReLU RNNs. state_dict keys follow the reference: for the
transformer ``position_embeddings``, ``transformer_encoder.layers.{i}.*``
(``self_attn`` in_proj/out_proj, ``linear1/2``, ``norm1/2``), ``fc``,
``mean_fc``, ``variance_fc``; for the biRNNs ``birnn_model.*`` (torch's
``nn.RNN`` keys, ``_reverse`` for the backward direction), ``mean_fc``,
``variance_fc``."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from tacorl_tpu_torch.core.distributions import DiagNormal, TanhNormal
from tacorl_tpu_torch.networks.layers import TorchDense, lecun_normal_

__all__ = ["PlanRecognitionTransformer", "PlanRecognitionBiRNN", "PlanRecognitionTanhBiRNN"]

# flax LayerNorm's epsilon (torch's default is 1e-5)
_LN_EPS = 1e-6


class _PostLNEncoderLayer(nn.Module):
    """Post-LayerNorm transformer encoder layer (torch's
    TransformerEncoderLayer with norm_first=False):
    x = LN1(x + attn(x)); x = LN2(x + ffn(x)). Batch-first (B, S, D)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dropout: float):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(
            d_model, num_heads, dropout=dropout, batch_first=True
        )
        self.linear1 = TorchDense(d_model, dim_feedforward)
        self.linear2 = TorchDense(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def reset_parameters(self) -> None:
        """flax MultiHeadDotProductAttention init: lecun-normal kernels with
        fan-in d_model, zero biases."""
        d = self.self_attn.embed_dim
        lecun_normal_(self.self_attn.in_proj_weight, d)
        nn.init.zeros_(self.self_attn.in_proj_bias)
        lecun_normal_(self.self_attn.out_proj.weight, d)
        nn.init.zeros_(self.self_attn.out_proj.bias)

    def forward(self, x: Tensor) -> Tensor:
        attn = self.self_attn(x, x, x, need_weights=False)[0]
        x = self.norm1(x + self.dropout1(attn))
        h = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout2(h))


class _TransformerEncoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class PlanRecognitionTransformer(nn.Module):
    """TransformerEncoder (learned position embeddings) -> fc -> mean over
    the sequence -> TanhNormal posterior, with the zero-pad of the state to
    head-divisibility."""

    def __init__(
        self,
        state_dim: int,
        latent_plan_dim: int,
        num_heads: int = 8,
        num_layers: int = 2,
        encoder_hidden_size: int = 2048,
        fc_hidden_size: int = 4096,
        encoder_normalize: bool = False,
        positional_normalize: bool = False,
        max_position_embeddings: int = 16,
        dropout_p: float = 0.01,
        min_std: float = 1e-4,
    ):
        super().__init__()
        self.state_dim = state_dim
        self.min_std = min_std
        mod = state_dim % num_heads
        self.d_model = state_dim + (num_heads - mod if mod else 0)
        d = self.d_model
        self.position_embeddings = nn.Embedding(max_position_embeddings, d)
        self.positional_norm = nn.LayerNorm(d, eps=_LN_EPS) if positional_normalize else None
        self.dropout = nn.Dropout(dropout_p)
        self.transformer_encoder = _TransformerEncoder(
            _PostLNEncoderLayer(d, num_heads, encoder_hidden_size, dropout_p)
            for _ in range(num_layers)
        )
        self.encoder_norm = nn.LayerNorm(d, eps=_LN_EPS) if encoder_normalize else None
        self.fc = TorchDense(d, fc_hidden_size)
        self.mean_fc = TorchDense(fc_hidden_size, latent_plan_dim)
        self.variance_fc = TorchDense(fc_hidden_size, latent_plan_dim)

    def reset_parameters(self) -> None:
        """flax Embed init: truncated normal with variance 1/d_model."""
        lecun_normal_(self.position_embeddings.weight, self.d_model)

    def forward(self, perceptual_emb: Tensor) -> TanhNormal:
        b, s, d = perceptual_emb.shape
        x = F.pad(perceptual_emb, (0, self.d_model - d))
        positions = self.position_embeddings(
            torch.arange(s, device=perceptual_emb.device)
        )
        x = x + positions[None]
        if self.positional_norm is not None:
            x = self.positional_norm(x)
        x = self.transformer_encoder(self.dropout(x))
        if self.encoder_norm is not None:
            x = self.encoder_norm(x)
        x = self.fc(x).mean(dim=1)  # fc before the pool over the sequence
        mean = self.mean_fc(x)
        std = F.softplus(self.variance_fc(x)) + self.min_std
        return TanhNormal(mean, std)


class _BiRNN(nn.RNN):
    """num_layers-deep bidirectional ReLU RNN, the directions concatenated
    per layer. The JAX cells (flax ``SimpleCell``) have no recurrent bias,
    so ``bias_hh_*`` is held at zero and frozen, as in ``StackedRNN``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int):
        super().__init__(
            input_size, hidden_size, num_layers, nonlinearity="relu",
            batch_first=True, bidirectional=True,
        )
        for name, p in self.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)

    def reset_parameters(self) -> None:
        """The JAX init: kernels uniform in +-1/sqrt(hidden), biases 0."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for name, p in self.named_parameters():
            if name.startswith("bias"):
                nn.init.zeros_(p)
            else:
                nn.init.uniform_(p, -bound, bound)


class PlanRecognitionBiRNN(nn.Module):
    """biRNN(relu) -> the final step's features -> DiagNormal posterior
    (softplus std + min_std)."""

    tanh = False

    def __init__(
        self,
        state_dim: int,
        latent_plan_dim: int,
        hidden_size: int = 2048,
        num_layers: int = 2,
        min_std: float = 1e-4,
    ):
        super().__init__()
        self.min_std = min_std
        self.birnn_model = _BiRNN(state_dim, hidden_size, num_layers)
        self.mean_fc = TorchDense(2 * hidden_size, latent_plan_dim)
        self.variance_fc = TorchDense(2 * hidden_size, latent_plan_dim)

    def forward(self, perceptual_emb: Tensor):
        x = self.birnn_model(perceptual_emb)[0][:, -1]
        mean = self.mean_fc(x)
        std = F.softplus(self.variance_fc(x)) + self.min_std
        return TanhNormal(mean, std) if self.tanh else DiagNormal(mean, std)


class PlanRecognitionTanhBiRNN(PlanRecognitionBiRNN):
    """The biRNN posterior returning a TanhNormal."""

    tanh = True
