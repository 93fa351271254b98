"""Plain PyTorch reference of the Play-LMP train step (TACO-RL stage 1).

The network of TACO-RL's ``PlayLMP`` (Rosete-Beas et al., CoRL 2022;
github.com/ErickRosete/tacorl ``config/module/play_lmp_for_rl.yaml``): an
LMP vision encoder per frame (convs 8/4, 4/2, 3/1, a spatial soft-argmax
with a learned temperature, a 2-layer head), a goal MLP, a post-LN
transformer posterior over the window (learned positions, the embedding
zero-padded to a multiple of the heads, fc, mean over time, a tanh-normal
with softplus std), an MLP prior (SiLU trunk, clamped mean and log std),
balanced KL, and a 2-layer ReLU RNN decoder with a discretised logistic
mixture over the continuous action columns and a two-class gripper. Adam
(betas 0.9, 0.999, eps 1e-8) updates every parameter but the recurrent
biases, which are held at zero.

``state_dict`` keys are those of the program's network, so one set of
weights loads into both. Randomness is drawn in the program's order from
a generator seeded per step (``common.seed_step``): the augmentation's
shifts and jitter factors and the posterior's standard normal from the
step generator, dropout (the posterior's, p from the configuration) from
the device's default generator through the same torch modules.

At W data-parallel ranks (``train_steps(..., ranks=W)``) a step is the W
ranks' shares of the global batch (``common``: each share's draws are its
rows of the global draws, its dropout its own), their gradients averaged
into one Adam step.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from perfbench.reference.common import (
    Precision,
    augment_rgb,
    balanced_kl,
    dense,
    draw,
    logistic_mixture_log_prob,
    relu_rnn,
    rows_of,
    seed_step,
    shard,
)

LN_EPS = 1e-6
LOG_SIG_MIN, LOG_SIG_MAX, MEAN_MIN, MEAN_MAX = -5.0, 2.0, -9.0, 9.0


class SoftArgmax(nn.Module):
    def __init__(self):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(1))

    def forward(self, x: Tensor) -> Tensor:
        n, c, h, w = x.shape
        sm = torch.softmax(x.reshape(n, c, h * w) / self.temperature, -1).reshape(n, c, h, w)
        ex = torch.einsum("nchw,w->nc", sm, torch.arange(w, dtype=x.dtype, device=x.device))
        ey = torch.einsum("nchw,h->nc", sm, torch.arange(h, dtype=x.dtype, device=x.device))
        return torch.stack([ex, ey], -1).reshape(n, 2 * c)


class VisionEncoder(nn.Module):
    def __init__(self, latent_dim: int, hidden_dim: int):
        super().__init__()
        self.model = nn.Sequential(
            nn.Conv2d(3, 32, 8, 4), nn.ReLU(), nn.Conv2d(32, 64, 4, 2), nn.ReLU(),
            nn.Conv2d(64, 64, 3, 1), nn.ReLU(), SoftArgmax(),
        )
        self.fc_layers = nn.Sequential(nn.Linear(128, hidden_dim), nn.ReLU(), nn.Dropout(0.0),
                                       nn.Linear(hidden_dim, latent_dim))

    def forward(self, x: Tensor, p: Precision) -> Tensor:
        for i in (0, 2, 4):
            x = F.relu(p.conv(x, self.model[i]))
        x = self.model[6](x)
        return dense(F.relu(dense(x, self.fc_layers[0])), self.fc_layers[3])


class Networks(nn.Module):
    """The image modality's encoder under ``networks.rgb_static``."""

    def __init__(self, latent_dim: int, hidden_dim: int):
        super().__init__()
        self.networks = nn.ModuleDict({"rgb_static": VisionEncoder(latent_dim, hidden_dim)})


class GoalEncoder(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.ReLU(), nn.Linear(hidden, hidden), nn.ReLU(),
                                 nn.Linear(hidden, dim))

    def forward(self, x: Tensor) -> Tensor:
        return dense(F.relu(dense(F.relu(dense(x, self.mlp[0])), self.mlp[2])), self.mlp[4])


class EncoderLayer(nn.Module):
    def __init__(self, d: int, heads: int, ffn: int, dropout: float):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d, heads, dropout=dropout, batch_first=True)
        self.linear1, self.linear2 = nn.Linear(d, ffn), nn.Linear(ffn, d)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=LN_EPS), nn.LayerNorm(d, eps=LN_EPS)
        self.dropout, self.dropout1, self.dropout2 = nn.Dropout(dropout), nn.Dropout(dropout), nn.Dropout(dropout)

    def forward(self, x: Tensor) -> Tensor:
        x = self.norm1(x + self.dropout1(self.self_attn(x, x, x, need_weights=False)[0]))
        return self.norm2(x + self.dropout2(dense(self.dropout(F.relu(dense(x, self.linear1))), self.linear2)))


class Layers(nn.Module):
    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Posterior(nn.Module):
    def __init__(self, state_dim: int, plan_dim: int, heads: int, layers: int, ffn: int, fc: int,
                 max_positions: int, dropout: float, min_std: float):
        super().__init__()
        self.d_model = state_dim + (-state_dim % heads)
        self.min_std = min_std
        self.position_embeddings = nn.Embedding(max_positions, self.d_model)
        self.dropout = nn.Dropout(dropout)
        self.transformer_encoder = Layers([EncoderLayer(self.d_model, heads, ffn, dropout) for _ in range(layers)])
        self.fc = nn.Linear(self.d_model, fc)
        self.mean_fc, self.variance_fc = nn.Linear(fc, plan_dim), nn.Linear(fc, plan_dim)

    def forward(self, emb: Tensor):
        s = emb.shape[1]
        x = F.pad(emb, (0, self.d_model - emb.shape[-1])) + self.position_embeddings.weight[:s][None]
        x = self.dropout(x)
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        x = dense(x, self.fc).mean(1)
        return dense(x, self.mean_fc), F.softplus(dense(x, self.variance_fc)) + self.min_std


class Policy(nn.Module):
    def __init__(self, in_dim: int, hidden: int, layers: int, out_dim: int):
        super().__init__()
        self.fc_layers = nn.ModuleList(nn.Linear(in_dim if i == 0 else hidden, hidden) for i in range(layers))
        self.fc_mean, self.fc_log_std = nn.Linear(hidden, out_dim), nn.Linear(hidden, out_dim)

    def forward(self, x: Tensor):
        for fc in self.fc_layers:
            x = F.silu(dense(x, fc))
        mean = torch.clamp(dense(x, self.fc_mean), MEAN_MIN, MEAN_MAX)
        return mean, torch.exp(torch.clamp(dense(x, self.fc_log_std), LOG_SIG_MIN, LOG_SIG_MAX))


class Prior(nn.Module):
    def __init__(self, in_dim: int, hidden: int, layers: int, out_dim: int):
        super().__init__()
        self.policy = Policy(in_dim, hidden, layers, out_dim)


class Decoder(nn.Module):
    def __init__(self, in_dim: int, hidden: int, layers: int, cont: int, mixtures: int):
        super().__init__()
        self.cont, self.mixtures, self.layers = cont, mixtures, layers
        self.rnn = nn.RNN(in_dim, hidden, layers, nonlinearity="relu", batch_first=True)
        for i in range(layers):
            getattr(self.rnn, f"bias_hh_l{i}").requires_grad_(False)
        self.mean_fc, self.log_scale_fc, self.prob_fc = (nn.Linear(hidden, cont * mixtures) for _ in range(3))
        self.gripper_fc = nn.Linear(hidden, 2)

    def loss(self, plan: Tensor, emb: Tensor, actions: Tensor, cfg: dict, p: Precision) -> Tensor:
        b, s = emb.shape[:2]
        x = torch.cat([plan[:, None].expand(b, s, plan.shape[-1]), emb], -1)
        weights = [tuple(getattr(self.rnn, f"{n}_l{i}") for n in ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))
                   for i in range(self.layers)]
        h = relu_rnn(x, weights, p)
        shape = (b, s, self.cont, self.mixtures)
        logits = dense(h, self.prob_fc).reshape(shape)
        means = dense(h, self.mean_fc).reshape(shape)
        log_scales = torch.clamp(dense(h, self.log_scale_fc), min=LOG_SIG_MIN).reshape(shape)
        lp = logistic_mixture_log_prob(actions[..., :-1], logits, means, log_scales, -1.0, 1.0,
                                       cfg["num_classes"], LOG_SIG_MIN)
        grip = (actions[..., -1] > 0).long()
        ce = -torch.gather(F.log_softmax(dense(h, self.gripper_fc), -1), -1, grip[..., None]).mean()
        return -lp.sum(-1).mean() + ce


class PlayLMP(nn.Module):
    """The whole network; ``sizes`` is the configuration's ``sizes``."""

    def __init__(self, sizes: dict):
        super().__init__()
        z, lat = sizes["latent_plan_dim"], sizes["latent_dim"]
        self.sizes = sizes
        self.perceptual_encoder = Networks(lat, sizes["encoder_hidden_dim"])
        self.goal_encoder = GoalEncoder(lat, sizes["goal_hidden_size"])
        self.plan_recognition = Posterior(
            lat, z, sizes["num_heads"], sizes["num_layers"], sizes["encoder_hidden_size"], sizes["fc_hidden_size"],
            sizes["max_window_size"], sizes["dropout_p"], sizes["min_std"],
        )
        self.plan_proposal = Prior(2 * lat, sizes["prior_hidden_dim"], sizes["prior_num_layers"], z)
        self.action_decoder = Decoder(z + lat, sizes["decoder_hidden_size"], sizes["decoder_num_layers"],
                                      sizes["action_dim"] - 1, sizes["n_mixtures"])

    def embed(self, frames: Tensor, p: Precision) -> Tensor:
        b, t = frames.shape[:2]
        return self.perceptual_encoder.networks["rgb_static"](frames.reshape((b * t,) + frames.shape[2:]), p).reshape(b, t, -1)

    def loss(self, batch: Dict[str, Tensor], generator: torch.Generator, p: Precision) -> Tensor:
        s = self.sizes
        frames = augment_rgb(batch["rgb_static"], generator, s["augment"], p)
        actions = batch["actions"].float()
        emb = self.embed(frames, p)
        goal = self.goal_encoder(emb[:, -1])
        prior_m, prior_s = self.plan_proposal.policy(torch.cat([emb[:, 0], goal], -1))
        post_m, post_s = self.plan_recognition(emb)
        kl = balanced_kl(post_m, post_s, prior_m, prior_s, s["kl_alpha"]).mean()
        eps = draw(lambda shape: torch.randn(shape, generator=generator, device=post_m.device, dtype=post_m.dtype),
                   post_m.shape)
        plan = torch.tanh(post_m + post_s * eps)
        action_loss = self.action_decoder.loss(plan, emb[:, :-1], actions[:, :-1], s, p)
        return kl * s["kl_beta"] + action_loss


def held_at_zero(name: str) -> bool:
    """Leaves the program holds at zero and never trains."""
    return name.startswith("action_decoder.rnn.bias_hh")


def train_steps(weights: Dict[str, Tensor], batches: List[Dict[str, Tensor]], sizes: dict, seed: int,
                first_index: int, mode: str = "f32", ranks: int = 1, exchange: bool = True) -> dict:
    """Train ``len(batches)`` steps from ``weights`` as the program's steps
    ``first_index, first_index + 1, ...`` of a run seeded ``seed``, each
    batch a global batch over ``ranks`` data-parallel ranks. Returns each
    step's ``losses`` (rank 0's share), ``grads`` (each trained leaf's
    gradient at the first step, the mean of the ranks') and ``params``
    (each leaf after the last step), all float32 on the device of the
    weights. ``exchange=False`` leaves the ranks' mean out, as the fault
    ``no_exchange`` does: rank 0 steps on its own share's gradient."""
    device = next(iter(weights.values())).device
    p = Precision(mode)
    net = PlayLMP(sizes).to(device)
    net.load_state_dict(weights)
    net.train()
    named = [(n, q) for n, q in net.named_parameters() if q.requires_grad]
    opt = torch.optim.Adam([q for _, q in named], lr=sizes["lr"], betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=device)
    losses, grads = [], {}
    with p.context():
        for i, batch in enumerate(batches):
            loss = _mean_of_shares(net, named, batch, generator, p, seed, first_index + i, ranks, exchange)
            if i == 0:
                grads = {n: q.grad.detach().clone() for n, q in named}
            opt.step()
            losses.append(loss.detach())
    params = {n: q.detach().clone() for n, q in net.named_parameters()}
    return {"losses": {"total_loss": torch.stack(losses)}, "grads": grads, "params": params}


def _mean_of_shares(net: PlayLMP, named, batch: Dict[str, Tensor], generator: torch.Generator, p: Precision,
                    seed: int, index: int, ranks: int, exchange: bool = True) -> Tensor:
    """Each rank's share of step ``index`` on its rows, the gradients
    summed and divided by ``ranks`` into ``.grad`` (without ``exchange``,
    rank 0's alone); returns rank 0's loss."""
    device = next(net.parameters()).device
    total = {n: torch.zeros_like(q) for n, q in named}
    losses = []
    for r in range(ranks if exchange else 1):
        seed_step(generator, device, seed, index, r, ranks)
        net.zero_grad(set_to_none=True)
        with shard(r, ranks):
            loss = net.loss(rows_of(batch, r, ranks), generator, p)
        loss.backward()
        for n, q in named:
            total[n] += q.grad
        losses.append(loss.detach())
    for n, q in named:
        q.grad = total[n] / (ranks if exchange else 1)
    return losses[0]


LOSSES = ("total_loss",)


def make(sizes: dict) -> PlayLMP:
    return PlayLMP(sizes)


def weights(sizes: dict, seed: int, device) -> dict:
    """The run's weights, all loaded into the program at fit start."""
    from perfbench.weights import make_weights

    return {"full": make_weights(make(sizes).to(device), seed, device, held_at_zero), "inject": [""]}


def batches(store, sizes: dict, seed: int, n: int, device) -> List[Dict[str, Tensor]]:
    """The first ``n`` batches the program's loader gives a run seeded
    ``seed``, read again from the set's files."""
    from perfbench.reference.loader import Windows

    windows = Windows(Path(store) / "training", sizes["min_window_size"], sizes["max_window_size"])
    return [windows.batch(seed, sizes["batch_size"], 0, i, device) for i in range(n)]
