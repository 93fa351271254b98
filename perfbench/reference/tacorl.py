"""Plain PyTorch reference of the TACO-RL train step (stage 2): CQL over
the latent plans of a frozen Play-LMP (Rosete-Beas et al., CoRL 2022;
github.com/ErickRosete/tacorl ``config/module/tacorl.yaml``).

Grafted from stage 1: the actor is Play-LMP's plan proposal behind
trainable copies of its vision and goal encoders; the perceptual encoder,
the posterior and the goal encoder are frozen; the decoder is fine-tuned
with its own Adam. Fresh twin critics, each with its own vision and goal
encoder and a SiLU MLP over [state, goal, plan], have Polyak targets.

One step, in the program's order and with its draws (from a generator
seeded per step): augment the window, then the goal; embed the window
with the frozen encoder and sample a plan from the frozen posterior (no
dropout: every network runs in eval mode); the decoder's imitation loss
and its Adam step; then CQL on (first frame, goal, plan, last frame,
reward = done = [displacement == 1]): alpha's step on the current sample's
log-density, then with the new alpha the actor loss (behaviour cloning of
the plan for the first ``bc_epochs`` epochs), the deterministic Bellman
target from the target critics, the conservative logsumexp over random,
current and next-policy plans (n each) with the Lagrange alpha', alpha''s
step, the clipped steps of actor and critics, and the Polyak targets.
"""

from __future__ import annotations

import copy
import math
from pathlib import Path
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch import Tensor

from perfbench.reference import play_lmp
from perfbench.reference.common import (
    Precision,
    augment_rgb,
    dense,
    seed_step,
    tanh_normal_log_prob,
)
from perfbench.weights import make_weights

LOSSES = ("action_loss", "alpha_loss", "actor_loss", "q1_loss", "q2_loss", "alpha_prime_loss")
FROZEN = ("perceptual_encoder", "plan_recognition", "goal_encoder")


class QNetwork(nn.Module):
    def __init__(self, in_dim: int, hidden: int, layers: int):
        super().__init__()
        self.fc_layers = nn.ModuleList(nn.Linear(in_dim if i == 0 else hidden, hidden) for i in range(layers))
        self.out = nn.Linear(hidden, 1)

    def forward(self, x: Tensor) -> Tensor:
        for fc in self.fc_layers:
            x = F.silu(dense(x, fc))
        return dense(x, self.out)


class Critic(nn.Module):
    def __init__(self, in_dim: int, hidden: int, layers: int):
        super().__init__()
        self.Q = QNetwork(in_dim, hidden, layers)

    def forward(self, emb: Tensor, action: Tensor) -> Tensor:
        return self.Q(torch.cat([emb, action], -1))


class Visual(nn.Module):
    """An encoder of the observation and of the goal frame (the goal's
    embedding through a goal MLP), concatenated."""

    def __init__(self, lat: int, hid: int, goal_hidden: int):
        super().__init__()
        self.encoder = play_lmp.Networks(lat, hid)
        self.goal_encoder = play_lmp.GoalEncoder(lat, goal_hidden)

    def emb(self, obs: Tensor, goal: Tensor, p: Precision) -> Tensor:
        enc = self.encoder.networks["rgb_static"]
        return torch.cat([enc(obs, p), self.goal_encoder(enc(goal, p))], -1)


class Actor(Visual):
    def __init__(self, lat, hid, goal_hidden, prior_hidden, prior_layers, z):
        super().__init__(lat, hid, goal_hidden)
        self.actor = play_lmp.Prior(2 * lat, prior_hidden, prior_layers, z)


class QWrapper(Visual):
    def __init__(self, lat, hid, goal_hidden, q_hidden, q_layers, z):
        super().__init__(lat, hid, goal_hidden)
        self.critic = Critic(2 * lat + z, q_hidden, q_layers)

    def forward(self, obs, goal, action, p):
        return self.critic(self.emb(obs, goal, p), action)


class TACORL(nn.Module):
    def __init__(self, sizes: dict):
        super().__init__()
        lmp = play_lmp.PlayLMP(sizes)
        lat, hid, g, z = sizes["latent_dim"], sizes["encoder_hidden_dim"], sizes["goal_hidden_size"], sizes["latent_plan_dim"]
        self.sizes = sizes
        self.actor = Actor(lat, hid, g, sizes["prior_hidden_dim"], sizes["prior_num_layers"], z)
        self.q1, self.q2 = (QWrapper(lat, hid, g, sizes["q_hidden_dim"], sizes["q_num_layers"], z) for _ in range(2))
        self.target_q1, self.target_q2 = copy.deepcopy(self.q1), copy.deepcopy(self.q2)
        self.log_alpha = nn.Parameter(torch.zeros(1))
        self.log_alpha_prime = nn.Parameter(torch.zeros(1))
        self.perceptual_encoder, self.plan_recognition = lmp.perceptual_encoder, lmp.plan_recognition
        self.goal_encoder, self.action_decoder = lmp.goal_encoder, lmp.action_decoder
        for part in FROZEN + ("target_q1", "target_q2"):
            getattr(self, part).requires_grad_(False)


def make(sizes: dict) -> TACORL:
    return TACORL(sizes)


def held_at_zero(name: str) -> bool:
    return ".rnn.bias_hh" in name or name.startswith(("log_alpha",))


def weights(sizes: dict, seed: int, device) -> dict:
    """The run's weights: Play-LMP's from the seed (the graft's source,
    which the program reads from a stage-1 checkpoint) and the critics'
    from the seed's second stream (loaded into the program at fit start),
    the targets equal to the critics, both alphas at log 0."""
    lmp = make_weights(play_lmp.make(sizes).to(device), seed, device, play_lmp.held_at_zero)
    net = make(sizes).to(device)
    fresh = make_weights(net, seed + 1, device, held_at_zero)
    full = {}
    for name in net.state_dict():
        part, _, rest = name.partition(".")
        if part in FROZEN + ("action_decoder",):
            full[name] = lmp[name]
        elif part == "actor":
            sub, _, leaf = rest.partition(".")
            src = {"encoder": "perceptual_encoder", "goal_encoder": "goal_encoder", "actor": "plan_proposal"}[sub]
            full[name] = lmp[f"{src}.{leaf}"]
        elif part in ("target_q1", "target_q2"):
            full[name] = fresh[name[len("target_"):]]
        else:
            full[name] = fresh[name]
    return {"full": full, "inject": ["q1.", "q2.", "target_q1.", "target_q2.", "log_alpha"], "graft": lmp}


def _clip(grads: List[Tensor], max_norm: float) -> List[Tensor]:
    """optax.clip_by_global_norm: g where the norm is under ``max_norm``,
    else g / norm * max_norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class _Groups:
    """One Adam per group (name -> (parameter names, lr, clip)); records
    each group's gradient as the optimizer gets it at the first step."""

    def __init__(self, net: nn.Module, groups: Dict[str, tuple]):
        params = dict(net.named_parameters())
        self.groups = {}
        for g, (names, lr, clip) in groups.items():
            ps = [params[n] for n in names]
            self.groups[g] = (names, ps, torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8), clip)
        self.first: Dict[str, Tensor] = {}
        self.recording = True

    def step(self, group: str, grads) -> None:
        names, ps, opt, clip = self.groups[group]
        grads = list(grads)
        if clip is not None:
            grads = _clip(grads, clip)
        if self.recording:
            self.first.update({n: g.detach().clone() for n, g in zip(names, grads)})
        for q, g in zip(ps, grads):
            q.grad = g
        opt.step()
        for q in ps:
            q.grad = None


def _groups(net: TACORL, s: dict) -> Dict[str, tuple]:
    names = [n for n, q in net.named_parameters() if q.requires_grad]

    def under(prefix):
        return [n for n in names if n.startswith(prefix + ".")]

    return {
        "action_decoder": (under("action_decoder"), s["action_decoder_lr"], None),
        "log_alpha": (["log_alpha"], s["actor_lr"], None),
        "log_alpha_prime": (["log_alpha_prime"], s["critic_lr"], None),
        "actor": (under("actor"), s["actor_lr"], s["clip_grad_val"]),
        "q1": (under("q1"), s["critic_lr"], s["clip_grad_val"]),
        "q2": (under("q2"), s["critic_lr"], s["clip_grad_val"]),
    }


def _policy(net: TACORL, emb: Tensor):
    return net.actor.actor.policy(emb)


def step(net: TACORL, opt: _Groups, batch: Dict[str, Tensor], gen: torch.Generator, p: Precision,
         bc_phase: float) -> Dict[str, Tensor]:
    s = net.sizes
    n_act, a_dim = s["n_action_samples"], s["latent_plan_dim"]
    states = augment_rgb(batch["rgb_static"], gen, s["augment"], p)
    goal = augment_rgb(batch["goal"], gen, s["augment"], p)
    actions = batch["actions"].float()
    out = {}
    with torch.no_grad():
        b, t = states.shape[:2]
        emb = net.perceptual_encoder.networks["rgb_static"](states.reshape((b * t,) + states.shape[2:]), p).reshape(b, t, -1)
        post_m, post_s = net.plan_recognition(emb)
        eps = torch.randn(post_m.shape, generator=gen, device=post_m.device)
        plan = torch.tanh(post_m + post_s * eps)
    dec_loss = net.action_decoder.loss(plan, emb[:, :-1], actions[:, :-1], s, p)
    opt.step("action_decoder", torch.autograd.grad(dec_loss, [q for _, q in _named(net, "action_decoder")]))
    out["action_loss"] = dec_loss.detach()

    s0, s_last = states[:, 0], states[:, -1]
    success = (batch["disp"] == 1).float().reshape(-1, 1)
    # 1. alpha
    actor_emb = net.actor.emb(s0, goal, p)
    m, sd = _policy(net, actor_emb)
    z = m + sd * torch.randn(m.shape, generator=gen, device=m.device)
    curr = torch.tanh(z)
    curr_lp = tanh_normal_log_prob(curr, z, m, sd)
    alpha_loss = -(net.log_alpha[0] * (curr_lp.detach() + s["target_entropy"])).mean()
    opt.step("log_alpha", torch.autograd.grad(alpha_loss, [net.log_alpha]))
    alpha = torch.exp(net.log_alpha[0]).detach()
    out["alpha_loss"] = alpha_loss.detach()
    # 2. actor
    q1_emb, q2_emb = net.q1.emb(s0, goal, p), net.q2.emb(s0, goal, p)
    q_pi = torch.minimum(net.q1.critic(q1_emb.detach(), curr), net.q2.critic(q2_emb.detach(), curr))
    q_loss = (alpha * curr_lp - q_pi).mean()
    m2, sd2 = _policy(net, actor_emb)
    bc_loss = (alpha * curr_lp - tanh_normal_log_prob(plan, None, m2, sd2)).mean()
    actor_loss = bc_phase * bc_loss + (1.0 - bc_phase) * q_loss
    actor_grads = torch.autograd.grad(actor_loss, [q for _, q in _named(net, "actor")])
    out["actor_loss"] = actor_loss.detach()
    # 3. targets and the conservative samples
    with torch.no_grad():
        emb_next = net.actor.emb(s_last, goal, p)
        mn, sdn = _policy(net, emb_next)
        next_act = torch.tanh(mn + sdn * torch.randn(mn.shape, generator=gen, device=mn.device))
        q_next = torch.minimum(net.target_q1(s_last, goal, next_act, p), net.target_q2(s_last, goal, next_act, p))
        q_target = s["reward_scale"] * success + (1.0 - success) * s["discount"] * q_next
        samples = []
        for e in (actor_emb.detach(), emb_next):
            mm, ss = _policy(net, e)
            zz = mm + ss * torch.randn((n_act,) + tuple(mm.shape), generator=gen, device=mm.device)
            samples.append((torch.tanh(zz).reshape(-1, a_dim), tanh_normal_log_prob(torch.tanh(zz), zz, mm, ss)[..., 0].T))
        rand = torch.rand((n_act, b, a_dim), generator=gen, device=s0.device).reshape(n_act * b, a_dim) * 2.0 - 1.0
        alpha_prime = torch.clamp(torch.exp(net.log_alpha_prime[0]), 0.0, 1e6)
    losses, raws = {}, {}
    for name, q, qe in (("q1", net.q1, q1_emb), ("q2", net.q2, q2_emb)):
        q_data = q.critic(qe, plan)
        bellman = torch.mean((q_data - q_target) ** 2)
        emb_n = qe.repeat(n_act, 1)

        def n_q(acts):
            return q.critic(emb_n, acts).reshape(n_act, b).T

        cat_q = torch.cat([n_q(rand) - math.log(0.5 ** a_dim), n_q(samples[0][0]) - samples[0][1],
                           n_q(samples[1][0]) - samples[1][1]], 1)
        raw = torch.logsumexp(cat_q, 1).mean() - q_data.mean()
        losses[name], raws[name] = bellman + alpha_prime * (raw - s["lagrange_thresh"]), raw.detach()
        out[f"{name}_loss"] = losses[name].detach()
    q_grads = {k: torch.autograd.grad(losses[k], [q for _, q in _named(net, k)]) for k in ("q1", "q2")}
    ap = torch.clamp(torch.exp(net.log_alpha_prime[0]), 0.0, 1e6)
    lap_loss = (-(ap * (raws["q1"] - s["lagrange_thresh"])) - ap * (raws["q2"] - s["lagrange_thresh"])) * 0.5
    out["alpha_prime_loss"] = lap_loss.detach()
    opt.step("log_alpha_prime", torch.autograd.grad(lap_loss, [net.log_alpha_prime]))
    opt.step("actor", actor_grads)
    opt.step("q1", q_grads["q1"])
    opt.step("q2", q_grads["q2"])
    # 5. Polyak
    with torch.no_grad():
        for src, dst in ((net.q1, net.target_q1), (net.q2, net.target_q2)):
            for a, b_ in zip(dst.parameters(), src.parameters()):
                a.mul_(1.0 - s["tau"]).add_(b_, alpha=s["tau"])
    return out


def _named(net: nn.Module, prefix: str):
    return [(n, q) for n, q in net.named_parameters() if q.requires_grad and (n == prefix or n.startswith(prefix + "."))]


def train_steps(weights_: Dict[str, Tensor], batches: List[Dict[str, Tensor]], sizes: dict, seed: int,
                first_index: int, mode: str = "f32", ranks: int = 1) -> dict:
    """As ``play_lmp.train_steps``: each step's losses (``LOSSES``), each
    trained leaf's gradient at the first step as its optimizer gets it
    (after the global-norm clip), every leaf after the last step. One rank
    only: the ranks' shares of a global batch are stage 1's alone."""
    if ranks != 1:
        raise NotImplementedError("the stage-2 reference trains one rank")
    device = next(iter(weights_.values())).device
    p = Precision(mode)
    net = make(sizes).to(device)
    net.load_state_dict(weights_)
    net.eval()
    opt = _Groups(net, _groups(net, sizes))
    gen = torch.Generator(device=device)
    losses: Dict[str, List[Tensor]] = {k: [] for k in LOSSES}
    with p.context():
        for i, batch in enumerate(batches):
            seed_step(gen, device, seed, first_index + i)
            opt.recording = i == 0
            out = step(net, opt, batch, gen, p, 1.0 if sizes["bc_epochs"] > 0 else 0.0)
            for k in LOSSES:
                losses[k].append(out[k])
    params = {n: q.detach().clone() for n, q in net.named_parameters()}
    return {"losses": {k: torch.stack(v) for k, v in losses.items()}, "grads": opt.first, "params": params}


def batches(store, sizes: dict, seed: int, n: int, device) -> List[Dict[str, Tensor]]:
    """The first ``n`` batches the program's loader gives a run seeded
    ``seed``, with their goals, read again from the set's files."""
    from perfbench.reference.loader import Windows

    windows = Windows(Path(store) / "training", sizes["min_window_size"], sizes["max_window_size"],
                      goals=sizes["goals"])
    return [windows.batch(seed, sizes["batch_size"], 0, i, device) for i in range(n)]
