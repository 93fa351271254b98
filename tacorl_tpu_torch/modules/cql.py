"""Goal-conditioned offline CQL (port of tacorl_tpu/modules/cql.py, the
visual path): twin critics with Polyak targets, a learnable entropy
temperature, the conservative logsumexp penalty over random, current and
next policy actions with an optional Lagrange alpha', optional DR3, BC
warm-start epochs (``bc_phase``) and per-network global-norm clipping.

One update keeps the JAX step's order and its semantics: every quantity is
computed from the parameters as they were when the step began, except that
the actor loss uses the alpha just updated. So the step takes alpha's
update first, then the gradients of the actor, the critics and alpha' (each
with ``torch.autograd.grad`` over its own group only, so no loss reaches
another group), then steps those groups, then the Polyak targets. The
conservative term re-uses each critic's observation embedding tiled n
times, as the JAX step does. Every network runs in eval mode (no dropout):
the JAX step applies them with their default ``train=False``.

Randomness enters as data. ``draws`` (all optional; what is missing comes
from the module's generator) holds, with the JAX step's key for each:

    aug_obs, aug_next_obs   DeviceTransforms draws, nested as the
                            observations ({"observation": {mod: {...}},
                            "goal": {...}}); keys k_aug, fold_in(k_aug, 1)
    curr                    the current-action sample of the alpha and
                            actor losses (one draw, used by both, as the
                            JAX step reuses k_curr): {"eps", "gumbel_u"}
    next_bellman            the Bellman target's next action (k_next_bellman)
    curr_n, next_n          the n conservative samples on obs / next_obs,
                            with a leading n axis (k_curr_n, k_next_n)
    rand                    the (bs * n, action_dim) uniform actions in
                            [-1, 1) (k_rand)

    vib                     critics whose encoder has a VIB head
                            (``critic_encoder...vib: true``): the standard
                            normals of the head's samples,
                            {"observation": {mod: (bs, latent)}, "goal":
                            {mod: ...}}, one per encoding of a step's
                            observation (or next observation) and goal
    dropout                 MC-dropout critics only (``q_network.with_dropout``):
                            {rows: boolean keep mask (rows, trunk_dim)} for
                            rows = bs and n * bs (k_drop)

``eps`` is the standard normal of the continuous action part and
``gumbel_u`` the uniform (1e-6, 1 - 1e-6) Gumbel draw of a discrete
gripper; the JAX actor draws them from ``jax.random.split(key)``, or eps
from the key itself without a gripper (``networks/actor.py``).

MC-dropout critics: the JAX step applies every critic with one dropout key
(``k_drop``), and flax derives a mask from that key, the module's path and
the shape. So every critic apply of a step with the same row count gets the
same mask: q1 and q2, both targets, the actor loss's critics and the
embedding path at ``bs`` rows, the conservative term's three n-action
batches at ``n * bs`` rows. The port takes one mask per row count from
``draws["dropout"]``, else draws it from the module's generator once per
row count per step; the validation step does the same.

Observations: dicts of modalities through the LateFusion encoders (image
modalities encoded, vector modalities passed through, as
``experiment=cql_fake_state`` uses them), or with ``state_based: true``
flat arrays (observation and goal concatenated) straight into the actor
and critics, with no encoders.

Without the conservative term (``use_conservative = False``, online SAC in
``modules/sac.py``) the critic loss is the Bellman term alone (plus DR3):
the step draws no n-action samples, no random actions and no n * bs
dropout mask, takes no alpha' step and reports no ``conservative_*``,
``*_random``, ``*_policy`` or ``alpha_prime`` metric, as the JAX step.

VIB: a critic encoder with a VIB head encodes by a reparameterised sample.
The JAX step cannot run it: its ``init_state`` and critic applies supply no
``"sample"`` rng (ROADMAP Queue 3, repaired on the port's side). The port
supplies the draw as the JAX step would with one ``"sample"`` key a step:
flax derives the normals from the key, the module's path and the call's
order within an apply, so every critic apply of a step (q1, q2, both
targets, on the observation and on the next observation) takes the same
normals for the observation's encoding and the same for the goal's. With
``with_vib`` each critic loss adds ``vib_coefficient * KL(vib_dist ||
N(0, I))`` of ``get_vib_distribution(obs)`` and logs ``<q>_vib_loss``.
An actor encoder's VIB head (none of the configs has one) draws from the
device's default generator.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor
from torch.profiler import record_function

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.core.distributions import DiagNormal, kl_diag_normal
from tacorl_tpu_torch.core.optimizers import GroupOptimizer
from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.data.transforms import DeviceTransforms, image_sizes
from tacorl_tpu_torch.modules.base import AlgorithmModule, seeded_init, step_scalar
from tacorl_tpu_torch.networks.actor import Actor
from tacorl_tpu_torch.networks.critic import Critic, dropout_keep_mask
from tacorl_tpu_torch.networks.goal_encoder import VisualGoalEncoder
from tacorl_tpu_torch.networks.late_fusion import build_late_fusion
from tacorl_tpu_torch.networks.layers import reset_parameters
from tacorl_tpu_torch.networks.visual_wrappers import VisualActorWrapper, VisualCriticWrapper
from tacorl_tpu_torch.parallel.mesh import draw_rows

__all__ = ["CQLNet", "CQLModule"]


class CQLNet(nn.Module):
    """state_dict keys follow the reference CQL_Offline: ``actor.``,
    ``q1.``, ``q2.``, ``target_q1.``, ``target_q2.``, ``log_alpha`` and
    (Lagrange) ``log_alpha_prime``. The targets take no gradient."""

    def __init__(
        self,
        actor: VisualActorWrapper,
        q1: VisualCriticWrapper,
        q2: VisualCriticWrapper,
        with_lagrange: bool,
    ):
        super().__init__()
        self.actor = actor
        self.q1 = q1
        self.q2 = q2
        self.target_q1 = copy.deepcopy(q1).requires_grad_(False)
        self.target_q2 = copy.deepcopy(q2).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.zeros(1))
        self.log_alpha_prime = nn.Parameter(torch.zeros(1)) if with_lagrange else None


class CQLModule(AlgorithmModule):
    name = "cql"
    # online SAC (modules/sac.py) runs this update without the conservative
    # penalty (sac_lightning.py:198-232 has no logsumexp term)
    use_conservative = True

    # -- construction --------------------------------------------------------

    def build(self) -> None:
        cfg = self.cfg
        self.discount = float(cfg.get("discount", 0.99))
        self.tau = float(cfg.get("tau", 0.005))
        self.reward_scale = float(cfg.get("reward_scale", 1.0))
        self.deterministic_backup = bool(cfg.get("deterministic_backup", False))
        self.bc_epochs = int(cfg.get("bc_epochs", 0))
        self.conservative_weight = float(cfg.get("conservative_weight", 1.0))
        self.n_action_samples = int(cfg.get("n_action_samples", 10))
        self.temp = float(cfg.get("temp", 1.0))
        self.with_lagrange = bool(cfg.get("with_lagrange", False))
        self.target_action_gap = float(cfg.get("lagrange_thresh", 5.0))
        self.with_dr3 = bool(cfg.get("with_dr3", False))
        self.dr3_coefficient = float(cfg.get("dr3_coefficient", 0.03))
        self.with_vib = bool(cfg.get("with_vib", False))
        self.vib_coefficient = float(cfg.get("vib_coefficient", 0.01))
        self.action_dim = int(cfg.get("action_dim", 7))
        self.target_entropy = float(cfg.get("target_entropy", -self.action_dim))
        self.obs_modalities = tuple(cfg.get("obs_modalities", ["rgb_static"]))
        self.goal_modalities = tuple(cfg.get("goal_modalities", ["rgb_static"]))
        self._epoch = 0

        # construction initializes weights from the global CPU RNG; fork it
        # so building leaves the caller's stream untouched (init_state
        # re-initializes from its seed)
        with torch.random.fork_rng(devices=[]):
            self.build_networks()

        self.transforms = DeviceTransforms(cfg.get("transforms"), device=self.device)
        actor_lr = float(cfg.get("actor_lr", 3e-4))
        critic_lr = float(cfg.get("critic_lr", 3e-4))
        clip = float(cfg.get("clip_grad_val", 1.0)) if cfg.get("clip_grad", True) else None
        # group -> (learning rate, global-norm clip)
        self.group_hparams: Dict[str, Tuple[float, Optional[float]]] = {
            "actor": (actor_lr, clip),
            "q1": (critic_lr, clip),
            "q2": (critic_lr, clip),
            "log_alpha": (actor_lr, None),
        }
        if self.with_lagrange:
            self.group_hparams["log_alpha_prime"] = (critic_lr, None)
        self.generator = torch.Generator(device=self.device)

    @property
    def critic_dropout(self) -> bool:
        """MC-dropout critics (``q_network.with_dropout``)."""
        return bool((self.cfg.get("q_network") or {}).get("with_dropout"))

    def build_networks(self) -> None:
        """Separate encoders per network; sets ``self.net``. With
        ``state_based: true`` observations are flat arrays (observation and
        goal concatenated) that pass straight through the wrappers: an empty
        fusion and no goal encoder (cql_offline_lightning_d4rl.py:107-128)."""
        cfg = self.cfg
        if cfg.get("state_based", False):
            state_dim, goal_dim = int(cfg["state_dim"]), int(cfg.get("goal_dim", 2))

            def encoders(enc_key):
                return build_late_fusion({}, []), None, (), ()
        else:
            vector_dims = dict(cfg.get("vector_dims", {}))
            all_mods = list(dict.fromkeys(self.obs_modalities + self.goal_modalities))
            sizes = image_sizes(cfg.get("transforms"))
            actor_encoder = build_late_fusion(
                cfg["actor_encoder"]["networks"], all_mods, vector_dims, sizes
            )
            state_dim = actor_encoder.calc_state_dim(self.obs_modalities)
            goal_dim = actor_encoder.calc_state_dim(self.goal_modalities)
            g_cfg = dict(cfg.get("goal_encoder", {}))
            g_cfg.pop("_target_", None)

            def encoders(enc_key):
                fusion = actor_encoder if enc_key == "actor_encoder" else build_late_fusion(
                    cfg[enc_key]["networks"], all_mods, vector_dims, sizes
                )
                goal_encoder = VisualGoalEncoder(in_features=goal_dim, out_features=goal_dim, **g_cfg)
                return fusion, goal_encoder, self.obs_modalities, self.goal_modalities

        policy_cfg = dict(cfg.get("policy", {}))
        policy_cls = get_class(policy_cfg.pop("_target_", "tacorl_tpu.networks.actor.MLPPolicy"))
        actor = Actor(
            policy=policy_cls(
                action_dim=self.action_dim, input_dim=state_dim + goal_dim, **policy_cfg
            ),
            action_dim=self.action_dim,
            state_dim=state_dim,
            goal_dim=goal_dim,
            discrete_gripper=bool(policy_cfg.get("discrete_gripper", False)),
        )
        actor_net = VisualActorWrapper(*encoders("actor_encoder"), actor)

        def critic():
            q_cfg = dict(cfg.get("q_network", {}))
            q_cls = get_class(q_cfg.pop("_target_", "tacorl_tpu.networks.critic.MLPQNetwork"))
            q_net = q_cls(input_dim=state_dim + goal_dim + self.action_dim, **q_cfg)
            return VisualCriticWrapper(
                *encoders("critic_encoder"), Critic(q_net, state_dim, goal_dim, self.action_dim)
            )

        self.net = CQLNet(actor_net, critic(), critic(), self.with_lagrange)

    # -- state ---------------------------------------------------------------

    def _init_parameters(self) -> None:
        """Fresh weights for every network, from torch's global RNG."""
        reset_parameters(self.net)

    def _group_params(self) -> Dict[str, List[nn.Parameter]]:
        net = self.net
        trainable = lambda m: [p for p in m.parameters() if p.requires_grad]  # noqa: E731
        groups = {
            "actor": trainable(net.actor),
            "q1": trainable(net.q1),
            "q2": trainable(net.q2),
            "log_alpha": [net.log_alpha],
        }
        if self.with_lagrange:
            groups["log_alpha_prime"] = [net.log_alpha_prime]
        return groups

    def init_state(self, seed: int = 0) -> TrainState:
        """Initialize the weights from ``seed`` (each layer's JAX-package
        init), alpha (and alpha') at log 0, the targets as copies of the
        critics; move everything to the device, seed the generator and make
        one Adam per group."""
        net = self.net
        with seeded_init(seed, self.device):
            self._init_parameters()
        with torch.no_grad():
            net.log_alpha.zero_()
            if self.with_lagrange:
                net.log_alpha_prime.zero_()
        net.target_q1.load_state_dict(net.q1.state_dict())
        net.target_q2.load_state_dict(net.q2.state_dict())
        net.to(self.device)
        self.generator.manual_seed(seed)
        params = self._group_params()
        optimizer = GroupOptimizer(
            {name: (params[name], lr, clip) for name, (lr, clip) in self.group_hparams.items()}
        )
        return TrainState(
            step=0, net=net, optimizer=optimizer,
            aux={"target_q1": net.target_q1, "target_q2": net.target_q2},
        )

    # -- epoch / schedule -----------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def step_scalars(self) -> Dict[str, float]:
        return {"bc_phase": 1.0 if self._epoch < self.bc_epochs else 0.0}

    # -- the update -------------------------------------------------------------

    def _tensor(self, x, dtype=torch.float32) -> Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    def _update(self, state, batch, scalars, draws, optimize: bool):
        """Transform the observations, then the CQL update."""
        self.net.eval()
        obs = self.transforms(
            batch["observations"], train=optimize, draws=draws.get("aug_obs"),
            generator=self.generator,
        )
        next_obs = self.transforms(
            batch["next_observations"], train=optimize, draws=draws.get("aug_next_obs"),
            generator=self.generator,
        )
        return self._cql_update(
            state, obs, next_obs,
            self._tensor(batch["actions"]),
            self._tensor(batch["rewards"]).reshape(-1, 1),
            self._tensor(batch["terminals"]).reshape(-1, 1),
            scalars, draws, optimize,
        )

    def _cql_update(
        self, state, obs, next_obs, actions, rewards, dones, scalars, draws, optimize: bool
    ) -> Tuple[TrainState, Dict[str, Tensor]]:
        """One CQL update on transformed observations, in place on
        ``state``; ``optimize=False`` computes the metrics only."""
        net, gen, opt = self.net, self.generator, state.optimizer
        policy = net.actor.actor
        bs = actions.shape[0]
        metrics: Dict[str, Tensor] = {}
        masks = self._dropout_masks(draws, bs)
        vib = self._vib_eps(draws, bs)

        # ---- 1. alpha: the current actions' log-density, no gradient
        with record_function("cql/alpha"):
            actor_emb = net.actor.get_emb_representation(obs)
            curr_actions, curr_log_pi = policy.get_actions(
                actor_emb, draws.get("curr"), reparameterize=True, generator=gen
            )
            alpha_loss = -(net.log_alpha[0] * (curr_log_pi.detach() + self.target_entropy)).mean()
            if optimize:
                opt.step_group("log_alpha", torch.autograd.grad(alpha_loss, [net.log_alpha]))
            alpha = torch.exp(net.log_alpha[0]).detach()
            metrics["alpha"] = alpha
            metrics["alpha_loss"] = alpha_loss.detach()

        # ---- 2. actor loss with the new alpha and the same sample; the
        # critics' gradient reaches the actor through the actions only
        with record_function("cql/actor"):
            bc_phase = step_scalar(scalars.get("bc_phase", 0.0))
            q1_emb = net.q1.get_emb_representation(obs, vib)
            q2_emb = net.q2.get_emb_representation(obs, vib)
            q_pi = torch.minimum(
                net.q1.critic(q1_emb.detach(), curr_actions, masks.get(bs)),
                net.q2.critic(q2_emb.detach(), curr_actions, masks.get(bs)),
            )
            q_loss = (alpha * curr_log_pi - q_pi).mean()
            bc_loss = (alpha * curr_log_pi - policy.log_prob(actor_emb, actions)).mean()
            actor_loss = bc_phase * bc_loss + (1.0 - bc_phase) * q_loss
            metrics["actor_loss"] = actor_loss.detach()
            if optimize:
                actor_grads = torch.autograd.grad(actor_loss, opt.params("actor"))

        with record_function("cql/critics"):
            # ---- 3. Bellman targets and 4. conservative samples, from the
            # actor as it was when the step began
            with torch.no_grad():
                actor_emb_next = net.actor.get_emb_representation(next_obs)
                next_actions, next_log_pi = policy.get_actions(
                    actor_emb_next, draws.get("next_bellman"), generator=gen
                )
                q_next = torch.minimum(
                    net.target_q1(next_obs, next_actions, masks.get(bs), vib_eps=vib),
                    net.target_q2(next_obs, next_actions, masks.get(bs), vib_eps=vib),
                )
                if not self.deterministic_backup:
                    q_next = q_next - alpha * next_log_pi
                q_target = self.reward_scale * rewards + (1.0 - dones) * self.discount * q_next
                samples = alpha_prime = None
                if self.use_conservative:
                    samples = self._conservative_samples(
                        policy, actor_emb.detach(), actor_emb_next, bs, draws
                    )
                if self.use_conservative and self.with_lagrange:
                    alpha_prime = torch.clamp(torch.exp(net.log_alpha_prime[0]), 0.0, 1e6)
                    metrics["alpha_prime"] = alpha_prime

            q1_loss, cons1_raw = self._critic_loss(
                net.q1, q1_emb, "q1", actions, q_target, samples, alpha_prime, (obs, next_obs),
                masks, vib, metrics,
            )
            q2_loss, cons2_raw = self._critic_loss(
                net.q2, q2_emb, "q2", actions, q_target, samples, alpha_prime, (obs, next_obs),
                masks, vib, metrics,
            )
            if optimize:
                q1_grads = torch.autograd.grad(q1_loss, opt.params("q1"))
                q2_grads = torch.autograd.grad(q2_loss, opt.params("q2"))
                if alpha_prime is not None:
                    # alpha' steps on the conservative gaps of this step
                    raw1, raw2 = cons1_raw.detach(), cons2_raw.detach()
                    ap = torch.clamp(torch.exp(net.log_alpha_prime[0]), 0.0, 1e6)
                    c1 = ap * (raw1 - self.target_action_gap)
                    c2 = ap * (raw2 - self.target_action_gap)
                    lap_loss = (-c1 - c2) * 0.5
                    metrics["alpha_prime_loss"] = lap_loss.detach()
                    opt.step_group(
                        "log_alpha_prime", torch.autograd.grad(lap_loss, [net.log_alpha_prime])
                    )
                opt.step_group("actor", actor_grads)
                opt.step_group("q1", q1_grads)
                opt.step_group("q2", q2_grads)

        if optimize:
            with record_function("cql/polyak"), torch.no_grad():
                # optax.incremental_update: tau * new + (1 - tau) * old
                for src, dst in ((net.q1, net.target_q1), (net.q2, net.target_q2)):
                    targets = list(dst.parameters())
                    torch._foreach_mul_(targets, 1.0 - self.tau)
                    torch._foreach_add_(targets, list(src.parameters()), alpha=self.tau)
            state.step += 1
        return state, metrics

    def _dropout_masks(self, draws, bs: int) -> Dict[int, Tensor]:
        """MC-dropout critics: one keep mask per row count (``bs`` and
        ``n * bs``), from ``draws["dropout"]`` or else the generator; empty
        without dropout."""
        if not self.critic_dropout:
            return {}
        q = self.net.q1.critic.Q
        given = draws.get("dropout") or {}
        masks = {}
        row_counts = (bs, self.n_action_samples * bs) if self.use_conservative else (bs,)
        for rows in row_counts:
            if rows in masks:
                continue
            if rows in given:
                masks[rows] = self._tensor(given[rows], torch.bool)
            else:
                # n * bs rows are n-major: (n, bs), the batch axis second
                masks[rows] = dropout_keep_mask(
                    (rows // bs, bs, q.trunk_dim), q.dropout_p, self.device, self.generator
                ).reshape(rows, q.trunk_dim)
        return masks

    def _vib_eps(self, draws, bs: int) -> Optional[Dict[str, Dict[str, Tensor]]]:
        """The normals of the critic encoders' VIB samples for this step
        (module docstring), from ``draws["vib"]`` or else the generator;
        None without a VIB head."""
        networks = self.net.q1.encoder.networks
        given = draws.get("vib") or {}
        out = {}
        for part, mods in (("observation", self.obs_modalities), ("goal", self.goal_modalities)):
            out[part] = {}
            for m in mods:
                if m in networks and getattr(networks[m], "vib", False):
                    eps = (given.get(part) or {}).get(m)
                    if eps is None:
                        eps = draw_rows(
                            lambda s: torch.randn(s, generator=self.generator, device=self.device),
                            (bs, networks[m].latent_dim),
                        )
                    out[part][m] = self._tensor(eps)
        return out if out["observation"] or out["goal"] else None

    def _conservative_samples(self, policy, emb, emb_next, bs, draws) -> Dict[str, Any]:
        """The actions the conservative term scores: random, current-policy
        and next-policy, each (bs * n, action_dim), with the policies'
        log-densities as (bs, n)."""
        n, a = self.n_action_samples, self.action_dim
        n_curr, n_curr_lp = policy.sample_n_with_log_prob(emb, n, draws.get("curr_n"), self.generator)
        n_next, n_next_lp = policy.sample_n_with_log_prob(
            emb_next, n, draws.get("next_n"), self.generator
        )
        rand = draws.get("rand")
        if rand is None:
            # n-major rows, as the samples: (n, bs), the batch axis second
            rand = draw_rows(
                lambda s: torch.rand(s, generator=self.generator, device=self.device), (n, bs, a), axis=1
            ).reshape(n * bs, a) * 2.0 - 1.0
        rand = self._tensor(rand)
        if policy.discrete_gripper:
            rand = torch.cat([rand[:, :-1], torch.where(rand[:, -1:] >= 0, 1.0, -1.0)], dim=-1)
        return {
            "rand": rand,
            "curr": n_curr.reshape(-1, a),
            "next": n_next.reshape(-1, a),
            "curr_log_pis": n_curr_lp[..., 0].T,
            "next_log_pis": n_next_lp[..., 0].T,
        }

    def _critic_loss(
        self, q, emb, name, actions, q_target, samples, alpha_prime, obs_pair, masks, vib, metrics
    ) -> Tuple[Tensor, Tensor]:
        """Bellman loss, the conservative penalty over the samples scored on
        the observation embedding tiled n times (without ``samples``: none),
        DR3 and VIB; ``obs_pair`` is (obs, next_obs). Returns (loss, the raw
        conservative gap or None)."""
        n, bs = self.n_action_samples, actions.shape[0]
        q_data = q.critic(emb, actions, masks.get(bs))
        bellman = torch.mean((q_data - q_target) ** 2)
        metrics[f"{name}_data"] = q_data.mean().detach()
        metrics[f"bellman_{name}_loss"] = bellman.detach()
        if samples is None:
            return self._critic_extra_losses(q, emb, name, bellman, None, obs_pair, vib, metrics)
        emb_n = emb.repeat(n, 1)  # jnp.tile(emb, (n, 1))

        def n_q(acts):
            return q.critic(emb_n, acts, masks.get(n * bs)).reshape(n, bs).T  # (bs, n)

        q_rand = n_q(samples["rand"])
        q_curr = n_q(samples["curr"])
        q_next = n_q(samples["next"])
        cat_q = torch.cat(
            [
                q_rand - math.log(0.5 ** self.action_dim),
                q_curr - samples["curr_log_pis"],
                q_next - samples["next_log_pis"],
            ],
            dim=1,
        )
        cw = self.conservative_weight
        cons_raw = (
            torch.logsumexp(cat_q / self.temp, dim=1).mean() * cw * self.temp
            - q_data.mean() * cw
        )
        cons = (
            alpha_prime * (cons_raw - self.target_action_gap)
            if alpha_prime is not None else cons_raw
        )
        metrics[f"{name}_random"] = q_rand.mean().detach()
        metrics[f"{name}_policy"] = q_curr.mean().detach()
        metrics[f"conservative_{name}_loss"] = cons.detach()
        metrics[f"conservative_{name}_gap"] = cons_raw.detach()
        return self._critic_extra_losses(q, emb, name, bellman + cons, cons_raw, obs_pair, vib, metrics)

    def _critic_extra_losses(self, q, emb, name, loss, cons_raw, obs_pair, vib, metrics):
        """DR3 and VIB on top of a critic's loss; records ``<name>_loss``."""
        obs, next_obs = obs_pair
        if self.with_dr3:
            with torch.no_grad():
                emb_next = q.get_emb_representation(next_obs, vib)
            dr3 = (emb * emb_next).sum(dim=1).mean() * self.dr3_coefficient
            loss = loss + dr3
            metrics[f"{name}_dr3_loss"] = dr3.detach()
        if self.with_vib:
            vib_dist = q.get_vib_distribution(obs)
            prior = DiagNormal(torch.zeros_like(vib_dist.mean), torch.ones_like(vib_dist.std))
            vib_loss = self.vib_coefficient * kl_diag_normal(vib_dist, prior).mean()
            loss = loss + vib_loss
            metrics[f"{name}_vib_loss"] = vib_loss.detach()
        metrics[f"{name}_loss"] = loss.detach()
        return loss, cons_raw

    # -- public steps -----------------------------------------------------------

    def make_train_step(self):
        def train_step(
            state: TrainState,
            batch: Dict[str, Any],
            scalars: Optional[Dict[str, float]] = None,
            *,
            draws: Optional[Dict[str, Any]] = None,
        ) -> Tuple[TrainState, Dict[str, Tensor]]:
            """One update in place on ``state``; ``draws`` as in the module
            docstring."""
            scalars = self.step_scalars() if scalars is None else scalars
            return self._update(state, batch, scalars, draws or {}, optimize=True)

        return train_step

    def make_val_step(self):
        def val_step(state, batch, scalars=None, *, draws=None):
            """The update's metrics with the evaluation transforms, no step."""
            scalars = self.step_scalars() if scalars is None else scalars
            with torch.no_grad():
                _, metrics = self._update(state, batch, scalars, draws or {}, optimize=False)
            return metrics, {}

        return val_step

    # -- rollout-time policy ------------------------------------------------------

    def make_policy_fn(self, deterministic: bool = True):
        """``policy(net, obs, draws=None, generator=None)``: the evaluation
        transforms, then the actor's ``get_actions`` (deterministic by
        default: nothing is drawn)."""
        transforms = self.transforms

        def policy(net, obs, draws=None, generator=None):
            obs_t = transforms(obs, train=False)
            actions, _ = net.actor.get_actions(
                obs_t, draws, deterministic=deterministic, generator=generator
            )
            return actions

        return policy
