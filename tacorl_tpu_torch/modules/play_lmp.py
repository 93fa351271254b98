"""Play-LMP: sequence-level conditional VAE over play windows (port of
tacorl_tpu/modules/play_lmp.py).

A LateFusion encoder embeds the window, the plan-recognition posterior and
the plan-proposal prior define a balanced KL, and an RNN action decoder
scores actions with a discretized-logistic-mixture NLL. The train step runs
augmentation -> loss -> backward -> Adam eagerly on the module's device;
the val step computes the loss metrics under the evaluation transforms.

With ``add_random_plan_loss`` or ``log_random_plan_loss`` the decoder also
scores the actions under a uniform plan and goal in [-1, 1):
``random_plan_action_loss`` and ``random_plan_gripper_accuracy`` are
metrics, and with ``add_random_plan_loss`` the total is ``total -
random_plan_action_loss`` (the JAX package's sign); without it the random
loss is computed without a graph.

Randomness enters as data: the steps take optional explicit draws (the DrQ
shifts and jitter factors per image modality, the posterior's eps, the
prior's ``pp_eps`` in the val step, and ``draws``: ``random_plan`` and
``random_goal``, the uniforms, and ``decoder`` / ``random_decoder``, the
decoder samples' draws of the two action losses, whose gripper column the
gripper accuracy reads); what is not given is drawn from the module's
``torch.Generator``. Dropout (the posterior's) draws from the
device's default generator, which takes no generator argument; the trainer
seeds both per step (``core/trainer.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch import Tensor
from torch.profiler import record_function

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.core.distributions import (
    DiagNormal,
    TanhNormal,
    balanced_kl,
    kl_diag_normal,
)
from tacorl_tpu_torch.core.optimizers import global_norm, reduce_gradients
from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.data.transforms import DeviceTransforms, image_sizes
from tacorl_tpu_torch.modules.base import AlgorithmModule, seeded_init, step_scalar
from tacorl_tpu_torch.networks.actor import Actor
from tacorl_tpu_torch.networks.late_fusion import LateFusion, build_late_fusion
from tacorl_tpu_torch.networks.layers import reset_parameters
from tacorl_tpu_torch.parallel.mesh import draw_rows

__all__ = ["PlayLMPNet", "PlayLMPModule", "uniform_pm1"]


def _base_normal(dist) -> DiagNormal:
    """The KL is taken between the base normals when the posterior is
    tanh-squashed."""
    return dist.normal if isinstance(dist, TanhNormal) else dist


class PlayLMPNet(nn.Module):
    """state_dict keys follow the reference PlayLMP: ``perceptual_encoder``,
    ``goal_encoder``, ``plan_recognition``, ``plan_proposal``,
    ``action_decoder``."""

    def __init__(
        self,
        perceptual_encoder: LateFusion,
        goal_encoder: nn.Module,
        plan_recognition: nn.Module,
        plan_proposal: Actor,
        action_decoder: nn.Module,
        pp_obs_modalities: Tuple[str, ...],
        pp_goal_modalities: Tuple[str, ...],
        pr_modalities: Tuple[str, ...],
        ad_modalities: Tuple[str, ...],
        kl_balancing: bool = True,
        kl_alpha: float = 0.8,
        add_random_plan_loss: bool = False,
        log_random_plan_loss: bool = False,
    ):
        super().__init__()
        self.add_random_plan_loss = add_random_plan_loss
        self.log_random_plan_loss = log_random_plan_loss
        self.perceptual_encoder = perceptual_encoder
        self.goal_encoder = goal_encoder
        self.plan_recognition = plan_recognition
        self.plan_proposal = plan_proposal
        self.action_decoder = action_decoder
        self.pp_obs_modalities = tuple(pp_obs_modalities)
        self.pp_goal_modalities = tuple(pp_goal_modalities)
        self.pr_modalities = tuple(pr_modalities)
        self.ad_modalities = tuple(ad_modalities)
        self.kl_balancing = kl_balancing
        self.kl_alpha = kl_alpha

    @property
    def all_modalities(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for m in (
            self.pp_obs_modalities
            + self.pp_goal_modalities
            + self.pr_modalities
            + self.ad_modalities
        ):
            if m not in seen:
                seen.append(m)
        return tuple(seen)

    # -- embeddings --------------------------------------------------------

    def get_emb_states(self, states: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Encode every modality over flattened (B*T) frames, back to
        (B, T, d)."""
        b, t = next(iter(states.values())).shape[:2]
        flat = {k: v.reshape((b * t,) + v.shape[2:]) for k, v in states.items()}
        emb = self.perceptual_encoder.encode(flat, self.all_modalities, cat_output=False)
        return {k: v.reshape(b, t, -1) for k, v in emb.items()}

    def process_batch(self, states: Dict[str, Tensor]):
        emb = self.get_emb_states(states)
        pp_state = torch.cat([emb[m][:, 0] for m in self.pp_obs_modalities], dim=-1)
        pp_goal = torch.cat([emb[m][:, -1] for m in self.pp_goal_modalities], dim=-1)
        pp_goal = self.goal_encoder(pp_goal)
        pp_dist = self.plan_proposal.get_dist(pp_state, pp_goal)
        pr_states = torch.cat([emb[m] for m in self.pr_modalities], dim=-1)
        pr_dist = self.plan_recognition(pr_states)
        return emb, pp_dist, pr_dist, pp_goal

    # -- losses --------------------------------------------------------------

    def compute_kl_loss(self, pr_dist, pp_dist) -> Tensor:
        posterior, prior = _base_normal(pr_dist), _base_normal(pp_dist)
        if self.kl_balancing:
            return balanced_kl(posterior, prior, self.kl_alpha).mean()
        return kl_diag_normal(posterior, prior).mean()

    def _action_loss(
        self, ad_states, actions, latent_plan, latent_goal, draws=None, generator=None
    ) -> Tuple[Tensor, Tensor]:
        """Returns (loss, gripper_accuracy). Without include_goal the final
        frame is dropped: a plan explains actions up to the goal frame, not
        the action taken in it. The predicted gripper is the last column of
        the decoder's sample (the logistic decoder's discrete gripper
        returns that column alone)."""
        if self.action_decoder.include_goal:
            loss, pred = self.action_decoder.loss_and_act(
                latent_plan, ad_states, actions, latent_goal, draws, generator
            )
            gt_gripper = actions[..., -1]
        else:
            loss, pred = self.action_decoder.loss_and_act(
                latent_plan, ad_states[:, :-1], actions[:, :-1], None, draws, generator
            )
            gt_gripper = actions[:, :-1, -1]
        if pred.dim() == actions.dim():
            pred = pred[..., -1]
        pred_gripper = torch.where(pred > 0, 1.0, -1.0)
        grip_acc = (gt_gripper == pred_gripper).float().mean()
        return loss, grip_acc

    def compute_loss(
        self,
        states: Dict[str, Tensor],
        actions: Tensor,
        kl_beta: float | Tensor,
        eps: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        sample_pp: bool = False,
        pp_eps: Optional[Tensor] = None,
        draws: Optional[Dict[str, Any]] = None,
    ) -> Tuple[Tensor, Dict[str, Tensor], Optional[Tensor]]:
        """The ELBO. ``eps`` (B, latent_plan_dim) is the posterior's
        standard-normal draw, ``draws`` as in the module docstring. Returns
        (total_loss, metrics, sampled_plan_pp): with ``sample_pp`` a plan
        sampled from the proposal prior (its standard normal ``pp_eps``,
        JAX's k_pp), else None (the JAX train step discards it)."""
        draws = draws or {}
        emb, pp_dist, pr_dist, lat_goal = self.process_batch(states)
        kl_loss = self.compute_kl_loss(pr_dist, pp_dist)
        kl_scaled = kl_loss * kl_beta

        ad_states = torch.cat([emb[m] for m in self.ad_modalities], dim=-1)
        latent_plan = pr_dist.sample(generator, eps=eps)  # rsample: gradients flow
        action_loss, grip_acc = self._action_loss(
            ad_states, actions, latent_plan, lat_goal, draws.get("decoder"), generator
        )
        total = kl_scaled + action_loss
        metrics = {
            "kl_loss": kl_loss,
            "kl_loss_scaled": kl_scaled,
            "action_loss": action_loss,
            "gripper_accuracy": grip_acc,
        }
        if self.add_random_plan_loss or self.log_random_plan_loss:
            rand_plan, rand_goal = (
                uniform_pm1(draws.get(k), like.shape, like, generator)
                for k, like in (("random_plan", pr_dist.mean), ("random_goal", lat_goal))
            )
            with torch.set_grad_enabled(self.add_random_plan_loss and torch.is_grad_enabled()):
                rand_loss, rand_acc = self._action_loss(
                    ad_states, actions, rand_plan, rand_goal, draws.get("random_decoder"), generator
                )
            metrics["random_plan_action_loss"] = rand_loss
            metrics["random_plan_gripper_accuracy"] = rand_acc
            if self.add_random_plan_loss:
                total = total - rand_loss
        metrics["total_loss"] = total
        sampled_plan_pp = pp_dist.sample(generator, eps=pp_eps) if sample_pp else None
        return total, metrics, sampled_plan_pp

    # -- rollout-time interfaces (used by the evaluation agents) -----------

    def encode_frame(self, obs: Dict[str, Tensor], modalities) -> Tensor:
        return self.perceptual_encoder.encode(obs, tuple(modalities), cat_output=True)

    def propose_plan(self, obs: Dict[str, Tensor], goal: Dict[str, Tensor]) -> TanhNormal:
        """The plan-proposal prior over latent plans from the current
        observation and the goal image."""
        pp_state = self.encode_frame(obs, self.pp_obs_modalities)
        pp_goal = self.goal_encoder(self.encode_frame(goal, self.pp_goal_modalities))
        return self.plan_proposal.get_dist(pp_state, pp_goal)

    def recognize_plan(self, states: Dict[str, Tensor]):
        emb = self.get_emb_states(states)
        return self.plan_recognition(torch.cat([emb[m] for m in self.pr_modalities], dim=-1))

    def decode_action(
        self,
        latent_plan: Tensor,
        obs: Dict[str, Tensor],
        carry: Optional[Tensor],
        latent_goal: Optional[Tensor] = None,
        draws: Optional[Dict[str, Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Tensor, Tensor]:
        """One streaming decoder step: encode the frame, run one RNN step
        (``ActionDecoderLogistic.act``); returns (actions (B, A + 1),
        carry)."""
        emb = self.encode_frame(obs, self.ad_modalities)
        action, carry = self.action_decoder.act(
            latent_plan, emb[:, None], latent_goal, carry, draws, generator
        )
        return action[:, 0], carry


def uniform_pm1(given: Optional[Tensor], shape, like: Tensor, generator) -> Tensor:
    """``given`` in ``like``'s dtype and device, else a uniform draw on
    [-1, 1) there (the random plan and goal)."""
    if given is not None:
        return torch.as_tensor(given).to(like)
    return draw_rows(lambda s: torch.rand(s, generator=generator, device=like.device), shape) * 2.0 - 1.0


class PlayLMPModule(AlgorithmModule):
    name = "play_lmp"

    def build(self) -> None:
        cfg = self.cfg
        self.latent_plan_dim = int(cfg.get("latent_plan_dim", 16))
        self.pp_obs = tuple(cfg.get("plan_proposal_obs_modalities", ["rgb_static"]))
        self.pp_goal = tuple(cfg.get("plan_proposal_goal_modalities", ["rgb_static"]))
        self.pr_mods = tuple(cfg.get("plan_recognition_modalities", ["rgb_static"]))
        self.ad_mods = tuple(cfg.get("action_decoder_modalities", ["rgb_static"]))
        vector_dims = dict(cfg.get("vector_dims", {}))
        all_mods: List[str] = []
        for m in self.pp_obs + self.pp_goal + self.pr_mods + self.ad_mods:
            if m not in all_mods:
                all_mods.append(m)

        # construction initializes weights from the global CPU RNG; fork it
        # so building a module leaves the caller's stream untouched
        # (init_state re-initializes from its seed)
        with torch.random.fork_rng(devices=[]):
            encoder = build_late_fusion(
                cfg["perceptual_encoder"]["networks"], all_mods, vector_dims,
                image_sizes(cfg.get("transforms")),
            )
            pp_state_dim = encoder.calc_state_dim(self.pp_obs)
            pp_goal_dim = encoder.calc_state_dim(self.pp_goal)
            pr_dim = encoder.calc_state_dim(self.pr_mods)
            ad_dim = encoder.calc_state_dim(self.ad_mods)

            goal_cfg = dict(cfg.get("goal_encoder", {}))
            goal_cls = get_class(
                goal_cfg.pop("_target_", "tacorl_tpu.networks.goal_encoder.VisualGoalEncoder")
            )
            goal_encoder = goal_cls(
                in_features=pp_goal_dim, out_features=pp_goal_dim, **goal_cfg
            )

            pr_cfg = dict(cfg.get("plan_recognition", {}))
            pr_cls = get_class(
                pr_cfg.pop(
                    "_target_",
                    "tacorl_tpu.networks.plan_recognition.PlanRecognitionTransformer",
                )
            )
            plan_recognition = pr_cls(
                state_dim=pr_dim, latent_plan_dim=self.latent_plan_dim, **pr_cfg
            )

            pp_cfg = dict(cfg.get("plan_proposal", {}))
            policy_cfg = dict(pp_cfg.pop("policy", {}))
            policy_cls = get_class(
                policy_cfg.pop("_target_", "tacorl_tpu.networks.actor.MLPPolicy")
            )
            plan_proposal = Actor(
                policy=policy_cls(
                    action_dim=self.latent_plan_dim,
                    input_dim=pp_state_dim + pp_goal_dim,
                    **policy_cfg,
                ),
                action_dim=self.latent_plan_dim,
                state_dim=pp_state_dim,
                goal_dim=pp_goal_dim,
                **pp_cfg,
            )

            ad_cfg = dict(cfg.get("action_decoder", {}))
            ad_cls = get_class(
                ad_cfg.pop(
                    "_target_",
                    "tacorl_tpu.networks.action_decoder.ActionDecoderLogistic",
                )
            )
            action_decoder = ad_cls(
                state_dim=ad_dim,
                goal_dim=pp_goal_dim,
                latent_plan_dim=self.latent_plan_dim,
                **ad_cfg,
            )

            self.net = PlayLMPNet(
                perceptual_encoder=encoder,
                goal_encoder=goal_encoder,
                plan_recognition=plan_recognition,
                plan_proposal=plan_proposal,
                action_decoder=action_decoder,
                pp_obs_modalities=self.pp_obs,
                pp_goal_modalities=self.pp_goal,
                pr_modalities=self.pr_mods,
                ad_modalities=self.ad_mods,
                kl_balancing=bool(cfg.get("kl_balancing", True)),
                kl_alpha=float(cfg.get("kl_alpha", 0.8)),
                add_random_plan_loss=bool(cfg.get("add_random_plan_loss", False)),
                log_random_plan_loss=bool(cfg.get("log_random_plan_loss", False)),
            )
        self.transforms = DeviceTransforms(cfg.get("transforms"), device=self.device)
        self.lr = float(cfg.get("lr", 1e-4))
        self.kl_beta = float(cfg.get("kl_beta", 1e-3))
        self.generator = torch.Generator(device=self.device)

    # -- schedule ------------------------------------------------------------

    def set_kl_beta(self, kl_beta: float) -> None:
        """KL-schedule callback hook."""
        self.kl_beta = float(kl_beta)

    def step_scalars(self) -> Dict[str, float]:
        return {"kl_beta": self.kl_beta}

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Initialize the parameters from ``seed`` (each layer's JAX-package
        init), move them to the device, seed the module's generator and
        make the Adam optimizer (optax.adam's defaults)."""
        with seeded_init(seed, self.device):
            reset_parameters(self.net)
        self.net.to(self.device)
        self.generator.manual_seed(seed)
        params = [p for p in self.net.parameters() if p.requires_grad]
        optimizer = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        return TrainState(step=0, net=self.net, optimizer=optimizer)

    # -- steps --------------------------------------------------------------

    def make_train_step(self):
        net, transforms, generator, device = (
            self.net, self.transforms, self.generator, self.device
        )

        def train_step(
            state: TrainState,
            batch: Dict[str, Any],
            scalars: Optional[Dict[str, float]] = None,
            *,
            aug_draws: Optional[Dict[str, Dict[str, Tensor]]] = None,
            eps: Optional[Tensor] = None,
            draws: Optional[Dict[str, Any]] = None,
        ) -> Tuple[TrainState, Dict[str, Tensor]]:
            """One step: augment -> loss -> backward -> Adam, in place on
            ``state``. ``aug_draws`` maps an image modality to its
            ``shifts``/``factors``; ``eps`` is the posterior's draw,
            ``draws`` the random plan's and the decoders' (module
            docstring)."""
            scalars = self.step_scalars() if scalars is None else scalars
            net.train()
            # the ranges name the step's stages in a torch.profiler trace
            with record_function("play_lmp/augment"):
                states = transforms(
                    batch["states"], train=True, draws=aug_draws, generator=generator
                )
                actions = torch.as_tensor(batch["actions"]).to(device, torch.float32)
            state.optimizer.zero_grad(set_to_none=True)
            with record_function("play_lmp/loss"):
                total, metrics, _ = net.compute_loss(
                    states, actions, step_scalar(scalars["kl_beta"]), eps=eps, generator=generator,
                    draws=draws,
                )
            with record_function("play_lmp/backward"):
                total.backward()
            with record_function("play_lmp/adam"):
                # the mean over the dp ranks first (no-op without a process group)
                params = [p for p in net.parameters() if p.grad is not None]
                grads = reduce_gradients(params)
                # optax.global_norm: the l2 norm over all gradient leaves,
                # an mp shard's squares summed over its group
                metrics["grad_norm"] = global_norm(grads, params)
                state.optimizer.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

        return train_step

    def make_val_step(self):
        net, transforms, generator, device = (
            self.net, self.transforms, self.generator, self.device
        )

        def val_step(
            state: TrainState,
            batch: Dict[str, Any],
            scalars: Optional[Dict[str, float]] = None,
            *,
            eps: Optional[Tensor] = None,
            pp_eps: Optional[Tensor] = None,
            draws: Optional[Dict[str, Any]] = None,
        ) -> Tuple[Dict[str, Tensor], Dict[str, Any]]:
            """The loss metrics under the evaluation transforms, in eval
            mode, without gradients; the outputs hold ``sampled_plan_pp``,
            the batch's ``idx`` and, when the batch has ``state_info``, its
            first and last frames (``state_info_initial``/``_final``).
            ``eps``/``pp_eps`` are the posterior's and the prior's draws."""
            scalars = self.step_scalars() if scalars is None else scalars
            net.eval()
            with torch.no_grad():
                states = transforms(batch["states"], train=False)
                actions = torch.as_tensor(batch["actions"]).to(device, torch.float32)
                _, metrics, sampled_plan_pp = net.compute_loss(
                    states, actions, step_scalar(scalars["kl_beta"]), eps=eps,
                    generator=generator, sample_pp=True, pp_eps=pp_eps, draws=draws,
                )
            outputs = {"sampled_plan_pp": sampled_plan_pp, "idx": batch["idx"]}
            if "state_info" in batch:
                outputs["state_info_initial"] = {k: v[:, 0] for k, v in batch["state_info"].items()}
                outputs["state_info_final"] = {k: v[:, -1] for k, v in batch["state_info"].items()}
            return metrics, outputs

        return val_step
