"""Relay Imitation Learning: two-level behavior cloning (port of
tacorl_tpu/modules/ril.py; reference:
modules/relay_imitation_learning/relay_imitation_learning.py:13-225).

Low level: the log-density of the dataset action given (obs, embedding of a
near goal). High level: the log-density of the stop-gradient embedding of
the subgoal (the frame at the end of the low-level window) given (obs,
embedding of a far goal), a regression in the goal encoder's latent space.
Both levels go through ``Actor.log_prob`` (TanhNormal, targets clipped to
+-0.999, plus the Gumbel gripper term on a discrete-gripper low level). One
Adam over every parameter.

Randomness enters as data: ``draws`` maps each of the four observation
leaves (``obs``, ``low_level_goal``, ``high_level_goal``,
``high_level_action``) to that leaf's DeviceTransforms draws (modality ->
``shifts``/``factors``, or ``noise``), which the JAX step makes from
``fold_in(key, stable_fold(leaf))``; what is missing is drawn from the
module's ``torch.Generator``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch import Tensor
from torch.profiler import record_function

from tacorl_tpu_torch.config import get_class
from tacorl_tpu_torch.core.optimizers import reduce_gradients
from tacorl_tpu_torch.core.train_state import TrainState
from tacorl_tpu_torch.data.transforms import DeviceTransforms, image_sizes
from tacorl_tpu_torch.modules.base import AlgorithmModule, seeded_init
from tacorl_tpu_torch.networks.actor import Actor
from tacorl_tpu_torch.networks.goal_encoder import VisualGoalEncoder
from tacorl_tpu_torch.networks.late_fusion import LateFusion, build_late_fusion
from tacorl_tpu_torch.networks.layers import reset_parameters

__all__ = ["RILNet", "RILModule", "LEAVES"]

# the observation leaves of a batch, each augmented with its own draws
LEAVES = ("obs", "low_level_goal", "high_level_goal", "high_level_action")


class RILNet(nn.Module):
    """state_dict keys follow the reference RelayImitationLearning:
    ``perceptual_encoder.``, ``goal_encoder.``, ``high_level_policy.`` and
    ``low_level_policy.``."""

    def __init__(
        self,
        perceptual_encoder: LateFusion,
        goal_encoder: nn.Module,
        high_level_policy: Actor,
        low_level_policy: Actor,
        hl_modalities: Sequence[str],
        ll_modalities: Sequence[str],
    ):
        super().__init__()
        self.perceptual_encoder = perceptual_encoder
        self.goal_encoder = goal_encoder
        self.high_level_policy = high_level_policy
        self.low_level_policy = low_level_policy
        self.hl_modalities = tuple(hl_modalities)
        self.ll_modalities = tuple(ll_modalities)

    @property
    def all_modalities(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(self.hl_modalities + self.ll_modalities))

    def _emb(self, states: Dict[str, Tensor], modalities: Sequence[str]) -> Tensor:
        return self.perceptual_encoder.encode(states, modalities)

    def compute_loss(self, batch: Dict[str, Any]) -> Tuple[Tensor, Dict[str, Tensor]]:
        """(relay_imitation_learning.py:101-181) on a transformed batch. The
        observation is encoded once for both levels."""
        obs = self.perceptual_encoder.encode(batch["obs"], self.all_modalities, cat_output=False)
        ll_state = torch.cat([obs[m] for m in self.ll_modalities], dim=-1)
        hl_state = torch.cat([obs[m] for m in self.hl_modalities], dim=-1)

        ll_goal = self.goal_encoder(self._emb(batch["low_level_goal"], self.ll_modalities))
        low_level_loss = -self.low_level_policy.log_prob(
            torch.cat([ll_state, ll_goal], dim=-1), batch["low_level_action"]
        ).mean()

        hl_goal = self.goal_encoder(self._emb(batch["high_level_goal"], self.hl_modalities))
        # the subgoal embedding is a target: no gradient reaches the encoders
        # through it
        with torch.no_grad():
            hl_action = self.goal_encoder(
                self._emb(batch["high_level_action"], self.hl_modalities)
            )
        high_level_loss = -self.high_level_policy.log_prob(
            torch.cat([hl_state, hl_goal], dim=-1), hl_action
        ).mean()

        total = low_level_loss + high_level_loss
        return total, {
            "low_level_loss": low_level_loss,
            "high_level_loss": high_level_loss,
            "total_loss": total,
        }

    # -- rollout time (rollout_manager.py:480-510) ---------------------------

    def high_level_action(self, obs: Dict[str, Tensor], goal: Dict[str, Tensor]) -> Tensor:
        """The deterministic subgoal: tanh of the high-level mean."""
        state = self._emb(obs, self.hl_modalities)
        goal_emb = self.goal_encoder(self._emb(goal, self.hl_modalities))
        mean = self.high_level_policy(torch.cat([state, goal_emb], dim=-1))[0]
        return torch.tanh(mean)

    def low_level_action(self, obs: Dict[str, Tensor], subgoal: Tensor) -> Tensor:
        """The deterministic low-level action: tanh(mean), and the argmax
        gripper of a discrete-gripper actor."""
        state = self._emb(obs, self.ll_modalities)
        actions, _ = self.low_level_policy.get_actions(
            torch.cat([state, subgoal], dim=-1), deterministic=True
        )
        return actions

    def encode_goal(self, goal: Dict[str, Tensor]) -> Tensor:
        """A goal observation embedded into the subgoal space the low level
        conditions on: the path training takes for ``low_level_goal``. An
        oracle high level supplies subgoals through it."""
        return self.goal_encoder(self._emb(goal, self.ll_modalities))


class RILModule(AlgorithmModule):
    name = "ril"

    def build(self) -> None:
        cfg = self.cfg
        self.hl_mods = tuple(cfg.get("high_level_policy_modalities", ["rgb_static"]))
        self.ll_mods = tuple(cfg.get("low_level_policy_modalities", ["rgb_static"]))
        vector_dims = dict(cfg.get("vector_dims", {}))
        all_mods = list(dict.fromkeys(self.hl_mods + self.ll_mods))

        # construction initializes weights from the global CPU RNG; fork it
        # so building leaves the caller's stream untouched (init_state
        # re-initializes from its seed)
        with torch.random.fork_rng(devices=[]):
            encoder = build_late_fusion(
                cfg["perceptual_encoder"]["networks"], all_mods, vector_dims,
                image_sizes(cfg.get("transforms")),
            )
            hl_dim = encoder.calc_state_dim(self.hl_mods)
            ll_dim = encoder.calc_state_dim(self.ll_mods)
            goal_cfg = dict(cfg.get("goal_encoder", {}))
            goal_cfg.pop("_target_", None)
            goal_out = int(goal_cfg.pop("out_features", 32))
            # one goal encoder embeds both levels' goals (flax infers its
            # input width; the levels' modalities have the same width)
            goal_encoder = VisualGoalEncoder(in_features=ll_dim, out_features=goal_out, **goal_cfg)
            self.net = RILNet(
                perceptual_encoder=encoder,
                goal_encoder=goal_encoder,
                # the high level acts in the goal-embedding space
                high_level_policy=self._make_actor("high_level_policy", goal_out, hl_dim, goal_out),
                low_level_policy=self._make_actor(
                    "low_level_policy", int(cfg.get("action_dim", 7)), ll_dim, goal_out
                ),
                hl_modalities=self.hl_mods,
                ll_modalities=self.ll_mods,
            )
        self.transforms = DeviceTransforms(cfg.get("transforms"), device=self.device)
        self.lr = float(cfg.get("lr", 1e-4))
        self.generator = torch.Generator(device=self.device)

    def _make_actor(self, policy_key: str, action_dim: int, state_dim: int, goal_dim: int) -> Actor:
        """The reference's low level is a discrete-gripper actor
        (relay_imitation_learning.yaml: actor@low_level_policy:
        discrete_gripper). The flag shapes both the trunk's heads and the
        Actor; a trunk class that does not take it gets it stripped, as the
        JAX package does."""
        p_cfg = dict(self.cfg.get(policy_key, {}))
        p_cls = get_class(p_cfg.pop("_target_", "tacorl_tpu.networks.actor.MLPPolicy"))
        discrete_gripper = bool(p_cfg.get("discrete_gripper", False))
        fields = inspect.signature(p_cls.__init__).parameters
        if "discrete_gripper" not in fields and not any(
            p.kind is inspect.Parameter.VAR_KEYWORD for p in fields.values()
        ):
            p_cfg.pop("discrete_gripper", None)
        return Actor(
            policy=p_cls(action_dim=action_dim, input_dim=state_dim + goal_dim, **p_cfg),
            action_dim=action_dim,
            state_dim=state_dim,
            goal_dim=goal_dim,
            discrete_gripper=discrete_gripper,
        )

    # -- state -----------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """Initialize the parameters from ``seed`` (each layer's JAX-package
        init), move them to the device, seed the module's generator and
        make one Adam over everything (optax.adam's defaults)."""
        with seeded_init(seed, self.device):
            reset_parameters(self.net)
        self.net.to(self.device)
        self.generator.manual_seed(seed)
        optimizer = torch.optim.Adam(
            self.net.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8
        )
        return TrainState(step=0, net=self.net, optimizer=optimizer)

    # -- steps -----------------------------------------------------------------

    def _transform_batch(self, batch, train: bool, draws: Optional[Dict]) -> Dict[str, Any]:
        """Each observation leaf through the transforms with its own draws."""
        draws = draws or {}
        out = {
            k: self.transforms(batch[k], train=train, draws=draws.get(k), generator=self.generator)
            for k in LEAVES
        }
        out["low_level_action"] = torch.as_tensor(batch["low_level_action"]).to(
            self.device, torch.float32
        )
        return out

    def make_train_step(self):
        net = self.net

        def train_step(
            state: TrainState,
            batch: Dict[str, Any],
            scalars: Optional[Dict[str, float]] = None,
            *,
            draws: Optional[Dict[str, Any]] = None,
        ) -> Tuple[TrainState, Dict[str, Tensor]]:
            """One step: augment -> loss -> backward -> Adam, in place on
            ``state``; ``draws`` as in the module docstring."""
            net.train()
            with record_function("ril/augment"):
                tbatch = self._transform_batch(batch, True, draws)
            state.optimizer.zero_grad(set_to_none=True)
            with record_function("ril/loss"):
                total, metrics = net.compute_loss(tbatch)
            with record_function("ril/backward"):
                total.backward()
            with record_function("ril/adam"):
                reduce_gradients(net.parameters())  # the mean over the ranks
                state.optimizer.step()
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

        return train_step

    def make_val_step(self):
        net = self.net

        def val_step(state, batch, scalars=None, *, draws=None):
            """The loss metrics under the evaluation transforms, in eval
            mode, without gradients."""
            net.eval()
            with torch.no_grad():
                _, metrics = net.compute_loss(self._transform_batch(batch, False, draws))
            return metrics, {}

        return val_step

    # -- rollout-time policy -----------------------------------------------------

    def make_policy_fns(self):
        """``high(net, obs, goal)``, the deterministic subgoal, and
        ``low(net, obs, subgoal)``, the deterministic action, each on
        observations through the evaluation transforms; neither draws."""
        transforms = self.transforms

        def high(net, obs, goal):
            return net.high_level_action(transforms(obs, train=False), transforms(goal, train=False))

        def low(net, obs, subgoal):
            return net.low_level_action(transforms(obs, train=False), subgoal)

        return high, low
