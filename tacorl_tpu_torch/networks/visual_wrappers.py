"""Dict-observation adapters around Actor and Critic (port of
tacorl_tpu/networks/visual_wrappers.py): encode the observation and goal
modalities through a LateFusion encoder (and the goal through an optional
goal encoder), concatenate, delegate. state_dict keys follow the
reference: ``encoder.networks.<modality>.*``, ``goal_encoder.mlp.*``, then
``actor.policy.*`` or ``critic.Q.*``. The CQL step calls the actor's
samplers on the embedding (``networks/actor.py``); the rollout policies call
the wrapper's ``get_actions``. ``get_vib_distribution`` is the VIB head's
distribution of the ``rgb_static`` encoder (an encoder built with
``vib: true``). ``vib_eps`` ({"observation": {modality: eps}, "goal":
{...}}) gives the normals of VIB heads' samples, else they draw their own
(``networks/late_fusion.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import torch
import torch.nn as nn
from torch import Tensor

from tacorl_tpu_torch.networks.actor import Actor
from tacorl_tpu_torch.networks.critic import Critic
from tacorl_tpu_torch.networks.late_fusion import LateFusion

Obs = Union[Dict[str, Any], Tensor]

__all__ = ["VisualActorWrapper", "VisualCriticWrapper"]


class _VisualWrapperBase(nn.Module):
    def __init__(
        self,
        encoder: LateFusion,
        goal_encoder: Optional[nn.Module],
        env_modalities: Sequence[str],
        goal_modalities: Sequence[str],
    ):
        super().__init__()
        self.encoder = encoder
        self.goal_encoder = goal_encoder
        self.env_modalities = tuple(env_modalities)
        self.goal_modalities = tuple(goal_modalities)

    def get_emb_representation(self, obs: Obs, vib_eps: Optional[Dict[str, Dict[str, Tensor]]] = None) -> Tensor:
        if not isinstance(obs, dict):
            return obs
        vib_eps = vib_eps or {}
        if self.goal_modalities and "goal" in obs:
            emb_obs = self.encoder.encode(obs["observation"], self.env_modalities, eps=vib_eps.get("observation"))
            emb_goal = self.encoder.encode(obs["goal"], self.goal_modalities, eps=vib_eps.get("goal"))
            if self.goal_encoder is not None:
                emb_goal = self.goal_encoder(emb_goal)
            return torch.cat([emb_obs, emb_goal], dim=-1)
        return self.encoder.encode(obs, self.env_modalities, eps=vib_eps.get("observation"))


class VisualActorWrapper(_VisualWrapperBase):
    def __init__(self, encoder, goal_encoder, env_modalities, goal_modalities, actor: Actor):
        super().__init__(encoder, goal_encoder, env_modalities, goal_modalities)
        self.actor = actor

    def get_actions(
        self,
        obs: Obs,
        draws: Optional[Dict[str, Tensor]] = None,
        deterministic: bool = False,
        reparameterize: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """The actor's ``get_actions`` on the observation's embedding."""
        return self.actor.get_actions(
            self.get_emb_representation(obs), draws, reparameterize, generator, deterministic
        )


class VisualCriticWrapper(_VisualWrapperBase):
    def __init__(self, encoder, goal_encoder, env_modalities, goal_modalities, critic: Critic):
        super().__init__(encoder, goal_encoder, env_modalities, goal_modalities)
        self.critic = critic

    def forward(
        self,
        obs: Obs,
        action: Tensor,
        mask: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        vib_eps: Optional[Dict[str, Dict[str, Tensor]]] = None,
    ) -> Tensor:
        """``mask`` and ``generator``: an MC-dropout trunk's keep mask or
        its source (``networks/critic.py``)."""
        return self.critic(self.get_emb_representation(obs, vib_eps), action, mask, generator)

    def get_vib_distribution(self, obs: Obs):
        """The VIB distribution of the rgb_static encoder
        (visual_critic_wrapper.py:25-33)."""
        obs_dict = obs["observation"] if self.goal_modalities and "goal" in obs else obs
        return self.encoder.networks["rgb_static"].get_dist(obs_dict["rgb_static"])
