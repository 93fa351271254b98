"""Dict-observation adapters around Actor and Critic (port of
tacorl_tpu/networks/visual_wrappers.py): encode the observation and goal
modalities through a LateFusion encoder (and the goal through an optional
goal encoder), concatenate, delegate. state_dict keys follow the
reference: ``encoder.networks.<modality>.*``, ``goal_encoder.mlp.*``, then
``actor.policy.*`` or ``critic.Q.*``. The CQL step calls the actor's
samplers on the embedding (``networks/actor.py``), so the actor wrapper
keeps only the embedding; the VIB distribution (``get_vib_distribution``)
waits for the VIB encoder head."""

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

    def get_emb_representation(self, obs: Obs) -> Tensor:
        if not isinstance(obs, dict):
            return obs
        if self.goal_modalities and "goal" in obs:
            emb_obs = self.encoder.encode(obs["observation"], self.env_modalities)
            emb_goal = self.encoder.encode(obs["goal"], self.goal_modalities)
            if self.goal_encoder is not None:
                emb_goal = self.goal_encoder(emb_goal)
            return torch.cat([emb_obs, emb_goal], dim=-1)
        return self.encoder.encode(obs, self.env_modalities)


class VisualActorWrapper(_VisualWrapperBase):
    def __init__(self, encoder, goal_encoder, env_modalities, goal_modalities, actor: Actor):
        super().__init__(encoder, goal_encoder, env_modalities, goal_modalities)
        self.actor = actor


class VisualCriticWrapper(_VisualWrapperBase):
    def __init__(self, encoder, goal_encoder, env_modalities, goal_modalities, critic: Critic):
        super().__init__(encoder, goal_encoder, env_modalities, goal_modalities)
        self.critic = critic

    def forward(self, obs: Obs, action: Tensor) -> Tensor:
        return self.critic(self.get_emb_representation(obs), action)
