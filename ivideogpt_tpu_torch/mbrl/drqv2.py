"""The DrQ-v2 policy, the port of the acting side of
``ivideogpt_tpu/mbrl/drqv2.py``: the conv ``Encoder``, the tanh ``Actor``
and the batched policy that the imagination rollout queries each frame.
The critic, the update and the agent's optimiser are not ported yet.

Observations are NHWC frame stacks in [0, 255], as in the JAX package. The
convs run NCHW inside, and the encoder flattens its output in NHWC order,
as the JAX encoder does, so the actor's first layer reads the features in
the JAX order (``utils.checkpoint.drqv2_state_dict`` loads JAX weights).
Module names are the DrQ-v2 reference's (``convnet``, ``trunk``,
``policy``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ivideogpt_tpu_torch.mbrl.utils import truncated_normal_sample
from ivideogpt_tpu_torch.utils.platform import resolve_device


class Encoder(nn.Module):
    """Four 3x3 convs of 32 channels, the first with stride 2, VALID
    padding, ReLU: [B, H, W, C] in [0, 255] -> [B, 32 * h * w] features."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.convnet = nn.Sequential(
            nn.Conv2d(in_channels, 32, 3, stride=2), nn.ReLU(),
            nn.Conv2d(32, 32, 3), nn.ReLU(),
            nn.Conv2d(32, 32, 3), nn.ReLU(),
            nn.Conv2d(32, 32, 3), nn.ReLU())

    @staticmethod
    def output_dim(height: int, width: int) -> int:
        h, w = (height - 3) // 2 + 1 - 6, (width - 3) // 2 + 1 - 6
        return 32 * h * w

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.permute(0, 3, 1, 2) / 255.0 - 0.5
        return self.convnet(x).permute(0, 2, 3, 1).flatten(1)


class Actor(nn.Module):
    """features -> Linear, LayerNorm (eps 1e-6, Flax's), tanh -> two ReLU
    layers -> tanh: the action mean in [-1, 1]."""

    def __init__(self, repr_dim: int, action_dim: int, feature_dim: int = 50,
                 hidden_dim: int = 1024):
        super().__init__()
        self.trunk = nn.Sequential(nn.Linear(repr_dim, feature_dim),
                                   nn.LayerNorm(feature_dim, eps=1e-6),
                                   nn.Tanh())
        self.policy = nn.Sequential(
            nn.Linear(feature_dim, hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, hidden_dim), nn.ReLU(),
            nn.Linear(hidden_dim, action_dim))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.policy(self.trunk(h)))


class DrQV2Policy(nn.Module):
    """Encoder and actor together: ``forward`` gives the action mean, the
    JAX agent's eval-mode ``_act_impl``."""

    def __init__(self, obs_shape: Sequence[int], action_dim: int,
                 feature_dim: int = 50, hidden_dim: int = 1024):
        super().__init__()
        h, w, c = obs_shape
        self.encoder = Encoder(c)
        self.actor = Actor(Encoder.output_dim(h, w), action_dim, feature_dim,
                           hidden_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(self.encoder(obs))


def build_policy(obs_shape: Sequence[int], action_dim: int, *,
                 feature_dim: int = 50, hidden_dim: int = 1024, seed: int = 0,
                 device=None) -> DrQV2Policy:
    """A policy with random weights from ``seed``, in eval mode, on CUDA
    unless ``device`` says otherwise."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        policy = DrQV2Policy(obs_shape, action_dim, feature_dim, hidden_dim)
    return policy.to(dev).eval()


@torch.no_grad()
def batched_policy(policy: DrQV2Policy, obs: torch.Tensor, stddev: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """The rollout's policy function: obs [B, H, W, C] in [0, 255] -> actions
    [B, A], the mean plus truncated-normal noise of ``stddev`` (the JAX
    agent's ``batched_policy``)."""
    return truncated_normal_sample(policy(obs), stddev, generator)
