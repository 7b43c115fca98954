"""The DrQ-v2 agent, the port of ``ivideogpt_tpu/mbrl/drqv2.py``: the
random-shift augmentation, the conv ``Encoder``, the tanh ``Actor``, the
twin ``Critic``, the batched policy that the imagination rollout queries
each frame, and ``DrQV2Agent`` with its update: n-step TD on the clipped
double-Q target, the actor's step every ``delay_steps`` updates on
detached features, and the Polyak target.

Observations are NHWC frame stacks in [0, 255], as in the JAX package. The
convs run NCHW inside, and the encoder flattens its output in NHWC order,
as the JAX encoder does, so the actor's and the critic's first layers read
the features in the JAX order (``utils.checkpoint.drqv2_agent_state_dict``
loads a JAX agent's weights). The critic's heads keep the JAX names
(``Q1_1``, ``Q1_2``, ``Q1_out``, ``Q2_*``).

The agent computes in fp32 with TF32 off. Its three AdamW states are
``train/optim.py``'s ``TrainState`` with optax.adamw's settings in the JAX
agent (a fixed lr, weight decay 1e-6 on every parameter, no clipping).
All of an update's random draws (the two shift tensors and the two normal
draws) come from :func:`update_draws`, so a test can feed the JAX draws
instead. As in the JAX package, each ``act`` and ``update`` call without
draws takes one ``np.random.randint(2**31)`` from numpy's global stream,
here the seed of the call's ``torch.Generator``, and the uniform
exploration actions come from ``np.random``.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ivideogpt_tpu_torch.mbrl.utils import (schedule, soft_update,
                                            truncated_normal,
                                            truncated_normal_sample)
from ivideogpt_tpu_torch.train.optim import TrainState
from ivideogpt_tpu_torch.utils.platform import (full_fp32, resolve_device,
                                                to_device)

PAD = 4


def random_shift_aug(x: torch.Tensor, shifts: torch.Tensor,
                     pad: int = PAD) -> torch.Tensor:
    """Shift each image of x [n, h, w, c] by an integer (row, column) offset
    in [-pad, pad]: edge padding of ``pad``, then a gather of the h x w
    window at ``shifts`` [n, 2] (integers in [0, 2 pad]) of the padded
    image."""
    n, h, w, _ = x.shape
    xp = nn.functional.pad(x.permute(0, 3, 1, 2), (pad,) * 4,
                           mode="replicate").permute(0, 2, 3, 1)
    rows = torch.arange(h, device=x.device)[None] + shifts[:, 0:1]
    cols = torch.arange(w, device=x.device)[None] + shifts[:, 1:2]
    batch = torch.arange(n, device=x.device)[:, None, None]
    return xp[batch, rows[:, :, None], cols[:, None, :], :]


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


class Critic(nn.Module):
    """features -> Linear, LayerNorm (eps 1e-6), tanh, then with the action
    appended two heads of two ReLU layers and a scalar: (Q1, Q2)."""

    def __init__(self, repr_dim: int, action_dim: int, feature_dim: int = 50,
                 hidden_dim: int = 1024):
        super().__init__()
        self.trunk = nn.Sequential(nn.Linear(repr_dim, feature_dim),
                                   nn.LayerNorm(feature_dim, eps=1e-6),
                                   nn.Tanh())
        for q in ("Q1", "Q2"):
            setattr(self, f"{q}_1", nn.Linear(feature_dim + action_dim,
                                              hidden_dim))
            setattr(self, f"{q}_2", nn.Linear(hidden_dim, hidden_dim))
            setattr(self, f"{q}_out", nn.Linear(hidden_dim, 1))

    def _q(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(getattr(self, f"{name}_1")(x))
        x = torch.relu(getattr(self, f"{name}_2")(x))
        return getattr(self, f"{name}_out")(x)

    def forward(self, h: torch.Tensor, action: torch.Tensor):
        x = torch.cat([self.trunk(h), action], dim=-1)
        return self._q("Q1", x), self._q("Q2", x)


class UpdateDraws(NamedTuple):
    """An update's random draws: integer shifts [n, 2] in [0, 2 PAD] of the
    observations and of the next observations, and N(0, 1) draws [n, A] of
    the next action's noise and of the actor step's."""
    shift_obs: torch.Tensor
    shift_next: torch.Tensor
    next_noise: torch.Tensor
    actor_noise: torch.Tensor


def update_draws(n: int, action_dim: int, generator: torch.Generator
                 ) -> UpdateDraws:
    """All of an update's random draws, from ``generator`` (on the device
    the update runs on)."""
    dev = generator.device
    shifts = torch.randint(0, 2 * PAD + 1, (2, n, 2), generator=generator,
                           device=dev)
    normal = torch.randn((2, n, action_dim), generator=generator,
                         device=dev)
    return UpdateDraws(shifts[0], shifts[1], normal[0], normal[1])


class DrQV2Agent(nn.Module):
    """The DrQ-v2 agent: ``policy`` (encoder and actor), ``critic`` and its
    Polyak target ``critic_target`` as submodules (so ``state_dict`` holds
    every weight), AdamW states for the encoder, the actor and the critic,
    and ``updated_steps``. Random weights from ``seed`` (torch's own
    initialisation, not Flax's), on CUDA unless ``device`` says otherwise.
    """

    def __init__(self, obs_shape: Sequence[int], action_dim: int, *,
                 lr: float = 1e-4, feature_dim: int = 50,
                 hidden_dim: int = 1024, critic_target_tau: float = 0.01,
                 num_expl_steps: int = 2000, update_every_steps: int = 2,
                 stddev_schedule: str = "linear(1.0,0.1,100000)",
                 stddev_clip: float = 0.3, delay_steps: int = 1,
                 discount_gamma: float = 0.99, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.action_dim = action_dim
        self.critic_target_tau = critic_target_tau
        self.num_expl_steps = num_expl_steps
        self.update_every_steps = update_every_steps
        self.stddev_schedule = stddev_schedule
        self.stddev_clip = stddev_clip
        self.delay_steps = delay_steps
        h, w, _ = obs_shape
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.policy = DrQV2Policy(obs_shape, action_dim, feature_dim,
                                      hidden_dim)
            self.critic = Critic(Encoder.output_dim(h, w), action_dim,
                                 feature_dim, hidden_dim)
        self.critic_target = copy.deepcopy(self.critic).requires_grad_(False)
        self.to(dev)
        self.device = dev

        def adamw(module):
            return TrainState(module, learning_rate=lr, lr_scheduler="fixed",
                              weight_decay=1e-6, embed_no_wd=False,
                              max_grad_norm=None)
        self.encoder_state = adamw(self.policy.encoder)
        self.actor_state = adamw(self.policy.actor)
        self.critic_state = adamw(self.critic)
        self.updated_steps = 0
        self.generator = torch.Generator(device=dev)

    def _call_generator(self) -> torch.Generator:
        """The generator seeded by this call's draw from numpy's global
        stream (the JAX agent's ``jax.random.key(np.random.randint(2**31))``
        at the same point)."""
        return self.generator.manual_seed(int(np.random.randint(2**31)))

    # ------------------------------------------------------------------

    @torch.no_grad()
    def act(self, obs: np.ndarray, step: int, eval_mode: bool) -> np.ndarray:
        """obs [H, W, C] in [0, 255] -> action [A]: the mean in eval mode,
        else the mean plus truncated-normal noise of the scheduled stddev;
        uniform(-1, 1) from ``np.random`` before ``num_expl_steps``."""
        gen = self._call_generator()
        stddev = schedule(self.stddev_schedule, step)
        x = to_device(np.asarray(obs)[None], self.device).float()
        with full_fp32():
            mu = self.policy(x)
            if not eval_mode:
                mu = truncated_normal_sample(mu, stddev, gen)
        a = mu[0].cpu().numpy()
        if not eval_mode and step < self.num_expl_steps:
            a = np.random.uniform(-1.0, 1.0, a.shape).astype(a.dtype)
        return a

    # ------------------------------------------------------------------

    @staticmethod
    def _take_step(states, loss):
        """Gradients of ``loss`` into each state's parameters alone, then
        each state's AdamW update."""
        params = [p for s in states for p in s.params]
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        for s in states:
            s.apply_gradients()

    def update_step(self, batch, stddev: float, draws: UpdateDraws,
                    update_actor: bool) -> Dict[str, torch.Tensor]:
        """One update on tensors on the agent's device: batch = (obs uint8
        or float [n, H, W, C], action [n, A], reward [n, 1], discount
        [n, 1], next_obs). Returns the metrics as 0-dim tensors, without
        waiting for the card."""
        obs, action, reward, discount, next_obs = batch
        enc, actor = self.policy.encoder, self.policy.actor
        clip = self.stddev_clip
        with full_fp32():
            obs = random_shift_aug(obs.float(), draws.shift_obs)
            next_obs = random_shift_aug(next_obs.float(), draws.shift_next)
            with torch.no_grad():
                next_feat = enc(next_obs)
                next_action = truncated_normal(actor(next_feat),
                                               draws.next_noise, stddev, clip)
                tq1, tq2 = self.critic_target(next_feat, next_action)
                target_q = reward + discount * torch.minimum(tq1, tq2)
            feat = enc(obs)
            q1, q2 = self.critic(feat, action)
            critic_loss = (((q1 - target_q) ** 2).mean()
                           + ((q2 - target_q) ** 2).mean())
            self._take_step((self.encoder_state, self.critic_state), critic_loss)
            metrics = {"critic_loss": critic_loss.detach(),
                       "critic_q1": q1.detach().mean(),
                       "critic_q2": q2.detach().mean(),
                       "critic_target_q": target_q.mean(),
                       "batch_reward": reward.mean()}
            if update_actor:
                feat = feat.detach()
                a = truncated_normal(actor(feat), draws.actor_noise, stddev,
                                     clip)
                q1a, q2a = self.critic(feat, a)
                actor_loss = -torch.minimum(q1a, q2a).mean()
                self._take_step((self.actor_state,), actor_loss)
                soft_update(self.critic_target, self.critic,
                            self.critic_target_tau)
                metrics["actor_loss"] = actor_loss.detach()
        self.updated_steps += 1
        return metrics

    def update(self, batch, step: int) -> Dict[str, float]:
        """One update from a host batch (obs, action, reward, discount,
        next_obs; numpy NHWC) every ``update_every_steps`` steps, with the
        draws of :func:`update_draws`. Returns float metrics ({} on the
        steps in between)."""
        if step % self.update_every_steps != 0:
            return {}
        draws = update_draws(len(batch[0]), self.action_dim,
                             self._call_generator())
        stddev = schedule(self.stddev_schedule, step)
        update_actor = self.updated_steps % self.delay_steps == 0
        batch = tuple(to_device(x, self.device) for x in batch)
        metrics = self.update_step(batch, stddev, draws, update_actor)
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------

    def train_states(self) -> Dict[str, TrainState]:
        return {"encoder": self.encoder_state, "actor": self.actor_state,
                "critic": self.critic_state}
