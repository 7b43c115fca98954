"""The MBPO world model, the port of ``ivideogpt_tpu/mbrl/video_predictor.py``:
batched imagination rollouts with the policy inside, and the online
finetuning of the tokenizer and the action-conditioned LM.

    vp = VideoPredictor(TOKENIZER_64, LLAMA_BASE, head_cfg)     # on CUDA
    policy = drqv2.build_policy((64, 64, 9), action_dim=4)
    pending = vp.rollout_async(obs, drqv2.batched_policy, policy, horizon=10,
                               generator=torch.Generator("cuda"))
    obss, actions, rewards = pending.fetch()    # numpy, as in the JAX package
    metrics = vp.train((obs, action, reward))

The rollout is a Python loop over frames on one CUDA stream (the JAX package
runs it as one jitted scan): the context frames are encoded (K1) and decoded
once (``build_decode_cache``); the context stream, without a trailing sdf,
fills the KV cache (K4 prefill); then each frame
- takes its action from the policy on the current frame stack (or from
  ``replay_actions``; ``expl_uniform`` replaces it by uniform(-1, 1)),
- decodes its sdf with the action's embedding added,
- samples 16 tokens with exact top-k 100 and decodes each of them, the 16th
  too (K3 over the int8 cache): the reward head reads the hidden state after
  the 16th,
- decodes its 16 dynamics ids to pixels (``decode_dyn_frame``) and rolls
  the stack.
The frame loop is ``generation.generate``'s, with the policy as its
``action_fn`` and the pixel decode as its ``on_frame``. Nothing in the
dispatch waits for the card: the inputs reach it through pinned memory,
and the card hands back one packed buffer (uint8 frames, fp32 actions and
rewards); ``fetch`` rebuilds the stacked observations on the host. Each
part runs inside a span (``utils.profiling``) named in ``ROLLOUT_RANGES``,
a ``record_function`` range under a profiler, so a trace splits the
rollout's host and device time by part.

Compute is bf16 over fp32 masters by default: the rollout runs bf16 copies
of the masters under the cast rules (the LM's matrices and the tokenizer's
convs; norms, biases and the VQ codebooks stay fp32), which each training
step refreshes, so a rollout after ``train`` sees the updated weights.

``train`` takes one tokenizer step (L1 + LPIPS on the context frames and on
a random subset of at most ``max_target_frames`` future frames, plus both
commit losses) and one LM step (cross-entropy plus ``reward_weight`` times
the MSE of the reward head against the symlog'd rewards), each clipped by
the global norm of all its gradients and applied by AdamW. With
``freeze_codebook`` the two codebooks keep their gradients in that norm and
are never moved: the JAX package's ``optax.masked`` passes their clipped
gradients through as updates (ROADMAP, Queue 3), which the port does not
copy.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ivideogpt_tpu_torch import generation
from ivideogpt_tpu_torch import tokens as token_lib
from ivideogpt_tpu_torch.configs import (ActionModelConfig,
                                         CompressiveVQConfig,
                                         TransformerConfig)
from ivideogpt_tpu_torch.mbrl.utils import symexp, symlog
from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
from ivideogpt_tpu_torch.models.lpips import LPIPS
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.train.optim import TrainState, global_norm
from ivideogpt_tpu_torch.train.tokenizer_trainer import recon_loss
from ivideogpt_tpu_torch.utils import profiling
from ivideogpt_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_train_state,
                                                  save_train_state)
from ivideogpt_tpu_torch.utils.platform import (full_fp32, resolve_device,
                                                to_device)

CODEBOOKS = ("quantize.embedding.weight",
             "dynamics_quantize.embedding.weight")
ROLLOUT_RANGES = ("mbrl.encode_context", "generation.prefill",
                  "mbrl.policy", "generation.decode", "mbrl.decode_dyn_frame")

PolicyFn = Callable[..., torch.Tensor]


@torch.no_grad()
def _copy_params(master, copy_):
    """Copy an fp32 master's parameters into the compute-dtype copy the
    rollout runs (nothing where the rollout runs the master itself)."""
    if copy_ is not master:
        for p, q in zip(master.parameters(), copy_.parameters()):
            q.copy_(p)


class RolloutResult(NamedTuple):
    """A rollout's outputs on the device; frames, actions and rewards are
    views of one packed buffer."""
    frames: torch.Tensor    # [B, H, h, w, 3] uint8 imagined frames
    actions: torch.Tensor   # [B, H+1, A], row 0 zeros
    rewards: torch.Tensor   # [B, H+1], row 0 zeros
    tokens: torch.Tensor    # [B, H, dyn_tokens] sampled (vocab) ids


class PendingRollout:
    """A rollout the card may still be running; :meth:`fetch` waits for it
    and returns ``(obss, actions, rewards)`` as numpy arrays."""

    def __init__(self, result: RolloutResult, packed_host: torch.Tensor,
                 done: Optional[torch.cuda.Event], obs: np.ndarray):
        self.result = result
        self._host = packed_host
        self._done = done
        self._obs = obs

    def fetch(self):
        if self._done is not None:
            self._done.synchronize()
        res = self.result
        B, H = res.frames.shape[:2]
        buf = self._host.numpy()
        n_act, n_rew = res.actions.numel(), res.rewards.numel()
        floats = buf[:4 * (n_act + n_rew)].view(np.float32)
        actions = floats[:n_act].reshape(res.actions.shape).copy()
        rewards = floats[n_act:].reshape(res.rewards.shape).copy()
        frames = buf[4 * (n_act + n_rew):].reshape(res.frames.shape)
        obs = self._obs
        k3 = obs.shape[-1]  # 3 * frame_stack channels
        obss = np.empty((B, H + 1, *obs.shape[1:3], k3), np.uint8)
        obss[:, 0] = np.clip(np.round(obs.astype(np.float32)), 0,
                             255).astype(np.uint8)
        for t in range(H):
            obss[:, t + 1, ..., :k3 - 3] = obss[:, t, ..., 3:]
            obss[:, t + 1, ..., k3 - 3:] = frames[:, t]
        return obss, actions, rewards


class VideoPredictor:
    """The tokenizer and the action-conditioned LM with their training
    states; ``train``, ``rollout_async``, ``rollout`` and the snapshot.
    Weights are random from ``seed`` unless state dicts in the port's names
    are given (``llm_state_dict``: the LLaMA alone, the heads random). On
    CUDA unless ``device`` says otherwise."""

    def __init__(self, tok_cfg: CompressiveVQConfig,
                 lm_cfg: TransformerConfig, head_cfg: ActionModelConfig, *,
                 tok_lr: float = 1e-4, model_lr: float = 1e-4,
                 tok_wd: float = 0.0, model_wd: float = 0.0,
                 reward_weight: float = 1.0, use_symlog: bool = True,
                 max_grad_norm: float = 1.0, freeze_codebook: bool = False,
                 max_target_frames: int = 16, seed: int = 0,
                 tok_state_dict=None, lm_state_dict=None,
                 llm_state_dict=None, lpips_state_dict=None,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 rollout_cache_dtype: torch.dtype = torch.int8, device=None):
        if not head_cfg.reward_prediction:
            raise ValueError("the world model needs the reward head "
                             "(head_cfg.reward_prediction)")
        self.device = resolve_device(device)
        self.tok_cfg, self.lm_cfg, self.head_cfg = tok_cfg, lm_cfg, head_cfg
        self.ctx = head_cfg.context_length
        self.reward_weight = reward_weight
        self.use_symlog = use_symlog
        self.max_target_frames = max_target_frames
        self.compute_dtype = compute_dtype
        self.rollout_cache_dtype = rollout_cache_dtype
        # draws the tokenizer step's target frames
        self.generator = torch.Generator().manual_seed(seed)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.tokenizer = CompressiveVQModel(tok_cfg, compute_dtype)
            self.model = HeadModelWithAction(lm_cfg, head_cfg, compute_dtype)
            self.lpips = LPIPS(compute_dtype)
        if lm_state_dict is not None and llm_state_dict is not None:
            raise ValueError("give lm_state_dict or llm_state_dict, not both")
        for module, sd in ((self.tokenizer, tok_state_dict),
                           (self.model, lm_state_dict),
                           (self.model.llm, llm_state_dict),
                           (self.lpips, lpips_state_dict)):
            if sd is not None:
                module.load_state_dict(sd, strict=True)
        self.lpips.requires_grad_(False)
        self.tokenizer.to(self.device).train()
        self.model.to(self.device).train()
        self.lpips.to(self.device).eval()

        self.tok_state = TrainState(
            self.tokenizer, learning_rate=tok_lr, lr_scheduler="fixed",
            weight_decay=tok_wd, embed_no_wd=False,
            max_grad_norm=max_grad_norm,
            frozen=CODEBOOKS if freeze_codebook else ())
        self.model_state = TrainState(
            self.model, learning_rate=model_lr, lr_scheduler="constant",
            warmup_steps=0, total_steps=10**9, weight_decay=model_wd,
            embed_no_wd=True, max_grad_norm=max_grad_norm)

        # the models the rollout runs: the masters in fp32, else their
        # compute-dtype copies, refreshed by each training step
        if compute_dtype == torch.float32:
            self.rollout_tokenizer, self.rollout_model = (self.tokenizer,
                                                          self.model)
        else:
            self.rollout_tokenizer = generation.cast_conv_params(
                copy.deepcopy(self.tokenizer), compute_dtype)
            self.rollout_model = generation.cast_matmul_params(
                copy.deepcopy(self.model), compute_dtype)
            for m in (self.rollout_tokenizer, self.rollout_model):
                m.requires_grad_(False).eval()

    # ------------------------------------------------------------------
    # online finetuning

    def tokenizer_step(self, obs: torch.Tensor, target_idx: torch.Tensor
                       ) -> dict:
        """One tokenizer step. obs [B, T, h, w, 3] in [0, 1]; target_idx
        the future frames (indices from 0 after the context) to
        reconstruct. Returns the JAX step's metrics and the gradients'
        global norm before the clip, as 0-dim tensors."""
        ctx = self.ctx
        ref = obs[:, :ctx].flatten(0, 1)
        target = obs[:, ctx:][:, target_idx].flatten(0, 1)

        def perc(a, b):
            return self.lpips(a * 2.0 - 1.0, b * 2.0 - 1.0).float().mean()

        with full_fp32():
            dec, ref_dec, commit, dyn_commit = self.tokenizer(
                ref, target, len(target_idx))
            m = {"recon_loss": recon_loss(target, dec, "l1"),
                 "ref_recon_loss": recon_loss(ref, ref_dec, "l1"),
                 "perceptual_loss": perc(target, dec),
                 "ref_perceptual_loss": perc(ref, ref_dec),
                 "commit_loss": commit, "dyna_commit_loss": dyn_commit}
            loss = sum(m.values())
            loss.backward()
        m["tokenizer_grad_norm"] = global_norm(
            p.grad for p in self.tok_state.params if p.grad is not None)
        self.tok_state.apply_gradients()
        _copy_params(self.tokenizer, self.rollout_tokenizer)
        m["tokenizer_loss"] = loss
        return {k: v.detach() for k, v in m.items()}

    def model_step(self, obs: torch.Tensor, action: torch.Tensor,
                   reward: torch.Tensor) -> dict:
        """One LM step on the current tokenizer's tokens. obs [B, T, h, w, 3]
        in [0, 1], action [B, T, A], reward [B, T] (symlog'd when
        ``use_symlog``). The head after frame t's last token is trained on
        reward[:, ctx + t], as in the JAX package. Returns the JAX step's
        metrics and the gradients' global norm before the clip."""
        ctx = self.ctx
        with torch.no_grad():
            ids, labels = self.tokenizer.tokenize(obs, ctx)
        out = self.model(ids, labels, action)
        target = reward[:, ctx:]
        pred = out["reward_pred"].float()
        ce = out["loss"]
        r_loss = ((pred - target) ** 2).mean()
        loss = ce + self.reward_weight * r_loss
        loss.backward()
        gnorm = global_norm(p.grad for p in self.model_state.params
                            if p.grad is not None)
        self.model_state.apply_gradients()
        _copy_params(self.model, self.rollout_model)
        m = {"ce_loss": ce, "reward_loss": r_loss, "model_loss": loss,
             "model_grad_norm": gnorm,
             "model_train/reward_mean": target.mean(),
             "model_train/reward_pred_mean": pred.mean()}
        return {k: v.detach() for k, v in m.items()}

    def train(self, batch, update_tokenizer: bool = True,
              update_model: bool = True) -> dict:
        """batch = (obs [B, T, h, w, 3] in [0, 255], action [B, T, A],
        reward [B, T] or [B, T, 1]), numpy or tensors. Returns float
        metrics and ``model_update_time`` (host seconds)."""
        start = time.time()
        obs, action, reward = (torch.as_tensor(x).to(self.device,
                                                     torch.float32)
                               for x in batch)
        obs = obs / 255.0
        if reward.ndim == 3:
            reward = reward[..., 0]   # the segment buffer's [B, T, 1]
        if self.use_symlog:
            reward = symlog(reward)
        metrics = {}
        if update_tokenizer:
            n_future = obs.shape[1] - self.ctx
            num_target = min(n_future, self.max_target_frames)
            if num_target < n_future:
                idx = torch.randperm(n_future, generator=self.generator)
                idx = idx[:num_target].sort().values
            else:
                idx = torch.arange(n_future)
            metrics.update(self.tokenizer_step(obs, idx.to(self.device)))
        if update_model:
            metrics.update(self.model_step(obs, action, reward))
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["model_update_time"] = time.time() - start
        return metrics

    # ------------------------------------------------------------------
    # imagination rollout

    @torch.inference_mode()
    def rollout_async(self, obs, policy_fn: Optional[PolicyFn], agent_state,
                      horizon: int, frame_stack: int = 3,
                      policy_stddev: float = 0.1,
                      generator: Optional[torch.Generator] = None,
                      replay_actions=None, expl_uniform: bool = False
                      ) -> PendingRollout:
        """Dispatch a batched rollout from obs [B, h, w, 3 * frame_stack] in
        [0, 255] (a host array; a tensor on the card is copied to the host
        first, which waits for it) and return without waiting for the card.

        ``policy_fn(agent_state, obs_255, stddev, generator) -> [B, A]``
        acts on each frame's stack, unless ``replay_actions`` [B, H, A]
        gives the actions. ``generator`` (on the device) draws the tokens,
        the policy's noise and the uniform actions; a fresh seed when None.
        """
        dev = self.device
        tok, lm = self.rollout_tokenizer, self.rollout_model
        tc = self.tok_cfg
        ctx, n_dyn = self.ctx, tc.dyn_tokens_per_frame
        A = self.head_cfg.action_dim
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.seed()
        obs_host = (obs.detach().cpu().numpy() if torch.is_tensor(obs)
                    else np.array(obs))
        stack = to_device(obs_host, dev).float() / 255.0
        B, h, w = stack.shape[:3]
        if replay_actions is not None:
            replay_actions = to_device(replay_actions, dev).float()

        # one buffer for the host: fp32 actions and rewards, uint8 frames
        n_act, n_rew = B * (horizon + 1) * A, B * (horizon + 1)
        n_float = 4 * (n_act + n_rew)
        packed = torch.zeros(n_float + B * horizon * h * w * 3,
                             dtype=torch.uint8, device=dev)
        floats = packed[:n_float].view(torch.float32)
        actions = floats[:n_act].view(B, horizon + 1, A)
        rewards = floats[n_act:].view(B, horizon + 1)
        frames = packed[n_float:].view(B, horizon, h, w, 3)

        with profiling.span("mbrl.encode_context"):
            ctx_frames = stack.view(B, h, w, frame_stack, 3).movedim(3, 1)
            idx_c = tok.encode_context(ctx_frames[:, -ctx:].contiguous())
            _, dec_cache = tok.build_decode_cache(idx_c)
            prelude = token_lib.make_prelude(idx_c, tc.num_vq_embeddings,
                                             tc.num_dyn_embeddings)

        def act(t):
            with profiling.span("mbrl.policy"):
                if replay_actions is not None:
                    action = replay_actions[:, t]
                elif expl_uniform:
                    action = torch.rand((B, A), generator=generator,
                                        device=dev) * 2.0 - 1.0
                else:
                    action = policy_fn(agent_state, stack * 255.0,
                                       policy_stddev, generator)
                actions[:, t + 1] = action
            return action

        def decode_frame(t, toks, _reward):
            nonlocal stack
            with profiling.span("mbrl.decode_dyn_frame"):
                dyn_idx = (toks - tc.num_vq_embeddings).clamp(
                    0, tc.num_dyn_embeddings - 1)
                frame = tok.decode_dyn_frame(dyn_idx, dec_cache).float()
                frame = frame.clamp(0.0, 1.0)
                stack = torch.cat([stack[..., 3:], frame], dim=-1)
                frames[:, t] = torch.round(frame * 255.0).clamp(0, 255).to(
                    torch.uint8)

        res = generation.generate(
            lm, prelude, segment_length=ctx + horizon, context_length=ctx,
            generator=generator, action_fn=act, on_frame=decode_frame,
            tokens_per_dyna=n_dyn, reward_prediction=True,
            cache_dtype=self.rollout_cache_dtype)
        rewards[:, 1:] = symexp(res.rewards) if self.use_symlog else \
            res.rewards
        P1 = prelude.shape[1]
        toks = res.tokens[:, P1 - 1:].view(B, horizon, n_dyn + 1)[..., 1:]

        result = RolloutResult(frames, actions, rewards, toks)
        if dev.type != "cuda":
            return PendingRollout(result, packed, None, obs_host)
        host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return PendingRollout(result, host, done, obs_host)

    def rollout(self, obs, policy_fn: Optional[PolicyFn], agent_state,
                horizon: int, frame_stack: int = 3,
                policy_stddev: float = 0.1,
                generator: Optional[torch.Generator] = None,
                replay_actions=None, expl_uniform: bool = False):
        """:meth:`rollout_async`, then fetch: (obss [B, H+1, h, w, 3k]
        uint8, actions [B, H+1, A], rewards [B, H+1]), numpy."""
        return self.rollout_async(
            obs, policy_fn, agent_state, horizon, frame_stack=frame_stack,
            policy_stddev=policy_stddev, generator=generator,
            replay_actions=replay_actions,
            expl_uniform=expl_uniform).fetch()

    # ------------------------------------------------------------------
    # snapshot

    def save_snapshot(self, workdir: str, step: int, suffix: str = ""):
        """Both train states (weights, AdamW moments, counters) under
        ``{workdir}/model{suffix}`` and ``{workdir}/tokenizer{suffix}`` as
        ``checkpoint-{step}``, in the port's train-state format, replacing
        an earlier snapshot."""
        for name, state in (("model", self.model_state),
                            ("tokenizer", self.tok_state)):
            save_train_state(os.path.join(workdir, f"{name}{suffix}"), step,
                             state, keep=1)

    def load_snapshot(self, workdir: str, suffix: str = "") -> int:
        """Restore what :meth:`save_snapshot` wrote, and the rollout's
        copies of the weights with it; returns its step. Raises when the
        two parts are of different steps."""
        steps = set()
        for name, state in (("model", self.model_state),
                            ("tokenizer", self.tok_state)):
            path = latest_checkpoint(os.path.join(workdir, f"{name}{suffix}"))
            if path is None:
                raise FileNotFoundError(
                    f"no {name}{suffix} snapshot under {workdir}")
            restore_train_state(path, state)
            steps.add(int(path.rsplit("-", 1)[1]))
        if len(steps) != 1:
            raise ValueError(f"{workdir}: model{suffix} and "
                             f"tokenizer{suffix} snapshots of steps "
                             f"{sorted(steps)}")
        _copy_params(self.tokenizer, self.rollout_tokenizer)
        _copy_params(self.model, self.rollout_model)
        return steps.pop()
