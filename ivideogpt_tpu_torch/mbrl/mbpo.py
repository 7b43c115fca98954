"""The MBPO workspace, the port of ``ivideogpt_tpu/mbrl/mbpo.py``: env
stepping with the DrQ-v2 agent, a seed phase, the world model's initial
training and its periodic updates, batched imagination into an imagined
replay buffer, agent batches mixing real and imagined transitions by
``real_ratio``, ``validate`` (rollout against the ground truth), eval
episodes and snapshots.

The world model is the port's ``VideoPredictor`` (bf16 over fp32 masters,
an int8 rollout cache) on the agent's device, from random weights or from
a pretrained hub (``pretrained_model_path``: ``tokenizer/`` re-sliced to the
world model's context, ``transformer/`` as the LLaMA alone or the whole
action model). An imagination rollout runs the agent's live policy: the
rollout is queued on the card's one stream before the agent's next update,
so it reads the weights of its dispatch.

Differences from the JAX workspace, each on purpose:
- the snapshot is the port's (``drq_workspace.save_agent_snapshot``:
  safetensors and JSON under ``{work_dir}/snapshot/``, the pending
  ``_gen_starts`` with it), not a pickle of JAX trees. It holds the world
  model too (``model`` / ``tokenizer`` beside it, at the same step) and
  whether its initial training and imagination rounds are done, so a
  resumed run goes on as an uninterrupted one would, where the JAX
  workspace resumes the agent alone and trains its world model afresh;
- a rollout's generator is seeded from ``np.random.randint(2**31)``, the
  draw the JAX workspace makes for its rollout key.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                         ActionModelConfig, _JsonMixin)
from ivideogpt_tpu_torch.mbrl import drqv2
from ivideogpt_tpu_torch.mbrl import utils as drq_utils
from ivideogpt_tpu_torch.mbrl.drq_workspace import (data_specs,
                                                    load_agent_snapshot,
                                                    make_agent,
                                                    save_agent_snapshot)
from ivideogpt_tpu_torch.mbrl.logger import Logger
from ivideogpt_tpu_torch.mbrl.replay_buffer import (ReplayBufferStorage,
                                                    make_replay_loader,
                                                    make_segment_replay_loader)
from ivideogpt_tpu_torch.mbrl.video import (TrainVideoRecorder, VideoRecorder,
                                            save_imagination_gif,
                                            save_validate_gif)
from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor


@dataclass(frozen=True)
class MBPOConfig(_JsonMixin):
    """MBPO's settings, field for field the JAX package's."""
    task_name: str = "coffee-push"
    frame_stack: int = 3
    action_repeat: int = 2
    discount: float = 0.99
    num_train_frames: int = 1_000_000
    num_seed_frames: int = 4000
    eval_every_frames: int = 20000
    num_eval_episodes: int = 20
    save_snapshot: bool = True
    replay_buffer_size: int = 1_000_000
    replay_buffer_num_workers: int = 1
    nstep: int = 3
    batch_size: int = 256
    demo_path: Optional[str] = None
    # with demo: demo_path_prefix/task_name
    demo: bool = False
    demo_path_prefix: Optional[str] = None
    seed: int = 1
    save_video: bool = True
    save_train_video: bool = False
    use_tb: bool = True
    # agent
    lr: float = 1e-4
    feature_dim: int = 50
    hidden_dim: int = 1024
    critic_target_tau: float = 0.01
    num_expl_steps: int = 2000
    stddev_schedule: str = "linear(1.0,0.1,100000)"
    stddev_clip: float = 0.3
    agent_update_times: int = 2
    # metaworld
    camera: str = "corner"
    duration: int = 100
    succ_bonus: float = 10.0
    # mbpo
    gen_every_steps: int = 200
    gen_batch: int = 32
    gen_horizon: int = 10
    update_gen_every_step: int = 10
    update_tokenizer_every_step: int = 40
    update_gen_times: int = 1
    init_update_gen_steps: int = 1000
    init_gen_times: int = 20
    real_ratio: float = 0.5
    start_mbpo: int = 4000
    # world model
    wm_context_length: int = 2
    wm_segment_length: int = 12
    wm_action_dim: int = 4
    wm_batch_size: int = 16
    wm_tok_lr: float = 1e-4
    wm_model_lr: float = 1e-4
    wm_tok_wd: float = 0.0
    wm_model_wd: float = 0.0
    wm_max_target_frames: int = 5
    wm_reward_weight: float = 1.0
    wm_symlog: bool = True
    wm_freeze_codebook: bool = True
    # the pretrained world model: {path}/tokenizer/ and {path}/transformer/
    pretrained_model_path: Optional[str] = None
    load_internal_llm: bool = True
    # dispatch a round's rollout, then fetch and store the previous round's
    # while the card runs it (imagined episodes land one round later)
    gen_pipeline: bool = True
    # roll out gen_rounds rounds of start frames as one batch of
    # gen_rounds * gen_batch
    gen_rounds: int = 1


# Per-task budgets: "easy" / "medium" / "hard" are the difficulty bases;
# each task composes "easy" and then overrides it.
DIFFICULTY_PRESETS = {
    "easy": dict(num_train_frames=1_100_000,
                 stddev_schedule="linear(1.0,0.1,100000)"),
    "medium": dict(num_train_frames=3_100_000,
                   stddev_schedule="linear(1.0,0.1,500000)"),
    "hard": dict(num_train_frames=30_100_000,
                 stddev_schedule="linear(1.0,0.1,2000000)"),
}

_EASY_TASK_OVERRIDES = dict(
    DIFFICULTY_PRESETS["easy"], action_repeat=2, eval_every_frames=2000,
    num_eval_episodes=20, num_train_frames=260002, num_seed_frames=4000)

TASK_PRESETS = {
    name: dict(_EASY_TASK_OVERRIDES, task_name=name.replace("_", "-"))
    for name in ("button_press_topdown_wall", "coffee_push", "door_lock",
                 "hammer", "handle_pull_side", "plate_slide")
}
TASK_PRESETS.update({k: dict(v) for k, v in DIFFICULTY_PRESETS.items()})


def apply_task_preset(cfg, preset: str, skip: Optional[set] = None):
    """cfg with a task preset laid over it; the fields in ``skip`` (set
    explicitly on the command line) keep their values."""
    key = preset.replace("-", "_")
    if key not in TASK_PRESETS:
        raise KeyError(
            f"unknown task preset {preset!r}; available: "
            f"{sorted(TASK_PRESETS)}")
    have = {f.name for f in dataclasses.fields(cfg)}
    vals = {k: v for k, v in TASK_PRESETS[key].items()
            if k in have and not (skip and k in skip)}
    return cfg.replace(**vals)


def _seeded_generator(device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw from numpy's global
    stream."""
    return torch.Generator(device=device).manual_seed(
        int(np.random.randint(2**31)))


class Workspace:
    """The MBPO loop on ``env_fn(seed)`` environments (Metaworld tasks
    unless given), the world model at ``tok_cfg`` / ``lm_cfg``
    (TOKENIZER_64 and LLAMA_BASE unless given); on CUDA unless ``device``
    says otherwise."""

    def __init__(self, cfg: MBPOConfig, work_dir: Optional[str] = None,
                 env_fn=None, tok_cfg=None, lm_cfg=None, device=None):
        self.work_dir = Path(work_dir or os.getcwd())
        self.cfg = cfg
        np.random.seed(cfg.seed)

        self.logger = Logger(self.work_dir, use_tb=cfg.use_tb)

        if env_fn is None:
            from ivideogpt_tpu_torch.mbrl import metaworld_env
            env_fn = lambda seed: metaworld_env.make(  # noqa: E731
                cfg.task_name, cfg.frame_stack, cfg.action_repeat, seed,
                cfg.camera, cfg.duration, cfg.succ_bonus)
        self.train_env = env_fn(cfg.seed)
        self.eval_env = env_fn(cfg.seed)
        specs = data_specs(self.train_env)

        if not cfg.save_snapshot:
            print("[warn] save_snapshot=False deletes fetched episode files; "
                  "the agent and world-model loaders share the buffer dir "
                  "and will starve each other — use True (reference default)")
        self.replay_storage = ReplayBufferStorage(specs,
                                                  self.work_dir / "buffer")
        if cfg.demo and cfg.demo_path is None:
            if not cfg.demo_path_prefix:
                raise ValueError(
                    "demo=true needs demo_path_prefix (or an explicit "
                    "demo_path): the demos are read from "
                    "demo_path_prefix/task_name")
            cfg = cfg.replace(demo_path=str(
                Path(cfg.demo_path_prefix) / cfg.task_name))
            self.cfg = cfg
        real_bs = int(cfg.batch_size * cfg.real_ratio)
        self.replay_buffer, self.replay_iter_real = make_replay_loader(
            self.work_dir / "buffer", cfg.replay_buffer_size, real_bs,
            cfg.replay_buffer_num_workers, cfg.save_snapshot, cfg.nstep,
            cfg.discount, cfg.demo_path, seed=cfg.seed)

        self.imag_replay_storage = ReplayBufferStorage(
            specs, self.work_dir / "imag_buffer")
        self.imag_buffer, self.imag_iter = make_replay_loader(
            self.work_dir / "imag_buffer", cfg.replay_buffer_size,
            cfg.batch_size - real_bs, cfg.replay_buffer_num_workers, False,
            cfg.nstep, cfg.discount, seed=cfg.seed + 1)

        self.seg_buffer, self.seg_iter = make_segment_replay_loader(
            self.work_dir / "buffer", cfg.replay_buffer_size,
            cfg.wm_batch_size, cfg.replay_buffer_num_workers,
            cfg.save_snapshot, cfg.nstep, cfg.discount,
            cfg.gen_horizon + cfg.wm_context_length, cfg.demo_path,
            seed=cfg.seed + 2)

        self.agent = make_agent(cfg, self.train_env, device)
        self.device = self.agent.device

        tok_cfg = tok_cfg or TOKENIZER_64
        lm_cfg = lm_cfg or LLAMA_BASE
        weights = {}
        if cfg.pretrained_model_path:
            from ivideogpt_tpu_torch.utils import checkpoint as ckpt
            tok_dir = os.path.join(cfg.pretrained_model_path, "tokenizer")
            # re-sliced to the world model's context, with the config read
            # from the checkpoint, so the modules match its weights
            weights["tok_state_dict"], loaded_cfg = \
                ckpt.load_tokenizer_for_context(tok_dir, cfg.wm_context_length)
            if loaded_cfg is not None:
                tok_cfg = loaded_cfg
            tf_dir = os.path.join(cfg.pretrained_model_path, "transformer")
            if os.path.exists(tf_dir):
                if cfg.load_internal_llm:
                    # the LLaMA alone; the action and reward heads start
                    # from random weights
                    weights["llm_state_dict"] = \
                        ckpt.load_llm_only_safetensors(tf_dir)
                else:
                    weights["lm_state_dict"] = \
                        ckpt.load_action_model_safetensors(tf_dir)
            else:
                print(f"[warn] {tf_dir} absent; world-model LLM starts "
                      "from random init (reference default loads it)")
        head_cfg = ActionModelConfig(
            action_dim=cfg.wm_action_dim, context_length=cfg.wm_context_length,
            segment_length=cfg.wm_segment_length,
            tokens_per_context=tok_cfg.ctx_tokens_per_frame,
            tokens_per_dyna=tok_cfg.dyn_tokens_per_frame,
            reward_prediction=True)
        self.video_predictor = VideoPredictor(
            tok_cfg, lm_cfg, head_cfg, tok_lr=cfg.wm_tok_lr,
            model_lr=cfg.wm_model_lr, tok_wd=cfg.wm_tok_wd,
            model_wd=cfg.wm_model_wd, reward_weight=cfg.wm_reward_weight,
            use_symlog=cfg.wm_symlog, freeze_codebook=cfg.wm_freeze_codebook,
            max_target_frames=cfg.wm_max_target_frames, seed=cfg.seed,
            device=self.device, **weights)

        self.video_recorder = VideoRecorder(
            self.work_dir if cfg.save_video else None)
        self.train_video_recorder = TrainVideoRecorder(
            self.work_dir if cfg.save_train_video else None)

        self.timer = drq_utils.Timer()
        self._global_step = 0
        self._global_episode = 0
        self._init_model = False  # the world model's initial training done
        self._init_gen = False    # the init_gen_times rounds done
        self._pending_gen = None  # the imagination round in flight
        self._gen_starts = []     # start batches gathered under gen_rounds

    # ------------------------------------------------------------------

    @property
    def global_step(self):
        return self._global_step

    @property
    def global_frame(self):
        return self._global_step * self.cfg.action_repeat

    def mixed_batch(self):
        """An agent batch: real transitions, and imagined ones once MBPO
        has started and the imagined buffer holds an episode (else real)."""
        real = next(self.replay_iter_real)
        if self.global_frame >= self.cfg.start_mbpo and \
                self.imag_buffer._episode_fns:
            fake = next(self.imag_iter)
        else:
            fake = next(self.replay_iter_real)
        return tuple(np.concatenate([r, f], 0) for r, f in zip(real, fake))

    def eval(self):
        """``num_eval_episodes`` episodes in the real env with the mean
        action; the first one recorded with its rewards."""
        step, episode, total_reward, total_success = 0, 0, 0.0, 0
        until = drq_utils.Until(self.cfg.num_eval_episodes)
        while until(episode):
            ts = self.eval_env.reset()
            ep_success = 0.0
            self.video_recorder.init(self.eval_env, enabled=(episode == 0))
            while not ts.last():
                action = self.agent.act(ts.observation, self.global_step,
                                        eval_mode=True)
                ts = self.eval_env.step(action)
                self.video_recorder.record(self.eval_env, ts.reward)
                total_reward += ts.reward
                ep_success += ts.success
                step += 1
            total_success += float(ep_success >= 1.0)
            episode += 1
            self.video_recorder.save(f"{self.global_frame}.gif")

        with self.logger.log_and_dump_ctx(self.global_frame, ty="eval") as log:
            log("episode_reward", total_reward / episode)
            log("episode_success", total_success / episode)
            log("episode_length", step * self.cfg.action_repeat / episode)
            log("episode", self._global_episode)
            log("step", self.global_step)

    def _expl_uniform(self) -> bool:
        """Imagined actions are uniform(-1, 1) before num_expl_steps."""
        return max(self.global_step - 1, 0) < self.cfg.num_expl_steps

    def _store_pending_gen(self):
        """Fetch the imagination round in flight (if any) and store its
        episodes, every 10th also as a GIF; returns the reward mean or
        None."""
        if self._pending_gen is None:
            return None
        obss, actions, rewards = self._pending_gen.fetch()
        self._pending_gen = None
        for i in range(len(obss)):
            path = self.imag_replay_storage._store_episode({
                "action": actions[i].astype(np.float32),
                "observation": obss[i].astype(np.uint8),
                "reward": rewards[i][:, None].astype(np.float32),
                "discount": np.ones_like(rewards[i][:, None], np.float32),
            })
            if self.cfg.save_video and i % 10 == 0:
                gif = Path(str(path).replace("imag_buffer", "imag_gif")
                           .replace(".npz", ".gif"))
                save_imagination_gif(gif, obss[i].astype(np.uint8),
                                     rewards[i])
        return float(rewards.mean())

    def _dispatch_rollout(self, obs0):
        """Dispatch one imagination rollout from start stacks ``obs0`` with
        the agent's live policy; returns the pending rollout."""
        stddev = drq_utils.schedule(self.cfg.stddev_schedule,
                                    max(self.global_step - 1, 0))
        return self.video_predictor.rollout_async(
            obs0, drqv2.batched_policy, self.agent.policy,
            self.cfg.gen_horizon, frame_stack=self.cfg.frame_stack,
            policy_stddev=stddev, generator=_seeded_generator(self.device),
            expl_uniform=self._expl_uniform())

    def _flush_gen_starts(self):
        """Dispatch the start batches still gathered under gen_rounds > 1
        (at the end of ``train`` only: a snapshot keeps them instead)."""
        if not self._gen_starts:
            return
        obs0 = np.concatenate(self._gen_starts, axis=0)
        self._gen_starts = []
        rm = self._store_pending_gen()
        if rm is not None:
            self.logger.log_metrics({"gen/reward_mean": rm},
                                    self.global_frame, ty="train")
        self._pending_gen = self._dispatch_rollout(obs0)

    def generate(self):
        """One imagination round into the imagined buffer. With
        ``gen_pipeline``: dispatch this round's rollout, then fetch and
        store the previous round's. With ``gen_rounds`` = N > 1: the first
        N - 1 calls only gather start batches; the N-th rolls out all of
        them at once."""
        start = time.time()
        # start frames from the real buffer only
        self._gen_starts.append(
            next(self.replay_iter_real)[0][: self.cfg.gen_batch])
        if len(self._gen_starts) < self.cfg.gen_rounds:
            return {"gen/time": time.time() - start}
        obs0 = np.concatenate(self._gen_starts, axis=0)
        self._gen_starts = []
        pending = self._dispatch_rollout(obs0)
        if self.cfg.gen_pipeline:
            try:
                reward_mean = self._store_pending_gen()
            finally:
                # the new round is dispatched: keep it whatever the
                # previous round's fetch did
                self._pending_gen = pending
        else:
            self._pending_gen = pending
            reward_mean = self._store_pending_gen()
        # under gen_pipeline: the dispatch and the previous round's wait
        # and store, not this round's rollout
        metrics = {"gen/time": time.time() - start}
        if reward_mean is not None:
            metrics["gen/reward_mean"] = reward_mean
        return metrics

    def validate(self, global_frame):
        """The world model's rollout with the recorded actions against a
        real segment: frame and reward MSE, and the GIFs."""
        obs, action, reward = next(self.seg_iter)
        k = self.cfg.frame_stack
        stacks = [obs[:, i:obs.shape[1] - (k - 1 - i)] for i in range(k)]
        obs_gt = np.concatenate(stacks, axis=-1)  # [B, T-k+1, h, w, 3k]
        # the actions from the step after the first stack
        act = action[:, k - 1:]

        start = time.time()
        obs_pred, _, reward_pred = self.video_predictor.rollout(
            obs_gt[:, 0], None, None, obs_gt.shape[1] - 1, frame_stack=k,
            generator=_seeded_generator(self.device),
            replay_actions=act[:, : obs_gt.shape[1] - 1])
        obs_mse = float(np.mean(
            (obs_pred[:, 1:] / 255.0 - obs_gt[:, 1:] / 255.0) ** 2))
        # the buffer's rewards are [B, L, 1], the rollout's [B, T]
        reward_gt = reward[:, k - 1:][:, :obs_gt.shape[1], 0]
        reward_mse = float(np.mean(
            (reward_pred[:, 1:] - reward_gt[:, 1:]) ** 2))
        val_time = time.time() - start
        if self.cfg.save_video:
            for i in range(obs_gt.shape[0]):
                save_validate_gif(
                    self.work_dir / "validate_gif"
                    / f"val-sample-{global_frame}-{i}.gif",
                    obs_gt[i], obs_pred[i], reward_gt[i], reward_pred[i])
        return {"val/obs_mse": obs_mse, "val/reward_mse": reward_mse,
                "val/time": val_time}

    # ------------------------------------------------------------------

    def train(self):
        """The loop, to ``num_train_frames``: seed steps; then the world
        model's initial training and validation, its update every
        ``update_gen_every_step`` frames (the tokenizer's every
        ``update_tokenizer_every_step``), ``init_gen_times`` imagination
        rounds at ``start_mbpo`` and one every ``gen_every_steps`` frames,
        and ``agent_update_times`` agent updates a step on mixed batches."""
        cfg = self.cfg
        train_until = drq_utils.Until(cfg.num_train_frames, cfg.action_repeat)
        seed_until = drq_utils.Until(cfg.num_seed_frames, cfg.action_repeat)
        eval_every = drq_utils.Every(cfg.eval_every_frames, cfg.action_repeat)
        gen_every = drq_utils.Every(cfg.gen_every_steps, cfg.action_repeat)
        update_gen_every = drq_utils.Every(cfg.update_gen_every_step,
                                           cfg.action_repeat)

        episode_step, episode_reward, episode_success = 0, 0.0, 0.0
        ts = self.train_env.reset()
        self.replay_storage.add(ts)
        self.train_video_recorder.init(ts.observation)
        metrics = None

        while train_until(self.global_step):
            if ts.last():
                self._global_episode += 1
                self.train_video_recorder.save(f"{self.global_frame}.gif")
                if metrics is not None:
                    elapsed, total = self.timer.reset()
                    ep_frame = episode_step * cfg.action_repeat
                    with self.logger.log_and_dump_ctx(self.global_frame,
                                                      ty="train") as log:
                        log("fps", ep_frame / max(elapsed, 1e-9))
                        log("total_time", total)
                        log("episode_reward", episode_reward)
                        log("episode_success", float(episode_success >= 1.0))
                        log("episode_length", ep_frame)
                        log("episode", self._global_episode)
                        log("buffer_size", len(self.replay_storage))
                        log("step", self.global_step)
                ts = self.train_env.reset()
                self.replay_storage.add(ts)
                self.train_video_recorder.init(ts.observation)
                if cfg.save_snapshot and self._global_episode % 10 == 0:
                    self.save_snapshot()
                episode_step, episode_reward, episode_success = 0, 0.0, 0.0
                if not seed_until(self.global_step) and \
                        self._global_episode % 5 == 0:
                    metrics = self.validate(self.global_frame)
                    self.logger.log_metrics(metrics, self.global_frame,
                                            ty="eval")

            if eval_every(self.global_step):
                self.logger.log("eval/total_time", self.timer.total_time(),
                                self.global_frame)
                self.eval()

            action = self.agent.act(ts.observation, self.global_step,
                                    eval_mode=False)

            if not seed_until(self.global_step):
                if not self._init_model:
                    for i in range(cfg.init_update_gen_steps):
                        metrics = self.video_predictor.train(
                            next(self.seg_iter))
                        if i % 10 == 0:
                            self.logger.log_metrics(
                                {k + "_init": v for k, v in metrics.items()},
                                i, ty="train")
                    self.video_predictor.save_snapshot(
                        str(self.work_dir), self._global_step, suffix="_init")
                    metrics = self.validate(self.global_frame)
                    self.logger.log_metrics(metrics, self.global_frame,
                                            ty="eval")
                    self._init_model = True
                elif update_gen_every(self.global_step):
                    upd_tok = self.global_step % (
                        cfg.update_tokenizer_every_step
                        // cfg.action_repeat) == 0
                    for _ in range(cfg.update_gen_times):
                        metrics = self.video_predictor.train(
                            next(self.seg_iter), update_tokenizer=upd_tok)
                    self.logger.log_metrics(metrics, self.global_frame,
                                            ty="train")

                if self.global_frame >= cfg.start_mbpo and \
                        not self._init_gen:
                    for _ in range(cfg.init_gen_times):
                        self.generate()
                    self._init_gen = True

                for _ in range(cfg.agent_update_times):
                    metrics = self.agent.update(self.mixed_batch(),
                                                self.global_step)
                self.logger.log_metrics(metrics, self.global_frame,
                                        ty="train")

                if self.global_frame >= cfg.start_mbpo and \
                        gen_every(self.global_step):
                    metrics = self.generate()
                    self.logger.log_metrics(metrics, self.global_frame,
                                            ty="train")

            ts = self.train_env.step(action)
            episode_reward += ts.reward
            episode_success += ts.success
            self.replay_storage.add(ts)
            self.train_video_recorder.record(ts.observation)
            episode_step += 1
            self._global_step += 1

        # land the round in flight, and any start batches still gathered
        self._flush_gen_starts()
        rm = self._store_pending_gen()
        if rm is not None:
            self.logger.log_metrics({"gen/reward_mean": rm},
                                    self.global_frame, ty="train")

    def save_snapshot(self):
        """The agent, the counters and the gathered ``_gen_starts``
        (``drq_workspace.save_agent_snapshot``), and the world model at the
        same step. The round in flight is fetched and stored first;
        gathered start batches are kept, not rolled out."""
        rm = self._store_pending_gen()
        if rm is not None:
            self.logger.log_metrics({"gen/reward_mean": rm},
                                    self.global_frame, ty="train")
        self.video_predictor.save_snapshot(str(self.work_dir),
                                           self._global_step)
        save_agent_snapshot(
            self.work_dir, self.agent,
            {"_global_step": self._global_step,
             "_global_episode": self._global_episode,
             "init_model": self._init_model, "init_gen": self._init_gen},
            tensors={"gen_starts": {
                str(i): torch.from_numpy(np.ascontiguousarray(s))
                for i, s in enumerate(self._gen_starts)}})

    def load_snapshot(self):
        """Restore what :meth:`save_snapshot` wrote. Raises when the world
        model's snapshot is of another step than the agent's."""
        tensors, counters = load_agent_snapshot(self.work_dir, self.agent)
        step = self.video_predictor.load_snapshot(str(self.work_dir))
        if step != counters["_global_step"]:
            raise ValueError(
                f"{self.work_dir}: the world model's snapshot is of step "
                f"{step}, the agent's of step {counters['_global_step']}")
        self._global_step = counters["_global_step"]
        self._global_episode = counters["_global_episode"]
        self._init_model = bool(counters["init_model"])
        self._init_gen = bool(counters["init_gen"])
        starts = tensors.get("gen_starts", {})
        self._gen_starts = [starts[str(i)].numpy()
                            for i in range(len(starts))]

    def close(self):
        """Stop the replay loaders' threads."""
        for it in (self.replay_iter_real, self.imag_iter, self.seg_iter):
            it.close()
