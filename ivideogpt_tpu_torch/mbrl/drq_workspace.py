"""The model-free DrQ-v2 baseline, the port of
``ivideogpt_tpu/mbrl/drq_workspace.py``: act -> env.step -> replay ->
agent.update, with eval episodes and a snapshot at each episode's end. It
shares the env wrappers, the replay buffer, the agent, the logger and the
recorders with the MBPO workspace (``mbrl/mbpo.py``), which adds the world
model.

The snapshot is the port's own, not a pickle of JAX trees: the agent's
three AdamW states (weights, moments, counts), its Polyak target and the
loop's counters in one ``utils/checkpoint.save_train_states`` checkpoint
under ``{work_dir}/snapshot/`` (see :func:`save_agent_snapshot`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ivideogpt_tpu_torch.configs import _JsonMixin
from ivideogpt_tpu_torch.mbrl import utils as drq_utils
from ivideogpt_tpu_torch.mbrl.drqv2 import DrQV2Agent
from ivideogpt_tpu_torch.mbrl.logger import Logger
from ivideogpt_tpu_torch.mbrl.metaworld_env import Array
from ivideogpt_tpu_torch.mbrl.replay_buffer import (ReplayBufferStorage,
                                                    make_replay_loader)
from ivideogpt_tpu_torch.mbrl.video import TrainVideoRecorder, VideoRecorder
from ivideogpt_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                  restore_train_states,
                                                  save_train_states)

SNAPSHOT = "snapshot"


@dataclass(frozen=True)
class DrQConfig(_JsonMixin):
    """The DrQ-v2 baseline's settings, field for field the JAX package's."""
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


def data_specs(env):
    """The replay storage's specs: observation, action, reward, discount."""
    return (env.observation_spec(), env.action_spec(),
            Array((1,), np.float32, "reward"),
            Array((1,), np.float32, "discount"))


def make_agent(cfg, env, device) -> DrQV2Agent:
    obs_spec, act_spec = env.observation_spec(), env.action_spec()
    return DrQV2Agent(
        obs_spec.shape, act_spec.shape[0], lr=cfg.lr,
        feature_dim=cfg.feature_dim, hidden_dim=cfg.hidden_dim,
        critic_target_tau=cfg.critic_target_tau,
        num_expl_steps=cfg.num_expl_steps, update_every_steps=1,
        stddev_schedule=cfg.stddev_schedule, stddev_clip=cfg.stddev_clip,
        seed=cfg.seed, device=device)


def has_snapshot(work_dir) -> bool:
    return latest_checkpoint(os.path.join(str(work_dir), SNAPSHOT)) is not None


def save_agent_snapshot(work_dir, agent: DrQV2Agent, counters: Dict[str, int],
                        tensors: Optional[Dict[str, Dict]] = None) -> str:
    """The agent (its AdamW states, ``critic_target`` and
    ``updated_steps``), the loop's ``counters`` and further named tensor
    dicts as ``{work_dir}/snapshot/checkpoint-{global_step}``, replacing
    the one before."""
    return save_train_states(
        os.path.join(str(work_dir), SNAPSHOT), counters["_global_step"],
        agent.train_states(),
        tensors={"critic_target": agent.critic_target.state_dict(),
                 **(tensors or {})},
        counters={**counters, "updated_steps": agent.updated_steps},
        keep=1)


def load_agent_snapshot(work_dir, agent: DrQV2Agent):
    """Restore the newest :func:`save_agent_snapshot` into ``agent``;
    returns (the other tensor dicts by name, the loop's counters)."""
    path = latest_checkpoint(os.path.join(str(work_dir), SNAPSHOT))
    if path is None:
        raise FileNotFoundError(f"no snapshot under {work_dir}")
    tensors, counters = restore_train_states(path, agent.train_states())
    agent.critic_target.load_state_dict(tensors.pop("critic_target"))
    agent.updated_steps = counters.pop("updated_steps")
    return tensors, counters


class DrQWorkspace:
    """The DrQ-v2 training loop on ``env_fn(seed)`` environments (Metaworld
    tasks unless given), the agent on CUDA unless ``device`` says
    otherwise."""

    def __init__(self, cfg: DrQConfig, work_dir: Optional[str] = None,
                 env_fn=None, device=None):
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

        self.replay_storage = ReplayBufferStorage(
            data_specs(self.train_env), self.work_dir / "buffer")
        self.replay_buffer, self.replay_iter = make_replay_loader(
            self.work_dir / "buffer", cfg.replay_buffer_size, cfg.batch_size,
            cfg.replay_buffer_num_workers, cfg.save_snapshot, cfg.nstep,
            cfg.discount, cfg.demo_path, seed=cfg.seed)

        self.agent = make_agent(cfg, self.train_env, device)

        self.video_recorder = VideoRecorder(
            self.work_dir if cfg.save_video else None)
        self.train_video_recorder = TrainVideoRecorder(
            self.work_dir if cfg.save_train_video else None)

        self.timer = drq_utils.Timer()
        self._global_step = 0
        self._global_episode = 0

    @property
    def global_step(self):
        return self._global_step

    @property
    def global_frame(self):
        return self._global_step * self.cfg.action_repeat

    def eval(self):
        """``num_eval_episodes`` episodes with the mean action; the first
        one recorded without the reward drawn."""
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
                self.video_recorder.record(self.eval_env)
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

    def train(self):
        """The loop, to ``num_train_frames``: seed steps without updates,
        then ``agent_update_times`` updates a step."""
        cfg = self.cfg
        train_until = drq_utils.Until(cfg.num_train_frames, cfg.action_repeat)
        seed_until = drq_utils.Until(cfg.num_seed_frames, cfg.action_repeat)
        eval_every = drq_utils.Every(cfg.eval_every_frames, cfg.action_repeat)

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
                if cfg.save_snapshot:
                    self.save_snapshot()
                episode_step, episode_reward, episode_success = 0, 0.0, 0.0

            if eval_every(self.global_step):
                self.logger.log("eval/total_time", self.timer.total_time(),
                                self.global_frame)
                self.eval()

            action = self.agent.act(ts.observation, self.global_step,
                                    eval_mode=False)

            if not seed_until(self.global_step):
                for _ in range(cfg.agent_update_times):
                    metrics = self.agent.update(next(self.replay_iter),
                                                self.global_step)
                self.logger.log_metrics(metrics, self.global_frame,
                                        ty="train")

            ts = self.train_env.step(action)
            episode_reward += ts.reward
            episode_success += ts.success
            self.replay_storage.add(ts)
            self.train_video_recorder.record(ts.observation)
            episode_step += 1
            self._global_step += 1

    def save_snapshot(self):
        """The agent and the counters (:func:`save_agent_snapshot`)."""
        save_agent_snapshot(self.work_dir, self.agent, {
            "_global_step": self._global_step,
            "_global_episode": self._global_episode})

    def load_snapshot(self):
        _, counters = load_agent_snapshot(self.work_dir, self.agent)
        self._global_step = counters["_global_step"]
        self._global_episode = counters["_global_episode"]

    def close(self):
        """Stop the replay loader's threads."""
        self.replay_iter.close()

