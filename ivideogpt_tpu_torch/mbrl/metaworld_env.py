"""The Metaworld environment and its wrappers, the port of
``ivideogpt_tpu/mbrl/metaworld_env.py``: the timestep tuples, action dtype
and scale, frame stack (NHWC: (H, W, 3k)) and the extended timestep that
carries the action taken.

The JAX module builds on ``dm_env``; the port carries the few pieces of it
that it uses instead (``StepType``, the ``Array`` / ``BoundedArray`` specs
and the ``Environment`` base), so it needs nothing beyond numpy.
``metaworld`` and ``mujoco`` are imported inside ``make`` alone, when a
real task is made.
"""

from __future__ import annotations

import enum
import os
from collections import deque
from typing import Any, NamedTuple

import numpy as np


class StepType(enum.IntEnum):
    """dm_env's step types, with its values."""
    FIRST = 0
    MID = 1
    LAST = 2


class Array:
    """An array's shape, dtype and name (dm_env's ``specs.Array``)."""

    def __init__(self, shape, dtype, name=None):
        self._shape = tuple(int(d) for d in shape)
        self._dtype = np.dtype(dtype)
        self._name = name

    shape = property(lambda self: self._shape)
    dtype = property(lambda self: self._dtype)
    name = property(lambda self: self._name)

    def _kwargs(self):
        return {"shape": self.shape, "dtype": self.dtype, "name": self.name}

    def replace(self, **kw):
        return type(self)(**{**self._kwargs(), **kw})

    def generate_value(self):
        return np.zeros(self.shape, self.dtype)

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs()})"


class BoundedArray(Array):
    """An ``Array`` with inclusive bounds, broadcastable to its shape and
    kept in its dtype (dm_env's ``specs.BoundedArray``)."""

    def __init__(self, shape, dtype, minimum, maximum, name=None):
        super().__init__(shape, dtype, name)
        lo = np.broadcast_to(minimum, self.shape)
        hi = np.broadcast_to(maximum, self.shape)
        if np.any(lo > hi):
            raise ValueError(f"minimum {minimum} > maximum {maximum}")
        self._minimum = np.array(minimum, dtype=self.dtype)
        self._maximum = np.array(maximum, dtype=self.dtype)
        self._minimum.setflags(write=False)
        self._maximum.setflags(write=False)

    minimum = property(lambda self: self._minimum)
    maximum = property(lambda self: self._maximum)

    def _kwargs(self):
        return {**super()._kwargs(), "minimum": self.minimum,
                "maximum": self.maximum}

    def generate_value(self):
        return (np.ones(self.shape, self.dtype)
                * self.dtype.type(self.minimum))


class Environment:
    """The interface the wrappers keep: ``reset``, ``step``,
    ``observation_spec``, ``action_spec``."""

    def reset(self):
        raise NotImplementedError

    def step(self, action):
        raise NotImplementedError

    def observation_spec(self):
        raise NotImplementedError

    def action_spec(self):
        raise NotImplementedError


class _Steps:
    __slots__ = ()

    def first(self):
        return self.step_type == StepType.FIRST

    def mid(self):
        return self.step_type == StepType.MID

    def last(self):
        return self.step_type == StepType.LAST

    def __getitem__(self, attr):
        if isinstance(attr, str):
            return getattr(self, attr)
        return tuple.__getitem__(self, attr)


class _ExtendedFields(NamedTuple):
    step_type: Any
    reward: Any
    discount: Any
    observation: Any
    action: Any
    success: Any
    state: Any = None


class _MetaWorldFields(NamedTuple):
    step_type: Any
    reward: Any
    discount: Any
    observation: Any
    success: Any
    state: Any = None


class ExtendedTimeStep(_Steps, _ExtendedFields):
    """A timestep with the action that led to it and the success flag."""
    __slots__ = ()


class MetaWorldTimeStep(_Steps, _MetaWorldFields):
    __slots__ = ()


class _Wrapper(Environment):
    def reset(self):
        return self._env.reset()

    def observation_spec(self):
        return self._env.observation_spec()

    def action_spec(self):
        return self._env.action_spec()

    def __getattr__(self, name):
        if name == "_env":
            raise AttributeError(name)
        return getattr(self._env, name)


class ActionDTypeWrapper(_Wrapper):
    """Cast incoming actions to the wrapped env's action dtype."""

    def __init__(self, env, dtype):
        self._env = env
        spec = env.action_spec()
        self._action_spec = BoundedArray(spec.shape, dtype, spec.minimum,
                                         spec.maximum, "action")

    def step(self, action):
        return self._env.step(np.asarray(action).astype(
            self._env.action_spec().dtype))

    def action_spec(self):
        return self._action_spec


class ActionScaleWrapper(_Wrapper):
    """Rescale actions in [minimum, maximum] to the env's own bounds, in
    the env's dtype."""

    def __init__(self, env, minimum, maximum):
        spec = env.action_spec()
        assert isinstance(spec, BoundedArray), spec
        minimum = np.asarray(minimum, spec.dtype)
        maximum = np.asarray(maximum, spec.dtype)
        lo, hi, dt = spec.minimum, spec.maximum, spec.dtype
        assert np.isfinite(lo).all() and np.isfinite(hi).all()
        scale = (hi - lo) / (maximum - minimum)

        def transform(action):
            return (lo + scale * (action - minimum)).astype(dt, copy=False)

        self._transform = transform
        self._action_spec = spec.replace(minimum=minimum, maximum=maximum)
        self._env = env

    def step(self, action):
        return self._env.step(self._transform(action))

    def action_spec(self):
        return self._action_spec


class FrameStackWrapper(_Wrapper):
    """Stack the last k frames on the channel axis: (H, W, 3k)."""

    def __init__(self, env, num_frames):
        self._env = env
        self._num_frames = num_frames
        self._frames = deque([], maxlen=num_frames)
        shape = env.observation_spec().shape
        self._obs_spec = BoundedArray(
            shape=(shape[0], shape[1], shape[2] * num_frames),
            dtype=np.uint8, minimum=0, maximum=255, name="observation")

    def _obs(self, ts):
        assert len(self._frames) == self._num_frames
        return ts._replace(observation=np.concatenate(list(self._frames),
                                                      axis=-1))

    def reset(self):
        ts = self._env.reset()
        for _ in range(self._num_frames):
            self._frames.append(ts.observation)
        return self._obs(ts)

    def step(self, action):
        ts = self._env.step(action)
        self._frames.append(ts.observation)
        return self._obs(ts)

    def observation_spec(self):
        return self._obs_spec


class ExtendedTimeStepWrapper(_Wrapper):
    """Timesteps as ``ExtendedTimeStep``, with the action taken (zeros at
    a reset)."""

    def __init__(self, env):
        self._env = env

    def reset(self):
        return self._augment(self._env.reset())

    def step(self, action):
        return self._augment(self._env.step(action), action)

    def _augment(self, ts, action=None):
        if action is None:
            spec = self.action_spec()
            action = np.zeros(spec.shape, dtype=spec.dtype)
        return ExtendedTimeStep(
            observation=ts.observation, step_type=ts.step_type, action=action,
            reward=ts.reward or 0.0, discount=ts.discount or 1.0,
            success=getattr(ts, "success", 0.0) or 0.0,
            state=getattr(ts, "state", None))


class MetaWorld(Environment):
    """A goal-observable Metaworld v2 task (``env``, made by :func:`make`)
    rendered offscreen at 64x64 from the camera ``camera_id``: action
    repeat summing rewards and successes, a success bonus, the image
    flipped upright, a fixed duration."""

    def __init__(self, env, camera_id, action_repeat=1, size=(64, 64),
                 camera=None, duration=500, succ_bonus=0.0):
        self._env = env
        self._env._freeze_rand_vec = False
        self._env.render_mode = "rgb_array"
        self._env.mujoco_renderer.camera_id = camera_id
        self._env.mujoco_renderer.height = size[0]
        self._env.mujoco_renderer.width = size[1]

        self._size = size
        self._action_repeat = action_repeat
        self._duration = duration
        self._succ_bonus = succ_bonus
        self._camera = camera
        self._steps = None

    def observation_spec(self):
        return BoundedArray(shape=self._size + (3,), dtype=np.uint8,
                            minimum=0, maximum=255, name="observation")

    def action_spec(self):
        return BoundedArray(
            shape=self._env.action_space.shape, dtype=np.float32,
            minimum=self._env.action_space.low.min(),
            maximum=self._env.action_space.high.max(), name="action")

    def step(self, action):
        assert self._steps is not None, "Must reset environment."
        assert np.isfinite(action).all(), action
        reward, success = 0.0, 0.0
        done = False
        for _ in range(self._action_repeat):
            state, rew, done, truncate, info = self._env.step(action)
            success += float(info["success"])
            reward += rew or 0.0
        success = float(success >= 1.0)
        if success == 1.0:
            reward += self._succ_bonus
        image = self._env.render()[::-1]
        self._steps += 1
        if self._steps >= self._duration:
            done = True
            self._steps = None
        return MetaWorldTimeStep(
            step_type=StepType.LAST if done else StepType.MID, reward=reward,
            discount=1, observation=image, success=success, state=state)

    def reset(self):
        self._steps = 0
        if self._camera == "corner2":
            self._env.model.cam_pos[2][:] = [0.75, 0.075, 0.7]
        self._env.reset()
        state, *_ = self._env.step(np.zeros(self._env.action_space.shape))
        image = self._env.render()[::-1]
        return MetaWorldTimeStep(step_type=StepType.FIRST, reward=0,
                                 discount=1, observation=image, success=0.0,
                                 state=state)

    def render(self, mode="offscreen"):
        return self._env.render()[::-1]

    def __getattr__(self, name):
        if name == "_env":
            raise AttributeError(name)
        return getattr(self._env, name)


def wrap(env, frame_stack):
    """The wrapper stack over a raw task: float32 actions in [-1, 1],
    ``frame_stack`` frames, extended timesteps."""
    env = ActionDTypeWrapper(env, np.float32)
    env = ActionScaleWrapper(env, minimum=-1.0, maximum=+1.0)
    env = FrameStackWrapper(env, frame_stack)
    return ExtendedTimeStepWrapper(env)


def make(name, frame_stack, action_repeat, seed, camera=None, duration=500,
         succ_bonus=0.0):
    """A Metaworld task in the standard wrapper stack. The only place that
    imports ``metaworld`` and ``mujoco``."""
    import metaworld  # noqa: F401
    from metaworld.envs import ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE
    import mujoco

    os.environ["MUJOCO_GL"] = os.environ.get("MUJOCO_GL", "egl")
    env = ALL_V2_ENVIRONMENTS_GOAL_OBSERVABLE[
        f"{name}-v2-goal-observable"](seed=seed)
    camera_id = mujoco.mj_name2id(env.model, mujoco.mjtObj.mjOBJ_CAMERA,
                                  "corner")
    return wrap(MetaWorld(env, camera_id, action_repeat=action_repeat,
                          camera=camera, duration=duration,
                          succ_bonus=succ_bonus), frame_stack)
