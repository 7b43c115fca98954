"""A random-pixel stand-in for a Metaworld task, the port of
``ivideogpt_tpu/mbrl/fake_env.py``: the whole MBPO loop (env stepping,
replay, world-model training, imagination, validation) runs without MuJoCo
or Metaworld. From the same seed it draws the same numpy stream as the JAX
package's."""

from __future__ import annotations

import numpy as np

from ivideogpt_tpu_torch.mbrl.metaworld_env import (BoundedArray,
                                                    Environment,
                                                    MetaWorldTimeStep,
                                                    StepType, wrap)


class FakeTask(Environment):
    """size x size random pixels, ``action_dim`` actions in [-2, 2], reward
    tanh(sum(action)) / 10, episodes of ``duration`` steps."""

    def __init__(self, seed=0, duration=100, size=64, action_dim=4):
        self._rng = np.random.default_rng(seed)
        self._duration = duration
        self._size = size
        self._action_dim = action_dim
        self._steps = None

    def observation_spec(self):
        return BoundedArray((self._size, self._size, 3), np.uint8, 0, 255,
                            "observation")

    def action_spec(self):
        return BoundedArray((self._action_dim,), np.float32, -2.0, 2.0,
                            "action")

    def _obs(self):
        return self._rng.integers(0, 255, (self._size, self._size, 3)
                                  ).astype(np.uint8)

    def reset(self):
        self._steps = 0
        return MetaWorldTimeStep(StepType.FIRST, 0.0, 1.0, self._obs(), 0.0)

    def step(self, action):
        self._steps += 1
        done = self._steps >= self._duration
        reward = float(np.tanh(np.sum(action)) * 0.1)
        return MetaWorldTimeStep(
            StepType.LAST if done else StepType.MID, reward, 1.0,
            self._obs(), 0.0)

    def render(self):
        return self._obs()


def make_fake(name, frame_stack, action_repeat, seed, camera=None,
              duration=100, succ_bonus=0.0, size=64, action_dim=4):
    """``metaworld_env.make``'s wrapper stack over the fake task."""
    return wrap(FakeTask(seed=seed, duration=duration, size=size,
                         action_dim=action_dim), frame_stack)
