"""GIF recorders of the MBRL loop, the port of ``ivideogpt_tpu/mbrl/video.py``:
the imagination and validation GIFs and the eval and train episode
recorders. NHWC observations; a frame stack shows its newest frame (the
last 3 channels).

The GIFs are written by ``utils/image_io.write_gif`` (a fixed palette),
and the reward is drawn with a 3 x 5 bitmap font in numpy, where the JAX
package draws it with ``cv2.putText`` and writes with ``imageio``: the
pixels inside ``REWARD_BOX`` (rows 3-10 from column 10 on, where both
texts lie) differ from the JAX frames, every other pixel is the same. The
train recorder resizes with bicubic interpolation in torch (cv2's
``INTER_CUBIC`` kernel, a = -0.75), which may round a level apart from
cv2's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ivideogpt_tpu_torch.utils.image_io import write_gif

# rows [3, 11) and columns [10, width) of a frame: the reward text's box
REWARD_BOX = (slice(3, 11), slice(10, None))
_GLYPHS = {
    "0": "111101101101111", "1": "010110010010111", "2": "111001111100111",
    "3": "111001111001111", "4": "101101111001001", "5": "111100111001111",
    "6": "111100111101111", "7": "111001001001001", "8": "111101111101111",
    "9": "111101111001111", "-": "000000111000000", ".": "000000000000010",
    "n": "000110101101101", "a": "000011101101011", "i": "010000010010010",
    "f": "011010111010010"}
_FONT = {c: np.array([int(b) for b in bits], bool).reshape(5, 3)
         for c, bits in _GLYPHS.items()}


def overlay_reward(frame: np.ndarray, reward: float) -> np.ndarray:
    """A copy of the uint8 frame with ``f"{reward:.2f}"`` in white at the
    top left: 3 x 5 glyphs, rows 5-9, 4 columns a character from column
    10, cut at the frame's edge."""
    frame = np.array(frame)
    x = REWARD_BOX[1].start
    for ch in f"{reward:.2f}":
        glyph = _FONT[ch]
        w = min(3, frame.shape[1] - x)
        if w <= 0:
            break
        frame[5:10, x:x + w][glyph[:, :w]] = 255
        x += 4
    return frame


def imagination_frames(obs_stack: np.ndarray, rewards: np.ndarray):
    """The frames of one imagined episode: the newest frame of each stack
    with its reward. obs_stack [T, H, W, 3k] uint8, rewards [T]."""
    return [overlay_reward(obs_stack[t, ..., -3:], float(rewards[t]))
            for t in range(obs_stack.shape[0])]


def save_imagination_gif(path, obs_stack: np.ndarray, rewards: np.ndarray):
    """One imagined episode as a GIF at 4 frames/s."""
    write_gif(str(path), imagination_frames(obs_stack, rewards),
              duration_ms=250, loop=0)


def validate_frames(obs_gt: np.ndarray, obs_pred: np.ndarray,
                    reward_gt: np.ndarray, reward_pred: np.ndarray):
    """[ground truth | prediction | abs error] a step, the rewards drawn
    from step 1 on. obs [T, H, W, 3k] uint8-valued, rewards [T]."""
    frames = []
    for t in range(obs_gt.shape[0]):
        gt = obs_gt[t, ..., -3:].astype(np.uint8)
        pred = obs_pred[t, ..., -3:].astype(np.uint8)
        err = np.abs(gt.astype(float) - pred.astype(float)).astype(np.uint8)
        if t > 0:
            gt = overlay_reward(gt, float(reward_gt[t]))
            pred = overlay_reward(pred, float(reward_pred[t]))
        frames.append(np.concatenate([gt, pred, err], axis=1))
    return frames


def save_validate_gif(path, obs_gt: np.ndarray, obs_pred: np.ndarray,
                      reward_gt: np.ndarray, reward_pred: np.ndarray):
    """The validation triptychs of one segment as a GIF at 4 frames/s."""
    write_gif(str(path), validate_frames(obs_gt, obs_pred, reward_gt,
                                         reward_pred), duration_ms=250,
              loop=0)


class VideoRecorder:
    """The eval episodes' rendered frames, rewards drawn where given, as
    ``{root}/eval_video/{name}`` at ``fps``."""

    def __init__(self, root_dir, render_size: int = 256, fps: int = 20):
        self.save_dir = None
        if root_dir is not None:
            self.save_dir = Path(root_dir) / "eval_video"
            self.save_dir.mkdir(exist_ok=True, parents=True)
        self.render_size = render_size
        self.fps = fps
        self.frames = []
        self.enabled = False

    def init(self, env, enabled: bool = True):
        self.frames = []
        self.enabled = self.save_dir is not None and enabled
        self.record(env)

    def record(self, env, reward=None):
        if not self.enabled:
            return
        frame = env.render()
        if reward is not None:
            frame = overlay_reward(frame, float(reward))
        self.frames.append(frame)

    def save(self, file_name: str):
        if self.enabled:
            write_gif(str(self.save_dir / file_name), self.frames,
                      duration_ms=1000 / self.fps)


def resize_cubic(frame: np.ndarray, size: int) -> np.ndarray:
    """A uint8 [H, W, 3] frame resized to size x size, bicubic (a = -0.75,
    half-pixel centres), rounded and clipped to uint8."""
    x = torch.from_numpy(np.ascontiguousarray(frame)).permute(2, 0, 1)
    y = torch.nn.functional.interpolate(x[None].double(), size=(size, size),
                                        mode="bicubic", align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(
        torch.uint8).numpy()


class TrainVideoRecorder:
    """The train episodes' newest frames, resized to ``render_size``, as
    ``{root}/train_video/{name}`` at ``fps``."""

    def __init__(self, root_dir, render_size: int = 256, fps: int = 20):
        self.save_dir = None
        if root_dir is not None:
            self.save_dir = Path(root_dir) / "train_video"
            self.save_dir.mkdir(exist_ok=True, parents=True)
        self.render_size = render_size
        self.fps = fps
        self.frames = []
        self.enabled = False

    def init(self, obs, enabled: bool = True):
        self.frames = []
        self.enabled = self.save_dir is not None and enabled
        self.record(obs)

    def record(self, obs):
        if not self.enabled:
            return
        self.frames.append(resize_cubic(obs[..., -3:], self.render_size))

    def save(self, file_name: str):
        if self.enabled:
            write_gif(str(self.save_dir / file_name), self.frames,
                      duration_ms=1000 / self.fps)
