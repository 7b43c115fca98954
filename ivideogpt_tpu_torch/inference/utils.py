"""npz sample parsing for the inference CLI: the port of ``NPZParser``
(``inference/utils.py:24-57``). It reads an episode npz, picks the display
key, applies the dataset's native stepsize (shrunk for short episodes),
pads a short episode with its last frame, center-crops robonet, resizes,
and returns [T, H, W, C] float32 in [0, 1] plus, where asked and present,
the [T, A] actions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ivideogpt_tpu_torch.data import augment
from ivideogpt_tpu_torch.data.npz_dataset import (get_base_stepsize,
                                                  get_display_key)


class NPZParser:
    def __init__(self, segment_length: int, image_size: int = 64):
        self.segment_length = segment_length
        self.image_size = image_size

    def parse(self, path: str, dataset_name: str, load_action: bool = False
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        with np.load(path) as ep:
            episode = ep[get_display_key(dataset_name)]
            action = ep["action"] if load_action and "action" in ep else None

        stepsize = max(round(get_base_stepsize(dataset_name) / 3), 1)
        if stepsize * self.segment_length > len(episode):
            stepsize = max(1, len(episode) // self.segment_length)

        frames = list(episode[::stepsize][: self.segment_length])
        actions = (list(action[::stepsize][: self.segment_length])
                   if action is not None else None)
        while len(frames) < self.segment_length:
            frames.append(frames[-1])
            if actions is not None:
                actions.append(actions[-1])

        out = np.empty((len(frames), self.image_size, self.image_size,
                        frames[0].shape[-1]), np.float32)
        for t, img in enumerate(frames):
            img = img.astype(np.float32) / 255.0
            if dataset_name == "tfds_robonet":
                img = augment.center_crop_square(img)
            out[t] = augment.resize(img, self.image_size)
        return out, (np.asarray(actions, np.float32)
                     if actions is not None else None)
