"""Something-Something v2 frame-folder dataset: the port's own copy of
``ivideogpt_tpu/data/sthsth_dataset.py`` (the reference's
``ivideogpt/data/sthsth_dataloader.py:209-306``): a reader of jpg frame
folders over a ``[video_id num_frames class]`` list file, with the manually
selected hand-manipulation labels (reference :31-207), the same
list-file filter, the same segment samplers and the same draws from its
numpy ``Generator``, so a seed gives the same videos, segments and pixels.

Frames are decoded by ``data/jpeg.py`` (no PIL), whose pixels equal PIL's.
Unlike the JAX reader, a root of None is refused when the dataset is built
(the JAX one fails later, inside a loader thread).

Returns [T, size, size, 3] float32 in [0, 1], NHWC.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ivideogpt_tpu_torch.data import augment
from ivideogpt_tpu_torch.data.jpeg import read_jpeg

# Label ids of the manually selected hand-manipulation classes (reference
# sthsth_dataloader.py:31-207; the active, uncommented entries).
MANUALLY_SELECTED_LABELS = {
    "1", "5", "6", "13", "14", "15", "16", "17", "18", "19", "20", "21",
    "27", "28", "29", "30", "31", "33", "34", "35", "36", "37", "38", "39",
    "40", "42", "43", "45", "46", "47", "48", "49", "50", "51", "52", "53",
    "54", "55", "56", "57", "58", "85", "86", "87", "88", "89", "90", "91",
    "92", "93", "94", "95", "96", "97", "98", "99", "100", "101", "102",
    "103", "104", "105", "106", "107", "108", "109", "110", "111", "112",
    "113", "114", "115", "116", "117", "118", "119", "120", "122", "123",
    "139", "140", "141", "143", "144", "145", "146", "147", "148", "156",
    "157", "158", "159", "160", "164", "173",
}


class VideoRecord:
    def __init__(self, row: List[str]):
        self.path = row[0]
        self.num_frames = int(row[1])
        self.label = int(row[2])


class SomethingV2Dataset:
    def __init__(self, root_path: str, *, segment_length: int,
                 context_length: int = 1, stepsize: int = 1,
                 segment_horizon: Optional[int] = None,
                 random_selection: bool = False, train: bool = True,
                 maxsize: Optional[int] = None, manual_labels: bool = True,
                 image_size: int = 64, list_dir: str = "datasets/somethingv2",
                 seed: int = 0, **_):
        if root_path is None:
            raise ValueError("the Something-Something dataset (sthsth) needs "
                             "its frame root: pass --sthsth_root_path")
        self.root_path = root_path
        self.segment_length = segment_length
        self.context_length = context_length
        self.random_selection = random_selection
        self.segment_horizon = segment_horizon or segment_length
        self.stepsize = stepsize
        self.image_size = image_size
        self.image_tmpl = "{:06d}.jpg"
        self.rng = np.random.default_rng(seed)

        list_file = os.path.join(
            list_dir, "train_video_folder.txt" if train
            else "val_video_folder.txt")
        minlen = (self.segment_horizon if random_selection
                  else segment_length) * stepsize
        labels = MANUALLY_SELECTED_LABELS if manual_labels else None
        with open(list_file) as f:
            rows = [line.strip().split(" ") for line in f]
        rows = [r for r in rows if int(r[1]) >= minlen
                and (labels is None or r[2] in labels)]
        self.video_list = [VideoRecord(r) for r in rows]
        if maxsize is not None:
            idx = self.rng.choice(len(self.video_list), maxsize)
            self.video_list = [self.video_list[i] for i in idx]
        self.size = len(self.video_list)
        if self.size == 0:
            raise ValueError("no SSv2 videos found")

    def _load_image(self, directory: str, idx: int) -> np.ndarray:
        return read_jpeg(os.path.join(self.root_path, directory,
                                      self.image_tmpl.format(idx + 1)))

    def _shrunk(self, n: int, span: int) -> int:
        if self.stepsize * span > n:
            return max(1, n // span)
        return self.stepsize

    def get_segment(self, video: VideoRecord) -> List[np.ndarray]:
        n = video.num_frames
        rng = self.rng
        if self.random_selection:
            st = self._shrunk(n, self.segment_horizon)
            start = int(rng.integers(max(n - st * self.segment_horizon + 1, 1)))
            window = [self._load_image(video.path, s)
                      for s in range(start, start + st * self.segment_horizon)]
            ctx = window[: st * self.context_length: st]
            after = window[st * self.context_length:]
            k = min(len(after), self.segment_length - self.context_length)
            sel = np.sort(rng.choice(len(after), k, replace=False))
            images = ctx + [after[i] for i in sel]
        else:
            st = self._shrunk(n, self.segment_length)
            start = int(rng.integers(max(n - st * self.segment_length + 1, 1)))
            images = [self._load_image(video.path, s)
                      for s in range(start, start + st * self.segment_length, st)]
        while len(images) < self.segment_length:
            images.append(images[-1])
        return images

    def sample(self) -> np.ndarray:
        video = self.video_list[int(self.rng.integers(self.size))]
        images = self.get_segment(video)
        out = np.empty((len(images), self.image_size, self.image_size, 3),
                       np.float32)
        for t, img in enumerate(images):
            out[t] = augment.resize(img.astype(np.float32) / 255.0,
                                    self.image_size)
        return out
