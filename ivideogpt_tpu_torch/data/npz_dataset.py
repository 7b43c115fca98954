"""npz trajectory-episode datasets with segment sampling: the port's own
copy of ``ivideogpt_tpu/data/npz_dataset.py`` (its tables, the
``DATASET.yaml`` registry, ``RoboticDataset``, ``MixRoboticDataset``, the
thread-pool ``_PrefetchLoader``, ``InfiniteDataLoader``, ``EvalDataset``
and ``EvalDataLoader``), without ``cv2`` or ``yaml``: the same files, the
same segment sampling, the same seeding (``SeedSequence(seed)
.generate_state`` per worker, ``seed * 1000 + k`` per dataset of a mix)
and the same draws from each numpy ``Generator``, so a seed gives the same
segments, crops and jitter. Batches are numpy float32 NHWC in [0, 1]
(+ float32 actions), as the JAX package's.

The registry is read by :func:`read_registry`, which takes the flat
``key: value`` form of the repository's ``DATASET.yaml`` and raises on
anything else. A mix's ``sthsth`` entry is the Something-Something v2
reader of ``data/sthsth_dataset.py``, built from ``sthsth_root_path`` as the
JAX mixture builds it; a root of None raises when the mixture is built.
"""

from __future__ import annotations

import glob
import os
import queue as queue_lib
import re
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ivideogpt_tpu_torch.data import augment
from ivideogpt_tpu_torch.data.sthsth_dataset import SomethingV2Dataset
from ivideogpt_tpu_torch.utils import profiling

# Per-dataset native control-frequency stepsize (reference
# simple_dataloader.py:18-70).
BASE_STEPSIZE = {
    "fractal20220817_data": 3,
    "kuka": 10,
    "bridge": 5,
    "taco_play": 15,
    "jaco_play": 10,
    "berkeley_cable_routing": 10,
    "roboturk": 10,
    "viola": 20,
    "toto": 30,
    "language_table": 10,
    "columbia_cairlab_pusht_real": 10,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": 20,
    "stanford_hydra_dataset_converted_externally_to_rlds": 10,
    "austin_buds_dataset_converted_externally_to_rlds": 20,
    "nyu_franka_play_dataset_converted_externally_to_rlds": 3,
    "maniskill_dataset_converted_externally_to_rlds": 20,
    "furniture_bench_dataset_converted_externally_to_rlds": 10,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": 2,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": 3,
    "austin_sailor_dataset_converted_externally_to_rlds": 20,
    "bc_z": 10,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": 10,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": 10,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": 10,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": 10,
    "robo_net": 1,
    "kaist_nonprehensile_converted_externally_to_rlds": 10,
    "stanford_mask_vit_converted_externally_to_rlds": 1,
    "dlr_sara_pour_converted_externally_to_rlds": 10,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": 10,
    "dlr_edan_shared_control_converted_externally_to_rlds": 5,
    "asu_table_top_converted_externally_to_rlds": 12.5,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": 20,
    "uiuc_d3field1": 1,
    "uiuc_d3field2": 1,
    "uiuc_d3field3": 1,
    "uiuc_d3field4": 1,
    "utaustin_mutex": 20,
    "berkeley_fanuc_manipulation": 10,
    "cmu_playing_with_food": 10,
    "cmu_play_fusion": 5,
    "cmu_stretch": 10,
    # downstream tasks
    "bair_robot_pushing": 1,
    "vp2_robodesk": 1,
    "vp2_robosuite": 1,
}

# Per-dataset camera key inside each npz (reference simple_dataloader.py:73-98).
DISPLAY_KEY = {
    "taco_play": "rgb_static",
    "roboturk": "front_rgb",
    "viola": "agentview_rgb",
    "berkeley_autolab_ur5": "hand_image",
    "language_table": "rgb",
    "berkeley_mvp_converted_externally_to_rlds": "hand_image",
    "berkeley_rpt_converted_externally_to_rlds": "hand_image",
    "stanford_robocook_converted_externally_to_rlds1": "image_1",
    "stanford_robocook_converted_externally_to_rlds2": "image_2",
    "stanford_robocook_converted_externally_to_rlds3": "image_3",
    "stanford_robocook_converted_externally_to_rlds4": "image_4",
    "uiuc_d3field1": "image_1",
    "uiuc_d3field2": "image_2",
    "uiuc_d3field3": "image_3",
    "uiuc_d3field4": "image_4",
    "bair_robot_pushing": "aux1_image",
    "vp2_robodesk": "image",
    "vp2_robosuite": "image",
}


def get_base_stepsize(name: str) -> float:
    return BASE_STEPSIZE.get(name, 1)


def get_display_key(name: str) -> str:
    return DISPLAY_KEY.get(name, "image")


# plain scalars YAML would not read as a string
_YAML_NON_STRING = re.compile(
    r"^(?:[-+]?(?:\d[\d_]*)?\.?\d+(?:[eE][-+]?\d+)?|0x[0-9a-fA-F]+|0o[0-7]+"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)|~|null|Null|NULL|true|True"
    r"|TRUE|false|False|FALSE|yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF)$")


def read_registry(path: str = "DATASET.yaml") -> dict:
    """The dataset path registry: a file of ``key: value`` lines (blank
    lines and ``#`` comments allowed, a value plain or quoted), read into
    {key: str} as ``yaml.safe_load`` reads it. Anything else (nesting,
    lists, flow collections, anchors, a value YAML would not read as a
    string, a repeated key) raises ValueError."""
    out = {}
    with open(path) as f:
        for n, line in enumerate(f, 1):
            text = line.rstrip("\n")
            if not text.strip() or text.lstrip().startswith("#"):
                continue
            m = re.match(r"^([A-Za-z_][\w.-]*):(?:\s+(.*))?$", text)
            if m is None:
                raise ValueError(f"{path}:{n}: not a flat 'key: value' line: "
                                 f"{text!r}")
            key, value = m.group(1), (m.group(2) or "").strip()
            quoted = re.match(r"""^(['"])([^'"\\]*)\1\s*(?:#.*)?$""", value)
            if quoted is not None:
                value = quoted.group(2)
            else:
                value = re.sub(r"\s+#.*$", "", value).strip()
                if (not value or value[0] in "[{&*!|>%@`'\"-?:,#"
                        or _YAML_NON_STRING.match(value) or ": " in value):
                    raise ValueError(f"{path}:{n}: {key}'s value {value!r} "
                                     f"is not a plain string")
            if key in out:
                raise ValueError(f"{path}:{n}: {key} repeated")
            out[key] = value
    return out


def _resolve_filenames(parent_dir: str, dataset_name: str, train: bool,
                       registry_path: str = "DATASET.yaml") -> List[str]:
    """Episode file discovery incl. DATASET.yaml-registered downstream sets
    (``ivideogpt_tpu/data/npz_dataset.py:120``)."""
    if dataset_name == "bair_robot_pushing":
        reg = read_registry(registry_path)
        d = reg["bair_train_dataset" if train else "bair_test_dataset"]
        return sorted(glob.glob(os.path.join(d, "*.npz")))
    if dataset_name == "vp2_robodesk":
        d = read_registry(registry_path)["robodesk_dataset"]
        pat = "train*" if train else "validation*"
        return sorted(glob.glob(os.path.join(d, "*", pat, "*.npz")))
    if dataset_name == "vp2_robosuite":
        d = read_registry(registry_path)["robosuite_dataset"]
        sub = "train" if train else "validation"
        return sorted(glob.glob(os.path.join(d, sub, "*.npz")))
    if dataset_name == "tfds_robonet":
        reg = read_registry(registry_path)
        d = reg["robonet_train_dataset" if train else "robonet_test_dataset"]
        return sorted(glob.glob(os.path.join(d, "*.npz")))
    files = sorted(glob.glob(os.path.join(parent_dir, dataset_name, "*.npz")))
    if train:
        return [x for i, x in enumerate(files) if i % 100 != 0]
    return [x for i, x in enumerate(files) if i % 100 == 0]


class RoboticDataset:
    """Single-source episode dataset; every draw is an independent random
    segment (the reference's infinite-random-dataset regime)."""

    def __init__(self, parent_dir: str, dataset_name: str, *,
                 segment_length: int, context_length: int = 1,
                 stepsize: int = 1, segment_horizon: Optional[int] = None,
                 random_selection: bool = False, random_shuffle: bool = False,
                 goal_conditioned: bool = False,
                 random_resized_crop_scale=None, random_resized_crop_ratio=None,
                 brightness=None, contrast=None, saturation=None, hue=None,
                 no_aug: bool = False, train: bool = True,
                 image_size: int = 64, load_action: bool = False,
                 seed: int = 0,
                 registry_path: str = "DATASET.yaml"):
        self.dataset_name = dataset_name
        self.segment_length = segment_length
        self.context_length = context_length
        self.stepsize = stepsize
        self.segment_horizon = segment_horizon or segment_length
        self.random_selection = random_selection
        self.random_shuffle = random_shuffle
        self.goal_conditioned = goal_conditioned
        self.crop_scale = random_resized_crop_scale
        self.crop_ratio = random_resized_crop_ratio
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue
        self.no_aug = no_aug
        self.image_size = image_size
        self.load_action = load_action
        self.rng = np.random.default_rng(seed)

        self.filenames = _resolve_filenames(parent_dir, dataset_name, train,
                                            registry_path)
        self.size = len(self.filenames)
        if self.size == 0:
            raise ValueError(f"no {'train' if train else 'test'} episodes "
                             f"for {dataset_name}")
        self.display_key = get_display_key(dataset_name)

    def _shrunk_stepsize(self, n: int, span: int) -> int:
        if self.stepsize * span > n:
            return max(1, n // span)
        return self.stepsize

    def get_segment(self, episode: np.ndarray,
                    action: Optional[np.ndarray] = None):
        rng = self.rng
        n = len(episode)
        if self.goal_conditioned:
            span = self.segment_length - 1
            st = self._shrunk_stepsize(n, span)
            start = rng.integers(max(n - st * span + 1, 1))
            idx = [min(start + st * i, n - 1) for i in range(span)]
            idx = idx[-1:] + idx  # goal frame first
            images = [episode[i] for i in idx]
            actions = None
        elif self.random_shuffle:
            st = self._shrunk_stepsize(n, self.segment_horizon)
            start = rng.integers(max(n - st * self.segment_horizon + 1, 1))
            sel = rng.choice(self.segment_horizon, self.segment_length,
                             replace=False)
            images = [episode[min(start + st * i, n - 1)] for i in sel]
            actions = None
        elif self.random_selection:
            st = self._shrunk_stepsize(n, self.segment_horizon)
            start = rng.integers(max(n - st * self.segment_horizon + 1, 1))
            window = episode[start: start + st * self.segment_horizon]
            ctx = list(window[: st * self.context_length: st])
            after = list(window[st * self.context_length:])
            k = min(len(after), self.segment_length - self.context_length)
            sel = np.sort(rng.choice(len(after), k, replace=False))
            images = ctx + [after[i] for i in sel]
            if action is not None:
                aw = action[start: start + st * self.segment_horizon]
                actions = (list(aw[: st * self.context_length: st])
                           + [aw[st * self.context_length:][i] for i in sel])
            else:
                actions = None
        else:
            st = self._shrunk_stepsize(n, self.segment_length)
            start = rng.integers(max(n - st * self.segment_length + 1, 1))
            images = list(episode[start: start + st * self.segment_length: st])
            actions = (list(action[start: start + st * self.segment_length: st])
                       if action is not None else None)

        while len(images) < self.segment_length:
            images.append(images[-1])
            if actions is not None:
                actions.append(actions[-1])
        return images, actions

    def sample(self):
        """One random segment: [T, size, size, C] float32 in [0, 1]
        (+ [T, A] actions if load_action)."""
        i = int(self.rng.integers(self.size))
        with np.load(self.filenames[i]) as ep:
            episode = ep[self.display_key]
            action = ep["action"] if self.load_action else None
        if self.dataset_name == "tfds_robonet" and action is not None:
            action = np.append(action, np.zeros((1, 5), action.dtype), axis=0)
        images, actions = self.get_segment(episode, action)
        images = np.asarray(images)

        if self.no_aug:
            out = np.empty((len(images), self.image_size, self.image_size,
                            images.shape[-1]), np.float32)
            for t, img in enumerate(images):
                img = img.astype(np.float32) / 255.0
                if self.dataset_name == "tfds_robonet":
                    img = augment.center_crop_square(img)
                out[t] = augment.resize(img, self.image_size)
        else:
            out = augment.augment_segment(
                images, self.image_size, self.crop_scale, self.crop_ratio,
                self.brightness, self.contrast, self.saturation, self.hue,
                self.rng)
        if self.load_action:
            return out, np.asarray(actions, np.float32)
        return out


class MixRoboticDataset:
    """Probability-weighted mixture over datasets with per-dataset native
    stepsize scaling."""

    FRAC_STEP_SIZE = 3

    def __init__(self, parent_dir: str, datasets: Sequence[Tuple[str, float]],
                 stepsize: int = 1, seed: int = 0,
                 sthsth_root_path: Optional[str] = None, **dataset_args):
        self.rng = np.random.default_rng(seed)
        self.datasets = []
        weights = []
        for k, (name, mix) in enumerate(datasets):
            if name == "sthsth":
                ss_args = {k2: v for k2, v in dataset_args.items()
                           if k2 in ("segment_length", "context_length",
                                     "segment_horizon", "random_selection",
                                     "train", "maxsize", "image_size")}
                self.datasets.append(SomethingV2Dataset(
                    sthsth_root_path, stepsize=1, seed=seed * 1000 + k,
                    **ss_args))
            else:
                ds_step = max(round(stepsize * get_base_stepsize(name)
                                    / self.FRAC_STEP_SIZE), 1)
                self.datasets.append(RoboticDataset(
                    parent_dir, name, stepsize=ds_step, seed=seed * 1000 + k,
                    **dataset_args))
            weights.append(mix)
        self.weights = np.asarray(weights, np.float64)
        self.weights /= self.weights.sum()

    def sample(self):
        k = int(self.rng.choice(len(self.datasets), p=self.weights))
        return self.datasets[k].sample()


class _PrefetchLoader:
    """Thread-pool prefetch: one worker thread a sample function (a numpy
    Generator is not thread-safe, so each worker draws from its own), a
    queue of ``prefetch`` batches. ``wait_s`` adds up the seconds
    ``__next__`` waited for a batch, each wait the span
    (``utils.profiling``) ``data.wait``."""

    def __init__(self, sample_fns: Sequence[Callable], batch_size: int,
                 prefetch: int = 4):
        self.batch_size = batch_size
        self.queue = queue_lib.Queue(maxsize=prefetch)
        self.wait_s = 0.0
        self._stop = threading.Event()
        self.threads = [threading.Thread(target=self._worker, args=(fn,),
                                         daemon=True)
                        for fn in sample_fns]
        for t in self.threads:
            t.start()

    def _worker(self, sample_fn):
        while not self._stop.is_set():
            samples = [sample_fn() for _ in range(self.batch_size)]
            if isinstance(samples[0], tuple):
                batch = tuple(np.stack(x) for x in zip(*samples))
            else:
                batch = np.stack(samples)
            # keep offering the same batch until it fits
            while not self._stop.is_set():
                try:
                    self.queue.put(batch, timeout=0.5)
                    break
                except queue_lib.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        with profiling.span("data.wait"):
            t0 = time.perf_counter()
            batch = self.queue.get()
            self.wait_s += time.perf_counter() - t0
        return batch

    def close(self):
        self._stop.set()
        # unblock any worker sitting in put(), then reap the threads
        try:
            while True:
                self.queue.get_nowait()
        except queue_lib.Empty:
            pass
        for t in self.threads:
            t.join(timeout=5.0)


class InfiniteDataLoader(_PrefetchLoader):
    """Infinite random batches from a mixture. Each worker thread owns an
    independent MixRoboticDataset (seeded from a spawned SeedSequence), so
    no numpy Generator is shared across threads."""

    def __init__(self, parent_dir: str, datasets, batch_size: int = 2,
                 num_workers: int = 4, stepsize: int = 1, seed: int = 0,
                 **dataset_args):
        worker_seeds = np.random.SeedSequence(seed).generate_state(
            max(num_workers, 1))
        self.mixtures = [
            MixRoboticDataset(parent_dir, datasets, stepsize=stepsize,
                              seed=int(s), **dataset_args)
            for s in worker_seeds]
        self.mixture = self.mixtures[0]
        super().__init__([m.sample for m in self.mixtures], batch_size)


class EvalDataset:
    """Fixed eval split: a deterministic pass over test episodes."""

    def __init__(self, dataset_name: str, segment_length: int,
                 image_size: int = 64, load_action: bool = False,
                 registry_path: str = "DATASET.yaml", seed: int = 0):
        self.dataset_name = dataset_name
        self.segment_length = segment_length
        self.image_size = image_size
        self.load_action = load_action
        self.rng = np.random.default_rng(seed)
        if dataset_name not in ("bair_robot_pushing", "tfds_robonet",
                                "vp2_robodesk", "vp2_robosuite"):
            raise NotImplementedError(dataset_name)
        self.filenames = _resolve_filenames(None, dataset_name, False,
                                            registry_path)
        self.size = len(self.filenames)
        if self.size == 0:
            raise ValueError(f"no test episodes for {dataset_name}")
        self.display_key = get_display_key(dataset_name)

    def __len__(self):
        return self.size

    def __getitem__(self, item: int):
        with np.load(self.filenames[item]) as ep:
            episode = ep[self.display_key]
            action = ep["action"] if self.load_action else None
        if self.dataset_name == "tfds_robonet" and action is not None:
            action = np.append(action, np.zeros((1, 5), action.dtype), axis=0)
        n = len(episode)
        if "vp2" in self.dataset_name:
            start = int(self.rng.integers(max(n - self.segment_length + 1, 1)))
        else:
            start = 0
        images = list(episode[start: start + self.segment_length])
        actions = (list(action[start: start + self.segment_length])
                   if action is not None else None)
        while len(images) < self.segment_length:
            images.append(images[-1])
            if actions is not None:
                actions.append(actions[-1])

        out = np.empty((len(images), self.image_size, self.image_size,
                        images[0].shape[-1]), np.float32)
        for t, img in enumerate(images):
            img = img.astype(np.float32) / 255.0
            if self.dataset_name == "tfds_robonet":
                img = augment.center_crop_square(img)
            out[t] = augment.resize(img, self.image_size)
        if self.load_action:
            return out, np.asarray(actions, np.float32)
        return out


class EvalDataLoader:
    """Sequential batches over the whole eval split; ``drop_last=True``
    yields only full ``batch_size`` batches."""

    def __init__(self, dataset_name: str, segment_length: int,
                 image_size: int = 64, batch_size: int = 2,
                 load_action: bool = False, drop_last: bool = False, **kw):
        self.dataset = EvalDataset(dataset_name, segment_length, image_size,
                                   load_action, **kw)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        for _, batch in self.shard(0, 1):
            yield batch

    def shard(self, index: int, count: int):
        """(n, batch) of the batches n with n mod ``count`` = ``index``, the
        others not loaded: a data-parallel rank's share of the split."""
        n = len(self.dataset)
        end = n - n % self.batch_size if self.drop_last else n
        for k, s in enumerate(range(0, end, self.batch_size)):
            if k % count != index:
                continue
            items = [self.dataset[i]
                     for i in range(s, min(s + self.batch_size, n))]
            if isinstance(items[0], tuple):
                yield k, tuple(np.stack(x) for x in zip(*items))
            else:
                yield k, np.stack(items)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size
