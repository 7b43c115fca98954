"""The one generator of every traffic mix: it reads a mix's parameters
(``traffic/<name>.json``) and makes, from the seed, what the cell's driver
feeds the program.

- ``kind: rollout``: ``distinct_batches`` batches of context frames
  (uniform pixels in [0, 1]) and actions (standard normal), made on the
  device and cycled through the window.
- ``kind: gpttrain``: episodes under a fresh directory of ``TMPDIR``, in
  the on-disk layout of the mix the loader reads: ``select`` writes
  ``episodes_per_dataset`` episodes (the first of each is the held-out
  split's) of every dataset of the OXE ``select`` mixture, under its
  camera key, long enough for a segment at its stepsize; ``bair`` writes
  ``episodes`` 30-frame BAIR trajectories (``aux1_image`` and 4-D float
  ``action``) and the registry file that points the loader at them.
  Frames are uniform random uint8 at the mix's ``frame_size``.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch


def seed_words(seed: int, *tags: int) -> List[int]:
    """An entropy list for numpy's SeedSequence: the seed's 32-bit words
    and the tags."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    return words + list(tags)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of its own for each tag."""
    ss = np.random.SeedSequence(seed_words(seed, *tags))
    a, b = ss.generate_state(2)
    return ((int(a) << 32) | int(b)) & (2 ** 63 - 1)


def rollout_inputs(cfg: dict, mix: dict, seed: int, device
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    t = cfg["tokenizer"]
    B, ctx, T = mix["batch"], cfg["context_length"], cfg["segment_length"]
    r = t["resolution"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    out = []
    for _ in range(mix["distinct_batches"]):
        px = torch.rand(B, ctx, r, r, t["in_channels"], device=device,
                        generator=gen)
        act = (torch.randn(B, T, cfg["action_dim"], device=device,
                           generator=gen)
               if cfg["action_conditioned"] else None)
        out.append((px, act))
    return out


def write_episodes(cfg: dict, mix: dict, seed: int, root: str):
    """(parent dir, the loader's mixture, the registry file naming the
    BAIR episodes or None) of the episodes written under ``root``."""
    from ivideogpt_tpu_torch.data import npz_dataset as npz
    from ivideogpt_tpu_torch.data.dataset_mixes import DATASET_NAMED_MIXES
    rng = np.random.default_rng(seed_words(seed, 2))
    size = mix["frame_size"]
    layout = mix["layout"]
    datasets = DATASET_NAMED_MIXES[layout]

    def frames(n):
        return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)

    if layout == "bair":
        d = os.path.join(root, "bair_train")
        os.makedirs(d)
        for e in range(mix["episodes"]):
            n = mix["episode_frames"]
            np.savez(os.path.join(d, f"traj_{e:04d}.npz"),
                     aux1_image=frames(n),
                     action=rng.normal(size=(n, cfg["action_dim"])).astype(
                         np.float32))
        registry = os.path.join(root, "DATASET.yaml")
        with open(registry, "w") as f:
            f.write(f"bair_train_dataset: {d}\n")
        return root, datasets, registry
    if layout != "select":
        raise ValueError(f"episode layout {layout!r}: select or bair")
    for name, _ in datasets:
        step = max(round(mix["video_stepsize"] * npz.get_base_stepsize(name)
                         / npz.MixRoboticDataset.FRAC_STEP_SIZE), 1)
        d = os.path.join(root, name)
        os.makedirs(d)
        n = cfg["segment_length"] * step + mix["extra_frames"]
        for e in range(mix["episodes_per_dataset"]):
            np.savez(os.path.join(d, f"episode_{e:03d}.npz"),
                     **{npz.get_display_key(name): frames(n)})
    return root, datasets, None
