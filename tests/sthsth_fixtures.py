"""Write the JPEG fixtures of ``tests/data/sthsth/`` from a seed with PIL,
and their digests.

    python tests/sthsth_fixtures.py [--check]

- ``seq/000001.jpg`` ... ``seq/000016.jpg``: 16 frames of Something-
  Something v2's 427 x 240 at 4:2:0 (PIL's default subsampling), smooth
  content moving from frame to frame with a little noise;
- ``s422.jpg``, ``s444.jpg``, ``gray.jpg``, ``restart.jpg`` (restart markers
  every 3 MCUs), ``odd.jpg`` (97 x 61, 4:2:0) and ``progressive.jpg``;
- ``digests.json``: for each file, the shape and the SHA-256 of
  ``np.asarray(Image.open(path).convert("RGB"))``'s bytes (the progressive
  file's too, though the port refuses it).

The machine with the card has no PIL: ``chip_smoke.py`` decodes these files
with the port's decoder and holds them to the digests. ``--check`` writes
nothing and fails if PIL's decode of a committed file has another digest.
"""

import hashlib
import json
import os
import sys

import numpy as np
from PIL import Image

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "sthsth")
SEED = 2024
FRAMES = 16
SSV2_HW = (240, 427)


def smooth(rng, h, w, t=0.0, channels=3, phase=None):
    """uint8 [h, w, channels]: a few waves drifting with ``t`` and a blob
    moving with it, plus noise; ``phase`` [channels, 3] fixes the waves
    (drawn from ``rng`` when None)."""
    if phase is None:
        phase = rng.uniform(0, 2 * np.pi, (channels, 3))
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    cx, cy = w * (0.2 + 0.04 * t), h * (0.5 + 0.2 * np.sin(0.3 * t))
    blob = 70 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * (h / 8) ** 2))
    img = np.stack([110 + 50 * np.sin(x / 23.0 + 0.35 * t + p[0])
                    * np.cos(y / 17.0 - 0.2 * t + p[1])
                    + 40 * np.sin((x + y) / 41.0 + p[2]) + blob
                    for p in phase], -1)
    img += rng.normal(0, 4, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def files():
    """{relative path: (uint8 image, PIL save options)}, from SEED."""
    rng = np.random.default_rng(SEED)
    phase = rng.uniform(0, 2 * np.pi, (3, 3))
    out = {f"seq/{t + 1:06d}.jpg": (smooth(rng, *SSV2_HW, t=float(t),
                                           phase=phase), dict(quality=85))
           for t in range(FRAMES)}
    small = dict(quality=90)
    out["s422.jpg"] = (smooth(rng, 48, 80), dict(small, subsampling=1))
    out["s444.jpg"] = (smooth(rng, 48, 80), dict(small, subsampling=0))
    out["gray.jpg"] = (smooth(rng, 48, 80, channels=1)[..., 0], small)
    out["restart.jpg"] = (smooth(rng, 48, 80),
                          dict(small, restart_marker_blocks=3))
    out["odd.jpg"] = (smooth(rng, 61, 97), small)
    out["progressive.jpg"] = (smooth(rng, 48, 80),
                              dict(small, progressive=True))
    return out


def pil_digest(path):
    rgb = np.ascontiguousarray(np.asarray(Image.open(path).convert("RGB")))
    return {"shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def write():
    digests = {}
    for rel, (img, opts) in files().items():
        path = os.path.join(DIR, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(img).save(path, "JPEG", **opts)
        digests[rel] = pil_digest(path)
    with open(os.path.join(DIR, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


def check():
    with open(os.path.join(DIR, "digests.json")) as f:
        digests = json.load(f)
    bad = [rel for rel, want in digests.items()
           if pil_digest(os.path.join(DIR, rel)) != want]
    if bad:
        raise SystemExit(f"PIL decodes these fixtures otherwise: {bad}")


if __name__ == "__main__":
    check() if sys.argv[1:] == ["--check"] else write()
