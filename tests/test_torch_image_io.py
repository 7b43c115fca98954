"""``ivideogpt_tpu_torch/utils/image_io.py`` read back by PIL and imageio:

- ``write_png``: the exact pixels, at odd sizes and one pixel;
- ``write_gif``: every frame decodes to its palette-quantized copy
  (``quantize``), whose error against the input is at most 25.5 levels in
  red and blue and 21.25 in green (the 6 x 7 x 6 palette's half steps);
  the frame count, 250 ms a frame and the loop count as written; frames
  large and varied enough that the LZW table fills and is cleared, and a
  flat frame (long runs);
- the predict CLI's ``write_gifs`` through it, with its names.
"""

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from ivideogpt_tpu_torch.inference import predict
from ivideogpt_tpu_torch.utils import image_io


def _frames(kind, shape, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]
    if kind == "flat":
        return [np.full(shape, 37 * i % 256, np.uint8) for i in range(n)]
    ramp = np.linspace(0, 255, shape[1]).astype(np.uint8)
    return [np.roll(np.broadcast_to(ramp[None, :, None], shape), 3 * i, 1)
            .copy() for i in range(n)]


def _read_gif(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")))
    return frames, im.info


@pytest.mark.parametrize("shape", [(64, 128, 3), (33, 47, 3), (1, 1, 3)])
def test_png_decodes_to_the_exact_pixels(tmp_path, shape):
    img = _frames("noise", shape, 1, seed=shape[0])[0]
    path = tmp_path / "sub" / "a.png"
    image_io.write_png(str(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("kind,shape", [("noise", (64, 128, 3)),
                                        ("noise", (200, 300, 3)),
                                        ("flat", (64, 128, 3)),
                                        ("ramp", (48, 256, 3)),
                                        ("noise", (1, 1, 3))])
def test_gif_decodes_to_the_quantized_frames(tmp_path, kind, shape):
    frames = _frames(kind, shape, 5, seed=shape[1])
    path = tmp_path / "a.gif"
    image_io.write_gif(str(path), frames, duration_ms=250, loop=0)
    got, info = _read_gif(path)
    assert len(got) == len(frames)
    assert info["duration"] == 250 and info["loop"] == 0
    err = np.zeros(3)
    for g, f in zip(got, frames):
        q = image_io.quantize(f)
        np.testing.assert_array_equal(g, q)
        err = np.maximum(err, np.abs(q.astype(float) - f).reshape(-1, 3)
                         .max(0))
    assert (err <= [25.5, 21.25, 25.5]).all(), err
    assert len(imageio.mimread(path)) == len(frames)


def test_gif_loop_count_and_palette(tmp_path):
    path = tmp_path / "b.gif"
    image_io.write_gif(str(path), _frames("ramp", (8, 8, 3), 2, 0),
                       duration_ms=100, loop=3)
    _, info = _read_gif(path)
    assert info["duration"] == 100 and info["loop"] == 3
    pal = image_io.palette()
    assert len({tuple(c) for c in pal[:252]}) == 252
    # every palette colour quantizes to itself
    np.testing.assert_array_equal(image_io.quantize(pal[None, :252]),
                                  pal[None, :252])


def test_writers_refuse_other_inputs(tmp_path):
    with pytest.raises(ValueError):
        image_io.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3)))
    with pytest.raises(ValueError):
        image_io.write_gif(str(tmp_path / "x.gif"), [])
    with pytest.raises(ValueError):
        image_io.write_gif(str(tmp_path / "x.gif"),
                           [np.zeros((4, 4, 3), np.uint8),
                            np.zeros((4, 5, 3), np.uint8)])


def test_predict_write_gifs_names_and_frames(tmp_path):
    rng = np.random.default_rng(3)
    pixels = rng.random((4, 16, 16, 3)).astype(np.float32)
    preds = rng.random((2, 4, 16, 16, 3)).astype(np.float32)
    strips = predict.gif_strips(pixels, preds)
    predict.write_gifs(strips, str(tmp_path / "gifs"))
    for j, strip in enumerate(strips):
        got, info = _read_gif(tmp_path / "gifs" / f"pred-samples-{j}.gif")
        assert info["duration"] == 250 and len(got) == 4
        for g, f in zip(got, strip):
            assert g.shape == (16, 32, 3)
            np.testing.assert_array_equal(g, image_io.quantize(f))
