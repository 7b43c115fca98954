"""The port's fused segment crop-resize-normalize (``csrc/segment_ops.cpp``
through ``ivideogpt_tpu_torch/data/native.py``, built here with the system
C++ compiler), the one resize of the port's ``augment_segment``, on the
CPU:

- the fused resize against the JAX ``augment.resized_crop`` (cv2 on
  ``img / 255``) and the port's numpy one within 2e-6 (the JAX package's
  own tolerance, ``tests/test_native_preproc.py``), at crops down, up, off
  centre, of the whole frame, on non-square frames with 3 channels and 1,
  and from a strided view;
- against the JAX package's own library (``native/segment_ops.cpp`` built
  by a copy of ``native/build.sh`` in a temporary directory, never in
  ``native/``, and loaded by the JAX binding) within 2e-6, where it loads;
- ``augment_segment`` against the JAX one on both of its paths (cv2, and
  ``IVG_NATIVE_PREPROC=1``) from one seed within 3e-5, the ``Generator``
  left in the same state, and bit for bit the fused resize then the
  jitter; a ``RoboticDataset`` sample against the JAX one's on both;
- refusals: arguments that would read out of bounds raise ``ValueError``,
  and with the compiler failing or missing ``augment_segment`` raises
  where the JAX package silently falls back to cv2;
- the library is the port's own, rebuilt when its source changes, and
  threads calling it at once get the same floats.
"""

import os
import shutil
import subprocess
import threading

import numpy as np
import pytest

from ivideogpt_tpu.data import augment as jaug
from ivideogpt_tpu.data import native as jnative
from ivideogpt_tpu.data import npz_dataset as jnpz
from ivideogpt_tpu_torch import _build
from ivideogpt_tpu_torch.data import augment as taug
from ivideogpt_tpu_torch.data import native
from ivideogpt_tpu_torch.data import npz_dataset as tnpz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESIZE_ATOL = 2e-6    # tests/test_native_preproc.py:48
JITTER_ATOL = 3e-5    # tests/test_native_preproc.py:80
JITTER = dict(brightness=(0.6, 1.4), contrast=(0.7, 1.3),
              saturation=(0.5, 1.5), hue=(-0.1, 0.1))
NO_JITTER = dict(brightness=None, contrast=None, saturation=None, hue=None)

# (frames [T, H, W, C], crop (i, j, h, w), output size)
RESIZES = {
    "down": ((3, 96, 128, 3), (7, 11, 80, 100), 64),
    "identity": ((2, 64, 64, 3), (0, 0, 64, 64), 64),
    "whole_non_square": ((2, 48, 80, 3), (0, 0, 48, 80), 64),
    "up_off_centre": ((2, 40, 56, 3), (3, 9, 21, 30), 64),
    "exact_half": ((2, 128, 128, 3), (0, 0, 128, 128), 64),
    "gray": ((3, 72, 50, 1), (5, 2, 60, 44), 32),
    "corner_1px": ((1, 9, 7, 3), (8, 6, 1, 1), 4),
    "oxe_256": ((2, 256, 256, 3), (10, 4, 230, 240), 256),
}


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _reference(images, crop, size, resized_crop):
    out = [resized_crop(f.astype(np.float32) / 255.0, *crop, size)
           for f in images]
    return np.stack(out).reshape(len(images), size, size, images.shape[-1])


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX binding over its own library, built from ``native/`` by a
    copy of ``native/build.sh`` under a temporary directory (the JAX test's
    fixture, off the tree) and loaded by ``jnative._load`` through a
    ``__file__`` that points there; None where it does not build or load.
    While the module's tests run, the JAX binding never reads
    ``native/libsegment_ops.so``: without the library it takes its cv2
    path."""
    root = tmp_path_factory.mktemp("jax_native")
    (root / "native").mkdir()
    for f in ("build.sh", "segment_ops.cpp"):
        shutil.copy(os.path.join(REPO, "native", f), root / "native" / f)
    built = subprocess.run(["bash", str(root / "native" / "build.sh")],
                           capture_output=True, text=True).returncode == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "__file__",
                   str(root / "ivideogpt_tpu" / "data" / "native.py"))
        mp.setattr(jnative, "_TRIED", False)
        mp.setattr(jnative, "_LIB", None)
        try:
            ok = built and jnative.available()
        except OSError:
            ok = False
        mp.setattr(jnative, "_TRIED", True)
        if not ok:
            mp.setattr(jnative, "_LIB", None)
        yield jnative if ok else None


# ----------------------------------------------------------------------
# the fused resize


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("case", list(RESIZES))
def test_fused_resize_matches_cv2_and_the_numpy_resize(case, strided):
    shape, crop, size = RESIZES[case]
    images = _frames(shape, seed=len(case))
    # a view with a step on T and W: the binding makes it contiguous
    view = (np.repeat(np.repeat(images, 2, axis=0), 2, axis=2)[::2, :, ::2]
            if strided else images)
    np.testing.assert_array_equal(view, images)
    got = native.segment_crop_resize(view, *crop, size)
    assert got.dtype == np.float32 and got.shape == (shape[0], size, size,
                                                     shape[-1])
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(
        got, _reference(images, crop, size, jaug.resized_crop),
        rtol=0, atol=RESIZE_ATOL)
    np.testing.assert_allclose(
        got, _reference(images, crop, size, taug.resized_crop),
        rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("case", list(RESIZES))
def test_fused_resize_matches_the_jax_library(jax_native, case):
    if jax_native is None:
        pytest.skip("the JAX package's library does not build or load here")
    shape, crop, size = RESIZES[case]
    images = _frames(shape, seed=len(case))
    want = jax_native.segment_crop_resize(images, *crop, size)
    got = native.segment_crop_resize(images, *crop, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


def test_identity_crop_is_the_frames_over_255():
    images = _frames((2, 64, 64, 3), seed=1)
    np.testing.assert_allclose(
        native.segment_crop_resize(images, 0, 0, 64, 64, 64),
        images.astype(np.float32) / 255.0, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# augment_segment and the loader


# the CLIs' shapes (BAIR tokenizer: 8 frames of 64 px; the GPT CLI: 16;
# oxe-256: 256 px) and a non-square frame
SEGMENTS = {"bair_tokenizer": (8, 64, 64, 64), "gpt": (16, 64, 64, 64),
            "non_square": (5, 72, 80, 64), "oxe_256": (2, 256, 256, 256)}


def _numpy_augment(images, size, kw, rng):
    """The JAX package's default path written out in the port's numpy:
    the same draws, ``resized_crop`` on ``img / 255``, then the jitter."""
    t, h, w, _ = images.shape
    i, j, ch, cw = taug.get_crop_params(h, w, kw["crop_scale"],
                                        kw["crop_ratio"], rng)
    params = taug.jitter_params(kw["brightness"], kw["contrast"],
                                kw["saturation"], kw["hue"], rng)
    return np.stack([taug.apply_jitter(taug.resized_crop(
        f.astype(np.float32) / 255.0, i, j, ch, cw, size), *params)
        for f in images])


@pytest.mark.parametrize("jitter", ["jitter", "no_jitter"])
@pytest.mark.parametrize("case", list(SEGMENTS))
def test_augment_segment_matches_jax_on_both_of_its_paths(
        jax_native, monkeypatch, case, jitter):
    """Against JAX ``augment_segment`` with ``IVG_NATIVE_PREPROC`` unset
    (cv2) and set to "1" (its own library where it loads), and against
    the numpy resize from the same draws."""
    t, h, w, size = SEGMENTS[case]
    images = _frames((t, h, w, 3), seed=t + h + w)
    kw = dict(crop_scale=(0.8, 1.0), crop_ratio=(0.9, 1.1),
              **(JITTER if jitter == "jitter" else NO_JITTER))
    gens = [np.random.default_rng(11) for _ in range(4)]
    ours = taug.augment_segment(images, size, rng=gens[0], **kw)
    assert ours.dtype == np.float32 and ours.shape == (t, size, size, 3)
    monkeypatch.delenv("IVG_NATIVE_PREPROC", raising=False)
    np.testing.assert_allclose(
        ours, jaug.augment_segment(images, size, rng=gens[1], **kw),
        rtol=0, atol=JITTER_ATOL)
    monkeypatch.setenv("IVG_NATIVE_PREPROC", "1")
    np.testing.assert_allclose(
        ours, jaug.augment_segment(images, size, rng=gens[2], **kw),
        rtol=0, atol=JITTER_ATOL)
    np.testing.assert_allclose(ours, _numpy_augment(images, size, kw,
                                                    gens[3]),
                               rtol=0, atol=JITTER_ATOL)
    state = gens[0].bit_generator.state
    assert all(g.bit_generator.state == state for g in gens[1:])


@pytest.mark.parametrize("case", list(SEGMENTS))
def test_augment_segment_is_the_fused_resize_then_the_jitter(case):
    """Bit for bit: the crop and jitter draws, one fused call on the
    whole segment, then ``apply_jitter`` on each frame."""
    t, h, w, size = SEGMENTS[case]
    images = _frames((t, h, w, 3), seed=t + 2 * h + w)
    got = taug.augment_segment(images, size, (0.8, 1.0), (0.9, 1.1),
                               rng=np.random.default_rng(7), **JITTER)
    rng = np.random.default_rng(7)
    crop = taug.get_crop_params(h, w, (0.8, 1.0), (0.9, 1.1), rng)
    params = taug.jitter_params(*JITTER.values(), rng)
    fused = native.segment_crop_resize(images, *crop, size)
    want = np.stack([taug.apply_jitter(f, *params) for f in fused])
    np.testing.assert_array_equal(got, want)


def _episodes(root, n=4, frames=20, hw=(72, 80)):
    d = root / "cmu_stretch"
    d.mkdir()
    rng = np.random.default_rng(3)
    for e in range(n):
        np.savez(d / f"episode_{e:03d}.npz",
                 image=rng.integers(0, 256, (frames, *hw, 3), np.uint8),
                 action=rng.normal(size=(frames, 4)).astype(np.float32))
    return root


@pytest.mark.parametrize("mode", ["plain", "random_selection", "no_aug"])
def test_robotic_dataset_sample_matches_jax_on_both_of_its_paths(
        jax_native, monkeypatch, tmp_path, mode):
    """A sample against the JAX dataset's with ``IVG_NATIVE_PREPROC``
    unset and set to "1" (``no_aug`` keeps ``augment.resize`` in both
    packages and never reaches the fused call)."""
    root = _episodes(tmp_path)
    kw = dict(segment_length=8, context_length=2, seed=5,
              random_resized_crop_scale=(0.8, 1.0),
              random_resized_crop_ratio=(0.9, 1.1), load_action=True,
              **JITTER,
              **({"random_selection": True, "segment_horizon": 12}
                 if mode == "random_selection" else {}),
              **({"no_aug": True} if mode == "no_aug" else {}))
    if mode == "no_aug":
        monkeypatch.setattr(native, "segment_crop_resize", None)
    ours = tnpz.RoboticDataset(str(root), "cmu_stretch", **kw)
    o_px, o_act = ours.sample()
    assert o_px.dtype == np.float32 and o_px.shape == (8, 64, 64, 3)
    for value in (None, "1"):
        if value is None:
            monkeypatch.delenv("IVG_NATIVE_PREPROC", raising=False)
        else:
            monkeypatch.setenv("IVG_NATIVE_PREPROC", value)
        theirs = jnpz.RoboticDataset(str(root), "cmu_stretch", **kw)
        t_px, t_act = theirs.sample()
        np.testing.assert_allclose(o_px, t_px, rtol=0, atol=JITTER_ATOL)
        np.testing.assert_array_equal(o_act, t_act)
        assert ours.rng.bit_generator.state == theirs.rng.bit_generator.state


# ----------------------------------------------------------------------
# refusals


BAD = {
    "negative_row": ((2, 16, 16, 3), np.uint8, (-1, 0, 8, 8, 8)),
    "rows_past_the_frame": ((2, 16, 16, 3), np.uint8, (9, 0, 8, 8, 8)),
    "negative_column": ((2, 16, 16, 3), np.uint8, (0, -2, 8, 8, 8)),
    "columns_past_the_frame": ((2, 16, 20, 3), np.uint8, (0, 13, 8, 8, 8)),
    "empty_rows": ((2, 16, 16, 3), np.uint8, (0, 0, 0, 8, 8)),
    "empty_columns": ((2, 16, 16, 3), np.uint8, (0, 0, 8, 0, 8)),
    "size_0": ((2, 16, 16, 3), np.uint8, (0, 0, 8, 8, 0)),
    "float_frames": ((2, 16, 16, 3), np.float32, (0, 0, 8, 8, 8)),
    "one_frame_3d": ((16, 16, 3), np.uint8, (0, 0, 8, 8, 8)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_out_of_range_arguments_raise_before_the_call(monkeypatch, case):
    shape, dtype, args = BAD[case]
    monkeypatch.setattr(native, "_library", lambda: pytest.fail(
        "the library was reached"))
    with pytest.raises(ValueError):
        native.segment_crop_resize(np.zeros(shape, dtype), *args)


def _no_compiler():
    raise RuntimeError("no C++ compiler (c++ or g++) found")


@pytest.mark.parametrize("compiler", ["fails", "missing"])
def test_a_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch,
                                                    compiler):
    """Not copied from the JAX package: with no library, JAX
    ``augment_segment`` silently takes its cv2 path
    (``ivideogpt_tpu/data/augment.py:129-130``); the port raises with the
    compiler's reason."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_fn", None)
    monkeypatch.setattr(_build, "_cxx", (lambda: shutil.which("false"))
                        if compiler == "fails" else _no_compiler)
    images = _frames((2, 32, 32, 3), seed=2)
    match = "c\\+\\+ failed for segment_ops.cpp" if compiler == "fails" \
        else "no C\\+\\+ compiler"
    with pytest.raises(RuntimeError, match=match):
        taug.augment_segment(images, 16, None, None, rng=np.random
                             .default_rng(0), **NO_JITTER)
    assert not (tmp_path / "build").exists() or not [
        f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


# ----------------------------------------------------------------------
# the library


def test_library_is_the_ports_own_and_rebuilt_when_its_source_changes(
        tmp_path, monkeypatch):
    assert "segment_ops" in _build.HOST_SOURCES
    assert "segment_ops" not in _build.SOURCES
    assert not {"-ffast-math", "-march=native", "-fopenmp"} & set(
        _build.HOST_FLAGS)
    assert "-ffp-contract=off" in _build.HOST_FLAGS
    native.segment_crop_resize(_frames((1, 8, 8, 3), seed=0), 0, 0, 8, 8, 4)
    path = _build._lib_path("segment_ops")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("segment_ops-")
    assert os.path.exists(path) and _build._libs["segment_ops"]._name == path
    with open(os.path.join(_build.CSRC, "segment_ops.cpp")) as f:
        src = f.read()
    assert "omp" not in src.replace("OpenMP", "")
    (tmp_path / "segment_ops.cpp").write_text(src)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build._lib_path("segment_ops")
    (tmp_path / "segment_ops.cpp").write_text(src + "// edited\n")
    assert _build._lib_path("segment_ops") != before


def test_threads_calling_at_once_get_the_same_floats():
    images = _frames((16, 64, 64, 3), seed=6)
    want = native.segment_crop_resize(images, 3, 5, 57, 51, 64)
    errors, got = [], []

    def work():
        try:
            for _ in range(20):
                out = native.segment_crop_resize(images, 3, 5, 57, 51, 64)
                got.append(np.array_equal(out, want))
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append(e)
    threads = [threading.Thread(target=work)
               for _ in range(2 * (os.cpu_count() or 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == [True] * (20 * len(threads))
