"""The port's JPEG decoder (``csrc/jpeg_decode.cpp`` through
``ivideogpt_tpu_torch/data/jpeg.py``, built here with the system C++
compiler) against PIL's decode on the CPU:

- files PIL writes from seeded smooth-plus-noise images at odd sizes, in
  4:2:0, 4:2:2, 4:4:4, grayscale, with restart markers (by blocks and by
  rows), at qualities 50 and 95, and with optimised Huffman tables: pixels
  equal to ``np.asarray(Image.open(p).convert("RGB"))`` bit for bit;
- refusals that name the file and the feature: progressive, four
  components, arithmetic coding, 12-bit precision, a DNL height, other
  sampling factors, more than one scan, data that ends early; corrupt
  entropy data raises and does not crash;
- the committed fixtures of ``tests/data/sthsth`` (the card's gate): PIL's
  decode still has the digest in ``digests.json``, the port's equals it,
  and two threads decoding the same files at once give the same bytes;
- the host build route of ``_build``: a failed compile and a missing
  compiler raise with the reason.
"""

import hashlib
import io
import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from ivideogpt_tpu_torch import _build
from ivideogpt_tpu_torch.data import jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "sthsth")
SIZES = [(240, 427), (61, 97), (8, 8), (33, 17)]
LAYOUTS = {
    "420": dict(subsampling=2),
    "422": dict(subsampling=1),
    "444": dict(subsampling=0),
    "gray": dict(),
    "restart_blocks": dict(restart_marker_blocks=3),
    "restart_rows": dict(restart_marker_rows=1),
    "optimize": dict(optimize=True),
}


def _image(h, w, channels, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, (channels, 2))
    img = np.stack([128 + 90 * np.sin(x / 9.0 + p[0]) * np.cos(y / 7.0 + p[1])
                    for p in phase], -1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def _jpeg_bytes(img, **opts):
    buf = io.BytesIO()
    Image.fromarray(img if img.shape[-1] == 3 else img[..., 0]).save(
        buf, "JPEG", **opts)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decode_equals_pil_bit_for_bit(hw, layout, quality):
    channels = 1 if layout == "gray" else 3
    img = _image(*hw, channels, seed=hw[0] * 1000 + hw[1] + quality)
    data = _jpeg_bytes(img, quality=quality, **LAYOUTS[layout])
    got = jpeg.decode_jpeg(data)
    want = _pil(data)
    assert got.dtype == np.uint8 and got.shape == (*hw, 3)
    np.testing.assert_array_equal(got, want)


def test_rgb_colour_space_is_not_converted():
    """An Adobe marker with transform 0 (PIL's ``keep_rgb``) holds RGB:
    libjpeg copies it, and so does the port."""
    data = _jpeg_bytes(_image(37, 45, 3, seed=3), quality=90, keep_rgb=True,
                       subsampling=0)
    assert b"Adobe" in data
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _pil(data))


def _sof(data):
    for marker in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        if marker in data:
            return data.index(marker)
    raise AssertionError("no SOF")


def _patched(data, offset, value):
    out = bytearray(data)
    out[offset] = value
    return bytes(out)


def _two_scans(data):
    """The file with its SOS segment and entropy data repeated: a second
    scan after the first."""
    sos = data.index(b"\xff\xda")
    return data[:-2] + data[sos:-2] + data[-2:]


def _refused():
    base = _jpeg_bytes(_image(24, 40, 3, seed=7), quality=80)
    sof = _sof(base)
    cmyk = io.BytesIO()
    Image.fromarray(_image(24, 40, 3, seed=8)).convert("CMYK").save(
        cmyk, "JPEG")
    return {
        "progressive": (_jpeg_bytes(_image(24, 40, 3, seed=9),
                                    progressive=True), "progressive"),
        "cmyk": (cmyk.getvalue(), "four components"),
        "arithmetic": (_patched(base, sof + 1, 0xC9), "arithmetic"),
        "12bit": (_patched(base, sof + 4, 12), "12-bit"),
        "dnl": (_patched(_patched(base, sof + 5, 0), sof + 6, 0), "DNL"),
        "sampling_4x1": (_patched(base, sof + 11, 0x41), "sampling"),
        "two_scans": (_two_scans(base), "more than one scan"),
        "truncated_scan": (base[:base.index(b"\xff\xda") + 60],
                           "ends early"),
        "truncated_end": (base[:-40], "ends"),
        "no_eoi": (base[:-2], "EOI"),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_refusals_name_the_file_and_the_feature(tmp_path, case):
    data, feature = _refused()[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(jpeg.JpegError) as info:
        jpeg.read_jpeg(str(path))
    assert str(path) in str(info.value) and feature in str(info.value)
    if case == "truncated_scan":   # PIL refuses it too
        with pytest.raises(OSError, match="truncated"):
            Image.open(io.BytesIO(data)).load()


def test_corrupt_entropy_data_raises_and_does_not_crash():
    data = _jpeg_bytes(_image(64, 96, 3, seed=11), quality=90)
    sos = data.index(b"\xff\xda") + 14
    rng = np.random.default_rng(0)
    raised = 0
    for _ in range(300):
        bad = bytearray(data)
        for i in rng.integers(sos, len(data) - 2, rng.integers(1, 6)):
            bad[i] = rng.integers(0, 256)
        try:
            out = jpeg.decode_jpeg(bytes(bad), "bad.jpg")
        except jpeg.JpegError as e:
            assert "bad.jpg" in str(e)
            raised += 1
        else:
            assert out.shape == (64, 96, 3)
    # an invalid code: all ones past the longest code of the DC table
    ones = bytearray(data)
    ones[sos:sos + 8] = b"\xff\x00" * 4
    with pytest.raises(jpeg.JpegError, match="Huffman"):
        jpeg.decode_jpeg(bytes(ones))
    assert raised > 100
    with pytest.raises(jpeg.JpegError, match="not a JPEG"):
        jpeg.decode_jpeg(b"GIF89a", "x.gif")


# ----------------------------------------------------------------------
# the committed fixtures


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def _sha(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


@pytest.mark.parametrize("rel", sorted(_digests()))
def test_fixture_digests_hold_for_pil_and_the_port(rel):
    want = _digests()[rel]
    path = os.path.join(FIXTURES, rel)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert [list(pil.shape), _sha(pil)] == [want["shape"], want["sha256"]]
    if rel == "progressive.jpg":
        with pytest.raises(jpeg.JpegError, match="progressive"):
            jpeg.read_jpeg(path)
        return
    got = jpeg.read_jpeg(path)
    assert [list(got.shape), _sha(got)] == [want["shape"], want["sha256"]]


def test_fixture_folder_is_small_and_complete():
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURES) for f in fs)
    assert total < 1 << 20
    rels = set(_digests())
    assert {f"seq/{i:06d}.jpg" for i in range(1, 17)} <= rels
    assert {"s422.jpg", "s444.jpg", "gray.jpg", "restart.jpg", "odd.jpg",
            "progressive.jpg"} <= rels
    for rel in rels:
        if rel.startswith("seq/"):
            assert _digests()[rel]["shape"] == [240, 427, 3]


def test_two_threads_decode_the_same_bytes():
    paths = [os.path.join(FIXTURES, rel) for rel in sorted(_digests())
             if rel != "progressive.jpg"]
    alone = [_sha(jpeg.read_jpeg(p)) for p in paths]
    got = [[], []]

    def run(k):
        for _ in range(3):
            got[k].append([_sha(jpeg.read_jpeg(p)) for p in paths])
    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got[0] == got[1] == [alone] * 3


def test_more_threads_than_cores_decode_the_same_bytes():
    """The decoder keeps no state between calls, and the library is loaded
    once whichever thread comes first: threads beyond the cores, switching
    often, all see the bytes of one thread alone."""
    import sys
    data = open(os.path.join(FIXTURES, "seq", "000001.jpg"), "rb").read()
    want = _sha(jpeg.decode_jpeg(data))
    n = 2 * (os.cpu_count() or 1) + 1
    got, errors = [[] for _ in range(n)], []

    def run(k):
        try:
            for _ in range(4):
                got[k].append(_sha(jpeg.decode_jpeg(data)))
        except Exception as e:   # reported below
            errors.append(e)
    old = sys.getswitchinterval()
    jpeg._fns = None    # the first decode in a thread loads the library
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert got == [[want] * 4] * n


# ----------------------------------------------------------------------
# the host build route


def test_host_library_is_built_under_csrc_build():
    assert "jpeg_decode" in _build.HOST_SOURCES
    assert "jpeg_decode" not in _build.SOURCES
    path = _build._lib_path("jpeg_decode")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("jpeg_decode-")
    jpeg.decode_jpeg(_jpeg_bytes(_image(8, 8, 3, seed=1)))
    assert os.path.exists(path)


def test_failed_host_build_raises_with_the_compiler_log(tmp_path,
                                                        monkeypatch):
    (tmp_path / "jpeg_decode.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="c\\+\\+ failed for "
                       "jpeg_decode.cpp") as info:
        _build.load("jpeg_decode")
    assert "error" in str(info.value)
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.load("jpeg_decode")
