"""Q1's tile schedule (``ivideogpt_tpu_torch/csrc/qconv.cu``) emulated on the
CPU, against JAX's int8 conv (``ivideogpt_tpu/ops/qconv.py``'s
``_int8_conv_call``: ``lax.conv_general_dilated`` with
``preferred_element_type=int32``).

The emulation walks what the kernel walks, from the plan the wrapper hands
it (``ops.qconv.q1_plan``): the persistent grid's tiles in order (a pixel
tile's channel tiles next to each other), for each K step the TMA box of
one tap and one 128-byte channel block read from the channels-last codes
with every coordinate outside the image zero-filled (at stride 2 through
the four parity views), the packed weight's rows in its K order, then the
store: by TMA (a tile's 128-byte rows of pixels from the tile's first
pixel, dropped past the frame and past O) where the plan says so, else the
masked copy. The tile's rows past its pixels hold garbage, as the ring's
stale stages do. Its int32 sums must equal JAX's bit for bit, and every
output be written exactly once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch.ops import qconv as tq

torch.set_num_threads(2)

BLOCK = tq.Q1_TILE_K  # bytes of a tap's channels a K step


def _box(xq, n, m, stride, c0, xc, yc, bw, br):
    """The TMA box {BLOCK, bw, br, 1} at (c0, xc, yc, n) of parity map m
    (stride 2) or of the codes (stride 1): [br * bw, BLOCK], zeros outside
    the map."""
    if stride == 1:
        view = xq[n]
    else:
        py, px = m >> 1, m & 1
        view = xq[n, py::2, px::2]
    h, w, cp = view.shape
    out = np.zeros((br, bw, BLOCK), np.int8)
    ys = np.arange(yc, yc + br)
    xs = np.arange(xc, xc + bw)
    yi, xi = ys[(ys >= 0) & (ys < h)], xs[(xs >= 0) & (xs < w)]
    c1 = min(cp, c0 + BLOCK)
    if len(yi) and len(xi) and c0 < cp:
        out[yi[0] - yc:yi[-1] - yc + 1, xi[0] - xc:xi[-1] - xc + 1,
            :c1 - c0] = view[yi[0]:yi[-1] + 1, xi[0]:xi[-1] + 1, c0:c1]
    return out.reshape(br * bw, BLOCK)


def emulate_q1(xq, packed, o_real, k, stride, pad, plan, seed=0):
    """Q1's int32 output [N, O, Ho, Wo] from channels-last codes xq [N, H,
    W, Cp] and the packed weight [O, K], tile by tile as the kernel runs
    ``plan``; also the count of writes of each output."""
    rng = np.random.default_rng(seed)
    n_img, h, w, cp = xq.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    n_cb = -(-cp // BLOCK)
    assert packed.shape == (o_real, k * k * n_cb * BLOCK)
    tiles_x = -(-wo // plan.bw)
    tiles_img = tiles_x * -(-ho // plan.br)
    tiles_o = -(-o_real // plan.bn)
    out = np.zeros((n_img, o_real, ho * wo), np.int64)
    writes = np.zeros(out.shape, np.int64)
    for t in range(n_img * tiles_img * tiles_o):
        pt, nt = divmod(t, tiles_o)
        n, r = divmod(pt, tiles_img)
        ty, tx = divmod(r, tiles_x)
        y0, x0, o0 = ty * plan.br, tx * plan.bw, nt * plan.bn
        acc = np.zeros((plan.bm, plan.bn))
        for ks in range(k * k * n_cb):
            tap, cb = divmod(ks, n_cb)
            dy, dx = divmod(tap, k)
            m, xc, yc = 0, x0 - pad + dx, y0 - pad + dy
            if stride == 2:
                ox, oy = dx - pad, dy - pad
                px, py = ox & 1, oy & 1
                m = 2 * py + px
                xc, yc = x0 + (ox - px) // 2, y0 + (oy - py) // 2
            a = rng.integers(-127, 128, (plan.bm, BLOCK)).astype(np.int8)
            a[:plan.br * plan.bw] = _box(xq, n, m, stride, cb * BLOCK, xc,
                                         yc, plan.bw, plan.br)
            b = np.zeros((plan.bn, BLOCK), np.int8)
            rows = packed[o0:o0 + plan.bn, ks * BLOCK:(ks + 1) * BLOCK]
            b[:len(rows)] = rows
            # exact in float64: every partial sum is an integer below 2^53
            acc += a.astype(np.float64) @ b.astype(np.float64).T
        acc = acc.astype(np.int64)
        o_hi = min(o_real, o0 + plan.bn)
        if plan.tma_store:
            p0 = y0 * wo + x0
            p_hi = min(ho * wo, p0 + plan.bm)
            out[n, o0:o_hi, p0:p_hi] = acc[:p_hi - p0, :o_hi - o0].T
            writes[n, o0:o_hi, p0:p_hi] += 1
        else:
            for ti in range(plan.bm):
                yy, xx = divmod(ti, plan.bw)
                y, x = y0 + yy, x0 + xx
                if yy >= plan.br or y >= ho or x >= wo:
                    continue
                out[n, o0:o_hi, y * wo + x] = acc[ti, :o_hi - o0]
                writes[n, o0:o_hi, y * wo + x] += 1
    return out.reshape(n_img, o_real, ho, wo), writes


def _jax_acc(xq, wq, stride, pad):
    """JAX's int8 conv of NHWC codes and an OIHW int8 kernel: NCHW int32."""
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq.transpose(2, 3, 1, 0)),
        (stride, stride), [(pad, pad)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(acc).transpose(0, 3, 1, 2)


def _check(n, c, h, w, o, k, stride, pad, out_bytes, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, c, h, w)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(o, c, k, k)).astype(np.float32))
    xq = tq.quantize(x, tq.amax(x) / 127.0).numpy()
    weight = tq.PackedWeight(wt)
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    plan = tq.q1_plan(ho, wo, o, out_bytes)
    got, writes = emulate_q1(xq, weight.packed.numpy(), o, k, stride, pad,
                             plan, seed)
    want = _jax_acc(xq[..., :c], weight.wq.numpy(), stride, pad)
    assert (writes == 1).all(), "an output written more or less than once"
    assert got.dtype == np.int64 and (np.abs(got) < 2**31).all()
    np.testing.assert_array_equal(got.astype(np.int32), want)
    return plan


# TOKENIZER_64's detokenize shapes cut to one or two frames and narrower
# channels where the tiles stay the same: (n, C, H=W, O, k)
DETOK = [(1, 64, 16, 512, 3), (2, 64, 16, 64, 1), (1, 128, 64, 3, 3),
         (1, 128, 32, 128, 3), (1, 256, 32, 256, 3), (1, 256, 64, 128, 1),
         (1, 512, 16, 512, 3), (1, 512, 32, 256, 1), (1, 512, 16, 3, 3)]


@pytest.mark.parametrize("n,c,hw,o,k", DETOK)
@pytest.mark.parametrize("out_bytes", [2, 4])
def test_tiles_at_detokenize_shapes(n, c, hw, o, k, out_bytes):
    """Whole tiles stored by TMA: 3 x 3 and 1 x 1, W 16, 32 and 64, C 64
    (half a channel block, zero-filled), 128, 256 and 512, O 3 (a 16-channel
    tile), 64, 128, 256 and 512."""
    plan = _check(n, c, hw, hw, o, k, 1, k // 2, out_bytes, seed=c + o + k)
    assert plan.tma_store and plan.bw * plan.br == plan.bm


@pytest.mark.parametrize("n,c,h,w,o,k,stride,pad", [
    (1, 16, 1, 1, 1, 1, 1, 0), (3, 128, 33, 31, 3, 3, 1, 1),
    (2, 64, 20, 20, 70, 3, 2, 1), (2, 48, 9, 9, 16, 3, 2, 0),
    (5, 3, 17, 13, 8, 3, 1, 1), (3, 100, 11, 7, 130, 1, 2, 0),
    (7, 32, 5, 5, 3, 3, 2, 1), (3, 64, 1, 1, 16, 3, 2, 1),
    (2, 32, 2, 1, 5, 3, 2, 1), (2, 16, 1, 6, 9, 1, 2, 0),
    (1, 200, 7, 300, 300, 3, 2, 1), (1, 16, 4, 512, 300, 3, 1, 1),
    (2, 64, 33, 31, 300, 3, 1, 1)])
@pytest.mark.parametrize("out_bytes", [2, 4])
def test_tiles_at_ragged_and_stride_2_shapes(n, c, h, w, o, k, stride, pad,
                                             out_bytes):
    """The GPU tests' shapes: ragged pixel tiles (W not dividing the tile:
    the masked copy), channels off the block (3, 100, 200), stride 2
    through the parity views (one of a single pixel, where three parities
    are empty), row segments (Wo 150 and 512 past a tile of 128)."""
    _check(n, c, h, w, o, k, stride, pad, out_bytes, seed=n + c + h + w)


def test_plan():
    """The tile sizes by O, whole rows or segments, and when the epilogue
    may store by TMA."""
    assert tq.q1_plan(16, 16, 512, 2) == (256, 128, 16, 8, True)
    assert tq.q1_plan(64, 64, 128, 2) == (128, 256, 64, 4, True)
    assert tq.q1_plan(64, 64, 3, 4) == (16, 256, 64, 4, True)
    assert tq.q1_plan(33, 31, 3, 2) == (16, 256, 31, 8, False)
    assert tq.q1_plan(3, 3, 3, 2) == (16, 256, 3, 3, False)  # 18 bytes
    assert tq.q1_plan(4, 4, 3, 2) == (16, 256, 4, 4, True)   # one tile
    assert tq.q1_plan(2, 512, 300, 2) == (256, 128, 128, 1, True)
    assert tq.q1_plan(8, 150, 300, 2) == (256, 128, 128, 1, False)
    assert tq.q1_plan(1, 1, 1, 4) == (16, 256, 1, 1, False)  # 4 bytes
