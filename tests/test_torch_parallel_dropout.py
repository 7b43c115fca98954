"""The attention-dropout mask of a shard (``ops/philox.py``): a data- or
tensor-parallel rank's rows from global row b0 and heads from global head
h0 of Hg draw the global rows' bits, so a shard's mask and the plain K4,
K5 and K6 of a shard equal the slice of the whole batch's, bit for bit,
and the default shard (0, 0, H) is the three-element form's mask. The
kernels take the same arguments (``_drop_args``); ``chip_smoke.py``'s
``dist_kernels`` phase holds them to the same slices on the card."""

import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch.ops import flash_attention as fa
from ivideogpt_tpu_torch.ops import philox

B, H, S, HD = 4, 6, 37, 64
DROP = (0.1, 1234, philox.offset_of(3, 2))
# (b0, nb, h0, nh): batch halves, head halves, a corner, one row and head
SHARDS = [(0, 2, 0, 6), (2, 2, 0, 6), (0, 4, 0, 3), (0, 4, 3, 3),
          (1, 2, 2, 3), (3, 1, 5, 1)]


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, H, HD, generator=g) for _ in range(4))
    return q, k, v, do


def _cut(t, b0, nb, h0, nh):
    return t[b0:b0 + nb, :, h0:h0 + nh].contiguous()


@pytest.mark.parametrize("b0,nb,h0,nh", SHARDS)
def test_a_shards_mask_is_the_slice_of_the_global_mask(b0, nb, h0, nh):
    whole = philox.keep_mask(DROP, B, H, S, 0, S, 0, S)
    part = philox.keep_mask(DROP + (b0, h0, H), nb, nh, S, 0, S, 0, S)
    assert torch.equal(part, whole[b0:b0 + nb, h0:h0 + nh])
    chunk = philox.keep_mask(DROP + (b0, h0, H), nb, nh, S, 5, 9, 6, 17)
    assert torch.equal(chunk, whole[b0:b0 + nb, h0:h0 + nh, 5:14, 6:23])


def test_the_default_shard_is_todays_mask():
    three = philox.keep_mask(DROP, B, H, S, 0, S, 0, S)
    assert torch.equal(three, philox.keep_mask(DROP + (0, 0, H), B, H, S, 0,
                                               S, 0, S))
    # a shard whose Hg is not its H draws other bits than the unsharded call
    assert not torch.equal(three[:, :3], philox.keep_mask(
        DROP + (0, 0, 3), B, 3, S, 0, S, 0, S))


@pytest.mark.parametrize("b0,nb,h0,nh", SHARDS)
def test_plain_kernels_of_a_shard_equal_the_slice_of_the_whole(b0, nb, h0,
                                                                nh):
    q, k, v, do = _inputs()
    o, lse = fa.flash_fwd_plain(q, k, v, DROP)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di, DROP)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, di, DROP)

    shard = DROP + (b0, h0, H)
    qs, ks, vs, dos = (_cut(t, b0, nb, h0, nh) for t in (q, k, v, do))
    o_s, lse_s = fa.flash_fwd_plain(qs, ks, vs, shard)
    di_s = di[b0:b0 + nb, h0:h0 + nh].contiguous()
    lse_c = lse[b0:b0 + nb, h0:h0 + nh].contiguous()
    dk_s, dv_s = fa.flash_bwd_dkv_plain(qs, ks, vs, dos, lse_c, di_s, shard)
    dq_s = fa.flash_bwd_dq_plain(qs, ks, vs, dos, lse_c, di_s, shard)
    for got, want in ((o_s, o), (dk_s, dk), (dv_s, dv), (dq_s, dq)):
        assert torch.equal(got, _cut(want, b0, nb, h0, nh))
    assert torch.equal(lse_s, lse[b0:b0 + nb, h0:h0 + nh])


def test_sharded_causal_attention_concatenates_to_the_whole():
    q, k, v, _ = _inputs(1)
    whole = fa.causal_attention(q, k, v, torch.float32, DROP)
    halves = [fa.causal_attention(*(t[:, :, h0:h0 + 3] for t in (q, k, v)),
                                  torch.float32, DROP + (0, h0, H))
              for h0 in (0, 3)]
    got = torch.cat([h.view(B, S, 3, HD) for h in halves], dim=2)
    assert torch.equal(got, whole.view(B, S, H, HD))


def test_drop_args_carry_the_shard_to_the_kernels():
    assert fa._drop_args(None, B, H) == (0.0, 0, 0, 0, 0, H)
    assert fa._drop_args(DROP, B, H) == DROP + (0, 0, H)
    assert fa._drop_args(DROP + (8, 6, 12), 8, 6) == DROP + (8, 6, 12)
    with pytest.raises(ValueError):
        fa._drop_args(DROP + (0, 7, 12), B, 6)   # heads past Hg
    with pytest.raises(ValueError):
        philox.check_dropout(DROP + (-1, 0, 12))
    with pytest.raises(ValueError):
        philox.check_dropout(DROP + (0, 0))
    with pytest.raises(ValueError):
        philox.shard_of(DROP + (2 ** 27, 0, 32), 1, 32)  # rows past an int


def test_a_shards_kept_share_is_the_rate():
    z = philox.keep_mask((0.25, 9, 4, 16, 6, 12), 16, 6, 300, 0, 300, 0, 300)
    np.testing.assert_allclose(z.float().mean().item(), 0.75, atol=2e-3)
