"""K4, K5 and K6 with dropout launched as a data- or tensor-parallel rank's
shard (``dropout=(p, seed, offset, b0, h0, Hg)``) on the card: the shards
of a batch concatenate to the whole launch bit for bit, in bf16 and fp32,
at ragged S, over batch halves, head halves and an odd corner; a shard's
launches refuse a head range past Hg.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_parallel.py
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

DROP = (0.1, 77, 5 << 16 | 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _launch(q, k, v, do, lse, di, drop):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    o, lse_o = fa.flash_fwd(q, k, v, drop)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, drop)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, di, drop)
    return o, lse_o, dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [37, 64, 751])
@pytest.mark.parametrize("cut", [(0, 2, 0, 6), (2, 2, 0, 6), (0, 4, 0, 3),
                                 (0, 4, 3, 3), (1, 2, 2, 3), (3, 1, 5, 1)])
def test_a_shards_launch_is_the_slice_of_the_whole(cuda, dtype, S, cut):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    B, H = 4, 6
    g = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, do = (torch.randn(B, S, H, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, DROP)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    whole = _launch(q, k, v, do, lse, di, DROP)
    b0, nb, h0, nh = cut
    rows = (slice(b0, b0 + nb), slice(None), slice(h0, h0 + nh))
    part = _launch(q[rows], k[rows], v[rows], do[rows].contiguous(),
                   lse[b0:b0 + nb, h0:h0 + nh].contiguous(),
                   di[b0:b0 + nb, h0:h0 + nh].contiguous(),
                   DROP + (b0, h0, H))
    for got, want in zip(part, whole):
        want = (want[b0:b0 + nb, h0:h0 + nh] if want.ndim == 3
                else want[rows])
        assert torch.equal(got, want)


def test_a_shard_past_its_heads_is_refused(cuda):
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    q = torch.randn(2, 64, 6, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q, q, DROP + (0, 4, 6))
