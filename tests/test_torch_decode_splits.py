"""K3's split plan (``ops/decode_attention.decode_splits``): the runs of
cache slots that the kernel's blocks walk side by side and merge in one
launch. Pure Python; the kernel's own head limit is held against this
module's on the card (``tests/test_torch_gpu_kernels.py``)."""

import pytest

from ivideogpt_tpu_torch.ops import decode_attention as tda

SMS = tda.H100_SMS


@pytest.mark.parametrize("b,m,splits", [(256, 752, 1), (32, 684, 4)])
def test_the_plan_at_the_rollouts_shapes(b, m, splits):
    """The main rollout (B=256) and the MBRL rollout (B=32), LLAMA_BASE's
    12 heads in one block: B=256 fills the card with rows alone (no
    merge), B=32 with 4 splits a row (128 blocks, one an SM)."""
    assert tda.decode_splits(b, 12, m) == splits
    blocks = b * tda.head_groups(12) * splits
    assert 0.9 * SMS <= blocks and (splits == 1 or blocks <= SMS), blocks


@pytest.mark.parametrize("b", [1, 2, 3])
def test_small_batches_split_down_to_single_runs(b):
    """At B <= 3 the card has room for a split of every 16-slot run."""
    assert tda.decode_splits(b, 12, 684) == 43
    assert tda.split_len(684, 43) == tda.K3_SPLIT_SLOTS


@pytest.mark.parametrize("m", [1, 15, 16, 17, 256, 684, 752, 4096])
def test_every_plan_covers_the_cache(m):
    runs = -(-m // tda.K3_SPLIT_SLOTS)
    for b in (1, 2, 3, 31, 32, 33, 128, 256, 257, 1024):
        for h in (1, 5, 12, 13, 16, 24):
            splits = tda.decode_splits(b, h, m)
            per = tda.split_len(m, splits)
            assert 1 <= splits <= runs
            assert per % tda.K3_SPLIT_SLOTS == 0
            assert splits * per >= m          # every slot in a split
            assert (splits - 1) * per < m     # none empty at valid = m
            assert b * tda.head_groups(h) * splits <= max(SMS, b * 2)
            assert tda.decode_splits(b, h, m, sms=SMS) == splits


def test_head_groups_hold_at_most_the_kernels_heads():
    hs = (1, 12, 13, 16, 24, 25)
    assert [tda.head_groups(h) for h in hs] == [1, 1, 2, 2, 2, 3]
