"""The yardstick's counts against hand counts at tiny shapes."""

import pytest

from benchmark import roofline as rf
from benchmark.tests import tiny

TINY_TOK = {"in_channels": 3, "out_channels": 3, "block_out_channels": [8],
            "layers_per_block": 1, "latent_channels": 4,
            "num_vq_embeddings": 16, "num_dyn_embeddings": 16,
            "norm_num_groups": 4, "vq_embed_dim": None,
            "mid_block_add_attention": False, "context_length": 2,
            "max_att_resolution": 16, "resolution": 8, "patch_size": 4,
            "cross_attn_heads": 2}


def test_k3_call():
    nbytes, flops = rf.k3_call(B=2, H=2, Hkv=2, hd=64, valid=10)
    # int8 K and V, bf16 scales: 2 * 10 * 2 * (64 + 64 + 2 + 2); q, out bf16
    assert nbytes == 2 * 10 * 2 * 132 + 2 * (2 * 2 * 64 * 2)
    assert flops == 2 * (2 * 2 * 2 * 10 * 64)


def test_decode_steps_of_a_rollout():
    dims = {"ctx_tokens": 256, "dyn_tokens": 16}
    lens = rf.decode_valid_lengths(2, 5, dims)
    # frame 0: 16 steps after the prefill's 514 slots; frames 1, 2: an sdf
    # step then 16 and 15 token steps
    assert lens[:2] == [515, 516] and lens[15] == 530
    assert lens[16] == 531 and lens[17] == 532
    assert len(lens) == 2 + 3 * 16 - 1 and lens[-1] == 563
    full = rf.decode_valid_lengths(2, 16, dims)
    assert len(full) == 236   # the rollout's 2832 K3 launches / 12 layers


def test_flash_calls():
    c = rf.flash_calls(B=1, S=4, H=1, hd=64)
    t, row, pairs = 4 * 64 * 2, 4 * 4, 10
    assert c["fwd"] == (4 * t + row, 2 * 2 * 64 * pairs)
    assert c["bwd_dkv"] == (6 * t + 2 * row, 4 * 2 * 64 * pairs)
    assert c["bwd_dq"] == (5 * t + 2 * row, 3 * 2 * 64 * pairs)
    assert rf.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert rf.bound_s(0, 989e12) == pytest.approx(1.0)


def test_lm_flops():
    m = tiny.config()["transformer"]
    per_layer = 4 * 128 * 128 + 3 * 128 * 256
    assert rf.lm_matmul_params(m) == 2 * per_layer
    got = rf.lm_forward_flops(m, B=1, S=3, unembedded=3)
    assert got == 2 * 2 * per_layer * 3 + 4 * 128 * 6 * 2 \
        + 2 * 128 * m["vocab_size"] * 3
    dec = rf.lm_decode_flops(m, B=2, valid=7, unembed=False)
    assert dec == 2 * (2 * 2 * per_layer + 4 * 128 * 7 * 2)


def test_tokenizer_flops_by_hand():
    # conv_in 3->8, one resnet (two 3x3 8->8), a mid block of two resnets,
    # conv_out 8->4, quant_conv 1x1 4->4, all at 8x8, a frame
    hw = 64
    frame = (2 * 8 * 3 * 9 + 6 * 2 * 8 * 8 * 9 + 2 * 4 * 8 * 9
             + 2 * 4 * 4) * hw
    assert rf.encode_context_flops(TINY_TOK, 2) == 2 * frame


def test_vq_flops():
    assert rf.vq_flops(TINY_TOK, 3, 5) == 2 * 4 * (3 * 16 + 5 * 16)
