"""The MBRL world model's rollout on the card: its dispatch never waits for
the card, so rollouts can be pipelined as MBPO's ``generate`` does (the
next one dispatched before the previous one is fetched), and a pipelined
rollout gives what the same rollout gives on its own.

Marked ``gpu``; the test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_*.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_pipelined_rollouts_do_not_wait_and_match_serial_ones(cuda):
    """Two rollouts dispatched back to back under the sync debug mode
    "error" (any call that waits for the card raises), then fetched: bit
    equal to the same two run one after the other. TOKENIZER_64, LLAMA_BASE
    widths at 2 layers, bf16 over fp32 masters, int8 cache, the DrQ-v2
    policy inside; B=4, horizon 3."""
    from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                             ActionModelConfig)
    from ivideogpt_tpu_torch.mbrl import drqv2
    from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
    B, H, K, A = 4, 3, 3, 4
    head = ActionModelConfig(action_dim=A, context_length=2,
                             segment_length=2 + H, reward_prediction=True)
    vp = VideoPredictor(TOKENIZER_64, LLAMA_BASE.replace(num_hidden_layers=2),
                        head, seed=0)
    policy = drqv2.build_policy((64, 64, 3 * K), A, seed=1)
    rng = np.random.default_rng(2)
    obs = [rng.integers(0, 256, (B, 64, 64, 3 * K)).astype(np.uint8)
           for _ in range(2)]

    def dispatch(i, generator):
        return vp.rollout_async(obs[i], drqv2.batched_policy, policy, H,
                                frame_stack=K, generator=generator)

    def generators():
        return [torch.Generator(device=cuda).manual_seed(10 + i)
                for i in range(2)]

    serial = [dispatch(i, g).fetch() for i, g in enumerate(generators())]
    gens = generators()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = [dispatch(i, g) for i, g in enumerate(gens)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for p, want in zip(pending, serial):
        for got, w in zip(p.fetch(), want):
            np.testing.assert_array_equal(got, w)
