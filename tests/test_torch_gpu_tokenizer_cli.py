"""The tokenizer trainer CLI on the card against the CPU.

Marked ``gpu``; the test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_tokenizer_cli.py

Eight fp32 micro-steps (``--mixed_precision no``: IEEE fp32 with TF32
off) of a narrow tokenizer on 32 px synthetic episodes, random weights from
the seed, one loader worker, ``--disc_start`` past the run and LPIPS logged
but out of the loss, as the CPU test against the JAX CLI runs it
(tests/test_torch_train_tokenizer.py: with LPIPS in the loss the
trajectories are chaotic under fp32 rounding): the generator's losses at
every log point on the card within 1e-4 relative of the CPU's, with K1
launched twice a generator step on the card.
"""

import json

import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch import train_tokenizer as tt
from ivideogpt_tpu_torch.ops import vq

pytestmark = pytest.mark.gpu

CFG = {"block_out_channels": [8, 16], "layers_per_block": 1,
       "latent_channels": 8, "num_vq_embeddings": 32,
       "num_dyn_embeddings": 32, "norm_num_groups": 4,
       "mid_block_add_attention": False, "context_length": 1,
       "max_att_resolution": 16, "resolution": 32, "cross_attn_heads": 2,
       "cross_attn_dropout": 0.0}
LOSSES = ("gen_loss", "recon_loss", "ref_recon_loss", "perceptual_loss",
          "ref_perceptual_loss", "commit_loss", "dyn_commit_loss")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _run(root, device):
    out = root / device
    tt.main(["--model_config", str(root / "cfg.json"), "--resolution", "32",
             "--context_length", "1", "--segment_length", "3",
             "--batch_size", "2", "--dataset_name", "debug",
             "--dataset_path", str(root / "data"),
             "--dataloader_num_workers", "1", "--max_train_steps", "8",
             "--log_steps", "2", "--log_image_steps", "0",
             "--validation_steps", "100000", "--checkpointing_steps",
             "100000", "--disc_start", "1000", "--perc_weight", "0",
             "--mixed_precision", "no", "--learning_rate", "1e-4",
             "--lr_warmup_steps", "0", "--seed", "5", "--output_dir",
             str(out), "--device", device])
    with open(out / "metrics.jsonl") as f:
        return {m["step"]: m for m in map(json.loads, f)}


def test_fp32_cli_steps_on_the_card_follow_the_cpu(cuda, tmp_path):
    data = tmp_path / "data" / "cmu_stretch"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        np.savez(data / f"episode_{i:03d}.npz",
                 image=rng.integers(0, 256, (10, 32, 32, 3), dtype=np.uint8))
    (tmp_path / "cfg.json").write_text(json.dumps(CFG))
    before = vq.vq_argmin.launches
    card = _run(tmp_path, "cuda")
    # four generator steps, two lookups each
    assert vq.vq_argmin.launches - before == 8
    cpu = _run(tmp_path, "cpu")
    assert sorted(card) == sorted(cpu) == [2, 4, 6, 8]
    for step, m in cpu.items():
        for key in LOSSES:
            np.testing.assert_allclose(card[step][key], m[key], rtol=1e-4,
                                       atol=2e-6, err_msg=f"{key}@{step}")
