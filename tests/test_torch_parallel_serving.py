"""The port's sharded serving and its collectives on the CPU: 2 ranks over
gloo (``tests/torch_parallel_worker.py``).

- ``sharded_generate`` at DP=2: fp32 ids equal to one process's, bit for
  bit (each rank samples its rows from the global batch's uniforms); at
  TP=2 the token contract of ``tests/test_sharded_generation.py`` (shape,
  id range, the forced sdf at every frame boundary) and the same ids on
  both ranks; a batch the data axis does not divide raises;
- ``sharded_rollout`` end to end at DP=2 (tokens and frames equal to one
  process's rollout of the same rows) and at TP=2, also where
  max_att_resolution is not the latent resolution (tokens_per_dyna from
  the latent geometry);
- the collectives: a gather of uneven row counts, ``params_to_host`` of a
  TP=2 model, rank 0's timestamp, the gradient mean, and a failed init
  that raises.
"""

import datetime

import numpy as np
import pytest
import torch

from ivideogpt_tpu_torch import generation, tokens
from ivideogpt_tpu_torch.configs import (ActionModelConfig,
                                         CompressiveVQConfig,
                                         TransformerConfig)
from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
from ivideogpt_tpu_torch.parallel import distributed as dl
from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
from ivideogpt_tpu_torch.parallel import serving
from ivideogpt_tpu_torch.rollout import detokenize
from tests import torch_parallel_worker as W

TINY_TOK = CompressiveVQConfig(
    block_out_channels=(16, 32, 32), layers_per_block=1, latent_channels=8,
    num_vq_embeddings=64, num_dyn_embeddings=64, norm_num_groups=8,
    mid_block_add_attention=False, context_length=2, resolution=32,
    max_att_resolution=8, patch_size=4)
B = 8


def _lm_inputs():
    torch.manual_seed(0)
    model = W.lm_model()
    with torch.no_grad():
        model.action_linear.weight.normal_(0, 0.1)
    rng = np.random.default_rng(0)
    P1 = tokens.prelude_len(W.CTX, ctx_tokens=W.NCTX) + 1
    prelude = torch.from_numpy(rng.integers(0, 64, (B, P1)))
    action = torch.from_numpy(rng.normal(size=(B, W.T, W.ACTION_DIM))
                              .astype(np.float32))
    return model.eval(), prelude, action


def _one_process_tokens(model, prelude, action):
    return generation.generate(
        model, prelude, segment_length=W.T, context_length=W.CTX,
        generator=torch.Generator().manual_seed(11), action=action,
        tokens_per_dyna=W.NDYN, top_k=5, cache_dtype=torch.float32).tokens


@pytest.mark.parametrize("n_model", [1, 2], ids=["dp2", "tp2"])
def test_sharded_generate(tmp_path, n_model):
    model, prelude, action = _lm_inputs()
    ranks = W.run_ranks("generate", 2, tmp_path, {
        "state_dict": model.state_dict(), "prelude": prelude,
        "action": action, "seed": 11, "n_model": n_model})
    want = _one_process_tokens(model, prelude, action)
    if n_model == 1:
        got = torch.cat([r["tokens"] for r in ranks])
        assert [r["rows"] for r in ranks] == [slice(0, 4), slice(4, 8)]
        assert torch.equal(got, want)
        assert all("not divisible" in r["error"] for r in ranks)
        return
    assert torch.equal(ranks[0]["tokens"], ranks[1]["tokens"])
    out = ranks[0]["tokens"].numpy()
    P1, D, vocab = prelude.shape[1], W.NDYN, W.LM["vocab_size"]
    assert out.shape == (B, tokens.seq_len(W.CTX, W.T, ctx_tokens=W.NCTX,
                                           dyn_tokens=D))
    assert out.min() >= 0 and out.max() < vocab
    for f in range(1, W.T - W.CTX):
        assert (out[:, P1 + f * (D + 1) - 1] == vocab - 1).all()
    assert (out[:, :P1] == prelude.numpy()).all()


def _rollout_run(tok_cfg, n_model, seed):
    torch.manual_seed(seed)
    tok = CompressiveVQModel(tok_cfg).eval()
    head = ActionModelConfig(action_dim=2, context_length=2,
                             segment_length=4,
                             tokens_per_context=tok_cfg.ctx_tokens_per_frame,
                             tokens_per_dyna=tok_cfg.dyn_tokens_per_frame)
    lm = TransformerConfig(**{**W.LM, "vocab_size": tok_cfg.vocab_size,
                              "max_position_embeddings": 2048})
    model = W.lm_model(lm.to_json(), head.to_json()).eval()
    rng = np.random.default_rng(seed)
    return {"n_model": n_model, "tok_json": tok_cfg.to_json(),
            "tok_sd": tok.state_dict(), "lm_json": lm.to_json(),
            "head_json": head.to_json(), "lm_sd": model.state_dict(),
            "pixels": torch.from_numpy(rng.uniform(0, 1, (B, 2, 32, 32, 3))
                                       .astype(np.float32)),
            "action": torch.from_numpy(rng.normal(size=(B, 4, 2))
                                       .astype(np.float32)),
            "ctx": 2, "T": 4}, tok, model


def test_sharded_rollout_dp_and_tp(tmp_path):
    runs = [_rollout_run(TINY_TOK, 1, 0),
            _rollout_run(TINY_TOK.replace(max_att_resolution=4), 1, 1),
            _rollout_run(TINY_TOK, 2, 2)]
    assert runs[1][1].config.max_att_resolution != \
        runs[1][1].config.latent_resolution
    ranks = W.run_ranks("rollout", 2, tmp_path, {"runs": [r[0] for r in runs]})
    for i, (run, tok, model) in enumerate(runs):
        cfg = tok.config
        L = tokens.seq_len(2, 4, ctx_tokens=cfg.ctx_tokens_per_frame,
                           dyn_tokens=cfg.dyn_tokens_per_frame)
        for r in ranks:
            assert r[i]["tokens"].shape == ((B // 2 if i < 2 else B), L)
            assert r[i]["frames"].shape == ((B // 2 if i < 2 else B), 4, 32,
                                            32, 3)
            assert torch.isfinite(r[i]["frames"]).all()
        if i == 2:
            assert torch.equal(ranks[0][i]["tokens"], ranks[1][i]["tokens"])
            continue
        # DP: one process's rollout of the whole batch, row for row
        with torch.inference_mode():
            prelude = tokens.make_prelude(
                tok.encode_context(run["pixels"]), cfg.num_vq_embeddings,
                cfg.num_dyn_embeddings)
            want = generation.generate(
                model, prelude, segment_length=4, context_length=2,
                generator=torch.Generator().manual_seed(4),
                action=run["action"],
                tokens_per_dyna=cfg.dyn_tokens_per_frame, top_k=5,
                cache_dtype=torch.float32).tokens
            frames = detokenize(tok, want, 2)
        got = torch.cat([r[i]["tokens"] for r in ranks])
        assert torch.equal(got, want)
        np.testing.assert_allclose(
            torch.cat([r[i]["frames"] for r in ranks]).numpy(),
            frames.numpy(), rtol=1e-5, atol=1e-5)


def test_batch_not_divisible_by_the_data_axis_raises():
    two = mesh_lib.Mesh(n_data=2, n_model=1, data_rank=0, model_rank=0)
    with pytest.raises(ValueError, match="not divisible"):
        serving._check_batch(7, two)
    model, prelude, action = _lm_inputs()
    with pytest.raises(ValueError, match="not divisible"):
        serving.sharded_generate(model, prelude[:5], mesh=two,
                                 generator=torch.Generator(),
                                 action=action[:5], segment_length=W.T,
                                 context_length=W.CTX)


def test_collectives(tmp_path):
    model = W.lm_model()
    ranks = W.run_ranks("util", 2, tmp_path, {
        "state_dict": model.state_dict(), "n_model": 2})
    rows = np.concatenate([np.full((1, 3), 0.0), np.full((2, 3), 1.0)])
    for r in ranks:
        np.testing.assert_array_equal(r["gathered"], rows.astype(np.float32))
        assert torch.equal(r["t_gathered"],
                           torch.cat([torch.arange(1), torch.arange(3)]))
        for k, v in model.state_dict().items():
            assert torch.equal(r["host"][k], v), k
        assert torch.equal(r["grads"][0], torch.full((3,), 0.5))
        assert r["grads"][1].dtype == torch.float64
        assert torch.equal(r["grads"][1], torch.full((2,), 1.0,
                                                     dtype=torch.float64))
        assert r["count"] == 2
    assert ranks[0]["stamp"] == ranks[1]["stamp"]
    assert ranks[1]["local_stamp"] - ranks[1]["stamp"] > 1.0
    assert [r["main"] for r in ranks] == [True, False]


def test_failed_init_raises_and_no_configuration_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert dl.maybe_initialize(device="cpu") is False
    assert dl.process_count() == 1 and dl.is_main_process()
    one = mesh_lib.make_mesh()
    assert (one.shape, one.size, one.data_group) == (
        {"data": 1, "model": 1}, 1, None)
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(n_data=2)
    with pytest.raises(ValueError, match="tensor-parallel groups"):
        mesh_lib.make_global_mesh(2)
    # auto-detection that cannot reach its rendezvous raises (the JAX
    # package would go on as one process)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(W.free_port()))
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(Exception):
        dl.maybe_initialize(device="cpu",
                            timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="num_processes"):
        dl.maybe_initialize("127.0.0.1:1", device="cpu")
