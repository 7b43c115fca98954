"""The inference entry points on the card, from a hub the port writes itself
(TOKENIZER_64's geometry at toy widths, a 2-layer LLaMA of head dim 64, so
the kernels take it):
- the VP2 predictor's dispatch of a chunk never waits for the card, and
  the window of renders kept on the card changes no pixel;
- predict's fp32 ids on the card equal the CPU's, and its teacher-forced
  logits agree with the CPU's;
- the ctx=1 rollout from the re-sliced hub tokenizer launches K1 once, K4
  once a layer and K3 once a layer a decode step (the graph's replays
  counted as they run), the LM step captured once and replayed after;
- generate's CUDA graph of the LM step gives the eager loop's tokens,
  rewards and frame callbacks bit for bit, over an int8 and a mixed cache
  with ``action`` and with ``action_fn``, captures once and replays every
  later step, and holds the eager loop's peak memory within 64 MiB.

Marked ``gpu``; each test decides inside itself whether a card is present
and skips when there is none. Imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_*.py
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tiny_hub(root, action_dim=4):
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch.configs import (CompressiveVQConfig,
                                             TransformerConfig)
    from ivideogpt_tpu_torch.utils import checkpoint as ckpt
    tok_cfg = CompressiveVQConfig(
        block_out_channels=(16, 32, 32), layers_per_block=1,
        latent_channels=8, num_vq_embeddings=64, num_dyn_embeddings=64,
        norm_num_groups=8, context_length=2, resolution=64,
        max_att_resolution=8)
    lm_cfg = TransformerConfig(
        vocab_size=tok_cfg.vocab_size, hidden_size=128,
        intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
        num_key_value_heads=2)
    tok, lm = ro.build_models(tok_cfg, lm_cfg, action_dim=action_dim,
                              dtype=torch.float32, seed=0, device="cpu")
    with torch.no_grad():
        lm.action_linear.weight.normal_(
            0, 0.02, generator=torch.Generator().manual_seed(1))
    return ckpt.export_hub(str(root), tok, lm)


def test_vp2_dispatch_does_not_wait_and_the_window_changes_nothing(
        cuda, tmp_path):
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    from ivideogpt_tpu_torch.vp.interface import IVideoGPTPredictor
    hub = _tiny_hub(tmp_path / "hub", action_dim=5)
    rng = np.random.default_rng(2)
    batch = {"video": np.repeat(rng.uniform(0, 1, (1, 2, 64, 64, 3))
                                .astype(np.float32), 7, axis=0),
             "actions": rng.uniform(-1, 1, (7, 10, 5)).astype(np.float32)}

    def predictor(window):
        return IVideoGPTPredictor(
            pretrained_vqgan_name_or_path=os.path.join(hub, "tokenizer"),
            pretrained_transformer_path=os.path.join(hub, "transformer"),
            action_dim=5, top_k=10, seed=1, generate_max_batchsize=3,
            decode_max_batchsize=2, max_pending_chunks=window)

    out = predictor(1)(batch)["rgb"]
    assert out.shape == (7, 11, 64, 64, 3) and np.isfinite(out).all()
    wide = predictor(4)
    np.testing.assert_array_equal(wide(batch)["rgb"], out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode(), full_fp32():
            renders = wide._dispatch_chunk(batch["video"][:3],
                                           batch["actions"][:3])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [r.host.is_pinned() for r in renders] == [True, True]
    assert np.isfinite(np.concatenate([wide._fetch(r) for r in renders])
                       ).all()


def test_predict_on_the_card_matches_the_cpu(cuda, tmp_path):
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch.inference import predict as pr
    from ivideogpt_tpu_torch.inference.utils import NPZParser
    hub = _tiny_hub(tmp_path / "hub")
    args = SimpleNamespace(
        pretrained_model_name_or_path=hub, context_length=2,
        segment_length=8, action_conditioned=True, action_dim=4,
        repeat_times=2, top_k=10, temperature=1.0, seed=0, device="cuda")
    pixels, actions = NPZParser(8, 64).parse(
        os.path.join(REPO, "inference", "samples", "synthetic_sample.npz"),
        "bair", load_action=True)
    tok, model = pr.load_models(args)
    res = pr.predict(args, tok, model, pixels, actions)
    assert res.frames.shape == (2, 8, 64, 64, 3)
    assert np.isfinite(res.frames).all()
    tok_cpu, model_cpu = pr.load_models(SimpleNamespace(**dict(
        vars(args), device="cpu")))
    px = torch.from_numpy(pixels)[None]
    act = torch.from_numpy(actions)[None].repeat(2, 1, 1)
    with torch.inference_mode():
        ids, _ = tok.tokenize(px.to(cuda), 2)
        ids_cpu, _ = tok_cpu.tokenize(px, 2)
        logits = generation.replay_logits(
            model, res.tokens, segment_length=8, context_length=2,
            action=act.to(cuda)).cpu()
        ref = generation.replay_logits(
            model_cpu, res.tokens.cpu(), segment_length=8, context_length=2,
            action=act)
    torch.testing.assert_close(ids.cpu(), ids_cpu, rtol=0, atol=0)
    # fp32 both sides, TF32 off; the bf16 cache rounds k/v that differ in
    # their last bits: the check phase's tolerance
    assert float((logits - ref).abs().max()) < 2e-2


def test_ctx1_rollout_from_the_hub_launches(cuda, tmp_path):
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch.ops import decode_attention as da
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import vq
    hub = _tiny_hub(tmp_path / "hub")
    T = 6
    tok, lm = ro.load_hub_models(hub, context_length=1, segment_length=T)
    assert tok.config.context_length == 1
    g = torch.Generator(device=cuda).manual_seed(3)
    px = torch.rand(3, 1, 64, 64, 3, device=cuda, generator=g)
    gen = generation.generate
    before = (vq.vq_argmin.launches, fa.flash_fwd.launches,
              da.decode_attention.launches, gen.graph_captures,
              gen.graph_replays, gen.eager_lm_steps)
    res = ro.rollout(tok, lm, px, torch.randn(3, T, 4, device=cuda,
                                              generator=g),
                     segment_length=T, generator=g)
    after = (vq.vq_argmin.launches, fa.flash_fwd.launches,
             da.decode_attention.launches, gen.graph_captures,
             gen.graph_replays, gen.eager_lm_steps)
    decodes = (T - 1) * 16 - 1 + (T - 2)
    assert [a - b for a, b in zip(after, before)] == [
        1, 2, 2 * decodes, 1, decodes - 1, 1]
    assert res.tokens.shape == (3, 256 + 17 * (T - 1))
    assert torch.isfinite(res.frames).all()


def _graph_lm(cuda):
    """A 2-layer bf16 LM of head dim 64 (K3's) with the action and reward
    heads, at TOKENIZER_64's token geometry over 64 + 64 codes."""
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch.configs import (ActionModelConfig,
                                             TransformerConfig)
    from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
    lm_cfg = TransformerConfig(
        vocab_size=64 + 64 + 2, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2)
    torch.manual_seed(0)
    lm = HeadModelWithAction(lm_cfg, ActionModelConfig(reward_prediction=True),
                             torch.bfloat16)
    with torch.no_grad():
        lm.action_linear.weight.normal_(0, 0.5)
    return generation.cast_matmul_params(lm).to(cuda).eval()


@pytest.mark.parametrize("cache,by,B,T,rewards", [
    (torch.int8, "action", 256, 16, False),
    (torch.int8, "action_fn", 16, 6, True),
    ("mixed", "action", 16, 6, True),
    ("mixed", "action_fn", 256, 16, True)])
def test_graphed_generate_matches_the_eager_loop(cuda, monkeypatch, cache,
                                                 by, B, T, rewards):
    from ivideogpt_tpu_torch import generation, tokens
    from ivideogpt_tpu_torch.ops import decode_attention as da
    lm = _graph_lm(cuda)
    g = torch.Generator(device=cuda).manual_seed(B + T)
    prelude = tokens.make_prelude(
        torch.randint(0, 64, (B, 2, 256), device=cuda, generator=g), 64, 64)
    action = torch.randn(B, T, 4, device=cuda, generator=g)
    F = T - 2
    # the rollout's 236 at B=256, T=16; the last token is decoded only
    # for its reward, the first sdf on its own step only with action_fn
    steps = F * 16 - 1 + (F - 1) + rewards + (by == "action_fn")

    def run():
        frames = []
        kw = ({"action": action} if by == "action" else
              {"action_fn": lambda f: torch.tanh(action[:, 1 + f])})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k3 = (da.decode_attention.launches, da.decode_attention.mixed_launches)
        res = generation.generate(
            lm, prelude, segment_length=T, context_length=2,
            generator=torch.Generator(device=cuda).manual_seed(7),
            on_frame=lambda f, toks, r: frames.append(
                (toks.clone(), None if r is None else r.clone())),
            reward_prediction=rewards, cache_dtype=cache, **kw)
        torch.cuda.synchronize()
        k3 = (da.decode_attention.launches - k3[0],
              da.decode_attention.mixed_launches - k3[1])
        return res, frames, torch.cuda.max_memory_allocated() - base, k3

    run()    # the side stream's first use (its cuBLAS workspace)
    gen = generation.generate
    before = (gen.graph_captures, gen.graph_replays, gen.eager_lm_steps)
    graphed, graphed_frames, graphed_peak, graphed_k3 = run()
    assert (gen.graph_captures, gen.graph_replays, gen.eager_lm_steps) == (
        before[0] + 1, before[1] + steps - 1, before[2] + 1)
    monkeypatch.setattr(generation, "_graphed", lambda *a: False)
    eager, eager_frames, eager_peak, eager_k3 = run()
    # K3 once a layer a step, the replays' launches counted as they run
    assert graphed_k3 == eager_k3 == ((2 * steps, 0) if cache == torch.int8
                                      else (0, 2 * steps))
    assert gen.eager_lm_steps == before[2] + 1 + steps
    assert gen.graph_replays == before[1] + steps - 1
    assert torch.equal(graphed.tokens, eager.tokens)
    assert (graphed.rewards is eager.rewards is None if not rewards
            else torch.equal(graphed.rewards, eager.rewards))
    assert len(graphed_frames) == len(eager_frames) == F
    for (gt, gr), (et, er) in zip(graphed_frames, eager_frames):
        assert torch.equal(gt, et)
        assert gr is er is None if not rewards else torch.equal(gr, er)
    assert abs(graphed_peak - eager_peak) <= 64 * 2 ** 20, (graphed_peak,
                                                            eager_peak)


def test_graphed_generate_keeps_reserved_memory_flat(cuda):
    """The graphs of successive generate calls share the device's kept
    pool, so the card's reserved memory stays flat call on call (a graph's
    own pool would stay reserved after the call until the cache is
    emptied)."""
    from ivideogpt_tpu_torch import generation, tokens
    lm = _graph_lm(cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    B, T = 64, 6
    prelude = tokens.make_prelude(
        torch.randint(0, 64, (B, 2, 256), device=cuda, generator=g), 64, 64)
    action = torch.randn(B, T, 4, device=cuda, generator=g)
    reserved, captures = [], generation.generate.graph_captures
    for seed in range(5):
        generation.generate(
            lm, prelude, segment_length=T, context_length=2,
            generator=torch.Generator(device=cuda).manual_seed(seed),
            action=action, cache_dtype=torch.int8)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert generation.generate.graph_captures == captures + 5
    assert reserved[1:] == [reserved[1]] * 4, reserved
