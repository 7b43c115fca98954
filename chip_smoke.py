#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py
    python3 <path to>/chip_smoke.py --ab-turn   # one A/B turn, see ab_turn
    python3 chip_smoke.py --vq-routing   # K1 against K2, see vq_routing
    python3 chip_smoke.py --k3-splits    # K3's split counts, see k3_splits

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:
  1. card      the nvidia-smi name and power limit
  2. build     nvcc for sm_90a of every csrc/*.cu, all at once (-Xptxas -v)
  3. K1        VQ argmin at every shape of the main paths (N=131072, 8192,
               3584, 1536, 16384, 1280, 2560, the inference entry
               points' 512, 224 and 65536, the tokenizer CLI's 4096, 1792,
               1024 and 192, the BAIR evaluation's 20480 and 19200;
               K=8192, D=64 fp32) against the
               plain version
               (TF32 off) and K2 (bit for bit), ties across a codebook
               split; timed beside K2, the plain version, cdist+argmin
     K2        the tiled VQ argmin at the wide training step's shapes
               (N=8192 and 1536, K=16384, D=256) and the rollout's (there
               against K1 bit for bit and timed beside it), two launches
               bit-identical, ties across a codebook split; timed beside
               the plain version and cdist+argmin
  4. K3        int8 decode attention, H=12, hd=64, at B=256, M=752 for
               valid in {515, 633, 751}, at the MBRL rollout's B=32,
               M=684 for valid in {514, 599, 683} and at the ctx=1
               rollout's B=256, M=512 for valid in {258, 384, 510}, against
               the plain
               version, two launches bit-identical, valid on the card
               bit-equal to the host int, one CUDA graph a shape replayed
               at two lengths; its split plan; timed against a cold L2
  5. flash     K4 (causal flash-attention forward) at the training shape
               (B=16, H=12, S=751), the prefill shape (B=256, S=514), the
               MBRL train() shape (B=16, S=683), the MBRL prefill (B=32,
               S=513), the ctx=1 prefill (B=256, S=257) and the BAIR
               evaluation's loss (B=80, S=511) and prefill (B=80, S=257),
               K5 (dK, dV) and
               K6 (dQ) at both training shapes, bf16, against the
               plain version and autograd through it; K4's lse against
               flash_fwd_plain's, K5 and K6 fed the plain lse against
               flash_bwd_dkv_plain and flash_bwd_dq_plain and bit-identical
               across two launches; the fp32 K4 at predict's prefill (B=5,
               S=514) and VP2's (B=100, S=514) against the plain version in
               fp32; SDPA timed beside them, each kernel's ratio to it
               printed
     flash_dropout  K4, K5 and K6 with attention dropout 0.1: each kernel's
               mask read back equal to the plain Philox mask at B=16,
               S=751, H=12; bf16 at that shape and at H=16 against the
               plain versions with the same (seed, offset), p=0 bit-equal to
               no dropout, the fp32 kernels with dropout at B=2 and without
               at the training shape; timed with and without dropout beside
               SDPA with dropout_p=0.1 (bf16) and SDPA fp32
  6. main      the rollout (TOKENIZER_64 + LLAMA_BASE + action head, bf16
               under the cast rules, int8 KV cache, ctx=2, T=16, B=256) with
               random weights from a seed: shapes, token ranges, launch
               counts (K3: exactly 2832 a rollout, K4: 12), frames/s
  7. check     a B=2 fp32 rollout on the GPU held against the plain CPU path
               on the same stream: context ids, teacher-forced logits, frames
  8. train     the GPT training step (frozen tokenize -> LLAMA_BASE forward/
               backward -> clipped AdamW), bf16 over fp32 masters, B=16,
               L=751: 3 warm-up and 10 timed steps on one batch, a falling
               finite loss, launches a step (K1 2, K4/K5/K6 12), ms/step,
               tokens/s, peak memory, one profiled step
  9. train check  one fp32 forward/backward at B=2 (LLAMA_BASE widths, 2
               layers) on the GPU held against the CPU's plain path: loss,
               grad norm, every gradient
 10. tok_train the tokenizer (VQGAN) training step: TOKENIZER_64, the
               discriminator and LPIPS, bf16 over fp32 masters, B=16, T=8,
               GAN on: 3 warm-up and 10 timed G+D pairs on one batch, a
               falling finite recon loss, launches a pair (K1 4), G and D
               ms/step, frames/s, peak memory, FLOP, one profiled pair
 11. tok_train_wide  the same step with 16384 x 256 codebooks: 1 warm-up
               and 3 timed pairs, launches a pair (K2 4, K1 0), ms/step
 12. tok_train check  one fp32 G step and D step at B=4 (full widths,
               discriminator depth 4, the training CLI's) on the card held
               against the CPU's plain path: losses, the adaptive weight,
               grad norms, every gradient, the updated u
 13. mbrl      the MBRL world model (mbrl/video_predictor.py): TOKENIZER_64 +
               LLAMA_BASE + the action and reward heads, bf16 over fp32
               masters, int8 KV cache; B=32 frame stacks of 3, horizon 10,
               the DrQ-v2 policy inside: shapes, action and reward ranges,
               launches a rollout (K1 1, K4 12, K3 2040), imagined frames/s
               over 3 pipelined rollouts, one profiled rollout by part
 14. mbrl check  a B=2 fp32 rollout with replayed actions held against the
               CPU's plain path on its own stream: context ids, teacher-
               forced logits, rewards, frames
 15. mbrl train  train() at B=16, T=12, 5 target frames, frozen codebooks:
               1 warm-up and 3 timed calls, finite losses, codebooks bit-
               unchanged, launches a call (K1 4, K4/K5/K6 12), ms a call
 16. mbrl train check  one fp32 train() call at B=2 (tokenizer at full
               width, LLAMA_BASE widths at 2 layers) on the card and the CPU:
               metrics, grad norms, the updates' signs, frozen codebooks
 17. hub       TOKENIZER_64 + LLAMA_BASE with the action head, fp32, random
               weights from a seed, written by the port's own safetensors
               writer as a hub (the tokenizer, an action-conditioned
               transformer, a bare LLaMA, and VP2's transformer with
               action_dim 5) in a temporary directory under outputs/, read
               back bit-equal
 18. predict   inference/predict.py's path: load_models from that hub onto
               the card, predict on inference/samples/synthetic_sample.npz
               (ctx 2, seg 16, repeat_times 5, top-k 100, action-
               conditioned): launches a call (K1 2, K4 12 fp32, K3 0), fp32
               ids bit-equal to the CPU's, teacher-forced logits against
               the CPU, frames finite in [0, 1], seconds a call
 19. rollout_ctx1  the BAIR protocol: the hub's tokenizer re-sliced to
               ctx=1, bf16 under the cast rules, the B=256, T=16 int8-cache
               rollout: launches (K1 1, K4 12, K3 3036), frames/s, the stage
               split
 20. vp2       the VP2 predictor from the hub with the yaml's chunks (100 to
               generate, 67 to decode), a CEM population of 200 sharing one
               context, actions [200, 10, 5]: launches a query (K1 and 12 K4
               a chunk, K3 0), rgb [200, 11, 64, 64, 3] finite in [0, 1],
               seconds a query, peak memory
 21. train_gpt the trainer CLI (ivideogpt_tpu_torch/train_gpt.py) in-process
               with the BAIR finetune recipe's LM flags (bf16, attention
               dropout 0.1, action-conditioned, --load_internal_llm from
               the hub's bare LLaMA, B=16, ctx 2, seg 16, --use_eval_dataset
               --use_fvd --use_frame_metrics) on 64 synthetic BAIR
               episodes registered in the hub dir's DATASET.yaml: 15 steps with a checkpoint and a validation with
               generation, a resume from the latest checkpoint to step 30
               with another of each; launches (K1 2, K4/K5/K6 12 a step,
               dropout keyed by (seed, global step, layer)), the export
               read back, a restored state and its next step bit-equal to
               the live ones; the validations' GIF strips decoded; ms/step,
               samples/s, the loader's wait, the validations' seconds, peak
               memory, the stage split, and 10 steps without dropout
 22. eval_gpt  the trainer CLI's --eval_only in-process with the BAIR
               evaluation recipe's flags (bf16, LLAMA_BASE, ctx 1, seg 16,
               action-conditioned, --use_fvd --use_frame_metrics,
               --eval_max_batchsize 80) from the hub, cut to 4 samples a
               clip and 2 batches of the synthetic BAIR test split, I3D
               and LPIPS at random weights: every metric finite, FVD
               recomputed and real-vs-real 0 within the eigenvalue floor,
               launches (K1 2 and K4 12 a batch, K4 12 a sample set), I3D
               logits and best-of-t metrics on the card against the CPU;
               wall s split among generate, detokenize, I3D and LPIPS,
               I3D's TFLOP/s, peak memory
 23. train_tokenizer  the tokenizer trainer CLI
               (ivideogpt_tpu_torch/train_tokenizer.py) in-process with the
               BAIR finetune recipe's tokenizer flags (bf16, B=16, ctx 1, seg
               8, --disc_start 1000005, --random_selection, 16 loader
               workers) plus --use_ema, from the hub's tokenizer re-sliced
               to ctx 1, on synthetic episodes: 20 micro-steps with a
               validation and a checkpoint, a resume to 40 with another of
               each; K1 2 a G, D and eval step; the PNG grids decoded; the
               export equal to the EMA copy; a restored state and its next
               G step, EMA update and D step bit-equal to the live ones;
               then 10 steps with the depth-4 discriminator on; ms/step,
               samples/s, the loader's wait, the validations' seconds, peak
               memory
 24. train_tokenizer_256  the oxe-256 recipe's TOKENIZER_256 (310M, remat)
               through the CLI: bf16, B=2, accumulation 4, ctx 2, 24
               micro-steps with the GAN from step 8 on 256 px episodes;
               ms per G and D update, peak memory; one fp32 G step at B=1
               with remat against none (ids bit-equal, gradients within
               1e-5 of their max) and the bf16 B=2 step's peak memory with
               and without remat
 25. train_medium  LLAMA_MEDIUM (24 layers, H=16), act-free, bf16, dropout
               0.1, B=16, L=751: 2 warm-up and 5 timed steps, launches a
               step (K1 2, K4/K5/K6 24), ms/step, tokens/s, peak memory
 26. train_gpt check  the train check's fp32 step at B=2, 2 layers, with
               attention dropout keyed alike on the card and the CPU
Then the launches by path, the kernels' JSON line, the card line again, and
the result line.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CTX, T, B = 2, 16, 256
N_TIMED = 3
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s
SPIN_CYCLES = 200_000_000  # queued_ms's head start: ~0.11 s at 1.755 GHz
TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 16, 3, 10
# attention dropout of every published GPT recipe; the trainer CLI's run:
# 30 steps (a checkpoint and a validation every 15, a resume at 15) on 64
# synthetic episodes of 24 frames; the medium recipe's steps
DROP_P, DROP_SEED = 0.1, 2024
GPT_STEPS, GPT_CKPT, GPT_EPISODES, GPT_FRAMES = 30, 15, 64, 24
# the BAIR evaluation recipe (scripts/evaluation/bair-64-act-cond.sh: ctx 1,
# seg 16, B=80, bf16) cut to 4 samples a clip (100 in the recipe) and 2
# batches: 160 test episodes; the card-vs-CPU checks of its metrics take
# 2 clips
EVAL_B, EVAL_REPS, EVAL_BATCHES, EVAL_CHECK = 80, 4, 2, 2
MEDIUM_WARMUP, MEDIUM_TIMED = 2, 5
TOK_T, TOK_CTX = 8, 2          # the tokenizer trainer's clips (B=TRAIN_B)
# the tokenizer trainer CLI: the BAIR finetune recipe's tokenizer (ctx 1,
# seg 8, B=16) for 40 micro-steps with a checkpoint and a resume at 20,
# then 10 with the discriminator on; the oxe-256 recipe's TOKENIZER_256
# (ctx 2, seg 8, B=2, accumulation 4) for 24 micro-steps, the GAN from
# step 8; 256 px episodes of 16 frames
TT_STEPS, TT_CKPT, TT_GAN_STEPS, TT_EPISODES = 40, 20, 10, 32
TT256_B, TT256_ACC, TT256_STEPS, TT256_DISC_START = 2, 4, 24, 8
TOK_WARMUP, TOK_TIMED = 3, 10
TOK_WIDE_WARMUP, TOK_WIDE_TIMED = 1, 3
# the MBRL world model (MBPO's defaults, bench.py's run_mbrl): imagination
# at gen_batch 32, horizon 10, frame stack 3, ctx 2, segment 12; train()
# at B=16 on 12-frame segments with at most 5 target frames
MB_B, MB_H, MB_K, MB_SEG, MB_A = 32, 10, 3, 12, 4
MB_TRAIN_B, MB_TARGETS, MB_TIMED = 16, 5, 3
MB_P1 = 257 * CTX                       # prelude + first sdf: 514
MB_M = MB_P1 + 17 * MB_H                # the rollout's KV cache: 684 slots
MB_L = MB_P1 - 1 + 17 * (MB_SEG - CTX)  # a train() segment's stream: 683
# K3's shapes: the main rollout's cache (B=256, 752 slots) at three
# lengths of its decode, and the MBRL rollout's (B=32, 684 slots) from the
# first frame's sdf to its last token; the split counts --k3-splits times
# the inference entry points: predict on one clip (fp32, repeat_times 5,
# top-k 100, action-conditioned; its prefill B=5, S=514), the VP2 planner's
# query (fp32, a CEM population of 200 sharing one context, actions
# [200, 10, 5], the yaml's chunks of 100 to generate and 67 to decode) and
# the BAIR protocol's ctx=1 rollout (bf16 under the cast rules, int8 cache,
# B=256, T=16: prefill S=257, 257 + 17 * 15 = 512 cache slots, decodes at
# valid 258 .. 510)
PRED_R, PRED_SAMPLE = 5, "inference/samples/synthetic_sample.npz"
VP2_B, VP2_A, VP2_T, VP2_SEG = 200, 5, 10, 12
VP2_CHUNK, VP2_DECODE = 100, 67
CTX1_P1 = 257
CTX1_M = CTX1_P1 + 17 * (T - 1)
K3_SHAPES = ((B, 752, (515, 633, 751)), (MB_B, MB_M, (MB_P1, 599, MB_M - 1)),
             (B, CTX1_M, (CTX1_P1 + 1, 384, CTX1_M - 2)))
K3_SPLIT_CANDIDATES = {B: (1, 2, 3, 4), MB_B: (1, 2, 3, 4, 5, 6, 8, 11)}
L2_ROTATION_BYTES = 200_000_000  # >= 4 x the H100's 50 MB L2
# K1's lookups on the main paths (K=8192, D=64): the rollout's context
# frames, the context frames of a B=16 GPT step and tokenizer pair, and the
# dynamics frames of the GPT step (16 x 14 x 16) and of the pair (16 x 6 x
# 16); the MBRL rollout's context frames (32 x 2 x 256); train()'s target
# frames (16 x 5 x 16) and its LM step's dynamics frames (16 x 10 x 16), its
# context lookups being the "context" shape; the tokenizer CLI's BAIR
# recipe (B=16, ctx 1: 16 x 256 context and 16 x 7 x 16 dynamics tokens)
# and TOKENIZER_256 at the oxe-256 recipe's B=2 (2 x 2 x 256, 2 x 6 x 16);
# the BAIR evaluation's batch (80 x 256, 80 x 15 x 16)
K1_SHAPES = (("rollout", B * CTX * 256), ("context", TRAIN_B * CTX * 256),
             ("GPT-step dynamics", TRAIN_B * (T - CTX) * 16),
             ("tokenizer dynamics", TRAIN_B * (TOK_T - TOK_CTX) * 16),
             ("mbrl rollout", MB_B * CTX * 256),
             ("mbrl train targets", MB_TRAIN_B * MB_TARGETS * 16),
             ("mbrl train dynamics", MB_TRAIN_B * (MB_SEG - CTX) * 16),
             ("predict and VP2 context", CTX * 256),
             ("predict dynamics", (T - CTX) * 16),
             ("ctx1 rollout", B * 256),
             ("BAIR tokenizer context", TRAIN_B * 1 * 256),
             ("BAIR tokenizer dynamics", TRAIN_B * (TOK_T - 1) * 16),
             ("tokenizer-256 context", TT256_B * 2 * 256),
             ("tokenizer-256 dynamics", TT256_B * (TOK_T - 2) * 16),
             ("BAIR eval context", EVAL_B * 256),
             ("BAIR eval dynamics", EVAL_B * (T - 1) * 16))
# K2's: the wide tokenizer pair's context and dynamics lookups against
# 16384 x 256 codebooks, and the rollout's lookup, which the routing sends
# to K1 (one timed shape on each side of it)
K2_SHAPES = (("context", TRAIN_B * TOK_CTX * 256, 16384, 256),
             ("dynamics", TRAIN_B * (TOK_T - TOK_CTX) * 16, 16384, 256),
             ("rollout", B * CTX * 256, 8192, 64))


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters, warmup=2):
    """(card ms, host ms) a call of fn, over iters calls enqueued behind a
    spin of the card (SPIN_CYCLES): the card's time with none of the host's
    launch cost in it, and the host's own time to issue one call. Where the
    host is slower than the card, cuda_ms reads the host's time instead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spun, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spun.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    spin_ms = spun.elapsed_time(start)
    check(host_ms < spin_ms, f"queued_ms: enqueueing {iters} calls took "
          f"{host_ms:.1f} ms, longer than the card's {spin_ms:.1f} ms spin")
    return start.elapsed_time(end) / iters, host_ms / iters


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_RATE * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def near_tie_gate(torch, what, z, e, ids, ref):
    """Hold ids against ref: they may differ only where the two picks'
    float64 distances are within 1e-5 of the distances' scale (fp32 sums
    in another order), at most N/1000 rows. Returns the largest gap."""
    n = z.shape[0]
    diff = (ids != ref).nonzero()[:, 0]
    z64, e64 = z[diff].double(), e.double()
    d_ours = ((z64 - e64[ids[diff]]) ** 2).sum(1)
    d_ref = ((z64 - e64[ref[diff]]) ** 2).sum(1)
    gap = (d_ours - d_ref).abs()
    scale = (z64 ** 2).sum(1) + (e64[ids[diff]] ** 2).sum(1)
    max_err = float(gap.max()) if len(diff) else 0.0
    print(f"{what}: {n - len(diff)}/{n} equal; {len(diff)} differ, max "
          f"float64 distance gap {max_err:.3e}")
    check(bool((gap < 1e-5 * scale).all()),
          f"{what}: ids differ beyond a near tie")
    check(len(diff) <= n // 1000, f"{what}: {len(diff)} near-tie flips")
    return max_err


def split_ties(torch, what, argmin, z, e, splits, per):
    """Copies of codes 0..255 on both sides of the first split boundary at
    or past index 384 of a plan for z (the middle of the codebook where
    there is one split), so that the copies leave codes 0..255 in place;
    rows of z equal to codes 0..255 must resolve to them, the smallest
    index."""
    n, k = z.shape[0], e.shape[0]
    edge = per * -(-384 // per) if splits > 1 else k // 2
    e_dup = e.clone()
    e_dup[edge - 128:edge + 128] = e[:256]
    ids = argmin(torch.cat([e[:256], z[:n - 256]]), e_dup)
    check(bool(((ids < edge - 128) | (ids >= edge + 128)).all()),
          f"{what}: a tie did not go to the smallest index")
    check(bool((ids[:256] == torch.arange(256, device="cuda")).all()),
          f"{what}: exact matches not found at the smaller index")
    where = "the split at" if splits > 1 else "index"
    print(f"{what} ties: codes copied across {where} {edge} ({splits} "
          f"splits of {per} codes) resolve to the smallest index")


def phase_k1(torch):
    """K1 at every shape the main paths give it (K=8192, D=64, fp32;
    K1_SHAPES), TF32 off: ids against the plain version by near_tie_gate,
    and equal to K2's bit for bit (the same fp32 arithmetic); ties across a
    split boundary. Times by cuda_ms and queued_ms, beside K2, the plain
    version and cdist+argmin. The kernels line keeps the rollout shape's
    numbers and, under ``at_n``, every shape's."""
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    k, d = 8192, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(1)
    row, worst, at_n = None, 0.0, {}
    for name, n in K1_SHAPES:
        z = torch.randn(n, d, device="cuda", generator=g)
        e = torch.randn(k, d, device="cuda", generator=g)
        splits, per = vq.vq_splits(n, k, sms, vq.K1_FIXED_TILES)
        iters = 10 if n > 8192 else 50
        with full_fp32():
            ids = vq.vq_argmin(z, e)
            ref = vq.vq_lookup_plain(z, e)
            torch.cuda.synchronize()
            worst = max(worst, near_tie_gate(
                torch, f"K1 {name} N={n} ids against the plain version", z,
                e, ids, ref))
            check(torch.equal(ids, vq.vq_argmin_tiled(z, e)),
                  f"K1 {name} N={n}: ids differ from K2's")
            print(f"K1 {name} N={n}: ids equal to K2's bit for bit")
            split_ties(torch, f"K1 {name}", vq.vq_argmin, z, e, splits, per)
            ms = cuda_ms(lambda: vq.vq_argmin(z, e), iters)
            q_ms, host_ms = queued_ms(lambda: vq.vq_argmin(z, e), iters)
            k2_ms = cuda_ms(lambda: vq.vq_argmin_tiled(z, e), iters)
            plain_ms = cuda_ms(lambda: vq.vq_lookup_plain(z, e), 5)
            lib_ms = cuda_ms(lambda: torch.cdist(z, e).argmin(1), 5)
        b_ms, b_by = bound(n * d * 4 + k * d * 4 + k * 4 + n * 8,
                           2 * n * k * d, FP32_PEAK)
        print(f"K1 {name} N={n} K={k} D={d} splits={splits}: "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (cdist+argmin) K2 {k2_ms:.4f} ms "
              f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound="
              f"{b_ms / ms:.3f}; "
              f"queued: kernel_ms={q_ms:.4f} (share {b_ms / q_ms:.3f}), "
              f"host_ms per call {host_ms:.4f}")
        at_n[n] = dict(path=name, splits=splits, ms=ms, queued_ms=q_ms,
                       host_ms=host_ms, k2_ms=k2_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms)
        if row is None:
            row = dict(name="vq_argmin", route="cuda",
                       source="ivideogpt_tpu_torch/csrc/vq_argmin.cu",
                       replaces="ivideogpt_tpu/ops/vq.py:89",
                       shape=f"{name} N={n} K={k} D={d}", ms=ms,
                       queued_ms=q_ms, host_ms=host_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       library="cdist+argmin")
        del z, e, ids, ref
    torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    row["at_n"] = at_n
    return row


def phase_k2(torch, k1):
    """K2 at K2_SHAPES, TF32 off: ids against the plain version by
    near_tie_gate and, at the rollout's shape, equal to K1's bit for bit;
    ties across a split boundary. Times by cuda_ms and queued_ms beside the
    plain version and cdist+argmin; at the rollout's shape, where the
    routing sends K1 (one timed shape on each side of it), K1's times from
    phase_k1's row ``k1``. The kernels line keeps the wide context shape's
    numbers, the largest lookup of the wide step, and every shape's under
    ``at_shape``."""
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    g = torch.Generator(device="cuda").manual_seed(20)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row, worst, at_shape = None, 0.0, {}
    for name, n, k, d in K2_SHAPES:
        z = torch.randn(n, d, device="cuda", generator=g)
        e = torch.randn(k, d, device="cuda", generator=g)
        splits, per = vq.vq_splits(n, k, sms, vq.k2_fixed(d))
        iters = 10 if n * k * d > 2**34 else 30
        with full_fp32():
            ids = vq.vq_argmin_tiled(z, e)
            ref = vq.vq_lookup_plain(z, e)
            torch.cuda.synchronize()
            worst = max(worst, near_tie_gate(
                torch, f"K2 {name} ids against the plain version", z, e, ids,
                ref))
            check(torch.equal(ids, vq.vq_argmin_tiled(z, e)),
                  f"K2 {name}: two launches differ")
            split_ties(torch, f"K2 {name}", vq.vq_argmin_tiled, z, e, splits,
                       per)
            extra = {}
            if d in vq.K1_WIDTHS:
                check(torch.equal(ids, vq.vq_argmin(z, e)),
                      f"K2 {name} ids differ from K1's")
                print(f"K2 {name} ids equal to K1's bit for bit")
                at = k1["at_n"][n]   # phase_k1 timed K1 at K=8192, D=64
                extra = dict(k1_ms=at["ms"], k1_queued_ms=at["queued_ms"])
            ms = cuda_ms(lambda: vq.vq_argmin_tiled(z, e), iters)
            q_ms, host_ms = queued_ms(lambda: vq.vq_argmin_tiled(z, e), iters)
            resident, smem = vq.k2_route(d)
            plain_ms = cuda_ms(lambda: vq.vq_lookup_plain(z, e), 5)
            lib_ms = cuda_ms(lambda: torch.cdist(z, e).argmin(1), 5)
            lib_q_ms = queued_ms(lambda: torch.cdist(z, e).argmin(1), 5)[0]
        b_ms, b_by = bound(n * d * 4 + k * d * 4 + k * 4 + n * 8,
                           2 * n * k * d, FP32_PEAK)
        print(f"K2 {name} N={n} K={k} D={d} splits={splits}: "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (cdist+argmin; queued "
              f"{lib_q_ms:.4f}, K2 {lib_q_ms / q_ms:.3f}x faster) "
              f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f}; "
              f"queued: kernel_ms={q_ms:.4f} (share {b_ms / q_ms:.3f}), "
              f"host_ms per call {host_ms:.4f}; z "
              f"{'resident' if resident else 'streamed'}, dynamic shared "
              f"memory {smem} bytes a CTA"
              + "".join(f"; {key} {v:.4f}" for key, v in extra.items()))
        at_shape[name] = dict(n=n, k=k, d=d, splits=splits, ms=ms,
                              queued_ms=q_ms, host_ms=host_ms,
                              plain_ms=plain_ms, library_ms=lib_ms,
                              library_queued_ms=lib_q_ms, bound_ms=b_ms,
                              z_resident=resident, smem=smem, **extra)
        if row is None:
            row = dict(name="vq_argmin_tiled", route="cuda",
                       source="ivideogpt_tpu_torch/csrc/vq_argmin_tiled.cu",
                       replaces="ivideogpt_tpu/ops/vq.py:46",
                       shape=f"{name} N={n} K={k} D={d}", ms=ms,
                       queued_ms=q_ms, host_ms=host_ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       library="cdist+argmin")
        del z, e, ids, ref
    torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    row["at_shape"] = at_shape
    return row


def vq_routing(torch):
    """K1 and K2 side by side at K in {8192, 16384, 32768} x D in K1's
    widths {8, 16, 32, 64} x N in {1536, 8192, 131072}, by cuda_ms and
    queued_ms, their ids held equal: the measurement behind ops/vq.uses_k1
    (``--vq-routing``)."""
    from ivideogpt_tpu_torch.ops import vq
    g = torch.Generator(device="cuda").manual_seed(30)
    out = []
    for d in vq.K1_WIDTHS:
        for k in (8192, 16384, 32768):
            for n in (1536, 8192, 131072):
                z = torch.randn(n, d, device="cuda", generator=g)
                e = torch.randn(k, d, device="cuda", generator=g)
                check(torch.equal(vq.vq_argmin(z, e),
                                  vq.vq_argmin_tiled(z, e)),
                      f"routing N={n} K={k} D={d}: K1 and K2 ids differ")
                iters = 5 if n == 131072 else 30
                r = dict(n=n, k=k, d=d)
                for key, fn in (("k1", vq.vq_argmin),
                                ("k2", vq.vq_argmin_tiled)):
                    r[key + "_ms"] = cuda_ms(lambda: fn(z, e), iters)
                    r[key + "_queued_ms"] = queued_ms(lambda: fn(z, e),
                                                      iters)[0]
                r["k2_over_k1_queued"] = r["k2_queued_ms"] / r["k1_queued_ms"]
                print(f"routing N={n} K={k} D={d}: K1 {r['k1_ms']:.4f} ms "
                      f"(queued {r['k1_queued_ms']:.4f}), K2 "
                      f"{r['k2_ms']:.4f} (queued {r['k2_queued_ms']:.4f}); "
                      f"K2 / K1 queued {r['k2_over_k1_queued']:.3f}")
                out.append(r)
                del z, e
    torch.cuda.empty_cache()
    print("routing: " + json.dumps(out))
    return out


def k3_caches(torch, b, M, g, H=12):
    """Int8 caches (k, ks, v, vs) at batch b, M slots, H=12, hd=64, from g:
    as many as hold ``L2_ROTATION_BYTES`` together (one at B=256, 305 MB;
    six at B=32, 35 MB each), so that a call that takes the next one finds
    its bytes outside the 50 MB L2, as each of a rollout's 12 layers does."""
    one = 2 * b * M * H * 64 + 2 * b * M * H * 2
    caches = []
    for _ in range(-(-L2_ROTATION_BYTES // one)):
        k, v = (torch.randint(-127, 128, (b, M, H, 64), device="cuda",
                              generator=g, dtype=torch.int8)
                for _ in range(2))
        ks, vs = ((torch.rand(b, M, H, device="cuda", generator=g) * 0.02
                   + 0.001).bfloat16() for _ in range(2))
        caches.append((k, ks, v, vs))
    return caches


def rotating(caches, fn):
    """A call of fn(k, ks, v, vs) on the next cache of the rotation."""
    turn = [0]

    def call():
        k, ks, v, vs = caches[turn[0] % len(caches)]
        turn[0] += 1
        return fn(k, ks, v, vs)
    return call


def k3_bound(b, valid, H=12):
    """(bound_ms, by) of one K3 call: the live int8 K and V and their bf16
    scales read once, q read and out written once (bf16), against 4 FLOP a
    cached value at the fp32 rate."""
    nbytes = 2 * b * valid * H * 64 + 2 * b * valid * H * 2 \
        + 2 * b * H * 64 * 2
    return bound(nbytes, 4 * b * H * valid * 64, FP32_PEAK)


def k3_graph_gate(torch, da, q, cache, valids):
    """Capture one K3 call with valid on the card; replay it after
    valid.fill_() at each of valids: bit for bit the host-int path's, and
    within the plain version's tolerance."""
    k, ks, v, vs = cache
    vt = torch.full((1,), valids[0], dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.decode_attention(q, k, ks, v, vs, vt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, k, ks, v, vs, vt)
    for valid in valids:
        vt.fill_(valid)
        graph.replay()
        want = da.decode_attention(q, k, ks, v, vs, valid)
        ref = da.decode_attention_plain(q, k, ks, v, vs, valid)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"K3: the graph replayed at valid="
              f"{valid} differs from the host-int path")
        check(torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-3),
              f"K3: the graph replayed at valid={valid} disagrees with the "
              f"plain version")
    del graph


def phase_k3(torch):
    """K3 at the main rollout's shape (B=256, M=752, valid 515, 633, 751)
    and the MBRL rollout's (B=32, M=684, valid 514, 599, 683), H=12, hd=64.
    Gates at each valid: the plain version within its tolerance, two
    launches bit-identical, valid as an int32 on the card bit-equal to the
    host int; at each shape one CUDA graph of K3 alone (valid on the card)
    replayed at two lengths, bit-equal to the host-int path. Prints the
    split plan. Times by cuda_ms and, for the card alone, queued_ms (at
    B=32 the host's launch is the slower), each call on the next cache of a
    rotation that holds >= 200 MB (``k3_caches``): one cache at B=32 (35
    MB) would sit in the 50 MB L2 across calls, where the rollout's 12
    layers never find theirs. The kernels line keeps B=256 at valid 751 and
    every shape under ``at_shape``."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    H, hd = 12, 64
    g = torch.Generator(device="cuda").manual_seed(2)
    max_err, row, at_shape = 0.0, None, {}
    for b, M, valids in K3_SHAPES:
        splits = da.decode_splits(b, H, M, da._sms(torch.device("cuda")))
        per = da.split_len(M, splits)
        blocks = b * da.head_groups(H) * splits
        print(f"K3 B={b} M={M}: plan {splits} split(s) of {per} slots, "
              f"{blocks} blocks of {H} heads")
        caches = k3_caches(torch, b, M, g)
        q = torch.randn(b, H, hd, device="cuda", generator=g).bfloat16()
        k, ks, v, vs = caches[0]
        for valid in valids:
            out = da.decode_attention(q, k, ks, v, vs, valid)
            again = da.decode_attention(q, k, ks, v, vs, valid)
            on_card = da.decode_attention(q, k, ks, v, vs, torch.tensor(
                [valid], dtype=torch.int32, device="cuda"))
            ref = da.decode_attention_plain(q, k, ks, v, vs, valid)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            max_err = max(max_err, err)
            # bf16 outputs of two fp32 sums taken in another order: a bf16
            # ulp
            ok = torch.allclose(out.float(), ref.float(), rtol=2e-2,
                                atol=2e-3)
            check(ok, f"K3 disagrees with the plain version at B={b}, "
                  f"valid={valid}")
            check(torch.equal(out, again), f"K3: two launches differ at "
                  f"B={b}, valid={valid}")
            check(torch.equal(out, on_card), f"K3: valid on the card "
                  f"differs from the host int at B={b}, valid={valid}")

            fn = rotating(caches, lambda k, ks, v, vs:
                          da.decode_attention(q, k, ks, v, vs, valid))
            ms = cuda_ms(fn, 60)
            q_ms, host_ms = queued_ms(fn, 240)
            plain_ms = cuda_ms(
                lambda: da.decode_attention_plain(q, k, ks, v, vs, valid), 5)
            b_ms, b_by = k3_bound(b, valid)
            print(f"K3 B={b} M={M} valid={valid}: max_abs_err={err:.3e} "
                  f"(rtol 2e-2, atol 2e-3), two launches and the device "
                  f"valid bit-equal; cold L2 ({len(caches)} caches): "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms=null bound_ms={b_ms:.4f} ({b_by}) "
                  f"share_of_bound={b_ms / ms:.3f}; queued: kernel_ms="
                  f"{q_ms:.4f} (share {b_ms / q_ms:.3f}), host_ms per call "
                  f"{host_ms:.4f}")
            at_shape[f"B={b} valid={valid}"] = dict(
                ms=ms, queued_ms=q_ms, host_ms=host_ms, plain_ms=plain_ms,
                bound_ms=b_ms, splits=splits, split_len=per)
            if b == B and M == 752:
                row = dict(name="decode_attention", route="cuda",
                           source="ivideogpt_tpu_torch/csrc/"
                                  "decode_attention.cu",
                           replaces="ivideogpt_tpu/ops/decode_attention.py:45",
                           shape=f"B={b} M={M} valid={valid}", ms=ms,
                           queued_ms=q_ms, host_ms=host_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
        k3_graph_gate(torch, da, q, caches[0], valids[:2])
        print(f"K3 B={b}: one CUDA graph (valid on the card) replayed at "
              f"valid {valids[0]} and {valids[1]}: bit-equal to the host-int "
              f"path, within rtol 2e-2, atol 2e-3 of the plain version")
        del caches, k, ks, v, vs, q
    torch.cuda.empty_cache()
    row["max_abs_err"] = max_err
    row["at_shape"] = at_shape
    return row


def k3_splits(torch):
    """K3 at the six shapes of ``phase_k3`` for every split count in
    K3_SPLIT_CANDIDATES, by cuda_ms and queued_ms over the cold-L2
    rotation, each held against the plan's output: the measurement behind
    ops/decode_attention.decode_splits (``--k3-splits``). Then K3's fixed
    cost a launch: queued_ms of a one-element add (the card's floor for
    back-to-back launches) beside K3 at valid=1, with one split and with
    the plan's (the difference: the merge's chain of fence, count and
    reads)."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    H = 12
    g = torch.Generator(device="cuda").manual_seed(31)
    out = []
    tiny = torch.zeros(1, device="cuda")
    floor_ms = queued_ms(lambda: tiny.add_(1), 240)[0]
    for b, M, valids in K3_SHAPES:
        plan = da.decode_splits(b, H, M, da._sms(torch.device("cuda")))
        caches = k3_caches(torch, b, M, g)
        q = torch.randn(b, H, 64, device="cuda", generator=g).bfloat16()
        for valid in valids:
            want = da.decode_attention(q, *caches[0], valid)
            b_ms, _ = k3_bound(b, valid)
            for splits in K3_SPLIT_CANDIDATES[b]:
                got = da._launch(q, *caches[0], valid, splits)
                check(torch.allclose(got.float(), want.float(), rtol=2e-2,
                                     atol=2e-3),
                      f"k3 splits: {splits} splits disagree at B={b}")
                fn = rotating(caches, lambda k, ks, v, vs:
                              da._launch(q, k, ks, v, vs, valid, splits))
                r = dict(b=b, valid=valid, splits=splits, plan=plan,
                         ms=cuda_ms(fn, 60), queued_ms=queued_ms(fn, 240)[0],
                         bound_ms=b_ms)
                r["share_queued"] = b_ms / r["queued_ms"]
                print(f"k3 splits B={b} valid={valid} splits={splits}"
                      f"{' (plan)' if splits == plan else ''}: "
                      f"{r['ms']:.4f} ms, queued {r['queued_ms']:.4f} "
                      f"(share {r['share_queued']:.3f})")
                out.append(r)
        fixed = {f"splits={n}": queued_ms(rotating(
            caches, lambda k, ks, v, vs: da._launch(q, k, ks, v, vs, 1, n)),
            240)[0] for n in sorted({1, plan})}
        print(f"k3 fixed cost B={b}: a one-element add {floor_ms:.4f} ms "
              f"queued; K3 at valid=1 " + ", ".join(
                  f"{k} {v:.4f}" for k, v in fixed.items()))
        out.append(dict(b=b, valid=1, floor_ms=floor_ms, fixed_ms=fixed))
        del caches, q
        torch.cuda.empty_cache()
    print("k3 splits: " + json.dumps(out))
    return out


def phase_flash(torch):
    """K4 at the training and prefill shapes of the main paths (B=16,
    S=751; B=256, S=514), of the MBRL world model (train(): B=16,
    S=683; the rollout's prefill: B=32, S=513), of the ctx=1 rollout's
    prefill (B=256, S=257) and of the BAIR evaluation (its loss: B=80,
    S=511; its prefill: B=80, S=257), K5/K6 at both training
    shapes, bf16, against the plain version in fp32 on the same (upcast) inputs
    with TF32 off: the kernels keep fp32 scores and sums and round P and dS
    to bf16 where the TPU kernel does, the plain bf16 version rounds the
    scores too, so fp32 is the reference for the algorithm. Also at their
    own interface: K4's lse against ``flash_fwd_plain``'s, and K5 and K6
    fed the plain lse and di against ``flash_bwd_dkv_plain`` and
    ``flash_bwd_dq_plain``, twice (bit-identical).
    Times: the kernels, the plain version in bf16 and SDPA (is_causal=True)
    on the same inputs, by cuda_ms; each kernel's ratio to SDPA. Beside
    them, by queued_ms, the kernels' and SDPA's card time without the
    host's launch cost, and the host's time to issue one call."""
    import torch.nn.functional as F
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    H, hd = 12, 64
    sm90 = "ivideogpt_tpu_torch/csrc/flash_attention_sm90.cu"
    stock = "jax/experimental/pallas/ops/tpu/flash_attention.py:"
    # bf16 P and dS, a bf16 result rounded at the end (2^-9), di from the
    # bf16 O: bf16 rounding of values up to ~10 in dK/dV
    tol = dict(rtol=2e-2, atol=2e-2)
    # the same roundings over a whole tensor: ~3e-3 of its norm; a wrong
    # tile or mask reads O(1e-1) and more. The wgmma K4, K5 and K6 are held
    # to 1.5x the worst the mma.sync kernels read (2.51e-3)
    rel_tol, lse_tol = 3.8e-3, 1e-3
    rows, sdpa = {}, {}

    def inputs(b, s, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(b, s, H, hd, device="cuda", generator=g).bfloat16()
                for _ in range(4)]

    def err(got, want, what):
        """Gate got against want elementwise and by norm; returns max |diff|
        and ||diff|| / ||want||."""
        want = want.detach()
        diff = got.float() - want
        e = float(diff.abs().max())
        rel = float(diff.norm() / want.norm())
        check(torch.allclose(got.float(), want, **tol),
              f"{what} disagrees with the plain version elementwise")
        check(rel < rel_tol, f"{what}: relative L2 error {rel:.3e} is over "
              f"{rel_tol}")
        return e, rel

    paths = {"train": "train", "prefill": "rollout",
             "mbrl_train": "mbrl_train", "mbrl_prefill": "mbrl_rollout",
             "ctx1_prefill": "rollout_ctx1", "predict_prefill": "predict",
             "vp2_prefill": "vp2", "eval_loss": "eval_gpt",
             "eval_prefill": "eval_gpt"}
    for name, b, s in (("train", TRAIN_B, 751), ("prefill", B, 514),
                       ("mbrl_train", MB_TRAIN_B, MB_L),
                       ("mbrl_prefill", MB_B, MB_P1 - 1),
                       ("ctx1_prefill", B, CTX1_P1),
                       ("eval_loss", EVAL_B, CTX1_M - 1),
                       ("eval_prefill", EVAL_B, CTX1_P1)):
        training = name.endswith("train")
        suffix = "" if name == "train" else f"_{name}"
        q, k, v, do = inputs(b, s, seed=s)
        elems = b * s * H * hd
        pairs = b * H * s * (s + 1) // 2   # causal (query, key) pairs
        iters = 50 if b * s < 20000 else 10
        out, lse = fa.flash_fwd(q, k, v)
        with full_fp32():
            ref_in = [t.float().requires_grad_(training)
                      for t in (q, k, v)]
            ref = fa.causal_attention_plain(*ref_in, torch.float32)
            _, ref_lse = fa.flash_fwd_plain(*(t.detach() for t in ref_in))
        e4, r4 = err(out.flatten(2), ref, f"K4 O at the {name} shape")
        e_lse = float((lse - ref_lse).abs().max())
        check(e_lse < lse_tol, f"K4 lse at the {name} shape: {e_lse:.3e} "
              f"from flash_fwd_plain's")
        ms = cuda_ms(lambda: fa.flash_fwd(q, k, v), iters)
        q_ms, host_ms = queued_ms(lambda: fa.flash_fwd(q, k, v), iters)
        plain_ms = cuda_ms(
            lambda: fa.causal_attention_plain(q, k, v, torch.bfloat16), 5)
        qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))

        def sdpa_fwd():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_ms = cuda_ms(sdpa_fwd, iters)
        lib_q, lib_host = queued_ms(sdpa_fwd, iters)
        sdpa[f"K4 {name}"] = (ms, lib_ms, q_ms, lib_q, "SDPA forward")
        b_ms, b_by = bound(4 * elems * 2 + b * H * s * 4, 4 * hd * pairs,
                           BF16_PEAK)
        print(f"K4 {name} B={b} S={s}: max_abs_err={e4:.3e} (rtol 2e-2, "
              f"atol 2e-2) rel_l2_err={r4:.3e} (< {rel_tol}) "
              f"lse_max_abs_err={e_lse:.3e} (< {lse_tol}) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (SDPA forward) bound_ms={b_ms:.4f} "
              f"({b_by}) share_of_bound={b_ms / ms:.3f}; queued: "
              f"kernel_ms={q_ms:.4f} library_ms={lib_q:.4f}, host_ms per "
              f"call {host_ms:.4f} (SDPA {lib_host:.4f})")
        rows[f"K4_{name}"] = dict(
            name="flash_attention_fwd", route="cuda", source=sm90,
            replaces=stock + "331", shape=f"{name} B={b} S={s}",
            paths=(paths[name],),
            max_abs_err=e4, ms=ms, queued_ms=q_ms, host_ms=host_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library="SDPA forward")
        if not training:
            del q, k, v, do, qt, kt, vt, out, lse, ref, ref_in, ref_lse
            continue

        di = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, di)
        with full_fp32():
            rq, rk, rv = torch.autograd.grad(ref, ref_in,
                                             do.float().flatten(2))
        (ek, rel_k) = err(dk, rk, f"K5 dK at the {name} shape")
        (ev, rel_v) = err(dv, rv, f"K5 dV at the {name} shape")
        e5, r5 = max(ek, ev), max(rel_k, rel_v)
        e6, r6 = err(dq, rq, f"K6 dQ at the {name} shape")
        # K5 at its own interface, apart from K4: the plain lse and di
        di_ref = (ref.detach().view(b, s, H, hd) * do.float()).sum(-1) \
            .transpose(1, 2).contiguous()
        dk_p, dv_p = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di_ref)
        with full_fp32():
            pk, pv = fa.flash_bwd_dkv_plain(*(t.detach() for t in ref_in),
                                            do.float(), ref_lse, di_ref)
        (ek_p, rk_p), (ev_p, rv_p) = (
            err(dk_p, pk, "K5 dK fed the plain lse"),
            err(dv_p, pv, "K5 dV fed the plain lse"))
        again = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di_ref)
        check(torch.equal(dk_p, again[0]) and torch.equal(dv_p, again[1]),
              "K5 is not bit-identical across two launches")
        print(f"K5 fed the plain lse and di: dK max_abs_err={ek_p:.3e} "
              f"rel_l2_err={rk_p:.3e}, dV {ev_p:.3e} / {rv_p:.3e} "
              f"(< {rel_tol}); bit-identical across two launches")
        # K6 at its own interface too
        dq_p = fa.flash_bwd_dq(q, k, v, do, ref_lse, di_ref)
        with full_fp32():
            pq = fa.flash_bwd_dq_plain(*(t.detach() for t in ref_in),
                                       do.float(), ref_lse, di_ref)
        eq_p, rq_p = err(dq_p, pq, "K6 dQ fed the plain lse")
        check(torch.equal(dq_p, fa.flash_bwd_dq(q, k, v, do, ref_lse,
                                                di_ref)),
              "K6 is not bit-identical across two launches")
        print(f"K6 fed the plain lse and di: dQ max_abs_err={eq_p:.3e} "
              f"rel_l2_err={rq_p:.3e} (< {rel_tol}); bit-identical across "
              f"two launches")
        del ref, ref_in, ref_lse, rq, rk, rv, di_ref, dk_p, dv_p, pk, pv
        del again, dq_p, pq

        def plain_fwd_bwd(bwd):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fa.causal_attention_plain(*ins, torch.bfloat16)
            if bwd:
                torch.autograd.grad(o, ins, do.flatten(2))

        def sdpa_fwd_bwd(bwd):
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            if bwd:
                torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))
        plain_bwd = (cuda_ms(lambda: plain_fwd_bwd(True), 3)
                     - cuda_ms(lambda: plain_fwd_bwd(False), 3))
        lib_bwd = (cuda_ms(lambda: sdpa_fwd_bwd(True), iters)
                   - cuda_ms(lambda: sdpa_fwd_bwd(False), iters))
        lib_bwd_q = (queued_ms(lambda: sdpa_fwd_bwd(True), iters)[0]
                     - queued_ms(lambda: sdpa_fwd_bwd(False), iters)[0])
        # SDPA's backward computes dQ, dK and dV; K5 only dK and dV, K6 dQ
        lib_what = ("SDPA forward+backward minus forward: dQ, dK and dV "
                    "together, the comparator of K5+K6")
        bwd = {}
        for key, kname, source, line, fn, e, rel, n_io, per_pair in (
                ("K5", "flash_attention_bwd_dkv", sm90, "796",
                 lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di), e5, r5, 6, 8),
                ("K6", "flash_attention_bwd_dq", sm90, "1146",
                 lambda: fa.flash_bwd_dq(q, k, v, do, lse, di), e6, r6, 5,
                 6)):
            ms = cuda_ms(fn, iters)
            q_ms, host_ms = queued_ms(fn, iters)
            bwd[key] = (ms, q_ms)
            b_ms, b_by = bound(n_io * elems * 2 + 2 * b * H * s * 4,
                               per_pair * hd * pairs, BF16_PEAK)
            print(f"{key} {name} B={b} S={s}: max_abs_err={e:.3e} (rtol 2e-2, "
                  f"atol 2e-2) rel_l2_err={rel:.3e} (< "
                  f"{rel_tol}) "
                  f"kernel_ms={ms:.4f} plain_ms="
                  f"{plain_bwd:.4f} (plain backward, dQ/dK/dV together) "
                  f"library_ms={lib_bwd:.4f} (SDPA forward+backward minus "
                  f"forward) bound_ms={b_ms:.4f} ({b_by}) share_of_bound="
                  f"{b_ms / ms:.3f}; queued: kernel_ms={q_ms:.4f} "
                  f"library_ms={lib_bwd_q:.4f}, host_ms per call "
                  f"{host_ms:.4f}")
            rows[key + suffix] = dict(
                name=kname, route="cuda", source=source,
                replaces=stock + line, shape=f"{name} B={b} S={s}",
                paths=(paths[name],), max_abs_err=e, ms=ms, queued_ms=q_ms,
                host_ms=host_ms, plain_ms=plain_bwd, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_bwd, library=lib_what)
        sdpa[f"K5 alone at the {name} shape"] = (
            bwd["K5"][0], lib_bwd, bwd["K5"][1], lib_bwd_q, lib_what)
        sdpa[f"K5+K6, the port's backward, at the {name} shape"] = (
            bwd["K5"][0] + bwd["K6"][0], lib_bwd,
            bwd["K5"][1] + bwd["K6"][1], lib_bwd_q, lib_what)
        del q, k, v, do, qt, kt, vt, out, lse, di, dk, dv, dq
    torch.cuda.empty_cache()

    # the fp32 K4 (FMA, no rounding below fp32) at the inference entry
    # points' prefills, against the plain version in fp32, TF32 off, at the
    # GPU tests' fp32 tolerance
    fp32 = "ivideogpt_tpu_torch/csrc/flash_attention.cu"
    for name, b, s in (("predict_prefill", PRED_R, 2 * 257),
                       ("vp2_prefill", VP2_CHUNK, 2 * 257)):
        g = torch.Generator(device="cuda").manual_seed(s + b)
        q, k, v = (torch.randn(b, s, H, hd, device="cuda", generator=g)
                   for _ in range(3))
        elems = b * s * H * hd
        pairs = b * H * s * (s + 1) // 2
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa_fp32():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        with full_fp32():
            out, lse = fa.flash_fwd(q, k, v)
            ref = fa.causal_attention_plain(q, k, v, torch.float32)
            _, ref_lse = fa.flash_fwd_plain(q, k, v)
            torch.cuda.synchronize()
            e4 = float((out.flatten(2) - ref).abs().max())
            check(torch.allclose(out.flatten(2), ref, rtol=1e-4, atol=1e-5),
                  f"fp32 K4 O at the {name} shape disagrees with the plain "
                  f"version ({e4:.3e})")
            e_lse = float((lse - ref_lse).abs().max())
            check(e_lse < 1e-4, f"fp32 K4 lse at the {name} shape: "
                  f"{e_lse:.3e} from flash_fwd_plain's")
            ms = cuda_ms(lambda: fa.flash_fwd(q, k, v), 20)
            q_ms, host_ms = queued_ms(lambda: fa.flash_fwd(q, k, v), 20)
            plain_ms = cuda_ms(lambda: fa.causal_attention_plain(
                q, k, v, torch.float32), 3)
            lib_ms = cuda_ms(sdpa_fp32, 20)
            lib_q = queued_ms(sdpa_fp32, 20)[0]
        b_ms, b_by = bound(4 * elems * 4 + b * H * s * 4, 4 * hd * pairs,
                           FP32_PEAK)
        print(f"K4 fp32 {name} B={b} S={s}: max_abs_err={e4:.3e} (rtol "
              f"1e-4, atol 1e-5) lse_max_abs_err={e_lse:.3e} (< 1e-4) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (SDPA forward, fp32, TF32 off) "
              f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound={b_ms / ms:.3f}"
              f"; queued: kernel_ms={q_ms:.4f} library_ms={lib_q:.4f}, "
              f"host_ms per call {host_ms:.4f}")
        rows[f"K4_{name}"] = dict(
            name="flash_attention_fwd", route="cuda", source=fp32,
            replaces=stock + "331", shape=f"{name} fp32 B={b} S={s}",
            paths=(paths[name],), max_abs_err=e4, ms=ms, queued_ms=q_ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, library="SDPA forward, fp32, TF32 off")
        sdpa[f"K4 fp32 {name}"] = (ms, lib_ms, q_ms, lib_q,
                                   "SDPA forward, fp32")
        del q, k, v, qt, kt, vt, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    card = card_line()
    for key, (ms, lib, q_ms, lib_q, what) in sdpa.items():
        print(f"ratio to SDPA ({what}; this run, {card}): {key} "
              f"{ms / lib:.3f} (queued, no host time: {q_ms / lib_q:.3f})")
    return rows


def phase_flash_dropout(torch):
    """Attention dropout inside K4, K5 and K6 (p = DROP_P) against the plain
    versions with the same (seed, offset):

    - each kernel's mask read back exactly at the training shape (q = 0
      makes P uniform over a row; one-hot V, dO or K blocks expose
      P Z / keep key by key) and equal to ``ops/philox.keep_mask``, whose
      kept share is within 5 sigma of 1 - p;
    - bf16 K4 (O, lse), K5 and K6 (fed the plain lse and di) at the
      training shape (B=16, S=751, H=12) and at LLAMA_MEDIUM's H=16,
      against flash_*_plain in fp32 on the upcast inputs, at phase_flash's
      tolerances; through causal_attention and autograd at H=12;
    - p = 0 bit-equal to the launch without dropout, in bf16 and fp32;
    - the fp32 kernels with dropout at B=2, S=751 against the plain
      versions (fp32 tolerance), and without dropout at the training shape.
    Times by cuda_ms and queued_ms, with and without dropout, beside SDPA
    with dropout_p = DROP_P (forward; forward+backward minus forward) and,
    for the fp32 kernels at the training shape, SDPA's fp32 forward and
    backward. Returns the kernels line's rows."""
    import torch.nn.functional as F
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    hd, s = 64, 751
    sm90 = "ivideogpt_tpu_torch/csrc/flash_attention_sm90.cu"
    fp32_src = "ivideogpt_tpu_torch/csrc/flash_attention.cu"
    stock = "jax/experimental/pallas/ops/tpu/flash_attention.py:"
    lines = {"K4": "331", "K5": "796", "K6": "1146"}
    names = {"K4": "flash_attention_fwd", "K5": "flash_attention_bwd_dkv",
             "K6": "flash_attention_bwd_dq"}
    bf16_tol, bf16_rel = dict(rtol=2e-2, atol=2e-2), 3.8e-3
    fp32_tol = dict(rtol=1e-4, atol=1e-5)
    drop = (DROP_P, DROP_SEED, philox.offset_of(7, 3))
    rows = {}

    def gate(got, want, what, tol, rel_tol=None):
        got, want = got.detach(), want.detach()
        diff = got.float() - want.float()
        e = float(diff.abs().max())
        rel = float(diff.norm() / want.float().norm())
        check(torch.allclose(got.float(), want.float(), **tol),
              f"{what} disagrees with the plain version elementwise "
              f"({e:.3e})")
        if rel_tol is not None:
            check(rel < rel_tol, f"{what}: relative L2 error {rel:.3e} is "
                  f"over {rel_tol}")
        return e

    # the masks, read back from each kernel at the training shape
    b, H = TRAIN_B, 12
    want = philox.keep_mask(drop, b, H, s, 0, s, 0, s, device="cuda")
    kept = float(want.float().mean())
    sigma = (DROP_P * (1 - DROP_P) / want.numel()) ** 0.5
    check(abs(kept - (1 - DROP_P)) < 5 * sigma, f"flash_dropout: the plain "
          f"mask keeps {kept:.6f}, more than 5 sigma from {1 - DROP_P}")
    want &= torch.ones(s, s, device="cuda", dtype=torch.bool).tril()
    zero = torch.zeros(b, s, H, hd, device="cuda", dtype=torch.bfloat16)
    e0 = zero.clone()
    e0[..., 0] = 1
    lse_u = torch.log(torch.arange(1, s + 1, device="cuda").float()) \
        .expand(b, H, s).contiguous()
    di0 = torch.zeros(b, H, s, device="cuda")
    got = torch.zeros(3, b, H, s, s, device="cuda", dtype=torch.bool)
    for c0 in range(0, s, 64):
        n = min(64, s - c0)
        hot = torch.zeros(b, s, H, hd, device="cuda")
        hot[:, c0:c0 + n] = torch.eye(hd, device="cuda")[:n, None, :]
        hot = hot.bfloat16()
        o, _ = fa.flash_fwd(zero, zero, hot, drop)
        got[0, ..., c0:c0 + n] = o[..., :n].permute(0, 2, 1, 3) != 0
        _, dv = fa.flash_bwd_dkv(zero, zero, zero, hot, lse_u, di0, drop)
        got[1, :, :, c0:c0 + n, :] = dv[..., :n].permute(0, 2, 3, 1) != 0
        dq = fa.flash_bwd_dq(zero, hot, e0, e0, lse_u, di0, drop)
        got[2, ..., c0:c0 + n] = dq[..., :n].permute(0, 2, 1, 3) != 0
    for i, k in enumerate(("K4", "K5", "K6")):
        check(torch.equal(got[i], want), f"flash_dropout: {k}'s mask at "
              f"B={b} S={s} H={H} differs from the plain mask")
    print(f"flash_dropout: the masks of K4, K5 and K6 at B={b} S={s} H={H} "
          f"equal the plain mask bit for bit; it keeps {kept:.6f} of "
          f"{want.numel()} (1 - p = {1 - DROP_P}, 5 sigma = {5 * sigma:.2e})")
    del want, got, zero, e0, lse_u, di0, hot, o, dv, dq

    def inputs(b, H, seed, dtype):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(b, s, H, hd, device="cuda", generator=g)
                .to(dtype) for _ in range(4)]

    def kernels(q, k, v, do, d, lse=None, di=None):
        """{"K4": fn, "K5": fn, "K6": fn} at their own interface."""
        if lse is None:
            o, lse = fa.flash_fwd(q, k, v, d)
            di = (o.float() * do.float()).sum(-1).transpose(1, 2) \
                .contiguous()
        return {"K4": lambda: fa.flash_fwd(q, k, v, d),
                "K5": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di, d),
                "K6": lambda: fa.flash_bwd_dq(q, k, v, do, lse, di, d)}

    def p0_bit_equal(q, k, v, do, what):
        o, lse = fa.flash_fwd(q, k, v)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        zero = (0.0, DROP_SEED, 99)
        none, p0 = kernels(q, k, v, do, None, lse, di), \
            kernels(q, k, v, do, zero, lse, di)
        for key in ("K4", "K5", "K6"):
            a, c = none[key](), p0[key]()
            a, c = (a if isinstance(a, tuple) else (a,),
                    c if isinstance(c, tuple) else (c,))
            check(all(torch.equal(x, y) for x, y in zip(a, c)),
                  f"flash_dropout: {key} at p=0 is not bit-equal to the "
                  f"launch without dropout ({what})")

    def timed(fns):
        return {key: (cuda_ms(fn, 10), *queued_ms(fn, 10))
                for key, fn in fns.items()}

    def sdpa_ms(q, k, v, do, p):
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2)

        def fwd_bwd(bwd):
            o = F.scaled_dot_product_attention(qt, kt, vt, dropout_p=p,
                                               is_causal=True)
            if bwd:
                torch.autograd.grad(o, (qt, kt, vt), dot)
        f = cuda_ms(lambda: fwd_bwd(False), 10)
        fq = queued_ms(lambda: fwd_bwd(False), 10)[0]
        fb = cuda_ms(lambda: fwd_bwd(True), 10)
        fbq = queued_ms(lambda: fwd_bwd(True), 10)[0]
        return f, fq, fb - f, fbq - fq

    def plain_ms(q, k, v, do, d, dtype):
        def fwd_bwd(bwd):
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            o = fa.causal_attention_plain(*ins, dtype, dropout=d)
            if bwd:
                torch.autograd.grad(o, ins, do.flatten(2))
        f = cuda_ms(lambda: fwd_bwd(False), 2, warmup=1)
        return f, cuda_ms(lambda: fwd_bwd(True), 2, warmup=1) - f

    def add_rows(tag, b, H, dtype, src, errs, t_drop, t_none, lib, plain,
                 paths, lib_what, peak, dropout_first=True):
        """A row a kernel: ms and queued_ms with dropout and, under
        *_no_dropout, without (dropout_first); or the other way round,
        under *_dropout."""
        elems, pairs = b * s * H * hd, b * H * s * (s + 1) // 2
        isz = 2 if dtype == torch.bfloat16 else 4
        for key, n_io, per_pair in (("K4", 4, 4), ("K5", 6, 8),
                                    ("K6", 5, 6)):
            n_rows = 1 if key == "K4" else 2
            b_ms, b_by = bound(n_io * elems * isz + n_rows * b * H * s * 4,
                               per_pair * hd * pairs, peak)
            first, other = ((t_drop, t_none) if dropout_first
                            else (t_none, t_drop))
            ms, q_ms, host = first[key]
            ms0, q_ms0, _ = other[key]
            suffix = "_no_dropout" if dropout_first else "_dropout"
            lib_ms = lib[0] if key == "K4" else lib[2]
            lib_q = lib[1] if key == "K4" else lib[3]
            row = dict(
                name=names[key], route="cuda", source=src,
                replaces=stock + lines[key],
                shape=f"{tag} B={b} S={s} H={H}", paths=paths,
                max_abs_err=errs[key], ms=ms, queued_ms=q_ms, host_ms=host,
                plain_ms=plain[0] if key == "K4" else plain[1],
                bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / q_ms,
                library_ms=lib_ms, library_queued_ms=lib_q,
                library=lib_what if key == "K4" else
                lib_what + " backward (forward+backward minus forward; dQ, "
                "dK and dV together)")
            row["ms" + suffix] = ms0
            row["queued_ms" + suffix] = q_ms0
            row["share_of_bound" + suffix] = b_ms / q_ms0
            rows[f"{key}_{tag}"] = row
            print(f"{key} {tag} B={b} S={s} H={H}: max_abs_err="
                  f"{errs[key]:.3e} kernel_ms={ms:.4f} queued_ms={q_ms:.4f} "
                  f"({suffix[1:]}: {ms0:.4f} / {q_ms0:.4f}) plain_ms="
                  f"{row['plain_ms']:.4f} library_ms={lib_ms:.4f} queued "
                  f"{lib_q:.4f} ({row['library']}) bound_ms={b_ms:.4f} "
                  f"({b_by}) share_of_bound={b_ms / q_ms:.3f} "
                  f"({suffix[1:]} {b_ms / q_ms0:.3f}); host_ms per call "
                  f"{host:.4f}")

    # bf16 at the training shape (LLAMA_BASE, H=12) and LLAMA_MEDIUM's H=16
    for tag, H, paths in (("train_dropout", 12, ("train_gpt",)),
                          ("medium_dropout", 16, ("train_medium",))):
        b = TRAIN_B
        q, k, v, do = inputs(b, H, H, torch.bfloat16)
        f = [t.float() for t in (q, k, v, do)]
        with full_fp32():
            o, lse = fa.flash_fwd(q, k, v, drop)
            ref_o, ref_lse = fa.flash_fwd_plain(*f[:3], drop)
            di = (ref_o * f[3]).sum(-1).transpose(1, 2).contiguous()
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di, drop)
            dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, di, drop)
            ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*f, ref_lse, di, drop)
            ref_dq = fa.flash_bwd_dq_plain(*f, ref_lse, di, drop)
        e_lse = float((lse - ref_lse).abs().max())
        check(e_lse < 1e-3, f"flash_dropout: K4 lse ({tag}) {e_lse:.3e} "
              f"from the plain, undropped lse")
        errs = {"K4": gate(o, ref_o, f"K4 O ({tag})", bf16_tol, bf16_rel),
                "K5": max(gate(dk, ref_dk, f"K5 dK ({tag})", bf16_tol,
                               bf16_rel),
                          gate(dv, ref_dv, f"K5 dV ({tag})", bf16_tol,
                               bf16_rel)),
                "K6": gate(dq, ref_dq, f"K6 dQ ({tag})", bf16_tol, bf16_rel)}
        del ref_o, ref_dk, ref_dv, ref_dq, dk, dv, dq
        if H == 12:
            # end to end: causal_attention and autograd against autograd
            # through the plain version in fp32
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fa.causal_attention(*ins, torch.bfloat16, drop)
            grads = torch.autograd.grad(out, ins, do.flatten(2))
            ref_in = [t.detach().requires_grad_() for t in f[:3]]
            with full_fp32():
                ref = fa.causal_attention_plain(*ref_in, torch.float32,
                                                dropout=drop)
                ref_grads = torch.autograd.grad(ref, ref_in,
                                                f[3].flatten(2))
            gate(out, ref, "causal_attention with dropout", bf16_tol,
                 bf16_rel)
            for g, r, w in zip(grads, ref_grads, "qkv"):
                gate(g, r, f"d{w} through causal_attention with dropout",
                     bf16_tol, bf16_rel)
            del ins, out, grads, ref_in, ref, ref_grads
        p0_bit_equal(q, k, v, do, f"bf16 {tag}")
        t_drop = timed(kernels(q, k, v, do, drop))
        t_none = timed(kernels(q, k, v, do, None))
        lib = sdpa_ms(q, k, v, do, DROP_P)
        plain = plain_ms(q, k, v, do, drop, torch.bfloat16)
        add_rows(tag, b, H, torch.bfloat16, sm90, errs, t_drop, t_none, lib,
                 plain, paths, f"SDPA forward, dropout_p={DROP_P}",
                 BF16_PEAK)
        del q, k, v, do, f, o, lse, di
        torch.cuda.empty_cache()

    # fp32: with dropout at B=2 against the plain version, p = 0 bit-equal
    q, k, v, do = inputs(2, 12, 5, torch.float32)
    with full_fp32():
        fns = kernels(q, k, v, do, drop)
        o, lse = fns["K4"]()
        ref_o, ref_lse = fa.flash_fwd_plain(q, k, v, drop)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fns["K5"]()
        dq = fns["K6"]()
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di, drop)
        ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, di, drop)
    e_fp32 = {"K4": gate(o, ref_o, "fp32 K4 O with dropout", fp32_tol),
              "K5": max(gate(dk, ref_dk, "fp32 K5 dK with dropout", fp32_tol),
                        gate(dv, ref_dv, "fp32 K5 dV with dropout",
                             fp32_tol)),
              "K6": gate(dq, ref_dq, "fp32 K6 dQ with dropout", fp32_tol)}
    check(float((lse - ref_lse).abs().max()) < 1e-4, "fp32 K4 lse with "
          "dropout differs from the plain lse")
    p0_bit_equal(q, k, v, do, "fp32 B=2")
    print(f"flash_dropout: fp32 K4/K5/K6 with dropout at B=2 S={s} H=12: "
          f"max_abs_err {json.dumps({k_: round(e_, 9) for k_, e_ in e_fp32.items()})} "
          f"(rtol 1e-4, atol 1e-5); p=0 bit-equal to no dropout")
    del q, k, v, do, o, lse, ref_o, ref_lse, di, dk, dv, dq
    del ref_dk, ref_dv, ref_dq

    # fp32 at the training shape: against the plain version without
    # dropout, timed with and without it, beside SDPA's fp32 forward and
    # backward (TF32 off)
    b = TRAIN_B
    q, k, v, do = inputs(b, 12, 6, torch.float32)
    with full_fp32():
        o, lse = fa.flash_fwd(q, k, v)
        ref_o, ref_lse = fa.flash_fwd_plain(q, k, v)
        di = (ref_o * do).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di)
        dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, di)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, di)
        ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, di)
        errs = {"K4": gate(o, ref_o, "fp32 K4 O (train shape)", fp32_tol),
                "K5": max(gate(dk, ref_dk, "fp32 K5 dK (train shape)",
                               fp32_tol),
                          gate(dv, ref_dv, "fp32 K5 dV (train shape)",
                               fp32_tol)),
                "K6": gate(dq, ref_dq, "fp32 K6 dQ (train shape)", fp32_tol)}
        del ref_o, ref_dk, ref_dv, ref_dq, dk, dv, dq
        t_drop = timed(kernels(q, k, v, do, drop))
        t_none = timed(kernels(q, k, v, do, None))
        lib = sdpa_ms(q, k, v, do, 0.0)
        plain = plain_ms(q, k, v, do, None, torch.float32)
    add_rows("train_fp32", b, 12, torch.float32, fp32_src, errs, t_drop,
             t_none, lib, plain, ("train_gpt_check",),
             "SDPA forward, fp32, TF32 off", FP32_PEAK, dropout_first=False)
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()
    card = card_line()
    for key, r in rows.items():
        print(f"ratio to SDPA ({r['library']}; this run, {card}): {key} "
              f"{r['ms'] / r['library_ms']:.3f} (queued, no host time: "
              f"{r['queued_ms'] / r['library_queued_ms']:.3f})")
    return rows


def check_stream(torch, tokens_mod, cfg, toks, batch, ctx=CTX):
    L = tokens_mod.seq_len(ctx, T)
    check(tuple(toks.shape) == (batch, L), f"tokens {tuple(toks.shape)}")
    c, d = tokens_mod.disassemble(toks, ctx, cfg.num_vq_embeddings,
                                  cfg.num_dyn_embeddings)
    check(tuple(c.shape) == (batch, ctx, 256)
          and tuple(d.shape) == (batch, T - ctx, 16), "disassembled grids")
    P = tokens_mod.prelude_len(ctx)
    check(bool((toks[:, :P] <= cfg.scf_token).all()), "prelude out of range")
    sdf = tokens_mod.sdf_positions(ctx, T, device=toks.device)
    check(bool((toks[:, sdf] == cfg.sdf_token).all()), "sdf slots")
    # sampling runs over the whole vocabulary, as in the JAX package: with
    # random weights a sampled slot may hold any id, which disassemble clamps
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a token lies outside the vocabulary")


def counted():
    """Every kernel wrapper, by the name the kernels line gives it."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import vq
    return {"vq_argmin": vq.vq_argmin,
            "vq_argmin_tiled": vq.vq_argmin_tiled,
            "decode_attention": da.decode_attention,
            "flash_attention_fwd": fa.flash_fwd,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv,
            "flash_attention_bwd_dq": fa.flash_bwd_dq}


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counted().items()}


def phase_main(torch):
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch import tokens as tok
    from ivideogpt_tpu_torch.ops import decode_attention as da
    t0 = time.time()
    tokenizer, lm = ro.build_models(context_length=CTX, segment_length=T,
                                    seed=0)
    n_tok = sum(p.numel() for p in tokenizer.parameters())
    n_lm = sum(p.numel() for p in lm.parameters())
    print(f"main: models built in {time.time() - t0:.1f}s "
          f"(tokenizer {n_tok / 1e6:.1f}M, LM {n_lm / 1e6:.1f}M params)")
    g = torch.Generator(device="cuda").manual_seed(3)
    px = torch.rand(B, CTX, 64, 64, 3, device="cuda", generator=g)
    action = torch.randn(B, T, 4, device="cuda", generator=g)
    frames_per_rollout = B * (T - CTX)

    def run(gen):
        return ro.rollout(tokenizer, lm, px, action, segment_length=T,
                          generator=gen, cache_dtype=torch.int8)

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run(torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = read_counts()
    print(f"main: first rollout {first_s:.2f}s, launches {launches}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check(launches["vq_argmin"] >= 1, "K1 never ran on the main path")
    check(launches["decode_attention"] == 2832,
          f"K3 ran {launches['decode_attention']} times, not 2832")
    check(launches["flash_attention_fwd"] == 12,
          f"K4 ran {launches['flash_attention_fwd']} times, not 12 (the "
          f"prefill of each layer)")
    check_stream(torch, tok, tokenizer.config, res.tokens, B)
    check(tuple(res.frames.shape) == (B, T, 64, 64, 3),
          f"frames {tuple(res.frames.shape)}")
    check(bool(torch.isfinite(res.frames).all()), "frames not finite")
    print(f"main: tokens {tuple(res.tokens.shape)} in range, frames "
          f"{tuple(res.frames.shape)} {res.frames.dtype} finite")

    gen = torch.Generator(device="cuda").manual_seed(5)
    k3_before = da.decode_attention.launches
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(N_TIMED):
        res = run(gen)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / N_TIMED
    check(da.decode_attention.launches - k3_before == 2832 * N_TIMED,
          "K3 launches per timed rollout are not 2832")
    fps = frames_per_rollout / dt
    print(f"main: {N_TIMED} timed rollouts, {dt:.4f} s/rollout, "
          f"{fps:.2f} frames/s ({frames_per_rollout} generated frames a "
          f"rollout)")

    stage_report(torch, "main", tokenizer, lm, px, action, gen)
    del tokenizer, lm, res
    torch.cuda.empty_cache()
    return launches


def stage_report(torch, tag, tokenizer, lm, px, action, gen):
    """Print a rollout's stage wall seconds, and their device seconds and
    busy shares from a kernel trace of each stage."""
    wall = stage_seconds(torch, tokenizer, lm, px, action, gen, None)
    print(f"{tag}: stage wall seconds " + json.dumps(wall))
    device = profile_stages(torch, tag, tokenizer, lm, px, action, gen)
    if device is not None:
        busy = {k: round(device[k] / wall[k], 4) for k in wall}
        print(f"{tag}: stage device seconds " + json.dumps(device)
              + " busy share " + json.dumps(busy))


def stage_seconds(torch, tokenizer, lm, px, action, gen, timer):
    """Run the rollout's three stages once each, through the same calls
    ``rollout`` makes (the context length is px's); ``timer(name)`` is a
    context manager around each stage (None: host wall seconds after a
    synchronize)."""
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import tokens as tok
    cfg = tokenizer.config
    ctx = px.shape[1]
    out = {}

    @contextlib.contextmanager
    def wall(name):
        torch.cuda.synchronize()
        t0 = time.time()
        yield
        torch.cuda.synchronize()
        out[name] = round(time.time() - t0, 4)

    timer = timer or wall
    with torch.inference_mode():
        with timer("tokenize"):
            prelude = tok.make_prelude(tokenizer.encode_context(px),
                                       cfg.num_vq_embeddings,
                                       cfg.num_dyn_embeddings)
        with timer("generate"):
            res = generation.generate(lm, prelude, segment_length=T,
                                      context_length=ctx, generator=gen,
                                      action=action, cache_dtype=torch.int8)
        with timer("detokenize"):
            for i in range(0, B, 128):
                tokenizer.detokenize(res.tokens[i:i + 128], ctx)
    return out


@contextlib.contextmanager
def kernel_trace(torch, out):
    """torch.profiler around the block; then out["seconds"] holds the CUDA
    kernels' device seconds (one stream, so kernels do not overlap) and
    out["kernels"] their averages by name, largest first. Ranges that
    annotate the device timeline (``Optimizer.step#AdamW.step``) overlap
    the kernels they hold and are left out. The device activity alone is
    traced: nothing here reads the CPU's ops, which only lengthen reading
    the trace back (a B=256 generate launches over 200k kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    out["kernels"] = kernels
    out["seconds"] = sum(e.self_device_time_total for e in kernels) / 1e6


def top_kernels(kernels, n, width=60):
    """(name, launches, device s) of the n largest kernels."""
    return [(e.key[:width], e.count, round(e.self_device_time_total / 1e6, 5))
            for e in kernels[:n]]


def profile_stages(torch, tag, tokenizer, lm, px, action, gen):
    """Device seconds of each stage from a kernel trace of that stage. None,
    with the reason printed, when the trace has no device time."""
    out, top, ours = {}, {}, {}
    families = ("vq_argmin", "decode_attn", "flash_")   # K1/K2, K3, K4

    @contextlib.contextmanager
    def traced(name):
        res = {}
        with kernel_trace(torch, res):
            yield
        out[name] = round(res["seconds"], 4)
        top[name] = top_kernels(res["kernels"], 6)
        ours[name] = {f: round(sum(e.self_device_time_total
                                   for e in res["kernels"] if f in e.key)
                               / 1e6, 5) for f in families}

    stage_seconds(torch, tokenizer, lm, px, action, gen, traced)
    if not any(out.values()):
        print(f"{tag}: the profiler recorded no device time: device seconds "
              "not measured")
        return None
    for name, rows in top.items():
        print(f"{tag}: top kernels in {name} (name, launches, device s): "
              + json.dumps(rows))
    print(f"{tag}: the port's kernels by stage (device s, by name fragment): "
          + json.dumps(ours))
    return out


def phase_check(torch):
    """A small fp32 rollout on the GPU (through K1 and K3) held against the
    plain CPU path of the same models on the same stream."""
    import copy
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    b = 2
    tokenizer, lm = ro.build_models(context_length=CTX, segment_length=T,
                                    dtype=torch.float32, seed=6)
    g = torch.Generator(device="cuda").manual_seed(7)
    px = torch.rand(b, CTX, 64, 64, 3, device="cuda", generator=g)
    action = torch.randn(b, T, 4, device="cuda", generator=g)
    res = ro.rollout(tokenizer, lm, px, action, segment_length=T,
                     generator=g, cache_dtype=torch.int8)
    with full_fp32():
        ids = tokenizer.encode_context(px).cpu()
        logits = generation.replay_logits(
            lm, res.tokens, segment_length=T, context_length=CTX,
            action=action, cache_dtype=torch.int8).cpu()
    torch.set_num_threads(os.cpu_count() or 1)
    tok_cpu = copy.deepcopy(tokenizer).cpu()
    lm_cpu = copy.deepcopy(lm).cpu()
    toks = res.tokens.cpu()
    with torch.inference_mode():
        ids_cpu = tok_cpu.encode_context(px.cpu())
        ref_logits = generation.replay_logits(
            lm_cpu, toks, segment_length=T, context_length=CTX,
            action=action.cpu(), cache_dtype=torch.int8)
        ref_frames = tok_cpu.detokenize(toks, CTX)
    same = float((ids == ids_cpu).float().mean())
    dl = float((logits - ref_logits).abs().max())
    df = float((res.frames.cpu() - ref_frames).abs().max())
    print(f"check: context ids equal to the CPU path {same:.4f}; max "
          f"|logit diff| {dl:.3e} (tolerance 2e-2); max |frame diff| "
          f"{df:.3e} (tolerance 1e-3)")
    # fp32 on both sides, TF32 off: ids may flip only at near ties; an int8
    # cache rounding may flip where the GPU's k/v differ in the last bits
    check(same >= 0.99, "context ids differ from the CPU path")
    check(dl < 2e-2, "teacher-forced logits differ from the CPU path")
    check(df < 1e-3, "frames differ from the CPU path")


def phase_train(torch):
    """The GPT training step at full width and depth: TOKENIZER_64 (fp32,
    frozen) + LLAMA_BASE with the action head, bf16 over fp32 masters,
    B=16, ctx=2, T=16, L=751, action-free; AdamW lr 1e-4, constant schedule
    without warmup (so the first update has lr 0, as in optax), clip 1.0.
    One fixed batch of pixels made on the card; each step tokenizes it (K1)
    and trains on it (K4/K5/K6 in every layer)."""
    from ivideogpt_tpu_torch import tokens as tok
    from ivideogpt_tpu_torch.configs import GPTTrainConfig
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    t0 = time.time()
    tokenizer, model = gt.build_train_models(context_length=CTX,
                                             segment_length=T, seed=10)
    n_lm = sum(p.numel() for p in model.parameters())
    cfg = GPTTrainConfig(learning_rate=1e-4, lr_scheduler="constant",
                         lr_warmup_steps=0, max_grad_norm=1.0)
    state = gt.create_train_state(model, cfg)
    tokenize = gt.make_tokenize_fn(tokenizer, CTX)
    g = torch.Generator(device="cuda").manual_seed(11)
    px = torch.rand(TRAIN_B, T, 64, 64, 3, device="cuda", generator=g)
    L = tok.seq_len(CTX, T)
    print(f"train: models built in {time.time() - t0:.1f}s (LM "
          f"{n_lm / 1e6:.1f}M fp32 masters, bf16 compute)")

    def step():
        ids, labels = tokenize(px)
        return gt.train_step(state, {"input_ids": ids, "labels": labels})

    warm = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    metrics = [step() for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    dt = (time.time() - t0) / TRAIN_TIMED
    launches = read_counts()
    losses = [float(m["loss"]) for m in warm + metrics]
    timed = losses[TRAIN_WARMUP:]
    print(f"train: losses {[round(x, 4) for x in losses]} (the first "
          f"{TRAIN_WARMUP} are warm-up steps); grad norms "
          f"{[round(float(m['grad_norm']), 4) for m in metrics]}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "train: a loss is not finite")
    check(timed[-1] < timed[0], f"train: the loss did not fall over the "
          f"timed steps ({timed[0]:.4f} -> {timed[-1]:.4f})")
    want = {"vq_argmin": 2, "decode_attention": 0, "flash_attention_fwd": 12,
            "flash_attention_bwd_dkv": 12, "flash_attention_bwd_dq": 12}
    for name, n in want.items():
        check(launches[name] == n * TRAIN_TIMED,
              f"train: {name} ran {launches[name]} times in "
              f"{TRAIN_TIMED} steps, not {n} a step")
    flops = 6 * n_lm * TRAIN_B * L
    print(f"train: {TRAIN_TIMED} timed steps, {dt * 1e3:.2f} ms/step, "
          f"{TRAIN_B * L / dt:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"6*N*B*L = {flops:.4e} FLOP = {flops / dt / BF16_PEAK:.4f} of "
          f"989 TFLOP/s; launches a step "
          f"{json.dumps({k: v // TRAIN_TIMED for k, v in launches.items()})}")

    stages = {}

    def timed_stage(name, fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = round(time.time() - t, 4)
        return out

    ids, labels = timed_stage("tokenize", lambda: tokenize(px))
    timed_stage("forward_backward", lambda: model(ids, labels)["loss"]
                .backward())
    timed_stage("clip_adamw", state.apply_gradients)
    print("train: stage wall seconds " + json.dumps(stages))
    profile_train_step(torch, step, dt)
    del tokenizer, model, state, metrics, warm
    torch.cuda.empty_cache()
    return launches


def profile_train_step(torch, step, step_s, tag="train"):
    """Device time of one training step by kernel, from a kernel trace."""
    res = {}
    with kernel_trace(torch, res):
        step()
    total, kernels = res["seconds"], res["kernels"]
    if not total:
        print(f"{tag}: the profiler recorded no device time: device seconds "
              "not measured")
        return
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_" in e.key) / 1e6
    vq = sum(e.self_device_time_total for e in kernels
             if "vq_argmin" in e.key) / 1e6
    print(f"{tag}: one profiled step: device {total:.4f} s, busy share "
          f"{total / step_s:.4f} of the unprofiled step, flash-attention "
          f"kernels {flash:.4f} s ({flash / total:.4f} of device time), VQ "
          f"argmin {vq:.4f} s")
    print(f"{tag}: top kernels (name, launches, device s): "
          + json.dumps(top_kernels(kernels, 12, width=70)))


def phase_tok_train(torch, wide):
    """The tokenizer (VQGAN) training step, the JAX bench's tok64 regime:
    TOKENIZER_64 (or its wide-codebook variant), DiscriminatorConfig()
    (hidden 512, depth 6) and LPIPS, random weights from a seed, bf16
    compute over fp32 masters, B=16, T=8, ctx=2, 64 px, one fixed batch.
    Each G+D pair quantizes context and dynamics twice: K1 4 times (K2 4
    times at the wide codebooks). The bench's depth 6 ends, at 64 px, in a
    1x1 map that InstanceNorm sets to 0 (constant logits, no D gradient,
    the adaptive weight at its clip); the training CLI builds depth 4,
    which the fp32 check uses."""
    from torch.utils.flop_counter import FlopCounterMode
    from ivideogpt_tpu_torch.configs import TOKENIZER_64, TokenizerTrainConfig
    from ivideogpt_tpu_torch.train import tokenizer_trainer as tt
    name = "tok_train_wide" if wide else "tok_train"
    warmup, timed = ((TOK_WIDE_WARMUP, TOK_WIDE_TIMED) if wide
                     else (TOK_WARMUP, TOK_TIMED))
    t0 = time.time()
    tok_cfg = TOKENIZER_64
    if wide:
        # taming-transformers' VQGAN f16-16384 codebooks: 16 MB padded fp32
        tok_cfg = tok_cfg.replace(num_vq_embeddings=16384,
                                  num_dyn_embeddings=16384, vq_embed_dim=256)
    models = tt.build_tokenizer_train_models(tok_cfg, seed=40 + wide)
    tokenizer, disc, lpips = models
    # the recipe (AdamW lr 5e-4, wd 1e-4, clip 1.0, constant schedule)
    # without warmup
    cfg = TokenizerTrainConfig(batch_size=TRAIN_B, segment_length=TOK_T,
                               context_length=TOK_CTX, lr_warmup_steps=0)
    state, disc_state = tt.create_train_states(tokenizer, disc, cfg)
    g_step = tt.make_generator_step(tokenizer, disc, lpips, cfg, use_gan=True)
    d_step = tt.make_discriminator_step(tokenizer, disc, cfg)
    gen = torch.Generator(device="cuda").manual_seed(41 + wide)
    px = torch.rand(TRAIN_B, TOK_T, 64, 64, 3, device="cuda", generator=gen)
    n_params = [sum(p.numel() for p in m.parameters()) for m in models]
    print(f"{name}: models built in {time.time() - t0:.1f}s (tokenizer "
          f"{n_params[0] / 1e6:.1f}M, discriminator {n_params[1] / 1e6:.1f}M, "
          f"LPIPS {n_params[2] / 1e6:.1f}M; fp32 masters, bf16 compute)")

    def pair():
        torch.cuda.synchronize()
        t = time.time()
        m = g_step(state, px, gen)
        torch.cuda.synchronize()
        t_g = time.time()
        dm = d_step(disc_state, px, gen)
        torch.cuda.synchronize()
        return m, dm, t_g - t, time.time() - t_g

    flops = {}
    for i in range(warmup):
        if i == warmup - 1 and not wide:
            # the last warm-up pair's FLOP by aten op (the VQ kernels, a
            # few GFLOP, are outside aten and not counted)
            for key, fn in (("G", lambda: g_step(state, px, gen)),
                            ("D", lambda: d_step(disc_state, px, gen))):
                with FlopCounterMode(display=False) as counter:
                    fn()
                flops[key] = counter.get_total_flops()
        else:
            pair()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs = [pair() for _ in range(timed)]
    launches = read_counts()
    g_ms = sum(r[2] for r in runs) / timed * 1e3
    d_ms = sum(r[3] for r in runs) / timed * 1e3
    recon = [float(r[0]["recon_loss"]) for r in runs]
    losses = {k: [float(r[0][k]) for r in runs]
              for k in ("gen_loss", "gan_loss", "adaptive_weight")}
    losses["discr_loss"] = [float(r[1]["discr_loss"]) for r in runs]
    print(f"{name}: recon_loss over the timed pairs "
          f"{[round(x, 5) for x in recon]}; "
          + "; ".join(f"{k} {[round(x, 5) for x in v]}"
                      for k, v in losses.items()))
    check(all(x == x and abs(x) != float("inf")
              for v in [recon, *losses.values()] for x in v),
          f"{name}: a loss is not finite")
    if not wide:
        # Adam at lr 5e-4 from random weights moves the loss up and down
        # from pair to pair: the later half's mean against the first pair
        late = sum(recon[timed // 2:]) / (timed - timed // 2)
        check(late < recon[0], f"{name}: recon_loss did not fall over the "
              f"timed pairs ({recon[0]:.5f}, then {late:.5f} on average over "
              f"the later half)")
    want = {"vq_argmin": 0 if wide else 4, "vq_argmin_tiled": 4 if wide else 0,
            "decode_attention": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    for kname, n in want.items():
        check(launches[kname] == n * timed,
              f"{name}: {kname} ran {launches[kname]} times in {timed} "
              f"pairs, not {n} a pair")
    pair_s = (g_ms + d_ms) / 1e3
    line = (f"{name}: {timed} timed G+D pairs, G {g_ms:.2f} ms/step, D "
            f"{d_ms:.2f} ms/step, {TRAIN_B * TOK_T / pair_s:.1f} frames/s "
            f"(B*T = {TRAIN_B * TOK_T} frames a pair), peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"a pair {json.dumps({k: v // timed for k, v in launches.items()})}"
            f"; G ms by pair {[round(r[2] * 1e3, 2) for r in runs]}, D ms "
            f"{[round(r[3] * 1e3, 2) for r in runs]}")
    if flops:
        line += (f"; FLOP of one G step {flops['G']:.4e} "
                 f"({flops['G'] / (g_ms / 1e3) / BF16_PEAK:.4f} of 989 "
                 f"TFLOP/s), of one D step {flops['D']:.4e} "
                 f"({flops['D'] / (d_ms / 1e3) / BF16_PEAK:.4f})")
    print(line)
    res = {}
    with kernel_trace(torch, res):
        g_step(state, px, gen)
        d_step(disc_state, px, gen)
    total, kernels = res["seconds"], res["kernels"]
    if total:
        vq_s = sum(e.self_device_time_total for e in kernels
                   if "vq_argmin" in e.key) / 1e6
        print(f"{name}: one profiled pair: device {total:.4f} s, busy share "
              f"{total / pair_s:.4f} of the unprofiled pair, VQ kernels "
              f"{vq_s:.4f} s ({vq_s / total:.4f} of device time)")
        print(f"{name}: top kernels (name, launches, device s): "
              + json.dumps(top_kernels(kernels, 12, width=70)))
    else:
        print(f"{name}: the profiler recorded no device time: device seconds "
              f"not measured")
    del models, state, disc_state, runs
    torch.cuda.empty_cache()
    return launches


def mbrl_models(torch, dtype, seed, lm_cfg=None):
    """The MBRL world model at MBPO's shapes (TOKENIZER_64, LLAMA_BASE or
    ``lm_cfg``, the action head with the reward head, ctx 2, segment 12,
    frozen codebooks, at most 5 target frames) with random weights from
    ``seed``, computing in ``dtype`` over fp32 masters, on the card."""
    from ivideogpt_tpu_torch.configs import (LLAMA_BASE, TOKENIZER_64,
                                             ActionModelConfig)
    from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
    head = ActionModelConfig(action_dim=MB_A, context_length=CTX,
                             segment_length=MB_SEG, reward_prediction=True)
    return VideoPredictor(TOKENIZER_64, lm_cfg or LLAMA_BASE, head,
                          freeze_codebook=True,
                          max_target_frames=MB_TARGETS, seed=seed,
                          compute_dtype=dtype)


def rollout_parts(torch, prof, names):
    """(host s, device s) of each record_function range in ``names`` from
    a kineto trace: a kernel (or copy) counts for the range during which
    the host called the CUDA runtime (or driver) to launch it, the call
    found by the kernel's correlation id. (Ops and ranges number their
    correlation ids apart from CUPTI's, so only runtime and driver calls,
    named cuda* and cu*, are matched.)"""
    import bisect
    from torch.autograd import DeviceType
    events = list(prof.profiler.kineto_results.events())
    spans, launched_at = [], {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() in names:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name().startswith("cu"):
            launched_at[e.correlation_id()] = e.start_ns()
    spans.sort()   # the ranges do not nest or overlap
    starts = [a for a, _, _ in spans]
    host, device = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for a, b, n in spans:
        host[n] += (b - a) / 1e9
    for e in events:
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.name() in names):
            continue
        t = launched_at.get(e.correlation_id())
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            device[spans[i][2]] += e.duration_ns() / 1e9
    return host, device


def phase_mbrl(torch, vp):
    """The MBRL imagination rollout at MBPO's shapes through the port's
    ``VideoPredictor``: B=32 frame stacks of 3 (64 px) from a seed, horizon
    10, the DrQ-v2 policy (Encoder + Actor, feature 50, hidden 1024, random
    weights, stddev 0.1) inside, bf16 over fp32 masters, int8 KV cache.
    One warm-up rollout (its launches: K1 1, K4 12, K3 2040, nothing else),
    then 3 timed rollouts pipelined as bench.py's run_mbrl does (the next
    dispatched before the previous one is fetched; the clock starts with
    one in flight), then one profiled rollout split by part."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ivideogpt_tpu_torch.mbrl import drqv2
    from ivideogpt_tpu_torch.mbrl.video_predictor import ROLLOUT_RANGES
    policy = drqv2.build_policy((64, 64, 3 * MB_K), MB_A, seed=60)
    obs = np.random.default_rng(61).integers(
        0, 256, (MB_B, 64, 64, 3 * MB_K)).astype(np.uint8)
    gen = torch.Generator(device="cuda").manual_seed(62)

    def dispatch():
        return vp.rollout_async(obs, drqv2.batched_policy, policy, MB_H,
                                frame_stack=MB_K, policy_stddev=0.1,
                                generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    obss, actions, rewards = dispatch().fetch()
    first_s = time.time() - t0
    launches = read_counts()
    print(f"mbrl: first rollout {first_s:.2f}s, launches {launches}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {"vq_argmin": 1, "vq_argmin_tiled": 0,
            "decode_attention": 10 * 17 * 12, "flash_attention_fwd": 12,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    for name, n in want.items():
        check(launches[name] == n, f"mbrl: {name} ran {launches[name]} "
              f"times in a rollout, not {n}")
    check(obss.shape == (MB_B, MB_H + 1, 64, 64, 3 * MB_K)
          and obss.dtype == np.uint8, f"mbrl: obs {obss.shape} {obss.dtype}")
    check(actions.shape == (MB_B, MB_H + 1, MB_A)
          and rewards.shape == (MB_B, MB_H + 1),
          f"mbrl: actions {actions.shape}, rewards {rewards.shape}")
    check(bool((np.abs(actions) < 1).all()), "mbrl: an action outside "
          "(-1, 1)")
    check(bool(np.isfinite(rewards).all()), "mbrl: a reward is not finite")
    check(bool((obss[:, 0] == obs).all()), "mbrl: the first stack is not "
          "the input")
    print(f"mbrl: obs {obss.shape} uint8, actions {actions.shape} in "
          f"[{actions.min():.4f}, {actions.max():.4f}], rewards "
          f"{rewards.shape} finite, in [{rewards.min():.4f}, "
          f"{rewards.max():.4f}]")

    pending = dispatch()
    t0 = time.time()
    for _ in range(MB_TIMED):
        nxt = dispatch()
        pending.fetch()
        pending = nxt
    dt = (time.time() - t0) / MB_TIMED
    pending.fetch()
    frames = MB_B * MB_H
    print(f"mbrl: {MB_TIMED} timed rollouts (pipelined), {dt:.4f} "
          f"s/rollout, {frames / dt:.2f} imagined frames/s ({frames} frames "
          f"a rollout); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        dispatch().fetch()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    total = sum(e.self_device_time_total for e in kernels) / 1e6
    if not total:
        print("mbrl: the profiler recorded no device time: device seconds "
              "not measured")
        return launches
    host, device = rollout_parts(torch, prof, ROLLOUT_RANGES)
    print(f"mbrl: one profiled rollout: wall {wall:.4f} s (profiled), "
          f"device {total:.4f} s, busy share {total / dt:.4f} of the "
          f"unprofiled rollout ({total / wall:.4f} of the profiled one)")
    print("mbrl: by part, host s " + json.dumps(
        {k: round(v, 4) for k, v in host.items()}) + ", device s "
        + json.dumps({k: round(v, 4) for k, v in device.items()})
        + f" (device s not attributed to a part "
        f"{total - sum(device.values()):.4f})")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print("mbrl: top kernels (name, launches, device s): "
          + json.dumps(top_kernels(kernels, 12, width=70)))
    return launches


def mbrl_batch(torch, b, seed):
    """A train() batch from a seed: uint8-valued frames [b, 12, 64, 64, 3],
    actions [b, 12, 4] in (-1, 1), rewards [b, 12]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    obs = torch.randint(0, 256, (b, MB_SEG, 64, 64, 3), device="cuda",
                        generator=g).float()
    action = torch.rand(b, MB_SEG, MB_A, device="cuda", generator=g) * 2 - 1
    reward = torch.randn(b, MB_SEG, device="cuda", generator=g)
    return obs, action, reward


def phase_mbrl_train(torch, vp):
    """The world model's online finetuning at MBPO's shapes: train() at
    B=16, T=12, at most 5 target frames, frozen codebooks, bf16 over fp32
    masters: 1 warm-up and 3 timed calls (each one tokenizer step and one
    LM step, synchronised by its float metrics). Losses finite, the
    codebooks bit-unchanged; launches a call: K1 4 (the tokenizer step's
    context and target lookups, the LM step's tokenize), K4/K5/K6 12."""
    from ivideogpt_tpu_torch.mbrl.video_predictor import CODEBOOKS
    batch = mbrl_batch(torch, MB_TRAIN_B, 63)
    books = {n: p.detach().clone() for n, p in vp.tokenizer.named_parameters()
             if n in CODEBOOKS}
    vp.train(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    metrics = [vp.train(batch) for _ in range(MB_TIMED)]
    dt = (time.time() - t0) / MB_TIMED
    launches = read_counts()
    keys = ("tokenizer_loss", "recon_loss", "perceptual_loss", "ce_loss",
            "reward_loss", "tokenizer_grad_norm", "model_grad_norm")
    print("mbrl train: " + "; ".join(
        f"{k} {[round(m[k], 5) for m in metrics]}" for k in keys))
    check(all(v == v and abs(v) != float("inf") for m in metrics
              for v in m.values()), "mbrl train: a metric is not finite")
    for n, p in vp.tokenizer.named_parameters():
        if n in CODEBOOKS:
            check(torch.equal(p, books[n]), f"mbrl train: {n} moved")
    want = {"vq_argmin": 4, "vq_argmin_tiled": 0, "decode_attention": 0,
            "flash_attention_fwd": 12, "flash_attention_bwd_dkv": 12,
            "flash_attention_bwd_dq": 12}
    for name, n in want.items():
        check(launches[name] == n * MB_TIMED,
              f"mbrl train: {name} ran {launches[name]} times in "
              f"{MB_TIMED} calls, not {n} a call")
    print(f"mbrl train: {MB_TIMED} timed calls, {dt * 1e3:.2f} ms a call "
          f"(model_update_time "
          f"{[round(m['model_update_time'] * 1e3, 2) for m in metrics]} ms),"
          f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
          f" codebooks bit-unchanged; launches a call "
          f"{json.dumps({k: v // MB_TIMED for k, v in launches.items()})}")
    return launches


def phase_mbrl_check(torch):
    """A B=2 fp32 rollout on the card (K1, the fp32 K4 prefill, K3 over the
    int8 cache) with replayed actions, held against the CPU's plain path on
    the rollout's own token stream: context ids, teacher-forced logits over
    an int8 cache, the rewards from the same replay's hidden states, and
    the frames decoded from the sampled ids; each at the check phase's
    tolerance. The full TOKENIZER_64 and LLAMA_BASE."""
    import copy
    import numpy as np
    from ivideogpt_tpu_torch import generation, tokens
    from ivideogpt_tpu_torch.mbrl.utils import symlog
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    b = 2
    vp = mbrl_models(torch, torch.float32, seed=64)
    rng = np.random.default_rng(65)
    obs = rng.integers(0, 256, (b, 64, 64, 3 * MB_K)).astype(np.uint8)
    replay = rng.uniform(-1, 1, (b, MB_H, MB_A)).astype(np.float32)
    reset_counts()
    pending = vp.rollout_async(obs, None, None, MB_H, frame_stack=MB_K,
                               generator=torch.Generator(
                                   device="cuda").manual_seed(66),
                               replay_actions=replay)
    obss, actions, rewards = pending.fetch()
    counts = read_counts()
    check(counts["vq_argmin"] == 1 and counts["flash_attention_fwd"] == 12
          and counts["decode_attention"] == 10 * 17 * 12,
          f"mbrl check: launches {counts}")
    toks = pending.result.tokens
    cfg = vp.tok_cfg
    frames = torch.from_numpy(obs).cuda().float().div(255).view(
        b, 64, 64, MB_K, 3).movedim(3, 1)[:, -CTX:].contiguous()
    action = np.zeros((b, MB_SEG, MB_A), np.float32)
    action[:, CTX - 1:CTX - 1 + MB_H] = replay
    action = torch.from_numpy(action)

    def stream_of(idx_c):
        sdf = toks.new_full((b, MB_H, 1), cfg.sdf_token)
        dyn = torch.cat([toks, sdf], 2).reshape(b, -1)[:, :-1]
        return torch.cat([tokens.make_prelude(
            idx_c, cfg.num_vq_embeddings, cfg.num_dyn_embeddings), dyn], 1)

    with torch.inference_mode(), full_fp32():
        ids = vp.tokenizer.encode_context(frames)
        stream = stream_of(ids)
        logits = generation.replay_logits(
            vp.model, stream, segment_length=MB_SEG, context_length=CTX,
            action=action.cuda(), cache_dtype=torch.int8).cpu()
    torch.set_num_threads(os.cpu_count() or 1)
    tok_cpu = copy.deepcopy(vp.tokenizer).cpu()
    lm_cpu = copy.deepcopy(vp.model).cpu()
    hidden = []   # the replay's hidden states, the reward head's input
    decode = lm_cpu.decode_cached

    def keep_hidden(embeds, cache, index):
        out = decode(embeds, cache, index)
        hidden.append(out[0][:, -1])
        return out
    lm_cpu.decode_cached = keep_hidden
    with torch.inference_mode():
        ids_cpu = tok_cpu.encode_context(frames.cpu())
        ref_logits = generation.replay_logits(
            lm_cpu, stream.cpu(), segment_length=MB_SEG, context_length=CTX,
            action=action, cache_dtype=torch.int8)
        last = torch.arange(MB_H) * 17 + 16   # after each frame's 16th token
        ref_rewards = lm_cpu.reward(torch.stack(hidden)[last]).T
        _, dcache = tok_cpu.build_decode_cache(ids.cpu())
        dyn = (toks.cpu() - cfg.num_vq_embeddings).clamp(
            0, cfg.num_dyn_embeddings - 1)
        ref_frames = torch.stack([tok_cpu.decode_dyn_frame(dyn[:, f], dcache)
                                  for f in range(MB_H)], 1)
    ref_u8 = torch.round(ref_frames.clamp(0, 1) * 255)
    same = float((ids.cpu() == ids_cpu).float().mean())
    dl = float((logits - ref_logits).abs().max())
    dr = float((symlog(torch.from_numpy(rewards[:, 1:])) - ref_rewards)
               .abs().max())
    got = torch.from_numpy(obss[:, 1:, ..., -3:]).float()
    df = float((got - ref_u8).abs().max())
    print(f"mbrl check: context ids equal to the CPU path {same:.4f}; max "
          f"|logit diff| {dl:.3e} (tolerance 2e-2); max |reward diff| "
          f"{dr:.3e} (symlog space, tolerance 2e-2); max |frame diff| {df} "
          f"levels of 255 (tolerance 1: the check phase's 1e-3 before "
          f"rounding)")
    # fp32 on both sides, TF32 off: ids may flip only at near ties; an int8
    # cache rounding may flip where the card's k/v differ in the last bits
    check(same >= 0.99, "mbrl check: context ids differ from the CPU path")
    check(dl < 2e-2, "mbrl check: teacher-forced logits differ from the "
          "CPU path")
    check(dr < 2e-2, "mbrl check: rewards differ from the CPU path")
    check(df <= 1, "mbrl check: frames differ from the CPU path")
    del vp
    torch.cuda.empty_cache()


def phase_mbrl_train_check(torch):
    """One fp32 train() on the card and on the CPU from the same weights
    and batch, B=2: the tokenizer at full widths, LLAMA_BASE widths at 2
    layers, frozen codebooks, the same target frames (each side's
    generator from the same seed). The two steps are held apart: the
    tokenizer step first, then the LM step with the CPU's tokenizer set to
    the card's updated one and fed the card's token ids (the CPU's ids are
    compared first, as in the train check), so neither step's differences
    reach the other. The metrics (losses, grad norms) within 1e-4 relative
    (the train checks' tolerance); the updated parameters: AdamW's first
    step moves an element by about lr, with the sign of its gradient, so at
    least 99 % of each model's elements must move the same way on both (an
    element whose gradient is near zero, or behind an LPIPS kink, can
    flip); the codebooks bit-unchanged on both."""
    from ivideogpt_tpu_torch.configs import LLAMA_BASE
    from ivideogpt_tpu_torch.mbrl.video_predictor import (CODEBOOKS,
                                                          VideoPredictor)
    lm_cfg = LLAMA_BASE.replace(num_hidden_layers=2)
    card = mbrl_models(torch, torch.float32, seed=67, lm_cfg=lm_cfg)

    def on_cpu(module):
        return {k: v.cpu() for k, v in module.state_dict().items()}
    host = VideoPredictor(
        card.tok_cfg, lm_cfg, card.head_cfg, freeze_codebook=True,
        max_target_frames=MB_TARGETS, seed=67, compute_dtype=torch.float32,
        tok_state_dict=on_cpu(card.tokenizer),
        lm_state_dict=on_cpu(card.model),
        lpips_state_dict=on_cpu(card.lpips), device="cpu")
    before = {n: p.detach().cpu().clone() for m in (card.tokenizer,
                                                    card.model)
              for n, p in m.named_parameters()}
    batch = mbrl_batch(torch, 2, 68)
    batch_cpu = tuple(t.cpu() for t in batch)
    torch.set_num_threads(os.cpu_count() or 1)
    reset_counts()
    m_card = card.train(batch, update_model=False)
    m_cpu = host.train(batch_cpu, update_model=False)
    host.tokenizer.load_state_dict(on_cpu(card.tokenizer))
    ids = []
    tokenize = card.tokenizer.tokenize
    card.tokenizer.tokenize = lambda *a: ids.append(tokenize(*a)) or ids[-1]
    host_tokenize = host.tokenizer.tokenize
    same = []

    def card_ids(*a):
        mine = host_tokenize(*a)
        same.append(float((mine[0] == ids[0][0].cpu()).float().mean()))
        return tuple(t.cpu() for t in ids[0])
    host.tokenizer.tokenize = card_ids
    m_card.update(card.train(batch, update_tokenizer=False))
    counts = read_counts()
    m_cpu.update(host.train(batch_cpu, update_tokenizer=False))
    check(counts["vq_argmin"] == 4 and counts["flash_attention_fwd"] == 2
          and counts["flash_attention_bwd_dq"] == 2,
          f"mbrl train check: launches {counts}")
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
           for k in m_cpu if k != "model_update_time"}
    agree = {}
    for label, mc, mh in (("tokenizer", card.tokenizer, host.tokenizer),
                          ("LM", card.model, host.model)):
        moved_same = total = 0
        for (n, p), q in zip(mc.named_parameters(), mh.parameters()):
            d_card = p.detach().cpu() - before[n]
            d_cpu = q.detach() - before[n]
            if n in CODEBOOKS:
                check(not d_card.any() and not d_cpu.any(),
                      f"mbrl train check: {n} moved")
                continue
            moved_same += int((torch.sign(d_card) == torch.sign(d_cpu))
                              .sum())
            total += d_card.numel()
        agree[label] = moved_same / total
    print(f"mbrl train check: the LM step's ids equal to the CPU "
          f"tokenizer's {same[0]:.4f}; relative diffs " + json.dumps(
              {k: float(f"{v:.3e}") for k, v in rel.items()})
          + " (tolerance 1e-4); share of elements moved the same way "
          + json.dumps({k: round(v, 6) for k, v in agree.items()})
          + " (at least 0.99); codebooks bit-unchanged on both")
    failed = [k for k, v in rel.items() if not v <= 1e-4]
    check(same[0] >= 0.99, "mbrl train check: ids differ from the CPU "
          "tokenizer")
    check(not failed, f"mbrl train check: {', '.join(failed)} differ from "
          f"the CPU path")
    check(min(agree.values()) >= 0.99, "mbrl train check: the updates "
          "differ from the CPU path")
    del card, host
    torch.cuda.empty_cache()


def grad_errors(names, grads, grads_ref):
    """The worst (error, name) of a model's gradients against the reference
    gradients, by the norm of the difference over the reference's norm and
    by the largest element over the reference's max; each denominator is
    floored at 1e-3 of the model's largest, since a bias in front of
    InstanceNorm, or the key bias of a softmax, has a gradient that is zero
    but for rounding."""
    norm_floor = 1e-3 * max(float(g.norm()) for g in grads_ref)
    max_floor = 1e-3 * max(float(g.abs().max()) for g in grads_ref)
    by_norm, by_max = [], []
    for n, g, g_ref in zip(names, grads, grads_ref):
        diff = g.cpu() - g_ref
        by_norm.append((float(diff.norm()) / max(float(g_ref.norm()),
                                                 norm_floor), n))
        by_max.append((float(diff.abs().max())
                       / max(float(g_ref.abs().max()), max_floor), n))
    return max(by_norm), max(by_max)


def phase_tok_train_check(torch):
    """One fp32 G step and one D step on the card held against the CPU's
    plain path with the same weights, batch and spectral-norm stats:
    TOKENIZER_64 at full width with cross-attention dropout 0 (dropout
    draws cannot be compared), LPIPS, B=4, and the discriminator at its
    full width (hidden 512) and the depth the training CLI builds it with
    (train_tokenizer.py's --disc_depth, 4; 4x4 logits at 64 px). The
    timed cells' DiscriminatorConfig() (depth 6) would not test anything
    here: at 64 px its sixth stride-2 conv leaves a 1x1 map that
    InstanceNorm sets to 0, so every input gets the same logits, the D
    gradients are zero and the adaptive weight is pinned at its 1e4 clip.

    Tolerances: the losses, adaptive weight and grad norms within 1e-4
    relative; the updated u within 1e-5; the D gradients within 1e-3 of
    their max and norm, the CPU's D step fed the card's reconstructions
    (the tokenizer forward is held by the G step; the discriminator's
    leaky-ReLU kinks would otherwise turn its ~1e-6 differences into jumps).
    The G gradients within 1e-2 of their max and norm, or 4 times the
    CPU's own spread (the CPU against itself at fewer threads, by norm and
    by element, whichever is larger) where that is larger: the backward
    into the encoders' first blocks runs through ~40 layers and GroupNorms
    and magnifies rounding there, for the CPU as for the card, so 1e-3
    cannot be held (on an H100 the card reads about 7e-3 there, 3.6 to
    3.9 times the CPU's spread). B=4, not 2,
    narrows the adaptive weight's spread. The VQ ids are compared first;
    the CPU then runs on the card's ids, so a near-tie flip does not move
    the losses."""
    import copy
    from ivideogpt_tpu_torch.configs import (TOKENIZER_64, DiscriminatorConfig,
                                             TokenizerTrainConfig)
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.train import tokenizer_trainer as tt
    b = 4
    cfg = TokenizerTrainConfig(batch_size=b, segment_length=TOK_T,
                               context_length=TOK_CTX, lr_warmup_steps=0)
    card = tt.build_tokenizer_train_models(
        TOKENIZER_64.replace(cross_attn_dropout=0.0),
        DiscriminatorConfig(depth=4), compute_dtype=torch.float32, seed=50)
    host = [copy.deepcopy(m).cpu() for m in card]
    g = torch.Generator(device="cuda").manual_seed(51)
    px = torch.rand(b, TOK_T, 64, 64, 3, device="cuda", generator=g)
    lookup = vq.vq_lookup
    card_ids, card_recons = [], []

    def steps(models, px, lookup_fn, recons):
        """[(metrics, gradients)] of the G step and the D step, the
        gradients kept instead of applied; ``recons`` stands in for the
        tokenizer in the D step."""
        tok, disc, lpips = models
        state, disc_state = tt.create_train_states(tok, disc, cfg)
        kept = []
        for s in (state, disc_state):
            s.apply_gradients = lambda s=s: kept.append(
                [p.grad.detach().clone() for p in s.params])
        vq.vq_lookup = lookup_fn
        try:
            out = [tt.make_generator_step(tok, disc, lpips, cfg,
                                          use_gan=True)(state, px)]
            tok.forward = recons
            out.append(tt.make_discriminator_step(tok, disc, cfg)(disc_state,
                                                                  px))
        finally:
            vq.vq_lookup = lookup
            tok.__dict__.pop("forward", None)
        return list(zip(out, kept))

    def card_lookup(z, e):
        card_ids.append(lookup(z, e))
        return card_ids[-1]

    def card_forward(*args, **kw):
        card_recons.append(type(card[0]).forward(card[0], *args, **kw))
        return card_recons[-1]

    reset_counts()
    ours = steps(card, px, card_lookup, card_forward)
    counts = read_counts()
    check(counts["vq_argmin"] == 4 and counts["vq_argmin_tiled"] == 0,
          f"tok_train check: VQ launches {counts}, not K1 4 and K2 0")

    threads = os.cpu_count() or 1
    torch.set_num_threads(threads)
    queue = list(card_ids)

    def host_lookup(z, e):
        """The CPU's ids held against the card's; the card's go on."""
        mine = lookup(z, e)
        theirs = queue.pop(0).cpu().view(mine.shape)
        d = z.shape[-1]
        near_tie_gate(torch, f"tok_train check: card ids against the CPU's "
                      f"(D={d})", z.reshape(-1, d).float(), e.float(),
                      theirs.reshape(-1), mine.reshape(-1))
        return theirs

    def host_forward(*args, **kw):
        return tuple(t.cpu() for t in card_recons[0])

    host_again = [copy.deepcopy(m) for m in host]
    ref = steps(host, px.cpu(), host_lookup, host_forward)
    # the CPU against itself at fewer threads (sums in another order): the
    # spread that the G gradients' tolerance is set against
    torch.set_num_threads(max(1, threads // 2 - 1))
    queue = list(card_ids)
    again = steps(host_again, px.cpu(), host_lookup, host_forward)
    torch.set_num_threads(threads)
    names = [n for n, p in card[0].named_parameters() if p.requires_grad]
    spread = grad_errors(names, again[0][1], ref[0][1])
    g_tol = max(1e-2, 4 * max(spread[0][0], spread[1][0]))
    moved = {k: abs(float(again[0][0][k]) - float(ref[0][0][k]))
             / abs(float(ref[0][0][k])) for k in ("adaptive_weight",
                                                  "grad_norm")}
    print(f"tok_train check: the CPU at {threads} threads against "
          f"{max(1, threads // 2 - 1)}: G gradients worst by norm "
          f"{spread[0][1]} at {spread[0][0]:.3e}, by element {spread[1][1]} "
          f"at {spread[1][0]:.3e}, so the G gradients' tolerance is "
          f"{g_tol:.3e}; relative diffs "
          + json.dumps({k: float(f"{v:.3e}") for k, v in moved.items()}))
    failed = []
    for label, (m, grads), (m_ref, grads_ref), model, keys, tol in (
            ("G", ours[0], ref[0], card[0],
             ("gen_loss", "adaptive_weight", "grad_norm"), g_tol),
            ("D", ours[1], ref[1], card[1], ("discr_loss", "disc_grad_norm"),
             1e-3)):
        rel = {k: abs(float(m[k]) - float(m_ref[k]))
               / max(abs(float(m_ref[k])), 1e-30) for k in keys}
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        by_norm, by_max = grad_errors(names, grads, grads_ref)
        print(f"tok_train check, {label}: relative diffs "
              + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()})
              + f" (tolerance 1e-4); worst gradient by norm {by_norm[1]} at "
              f"{by_norm[0]:.3e} of its norm, by element {by_max[1]} at "
              f"{by_max[0]:.3e} of its max (tolerance {tol:.3e})")
        failed += [f"{label} {k}" for k, v in rel.items() if not v <= 1e-4]
        failed += [f"{label} {n}'s gradient" for e, n in (by_norm, by_max)
                   if not e <= tol]
    aw = [float(r[0][0]["adaptive_weight"]) for r in (ours, ref)]
    u_err = max(float((u.cpu() - u_ref).abs().max())
                for (n, u), u_ref in zip(card[1].named_buffers(),
                                         host[1].buffers()) if n.endswith(".u"))
    print(f"tok_train check: adaptive weight {aw[0]:.6f} on the card, "
          f"{aw[1]:.6f} on the CPU; updated u max |diff| {u_err:.3e} "
          f"(tolerance 1e-5)")
    # fp32 on both sides, TF32 off, the same ids: cuDNN, the kernels and
    # the CPU sum in other orders
    check(0 < aw[1] < 1e4 and float(ref[1][0]["disc_grad_norm"]) > 0,
          "tok_train check: the discriminator does not see its input")
    check(not failed, f"tok_train check: differs from the CPU path: "
          f"{', '.join(failed)}")
    check(u_err <= 1e-5, "tok_train check: the updated spectral-norm u "
          "differs from the CPU path")
    del card, ours, card_recons
    torch.cuda.empty_cache()


def phase_train_check(torch, dropout=False):
    """One fp32 training forward/backward at B=2 on the card (K1, K4, K5,
    K6) held against the same step on the CPU's plain path, with the same
    weights and batch: LLAMA_BASE widths at a depth cut to 2 layers to stay
    within the time limit, the full TOKENIZER_64. With ``dropout`` (the
    ``train_gpt check`` phase), attention dropout DROP_P keyed by the same
    (seed, step) on both sides: the kernels' Philox mask on the card, the
    plain version's in torch on the CPU. Returns the card's launches."""
    import copy
    from ivideogpt_tpu_torch.configs import LLAMA_BASE
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    from ivideogpt_tpu_torch.train.optim import global_norm
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    b, depth = 2, 2
    tag = "train_gpt check" if dropout else "train check"
    key = (DROP_SEED, 17) if dropout else None
    lm_cfg = LLAMA_BASE.replace(num_hidden_layers=depth,
                                attention_dropout=DROP_P if dropout else 0.0)
    tokenizer, model = gt.build_train_models(
        lm_cfg=lm_cfg, context_length=CTX,
        segment_length=T, compute_dtype=torch.float32, seed=12)
    tok_cpu, model_cpu = (copy.deepcopy(m).cpu() for m in (tokenizer, model))
    g = torch.Generator(device="cuda").manual_seed(13)
    px = torch.rand(b, T, 64, 64, 3, device="cuda", generator=g)
    reset_counts()
    ids, labels = gt.make_tokenize_fn(tokenizer, CTX)(px)
    with full_fp32():
        loss = model(ids, labels, dropout_key=key)["loss"]
        loss.backward()
    loss = loss.detach()
    counts = read_counts()
    for name in ("vq_argmin", "flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        check(counts[name] == 2, f"{tag}: {name} ran {counts[name]} "
              f"times, not 2")
    gnorm = float(global_norm(p.grad for p in model.parameters()
                              if p.grad is not None))

    torch.set_num_threads(os.cpu_count() or 1)
    ids_cpu, _ = gt.make_tokenize_fn(tok_cpu, CTX)(px.cpu())
    same = float((ids.cpu() == ids_cpu).float().mean())
    loss_cpu = model_cpu(ids.cpu(), labels.cpu(), dropout_key=key)["loss"]
    loss_cpu.backward()
    loss_cpu = loss_cpu.detach()
    gnorm_cpu = float(global_norm(p.grad for p in model_cpu.parameters()
                                  if p.grad is not None))
    dl = abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu))
    dn = abs(gnorm - gnorm_cpu) / gnorm_cpu
    worst, worst_name = 0.0, ""
    for (name, p), p_cpu in zip(model.named_parameters(),
                                model_cpu.parameters()):
        if p_cpu.grad is None:
            check(p.grad is None, f"{tag}: {name} has a gradient on "
                  f"the card only")
            continue
        rel = float((p.grad.cpu() - p_cpu.grad).abs().max()
                    / p_cpu.grad.abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    print(f"{tag}: ids equal to the CPU tokenizer's {same:.4f}; loss "
          f"{float(loss):.6f} vs {float(loss_cpu):.6f} (relative diff "
          f"{dl:.3e}, tolerance 1e-4); grad norm {gnorm:.6f} vs "
          f"{gnorm_cpu:.6f} (relative diff {dn:.3e}, tolerance 1e-4); worst "
          f"gradient {worst_name} at {worst:.3e} of its max (tolerance "
          f"1e-3)")
    # fp32 on both sides, TF32 off; the kernels, cuBLAS and the CPU sum in
    # other orders, and the differences compound through the backward
    check(same >= 0.99, f"{tag}: ids differ from the CPU tokenizer")
    check(dl < 1e-4, f"{tag}: the loss differs from the CPU path")
    check(dn < 1e-4, f"{tag}: the grad norm differs from the CPU path")
    check(worst < 1e-3, f"{tag}: {worst_name}'s gradient differs from "
          f"the CPU path")
    return counts


def write_episodes(root, n, frames, seed, size=64):
    """``{root}/cmu_stretch/episode_*.npz`` for the ``debug`` mix: uint8
    frames [frames, size, size, 3] under ``image`` and actions [frames, 4]
    under ``action``, from a seed."""
    import numpy as np
    d = os.path.join(root, "cmu_stretch")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for e in range(n):
        np.savez(os.path.join(d, f"episode_{e:03d}.npz"),
                 image=rng.integers(0, 256, (frames, size, size, 3),
                                    dtype=np.uint8),
                 action=rng.normal(size=(frames, 4)).astype(np.float32))
    return root


def write_bair(root, n_train, n_test, frames, seed):
    """``{root}/bair_{train,test}/traj_*.npz`` (uint8 ``aux1_image`` [frames,
    64, 64, 3] and ``action`` [frames, 4], from a seed) and
    ``{root}/DATASET.yaml`` registering them as ``bair_train_dataset`` and
    ``bair_test_dataset``: the registry the loaders read from the working
    directory."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lines = []
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, f"bair_{split}")
        os.makedirs(d)
        for e in range(n):
            np.savez(os.path.join(d, f"traj_{e:04d}.npz"),
                     aux1_image=rng.integers(0, 256, (frames, 64, 64, 3),
                                             dtype=np.uint8),
                     action=rng.normal(size=(frames, 4)).astype(np.float32))
        lines.append(f"bair_{split}_dataset: {d}\n")
    with open(os.path.join(root, "DATASET.yaml"), "w") as f:
        f.writelines(lines)
    return root


def lzw_decode(raw, min_code, n):
    """n palette indices from GIF LZW data (a decoder of its own, to read
    back what ``utils/image_io.write_gif`` wrote)."""
    import numpy as np
    clear, end = 1 << min_code, (1 << min_code) + 1
    bits, pos = int.from_bytes(raw, "little"), 0
    width, table, prev, out = min_code + 1, None, None, []
    while True:
        code = (bits >> pos) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            width, prev = min_code + 1, None
            continue
        if code == end:
            break
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code < len(table) else prev + prev[:1]
            table.append(prev + entry[:1])
        out.append(entry)
        prev = entry
        if len(table) == 1 << width and width < 12:
            width += 1
    return np.frombuffer(b"".join(out), np.uint8)[:n]


def read_gif(path):
    """(frames uint8 [H, W, 3], delays in 1/100 s, loop count) of a GIF
    with one global palette."""
    import struct
    import numpy as np
    data = open(path, "rb").read()
    check(data[:6] == b"GIF89a", f"{path}: not a GIF89a file")
    pal = np.frombuffer(data[13:13 + 768], np.uint8).reshape(256, 3)
    pos, frames, delays, loop = 13 + 768, [], [], None

    def blocks(pos):
        out = []
        while data[pos]:
            out.append(data[pos + 1:pos + 1 + data[pos]])
            pos += data[pos] + 1
        return out, pos + 1

    while data[pos] != 0x3B:
        if data[pos] == 0x21:
            label = data[pos + 1]
            sub, pos = blocks(pos + 2)
            if label == 0xF9:
                delays.append(struct.unpack("<H", sub[0][1:3])[0])
            elif label == 0xFF and sub[0] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", sub[1][1:3])[0]
        else:
            check(data[pos] == 0x2C, f"{path}: unknown block at {pos}")
            w, h = struct.unpack("<HH", data[pos + 5:pos + 9])
            min_code = data[pos + 10]
            sub, pos = blocks(pos + 11)
            idx = lzw_decode(b"".join(sub), min_code, w * h)
            check(idx.size == w * h, f"{path}: a frame decodes short")
            frames.append(pal[idx].reshape(h, w, 3))
    return frames, delays, loop


def read_png(path):
    """uint8 [H, W, 3] of an 8-bit RGB PNG whose rows all use filter 0."""
    import struct
    import zlib
    import numpy as np
    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG file")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        check(zlib.crc32(kind + body) == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0], f"{path}: bad CRC")
        if kind == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def same_train_state(torch, a, b, what):
    """Gate two TrainStates bit-equal: parameters and buffers, AdamW's
    moments and counts, the counters."""
    sa, sb = a.state_dict(), b.state_dict()
    check((sa["step"], sa["updates"]) == (sb["step"], sb["updates"]),
          f"{what}: counters {sa['step'], sa['updates']} vs "
          f"{sb['step'], sb['updates']}")
    for k, v in sa["model"].items():
        check(torch.equal(v, sb["model"][k]), f"{what}: {k} differs")
    for i, entry in sa["optimizer"]["state"].items():
        for k, v in entry.items():
            check(torch.equal(torch.as_tensor(v),
                              torch.as_tensor(sb["optimizer"]["state"][i][k])),
                  f"{what}: AdamW's {k} of parameter {i} differs")


def phase_train_gpt(torch, root, hub, free):
    """``python -m ivideogpt_tpu_torch.train_gpt``'s ``main`` in-process
    with the BAIR finetune recipe's LM flags
    (``scripts/finetune/bair-64-act-cond.sh:17-31``) at ctx 2, seg 16: bf16
    over fp32 masters, attention dropout 0.1, action-conditioned, the LLaMA
    warm-started from the hub's bare LLaMA through ``--load_internal_llm``,
    B=16, ``--dataset_name bair --use_eval_dataset --use_fvd
    --use_frame_metrics`` on the synthetic BAIR splits that ``root``'s
    ``DATASET.yaml`` registers (the working directory; GPT_EPISODES
    training episodes of GPT_FRAMES frames), I3D and LPIPS at random
    weights. Steps 1-15 checkpoint at 15, then a second run resumes from
    the latest checkpoint and trains to 30, checkpointing there; validation
    with generation, FVD and the frame metrics at 15 and 30.

    Gates: finite losses and validation metrics (``gen_fvd``, ``gen_mse``,
    ``gen_psnr``, ``gen_ssim``, ``gen_lpips`` among them); the launches
    (K4, K5 and K6 12 a training step,
    all with dropout keyed by (seed, global step, layer) across the resume;
    K1 2 a step; the validations' K1 and K4 without dropout; K3 0);
    checkpoint-15 and checkpoint-30 written; each validation's four GIF
    strips decoded (16 frames of 64 x 128, 250 ms, looping); the
    transformer export read
    back by the port's loader bit-equal to the live model; a fresh state
    restored from checkpoint-30 bit-equal to the live one, and one more step
    from each on the same batch bit-equal. Prints ms/step, samples/s and
    the loader's wait a step over the steady log windows, the validations'
    seconds, the peak memory, the step's stage split and device time, and
    ms/step of 10 steps without dropout. Returns the launches of the two
    runs."""
    import numpy as np
    from ivideogpt_tpu_torch import train_gpt
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
    from ivideogpt_tpu_torch.utils import checkpoint as ckpt
    out = os.path.join(root, "run")
    recipe = ["--pretrained_model_name_or_path", hub,
              "--pretrained_transformer_path", free, "--load_internal_llm",
              "--llm_config", "base", "--action_conditioned",
              "--action_dim", "4", "--mixed_precision", "bf16",
              "--attention_dropout", str(DROP_P), "--embed_no_wd",
              "--weight_decay", "0.01", "--batch_size", str(TRAIN_B),
              "--gradient_accumulation_steps", "1", "--learning_rate", "1e-4",
              "--lr_scheduler_type", "cosine", "--dataset_name", "bair",
              "--dataset_path", root, "--use_eval_dataset", "--use_fvd",
              "--use_frame_metrics", "--resolution", "64",
              "--dataloader_num_workers", "16", "--video_stepsize", "1",
              "--segment_length", str(T), "--context_length", str(CTX),
              "--num_warmup_steps", "0", "--validation_eval_batches", "1",
              "--log_steps", "5", "--seed", "0"]

    def argv(*extra, out=out):
        return recipe + ["--output_dir", out, *extra]

    keys, drops, per_step = [], [], []
    real_step, real_drop = train_gpt.train_step, fa._drop_args

    def step_recording(state, batch, rng=None):
        keys.append(rng)
        before = read_counts()
        m = real_step(state, batch, rng)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return m

    def drop_recording(dropout):
        drops.append(dropout)
        return real_drop(dropout)

    train_gpt.train_step, fa._drop_args = step_recording, drop_recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        train_gpt.main(argv("--max_train_steps", str(GPT_CKPT),
                            "--checkpointing_steps", str(GPT_CKPT),
                            "--validation_steps", str(GPT_CKPT)))
        t1 = time.time()
        live = train_gpt.main(argv("--max_train_steps", str(GPT_STEPS),
                                   "--checkpointing_steps", str(GPT_STEPS),
                                   "--validation_steps", str(GPT_CKPT),
                                   "--resume_from_checkpoint", "latest"))
        torch.cuda.synchronize()
        t2 = time.time()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        train_gpt.train_step, fa._drop_args = real_step, real_drop
    print(f"train_gpt: two runs (1-{GPT_CKPT}, then resumed {GPT_CKPT + 1}-"
          f"{GPT_STEPS}) in {t1 - t0:.1f} s and {t2 - t1:.1f} s, models, "
          f"loaders, validations and checkpoints included; launches "
          f"{json.dumps(launches)}; peak memory {peak:.2f} GiB")
    check(keys == [(0, i) for i in range(GPT_STEPS)],
          f"train_gpt: the dropout keys of the steps are {keys[:3]}..., not "
          f"(seed, global step) across the resume")
    want = {"vq_argmin": 2, "flash_attention_fwd": 12,
            "flash_attention_bwd_dkv": 12, "flash_attention_bwd_dq": 12,
            "decode_attention": 0, "vq_argmin_tiled": 0}
    for i, got in enumerate(per_step):
        # the step's own tokenize ran before it: K1 counts 0 inside
        check(all(got[k] == (0 if k == "vq_argmin" else n)
                  for k, n in want.items()),
              f"train_gpt: step {i} launched {got}")
    n_val = GPT_STEPS // GPT_CKPT
    # a validation: 4 held-out batches (K1 2, K4 12 each), one generation
    # batch (its loss: K1 2, K4 12; generate's prefill: K4 12)
    expect = {"vq_argmin": 2 * GPT_STEPS + n_val * 10,
              "flash_attention_fwd": 12 * GPT_STEPS + n_val * 72,
              "flash_attention_bwd_dkv": 12 * GPT_STEPS,
              "flash_attention_bwd_dq": 12 * GPT_STEPS,
              "decode_attention": 0, "vq_argmin_tiled": 0}
    check(launches == expect, f"train_gpt: launches {launches}, not "
          f"{expect}")
    dropped = [d for d in drops if d is not None and d[0] > 0]
    want_drops = sorted((DROP_P, 0, philox.offset_of(i, layer))
                        for i in range(GPT_STEPS) for layer in range(12)
                        for _ in range(3))
    check(sorted(dropped) == want_drops, "train_gpt: the kernels' dropout "
          "arguments are not (0.1, seed, offset_of(step, layer)) for K4, K5 "
          "and K6 of every training step")
    check(len(drops) - len(dropped) == n_val * 72, "train_gpt: the "
          "validations launched K4 with dropout")

    metrics = [json.loads(line) for line in
               open(os.path.join(out, "metrics.jsonl")).read().splitlines()]
    for m in metrics:
        for k, v in m.items():
            check(not isinstance(v, float) or v == v and abs(v) != float(
                "inf"), f"train_gpt: {k} = {v} at step {m['step']}")
    train = {m["step"]: m for m in metrics if "loss" in m}
    val = [m for m in metrics if "eval_loss" in m]
    check(sorted(train) == list(range(5, GPT_STEPS + 1, 5)),
          f"train_gpt: logged steps {sorted(train)}")
    check([m["step"] for m in val] == [GPT_CKPT, GPT_STEPS]
          and all(m["gen_generated"] == TRAIN_B for m in val),
          f"train_gpt: validations {val}")
    gen_keys = ("gen_eval_loss", "gen_perplexity", "gen_mse", "gen_psnr",
                "gen_ssim", "gen_lpips", "gen_fvd")
    check(all(k in m for m in val for k in gen_keys),
          f"train_gpt: a validation lacks one of {gen_keys}: {val}")
    print("train_gpt: the validations' generation metrics "
          + json.dumps([{k: m[k] for k in gen_keys} for m in val]))
    for step in (GPT_CKPT, GPT_STEPS):
        check(os.path.exists(os.path.join(out, f"checkpoint-{step}",
                                          ckpt.STATE_TENSORS)),
              f"train_gpt: checkpoint-{step} was not written")
        for j in range(4):
            frames, delays, loop = read_gif(os.path.join(
                out, "samples", f"pred-{step}-{j}.gif"))
            check(len(frames) == T and delays == [25] * T and loop == 0
                  and all(f.shape == (64, 128, 3) for f in frames),
                  f"train_gpt: pred-{step}-{j}.gif holds {len(frames)} "
                  f"frames, delays {delays[:2]}, loop {loop}")
    print(f"train_gpt: the validations' GIF strips pred-{{{GPT_CKPT},"
          f"{GPT_STEPS}}}-{{0..3}}.gif decode: {T} frames of 64 x 128 each, "
          f"250 ms a frame, looping")
    exported = ckpt.load_action_model_safetensors(
        os.path.join(out, "transformer"))
    live_sd = live.model.state_dict()
    check(sorted(exported) == sorted(live_sd)
          and all(torch.equal(exported[k], v.cpu())
                  for k, v in live_sd.items()),
          "train_gpt: the transformer export differs from the live model")
    # windows of log_steps steps that hold no validation or checkpoint
    steady = [train[s_] for s_ in (10, GPT_CKPT, 25, GPT_STEPS)]
    step_ms = float(np.mean([m["step_ms"] for m in steady]))
    sps = float(np.mean([m["samples_per_sec"] for m in steady]))
    wait_ms = float(np.mean([m["loader_wait_ms"] for m in steady]))
    print(f"train_gpt: losses {[train[s_]['loss'] for s_ in sorted(train)]}; "
          f"steady windows (steps 6-10, 11-15, 21-25, 26-30): "
          f"{step_ms:.2f} ms/step, {sps:.2f} samples/s, the loop waited "
          f"{wait_ms:.3f} ms a step on the loader; validation seconds "
          f"{[round(m['validation_seconds'], 3) for m in val]} (4 held-out "
          f"batches and one generation of B={TRAIN_B} with FVD and the frame "
          f"metrics); eval loss "
          f"{[m['eval_loss'] for m in val]}")

    # resume: a fresh state from checkpoint-30 equals the live one, and so
    # does one more step from each on the same batch
    args = train_gpt.parse_args(argv("--max_train_steps", str(GPT_STEPS)))
    tokenizer, model = train_gpt.build_models(args, torch.device("cuda"))
    fresh = train_gpt.make_train_state(args, model)
    ckpt.restore_train_state(os.path.join(out, f"checkpoint-{GPT_STEPS}"),
                             fresh)
    same_train_state(torch, live, fresh, "train_gpt resume")
    g = torch.Generator(device="cuda").manual_seed(94)
    px = torch.rand(TRAIN_B, T, 64, 64, 3, device="cuda", generator=g)
    action = torch.randn(TRAIN_B, T, 4, device="cuda", generator=g)
    tokenize = train_gpt.make_tokenize_fn(tokenizer, CTX)
    ids, labels = tokenize(px)
    batch = {"input_ids": ids, "labels": labels, "action": action}
    for state in (live, fresh):
        train_gpt.train_step(state, batch, rng=(0, GPT_STEPS))
    same_train_state(torch, live, fresh, "train_gpt: the step after resume")
    print(f"train_gpt: checkpoint-{GPT_CKPT} and checkpoint-{GPT_STEPS} "
          f"written; the export reads back bit-equal; a state restored from "
          f"checkpoint-{GPT_STEPS} equals the live one (parameters, AdamW "
          f"moments and counts, counters), and so does the next step from "
          f"each")

    # where a step's time goes: stage wall seconds and one profiled step
    del fresh, model
    torch.cuda.empty_cache()
    stages = {}

    def timed_stage(name, fn):
        torch.cuda.synchronize()
        t = time.time()
        r = fn()
        torch.cuda.synchronize()
        stages[name] = round(time.time() - t, 4)
        return r

    live.model.train()
    for _ in range(2):
        ids, labels = timed_stage("tokenize", lambda: tokenize(px))
        timed_stage("forward_backward", lambda: live.model(
            ids, labels, action, dropout_key=(0, 99))["loss"].backward())
        timed_stage("clip_adamw", live.apply_gradients)
    print("train_gpt: stage wall seconds (the second of two) "
          + json.dumps(stages))
    def profiled_step():
        ids, labels = tokenize(px)
        train_gpt.train_step(live, {"input_ids": ids, "labels": labels,
                                    "action": action}, rng=(0, 100))
    profile_train_step(torch, profiled_step, step_ms / 1e3, tag="train_gpt")
    del live, tokenizer, batch
    torch.cuda.empty_cache()

    # what dropout costs end to end: 10 steps at attention_dropout 0
    off = os.path.join(root, "run_no_dropout")
    argv_off = argv("--max_train_steps", "10", "--checkpointing_steps",
                    "100000", "--validation_steps", "100000", out=off)
    argv_off[argv_off.index("--attention_dropout") + 1] = "0"
    train_gpt.main(argv_off)
    off_m = {m["step"]: m for m in
             (json.loads(line) for line in open(os.path.join(
                 off, "metrics.jsonl")).read().splitlines())}
    print(f"train_gpt: without dropout, steps 6-10: {off_m[10]['step_ms']:.2f}"
          f" ms/step, {off_m[10]['samples_per_sec']:.2f} samples/s (with "
          f"dropout {step_ms:.2f} ms/step)")
    torch.cuda.empty_cache()
    return launches


def with_conv_flops(torch, model, x):
    """(model(x), the FLOP of its Conv3d layers in that forward, 2 a
    multiply-add), counted from the shapes its forward hooks see."""
    total = [0]

    def hook(mod, inp, out):
        total[0] += 2 * out.numel() * mod.weight[0].numel()
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv3d)]
    try:
        out = model(x)
    finally:
        for h in hooks:
            h.remove()
    return out, total[0]


def phase_eval_gpt(torch, root, hub):
    """``python -m ivideogpt_tpu_torch.train_gpt --eval_only`` in-process
    with ``scripts/evaluation/bair-64-act-cond.sh``'s flags: bf16,
    ``--llm_config base``, ctx 1, seg 16, action-conditioned (dim 4),
    ``--use_fvd --use_frame_metrics --eval_max_batchsize 80``, from the hub
    (its tokenizer re-sliced to ctx 1, the action-conditioned transformer)
    on the synthetic BAIR test split that ``root``'s ``DATASET.yaml``
    registers (the working directory). Cut to ``--eval_generate_times``
    EVAL_REPS (100 in the recipe) and ``--max_eval_batches`` EVAL_BATCHES;
    no ``--i3d_weights`` or ``--lpips_weights`` (the files are not in the
    repository): I3D and LPIPS at random weights from seed 0.

    Gates: every result key finite, perplexity = exp(eval_loss), the clips
    generated; FVD recomputed from the I3D features the run fed equal to
    its result, and the real features against themselves 0 within the
    eigenvalue floor; the launches (K1 2 and K4 12 a batch, K4 12 a
    sample set, K3 0: the decode runs a plain bf16 cache); I3D's logits on
    the card against the CPU port's on EVAL_CHECK of the batch's clips at
    224 px (fp32, TF32 off, 1e-4 of their largest), and against the
    features the run fed them in its chunk of 80; ``best_of_t_metrics`` on
    the card against the CPU on the first batch without LPIPS and on
    EVAL_CHECK clips with it. Prints the wall seconds and their split among
    generate, detokenize, I3D and LPIPS (each call synchronised), I3D's
    FLOP a clip and rate, and the peak memory. Returns the launches."""
    import math
    import numpy as np
    from ivideogpt_tpu_torch import generation, train_gpt
    from ivideogpt_tpu_torch.models.i3d import I3D
    from ivideogpt_tpu_torch.models.lpips import LPIPS
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    from ivideogpt_tpu_torch.utils import video_metric as vm
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    argv = ["--output_dir", os.path.join(root, "eval"), "--seed", "0",
            "--mixed_precision", "bf16", "--pretrained_model_name_or_path",
            hub, "--llm_config", "base", "--dataset_name", "bair",
            "--resolution", "64", "--video_stepsize", "1",
            "--segment_length", str(T), "--context_length", "1",
            "--use_fvd", "--use_frame_metrics", "--eval_only",
            "--eval_generate_times", str(EVAL_REPS),
            "--eval_max_batchsize", str(EVAL_B), "--action_conditioned",
            "--action_dim", "4", "--max_eval_batches", str(EVAL_BATCHES)]
    print(f"eval_gpt: the BAIR evaluation recipe cut to "
          f"--eval_generate_times {EVAL_REPS} (100) and --max_eval_batches "
          f"{EVAL_BATCHES} ({EVAL_BATCHES * EVAL_B} test clips); no "
          f"--i3d_weights or --lpips_weights: random weights from seed 0")
    parts = dict.fromkeys(("generate", "detokenize", "i3d", "lpips"), 0.0)
    peaks = dict.fromkeys(("rest",) + tuple(parts), 0)
    feats, first = [], []

    def timed(part, fn):
        """fn, its calls synchronised and timed into parts[part], the peak
        memory inside them into peaks[part] and outside into peaks["rest"]
        """
        def call(*a, **kw):
            torch.cuda.synchronize()
            peaks["rest"] = max(peaks["rest"],
                                torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t
            peaks[part] = max(peaks[part], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return r
        return call

    real = (generation.generate, CompressiveVQModel.detokenize,
            train_gpt.build_evaluator, vm.Evaluator.i3d_features,
            vm.Evaluator.frame_metrics)

    def build(args, dev):
        ev = real[2](args, dev)
        ev.i3d_fn, ev.lpips_fn = (timed("i3d", ev.i3d_fn),
                                  timed("lpips", ev.lpips_fn))
        return ev

    def features(self, videos):
        feats.append(real[3](self, videos))
        return feats[-1]

    def frames(self, gt, gen):
        if not first:
            first.append((gt, gen))
        return real[4](self, gt, gen)

    generation.generate = timed("generate", real[0])
    CompressiveVQModel.detokenize = timed("detokenize", real[1])
    train_gpt.build_evaluator = build
    vm.Evaluator.i3d_features, vm.Evaluator.frame_metrics = features, frames
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        result = train_gpt.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peaks["rest"] = max(peaks["rest"], torch.cuda.max_memory_allocated())
    finally:
        (generation.generate, CompressiveVQModel.detokenize,
         train_gpt.build_evaluator, vm.Evaluator.i3d_features,
         vm.Evaluator.frame_metrics) = real
    keys = ("eval_loss", "perplexity", "mse", "psnr", "ssim", "lpips", "fvd")
    print("eval_gpt: result " + json.dumps(result))
    check(sorted(result) == sorted(keys + ("generated",)),
          f"eval_gpt: result keys {sorted(result)}")
    check(all(math.isfinite(result[k]) for k in keys),
          f"eval_gpt: a metric is not finite: {result}")
    check(math.isclose(result["perplexity"], math.exp(result["eval_loss"]),
                       rel_tol=1e-12), "eval_gpt: perplexity is not "
          "exp(eval_loss)")
    n_gen = EVAL_BATCHES * EVAL_REPS * EVAL_B
    check(result["generated"] == n_gen,
          f"eval_gpt: {result['generated']} clips generated, not {n_gen}")
    want = {"vq_argmin": 2 * EVAL_BATCHES,
            "flash_attention_fwd": 12 * EVAL_BATCHES * (1 + EVAL_REPS),
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0,
            "decode_attention": 0, "vq_argmin_tiled": 0}
    check(launches == want, f"eval_gpt: launches {launches}, not {want}")

    # FVD from the features the run fed, and real against real
    check(len(feats) == 2 * EVAL_BATCHES
          and all(f.shape == ((EVAL_REPS if i % 2 else 1) * EVAL_B, 400)
                  for i, f in enumerate(feats)),
          f"eval_gpt: I3D features {[f.shape for f in feats]}")
    stats = {"real": vm.FeatureStats(), "gen": vm.FeatureStats()}
    for i, f in enumerate(feats):
        stats["gen" if i % 2 else "real"].append(f)
    fvd = vm.frechet_distance(stats["real"], stats["gen"])
    check(fvd == result["fvd"], f"eval_gpt: FVD from the fed features "
          f"{fvd} != the result's {result['fvd']}")
    d = 400
    floor = 2 * d * math.sqrt(d * np.finfo(np.float64).eps) * float(
        np.linalg.eigvalsh(stats["real"].get_mean_cov()[1]).max())
    self_fvd = vm.frechet_distance(stats["real"], stats["real"])
    check(abs(self_fvd) <= floor, f"eval_gpt: FVD of the real features "
          f"against themselves {self_fvd:.3e}, over the floor {floor:.3e}")
    print(f"eval_gpt: FVD {result['fvd']:.6f} recomputed from the fed "
          f"features; real against real {self_fvd:.3e} (floor {floor:.3e}, "
          f"{stats['real'].num_items} clips, 400 features: rank-deficient)")

    # I3D on the card against the CPU port, the evaluator's weights
    gt, gen = first[0]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        i3d = I3D().eval()
    clips = gt[:EVAL_CHECK]
    with torch.no_grad(), full_fp32():
        want_l, flop = with_conv_flops(torch, i3d, clips.cpu())
        got_l = i3d.to("cuda")(clips).cpu()
    flop //= EVAL_CHECK
    scale = float(want_l.abs().max())
    e_card = float((got_l - want_l).abs().max())
    e_fed = float((torch.from_numpy(feats[0][:EVAL_CHECK]) - want_l)
                  .abs().max())
    check(e_card <= 1e-4 * scale and e_fed <= 1e-4 * scale,
          f"eval_gpt: I3D logits on the card {e_card:.3e} and in the run's "
          f"chunk {e_fed:.3e} from the CPU's (largest {scale:.3e})")
    n_i3d = EVAL_BATCHES * (1 + EVAL_REPS) * EVAL_B
    print(f"eval_gpt: I3D logits of {EVAL_CHECK} clips at 224 px: card "
          f"{e_card:.3e}, the run's chunk of {EVAL_B} {e_fed:.3e} from the "
          f"CPU port's (largest {scale:.3e}, gate 1e-4 of it); "
          f"{flop / 1e9:.2f} GFLOP a clip in its convs, {n_i3d} clips in "
          f"{parts['i3d']:.3f} s: {n_i3d * flop / parts['i3d'] / 1e12:.2f} "
          f"TFLOP/s fp32 (TF32 off)")
    del i3d

    # best_of_t_metrics on the card against the CPU
    with torch.no_grad():
        got = vm.best_of_t_metrics(gt, gen)
        want_m = vm.best_of_t_metrics(gt.cpu(), gen.cpu())
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            lpips = LPIPS().eval()
        idx = torch.cat([torch.arange(EVAL_CHECK) + r * EVAL_B
                         for r in range(EVAL_REPS)]).to(gen.device)
        gt_s, gen_s = gt[:EVAL_CHECK], gen[idx]
        want_s = vm.best_of_t_metrics(gt_s.cpu(), gen_s.cpu(), lpips)
        lpips = lpips.to("cuda")
        with full_fp32():
            got_s = vm.best_of_t_metrics(gt_s, gen_s, lpips)
    tol = {"mse": 1e-7, "psnr": 1e-4, "ssim": 1e-5, "lpips": 1e-5}
    errs = {}
    for tag, a, b in (("batch", got, want_m), ("lpips", got_s, want_s)):
        for k, v in a.items():
            errs[f"{tag} {k}"] = e = abs(float(v) - float(b[k]))
            check(e <= tol[k], f"eval_gpt: best_of_t {k} ({tag}) on the "
                  f"card {float(v)} vs the CPU {float(b[k])}")
    print(f"eval_gpt: best_of_t_metrics on the card against the CPU (the "
          f"first batch, {EVAL_REPS} samples a clip; with LPIPS on "
          f"{EVAL_CHECK} clips), |diff| "
          + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
          + f" (gates {json.dumps(tol)})")
    del lpips, first[:], gt, gen
    torch.cuda.empty_cache()
    rest = wall - sum(parts.values())
    print(f"eval_gpt: {wall:.2f} s wall, models and loader included: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
          + f", the rest (loading, tokenize, loss, MSE/PSNR/SSIM, host) "
          f"{rest:.3f} s; launches {json.dumps(launches)}; peak memory "
          f"{max(peaks.values()) / 2**30:.2f} GiB, by part (GiB) "
          + json.dumps({k: round(v / 2**30, 2) for k, v in peaks.items()}))
    return launches


def phase_train_medium(torch):
    """The medium recipe's LM (``scripts/pretrain/oxe-64-act-free-medium.
    sh``): LLAMA_MEDIUM (24 layers, H=16), act-free, bf16 over fp32
    masters, attention dropout 0.1, B=16, L=751, no remat, the frozen fp32
    TOKENIZER_64 in front; one fixed batch of pixels made on the card.
    MEDIUM_WARMUP then MEDIUM_TIMED steps: finite losses, launches a step
    (K1 2, K4/K5/K6 24), ms/step, tokens/s, peak memory. Returns the timed
    steps' launches."""
    from ivideogpt_tpu_torch import tokens as tok
    from ivideogpt_tpu_torch.configs import LLAMA_MEDIUM, GPTTrainConfig
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    t0 = time.time()
    tokenizer, model = gt.build_train_models(
        lm_cfg=LLAMA_MEDIUM.replace(attention_dropout=DROP_P),
        context_length=CTX, segment_length=T, seed=15)
    n_lm = sum(p.numel() for p in model.parameters())
    state = gt.create_train_state(model, GPTTrainConfig(
        learning_rate=1e-4, lr_scheduler="cosine", lr_warmup_steps=0,
        max_train_steps=1000))
    tokenize = gt.make_tokenize_fn(tokenizer, CTX)
    g = torch.Generator(device="cuda").manual_seed(16)
    px = torch.rand(TRAIN_B, T, 64, 64, 3, device="cuda", generator=g)
    L = tok.seq_len(CTX, T)
    print(f"train_medium: models built in {time.time() - t0:.1f}s (LM "
          f"{n_lm / 1e6:.1f}M fp32 masters, bf16 compute, dropout {DROP_P})")

    def step(i):
        ids, labels = tokenize(px)
        return gt.train_step(state, {"input_ids": ids, "labels": labels},
                             rng=(0, i))

    warm = [step(i) for i in range(MEDIUM_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    metrics = [step(MEDIUM_WARMUP + i) for i in range(MEDIUM_TIMED)]
    torch.cuda.synchronize()
    dt = (time.time() - t0) / MEDIUM_TIMED
    launches = read_counts()
    losses = [float(m["loss"]) for m in warm + metrics]
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "train_medium: a loss is not finite")
    want = {"vq_argmin": 2, "decode_attention": 0, "flash_attention_fwd": 24,
            "flash_attention_bwd_dkv": 24, "flash_attention_bwd_dq": 24}
    for name, n in want.items():
        check(launches[name] == n * MEDIUM_TIMED,
              f"train_medium: {name} ran {launches[name]} times in "
              f"{MEDIUM_TIMED} steps, not {n} a step")
    print(f"train_medium: losses {[round(x, 4) for x in losses]}; "
          f"{MEDIUM_TIMED} timed steps, {dt * 1e3:.2f} ms/step, "
          f"{TRAIN_B * L / dt:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tokenizer, model, state, metrics, warm
    torch.cuda.empty_cache()
    return launches


def counted_steps(cli, record, sync=False):
    """Wrap the tokenizer CLI's step factories: every step call appends
    (kind, the kernels' launches in it, its seconds) to ``record``; kind is
    "G", "G_gan", "D" or "eval". With ``sync`` the seconds are the card's
    too (a synchronize at both ends). Returns a function that restores the
    factories."""
    import torch
    names = {"make_generator_step": "G", "make_discriminator_step": "D",
             "make_eval_step": "eval"}
    real = {n: getattr(cli, n) for n in names}

    def wrap(name):
        def factory(*args, **kw):
            step = real[name](*args, **kw)
            kind = names[name] + ("_gan" if kw.get("use_gan") else "")

            def step_counted(*a, **k):
                if sync:
                    torch.cuda.synchronize()
                before, t = read_counts(), time.perf_counter()
                out = step(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                after = read_counts()
                record.append((kind, {n: after[n] - before[n] for n in after},
                               time.perf_counter() - t))
                return out
            return step_counted
        return factory

    for n in names:
        setattr(cli, n, wrap(n))
    return lambda: [setattr(cli, n, f) for n, f in real.items()]


def k1_per_step(record, what):
    """Gate: every step call launched K1 twice (context and dynamics) and
    no other kernel."""
    for kind, got, _ in record:
        want = {n: (2 if n == "vq_argmin" else 0) for n in got}
        check(got == want, f"{what}: a {kind} step launched {got}")


def cli_metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def finite_metrics(metrics, what):
    for m in metrics:
        for k, v in m.items():
            check(not isinstance(v, float) or (v == v and abs(v) != float(
                "inf")), f"{what}: {k} = {v} at step {m['step']}")


def phase_train_tokenizer(torch, root, hub):
    """``python -m ivideogpt_tpu_torch.train_tokenizer``'s ``main``
    in-process with the BAIR finetune recipe's tokenizer flags
    (``scripts/finetune/bair-64-act-cond.sh:9-17``: bf16, B=16,
    ``--disc_start 1000005``, ``--random_selection``, ``--segment_horizon
    16``, seg 8, ctx 1, 16 loader workers) plus ``--use_ema``, warm-started
    from the hub's ctx=2 TOKENIZER_64 (re-sliced to ctx 1), on TT_EPISODES
    synthetic 64 px episodes: steps 1-20 with a validation and a checkpoint
    at 20, then a second run resumed from the latest checkpoint to 40 with
    another of each; then 10 steps from the hub with ``--disc_start 0`` and
    no warmup, the depth-4 discriminator training.

    Gates: finite metrics; K1 launched twice by every generator,
    discriminator and eval step and no other kernel; 20 generator steps,
    no discriminator step before ``--disc_start``; the validation and
    training grids decode as PNGs of the GT-over-recon shape;
    checkpoint-20 and checkpoint-40 written; the exported tokenizer read
    back by the port's loader equal to the live EMA copy; a fresh state
    restored from checkpoint-40 bit-equal to the live one (both
    TrainStates, the EMA copy, the counters), and so is one more
    generator step, EMA update and discriminator step from each; with the
    discriminator on, its loss moves off its first reading. Prints ms/step,
    samples/s and the loader's wait over the steady windows, the
    validations' seconds, the peak memory, and a G step's wall time with
    no loader running beside its device time in one profiled step.
    Returns the launches of the recipe's two runs."""
    from ivideogpt_tpu_torch import train_tokenizer as cli
    from ivideogpt_tpu_torch.train.optim import ema_update
    from ivideogpt_tpu_torch.utils import checkpoint as ckpt
    data = write_episodes(os.path.join(root, "tok_data"), TT_EPISODES,
                          GPT_FRAMES, seed=95)
    out = os.path.join(root, "tok_run")
    recipe = ["--seed", "0", "--mixed_precision", "bf16", "--batch_size",
              str(TRAIN_B), "--gradient_accumulation_steps", "1",
              "--disc_start", "1000005", "--dataset_name", "debug",
              "--resolution", "64", "--dataloader_num_workers", "16",
              "--random_selection", "--video_stepsize", "1",
              "--segment_horizon", "16", "--segment_length", str(TOK_T),
              "--context_length", "1", "--pretrained_model_name_or_path",
              os.path.join(hub, "tokenizer"), "--dataset_path", data,
              "--use_ema", "--log_steps", "10"]

    def argv(*extra, out=out):
        return recipe + ["--output_dir", out, *extra]

    record = []
    restore = counted_steps(cli, record)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        cli.main(argv("--max_train_steps", str(TT_CKPT),
                      "--checkpointing_steps", str(TT_CKPT),
                      "--validation_steps", str(TT_CKPT)))
        t1 = time.time()
        live, live_disc, progress = cli.main(argv(
            "--max_train_steps", str(TT_STEPS), "--checkpointing_steps",
            str(TT_CKPT), "--validation_steps", str(TT_CKPT),
            "--resume_from_checkpoint", "latest"))
        torch.cuda.synchronize()
        t2 = time.time()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        restore()
    print(f"train_tokenizer: two runs (1-{TT_CKPT}, then resumed "
          f"{TT_CKPT + 1}-{TT_STEPS}) in {t1 - t0:.1f} s and {t2 - t1:.1f} "
          f"s, models, loaders, validations and checkpoints included; "
          f"launches {json.dumps(launches)}; peak memory {peak:.2f} GiB")
    kinds = [k for k, _, _ in record]
    n_val = TT_STEPS // TT_CKPT
    check(kinds.count("G") == TT_STEPS // 2 and "D" not in kinds
          and "G_gan" not in kinds and kinds.count("eval") == 4 * n_val + 1,
          f"train_tokenizer: step calls {sorted(set(kinds))}: "
          f"{[kinds.count(k) for k in ('G', 'G_gan', 'D', 'eval')]}")
    k1_per_step(record, "train_tokenizer")
    check(launches["vq_argmin"] == 2 * len(record), f"train_tokenizer: K1 "
          f"launched {launches['vq_argmin']} times outside the steps' "
          f"{2 * len(record)}")

    metrics = cli_metrics(out)
    finite_metrics(metrics, "train_tokenizer")
    train = {m["step"]: m for m in metrics if "samples/sec" in m}
    val = [m for m in metrics if "validation_seconds" in m]
    check(sorted(train) == list(range(10, TT_STEPS + 1, 10)),
          f"train_tokenizer: logged steps {sorted(train)}")
    check([m["step"] for m in val] == [TT_CKPT, TT_STEPS],
          f"train_tokenizer: validations {[m['step'] for m in val]}")
    for name in (f"recon/step{TT_CKPT}.png", f"recon/step{TT_STEPS}.png",
                 "train_recon/step1.png"):
        img = read_png(os.path.join(out, name))
        check(img.shape == (128, (TOK_T - 1) * 64, 3),
              f"train_tokenizer: {name} is {img.shape}")
    for step in (TT_CKPT, TT_STEPS):
        check(os.path.exists(os.path.join(out, f"checkpoint-{step}",
                                          ckpt.STATE_TENSORS)),
              f"train_tokenizer: checkpoint-{step} was not written")
    exported = ckpt.load_tokenizer_safetensors(os.path.join(out,
                                                            "tokenizer"))
    check(sorted(exported) == sorted(progress.ema)
          and all(torch.equal(exported[k], v.cpu())
                  for k, v in progress.ema.items()),
          "train_tokenizer: the export differs from the live EMA copy")
    steady = [train[TT_CKPT], train[TT_STEPS]]
    step_ms = sum(m["step_ms"] for m in steady) / 2
    sps = sum(m["samples/sec"] for m in steady) / 2
    wait_ms = sum(m["loader_wait_ms"] for m in steady) / 2
    g_ms = [round(t * 1e3, 2) for k, _, t in record if k == "G"]
    gen_loss = [train[s_]["gen_loss"] for s_ in sorted(train)]
    val_s = [round(m["validation_seconds"], 3) for m in val]
    print(f"train_tokenizer: gen_loss {gen_loss}; steady windows (steps {TT_CKPT - 9}-{TT_CKPT}, "
          f"{TT_STEPS - 9}-{TT_STEPS}; a window is 5 generator steps and 5 "
          f"discriminator micro-batches consumed without an update): "
          f"{step_ms:.2f} ms/step, {sps:.2f} samples/s (the JAX driver's "
          f"log_steps x B x 2 / seconds), the loop waited {wait_ms:.3f} ms a "
          f"step on the loader; a G step's host seconds (ms) {g_ms}; "
          f"validation seconds {val_s} (4 held-out batches and a grid); "
          f"eval recon loss "
          f"{[m['eval_recon_loss'] for m in val]}")

    # a fresh state restored from checkpoint-40 is the live one, and so is
    # one more G step, EMA update and D step from each
    args = cli.parse_args(argv("--max_train_steps", str(TT_STEPS)))
    cfg = cli.train_config(args)
    tokenizer, disc, lpips = cli.build_models(
        args, cli.tokenizer_config(args), torch.device("cuda"))
    fresh, fresh_disc = cli.create_train_states(
        tokenizer, disc, cfg, disc_lr_scheduler=args.discr_lr_scheduler)
    got = cli.restore_checkpoint(args, os.path.join(
        out, f"checkpoint-{TT_STEPS}"), fresh, fresh_disc)
    check((got.step, got.data_iter) == (progress.step, progress.data_iter),
          f"train_tokenizer: restored counters {got.step, got.data_iter}, "
          f"live {progress.step, progress.data_iter}")

    def same(what, ema_a, ema_b):
        same_train_state(torch, live, fresh, f"{what} (generator)")
        same_train_state(torch, live_disc, fresh_disc,
                         f"{what} (discriminator)")
        check(all(torch.equal(v, ema_b[k]) for k, v in ema_a.items()),
              f"{what}: the EMA copies differ")
    same("train_tokenizer resume", progress.ema, got.ema)
    g = torch.Generator(device="cuda").manual_seed(96)
    px = torch.rand(TRAIN_B, TOK_T, 64, 64, 3, device="cuda", generator=g)
    emas = []
    for st, dst, ema in ((live, live_disc, progress.ema),
                         (fresh, fresh_disc, got.ema)):
        cli.make_generator_step(st.model, dst.model, lpips, cfg,
                                use_gan=False)(
            st, px, cli.step_generator(0, progress.data_iter, g.device))
        emas.append(ema_update(ema, st.model.state_dict(), args.ema_decay))
        cli.make_discriminator_step(st.model, dst.model, cfg)(
            dst, px, cli.step_generator(0, progress.data_iter + 1, g.device))
    same("train_tokenizer: the steps after resume", *emas)
    print(f"train_tokenizer: checkpoint-{TT_CKPT} and checkpoint-{TT_STEPS} "
          f"written; the grids decode; the export (the EMA weights) reads "
          f"back bit-equal; a state restored from checkpoint-{TT_STEPS} "
          f"equals the live one (both TrainStates with the spectral-norm "
          f"buffers, AdamW moments and counts, the EMA copy, step "
          f"{got.step}, data_iter {got.data_iter}), and so do the next G "
          f"step, EMA update and D step from each")

    # where a G step's time goes, with no loader running: host wall a step
    # (each ending in a synchronize) against the card's time in one
    # profiled step
    g_step = cli.make_generator_step(live.model, live_disc.model, lpips, cfg,
                                     use_gan=False)

    def one_g():
        g_step(live, px, cli.step_generator(0, 999, g.device))
    one_g()
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(3):
        one_g()
    torch.cuda.synchronize()
    alone_s = (time.time() - t) / 3
    res = {}
    with kernel_trace(torch, res):
        one_g()
    if res["seconds"]:
        print(f"train_tokenizer: a G step with no loader running "
              f"{alone_s * 1e3:.2f} ms (in the CLI's run, median "
              f"{sorted(g_ms)[len(g_ms) // 2]:.2f} ms of host time); one "
              f"profiled: device {res['seconds']:.4f} s, busy share "
              f"{res['seconds'] / alone_s:.4f}; top kernels (name, launches, "
              f"device s): {json.dumps(top_kernels(res['kernels'], 8))}")
    else:
        print("train_tokenizer: the profiler recorded no device time: "
              "device seconds not measured")
    del live, live_disc, fresh, fresh_disc, tokenizer, disc, lpips, emas
    del progress, got
    torch.cuda.empty_cache()

    # the discriminator on: --disc_start 0 reached, as oxe-256's 250000 is
    record = []
    restore = counted_steps(cli, record)
    gan_out = os.path.join(root, "tok_gan")
    try:
        cli.main(argv("--max_train_steps", str(TT_GAN_STEPS), "--disc_start",
                      "0", "--lr_warmup_steps", "0", "--log_steps", "2",
                      "--log_image_steps", "0", "--validation_steps",
                      "100000", "--checkpointing_steps", "100000",
                      out=gan_out))
    finally:
        restore()
    kinds = [k for k, _, _ in record]
    check(kinds == ["G_gan", "D"] * (TT_GAN_STEPS // 2),
          f"train_tokenizer GAN: step calls {kinds}")
    k1_per_step(record, "train_tokenizer GAN")
    metrics = cli_metrics(gan_out)
    finite_metrics(metrics, "train_tokenizer GAN")
    d_loss = [m["discr_loss"] for m in metrics]
    check(len(d_loss) == TT_GAN_STEPS // 2 and abs(d_loss[-1] - d_loss[0])
          > 1e-3, f"train_tokenizer GAN: discriminator losses {d_loss}")
    ms = {k: [round(t * 1e3, 2) for kk, _, t in record if kk == k]
          for k in ("G_gan", "D")}
    print(f"train_tokenizer GAN: discr_loss {d_loss}; gan_loss "
          f"{[m['gan_loss'] for m in metrics]}; adaptive_weight "
          f"{[m['adaptive_weight'] for m in metrics]}; host ms a step "
          f"{json.dumps(ms)}")
    torch.cuda.empty_cache()
    return launches


def remat_pair(torch, dtype, b, seed):
    """One generator step (no GAN, LPIPS in the loss) of TOKENIZER_256 at
    batch b with remat and without, from the same weights, pixels and
    dropout generator, the gradients kept instead of applied: the
    parameters' names, then for each (the gradients of the first step and
    of a second one on the same inputs, the VQ ids of its forward, peak
    memory GiB, seconds of the second step, device seconds of a third one,
    profiled; 0 where the profiler recorded none)."""
    import copy
    from ivideogpt_tpu_torch.configs import (TOKENIZER_256,
                                             DiscriminatorConfig,
                                             TokenizerTrainConfig)
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.train import tokenizer_trainer as tt
    cfg = TokenizerTrainConfig(batch_size=b, segment_length=TOK_T,
                               context_length=2, lr_warmup_steps=0)
    tok, disc, lpips = tt.build_tokenizer_train_models(
        TOKENIZER_256, DiscriminatorConfig(depth=4), compute_dtype=dtype,
        seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    px = torch.rand(b, TOK_T, 256, 256, 3, device="cuda", generator=g)
    lookup, res = vq.vq_lookup, []
    names = [n for n, p in tok.named_parameters() if p.requires_grad]
    for remat in (True, False):
        model = tok
        if not remat:
            model = copy.deepcopy(tok)
            for m in (model.encoder, model.decoder, model.cond_encoder,
                      model.cond_decoder):
                m.remat = False
        state, _ = tt.create_train_states(model, disc, cfg)
        kept, ids = [], []
        state.apply_gradients = lambda: kept.append(
            [p.grad.detach().clone() for p in state.params])
        step = tt.make_generator_step(model, disc, lpips, cfg, use_gan=False)

        def lookup_kept(z, e):
            out = lookup(z, e)
            ids.append(out)
            return out
        vq.vq_lookup = lookup_kept
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(state, px, torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            t = time.time()
            step(state, px, torch.Generator(device="cuda").manual_seed(7))
            torch.cuda.synchronize()
            secs = time.time() - t
            trace = {}
            with kernel_trace(torch, trace):
                step(state, px, torch.Generator(device="cuda").manual_seed(7))
        finally:
            vq.vq_lookup = lookup
        res.append((kept, ids[:2], peak, secs, trace["seconds"]))
        del state, kept, step
        if not remat:
            del model
        torch.cuda.empty_cache()
    del tok, disc, lpips
    torch.cuda.empty_cache()
    return names, res


def phase_train_tokenizer_256(torch, root):
    """The oxe-256 recipe's tokenizer stage through the CLI
    (``scripts/pretrain/oxe-256-act-free.sh:3-10``: TOKENIZER_256, 310M,
    remat on, bf16, B=2, accumulation 4, seg 8, ctx 2, lr 5e-4 for G and D,
    ``--random_selection``, ``--segment_horizon 16``, 16 loader workers)
    on synthetic 256 px episodes, TT256_STEPS micro-steps with the GAN from
    step TT256_DISC_START (the recipe's 250000, reached in training); then
    remat held against no remat: one fp32 generator step at B=1 (fp32
    without remat at the recipe's B=2 would not leave room on the card)
    with ids bit-equal and every gradient within 1e-5 of its tensor's
    largest element (plus 1e-6 of the largest gradient overall, for the
    gradients that are rounding alone) or 4 times the card's own spread
    between two steps without remat, and the recipe's bf16 step at B=2
    (its seconds, peak memory and device seconds) with and without
    remat for peak memory and seconds. Gates: finite metrics; K1 twice a
    step call; the discriminator updates after the GAN starts. Prints ms
    per optimizer update (G and D, from the step calls' card-synchronised
    seconds), samples/s and peak memory. Returns the run's launches."""
    from ivideogpt_tpu_torch import train_tokenizer as cli
    data = write_episodes(os.path.join(root, "tok256_data"), 8, 16, seed=97,
                          size=256)
    out = os.path.join(root, "tok256_run")
    argv = ["--output_dir", out, "--seed", "0", "--mixed_precision", "bf16",
            "--learning_rate", "5e-4", "--disc_learning_rate", "5e-4",
            "--batch_size", str(TT256_B), "--gradient_accumulation_steps",
            str(TT256_ACC), "--disc_start", str(TT256_DISC_START),
            "--dataset_name", "debug", "--resolution", "256",
            "--dataloader_num_workers", "16", "--random_selection",
            "--video_stepsize", "1", "--segment_horizon", "16",
            "--segment_length", str(TOK_T), "--context_length", "2",
            "--dataset_path", data, "--max_train_steps", str(TT256_STEPS),
            "--log_steps", str(2 * TT256_ACC), "--log_image_steps", "0",
            "--validation_steps", "100000", "--checkpointing_steps",
            "100000"]
    record = []
    restore = counted_steps(cli, record, sync=True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        state, disc_state, _ = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        restore()
    n_params = sum(p.numel() for p in state.model.parameters())
    check(state.model.config.remat and n_params > 300e6,
          f"train_tokenizer_256: a {n_params / 1e6:.1f}M tokenizer, remat "
          f"{state.model.config.remat}")
    kinds = [k for k, _, _ in record]
    g_windows = TT256_STEPS // (2 * TT256_ACC)
    # the first discriminator window falls before --disc_start: consumed
    # without a step call
    want = ["G"] * TT256_ACC + (["G_gan"] * TT256_ACC
                                + ["D"] * TT256_ACC) * (g_windows - 1)
    check(kinds == want, f"train_tokenizer_256: step calls {kinds}")
    check((state.updates, disc_state.updates) == (g_windows, g_windows - 1),
          f"train_tokenizer_256: {state.updates} G and {disc_state.updates} "
          f"D updates")
    k1_per_step(record, "train_tokenizer_256")
    metrics = cli_metrics(out)
    finite_metrics(metrics, "train_tokenizer_256")
    check(all("discr_loss" in m for m in metrics[1:]),
          f"train_tokenizer_256: no discriminator loss after the GAN starts")
    # the last window of each: card-synchronised seconds of its 4 calls
    g_ms = sum(t for k, _, t in record[-2 * TT256_ACC:-TT256_ACC]) * 1e3
    d_ms = sum(t for k, _, t in record[-TT256_ACC:]) * 1e3
    print(f"train_tokenizer_256: {n_params / 1e6:.1f}M tokenizer, remat on; "
          f"{TT256_STEPS} micro-steps in {wall:.1f} s (models and loaders "
          f"included); launches {json.dumps(launches)}; the last windows: "
          f"{g_ms:.2f} ms a generator update ({TT256_ACC} micro-batches of "
          f"B={TT256_B} with the GAN), {d_ms:.2f} ms a discriminator update, "
          f"{TT256_ACC * TT256_B * 2 / ((g_ms + d_ms) / 1e3):.2f} samples/s "
          f"over the pair; peak memory {peak:.2f} GiB; gen_loss "
          f"{[m.get('gen_loss') for m in metrics]}; discr_loss "
          f"{[m.get('discr_loss') for m in metrics]}; host ms a call "
          f"{[round(t * 1e3, 1) for _, _, t in record]}")
    del state, disc_state
    torch.cuda.empty_cache()

    names, ((g_r, ids_r, peak_r, s_r, _), (g_n, ids_n, peak_n, s_n, _)) = \
        remat_pair(torch, torch.float32, 1, seed=98)
    check(all(torch.equal(a, b) for a, b in zip(ids_r, ids_n)),
          "train_tokenizer_256: fp32 ids with remat differ from without")
    # each gradient within 1e-5 of its largest element, plus a floor of
    # 1e-6 of the largest gradient overall (a bias in front of a GroupNorm
    # has a gradient that is zero but for rounding), or within 4 times the
    # card's own spread where that is larger: the weight gradients of the
    # 256 px convs sum over 65536 positions a frame in an order cuDNN
    # does not fix, and two steps without remat on the same inputs differ
    gmax = max(float(b.abs().max()) for b in g_n[0])
    errs = []
    for n, a, b, b2 in zip(names, g_r[0], g_n[0], g_n[1]):
        spread = float((b2 - b).abs().max())
        errs.append((float((a - b).abs().max()), spread,
                     float(b.abs().max()), n))
    errs.sort(key=lambda e: e[0] / max(e[2], 1e-30), reverse=True)
    bad = [e for e in errs
           if e[0] > max(1e-5 * e[2] + 1e-6 * gmax, 4 * e[1])]
    print(f"train_tokenizer_256: fp32 G step at B=1, remat against none: "
          f"ids bit-equal; worst gradients by their max (max |diff|, the "
          f"card's own spread without remat, max |g|, name) {errs[:4]}; "
          f"largest ratio of diff to spread "
          f"{max((e[0] / e[1] for e in errs if e[1] > 0), default=0):.3f}; "
          f"the largest "
          f"gradient {gmax:.4e}; peak memory {peak_r:.2f} GiB with remat, "
          f"{peak_n:.2f} without; {s_r * 1e3:.1f} ms and {s_n * 1e3:.1f} ms "
          f"a step")
    check(not bad, f"train_tokenizer_256: fp32 gradients with remat off "
          f"the ones without beyond 1e-5 of their max and 4 times the "
          f"card's spread: {bad[:3]}")
    del g_r, g_n
    _, ((_, _, peak_r, s_r, dev_r), (_, _, peak_n, s_n, dev_n)) = \
        remat_pair(torch, torch.bfloat16, TT256_B, seed=99)
    print(f"train_tokenizer_256: the recipe's bf16 G step at B={TT256_B} "
          f"(no GAN): peak memory {peak_r:.2f} GiB with remat, {peak_n:.2f} "
          f"without; {s_r * 1e3:.1f} ms and {s_n * 1e3:.1f} ms a step; device "
          f"{dev_r:.4f} s and {dev_n:.4f} s a step (one profiled each; 0: "
          f"not measured), busy share {dev_r / s_r:.4f} and "
          f"{dev_n / s_n:.4f}")
    torch.cuda.empty_cache()
    return launches


def hub_models(torch):
    """TOKENIZER_64 and LLAMA_BASE with the action head (action_dim 4) in
    fp32 at full width and depth, random weights from a seed (the action
    head's too, so that actions move the logits), on the CPU."""
    from ivideogpt_tpu_torch import rollout as ro
    tok, lm = ro.build_models(context_length=CTX, segment_length=T,
                              dtype=torch.float32, seed=90, device="cpu")
    g = torch.Generator().manual_seed(91)
    with torch.no_grad():
        lm.action_linear.weight.normal_(0, 0.02, generator=g)
    return tok, lm


def phase_hub(torch, root):
    """Write a hub with the port's own writer under ``root``: ``cond`` (the
    tokenizer and the action-conditioned transformer), ``free/transformer``
    (the bare LLaMA) and ``vp2/transformer`` (the same LLaMA under an
    action head of action_dim 5); read every file back bit-equal, the bare
    LLaMA also through ``load_llm_only_safetensors``. Returns the ``cond``
    hub dir and the CPU models it holds."""
    import shutil
    from ivideogpt_tpu_torch.utils import checkpoint as ckpt
    from ivideogpt_tpu_torch.utils import safetensors as st
    t0 = time.time()
    tok, lm = hub_models(torch)
    cond = ckpt.export_hub(os.path.join(root, "cond"), tok, lm)
    free = os.path.join(root, "free", "transformer")
    ckpt.export_llama_safetensors(lm.llm,
                                  os.path.join(free, ckpt.TRANSFORMER_FILE))
    vp2 = os.path.join(root, "vp2", "transformer")
    vp2_sd = dict(lm.state_dict())
    vp2_sd["action_linear.weight"] = torch.randn(
        lm.llm_config.hidden_size, VP2_A,
        generator=torch.Generator().manual_seed(92)) * 0.02
    st.save_file(vp2_sd, os.path.join(vp2, ckpt.TRANSFORMER_FILE))
    shutil.copy(os.path.join(cond, "transformer", "config.json"), vp2)
    write_s = time.time() - t0
    for what, got, want in (
            ("tokenizer", st.load(os.path.join(cond, "tokenizer")),
             tok.state_dict()),
            ("transformer", st.load(os.path.join(cond, "transformer")),
             lm.state_dict()),
            ("bare LLaMA", st.load(free), lm.llm.state_dict()),
            ("bare LLaMA by load_llm_only_safetensors",
             ckpt.load_llm_only_safetensors(free), lm.llm.state_dict()),
            ("VP2 transformer", st.load(vp2), vp2_sd)):
        check(sorted(got) == sorted(want), f"hub: the {what} holds other "
              f"names than the model")
        for k, v in want.items():
            check(got[k].dtype == v.dtype and torch.equal(got[k], v),
                  f"hub: {what}: {k} differs after the round trip")
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)
    print(f"hub: wrote {size / 2**20:.1f} MiB in {write_s:.1f}s (tokenizer "
          f"{sum(p.numel() for p in tok.parameters()) / 1e6:.1f}M, LM "
          f"{sum(p.numel() for p in lm.parameters()) / 1e6:.1f}M params, "
          f"fp32); every tensor of the tokenizer, the action-conditioned "
          f"transformer, the bare LLaMA and VP2's transformer read back "
          f"bit-equal")
    return cond, tok, lm


def phase_predict(torch, hub, tok_cpu, lm_cpu):
    """``inference/predict.py``'s path on the card: ``load_models`` from
    the hub (fp32) and ``predict`` on the synthetic sample (ctx 2, seg 16,
    repeat_times 5, top-k 100, action-conditioned). Gates: the launches of
    the first call (K1 2: the context and dynamics lookups; K4 12, fp32;
    K3 0: a bf16 cache decodes in plain torch), the stream, frames finite
    in [0, 1]; K1's ids bit-equal to the port's on the CPU; teacher-forced
    logits over the card's stream on the card against the CPU, within the
    check phase's 2e-2. Times a call, mean of 3 after the first."""
    import numpy as np
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import tokens as tok_lib
    from ivideogpt_tpu_torch.inference import predict as pr
    from ivideogpt_tpu_torch.inference.utils import NPZParser
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    args = pr.parse_args([
        "--pretrained_model_name_or_path", hub,
        "--input_path", os.path.join(REPO, PRED_SAMPLE),
        "--dataset_name", "bair", "--action_conditioned",
        "--repeat_times", str(PRED_R), "--seed", "95"])
    t0 = time.time()
    tokenizer, model = pr.load_models(args)
    print(f"predict: load_models from the hub in {time.time() - t0:.1f}s")
    pixels, actions = NPZParser(T, 64).parse(args.input_path,
                                             args.dataset_name, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = pr.predict(args, tokenizer, model, pixels, actions)
    first_s = time.time() - t0
    launches = read_counts()
    want = {"vq_argmin": 2, "vq_argmin_tiled": 0, "decode_attention": 0,
            "flash_attention_fwd": 12, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}
    for name, n in want.items():
        check(launches[name] == n, f"predict: {name} ran {launches[name]} "
              f"times in a call, not {n}")
    check_stream(torch, tok_lib, tokenizer.config, res.tokens, PRED_R)
    f = res.frames
    check(f.shape == (PRED_R, T, 64, 64, 3), f"predict: frames {f.shape}")
    check(bool(np.isfinite(f).all() and f.min() >= 0 and f.max() <= 1),
          "predict: frames not finite in [0, 1]")
    print(f"predict: first call {first_s:.2f}s, launches {launches}; "
          f"tokens {tuple(res.tokens.shape)}, frames {f.shape} finite in "
          f"[0, 1]")

    px = torch.from_numpy(pixels)[None]
    act = torch.from_numpy(actions)[None].repeat(2, 1, 1)
    stream = res.tokens[:2]
    with torch.inference_mode(), full_fp32():
        ids, _ = tokenizer.tokenize(px.cuda(), CTX)
        ids_cpu, _ = tok_cpu.tokenize(px, CTX)
        logits = generation.replay_logits(
            model, stream, segment_length=T, context_length=CTX,
            action=act.cuda()).cpu()
        ref = generation.replay_logits(
            lm_cpu, stream.cpu(), segment_length=T, context_length=CTX,
            action=act)
    same = int((ids.cpu() == ids_cpu).sum())
    dl = float((logits - ref).abs().max())
    print(f"predict: fp32 ids on the card equal to the CPU's {same}/"
          f"{ids.numel()}; teacher-forced logits (bf16 cache, 2 samples) "
          f"max |card - CPU| {dl:.3e} (tolerance 2e-2)")
    check(torch.equal(ids.cpu(), ids_cpu), "predict: K1's ids differ from "
          "the port's on the CPU")
    check(dl < 2e-2, "predict: teacher-forced logits differ from the CPU's")

    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(N_TIMED):
        pr.predict(args, tokenizer, model, pixels, actions)
    dt = (time.time() - t0) / N_TIMED
    print(f"predict: {N_TIMED} timed calls, {dt:.4f} s a call ({PRED_R} "
          f"futures of {T - CTX} frames, {PRED_R * (T - CTX) / dt:.2f} "
          f"frames/s), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del tokenizer, model, res
    torch.cuda.empty_cache()
    return launches


def phase_rollout_ctx1(torch, hub):
    """The BAIR protocol's ctx=1 rollout: the hub's ctx=2 tokenizer
    re-sliced to ctx=1 (``load_tokenizer_for_context``), bf16 under the
    cast rules, ``rollout.rollout`` at B=256, T=16 over the int8 cache.
    Gates: the first rollout's launches (K1 1, K4 12 at S=257, K3
    12 x 253 = 3036), the stream, finite frames. Frames/s, mean of 3
    after it, and the stage split as the main phase prints it."""
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch import tokens as tok_lib
    tokenizer, lm = ro.load_hub_models(hub, context_length=1,
                                       segment_length=T)
    check(tokenizer.config.context_length == 1, "rollout_ctx1: the "
          "tokenizer was not re-sliced")
    g = torch.Generator(device="cuda").manual_seed(93)
    px = torch.rand(B, 1, 64, 64, 3, device="cuda", generator=g)
    action = torch.randn(B, T, 4, device="cuda", generator=g)

    def run(gen):
        return ro.rollout(tokenizer, lm, px, action, segment_length=T,
                          generator=gen, cache_dtype=torch.int8)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    res = run(torch.Generator(device="cuda").manual_seed(96))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = read_counts()
    decodes = (T - 1) * 16 - 1 + (T - 2)
    want = {"vq_argmin": 1, "vq_argmin_tiled": 0,
            "decode_attention": 12 * decodes, "flash_attention_fwd": 12,
            "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}
    for name, n in want.items():
        check(launches[name] == n, f"rollout_ctx1: {name} ran "
              f"{launches[name]} times in a rollout, not {n}")
    check_stream(torch, tok_lib, tokenizer.config, res.tokens, B, ctx=1)
    check(tuple(res.frames.shape) == (B, T, 64, 64, 3)
          and bool(torch.isfinite(res.frames).all()),
          f"rollout_ctx1: frames {tuple(res.frames.shape)} not finite")
    print(f"rollout_ctx1: first rollout {first_s:.2f}s, launches "
          f"{launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; tokens "
          f"{tuple(res.tokens.shape)} in range, frames finite")
    gen = torch.Generator(device="cuda").manual_seed(97)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(N_TIMED):
        run(gen)
    torch.cuda.synchronize()
    dt = (time.time() - t0) / N_TIMED
    frames = B * (T - 1)
    print(f"rollout_ctx1: {N_TIMED} timed rollouts, {dt:.4f} s/rollout, "
          f"{frames / dt:.2f} frames/s ({frames} generated frames a "
          f"rollout)")
    stage_report(torch, "rollout_ctx1", tokenizer, lm, px, action, gen)
    del tokenizer, lm, res
    torch.cuda.empty_cache()
    return launches


def phase_vp2(torch, hub, root):
    """The VP2 predictor from the hub (its ``vp2`` transformer: action_dim
    5) with the yaml's defaults (chunks of 100 to generate, 67 to
    decode), queried by a CEM population of 200 sharing one context, with
    actions [200, 10, 5]. Gates: the first query's launches (K1 once a
    chunk, K4 12 a chunk, fp32; K3 0), the output [200, 11, 64, 64, 3]
    finite in [0, 1]. Seconds a query, mean of 3 after it, and the peak
    memory."""
    import numpy as np
    from ivideogpt_tpu_torch.vp.interface import IVideoGPTPredictor
    pred = IVideoGPTPredictor(
        pretrained_vqgan_name_or_path=os.path.join(hub, "tokenizer"),
        pretrained_transformer_path=os.path.join(root, "vp2",
                                                 "transformer"),
        action_dim=VP2_A, generate_max_batchsize=VP2_CHUNK,
        decode_max_batchsize=VP2_DECODE, seed=0)
    rng = np.random.default_rng(94)
    batch = {"video": np.repeat(rng.uniform(0, 1, (1, CTX, 64, 64, 3))
                                .astype(np.float32), VP2_B, axis=0),
             "actions": rng.uniform(-1, 1, (VP2_B, VP2_T, VP2_A))
             .astype(np.float32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    out = pred(batch)["rgb"]
    first_s = time.time() - t0
    launches = read_counts()
    chunks = VP2_B // VP2_CHUNK
    want = {"vq_argmin": chunks, "vq_argmin_tiled": 0, "decode_attention": 0,
            "flash_attention_fwd": 12 * chunks, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0}
    for name, n in want.items():
        check(launches[name] == n, f"vp2: {name} ran {launches[name]} "
              f"times in a query, not {n}")
    check(out.shape == (VP2_B, VP2_SEG - 1, 64, 64, 3)
          and out.dtype == np.float32,
          f"vp2: rgb {out.shape} {out.dtype}")
    check(bool(np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1),
          "vp2: rgb not finite in [0, 1]")
    print(f"vp2: first query {first_s:.2f}s, launches {launches}; rgb "
          f"{out.shape} float32 finite in [0, 1]")
    t0 = time.time()
    for _ in range(N_TIMED):
        pred(batch)
    dt = (time.time() - t0) / N_TIMED
    print(f"vp2: {N_TIMED} timed queries, {dt:.4f} s a query ({VP2_B} "
          f"candidates, {VP2_B * (VP2_SEG - 1) / dt:.2f} predicted "
          f"frames/s), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pred
    torch.cuda.empty_cache()
    return launches


def ab_kernel_times(torch):
    """K1 at K1_SHAPES, K2 at the wide shapes of K2_SHAPES, K3 at the six
    shapes of K3_SHAPES (the host-int valid, over phase_k3's cold-L2
    rotation of caches), and K5, K6 and SDPA's backward at the training
    shape, by cuda_ms and queued_ms, through the interfaces every tree of
    the port has: the kernel half of an A/B turn (``--ab-turn``)."""
    import torch.nn.functional as F
    from ivideogpt_tpu_torch.ops import decode_attention as da
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    out = {}
    g = torch.Generator(device="cuda").manual_seed(1)
    for b, M, valids in K3_SHAPES:
        caches = k3_caches(torch, b, M, g)
        q = torch.randn(b, 12, 64, device="cuda", generator=g).bfloat16()
        for valid in valids:
            fn = rotating(caches, lambda k, ks, v, vs:
                          da.decode_attention(q, k, ks, v, vs, valid))
            out[f"K3 B={b} valid={valid}"] = (cuda_ms(fn, 60),
                                              queued_ms(fn, 240)[0])
        del caches, q
        torch.cuda.empty_cache()
    shapes = ([(f"K1 N={n}", vq.vq_argmin, n, 8192, 64)
               for _, n in K1_SHAPES]
              + [(f"K2 N={n} K={k} D={d}", vq.vq_argmin_tiled, n, k, d)
                 for _, n, k, d in K2_SHAPES if d not in vq.K1_WIDTHS])
    for key, fn, n, k, d in shapes:
        z = torch.randn(n, d, device="cuda", generator=g)
        e = torch.randn(k, d, device="cuda", generator=g)
        iters = 10 if n * k * d > 2**34 else 50
        with full_fp32():
            out[key] = (cuda_ms(lambda: fn(z, e), iters),
                        queued_ms(lambda: fn(z, e), iters)[0])
    q, k, v, do = (torch.randn(TRAIN_B, 751, 12, 64, device="cuda",
                               generator=g).bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    for key, fn in (("K5", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di)),
                    ("K6", lambda: fa.flash_bwd_dq(q, k, v, do, lse, di))):
        out[key] = (cuda_ms(fn, 50), queued_ms(fn, 50)[0])
    qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))

    def sdpa(bwd):
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        if bwd:
            torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))
    out["SDPA backward"] = (
        cuda_ms(lambda: sdpa(True), 50) - cuda_ms(lambda: sdpa(False), 50),
        queued_ms(lambda: sdpa(True), 50)[0]
        - queued_ms(lambda: sdpa(False), 50)[0])
    print("ab: kernel ms (cuda_ms, queued_ms) "
          + json.dumps({k: [round(x, 4) for x in v]
                        for k, v in out.items()}))
    return out


def ab_turn(torch):
    """One turn of an A/B between two trees of the port on one card, run as
    ``python3 <this file> --ab-turn`` from the root of the tree to measure
    (its package is the one imported): the kernels' times, then the
    rollout, the GPT step, the tokenizer pair and the wide pair, each with
    its profiled device seconds, and the MBRL imagination rollout with its
    device seconds by part (``generation.decode`` holds its K3 calls).
    Turns alternate between the trees, parent first."""
    ab_kernel_times(torch)
    phase_main(torch)
    phase_train(torch)
    phase_tok_train(torch, wide=False)
    phase_tok_train(torch, wide=True)
    vp = mbrl_models(torch, torch.bfloat16, seed=59)
    phase_mbrl(torch, vp)


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this script measures the GPU port",
              file=sys.stderr)
        return 1
    mode = sys.argv[1:]
    ab = mode == ["--ab-turn"]
    if mode not in ([], ["--ab-turn"], ["--vq-routing"], ["--k3-splits"]):
        print(f"FAIL: usage: {sys.argv[0]} [--ab-turn | --vq-routing | "
              f"--k3-splits]", file=sys.stderr)
        return 1
    tree = os.getcwd() if ab else REPO
    if not os.path.isdir(os.path.join(tree, "ivideogpt_tpu_torch")):
        print("FAIL: run from a checkout that holds ivideogpt_tpu_torch/",
              file=sys.stderr)
        return 1
    sys.path.insert(0, tree)
    torch.backends.cuda.matmul.allow_tf32 = False

    try:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
        from ivideogpt_tpu_torch import _build
        t0 = time.time()
        logs = _build.build_all()
        print(f"build: {len(logs)} sources in {time.time() - t0:.1f}s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "ptxas info" in line or "spill" in line:
                    print(f"build[{name}]: {line.strip()}")
        if ab:
            ab_turn(torch)
            return 0
        if mode == ["--vq-routing"]:
            vq_routing(torch)
            return 0
        if mode == ["--k3-splits"]:
            k3_splits(torch)
            return 0
        k1 = phase_k1(torch)
        k2 = phase_k2(torch, k1)
        k3 = phase_k3(torch)
        flash = phase_flash(torch)
        flash.update(phase_flash_dropout(torch))
        by_path = {"rollout": phase_main(torch)}
        phase_check(torch)
        by_path["train"] = phase_train(torch)
        phase_train_check(torch)
        by_path["tokenizer_train"] = phase_tok_train(torch, wide=False)
        by_path["tokenizer_train_wide"] = phase_tok_train(torch, wide=True)
        phase_tok_train_check(torch)
        vp = mbrl_models(torch, torch.bfloat16, seed=59)
        by_path["mbrl_rollout"] = phase_mbrl(torch, vp)
        phase_mbrl_check(torch)
        by_path["mbrl_train"] = phase_mbrl_train(torch, vp)
        del vp
        torch.cuda.empty_cache()
        phase_mbrl_train_check(torch)
        scratch = os.path.join(REPO, "outputs")
        os.makedirs(scratch, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="hub-", dir=scratch) as root:
            hub, tok_cpu, lm_cpu = phase_hub(torch, root)
            by_path["predict"] = phase_predict(torch, hub, tok_cpu, lm_cpu)
            del tok_cpu, lm_cpu
            by_path["rollout_ctx1"] = phase_rollout_ctx1(torch, hub)
            by_path["vp2"] = phase_vp2(torch, hub, root)
            write_bair(root, GPT_EPISODES, EVAL_BATCHES * EVAL_B, GPT_FRAMES,
                       seed=93)
            with contextlib.chdir(root):
                by_path["train_gpt"] = phase_train_gpt(
                    torch, root, hub, os.path.join(root, "free",
                                                   "transformer"))
                by_path["eval_gpt"] = phase_eval_gpt(torch, root, hub)
            by_path["train_tokenizer"] = phase_train_tokenizer(torch, root,
                                                               hub)
            by_path["train_tokenizer_256"] = phase_train_tokenizer_256(
                torch, root)
        by_path["train_medium"] = phase_train_medium(torch)
        by_path["train_gpt_check"] = phase_train_check(torch, dropout=True)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("launches by path (rollout: the first B=256 rollout; train: the "
          f"{TRAIN_TIMED} timed steps; tokenizer_train: the {TOK_TIMED} timed "
          f"G+D pairs; tokenizer_train_wide: the {TOK_WIDE_TIMED} timed "
          f"pairs; mbrl_rollout: the first B={MB_B} imagination rollout; "
          f"mbrl_train: the {MB_TIMED} timed train() calls; predict: the "
          f"first call; rollout_ctx1: the first B={B} ctx=1 rollout; vp2: "
          f"the first B={VP2_B} query; train_gpt: the CLI's two runs, "
          f"{GPT_STEPS} steps and 2 validations; train_tokenizer: the "
          f"CLI's two runs, {TT_STEPS} micro-steps and 2 validations; "
          f"eval_gpt: the --eval_only run, {EVAL_BATCHES} batches of "
          f"{EVAL_B} x {EVAL_REPS} samples; "
          f"train_tokenizer_256: the CLI's {TT256_STEPS} micro-steps; "
          f"train_medium: the {MEDIUM_TIMED} timed steps; train_gpt_check: "
          f"one step): "
          + json.dumps(by_path))
    per_run = {"rollout": ("rollout", 1), "train_step": ("train", TRAIN_TIMED),
               "tokenizer_train": ("tokenizer_train", TOK_TIMED),
               "tokenizer_train_wide": ("tokenizer_train_wide",
                                        TOK_WIDE_TIMED),
               "mbrl_rollout": ("mbrl_rollout", 1),
               "mbrl_train": ("mbrl_train", MB_TIMED),
               "predict": ("predict", 1), "rollout_ctx1": ("rollout_ctx1", 1),
               "vp2": ("vp2", 1), "train_gpt_run": ("train_gpt", 1),
               "eval_gpt": ("eval_gpt", 1),
               "train_tokenizer_run": ("train_tokenizer", 1),
               "train_tokenizer_256_run": ("train_tokenizer_256", 1),
               "train_medium_step": ("train_medium", MEDIUM_TIMED),
               "train_gpt_check": ("train_gpt_check", 1)}
    rows = (k1, k2, k3, flash["K4_train"], flash["K4_prefill"],
            flash["K4_mbrl_prefill"], flash["K4_mbrl_train"],
            flash["K4_ctx1_prefill"], flash["K4_eval_loss"],
            flash["K4_eval_prefill"], flash["K4_predict_prefill"],
            flash["K4_vp2_prefill"], flash["K5"], flash["K5_mbrl_train"],
            flash["K6"], flash["K6_mbrl_train"],
            *(flash[f"{k}_{tag}"] for tag in ("train_dropout",
                                               "medium_dropout", "train_fp32")
              for k in ("K4", "K5", "K6")))
    for r in rows:
        # launches: all the path runs read (the first rollouts + the timed
        # steps, pairs and calls), or those of the row's own paths (the
        # flash rows: the path of their shape); launches_by_path: a
        # rollout's, a train step's, a tokenizer G+D pair's, an imagination
        # rollout's and a train() call's
        r["launches"] = sum(by_path[p][r["name"]]
                            for p in r.get("paths", by_path))
        r["launches_by_path"] = {key: by_path[path][r["name"]] // n
                                 for key, (path, n) in per_run.items()}
    keys = ("name", "shape", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "queued_ms", "host_ms",
            "plain_ms", "bound_ms", "bound_by", "share_of_bound",
            "library_ms", "library_queued_ms", "library", "ms_no_dropout",
            "queued_ms_no_dropout", "share_of_bound_no_dropout",
            "ms_dropout", "queued_ms_dropout", "share_of_bound_dropout",
            "at_n", "at_shape")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
