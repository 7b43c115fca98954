#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py
    python3 <path to>/chip_smoke.py --ab-turn   # one A/B turn, see ab_turn
    python3 <path to>/chip_smoke.py --ab-kernels   # its kernel half alone
                                    # (K1-K6, and Q1 and the quantize at a
                                    # detokenize chunk's 23 conv shapes)
    python3 chip_smoke.py --vq-routing   # K1 against K2, see vq_routing
    python3 chip_smoke.py --k3-splits    # K3's split counts, see k3_splits
    python3 chip_smoke.py --dist         # the multi-process phases alone
                                         # (with a probe of gloo on CUDA)

Phases, each printed on its own lines; any failure exits non-zero without
the final result line. Phases 1-5 run alone; from 6 on two lanes run side
by side on the card (run_lanes): this process runs 6-16 and drq_update,
a child process (``--lane``, its log printed after this
process's lane and kept in outputs/lane-hub.log) the hub's phases 17-25 but
dist_train, dist_serve and dist_cli (in the order hub, predict, train_gpt,
train_gpt_lora, train_tokenizer, train_tokenizer_sthsth, eval_gpt,
train_tokenizer_256,
train_gpt_256, train_gpt_goal, rollout_ctx1, vp2, vp2_int8, train_medium,
train_medium_dots, so that the two lanes' memory peaks fall apart); when
the child has ended this process runs mbpo, drq, train_gpt check and
native_preproc alone, then the multi-process phases follow alone, on the
child's hub:
  1. card      the nvidia-smi name and power limit
  2. build     nvcc for sm_90a of every csrc/*.cu and the host C++ compiler
               for csrc/jpeg_decode.cpp and csrc/segment_ops.cpp, all at
               once (-Xptxas -v)
  3. K1        VQ argmin at every shape of the main paths (N=131072, 8192,
               3584, 1536, 16384, 1280, 2560, the inference entry
               points' 512, 224 and 65536, the tokenizer CLI's 4096, 1792,
               1024 and 192, the BAIR evaluation's 20480 and 19200, the
               oxe-256 GPT stage's 2048 and 896, the goal-conditioned
               one's 8192 and 3840; K=8192, D=64 fp32) against the
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
     K3 variants  K3 over grouped KV heads (int8 K, Hkv 4 and 1) and over
               the mixed cache (bf16 K, int8 V) at B=256, M=752, valid 515,
               633, 751: against the plain version and the plain split,
               two launches bit-identical, each launch on its variant's
               count; timed against a cold L2
     qconv     Q1 (the int8 implicit-GEMM conv: s8 wgmma fed by TMA, a
               persistent grid, TMA stores) and its quantize kernel at
               every distinct conv shape of TOKENIZER_64's int8 detokenize
               at the rollout's chunk of 128 clips: codes, int32
               accumulators and bf16 outputs bit-equal to the plain
               versions; each Q1 instance's SASS with IGMMA and UTMALDG and
               without IMMA or LDGSTS, its ptxas registers and spills and
               its dynamic shared memory; each shape's tile plan, share of
               bound and speed against bf16 cuDNN channels-last, timed
               beside it
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
               S=751 and S=768, H=12; bf16 at B=16, S=751 with H=12 and 16,
               at the oxe-256 GPT stage's B=4, S=751 and the
               goal-conditioned one's B=16, S=768 against the
               plain versions with the same (seed, offset), K5 and K6 with
               dropout bit-identical across two launches, p=0 bit-equal to
               no dropout, the fp32 kernels with and without dropout at
               the training shape (fp32 SDPA's own error printed beside
               them); timed with and without dropout beside SDPA with
               dropout_p=0.1 (bf16) and fp32 SDPA at the same dropout_p,
               the fp32 rows bounded by three-term TF32 (TF32X3_PEAK, the FMA
               bound beside it); a time with
               dropout bounded by bytes, FLOP or Philox's integer work (one
               call a causal group, its SASS instructions counted in a probe
               built here, over INT32_RATE), the SASS of K4, K5 and K6
               (bf16 and fp32) by opcode, HGMMA counted
     dist_kernels  K4, K5 and K6 with dropout 0.1, bf16 and fp32, at B=16,
               S=751, H=12 launched whole and as a rank's shards (batch
               halves b0 = 0, 8; head halves h0 = 0, 6 of Hg = 12): the
               concatenated O, lse, dQ, dK, dV bit-equal to the whole
               launch's; one shard's masks read back equal to the slice of
               keep_mask over the whole batch
  6. main      the rollout (TOKENIZER_64 + LLAMA_BASE + action head, bf16
               under the cast rules, int8 KV cache, ctx=2, T=16, B=256) with
               random weights from a seed: shapes, token ranges, launch
               counts (K3: exactly 2832 a rollout, K4: 12), frames/s
     rollout variants  the main rollout with int8_detok="static" and "1":
               token ids equal to the bf16 render's, launches (Q1 and the
               quantize 114, K3 2832), PSNR to the bf16 render, detokenize
               wall and device s by mode, 2 clips with every conv bit-equal
               to the plain int8 conv and the render against the CPU's;
               cache_dtype="mixed" (K3 2832 on the mixed variant; an fp32
               LM's replay: K bit-equal to the bf16 cache's, logits against
               the bf16 cache's); a grouped-head LLAMA_BASE (Hkv=4: K3 2832
               on the grouped variant); frames/s over a timed rollout
               (mixed, grouped)
  7. check     a B=2 fp32 rollout on the GPU held against the plain CPU path
               on the same stream: context ids, teacher-forced logits, frames
  8. train     the GPT training step (frozen tokenize -> LLAMA_BASE forward/
               backward -> clipped AdamW), bf16 over fp32 masters, B=16,
               L=751: 3 warm-up and 10 timed steps on one batch, a falling
               finite loss, launches a step (K1 2, K4/K5/K6 12), ms/step,
               tokens/s, peak memory, one profiled step
     train_fp32  the same step at the trainer CLI's default precision
               (--mixed_precision no, --attention_dropout 0.1): fp32
               compute, TF32 off, dropout keyed by (seed, step), so every
               layer runs the fp32 K4, K5 and K6 with dropout; the same
               checks and measures, the device time by kernel
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
     drq_update  one DrQ-v2 agent update at MBPOConfig's widths (batch 256,
               hidden 1024, feature 50, 64 x 64 x 9, fp32, TF32 off) on the
               card and the CPU from the same weights and draws: metrics,
               gradients, parameters after AdamW, the Polyak target; ms an
               update queued and wall
     mbpo      python -m ivideogpt_tpu_torch.mbrl_train --fake_env in-process
               at MBPOConfig's widths (TOKENIZER_64 + LLAMA_BASE with random
               weights), cut in its frame counts only (MBPO_CUTS): launches
               of each train() call and rollout, episodes on disk and
               imagined, GIFs decoded, losses and val/obs_mse finite, env
               steps/s, update, train() and generate times, a profiled
               generate's busy share, peak memory; a resume through the CLI
               bit-equal, its next agent update equal
     drq       the same CLI with --drq_only (DRQ_CUTS): the same checks
               without the world model, no kernel of the port launched
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
     vp2_int8  the same query with int8_detok=True: Q1 and the quantize 228
               a query, the pixel gap to the exact render, s a query over a
               timed query, the int8 render's share of a traced query's
               device s
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
               --eval_max_batchsize 80) from the hub, cut to 2 samples a
               clip and 2 batches of the synthetic BAIR test split, I3D
               and LPIPS at random weights: every metric finite, FVD
               recomputed and real-vs-real 0 within the eigenvalue floor,
               launches (K1 2 and K4 12 a batch, K4 12 a sample set), I3D
               logits and best-of-t metrics on the card against the CPU;
               wall s split among generate, detokenize, I3D and LPIPS,
               I3D's TFLOP/s, peak memory
     train_gpt_lora  the trainer CLI with --lora --lora_r 8 --lora_alpha 16
               and the VP2 RoboDesk finetune recipe's LM flags (bf16,
               dropout 0.1, action_dim 5, ctx 2, seg 12, B=16,
               --load_internal_llm from the hub's bare LLaMA,
               --use_eval_dataset --use_fvd --use_frame_metrics) on
               synthetic RoboDesk episodes: 5 steps with a checkpoint, a
               resume to 10 with a checkpoint and a validation with
               generation on the merged weights; launches (K4/K5/K6 12 a
               step with dropout keyed by (seed, global step, layer), K1 2
               a step); checkpoints of adapters and AdamW state alone; the
               exported base bit-equal to the warm start, every adapter's
               b off 0; a restored state and its next step bit-equal;
               IVideoGPTPredictor(lora=True) over the export against the
               trainer's merged model (weights, teacher-forced logits in
               fp32 and bf16); ms/step, peak memory and AdamW bytes of a
               LoRA step beside a full step on one batch
     dist_train, dist_serve, dist_cli  started together: two ranks on the
               card over gloo (spawned as --dist-rank processes, LOCAL_RANK
               0 both) and an NCCL world of one, one process's references
               beside them on the same card and batch: 3 GPT steps (bf16,
               dropout 0.1, global B=16) at DP=2 and at TP=2, 2 fp32
               tokenizer G+D pairs at DP=2 (losses and norms within
               DIST_LOSS_RTOL and DIST_NORM_RTOL; DP parameters and
               spectral-norm buffers bit-identical; ms a step and its
               share in the collectives); sharded_rollout at DP=2 over
               B=256 and TP=2 over B=32, T=4 (the token contract, replays
               against one process's: DP bit-equal, TP within
               DIST_LOGIT_ATOL and the top-100 overlap; frames/s and K1,
               K3, K4 launches a rank); the GPT trainer CLI through
               --coordinator_address --num_processes --process_id: NCCL as
               a world of one (4 steps, a checkpoint, a resume bit-equal)
               and the two ranks over --dist_backend gloo (4 steps at B=8 a
               rank, parameters bit-identical, rank 0 alone writing)
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
     train_tokenizer_sthsth  the Something-Something v2 reader: every
               committed JPEG fixture (tests/data/sthsth) decoded by the
               host library built here to PIL's SHA-256 digests, the
               progressive one refused; frames/s of the 427 x 240 4:2:0
               decode on 1 thread, the lane's and 16; then the tokenizer CLI
               with the OXE pretrain recipe's flags (TOKENIZER_64 from a
               seed, bf16, B=16, seg 8, ctx 2, 16 loader workers) over
               --dataset_name select_sthsth --sthsth_root_path (a synthetic
               SSv2 tree linked to the fixtures, two 64 px episodes of each
               OXE_SELECT dataset): 20 micro-steps and a validation, then 10
               over sthsth; K1 2 a G and eval step and nothing else, the
               grid decoded, metrics finite, the SSv2 share of the draws
               within 5 binomial deviations of 0.15, sthsth drawing SSv2
               alone; ms/step, samples/s, loader_wait_ms, peak memory
 24. train_tokenizer_256  the oxe-256 recipe's TOKENIZER_256 (310M, remat)
               through the CLI: bf16, B=2, accumulation 4, ctx 2, 24
               micro-steps with the GAN from step 8 on 256 px episodes;
               ms per G and D update, peak memory; one fp32 G step at B=1
               with remat against none (ids bit-equal, gradients within
               1e-5 of their max) and the bf16 B=2 step's peak memory with
               and without remat
     train_gpt_256, train_gpt_goal  the GPT stages of the oxe-256 recipe
               (B=4 over a frozen fp32 TOKENIZER_256, 256 px) and the
               goal-conditioned one (--goal_conditioned --segment_length
               17, B=16, L=768) through the CLI, 6 steps each: finite
               losses, batches [B, L], launches (K4/K5/K6 12 a step, K1 2),
               ms/step, peak memory
 25. train_medium  LLAMA_MEDIUM (24 layers, H=16), act-free, bf16, dropout
               0.1, B=16, L=751: 2 warm-up and 5 timed steps, launches a
               step (K1 2, K4/K5/K6 24), ms/step, tokens/s, peak memory
     train_medium_dots  the same with remat_policy "none" and "dots": the
               loss bit-equal to no remat's and every gradient within 1e-3
               of its norm, launches a step (K4 48, K5/K6 24), ms/step and
               peak memory of each beside no remat's
 26. train_gpt check  the train check's fp32 step at B=2, 2 layers, with
               attention dropout keyed alike on the card and the CPU
 27. native_preproc  the loaders' fused host crop-resize-normalize
               (augment_segment through data/native.py over
               csrc/segment_ops.cpp, built here): at the BAIR tokenizer
               recipe's 8 and the GPT CLI's 16 frames of 64 px to 64 and
               oxe-256's 8 of 256 px to 256, 3 crop draws each, the fused
               resize within 2e-6 of the numpy one and augment_segment
               (colour jitter on) within 3e-5 of its plain numpy version,
               the Generator left in the same state; the segments/s of
               each on 1 and 16 threads; then the tokenizer CLI with the
               BAIR recipe's flags (TOKENIZER_64 from a seed, 16 loader
               workers) on the train_tokenizer phase's episodes, 6
               micro-steps a run, in turns numpy, fused, fused, numpy (the
               plain version patched into the loader for numpy): metrics
               finite, K1 2 a G step and nothing else, every augmented
               sample through the fused call in a fused run and none in a
               numpy one; ms/step, loader_wait_ms, the workers' delivered
               samples/s (a smoke reading, not a verdict on the step)
Each phase's seconds follow it ("[time]" lines, with the wall clock and
the process's and the card's memory; a lane's phases are timed beside the
other lane's). Then the launches by path,
the kernels' JSON line, the card line again, and the result line.
Imports nothing of JAX or of the JAX package.
"""

import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CTX, T, B = 2, 16, 256
# timed rollouts, predict calls and VP2 queries after the first (one, so
# that the whole script, the GPT recipes' phases included, keeps ~100 s
# from its 1200 s limit on a slow host)
N_TIMED = 1
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
BF16_PEAK = 989e12     # H100 SXM dense bf16 tensor cores, FLOP/s
# fp32-accurate products on the tensor cores: three TF32 products each
# (hi*hi + hi*lo + lo*hi) at the dense TF32 rate, 495 TFLOP/s. The fp32
# attention rows are bounded by it, their FMA bound (FP32_PEAK) beside it
TF32X3_PEAK = 495e12 / 3
HBM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s
INT8_PEAK = 1979e12    # H100 SXM dense int8 tensor cores, operations/s
# 32-bit integer instructions/s (one lane each): 64 results a clock an SM
# for integer add, multiply(-add), logic and compare at compute capability
# 9.0 (CUDA C++ Programming Guide, throughput of native arithmetic
# instructions), half the 128 fp32 lanes behind FP32_PEAK (2 FLOP an FMA),
# at the same clock
INT32_RATE = FP32_PEAK / 4
SPIN_CYCLES = 200_000_000  # queued_ms's head start: ~0.11 s at 1.755 GHz
TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 16, 3, 10
# attention dropout of every published GPT recipe; the trainer CLI's run:
# 30 steps (a checkpoint and a validation every 15, a resume at 15) on 64
# synthetic episodes of 24 frames; the medium recipe's steps
DROP_P, DROP_SEED = 0.1, 2024
GPT_STEPS, GPT_CKPT, GPT_EPISODES, GPT_FRAMES = 30, 15, 64, 24
# the BAIR evaluation recipe (scripts/evaluation/bair-64-act-cond.sh: ctx 1,
# seg 16, B=80, bf16) cut to 2 samples a clip (100 in the recipe) and 2
# batches: 160 test episodes; the card-vs-CPU checks of its metrics take
# 2 clips
EVAL_B, EVAL_REPS, EVAL_BATCHES, EVAL_CHECK = 80, 2, 2, 2
MEDIUM_WARMUP, MEDIUM_TIMED = 2, 5
# the pretrain recipes' GPT stages: oxe-256-act-free.sh at B=4 over
# TOKENIZER_256 (whose 16 x 16 latent gives the 256 context and 16 dynamics
# tokens a frame of 64 px, so L = 751), and oxe-64-goal-cond.sh at B=16
# with segment 17 (the goal frame first, then 16): L = 2 * 257 - 1 + 15 *
# 17 = 768; 6 CLI steps of each (ms/step from the last 3). The LoRA run:
# the VP2 RoboDesk finetune recipe's LM (B=16, action_dim 5, ctx 2, segment
# 12, L = 683) with --lora, rank 8, alpha 16: 5 steps, then a resume to 10
GPT256_B, GOAL_B, GOAL_T = 4, 16, 17
GOAL_L = 257 * CTX - 1 + 17 * (GOAL_T - CTX)
RECIPE_STEPS = 6
LORA_STEPS, LORA_CKPT, LORA_R, LORA_ALPHA = 10, 5, 8, 16.0
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
# the DrQ-v2 agent at MBPOConfig's widths: a batch of 256; the MBPO and
# DrQ-v2 loops through the CLI, cut only in their frame counts (an episode
# is 100 steps, 200 frames)
AGENT_B, AGENT_TIMED = 256, 10
MBPO_CUTS = (("num_seed_frames", 200), ("start_mbpo", 200),
             ("num_expl_steps", 100), ("init_update_gen_steps", 10),
             ("init_gen_times", 2), ("num_train_frames", 800),
             ("eval_every_frames", 400), ("num_eval_episodes", 1))
DRQ_CUTS = (("num_seed_frames", 200), ("num_expl_steps", 100),
            ("num_train_frames", 600), ("eval_every_frames", 400),
            ("num_eval_episodes", 1))
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
# K3's variants at the main rollout's cache: int8 K over 4 and 1 KV
# heads (grouped), and the "mixed" cache (bf16 K, int8 V) over 12
K3_VARIANTS = (("grouped", 4, False), ("grouped", 1, False),
               ("mixed", 12, True))
# Q1 at the rollout's detokenize chunk (rollout.rollout's detok_chunk)
QCONV_CLIPS = 128
# the rollout's variants: int8 renders, the mixed cache and a
# grouped-head LLAMA_BASE; one timed rollout after the first over the
# mixed cache and the grouped LM (the int8 renders are timed by their
# detokenize), one timed VP2 int8 query; the card-vs-CPU check of the
# int8 render on 2 clips
VARIANT_TIMED, INT8_CHECK_CLIPS = 1, 2
# the mixed cache's teacher-forced logits (fp32 LM) against the bf16
# cache's, mean |difference|: between the mixed cache's reading and the int8
# cache's (0.000751 and 0.000755 on an H100 80GB HBM3 at 700 W, the same
# in three runs), so that a mixed cache that rounds K like int8 fails
MIXED_LOGIT_LIMIT = 7.53e-4
# K1's lookups on the main paths (K=8192, D=64): the rollout's context
# frames, the context frames of a B=16 GPT step and tokenizer pair (and of
# the goal-conditioned recipe's step), and the
# dynamics frames of the GPT step (16 x 14 x 16) and of the pair (16 x 6 x
# 16); the MBRL rollout's context frames (32 x 2 x 256); train()'s target
# frames (16 x 5 x 16) and its LM step's dynamics frames (16 x 10 x 16), its
# context lookups being the "context" shape; the tokenizer CLI's BAIR
# recipe (B=16, ctx 1: 16 x 256 context and 16 x 7 x 16 dynamics tokens)
# and TOKENIZER_256 at the oxe-256 recipe's B=2 (2 x 2 x 256, 2 x 6 x 16);
# the BAIR evaluation's batch (80 x 256, 80 x 15 x 16); the oxe-256 GPT
# stage's (4 x 2 x 256, 4 x 14 x 16) and the goal-conditioned one's
# dynamics (16 x 15 x 16)
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
             ("BAIR eval dynamics", EVAL_B * (T - 1) * 16),
             ("oxe-256 GPT context", GPT256_B * CTX * 256),
             ("oxe-256 GPT dynamics", GPT256_B * (T - CTX) * 16),
             ("goal-conditioned GPT dynamics",
              GOAL_B * (GOAL_T - CTX) * 16))
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


def bound(bytes_moved, flops, peak_flops, int_ops=0):
    """(ms, by): the largest of the bytes over HBM_RATE, the FLOP over
    peak_flops and the integer instructions over INT32_RATE (Philox's, for
    attention dropout), and which of them it is: "bytes", "operations" or
    "philox" (integer operations, so "operations" in the kernels line)."""
    terms = {"bytes": bytes_moved / HBM_RATE * 1e3,
             "operations": flops / peak_flops * 1e3,
             "philox": int_ops / INT32_RATE * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


# Two kernels around csrc/philox.cuh's philox4x32_10: one call, and two
# chained calls with one key (whose round keys the second call reuses, as
# the 8 calls of a thread's keep word in ivg::keep_word share theirs)
PHILOX_PROBE = r"""
#include "philox.cuh"
extern "C" __global__ void one(const uint4* c, uint2 k, uint4* out) {
  out[threadIdx.x] = ivg::philox4x32_10(c[threadIdx.x], k);
}
extern "C" __global__ void two(const uint4* c, uint2 k, uint4* out) {
  out[threadIdx.x] =
      ivg::philox4x32_10(ivg::philox4x32_10(c[threadIdx.x], k), k);
}
"""


def sass_opcodes(binary):
    """{kernel: {opcode: static count}} in ``cuobjdump -sass`` of a cubin or
    a library holding sm_90a code, NOPs left out."""
    from ivideogpt_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", binary], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {binary}: {out.stderr}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if name is not None and m and not m.group(1).startswith("NOP"):
            op = m.group(1)
            counts[name][op] = counts[name].get(op, 0) + 1
    return counts


def philox_sass():
    """The SASS instructions of one philox4x32_10 call on this card's
    compiler: PHILOX_PROBE built by nvcc for sm_90a, the two-call kernel's
    count less the one-call kernel's (loads, stores and the key schedule
    cancel). Returns (count, the marginal call's opcodes)."""
    from ivideogpt_tpu_torch import _build
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        src = os.path.join(tmp, "philox_probe.cu")
        with open(src, "w") as f:
            f.write(PHILOX_PROBE)
        cubin = os.path.join(tmp, "philox_probe.cubin")
        out = subprocess.run(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-cubin", "-I", _build.CSRC, "-o", cubin,
             src], capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"nvcc of the Philox probe: {out.stdout}"
              f"{out.stderr}")
        counts = sass_opcodes(cubin)
    check({"one", "two"} <= set(counts), f"the Philox probe's SASS holds "
          f"{sorted(counts)}, not one and two")
    ops = {op: counts["two"].get(op, 0) - counts["one"].get(op, 0)
           for op in set(counts["one"]) | set(counts["two"])}
    ops = {op: n for op, n in sorted(ops.items()) if n}
    return sum(ops.values()), ops


def flash_sass():
    """Static SASS counts of K4, K5 and K6 with and without dropout, bf16 in
    the built flash_attention_sm90 library and fp32 in flash_attention_tf32,
    by opcode: what the dropout instances add (the keep tile's draw twice,
    before the loop and inside it, and the bit reads), and the fp32
    kernels' conversion passes and three-term products (HGMMA)."""
    from ivideogpt_tpu_torch import _build
    out = {}
    for lib, dtype, kernels in (
            ("flash_attention_sm90", "bf16",
             (("flash_fwd_sm90_kernel", "K4"),
              ("flash_bwd_dkv_sm90_kernel", "K5"),
              ("flash_bwd_dq_sm90_kernel", "K6"))),
            ("flash_attention_tf32", "fp32",
             (("flash_fwd_tf32_kernel", "K4"),
              ("flash_bwd_dkv_tf32_kernel", "K5"),
              ("flash_bwd_dq_tf32_kernel", "K6")))):
        for name, ops in sass_opcodes(_build._lib_path(lib)).items():
            for kernel, tag in kernels:
                if kernel in name:
                    drop = "ILb1E" in name
                    out[f"{tag} {dtype} "
                        f"{'dropout' if drop else 'no dropout'}"] = ops
    check(len(out) == 12, f"flash_attention_sm90's and flash_attention_tf32's "
          f"SASS: {sorted(out)}")
    return out


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


def k3_bound(b, valid, H=12, kv=None, mixed=False):
    """(bound_ms, by) of one K3 call over kv KV heads (H, the rollout's
    cache, by default): the live K (int8, or bf16 where ``mixed``) and the
    int8 V read once with their bf16 scales (vs alone where mixed), q read
    and out written once (bf16), against each query head's two products:
    q . K, 2 FLOP a cached value at the bf16 tensor-core rate (a bf16 q and
    an int8 or bf16 K are exact in bf16), and P . V, 2 FLOP a cached value
    in fp32 at the three-term TF32 rate, as the fp32 attention rows."""
    kv = H if kv is None else kv
    nbytes = b * valid * kv * (64 * (3 if mixed else 2)
                               + 2 * (1 if mixed else 2)) + 2 * b * H * 64 * 2
    n = b * H * valid * 64
    return bound(nbytes, 2 * n * (1 + BF16_PEAK / TF32X3_PEAK), BF16_PEAK)


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


def k3_variant_caches(torch, b, M, kv, mixed, g):
    """Caches (k, ks, v, vs) of a K3 variant at batch b, M slots, kv KV
    heads, hd=64 (``mixed``: bf16 k and ks None), as many as hold
    ``L2_ROTATION_BYTES`` together, as ``k3_caches``."""
    one = b * M * kv * (64 * (3 if mixed else 2) + 2 * (1 if mixed else 2))
    caches = []
    for _ in range(-(-L2_ROTATION_BYTES // one)):
        k = (torch.randn(b, M, kv, 64, device="cuda", generator=g).bfloat16()
             if mixed else torch.randint(-127, 128, (b, M, kv, 64),
                                         device="cuda", generator=g,
                                         dtype=torch.int8))
        v = torch.randint(-127, 128, (b, M, kv, 64), device="cuda",
                          generator=g, dtype=torch.int8)
        ks = None if mixed else (torch.rand(b, M, kv, device="cuda",
                                            generator=g) * 0.02
                                 + 0.001).bfloat16()
        vs = (torch.rand(b, M, kv, device="cuda", generator=g) * 0.02
              + 0.001).bfloat16()
        caches.append((k, ks, v, vs))
    return caches


def phase_k3_variants(torch):
    """K3's two variants at the main rollout's cache (B=256, M=752,
    valid 515, 633, 751, H=12, hd=64): int8 K over 4 and 1 KV heads (query
    head h reads KV head h // (12 / Hkv)) and the mixed cache (bf16 K
    without scales, int8 V) over 12. Gates at each valid: the plain version
    and the plain split-then-merge within K3's tolerance, two launches
    bit-identical, one launch counted on the variant's own count. Times by
    cuda_ms and queued_ms over a cold-L2 rotation of the variant's caches
    (``k3_variant_caches``), the plain version beside. Returns the
    kernels line's rows: the grouped variant (Hkv=4 at valid 751; both
    Hkv under ``at_shape``) and the mixed one (valid 751)."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    H, M, valids = 12, 752, (515, 633, 751)
    g = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for tag, kv, mixed in K3_VARIANTS:
        name = f"decode_attention_{tag}"
        row = rows.setdefault(name, dict(
            name=name, route="cuda",
            source="ivideogpt_tpu_torch/csrc/decode_attention.cu",
            replaces="ivideogpt_tpu/ops/decode_attention.py:45",
            max_abs_err=0.0, at_shape={}))
        count = "mixed_launches" if mixed else "grouped_launches"
        caches = k3_variant_caches(torch, B, M, kv, mixed, g)
        q = torch.randn(B, H, 64, device="cuda", generator=g).bfloat16()
        k, ks, v, vs = caches[0]
        for valid in valids:
            before = getattr(da.decode_attention, count)
            out = da.decode_attention(q, k, ks, v, vs, valid)
            check(getattr(da.decode_attention, count) == before + 1,
                  f"K3 {tag}: the launch was not counted on its variant")
            again = da.decode_attention(q, k, ks, v, vs, valid)
            ref = da.decode_attention_plain(q, k, ks, v, vs, valid)
            split = da.decode_attention_split_plain(q, k, ks, v, vs, valid)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            row["max_abs_err"] = max(row["max_abs_err"], err)
            for want, what in ((ref, "plain"), (split, "split plain")):
                check(torch.allclose(out.float(), want.float(), rtol=2e-2,
                                     atol=2e-3),
                      f"K3 {tag} Hkv={kv} disagrees with the {what} version "
                      f"at valid={valid}")
            check(torch.equal(out, again), f"K3 {tag}: two launches differ")
            fn = rotating(caches, lambda k, ks, v, vs:
                          da.decode_attention(q, k, ks, v, vs, valid))
            ms = cuda_ms(fn, 60)
            q_ms, host_ms = queued_ms(fn, 240)
            plain_ms = cuda_ms(
                lambda: da.decode_attention_plain(q, k, ks, v, vs, valid), 3)
            b_ms, b_by = k3_bound(B, valid, kv=kv, mixed=mixed)
            print(f"K3 {tag} B={B} Hkv={kv} M={M} valid={valid}: "
                  f"max_abs_err={err:.3e} (rtol 2e-2, atol 2e-3, plain and "
                  f"split plain), two launches bit-equal; cold L2 "
                  f"({len(caches)} caches): kernel_ms={ms:.4f} plain_ms="
                  f"{plain_ms:.4f} library_ms=null bound_ms={b_ms:.4f} "
                  f"({b_by}) share_of_bound={b_ms / ms:.3f}; queued: "
                  f"kernel_ms={q_ms:.4f} (share {b_ms / q_ms:.3f}), host_ms "
                  f"per call {host_ms:.4f}")
            row["at_shape"][f"Hkv={kv} valid={valid}"] = dict(
                ms=ms, queued_ms=q_ms, host_ms=host_ms, plain_ms=plain_ms,
                bound_ms=b_ms)
            if valid == valids[-1] and kv in (4, 12):
                row.update(shape=f"B={B} H={H} Hkv={kv} M={M} valid={valid}",
                           ms=ms, queued_ms=q_ms, host_ms=host_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=None)
        del caches, k, ks, v, vs, q
        torch.cuda.empty_cache()
    return list(rows.values())


def detok_conv_shapes(torch, tokenizer):
    """The convs one int8 detokenize of one clip runs, as {(N, C, H, W, O,
    k, stride, padding): calls}, recorded by wrapping
    ``ops.qconv.int8_conv`` (the context decoder's N is ctx frames, the
    conditional decoder's T - ctx)."""
    from ivideogpt_tpu_torch import tokens as tok_lib
    from ivideogpt_tpu_torch.ops import qconv
    cfg = tokenizer.config
    seen = {}
    inner = qconv.int8_conv

    def record(conv, x, *args):
        key = (*x.shape, conv.out_channels, conv.kernel_size[0],
               conv.stride[0], conv.padding[0])
        seen[key] = seen.get(key, 0) + 1
        return inner(conv, x, *args)
    g = torch.Generator(device="cuda").manual_seed(71)
    c = torch.randint(0, cfg.num_vq_embeddings, (1, CTX, 256), device="cuda",
                      generator=g)
    d = torch.randint(0, cfg.num_dyn_embeddings, (1, T - CTX, 16),
                      device="cuda", generator=g)
    ids, _ = tok_lib.assemble(c, d, cfg.num_vq_embeddings,
                              cfg.num_dyn_embeddings)
    qconv.int8_conv = record
    try:
        with torch.inference_mode(), qconv.int8_convs():
            tokenizer.detokenize(ids, CTX)
    finally:
        qconv.int8_conv = inner
    return seen


def chunk_conv_shapes(torch):
    """``detok_conv_shapes`` of TOKENIZER_64 at random weights (seed 0, bf16
    under the cast rules, the rollout's render) and the convs a detokenize
    call runs."""
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch.configs import TOKENIZER_64
    from ivideogpt_tpu_torch.models.tokenizer import CompressiveVQModel
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tokenizer = CompressiveVQModel(
            TOKENIZER_64.replace(context_length=CTX), torch.bfloat16)
    generation.cast_conv_params(tokenizer, torch.bfloat16)
    tokenizer = tokenizer.cuda().eval()
    shapes = detok_conv_shapes(torch, tokenizer)
    del tokenizer
    torch.cuda.empty_cache()
    return shapes, sum(shapes.values())


def qconv_sass():
    """Static SASS counts of Q1's instances (``qconv_kernel<BN, MB, mode>``)
    in the built qconv library, by opcode, keyed "BN=.. MB=.. mode=..", and
    of the quantize kernel's two."""
    from ivideogpt_tpu_torch import _build
    out = {}
    for name, ops in sass_opcodes(_build._lib_path("qconv")).items():
        m = re.search(r"qconv_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        if m:
            out["Q1 BN={} MB={} mode={}".format(*m.groups())] = ops
        elif "quantize_kernel" in name:
            out["quantize " + ("bf16" if "bfloat16" in name else "fp32")] = ops
    check(len(out) == 11, f"qconv's SASS: {sorted(out)}")
    return out


def qconv_build_lines(log):
    """{Q1 instance or quantize kernel: (registers, spill stores, spill
    loads)} from nvcc's -Xptxas -v log of the qconv library."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            q = re.search(r"qconv_kernelILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            name = ("Q1 BN={} MB={} mode={}".format(*q.groups()) if q else
                    "quantize " + ("bf16" if "bfloat16" in m.group(1)
                                   else "fp32"))
            found[name] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            found[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name][0] = int(m.group(1))
    return found


def phase_qconv(torch, build_log=""):
    """Q1 (``csrc/qconv.cu``) and its quantize kernel at every distinct conv
    shape of TOKENIZER_64's int8 detokenize (bf16, the rollout's render) at
    the rollout's chunk of ``QCONV_CLIPS`` clips (the context decoder's 256
    frames, the conditional decoder's 1792), recorded from the tokenizer
    itself (``detok_conv_shapes``). At each shape, on random bf16
    activations and weights: the quantize kernel's codes equal the plain
    quantize's, Q1's int32 accumulators equal ``qconv_plain``'s bit for bit
    and its bf16 outputs equal the plain epilogue's. Times Q1 by cuda_ms and
    queued_ms beside the plain version (one call: its accumulator and
    epilogue) and bf16 cuDNN ``F.conv2d`` channels-last at the same shape
    (the library's time), the quantize kernel beside its plain version;
    bounds: Q1 by int8 operations (INT8_PEAK) or bytes (the codes read,
    the int8 weight read, the bf16 output written), the quantize by bytes.
    Before them, Q1's build: each instance's SASS holds int8 wgmma (IGMMA)
    and TMA loads (UTMALDG), and neither mma.sync (IMMA) nor cp.async
    (LDGSTS); its registers and spills (ptxas, from ``build_log``) and
    dynamic shared memory; the quantize kernels' too. Each shape prints
    its tile plan, its share of bound and its speed against cuDNN.
    Returns the two rows (each summed over a chunk's convs, every shape
    under ``at_shape``) and the convs a detokenize call runs."""
    import torch.nn.functional as F
    from ivideogpt_tpu_torch.ops import qconv
    sass = qconv_sass()
    ptxas = qconv_build_lines(build_log)
    smem_of = qconv._build.load("qconv").ivg_qconv_smem
    smem_of.argtypes, smem_of.restype = [ctypes.c_int] * 2, ctypes.c_int
    for name, ops in sass.items():
        regs, st, ld = ptxas.get(name, ("not in this build's log",) * 3)
        n = {op: sum(v for k, v in ops.items() if k.split(".")[0] == op)
             for op in ("IGMMA", "IMMA", "UTMALDG", "UTMASTG", "LDGSTS")}
        smem = ""
        if name.startswith("Q1"):
            bn, _, mode = (int(v) for v in re.search(
                r"BN=(\d+) MB=(\d+) mode=(\d+)", name).groups())
            check(n["IGMMA"] > 0 and n["UTMALDG"] > 0 and not n["IMMA"]
                  and not n["LDGSTS"], f"qconv: {name}'s SASS: {n}")
            smem = f", {smem_of(bn, mode)} bytes dynamic smem"
        print(f"qconv build: {name}: {sum(ops.values())} SASS instructions, "
              + ", ".join(f"{op} {c}" for op, c in n.items())
              + f"; ptxas: {regs} registers at entry, spill stores {st}, "
              f"loads {ld}{smem}")
    shapes, calls = chunk_conv_shapes(torch)
    chunks = B // QCONV_CLIPS
    print(f"qconv: a detokenize call runs {calls} int8 convs at "
          f"{len(shapes)} shapes; {calls * chunks} launches of Q1 and of "
          f"the quantize a B={B} rollout ({chunks} chunks of {QCONV_CLIPS})")
    g = torch.Generator(device="cuda").manual_seed(72)
    keys = ("ms", "queued_ms", "plain_ms", "bound_ms", "library_ms")
    q1 = dict(name="qconv", route="cuda",
              source="ivideogpt_tpu_torch/csrc/qconv.cu",
              replaces="ivideogpt_tpu/ops/qconv.py:84 (XLA's int8 conv in "
                       "_int8_conv_call; no TPU kernel)",
              shape=f"the {calls} convs of one detokenize chunk of "
                    f"{QCONV_CLIPS} clips, summed ({len(shapes)} shapes)",
              max_abs_err=0.0, at_shape={}, **{k: 0.0 for k in keys})
    qz = dict(name="quantize", route="cuda",
              source="ivideogpt_tpu_torch/csrc/qconv.cu",
              replaces="ivideogpt_tpu/ops/qconv.py:67 (XLA's quantize in "
                       "_quantize_per_tensor; no TPU kernel)",
              shape=q1["shape"], max_abs_err=0.0, library_ms=None,
              at_shape={}, ms=0.0, queued_ms=0.0, plain_ms=0.0,
              bound_ms=0.0)
    for (n1, c, h, w, o, k, stride, pad), count in sorted(shapes.items()):
        n = n1 * QCONV_CLIPS
        tag = f"N={n} C={c} {h}x{w} O={o} k={k} s={stride} p={pad}"
        x = torch.randn(n, c, h, w, device="cuda", generator=g).bfloat16()
        wt = torch.randn(o, c, k, k, device="cuda", generator=g) \
            * (c * k * k) ** -0.5
        bias = torch.randn(o, device="cuda", generator=g) * 0.1
        packed = qconv.PackedWeight(wt)
        scale = (qconv.amax(x) / 127.0).clamp_min(1e-12)
        xq = qconv.quantize(x, scale)
        codes = qconv.quantize_per_tensor(x, scale)[0]
        check(torch.equal(xq[..., :c], codes.permute(0, 2, 3, 1)),
              f"qconv {tag}: the quantize kernel's codes differ")
        acc = qconv.qconv(xq, scale, packed, bias, stride, pad,
                          torch.bfloat16, accumulator=True)
        torch.cuda.synchronize()
        t0 = time.time()
        acc_ref = qconv.qconv_plain(codes, scale, packed.wq, packed.w_scale,
                                    bias, stride, pad, torch.bfloat16,
                                    accumulator=True)
        ref = qconv.dequantize(acc_ref, scale, packed.w_scale, bias,
                               torch.bfloat16)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        check(torch.equal(acc, acc_ref), f"qconv {tag}: Q1's int32 "
              f"accumulators differ from the plain version's")
        del acc, acc_ref
        out = qconv.qconv(xq, scale, packed, bias, stride, pad,
                          torch.bfloat16)
        check(torch.equal(out, ref), f"qconv {tag}: Q1's output differs "
              f"from the plain epilogue's")
        del out, ref, codes

        def run():
            return qconv.qconv(xq, scale, packed, bias, stride, pad,
                               torch.bfloat16)
        iters = 5 if n * h * w * o * k * k * c > 2**40 else 20
        ms = cuda_ms(run, iters)
        q_ms = queued_ms(run, iters)[0]
        xcl = x.contiguous(memory_format=torch.channels_last)
        wcl = wt.bfloat16().contiguous(memory_format=torch.channels_last)
        bcl = bias.bfloat16()
        lib_ms = cuda_ms(lambda: F.conv2d(xcl, wcl, bcl, stride, pad), iters)
        del xcl, wcl
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        b_ms, b_by = bound(n * h * w * xq.shape[-1] + o * k * k * c
                           + 2 * n * o * ho * wo,
                           2 * n * ho * wo * o * k * k * c, INT8_PEAK)
        z_ms = cuda_ms(lambda: qconv.quantize(x, scale), iters)
        zq_ms = queued_ms(lambda: qconv.quantize(x, scale), iters)[0]

        def plain_quantize():
            out = torch.zeros(xq.shape, dtype=torch.int8, device="cuda")
            out[..., :c] = qconv.quantize_per_tensor(x, scale)[0].permute(
                0, 2, 3, 1)
            return out
        zp_ms = cuda_ms(plain_quantize, 2, warmup=1)
        zb_ms, _ = bound(2 * x.numel() + xq.numel(), 0, INT8_PEAK)
        plan = qconv.q1_plan(ho, wo, o, 2)
        print(f"qconv {tag}: {count} a chunk, {count * chunks} launches a "
              f"rollout; tiles {plan.bm} pixels ({plan.br} x {plan.bw}) x "
              f"{plan.bn} channels, stored by "
              f"{'TMA' if plan.tma_store else 'the warpgroups'}; "
              f"int32 accumulators and bf16 outputs bit-equal to "
              f"the plain version; kernel_ms={ms:.4f} queued_ms={q_ms:.4f} "
              f"plain_ms={plain_ms:.2f} library_ms={lib_ms:.4f} (bf16 cuDNN, "
              f"channels-last; Q1 {lib_ms / q_ms:.2f}x its speed by q) "
              f"bound_ms={b_ms:.4f} ({b_by}) share_of_bound="
              f"{b_ms / q_ms:.3f} (q); quantize: kernel_ms={z_ms:.4f} "
              f"queued_ms={zq_ms:.4f} plain_ms={zp_ms:.4f} bound_ms="
              f"{zb_ms:.4f} (bytes) share {zb_ms / zq_ms:.3f} (q), codes "
              f"bit-equal")
        q1["at_shape"][tag] = dict(calls=count, ms=ms, queued_ms=q_ms,
                                   plain_ms=plain_ms, library_ms=lib_ms,
                                   bound_ms=b_ms, bound_by=b_by)
        qz["at_shape"][tag] = dict(calls=count, ms=z_ms, queued_ms=zq_ms,
                                   plain_ms=zp_ms, bound_ms=zb_ms)
        for key, val in zip(keys, (ms, q_ms, plain_ms, b_ms, lib_ms)):
            q1[key] += count * val
        for key, val in (("ms", z_ms), ("queued_ms", zq_ms),
                         ("plain_ms", zp_ms), ("bound_ms", zb_ms)):
            qz[key] += count * val
        del x, xq, wt, packed
        torch.cuda.empty_cache()
    q1["bound_by"] = ("operations" if sum(
        r["bound_ms"] * r["calls"] for r in q1["at_shape"].values()
        if r["bound_by"] == "operations") > q1["bound_ms"] / 2 else "bytes")
    qz["bound_by"] = "bytes"
    print(f"qconv: a chunk's {calls} convs: Q1 {q1['ms']:.3f} ms (q "
          f"{q1['queued_ms']:.3f}), bf16 cuDNN {q1['library_ms']:.3f} ms, "
          f"bound {q1['bound_ms']:.3f} ms (mostly {q1['bound_by']}); "
          f"quantize {qz['ms']:.3f} ms (q {qz['queued_ms']:.3f}), bound "
          f"{qz['bound_ms']:.3f} ms")
    return (q1, qz), calls


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

    # the fp32 K4 (three-term TF32 wgmma, nothing rounded below fp32) at the
    # inference entry points' prefills, against the plain version in fp32,
    # TF32 off, at the GPU tests' fp32 tolerance
    fp32 = "ivideogpt_tpu_torch/csrc/flash_attention_tf32.cu"
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
        # bounded by fp32-accurate tensor-core products (TF32X3_PEAK), its
        # FMA bound beside it
        io = (4 * elems * 4 + b * H * s * 4, 4 * hd * pairs)
        b_ms, b_by = bound(*io, TF32X3_PEAK)
        fma_ms = bound(*io, FP32_PEAK)[0]
        print(f"K4 fp32 {name} B={b} S={s}: max_abs_err={e4:.3e} (rtol "
              f"1e-4, atol 1e-5) lse_max_abs_err={e_lse:.3e} (< 1e-4) "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (SDPA forward, fp32, TF32 off) "
              f"bound_ms={b_ms:.4f} ({b_by}, three-term TF32) "
              f"share_of_bound={b_ms / ms:.3f} bound_ms_fma={fma_ms:.4f}"
              f"; queued: kernel_ms={q_ms:.4f} library_ms={lib_q:.4f}, "
              f"host_ms per call {host_ms:.4f}")
        rows[f"K4_{name}"] = dict(
            name="flash_attention_fwd", route="cuda", source=fp32,
            replaces=stock + "331", shape=f"{name} fp32 B={b} S={s}",
            paths=(paths[name],), max_abs_err=e4, ms=ms, queued_ms=q_ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            bound_ms_fma=fma_ms, library_ms=lib_ms,
            library="SDPA forward, fp32, TF32 off")
        sdpa[f"K4 fp32 {name}"] = (ms, lib_ms, q_ms, lib_q,
                                   "SDPA forward, fp32")
        del q, k, v, qt, kt, vt, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    card = card_line()
    for key, (ms, lib, q_ms, lib_q, what) in sdpa.items():
        print(f"ratio to SDPA ({what}; this run, {card}): {key} "
              f"{ms / lib:.3f} (queued, no host time: {q_ms / lib_q:.3f})")
    return rows


def kernel_masks(torch, drop, b, H, s, hd=64):
    """The masks K4, K5 and K6 draw for ``drop`` (a shard's too) over b
    rows and H heads of an S x S attention, read back exactly: [3, b, H,
    s, s] bool, causal. q = 0 makes P uniform over a row; one-hot V, dO or
    K blocks expose P Z / keep key by key."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
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
    return got


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
    - the fp32 kernels with and without dropout at the training shape
      against the plain versions (fp32 tolerance; max_abs_err and
      max_abs_err_dropout).
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
    tf32_src = "ivideogpt_tpu_torch/csrc/flash_attention_tf32.cu"
    stock = "jax/experimental/pallas/ops/tpu/flash_attention.py:"
    lines = {"K4": "331", "K5": "796", "K6": "1146"}
    names = {"K4": "flash_attention_fwd", "K5": "flash_attention_bwd_dkv",
             "K6": "flash_attention_bwd_dq"}
    bf16_tol, bf16_rel = dict(rtol=2e-2, atol=2e-2), 3.8e-3
    fp32_tol = dict(rtol=1e-4, atol=1e-5)
    drop = (DROP_P, DROP_SEED, philox.offset_of(7, 3))
    rows = {}
    n_sass, probe_ops = philox_sass()
    print(f"flash_dropout: one philox4x32_10 call is {n_sass} SASS "
          f"instructions (sm_90a, the probe's two-call kernel less its "
          f"one-call kernel): {json.dumps(probe_ops)}; integer rate "
          f"{INT32_RATE:.4g}/s")
    for what, ops in flash_sass().items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:12]
        hgmma = sum(n for op, n in ops.items() if op.startswith("HGMMA"))
        print(f"flash_dropout: SASS of {what}: {sum(ops.values())} "
              f"instructions (static), HGMMA {hgmma}, the most frequent "
              f"{json.dumps(dict(top))}")

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

    def read_masks(b, H, s):
        """Each kernel's mask, read back, against the plain mask."""
        want = philox.keep_mask(drop, b, H, s, 0, s, 0, s, device="cuda")
        kept = float(want.float().mean())
        sigma = (DROP_P * (1 - DROP_P) / want.numel()) ** 0.5
        check(abs(kept - (1 - DROP_P)) < 5 * sigma, f"flash_dropout: the "
              f"plain mask keeps {kept:.6f}, more than 5 sigma from "
              f"{1 - DROP_P}")
        want &= torch.ones(s, s, device="cuda", dtype=torch.bool).tril()
        got = kernel_masks(torch, drop, b, H, s)
        for i, k in enumerate(("K4", "K5", "K6")):
            check(torch.equal(got[i], want), f"flash_dropout: {k}'s mask at "
                  f"B={b} S={s} H={H} differs from the plain mask")
        print(f"flash_dropout: the masks of K4, K5 and K6 at B={b} S={s} "
              f"H={H} equal the plain mask bit for bit; it keeps "
              f"{kept:.6f} of {want.numel()} (1 - p = {1 - DROP_P}, 5 sigma "
              f"= {5 * sigma:.2e})")
        del want, got

    # the masks at the training shape and at the goal-conditioned recipe's
    # (S a whole number of 64-key tiles)
    read_masks(TRAIN_B, 12, s)
    read_masks(GOAL_B, 12, GOAL_L)

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

    def add_rows(tag, b, H, dtype, srcs, errs, t_drop, t_none, lib, plain,
                 paths, lib_what, peak, dropout_first=True, lib_other=None):
        """A row a kernel: ms and queued_ms with dropout and, under
        *_no_dropout, without (dropout_first); or the other way round,
        under *_dropout. The bound of a time with dropout counts Philox's
        integer work too: one call of n_sass instructions a causal group
        (``philox.causal_groups``), each kernel drawing the mask anew.
        srcs: each kernel's source. lib_other: SDPA's times for the other
        variant, under library_ms* + the suffix. The fp32 rows (peak
        TF32X3_PEAK) also carry their FMA bound, bound_ms_fma."""
        elems, pairs = b * s * H * hd, b * H * s * (s + 1) // 2
        isz = 2 if dtype == torch.bfloat16 else 4
        int_ops = philox.causal_groups(b, H, s) * n_sass
        for key, n_io, per_pair in (("K4", 4, 4), ("K5", 6, 8),
                                    ("K6", 5, 6)):
            n_rows = 1 if key == "K4" else 2
            io = (n_io * elems * isz + n_rows * b * H * s * 4,
                  per_pair * hd * pairs, peak)
            b_drop, b_none = bound(*io, int_ops=int_ops), bound(*io)
            (b_ms, b_by), (b_ms0, b_by0) = ((b_drop, b_none) if dropout_first
                                            else (b_none, b_drop))
            first, other = ((t_drop, t_none) if dropout_first
                            else (t_none, t_drop))
            ms, q_ms, host = first[key]
            ms0, q_ms0, _ = other[key]
            suffix = "_no_dropout" if dropout_first else "_dropout"
            lib_ms = lib[0] if key == "K4" else lib[2]
            lib_q = lib[1] if key == "K4" else lib[3]
            # the kernels line's bound_by is bytes or operations; Philox's
            # integer instructions are operations, named in bound_term
            row = dict(
                name=names[key], route="cuda", source=srcs[key],
                replaces=stock + lines[key],
                shape=f"{tag} B={b} S={s} H={H}", paths=paths,
                max_abs_err=errs[key], ms=ms, queued_ms=q_ms, host_ms=host,
                plain_ms=plain[0] if key == "K4" else plain[1],
                bound_ms=b_ms, bound_by=b_by.replace("philox", "operations"),
                bound_term=b_by, share_of_bound=b_ms / q_ms,
                library_ms=lib_ms, library_queued_ms=lib_q,
                library=lib_what if key == "K4" else
                lib_what + " backward (forward+backward minus forward; dQ, "
                "dK and dV together)")
            row["ms" + suffix] = ms0
            row["queued_ms" + suffix] = q_ms0
            row["bound_ms" + suffix] = b_ms0
            row["bound_by" + suffix] = b_by0.replace("philox", "operations")
            row["bound_term" + suffix] = b_by0
            row["share_of_bound" + suffix] = b_ms0 / q_ms0
            if lib_other is not None:
                row["library_ms" + suffix] = (lib_other[0] if key == "K4"
                                              else lib_other[2])
                row["library_queued_ms" + suffix] = (
                    lib_other[1] if key == "K4" else lib_other[3])
            if peak == TF32X3_PEAK:
                row["bound_ms_fma"] = bound(io[0], io[1], FP32_PEAK)[0]
            rows[f"{key}_{tag}"] = row
            print(f"{key} {tag} B={b} S={s} H={H}: max_abs_err="
                  f"{errs[key]:.3e} kernel_ms={ms:.4f} queued_ms={q_ms:.4f} "
                  f"({suffix[1:]}: {ms0:.4f} / {q_ms0:.4f}) plain_ms="
                  f"{row['plain_ms']:.4f} library_ms={lib_ms:.4f} queued "
                  f"{lib_q:.4f} ({row['library']}) bound_ms={b_ms:.4f} "
                  f"({b_by}) share_of_bound={b_ms / q_ms:.3f} "
                  f"({suffix[1:]}: bound_ms={b_ms0:.4f} ({b_by0}) share "
                  f"{b_ms0 / q_ms0:.3f}); host_ms per call {host:.4f}")

    # bf16 at the training shape (LLAMA_BASE, H=12), LLAMA_MEDIUM's H=16 and
    # the pretrain recipes' GPT stages: oxe-256 (B=4) and goal-conditioned
    # (S=768); ``s`` is read by inputs(), plain_ms() and add_rows()
    for tag, b, s, H, paths in (
            ("train_dropout", TRAIN_B, 751, 12, ("train_gpt",)),
            ("medium_dropout", TRAIN_B, 751, 16, ("train_medium",
                                                  "train_medium_dots")),
            ("oxe256_dropout", GPT256_B, 751, 12, ("train_gpt_256",)),
            ("goal_dropout", GOAL_B, GOAL_L, 12, ("train_gpt_goal",))):
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
        # no atomics, and the keep tiles a pure function of the arguments
        dk2, dv2 = fa.flash_bwd_dkv(q, k, v, do, ref_lse, di, drop)
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash_dropout: K5 with dropout ({tag}) is not bit-identical "
              f"across two launches")
        check(torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, ref_lse, di,
                                              drop)),
              f"flash_dropout: K6 with dropout ({tag}) is not bit-identical "
              f"across two launches")
        print(f"flash_dropout: K5 and K6 with dropout ({tag}) bit-identical "
              f"across two launches")
        del ref_o, ref_dk, ref_dv, ref_dq, dk, dv, dq, dk2, dv2
        if tag == "train_dropout":
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
        add_rows(tag, b, H, torch.bfloat16, dict.fromkeys(lines, sm90), errs,
                 t_drop, t_none, lib, plain, paths,
                 f"SDPA forward, dropout_p={DROP_P}", BF16_PEAK)
        del q, k, v, do, f, o, lse, di
        torch.cuda.empty_cache()

    # fp32: with dropout at the training shape against the plain version,
    # p = 0 bit-equal
    b, s = TRAIN_B, 751
    q, k, v, do = inputs(b, 12, 5, torch.float32)
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
    p0_bit_equal(q, k, v, do, f"fp32 B={b}")
    print(f"flash_dropout: fp32 K4/K5/K6 with dropout at B={b} S={s} H=12: "
          f"max_abs_err {json.dumps({k_: round(e_, 9) for k_, e_ in e_fp32.items()})} "
          f"(rtol 1e-4, atol 1e-5); p=0 bit-equal to no dropout")
    del q, k, v, do, o, lse, ref_o, ref_lse, di, dk, dv, dq
    del ref_dk, ref_dv, ref_dq

    # fp32 at the training shape: against the plain version without
    # dropout, timed with and without it, beside SDPA's fp32 forward and
    # backward (TF32 off), each at the same dropout_p. SDPA's own error
    # against the plain version under the same gates, as evidence of what
    # its three TF32 terms (OpMultiplyAddFastF32) hold: printed, not gated
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
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        sdpa_g = torch.autograd.grad(sdpa_o, (qt, kt, vt),
                                     do.transpose(1, 2))
        sdpa_err = {}
        for w, got, want in zip("QKV", sdpa_g, (ref_dq, ref_dk, ref_dv)):
            got = got.transpose(1, 2)
            sdpa_err[f"d{w}"] = (
                float((got - want).abs().max()),
                bool(torch.allclose(got, want, **fp32_tol)))
        print(f"flash_dropout: fp32 SDPA backward at B={b} S={s} H=12 "
              f"against the plain version (max_abs_err, within rtol 1e-4 "
              f"atol 1e-5): {json.dumps(sdpa_err)}; the kernels' max_abs_err "
              f"K5 {errs['K5']:.3e} K6 {errs['K6']:.3e}")
        del ref_o, ref_dk, ref_dv, ref_dq, dk, dv, dq, qt, kt, vt, sdpa_o
        del sdpa_g
        t_drop = timed(kernels(q, k, v, do, drop))
        t_none = timed(kernels(q, k, v, do, None))
        lib = sdpa_ms(q, k, v, do, 0.0)
        lib_drop = sdpa_ms(q, k, v, do, DROP_P)
        plain = plain_ms(q, k, v, do, None, torch.float32)
    add_rows("train_fp32", b, 12, torch.float32,
             dict.fromkeys(lines, tf32_src), errs, t_drop,
             t_none, lib, plain, ("train_fp32", "train_gpt_check"),
             "SDPA forward, fp32, TF32 off", TF32X3_PEAK,
             dropout_first=False, lib_other=lib_drop)
    for key, e in e_fp32.items():
        rows[f"{key}_train_fp32"]["max_abs_err_dropout"] = e
    del q, k, v, do, o, lse, di
    torch.cuda.empty_cache()
    card = card_line()
    for key, r in rows.items():
        print(f"ratio to SDPA ({r['library']}; this run, {card}): {key} "
              f"{r['ms'] / r['library_ms']:.3f} (queued, no host time: "
              f"{r['queued_ms'] / r['library_queued_ms']:.3f})")
        if "library_ms_dropout" in r:
            print(f"ratio to SDPA with dropout_p={DROP_P}, like for like "
                  f"(this run, {card}): {key} with dropout "
                  f"{r['ms_dropout'] / r['library_ms_dropout']:.3f} "
                  f"(queued: {r['queued_ms_dropout'] / r['library_queued_ms_dropout']:.3f})")
    k5, k6 = rows["K5_train_fp32"], rows["K6_train_fp32"]
    for sfx, what in (("", "without dropout"),
                      ("_dropout", f"dropout_p={DROP_P}")):
        both = k5["queued_ms" + sfx] + k6["queued_ms" + sfx]
        lib_q = k5["library_queued_ms" + sfx]
        print(f"flash_dropout: fp32 K5+K6 {what}: queued {both:.4f} ms "
              f"against fp32 SDPA's backward {lib_q:.4f} ({both / lib_q:.3f}x;"
              f" this run, {card})")
    return rows


def check_stream(torch, tokens_mod, cfg, toks, batch, ctx=CTX, T=T):
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
    """Every kernel's launch count, by the name the kernels line gives it,
    as (wrapper, attribute): K3's variants count on attributes of their
    one wrapper."""
    from ivideogpt_tpu_torch.ops import decode_attention as da
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import qconv
    from ivideogpt_tpu_torch.ops import vq
    return {"vq_argmin": (vq.vq_argmin, "launches"),
            "vq_argmin_tiled": (vq.vq_argmin_tiled, "launches"),
            "decode_attention": (da.decode_attention, "launches"),
            "decode_attention_grouped": (da.decode_attention,
                                         "grouped_launches"),
            "decode_attention_mixed": (da.decode_attention, "mixed_launches"),
            "flash_attention_fwd": (fa.flash_fwd, "launches"),
            "flash_attention_bwd_dkv": (fa.flash_bwd_dkv, "launches"),
            "flash_attention_bwd_dq": (fa.flash_bwd_dq, "launches"),
            "qconv": (qconv.qconv, "launches"),
            "quantize": (qconv.quantize, "launches")}


def reset_counts():
    for fn, attr in counted().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in counted().items()}


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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    out["kernels"] = kernels
    out["seconds"] = sum(e.self_device_time_total for e in kernels) / 1e6


class KernelSum(tuple):
    """A kernel's name, launches and device microseconds in a trace, named
    as ``key_averages()``'s rows are."""
    key = property(lambda self: self[0])
    count = property(lambda self: self[1])
    self_device_time_total = property(lambda self: self[2])


def device_kernels(prof, skip=()):
    """The trace's device events (kernels and copies, not the ranges that
    annotate the device timeline, nor names in ``skip``) summed by name,
    largest first: ``key_averages()``'s device rows, read from the kineto
    events without building the profiler's Python event tree, which takes
    minutes for a rollout's trace."""
    from torch.autograd import DeviceType
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA or e.is_user_annotation()
                or e.name() in skip):
            continue
        n, us = sums.get(e.name(), (0, 0.0))
        sums[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return sorted((KernelSum((k, n, us)) for k, (n, us) in sums.items()),
                  key=lambda e: e.self_device_time_total, reverse=True)


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


def frame_gap(torch, a, b):
    """(mean |a - b|, max |a - b|, PSNR of a against b) over frames clipped
    to [0, 1]."""
    a, b = a.float().clamp(0, 1), b.float().clamp(0, 1)
    d = (a - b).abs()
    mse = float((d * d).mean())
    psnr = 10 * math.log10(1 / mse) if mse > 0 else float("inf")
    return float(d.mean()), float(d.max()), psnr


def phase_rollout_variants(torch, convs):
    """The rollout's inference knobs at B=256 (the main phase's models, seed 0),
    each through ``rollout.rollout`` with one generator seed:
    ``int8_detok="static"`` (calibrated on its first chunk, margin 1.1),
    then ``"1"`` (dynamic), against the bf16 render; ``cache_dtype=
    "mixed"``; and a grouped-head LLAMA_BASE (Hkv=4) over the int8 cache.
    Gates: each int8 render keeps the bf16 render's token ids, its frames
    finite; launches of its first rollout (Q1 and the quantize kernel
    ``convs`` a chunk, K3 2832, K4 12, K1 1; the mixed cache's K3 2832 on
    its variant, the grouped LM's 2832 on its); the card's dynamic int8
    render of ``INT8_CHECK_CLIPS`` clips with each conv bit-equal to the
    plain int8 conv of its own input, and against the CPU port's render
    (plain versions) of the same ids: the CPU's int8-vs-bf16 gap within
    [0.8, 1.25] of the card's, the two renders less than 1.5 gaps apart (at
    random weights a render is chaotic under float rounding, and bf16's
    roundings between card and CPU flip codes apart,
    tests/test_torch_qconv.py);
    the mixed cache's teacher-forced replay (the fp32 LM of the same
    weights, 16 samples of the mixed rollout's stream): its K bit for bit
    the bf16 cache's and its V and scales the int8 cache's where the
    replays wrote the same values, its logits' mean |difference| to the
    bf16 cache's below ``MIXED_LOGIT_LIMIT`` and below the int8 cache's,
    and through K3 within 1e-3 of the same replay through K3's plain
    version. Prints PSNR and mean |difference| to the bf16 render, the
    mixed cache's and grouped LM's s/rollout and frames/s
    (``VARIANT_TIMED`` after the first, with their range; an int8 render's
    cost is its detokenize's, timed alone), detokenize wall and device s by
    mode, Q1's and the quantize's device s."""
    import copy
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch import tokens as tok_lib
    from ivideogpt_tpu_torch.configs import LLAMA_BASE
    from ivideogpt_tpu_torch.ops import qconv
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    tokenizer, lm = ro.build_models(context_length=CTX, segment_length=T,
                                    seed=0)
    g = torch.Generator(device="cuda").manual_seed(3)
    px = torch.rand(B, CTX, 64, 64, 3, device="cuda", generator=g)
    action = torch.randn(B, T, 4, device="cuda", generator=g)
    chunks = B // 128

    def run(model, mode="0", cache=torch.int8, scales=None):
        return ro.rollout(tokenizer, model, px, action, segment_length=T,
                          generator=torch.Generator(device="cuda")
                          .manual_seed(41),
                          cache_dtype=cache, int8_detok=mode,
                          static_scales=scales)

    def first(tag, want, *args, timed=VARIANT_TIMED, **kw):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        res = run(*args, **kw)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        launches = read_counts()
        for name, n in want.items():
            check(launches[name] == n, f"{tag}: {name} ran {launches[name]} "
                  f"times in a rollout, not {n}")
        check_stream(torch, tok_lib, tokenizer.config, res.tokens, B)
        check(tuple(res.frames.shape) == (B, T, 64, 64, 3)
              and bool(torch.isfinite(res.frames).all()),
              f"{tag}: frames {tuple(res.frames.shape)} not finite")
        times = []
        for _ in range(timed):
            t0 = time.time()
            run(*args, **kw)
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        speed = ""
        if times:
            dt = sum(times) / len(times)
            fps = sorted(B * (T - CTX) / t for t in times)
            speed = (f"; {timed} timed: {dt:.4f} s/rollout, "
                     f"{B * (T - CTX) / dt:.2f} frames/s (runs {fps[0]:.2f} "
                     f"to {fps[-1]:.2f})")
        print(f"{tag}: first rollout {first_s:.2f}s, launches {launches}"
              + speed)
        return res, launches

    base = {"vq_argmin": 1, "flash_attention_fwd": 12,
            "decode_attention": 2832, "decode_attention_grouped": 0,
            "decode_attention_mixed": 0}
    by_path = {}
    ref = run(lm)
    scales = {}
    for mode, key in (("static", "rollout_int8_static"),
                      ("1", "rollout_int8_detok")):
        res, by_path[key] = first(
            key, dict(base, qconv=convs * chunks, quantize=convs * chunks),
            lm, mode, timed=0, scales=scales if mode == "static" else None)
        check(torch.equal(res.tokens, ref.tokens), f"{key}: the token ids "
              f"differ from the bf16 render's rollout")
        mean, mx, psnr = frame_gap(torch, res.frames, ref.frames)
        print(f"{key}: token ids equal to the bf16-render rollout's; frames "
              f"against the bf16 render: mean |diff| {mean:.5f}, max "
              f"{mx:.4f}, PSNR {psnr:.2f} dB")
    check(len(scales) == convs, f"static: {len(scales)} calibrated convs, "
          f"not {convs}")

    device, wall = {}, {}
    for mode in ("0", "1", "static"):
        torch.cuda.synchronize()
        t0 = time.time()
        with torch.inference_mode():
            ro.detokenize(tokenizer, ref.tokens, CTX, 128, mode, scales)
        torch.cuda.synchronize()
        wall[mode] = time.time() - t0
        res = {}
        with kernel_trace(torch, res), torch.inference_mode():
            ro.detokenize(tokenizer, ref.tokens, CTX, 128, mode, scales)
        device[mode] = dict(seconds=round(res["seconds"], 5), **{
            name: round(sum(e.self_device_time_total for e in res["kernels"]
                            if frag in e.key) / 1e6, 5)
            for name, frag in (("Q1", "qconv_kernel"),
                               ("quantize", "quantize_kernel"))})
    print("rollout_int8: detokenize of a B=256 stream (2 chunks) by "
          "int8_detok mode, wall s " + json.dumps(
              {k: round(v, 4) for k, v in wall.items()})
          + ", device s " + json.dumps(device))

    # the card's dynamic int8 render of INT8_CHECK_CLIPS clips, each conv
    # held bit-equal to the plain int8 conv of its own input on the card,
    # then the whole render against the CPU port's
    ids = ref.tokens[:INT8_CHECK_CLIPS]
    inner, held = qconv.int8_conv, []

    def held_conv(conv, x, *args):
        out = inner(conv, x, *args)
        scale = (qconv.amax(x) / 127.0).clamp_min(1e-12)
        w = qconv.packed_weight(conv)
        want = qconv.qconv_plain(qconv.quantize_per_tensor(x, scale)[0],
                                 scale, w.wq, w.w_scale, conv.bias,
                                 conv.stride[0], conv.padding[0], x.dtype)
        check(torch.equal(out, want), f"rollout_int8 check: Q1 in "
              f"{conv.qconv_key} differs from the plain int8 conv")
        held.append(conv.qconv_key)
        return out
    with torch.inference_mode():
        exact = tokenizer.detokenize(ids, CTX).float().cpu()
        qconv.int8_conv = held_conv
        try:
            with qconv.int8_convs():
                card = tokenizer.detokenize(ids, CTX).float().cpu()
        finally:
            qconv.int8_conv = inner
    check(len(held) == convs, f"rollout_int8 check: {len(held)} convs held")
    torch.set_num_threads(cpu_threads())
    tok_cpu = copy.deepcopy(tokenizer).cpu()
    t0 = time.time()
    with torch.inference_mode(), qconv.int8_convs():
        host = tok_cpu.detokenize(ids.cpu(), CTX).float()
    host_s = time.time() - t0
    del tok_cpu
    gap = float((card - exact).abs().mean())
    drift = float((card - host).abs().mean())
    ratio = float((host - exact).abs().mean()) / gap
    print(f"rollout_int8 check: {INT8_CHECK_CLIPS} clips; in the card's "
          f"int8 render each of the {convs} convs bit-equal to the plain int8 "
          f"conv of its own input; the whole render against the CPU's "
          f"({host_s:.1f} s): mean |diff| {drift:.5f} (max "
          f"{float((card - host).abs().max()):.4f}); the card's int8-vs-bf16 "
          f"gap {gap:.5f} (max {float((card - exact).abs().max()):.4f}); the "
          f"CPU's gap / the card's {ratio:.4f} (tolerances: ratio in [0.8, "
          f"1.25], drift below 1.5 gaps: in bf16 the float layers differ "
          f"between card and CPU by bf16 roundings, so the two int8 renders "
          f"flip codes apart)")
    check(0.8 < ratio < 1.25, "rollout_int8 check: the CPU's int8 render "
          "is not as far from the bf16 render as the card's")
    check(drift < 1.5 * gap, "rollout_int8 check: the card's int8 render is "
          "farther from the CPU's than 1.5 gaps")

    res, by_path["rollout_mixed"] = first(
        "rollout_mixed", dict(base, decode_attention=0,
                              decode_attention_mixed=2832, qconv=0),
        lm, cache="mixed")
    # the logits in fp32 (the same weights), so that the bf16 cache's K is
    # exact and the caches differ only by what they quantize; the mixed
    # replay again with K3's plain version in place of K3
    from ivideogpt_tpu_torch.models import llama as llama_mod
    from ivideogpt_tpu_torch.ops import decode_attention as da
    del lm
    _, lm32 = ro.build_models(context_length=CTX, segment_length=T,
                              dtype=torch.float32, seed=0)

    caches = {}

    def replay(dt, tag=None):
        inner = lm32.init_cache

        def kept(*args):
            caches[tag] = inner(*args)
            return caches[tag]
        if tag is not None:
            lm32.init_cache = kept
        try:
            return generation.replay_logits(
                lm32, res.tokens[:16], segment_length=T, context_length=CTX,
                action=action[:16], cache_dtype=dt)
        finally:
            lm32.__dict__.pop("init_cache", None)
    with full_fp32():
        logits = {c: replay(dt, c) for c, dt in (("mixed", "mixed"),
                                                 ("bf16", torch.bfloat16),
                                                 ("int8", torch.int8))}
        llama_mod.decode_attention = da.decode_attention_plain
        try:
            plain = replay("mixed")
        finally:
            llama_mod.decode_attention = da.decode_attention
    # what the mixed cache is for: its K is the bf16 cache's bit for bit,
    # its V and scales the int8 cache's, wherever the three replays wrote
    # the same values (the prefill's slots of every layer, attended over
    # fresh k/v; every slot of layer 0, whose k/v depend on the embeddings
    # alone)
    P1 = tok_lib.prelude_len(CTX) + 1    # the replay's prefill
    for i, (mix, b16, i8) in enumerate(zip(caches["mixed"], caches["bf16"],
                                           caches["int8"])):
        upto = None if i == 0 else P1
        check(torch.equal(mix["k"][:, :upto], b16["k"][:, :upto]),
              f"rollout_mixed: layer {i}'s K in the mixed cache is not the "
              f"bf16 cache's")
        check(torch.equal(mix["v"][:, :upto], i8["v"][:, :upto])
              and torch.equal(mix["vs"][:, :upto], i8["vs"][:, :upto]),
              f"rollout_mixed: layer {i}'s V in the mixed cache is not the "
              f"int8 cache's")
    d_mixed = (logits["mixed"] - logits["bf16"]).abs()
    d_int8 = (logits["int8"] - logits["bf16"]).abs()
    d_plain = float((logits["mixed"] - plain).abs().max())
    print(f"rollout_mixed: after the replays the mixed cache's K equals the "
          f"bf16 cache's and its V and scales the int8 cache's, bit for bit, "
          f"at the {P1} prefill slots of all {len(caches['mixed'])} layers "
          f"and every slot of layer 0; teacher-forced logits (fp32 LM, 16 "
          f"samples of the stream) against the bf16 cache's: mixed mean "
          f"|diff| {float(d_mixed.mean()):.7f} (max "
          f"{float(d_mixed.max()):.6f}), int8 {float(d_int8.mean()):.7f} "
          f"(max {float(d_int8.max()):.6f}); |logit| mean "
          f"{float(logits['bf16'].abs().mean()):.4f}; the mixed replay "
          f"through K3 against K3's plain version: max |diff| {d_plain:.3e} "
          f"(tolerances: mixed mean below {MIXED_LOGIT_LIMIT} and below "
          f"int8's, K3 against plain 1e-3)")
    check(float(d_mixed.mean()) < MIXED_LOGIT_LIMIT, "rollout_mixed: the "
          f"mixed cache's logits lie {MIXED_LOGIT_LIMIT} or more from the "
          "bf16 cache's")
    check(float(d_mixed.mean()) < float(d_int8.mean()), "rollout_mixed: the "
          "mixed cache's logits are not closer to the bf16 cache's than the "
          "int8 cache's")
    check(d_plain < 1e-3, "rollout_mixed: the replay through K3's mixed "
          "variant differs from the plain version's")
    del lm32, logits, plain, caches

    _, lm_g = ro.build_models(lm_cfg=LLAMA_BASE.replace(
        num_key_value_heads=4), context_length=CTX, segment_length=T, seed=0)
    check(lm_g.llm.model.layers[0].self_attn.k_proj.weight.shape[0] == 256,
          "rollout_grouped: k_proj is not 4 heads wide")
    _, by_path["rollout_grouped"] = first(
        "rollout_grouped", dict(base, decode_attention=0,
                                decode_attention_grouped=2832, qconv=0),
        lm_g)
    del tokenizer, lm_g
    torch.cuda.empty_cache()
    return by_path


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
    torch.set_num_threads(cpu_threads())
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


def phase_train(torch, fp32=False):
    """The GPT training step at full width and depth: TOKENIZER_64 (fp32,
    frozen) + LLAMA_BASE with the action head, bf16 over fp32 masters,
    B=16, ctx=2, T=16, L=751, action-free; AdamW lr 1e-4, constant schedule
    without warmup (so the first update has lr 0, as in optax), clip 1.0.
    One fixed batch of pixels made on the card; each step tokenizes it (K1)
    and trains on it (K4/K5/K6 in every layer). With ``fp32`` (the
    ``train_fp32`` phase): the trainer CLI's default precision
    (``--mixed_precision no``, ``--attention_dropout 0.1``), compute in fp32
    (TF32 off) with attention dropout DROP_P keyed by (DROP_SEED, step), so
    every layer runs the fp32 K4, K5 and K6 with dropout."""
    from ivideogpt_tpu_torch import tokens as tok
    from ivideogpt_tpu_torch.configs import LLAMA_BASE, GPTTrainConfig
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    tag = "train_fp32" if fp32 else "train"
    t0 = time.time()
    extra = (dict(lm_cfg=LLAMA_BASE.replace(attention_dropout=DROP_P),
                  compute_dtype=torch.float32) if fp32 else {})
    tokenizer, model = gt.build_train_models(context_length=CTX,
                                             segment_length=T, seed=10,
                                             **extra)
    n_lm = sum(p.numel() for p in model.parameters())
    cfg = GPTTrainConfig(learning_rate=1e-4, lr_scheduler="constant",
                         lr_warmup_steps=0, max_grad_norm=1.0)
    state = gt.create_train_state(model, cfg)
    tokenize = gt.make_tokenize_fn(tokenizer, CTX)
    g = torch.Generator(device="cuda").manual_seed(11)
    px = torch.rand(TRAIN_B, T, 64, 64, 3, device="cuda", generator=g)
    L = tok.seq_len(CTX, T)
    print(f"{tag}: models built in {time.time() - t0:.1f}s (LM "
          f"{n_lm / 1e6:.1f}M fp32 masters, "
          f"{'fp32 compute, attention dropout ' + str(DROP_P) if fp32 else 'bf16 compute'})")
    n_steps = [0]

    def step():
        ids, labels = tokenize(px)
        n_steps[0] += 1
        return gt.train_step(state, {"input_ids": ids, "labels": labels},
                             (DROP_SEED, n_steps[0]) if fp32 else None)

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
    print(f"{tag}: losses {[round(x, 4) for x in losses]} (the first "
          f"{TRAIN_WARMUP} are warm-up steps); grad norms "
          f"{[round(float(m['grad_norm']), 4) for m in metrics]}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"{tag}: a loss is not finite")
    check(timed[-1] < timed[0], f"{tag}: the loss did not fall over the "
          f"timed steps ({timed[0]:.4f} -> {timed[-1]:.4f})")
    want = {"vq_argmin": 2, "decode_attention": 0, "flash_attention_fwd": 12,
            "flash_attention_bwd_dkv": 12, "flash_attention_bwd_dq": 12}
    for name, n in want.items():
        check(launches[name] == n * TRAIN_TIMED,
              f"{tag}: {name} ran {launches[name]} times in "
              f"{TRAIN_TIMED} steps, not {n} a step")
    flops = 6 * n_lm * TRAIN_B * L
    peak, peak_name = ((FP32_PEAK, "67 TFLOP/s fp32") if fp32
                       else (BF16_PEAK, "989 TFLOP/s"))
    print(f"{tag}: {TRAIN_TIMED} timed steps, {dt * 1e3:.2f} ms/step, "
          f"{TRAIN_B * L / dt:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"6*N*B*L = {flops:.4e} FLOP = {flops / dt / peak:.4f} of "
          f"{peak_name}; launches a step "
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
    key = (DROP_SEED, 0) if fp32 else None
    timed_stage("forward_backward", lambda: model(ids, labels,
                                                  dropout_key=key)["loss"]
                .backward())
    timed_stage("clip_adamw", state.apply_gradients)
    print(f"{tag}: stage wall seconds " + json.dumps(stages))
    profile_train_step(torch, step, dt, tag)
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
    by_kernel = {k: round(sum(e.self_device_time_total for e in kernels
                              if f"flash_{k}_" in e.key) / 1e6, 6)
                 for k in ("fwd", "bwd_dkv", "bwd_dq")}
    print(f"{tag}: one profiled step: device {total:.4f} s, busy share "
          f"{total / step_s:.4f} of the unprofiled step, flash-attention "
          f"kernels {flash:.4f} s ({flash / total:.4f} of device time; K4 / "
          f"K5 / K6 {json.dumps(by_kernel)}), VQ argmin {vq:.4f} s")
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
    kernels = device_kernels(prof, skip=ROLLOUT_RANGES)
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
    torch.set_num_threads(cpu_threads())
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
    torch.set_num_threads(cpu_threads())
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


def agent_states(agent):
    """Every tensor of a DrQ-v2 agent's state, by a name: its weights (the
    Polyak target among them) and its three AdamW states."""
    out = {f"w/{k}": v for k, v in agent.state_dict().items()}
    for name, state in agent.train_states().items():
        for i, p in enumerate(state.params):
            for k, v in state.optimizer.state.get(p, {}).items():
                out[f"{name}/{i}/{k}"] = v
    return out


def world_model_states(vp):
    """Every tensor of the world model's two train states, by a name."""
    out = {}
    for name, state in (("model", vp.model_state), ("tok", vp.tok_state)):
        sd = state.state_dict()
        out.update({f"{name}/w/{k}": v for k, v in sd["model"].items()})
        for i, entry in sd["optimizer"]["state"].items():
            out.update({f"{name}/{i}/{k}": v for k, v in entry.items()})
    return out


def same_tensors(torch, a, b, what):
    check(sorted(a) == sorted(b), f"{what}: other tensors")
    for k in a:
        check(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])),
              f"{what}: {k} differs")


def update_pair_errors(torch, card, host, lr=1e-4, eps=1e-8):
    """Card-vs-CPU errors of one DrQ-v2 update taken from the same weights.
    The worst relative norm of a gradient (AdamW's first moment after one
    step, 0.1 g) and its tensor. The worst parameter error beyond what
    AdamW's first step, lr g / (|g| + eps), makes of the two gradients:
    lr |g / (|g| + eps) - h / (|h| + eps)| for the card's g and the CPU's
    h (a few 1e-7 where the two agree to 1 %; up to 2 lr where they differ
    in sign). The worst share, in a tensor, of the elements whose gradient
    is above rounding level (1e-5 of the tensor's largest) and yet differs
    between the card and the CPU by more than 1 %, as "n of numel in the
    tensor", and the count of such elements over all tensors."""
    grad, worst, excess, share, share_at, n_all = 0.0, None, 0.0, 0.0, None, 0
    for name, sc in card.train_states().items():
        sh = host.train_states()[name]
        for (pname, p), q in zip(sc.model.named_parameters(), sh.params):
            g = sc.optimizer.state[p]["exp_avg"].cpu().double() * 10
            h = sh.optimizer.state[q]["exp_avg"].double() * 10
            rel = float((g - h).norm() / h.norm().clamp_min(1e-30))
            if rel >= grad:
                grad, worst = rel, f"{name}.{pname}"
            step = lr * (g / (g.abs() + eps) - h / (h.abs() + eps)).abs()
            err = (p.detach().cpu().double() - q.detach().double()).abs()
            excess = max(excess, float((err - step).max()))
            loose = ((h.abs() > 1e-5 * h.abs().max())
                     & ((g - h).abs() > 1e-2 * h.abs()))
            n = int(loose.sum())
            n_all += n
            if n / loose.numel() >= share:
                share = n / loose.numel()
                share_at = f"{n} of {loose.numel()} in {name}.{pname}"
    return grad, worst, excess, share, share_at, n_all


def phase_drq_update(torch):
    """One DrQ-v2 agent update at MBPOConfig's widths (batch 256, hidden
    1024, feature 50, 64 x 64 x 9 frame stacks, 4 actions; fp32, TF32 off)
    on the card and on the CPU from the same weights, batch and draws (the
    shifts and normals of ``update_draws``), with the actor step: the
    metrics within 1e-4 relative; each gradient within 1e-2 of its norm
    (the tokenizer checks' tolerance: the encoder's ReLUs at near-zero
    activations); in no tensor more than a tenth of the gradients above
    rounding level differing by more than 1 % (the first conv's bias has 32
    elements: one is 3 %); every updated parameter
    within 1e-6 beyond the difference that AdamW's first step makes of the
    two gradients (``update_pair_errors``); the Polyak target within 1e-6.
    Then the update's ms on the card alone (queued behind a spin) and a
    call's wall ms from a host batch with its metrics read back
    (``DrQV2Agent.update``, as the MBPO loop calls it)."""
    import numpy as np
    from ivideogpt_tpu_torch.mbrl.drqv2 import DrQV2Agent, update_draws
    from ivideogpt_tpu_torch.mbrl.utils import schedule
    from ivideogpt_tpu_torch.utils.platform import to_device
    obs_shape = (64, 64, 3 * MB_K)
    card = DrQV2Agent(obs_shape, MB_A, seed=70, update_every_steps=1)
    host = DrQV2Agent(obs_shape, MB_A, seed=71, update_every_steps=1,
                      device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(72)
    batch = (rng.integers(0, 256, (AGENT_B, *obs_shape)).astype(np.uint8),
             rng.uniform(-1, 1, (AGENT_B, MB_A)).astype(np.float32),
             rng.normal(size=(AGENT_B, 1)).astype(np.float32),
             np.full((AGENT_B, 1), 0.99 ** 3, np.float32),
             rng.integers(0, 256, (AGENT_B, *obs_shape)).astype(np.uint8))
    draws = update_draws(AGENT_B, MB_A, torch.Generator().manual_seed(73))
    stddev = schedule("linear(1.0,0.1,100000)", 2000)
    on_card = tuple(to_device(x, torch.device("cuda")) for x in batch)
    draws_card = type(draws)(*(d.cuda() for d in draws))
    torch.set_num_threads(cpu_threads())
    t0 = time.time()
    m_cpu = host.update_step(tuple(torch.from_numpy(x) for x in batch),
                             stddev, draws, True)
    cpu_s = time.time() - t0
    m_card = card.update_step(on_card, stddev, draws_card, True)
    rel = {k: abs(float(m_card[k]) - float(v)) / max(abs(float(v)), 1e-30)
           for k, v in m_cpu.items()}
    grad, worst, excess, share, share_at, n_loose = update_pair_errors(
        torch, card, host)
    target = max(float((p.detach().cpu() - q).abs().max()) for p, q in zip(
        card.critic_target.parameters(), host.critic_target.parameters()))
    n_params = sum(p.numel() for p in card.parameters()
                   if p.requires_grad)
    print(f"drq_update: B={AGENT_B}, {n_params} trained parameters, "
          f"stddev {stddev}; card against the CPU ({cpu_s:.2f} s there): "
          f"metric relative diffs " + json.dumps(
              {k: float(f"{v:.3e}") for k, v in rel.items()})
          + f" (tolerance 1e-4); worst gradient relative norm {grad:.3e} "
          f"({worst}; tolerance 1e-2, the tokenizer checks': ReLU kinks "
          f"at near-zero activations); gradients above rounding level "
          f"differing by more than 1 %: {n_loose} in all, at most "
          f"{share:.3e} of a tensor ({share_at}; tolerance 1e-1); updated "
          f"parameters max |diff| "
          f"beyond AdamW's step of the two gradients {excess:.3e} "
          f"(tolerance 1e-6); Polyak target {target:.3e} (tolerance 1e-6)")
    failed = [k for k, v in rel.items() if not v <= 1e-4]
    check(not failed, f"drq_update: {', '.join(failed)} differ from the "
          f"CPU")
    check(grad <= 1e-2, "drq_update: gradients differ from the CPU")
    check(share <= 1e-1, "drq_update: gradients unresolved between the "
          "card and the CPU")
    check(excess <= 1e-6,
          "drq_update: updated parameters differ from the CPU")
    check(target <= 1e-6, "drq_update: the Polyak target differs")

    # the host takes ~28 ms to issue one update: two fit in the spin
    q_ms, host_ms = queued_ms(
        lambda: card.update_step(on_card, stddev, draws_card, True), 2)
    np.random.seed(74)
    card.update(batch, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(AGENT_TIMED):
        card.update(batch, step)
    wall_ms = (time.perf_counter() - t0) * 1e3 / AGENT_TIMED
    print(f"drq_update: an update {q_ms:.3f} ms on the card (queued; the "
          f"host takes {host_ms:.3f} ms to issue one), {wall_ms:.3f} ms wall "
          f"a call from a host batch with its metrics read back (mean of "
          f"{AGENT_TIMED}); card {card_line()}")
    del card, host
    torch.cuda.empty_cache()


def mbrl_cli(torch, argv):
    """``python -m ivideogpt_tpu_torch.mbrl_train``'s ``main`` in-process,
    with the loop's parts wrapped to record them: each ``VideoPredictor.
    train`` call (update_tokenizer, its launches, wall s, metrics), each
    ``rollout_async`` (batch, horizon, policy-driven, launches), each
    agent update (wall s, metrics), each ``generate`` (wall s, the previous
    round's fetch included) and ``validate`` (metrics), and the wall time
    after each step of the train env. Returns (the workspace, the
    record)."""
    from ivideogpt_tpu_torch import mbrl_train
    from ivideogpt_tpu_torch.mbrl import drqv2, fake_env, mbpo
    from ivideogpt_tpu_torch.mbrl.video_predictor import VideoPredictor
    rec = {k: [] for k in ("train", "rollout", "update", "generate",
                           "validate", "steps")}
    saved = [(VideoPredictor, "train"), (VideoPredictor, "rollout_async"),
             (drqv2.DrQV2Agent, "update"), (mbpo.Workspace, "generate"),
             (mbpo.Workspace, "validate"), (fake_env, "make_fake")]
    real = {(o, n): getattr(o, n) for o, n in saved}

    def delta(before):
        after = read_counts()
        return {k: after[k] - before[k] for k in after}

    def train(self, batch, update_tokenizer=True, update_model=True):
        before, t = read_counts(), time.perf_counter()
        m = real[VideoPredictor, "train"](self, batch, update_tokenizer,
                                          update_model)
        rec["train"].append((update_tokenizer, delta(before),
                             time.perf_counter() - t, m))
        return m

    def rollout_async(self, obs, policy_fn, agent_state, horizon, **kw):
        before = read_counts()
        out = real[VideoPredictor, "rollout_async"](
            self, obs, policy_fn, agent_state, horizon, **kw)
        rec["rollout"].append((len(obs), horizon, policy_fn is not None,
                               delta(before)))
        return out

    def update(self, batch, step):
        t = time.perf_counter()
        m = real[drqv2.DrQV2Agent, "update"](self, batch, step)
        if m:
            rec["update"].append((time.perf_counter() - t, m))
        return m

    def generate(self):
        t = time.perf_counter()
        m = real[mbpo.Workspace, "generate"](self)
        rec["generate"].append(time.perf_counter() - t)
        return m

    def validate(self, global_frame):
        m = real[mbpo.Workspace, "validate"](self, global_frame)
        rec["validate"].append(m)
        return m

    envs = []

    def make_fake(*a, **kw):
        env = real[fake_env, "make_fake"](*a, **kw)
        if not envs:   # the first env made is the train env
            step = env.step

            def stamped(action):
                ts = step(action)
                rec["steps"].append(time.perf_counter())
                return ts
            env.step = stamped
        envs.append(env)
        return env

    for (o, n), f in zip(saved, (train, rollout_async, update, generate,
                                 validate, make_fake)):
        setattr(o, n, f)
    try:
        ws = mbrl_train.main(argv)
    finally:
        for (o, n), f in real.items():
            setattr(o, n, f)
    return ws, rec


def cli_argv(work_dir, cuts, *extra):
    return ["--fake_env", "--work_dir", work_dir, *extra] + [
        a for k, v in cuts for a in (f"--{k}", str(v))]


def steps_per_s(stamps, first, last):
    """Train-env steps a second between the steps ``first`` and ``last``."""
    return (last - first) / (stamps[last] - stamps[first])


def finite(values):
    return all(v == v and abs(v) != float("inf") for v in values)


def resume_check(torch, ws, argv, what, world_model):
    """Snapshot the live workspace, resume a second one through the CLI
    (which finds the snapshot, restores it and has no frames left to
    train), and hold the two equal: the counters, the agent (weights, the
    Polyak target, AdamW moments and counts, updated_steps) and, with
    ``world_model``, ``_gen_starts``, whether the world model's initial
    training and imagination rounds are done, and both of its train states,
    bit for bit; then
    one agent update on the same batch from the same numpy seed in each
    (cuDNN's deterministic algorithms), whose metrics and resulting states
    must be equal. Returns the resumed workspace."""
    import numpy as np
    from ivideogpt_tpu_torch import mbrl_train
    ws.save_snapshot()
    t0 = time.time()
    ws2 = mbrl_train.main(argv)
    resume_s = time.time() - t0
    check((ws2.global_step, ws2._global_episode) ==
          (ws.global_step, ws._global_episode),
          f"{what}: the resume restored counters "
          f"{(ws2.global_step, ws2._global_episode)}, not "
          f"{(ws.global_step, ws._global_episode)}")
    check(ws2.agent.updated_steps == ws.agent.updated_steps,
          f"{what}: updated_steps differs after the resume")
    same_tensors(torch, agent_states(ws2.agent), agent_states(ws.agent),
                 f"{what} resume: the agent")
    if world_model:
        check(len(ws2._gen_starts) == len(ws._gen_starts),
              f"{what}: _gen_starts differs after the resume")
        check((ws2._init_model, ws2._init_gen)
              == (ws._init_model, ws._init_gen),
              f"{what}: the initial training's flags differ after the "
              f"resume")
        same_tensors(torch, world_model_states(ws2.video_predictor),
                     world_model_states(ws.video_predictor),
                     f"{what} resume: the world model")
        batch = ws.mixed_batch()
    else:
        batch = next(ws.replay_iter)
    metrics = []
    # cuDNN's default weight-gradient algorithms may sum in another order
    # from one call to the next; the comparison takes deterministic ones
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        for w in (ws, ws2):
            np.random.seed(75)
            metrics.append(w.agent.update(batch, ws.global_step))
    check(metrics[0] == metrics[1], f"{what}: the next update after the "
          f"resume differs: {metrics}")
    same_tensors(torch, agent_states(ws2.agent), agent_states(ws.agent),
                 f"{what}: the agent after the next update")
    print(f"{what}: resumed from the snapshot in {resume_s:.1f} s (the "
          f"workspace built anew): counters, agent"
          + (", world model" if world_model else "")
          + " bit-equal; the next update equal " + json.dumps(metrics[0]))
    return ws2


def phase_mbpo(torch, root):
    """``python -m ivideogpt_tpu_torch.mbrl_train --fake_env`` in-process
    (MBPO): 64 px, frame stack 3, action repeat 2, episodes of 100 steps,
    MBPOConfig's widths (agent batch 256, hidden 1024; world model
    TOKENIZER_64 + LLAMA_BASE with random weights, bf16 over fp32 masters,
    int8 rollout cache; imagination at B=32, horizon 10; train() at B=16 on
    12-frame segments), cut only in its frame counts (MBPO_CUTS).

    Gates: the run reaches its global step; 4 real episodes on disk and 32
    imagined episodes stored a policy rollout; launches of each train()
    call K1 4 (2 without the tokenizer step) / K4-K6 12, of each rollout K1
    1 / K4 12 / K3 17 x 12 a frame, and none outside them; the imagination
    and validation GIFs and the eval GIF decoded; losses and val/obs_mse
    finite; a resume bit-equal (``resume_check``). Prints env steps/s in
    the seed phase and after start_mbpo, an agent update's, a train()
    call's and a generate's wall time, the busy share of one profiled
    generate, peak memory. Returns the run's launches."""
    import glob
    import numpy as np
    cuts = dict(MBPO_CUTS)
    work = os.path.join(root, "mbpo")
    argv = cli_argv(work, MBPO_CUTS, "--save_video", "true")
    print("mbpo: " + " ".join(argv))
    for k, v in MBPO_CUTS:
        print(f"mbpo: cut {k} = {v}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.time()
    ws, rec = mbrl_cli(torch, argv)
    run_s = time.time() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = cuts["num_train_frames"] // 2
    seed_steps = cuts["num_seed_frames"] // 2
    check(ws.global_step == steps, f"mbpo: global_step {ws.global_step}, "
          f"not {steps}")
    check(len(rec["steps"]) == steps, f"mbpo: {len(rec['steps'])} env steps")
    episodes = sorted(glob.glob(os.path.join(work, "buffer", "*.npz")))
    check(len(episodes) == steps // ws.cfg.duration,
          f"mbpo: {len(episodes)} real episodes on disk")
    policy = [r for r in rec["rollout"] if r[2]]
    check(ws.imag_replay_storage._num_episodes == 32 * len(policy) > 0,
          f"mbpo: {ws.imag_replay_storage._num_episodes} imagined episodes "
          f"stored for {len(policy)} rollouts")
    zero = dict.fromkeys(launches, 0)
    total = dict(zero)
    for upd_tok, got, _, _ in rec["train"]:
        want = dict(zero, vq_argmin=4 if upd_tok else 2,
                    flash_attention_fwd=12, flash_attention_bwd_dkv=12,
                    flash_attention_bwd_dq=12)
        check(got == want, f"mbpo: a train() call launched {got}")
        total = {k: total[k] + got[k] for k in total}
    for b, horizon, _, got in rec["rollout"]:
        want = dict(zero, vq_argmin=1, flash_attention_fwd=12,
                    decode_attention=17 * 12 * horizon)
        check(got == want, f"mbpo: a B={b} rollout of horizon {horizon} "
              f"launched {got}")
        total = {k: total[k] + got[k] for k in total}
    check(total == launches, f"mbpo: kernels launched outside train() and "
          f"the rollouts: {launches} against {total}")
    metrics = ([v for _, _, _, m in rec["train"] for v in m.values()]
               + [v for _, m in rec["update"] for v in m.values()]
               + [v for m in rec["validate"] for v in m.values()])
    check(rec["validate"] and finite(metrics),
          "mbpo: a loss or val/obs_mse is not finite")
    imag = sorted(glob.glob(os.path.join(work, "imag_gif", "*.gif")))
    val = sorted(glob.glob(os.path.join(work, "validate_gif", "*.gif")))
    evals = sorted(glob.glob(os.path.join(work, "eval_video", "*.gif")))
    check(len(imag) == 4 * len(policy) and len(val) == 16 and evals,
          f"mbpo: {len(imag)} imagination, {len(val)} validation, "
          f"{len(evals)} eval GIFs")
    for path, n, shape in ((imag[0], 11, (64, 64, 3)),
                           (imag[-1], 11, (64, 64, 3)),
                           (val[0], 10, (64, 192, 3)),
                           (evals[0], 101, (64, 64, 3))):
        frames, _, _ = read_gif(path)
        check(len(frames) == n and frames[0].shape == shape,
              f"mbpo: {path} decodes to {len(frames)} frames of "
              f"{frames[0].shape}")
    tok_ms = [s * 1e3 for u, _, s, _ in rec["train"] if u]
    lm_ms = [s * 1e3 for u, _, s, _ in rec["train"] if not u]
    upd_ms = [s * 1e3 for s, _ in rec["update"]]
    seed_rate = steps_per_s(rec["steps"], 1, seed_steps - 1)
    mbpo_rate = steps_per_s(rec["steps"], seed_steps, steps - 1)
    print(f"mbpo: {steps} env steps in {run_s:.1f} s (the workspace built "
          f"in it); env steps/s {seed_rate:.2f} in the seed phase (steps 1-"
          f"{seed_steps - 1}), {mbpo_rate:.2f} after start_mbpo (steps "
          f"{seed_steps}-{steps - 1}: {len(upd_ms)} agent updates, "
          f"{len(rec['train'])} train() calls, {len(rec['generate'])} "
          f"generates, an eval); peak memory {peak:.2f} GiB")
    print(f"mbpo: an agent update {np.mean(upd_ms):.3f} ms wall (median "
          f"{np.median(upd_ms):.3f}, B={ws.cfg.batch_size}); a train() call "
          f"{np.mean(tok_ms):.2f} ms with the tokenizer step "
          f"({len(tok_ms)} calls), {np.mean(lm_ms):.2f} ms without "
          f"({len(lm_ms)}); a generate {np.mean(rec['generate']):.4f} s "
          f"(dispatch and the previous round's fetch and store; "
          f"{len(rec['generate'])} calls); validation val/obs_mse "
          f"{rec['validate'][0]['val/obs_mse']:.5f}, val/time "
          f"{rec['validate'][0]['val/time']:.3f} s; launches "
          + json.dumps(launches))
    # one generate, dispatch to stored episodes, under the profiler
    res = {}
    with kernel_trace(torch, res):
        t0 = time.perf_counter()
        ws.generate()
        ws._store_pending_gen()
        wall = time.perf_counter() - t0
    if res["seconds"]:
        print(f"mbpo: one profiled generate (B={ws.cfg.gen_batch}, horizon "
              f"{ws.cfg.gen_horizon}, dispatch to stored episodes): wall "
              f"{wall:.4f} s, device {res['seconds']:.4f} s, busy share "
              f"{res['seconds'] / wall:.4f}; top kernels " + json.dumps(
                  top_kernels(res["kernels"], 6, width=50)))
    else:
        print("mbpo: the profiler recorded no device time: busy share not "
              "measured")
    ws2 = resume_check(torch, ws, argv, "mbpo", world_model=True)
    for w in (ws, ws2):
        w.close()
    del ws, ws2
    torch.cuda.empty_cache()
    print(f"mbpo: card {card_line()}")
    return launches


def phase_drq(torch, root):
    """``python -m ivideogpt_tpu_torch.mbrl_train --drq_only --fake_env``
    in-process on the same env and agent widths, cut in its frame counts
    (DRQ_CUTS): the run reaches its global step, 3 real episodes on disk,
    a snapshot at each episode's end, finite losses, the eval GIF decoded,
    no kernel of the port launched (the DrQ-v2 convs and MLPs are cuDNN and
    cuBLAS), a resume bit-equal. Prints env steps/s and an update's wall
    ms. Returns the run's launches."""
    import glob
    import numpy as np
    from ivideogpt_tpu_torch.mbrl.drq_workspace import has_snapshot
    cuts = dict(DRQ_CUTS)
    work = os.path.join(root, "drq")
    argv = cli_argv(work, DRQ_CUTS, "--drq_only")
    for k, v in DRQ_CUTS:
        print(f"drq: cut {k} = {v}")
    reset_counts()
    t0 = time.time()
    ws, rec = mbrl_cli(torch, argv)
    run_s = time.time() - t0
    launches = read_counts()
    steps = cuts["num_train_frames"] // 2
    seed_steps = cuts["num_seed_frames"] // 2
    check(ws.global_step == steps, f"drq: global_step {ws.global_step}")
    episodes = glob.glob(os.path.join(work, "buffer", "*.npz"))
    check(len(episodes) == steps // ws.cfg.duration and has_snapshot(work),
          f"drq: {len(episodes)} episodes on disk, snapshot "
          f"{has_snapshot(work)}")
    check(not any(launches.values()), f"drq: launches {launches}")
    check(rec["update"] and finite(v for _, m in rec["update"]
                                   for v in m.values()),
          "drq: a loss is not finite")
    evals = sorted(glob.glob(os.path.join(work, "eval_video", "*.gif")))
    frames, _, _ = read_gif(evals[0])
    check(len(frames) == ws.cfg.duration + 1, "drq: the eval GIF")
    upd_ms = [s * 1e3 for s, _ in rec["update"]]
    print(f"drq: {steps} env steps in {run_s:.1f} s; env steps/s "
          f"{steps_per_s(rec['steps'], 1, seed_steps - 1):.2f} in the seed "
          f"phase, {steps_per_s(rec['steps'], seed_steps, steps - 1):.2f} "
          f"after it ({len(upd_ms)} updates); an update "
          f"{np.mean(upd_ms):.3f} ms wall (median {np.median(upd_ms):.3f})")
    ws2 = resume_check(torch, ws, argv, "drq", world_model=False)
    ws.close()
    ws2.close()
    del ws, ws2
    torch.cuda.empty_cache()
    return launches


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

    threads = cpu_threads()
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

    torch.set_num_threads(cpu_threads())
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

    def drop_recording(dropout, B, H):
        drops.append(dropout)
        return real_drop(dropout, B, H)

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
    expect = dict(dict.fromkeys(launches, 0),
                  vq_argmin=2 * GPT_STEPS + n_val * 10,
                  flash_attention_fwd=12 * GPT_STEPS + n_val * 72,
                  flash_attention_bwd_dkv=12 * GPT_STEPS,
                  flash_attention_bwd_dq=12 * GPT_STEPS)
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
    want = dict(dict.fromkeys(launches, 0), vq_argmin=2 * EVAL_BATCHES,
                flash_attention_fwd=12 * EVAL_BATCHES * (1 + EVAL_REPS))
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
    steps' launches and the reading {"ms", "peak"}."""
    t0 = time.time()
    tokenizer, model, state, tokenize, px = medium_models(torch)
    n_lm = sum(p.numel() for p in model.parameters())
    L = 257 * CTX - 1 + 17 * (T - CTX)
    print(f"train_medium: models built in {time.time() - t0:.1f}s (LM "
          f"{n_lm / 1e6:.1f}M fp32 masters, bf16 compute, dropout {DROP_P})")
    losses, ms, peak, launches = timed_medium_steps(torch, state, tokenize,
                                                    px, 0)
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "train_medium: a loss is not finite")
    want = {"vq_argmin": 2, "decode_attention": 0, "flash_attention_fwd": 24,
            "flash_attention_bwd_dkv": 24, "flash_attention_bwd_dq": 24}
    for name, n in want.items():
        check(launches[name] == n * MEDIUM_TIMED,
              f"train_medium: {name} ran {launches[name]} times in "
              f"{MEDIUM_TIMED} steps, not {n} a step")
    print(f"train_medium: losses {[round(x, 4) for x in losses]}; "
          f"{MEDIUM_TIMED} timed steps, {ms:.2f} ms/step, "
          f"{TRAIN_B * L / ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak:.2f} GiB")
    del tokenizer, model, state
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "peak": peak}


def medium_models(torch):
    """The medium recipe's frozen fp32 TOKENIZER_64 and LLAMA_MEDIUM (bf16
    over fp32 masters, attention dropout DROP_P, no remat) from seed 15,
    a state with the recipe's optimizer, and one fixed batch of pixels made
    on the card."""
    from ivideogpt_tpu_torch.configs import LLAMA_MEDIUM, GPTTrainConfig
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    tokenizer, model = gt.build_train_models(
        lm_cfg=LLAMA_MEDIUM.replace(attention_dropout=DROP_P),
        context_length=CTX, segment_length=T, seed=15)
    state = gt.create_train_state(model, GPTTrainConfig(
        learning_rate=1e-4, lr_scheduler="cosine", lr_warmup_steps=0,
        max_train_steps=1000))
    g = torch.Generator(device="cuda").manual_seed(16)
    px = torch.rand(TRAIN_B, T, 64, 64, 3, device="cuda", generator=g)
    return tokenizer, model, state, gt.make_tokenize_fn(tokenizer, CTX), px


def timed_medium_steps(torch, state, tokenize, px, first_step):
    """MEDIUM_WARMUP then MEDIUM_TIMED train steps (the frozen tokenize
    inside each) on ``px``: (losses, ms/step of the timed ones, their peak
    memory in GiB, their launches)."""
    from ivideogpt_tpu_torch.train import gpt_trainer as gt

    def step(i):
        ids, labels = tokenize(px)
        return gt.train_step(state, {"input_ids": ids, "labels": labels},
                             rng=(0, first_step + i))

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
    return (losses, dt * 1e3, torch.cuda.max_memory_allocated() / 2**30,
            launches)


def phase_train_medium_dots(torch, plain):
    """LLAMA_MEDIUM as ``phase_train_medium`` builds it (B=16, L=751, bf16,
    attention dropout 0.1), with remat: ``remat_policy`` "none" (each
    layer recomputed) and "dots" (the seven projections' products kept,
    ``models/llama.py``), beside ``plain``, the no-remat reading of
    ``phase_train_medium`` ({"ms", "peak"}). First one forward and backward
    of each of the three on one batch with the dropout key (0, 0): the
    losses bit-equal, every gradient within 1e-3 of its tensor's norm
    (printed: whether bit-equal). Then MEDIUM_WARMUP and MEDIUM_TIMED steps
    under each policy: finite losses, launches a step (K1 2, K4 48: the
    forward's and the recompute's, K5/K6 24), ms/step and peak memory;
    the kept products' bytes predicted beside the peaks' difference.
    Returns the timed steps' launches (both policies)."""
    t0 = time.time()
    tokenizer, model, state, tokenize, px = medium_models(torch)
    llm = model.llm
    base_cfg = llm.config
    L = 257 * CTX - 1 + 17 * (T - CTX)
    print(f"train_medium_dots: models built in {time.time() - t0:.1f}s")
    ids, labels = tokenize(px)
    losses, grads, held = {}, {}, {}
    for policy in ("no remat", "none", "dots"):
        llm.config = base_cfg.replace(remat=policy != "no remat",
                                      remat_policy=("none" if policy ==
                                                    "no remat" else policy))
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        loss = model(ids, labels, dropout_key=(0, 0))["loss"]
        # what the forward leaves for the backward (the logits' included)
        held[policy] = (torch.cuda.memory_allocated() - before) / 2**30
        loss.backward()
        losses[policy] = loss.detach()
        # the act-free step leaves the action head without a gradient
        grads[policy] = [torch.zeros_like(p) if p.grad is None
                         else p.grad.clone() for p in state.params]
    model.zero_grad(set_to_none=True)
    ref = grads.pop("no remat")
    for policy, got in grads.items():
        check(torch.equal(losses[policy], losses["no remat"]),
              f"train_medium_dots: the loss under remat_policy {policy!r} "
              f"{float(losses[policy])!r} is not bit-equal to no remat's "
              f"{float(losses['no remat'])!r}")
        rel = max(float((g - r).norm() / r.norm().clamp_min(1e-30))
                  for g, r in zip(got, ref))
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        check(rel < 1e-3, f"train_medium_dots: a gradient under "
              f"remat_policy {policy!r} is {rel:.3e} of its norm from no "
              f"remat's")
        print(f"train_medium_dots: remat_policy {policy!r}: loss bit-equal "
              f"to no remat's ({float(losses[policy]):.6f}); gradients "
              f"{'bit-equal' if same else f'within {rel:.3e} of each norm'}")
    del grads, ref
    torch.cuda.empty_cache()

    launches, readings = {}, {}
    for i, policy in enumerate(("none", "dots")):
        llm.config = base_cfg.replace(remat=True, remat_policy=policy)
        step_losses, ms, peak, got = timed_medium_steps(
            torch, state, tokenize, px,
            i * (MEDIUM_WARMUP + MEDIUM_TIMED))
        check(all(x == x and abs(x) != float("inf") for x in step_losses),
              f"train_medium_dots ({policy}): a loss is not finite")
        want = {"vq_argmin": 2, "flash_attention_fwd": 48,
                "flash_attention_bwd_dkv": 24, "flash_attention_bwd_dq": 24}
        for name, n in want.items():
            check(got[name] == n * MEDIUM_TIMED,
                  f"train_medium_dots ({policy}): {name} ran {got[name]} "
                  f"times in {MEDIUM_TIMED} steps, not {n} a step")
        launches = {k: launches.get(k, 0) + v for k, v in got.items()}
        readings[policy] = (ms, peak)
        print(f"train_medium_dots: remat_policy {policy!r}: losses "
              f"{[round(x, 4) for x in step_losses]}; {MEDIUM_TIMED} timed "
              f"steps, {ms:.2f} ms/step, {TRAIN_B * L / ms * 1e3:.1f} "
              f"tokens/s, peak memory {peak:.2f} GiB; launches a step "
              + json.dumps({k: v // MEDIUM_TIMED for k, v in got.items()
                            if v}))
    llm.config = base_cfg
    c = base_cfg
    kept = (c.num_hidden_layers * TRAIN_B * L * 2
            * (4 * c.hidden_size + 2 * c.intermediate_size + c.hidden_size))
    (ms_n, peak_n), (ms_d, peak_d) = readings["none"], readings["dots"]
    print(f"train_medium_dots: ms/step no remat {plain['ms']:.2f} "
          f"(train_medium), remat 'none' {ms_n:.2f} "
          f"({ms_n / plain['ms']:.3f}x), 'dots' {ms_d:.2f} "
          f"({ms_d / plain['ms']:.3f}x); peak memory {plain['peak']:.2f} / "
          f"{peak_n:.2f} / {peak_d:.2f} GiB; held after the forward (no "
          f"remat / 'none' / 'dots') {held['no remat']:.2f} / "
          f"{held['none']:.2f} / {held['dots']:.2f} GiB; the products "
          f"'dots' keeps: {kept / 1e9:.2f} GB predicted, 'dots' holds "
          f"{(held['dots'] - held['none']) * 2**30 / 1e9:.2f} GB more than "
          f"'none' ({card_line()})")
    del tokenizer, model, state
    torch.cuda.empty_cache()
    return launches


def write_robodesk(root, n_train, n_test, frames, seed):
    """``{root}/robodesk/desk/{train,validation}_0/ep_*.npz`` (uint8
    ``image`` [frames, 64, 64, 3] and ``action`` [frames, 5], from a seed)
    for ``--dataset_name vp2_robodesk``, and its ``robodesk_dataset`` line
    appended to ``{root}/DATASET.yaml``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    top = os.path.join(root, "robodesk")
    for split, n in (("train_0", n_train), ("validation_0", n_test)):
        d = os.path.join(top, "desk", split)
        os.makedirs(d)
        for e in range(n):
            np.savez(os.path.join(d, f"ep_{e:04d}.npz"),
                     image=rng.integers(0, 256, (frames, 64, 64, 3),
                                        dtype=np.uint8),
                     action=rng.normal(size=(frames, VP2_A)).astype(
                         np.float32))
    with open(os.path.join(root, "DATASET.yaml"), "a") as f:
        f.write(f"robodesk_dataset: {top}\n")


def optimizer_bytes(state):
    return sum(t.numel() * t.element_size()
               for entry in state.optimizer.state.values()
               for t in entry.values() if hasattr(t, "numel"))


def recording_steps(train_gpt, name, keys, per_step, batches=None):
    """Wrap ``train_gpt.<name>`` (the CLI's step function): each call
    appends its dropout key to ``keys``, the kernels' launches inside it to
    ``per_step`` and, where asked, its batch's shapes to ``batches``.
    Returns a function that restores it."""
    real = getattr(train_gpt, name)

    def step(*args, rng=None):
        keys.append(rng)
        if batches is not None:
            batches.append({k: tuple(v.shape) for k, v in args[-1].items()})
        before = read_counts()
        m = real(*args, rng=rng)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return m
    setattr(train_gpt, name, step)
    return lambda: setattr(train_gpt, name, real)


def steady_ms(metrics, last=3):
    """The median step_ms of the last ``last`` logged steps."""
    import numpy as np
    return float(np.median([m["step_ms"] for m in metrics
                            if "step_ms" in m][-last:]))


def phase_train_gpt_lora(torch, root, hub, free):
    """``python -m ivideogpt_tpu_torch.train_gpt --lora`` in-process with
    the LM flags of the VP2 RoboDesk finetune recipe
    (``scripts/finetune/vp2-robodesk-64-act-cond.sh:15-27``: bf16, attention
    dropout 0.1, action-conditioned with action_dim 5, ctx 2, seg 12, B=16,
    the LLaMA warm-started from the hub's bare LLaMA through
    ``--load_internal_llm``, ``--use_eval_dataset --use_fvd
    --use_frame_metrics``) plus ``--lora --lora_r 8 --lora_alpha 16``, on
    synthetic RoboDesk episodes registered in the working directory's
    DATASET.yaml: steps 1-5 checkpoint at 5, a second run resumes and trains
    to 10, checkpointing and validating (with generation, FVD and the frame
    metrics, on the merged weights) there.

    Gates: finite metrics; the steps' dropout keys (seed, global step)
    across the resume and the kernels' (p, seed, offset_of(step, layer));
    K4/K5/K6 12 a step with dropout, K1 2 a step outside it, the
    validation's K1 10 / K4 72; both checkpoints hold the adapters and
    their AdamW state alone; the exported ``model.safetensors`` bit-equal
    to the warm-started base and every adapter's ``b`` off 0; a state
    restored from checkpoint-10 bit-equal to the live one, and so is one
    more step from each; ``IVideoGPTPredictor(lora=True, lora_r=8,
    lora_alpha=16)`` over the export: its folded weights within 1e-6 of
    each merged weight's largest element, its teacher-forced logits (fp32)
    within 1e-3 of the trainer's merged model run in fp32, and within 3e-2
    (relative L2: bf16 keeps 8 bits) of the trainer's own bf16 model.
    Prints ms/step (the CLI's, and a LoRA step against a full step on one
    batch in-process), peak memory and the optimizer state's bytes of
    each. Returns the two runs' launches."""
    import numpy as np
    from ivideogpt_tpu_torch import train_gpt
    from ivideogpt_tpu_torch.models.action_model import HeadModelWithAction
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
    from ivideogpt_tpu_torch.train import lora
    from ivideogpt_tpu_torch.utils import checkpoint as ckpt
    from ivideogpt_tpu_torch.utils import safetensors as st
    from ivideogpt_tpu_torch.vp.interface import IVideoGPTPredictor
    write_robodesk(root, 32, TRAIN_B, 16, seed=95)
    out = os.path.join(root, "lora_run")
    recipe = ["--pretrained_model_name_or_path", hub,
              "--pretrained_transformer_path", free, "--load_internal_llm",
              "--llm_config", "base", "--action_conditioned",
              "--action_dim", str(VP2_A), "--mixed_precision", "bf16",
              "--attention_dropout", str(DROP_P), "--embed_no_wd",
              "--weight_decay", "0.01", "--batch_size", str(TRAIN_B),
              "--gradient_accumulation_steps", "1", "--learning_rate", "1e-4",
              "--lr_scheduler_type", "cosine", "--num_warmup_steps", "0",
              "--dataset_name", "vp2_robodesk", "--dataset_path", root,
              "--resolution", "64", "--dataloader_num_workers", "16",
              "--video_stepsize", "1", "--segment_length", str(VP2_SEG),
              "--context_length", str(CTX), "--use_eval_dataset",
              "--use_fvd", "--use_frame_metrics",
              "--validation_eval_batches", "1", "--log_steps", "1",
              "--seed", "0", "--lora", "--lora_r", str(LORA_R),
              "--lora_alpha", str(LORA_ALPHA), "--output_dir", out]
    keys, per_step, drops = [], [], []
    restore = recording_steps(train_gpt, "lora_train_step", keys, per_step)
    real_drop = fa._drop_args

    def drop_recording(dropout, B, H):
        drops.append(dropout)
        return real_drop(dropout, B, H)
    fa._drop_args = drop_recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        train_gpt.main(recipe + [
            "--max_train_steps", str(LORA_CKPT), "--checkpointing_steps",
            str(LORA_CKPT), "--validation_steps", "100000"])
        t1 = time.time()
        live = train_gpt.main(recipe + [
            "--max_train_steps", str(LORA_STEPS), "--checkpointing_steps",
            str(LORA_STEPS), "--validation_steps", str(LORA_STEPS),
            "--resume_from_checkpoint", "latest"])
        torch.cuda.synchronize()
        t2 = time.time()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        restore()
        fa._drop_args = real_drop
    adapters = live.model
    n_adapt = sum(p.numel() for p in adapters.parameters())
    print(f"train_gpt_lora: two runs (1-{LORA_CKPT}, then resumed "
          f"{LORA_CKPT + 1}-{LORA_STEPS}) in {t1 - t0:.1f} s and "
          f"{t2 - t1:.1f} s, models, loaders, a validation and checkpoints "
          f"included; {len(adapters.names())} adapter pairs of rank "
          f"{adapters.rank}, {n_adapt / 1e6:.3f}M parameters; launches "
          f"{json.dumps(launches)}; peak memory {peak:.2f} GiB")
    check(keys == [(0, i) for i in range(LORA_STEPS)],
          f"train_gpt_lora: the steps' dropout keys are {keys[:3]}..., not "
          f"(seed, global step) across the resume")
    want = {"vq_argmin": 0, "flash_attention_fwd": 12,
            "flash_attention_bwd_dkv": 12, "flash_attention_bwd_dq": 12}
    for i, got in enumerate(per_step):
        check(all(got[k] == n for k, n in want.items())
              and sum(got.values()) == 36,
              f"train_gpt_lora: step {i} launched {got}")
    expect = dict(dict.fromkeys(launches, 0),
                  vq_argmin=2 * LORA_STEPS + 10,
                  flash_attention_fwd=12 * LORA_STEPS + 72,
                  flash_attention_bwd_dkv=12 * LORA_STEPS,
                  flash_attention_bwd_dq=12 * LORA_STEPS)
    check(launches == expect, f"train_gpt_lora: launches {launches}, not "
          f"{expect}")
    dropped = [d for d in drops if d is not None and d[0] > 0]
    check(sorted(dropped) == sorted(
        (DROP_P, 0, philox.offset_of(i, layer)) for i in range(LORA_STEPS)
        for layer in range(12) for _ in range(3)),
        "train_gpt_lora: the kernels' dropout arguments are not (0.1, seed, "
        "offset_of(step, layer)) for K4, K5 and K6 of every step")
    metrics = cli_metrics(out)
    finite_metrics(metrics, "train_gpt_lora")
    val = [m for m in metrics if "eval_loss" in m]
    check([m["step"] for m in val] == [LORA_STEPS]
          and "gen_fvd" in val[0] and val[0]["gen_generated"] == TRAIN_B,
          f"train_gpt_lora: validations {val}")
    for step in (LORA_CKPT, LORA_STEPS):
        held = st.load_file(os.path.join(out, f"checkpoint-{step}",
                                         ckpt.STATE_TENSORS))
        check(all(k.startswith(("model/a.", "model/b.", "optimizer/"))
                  for k in held), f"train_gpt_lora: checkpoint-{step} holds "
              f"more than the adapters and their AdamW state")
        size = sum(v.numel() * v.element_size() for v in held.values())
    print(f"train_gpt_lora: checkpoint-{LORA_STEPS} holds {len(held)} "
          f"tensors, {size / 2**20:.2f} MiB (adapters and AdamW state); "
          f"validation at {LORA_STEPS} on the merged weights: "
          + json.dumps({k: val[0][k] for k in
                        ("eval_loss", "gen_mse", "gen_psnr", "gen_fvd",
                         "validation_seconds")}))

    # the export: the base as warm-started, the adapters beside it
    args = train_gpt.parse_args(recipe + ["--max_train_steps",
                                          str(LORA_STEPS)])
    dev = torch.device("cuda")
    tokenizer, model = train_gpt.build_models(args, dev)
    tf_dir = os.path.join(out, "transformer")
    exported = st.load_file(os.path.join(tf_dir, ckpt.TRANSFORMER_FILE))
    base_sd = model.state_dict()
    check(sorted(exported) == sorted(base_sd) and all(
        torch.equal(exported[k], v.cpu()) for k, v in base_sd.items()),
        "train_gpt_lora: the exported base differs from the warm start")
    moved = [float(adapters.b[n].abs().max()) for n in adapters.names()]
    check(min(moved) > 0, f"train_gpt_lora: {moved.count(0.0)} adapters' b "
          f"still 0")
    flat = st.load_file(os.path.join(tf_dir, ckpt.LORA_FILE))
    check(sorted(flat) == sorted(adapters.flat()) and all(
        torch.equal(flat[k], v.cpu()) for k, v in adapters.flat().items()),
        "train_gpt_lora: lora.safetensors differs from the live adapters")

    # resume: a fresh state from checkpoint-10 equals the live one, and so
    # does one more step from each on the same batch
    lora.attach(model, adapters)
    _, fresh_model = train_gpt.build_models(args, dev)
    fresh = train_gpt.make_train_state(
        args, train_gpt.build_lora(args, fresh_model))
    ckpt.restore_train_state(os.path.join(out, f"checkpoint-{LORA_STEPS}"),
                             fresh)
    same_train_state(torch, live, fresh, "train_gpt_lora resume")
    g = torch.Generator(device="cuda").manual_seed(96)
    px = torch.rand(TRAIN_B, VP2_SEG, 64, 64, 3, device="cuda", generator=g)
    action = torch.randn(TRAIN_B, VP2_SEG, VP2_A, device="cuda", generator=g)
    ids, labels = train_gpt.make_tokenize_fn(tokenizer, CTX)(px)
    batch = {"input_ids": ids, "labels": labels, "action": action}
    for state, m in ((live, model), (fresh, fresh_model)):
        train_gpt.lora_train_step(state, m, batch, rng=(0, LORA_STEPS))
    same_train_state(torch, live, fresh, "train_gpt_lora: the step after "
                     "resume")
    del fresh, fresh_model
    print(f"train_gpt_lora: checkpoint-{LORA_CKPT} and "
          f"checkpoint-{LORA_STEPS} written; the exported base equals the "
          f"warm start bit for bit, lora.safetensors the live adapters; "
          f"every b off 0 (smallest max |b| {min(moved):.3e}); a state "
          f"restored from checkpoint-{LORA_STEPS} equals the live one "
          f"(adapters, AdamW moments and counts, counters), and so does the "
          f"next step from each")

    # the VP2 predictor over the export against the trainer's merged model
    pred = IVideoGPTPredictor(
        pretrained_vqgan_name_or_path=os.path.join(hub, "tokenizer"),
        pretrained_transformer_path=tf_dir, action_dim=VP2_A, lora=True,
        lora_r=LORA_R, lora_alpha=LORA_ALPHA)
    fp32 = HeadModelWithAction(model.llm_config, model.head_config)
    fp32.load_state_dict(lora.base_state_dict(model))
    lora.attach(fp32.to(dev).eval(), adapters)
    w_err = 0.0
    with torch.no_grad():
        for name, p in pred.model.named_parameters():
            mod, _, attr = name.rpartition(".")
            want_w = getattr(fp32.get_submodule(mod), attr)
            w_err = max(w_err, float((p - want_w).abs().max()
                                     / want_w.abs().max().clamp_min(1e-30)))
        model.eval()
        tf = {what: m(ids[:2], None, action[:2])["logits"]
              for what, m in (("predictor", pred.model), ("fp32", fp32),
                              ("bf16", model))}
    e_fp32 = float((tf["predictor"] - tf["fp32"]).abs().max())
    e_bf16 = float((tf["predictor"] - tf["bf16"]).norm()
                   / tf["predictor"].norm())
    check(w_err < 1e-6, f"train_gpt_lora: a folded weight is {w_err:.3e} of "
          f"its largest element from the merged weight")
    check(e_fp32 < 1e-3, f"train_gpt_lora: the predictor's teacher-forced "
          f"logits are {e_fp32:.3e} from the merged model's in fp32")
    check(e_bf16 < 3e-2, f"train_gpt_lora: the predictor's teacher-forced "
          f"logits are {e_bf16:.3e} (relative L2) from the trainer's bf16 "
          f"merged model's")
    print(f"train_gpt_lora: IVideoGPTPredictor(lora=True, lora_r={LORA_R}, "
          f"lora_alpha={LORA_ALPHA:g}) folds the export: weights within "
          f"{w_err:.3e} of the merged ones (relative to each tensor's "
          f"largest), teacher-forced logits {e_fp32:.3e} (max abs) from the "
          f"merged model in fp32 and {e_bf16:.3e} (relative L2) from the "
          f"trainer's bf16 model")
    pred.close()
    del pred, fp32, tf

    # a LoRA step against a full step on one batch, in-process
    ms_cli = steady_ms(metrics)

    def timed(step):
        for i in range(2):
            step(LORA_STEPS + 1 + i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        for i in range(5):
            step(LORA_STEPS + 3 + i)
        torch.cuda.synchronize()
        return ((time.time() - t) / 5 * 1e3,
                torch.cuda.max_memory_allocated() / 2**30)
    model.train()
    lora_ms, lora_peak = timed(lambda i: train_gpt.lora_train_step(
        live, model, batch, rng=(0, i)))
    lora_bytes = optimizer_bytes(live)
    lora.detach(model).requires_grad_(True)
    args.lora = False            # the same recipe's full run
    full = train_gpt.make_train_state(args, model)
    full_ms, full_peak = timed(lambda i: train_gpt.train_step(
        full, batch, rng=(0, i)))
    full_bytes = optimizer_bytes(full)
    print(f"train_gpt_lora: the CLI's steady ms/step {ms_cli:.2f} (median of "
          f"the last 3 logged steps); on one batch in-process (B={TRAIN_B}, "
          f"L={ids.shape[1]}, the tokenize outside): LoRA step "
          f"{lora_ms:.2f} ms, peak {lora_peak:.2f} GiB, AdamW state "
          f"{lora_bytes / 2**20:.2f} MiB; full step {full_ms:.2f} ms, peak "
          f"{full_peak:.2f} GiB, AdamW state {full_bytes / 2**20:.2f} MiB "
          f"({card_line()})")
    del live, full, model, tokenizer, batch, adapters
    torch.cuda.empty_cache()
    return launches


def phase_train_gpt_recipe(torch, root, hub, which):
    """A pretrain recipe's GPT stage through the CLI in-process, RECIPE_STEPS
    steps, no checkpoint or validation: ``which`` "256" is
    ``scripts/pretrain/oxe-256-act-free.sh:12-20`` (B=4, a frozen fp32
    TOKENIZER_256 at random weights from the seed, as the JAX driver builds
    one where the dir has no tokenizer, on the 256 px episodes of
    ``phase_train_tokenizer_256``), "goal" is
    ``scripts/pretrain/oxe-64-goal-cond.sh:15-23`` (``--goal_conditioned
    --segment_length 17``, B=16, the hub's TOKENIZER_64 on 64 px episodes):
    LLAMA_BASE from the seed, bf16, attention dropout 0.1, act-free, the
    ``debug`` mix (the recipes' ``select`` mix names OXE sets that are not
    here). Gates: finite losses; each step's batch [B, L] (L 751 / 768);
    K4/K5/K6 12 a step with dropout, K1 2 a step outside it. Prints
    ms/step (median of the last 3 steps), samples/s and peak memory.
    Returns the run's launches."""
    from ivideogpt_tpu_torch import train_gpt
    if which == "256":
        b, seg, res, L = GPT256_B, T, 256, 257 * CTX - 1 + 17 * (T - CTX)
        data = os.path.join(root, "tok256_data")
        tok_hub = os.path.join(root, "no_tokenizer")
        os.makedirs(tok_hub, exist_ok=True)
        extra = []
    else:
        b, seg, res, L = GOAL_B, GOAL_T, 64, GOAL_L
        data = write_episodes(os.path.join(root, "goal_data"), 16, 24,
                              seed=98)
        tok_hub = os.path.join(root, "goal_hub")
        os.makedirs(tok_hub, exist_ok=True)
        if not os.path.exists(os.path.join(tok_hub, "tokenizer")):
            os.symlink(os.path.join(hub, "tokenizer"),
                       os.path.join(tok_hub, "tokenizer"))
        extra = ["--goal_conditioned"]
    tag = f"train_gpt_{which}"
    out = os.path.join(root, f"{which}_run")
    argv = ["--output_dir", out, "--seed", "0", "--mixed_precision", "bf16",
            "--pretrained_model_name_or_path", tok_hub, "--llm_config",
            "base", "--batch_size", str(b), "--learning_rate", "1e-4",
            "--lr_scheduler_type", "cosine", "--dataset_name", "debug",
            "--resolution", str(res), "--dataloader_num_workers", "16",
            "--dataset_path", data, "--video_stepsize", "1",
            "--segment_length", str(seg), "--context_length", str(CTX),
            "--weight_decay", "0.01", "--attention_dropout", str(DROP_P),
            "--embed_no_wd", "--max_train_steps", str(RECIPE_STEPS),
            "--checkpointing_steps", "100000", "--validation_steps",
            "100000", "--log_steps", "1", *extra]
    keys, per_step, shapes = [], [], []
    restore = recording_steps(train_gpt, "train_step", keys, per_step,
                              shapes)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.time()
        state = train_gpt.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        restore()
    metrics = cli_metrics(out)
    finite_metrics(metrics, tag)
    check(len(per_step) == RECIPE_STEPS
          and all(s_ == {"input_ids": (b, L), "labels": (b, L)}
                  for s_ in shapes),
          f"{tag}: the steps' batches {shapes[:2]}, not [{b}, {L}]")
    for i, got in enumerate(per_step):
        check(got == dict(dict.fromkeys(got, 0), flash_attention_fwd=12,
                          flash_attention_bwd_dkv=12,
                          flash_attention_bwd_dq=12),
              f"{tag}: step {i} launched {got}")
    check(launches["vq_argmin"] == 2 * RECIPE_STEPS,
          f"{tag}: K1 ran {launches['vq_argmin']} times in {RECIPE_STEPS} "
          f"steps")
    ms = steady_ms(metrics)
    n_tok = sum(p.numel() for p in state.model.parameters())
    print(f"{tag}: {RECIPE_STEPS} steps in {wall:.1f} s (models and loaders "
          f"included), batches [{b}, {L}], LM {n_tok / 1e6:.1f}M; losses "
          f"{[m['loss'] for m in metrics]}; {ms:.2f} ms/step (median of the "
          f"last 3), {b / ms * 1e3:.2f} samples/s, {b * L / ms * 1e3:.1f} "
          f"tokens/s, peak memory {peak:.2f} GiB; launches "
          f"{json.dumps(launches)} ({card_line()})")
    del state
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
    discriminator on, one update a D step, every discriminator parameter
    off its initial value, and its loss off its first reading. Prints ms/step,
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
    gan_argv = argv("--max_train_steps", str(TT_GAN_STEPS), "--disc_start",
                    "0", "--lr_warmup_steps", "0", "--log_steps", "2",
                    "--log_image_steps", "0", "--validation_steps", "100000",
                    "--checkpointing_steps", "100000", out=gan_out)
    try:
        _, gan_disc, _ = cli.main(gan_argv)
    finally:
        restore()
    kinds = [k for k, _, _ in record]
    n_d = TT_GAN_STEPS // 2
    check(kinds == ["G_gan", "D"] * n_d,
          f"train_tokenizer GAN: step calls {kinds}")
    k1_per_step(record, "train_tokenizer GAN")
    metrics = cli_metrics(gan_out)
    finite_metrics(metrics, "train_tokenizer GAN")
    # the discriminator trained: its AdamW updated it once a D step, every
    # parameter left its initial value (built again from the same seed),
    # and its loss moved off its first reading. The loader's 16 workers
    # make the batch order, and so each reading, differ from run to run.
    check((gan_disc.step, gan_disc.updates) == (n_d, n_d),
          f"train_tokenizer GAN: discriminator counters "
          f"{gan_disc.step, gan_disc.updates}, want {n_d, n_d}")
    gan_args = cli.parse_args(gan_argv)
    _, disc0, _ = cli.build_models(gan_args, cli.tokenizer_config(gan_args),
                                   torch.device("cuda"))
    trained = dict(gan_disc.model.named_parameters())
    still = [k for k, p in disc0.named_parameters()
             if torch.equal(p, trained[k])]
    check(sorted(trained) == sorted(k for k, _ in disc0.named_parameters())
          and not still, f"train_tokenizer GAN: discriminator parameters "
          f"at their initial values after {n_d} D steps: {still}")
    d_loss = [m["discr_loss"] for m in metrics]
    check(len(d_loss) == n_d
          and max(abs(d - d_loss[0]) for d in d_loss[1:]) > 1e-3,
          f"train_tokenizer GAN: discriminator losses {d_loss}")
    del disc0, trained, gan_disc
    ms = {k: [round(t * 1e3, 2) for kk, _, t in record if kk == k]
          for k in ("G_gan", "D")}
    print(f"train_tokenizer GAN: discr_loss {d_loss}; gan_loss "
          f"{[m['gan_loss'] for m in metrics]}; adaptive_weight "
          f"{[m['adaptive_weight'] for m in metrics]}; host ms a step "
          f"{json.dumps(ms)}")
    torch.cuda.empty_cache()
    return launches


# the SSv2 phase: the select_sthsth run's steps (a validation at the last)
# and the sthsth run's, their log windows (a log falls on a discriminator
# micro-step: an even one), and the synthetic SSv2 videos ((frames,
# label): selected labels, two excluded, two shorter than the recipe's
# 16-frame window)
TTS_STEPS, TTS_LOG, TTS_SS_STEPS, TTS_SS_LOG = 20, 10, 6, 6
TTS_VIDEOS = [(24, "86"), (31, "1"), (48, "13"), (37, "40"), (29, "93"),
              (44, "104"), (26, "146"), (40, "173"), (35, "2"), (30, "7"),
              (12, "86"), (15, "5")]
TTS_Z = 5.0   # the SSv2 share's gate, in binomial standard deviations
FIXTURES = os.path.join(REPO, "tests", "data", "sthsth")


def decode_rate(jpeg, frames, threads, seconds=0.5):
    """Frames/s of ``threads`` threads decoding the JPEG bytes ``frames``
    round and round for about ``seconds``."""
    import threading
    done = [0] * threads
    stop = time.perf_counter() + seconds

    def work(k):
        while time.perf_counter() < stop:
            for data in frames:
                jpeg.decode_jpeg(data)
            done[k] += len(frames)
    t0 = time.perf_counter()
    pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return sum(done) / (time.perf_counter() - t0)


def write_ssv2(root, seq):
    """A synthetic SSv2 tree under ``root``: ``frames/<id>/{:06d}.jpg``
    linked to the committed 16-frame sequence (played forwards and back),
    and the list files in ``datasets/somethingv2`` (the reader's default
    ``list_dir``, relative to the working directory); the val split holds
    every third video."""
    frames = os.path.join(root, "frames")
    lists = os.path.join(root, "datasets", "somethingv2")
    os.makedirs(lists)
    rows = []
    for v, (n, label) in enumerate(TTS_VIDEOS):
        d = os.path.join(frames, f"{50001 + v}")
        os.makedirs(d)
        for i in range(n):
            k = i % (2 * len(seq) - 2)
            src = seq[k if k < len(seq) else 2 * len(seq) - 2 - k]
            os.symlink(src, os.path.join(d, f"{i + 1:06d}.jpg"))
        rows.append(f"{50001 + v} {n} {label}")
    with open(os.path.join(lists, "train_video_folder.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    with open(os.path.join(lists, "val_video_folder.txt"), "w") as f:
        f.write("\n".join(rows[::3]) + "\n")
    return frames


def write_oxe_select(root, seed, size=64):
    """Two episodes of each OXE_SELECT dataset under ``root/<name>``
    (episode 0 is the eval split's), uint8 frames under the dataset's
    display key, 16 frames at its stepsize at the recipe's
    ``--video_stepsize 1``."""
    import numpy as np
    from ivideogpt_tpu_torch.data import npz_dataset as npz
    from ivideogpt_tpu_torch.data.dataset_mixes import OXE_SELECT
    rng = np.random.default_rng(seed)
    for name, _ in OXE_SELECT:
        step = max(round(npz.get_base_stepsize(name)
                         / npz.MixRoboticDataset.FRAC_STEP_SIZE), 1)
        d = os.path.join(root, name)
        os.makedirs(d)
        for e in range(2):
            np.savez(os.path.join(d, f"episode_{e:03d}.npz"), **{
                npz.get_display_key(name): rng.integers(
                    0, 256, (16 * step, size, size, 3), dtype=np.uint8)})
    return root


def counting_draws(classes):
    """Count the calls of each class's ``sample`` from any thread: returns
    (counts by class name, the perf_counter seconds at which each draw
    returned, a function that restores the methods)."""
    import threading
    lock = threading.Lock()
    counts = {c.__name__: 0 for c in classes}
    returned = []
    real = {c: c.sample for c in classes}

    def wrap(cls):
        def sample(self):
            out = real[cls](self)
            with lock:
                counts[cls.__name__] += 1
                returned.append(time.perf_counter())
            return out
        return sample
    for c in classes:
        c.sample = wrap(c)
    return counts, returned, lambda: [setattr(c, "sample", f)
                                      for c, f in real.items()]


def phase_train_tokenizer_sthsth(torch, root):
    """The Something-Something v2 reader on the card's machine, and the
    tokenizer CLI over the SSv2 mixes at the OXE pretrain recipe's widths.

    Decoder gate: every committed fixture of tests/data/sthsth decoded by
    the library built here (``data/jpeg.py``, host C++) has the SHA-256 of
    PIL's decode recorded in ``digests.json``; the progressive one is
    refused. Decode rate: frames/s over the 16 427 x 240 4:2:0 frames on
    one thread, on the lane's threads and on the recipe's 16 loader
    workers. Data: a synthetic SSv2 tree (TTS_VIDEOS, frames linked to the
    committed sequence, two excluded labels, two videos too short) and two
    64 px episodes of each of OXE_SELECT's 38 datasets. Run: ``main`` of
    ``python -m ivideogpt_tpu_torch.train_tokenizer`` with
    ``scripts/pretrain/oxe-64-act-free.sh:7-13``'s flags (TOKENIZER_64
    from a seed, bf16, B=16, seg 8, ctx 2, ``--random_selection
    --segment_horizon 16``, 16 loader workers) and ``--dataset_name
    select_sthsth --sthsth_root_path``: TTS_STEPS micro-steps with a
    validation at the last; then TTS_SS_STEPS with ``--dataset_name
    sthsth``. Gates: finite metrics; K1 launched twice by every G and eval
    step and no other kernel; the validation grid decodes; the share of
    the mixture's draws that went to SSv2 within TTS_Z binomial standard
    deviations of its weight 0.15; the sthsth run drew from SSv2 alone.
    Prints ms/step, samples/s and ``loader_wait_ms`` of both mixes' last
    log window, the peak memory, and whether the loader or the card sets
    the sthsth run's step: the samples/s its 16 workers delivered (draws
    over the seconds between the first and the last) against the samples/s
    the loop takes when it does not wait (B over step_ms less
    loader_wait_ms). Returns the select_sthsth run's launches."""
    import hashlib
    import numpy as np
    from ivideogpt_tpu_torch import train_tokenizer as cli
    from ivideogpt_tpu_torch.data import jpeg
    from ivideogpt_tpu_torch.data import npz_dataset as npz
    from ivideogpt_tpu_torch.data import sthsth_dataset as ssv2
    from ivideogpt_tpu_torch.data.dataset_mixes import OXE_SELECT_STHSTH

    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    for rel, want in sorted(digests.items()):
        path = os.path.join(FIXTURES, rel)
        if rel == "progressive.jpg":
            try:
                jpeg.read_jpeg(path)
            except jpeg.JpegError as e:
                check("progressive" in str(e),
                      f"train_tokenizer_sthsth: {rel} refused as {e}")
            else:
                check(False, f"train_tokenizer_sthsth: {rel} was decoded")
            continue
        rgb = jpeg.read_jpeg(path)
        got = [list(rgb.shape), hashlib.sha256(rgb.tobytes()).hexdigest()]
        check(got == [want["shape"], want["sha256"]],
              f"train_tokenizer_sthsth: {rel} decodes to {got}, PIL's "
              f"digest is {want}")
    seq = sorted(os.path.join(FIXTURES, "seq", f)
                 for f in os.listdir(os.path.join(FIXTURES, "seq")))
    frames = [open(p, "rb").read() for p in seq]
    rates = {n: decode_rate(jpeg, frames, n)
             for n in (1, cpu_threads(), 16)}
    print(f"train_tokenizer_sthsth: the decoder built here gives PIL's "
          f"digests on all {len(digests) - 1} fixtures and refuses the "
          f"progressive one; 427 x 240 4:2:0 frames/s on 1 / "
          f"{cpu_threads()} (the lane's) / 16 (the loader's) threads "
          f"{json.dumps({n: round(r, 1) for n, r in rates.items()})} on "
          f"{os.cpu_count()} cores ({card_line()})")

    base = os.path.join(root, "sthsth")
    frames_root = write_ssv2(base, seq)
    oxe = write_oxe_select(os.path.join(base, "oxe"), seed=101)
    recipe = ["--seed", "0", "--mixed_precision", "bf16", "--learning_rate",
              "5e-4", "--disc_learning_rate", "5e-4", "--batch_size",
              str(TRAIN_B), "--gradient_accumulation_steps", "1",
              "--disc_start", "1000005", "--resolution", "64",
              "--dataloader_num_workers", "16", "--random_selection",
              "--video_stepsize", "1", "--segment_horizon", "16",
              "--segment_length", str(TOK_T), "--context_length",
              str(TOK_CTX), "--dataset_path", oxe, "--sthsth_root_path",
              frames_root, "--log_image_steps", "0",
              "--checkpointing_steps", "100000"]
    runs = {"select_sthsth": (TTS_STEPS, TTS_LOG, str(TTS_STEPS)),
            "sthsth": (TTS_SS_STEPS, TTS_SS_LOG, "100000")}
    steady, launches, drawn, delivered = {}, None, {}, {}
    with contextlib.chdir(base):
        for mix, (steps, log, val) in runs.items():
            out = os.path.join(base, f"run_{mix}")
            record = []
            restore = counted_steps(cli, record)
            counts, returned, uncount = counting_draws(
                (ssv2.SomethingV2Dataset, npz.RoboticDataset))
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                t0 = time.time()
                cli.main(recipe + ["--dataset_name", mix, "--output_dir",
                                   out, "--max_train_steps", str(steps),
                                   "--log_steps", str(log),
                                   "--validation_steps", val])
                torch.cuda.synchronize()
                wall = time.time() - t0
                got = read_counts()
                peak = torch.cuda.max_memory_allocated() / 2**30
            finally:
                restore()
                uncount()
            drawn[mix] = dict(counts)
            delivered[mix] = ((len(returned) - 1)
                              / (returned[-1] - returned[0]))
            kinds = [k for k, _, _ in record]
            n_eval = 4 if val == str(steps) else 0
            check(kinds.count("G") == steps // 2 and "D" not in kinds
                  and kinds.count("eval") == n_eval,
                  f"train_tokenizer_sthsth ({mix}): step calls "
                  f"{[kinds.count(k) for k in ('G', 'D', 'eval')]}")
            k1_per_step(record, f"train_tokenizer_sthsth ({mix})")
            check(got == dict(dict.fromkeys(got, 0),
                              vq_argmin=2 * len(record)),
                  f"train_tokenizer_sthsth ({mix}): launches {got}, the "
                  f"steps' K1 {2 * len(record)}")
            metrics = cli_metrics(out)
            finite_metrics(metrics, f"train_tokenizer_sthsth ({mix})")
            train = {m["step"]: m for m in metrics if "samples/sec" in m}
            check(sorted(train) == list(range(log, steps + 1, log)),
                  f"train_tokenizer_sthsth ({mix}): logged steps "
                  f"{sorted(train)}")
            last = train[steps]
            steady[mix] = (last["step_ms"], last["samples/sec"],
                           last["loader_wait_ms"], peak, wall)
            if mix == "select_sthsth":
                launches = got
                val_m = [m for m in metrics if "validation_seconds" in m]
                check([m["step"] for m in val_m] == [steps],
                      f"train_tokenizer_sthsth: validations "
                      f"{[m['step'] for m in val_m]}")
                img = read_png(os.path.join(out, "recon", f"step{steps}.png"))
                check(img.shape == (128, (TOK_T - TOK_CTX) * 64, 3),
                      f"train_tokenizer_sthsth: the grid is {img.shape}")
            print(f"train_tokenizer_sthsth ({mix}): {steps} micro-steps in "
                  f"{wall:.1f} s (models and loaders included); gen_loss "
                  f"{[train[s_]['gen_loss'] for s_ in sorted(train)]}; "
                  f"draws {json.dumps(drawn[mix])}")

    weights = dict(OXE_SELECT_STHSTH)
    p = weights["sthsth"] / sum(weights.values())
    k = drawn["select_sthsth"]["SomethingV2Dataset"]
    n = k + drawn["select_sthsth"]["RoboticDataset"]
    z = (k - n * p) / math.sqrt(n * p * (1 - p))
    check(abs(z) <= TTS_Z, f"train_tokenizer_sthsth: {k} of {n} draws from "
          f"SSv2 ({k / n:.4f}), {z:.2f} standard deviations off {p}")
    check(drawn["sthsth"]["RoboticDataset"] == 0
          and drawn["sthsth"]["SomethingV2Dataset"] > 0,
          f"train_tokenizer_sthsth: the sthsth run drew {drawn['sthsth']}")
    ms, sps, wait, _, _ = steady["sthsth"]
    need = TRAIN_B / (ms - wait) * 1e3
    verdict = ("the loader sets the step" if delivered["sthsth"] < need
               else "the card sets the step")
    print(f"train_tokenizer_sthsth: {k} of {n} of select_sthsth's draws "
          f"from SSv2 ({k / n:.4f}; weight {p:.4f}, {z:.2f} standard "
          f"deviations, gate {TTS_Z}); last log window (ms/step, samples/s, "
          f"loader_wait_ms, peak GiB): "
          + "; ".join(f"{m} {s[0]:.2f}, {s[1]:.2f}, {s[2]:.3f}, {s[3]:.2f}"
                      for m, s in steady.items())
          + f"; sthsth at the recipe's 16 workers: {verdict}: they "
          f"delivered {delivered['sthsth']:.2f} samples/s (select_sthsth's "
          f"{delivered['select_sthsth']:.2f}) where the loop takes "
          f"{need:.2f} when it does not wait (the loop waited {wait:.3f} of "
          f"{ms:.2f} ms a step over steps 1-{TTS_SS_STEPS}: the workers' "
          f"first fill, each of the 16 building a whole batch before the "
          f"first arrives) ({card_line()})")
    torch.cuda.empty_cache()
    return launches


# the native_preproc phase: the CLIs' segments (the BAIR tokenizer recipe's
# 8 frames and the GPT CLI's 16 of 64 px frames to 64, oxe-256's 8 of 256 px
# to 256) with the loaders' crop draws (scale 0.8-1, ratio 0.9-1.1; the
# CLIs pass no colour jitter, the gate adds one); the tokenizer CLI's runs
# of NP_STEPS micro-steps, logged every NP_LOG, in NP_ORDER: the plain
# numpy resize swapped in for "numpy", the port's loader for "fused"
NP_SHAPES = (("BAIR tokenizer", TOK_T, 64, 64), ("GPT CLI", T, 64, 64),
             ("oxe-256", TOK_T, 256, 256))
NP_JITTER = ((0.6, 1.4), (0.7, 1.3), (0.5, 1.5), (-0.1, 0.1))
NP_RESIZE_ATOL, NP_JITTER_ATOL = 2e-6, 3e-5
NP_STEPS, NP_LOG = 6, 2
NP_ORDER = ("numpy", "fused", "fused", "numpy")


def plain_augment_segment(augment, images, size, crop_scale, crop_ratio,
                          brightness, contrast, saturation, hue, rng):
    """``augment_segment``'s plain version: the same draws, then numpy's
    ``resized_crop`` on each frame over 255 (what the JAX package's default
    path computes with cv2), then the jitter."""
    import numpy as np
    t, hh, ww, _ = images.shape
    i, j, h, w = augment.get_crop_params(hh, ww, crop_scale or (1.0, 1.0),
                                         crop_ratio or (1.0, 1.0), rng)
    params = augment.jitter_params(brightness, contrast, saturation, hue, rng)
    return np.stack([augment.apply_jitter(augment.resized_crop(
        f.astype(np.float32) / 255.0, i, j, h, w, size), *params)
        for f in images])


def augment_rate(fn, images, size, threads, seconds=0.5):
    """Segments/s of ``threads`` threads calling ``fn`` (``augment_segment``
    or its plain version) on ``images`` round and round for about
    ``seconds``; each thread draws from its own Generator."""
    import threading
    import numpy as np
    done = [0] * threads
    stop = time.perf_counter() + seconds

    def work(k):
        rng = np.random.default_rng(k)
        while time.perf_counter() < stop:
            fn(images, size, (0.8, 1.0), (0.9, 1.1), None, None, None, None,
               rng)
            done[k] += 1
    t0 = time.perf_counter()
    pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return sum(done) / (time.perf_counter() - t0)


def phase_native_preproc(torch, root):
    """The loaders' fused host crop-resize-normalize (``augment_segment``
    through ``data/native.py`` over ``csrc/segment_ops.cpp``, built here by
    ``_build`` with the host C++ compiler) on the card's host.

    Gate: at each of NP_SHAPES' segments, the fused resize against the
    numpy ``resized_crop`` of every frame within NP_RESIZE_ATOL, and
    ``augment_segment`` against its plain version (the loaders' crop draws
    and NP_JITTER's colour jitter) within NP_JITTER_ATOL, the Generator
    left in the same state. Rate: the segments/s of each on 1 thread and on
    the loaders' 16. Run: ``main`` of ``python -m
    ivideogpt_tpu_torch.train_tokenizer`` with the BAIR finetune recipe's
    tokenizer flags (``phase_train_tokenizer``'s, without the hub's
    weights: TOKENIZER_64 from a seed, bf16, B=16, seg 8, ctx 1, 16 loader
    workers) on ``phase_train_tokenizer``'s synthetic episodes, NP_STEPS
    micro-steps a run in NP_ORDER, "numpy" with the plain version patched
    in for the loader's ``augment_segment``; gates: finite metrics, K1
    launched twice by every G step and no other kernel, every drawn sample
    through the fused call in a "fused" run and none in a "numpy" one.
    Prints each run's ms/step and ``loader_wait_ms`` (the first window, the
    16 workers' first fill, apart from the rest) and the samples/s the
    workers delivered: a smoke reading of a few steps beside the other
    lane, not a verdict on the step. Returns the launches of the first
    "fused" run."""
    import functools
    import threading
    import numpy as np
    from ivideogpt_tpu_torch import train_tokenizer as cli
    from ivideogpt_tpu_torch.data import augment, native
    from ivideogpt_tpu_torch.data import npz_dataset as npz

    plain = functools.partial(plain_augment_segment, augment)
    rng = np.random.default_rng(103)
    rates = {}
    for name, t, hw, size in NP_SHAPES:
        images = rng.integers(0, 256, (t, hw, hw, 3), dtype=np.uint8)
        for seed in range(3):
            i, j, h, w = augment.get_crop_params(
                hw, hw, (0.8, 1.0), (0.9, 1.1), np.random.default_rng(seed))
            fused = native.segment_crop_resize(images, i, j, h, w, size)
            ref = np.stack([augment.resized_crop(
                f.astype(np.float32) / 255.0, i, j, h, w, size)
                for f in images])
            err = float(np.abs(fused - ref).max())
            check(fused.shape == ref.shape and err <= NP_RESIZE_ATOL,
                  f"native_preproc ({name}): the fused resize of crop "
                  f"{(i, j, h, w)} is {err} off the numpy one (limit "
                  f"{NP_RESIZE_ATOL})")
            outs, states = [], []
            for fn in (augment.augment_segment, plain):
                g = np.random.default_rng(seed)
                outs.append(fn(images, size, (0.8, 1.0), (0.9, 1.1),
                               *NP_JITTER, g))
                states.append(g.bit_generator.state)
            err = float(np.abs(outs[0] - outs[1]).max())
            check(states[0] == states[1] and err <= NP_JITTER_ATOL,
                  f"native_preproc ({name}): augment_segment is {err} off "
                  f"its plain version (limit {NP_JITTER_ATOL}), Generator "
                  f"states equal: {states[0] == states[1]}")
        rates[name] = {f"{tag} x{n}": round(
            augment_rate(fn, images, size, n), 1)
            for tag, fn in (("numpy", plain),
                            ("fused", augment.augment_segment))
            for n in (1, 16)}
    print(f"native_preproc: the fused resize within {NP_RESIZE_ATOL} of the "
          f"numpy one and augment_segment within {NP_JITTER_ATOL} of its "
          f"plain version (jitter on, equal Generator states) at 3 crops of "
          f"each segment; segments/s of the plain version (numpy) and of "
          f"augment_segment (fused) on 1 and 16 threads of {os.cpu_count()} "
          f"cores: {json.dumps(rates)} ({card_line()})")

    data = write_episodes(os.path.join(root, "np_data"), TT_EPISODES,
                          GPT_FRAMES, seed=95)
    recipe = ["--seed", "0", "--mixed_precision", "bf16", "--batch_size",
              str(TRAIN_B), "--gradient_accumulation_steps", "1",
              "--disc_start", "1000005", "--dataset_name", "debug",
              "--resolution", "64", "--dataloader_num_workers", "16",
              "--random_selection", "--video_stepsize", "1",
              "--segment_horizon", "16", "--segment_length", str(TOK_T),
              "--context_length", "1", "--dataset_path", data,
              "--max_train_steps", str(NP_STEPS), "--log_steps", str(NP_LOG),
              "--log_image_steps", "0", "--validation_steps", "100000",
              "--checkpointing_steps", "100000"]
    real_fused = native.segment_crop_resize
    real_augment = augment.augment_segment
    real_sample = npz.RoboticDataset.sample
    runs, launches = [], None
    for k, tag in enumerate(NP_ORDER):
        out = os.path.join(root, f"np_run_{k}_{tag}")
        record, lock = [], threading.Lock()
        fused_calls, returned = [0], []

        def fused_counted(*a, **kw):
            with lock:
                fused_calls[0] += 1
            return real_fused(*a, **kw)

        def sample_counted(self):
            # the training loader's draws (the eval loader's are no_aug)
            got = real_sample(self)
            if not self.no_aug:
                with lock:
                    returned.append(time.perf_counter())
            return got
        restore = counted_steps(cli, record)
        native.segment_crop_resize = fused_counted
        npz.RoboticDataset.sample = sample_counted
        if tag == "numpy":
            augment.augment_segment = plain
        try:
            reset_counts()
            t0 = time.time()
            cli.main(recipe + ["--output_dir", out])
            torch.cuda.synchronize()
            wall = time.time() - t0
            got = read_counts()
        finally:
            native.segment_crop_resize = real_fused
            augment.augment_segment = real_augment
            npz.RoboticDataset.sample = real_sample
            restore()
        kinds = [kind for kind, _, _ in record]
        check(kinds == ["G"] * (NP_STEPS // 2),
              f"native_preproc ({tag}): step calls {kinds}")
        k1_per_step(record, f"native_preproc ({tag})")
        check(got == dict(dict.fromkeys(got, 0), vq_argmin=2 * len(record)),
              f"native_preproc ({tag}): launches {got}, the steps' K1 "
              f"{2 * len(record)}")
        drawn = len(returned)
        check(fused_calls[0] == (drawn if tag == "fused" else 0)
              and drawn >= NP_STEPS * TRAIN_B, f"native_preproc ({tag}): "
              f"{fused_calls[0]} fused calls for {drawn} augmented samples")
        metrics = cli_metrics(out)
        finite_metrics(metrics, f"native_preproc ({tag})")
        train = {m["step"]: m for m in metrics if "samples/sec" in m}
        check(sorted(train) == list(range(NP_LOG, NP_STEPS + 1, NP_LOG)),
              f"native_preproc ({tag}): logged steps {sorted(train)}")
        rest = [train[s_] for s_ in sorted(train)[1:]]
        runs.append(dict(
            path=tag,
            first_ms=round(train[NP_LOG]["step_ms"], 2),
            first_wait_ms=round(train[NP_LOG]["loader_wait_ms"], 3),
            ms=round(sum(m["step_ms"] for m in rest) / len(rest), 2),
            wait_ms=round(sum(m["loader_wait_ms"] for m in rest)
                          / len(rest), 3),
            delivered=round((len(returned) - 1)
                            / (returned[-1] - returned[0]), 2),
            wall_s=round(wall, 1),
            gen_loss=[train[s_]["gen_loss"] for s_ in sorted(train)]))
        if tag == "fused" and launches is None:
            launches = got
    mean = {tag: round(sum(r["ms"] for r in runs if r["path"] == tag)
                       / NP_ORDER.count(tag), 2) for tag in set(NP_ORDER)}
    print(f"native_preproc: the tokenizer CLI, BAIR recipe, {NP_STEPS} "
          f"micro-steps a run, in turns (ms/step and loader_wait_ms of steps "
          f"{NP_LOG + 1}-{NP_STEPS}; first_*: steps 1-{NP_LOG}, the 16 "
          f"workers' first fill; delivered: samples/s the workers' draws "
          f"returned, first to last): {json.dumps(runs)}; mean ms/step "
          f"{json.dumps(mean)}: a smoke reading beside the other lane, not "
          f"a verdict ({card_line()})")
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
    memory. Returns the launches and the first query's rgb."""
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
    return launches, out


def phase_vp2_int8(torch, hub, root, exact, convs):
    """The VP2 predictor with ``int8_detok=True`` on phase_vp2's query (the
    same seed, so the same token ids): launches of its first query (Q1 and
    the quantize kernel ``convs`` a decode chunk of 67, 4 chunks; K1 2, K4
    24, K3 0), rgb finite in [0, 1], the pixel gap to the exact render
    ``exact`` (mean, max, PSNR), seconds a query (``VARIANT_TIMED`` after
    the first, with their range), and the int8 render's device seconds
    against the first query's, which is traced (the exact render's
    beside)."""
    import numpy as np
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    from ivideogpt_tpu_torch.vp.interface import IVideoGPTPredictor
    pred = IVideoGPTPredictor(
        pretrained_vqgan_name_or_path=os.path.join(hub, "tokenizer"),
        pretrained_transformer_path=os.path.join(root, "vp2",
                                                 "transformer"),
        action_dim=VP2_A, generate_max_batchsize=VP2_CHUNK,
        decode_max_batchsize=VP2_DECODE, seed=0, int8_detok=True)
    rng = np.random.default_rng(94)
    batch = {"video": np.repeat(rng.uniform(0, 1, (1, CTX, 64, 64, 3))
                                .astype(np.float32), VP2_B, axis=0),
             "actions": rng.uniform(-1, 1, (VP2_B, VP2_T, VP2_A))
             .astype(np.float32)}
    # the first query traced, its token ids kept as the predictor hands
    # them to rollout.detokenize, for the render's share of a query
    inner, chunks_seen, query = ro.detokenize, [], {}

    def kept(tokenizer, ids, *args, **kw):
        chunks_seen.append(ids.clone())
        return inner(tokenizer, ids, *args, **kw)
    torch.cuda.synchronize()
    reset_counts()
    ro.detokenize = kept
    t0 = time.time()
    try:
        with kernel_trace(torch, query):
            out = pred(batch)["rgb"]
    finally:
        ro.detokenize = inner
    first_s = time.time() - t0
    launches = read_counts()
    chunks = VP2_B // VP2_CHUNK * -(-VP2_CHUNK // VP2_DECODE)
    want = {"vq_argmin": 2, "decode_attention": 0, "flash_attention_fwd": 24,
            "qconv": convs * chunks, "quantize": convs * chunks}
    for name, n in want.items():
        check(launches[name] == n, f"vp2_int8: {name} ran {launches[name]} "
              f"times in a query, not {n}")
    check(out.shape == exact.shape and bool(
        np.isfinite(out).all() and out.min() >= 0 and out.max() <= 1),
        "vp2_int8: rgb not finite in [0, 1]")
    mean, mx, psnr = frame_gap(torch, torch.from_numpy(out),
                               torch.from_numpy(exact))
    times = []
    for _ in range(VARIANT_TIMED):
        t0 = time.time()
        pred(batch)
        times.append(time.time() - t0)
    dt = sum(times) / len(times)
    print(f"vp2_int8: first query {first_s:.2f}s (traced), launches "
          f"{launches}; against the exact render of the same ids: mean "
          f"|diff| {mean:.5f}, max {mx:.4f}, PSNR {psnr:.2f} dB; "
          f"{VARIANT_TIMED} timed: {dt:.4f} s a query (runs {min(times):.4f}"
          f" to {max(times):.4f})")
    # the first query's render chunks alone, traced, int8 and exact
    render = {}
    for mode in ("1", "0"):
        res = {}
        with kernel_trace(torch, res), torch.inference_mode(), full_fp32():
            for ids in chunks_seen:
                inner(pred.tokenizer, ids, pred.ctx, chunk=ids.shape[0],
                      int8_detok=mode)
        render[mode] = res["seconds"]
    print(f"vp2_int8: the first query {query['seconds']:.4f} device s; its "
          f"{len(chunks_seen)} render chunks alone: int8 "
          f"{render['1']:.4f} device s ({render['1'] / query['seconds']:.4f} "
          f"of the query's device s, {render['1'] / dt:.4f} of its wall), "
          f"exact {render['0']:.4f}")
    del pred, chunks_seen
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# multi-process phases: two ranks on the one card over gloo (NCCL refuses
# two ranks on one card), and the NCCL path as a world of one

# dist_train's GPT steps and tokenizer G+D pairs, its global batch; the
# sharded rollouts' batches; a spawn's time limit (its ranks, its group)
DIST_STEPS, DIST_PAIRS, DIST_B = 3, 2, TRAIN_B
DIST_SERVE_DP_B, DIST_SERVE_TP_B = B, 32
# the TP rollout's segment: its 2 generated frames are 34 decode steps,
# each with 24 all-reduces through gloo (~5 ms each on one card)
DIST_TP_T = 4
# each rank's detokenize chunk: two ranks and the parent share the card
DIST_DETOK_CHUNK = 64
DIST_TIMEOUT = 300
# dist_train against one process on the same batch, bf16: the ranks'
# cuBLAS products run at other row counts (DP) or sum the projections'
# halves (TP), so each loss and gradient norm moves by bf16 rounding;
# the gates, relative: the loss within 2e-3, the gradient norm within
# 2e-2, the adaptive weight within 2e-2
DIST_LOSS_RTOL, DIST_NORM_RTOL = 2e-3, 2e-2
# dist_serve's TP replay against one process (bf16 LM, int8 cache): the
# largest |logit difference| and the mean top-100 set overlap (Jaccard)
DIST_LOGIT_ATOL, DIST_TOPK_MIN = 0.25, 0.9
DIST_REPLAY_ROWS, DIST_TOPK = 2, 100
# dist_cli: the GPT CLI's steps, a checkpoint at the last
DIST_CLI_STEPS = 4


def phase_dist_kernels(torch):
    """K4, K5 and K6 with dropout DROP_P, bf16 and fp32, at the training
    shape (B=16, S=751, H=12), launched whole and as the shards a data- or
    tensor-parallel rank launches: batch halves (b0 = 0, 8) and head
    halves (h0 = 0, 6 of Hg = 12), q/k/v read as views of the whole
    tensors, K5 and K6 fed the whole launch's lse and di rows. Gates: the
    concatenated O, lse, dQ, dK and dV equal the whole launch's bit for
    bit; the three kernels' masks of one shard (rows 8-9, heads 6-11),
    read back, equal the slice of ``philox.keep_mask`` over the whole
    batch, and its shard form."""
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
    b, s, H, hd = TRAIN_B, 751, 12, 64
    drop = (DROP_P, DROP_SEED, philox.offset_of(5, 1))
    cuts = {"batch": ((0, b // 2, 0, H), (b // 2, b // 2, 0, H)),
            "head": ((0, b, 0, H // 2), (0, b, H // 2, H // 2))}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(61)
        q, k, v, do = (torch.randn(b, s, H, hd, device="cuda", generator=g)
                       .to(dtype) for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, drop)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, di, drop)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, di, drop)
        whole = {"O": o, "lse": lse, "dQ": dq, "dK": dk, "dV": dv}
        for axis, shards in cuts.items():
            parts = []
            for b0, nb, h0, nh in shards:
                shard = drop + (b0, h0, H)
                qs, ks, vs = (t[b0:b0 + nb, :, h0:h0 + nh] for t in (q, k, v))
                dos = do[b0:b0 + nb, :, h0:h0 + nh].contiguous()
                lse_s = lse[b0:b0 + nb, h0:h0 + nh].contiguous()
                di_s = di[b0:b0 + nb, h0:h0 + nh].contiguous()
                o_s, l_s = fa.flash_fwd(qs, ks, vs, shard)
                dk_s, dv_s = fa.flash_bwd_dkv(qs, ks, vs, dos, lse_s, di_s,
                                              shard)
                dq_s = fa.flash_bwd_dq(qs, ks, vs, dos, lse_s, di_s, shard)
                parts.append({"O": o_s, "lse": l_s, "dQ": dq_s, "dK": dk_s,
                              "dV": dv_s})
            for name, t in whole.items():
                dim = 0 if axis == "batch" else (1 if name == "lse" else 2)
                got = torch.cat([p[name] for p in parts], dim=dim)
                check(torch.equal(got, t), f"dist_kernels: {dtype} {name} "
                      f"of the {axis} halves differs from the whole launch")
        print(f"dist_kernels: {dtype} K4, K5 and K6 with dropout {DROP_P} "
              f"at B={b}, S={s}, H={H}: the batch halves (b0 = 0, {b // 2}) "
              f"and the head halves (h0 = 0, {H // 2} of Hg = {H}) "
              f"concatenate to the whole launch's O, lse, dQ, dK and dV bit "
              f"for bit")
        del q, k, v, do, o, lse, di, dk, dv, dq, whole, parts
    shard = drop + (8, 6, H)
    want = philox.keep_mask(drop, b, H, s, 0, s, 0, s, device="cuda")
    want = want[8:10, 6:12]
    check(torch.equal(want, philox.keep_mask(shard, 2, 6, s, 0, s, 0, s,
                                             device="cuda")),
          "dist_kernels: keep_mask of the shard is not the slice")
    want &= torch.ones(s, s, device="cuda", dtype=torch.bool).tril()
    got = kernel_masks(torch, shard, 2, 6, s)
    for i, name in enumerate(("K4", "K5", "K6")):
        check(torch.equal(got[i], want), f"dist_kernels: {name}'s mask of "
              f"the shard (rows 8-9, heads 6-11 of 16 x 12) differs from "
              f"keep_mask's slice")
    print(f"dist_kernels: the masks of K4, K5 and K6 launched on rows 8-9 "
          f"and heads 6-11 (b0 = 8, h0 = 6, Hg = {H}) equal keep_mask's "
          f"slice of the whole batch's bit for bit")


def dist_gpt_steps(torch, mesh=None):
    """DIST_STEPS GPT steps at full width (TOKENIZER_64 frozen fp32, K1;
    LLAMA_BASE bf16 over fp32 masters, attention dropout DROP_P, K4-K6)
    on a global batch of DIST_B clips from a seed, this rank's rows on a
    ``mesh`` (the whole batch without). Returns each step's loss, gradient
    norm and ms, the share of the steps' wall time inside collectives,
    the launches of the steps and the parameters' sha256."""
    import hashlib
    from ivideogpt_tpu_torch.configs import LLAMA_BASE, GPTTrainConfig
    from ivideogpt_tpu_torch.parallel import distributed as dist_lib
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.train import gpt_trainer as gt
    tokenizer, model = gt.build_train_models(
        context_length=CTX, segment_length=T, seed=70,
        lm_cfg=LLAMA_BASE.replace(attention_dropout=DROP_P))
    cfg = GPTTrainConfig(learning_rate=1e-4, lr_scheduler="constant",
                         lr_warmup_steps=0, max_grad_norm=1.0)
    kw = {}
    if mesh is not None:
        mesh_lib.shard_params(model, mesh)
        kw["mesh"] = mesh
    state = gt.create_train_state(model, cfg)
    if mesh is not None:
        mesh_lib.place_state(state, mesh)
    tokenize = gt.make_tokenize_fn(tokenizer, CTX)
    g = torch.Generator(device="cuda").manual_seed(71)
    px = torch.rand(DIST_B, T, 64, 64, 3, device="cuda", generator=g)
    if mesh is not None:
        px = px[mesh_lib.batch_rows(DIST_B, mesh)]
    out = {"loss": [], "grad_norm": [], "ms": []}
    comm = [0.0]
    real = dist_lib._all_reduce_sum_

    def timed(t, group=None):
        torch.cuda.synchronize()
        t0 = time.time()
        r = real(t, group)
        torch.cuda.synchronize()
        comm[0] += time.time() - t0
        return r
    dist_lib._all_reduce_sum_ = timed
    try:
        reset_counts()
        for i in range(DIST_STEPS):
            torch.cuda.synchronize()
            t0 = time.time()
            ids, labels = tokenize(px)
            m = gt.train_step(state, {"input_ids": ids, "labels": labels},
                              (DROP_SEED, i), **kw)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["ms"].append((time.time() - t0) * 1e3)
        out["launches"] = read_counts()
    finally:
        dist_lib._all_reduce_sum_ = real
    out["comm_share"] = comm[0] / (sum(out["ms"]) / 1e3)
    h = hashlib.sha256()
    for p in state.params:
        h.update(p.detach().float().cpu().reshape(-1).numpy().tobytes())
    out["digest"] = h.hexdigest()
    del tokenizer, model, state
    torch.cuda.empty_cache()
    return out


def dist_tok_pairs(torch, mesh=None):
    """DIST_PAIRS tokenizer G+D pairs at full width (TOKENIZER_64 without
    cross-attention dropout, so that one process and the ranks draw no
    masks; the CLI's depth-4 discriminator; LPIPS; fp32, the CLI's default
    precision, TF32 off: in bf16 the hinge loss's kinks turn the ranks'
    other rounding into a D gradient norm 3 % apart after one update, GAN
    on) on a global batch of DIST_B clips of TOK_T frames,
    this rank's rows on a ``mesh``. Returns each pair's losses, adaptive
    weight and gradient norms, its ms, the launches and the sha256 of both
    models' parameters and the discriminator's buffers."""
    import hashlib
    from ivideogpt_tpu_torch.configs import (TOKENIZER_64,
                                             DiscriminatorConfig,
                                             TokenizerTrainConfig)
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.train import tokenizer_trainer as tt
    tok, disc, lpips = tt.build_tokenizer_train_models(
        TOKENIZER_64.replace(cross_attn_dropout=0.0),
        DiscriminatorConfig(depth=4), compute_dtype=torch.float32, seed=72)
    cfg = TokenizerTrainConfig(batch_size=DIST_B, segment_length=TOK_T,
                               context_length=TOK_CTX, lr_warmup_steps=0)
    kw = {} if mesh is None else {"mesh": mesh}
    state, disc_state = tt.create_train_states(tok, disc, cfg)
    g_step = tt.make_generator_step(tok, disc, lpips, cfg, use_gan=True,
                                    **kw)
    d_step = tt.make_discriminator_step(tok, disc, cfg, **kw)
    g = torch.Generator(device="cuda").manual_seed(73)
    px = torch.rand(DIST_B, TOK_T, 64, 64, 3, device="cuda", generator=g)
    if mesh is not None:
        px = px[mesh_lib.batch_rows(DIST_B, mesh)]
    keys = ("gen_loss", "adaptive_weight", "grad_norm", "discr_loss",
            "disc_grad_norm")
    out = {k: [] for k in (*keys, "ms")}
    reset_counts()
    for i in range(DIST_PAIRS):
        torch.cuda.synchronize()
        t0 = time.time()
        m = g_step(state, px, torch.Generator(device="cuda").manual_seed(i))
        m.update(d_step(disc_state, px,
                        torch.Generator(device="cuda").manual_seed(i)))
        for k in keys:
            out[k].append(float(m[k]))
        out["ms"].append((time.time() - t0) * 1e3)
    out["launches"] = read_counts()
    h = hashlib.sha256()
    for t in [*tok.parameters(), *disc.parameters(), *disc.buffers()]:
        h.update(t.detach().float().cpu().reshape(-1).numpy().tobytes())
    out["digest"] = h.hexdigest()
    del tok, disc, lpips, state, disc_state
    torch.cuda.empty_cache()
    return out


def dist_rollout(torch, n_model, batch, seg=T):
    """``parallel/serving.sharded_rollout`` on this rank (a mesh of
    ``n_model``) over the main rollout's models and inputs (seeds 0 and 3)
    cut to ``batch`` clips of ``seg`` frames: a warm-up rollout of one
    frame on a few clips, then the timed one.
    Returns its wall s, frames/s of the whole batch, the launches, and its
    first DIST_REPLAY_ROWS rows' tokens, actions and teacher-forced
    logits (``generation.replay_logits`` over an int8 cache, on the CPU)
    for the parent to hold against one process."""
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch import tokens as tok
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    from ivideogpt_tpu_torch.parallel import serving
    mesh = mesh_lib.make_global_mesh(n_model)
    tokenizer, lm = ro.build_models(context_length=CTX, segment_length=T,
                                    seed=0)
    serving.place_inference_params(lm, mesh)
    g = torch.Generator(device="cuda").manual_seed(3)
    px = torch.rand(B, CTX, 64, 64, 3, device="cuda", generator=g)[:batch]
    action = torch.randn(B, T, 4, device="cuda", generator=g)[:batch, :seg]

    def run(n, seed, frames=seg):
        return serving.sharded_rollout(
            tokenizer, lm, px[:n], mesh=mesh, action=action[:n, :frames],
            generator=torch.Generator(device="cuda").manual_seed(seed),
            segment_length=frames, context_length=CTX,
            cache_dtype=torch.int8, detok_chunk=DIST_DETOK_CHUNK)
    run(2 * mesh.n_data, 1, CTX + 1)   # the warm-up: one frame
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    frames, res = run(batch, 4)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_counts()
    rows = batch // mesh.n_data
    check_stream(torch, tok, tokenizer.config, res.tokens, rows, T=seg)
    check(tuple(frames.shape) == (rows, seg, 64, 64, 3)
          and bool(torch.isfinite(frames).all()),
          f"dist_serve: frames {tuple(frames.shape)} not finite or not "
          f"the rank's rows")
    mine = mesh_lib.batch_rows(batch, mesh)
    r = DIST_REPLAY_ROWS
    logits = generation.replay_logits(
        lm, res.tokens[:r], segment_length=seg, context_length=CTX,
        action=action[mine][:r], cache_dtype=torch.int8)
    out = {"wall": wall, "fps": batch * (seg - CTX) / wall, "seg": seg,
           "launches": launches, "tokens": res.tokens[:r].cpu(),
           "action": action[mine][:r].cpu(), "logits": logits.cpu(),
           "mesh": mesh.shape}
    del tokenizer, lm, frames, res
    torch.cuda.empty_cache()
    return out


def gloo_cuda_probe(torch):
    """Which collectives a gloo group takes on CUDA tensors (the port's
    collectives never ask: over gloo they run on CPU copies), in a group
    of its own with a short timeout."""
    import datetime
    import torch.distributed as dist
    group = dist.new_group(timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device="cuda")
    ops = {"all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
           "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
           "all_gather (list)": lambda: dist.all_gather(
               [torch.empty_like(x) for _ in range(2)], x, group=group),
           "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
               torch.empty(8, device="cuda"), x, group=group),
           "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
               torch.empty(2, device="cuda"), x, group=group)}
    out = {}
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 -- the probe's answer
            out[name] = f"{type(e).__name__}: {str(e)[:120]}"
    return out


def dist_job_train(torch, rank, probe=False):
    """dist_train's and dist_serve's work on one rank: GPT steps at DP=2
    and at TP=2, tokenizer pairs at DP=2, the sharded rollouts at DP=2
    over DIST_SERVE_DP_B and TP=2 over DIST_SERVE_TP_B (with ``probe``,
    first :func:`gloo_cuda_probe`)."""
    from ivideogpt_tpu_torch.parallel import mesh as mesh_lib
    t0 = time.time()

    def done(what):
        print(f"dist: rank {rank} {what} at {time.time() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
    out = {"probe": gloo_cuda_probe(torch)} if probe else {}
    for n_model in (1, 2):
        out[f"gpt_{n_model}"] = dist_gpt_steps(
            torch, mesh_lib.make_global_mesh(n_model))
        done(f"GPT steps (n_model {n_model})")
    out["tok"] = dist_tok_pairs(torch, mesh_lib.make_global_mesh(1))
    done("tokenizer pairs")
    out["serve_dp"] = dist_rollout(torch, 1, DIST_SERVE_DP_B)
    done("DP rollout")
    out["serve_tp"] = dist_rollout(torch, 2, DIST_SERVE_TP_B, DIST_TP_T)
    done("TP rollout")
    return out


def dist_job_cli(torch, rank, argv_runs):
    """Each argv of ``argv_runs`` through ``train_gpt.main`` on this rank:
    the files it opens for writing, and per run its step, its trained
    parameters' sha256 and the steady ms/step its metrics log."""
    import builtins
    import hashlib
    from ivideogpt_tpu_torch import train_gpt
    writes, runs = [], []
    real_open = builtins.open

    def recording(file, mode="r", *args, **kw):
        if any(c in mode for c in "wax+"):
            writes.append(os.path.abspath(str(file)))
        return real_open(file, mode, *args, **kw)
    builtins.open = recording
    try:
        for argv in argv_runs:
            reset_counts()
            t0 = time.time()
            state = train_gpt.main(argv)
            h = hashlib.sha256()
            for p in state.params:
                h.update(p.detach().float().cpu().reshape(-1).numpy()
                         .tobytes())
            runs.append({"step": state.step, "digest": h.hexdigest(),
                         "s": time.time() - t0, "launches": read_counts()})
    finally:
        builtins.open = real_open
    return {"writes": writes, "runs": runs}


def dist_rank_main(argv):
    """A rank of a multi-process phase: ``--dist-rank <job> <host:port>
    <world> <rank> <dir> <backend>``, on cuda:0 (LOCAL_RANK 0 for every
    rank): job "cli" runs the trainer CLI's runs of ``<dir>/job.json``,
    which join the group from their flags; job "train" joins the group,
    runs :func:`dist_job_train`, leaves the group and runs the CLI's
    runs, which join one at ``cli_coord``. Writes the result to
    ``<dir>/rank<rank>.pt``."""
    import datetime
    import torch
    job, coord, world, rank, out_dir, backend = argv
    world, rank = int(world), int(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(out_dir, "job.json")) as f:
        spec = json.load(f)
    if job == "cli":
        res = dist_job_cli(torch, rank, [
            a + ["--coordinator_address", coord, "--num_processes",
                 str(world), "--process_id", str(rank), "--dist_backend",
                 backend] for a in spec["argv"]])
    else:
        from ivideogpt_tpu_torch.parallel import distributed as dist_lib
        dist_lib.maybe_initialize(
            coord, world, rank, device="cuda", backend=backend,
            timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
        res = dist_job_train(torch, rank, spec.get("probe", False))
        # the trainer CLI then joins a group of its own from its flags
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        res["cli"] = dist_job_cli(torch, rank, [
            a + ["--coordinator_address", spec["cli_coord"],
                 "--num_processes", str(world), "--process_id", str(rank),
                 "--dist_backend", backend] for a in spec["cli_argv"]])
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(torch, job, world, out_dir, backend, spec=None,
                timeout=DIST_TIMEOUT):
    """Start ``world`` ranks of ``job`` (``--dist-rank``), all on cuda:0;
    returns a function that waits for them (killing every rank when one
    fails or the time runs out) and returns their results in rank
    order."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "job.json"), "w") as f:
        json.dump(spec or {}, f)
    coord = f"127.0.0.1:{free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["LOCAL_RANK"] = "0"
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-rank", job,
         coord, str(world), str(r), out_dir, backend],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=os.getcwd())
        for r in range(world)]
    deadline = time.time() + timeout

    def wait():
        # every rank is killed as soon as one fails: its peers would wait
        # in a collective until the group's timeout
        try:
            while time.time() < deadline:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) or any(codes):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                text = f.read()
            if r in bad:
                print(f"{job} rank {r} (exit {procs[r].returncode}):\n"
                      f"{text[-4000:]}")
            for line in text.splitlines():
                if line.startswith("dist: "):
                    print(f"{job}: {line[6:]}")
        check(not bad, f"{job}: ranks {bad} failed or outlasted {timeout} s")
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pt")
            results.append(torch.load(path, weights_only=False))
            os.remove(path)
        return results
    return wait


def rel_gap(a, b):
    return max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))


def dist_cli_argv(root, hub, free, out, b):
    """The GPT CLI's flags for dist_cli: the recipe's LM flags (bf16,
    dropout DROP_P, warm start from the hub), B=``b`` a rank, on the
    synthetic BAIR episodes, DIST_CLI_STEPS steps with a checkpoint at the
    last, no validation."""
    return ["--pretrained_model_name_or_path", hub,
            "--pretrained_transformer_path", free, "--load_internal_llm",
            "--llm_config", "base", "--action_conditioned",
            "--action_dim", "4", "--mixed_precision", "bf16",
            "--attention_dropout", str(DROP_P), "--batch_size", str(b),
            "--learning_rate", "1e-4", "--num_warmup_steps", "0",
            "--dataset_name", "bair", "--dataset_path", root,
            "--resolution", "64", "--dataloader_num_workers", "2",
            "--segment_length", str(T), "--context_length", str(CTX),
            "--max_train_steps", str(DIST_CLI_STEPS),
            "--checkpointing_steps", str(DIST_CLI_STEPS),
            "--validation_steps", "100000", "--log_steps", "1",
            "--no_validation_generation", "--seed", "0",
            "--output_dir", out, "--device", "cuda"]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(torch, root, hub, free, logs, probe=False):
    """dist_train, dist_serve and dist_cli, started together (in the hub's
    directory, on its synthetic BAIR episodes): two ranks on cuda:0 over
    gloo (``--dist-rank``), an NCCL world of one beside them, and one
    process's references on the same card and batch in this process.

    dist_train: DIST_STEPS GPT steps (bf16, dropout DROP_P, global
    B=DIST_B) at DP=2, then at TP=2 (LLAMA_BASE's 12 heads 6 a rank, the
    MLP's 3072 columns 1536), DIST_PAIRS fp32 tokenizer G+D pairs at DP=2;
    the losses within DIST_LOSS_RTOL and the gradient norms (and the
    adaptive weight) within DIST_NORM_RTOL of one process's, parameters
    (and the discriminator's buffers) bit-identical across the DP ranks,
    each kernel of the path launched on every rank; each step's ms and
    the share of it inside the collectives (gloo through the host)
    printed, not claimed. dist_serve: ``sharded_rollout`` at DP=2 over
    B=256 and at TP=2 over B=32 and DIST_TP_T frames (main's models, int8
    cache): the token contract and finite frames on every rank; replays,
    teacher-forced, against one process's replay of the same rows: DP
    rank 0's bit-equal (the same model; rank 1 runs it on other rows),
    both TP ranks' |logit difference| within DIST_LOGIT_ATOL and top-100
    sets' mean Jaccard at least DIST_TOPK_MIN; frames/s and the launches
    of K1, K3 and K4 a rank. dist_cli: ``train_gpt`` through the
    JAX-spelled flags (``--coordinator_address 127.0.0.1:<port>
    --num_processes N --process_id i``, ``dist_cli_argv``): (1) NCCL as a
    world of one, B=16, DIST_CLI_STEPS steps with a checkpoint, then a
    resume from it bit-equal to the live state; (2) the two gloo ranks,
    after their own work, leave their group and run the CLI at B=8 a rank
    over ``--dist_backend gloo``: parameters bit-identical, every file
    written by rank 0 alone (rank 1 opens none under the run's
    directory), one log line a step. Rank logs go to ``logs``. Returns
    rank 0's launches: {"dist_train": its GPT and tokenizer steps,
    "dist_serve": its two rollouts, "dist_cli": its CLI run and the NCCL
    runs}."""
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import rollout as ro
    one_out, two_out = (os.path.join(root, f"dist_cli_{w}") for w in (1, 2))
    one = dist_cli_argv(root, hub, free, one_out, TRAIN_B)
    t0 = time.time()
    wait_nccl = spawn_ranks(torch, "cli", 1, os.path.join(logs, "cli"),
                            "nccl", {"argv": [one, one + [
                                "--resume_from_checkpoint", "latest"]]})
    wait = spawn_ranks(torch, "train", 2, os.path.join(logs, "train"),
                       "gloo", {"probe": probe,
                                "cli_coord": f"127.0.0.1:{free_port()}",
                                "cli_argv": [dist_cli_argv(
                                    root, hub, free, two_out,
                                    TRAIN_B // 2)]})
    one_gpt = dist_gpt_steps(torch)
    one_tok = dist_tok_pairs(torch)
    t_one = time.time() - t0
    (nccl,) = wait_nccl()
    t_nccl = time.time() - t0
    ranks = wait()
    print(f"dist: the ranks ran {time.time() - t0:.1f} s, the NCCL world of "
          f"one {t_nccl:.1f} s beside them (one process's reference steps "
          f"{t_one:.1f} s, beside both)")
    if probe:
        print(f"dist_train: gloo on CUDA tensors (torch {torch.__version__})"
              f": {json.dumps(ranks[0]['probe'])}")
    for n_model, tag in ((1, "DP=2"), (2, "TP=2")):
        for r, res in enumerate(ranks):
            got = res[f"gpt_{n_model}"]
            lg = rel_gap(got["loss"], one_gpt["loss"])
            ng = rel_gap(got["grad_norm"], one_gpt["grad_norm"])
            check(lg < DIST_LOSS_RTOL and ng < DIST_NORM_RTOL,
                  f"dist_train: GPT {tag} rank {r}: losses {got['loss']} "
                  f"(gap {lg:.3e}) / norms {got['grad_norm']} (gap "
                  f"{ng:.3e}) against one process's {one_gpt['loss']} / "
                  f"{one_gpt['grad_norm']}")
            for k in ("vq_argmin", "flash_attention_fwd",
                      "flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
                check(got["launches"][k] > 0, f"dist_train: {k} never ran "
                      f"in GPT {tag} rank {r}")
            print(f"dist_train: GPT {tag} rank {r}: losses "
                  f"{got['loss']}, gradient norms {got['grad_norm']}; "
                  f"largest relative gap to one process {lg:.3e} (loss), "
                  f"{ng:.3e} (norm); ms a step {got['ms']}, "
                  f"{got['comm_share']:.3f} of them in collectives; "
                  f"launches {json.dumps(got['launches'])}")
    check(ranks[0]["gpt_1"]["digest"] == ranks[1]["gpt_1"]["digest"],
          "dist_train: the DP ranks' GPT parameters differ")
    print(f"dist_train: one process: GPT losses {one_gpt['loss']}, norms "
          f"{one_gpt['grad_norm']}, ms a step {one_gpt['ms']}; the DP "
          f"ranks' parameters bit-identical (sha256 "
          f"{ranks[0]['gpt_1']['digest'][:16]})")
    for r, res in enumerate(ranks):
        got = res["tok"]
        gaps = {k: rel_gap(got[k], one_tok[k]) for k in
                ("gen_loss", "discr_loss", "adaptive_weight", "grad_norm",
                 "disc_grad_norm")}
        check(gaps["gen_loss"] < DIST_LOSS_RTOL
              and gaps["discr_loss"] < DIST_LOSS_RTOL
              and max(gaps["adaptive_weight"], gaps["grad_norm"],
                      gaps["disc_grad_norm"]) < DIST_NORM_RTOL,
              f"dist_train: tokenizer DP=2 rank {r}: {got} against one "
              f"process's {one_tok} (gaps {gaps})")
        check(got["launches"]["vq_argmin"] > 0, "dist_train: K1 never ran "
              f"in the tokenizer pairs of rank {r}")
        print(f"dist_train: tokenizer DP=2 rank {r}: G losses "
              f"{got['gen_loss']}, adaptive weight {got['adaptive_weight']}, "
              f"D losses {got['discr_loss']}; gaps "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})}"
              f"; ms a pair {got['ms']}")
    check(ranks[0]["tok"]["digest"] == ranks[1]["tok"]["digest"],
          "dist_train: the DP ranks' tokenizer, discriminator or "
          "spectral-norm buffers differ")
    print(f"dist_train: one process's tokenizer pairs: G {one_tok['gen_loss']}"
          f", adaptive weight {one_tok['adaptive_weight']}, D "
          f"{one_tok['discr_loss']}, ms a pair {one_tok['ms']}; the DP "
          f"ranks' models and spectral-norm buffers bit-identical")

    tokenizer, lm = ro.build_models(context_length=CTX, segment_length=T,
                                    seed=0)
    for key, tag, batch in (("serve_dp", "DP=2", DIST_SERVE_DP_B),
                            ("serve_tp", "TP=2", DIST_SERVE_TP_B)):
        for r, res in enumerate(ranks):
            got = res[key]
            la = got["launches"]
            for k in ("vq_argmin", "decode_attention", "flash_attention_fwd"):
                check(la[k] > 0, f"dist_serve: {k} never ran on {tag} rank "
                      f"{r}")
            replay = ""
            if key == "serve_tp" or r == 0:
                want = generation.replay_logits(
                    lm, got["tokens"].cuda(), segment_length=got["seg"],
                    context_length=CTX, action=got["action"].cuda(),
                    cache_dtype=torch.int8).cpu()
                err = float((got["logits"] - want).abs().max())
                top_got = got["logits"].topk(DIST_TOPK, dim=-1).indices
                top_want = want.topk(DIST_TOPK, dim=-1).indices
                jac = []
                for a, b_ in zip(top_got.reshape(-1, DIST_TOPK).tolist(),
                                 top_want.reshape(-1, DIST_TOPK).tolist()):
                    a, b_ = set(a), set(b_)
                    jac.append(len(a & b_) / len(a | b_))
                jac = sum(jac) / len(jac)
                if key == "serve_dp":
                    check(torch.equal(got["logits"], want), f"dist_serve: DP "
                          f"rank {r}'s replay differs from one process's")
                else:
                    check(err <= DIST_LOGIT_ATOL and jac >= DIST_TOPK_MIN,
                          f"dist_serve: TP rank {r}: logits {err:.3e} from "
                          f"one process's, top-{DIST_TOPK} overlap {jac:.4f}")
                replay = (f"; replay of its first {DIST_REPLAY_ROWS} rows "
                          f"against one process: max |logit difference| "
                          f"{err:.4e}, top-{DIST_TOPK} mean Jaccard {jac:.4f}")
            print(f"dist_serve: {tag} B={batch} T={got['seg']} rank {r}: "
                  f"{got['wall']:.3f} s, {got['fps']:.2f} frames/s of the "
                  f"whole batch; launches K1 {la['vq_argmin']}, K3 "
                  f"{la['decode_attention']}, K4 {la['flash_attention_fwd']}"
                  f"{replay}")
    del tokenizer, lm
    torch.cuda.empty_cache()

    live, resumed = nccl["runs"]
    check(live["step"] == resumed["step"] == DIST_CLI_STEPS
          and live["digest"] == resumed["digest"],
          "dist_cli: the NCCL world of one's resumed state differs from the "
          "live one")
    check(os.path.isdir(os.path.join(one_out, f"checkpoint-{DIST_CLI_STEPS}")),
          "dist_cli: the NCCL run wrote no checkpoint")
    gloo = [res["cli"] for res in ranks]
    check(gloo[0]["runs"][0]["digest"] == gloo[1]["runs"][0]["digest"],
          "dist_cli: the gloo ranks' parameters differ")
    under = os.path.abspath(two_out)
    check(not [p for p in gloo[1]["writes"] if p.startswith(under)],
          "dist_cli: rank 1 wrote under the run's directory")
    check(any(f"checkpoint-{DIST_CLI_STEPS}" in p
              for p in gloo[0]["writes"] if p.startswith(under)),
          "dist_cli: rank 0 wrote no checkpoint")
    for name, out in (("NCCL world of one", one_out), ("gloo, 2 ranks",
                                                         two_out)):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        steps = [m for m in logged if "loss" in m]
        check([m["step"] for m in steps] == list(range(1, DIST_CLI_STEPS + 1)),
              f"dist_cli: {name} logged steps {[m['step'] for m in steps]}")
        check(all(math.isfinite(m["loss"]) for m in steps),
              f"dist_cli: {name} logged a non-finite loss")
        print(f"dist_cli: {name}: losses {[m['loss'] for m in steps]}, "
              f"ms/step {[round(m['step_ms'], 2) for m in steps]}")
    print(f"dist_cli: NCCL world of one: {live['s']:.1f} s to "
          f"{DIST_CLI_STEPS} steps and a checkpoint, resume bit-equal "
          f"({resumed['s']:.1f} s); gloo 2 ranks: "
          f"{gloo[0]['runs'][0]['s']:.1f} s, parameters bit-identical, "
          f"rank 1 wrote no file under the run")
    r0 = ranks[0]
    keys = r0["tok"]["launches"]
    return {"dist_train": {k: r0["gpt_1"]["launches"][k]
                           + r0["gpt_2"]["launches"][k]
                           + r0["tok"]["launches"][k] for k in keys},
            "dist_serve": {k: r0["serve_dp"]["launches"][k]
                           + r0["serve_tp"]["launches"][k] for k in keys},
            "dist_cli": {k: live["launches"][k] + resumed["launches"][k]
                         + gloo[0]["runs"][0]["launches"][k] for k in keys}}


def dist_phases(torch):
    """``--dist``: the multi-process phases alone (dist_kernels, then
    dist_train, dist_serve and dist_cli on a hub and synthetic BAIR
    episodes of their own, with :func:`gloo_cuda_probe`), for rehearsing
    them on the card; the ranks' logs stay in ``outputs/dist``."""
    scratch = os.path.join(REPO, "outputs")
    os.makedirs(scratch, exist_ok=True)
    t0 = time.time()
    phase_dist_kernels(torch)
    print(f"[time] dist_kernels: {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="hub-", dir=scratch) as root:
        hub, _, _ = phase_hub(torch, root)
        write_bair(root, GPT_EPISODES, EVAL_BATCHES * EVAL_B, GPT_FRAMES,
                   seed=93)
        with contextlib.chdir(root):
            t0 = time.time()
            print(json.dumps(phase_dist(
                torch, root, hub, os.path.join(root, "free", "transformer"),
                os.path.join(scratch, "dist"), probe=True)))
            print(f"[time] dist_train + dist_serve + dist_cli: "
                  f"{time.time() - t0:.1f} s")


def ab_kernel_times(torch):
    """K1 at K1_SHAPES, K2 at the wide shapes of K2_SHAPES, K3 at the six
    shapes of K3_SHAPES (the host-int valid, over phase_k3's cold-L2
    rotation of caches), K4 beside SDPA's forward and K5, K6 beside SDPA's
    backward at the training shape, bf16 and fp32 (TF32 off), without and
    with attention dropout (DROP_P, the flash_dropout phase's seed and
    offset; SDPA at dropout_p=DROP_P), and the fp32 K4 beside fp32 SDPA's
    forward at predict's and VP2's prefills, and Q1 and the quantize
    kernel at a detokenize chunk's 23 conv shapes (``ab_qconv_times``), by
    cuda_ms and queued_ms, through the interfaces every tree of the port
    has since dropout came in (Q1's since PR 17): the kernel half of an
    A/B turn (``--ab-turn``)."""
    import torch.nn.functional as F
    from ivideogpt_tpu_torch.ops import decode_attention as da
    from ivideogpt_tpu_torch.ops import flash_attention as fa
    from ivideogpt_tpu_torch.ops import philox
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
    drop = (DROP_P, DROP_SEED, philox.offset_of(7, 3))
    for key, d in (("", None), (" dropout", drop)):
        for name, fn in (
                ("K4", lambda: fa.flash_fwd(q, k, v, d)),
                ("K5", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di, d)),
                ("K6", lambda: fa.flash_bwd_dq(q, k, v, do, lse, di, d))):
            out[name + key] = (cuda_ms(fn, 50), queued_ms(fn, 50)[0])
    qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))

    def sdpa(bwd, p):
        o = F.scaled_dot_product_attention(qt, kt, vt, dropout_p=p,
                                           is_causal=True)
        if bwd:
            torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))
    for key, p in (("", 0.0), (" dropout", DROP_P)):
        out["SDPA forward" + key] = (cuda_ms(lambda: sdpa(False, p), 50),
                                     queued_ms(lambda: sdpa(False, p), 50)[0])
        out["SDPA backward" + key] = (
            cuda_ms(lambda: sdpa(True, p), 50)
            - cuda_ms(lambda: sdpa(False, p), 50),
            queued_ms(lambda: sdpa(True, p), 50)[0]
            - queued_ms(lambda: sdpa(False, p), 50)[0])
    # the fp32 K4, K5 and K6 (the trainer CLI's default precision) beside
    # fp32 SDPA's forward and backward, TF32 off, each without and with
    # dropout
    del q, k, v, do, o, lse, di, qt, kt, vt
    q, k, v, do = (torch.randn(TRAIN_B, 751, 12, 64, device="cuda",
                               generator=g) for _ in range(4))
    with full_fp32():
        o, lse = fa.flash_fwd(q, k, v)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
        for key, d, p in (("", None, 0.0), (" dropout", drop, DROP_P)):
            for name, fn in (
                    ("fp32 K4", lambda: fa.flash_fwd(q, k, v, d)),
                    ("fp32 K5", lambda: fa.flash_bwd_dkv(q, k, v, do, lse, di,
                                                         d)),
                    ("fp32 K6", lambda: fa.flash_bwd_dq(q, k, v, do, lse, di,
                                                        d))):
                out[name + key] = (cuda_ms(fn, 20), queued_ms(fn, 20)[0])
            out["fp32 SDPA forward" + key] = (
                cuda_ms(lambda: sdpa(False, p), 20),
                queued_ms(lambda: sdpa(False, p), 20)[0])
            out["fp32 SDPA backward" + key] = (
                cuda_ms(lambda: sdpa(True, p), 20)
                - cuda_ms(lambda: sdpa(False, p), 20),
                queued_ms(lambda: sdpa(True, p), 20)[0]
                - queued_ms(lambda: sdpa(False, p), 20)[0])
    # the fp32 K4 at the inference entry points' prefills, as phase_flash
    # times it, beside fp32 SDPA's forward
    del q, k, v, do, o, lse, di, qt, kt, vt
    for name, b in (("predict", PRED_R), ("vp2", VP2_CHUNK)):
        q, k, v = (torch.randn(b, 2 * 257, 12, 64, device="cuda",
                               generator=g) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        with full_fp32():
            for key, fn in (
                    (f"fp32 K4 {name}", lambda: fa.flash_fwd(q, k, v)),
                    (f"fp32 SDPA forward {name}",
                     lambda: F.scaled_dot_product_attention(
                         qt, kt, vt, is_causal=True))):
                out[key] = (cuda_ms(fn, 20), queued_ms(fn, 20)[0])
        del q, k, v, qt, kt, vt
    ab_qconv_times(torch, out)
    print("ab: kernel ms (cuda_ms, queued_ms) "
          + json.dumps({k: [round(x, 4) for x in v]
                        for k, v in out.items()}))
    return out


def ab_qconv_times(torch, out):
    """Q1 (bf16 out, the rollout's render) and the quantize kernel at each of
    the 23 conv shapes of a detokenize chunk of ``QCONV_CLIPS`` clips (as
    phase_qconv draws them), by cuda_ms and queued_ms into ``out``, and
    their sums over the chunk's 57 convs ("Q1 chunk", "quantize chunk")."""
    from ivideogpt_tpu_torch.ops import qconv
    shapes, _ = chunk_conv_shapes(torch)
    g = torch.Generator(device="cuda").manual_seed(72)
    chunk = {"Q1": [0.0, 0.0], "quantize": [0.0, 0.0]}
    for (n1, c, h, w, o, k, stride, pad), count in sorted(shapes.items()):
        n = n1 * QCONV_CLIPS
        tag = f"N={n} C={c} {h}x{w} O={o} k={k}"
        x = torch.randn(n, c, h, w, device="cuda", generator=g).bfloat16()
        wt = torch.randn(o, c, k, k, device="cuda", generator=g) \
            * (c * k * k) ** -0.5
        bias = torch.randn(o, device="cuda", generator=g) * 0.1
        packed = qconv.PackedWeight(wt)
        scale = (qconv.amax(x) / 127.0).clamp_min(1e-12)
        xq = qconv.quantize(x, scale)
        iters = 5 if n * h * w * o * k * k * c > 2**40 else 20
        for name, fn in (
                ("Q1", lambda: qconv.qconv(xq, scale, packed, bias, stride,
                                           pad, torch.bfloat16)),
                ("quantize", lambda: qconv.quantize(x, scale))):
            out[f"{name} {tag}"] = (cuda_ms(fn, iters),
                                    queued_ms(fn, iters)[0])
            for i in range(2):
                chunk[name][i] += count * out[f"{name} {tag}"][i]
        del x, xq, wt, packed
        torch.cuda.empty_cache()
    out.update({f"{name} chunk": tuple(v) for name, v in chunk.items()})


def ab_render(torch):
    """The B=256 render alone, as the rollout runs it: ``rollout.detokenize``
    of one stream of random ids (assembled as a rollout's) in chunks of 128
    with ``int8_detok`` "0" (the bf16 render), "1" and "static" (calibrated
    on the first chunk by the warm-up call), TOKENIZER_64 from
    ``rollout.build_models`` (seed 0): wall s (the mean of 2 after a
    warm-up) and device s (one traced call) by mode, Q1's and the
    quantize's device s in it."""
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch import tokens as tok_lib
    tokenizer, lm = ro.build_models(context_length=CTX, segment_length=T,
                                    seed=0)
    del lm
    cfg = tokenizer.config
    g = torch.Generator(device="cuda").manual_seed(95)
    c = torch.randint(0, cfg.num_vq_embeddings, (B, CTX, 256), device="cuda",
                      generator=g)
    d = torch.randint(0, cfg.num_dyn_embeddings, (B, T - CTX, 16),
                      device="cuda", generator=g)
    ids, _ = tok_lib.assemble(c, d, cfg.num_vq_embeddings,
                              cfg.num_dyn_embeddings)
    scales, wall, device = {}, {}, {}
    for mode in ("0", "1", "static"):
        with torch.inference_mode():
            ro.detokenize(tokenizer, ids, CTX, 128, mode, scales)
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.time()
                ro.detokenize(tokenizer, ids, CTX, 128, mode, scales)
                torch.cuda.synchronize()
                times.append(time.time() - t0)
        wall[mode] = sum(times) / len(times)
        res = {}
        with kernel_trace(torch, res), torch.inference_mode():
            ro.detokenize(tokenizer, ids, CTX, 128, mode, scales)
        device[mode] = dict(seconds=round(res["seconds"], 5), **{
            name: round(sum(e.self_device_time_total for e in res["kernels"]
                            if frag in e.key) / 1e6, 5)
            for name, frag in (("Q1", "qconv_kernel"),
                               ("quantize", "quantize_kernel"))})
    print(f"ab: the B={B} render by int8_detok mode, wall s "
          + json.dumps({k: round(v, 4) for k, v in wall.items()})
          + ", device s " + json.dumps(device))
    del tokenizer
    torch.cuda.empty_cache()


def ab_turn(torch):
    """One turn of an A/B between two trees of the port on one card, run as
    ``python3 <this file> --ab-turn`` from the root of the tree to measure
    (its package is the one imported): the kernels' times, the B=256
    render by int8 mode (``ab_render``), then the rollout, the GPT step, the tokenizer pair and the wide pair, each with
    its profiled device seconds (the GPT step twice: bf16, and fp32 with
    dropout at the trainer CLI's default precision), and the MBRL
    imagination rollout with its device seconds by part (``generation.decode`` holds its K3 calls).
    Turns alternate between the trees, parent first."""
    ab_kernel_times(torch)
    ab_render(torch)
    phase_main(torch)
    phase_train(torch)
    phase_train(torch, fp32=True)
    phase_tok_train(torch, wide=False)
    phase_tok_train(torch, wide=True)
    vp = mbrl_models(torch, torch.bfloat16, seed=59)
    phase_mbrl(torch, vp)


# After the kernels' phases the paths run in two lanes that share the card
# and the host: this process drives the rollouts, the in-process training
# steps and the MBRL world model (lane_main), a child process (``--lane``)
# the hub's paths: the trainer CLIs, the inference entry points and the
# medium LM (lane_hub). Each lane orders its phases so that the two never
# hold their memory peaks together: lane_main's above 20 GiB (main, the
# rollout variants) come first, lane_hub's (eval_gpt, the 256 px tokenizer,
# the ctx=1 rollout, VP2, the medium LM) last. lane_main's tail (the MBPO
# and DrQ-v2 CLIs, 16+ GiB, and the lighter checks after them) waits for
# the hub lane to end, so the card's memory never rests on how fast each
# lane runs: with the decode graphed, lane_main reached MBPO while the
# hub's eval_gpt held ~60 GiB. Then lane_main's tail and the
# multi-process phases, which spawn processes of their own, run alone.
# While the lanes run, lane_main's CPU references (the rollout, tokenizer
# and MBRL checks) take all cores but LANE_HUB_THREADS, lane_hub's
# (predict's) those; the times of the lanes' phases are taken beside the
# other lane (--ab-turn times the paths alone)
LANE_TIMEOUT = 900
LANE_HUB_THREADS = 2
CPU_THREADS = 0


def cpu_threads():
    """The threads of a phase's CPU reference: every core, or the lane's
    share of them while the lanes run."""
    return CPU_THREADS or os.cpu_count() or 1


def lane_threads(hub):
    """A lane's CPU threads: LANE_HUB_THREADS for lane_hub, the rest of the
    cores for lane_main."""
    cores = os.cpu_count() or 1
    return max(1, LANE_HUB_THREADS if hub else cores - LANE_HUB_THREADS)


def card_memory():
    """This process's memory on the card and the card's free memory, in
    GiB: allocated, reserved (cached included), the part of reserved in
    CUDA graphs' private pools, and free on the card (every process)."""
    import torch
    pools = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))
    free, total = torch.cuda.mem_get_info()
    return (f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
            f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB "
            f"(graph pools {pools / 2**30:.2f}), card free "
            f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB")


def marker(since):
    """A function that prints a phase's seconds and those since this
    call, the wall clock (to line up the two lanes) and card_memory()
    ("[time]" lines)."""
    started = [time.time()] * 2

    def mark(phase):
        now = time.time()
        print(f"[time] {phase}: {now - started[1]:.1f} s, "
              f"{now - started[0]:.1f} s since {since}, at {now:.1f}; "
              f"{card_memory()}", flush=True)
        started[1] = now
    return mark


def lane_main(torch, convs, mark):
    """The rollouts, the in-process training steps, the tokenizer steps,
    MBRL and the DrQ-v2 update, in this process; returns their launches by
    path."""
    by_path = {"rollout": phase_main(torch)}
    mark("main")
    by_path.update(phase_rollout_variants(torch, convs))
    mark("rollout variants")
    phase_check(torch)
    mark("check")
    by_path["train"] = phase_train(torch)
    mark("train")
    by_path["train_fp32"] = phase_train(torch, fp32=True)
    mark("train_fp32")
    phase_train_check(torch)
    mark("train check")
    by_path["tokenizer_train"] = phase_tok_train(torch, wide=False)
    mark("tok_train")
    by_path["tokenizer_train_wide"] = phase_tok_train(torch, wide=True)
    mark("tok_train_wide")
    phase_tok_train_check(torch)
    mark("tok_train check")
    vp = mbrl_models(torch, torch.bfloat16, seed=59)
    by_path["mbrl_rollout"] = phase_mbrl(torch, vp)
    mark("mbrl")
    phase_mbrl_check(torch)
    mark("mbrl check")
    by_path["mbrl_train"] = phase_mbrl_train(torch, vp)
    mark("mbrl train")
    del vp
    torch.cuda.empty_cache()
    phase_mbrl_train_check(torch)
    mark("mbrl train check")
    phase_drq_update(torch)
    mark("drq_update")
    return by_path


def lane_main_tail(torch, mark):
    """The RL trainer CLIs, the GPT step's dropout check and the fused
    preprocessing, after the hub lane has ended; returns their launches by
    path."""
    by_path = {}
    scratch = os.path.join(REPO, "outputs")
    with tempfile.TemporaryDirectory(prefix="mbrl-", dir=scratch) as root:
        by_path["mbpo"] = phase_mbpo(torch, root)
        mark("mbpo")
        by_path["drq"] = phase_drq(torch, root)
        mark("drq")
    by_path["train_gpt_check"] = phase_train_check(torch, dropout=True)
    mark("train_gpt check")
    with tempfile.TemporaryDirectory(prefix="native-", dir=scratch) as root:
        by_path["native_preproc"] = phase_native_preproc(torch, root)
    mark("native_preproc")
    return by_path


def lane_hub(torch, root, convs, mark):
    """The hub under ``root`` (with the synthetic BAIR episodes the
    multi-process phases read after the lanes), the trainer CLIs, the
    inference entry points and the medium LM; returns their launches by
    path."""
    by_path = {}
    hub, tok_cpu, lm_cpu = phase_hub(torch, root)
    mark("hub")
    free = os.path.join(root, "free", "transformer")
    by_path["predict"] = phase_predict(torch, hub, tok_cpu, lm_cpu)
    mark("predict")
    del tok_cpu, lm_cpu
    write_bair(root, GPT_EPISODES, EVAL_BATCHES * EVAL_B, GPT_FRAMES, seed=93)
    with contextlib.chdir(root):
        by_path["train_gpt"] = phase_train_gpt(torch, root, hub, free)
        mark("train_gpt")
        by_path["train_gpt_lora"] = phase_train_gpt_lora(torch, root, hub,
                                                         free)
        mark("train_gpt_lora")
    by_path["train_tokenizer"] = phase_train_tokenizer(torch, root, hub)
    mark("train_tokenizer")
    by_path["train_tokenizer_sthsth"] = phase_train_tokenizer_sthsth(torch,
                                                                     root)
    mark("train_tokenizer_sthsth")
    with contextlib.chdir(root):
        by_path["eval_gpt"] = phase_eval_gpt(torch, root, hub)
        mark("eval_gpt")
    by_path["train_tokenizer_256"] = phase_train_tokenizer_256(torch, root)
    mark("train_tokenizer_256")
    for which in ("256", "goal"):
        by_path[f"train_gpt_{which}"] = phase_train_gpt_recipe(
            torch, root, hub, which)
        mark(f"train_gpt_{which}")
    by_path["rollout_ctx1"] = phase_rollout_ctx1(torch, hub)
    mark("rollout_ctx1")
    by_path["vp2"], vp2_rgb = phase_vp2(torch, hub, root)
    mark("vp2")
    by_path["vp2_int8"] = phase_vp2_int8(torch, hub, root, vp2_rgb, convs)
    del vp2_rgb
    mark("vp2_int8")
    by_path["train_medium"], medium = phase_train_medium(torch)
    mark("train_medium")
    by_path["train_medium_dots"] = phase_train_medium_dots(torch, medium)
    mark("train_medium_dots")
    return by_path


def lane_child(torch, root, convs, out):
    """``--lane <root> <convs> <out>``: lane_hub in this process, its
    launches by path written to ``out`` as JSON."""
    global CPU_THREADS
    CPU_THREADS = lane_threads(hub=True)
    torch.set_num_threads(CPU_THREADS)
    from ivideogpt_tpu_torch import _build
    _build.build_all()
    try:
        by_path = lane_hub(torch, root, int(convs),
                           marker("the lane's start"))
    except BaseException:
        print(f"[time] lane_hub failed at {time.time():.1f}; "
              f"{card_memory()}", flush=True)
        raise
    with open(out, "w") as f:
        json.dump(by_path, f)
    return 0


def run_lanes(torch, convs, mark):
    """lane_main here and lane_hub in a child process, side by side, then
    lane_main_tail and the multi-process phases alone, the latter on the
    child's hub; the child is killed
    if this lane fails or it outlasts LANE_TIMEOUT, and its log (also in
    outputs/lane-hub.log) is printed after this lane's. Returns the
    launches by path of every phase."""
    global CPU_THREADS
    import signal
    scratch = os.path.join(REPO, "outputs")
    os.makedirs(scratch, exist_ok=True)
    log_path = os.path.join(scratch, "lane-hub.log")
    with tempfile.TemporaryDirectory(prefix="hub-", dir=scratch) as root:
        out = os.path.join(root, "lane.json")
        with open(log_path, "w") as log:
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--lane", root,
                 str(convs), out], stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONUNBUFFERED="1"), cwd=os.getcwd(),
                start_new_session=True)
        deadline = time.time() + LANE_TIMEOUT
        CPU_THREADS = lane_threads(hub=False)
        torch.set_num_threads(CPU_THREADS)
        try:
            try:
                by_path = lane_main(torch, convs, mark)
            except BaseException:
                print(f"[time] lane_main failed at {time.time():.1f}; "
                      f"{card_memory()}", flush=True)
                raise
            torch.cuda.empty_cache()
            try:
                child.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
        finally:
            if child.poll() is None:
                os.killpg(child.pid, signal.SIGKILL)
                child.wait()
            CPU_THREADS = 0
            torch.set_num_threads(cpu_threads())
            with open(log_path) as f:
                print(f"--- the hub lane (exit {child.returncode}):\n"
                      f"{f.read()}--- end of the hub lane", flush=True)
        check(child.returncode == 0 and os.path.exists(out),
              f"the hub lane failed (exit {child.returncode}) or outlasted "
              f"{LANE_TIMEOUT} s")
        with open(out) as f:
            by_path.update(json.load(f))
        mark("the lanes")
        by_path.update(lane_main_tail(torch, mark))
        with contextlib.chdir(root):
            by_path.update(phase_dist(
                torch, root, os.path.join(root, "cond"),
                os.path.join(root, "free", "transformer"),
                os.path.join(root, "dist")))
        mark("dist_train + dist_serve + dist_cli")
    return by_path


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
    ab = mode in (["--ab-turn"], ["--ab-kernels"])
    rank = mode[:1] == ["--dist-rank"] and len(mode) == 7
    lane = mode[:1] == ["--lane"] and len(mode) == 4
    if mode not in ([], ["--ab-turn"], ["--ab-kernels"], ["--vq-routing"],
                    ["--k3-splits"], ["--dist"]) and not (rank or lane):
        print(f"FAIL: usage: {sys.argv[0]} [--ab-turn | --ab-kernels | "
              f"--vq-routing | --k3-splits | --dist]", file=sys.stderr)
        return 1
    tree = os.getcwd() if ab else REPO
    if not os.path.isdir(os.path.join(tree, "ivideogpt_tpu_torch")):
        print("FAIL: run from a checkout that holds ivideogpt_tpu_torch/",
              file=sys.stderr)
        return 1
    sys.path.insert(0, tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    if rank or lane:
        try:
            if lane:
                return lane_child(torch, *mode[1:])
            return dist_rank_main(mode[1:])
        except PhaseError as e:
            print(f"FAIL: {e}", file=sys.stderr)
            return 1

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
            (ab_turn if mode == ["--ab-turn"] else ab_kernel_times)(torch)
            return 0
        if mode == ["--vq-routing"]:
            vq_routing(torch)
            return 0
        if mode == ["--k3-splits"]:
            k3_splits(torch)
            return 0
        if mode == ["--dist"]:
            dist_phases(torch)
            return 0
        mark = marker("the build")
        k1 = phase_k1(torch)
        mark("K1")
        k2 = phase_k2(torch, k1)
        mark("K2")
        k3 = phase_k3(torch)
        mark("K3")
        k3_variants = phase_k3_variants(torch)
        mark("K3 variants")
        q1_rows, convs = phase_qconv(torch, logs.get("qconv", ""))
        mark("qconv")
        flash = phase_flash(torch)
        mark("flash")
        flash.update(phase_flash_dropout(torch))
        mark("flash_dropout")
        phase_dist_kernels(torch)
        mark("dist_kernels")
        by_path = run_lanes(torch, convs, mark)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print("launches by path (rollout: the first B=256 rollout; train: the "
          f"{TRAIN_TIMED} timed steps; train_fp32: its {TRAIN_TIMED} timed "
          f"fp32 steps with dropout; tokenizer_train: the {TOK_TIMED} timed "
          f"G+D pairs; tokenizer_train_wide: the {TOK_WIDE_TIMED} timed "
          f"pairs; mbrl_rollout: the first B={MB_B} imagination rollout; "
          f"mbrl_train: the {MB_TIMED} timed train() calls; predict: the "
          f"first call; rollout_ctx1: the first B={B} ctx=1 rollout; vp2: "
          f"the first B={VP2_B} query; train_gpt: the CLI's two runs, "
          f"{GPT_STEPS} steps and 2 validations; train_tokenizer: the "
          f"CLI's two runs, {TT_STEPS} micro-steps and 2 validations; "
          f"train_tokenizer_sthsth: the select_sthsth run, {TTS_STEPS} "
          f"micro-steps and a validation; "
          f"eval_gpt: the --eval_only run, {EVAL_BATCHES} batches of "
          f"{EVAL_B} x {EVAL_REPS} samples; "
          f"train_tokenizer_256: the CLI's {TT256_STEPS} micro-steps; "
          f"train_gpt_lora: the --lora CLI's two runs, {LORA_STEPS} steps "
          f"and a validation; train_gpt_256, train_gpt_goal: the recipe's "
          f"{RECIPE_STEPS} CLI steps; "
          f"train_medium: the {MEDIUM_TIMED} timed steps; train_medium_dots: "
          f"the {MEDIUM_TIMED} timed steps under remat 'none' and the "
          f"{MEDIUM_TIMED} under 'dots'; train_gpt_check: "
          f"one step; mbpo: the MBPO CLI's run; drq: the DrQ-v2 run; "
          f"native_preproc: the first fused tokenizer CLI run, "
          f"{NP_STEPS} micro-steps; "
          f"rollout_int8_detok, rollout_int8_static, rollout_mixed, "
          f"rollout_grouped: the first B={B} rollout of each; vp2_int8: "
          f"the first int8-render query; dist_cli: rank 0's CLI runs, NCCL "
          f"and gloo; dist_train: rank 0's {DIST_STEPS} GPT steps at DP=2 "
          f"and at TP=2 and its {DIST_PAIRS} tokenizer pairs; dist_serve: "
          f"rank 0's DP and TP rollouts): "
          + json.dumps(by_path))
    per_run = {"rollout": ("rollout", 1), "train_step": ("train", TRAIN_TIMED),
               "train_fp32_step": ("train_fp32", TRAIN_TIMED),
               "tokenizer_train": ("tokenizer_train", TOK_TIMED),
               "tokenizer_train_wide": ("tokenizer_train_wide",
                                        TOK_WIDE_TIMED),
               "mbrl_rollout": ("mbrl_rollout", 1),
               "mbrl_train": ("mbrl_train", MB_TIMED),
               "predict": ("predict", 1), "rollout_ctx1": ("rollout_ctx1", 1),
               "vp2": ("vp2", 1), "train_gpt_run": ("train_gpt", 1),
               "eval_gpt": ("eval_gpt", 1),
               "train_tokenizer_run": ("train_tokenizer", 1),
               "train_tokenizer_sthsth_run": ("train_tokenizer_sthsth", 1),
               "train_tokenizer_256_run": ("train_tokenizer_256", 1),
               "train_medium_step": ("train_medium", MEDIUM_TIMED),
               "train_medium_dots_step": ("train_medium_dots",
                                          2 * MEDIUM_TIMED),
               "train_gpt_lora_run": ("train_gpt_lora", 1),
               "train_gpt_256_step": ("train_gpt_256", RECIPE_STEPS),
               "train_gpt_goal_step": ("train_gpt_goal", RECIPE_STEPS),
               "train_gpt_check": ("train_gpt_check", 1),
               "mbpo_run": ("mbpo", 1), "drq_run": ("drq", 1),
               "rollout_int8_detok": ("rollout_int8_detok", 1),
               "rollout_int8_static": ("rollout_int8_static", 1),
               "rollout_mixed": ("rollout_mixed", 1),
               "rollout_grouped": ("rollout_grouped", 1),
               "vp2_int8": ("vp2_int8", 1)}
    rows = (k1, k2, k3, *k3_variants, *q1_rows, flash["K4_train"],
            flash["K4_prefill"],
            flash["K4_mbrl_prefill"], flash["K4_mbrl_train"],
            flash["K4_ctx1_prefill"], flash["K4_eval_loss"],
            flash["K4_eval_prefill"], flash["K4_predict_prefill"],
            flash["K4_vp2_prefill"], flash["K5"], flash["K5_mbrl_train"],
            flash["K6"], flash["K6_mbrl_train"],
            *(flash[f"{k}_{tag}"] for tag in ("train_dropout",
                                               "medium_dropout", "train_fp32",
                                               "oxe256_dropout",
                                               "goal_dropout")
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
            "launches_by_path", "max_abs_err", "max_abs_err_dropout", "ms",
            "queued_ms", "host_ms",
            "plain_ms", "bound_ms", "bound_by", "bound_term",
            "share_of_bound", "bound_ms_fma", "library_ms",
            "library_queued_ms", "library", "library_ms_dropout",
            "library_queued_ms_dropout",
            "ms_no_dropout", "queued_ms_no_dropout", "bound_ms_no_dropout",
            "bound_by_no_dropout", "bound_term_no_dropout",
            "share_of_bound_no_dropout", "ms_dropout", "queued_ms_dropout",
            "bound_ms_dropout", "bound_by_dropout", "bound_term_dropout",
            "share_of_bound_dropout",
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
