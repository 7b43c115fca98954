#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero without
the final result line:
  1. card      the nvidia-smi name and power limit
  2. build     nvcc for sm_90a of every csrc/*.cu, all at once (-Xptxas -v)
  3. K1        VQ argmin at N=131072, K=8192, D=64 fp32 against the plain
               version (TF32 off), plus a codebook with duplicated rows
  4. K3        int8 decode attention at B=256, H=12, hd=64, M=752 for
               valid in {515, 633, 751} against the plain version
  5. main      the rollout (TOKENIZER_64 + LLAMA_BASE + action head, bf16
               under the cast rules, int8 KV cache, ctx=2, T=16, B=256) with
               random weights from a seed: shapes, token ranges, launch
               counts (K3: exactly 2832 a rollout), frames/s
  6. check     a B=2 fp32 rollout on the GPU held against the plain CPU path
               on the same stream: context ids, teacher-forced logits, frames
Then the kernels' JSON line, the card line again, and the result line.
Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CTX, T, B = 2, 16, 256
N_TIMED = 3
FP32_PEAK = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12     # H100 SXM HBM3, bytes/s


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


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_RATE * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_k1(torch):
    from ivideogpt_tpu_torch.ops import vq
    from ivideogpt_tpu_torch.utils.platform import full_fp32
    n, k, d = B * CTX * 256, 8192, 64
    g = torch.Generator(device="cuda").manual_seed(1)
    z = torch.randn(n, d, device="cuda", generator=g)
    e = torch.randn(k, d, device="cuda", generator=g)
    with full_fp32():
        ids = vq.vq_argmin(z, e)
        ref = vq.vq_lookup_plain(z, e)
        torch.cuda.synchronize()
        diff = (ids != ref).nonzero()[:, 0]
        z64, e64 = z[diff].double(), e.double()
        d_ours = ((z64 - e64[ids[diff]]) ** 2).sum(1)
        d_ref = ((z64 - e64[ref[diff]]) ** 2).sum(1)
        gap = (d_ours - d_ref).abs()
        scale = (z64 ** 2).sum(1) + (e64[ids[diff]] ** 2).sum(1)
        max_err = float(gap.max()) if len(diff) else 0.0
        print(f"K1 ids: {n - len(diff)}/{n} equal to the plain version; "
              f"{len(diff)} differ, max float64 distance gap {max_err:.3e}")
        check(bool((gap < 1e-5 * scale).all()),
              "K1 ids differ from the plain version beyond a near tie")
        check(len(diff) <= n // 1000, f"K1: {len(diff)} near-tie flips")

        # duplicated codebook rows: an exact tie must go to the smaller index
        e_dup = e.clone()
        e_dup[4096:4096 + 512] = e[:512]
        z_dup = torch.cat([e[:512], z[:4096]])
        ids_dup = vq.vq_argmin(z_dup, e_dup)
        check(bool(((ids_dup < 4096) | (ids_dup >= 4096 + 512)).all()),
              "K1 tie did not go to the smallest index")
        check(bool((ids_dup[:512] == torch.arange(512, device="cuda")).all()),
              "K1 exact matches not found at the smaller index")
        print("K1 ties: duplicated rows resolve to the smallest index")

        ms = cuda_ms(lambda: vq.vq_argmin(z, e), 10)
        plain_ms = cuda_ms(lambda: vq.vq_lookup_plain(z, e), 5)
        lib_ms = cuda_ms(lambda: torch.cdist(z, e).argmin(1), 5)
    b_ms, b_by = bound(n * d * 4 + k * d * 4 + k * 4 + n * 8, 2 * n * k * d,
                       FP32_PEAK)
    print(f"K1 kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} (cdist+argmin) bound_ms={b_ms:.4f} "
          f"({b_by}) share_of_bound={b_ms / ms:.3f}")
    return dict(name="vq_argmin", route="cuda",
                source="ivideogpt_tpu_torch/csrc/vq_argmin.cu",
                replaces="ivideogpt_tpu/ops/vq.py:89", max_abs_err=max_err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def phase_k3(torch):
    from ivideogpt_tpu_torch.ops import decode_attention as da
    H, hd, M = 12, 64, 752
    g = torch.Generator(device="cuda").manual_seed(2)

    def ints():
        return torch.randint(-127, 128, (B, M, H, hd), device="cuda",
                             generator=g, dtype=torch.int8)

    def scales():
        return (torch.rand(B, M, H, device="cuda", generator=g) * 0.02
                + 0.001).bfloat16()
    q = torch.randn(B, H, hd, device="cuda", generator=g).bfloat16()
    k, v, ks, vs = ints(), ints(), scales(), scales()
    max_err = 0.0
    row = None
    for valid in (515, 633, 751):
        out = da.decode_attention(q, k, ks, v, vs, valid)
        ref = da.decode_attention_plain(q, k, ks, v, vs, valid)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        max_err = max(max_err, err)
        # bf16 outputs of two fp32 sums taken in another order: a bf16 ulp
        ok = torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-3)
        ms = cuda_ms(lambda: da.decode_attention(q, k, ks, v, vs, valid), 50)
        plain_ms = cuda_ms(
            lambda: da.decode_attention_plain(q, k, ks, v, vs, valid), 5)
        nbytes = 2 * B * valid * H * hd + 2 * B * valid * H * 2 \
            + 2 * B * H * hd * 2
        b_ms, b_by = bound(nbytes, 4 * B * H * valid * hd, FP32_PEAK)
        print(f"K3 valid={valid}: max_abs_err={err:.3e} (rtol 2e-2, atol "
              f"2e-3) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms=null bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f}")
        check(ok, f"K3 disagrees with the plain version at valid={valid}")
        row = dict(name="decode_attention", route="cuda",
                   source="ivideogpt_tpu_torch/csrc/decode_attention.cu",
                   replaces="ivideogpt_tpu/ops/decode_attention.py:45",
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None)
    row["max_abs_err"] = max_err
    return row


def check_stream(torch, tokens_mod, cfg, toks, batch):
    L = tokens_mod.seq_len(CTX, T)
    check(tuple(toks.shape) == (batch, L), f"tokens {tuple(toks.shape)}")
    c, d = tokens_mod.disassemble(toks, CTX, cfg.num_vq_embeddings,
                                  cfg.num_dyn_embeddings)
    check(tuple(c.shape) == (batch, CTX, 256)
          and tuple(d.shape) == (batch, T - CTX, 16), "disassembled grids")
    P = tokens_mod.prelude_len(CTX)
    check(bool((toks[:, :P] <= cfg.scf_token).all()), "prelude out of range")
    sdf = tokens_mod.sdf_positions(CTX, T, device=toks.device)
    check(bool((toks[:, sdf] == cfg.sdf_token).all()), "sdf slots")
    # sampling runs over the whole vocabulary, as in the JAX package: with
    # random weights a sampled slot may hold any id, which disassemble clamps
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "a token lies outside the vocabulary")


def phase_main(torch):
    from ivideogpt_tpu_torch import rollout as ro
    from ivideogpt_tpu_torch import tokens as tok
    from ivideogpt_tpu_torch.ops import decode_attention as da
    from ivideogpt_tpu_torch.ops import vq
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

    vq.vq_argmin.launches = 0
    da.decode_attention.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = run(torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {"vq_argmin": vq.vq_argmin.launches,
                "decode_attention": da.decode_attention.launches}
    print(f"main: first rollout {first_s:.2f}s, launches {launches}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check(launches["vq_argmin"] >= 1, "K1 never ran on the main path")
    check(launches["decode_attention"] == 2832,
          f"K3 ran {launches['decode_attention']} times, not 2832")
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

    wall = stage_seconds(torch, tokenizer, lm, px, action, gen, None)
    print("main: stage wall seconds " + json.dumps(wall))
    device = profile_stages(torch, tokenizer, lm, px, action, gen)
    if device is not None:
        busy = {k: round(device[k] / wall[k], 4) for k in wall}
        print("main: stage device seconds " + json.dumps(device)
              + " busy share " + json.dumps(busy))
    del tokenizer, lm, res
    torch.cuda.empty_cache()
    return launches


def stage_seconds(torch, tokenizer, lm, px, action, gen, timer):
    """Run the rollout's three stages once each, through the same calls
    ``rollout`` makes; ``timer(name)`` is a context manager around each
    stage (None: host wall seconds after a synchronize)."""
    import contextlib
    from ivideogpt_tpu_torch import generation
    from ivideogpt_tpu_torch import tokens as tok
    cfg = tokenizer.config
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
                                      context_length=CTX, generator=gen,
                                      action=action, cache_dtype=torch.int8)
        with timer("detokenize"):
            for i in range(0, B, 128):
                tokenizer.detokenize(res.tokens[i:i + 128], CTX)
    return out


def profile_stages(torch, tokenizer, lm, px, action, gen):
    """Device seconds of each stage: the CUDA kernels' time summed from a
    torch.profiler trace of that stage (one stream, so kernels do not
    overlap). None, with the reason printed, when the trace has no device
    time."""
    import contextlib
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out, top = {}, {}

    @contextlib.contextmanager
    def traced(name):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        out[name] = round(sum(e.self_device_time_total for e in kernels)
                          / 1e6, 4)
        kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
        top[name] = [(e.key[:60], e.count,
                      round(e.self_device_time_total / 1e6, 4))
                     for e in kernels[:6]]

    stage_seconds(torch, tokenizer, lm, px, action, gen, traced)
    if not any(out.values()):
        print("main: the profiler recorded no device time: device seconds "
              "not measured")
        return None
    for name, rows in top.items():
        print(f"main: top kernels in {name} (name, launches, device s): "
              + json.dumps(rows))
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
    if not os.path.isdir(os.path.join(REPO, "ivideogpt_tpu_torch")):
        print("FAIL: run from a checkout that holds ivideogpt_tpu_torch/",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
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
                if "ptxas info" in line:
                    print(f"build[{name}]: {line.strip()}")
        k1 = phase_k1(torch)
        k3 = phase_k3(torch)
        launches = phase_main(torch)
        k1["launches"] = launches["vq_argmin"]
        k3["launches"] = launches["decode_attention"]
        phase_check(torch)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (k1, k3)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
