// K4 (forward), K5 (dK, dV) and K6 (dQ) of causal flash attention on bf16
// inputs, for Hopper (sm_90a): TMA copies into shared memory and wgmma
// products.
//
// Replaces, for bf16 q/k/v, the stock TPU kernels that the JAX package calls
// at ivideogpt_tpu/models/llama.py:97 (jax/experimental/pallas/ops/tpu/
// flash_attention.py, JAX 0.9.0):
//   K4  _flash_attention_kernel      :331 (launched :758)
//   K5  _flash_attention_dkv_kernel  :796 (launched :1121)
//   K6  _flash_attention_dq_kernel   :1146 (launched :1456)
// A library of its own, with its own C entry points (ivg_flash_fwd_bf16,
// ivg_flash_bwd_dkv_bf16, ivg_flash_bwd_dq_bf16, at the end). The fp32 K4,
// K5 and K6 are in flash_attention_tf32.cu; the Hopper building blocks that
// the sm_90a kernels share (mbarriers, TMA, wgmma descriptors and fences,
// the reading of the keep tile) in sm90.cuh.
//
// What they compute, for one (b, h), s = q.k * hd^-0.5, keys j <= query i:
//   K4  O = softmax(s) V, lse_i = log sum_j exp(s_ij) (natural log, fp32)
//   K5  P = exp(s - lse), dS = P * (dO V^T - di), dV = P^T dO,
//       dK = dS^T Q * hd^-0.5
//   K6  dQ = dS K * hd^-0.5
// Scores, softmax statistics and sums are fp32; P and dS are rounded to
// bf16 before their products, where the TPU kernel rounds them.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16), inputs read once and
// outputs written once:
//   K4 train (B=16, S=751, H=12): 74 MB -> 22 us; 1.4e10 FLOP -> 14 us.
//   K4 prefill (B=256, S=514):    0.81 GB -> 0.24 ms; 1.04e11 FLOP -> 0.105 ms.
//   K5 train: 112 MB -> 33 us; 2.8e10 FLOP -> 28 us.
//   K6 train: 93 MB -> 28 us; 2.1e10 FLOP -> 21 us.
// (FLOP counts the causal pairs only.) Bytes bound all four. Next come,
// on whole 64 x 64 tiles, the products and the exponentials (one MUFU ex2
// per score, 16 a clock an SM): at the prefill about 0.15 ms each, so if a
// CTA runs copy, products and softmax in series rather than overlapped,
// they and not the bytes set the time. chip_smoke.py measures each kernel
// against these bounds (PERF.md §6).
// So the design keeps copies off the critical path, runs the products at
// the tensor cores' full rate, and spends as few instructions as it can on
// each score:
//   - Copies: one thread issues TMA (cp.async.bulk.tensor) loads of whole
//     64 x 64 tiles, completing on mbarriers. A 4-D tensor map per input,
//     dims (64, H, S, B) over the caller's strides (so q/k/v sliced from a
//     fused qkv tensor need no copy), box (64, 1, 64, 1), 128-byte swizzle:
//     one bf16 row is 128 B, the swizzle span. Rows at or past S read as
//     zeros (TMA's out-of-bounds fill), which pads the ragged last tile.
//     The streamed tiles sit in a 2-stage ring: tile j+1's copy is in
//     flight while tile j's products run.
//   - Products: wgmma.mma_async m64n64k16, bf16 in, fp32 out, from
//     descriptors of the swizzled tiles. The products of scores read both
//     operands from shared memory (K-major); the products that follow take
//     their A operand (P or dS) from registers, a score product's fp32
//     accumulator rounded to bf16 in its own layout, and their B operand
//     (V, dO, Q or K) from shared memory as an MN-major operand (transpose
//     bit).
//   - Scores: scale * log2(e) folded into one FMA before ex2; the causal
//     and col < S masks only on the diagonal tile and the ragged last tile;
//     lse is kept in log2 units inside the kernels and written in natural
//     log, since K6 and the backward read it as it is.
// Layout: one warpgroup (128 threads) on 64 rows, thread 0 issuing the
// copies; several CTAs an SM overlap one CTA's softmax with another's
// products. K4: one CTA per (b*h, query tile). K5: one CTA per (b*h, key
// tile); K and V are loaded once, Q, dO and the tile's lse and di flow
// through the ring. K6: one CTA per (b*h, query tile); Q, dO and the rows'
// lse and di are loaded once, K and V flow through the ring, and each key
// tile takes three products: S = Q K^T and dP = dO V^T (shared x shared),
// then dQ += dS K with dS from registers and K as an MN-major B. The grid
// is one dimension, a head's tiles next to each other (heaviest first:
// K4's and K6's last query tile, K5's key tile 0), so the CTAs resident at
// once share few heads and the tiles they read again come from L2: ordered
// by head first, the ~660 resident CTAs of the prefill belong to as many
// heads, whose K and V (86 MB) overflow the 50 MB L2.
// No atomics and no sums across CTAs: the gradients are deterministic.
//
// Attention dropout (p_drop > 0, the published recipes' training): each
// kernel is a template on kDrop, and p_drop == 0 launches the kDrop = false
// instance, the code above unchanged. With dropout, the mask Z of
// philox.cuh (a pure function of seed, offset, b, h, query i, key j and S)
// multiplies the probabilities by Z / keep: K4 takes the row max and lse
// of the undropped P, then masks and scales its fp32 P fragment before it
// is rounded to bf16 for the P V product; K5 and K6 regenerate Z for the
// same (i, j) and form dV from (P Z / keep)^T and dS = P (dP Z / keep - di).
// The cost is Philox's integer work: one call (ten rounds of two 32 x 32 ->
// 64-bit products, 40 SASS instructions: 20 IMAD.WIDE.U32, 20 LOP3) serves
// a group of 4 keys of a row. At the train shape the causal groups are
// 13.6 M a kernel: 0.033 ms at 64 integer instructions a clock an SM, as
// long as K5's bytes take. So a call must serve its whole group and stay
// off the critical path:
//   - K4, K5 and K6 draw each tile's bits once, into a 2-stage keep ring in
//     shared memory (ivg::draw_keep_tile: 64 queries x 64 keys, 2 words a
//     query, 512 B). Each thread makes the 8 calls of one query's 32 keys,
//     independent and unrolled, and shifts each word's compare in as a
//     borrow; on the diagonal tile a warp whose keys all lie past its
//     queries makes none. One call per group, where a thread of K5 (which
//     holds P^T, two keys of 16 queries) would otherwise call once an
//     element, 4 times the groups, and a thread of K4 or K6 (keys 2t, 2t + 1
//     of a group) once a pair, twice the groups.
//   - Tile t + 1's bits are drawn between the commit and the wait of tile
//     t's score products, so the integer work runs while the tensor cores
//     do (a tile's products last about a third of its draw, so they hide
//     no more); the barrier that opens tile t + 1 publishes them.
//   - A thread reads its elements' bits with 32-bit shared loads: in K5 one
//     word holds both of its keys of a query (16 loads a tile; the 8 lanes
//     of a column read one word, a broadcast), in K4 and K6 a row's 16 keys
//     lie in its two words (4 loads; sm90.cuh's drop_rows, on K4's P after
//     the row sums and on K6's dP).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"
#include "sm90.cuh"

namespace {

using namespace ivg::sm90;
using bf16 = __nv_bfloat16;

constexpr int kHd = 64;                      // head dim
constexpr int kTile = 64;                    // rows of a query or key tile
constexpr int kThreads = 128;                // one warpgroup
constexpr int kTileBytes = kTile * kHd * 2;  // one bf16 64 x 64 tile
constexpr int kAlign = kSwizzleAtom;         // the 128-byte swizzle's repeat
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory, from a base rounded up to kAlign:
//   K4: Q | K0 | V0 | K1 | V1 | 3 mbarriers | with dropout, keep[2][128]
//   K5: K | V | Q0 | dO0 | Q1 | dO1 | lse[2][64] | di[2][64] | 3 mbarriers
//       | with dropout, keep[2][128]
//   K6: Q | dO | K0 | V0 | K1 | V1 | 3 mbarriers | with dropout, keep[2][128]
// The keep ring (two stages of ivg::draw_keep_tile's words) comes last and
// is allocated only for the kDrop instances, so the others are unchanged.
constexpr int kFwdKeep = 5 * kTileBytes + 64;
constexpr int kFwdSmem = kFwdKeep + kAlign;
constexpr int kDqKeep = 6 * kTileBytes + 64;
constexpr int kDqSmem = kDqKeep + kAlign;
constexpr int kDkvLse = 6 * kTileBytes;
constexpr int kDkvDi = kDkvLse + 2 * kTile * 4;
constexpr int kDkvBars = kDkvDi + 2 * kTile * 4;
constexpr int kDkvKeep = kDkvBars + 64;
constexpr int kDkvSmem = kDkvKeep + kAlign;
constexpr int kKeepRing = 2 * ivg::kKeepWords * 4;

// ------------------------------ wgmma --------------------------------------

// K-major operands step k by 16 elements = 32 B (+2 in the descriptor's
// address field), MN-major ones by 16 rows = 2048 B (+128).
constexpr uint64_t kStepK = 2, kStepMN = 128;

// d (+)= A B for one k-step of 16: A [64 x 16] and B [16 x 64] both
// K-major in shared memory; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " IVG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : IVG_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for one k-step of 16: A from registers (the m16n8k16 A fragment
// of each warp's 16 rows), B [16 x 64] MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " IVG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : IVG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------- register layouts --------------------------------
//
// The m64n64 fp32 accumulator: warp w, lane = 4 g + t of the warpgroup
// holds d[4 j + e] at row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1).
// The register A fragment of k-step kk (columns 16 kk .. 16 kk + 15) is
//   {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}
// = d[8 kk + 0..1], d[8 kk + 2..3], d[8 kk + 4..5], d[8 kk + 6..7], so an
// accumulator becomes the next product's A operand without a shuffle.

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void to_a(const float (&d)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// Writes an accumulator times mul[row half] as bf16 into the swizzled tile
// at `tile` (free by now), then copies rows [row0, min(row0 + 64, S)) to a
// contiguous [B, S, H, 64] output with 16-byte stores, 8 threads a row.
// Both ends of the trip through shared memory are free of bank conflicts.
__device__ __forceinline__ void store_tile(uint8_t* tile, const float (&d)[32],
                                           const float (&mul)[2], bf16* out,
                                           int64_t b, int64_t h, int H,
                                           int row0, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5) + g;
  __syncthreads();  // every product that read the tile has completed
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + (r0 + 8 * r) * 128 +
                                   ((j ^ g) << 4) + 4 * t) =
          pack(d[4 * j + 2 * r] * mul[r], d[4 * j + 2 * r + 1] * mul[r]);
  __syncthreads();
  for (int c = threadIdx.x; c < kTile * 8; c += kThreads) {
    const int r = c >> 3, chunk = c & 7;
    const int row = row0 + r;
    if (row >= S) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(
        tile + r * 128 + ((chunk ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(out + ((b * S + row) * H + h) * kHd +
                              8 * chunk) = v;
  }
}

// K4 ----------------------------------------------------------------------
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      bf16* __restrict__ o, float* __restrict__ lse, int S,
                      int H, float scale_log2, ivg::Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  const uint32_t q_s = base;
  const uint32_t bar_q = base + 5 * kTileBytes;
  auto k_s = [&](int st) { return base + (1 + 2 * st) * kTileBytes; };
  auto v_s = [&](int st) { return base + (2 + 2 * st) * kTileBytes; };
  auto bar_kv = [&](int st) { return bar_q + 8 * (1 + st); };
  // the keep bits of a stage's (64 queries, 64 keys) tile
  auto keep_s = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + kFwdKeep) + ivg::kKeepWords * st;
  };

  const int nt = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / nt;
  const int qt = nt - 1 - static_cast<int>(blockIdx.x % nt);
  const int b = bh / H, h = bh % H;
  // the Philox counter of this head's row 0 in the global [B, Hg] batch of
  // heads whose mask this shard draws (philox.cuh)
  const uint64_t head_ctr = ivg::head_counter(drop, b, h, S);
  const int q0 = qt * kTile;
  const int g = (threadIdx.x & 31) >> 2;
  const int row = q0 + 16 * (threadIdx.x >> 5) + g;  // and row + 8

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv(0), 1);
    mbar_init(bar_kv(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, kTileBytes);
    tma_load(q_s, &q_map, bar_q, 0, h, q0, b);
    mbar_expect_tx(bar_kv(0), 2 * kTileBytes);
    tma_load(k_s(0), &k_map, bar_kv(0), 0, h, 0, b);
    tma_load(v_s(0), &v_map, bar_kv(0), 0, h, 0, b);
  }
  if constexpr (kDrop) ivg::draw_keep_tile(drop, head_ctr, S, q0, 0, keep_s(0));
  __syncthreads();

  float acc[32], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint64_t q_desc = desc(q_s);
  mbar_wait(bar_q, 0);

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    // every thread is done with tile kt - 1, whose stage takes tile kt + 1
    // (and whose keep bits it has read), and sees tile kt's keep bits
    if (kt > 0) __syncthreads();
    if (threadIdx.x == 0 && kt < qt) {
      mbar_expect_tx(bar_kv(st ^ 1), 2 * kTileBytes);
      tma_load(k_s(st ^ 1), &k_map, bar_kv(st ^ 1), 0, h, (kt + 1) * kTile, b);
      tma_load(v_s(st ^ 1), &v_map, bar_kv(st ^ 1), 0, h, (kt + 1) * kTile, b);
    }
    mbar_wait(bar_kv(st), (kt >> 1) & 1);

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t k_desc = desc(k_s(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, q_desc + kStepK * kk, k_desc + kStepK * kk, kk > 0);
    wg_commit();
    // while the product runs, the next tile's keep bits into the other stage
    if constexpr (kDrop)
      if (kt < qt)
        ivg::draw_keep_tile(drop, head_ctr, S, q0, (kt + 1) * kTile,
                            keep_s(st ^ 1));
    wg_wait_all();
    reg_fence(s);

    // the online softmax (rows past S read as 0 and are never stored)
    softmax_rows(s, acc, m, l, row, kt * kTile, S, kt == qt, scale_log2);
    // P Z / keep, after the row sums (lse is of the undropped P)
    if constexpr (kDrop) drop_rows(s, keep_s(st), drop, row, q0);
    uint32_t pa[4][4];  // P rounded to bf16, as the TPU kernel rounds it
    to_a(s, pa);

    // O += P V
    const uint64_t v_desc = desc(v_s(st));
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pa[kk], v_desc + kStepMN * kk);
    wg_commit();
    wg_wait_all();
    reg_fence(acc);
  }

  finish_rows(l, m, lse + static_cast<int64_t>(bh) * S, row, S);
  store_tile(smem, acc, l, o, b, h, H, q0, S);
}

// K5 ----------------------------------------------------------------------
// 3 CTAs an SM, so at most 168 registers a thread: left to itself, ptxas
// gave the dropout instance 172 with the shard's head carried through the
// loop (philox.cuh), which fits 2 CTAs an SM and was ~13 % slower
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 3)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int S, int H, float scale,
                          float scale_log2, ivg::Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  const uint32_t k_s = base, v_s = base + kTileBytes;
  auto q_s = [&](int st) { return base + (2 + 2 * st) * kTileBytes; };
  auto do_s = [&](int st) { return base + (3 + 2 * st) * kTileBytes; };
  // lse (times log2(e)) and di of a stage's 64 queries
  auto lse_s = [&](int st) {
    return reinterpret_cast<float*>(smem + kDkvLse) + kTile * st;
  };
  auto di_s = [&](int st) {
    return reinterpret_cast<float*>(smem + kDkvDi) + kTile * st;
  };
  const uint32_t bar_kv = base + kDkvBars;
  auto bar_full = [&](int st) { return bar_kv + 8 * (1 + st); };
  // the keep bits of a stage's (64 queries, 64 keys) tile
  auto keep_s = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + kDkvKeep) + ivg::kKeepWords * st;
  };

  const int nt = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / nt;
  const int kt = blockIdx.x % nt;  // key tile 0 meets the most query tiles
  const int b = bh / H, h = bh % H;
  // the Philox counter of this head's row 0 in the global [B, Hg] batch of
  // heads whose mask this shard draws (philox.cuh)
  const uint64_t head_ctr = ivg::head_counter(drop, b, h, S);
  const int k0 = kt * kTile;
  const int g = (threadIdx.x & 31) >> 2;
  const int key = k0 + 16 * (threadIdx.x >> 5) + g;  // and key + 8

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_full(0), 1);
    mbar_init(bar_full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kTileBytes);
    tma_load(k_s, &k_map, bar_kv, 0, h, k0, b);
    tma_load(v_s, &v_map, bar_kv, 0, h, k0, b);
    mbar_expect_tx(bar_full(0), 2 * kTileBytes);
    tma_load(q_s(0), &q_map, bar_full(0), 0, h, k0, b);
    tma_load(do_s(0), &do_map, bar_full(0), 0, h, k0, b);
  }
  // threads 0..63 carry lse, 64..127 di, one query each, into the ring
  const int qi = threadIdx.x & (kTile - 1);
  const bool is_lse = threadIdx.x < kTile;
  const float* src = (is_lse ? lse : di) + static_cast<int64_t>(bh) * S;
  const float mul = is_lse ? kLog2e : 1.f;
  auto fetch = [&](int q0) {
    return q0 + qi < S ? src[q0 + qi] * mul : 0.f;
  };
  (is_lse ? lse_s(0) : di_s(0))[qi] = fetch(k0);
  if constexpr (kDrop)
    ivg::draw_keep_tile(drop, head_ctr, S, k0, k0, keep_s(0));
  __syncthreads();

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint64_t k_desc = desc(k_s), v_desc = desc(v_s);
  mbar_wait(bar_kv, 0);

  for (int qt = kt; qt < nt; ++qt) {
    const int j = qt - kt, st = j & 1;
    const int q0 = qt * kTile;
    const bool more = qt + 1 < nt;
    // every thread is done with tile qt - 1, whose stage takes tile qt + 1
    if (j > 0) __syncthreads();
    float next = 0.f;
    if (more) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar_full(st ^ 1), 2 * kTileBytes);
        tma_load(q_s(st ^ 1), &q_map, bar_full(st ^ 1), 0, h, q0 + kTile, b);
        tma_load(do_s(st ^ 1), &do_map, bar_full(st ^ 1), 0, h, q0 + kTile, b);
      }
      next = fetch(q0 + kTile);  // stored after this tile's products
    }
    mbar_wait(bar_full(st), (j >> 1) & 1);

    // S^T = K Q^T, dP^T = V dO^T
    float sT[32], dpT[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
    const uint64_t q_desc = desc(q_s(st)), do_desc = desc(do_s(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(sT, k_desc + kStepK * kk, q_desc + kStepK * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dpT, v_desc + kStepK * kk, do_desc + kStepK * kk, kk > 0);
    wg_commit();
    // while the products run, the next tile's keep bits into the other
    // stage (read by every thread in tile qt - 1, before the barrier above)
    if constexpr (kDrop)
      if (more)
        ivg::draw_keep_tile(drop, head_ctr, S, q0 + kTile, k0, keep_s(st ^ 1));
    wg_wait_all();
    reg_fence(sT);
    reg_fence(dpT);

    // P^T and dS^T, with the stage's keep tile (sm90.cuh)
    p_ds_transposed<kDrop>(sT, dpT, lse_s(st), di_s(st), keep_s(st), drop, q0,
                           key, S, qt == kt || qt == nt - 1, scale_log2);
    uint32_t pa[4][4], dsa[4][4];  // rounded to bf16, as on the TPU
    to_a(sT, pa);
    to_a(dpT, dsa);

    // dV += P^T dO, dK += dS^T Q
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv_acc, pa[kk], do_desc + kStepMN * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk_acc, dsa[kk], q_desc + kStepMN * kk);
    wg_commit();
    wg_wait_all();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    if (more) (is_lse ? lse_s(st ^ 1) : di_s(st ^ 1))[qi] = next;
  }

  const float dk_mul[2] = {scale, scale}, dv_mul[2] = {1.f, 1.f};
  store_tile(smem, dk_acc, dk_mul, dk, b, h, H, k0, S);
  store_tile(smem + kTileBytes, dv_acc, dv_mul, dv, b, h, H, k0, S);
}

// K6 ----------------------------------------------------------------------
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, bf16* __restrict__ dq,
                         int S, int H, float scale, float scale_log2,
                         ivg::Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  const uint32_t q_s = base, do_s = base + kTileBytes;
  auto k_s = [&](int st) { return base + (2 + 2 * st) * kTileBytes; };
  auto v_s = [&](int st) { return base + (3 + 2 * st) * kTileBytes; };
  const uint32_t bar_q = base + 6 * kTileBytes;
  auto bar_kv = [&](int st) { return bar_q + 8 * (1 + st); };
  // the keep bits of a stage's (64 queries, 64 keys) tile
  auto keep_s = [&](int st) {
    return reinterpret_cast<uint32_t*>(smem + kDqKeep) + ivg::kKeepWords * st;
  };

  const int nt = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / nt;
  const int qt = nt - 1 - static_cast<int>(blockIdx.x % nt);
  const int b = bh / H, h = bh % H;
  // the Philox counter of this head's row 0 in the global [B, Hg] batch of
  // heads whose mask this shard draws (philox.cuh)
  const uint64_t head_ctr = ivg::head_counter(drop, b, h, S);
  const int q0 = qt * kTile;
  const int g = (threadIdx.x & 31) >> 2;
  const int row = q0 + 16 * (threadIdx.x >> 5) + g;  // and row + 8

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv(0), 1);
    mbar_init(bar_kv(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * kTileBytes);
    tma_load(q_s, &q_map, bar_q, 0, h, q0, b);
    tma_load(do_s, &do_map, bar_q, 0, h, q0, b);
    mbar_expect_tx(bar_kv(0), 2 * kTileBytes);
    tma_load(k_s(0), &k_map, bar_kv(0), 0, h, 0, b);
    tma_load(v_s(0), &v_map, bar_kv(0), 0, h, 0, b);
  }
  // lse (times log2(e)) and di of this thread's two rows; rows past S read
  // zero Q and dO, so their dS is 0 and they are never stored
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row + 8 * r < S;
    const int64_t at = static_cast<int64_t>(bh) * S + row + 8 * r;
    lse_r[r] = live ? lse[at] * kLog2e : 0.f;
    di_r[r] = live ? di[at] : 0.f;
  }
  if constexpr (kDrop) ivg::draw_keep_tile(drop, head_ctr, S, q0, 0, keep_s(0));
  __syncthreads();

  float dq_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
  const uint64_t q_desc = desc(q_s), do_desc = desc(do_s);
  mbar_wait(bar_q, 0);

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    // every thread is done with tile kt - 1, whose stage takes tile kt + 1
    if (kt > 0) __syncthreads();
    if (threadIdx.x == 0 && kt < qt) {
      mbar_expect_tx(bar_kv(st ^ 1), 2 * kTileBytes);
      tma_load(k_s(st ^ 1), &k_map, bar_kv(st ^ 1), 0, h, (kt + 1) * kTile, b);
      tma_load(v_s(st ^ 1), &v_map, bar_kv(st ^ 1), 0, h, (kt + 1) * kTile, b);
    }
    mbar_wait(bar_kv(st), (kt >> 1) & 1);

    // S = Q K^T, dP = dO V^T
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    const uint64_t k_desc = desc(k_s(st)), v_desc = desc(v_s(st));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(s, q_desc + kStepK * kk, k_desc + kStepK * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss(dp, do_desc + kStepK * kk, v_desc + kStepK * kk, kk > 0);
    wg_commit();
    // while the products run, the next tile's keep bits into the other
    // stage (read by every thread in tile kt - 1, before the barrier above)
    if constexpr (kDrop)
      if (kt < qt)
        ivg::draw_keep_tile(drop, head_ctr, S, q0, (kt + 1) * kTile,
                            keep_s(st ^ 1));
    wg_wait_all();
    reg_fence(s);
    reg_fence(dp);

    // dS = P (dP - di) into s, with the stage's keep tile (sm90.cuh); the
    // diagonal tile holds the causal edge and, on the last query tile, the
    // ragged one
    ds_rows<kDrop>(s, dp, lse_r, di_r, keep_s(st), drop, row, q0, kt * kTile,
                   S, kt == qt, scale_log2);
    uint32_t dsa[4][4];  // dS rounded to bf16, as the TPU kernel rounds it
    to_a(s, dsa);

    // dQ += dS K
    reg_fence(dq_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dq_acc, dsa[kk], k_desc + kStepMN * kk);
    wg_commit();
    wg_wait_all();
    reg_fence(dq_acc);
  }

  const float mul[2] = {scale, scale};
  store_tile(smem, dq_acc, mul, dq, b, h, H, q0, S);
}

// ------------------------------- host --------------------------------------

// The map of a bf16 [B, S, H, 64] tensor read through its batch, sequence
// and head strides st[0..2] (elements; the head dim contiguous): dims
// (64, H, S, B), box (64, 1, 64, 1), 128-byte swizzle, zeros past S.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     const int64_t st[3]) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kHd, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr float kScale = 0.125f;  // hd^-0.5 at hd = 64
constexpr int kMaxS = 1024;

bool bad_shape(int B, int S, int H, int hd) {
  return hd != kHd || B < 1 || H < 1 || S < 1 || S > kMaxS;
}

bool bad_dropout(double p_drop) { return !(p_drop >= 0.0 && p_drop < 1.0); }

}  // namespace

// q/k/v: bf16 [B, S, H, 64] read through the given batch/sequence/head
// strides (elements), head dim contiguous, base pointers 16-byte aligned and
// strides multiples of 8 (TMA's rule). Outputs are contiguous: o, dk, dv,
// dq [B, S, H, 64] bf16, lse [B, H, S] fp32 (natural log). dout is contiguous
// [B, S, H, 64] bf16; di is fp32 [B, H, S]. p_drop in [0, 1) is the
// attention dropout, its mask drawn from (seed, offset) as philox.cuh says,
// at the rows of a shard whose first batch row is b0 and first head h0 of
// Hg heads in all (0, 0, H for a call that holds the whole batch);
// 0 launches the kernels without dropout. The same arguments as the fp32
// entry points (flash_attention_tf32.cu). Each function encodes its tensor
// maps, launches one kernel on `stream` and returns the first cudaError_t
// (0 on success).
extern "C" int ivg_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int B, int S, int H,
                                  int hd, int64_t q_sb, int64_t q_ss,
                                  int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                  int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                  int64_t v_sh, double p_drop, uint64_t seed,
                                  uint64_t offset, int b0, int h0, int Hg,
                                  void* stream) {
  if (bad_shape(B, S, H, hd) || bad_dropout(p_drop) ||
      ivg::bad_shard(B, H, b0, h0, Hg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t sts[3][3] = {
      {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}};
  const void* ptrs[3] = {q, k, v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], B, S, H, sts[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B * H * ((S + kTile - 1) / kTile));
  const ivg::Dropout drop =
      ivg::make_dropout(p_drop, seed, offset, S, b0, h0, Hg);
  const auto kernel = p_drop > 0.0 ? flash_fwd_sm90_kernel<true>
                                   : flash_fwd_sm90_kernel<false>;
  const int smem = kFwdSmem + (p_drop > 0.0 ? kKeepRing : 0);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), lse, S, H,
      kScale * kLog2e, drop);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ivg_flash_bwd_dkv_bf16(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* di,
                                      void* dk, void* dv, int B, int S, int H,
                                      int hd, int64_t q_sb, int64_t q_ss,
                                      int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                      int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                      int64_t v_sh, double p_drop,
                                      uint64_t seed, uint64_t offset,
                                      int b0, int h0, int Hg,
                                      void* stream) {
  if (bad_shape(B, S, H, hd) || bad_dropout(p_drop) ||
      ivg::bad_shard(B, H, b0, h0, Hg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t sts[4][3] = {{q_sb, q_ss, q_sh},
                             {k_sb, k_ss, k_sh},
                             {v_sb, v_ss, v_sh},
                             {static_cast<int64_t>(S) * H * kHd,
                              static_cast<int64_t>(H) * kHd, kHd}};
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], B, S, H, sts[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto kernel = p_drop > 0.0 ? flash_bwd_dkv_sm90_kernel<true>
                                   : flash_bwd_dkv_sm90_kernel<false>;
  const int smem = kDkvSmem + (p_drop > 0.0 ? kKeepRing : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H * ((S + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, kScale, kScale * kLog2e,
      ivg::make_dropout(p_drop, seed, offset, S, b0, h0, Hg));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ivg_flash_bwd_dq_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* di,
                                     void* dq, int B, int S, int H, int hd,
                                     int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                     int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                     int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                     double p_drop, uint64_t seed,
                                     uint64_t offset, int b0, int h0, int Hg,
                                     void* stream) {
  if (bad_shape(B, S, H, hd) || bad_dropout(p_drop) ||
      ivg::bad_shard(B, H, b0, h0, Hg))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t sts[4][3] = {{q_sb, q_ss, q_sh},
                             {k_sb, k_ss, k_sh},
                             {v_sb, v_ss, v_sh},
                             {static_cast<int64_t>(S) * H * kHd,
                              static_cast<int64_t>(H) * kHd, kHd}};
  const void* ptrs[4] = {q, k, v, dout};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_map(&maps[i], ptrs[i], B, S, H, sts[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto kernel = p_drop > 0.0 ? flash_bwd_dq_sm90_kernel<true>
                                   : flash_bwd_dq_sm90_kernel<false>;
  const int smem = kDqSmem + (p_drop > 0.0 ? kKeepRing : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H * ((S + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<bf16*>(dq), S,
      H, kScale, kScale * kLog2e,
      ivg::make_dropout(p_drop, seed, offset, S, b0, h0, Hg));
  return static_cast<int>(cudaGetLastError());
}
