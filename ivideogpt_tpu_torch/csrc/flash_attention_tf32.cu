// K4 (forward), K5 (dK, dV) and K6 (dQ) of causal flash attention on fp32
// inputs, for Hopper (sm_90a): TMA copies into shared memory, and every
// product as three TF32 wgmma products summed in fp32.
//
// Replaces, for fp32 q/k/v, the stock TPU kernels that the JAX package calls
// at ivideogpt_tpu/models/llama.py:97 (jax/experimental/pallas/ops/tpu/
// flash_attention.py, JAX 0.9.0):
//   K4  _flash_attention_kernel      :331 (launched :758)
//   K5  _flash_attention_dkv_kernel  :796 (launched :1121)
//   K6  _flash_attention_dq_kernel   :1146 (launched :1456)
// A library of its own (ivg_flash_fwd_fp32, ivg_flash_bwd_dkv_fp32,
// ivg_flash_bwd_dq_fp32, at the end), with the arguments of the bf16 entry
// points (flash_attention_sm90.cu).
//
// What they compute, for one (b, h), s = q.k * hd^-0.5, keys j <= query i:
//   K4  O = softmax(s) V, lse_i = log sum_j exp(s_ij) (natural log)
//   K5  P = exp(s - lse), dS = P * (dO V^T - di), dV = P^T dO,
//       dK = dS^T Q * hd^-0.5
//   K6  dQ = dS K * hd^-0.5
// with dropout O = (P Z / keep) V (lse of the undropped P), dV from
// (P Z / keep)^T and dS = P (dP Z / keep - di), Z the mask of philox.cuh.
// Nothing is rounded to bf16: the trainer CLI's default precision
// (--mixed_precision no) trains through these kernels, and the fp32
// prefills of predict and VP2 run K4.
//
// Bound on an H100 SXM at the train shape (B=16, S=751, H=12; causal pairs
// only): K4 1.39e10 FLOP, K5 2.78e10, K6 2.08e10. fp32 FMA (67 TFLOP/s)
// would take 0.207 / 0.414 / 0.311 ms; the tensor cores' TF32 rate is 495
// TFLOP/s, and an fp32-accurate product takes three TF32 products, so 165
// TFLOP/s: 0.084 / 0.168 / 0.126 ms. The bytes (fp32 in and out once:
// 0.044 / 0.066 / 0.055 ms) do not bound them. So the products run on the
// tensor cores:
//   - Three terms. A B ~ A_h B_h + A_h B_l + A_l B_h, A_h = A rounded to
//     TF32 (to nearest, ties away: cvt.rna's value, in two integer
//     instructions), A_l = A - A_h rounded alike; the two small terms
//     first, then the large one, into one fp32 accumulator (as PyTorch's
//     fp32 memory-efficient attention does on sm80+). hi + lo holds x to
//     2^-22 |x|, and the dropped A_l B_l is below that.
//   - wgmma.mma_async m64n64k8 .tf32 takes both operands K-major: it has no
//     transpose bit. The score products (S = Q K^T in K4; S^T = K Q^T,
//     dP^T = V dO^T in K5; S = Q K^T, dP = dO V^T in K6) reduce over the
//     head dim, which is contiguous as TMA lands the tiles. The products
//     that follow reduce over the sequence (O = P V in K4; dV = P^T dO,
//     dK = dS^T Q in K5; dQ = dS K in K6): their A (P, P^T, dS^T, dS) is the
//     score product's accumulator, split into hi and lo in registers; their
//     B (V, dO, Q, K) is transposed in shared memory by one conversion pass
//     a landed tile.
//   - The conversion pass (convert_tile): 128 threads read a landed 64 x 64
//     tile once with 16-byte loads, write its hi in place and its lo beside
//     it and, for an operand that is also a B over the sequence, the
//     transposed hi and lo; every load and store is 16 bytes and free of
//     bank conflicts (each 8-lane phase meets 8 bank groups, by the choice
//     of block per thread). The transposed tile stores a k-step's 8 rows in
//     the order [0 2 4 6 1 3 5 7]: the tf32 A fragment holds columns t and
//     t + 4 of a k-step where the accumulator holds 2t and 2t + 1, so the
//     accumulator becomes the next A operand without a shuffle.
//   - Copies: one thread issues TMA loads of 64 x 64 fp32 tiles, two 64 x 32
//     boxes each (a 128-byte swizzle row is 32 floats), over a 4-D tensor
//     map per input (dims (64, H, S, B), the caller's strides: 16-byte
//     aligned bases and strides), zeros past S, completing on mbarriers; the
//     next streamed tile's copy is in flight while this one converts and
//     multiplies (a 2-stage landing ring).
//   - Shared memory: a 64 x 64 tile is 16 KB, its hi and lo 32 KB a layout.
//     K4 holds Q (hi, lo), the ring of K and V, K's lo and two stages of
//     V's transposed hi and lo: 11 tiles, 176 KB (V's own hi and lo are
//     never read, so its conversion writes only the transposed tiles); K5
//     holds K and V (hi, lo), the ring of Q and dO, their lo and their
//     transposed hi and lo: 14 tiles, 224 KB of the 227 KB; K6 holds Q and
//     dO (hi, lo), the ring of K and V, their lo and two stages of K's
//     transposed hi and lo: 14 tiles. One CTA an SM, one warpgroup on 64
//     rows, so nothing hides a pass that runs alone: K4 and K6 convert key
//     tile kt + 1 while tile kt's last product (P V, dQ) runs (into the
//     other transposed stage). K5 has no room for a second stage and
//     converts in series;
//     splitting tile qt + 1 under tile qt's dV/dK products and transposing
//     it under its own score products measured slower (the score products
//     already use most of the shared-memory bandwidth).
//   - Scores, masks, K4's online softmax, lse (log2 units inside) and the
//     dropout keep ring are the bf16 kernels' (the m64n64 fp32 accumulator
//     has one layout for every input type): each 64 x 64 tile's keep bits
//     are drawn once (ivg::draw_keep_tile, one Philox call a group of 4
//     keys) while the tile before runs its score products, and read through
//     sm90.cuh's drop_rows / p_ds_transposed.
// K4 and K6: one CTA per (b*h, query tile), the last query tile first; K5:
// one CTA per (b*h, key tile), key tile 0 (the most query tiles) first,
// each walking its query tiles from the last to the diagonal. No atomics
// and no sums across CTAs: outputs and gradients are deterministic.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"
#include "sm90.cuh"

namespace {

using namespace ivg::sm90;

constexpr int kHd = 64;                      // head dim
constexpr int kTile = 64;                    // rows of a query or key tile
constexpr int kThreads = 128;                // one warpgroup
constexpr int kHalf = 32;                    // floats in a 128-byte row
constexpr int kTileBytes = kTile * kHd * 4;  // one fp32 64 x 64 tile
constexpr int kHalfBytes = kTileBytes / 2;   // its 64 x 32 box
constexpr int kAlign = kSwizzleAtom;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory, from a base rounded up to kAlign, in 16 KB tiles:
//   K4: Q | Q_lo | K0 | V0 | K1 | V1 | K_lo | V^T0 | V^T_lo0 | V^T1 |
//       V^T_lo1 | 3 mbarriers | with dropout, keep[2][128]
//   K5: K | K_lo | V | V_lo | Q0 | dO0 | Q1 | dO1 | Q_lo | dO_lo | Q^T |
//       Q^T_lo | dO^T | dO^T_lo | lse[64] | di[64] | 3 mbarriers
//       | with dropout, keep[2][128]
//   K6: Q | Q_lo | dO | dO_lo | K0 | V0 | K1 | V1 | K_lo | V_lo | K^T0 |
//       K^T_lo0 | K^T1 | K^T_lo1 | 3 mbarriers | with dropout, keep[2][128]
// The landed tiles (K, V, Q, dO, and the ring's) hold their own hi once
// converted (K4's V excepted); the lo and transposed tiles hold the tile
// being multiplied.
constexpr int kFwdBars = 11 * kTileBytes;
constexpr int kFwdKeep = kFwdBars + 64;
constexpr int kFwdSmem = kFwdKeep + kAlign;
constexpr int kDkvLse = 14 * kTileBytes;
constexpr int kDkvBars = kDkvLse + 2 * kTile * 4;
constexpr int kDkvKeep = kDkvBars + 64;
constexpr int kDkvSmem = kDkvKeep + kAlign;
constexpr int kDqBars = 14 * kTileBytes;
constexpr int kDqKeep = kDqBars + 64;
constexpr int kDqSmem = kDqKeep + kAlign;
constexpr int kKeepRing = 2 * ivg::kKeepWords * 4;
static_assert(kFwdSmem + kKeepRing <= 232448, "K4 exceeds 227 KB");
static_assert(kDkvSmem + kKeepRing <= 232448, "K5 exceeds 227 KB");
static_assert(kDqSmem + kKeepRing <= 232448, "K6 exceeds 227 KB");

// ------------------------- TF32 splits -------------------------------------

// x rounded to TF32, to nearest with ties away from zero: the value
// cvt.rna.tf32.f32 gives for finite x, in two integer instructions (half of
// the 13 dropped bits added to the magnitude, a carry rounding up into the
// exponent, then the 13 bits cleared). It measured faster than the
// conversion instruction on an H100, the gradients bit-equal.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to 2^-22 |x|: hi is x rounded to TF32 (nearest, ties away
// from zero), lo the remainder (exact in fp32) rounded alike.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& v, float4& hi,
                                       float4& lo) {
  uint32_t h, l;
  split(v.x, h, l);
  hi.x = __uint_as_float(h);
  lo.x = __uint_as_float(l);
  split(v.y, h, l);
  hi.y = __uint_as_float(h);
  lo.y = __uint_as_float(l);
  split(v.z, h, l);
  hi.z = __uint_as_float(h);
  lo.z = __uint_as_float(l);
  split(v.w, h, l);
  hi.w = __uint_as_float(h);
  lo.w = __uint_as_float(l);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Splits a landed tile (64 rows x 64 floats, two 64 x 32 halves with the
// 128-byte swizzle, as TMA writes them): with kSplit into its TF32 hi, in
// place, and lo at `lo` (the same layout); with kTrans into the transposed
// tile's hi and lo at tr_hi, tr_lo: row e (a column of the landed tile) holds the
// landed rows as the K of a product, rows 0-31 in the first 8 KB half and
// 32-63 in the second, each k-step's 8 rows in the order [0 2 4 6 1 3 5 7]
// (see to_a_tf32). Thread x takes rows 8 j + 2 p + s (p < 4) of the landed
// tile, columns 32 ch + 4 a .. + 3 (ch < 2): s = x & 1, j = 4 (x >> 6) +
// ((x >> 1) & 3), a = ((x >> 3) & 7) ^ 2 ((x >> 1) & 3). Then in every
// 16-byte load and store, the 8 lanes of a phase meet 8 different bank
// groups. The caller orders the writes before wgmma reads them
// (fence_proxy_async, a barrier).
template <bool kTrans, bool kSplit = true>
__device__ __forceinline__ void convert_tile(uint8_t* tile, uint8_t* lo,
                                             uint8_t* tr_hi, uint8_t* tr_lo) {
  const int x = threadIdx.x;
  const int s = x & 1, j3 = (x >> 1) & 3, jh = x >> 6;
  const int a = ((x >> 3) & 7) ^ (2 * j3);
  const int j = 4 * jh + j3;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    float4 h4[4], l4[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = 8 * j + 2 * p + s;
      const int off = ch * kHalfBytes + r * 128 + ((a ^ (r & 7)) << 4);
      split4(*reinterpret_cast<const float4*>(tile + off), h4[p], l4[p]);
      if constexpr (kSplit) {
        *reinterpret_cast<float4*>(tile + off) = h4[p];
        *reinterpret_cast<float4*>(lo + off) = l4[p];
      }
    }
    if constexpr (kTrans) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = kHalf * ch + 4 * a + i;
        const int off =
            jh * kHalfBytes + e * 128 + (((2 * j3 + s) ^ (e & 7)) << 4);
        *reinterpret_cast<float4*>(tr_hi + off) = make_float4(
            comp(h4[0], i), comp(h4[1], i), comp(h4[2], i), comp(h4[3], i));
        *reinterpret_cast<float4*>(tr_lo + off) = make_float4(
            comp(l4[0], i), comp(l4[1], i), comp(l4[2], i), comp(l4[3], i));
      }
    }
  }
}

// ------------------------------ wgmma --------------------------------------

// d (+)= A B for one k-step of 8: A [64 x 8] and B [8 x 64], both K-major in
// shared memory, read as TF32; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " IVG_D32
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : IVG_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for one k-step of 8: A from registers (each warp's 16 rows:
// {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}), B [8 x 64] K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " IVG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : IVG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The descriptor of k-step kk (8 columns, 32 bytes) of a tile of two 64 x 32
// halves.
__device__ __forceinline__ uint64_t kstep(uint64_t d, int kk) {
  return d + (kk >> 2) * (kHalfBytes >> 4) + (kk & 3) * 2;
}

// d = A B^T over 64 columns in three TF32 terms, the small ones first:
// A_h B_l + A_l B_h + A_h B_h. A, B: 64 x 64 row-major tiles (hi, lo).
__device__ __forceinline__ void product3_ss(float (&d)[32], uint32_t a_h,
                                            uint32_t a_l, uint32_t b_h,
                                            uint32_t b_l) {
  const uint64_t ah = desc(a_h), al = desc(a_l), bh = desc(b_h),
                 bl = desc(b_l);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_ss(d, kstep(ah, kk), kstep(bl, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(d, kstep(al, kk), kstep(bh, kk), 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_ss(d, kstep(ah, kk), kstep(bh, kk), 1);
}

// d += A B in three TF32 terms, A (hi, lo) from registers as to_a_tf32
// gives it, B from a transposed tile (hi, lo) of convert_tile.
__device__ __forceinline__ void product3_rs(float (&d)[32],
                                            const uint32_t (&a_h)[8][4],
                                            const uint32_t (&a_l)[8][4],
                                            uint32_t b_h, uint32_t b_l) {
  const uint64_t bh = desc(b_h), bl = desc(b_l);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs(d, a_h[kk], kstep(bl, kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs(d, a_l[kk], kstep(bh, kk));
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs(d, a_h[kk], kstep(bh, kk));
}

// An accumulator as the A operand of a product over its columns, split into
// TF32 hi and lo: k-step kk takes columns 8 kk .. 8 kk + 7, and thread
// (g, t) holds columns 2t and 2t + 1 of rows g and g + 8 (d[4 kk + e]), which
// the fragment puts at k positions t and t + 4: {d[4kk], d[4kk + 2],
// d[4kk + 1], d[4kk + 3]}. So position p of a k-step is column 2p (p < 4) or
// 2 (p - 4) + 1, the row order of convert_tile's transposed tiles.
__device__ __forceinline__ void to_a_tf32(const float (&d)[32],
                                          uint32_t (&hi)[8][4],
                                          uint32_t (&lo)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(d[4 * kk + ((r & 1) << 1) + (r >> 1)], hi[kk][r], lo[kk][r]);
}

// Rows [row0, row0 + 64) of head h, batch b into the tile at dst: two
// 64 x 32 boxes (16 KB on the barrier).
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int h, int row0,
                                          int b) {
  tma_load(dst, map, bar, 0, h, row0, b);
  tma_load(dst + kHalfBytes, map, bar, kHalf, h, row0, b);
}

// An accumulator times mul into rows [row0, min(row0 + 64, S)) of a
// contiguous fp32 [B, S, H, 64] output, 8 bytes a store.
__device__ __forceinline__ void store_acc(const float (&d)[32], float mul,
                                          float* out, int64_t b, int64_t h,
                                          int H, int row0, int S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 16 * (threadIdx.x >> 5) + g + 8 * r;
    if (row >= S) continue;
    float* p = out + ((b * S + row) * H + h) * kHd + 2 * t;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<float2*>(p + 8 * jj) =
          make_float2(d[4 * jj + 2 * r] * mul, d[4 * jj + 2 * r + 1] * mul);
  }
}

// Orders the writes of an A fragment before the wgmma.fence of the products
// that read it, and keeps it in its registers until they have completed
// (the compiler does not see wgmma read them late).
__device__ __forceinline__ void frag_fence(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// K4 ----------------------------------------------------------------------
// Q is landed once and split; K and V flow through the ring. Key tile
// kt + 1 converts while tile kt's P V product runs: K's hi in place and its
// lo (free once tile kt's score product is done), V's transposed hi and lo
// into the other V^T stage.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      float* __restrict__ o, float* __restrict__ lse, int S,
                      int H, float scale_log2, ivg::Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  auto tile = [&](int i) { return smem + i * kTileBytes; };
  auto at = [&](int i) { return base + i * kTileBytes; };
  enum { Q, Q_LO, RING, K_LO = 6, VT };
  auto k_st = [&](int st) { return RING + 2 * st; };      // K's hi
  auto v_st = [&](int st) { return RING + 2 * st + 1; };  // V as landed
  auto vt_st = [&](int st) { return VT + 2 * st; };       // V^T's hi
  auto vtl_st = [&](int st) { return VT + 2 * st + 1; };  // V^T's lo
  const uint32_t bar_q = base + kFwdBars;
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
    load_tile(at(Q), &q_map, bar_q, h, q0, b);
    for (int n = 0; n < 2 && n <= qt; ++n) {
      mbar_expect_tx(bar_kv(n), 2 * kTileBytes);
      load_tile(at(k_st(n)), &k_map, bar_kv(n), h, n * kTile, b);
      load_tile(at(v_st(n)), &v_map, bar_kv(n), h, n * kTile, b);
    }
  }
  if constexpr (kDrop) ivg::draw_keep_tile(drop, head_ctr, S, q0, 0, keep_s(0));
  __syncthreads();
  mbar_wait(bar_q, 0);
  convert_tile<false>(tile(Q), tile(Q_LO), nullptr, nullptr);
  mbar_wait(bar_kv(0), 0);
  convert_tile<false>(tile(k_st(0)), tile(K_LO), nullptr, nullptr);
  convert_tile<true, false>(tile(v_st(0)), nullptr, tile(vt_st(0)),
                            tile(vtl_st(0)));

  float acc[32], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  zero(acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    // tile kt's conversion and keep bits, by every thread, before the
    // products read them
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T
    float s[32];
    zero(s);
    wg_fence();
    product3_ss(s, at(Q), at(Q_LO), at(k_st(st)), at(K_LO));
    wg_commit();
    // while the product runs, the next tile's keep bits into the other
    // stage (read by every thread in tile kt - 1, before the barrier above)
    if constexpr (kDrop)
      if (kt < qt)
        ivg::draw_keep_tile(drop, head_ctr, S, q0, (kt + 1) * kTile,
                            keep_s(st ^ 1));
    wg_wait_all();
    reg_fence(s);
    // every warp is past it: stage st's landed tiles take tile kt + 2 (its
    // V went into V^T when it converted), K_LO takes tile kt + 1
    __syncthreads();
    if (threadIdx.x == 0 && kt + 2 <= qt) {
      mbar_expect_tx(bar_kv(st), 2 * kTileBytes);
      load_tile(at(k_st(st)), &k_map, bar_kv(st), h, (kt + 2) * kTile, b);
      load_tile(at(v_st(st)), &v_map, bar_kv(st), h, (kt + 2) * kTile, b);
    }

    // the online softmax (rows past S read as 0 and are never stored)
    softmax_rows(s, acc, m, l, row, kt * kTile, S, kt == qt, scale_log2);
    // P Z / keep, after the row sums (lse is of the undropped P)
    if constexpr (kDrop) drop_rows(s, keep_s(st), drop, row, q0);
    uint32_t p_hi[8][4], p_lo[8][4];
    to_a_tf32(s, p_hi, p_lo);

    // O += P V, running while tile kt + 1 converts (into K_LO and the other
    // V^T stage; nothing there writes a register the product owns)
    reg_fence(acc);
    frag_fence(p_hi);
    frag_fence(p_lo);
    wg_fence();
    product3_rs(acc, p_hi, p_lo, at(vt_st(st)), at(vtl_st(st)));
    wg_commit();
    if (kt < qt) {
      mbar_wait(bar_kv(st ^ 1), ((kt + 1) >> 1) & 1);
      convert_tile<false>(tile(k_st(st ^ 1)), tile(K_LO), nullptr, nullptr);
      convert_tile<true, false>(tile(v_st(st ^ 1)), nullptr,
                                tile(vt_st(st ^ 1)), tile(vtl_st(st ^ 1)));
    }
    wg_wait_all();
    reg_fence(acc);
    frag_fence(p_hi);
    frag_fence(p_lo);
  }

  finish_rows(l, m, lse + static_cast<int64_t>(bh) * S, row, S);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] *= l[(i >> 1) & 1];
  store_acc(acc, 1.f, o, b, h, H, q0, S);
}

// K5 ----------------------------------------------------------------------
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ di, float* __restrict__ dk,
                          float* __restrict__ dv, int S, int H, float scale,
                          float scale_log2, ivg::Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  auto tile = [&](int i) { return smem + i * kTileBytes; };
  auto at = [&](int i) { return base + i * kTileBytes; };
  enum { K, K_LO, V, V_LO, RING, Q_LO = 8, DO_LO, QT, QT_LO, DOT, DOT_LO };
  auto q_st = [&](int st) { return RING + 2 * st; };       // Q's hi
  auto do_st = [&](int st) { return RING + 2 * st + 1; };  // dO's hi
  // lse (times log2(e)) and di of the tile's 64 queries
  float* lse_s = reinterpret_cast<float*>(smem + kDkvLse);
  float* di_s = lse_s + kTile;
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
  // Query tiles from the last to the diagonal: a key's largest P (its
  // nearest queries') are added last, onto the smaller sums of the far
  // queries, which keeps dK and dV near the three-term budget (the tensor
  // cores' fp32 sums drop low bits: in the other order K5's dV and dK
  // read several times the error of dQ and of the CPU's emulation of the
  // same terms)
  const int last = (nt - 1) * kTile;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_full(0), 1);
    mbar_init(bar_full(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * kTileBytes);
    load_tile(at(K), &k_map, bar_kv, h, k0, b);
    load_tile(at(V), &v_map, bar_kv, h, k0, b);
    mbar_expect_tx(bar_full(0), 2 * kTileBytes);
    load_tile(at(q_st(0)), &q_map, bar_full(0), h, last, b);
    load_tile(at(do_st(0)), &do_map, bar_full(0), h, last, b);
  }
  // threads 0..63 carry lse, 64..127 di, one query each; a tile's values
  // are stored once every thread is done with the tile before
  const int qi = threadIdx.x & (kTile - 1);
  const bool is_lse = threadIdx.x < kTile;
  const float* src = (is_lse ? lse : di) + static_cast<int64_t>(bh) * S;
  const float mul = is_lse ? kLog2e : 1.f;
  auto fetch = [&](int q0) {
    return q0 + qi < S ? src[q0 + qi] * mul : 0.f;
  };
  float cur = fetch(last);
  if constexpr (kDrop)
    ivg::draw_keep_tile(drop, head_ctr, S, last, k0, keep_s(0));
  __syncthreads();
  mbar_wait(bar_kv, 0);
  convert_tile<false>(tile(K), tile(K_LO), nullptr, nullptr);
  convert_tile<false>(tile(V), tile(V_LO), nullptr, nullptr);

  float dk_acc[32], dv_acc[32];
  zero(dk_acc);
  zero(dv_acc);

  for (int qt = nt - 1; qt >= kt; --qt) {
    const int j = nt - 1 - qt, st = j & 1;
    const int q0 = qt * kTile;
    const bool more = qt > kt;
    // every thread is done with tile qt + 1: its products, its lse and di,
    // its keep bits and its landing stage, which takes tile qt - 1
    if (j > 0) __syncthreads();
    (is_lse ? lse_s : di_s)[qi] = cur;
    if (more) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar_full(st ^ 1), 2 * kTileBytes);
        load_tile(at(q_st(st ^ 1)), &q_map, bar_full(st ^ 1), h, q0 - kTile,
                  b);
        load_tile(at(do_st(st ^ 1)), &do_map, bar_full(st ^ 1), h,
                  q0 - kTile, b);
      }
      cur = fetch(q0 - kTile);
    }
    mbar_wait(bar_full(st), (j >> 1) & 1);
    convert_tile<true>(tile(q_st(st)), tile(Q_LO), tile(QT), tile(QT_LO));
    convert_tile<true>(tile(do_st(st)), tile(DO_LO), tile(DOT), tile(DOT_LO));
    fence_proxy_async();
    __syncthreads();

    // S^T = K Q^T, dP^T = V dO^T
    float sT[32], dpT[32];
    zero(sT);
    zero(dpT);
    wg_fence();
    product3_ss(sT, at(K), at(K_LO), at(q_st(st)), at(Q_LO));
    product3_ss(dpT, at(V), at(V_LO), at(do_st(st)), at(DO_LO));
    wg_commit();
    // while the products run, the next tile's keep bits into the other
    // stage (read by every thread in tile qt + 1, before the barrier above)
    if constexpr (kDrop)
      if (more)
        ivg::draw_keep_tile(drop, head_ctr, S, q0 - kTile, k0, keep_s(st ^ 1));
    wg_wait_all();
    reg_fence(sT);
    reg_fence(dpT);

    // P^T and dS^T, with the stage's keep tile (sm90.cuh)
    p_ds_transposed<kDrop>(sT, dpT, lse_s, di_s, keep_s(st), drop, q0, key, S,
                           qt == kt || qt == nt - 1, scale_log2);
    uint32_t p_hi[8][4], p_lo[8][4], ds_hi[8][4], ds_lo[8][4];
    to_a_tf32(sT, p_hi, p_lo);
    to_a_tf32(dpT, ds_hi, ds_lo);

    // dV += P^T dO, dK += dS^T Q
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    frag_fence(p_hi);
    frag_fence(p_lo);
    frag_fence(ds_hi);
    frag_fence(ds_lo);
    wg_fence();
    product3_rs(dv_acc, p_hi, p_lo, at(DOT), at(DOT_LO));
    product3_rs(dk_acc, ds_hi, ds_lo, at(QT), at(QT_LO));
    wg_commit();
    wg_wait_all();
    reg_fence(dv_acc);
    reg_fence(dk_acc);
    frag_fence(p_hi);
    frag_fence(p_lo);
    frag_fence(ds_hi);
    frag_fence(ds_lo);
  }

  store_acc(dk_acc, scale, dk, b, h, H, k0, S);
  store_acc(dv_acc, 1.f, dv, b, h, H, k0, S);
}

// K6 ----------------------------------------------------------------------
// The conversion of key tile kt + 1 runs while tile kt's dQ product does:
// K's transposed tiles are double-buffered, the lo tiles free once tile
// kt's score products are done.
template <bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, float* __restrict__ dq,
                         int S, int H, float scale, float scale_log2,
                         ivg::Dropout drop) {
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  auto tile = [&](int i) { return smem + i * kTileBytes; };
  auto at = [&](int i) { return base + i * kTileBytes; };
  enum { Q, Q_LO, DO, DO_LO, RING, K_LO = 8, V_LO, KT };
  auto k_st = [&](int st) { return RING + 2 * st; };      // K's hi
  auto v_st = [&](int st) { return RING + 2 * st + 1; };  // V's hi
  auto kt_st = [&](int st) { return KT + 2 * st; };       // K^T's hi
  auto ktl_st = [&](int st) { return KT + 2 * st + 1; };  // K^T's lo
  const uint32_t bar_q = base + kDqBars;
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
    load_tile(at(Q), &q_map, bar_q, h, q0, b);
    load_tile(at(DO), &do_map, bar_q, h, q0, b);
    for (int n = 0; n < 2 && n <= qt; ++n) {
      mbar_expect_tx(bar_kv(n), 2 * kTileBytes);
      load_tile(at(k_st(n)), &k_map, bar_kv(n), h, n * kTile, b);
      load_tile(at(v_st(n)), &v_map, bar_kv(n), h, n * kTile, b);
    }
  }
  // lse (times log2(e)) and di of this thread's two rows; rows past S read
  // zero Q and dO, so their dS is 0 and they are never stored
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool live = row + 8 * r < S;
    const int64_t idx = static_cast<int64_t>(bh) * S + row + 8 * r;
    lse_r[r] = live ? lse[idx] * kLog2e : 0.f;
    di_r[r] = live ? di[idx] : 0.f;
  }
  if constexpr (kDrop) ivg::draw_keep_tile(drop, head_ctr, S, q0, 0, keep_s(0));
  __syncthreads();
  mbar_wait(bar_q, 0);
  convert_tile<false>(tile(Q), tile(Q_LO), nullptr, nullptr);
  convert_tile<false>(tile(DO), tile(DO_LO), nullptr, nullptr);
  mbar_wait(bar_kv(0), 0);
  convert_tile<true>(tile(k_st(0)), tile(K_LO), tile(kt_st(0)),
                     tile(ktl_st(0)));
  convert_tile<false>(tile(v_st(0)), tile(V_LO), nullptr, nullptr);

  float dq_acc[32];
  zero(dq_acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int st = kt & 1;
    // tile kt's conversion, by every thread, before the products read it
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T, dP = dO V^T
    float s[32], dp[32];
    zero(s);
    zero(dp);
    wg_fence();
    product3_ss(s, at(Q), at(Q_LO), at(k_st(st)), at(K_LO));
    product3_ss(dp, at(DO), at(DO_LO), at(v_st(st)), at(V_LO));
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
    // every warp is past them: stage st's landed tiles take tile kt + 2,
    // the lo tiles take tile kt + 1
    __syncthreads();
    if (threadIdx.x == 0 && kt + 2 <= qt) {
      mbar_expect_tx(bar_kv(st), 2 * kTileBytes);
      load_tile(at(k_st(st)), &k_map, bar_kv(st), h, (kt + 2) * kTile, b);
      load_tile(at(v_st(st)), &v_map, bar_kv(st), h, (kt + 2) * kTile, b);
    }

    // dS = P (dP - di) into s, with the stage's keep tile (sm90.cuh); the
    // diagonal tile holds the causal edge and, on the last query tile, the
    // ragged one
    ds_rows<kDrop>(s, dp, lse_r, di_r, keep_s(st), drop, row, q0, kt * kTile,
                   S, kt == qt, scale_log2);
    uint32_t ds_hi[8][4], ds_lo[8][4];
    to_a_tf32(s, ds_hi, ds_lo);

    // dQ += dS K, running while tile kt + 1 converts (into the other
    // transposed tiles; nothing there writes a register the product owns)
    reg_fence(dq_acc);
    frag_fence(ds_hi);
    frag_fence(ds_lo);
    wg_fence();
    product3_rs(dq_acc, ds_hi, ds_lo, at(kt_st(st)), at(ktl_st(st)));
    wg_commit();
    if (kt < qt) {
      mbar_wait(bar_kv(st ^ 1), ((kt + 1) >> 1) & 1);
      convert_tile<true>(tile(k_st(st ^ 1)), tile(K_LO), tile(kt_st(st ^ 1)),
                         tile(ktl_st(st ^ 1)));
      convert_tile<false>(tile(v_st(st ^ 1)), tile(V_LO), nullptr, nullptr);
    }
    wg_wait_all();
    reg_fence(dq_acc);
    frag_fence(ds_hi);
    frag_fence(ds_lo);
  }

  store_acc(dq_acc, scale, dq, b, h, H, q0, S);
}

// ------------------------------- host --------------------------------------

// The map of an fp32 [B, S, H, 64] tensor read through its batch, sequence
// and head strides st[0..2] (elements; the head dim contiguous): dims
// (64, H, S, B), box (32, 1, 64, 1), 128-byte swizzle, zeros past S.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     const int64_t st[3]) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kHd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 4,
                                 static_cast<cuuint64_t>(st[1]) * 4,
                                 static_cast<cuuint64_t>(st[0]) * 4};
  const cuuint32_t box[4] = {kHalf, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
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

// The maps of q, k, v (the given strides) and dO (contiguous).
cudaError_t make_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                      const void* v, const void* dout, int B, int S, int H,
                      const int64_t (&sts)[3][3]) {
  const int64_t do_st[3] = {static_cast<int64_t>(S) * H * kHd,
                            static_cast<int64_t>(H) * kHd, kHd};
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err =
        make_map(&maps[i], ptrs[i], B, S, H, i < 3 ? sts[i] : do_st);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// q/k/v: fp32 [B, S, H, 64] read through the given batch/sequence/head
// strides (elements), head dim contiguous, base pointers 16-byte aligned and
// strides multiples of 4 (TMA's rule). dout is contiguous fp32 [B, S, H, 64];
// lse (natural log) and di are fp32 [B, H, S]. Outputs are contiguous fp32
// [B, S, H, 64]: o, dk, dv, dq (K4 also writes lse). p_drop in [0, 1) is the
// attention dropout, its mask drawn from (seed, offset) as philox.cuh says,
// at the rows of a shard whose first batch row is b0 and first head h0 of
// Hg heads in all (0, 0, H for a call that holds the whole batch);
// 0 launches the kernels without dropout. Each function encodes its tensor
// maps, launches one kernel on `stream` and returns the first cudaError_t (0
// on success).
extern "C" int ivg_flash_fwd_fp32(const void* q, const void* k, const void* v,
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
  const auto kernel = p_drop > 0.0 ? flash_fwd_tf32_kernel<true>
                                   : flash_fwd_tf32_kernel<false>;
  const int smem = kFwdSmem + (p_drop > 0.0 ? kKeepRing : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H * ((S + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), lse, S, H,
      kScale * kLog2e, ivg::make_dropout(p_drop, seed, offset, S, b0, h0, Hg));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ivg_flash_bwd_dkv_fp32(const void* q, const void* k,
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
  const int64_t sts[3][3] = {
      {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}};
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, q, k, v, dout, B, S, H, sts);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = p_drop > 0.0 ? flash_bwd_dkv_tf32_kernel<true>
                                   : flash_bwd_dkv_tf32_kernel<false>;
  const int smem = kDkvSmem + (p_drop > 0.0 ? kKeepRing : 0);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H * ((S + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, kScale, kScale * kLog2e,
      ivg::make_dropout(p_drop, seed, offset, S, b0, h0, Hg));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ivg_flash_bwd_dq_fp32(const void* q, const void* k,
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
  const int64_t sts[3][3] = {
      {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}};
  CUtensorMap maps[4];
  cudaError_t err = make_maps(maps, q, k, v, dout, B, S, H, sts);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = p_drop > 0.0 ? flash_bwd_dq_tf32_kernel<true>
                                   : flash_bwd_dq_tf32_kernel<false>;
  const int smem = kDqSmem + (p_drop > 0.0 ? kKeepRing : 0);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H * ((S + kTile - 1) / kTile));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], lse, di, static_cast<float*>(dq), S,
      H, kScale, kScale * kLog2e,
      ivg::make_dropout(p_drop, seed, offset, S, b0, h0, Hg));
  return static_cast<int>(cudaGetLastError());
}
