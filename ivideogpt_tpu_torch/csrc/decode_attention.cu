// K3: single-token decode attention over the int8 KV cache, sm_90a.
//
// Replaces ivideogpt_tpu/ops/decode_attention.py::_decode_attn_kernel. For
// one decode step, per (b, h):
//
//   s_m   = (q . K_int8[b, m, h, :]) * ks[b, m, h] * hd^-0.5,  m < valid
//   out   = sum_m softmax(s)_m * vs[b, m, h] * V_int8[b, m, h, :]
//
// over the port's bshd cache [B, M, H, hd] (int8) with bf16 scales
// [B, M, H], both sums in fp32; no dequantised cache is ever written.
//
// Two variants of the same kernel serve the JAX package's other caches:
// - grouped KV heads (a runtime argument of every instance): the cache has
//   Hkv < H heads, [B, M, Hkv, hd] and [B, M, Hkv], and query head h reads
//   KV head h / (H / Hkv). A block fetches each KV head its query heads
//   read once; the cache is never repeated.
// - the "mixed" cache (the instance kKInt8 = false): K in bf16 without
//   scales, V int8 with vs. Its scores are fp32 sums of bf16 q . bf16 K
//   products (q rounded to bf16 nowhere: a fp32 q stays fp32), in place of
//   the int8 digit planes; it reads twice K's bytes, so its bound is
//   bytes as the int8 instance's is.
//
// Bound on the H100: memory. A call must read the live int8 cache and its
// scales once, 2*B*valid*H*(hd + 2) bytes, plus q and out (34.7 MB at B=32,
// H=12, valid=683: 10.4 us at 3.35 TB/s; 305 MB at B=256, valid=751: 91 us),
// for ~4 FLOP a byte.
//
// Design (the TPU kernel walked M tiles in grid order, carrying its flash
// state in VMEM scratch; a Hopper grid runs in no order, so the walk over
// M is cut into splits that run side by side):
//
// - Grid (split, b, head group), one warp a head: a block holds the heads
//   of one batch row (up to kMaxHeads; more go to further head groups) and
//   walks one split of its slots, [split * per, (split + 1) * per) clipped
//   at valid. In the bshd cache those bytes are contiguous: all H heads of
//   a slot are H * 64 bytes of K (768 at H=12) and H * 2 bytes of scales,
//   slot after slot. The split count comes from the wrapper's plan
//   (ops/decode_attention.decode_splits, one block an SM): 4 splits at
//   B=32, 1 at B=256, where the rows alone fill the card. Blocks that hold
//   fewer heads with several warps a head, and with no merge, measured
//   slower at both shapes.
// - Copies: tiles of kTile = 16 slots go through a kStages = 3 ring in
//   shared memory, filled by TMA bulk copies (cp.async.bulk, completing on
//   one mbarrier a stage) that warp 0 issues: K and V of the tile's live
//   slots one copy each (n * H * 64 contiguous bytes; a slot row a copy in
//   a head group), and the K and V scales of those slots, one contiguous
//   run of n * H * 2 bytes each, in the 16-byte chunks around it. Two
//   tiles are in flight while one is computed; one block barrier a tile
//   frees the ring's oldest stage. 1-D bulk copies need no tensor map
//   (a tensor-mapped 3-D box per head group measured slower), and they
//   move more bytes an SM than 16-byte cp.async copies did. Only live
//   slots are fetched.
// - Compute: a warp's 32 lanes are 8 quads; a quad takes 2 slots of a
//   tile, each lane 16 of the 64 dims. q . K in integers: q is cut once a
//   block into three signed int8 digit planes under a power-of-two scale
//   (exact for a bf16 q, 22 bits of an fp32 one), dp4a sums each plane
//   against the int8 K exactly, the planes combine in fp32, and two
//   shuffles sum the quad. Each quad keeps its own online softmax (running
//   max and denominator, base 2, the scales folded in) and its lanes 16
//   fp32 partial sums of P . V; V's int8 becomes fp32 by a byte permute
//   onto the bits of 2^23 and one subtraction (exact), not the I2F unit.
// - Merge, inside the one launch: the 8 quads merge by the lse rule over a
//   shuffle butterfly. With one split the block writes out directly. With
//   more, it writes its (max, denominator, 64 sums) a head into the
//   workspace partials [B*H, splits, 66] and counts its arrival on the
//   row's counter with one acquire-release add; the block that arrives
//   last merges all splits of its heads from the workspace in split order
//   (loads for up to 8 splits in flight at once) and resets the counter to
//   0. The order never depends on which block is last, so two launches
//   give the same bits. A split that starts at or past valid streams
//   nothing, writes an empty state (max -inf) and counts.
// - valid comes from a host int or from an int32 on the device (a CUDA
//   graph can then replay one capture at every length); the grid depends
//   on B, H and M only. A valid outside [1, M] traps.
//
// Bytes fetched for each byte the bound counts: K and V exactly (live slots
// only); the scales in 16-byte chunks around each tile's run of 16 * 24
// bytes (whole chunks at the rollouts' shapes, where every run starts
// 16-byte aligned); q once a split (4 x 49 KB at B=32). At B=256 (one
// split) 1.000, at B=32 1.004, plus the partials' round trip through L2 at
// B=32 (B * H * splits * 264 bytes written and read: 0.4 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHd = 64;
constexpr int kQuads = 8;             // 4-lane slot groups a warp
constexpr int kSpq = 2;               // slots a quad takes from a tile
constexpr int kTile = kQuads * kSpq;  // slots a tile
constexpr int kStages = 3;            // ring depth, in tiles
constexpr int kMaxHeads = 12;         // heads (warps) a block
constexpr int kPartial = kHd + 2;     // max, denominator, 64 sums
constexpr int kMergeChunk = 8;        // splits a merge step loads at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMagic = 8388736.0f;  // 2^23 + 128

// Byte offsets of one ring stage: K rows, V rows, K scales (int8 K only),
// V scales.
struct Stage {
  int kp, vp;   // bytes between slot rows of K and of V (a block's Gkv
                // KV heads)
  int v_at;     // the V tile (after the K tile)
  int sc;       // one scale run (all Hkv heads), with 16 bytes of slack
  int ks_at;    // the K scales' run
  int vs_at;    // the V scales' run
  int bytes;    // the stage
};

__host__ __device__ inline Stage stage_of(int Gkv, int Hkv, bool k_int8) {
  Stage s;
  s.vp = Gkv * kHd;
  s.kp = k_int8 ? s.vp : 2 * s.vp;
  s.v_at = kTile * s.kp;
  s.sc = ((kTile * Hkv * 2 + 15) / 16 + 1) * 16;
  s.ks_at = s.v_at + kTile * s.vp;
  s.vs_at = s.ks_at + (k_int8 ? s.sc : 0);
  s.bytes = s.vs_at + s.sc;
  return s;
}

// The KV heads [kv0, kv0 + n) that query heads [h0, h0 + gh) read.
__host__ __device__ inline int kv_first(int h0, int rep) { return h0 / rep; }
__host__ __device__ inline int kv_count(int h0, int gh, int rep) {
  return (h0 + gh - 1) / rep - h0 / rep + 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Returns once the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy (no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on the mbarrier at bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// q[16] of one lane: 16 consecutive values from p.
__device__ __forceinline__ void load16(const float* p, float* r) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 w = reinterpret_cast<const float4*>(p)[i];
    r[4 * i] = w.x, r[4 * i + 1] = w.y, r[4 * i + 2] = w.z,
    r[4 * i + 3] = w.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* r) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      r[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float* r) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* r) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(r[8 * i + 2 * j], r[8 * i + 2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&h);
    }
    reinterpret_cast<uint4*>(p)[i] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The 16 int8 values of w as exact floats: byte ^ 0x80 = value + 128 goes
// into the low mantissa bits of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ void int8x16(const uint4 w, float* f) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * j + i] =
          __uint_as_float(__byte_perm(u[j], 0x4B000000u, 0x7440u | i)) -
          kMagic;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Folds state (mo, lo, ao) into (m, l, a) by the lse rule; an empty state
// has max -inf and weighs nothing.
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float mo,
                                      float lo, const float* ao) {
  const float mm = fmaxf(m, mo);
  const float base = mm == -CUDART_INF_F ? 0.f : mm;  // both empty
  const float c = ex2(m - base), co = ex2(mo - base);
  l = l * c + lo * co;
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = a[i] * c + ao[i] * co;
  m = mm;
}

// kKInt8: K int8 with ks (the int8 cache), else bf16 K without ks (the
// "mixed" cache).
template <typename T, bool kKInt8>
__global__ void __launch_bounds__(kMaxHeads * 32, 2)
decode_attn_kernel(const T* __restrict__ q, const void* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ ks,
                   const int8_t* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ vs, T* __restrict__ out,
                   float* __restrict__ partials, int* __restrict__ counters,
                   int M, int H, int Hkv, int G, int Gkv, int per,
                   const int* valid_dev, int valid_host, float scale_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  __shared__ int last_s;

  const int valid = valid_dev != nullptr ? *valid_dev : valid_host;
  if (valid < 1 || valid > M) __trap();

  const Stage S = stage_of(Gkv, Hkv, kKInt8);
  constexpr int kKb = kKInt8 ? 1 : 2;  // bytes of a K value
  const int rep = H / Hkv;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, splits = gridDim.x;
  const int b = blockIdx.y, group = blockIdx.z;
  const int h0 = group * G;
  const int gh = min(G, H - h0);  // heads of this block
  const int warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, part = lane & 3;
  const bool has_head = warp < gh;
  // a warp past the last head computes on head h0's bytes and stores
  // nothing, so every warp runs the same code
  const int hw = has_head ? warp : 0;
  const int h = h0 + hw;
  const int kv0 = kv_first(h0, rep);
  const int gkv = kv_count(h0, gh, rep);  // KV heads of this block
  const int hk = h / rep;                 // this warp's KV head

  const int s_begin = split * per;
  const int s_end = min(s_begin + per, valid);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kTile - 1) / kTile
                                      : 0;
  const int64_t row_base = static_cast<int64_t>(b) * M + s_begin;
  const int64_t bh = static_cast<int64_t>(b) * H + h;

  // This block's state for head h, quad by quad: a running max and
  // denominator (base 2) and, a lane, 16 dims of the P . V sums.
  float m_run = -CUDART_INF_F, l_run = 0.f;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  // A split at or past valid streams nothing: it keeps the empty state and
  // only writes it and counts its arrival below.
  if (n_tiles > 0) {
    // Copies, by warp 0, as TMA bulk copies (no tensor map) completing on
    // the stage's mbarrier: the tile's live slot rows of K and of V, one
    // copy each where the block reads every KV head (the rows are then one
    // run of n * Hkv * 64 values), else one a slot row (gkv * 64 values);
    // and the scales of the tile's slots (all Hkv heads, one run each of
    // ks, where K is int8, and vs) in the 16-byte chunks around it.
    const uint32_t bar0 = smem_u32(&bars[0]);
    const uint32_t k_row = gkv * kHd * kKb, v_row = gkv * kHd;
    const uint8_t* kblk = static_cast<const uint8_t*>(kc) +
                          (row_base * Hkv + kv0) * kHd * kKb;
    const int8_t* vblk = vc + (row_base * Hkv + kv0) * kHd;
    const int64_t sc_start = row_base * Hkv * 2;  // bytes
    const int sc_off = static_cast<int>(sc_start & 15);
    const int64_t sc_total = static_cast<int64_t>(gridDim.y) * M * Hkv * 2;

    auto issue = [&](int t) {
      uint8_t* st = smem + (t % kStages) * S.bytes;
      const uint32_t bar = bar0 + (t % kStages) * 8;
      const int n = min(kTile, s_end - s_begin - t * kTile);
      const int64_t slot0 = static_cast<int64_t>(t) * kTile;  // in the split
      // kTile * Hkv * 2 is a multiple of 16: every tile's run starts sc_off
      // into its first chunk
      const int64_t at = sc_start - sc_off + slot0 * Hkv * 2;
      const uint32_t sc_bytes = (sc_off + n * Hkv * 2 + 15) & ~15;
      // the chunks stay inside the scale tensors but at their very end
      const bool sc_bulk = at + sc_bytes <= sc_total;
      if (lane == 0)
        mbar_expect_tx(bar, n * (k_row + v_row) +
                                (sc_bulk ? (kKInt8 ? 2 : 1) * sc_bytes : 0));
      __syncwarp();
      if (gkv == Hkv) {
        if (lane == 0)
          bulk_load(smem_u32(st), kblk + slot0 * Hkv * kHd * kKb, n * k_row,
                    bar);
        if (lane == 1)
          bulk_load(smem_u32(st + S.v_at), vblk + slot0 * Hkv * kHd,
                    n * v_row, bar);
      } else if (lane < n) {
        const int64_t src = (slot0 + lane) * Hkv * kHd;
        bulk_load(smem_u32(st + lane * S.kp), kblk + src * kKb, k_row, bar);
        bulk_load(smem_u32(st + S.v_at + lane * S.vp), vblk + src, v_row,
                  bar);
      }
      const uint8_t* ksb = reinterpret_cast<const uint8_t*>(ks);
      const uint8_t* vsb = reinterpret_cast<const uint8_t*>(vs);
      if (sc_bulk) {
        if (kKInt8 && lane == 2)
          bulk_load(smem_u32(st + S.ks_at), ksb + at, sc_bytes, bar);
        if (lane == 3)
          bulk_load(smem_u32(st + S.vs_at), vsb + at, sc_bytes, bar);
      } else {  // plain copies of the run itself, done before the barrier
        const int64_t e0 = (row_base + slot0) * Hkv;
        __nv_bfloat16* kd =
            reinterpret_cast<__nv_bfloat16*>(st + S.ks_at + sc_off);
        __nv_bfloat16* vd =
            reinterpret_cast<__nv_bfloat16*>(st + S.vs_at + sc_off);
        for (int e = lane; e < n * Hkv; e += 32) {
          if (kKInt8) kd[e] = ks[e0 + e];
          vd[e] = vs[e0 + e];
        }
      }
    };

    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bar0 + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0)
      for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) issue(t);

    // int8 K: q . K exactly in integers: q = 2^(e - 22) * Q, Q an int32
    // (|Q| <= 2^22) cut into three signed int8 digits (Q = 2^16 D2 + 2^8
    // D1 + D0, each packed four dims a word as the cache packs K), so that
    // dp4a sums each digit plane against the int8 K exactly and the planes
    // combine in fp32. e bounds the head's |q|: Q keeps every bit of a
    // bf16 q within 2^14 of the largest, and 22 bits of an fp32 one.
    // bf16 K: q stays in fp32 and the lane's 16 products sum by fmaf.
    uint32_t qd[3][4];
    float qr[16];
    float q_scale = scale_log2;
    load16(q + bh * kHd + part * 16, qr);
    if (kKInt8) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(qr[i]));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      // amax < 2^e; tiny heads keep e >= -100 so 2^(22 - e) stays finite
      const int e = max(
          static_cast<int>((__float_as_uint(amax) >> 23) & 255) - 126, -100);
      const float up =
          __uint_as_float(static_cast<uint32_t>(127 + 22 - e) << 23);
      q_scale = __uint_as_float(static_cast<uint32_t>(127 - 22 + e) << 23) *
                scale_log2;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        uint32_t d[3] = {0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int v = __float2int_rn(qr[4 * w + i] * up);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const int digit = ((v + 128) & 255) - 128;
            d[p] |= static_cast<uint32_t>(digit & 255) << (8 * i);
            v = (v - digit) >> 8;
          }
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) qd[p][w] = d[p];
      }
    }

    // Reads, fixed for the whole walk: slot quad + 8 j of a tile, dims
    // part * 16 .. + 15 of KV head hk; its scales.
    const int k_at = quad * S.kp + ((hk - kv0) * kHd + part * 16) * kKb;
    const int v_at = S.v_at + quad * S.vp + (hk - kv0) * kHd + part * 16;
    const int sc_at = sc_off + (quad * Hkv + hk) * 2;

    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(bar0 + (t % kStages) * 8, (t / kStages) & 1);
      __syncthreads();  // tile t has landed; tile t - 1's stage is free
      if (warp == 0 && t + kStages - 1 < n_tiles) issue(t + kStages - 1);

      const uint8_t* st = smem + (t % kStages) * S.bytes;
      const int n = min(kTile, s_end - s_begin - t * kTile);
      float s[kSpq];
#pragma unroll
      for (int j = 0; j < kSpq; ++j) {
        const uint8_t* kp = st + k_at + j * kQuads * S.kp;
        float d;
        if (kKInt8) {
          const uint4 w = *reinterpret_cast<const uint4*>(kp);
          const int kw[4] = {static_cast<int>(w.x), static_cast<int>(w.y),
                             static_cast<int>(w.z), static_cast<int>(w.w)};
          int a[3] = {0, 0, 0};
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              a[p] = __dp4a(kw[x], static_cast<int>(qd[p][x]), a[p]);
          d = fmaf(static_cast<float>(a[2]), 65536.f,
                   fmaf(static_cast<float>(a[1]), 256.f,
                        static_cast<float>(a[0])));
        } else {
          d = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint4 w = reinterpret_cast<const uint4*>(kp)[half];
            const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              d = fmaf(qr[8 * half + 2 * i], __uint_as_float(u[i] << 16), d);
              d = fmaf(qr[8 * half + 2 * i + 1],
                       __uint_as_float(u[i] & 0xffff0000u), d);
            }
          }
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        const float ksc =
            kKInt8 ? __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
                         st + S.ks_at + sc_at + j * kQuads * Hkv * 2))
                   : 1.f;
        s[j] = quad + kQuads * j < n ? d * ksc * q_scale : -CUDART_INF_F;
      }
      float m_new = m_run;
#pragma unroll
      for (int j = 0; j < kSpq; ++j) m_new = fmaxf(m_new, s[j]);
      // no live slot yet for this quad: every weight below is 2^-inf = 0
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = ex2(m_run - base);
      l_run *= alpha;
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kSpq; ++j) {
        const float p = ex2(s[j] - base);
        l_run += p;
        const float vsc = __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(
                st + S.vs_at + sc_at + j * kQuads * Hkv * 2));
        const float wv = quad + kQuads * j < n ? p * vsc : 0.f;
        const uint4 w = *reinterpret_cast<const uint4*>(
            st + v_at + j * kQuads * S.vp);
        float f[16];
        int8x16(w, f);
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = fmaf(wv, f[i], acc[i]);
      }
      m_run = m_new;
    }

    // The 8 quads' states into one (every quad ends with it).
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      float ao[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        ao[i] = __shfl_xor_sync(0xffffffffu, acc[i], off);
      const float mo = __shfl_xor_sync(0xffffffffu, m_run, off);
      const float lo = __shfl_xor_sync(0xffffffffu, l_run, off);
      merge<16>(m_run, l_run, acc, mo, lo, ao);
    }
  }

  if (splits == 1) {
    if (has_head && quad == 0) {
      const float inv = 1.f / l_run;  // l >= 1: the max slot adds 2^0
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] *= inv;
      store16(out + bh * kHd + part * 16, acc);
    }
    return;
  }

  if (has_head && quad == 0) {
    float* p = partials + (bh * splits + split) * kPartial;
    if (part == 0) p[0] = m_run, p[1] = l_run;
#pragma unroll
    for (int i = 0; i < 16; ++i) p[2 + part * 16 + i] = acc[i];
  }
  // Arrival: after the barrier, one acquire-release add publishes the
  // block's partials (release, cumulative over the barrier) and, in the
  // last block, orders its reads of the others' after their adds.
  int* counter = counters + static_cast<int64_t>(b) * gridDim.z + group;
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(counter)
                 : "memory");
    last_s = prev == splits - 1;
  }
  __syncthreads();
  if (!last_s) return;

  // The last block of the row: every split of its heads, in split order,
  // kMergeChunk splits' loads in flight at a time (lane i also loads split
  // i's max for the common max, so up to kMergeChunk splits take one round
  // trip to L2).
  if (has_head) {
    const float* p = partials + bh * splits * kPartial;
    float mi[kMergeChunk], li[kMergeChunk], o0[kMergeChunk], o1[kMergeChunk];
    auto load = [&](int i0) {
#pragma unroll
      for (int k = 0; k < kMergeChunk; ++k) {
        const bool in = i0 + k < splits;
        const float* pi = p + (in ? i0 + k : 0) * kPartial;
        mi[k] = in ? __ldcg(pi) : -CUDART_INF_F;
        li[k] = __ldcg(pi + 1);
        o0[k] = __ldcg(pi + 2 + lane);
        o1[k] = __ldcg(pi + 2 + 32 + lane);
      }
    };
    load(0);
    float m = -CUDART_INF_F;
    for (int i = lane; i < splits; i += 32)
      m = fmaxf(m, __ldcg(p + i * kPartial));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f, out0 = 0.f, out1 = 0.f;
    for (int i0 = 0;;) {
#pragma unroll
      for (int k = 0; k < kMergeChunk; ++k) {
        // an empty split or none (max -inf) weighs 0; its sums are unread
        const bool w = mi[k] != -CUDART_INF_F;
        const float c = w ? ex2(mi[k] - m) : 0.f;
        l = fmaf(w ? li[k] : 0.f, c, l);
        out0 = fmaf(w ? o0[k] : 0.f, c, out0);
        out1 = fmaf(w ? o1[k] : 0.f, c, out1);
      }
      i0 += kMergeChunk;
      if (i0 >= splits) break;
      load(i0);
    }
    store1(out + bh * kHd + lane, out0 / l);
    store1(out + bh * kHd + 32 + lane, out1 / l);
  }
  if (tid == 0) *counter = 0;
}

template <typename T, bool kKInt8>
int launch(const void* q, const void* k, const void* ks, const int8_t* v,
           const void* vs, void* out, float* partials, int* counters, int B,
           int M, int H, int Hkv, int splits, int per, const int* valid_dev,
           int valid_host, cudaStream_t stream) {
  const int groups = (H + kMaxHeads - 1) / kMaxHeads;
  const int G = (H + groups - 1) / groups;
  int Gkv = 0;  // the most KV heads a head group reads
  for (int h0 = 0; h0 < H; h0 += G)
    Gkv = max(Gkv, kv_count(h0, min(G, H - h0), H / Hkv));
  const int smem = kStages * stage_of(Gkv, Hkv, kKInt8).bytes;
  static int raised[64] = {};  // dynamic shared memory allowed, by device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || smem > raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, kKInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) raised[dev] = smem;
  }
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(kHd));
  decode_attn_kernel<T, kKInt8>
      <<<dim3(splits, B, groups), G * 32, smem, stream>>>(
          static_cast<const T*>(q), k, static_cast<const __nv_bfloat16*>(ks),
          v, static_cast<const __nv_bfloat16*>(vs), static_cast<T*>(out),
          partials, counters, M, H, Hkv, G, Gkv, per, valid_dev, valid_host,
          scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out [B, H, 64] in bf16 (q_is_bf16=1) or fp32; k [B, M, Hkv, 64] int8
// with ks [B, M, Hkv] bf16 (k_is_int8=1), or bf16 with ks null; v
// [B, M, Hkv, 64] int8, vs [B, M, Hkv] bf16; H a multiple of Hkv (query
// head h reads KV head h / (H / Hkv)); all contiguous and 16-byte aligned.
// A block holds the heads of a batch row (ceil(H / 12) groups of them
// where H > 12); the slots are cut into `splits` runs of `per` (splits *
// per >= M). With splits > 1, partials holds B*H*splits*66 floats and
// counters B*ceil(H/12) int32 zeros, left zero by the call. valid:
// *valid_dev when valid_dev is not null (an int32 on the device, trapping
// outside [1, M]), else valid_host. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int ivg_decode_attention(const void* q, const void* k,
                                    const void* ks, const int8_t* v,
                                    const void* vs, void* out,
                                    float* partials, int* counters, int B,
                                    int M, int H, int Hkv, int hd, int splits,
                                    int per, const int* valid_dev,
                                    int valid_host, int q_is_bf16,
                                    int k_is_int8, void* stream) {
  if (hd != kHd || B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 ||
      splits < 1 || per < 1 || static_cast<int64_t>(splits) * per < M ||
      (splits > 1 && (partials == nullptr || counters == nullptr)) ||
      (k_is_int8 && ks == nullptr) ||
      (valid_dev == nullptr && (valid_host < 1 || valid_host > M)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto q_type, auto k_int8) {
    using T = decltype(q_type);
    return launch<T, decltype(k_int8)::value>(
        q, k, ks, v, vs, out, partials, counters, B, M, H, Hkv, splits, per,
        valid_dev, valid_host, s);
  };
  using Int8K = std::integral_constant<bool, true>;
  using Bf16K = std::integral_constant<bool, false>;
  if (q_is_bf16)
    return k_is_int8 ? go(__nv_bfloat16{}, Int8K{})
                     : go(__nv_bfloat16{}, Bf16K{});
  return k_is_int8 ? go(0.f, Int8K{}) : go(0.f, Bf16K{});
}

// The heads a block holds: the wrapper's head groups must count as these.
extern "C" int ivg_decode_attention_max_heads() { return kMaxHeads; }
