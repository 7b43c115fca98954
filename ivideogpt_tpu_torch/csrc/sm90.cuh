// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, 4-D TMA tile loads, wgmma descriptors of 128-byte-swizzled
// K-major tiles, the wgmma fences, K4's online softmax, the reading of the
// dropout keep tile (K4's P, the backward's P and dS), and the host's
// cuTensorMapEncodeTiled.
// flash_attention_sm90.cu (bf16 K4, K5, K6) and flash_attention_tf32.cu
// (fp32 K4, K5, K6) include it.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace ivg {
namespace sm90 {

// The 128-byte swizzle repeats every 8 rows of 128 bytes: tiles start on
// this boundary, and it is the stride between 8-row groups of a tile.
constexpr int kSwizzleAtom = 1024;

constexpr float kLn2 = 0.6931471805599453f;

// ------------------------- mbarriers and TMA -------------------------------

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

// The box at (d0, h, row0, b) of a 4-D tensor map over (head dim, H, S, B)
// into shared memory at dst (swizzled as the map says), completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int h, int row0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h),
      "r"(row0), "r"(b)
      : "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads and
// writes by the async proxy (wgmma operands, TMA); a barrier then publishes
// them to the other threads' wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------ wgmma --------------------------------------

// Descriptor of a K-major operand tile of 128-byte rows written with the
// 128-byte swizzle (by TMA or by the same XOR by hand): 8-row atoms of
// 1024 B (stride byte offset 1024), layout type 1 (128B swizzle); the
// leading byte offset is unused for these shapes. A k-step of 32 bytes
// (16 bf16 or 8 tf32 values) adds 2 to the descriptor.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kSwizzleAtom >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define IVG_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define IVG_D32_OPS(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// ------------------------- the m64n64 accumulator --------------------------
//
// Warp w, lane = 4 g + t of the warpgroup holds d[4 j + e] at row
// 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1), whatever the input type.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------ K4's online softmax (bf16 and fp32) --------------------

// Score tile k0 of this thread's rows row and row + 8 (r = (i >> 1) & 1),
// in log2 units: masks keys past the row and at or past S (tested only
// where diag: the diagonal tile, on the last query tile also the ragged
// one), raises the running max m (of s * scale_log2), rescales the running
// sum l and the output accumulator acc by exp2(m_old - m_new), and turns s
// into P = exp2(s * scale_log2 - m) summed into l (the undropped P). Every
// row sees a live key in every tile (key 0 .. or its own), so m is finite
// from the first tile on, and the rescale is 0 there.
__device__ __forceinline__ void softmax_rows(float (&s)[32], float (&acc)[32],
                                             float (&m)[2], float (&l)[2],
                                             int row, int k0, int S,
                                             bool diag, float scale_log2) {
  const int t = threadIdx.x & 3;
  if (diag) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col > row + 8 * ((i >> 1) & 1) || col >= S) s[i] = -CUDART_INF_F;
    }
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2], neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale_log2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale_log2, neg_m[r]));
    l[r] += s[i];
    acc[i] *= alpha[r];
  }
}

// K4's end for rows row and row + 8 of head row lse_h (lse_h[i] = query
// i's): the row sums l gathered from the quad, lse = (m + log2 l) ln 2 (the
// natural log, as K6 and the backward read it) written for rows below S;
// returns 1 / l, the rows' output scale.
__device__ __forceinline__ void finish_rows(float (&l)[2], const float (&m)[2],
                                            float* lse_h, int row, int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if ((threadIdx.x & 3) == 0 && row + 8 * r < S)
      lse_h[row + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
    l[r] = 1.f / l[r];
  }
}

// ------------- P and dS with the keep tile (ivg::draw_keep_tile) ----------
//
// Both K4s, both K5s and both K6s (bf16 and fp32) read the keep tile here,
// so its layout is read in one place.

// x, a row-layout accumulator over key tile k0 (rows this thread's row and
// row + 8, r = (i >> 1) & 1; keys k0 + 8 jj + 2 t + e at x[4 jj + 2 r + e]),
// times Z / keep in place: x scale where kept, 0 where dropped. A row's 16
// keys are bits 8 (jj & 3) + 2 t + e of its two words 2 (row - q0) + 16 r +
// (jj >> 2) in the (q0, k0) keep tile, 4 loads. K4 applies it to P after
// the row sums (lse is of the undropped P), K6 to dP.
__device__ __forceinline__ void drop_rows(float (&x)[32], const uint32_t* keep,
                                          const Dropout& drop, int row,
                                          int q0) {
  const int t = threadIdx.x & 3;
  const uint32_t* keep_t = keep + 2 * (row - q0);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t kept = keep_t[16 * r + half] >> (2 * t);
#pragma unroll
      for (int jj = 4 * half; jj < 4 * half + 4; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = x[4 * jj + 2 * r + e];
          v = (kept >> (8 * (jj & 3) + e)) & 1u ? v * drop.scale : 0.f;
        }
    }
}

// K5: sT = K Q^T and dpT = V dO^T of key tile k0 and query tile q0, rows
// this thread's keys (key and key + 8), columns queries q0 + c. In place,
// P^T = exp(s - lse) and dS^T = P^T (dP^T - di), P^T zero where the query
// lies before the key or at or past S (tested only where edge). With
// dropout, P^T Z / keep and dS^T = P^T (dP^T Z / keep - di), Z of (query
// q0 + c, key key or key + 8): bits key - k0 and key - k0 + 8 of word
// 2 c + warp / 2 of the (q0, k0) keep tile, one 32-bit load for both.
// lse[c] is the query's lse times log2(e), di[c] its di.
template <bool kDrop>
__device__ __forceinline__ void p_ds_transposed(
    float (&sT)[32], float (&dpT)[32], const float* lse, const float* di,
    const uint32_t* keep, const Dropout& drop, int q0, int key, int S,
    bool edge, float scale_log2) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* keep_t = keep + (threadIdx.x >> 6);
  const int key_bit = 16 * ((threadIdx.x >> 5) & 1) + g;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i >> 2) + 2 * t + (i & 1);
    float p = ex2(fmaf(sT[i], scale_log2, -lse[c]));
    if (edge && (q0 + c < key + 8 * ((i >> 1) & 1) || q0 + c >= S)) p = 0.f;
    if constexpr (kDrop) {
      const uint32_t kept = keep_t[2 * c] >> (key_bit + 8 * ((i >> 1) & 1));
      const float z = (kept & 1u) ? drop.scale : 0.f;
      sT[i] = p * z;
      dpT[i] = p * (dpT[i] * z - di[c]);
    } else {
      sT[i] = p;
      dpT[i] = p * (dpT[i] - di[c]);
    }
  }
}

// K6: s = Q K^T and dp = dO V^T of query tile q0 and key tile k0, rows this
// thread's row and row + 8 (lse_r: their lse times log2(e); di_r: their
// di). In place, s = dS = P (dP - di), P = exp(s - lse) zero past the
// causal edge and at or past S (tested only where diag). With dropout,
// dS = P (dP Z / keep - di), dP Z / keep by drop_rows.
template <bool kDrop>
__device__ __forceinline__ void ds_rows(float (&s)[32], float (&dp)[32],
                                        const float (&lse_r)[2],
                                        const float (&di_r)[2],
                                        const uint32_t* keep,
                                        const Dropout& drop, int row, int q0,
                                        int k0, int S, bool diag,
                                        float scale_log2) {
  const int t = threadIdx.x & 3;
  if constexpr (kDrop) drop_rows(dp, keep, drop, row, q0);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(s[i], scale_log2, -lse_r[r]));
    if (diag) {
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col > row + 8 * r || col >= S) p = 0.f;
    }
    s[i] = p * (dp[i] - di_r[r]);
  }
}

// Shared memory rounded up to kSwizzleAtom: (generic pointer, shared
// address).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw,
                                                 uint32_t* addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(raw));
  const uint32_t up = (a + kSwizzleAtom - 1) &
                      ~static_cast<uint32_t>(kSwizzleAtom - 1);
  *addr = up;
  return raw + (up - a);
}

// ------------------------------- host --------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library needs no -lcuda.
inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

}  // namespace sm90
}  // namespace ivg
