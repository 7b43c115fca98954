// K4: causal flash attention forward on fp32 inputs, sm_90a, in fp32 FMA
// tile products: the C entry point and kernel of the fp32 prefills (predict,
// VP2) and of the fp32 training forward.
//
// Replaces, for fp32 q/k/v, the stock TPU kernel that the JAX package calls
// at ivideogpt_tpu/models/llama.py:97 (jax/experimental/pallas/ops/tpu/
// flash_attention.py, JAX 0.9.0):
//   K4  _flash_attention_kernel      :331 (launched :758)
// The fp32 K5 and K6 (dK/dV, dQ) are the TF32 wgmma kernels of
// flash_attention_tf32.cu; the bf16 K4, K5 and K6 are the TMA-fed wgmma
// kernels of flash_attention_sm90.cu. Each file is a library of its own.
//
// For one (b, h), with s = q.k * hd^-0.5 and keys j <= query i only:
//   O = softmax(s) V, and lse_i = log sum_j exp(s_ij)  (fp32)
//
// Layout: q/k/v are read in the port's bshd layout [B, S, H, 64] through
// their batch, sequence and head strides (the head dim is contiguous); O is
// written contiguous [B, S, H, 64] and lse fp32 [B, H, S]. No transpose to
// [B, H, S, hd] and no padding of S to a tile multiple as on the TPU
// (llama.py:88-99): rows at or past S read as 0 and the ragged last tile is
// masked. hd = 64, 1 <= S <= 1024.
//
// Bound on the H100: its FLOP (4 hd per causal pair) over 67 TFLOP/s, the
// fp32 FMA rate it runs at; fp32-accurate products on the tensor cores
// (three TF32 products each, as flash_attention_tf32.cu runs them) would be
// bounded at 165 TFLOP/s (ROADMAP Queue 2).
//
// Design. One block per 64-query tile of one (b, h), heaviest first
// (blockIdx.y); it loops over key tiles up to the diagonal with an fp32
// online softmax (running max m, sum l). The tiles are 64 x 64 x 64
// products in fp32 FMAs, so fp32 inputs are never rounded to bf16 or TF32.
// 256 threads, fp32 tiles in shared memory with a row stride of 65 floats
// (a row walk and a column walk both free of bank conflicts); each thread
// owns a 4 x 4 piece of every result (rows ty + 16 i, columns tx + 16 j),
// and a row's 16 owners are one half warp, so row max and row sum are
// shuffles.
//
// Attention dropout (p_drop > 0): the kernel is a template on kDrop, and
// p_drop == 0 launches the kDrop = false instance, the code above
// unchanged. With dropout it sums the undropped P into l (lse) and stores
// P Z / keep for the P V product, Z the mask of philox.cuh for (b, h,
// query i, key j): one Philox call per element, since a thread's columns
// tx + 16 j are in different groups of four keys.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kHd = 64;    // head dim = the inner dim of every product
constexpr int kTile = 64;  // rows of a query tile and of a key tile
constexpr int kMaxS = 1024;

struct Strides {
  int64_t b, s, h;  // in elements; the head dim has stride 1
};

// ======================= fp32: FMA tile products ==========================

constexpr int kLd = kHd + 1;   // shared-memory row stride, in floats
constexpr int kTileFloats = kTile * kLd;
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 piece each

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + 64) of one (b, h) of a [B, S, H, 64] tensor into
// dst[64][kLd]; rows at or past S read as 0. Neighbouring threads read
// neighbouring elements of a row.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          Strides st, int64_t b, int64_t h,
                                          int row0, int S) {
  const float* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * kHd; i += kThreads) {
    const int r = i / kHd;
    const int d = i % kHd;
    const int row = row0 + r;
    dst[r * kLd + d] =
        row < S ? base[static_cast<int64_t>(row) * st.s + d] : 0.f;
  }
}

// acc[i][j] += sum_{k < 64} A(k, ty + 16 i) * B(k, tx + 16 j), where
// A(k, m) = a[k * AK + m * AM] and B(k, n) = b[k * BK + n * BN] in shared
// memory. Within a warp the A reads hit 2 addresses (a broadcast) and the B
// reads 16 distinct banks, for either stride order, because kLd is odd.
template <int AK, int AM, int BK, int BN>
__device__ __forceinline__ void tile_product(const float* a, const float* b,
                                             float acc[4][4], int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < kHd; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[k * AK + (ty + 16 * i) * AM];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * BK + (tx + 16 * j) * BN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float x[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
}

// Writes this thread's 4 x 4 piece of a [64 rows, 64] tile starting at row0
// into a contiguous [B, S, H, 64] output, times `mul`; rows past S skipped.
__device__ __forceinline__ void store_tile(float* out, const float x[4][4],
                                           float mul, int64_t b, int64_t h,
                                           int H, int row0, int S, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
    float* p = out + ((b * S + row) * H + h) * kHd;
#pragma unroll
    for (int j = 0; j < 4; ++j) p[tx + 16 * j] = x[i][j] * mul;
  }
}

// K4, fp32 ----------------------------------------------------------------
template <bool kDrop>
__global__ void __launch_bounds__(kThreads)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides qs, Strides ks,
                      Strides vs, int S, int H, float scale,
                      ivg::Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;                // [query][d]
  float* k_s = q_s + kTileFloats;   // [key][d]
  float* v_s = k_s + kTileFloats;   // [key][e]
  float* p_s = v_s + kTileFloats;   // [query][key]

  const int nt = (S + kTile - 1) / kTile;
  const int qt = nt - 1 - static_cast<int>(blockIdx.y);
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int q0 = qt * kTile;

  load_tile(q_s, q, qs, b, h, q0, S);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  zero(acc);

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's reads of k_s, v_s, p_s are done
    load_tile(k_s, k, ks, b, h, k0, S);
    load_tile(v_s, v, vs, b, h, k0, S);
    __syncthreads();

    float s[4][4];
    zero(s);
    tile_product<1, kLd, 1, kLd>(q_s, k_s, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = (col <= row && col < S) ? s[i][j] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = expf(m[i] - base);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
      if constexpr (kDrop) {
        const uint64_t rctr = ivg::row_counter(drop, bh * S + row);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] *= ivg::keep_scale(drop, rctr, k0 + tx + 16 * j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= alpha;
        p_s[(ty + 16 * i) * kLd + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();
    // O[query][e] += sum_key P[query][key] V[key][e]
    tile_product<1, kLd, kLd, 1>(p_s, v_s, acc, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= inv;
    if (tx == 0 && row < S) lse[bh * S + row] = m[i] + logf(l[i]);
  }
  store_tile(o, acc, 1.f, b, h, H, q0, S, ty, tx);
}

constexpr int kFwdSmem = 4 * kTileFloats * 4;

// ============================== launches ==================================

bool bad_shape(int B, int S, int H, int hd) {
  return hd != kHd || B < 1 || H < 1 || S < 1 || S > kMaxS;
}

bool bad_dropout(double p_drop) { return !(p_drop >= 0.0 && p_drop < 1.0); }

float softmax_scale() { return 1.0f / sqrtf(static_cast<float>(kHd)); }

dim3 grid(int B, int S, int H) {
  return dim3(B * H, (S + kTile - 1) / kTile);
}

// The kernel takes more than 48 KB of shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// q/k/v: fp32 [B, S, H, 64] (flash_attention_sm90.cu takes bf16 with the
// same arguments), read through the given batch/sequence/head strides
// (elements), head dim contiguous. Outputs are contiguous: o [B, S, H, 64]
// fp32, lse [B, H, S] fp32. p_drop in [0, 1) is the attention dropout, its
// mask drawn from (seed, offset) as philox.cuh says; 0 launches the kernel
// without dropout. Launches one kernel on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int ivg_flash_fwd_fp32(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int B, int S, int H,
                                  int hd, int64_t q_sb, int64_t q_ss,
                                  int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                  int64_t k_sh, int64_t v_sb, int64_t v_ss,
                                  int64_t v_sh, double p_drop, uint64_t seed,
                                  uint64_t offset, void* stream) {
  if (bad_shape(B, S, H, hd) || bad_dropout(p_drop))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh};
  const auto kernel = p_drop > 0.0 ? flash_fwd_fp32_kernel<true>
                                   : flash_fwd_fp32_kernel<false>;
  const cudaError_t err = allow_smem(kernel, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid(B, S, H), kThreads, kFwdSmem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, qs, ks, vs, S,
      H, softmax_scale(), ivg::make_dropout(p_drop, seed, offset, S));
  return static_cast<int>(cudaGetLastError());
}
