// K3: single-token decode attention over the int8 KV cache, sm_90a.
//
// Replaces ivideogpt_tpu/ops/decode_attention.py::_decode_attn_kernel. For
// one decode step, per (b, h):
//
//   s_m   = (q . K_int8[b, m, h, :]) * ks[b, m, h] * hd^-0.5,  m < valid
//   out   = sum_m softmax(s)_m * vs[b, m, h] * V_int8[b, m, h, :]
//
// over the port's bshd cache [B, M, H, hd] (int8) with bf16 scales
// [B, M, H]. Both scales fold in fp32; no dequantised cache is ever written.
//
// Bound on the H100: memory. One step reads 2*B*valid*H*hd int8 bytes plus
// 2*B*valid*H*2 scale bytes (~305 MB at B=256, H=12, valid=751: ~91 us at
// 3.35 TB/s) and does ~4 FLOP per byte.
//
// Design: the TPU kernel walked M tiles in grid order, carrying its flash
// state in VMEM scratch. Here one block of 128 threads owns one (b, h) and
// loops over tiles of 128 slots itself, with an fp32 online softmax (running
// max and denominator) across tiles. Only the ceil(valid / 128) live tiles
// are read, and the last one is masked at `valid`, so M need not be a
// multiple of the tile (752 is not). Scores: one thread per slot, reading
// the slot's 64-byte K row as four 16-byte loads. P.V: 8 groups of 16
// threads, each group reading one 64-byte V row coalesced, 4 dims a thread;
// the 8 partial sums meet in shared memory at the end. B*H = 3072 blocks at
// B=256 fill the 132 SMs without a split over M.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;
constexpr int kThreads = 128;  // = slots per tile
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / (kHd / 4);  // 8 groups of 16 threads

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float int8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xff));
}

// Block-wide max (kMax) or sum over 128 threads; every thread gets the
// result. `red` holds kWarps floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // `red` may be reused right after
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const int8_t* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ ks,
                   const int8_t* __restrict__ vc,
                   const __nv_bfloat16* __restrict__ vs, T* __restrict__ out,
                   int M, int H, int valid, float scale) {
  __shared__ float q_s[kHd];
  __shared__ float pv_s[kThreads];
  __shared__ float red[kWarps];
  __shared__ float acc_s[kGroups][kHd];

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;  // = b * H + h
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t slot = (int64_t)H * kHd;  // bytes between cache slots
  const int8_t* kbase = kc + (b * M * H + h) * kHd;
  const int8_t* vbase = vc + (b * M * H + h) * kHd;
  const __nv_bfloat16* ksbase = ks + b * M * H + h;
  const __nv_bfloat16* vsbase = vs + b * M * H + h;

  if (tid < kHd) q_s[tid] = to_float(q[bh * kHd + tid]);
  __syncthreads();

  const int group = tid / (kHd / 4);
  const int dim0 = 4 * (tid % (kHd / 4));
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float m_run = -CUDART_INF_F;
  float l_run = 0.f;

  for (int m0 = 0; m0 < valid; m0 += kThreads) {
    const int m = m0 + tid;
    const bool live = m < valid;
    float s = -CUDART_INF_F;
    if (live) {
      const int4* kp = reinterpret_cast<const int4*>(kbase + m * slot);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kHd / 16; ++c) {
        const int4 w = kp[c];
        const uint32_t words[4] = {(uint32_t)w.x, (uint32_t)w.y,
                                   (uint32_t)w.z, (uint32_t)w.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dot = fmaf(q_s[16 * c + 4 * j + i], int8_at(words[j], i), dot);
      }
      s = dot * __bfloat162float(ksbase[m * H]) * scale;
    }

    const float m_new = fmaxf(m_run, block_reduce<true>(s, red));
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    const float p = live ? expf(s - m_new) : 0.f;
    l_run = l_run * alpha + block_reduce<false>(p, red);
    pv_s[tid] = live ? p * __bfloat162float(vsbase[m * H]) : 0.f;
    m_run = m_new;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= alpha;
    const int nt = min(kThreads, valid - m0);
    for (int t = group; t < nt; t += kGroups) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          vbase + (m0 + t) * slot + dim0);
      const float pv = pv_s[t];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(pv, int8_at(w, i), acc[i]);
    }
    __syncthreads();  // pv_s is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) acc_s[group][dim0 + i] = acc[i];
  __syncthreads();
  if (tid < kHd) {
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) o += acc_s[g][tid];
    store(out + bh * kHd + tid, o / fmaxf(l_run, 1e-30f));
  }
}

}  // namespace

// q/out [B, H, 64] in bf16 (q_is_bf16=1) or fp32; k/v [B, M, H, 64] int8;
// ks/vs [B, M, H] bf16; all contiguous and 16-byte aligned; 1 <= valid <= M.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ivg_decode_attention(const void* q, const int8_t* k,
                                    const void* ks, const int8_t* v,
                                    const void* vs, void* out, int B, int M,
                                    int H, int hd, int valid, int q_is_bf16,
                                    void* stream) {
  if (hd != kHd || valid < 1 || valid > M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 1.0f / sqrtf(static_cast<float>(kHd));
  const auto* ksb = static_cast<const __nv_bfloat16*>(ks);
  const auto* vsb = static_cast<const __nv_bfloat16*>(vs);
  const int blocks = B * H;
  if (q_is_bf16) {
    decode_attn_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), k, ksb, v, vsb,
        static_cast<__nv_bfloat16*>(out), M, H, valid, scale);
  } else {
    decode_attn_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(q), k, ksb, v, vsb,
        static_cast<float*>(out), M, H, valid, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
