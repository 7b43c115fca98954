// K1: nearest-codebook-entry lookup for the VQ tokenizer, sm_90a.
//
// Replaces ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel_flash (the TPU's
// default VQ kernel). For z [N, D] and codebook E [K, D], both fp32:
//
//   ids[n] = argmin_k (||E_k||^2 - 2 z_n . E_k)
//
// with ||z||^2 omitted (constant per row) and exact ties going to the
// smallest k, as in the TPU kernel and its XLA oracle.
//
// Bound on the H100: 2*N*K*D FLOP of fp32 FMA against ~36 MB of traffic,
// so it is compute-bound on the 67 TFLOP/s non-tensor fp32 rate (~2.05 ms at
// N=131072, K=8192, D=64). The distances must be IEEE fp32, so no tensor
// cores and no TF32: a TF32 product would flip ids near codebook boundaries.
//
// Design: the TPU kept the whole 4 MB codebook in VMEM; an SM has 227 KB, so
// here each block streams the codebook through shared memory in tiles of
// TK rows. Every thread owns R rows of z, held in registers for the whole
// run, and walks k in increasing order with a strict `<`, so the first
// index wins an exact tie without any cross-thread reduction. Each
// broadcast float4 read of the tile feeds 4*R FMAs. ||E||^2 comes from the
// wrapper (the same tensor the plain version uses).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRows = 2;   // rows of z per thread
constexpr int kTile = 64;  // codebook rows per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ e,
                 const float* __restrict__ en, int64_t* __restrict__ out,
                 int n, int k) {
  constexpr int D4 = D / 4;
  __shared__ __align__(16) float4 e_s[kTile * D4];
  __shared__ float en_s[kTile];

  const int64_t row0 = (int64_t)blockIdx.x * kThreads * kRows + threadIdx.x;
  float zr[kRows][D];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = row0 + (int64_t)r * kThreads;
#pragma unroll
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < n) v = reinterpret_cast<const float4*>(z + row * D)[d4];
      zr[r][4 * d4 + 0] = v.x;
      zr[r][4 * d4 + 1] = v.y;
      zr[r][4 * d4 + 2] = v.z;
      zr[r][4 * d4 + 3] = v.w;
    }
  }

  float best[kRows];
  int64_t best_i[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    best[r] = CUDART_INF_F;
    best_i[r] = 0;
  }

  const float4* e4 = reinterpret_cast<const float4*>(e);
  for (int k0 = 0; k0 < k; k0 += kTile) {
    const int kn = min(kTile, k - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < kn * D4; i += kThreads)
      e_s[i] = e4[(int64_t)k0 * D4 + i];
    for (int i = threadIdx.x; i < kn; i += kThreads) en_s[i] = en[k0 + i];
    __syncthreads();

    for (int kk = 0; kk < kn; ++kk) {
      float dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < D4; ++d4) {
        const float4 ev = e_s[kk * D4 + d4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dot[r] = fmaf(zr[r][4 * d4 + 0], ev.x, dot[r]);
          dot[r] = fmaf(zr[r][4 * d4 + 1], ev.y, dot[r]);
          dot[r] = fmaf(zr[r][4 * d4 + 2], ev.z, dot[r]);
          dot[r] = fmaf(zr[r][4 * d4 + 3], ev.w, dot[r]);
        }
      }
      const float enk = en_s[kk];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dist = enk - 2.0f * dot[r];
        if (dist < best[r]) {
          best[r] = dist;
          best_i[r] = k0 + kk;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = row0 + (int64_t)r * kThreads;
    if (row < n) out[row] = best_i[r];
  }
}

template <int D>
cudaError_t launch(const float* z, const float* e, const float* en,
                   int64_t* out, int n, int k, cudaStream_t stream) {
  const int rows_per_block = kThreads * kRows;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  vq_argmin_kernel<D><<<blocks, kThreads, 0, stream>>>(z, e, en, out, n, k);
  return cudaGetLastError();
}

}  // namespace

// z [n, d] fp32, e [k, d] fp32, en [k] fp32 (= sum(e*e, 1)), out [n] int64;
// all contiguous, z and e 16-byte aligned. d in {8, 16, 32, 64}.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ivg_vq_argmin(const float* z, const float* e, const float* en,
                             int64_t* out, int n, int k, int d, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(z, e, en, out, n, k, s);
    case 16: return launch<16>(z, e, en, out, n, k, s);
    case 32: return launch<32>(z, e, en, out, n, k, s);
    case 64: return launch<64>(z, e, en, out, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
