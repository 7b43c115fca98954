// K2: nearest-codebook-entry lookup for codebooks K1 does not take, sm_90a.
//
// Replaces ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel (the TPU's kernel for
// padded codebooks over 6 MB, launched from _vq_lookup_pallas). For z [N, D]
// and codebook E [K, D], both fp32:
//
//   ids[n] = argmin_k (||E_k||^2 - 2 z_n . E_k)
//
// with ||z||^2 omitted and exact ties going to the smallest k, as in the TPU
// kernel and its XLA reduction (vq.py:229-232).
//
// Bound on the H100: 2*N*K*D FLOP of fp32 FMA (no tensor cores and no TF32:
// a TF32 product flips ids near codebook boundaries) against a few MB of
// traffic, so it is compute-bound on the 67 TFLOP/s fp32 rate (~1.03 ms at
// N=8192, K=16384, D=256).
//
// Design. The TPU tiled the codebook through a 2-D grid because it did not
// fit VMEM. On Hopper the problems are others: at D > 64 a row of z no
// longer fits in a thread's registers (K1 keeps 2 rows there), and with few
// rows of z (the dynamics lookup: N=1536) there are too few row tiles to
// fill 132 SMs. So:
// - a grid of (row tiles of 64 rows of z, splits of the codebook): each
//   block keeps its z tile in shared memory, transposed ([D][64], 64 KB at
//   D=256, so dynamic shared memory above 48 KB), and streams its split's
//   codebook rows through shared memory 64 codes x 32 dims at a time,
//   also transposed;
// - 256 threads, each owning a 4 rows x 4 codes micro-tile of dot products:
//   one float4 of z and one float4 of E per dimension feed 16 FMAs; each dot
//   is a chain of FMAs over d = 0..D-1 in order, the order K1 uses;
// - each thread keeps, for its 4 rows, the running (dist, idx) minimum over
//   the codes it sees in increasing order with a strict `<`; the 16 threads
//   sharing a row reduce lexicographically on (dist, idx) with warp
//   shuffles, and a second small kernel reduces the splits the same way.
//   A lexicographic minimum does not depend on the order of the reduction,
//   so the smallest index wins an exact tie wherever the copies sit.
// ||E||^2 comes from the wrapper, as for K1. The wrapper zero-pads D to a
// multiple of 4 (distances unchanged) and picks the number of splits.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;     // rows of z a block
constexpr int kBN = 64;     // codes a tile
constexpr int kDC = 32;     // dimensions of a codebook chunk in shared memory
constexpr int kMaxD = 512;  // z tile of 128 KB
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__global__ void __launch_bounds__(kThreads)
vq_argmin_tiled_kernel(const float* __restrict__ z, const float* __restrict__ e,
                       const float* __restrict__ en, float* __restrict__ part_d,
                       int* __restrict__ part_i, int n, int k, int d,
                       int codes_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                        // [d][kBM]
  float* es = zs + (size_t)d * kBM;        // [kDC][kBN]
  float* ens = es + kDC * kBN;             // [kBN]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // codes 4*tx .. 4*tx+3 of a tile
  const int ty = tid / 16;  // rows 4*ty .. 4*ty+3 of the block
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int kbeg = split * codes_per_split;
  const int kend = min(k, kbeg + codes_per_split);
  const int d4 = d / 4;

  for (int i = tid; i < kBM * d4; i += kThreads) {
    const int r = i / d4, c4 = i % d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      v = reinterpret_cast<const float4*>(z + (int64_t)(row0 + r) * d)[c4];
    zs[(4 * c4 + 0) * kBM + r] = v.x;
    zs[(4 * c4 + 1) * kBM + r] = v.y;
    zs[(4 * c4 + 2) * kBM + r] = v.z;
    zs[(4 * c4 + 3) * kBM + r] = v.w;
  }

  float best[4];
  int best_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = CUDART_INF_F;
    best_i[i] = kNoIndex;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kDC) {
      const int dc = min(kDC, d - d0);  // a multiple of 4
      const int dc4 = dc / 4;
      __syncthreads();  // the z tile is written; the last chunk is consumed
      for (int i = tid; i < kBN * dc4; i += kThreads) {
        const int c = i / dc4, c4 = i % dc4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + c < kend)
          v = reinterpret_cast<const float4*>(e + (int64_t)(k0 + c) * d + d0)[c4];
        es[(4 * c4 + 0) * kBN + c] = v.x;
        es[(4 * c4 + 1) * kBN + c] = v.y;
        es[(4 * c4 + 2) * kBN + c] = v.z;
        es[(4 * c4 + 3) * kBN + c] = v.w;
      }
      if (d0 == 0 && tid < kBN)  // codes past the split can never win
        ens[tid] = k0 + tid < kend ? en[k0 + tid] : CUDART_INF_F;
      __syncthreads();

#pragma unroll 4
      for (int dd = 0; dd < dc; ++dd) {
        const float4 a =
            reinterpret_cast<const float4*>(zs + (size_t)(d0 + dd) * kBM)[ty];
        const float4 b = reinterpret_cast<const float4*>(es + dd * kBN)[tx];
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float enk = ens[4 * tx + j];
      const int code = k0 + 4 * tx + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dist = enk - 2.0f * acc[i][j];
        if (dist < best[i]) {
          best[i] = dist;
          best_i[i] = code;
        }
      }
    }
  }

  // the 16 threads of a row group are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float bd = best[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int row = row0 + 4 * ty + i;
    if (tx == 0 && row < n) {
      part_d[(int64_t)split * n + row] = bd;
      part_i[(int64_t)split * n + row] = bi;
    }
  }
}

__global__ void vq_argmin_reduce_kernel(const float* __restrict__ part_d,
                                        const int* __restrict__ part_i,
                                        int64_t* __restrict__ out, int n,
                                        int splits) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float bd = part_d[row];
  int bi = part_i[row];
  for (int s = 1; s < splits; ++s) {
    const float od = part_d[(int64_t)s * n + row];
    const int oi = part_i[(int64_t)s * n + row];
    if (better(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
  // no finite distance at all: index 0, as torch.argmin over all-inf
  out[row] = bi == kNoIndex ? 0 : bi;
}

}  // namespace

// z [n, d] fp32, e [k, d] fp32, en [k] fp32 (= sum(e*e, 1)); scratch
// part_d [splits, n] fp32 and part_i [splits, n] int32; out [n] int64. All
// contiguous, z and e 16-byte aligned; d a multiple of 4 up to 512;
// codes_per_split a multiple of 64 with splits * codes_per_split >= k.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int ivg_vq_argmin_tiled(const float* z, const float* e,
                                   const float* en, float* part_d, int* part_i,
                                   int64_t* out, int n, int k, int d,
                                   int splits, int codes_per_split,
                                   void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || d <= 0 || d % 4 || d > kMaxD || splits <= 0 ||
      codes_per_split <= 0 || codes_per_split % kBN ||
      (int64_t)splits * codes_per_split < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (d * kBM + kDC * kBN + kBN) * sizeof(float);
  // above 48 KB only after opting in, for the current device
  cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBM - 1) / kBM, splits);
  vq_argmin_tiled_kernel<<<grid, kThreads, smem, s>>>(
      z, e, en, part_d, part_i, n, k, d, codes_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_argmin_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_d, part_i, out,
                                                          n, splits);
  return static_cast<int>(cudaGetLastError());
}
