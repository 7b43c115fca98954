// K1: nearest-codebook-entry lookup for the VQ tokenizer, sm_90a.
//
// Replaces ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel_flash (the TPU's
// default VQ kernel). For z [N, D] and codebook E [K, D], both fp32:
//
//   ids[n] = argmin_k (||E_k||^2 - 2 z_n . E_k)
//
// with ||z||^2 omitted (constant per row) and exact ties going to the
// smallest k, as in the TPU kernel and its XLA oracle. Each dot product is
// one chain of fmaf over d = 0..D-1 from 0, ||E||^2 comes from the wrapper,
// and a code wins only by a strict `<` in increasing k: the arithmetic of K2
// (vq_argmin_tiled.cu), so the two give the same ids bit for bit.
//
// Bound on the H100: 2*N*K*D FLOP of fp32 FMA against a few MB of traffic,
// so it is compute-bound on the 67 TFLOP/s fp32 rate outside the tensor
// cores (2.05 ms at N=131072, K=8192, D=64; 0.128 / 0.056 / 0.024 ms at
// N=8192 / 3584 / 1536). The distances must be IEEE fp32: no tensor cores
// and no TF32, which would flip ids near codebook boundaries.
//
// What the design has to meet: the training lookups have few rows (N=1536
// is 12 tiles of 128), so rows alone leave most of the 132 SMs idle; a
// thread needs many independent FMA chains, or FMA latency and not the FMA
// rate sets the pace; and the codebook's copies must overlap the
// arithmetic. So:
// - Grid of (128-row tiles of z, splits of the codebook). The wrapper
//   sizes the splits (ops/vq.py::k1_splits) so that the grid holds at least
//   2 CTAs an SM where the codebook has enough 128-code chunks, and its
//   waves the least time; at the rollout's N there is one split. A second
//   small kernel combines the splits' (dist, idx) minima lexicographically,
//   which does not depend on the order, so exact ties go to the smallest
//   index across splits too.
// - Register tile: 256 threads (16 x 16), each owning 8 rows x 8 codes, so
//   64 independent accumulators. The z tile is stored transposed [D][128]
//   and each codebook chunk [D][128], so per d four 16-byte shared loads
//   (4 rows, 4 rows, 4 codes, 4 codes) feed 64 FMAs. D is a template
//   parameter; the d loop is unrolled 16 deep.
// - Copies: a 2-stage ring of codebook chunks filled by cp.async (16-byte
//   copies of E^T rows, 4-byte copies of ||E||^2). Chunk c+1 is in flight
//   while chunk c's FMAs run; one __syncthreads a chunk hands a stage back.
//   A first small kernel writes E^T [D][ldk] into the wrapper's scratch
//   (ldk = K rounded up to 4, so every 16-byte copy is aligned; zeros past
//   K); codes past a split's end get ||E||^2 = inf and never win. The z
//   tile is read once per CTA, while chunk 0 flies. (Chunks copied
//   row-major from E, with float4 reads of 4 dims of a code, lost more
//   time in the FMA loop on an H100 than the transpose costs.)
// Shared memory at D=64: 32 KB of z + 2 x 32.5 KB of ring = 97 KB; 167
// registers a thread, so one CTA an SM. Capping registers at 128 for two
// CTAs an SM spilled and ran slower on an H100.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBM = 128;       // rows of z a CTA: 8 a thread
constexpr int kBN = 128;       // codes a chunk: 8 a thread
constexpr int kStages = 2;     // chunks in the ring
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copies of codes [k0, min(k0 + kBN, kend)) into one stage of the
// ring: es [D][kBN] from et [D][ldk], ens [kBN] from en; codes at or past
// kend get ens = inf (their es may hold anything: they cannot win).
template <int D>
__device__ __forceinline__ void load_chunk(float* es, float* ens,
                                           const float* et, int ldk,
                                           const float* en, int k0, int kend,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < D * kBN / 4 / kThreads; ++i) {
    const int p = tid + i * kThreads;
    const int d = p / (kBN / 4), c = (p % (kBN / 4)) * 4;
    if (k0 + c < kend)
      cp_async16(smem_u32(es + d * kBN + c),
                 et + static_cast<int64_t>(d) * ldk + k0 + c);
  }
  if (tid < kBN) {
    if (k0 + tid < kend)
      cp_async4(smem_u32(ens + tid), en + k0 + tid);
    else
      ens[tid] = CUDART_INF_F;
  }
}

// E [k][D] -> E^T [D][ldk], columns k..ldk-1 zero, 64 codes a block:
// reads and writes both coalesced, the shared tile padded against bank
// conflicts.
template <int D>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ e, float* __restrict__ et, int k,
                 int ldk) {
  __shared__ float t[64][D + 1];
  const int k0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    t[r][c] = k0 + r < k ? e[static_cast<int64_t>(k0 + r) * D + c] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int d = i / 64, r = i % 64;
    if (k0 + r < ldk) et[static_cast<int64_t>(d) * ldk + k0 + r] = t[r][d];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
vq_argmin_kernel(const float* __restrict__ z, const float* __restrict__ et,
                 const float* __restrict__ en, float* __restrict__ part_d,
                 int* __restrict__ part_i, int64_t* __restrict__ out, int n,
                 int k, int ldk, int codes_per_split) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                        // [D][kBM]
  float* es = zs + D * kBM;                // [kStages][D][kBN]
  float* ens = es + kStages * D * kBN;     // [kStages][kBN]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // codes 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = tid >> 4;  // rows 4ty..4ty+3 and 64+4ty..64+4ty+3
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int kbeg = split * codes_per_split;
  const int kend = min(k, kbeg + codes_per_split);
  const int chunks = (kend - kbeg + kBN - 1) / kBN;

  load_chunk<D>(es, ens, et, ldk, en, kbeg, kend, tid);
  cp_async_commit();

  // the z tile, transposed, while chunk 0 is in flight: neighbouring
  // threads take neighbouring rows, so the stores are free of bank conflicts
  for (int i = tid; i < kBM * D / 4; i += kThreads) {
    const int r = i % kBM, c4 = i / kBM;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n)
      v = reinterpret_cast<const float4*>(
          z + static_cast<int64_t>(row0 + r) * D)[c4];
    zs[(4 * c4 + 0) * kBM + r] = v.x;
    zs[(4 * c4 + 1) * kBM + r] = v.y;
    zs[(4 * c4 + 2) * kBM + r] = v.z;
    zs[(4 * c4 + 3) * kBM + r] = v.w;
  }

  float best[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = CUDART_INF_F;
    best_i[i] = kNoIndex;
  }

  for (int c = 0; c < chunks; ++c) {
    const int st = c & 1;
    cp_async_wait_all();
    // chunk c is in stage st for every thread (and the z tile is written);
    // every thread is done with chunk c - 1, whose stage takes chunk c + 1
    __syncthreads();
    if (c + 1 < chunks)
      load_chunk<D>(es + (st ^ 1) * D * kBN, ens + (st ^ 1) * kBN, et, ldk,
                    en, kbeg + (c + 1) * kBN, kend, tid);
    cp_async_commit();

    const float* e_c = es + st * D * kBN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float* zd = zs + d * kBM + 4 * ty;
      const float* ed = e_c + d * kBN + 4 * tx;
      const float4 a0 = *reinterpret_cast<const float4*>(zd);
      const float4 a1 = *reinterpret_cast<const float4*>(zd + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(ed);
      const float4 b1 = *reinterpret_cast<const float4*>(ed + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

    // this thread's codes in increasing order, a strict `<`
    const float* en_c = ens + st * kBN;
    const float4 n0 = *reinterpret_cast<const float4*>(en_c + 4 * tx);
    const float4 n1 = *reinterpret_cast<const float4*>(en_c + 64 + 4 * tx);
    const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    const int k0 = kbeg + c * kBN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = k0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dist = nv[j] - 2.0f * acc[i][j];
        if (dist < best[i]) {
          best[i] = dist;
          best_i[i] = code;
        }
      }
    }
  }

  // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
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
    const int row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (tx == 0 && row < n) {
      if (gridDim.y == 1) {
        // no finite distance at all: index 0, as torch.argmin over all-inf
        out[row] = bi == kNoIndex ? 0 : bi;
      } else {
        part_d[static_cast<int64_t>(split) * n + row] = bd;
        part_i[static_cast<int64_t>(split) * n + row] = bi;
      }
    }
  }
}

// The splits' (dist, idx) minima of each row, combined lexicographically.
__global__ void vq_argmin_reduce_kernel(const float* __restrict__ part_d,
                                        const int* __restrict__ part_i,
                                        int64_t* __restrict__ out, int n,
                                        int splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;
  float bd = part_d[row];
  int bi = part_i[row];
  for (int s = 1; s < splits; ++s) {
    const float od = part_d[static_cast<int64_t>(s) * n + row];
    const int oi = part_i[static_cast<int64_t>(s) * n + row];
    if (better(od, oi, bd, bi)) {
      bd = od;
      bi = oi;
    }
  }
  out[row] = bi == kNoIndex ? 0 : bi;
}

template <int D>
cudaError_t launch(const float* z, const float* e, float* et, const float* en,
                   float* part_d, int* part_i, int64_t* out, int n, int k,
                   int ldk, int splits, int codes_per_split,
                   cudaStream_t stream) {
  const int smem = (D * kBM + kStages * (D * kBN + kBN)) * sizeof(float);
  // above 48 KB only after opting in, for the current device
  cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  transpose_kernel<D><<<(ldk + 63) / 64, kThreads, 0, stream>>>(e, et, k,
                                                                ldk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBM - 1) / kBM, splits);
  vq_argmin_kernel<D><<<grid, kThreads, smem, stream>>>(
      z, et, en, part_d, part_i, out, n, k, ldk, codes_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  vq_argmin_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part_d, part_i,
                                                               out, n, splits);
  return cudaGetLastError();
}

}  // namespace

// z [n, d] and e [k, d] fp32 contiguous; en [k] fp32 (= sum(e*e, 1)); out
// [n] int64. Scratch: et [d, ldk] fp32 (the transposed codebook, ldk = k
// rounded up to 4) and, with splits > 1, part_d [splits, n] fp32 and
// part_i [splits, n] int32 (unused, may be null, with one split). z and et
// 16-byte aligned; d in {8, 16, 32, 64}; codes_per_split a multiple of 128
// with no split empty. Launches on `stream` and returns the
// cudaError_t of the launches (0 on success).
extern "C" int ivg_vq_argmin(const float* z, const float* e, float* et,
                             const float* en, float* part_d, int* part_i,
                             int64_t* out, int n, int k, int d, int splits,
                             int codes_per_split, void* stream) {
  if (n <= 0) return 0;
  const int ldk = (k + 3) / 4 * 4;
  if (k <= 0 || splits <= 0 || codes_per_split <= 0 ||
      codes_per_split % kBN ||
      static_cast<int64_t>(splits - 1) * codes_per_split >= k ||
      static_cast<int64_t>(splits) * codes_per_split < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8:
      return launch<8>(z, e, et, en, part_d, part_i, out, n, k, ldk, splits,
                       codes_per_split, s);
    case 16:
      return launch<16>(z, e, et, en, part_d, part_i, out, n, k, ldk, splits,
                        codes_per_split, s);
    case 32:
      return launch<32>(z, e, et, en, part_d, part_i, out, n, k, ldk, splits,
                        codes_per_split, s);
    case 64:
      return launch<64>(z, e, et, en, part_d, part_i, out, n, k, ldk, splits,
                        codes_per_split, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
