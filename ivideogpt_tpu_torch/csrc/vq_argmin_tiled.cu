// K2: nearest-codebook-entry lookup for any codebook, sm_90a.
//
// Replaces ivideogpt_tpu/ops/vq.py::_vq_argmin_kernel (vq.py:46, the TPU's
// kernel for padded codebooks over 6 MB, launched at vq.py:203 from
// _vq_lookup_pallas). For z [N, D] and codebook E [K, D], both fp32, any
// K >= 1 and D <= 512:
//
//   ids[n] = argmin_k (||E_k||^2 - 2 z_n . E_k)
//
// with ||z||^2 omitted and exact ties going to the smallest k, as in the TPU
// kernel and its XLA reduction (vq.py:229-232). The arithmetic is K1's
// (vq_argmin.cu), so the two give the same ids bit for bit: each dot is one
// chain of fmaf over d = 0..D-1 in order from 0 (the zero dimensions that
// pad D to a stage add 0 * 0 and change no distance), ||E||^2 is the
// wrapper's `(ef * ef).sum(1)`, a code wins inside a thread only by a strict
// `<` in increasing k, and across lanes and splits the minimum is
// lexicographic on (dist, idx). A NaN distance never wins; a row with no
// finite distance gets 0.
//
// Bound on the H100: 2*N*K*D FLOP of fp32 FMA against a few MB of traffic,
// so compute-bound on the 67 TFLOP/s fp32 rate outside the tensor cores
// (1.03 ms at N=8192, K=16384, D=256; 0.19 ms at N=1536; 2.05 ms at the
// rollout's N=131072, K=8192, D=64). Out of scope, on purpose: tensor cores.
// A TF32 product, or split-fp32 (3xTF32) on wgmma, sums in another way and
// flips ids near codebook boundaries, which breaks bit-equality with K1.
// Also out of scope: warp specialisation and persistent CTAs.
//
// Design: K1's register tile, with D streamed instead of held whole.
// - Two small kernels first write z^T [Dp][ldn] and E^T [Dp][ldk] into the
//   wrapper's scratch (Dp = D rounded up to kDC, zero rows past D; ldn, ldk
//   = N, K rounded up to 4, so every 16-byte copy is aligned). They read z
//   and E through a row stride, so the wrapper copies neither.
// - Grid of (128-row tiles of z, splits of the codebook); the wrapper plans
//   the splits (ops/vq.py::vq_splits) to fill the card at one CTA an SM in
//   the fewest waves x tiles. With more than one split a last small kernel
//   combines the splits' (dist, idx) minima lexicographically.
// - Register tile: 256 threads (16 x 16), each owning 8 rows x 8 codes, 64
//   independent accumulators; per d, four 16-byte shared loads feed 64
//   FMAs.
// - D streamed: a CTA walks its split's 128-code tiles, each as Dp / kDC
//   stages of kDC dimensions. A stage is a [kDC][128] slice of E^T, filled
//   by 16-byte cp.async through a ring of kStages stages, so the next
//   kStages - 1 stages are in flight while one computes, across tile
//   boundaries too; one __syncthreads a stage hands a slot back. The
//   accumulators live across a tile's stages; its last stage also brings
//   the tile's 128 norms (inf past the split's end, so those codes never
//   win), and the running minimum is updated once a tile.
// - The z tile: its z^T [Dp][128] stays in shared memory, copied once with
//   the first stage, wherever it fits beside the ring (Dp <= 320: 128 KB at
//   D=256); past that, each stage also carries the matching [kDC][128]
//   slice of z^T. Resident z was 6-7 % faster at D=256 on an H100 (it
//   halves the copies a stage); wider D takes the streamed route.
// - Copies land in shared memory as they are laid out in z^T and E^T:
//   consecutive threads write consecutive 16 bytes, free of bank conflicts.
//
// -Xptxas -v (CUDA 12.8, sm_90a): the argmin kernel 141 registers with z
// resident, 149 streamed, no spills; dynamic shared memory 198,656 B at
// D=256 and 100,352 B at D=64 (resident), 133,120 B (streamed): one CTA an
// SM. The transpose 20 registers and 4,224 B; the combine 32 registers.
// On an H100 at 700 W: 1.60 ms at N=8192, K=16384, D=256 (0.64 of the
// bound), 0.334 ms at N=1536 (0.58) (PERF.md section 6).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBM = 128;       // rows of z a CTA: 8 a thread
constexpr int kBN = 128;       // codes a tile: 8 a thread
constexpr int kDC = 32;        // dimensions a stage
constexpr int kStages = 4;     // stages in the ring
constexpr int kMaxD = 512;
constexpr int kMaxSmem = 232448;  // shared memory a CTA may opt into, sm_90
constexpr int kNoIndex = 0x7fffffff;
// a stage: z^T slice [kDC][kBM] (streamed z only), E^T slice [kDC][kBN],
// the tile's norms [kBN]
constexpr int kSliceFloats = kDC * kBN;

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copies of src [d0, d0 + rows)[c0, c0 + 128) into dst
// [rows][128] (src has row stride ld); columns at or past cend are left as
// they are (their results are dropped, or their norms are inf).
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int64_t ld, int d0, int rows,
                                           int c0, int cend, int tid) {
  const int c = (tid % (kBN / 4)) * 4;
  for (int d = tid / (kBN / 4); d < rows; d += kThreads / (kBN / 4))
    if (c0 + c < cend)
      cp_async16(smem_u32(dst + d * kBN + c),
                 src + static_cast<int64_t>(d0 + d) * ld + c0 + c);
}

// in [rows][cols] (row stride ld_in) -> out [cols_p][ld_out]: out[c][r] =
// in[r][c], 0 for c >= cols (rows cols..cols_p-1 pad D with zeros); columns
// r >= rows of out are left unwritten. 32 x 32 tiles through a padded
// shared tile: reads and writes coalesced, no bank conflicts.
__global__ void __launch_bounds__(kThreads)
vq_argmin_tiled_transpose_kernel(const float* __restrict__ in, int64_t ld_in,
                                 int rows, int cols, float* __restrict__ out,
                                 int64_t ld_out) {
  __shared__ float t[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll
  for (int j = w; j < 32; j += kThreads / 32) {
    const int r = r0 + j, c = c0 + lane;
    t[j][lane] = r < rows && c < cols ? in[r * ld_in + c] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int j = w; j < 32; j += kThreads / 32) {
    const int r = r0 + lane;
    if (r < rows) out[(c0 + j) * ld_out + r] = t[lane][j];
  }
}

template <bool kZResident>
__global__ void __launch_bounds__(kThreads, 1)
vq_argmin_tiled_kernel(const float* __restrict__ zt, int ldn,
                       const float* __restrict__ et, int ldk,
                       const float* __restrict__ en,
                       float* __restrict__ part_d, int* __restrict__ part_i,
                       int64_t* __restrict__ out, int n, int k, int dp,
                       int codes_per_split) {
  constexpr int kStageFloats = (kZResident ? 1 : 2) * kSliceFloats + kBN;
  extern __shared__ __align__(16) float smem[];
  // resident z: the CTA's whole z^T tile [dp][kBM] before the ring
  float* zs = smem;
  float* ring = smem + (kZResident ? dp * kBM : 0);

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // codes 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = tid >> 4;  // rows 4ty..4ty+3 and 64+4ty..64+4ty+3
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int kbeg = split * codes_per_split;
  const int kend = min(k, kbeg + codes_per_split);
  const int stages_a_tile = dp / kDC;
  const int total = (kend - kbeg + kBN - 1) / kBN * stages_a_tile;

  // stage s: dimensions (s % stages_a_tile) * kDC.. of tile s / stages_a_tile
  auto issue = [&](int s) {
    if (s < total) {
      const int tile = s / stages_a_tile;
      const int d0 = (s - tile * stages_a_tile) * kDC;
      const int k0 = kbeg + tile * kBN;
      float* st = ring + (s % kStages) * kStageFloats;
      float* es = st + (kZResident ? 0 : kSliceFloats);
      if (!kZResident) load_slice(st, zt, ldn, d0, kDC, row0, n, tid);
      load_slice(es, et, ldk, d0, kDC, k0, kend, tid);
      if (d0 + kDC == dp && tid < kBN) {
        float* ens = es + kSliceFloats;
        if (k0 + tid < kend)
          cp_async4(smem_u32(ens + tid), en + k0 + tid);
        else
          ens[tid] = CUDART_INF_F;
      }
    }
    cp_async_commit();
  };

  if (kZResident) load_slice(zs, zt, ldn, 0, dp, row0, n, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float best[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = CUDART_INF_F;
    best_i[i] = kNoIndex;
  }

  int s = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kBN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    const float* st = ring;
    for (int d0 = 0; d0 < dp; d0 += kDC, ++s) {
      cp_async_wait<kStages - 2>();
      // stage s is in its slot for every thread; every thread is done with
      // stage s - 1, whose slot takes stage s + kStages - 1
      __syncthreads();
      issue(s + kStages - 1);

      st = ring + (s % kStages) * kStageFloats;
      const float* zc = kZResident ? zs + d0 * kBM : st;
      const float* ec = st + (kZResident ? 0 : kSliceFloats);
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const float* zd = zc + d * kBM + 4 * ty;
        const float* ed = ec + d * kBN + 4 * tx;
        const float4 a0 = *reinterpret_cast<const float4*>(zd);
        const float4 a1 = *reinterpret_cast<const float4*>(zd + 64);
        const float4 b0 = *reinterpret_cast<const float4*>(ed);
        const float4 b1 = *reinterpret_cast<const float4*>(ed + 64);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // the tile's norms came with its last stage, still in its slot; this
    // thread's codes in increasing order, a strict `<`
    const float* en_c = st + (kZResident ? 1 : 2) * kSliceFloats;
    const float4 n0 = *reinterpret_cast<const float4*>(en_c + 4 * tx);
    const float4 n1 = *reinterpret_cast<const float4*>(en_c + 64 + 4 * tx);
    const float nv[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
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
  cp_async_wait<0>();

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

template <bool kZResident>
int smem_bytes(int dp) {
  return ((kZResident ? dp * kBM : 0) +
          kStages * ((kZResident ? 1 : 2) * kSliceFloats + kBN)) *
         static_cast<int>(sizeof(float));
}

// z^T stays in shared memory wherever it fits beside the ring (dp <= 320)
bool z_fits(int dp) { return smem_bytes<true>(dp) <= kMaxSmem; }

template <bool kZResident>
cudaError_t launch(const float* zt, int ldn, const float* et, int ldk,
                   const float* en, float* part_d, int* part_i, int64_t* out,
                   int n, int k, int dp, int splits, int codes_per_split,
                   cudaStream_t stream) {
  const int smem = smem_bytes<kZResident>(dp);
  // above 48 KB only after opting in, for the current device
  cudaError_t err = cudaFuncSetAttribute(
      vq_argmin_tiled_kernel<kZResident>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBM - 1) / kBM, splits);
  vq_argmin_tiled_kernel<kZResident><<<grid, kThreads, smem, stream>>>(
      zt, ldn, et, ldk, en, part_d, part_i, out, n, k, dp, codes_per_split);
  return cudaGetLastError();
}

}  // namespace

// The route at width d (1: z^T resident in shared memory, 0: streamed), and
// the bytes of dynamic shared memory a CTA of the argmin kernel then takes.
extern "C" int ivg_vq_argmin_tiled_route(int d, int* smem) {
  const int dp = (d + kDC - 1) / kDC * kDC;
  const bool resident = z_fits(dp);
  *smem = resident ? smem_bytes<true>(dp) : smem_bytes<false>(dp);
  return resident;
}

// z [n, d] with row stride ldz and e [k, d] with row stride lde, fp32, unit
// column stride; en [k] fp32 (= sum(e*e, 1)); out [n] int64. Scratch, 16-byte
// aligned: zt [dp, ldn] and et [dp, ldk] fp32 (dp = d rounded up to 32, ldn
// and ldk = n and k rounded up to 4) and, with splits > 1, part_d [splits, n]
// fp32 and part_i [splits, n] int32 (unused, may be null, with one split).
// 1 <= d <= 512; codes_per_split a multiple of 128 with no split empty.
// z^T stays in shared memory where it fits and is streamed otherwise.
// Launches on `stream` and returns the cudaError_t of the launches (0 on
// success).
extern "C" int ivg_vq_argmin_tiled(const float* z, int64_t ldz,
                                   const float* e, int64_t lde, float* zt,
                                   float* et, const float* en, float* part_d,
                                   int* part_i, int64_t* out, int n, int k,
                                   int d, int splits, int codes_per_split,
                                   void* stream) {
  if (n <= 0) return 0;
  if (k <= 0 || d <= 0 || d > kMaxD || splits <= 0 ||
      codes_per_split <= 0 || codes_per_split % kBN ||
      static_cast<int64_t>(splits - 1) * codes_per_split >= k ||
      static_cast<int64_t>(splits) * codes_per_split < k)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + kDC - 1) / kDC * kDC;
  const int ldn = (n + 3) / 4 * 4, ldk = (k + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  vq_argmin_tiled_transpose_kernel<<<dim3((n + 31) / 32, dp / 32), kThreads,
                                     0, s>>>(z, ldz, n, d, zt, ldn);
  vq_argmin_tiled_transpose_kernel<<<dim3((k + 31) / 32, dp / 32), kThreads,
                                     0, s>>>(e, lde, k, d, et, ldk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = z_fits(dp) ? launch<true>(zt, ldn, et, ldk, en, part_d, part_i, out,
                                  n, k, dp, splits, codes_per_split, s)
                   : launch<false>(zt, ldn, et, ldk, en, part_d, part_i, out,
                                   n, k, dp, splits, codes_per_split, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  vq_argmin_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_d, part_i,
                                                          out, n, splits);
  return static_cast<int>(cudaGetLastError());
}
