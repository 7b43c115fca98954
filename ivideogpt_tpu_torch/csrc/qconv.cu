// Q1: int8 x int8 -> int32 convolution as an implicit GEMM, with the
// dequantize, bias and cast fused, sm_90a; and the quantize pass that feeds
// it.
//
// Replaces no TPU kernel: it is the counterpart of XLA's int8 conv in
// ivideogpt_tpu/ops/qconv.py::_int8_conv_call (lax.conv_general_dilated
// with preferred_element_type=int32), which PyTorch has no CUDA operator
// for. For the detokenize's convs (kernel 1 or 3, stride 1 or 2, padding 0
// or 1):
//
//   acc[n, o, y, x] = sum_{dy, dx, c} xq[n, y*s - p + dy, x*s - p + dx, c]
//                                     * wq[o, dy, dx, c]        (int32, exact)
//   out[n, o, y, x] = float(acc) * (x_scale * w_scale[o]) + bias[o]
//
// the scales' product formed first in fp32 and each step rounded on its own
// (no fused multiply-add), then cast to the output type (bf16 or fp32),
// written NCHW, the layout the port's next layer takes. Mode 2 writes acc
// itself (the exact check against the plain version).
//
// Bound on the H100: operations at most of the detokenize's shapes, bytes
// at a few (2 * k^2 * C int8 operations an output against C bytes read an
// input pixel and 2 or 4 bytes written an output; the 3 x 3, 128-channel
// conv at 64 x 64 of a 1792-frame chunk: 2.2 TOP, 1.1 ms at 1,979 TOP/s,
// against 2.8 GB, 0.84 ms at 3.35 TB/s; the 1 x 1 shortcuts are bytes).
//
// Design (a right, simple first kernel; wgmma, TMA and a tuned tile are
// later work):
// - GEMM view: M = N * Ho * Wo output pixels, N = O output channels, K =
//   k^2 * C over (dy, dx, c), the activation channels-last with C padded to
//   a 16-byte multiple (the quantize kernel below writes it so), the weight
//   packed by the wrapper as rows of K bytes per output channel, O padded
//   to 64 and K to 64 with zeros.
// - A block takes 128 pixels x 64 channels, 4 warps of 64 x 32, each a
//   4 x 4 grid of mma.sync.m16n8k32 s8 tiles (64 int32 accumulators a
//   thread). K goes in steps of 64 bytes through a 3-stage cp.async ring:
//   a 16-byte chunk of an A row is one (dy, dx) tap's run of 16 channels,
//   its address computed from the pixel and the tap; chunks outside the
//   image or past K are zero-filled by cp.async's source size. Rows are
//   80 bytes apart in shared memory, so the fragment reads (8 rows x 4
//   words a warp) hit 32 distinct banks.
// - The epilogue guards the ragged pixel and channel edges (conv_out's 3
//   channels fill 3 of the tile's 64).
//
// The quantize kernel: x NCHW (bf16 or fp32) and a fp32 scale on the card
// -> int8 NHWC with C padded to Cp: q = clip(rint(x / scale), +-127), true
// division, round half to even, in one pass (a thread reads 16 channels of
// one pixel, neighbouring threads neighbouring pixels, and writes 16 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // output pixels a block
constexpr int kBN = 64;            // output channels a block
constexpr int kBK = 64;            // reduction bytes a stage
constexpr int kStages = 3;
constexpr int kPitch = kBK + 16;   // bytes between rows in shared memory
constexpr int kThreads = 128;

struct Geometry {
  int N, H, W, C;   // input, C padded to a multiple of 16
  int O, Ho, Wo;    // output
  int k, stride, pad;
  int K;            // the packed weight's row, a multiple of kBK
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or zeros where !full (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b on one 16 x 8 x 32 tile, s8 x s8 -> s32.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kMode 0: fp32 out, 1: bf16 out, 2: the int32 accumulator.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ w_scale,
             const float* __restrict__ x_scale,
             const float* __restrict__ bias, void* __restrict__ out,
             Geometry g) {
  __shared__ __align__(16) int8_t sA[kStages][kBM * kPitch];
  __shared__ __align__(16) int8_t sB[kStages][kBN * kPitch];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int64_t P = static_cast<int64_t>(g.Ho) * g.Wo;
  const int64_t M = static_cast<int64_t>(g.N) * P;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;
  const int k_real = g.k * g.k * g.C;
  const int n_k = g.K / kBK;

  // The loads: thread t copies chunk (t & 3) of A rows (t >> 2) + 32 j and
  // of B rows (t >> 2) + 32 j. Its A rows' pixels, fixed for the walk.
  const int kc = tid & 3, row0 = tid >> 2;
  int64_t a_img[4];  // the pixel's image, as the index of its first pixel
  int a_y[4], a_x[4];
  bool a_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t m = m0 + row0 + 32 * j;
    a_ok[j] = m < M;
    const int64_t mm = a_ok[j] ? m : 0;
    const int64_t n = mm / P;
    const int p = static_cast<int>(mm - n * P);
    const int oy = p / g.Wo, ox = p - oy * g.Wo;
    a_img[j] = n * g.H * g.W;
    a_y[j] = oy * g.stride - g.pad;
    a_x[j] = ox * g.stride - g.pad;
  }

  auto load = [&](int stage, int kt) {
    const int k = kt * kBK + kc * 16;
    const int tap = k / g.C, c = k - tap * g.C;
    const int dy = tap / g.k, dx = tap - dy * g.k;
    const bool k_in = k < k_real;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int iy = a_y[j] + dy, ix = a_x[j] + dx;
      const bool ok = k_in && a_ok[j] && iy >= 0 && iy < g.H && ix >= 0 &&
                      ix < g.W;
      const int8_t* src =
          ok ? x + ((a_img[j] + static_cast<int64_t>(iy) * g.W + ix) * g.C +
                    c)
             : x;
      cp_async16(smem_u32(&sA[stage][(row0 + 32 * j) * kPitch + kc * 16]),
                 src, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = row0 + 32 * j;
      cp_async16(smem_u32(&sB[stage][r * kPitch + kc * 16]),
                 w + static_cast<int64_t>(o0 + r) * g.K + k, true);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < n_k) load(next % kStages, next);
    cp_async_commit();

    const int8_t* a = sA[kt % kStages];
    const int8_t* b = sB[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* r = a + (wm * 64 + mt * 16 + grp) * kPitch + ks * 32 +
                          tig * 4;
        af[mt][0] = ld32(r);
        af[mt][1] = ld32(r + 8 * kPitch);
        af[mt][2] = ld32(r + 16);
        af[mt][3] = ld32(r + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* r = b + (wn * 32 + nt * 8 + grp) * kPitch + ks * 32 +
                          tig * 4;
        bf[nt][0] = ld32(r);
        bf[nt][1] = ld32(r + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

  // Accumulator (mt, nt, e): pixel row wm*64 + mt*16 + grp + 8 (e >> 1),
  // channel wn*32 + nt*8 + 2 tig + (e & 1).
  const float xs = *x_scale;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * 64 + mt * 16 + grp + 8 * h;
      if (m >= M) continue;
      const int64_t n = m / P, p = m - n * P;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn * 32 + nt * 8 + 2 * tig + e;
          if (o >= g.O) continue;
          const int v = acc[mt][nt][2 * h + e];
          const int64_t at = (n * g.O + o) * P + p;
          if (kMode == 2) {
            static_cast<int*>(out)[at] = v;
          } else {
            float f = __fmul_rn(__int2float_rn(v), __fmul_rn(xs, w_scale[o]));
            if (bias != nullptr) f = __fadd_rn(f, bias[o]);
            if (kMode == 1)
              store(static_cast<__nv_bfloat16*>(out) + at, f);
            else
              store(static_cast<float*>(out) + at, f);
          }
        }
    }
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                const float* __restrict__ scale,
                                int8_t* __restrict__ y, int N, int C,
                                int64_t HW, int Cp) {
  const int groups = Cp / 16;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(N) * groups * HW) return;
  const int64_t p = i % HW, t = i / HW;
  const int cg = static_cast<int>(t % groups);
  const int64_t n = t / groups;
  const float s = *scale;
  uint32_t words[4];
#pragma unroll
  for (int q4 = 0; q4 < 4; ++q4) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = cg * 16 + q4 * 4 + b;
      int v = 0;
      if (c < C) {
        const float q = rintf(__fdiv_rn(as_float(x[(n * C + c) * HW + p]), s));
        v = static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
      }
      word |= static_cast<uint32_t>(v & 255) << (8 * b);
    }
    words[q4] = word;
  }
  *reinterpret_cast<uint4*>(y + (n * HW + p) * Cp + cg * 16) =
      make_uint4(words[0], words[1], words[2], words[3]);
}

}  // namespace

// x int8 [N, H, W, C] (C a multiple of 16); w int8 [ceil(O/64)*64, K]
// (K a multiple of 64 and at least k*k*C); w_scale fp32 [O]; x_scale one
// fp32 on the card; bias fp32 [O] or null; out [N, O, Ho, Wo] fp32
// (mode 0), bf16 (mode 1) or int32 (mode 2, the accumulator). All
// contiguous, 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int ivg_qconv(const int8_t* x, const int8_t* w,
                         const float* w_scale, const float* x_scale,
                         const float* bias, void* out, int N, int H, int W,
                         int C, int O, int Ho, int Wo, int k, int stride,
                         int pad, int K, int mode, void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 16 || C % 16 != 0 || O < 1 ||
      Ho < 1 || Wo < 1 || (k != 1 && k != 3) || stride < 1 || pad < 0 ||
      K % kBK != 0 || K < k * k * C || mode < 0 || mode > 2 ||
      Ho != (H + 2 * pad - k) / stride + 1 ||
      Wo != (W + 2 * pad - k) / stride + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{N, H, W, C, O, Ho, Wo, k, stride, pad, K};
  const int64_t m = static_cast<int64_t>(N) * Ho * Wo;
  const dim3 grid(static_cast<unsigned>((m + kBM - 1) / kBM),
                  (O + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    qconv_kernel<0><<<grid, kThreads, 0, s>>>(x, w, w_scale, x_scale, bias,
                                              out, g);
  else if (mode == 1)
    qconv_kernel<1><<<grid, kThreads, 0, s>>>(x, w, w_scale, x_scale, bias,
                                              out, g);
  else
    qconv_kernel<2><<<grid, kThreads, 0, s>>>(x, w, w_scale, x_scale, bias,
                                              out, g);
  return static_cast<int>(cudaGetLastError());
}

// x [N, C, H*W] bf16 (is_bf16=1) or fp32; scale one fp32 on the card; y
// int8 [N, H*W, Cp], Cp a multiple of 16 and at least C (the padding
// channels written 0). Returns the launch's cudaError_t.
extern "C" int ivg_quantize_nhwc(const void* x, const float* scale,
                                 int8_t* y, int N, int C, int HW, int Cp,
                                 int is_bf16, void* stream) {
  if (N < 1 || C < 1 || HW < 1 || Cp % 16 != 0 || Cp < C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(N) * (Cp / 16) * HW;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_kernel<<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, y, N, C, HW, Cp);
  else
    quantize_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(x),
                                           scale, y, N, C, HW, Cp);
  return static_cast<int>(cudaGetLastError());
}
