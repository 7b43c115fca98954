// Q1: int8 x int8 -> int32 convolution as an implicit GEMM, with the
// dequantize, bias and cast fused, for Hopper (sm_90a); and the quantize
// pass that feeds it.
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
// So the products must run at the int8 tensor cores' rate while the
// output's bytes leave the SM behind them, and no thread may spend
// instructions on the im2col addressing:
//
// - GEMM view: M = output pixels, N = O output channels, K = k^2 * Cb over
//   (dy, dx, c), Cb the channels rounded up to 128. A is the channels-last
//   codes [N, H, W, Cp] (Cp: C padded to 16 bytes by the quantize kernel),
//   B the packed weight [O, K]: one K-major row per output channel, each
//   tap's channels in blocks of 128 bytes, zero past C. Both operands are
//   K-major, as wgmma's 8-bit types require.
// - Products: wgmma.mma_async m64nNk32 s8 x s8 -> s32 from 128-byte-swizzled
//   tiles in shared memory (sm90.cuh's desc: an int8 row of 128 bytes has
//   bf16's descriptor, and a k-step of 32 bytes adds 2). Two consumer
//   warpgroups, each holding m64 x 256 (or 2 x m64 x 128, or 2 x m64 x 16)
//   int32 accumulators, 128 registers a thread at most; setmaxnreg gives
//   them 232 registers and the producer 40.
// - The A tile: one TMA box a K step. A pixel tile is br whole output rows
//   of bw = Wo pixels (a segment of bw = 128 or 256 pixels where Wo is
//   wider), and for tap (dy, dx) and channel block c0 its rows are the box
//   {128 channel bytes, bw, br, 1} at (c0, x0*s - p + dx, y0*s - p + dy, n)
//   of a 4-D tensor map over (Cp, W, H, N). TMA zero-fills every
//   coordinate outside the image, negative ones included: that is the
//   padding, and the channels past Cp. Stride 2 reads through four maps,
//   one per (row, column) parity of the input, each with doubled strides,
//   so a box again walks consecutive elements. A tile that is not whole
//   (Wo not dividing the tile) leaves its last rows unused, masked at the
//   store. The B tile is a 2-D box {128, BN} of the packed weight; rows past
//   O read as zeros.
// - Tiles: 128 pixels x 256 channels, or 256 pixels x 128 channels where
//   O <= 128, or 256 pixels x 16 channels where O <= 16 (conv_out's 3). A
//   stage holds one K step of both (48 KB; 34 KB at 16 channels), in a ring
//   of 4 (5) stages fed by one producer thread through full/empty mbarriers.
// - A persistent grid: one block an SM walks the (pixel tile, channel tile)
//   pairs, a pixel tile's channel tiles next to each other, so A is read
//   again from L2. The consumers release each stage as soon as its products
//   are done, so the producer fills the ring for the next tile while they
//   run the epilogue.
// - The epilogue: each consumer warpgroup dequantizes its accumulators
//   (float(acc) * (x_scale * w_scale[o]), + bias, __fmul_rn / __fadd_rn:
//   no fused multiply-add) and stages them channel-major in a 16 KB buffer
//   in the 128-byte swizzle (bank-conflict free; bf16 by stmatrix.trans, 8
//   pixels of a channel a row), then one thread stores it to the NCHW
//   output by TMA: a tile's pixels are contiguous there, so the box is
//   {128 bytes of pixels, channels, 1} over (Ho*Wo, O, N), and TMA drops
//   what lies past the image or past O. The store is not waited on until
//   the buffer comes round again, so it overlaps the next tile's products.
//   Where a tile is not whole, or Ho*Wo*bytes is no multiple of 16, the
//   warpgroup copies the staged tile out itself with masks instead. A
//   tile's scales and biases are loaded before its products, one column a
//   lane, and read by shuffles: loaded where they are used, their latency
//   stalled the 8 consumer warps for ~4 us a tile (measured on the H100).
//
// The quantize kernel: x NCHW (bf16 or fp32) and a fp32 scale on the card
// -> int8 NHWC with C padded to Cp: q = clip(rint(x / scale), +-127), true
// division (__fdiv_rn), round half to even. It is a transpose, bound by
// bytes: a block takes 64 channels x 128 pixels, reads each channel's 128
// pixels as 16-byte vectors, packs four channels' codes of a pixel into a
// word in shared memory, and writes each pixel's 64 channels as four
// 16-byte stores (whole 32-byte sectors).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace ivg::sm90;

constexpr int kBlockK = 128;       // bytes of one tap's channels a K step
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kStaging = 16384;    // a consumer warpgroup's output buffer
constexpr int kSmemLimit = 232448;  // the H100's per-block maximum
constexpr int kBars = 256;         // room for the mbarriers

// ------------------------------ PTX ----------------------------------------

// The box at (k0, row0) of a 2-D tensor map into shared memory at dst.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// The shared-memory box at src to (c0, c1, c2) of a 3-D tensor map; TMA
// drops the elements past the tensor's ends.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A barrier of one warpgroup's 128 threads.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Four 8 x 8 b16 matrices of a warp's mma fragments, stored transposed:
// lane 8 i + k gives the address of row k of matrix i (its column k).
__device__ __forceinline__ void stmatrix_t(uint32_t addr,
                                           const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A B for one k-step of 32 bytes: A [64 x 32] and B [32 x N] s8,
// both K-major in shared memory; accumulate = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),
        "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),
        "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),
        "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),
        "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),
        "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]),
        "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]),
        "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),
        "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]),
        "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ------------------------------ Q1 -----------------------------------------

struct Args {
  int Ho, Wo, O;
  int k, stride, pad;
  int nCB;        // channel blocks a tap: ceil(Cp / 128)
  int ksteps;     // k * k * nCB
  int bw, br;     // a pixel tile: br rows of bw output pixels
  int tiles_x;    // pixel tiles along a row: ceil(Wo / bw)
  int tiles_img;  // pixel tiles a frame
  int tiles_o;    // channel tiles: ceil(O / BN)
  int total;      // pixel tiles x channel tiles
  int empty;      // bit m: the stride-2 parity map m holds no element
  int tma_store;  // every tile whole: stored by TMA
  const float* w_scale;
  const float* x_scale;
  const float* bias;
  void* out;
};

struct Maps {
  CUtensorMap a[4];  // the codes; stride 2: one per (row, column) parity
  CUtensorMap b;     // the packed weight
  CUtensorMap out;   // the output, where tma_store
};

struct Tile {
  int n, y0, x0, o0;
};

template <int kBN>
__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int pt = t / a.tiles_o;
  const int n = pt / a.tiles_img, r = pt - n * a.tiles_img;
  const int ty = r / a.tiles_x, tx = r - ty * a.tiles_x;
  return Tile{n, ty * a.br, tx * a.bw, (t - pt * a.tiles_o) * kBN};
}

template <int kMode>
struct Out;
template <>
struct Out<0> {
  using T = float;
};
template <>
struct Out<1> {
  using T = __nv_bfloat16;
};
template <>
struct Out<2> {
  using T = int;
};


// kMode 0: fp32 out, 1: bf16 out, 2: the int32 accumulator. kBN output
// channels a tile, kMB m64 blocks a consumer warpgroup.
template <int kBN, int kMB, int kMode>
struct Q1 {
  using T = typename Out<kMode>::T;
  static constexpr int kBM = 64 * kMB * kConsumers;  // pixels a tile
  static constexpr int kABytes = kBM * kBlockK;
  static constexpr int kBBytes = kBN * kBlockK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages =
      (kSmemLimit - kSwizzleAtom - kBars - kConsumers * kStaging) /
                  kStageBytes > 6
          ? 6
          : (kSmemLimit - kSwizzleAtom - kBars - kConsumers * kStaging) /
                kStageBytes;
  static constexpr int kBytes = static_cast<int>(sizeof(T));
  static constexpr int kPxBox = 128 / kBytes;  // pixels a 128-byte store row
  static constexpr int kChunk =                // channels a staged unit
      kBN < kStaging / (64 * kBytes) ? kBN : kStaging / (64 * kBytes);
  static constexpr int kLaneCols = (kBN + 31) / 32;  // columns a lane loads
  static constexpr int kSmem =
      kStages * kStageBytes + kConsumers * kStaging + kBars + kSwizzleAtom;
  static_assert(kStages >= 3, "the ring needs three stages");
  static_assert(kSmem <= kSmemLimit, "shared memory");
  static_assert(kBN % kChunk == 0 && kChunk % 8 == 0, "staged units");
};

template <int kBN, int kMB, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
qconv_kernel(const __grid_constant__ Maps maps, const Args a) {
  using Q = Q1<kBN, kMB, kMode>;
  using T = typename Q::T;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  uint8_t* smem = aligned_smem(smem_raw, &base);
  auto sA = [&](int s) { return base + s * Q::kStageBytes; };
  auto sB = [&](int s) { return base + s * Q::kStageBytes + Q::kABytes; };
  const uint32_t staging0 = base + Q::kStages * Q::kStageBytes;
  const uint32_t bars = staging0 + kConsumers * kStaging;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (Q::kStages + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Q::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kConsumers) {
    // ---- the producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * kConsumers && lane == 0) {
      const uint32_t a_bytes = kBlockK * a.bw * a.br;
      int it = 0;
      for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
        const Tile tl = tile_of<kBN>(a, t);
        for (int ks = 0; ks < a.ksteps; ++ks, ++it) {
          const int s = it % Q::kStages;
          mbar_wait(empty(s), ((it / Q::kStages) & 1) ^ 1);
          const int tap = ks / a.nCB, cb = ks - tap * a.nCB;
          const int dy = tap / a.k, dx = tap - dy * a.k;
          int m = 0, xc = tl.x0 - a.pad + dx, yc = tl.y0 - a.pad + dy;
          if (a.stride == 2) {
            // input column 2 x + dx - p = 2 j + px in parity map px
            const int ox = dx - a.pad, oy = dy - a.pad;
            const int px = ox & 1, py = oy & 1;
            m = 2 * py + px;
            xc = tl.x0 + ((ox - px) >> 1);
            yc = tl.y0 + ((oy - py) >> 1);
            if ((a.empty >> m) & 1) xc = 1 << 30;  // all zeros
          }
          mbar_expect_tx(full(s), a_bytes + Q::kBBytes);
          tma_load(sA(s), &maps.a[m], full(s), cb * kBlockK, xc, yc, tl.n);
          tma_load_2d(sB(s), &maps.b, full(s), ks * kBlockK, tl.o0);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups: products, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, tq = lane & 3;
    const int tid = threadIdx.x & 127;
    const uint32_t staging = staging0 + wg * kStaging;
    uint8_t* stage_p = smem + (staging - base);
    const float xs = __ldg(a.x_scale);
    bool pending = false;  // thread tid 0: a store reads the buffer
    int acc[kMB][kBN / 2];
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb)
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[mb][i] = 0;

    int it = 0;
    for (int t = blockIdx.x; t < a.total; t += gridDim.x) {
      const Tile tl = tile_of<kBN>(a, t);
      // the tile's x_scale * w_scale[o] and bias[o]: lane l holds column
      // 32 r + l, loaded before the products hide the loads' latency, read
      // by shuffles in the epilogue
      float scr[Q::kLaneCols], bir[Q::kLaneCols];
#pragma unroll
      for (int r = 0; r < Q::kLaneCols; ++r) {
        const int o = tl.o0 + 32 * r + lane;
        scr[r] = 0.f, bir[r] = 0.f;
        if (kMode != 2 && o < a.O) {
          scr[r] = __fmul_rn(xs, __ldg(a.w_scale + o));
          if (a.bias != nullptr) bir[r] = __ldg(a.bias + o);
        }
      }
      // the scale and bias of column 8 j + 2 tq + e1 of the tile
      auto params = [&](int j, int e1, float& sc, float& bo) {
        const int src = 8 * (j & 3) + 2 * tq + e1;
        sc = __shfl_sync(0xffffffffu, scr[j >> 2], src);
        bo = __shfl_sync(0xffffffffu, bir[j >> 2], src);
      };
      auto dequant = [&](int v, float sc, float bo) {
        float f = __fmul_rn(__int2float_rn(v), sc);
        if (a.bias != nullptr) f = __fadd_rn(f, bo);
        return f;
      };
      for (int ks = 0; ks < a.ksteps; ++ks, ++it) {
        const int s = it % Q::kStages;
        mbar_wait(full(s), (it / Q::kStages) & 1);
        wg_fence();
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
          const uint64_t da = desc(sA(s) + (wg * kMB + mb) * 64 * kBlockK);
          const uint64_t db = desc(sB(s));
#pragma unroll
          for (int kk = 0; kk < kBlockK / 32; ++kk)
            wgmma_s8<kBN>(acc[mb], da + 2 * kk, db + 2 * kk,
                          ks > 0 || kk > 0);
        }
        wg_commit();
        // the previous K step's products are done: its stage is free
        wg_wait<1>();
        if (ks > 0 && lane == 0) mbar_arrive(empty((it - 1) % Q::kStages));
      }
      wg_wait<0>();
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) reg_fence(acc[mb]);
      if (lane == 0) mbar_arrive(empty((it - 1) % Q::kStages));

      // ---- the epilogue, a unit of 64 pixels x kChunk channels at a time
      const int p_tile = tl.y0 * a.Wo + tl.x0;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        const int px0 = (wg * kMB + mb) * 64;  // the unit's first pixel
#pragma unroll
        for (int c = 0; c < kBN / Q::kChunk; ++c) {
          const int oc = tl.o0 + c * Q::kChunk;
          if (tid == 0 && pending) bulk_wait_read();
          wg_sync(1 + wg);  // the buffer is free
          if constexpr (kMode == 1) {
            // bf16: an 8 x 8 block (pixels 16 w + 8 h + g, channels 8 jj +
            // 2 tq + e1) is an mma fragment; stmatrix.trans stores its
            // channel rows, 16 bytes of 8 pixels each, 4 blocks a call
            const int mi = lane >> 3, k = lane & 7;
#pragma unroll
            for (int jp = 0; jp < Q::kChunk / 16; ++jp) {
              uint32_t r[4];  // block 2 half + h: n8 group 2 jp + half
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int j = c * Q::kChunk / 8 + 2 * jp + half;
                float sc0, bo0, sc1, bo1;
                params(j, 0, sc0, bo0);
                params(j, 1, sc1, bo1);
#pragma unroll
                for (int h = 0; h < 2; ++h)
                  r[2 * half + h] = pack_bf16(
                      dequant(acc[mb][4 * j + 2 * h], sc0, bo0),
                      dequant(acc[mb][4 * j + 2 * h + 1], sc1, bo1));
              }
              // this lane's address: row k of block mi = (jj 2 jp + mi / 2,
              // h mi % 2), channel 8 jj + k, pixels 16 w + 8 h ..
              const int ch = 8 * (2 * jp + (mi >> 1)) + k;
              stmatrix_t(staging + ch * 128 + (((2 * w + (mi & 1)) ^ k) << 4),
                         r);
            }
          } else {
#pragma unroll
            for (int jj = 0; jj < Q::kChunk / 8; ++jj)
#pragma unroll
              for (int e1 = 0; e1 < 2; ++e1) {
                const int cl = 8 * jj + 2 * tq + e1;
                const int j = c * Q::kChunk / 8 + jj;
                float sc = 0.f, bo = 0.f;
                if (kMode != 2) params(j, e1, sc, bo);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int v = acc[mb][4 * j + 2 * h + e1];
                  const int row = 16 * w + g + 8 * h;  // pixel in the unit
                  const int byte = (row % Q::kPxBox) * Q::kBytes;
                  const int at = (row / Q::kPxBox) * Q::kChunk * 128 +
                                 cl * 128 + (((byte >> 4) ^ (cl & 7)) << 4) +
                                 (byte & 15);
                  T* p = reinterpret_cast<T*>(stage_p + at);
                  if constexpr (kMode == 2)
                    *p = v;
                  else
                    *p = dequant(v, sc, bo);
                }
              }
          }
          fence_proxy_async();
          wg_sync(1 + wg);  // the unit is staged
          if (a.tma_store) {
            if (tid == 0) {
#pragma unroll
              for (int bx = 0; bx < 64 / Q::kPxBox; ++bx)
                tma_store_3d(&maps.out, staging + bx * Q::kChunk * 128,
                             p_tile + px0 + bx * Q::kPxBox, oc, tl.n);
              bulk_commit();
              pending = true;
            }
          } else {
            // a tile that is not whole: copy it out with masks
            T* out = static_cast<T*>(a.out);
            for (int i = tid; i < 64 * Q::kChunk; i += 128) {
              const int col = i >> 6, row = i & 63;
              const int ti = px0 + row;  // pixel in the tile
              const int yy = ti / a.bw, xx = ti - yy * a.bw;
              const int y = tl.y0 + yy, x = tl.x0 + xx, o = oc + col;
              if (yy >= a.br || y >= a.Ho || x >= a.Wo || o >= a.O) continue;
              const int byte = (row % Q::kPxBox) * Q::kBytes;
              const int at = (row / Q::kPxBox) * Q::kChunk * 128 + col * 128 +
                             (((byte >> 4) ^ (col & 7)) << 4) + (byte & 15);
              out[((static_cast<int64_t>(tl.n) * a.O + o) * a.Ho + y) * a.Wo +
                  x] = *reinterpret_cast<const T*>(stage_p + at);
            }
          }
        }
      }
    }
    if (tid == 0 && pending) bulk_wait();
  }
}

// ---------------------------- quantize -------------------------------------

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t code(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(q, -127.f),
                                                      127.f)) & 255);
}

// Eight values of a channel row from p (16-byte aligned where vec).
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(b[i]);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

constexpr int kQPixels = 128, kQChannels = 64, kQThreads = 256;

// Block (n x pixel block) x channel blocks + channel block: a pixel block's
// channel blocks run side by side, so its pixels' rows are written
// together. Thread (cq, po) = (tid / 16,
// tid % 16) reads channels c0 + 4 cq .. + 3 at pixels p0 + 8 po .. + 7 and
// writes, for each pixel, the word of those four channels' codes to
// tile[pixel][cq ^ po] (the XOR spreads a warp's 32 words over the banks);
// then thread e, e + 256 stores pixel e / 4's 16 channels 16 (e % 4) .. as
// one 16-byte store.
template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                int8_t* __restrict__ y, int C, int HW, int Cp) {
  __shared__ uint32_t tile[kQPixels * kQChannels / 4];
  const int cblocks = (Cp + kQChannels - 1) / kQChannels;
  const int blocks = (HW + kQPixels - 1) / kQPixels;
  const int rest = blockIdx.x / cblocks, n = rest / blocks;
  const int c0 = (blockIdx.x - rest * cblocks) * kQChannels;
  const int p0 = (rest - n * blocks) * kQPixels;
  const int tid = threadIdx.x, cq = tid >> 4, po = tid & 15;
  const float s = *scale;
  const bool vec = HW % 8 == 0 && p0 + 8 * po + 8 <= HW;
  uint32_t words[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) words[i] = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = c0 + 4 * cq + r;
    if (c >= C) continue;
    const T* row = x + (static_cast<int64_t>(n) * C + c) * HW + p0 + 8 * po;
    float v[8];
    if (vec) {
      load8(row, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = p0 + 8 * po + i < HW ? as_float(row[i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) words[i] |= code(v[i], s) << (8 * r);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[(8 * po + i) * 16 + (cq ^ po)] = words[i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int e = tid + kQThreads * j, px = e >> 2, qq = e & 3;
    const int p = p0 + px, cbyte = c0 + 16 * qq;
    if (p >= HW || cbyte >= Cp) continue;
    const uint32_t* wp = tile + px * 16;
    const int sw = px >> 3;
    const uint4 v = make_uint4(wp[(4 * qq) ^ sw], wp[(4 * qq + 1) ^ sw],
                               wp[(4 * qq + 2) ^ sw], wp[(4 * qq + 3) ^ sw]);
    *reinterpret_cast<uint4*>(y + (static_cast<int64_t>(n) * HW + p) * Cp +
                              cbyte) = v;
  }
}

// ------------------------------- host --------------------------------------

cudaError_t encode(CUtensorMap* map, CUtensorMapDataType type, int rank,
                   const void* ptr, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kBN, int kMB, int kMode>
cudaError_t launch(const Maps& maps, const Args& a, cudaStream_t stream) {
  using Q = Q1<kBN, kMB, kMode>;
  const auto kernel = qconv_kernel<kBN, kMB, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = a.total < sms ? a.total : sms;
  kernel<<<grid, kThreads, Q::kSmem, stream>>>(maps, a);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t launch_mode(int bn, const Maps& maps, const Args& a,
                        cudaStream_t stream) {
  if (bn == 256) return launch<256, 1, kMode>(maps, a, stream);
  if (bn == 128) return launch<128, 2, kMode>(maps, a, stream);
  return launch<16, 2, kMode>(maps, a, stream);
}

}  // namespace

// x int8 [N, H, W, C] (C: the channels padded to a multiple of 16); w int8
// [O, K] with K = k * k * ceil(C / 128) * 128 (each tap's channels in
// blocks of 128 bytes, zero past the real channels); w_scale fp32 [O];
// x_scale one fp32 on the card; bias fp32 [O] or null; out [N, O, Ho, Wo]
// fp32 (mode 0), bf16 (mode 1) or int32 (mode 2, the accumulator). All
// contiguous, 16-byte aligned. The tile plan (ops/qconv.py's q1_plan): bn
// output channels (16, 128 or 256) by bm pixels (256, 256 or 128), a pixel
// tile br rows of bw output pixels, tma_store where every tile is whole.
// Encodes the tensor maps, launches on `stream` and returns the first
// cudaError_t (0 on success).
extern "C" int ivg_qconv(const int8_t* x, const int8_t* w,
                         const float* w_scale, const float* x_scale,
                         const float* bias, void* out, int N, int H, int W,
                         int C, int O, int Ho, int Wo, int k, int stride,
                         int pad, int K, int mode, int bn, int bm, int bw,
                         int br, int tma_store, void* stream) {
  const int n_cb = (C + kBlockK - 1) / kBlockK;
  const int ob = mode == 1 ? 2 : 4;
  const int64_t P = static_cast<int64_t>(Ho) * Wo;
  const bool whole_rows = bw == Wo && (bw * br == bm || br >= Ho);
  const bool segments = bw == bm && bw < Wo && Wo % bw == 0;
  if (N < 1 || H < 1 || W < 1 || C < 16 || C % 16 != 0 || O < 1 ||
      Ho < 1 || Wo < 1 || (k != 1 && k != 3) || (stride != 1 && stride != 2) ||
      (pad != 0 && pad != 1) || mode < 0 || mode > 2 ||
      Ho != (H + 2 * pad - k) / stride + 1 ||
      Wo != (W + 2 * pad - k) / stride + 1 || K != k * k * n_cb * kBlockK ||
      !((bn == 256 && bm == 128) || ((bn == 128 || bn == 16) && bm == 256)) ||
      bw < 1 || br < 1 || br > Ho || bw * br > bm ||
      !(bw == Wo || (bw == bm && Wo > bm)) ||
      (tma_store && !((P * ob) % 16 == 0 && (whole_rows || segments))))
    return static_cast<int>(cudaErrorInvalidValue);

  Maps maps;
  Args a{};
  a.Ho = Ho, a.Wo = Wo, a.O = O, a.k = k, a.stride = stride, a.pad = pad;
  a.nCB = n_cb, a.ksteps = k * k * n_cb, a.bw = bw, a.br = br;
  a.tiles_x = (Wo + bw - 1) / bw;
  a.tiles_img = a.tiles_x * ((Ho + br - 1) / br);
  a.tiles_o = (O + bn - 1) / bn;
  const int64_t total = static_cast<int64_t>(N) * a.tiles_img * a.tiles_o;
  if (total >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.total = static_cast<int>(total);
  a.tma_store = tma_store;
  a.w_scale = w_scale, a.x_scale = x_scale, a.bias = bias, a.out = out;

  // the codes: (Cp, W, H, N); at stride 2, parity (py, px) holds input
  // pixels (2 j + py, 2 i + px): doubled strides, its own base
  const cuuint32_t a_box[4] = {kBlockK, static_cast<cuuint32_t>(bw),
                               static_cast<cuuint32_t>(br), 1};
  const int maps_a = stride == 1 ? 1 : 4;
  for (int m = 0; m < maps_a; ++m) {
    const int py = m >> 1, px = m & 1;
    int wm = W, hm = H;
    if (stride == 2) {
      wm = (W - px + 1) / 2, hm = (H - py + 1) / 2;
      if (wm < 1 || hm < 1) {  // never read: its boxes are all zeros
        a.empty |= 1 << m;
        wm = hm = 1;
      }
    }
    const int8_t* ptr = (a.empty >> m) & 1
                            ? x
                            : x + (static_cast<int64_t>(py) * W + px) * C;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                                static_cast<cuuint64_t>(wm),
                                static_cast<cuuint64_t>(hm),
                                static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[3] = {
        static_cast<cuuint64_t>(C) * stride,
        static_cast<cuuint64_t>(W) * C * stride,
        static_cast<cuuint64_t>(H) * W * C};
    const cudaError_t err =
        encode(&maps.a[m], CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, ptr, dims,
               strides, a_box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int m = maps_a; m < 4; ++m) maps.a[m] = maps.a[0];
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(O)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
    const cuuint32_t box[2] = {kBlockK, static_cast<cuuint32_t>(bn)};
    const cudaError_t err =
        encode(&maps.b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, dims, strides,
               box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tma_store) {
    // the output: (Ho * Wo, O, N), a box of 128 bytes of pixels by the
    // staged unit's channels
    const int chunk = bn < kStaging / (64 * ob) ? bn : kStaging / (64 * ob);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P),
                                static_cast<cuuint64_t>(O),
                                static_cast<cuuint64_t>(N)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P) * ob,
                                   static_cast<cuuint64_t>(P) * O * ob};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / ob),
                               static_cast<cuuint32_t>(chunk), 1};
    const cudaError_t err = encode(
        &maps.out,
        mode == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                  : (mode == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_INT32),
        3, out, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    maps.out = maps.b;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0)
    err = launch_mode<0>(bn, maps, a, s);
  else if (mode == 1)
    err = launch_mode<1>(bn, maps, a, s);
  else
    err = launch_mode<2>(bn, maps, a, s);
  return static_cast<int>(err);
}

// Q1's dynamic shared memory for a tile of bn channels writing mode's
// type, as ivg_qconv launches it (bytes; 0 for a bn it does not take).
extern "C" int ivg_qconv_smem(int bn, int mode) {
  if (bn == 256)
    return mode == 1 ? Q1<256, 1, 1>::kSmem : Q1<256, 1, 0>::kSmem;
  if (bn == 128)
    return mode == 1 ? Q1<128, 2, 1>::kSmem : Q1<128, 2, 0>::kSmem;
  if (bn == 16) return mode == 1 ? Q1<16, 2, 1>::kSmem : Q1<16, 2, 0>::kSmem;
  return 0;
}

// x [N, C, H*W] bf16 (is_bf16=1) or fp32, 16-byte aligned; scale one fp32 on
// the card; y int8 [N, H*W, Cp], Cp a multiple of 16 and at least C (the
// padding channels written 0). Returns the launch's cudaError_t.
extern "C" int ivg_quantize_nhwc(const void* x, const float* scale,
                                 int8_t* y, int N, int C, int HW, int Cp,
                                 int is_bf16, void* stream) {
  const int64_t blocks = static_cast<int64_t>(N) *
                        ((HW + kQPixels - 1) / kQPixels) *
                        ((Cp + kQChannels - 1) / kQChannels);
  if (N < 1 || C < 1 || HW < 1 || Cp % 16 != 0 || Cp < C ||
      blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_kernel<<<grid, kQThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, y, C, HW, Cp);
  else
    quantize_kernel<<<grid, kQThreads, 0, s>>>(static_cast<const float*>(x),
                                               scale, y, C, HW, Cp);
  return static_cast<int>(cudaGetLastError());
}
