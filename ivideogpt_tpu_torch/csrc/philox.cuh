// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC 2011; the Random123 constants) and the attention-dropout mask that
// K4, K5 and K6 draw from it. ops/philox.py computes the same bits in
// torch; the two must agree bit for bit.
//
// The generator: a 4 x 32-bit counter c and a 2 x 32-bit key k, ten rounds
//   (hi0, lo0) = 0xD2511F53 * c0,  (hi1, lo1) = 0xCD9E8D57 * c2  (64-bit)
//   c = (hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0)
// with the key bumped by the Weyl constants (0x9E3779B9, 0xBB67AE85)
// before every round but the first. Known answers (Random123's kat_vectors):
//   c = 0, k = 0                   -> 6627e8d5 e169c58d bc57ac4c 9b00dbd8
//   c = ffffffff x 4, k = ffffffff x 2
//                                  -> 408f276d 41c83b0e a20bc7c6 6d5451fd
//   c = 243f6a88 85a308d3 13198a2e 03707344, k = a4093822 299f31d0
//                                  -> d16cfe09 94fdcceb 5001e420 24126ea1
//
// The dropout mask. Element (b, h, i, j) of the [B, H, S, S] attention
// probabilities (query i, key j) is kept with probability keep = 1 - p:
//   row  = (b * H + h) * S + i
//   ctr  = row * ceil(S / 4) + (j >> 2)              (64-bit)
//   c    = (lo32(ctr), hi32(ctr), lo32(offset), hi32(offset))
//   k    = (lo32(seed), hi32(seed))
//   keep iff philox(c, k)[j & 3] < threshold,  threshold = floor(keep * 2^32)
// That is the linear index ((b H + h) S + i) * 4 ceil(S/4) + j of the
// probabilities with each row padded to a multiple of 4 keys, divided by 4,
// the remainder choosing the word: one Philox call serves 4 consecutive
// keys of a row. The bit is a pure function of (seed, offset, b, h, i, j,
// S) and of nothing a kernel chooses (tile sizes, the grid, the warp
// layout, padding of the ragged tile). A kept element is scaled by
// scale = 1 / keep.
//
// A shard. A data- or tensor-parallel rank holds a block of that global
// [B, H] batch of heads: its B' rows from global row b0 on, its H' heads
// from global head h0 on, of Hg heads in all. Its local (b', h') is the
// global (b0 + b', h0 + h'), so it draws row ((b0 + b') Hg + h0 + h') S + i:
// the bits that a launch over the whole batch draws there. A call that
// holds the whole batch is the shard (0, 0, H).
//
// How a kernel draws it: K4, K5 and K6, bf16 (flash_attention_sm90.cu) and
// fp32 (flash_attention_tf32.cu), draw a whole 64 x 64 tile's bits into
// shared memory once, one call per group (draw_keep_tile), and read them
// through sm90.cuh's drop_rows (K4, K6) or p_ds_transposed (K5).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ivg {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u, kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u, kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The dropout arguments of one attention call, passed to a kernel by value.
struct Dropout {
  uint64_t seed, offset;
  uint32_t threshold;  // keep iff the word < threshold
  float scale;         // 1 / keep
  int n4;              // ceil(S / 4): Philox groups in a row
  int b0, h0, Hg;      // the shard: first global batch row, first global
                       // head, global head count
};

// The dropout of probability p (0 < p < 1) over rows of S keys, of the
// shard (b0, h0, Hg); all zero for p <= 0, which the kernels never read
// (they launch without dropout).
inline Dropout make_dropout(double p, uint64_t seed, uint64_t offset, int S,
                            int b0, int h0, int Hg) {
  Dropout d{};
  if (!(p > 0.0)) return d;
  d.seed = seed;
  d.offset = offset;
  d.threshold = static_cast<uint32_t>((1.0 - p) * 4294967296.0);
  d.scale = static_cast<float>(1.0 / (1.0 - p));
  d.n4 = (S + 3) / 4;
  d.b0 = b0;
  d.h0 = h0;
  d.Hg = Hg;
  return d;
}

// A shard that is not a block of a global batch of heads whose indices fit
// an int: B rows from b0, H heads from h0, of Hg.
inline bool bad_shard(int B, int H, int b0, int h0, int Hg) {
  return b0 < 0 || h0 < 0 || Hg < 1 || static_cast<int64_t>(h0) + H > Hg ||
         (static_cast<int64_t>(b0) + B) * Hg > 0x7fffffff;
}

// The Philox counter of query 0, key 0 of the local head (b, h): row
// ((b0 + b) Hg + h0 + h) S of the global batch times ceil(S / 4). Computed
// once a CTA, before its loop; a tile adds its query's and key's offset.
__device__ __forceinline__ uint64_t head_counter(const Dropout& d, int b,
                                                 int h, int S) {
  return static_cast<uint64_t>((d.b0 + b) * d.Hg + d.h0 + h) *
         static_cast<uint64_t>(S) * static_cast<uint64_t>(d.n4);
}


// The keep bits of a tile of 64 queries x 64 keys, drawn once by a
// warpgroup into shared memory for the tile's elements to read: word
// 2 r + w of `bits` holds keys j0 + 32 w .. j0 + 32 w + 31 of query i0 + r,
// key j0 + 32 w + n at bit n (1: kept); 128 words, 512 B.
constexpr int kKeepRows = 64;
constexpr int kKeepWords = 2 * kKeepRows;

// acc shifted left by one, bit 0 set where w >= thr (w's element dropped):
// the borrow of w - thr, shifted in by an add with carry, two integer
// instructions, where a compare, a select and an or take three.
__device__ __forceinline__ uint32_t shift_in_dropped(uint32_t acc, uint32_t w,
                                                     uint32_t thr) {
  uint32_t out;
  asm("{\n.reg .u32 t;\nsub.cc.u32 t, %1, %2;\naddc.u32 %0, %3, %3;\n}\n"
      : "=r"(out)
      : "r"(w), "r"(thr), "r"(acc));
  return out;
}

// The 32 keep bits of the 8 groups from group counter `ctr` on (32
// consecutive keys of one row, the first a multiple of 4), key n at bit n:
// one Philox call a group. The calls are independent and unrolled, so that
// their ten-round chains interleave; they share the key schedule.
__device__ __forceinline__ uint32_t keep_word(const Dropout& d, uint64_t ctr) {
  const uint2 key = make_uint2(static_cast<uint32_t>(d.seed),
                               static_cast<uint32_t>(d.seed >> 32));
  uint32_t dropped = 0;  // key 31 shifted in first, so key n ends at bit n
#pragma unroll
  for (int u = 7; u >= 0; --u) {
    const uint64_t c = ctr + static_cast<uint64_t>(u);
    const uint4 w = philox4x32_10(
        make_uint4(static_cast<uint32_t>(c), static_cast<uint32_t>(c >> 32),
                   static_cast<uint32_t>(d.offset),
                   static_cast<uint32_t>(d.offset >> 32)),
        key);
    dropped = shift_in_dropped(dropped, w.w, d.threshold);
    dropped = shift_in_dropped(dropped, w.z, d.threshold);
    dropped = shift_in_dropped(dropped, w.y, d.threshold);
    dropped = shift_in_dropped(dropped, w.x, d.threshold);
  }
  return ~dropped;
}

// Draws the keep tile of queries i0 .. i0 + 63 and keys j0 .. j0 + 63 (j0 a
// multiple of 4, so the tile holds whole groups) of the head whose counter
// is `head_ctr` (head_counter) into `bits` (shared memory), with the 128
// threads of a warpgroup: thread x draws word 2 (x & 63) + (x >> 6), its
// row's 8 groups, one call each; warps 0-1 take keys j0 .. j0 + 31, warps
// 2-3 the rest. So a tile costs one call per group, at most 1024. A word
// that changes no output is not drawn and keeps what it held: a query at or
// past S (K4 never stores its O, K5 zeroes its P, K6 its dS and never
// stores its dQ), and 32 keys that all lie past their query (on the
// diagonal tile; there warp 2 skips as a whole), whose P is 0. The caller
// publishes the words with a barrier.
__device__ __forceinline__ void draw_keep_tile(const Dropout& d,
                                               uint64_t head_ctr, int S,
                                               int i0, int j0,
                                               uint32_t* bits) {
  const int r = threadIdx.x & (kKeepRows - 1), half = threadIdx.x >> 6;
  const int i = i0 + r, j = j0 + 32 * half;
  if (i < S && j <= i)
    bits[2 * r + half] = keep_word(
        d, head_ctr + static_cast<uint64_t>(i) * static_cast<uint64_t>(d.n4) +
               static_cast<uint64_t>(j >> 2));
  __syncwarp();  // converged again for the warpgroup's aligned instructions
}

}  // namespace ivg
