// Baseline JPEG decoder for the Something-Something v2 frame reader
// (data/jpeg.py), host C++17 with a plain C interface loaded through ctypes.
//
// It reproduces libjpeg's decode at the defaults an image library leaves in
// place: the islow integer IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2,
// the post-IDCT range limit), fancy upsampling as jdsample.c does it
// (h2v1_fancy_upsample for 4:2:2, h2v2_fancy_upsample for 4:2:0, the box
// upsamplers where the chroma is at most 2 samples wide), no merged
// upsampler, and jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16).
// The colour space follows jdapimin.c's rule: a JFIF marker means YCbCr; an
// Adobe marker with transform 0, or component ids 'R' 'G' 'B', means RGB.
//
// Supported: SOF0 and SOF1 at 8-bit precision, one or three components,
// sampling 4:4:4, 4:2:2 and 4:2:0, Huffman coding, restart intervals, DQT
// with 8- and 16-bit entries, APPn and COM skipped. Refused with an error:
// progressive, lossless, hierarchical and arithmetic-coded files, other
// precisions, two or four components, other sampling factors, a sequential
// file of more than one scan, DNL, and data that ends early.
//
// The decoder is reentrant: it keeps no global state, and its only memory is
// the scratch buffer the caller passes (ivg_jpeg_header gives its size).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

enum Status { OK = 0, CORRUPT = 1, UNSUPPORTED = 2, TRUNCATED = 3, BUFFER = 4 };

struct Error {
  int code = OK;
  char *msg = nullptr;
  size_t len = 0;
};

// Records the first error; later ones are ignored.
int fail(Error &e, int code, const char *fmt, int a = 0, int b = 0) {
  if (e.code == OK) {
    e.code = code;
    if (e.msg && e.len) std::snprintf(e.msg, e.len, fmt, a, b);
  }
  return code;
}

// natural-order index of the k-th zigzag coefficient
constexpr uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kFastBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t values[256];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // values[] index of a length's first code, minus it
  uint16_t fast[1 << kFastBits];  // (length << 8) | value, 0 if longer
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;               // the scan's DC and AC table
  int dw = 0, dh = 0;               // downsampled width and height
  int bw = 0, bh = 0;               // blocks a row and rows of blocks
  int pw = 0, ph = 0;               // plane width and height (bw*8, bh*8)
  uint8_t *plane = nullptr;
  uint8_t *row = nullptr;           // one upsampled row
  int last_dc = 0;
};

struct Decoder {
  const uint8_t *data = nullptr;
  size_t size = 0, pos = 0;
  Error err;

  int16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;

  bool sof = false;
  int width = 0, height = 0, ncomp = 0;
  Component comp[3];
  int hmax = 1, vmax = 1;
  int scan_order[3] = {0, 1, 2};
  int scans = 0;

  // the entropy-coded segment's bit reader
  uint64_t acc = 0;
  int nbits = 0;
  int fake_bits = 0;   // zero bits appended past the segment's end
  bool at_marker = false;
};

uint16_t be16(const uint8_t *p) { return uint16_t(p[0] << 8 | p[1]); }

// ------------------------------------------------------------------ markers

// Reads a marker at d.pos, skipping fill bytes; returns its code or -1.
int read_marker(Decoder &d) {
  if (d.pos + 1 >= d.size || d.data[d.pos] != 0xFF) return -1;
  size_t p = d.pos + 1;
  while (p < d.size && d.data[p] == 0xFF) ++p;
  if (p >= d.size) return -1;
  d.pos = p + 1;
  return d.data[p];
}

// The payload of a marker segment at d.pos: sets *seg and *len.
bool segment(Decoder &d, const uint8_t **seg, int *len) {
  if (d.pos + 2 > d.size)
    return fail(d.err, TRUNCATED, "the data ends inside a marker segment"), false;
  int n = be16(d.data + d.pos);
  if (n < 2 || d.pos + n > d.size)
    return fail(d.err, TRUNCATED, "the data ends inside a marker segment"), false;
  *seg = d.data + d.pos + 2;
  *len = n - 2;
  d.pos += n;
  return true;
}

bool parse_dqt(Decoder &d, const uint8_t *p, int n) {
  while (n > 0) {
    int pq = p[0] >> 4, tq = p[0] & 15;
    int bytes = pq ? 128 : 64;
    if (tq > 3 || pq > 1 || n < 1 + bytes)
      return fail(d.err, CORRUPT, "a bad DQT segment"), false;
    for (int k = 0; k < 64; ++k) {
      int q = pq ? be16(p + 1 + 2 * k) : p[1 + k];
      // jddctmgr.c keeps the islow multipliers as short
      d.quant[tq][kNatural[k]] = int16_t(q);
    }
    d.quant_defined[tq] = true;
    p += 1 + bytes;
    n -= 1 + bytes;
  }
  return true;
}

bool build_huffman(Decoder &d, Huffman &t, const uint8_t *counts,
                   const uint8_t *vals, int total) {
  std::memcpy(t.values, vals, total);
  std::memset(t.fast, 0, sizeof t.fast);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    int c = counts[len - 1];
    t.valoffset[len] = k - code;
    // as jdhuff.c: a length's codes fit in its bits, none all ones
    if (c && code + c >= (int32_t(1) << len))
      return fail(d.err, CORRUPT, "a bad Huffman table"), false;
    if (c) {
      for (int i = 0; i < c; ++i, ++k, ++code) {
        if (len <= kFastBits) {
          int shift = kFastBits - len;
          for (int f = 0; f < (1 << shift); ++f)
            t.fast[(code << shift) | f] = uint16_t(len << 8 | vals[k]);
        }
      }
      t.maxcode[len] = code - 1;
    } else {
      t.maxcode[len] = -1;
    }
    code <<= 1;
  }
  t.maxcode[17] = 0x7FFFFFFF;
  t.defined = true;
  return true;
}

bool parse_dht(Decoder &d, const uint8_t *p, int n) {
  while (n > 0) {
    if (n < 17) return fail(d.err, CORRUPT, "a bad DHT segment"), false;
    int tc = p[0] >> 4, th = p[0] & 15;
    int total = 0;
    for (int i = 0; i < 16; ++i) total += p[1 + i];
    if (tc > 1 || th > 3 || total > 256 || n < 17 + total)
      return fail(d.err, CORRUPT, "a bad DHT segment"), false;
    if (!build_huffman(d, tc ? d.ac[th] : d.dc[th], p + 1, p + 17, total))
      return false;
    p += 17 + total;
    n -= 17 + total;
  }
  return true;
}

bool parse_sof(Decoder &d, const uint8_t *p, int n) {
  if (d.sof) return fail(d.err, CORRUPT, "two SOF markers"), false;
  d.sof = true;
  if (n < 6) return fail(d.err, CORRUPT, "a bad SOF segment"), false;
  int precision = p[0];
  d.height = be16(p + 1);
  d.width = be16(p + 3);
  int nc = p[5];
  if (precision != 8)
    return fail(d.err, UNSUPPORTED, "%d-bit precision (only 8-bit is "
                "supported)", precision), false;
  if (d.height == 0)
    return fail(d.err, UNSUPPORTED, "a height of 0 (defined by a DNL "
                "marker)"), false;
  if (d.width == 0) return fail(d.err, CORRUPT, "a width of 0"), false;
  if (nc == 4)
    return fail(d.err, UNSUPPORTED, "four components (CMYK or YCCK)"), false;
  if (nc != 1 && nc != 3)
    return fail(d.err, UNSUPPORTED, "%d components (1 or 3 are supported)",
                nc), false;
  if (n < 6 + 3 * nc) return fail(d.err, CORRUPT, "a bad SOF segment"), false;
  d.ncomp = nc;
  for (int c = 0; c < nc; ++c) {
    Component &k = d.comp[c];
    k.id = p[6 + 3 * c];
    k.h = p[7 + 3 * c] >> 4;
    k.v = p[7 + 3 * c] & 15;
    k.tq = p[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
      return fail(d.err, CORRUPT, "bad sampling factors or table ids"), false;
  }
  if (nc == 1) d.comp[0].h = d.comp[0].v = 1;  // one block an MCU whatever
  d.hmax = d.vmax = 1;
  for (int c = 0; c < nc; ++c) {
    if (d.comp[c].h > d.hmax) d.hmax = d.comp[c].h;
    if (d.comp[c].v > d.vmax) d.vmax = d.comp[c].v;
  }
  int blocks = 0;
  for (int c = 0; c < nc; ++c) {
    Component &k = d.comp[c];
    int rh = d.hmax / k.h, rv = d.vmax / k.v;
    bool ok = d.hmax % k.h == 0 && d.vmax % k.v == 0 && k.h <= 2 && k.v <= 2 &&
              ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
               (rh == 2 && rv == 2));
    if (!ok)
      return fail(d.err, UNSUPPORTED, "sampling factors %dx%d (4:4:4, 4:2:2 "
                  "and 4:2:0 are supported)", k.h, k.v), false;
    blocks += k.h * k.v;
  }
  if (blocks > 10)
    return fail(d.err, CORRUPT, "sampling factors too large for an "
                "interleaved scan"), false;
  return true;
}

// Plane geometry of every component, and the scratch bytes it needs.
size_t layout(Decoder &d) {
  size_t bytes = 0;
  int mcux = (d.width + 8 * d.hmax - 1) / (8 * d.hmax);
  int mcuy = (d.height + 8 * d.vmax - 1) / (8 * d.vmax);
  for (int c = 0; c < d.ncomp; ++c) {
    Component &k = d.comp[c];
    k.dw = int((int64_t(d.width) * k.h + d.hmax - 1) / d.hmax);
    k.dh = int((int64_t(d.height) * k.v + d.vmax - 1) / d.vmax);
    if (d.ncomp == 1) {
      k.bw = (k.dw + 7) / 8;
      k.bh = (k.dh + 7) / 8;
    } else {
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
    }
    k.pw = 8 * k.bw;
    k.ph = 8 * k.bh;
    bytes += size_t(k.pw) * k.ph + 2 * size_t(k.pw) + 64;
  }
  return bytes;
}

bool parse_sos(Decoder &d, const uint8_t *p, int n) {
  if (!d.sof) return fail(d.err, CORRUPT, "SOS before SOF"), false;
  if (++d.scans > 1)
    return fail(d.err, UNSUPPORTED, "a sequential file of more than one "
                "scan"), false;
  if (n < 1) return fail(d.err, CORRUPT, "a bad SOS segment"), false;
  int ns = p[0];
  if (n < 4 + 2 * ns) return fail(d.err, CORRUPT, "a bad SOS segment"), false;
  if (ns != d.ncomp)
    return fail(d.err, UNSUPPORTED, "a scan of %d of %d components (a "
                "sequential file of more than one scan)", ns, d.ncomp), false;
  bool seen[3] = {false, false, false};
  for (int i = 0; i < ns; ++i) {
    int id = p[1 + 2 * i], c = 0;
    while (c < d.ncomp && d.comp[c].id != id) ++c;
    if (c == d.ncomp || seen[c])
      return fail(d.err, CORRUPT, "a bad component id %d in SOS", id), false;
    seen[c] = true;
    d.scan_order[i] = c;
    d.comp[c].td = p[2 + 2 * i] >> 4;
    d.comp[c].ta = p[2 + 2 * i] & 15;
    if (d.comp[c].td > 3 || d.comp[c].ta > 3)
      return fail(d.err, CORRUPT, "a bad Huffman table id in SOS"), false;
    if (!d.dc[d.comp[c].td].defined || !d.ac[d.comp[c].ta].defined)
      return fail(d.err, CORRUPT, "a scan uses an undefined Huffman "
                  "table"), false;
    if (!d.quant_defined[d.comp[c].tq])
      return fail(d.err, CORRUPT, "a component uses an undefined "
                  "quantization table"), false;
  }
  int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], a = p[3 + 2 * ns];
  if (ss != 0 || se != 63 || a != 0)
    return fail(d.err, CORRUPT, "bad spectral selection in a sequential "
                "scan"), false;
  return true;
}

// ---------------------------------------------------------------- bit reader

void fill(Decoder &d) {
  while (d.nbits <= 56) {
    uint32_t byte = 0;
    if (d.at_marker || d.pos >= d.size) {
      d.at_marker = true;
      d.fake_bits += 8;
    } else if (d.data[d.pos] != 0xFF) {
      byte = d.data[d.pos++];
    } else {
      size_t p = d.pos + 1;
      while (p < d.size && d.data[p] == 0xFF) ++p;
      if (p < d.size && d.data[p] == 0) {
        byte = 0xFF;
        d.pos = p + 1;
      } else {
        // a marker (or the end): leave d.pos at its last 0xFF
        d.pos = p - 1;
        d.at_marker = true;
        d.fake_bits += 8;
      }
    }
    d.acc |= uint64_t(byte) << (56 - d.nbits);
    d.nbits += 8;
  }
}

inline int get_bits(Decoder &d, int n) {
  if (n == 0) return 0;
  if (d.nbits < n) fill(d);
  int v = int(d.acc >> (64 - n));
  d.acc <<= n;
  d.nbits -= n;
  return v;
}

inline int extend(int v, int n) {
  return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
}

inline int decode_symbol(Decoder &d, const Huffman &t) {
  if (d.nbits < 16) fill(d);
  int look = int(d.acc >> (64 - kFastBits));
  int f = t.fast[look];
  if (f) {
    int len = f >> 8;
    d.acc <<= len;
    d.nbits -= len;
    return f & 0xFF;
  }
  int32_t code = int32_t(d.acc >> (64 - kFastBits));
  int len = kFastBits;
  while (len <= 16 && code > t.maxcode[len]) {
    ++len;
    code = int32_t(d.acc >> (64 - len));
  }
  if (len > 16) return -1;
  d.acc <<= len;
  d.nbits -= len;
  return t.values[t.valoffset[len] + code];
}

// Moves d.pos to the next marker (past leftover bits) and reads it.
int next_marker(Decoder &d) {
  d.acc = 0;
  d.nbits = 0;
  d.fake_bits = 0;
  d.at_marker = false;
  while (d.pos + 1 < d.size &&
         !(d.data[d.pos] == 0xFF && d.data[d.pos + 1] != 0 &&
           d.data[d.pos + 1] != 0xFF) &&
         !(d.data[d.pos] == 0xFF && d.data[d.pos + 1] == 0xFF))
    ++d.pos;
  return read_marker(d);
}

// ---------------------------------------------------------------------- IDCT

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: the low 10 bits of x as a signed value,
// recentred by 128 and clamped to [0, 255]
inline uint8_t range_limit(int64_t x) {
  int v = int(((x & 1023) ^ 512) - 512);
  v += 128;
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// jidctint.c's jpeg_idct_islow, coefficients in natural order
void idct_islow(const int16_t *coef, const int16_t *q, uint8_t *out,
                int stride) {
  int32_t ws[64];  // the workspace is int, as jidctint.c's
  for (int c = 0; c < 8; ++c) {
    const int16_t *in = coef + c;
    const int16_t *qt = q + c;
    int32_t *w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int64_t dc = (int64_t(in[0]) * qt[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qt[16], z3 = int64_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    const int sh = kConstBits - kPass1Bits;
    w[0] = int32_t(descale(tmp10 + tmp3, sh));
    w[56] = int32_t(descale(tmp10 - tmp3, sh));
    w[8] = int32_t(descale(tmp11 + tmp2, sh));
    w[48] = int32_t(descale(tmp11 - tmp2, sh));
    w[16] = int32_t(descale(tmp12 + tmp1, sh));
    w[40] = int32_t(descale(tmp12 - tmp1, sh));
    w[24] = int32_t(descale(tmp13 + tmp0, sh));
    w[32] = int32_t(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t *w = ws + 8 * r;
    uint8_t *o = out + r * stride;
    const int sh = kConstBits + kPass1Bits + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = range_limit(descale(w[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;

    o[0] = range_limit(descale(tmp10 + tmp3, sh));
    o[7] = range_limit(descale(tmp10 - tmp3, sh));
    o[1] = range_limit(descale(tmp11 + tmp2, sh));
    o[6] = range_limit(descale(tmp11 - tmp2, sh));
    o[2] = range_limit(descale(tmp12 + tmp1, sh));
    o[5] = range_limit(descale(tmp12 - tmp1, sh));
    o[3] = range_limit(descale(tmp13 + tmp0, sh));
    o[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// ------------------------------------------------------------ entropy decode

bool decode_block(Decoder &d, Component &k, int16_t *coef) {
  std::memset(coef, 0, 64 * sizeof(int16_t));
  int s = decode_symbol(d, d.dc[k.td]);
  if (s < 0 || s > 15)
    return fail(d.err, CORRUPT, "a corrupt Huffman code"), false;
  int diff = s ? extend(get_bits(d, s), s) : 0;
  // jdhuff.c adds in unsigned arithmetic and stores a short
  k.last_dc = int(uint32_t(k.last_dc) + uint32_t(diff));
  coef[0] = int16_t(k.last_dc);
  const Huffman &ac = d.ac[k.ta];
  for (int i = 1; i < 64; ++i) {
    int rs = decode_symbol(d, ac);
    if (rs < 0) return fail(d.err, CORRUPT, "a corrupt Huffman code"), false;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      i += r;
      if (i > 63)
        return fail(d.err, CORRUPT, "a corrupt Huffman code (coefficient "
                    "index past 63)"), false;
      coef[kNatural[i]] = int16_t(extend(get_bits(d, s), s));
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
  return true;
}

bool decode_scan(Decoder &d) {
  int16_t coef[64];
  int mcux, mcuy;
  if (d.ncomp == 1) {
    mcux = d.comp[0].bw;
    mcuy = d.comp[0].bh;
  } else {
    mcux = (d.width + 8 * d.hmax - 1) / (8 * d.hmax);
    mcuy = (d.height + 8 * d.vmax - 1) / (8 * d.vmax);
  }
  int restarts_to_go = d.restart_interval, next_rst = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (d.restart_interval) {
        if (restarts_to_go == 0) {
          int m = next_marker(d);
          if (m < 0)
            return fail(d.err, TRUNCATED, "the data ends before a restart "
                        "marker"), false;
          if (m != 0xD0 + next_rst)
            return fail(d.err, CORRUPT, "marker 0x%02X where RST%d was "
                        "expected", m, next_rst), false;
          next_rst = (next_rst + 1) & 7;
          for (int c = 0; c < d.ncomp; ++c) d.comp[c].last_dc = 0;
          restarts_to_go = d.restart_interval;
        }
        --restarts_to_go;
      }
      for (int i = 0; i < d.ncomp; ++i) {
        Component &k = d.comp[d.scan_order[i]];
        const int16_t *q = d.quant[k.tq];
        for (int v = 0; v < k.v; ++v) {
          for (int h = 0; h < k.h; ++h) {
            if (!decode_block(d, k, coef)) return false;
            int bx = mx * k.h + h, by = my * k.v + v;
            idct_islow(coef, q, k.plane + size_t(by) * 8 * k.pw + bx * 8,
                       k.pw);
          }
        }
      }
      if (d.nbits < d.fake_bits)
        return fail(d.err, TRUNCATED, "the entropy-coded data ends early "
                    "(at MCU %d of %d)", my * mcux + mx + 1,
                    mcux * mcuy), false;
    }
  }
  return true;
}

// ------------------------------------------------- upsampling and colour

// Row y of component k upsampled to full width (at least d.width samples).
const uint8_t *upsampled_row(const Decoder &d, const Component &k, int y) {
  int rh = d.hmax / k.h, rv = d.vmax / k.v;
  if (rh == 1) return k.plane + size_t(y) * k.pw;
  const int w = k.dw;
  uint8_t *out = k.row;
  if (rv == 1) {
    const uint8_t *in = k.plane + size_t(y) * k.pw;
    if (w <= 2) {  // jdsample.c h2v1_upsample
      for (int i = 0; i < w; ++i) out[2 * i] = out[2 * i + 1] = in[i];
      return out;
    }
    // h2v1_fancy_upsample
    out[0] = in[0];
    out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < w - 1; ++i) {
      int v = in[i] * 3;
      out[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
    }
    out[2 * w - 2] = uint8_t((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
    out[2 * w - 1] = in[w - 1];
    return out;
  }
  int r0 = y >> 1;
  const uint8_t *in0 = k.plane + size_t(r0) * k.pw;
  if (w <= 2) {  // h2v2_upsample
    for (int i = 0; i < w; ++i) out[2 * i] = out[2 * i + 1] = in0[i];
    return out;
  }
  // h2v2_fancy_upsample: the nearer row (3/4) and the row above for even
  // output rows, below for odd ones; the first and last real rows stand in
  // for the rows beyond them (jdmainct.c's context pointers)
  int r1 = (y & 1) ? r0 + 1 : r0 - 1;
  if (r1 < 0) r1 = 0;
  if (r1 > k.dh - 1) r1 = k.dh - 1;
  const uint8_t *in1 = k.plane + size_t(r1) * k.pw;
  int this_sum = in0[0] * 3 + in1[0];
  int next_sum = in0[1] * 3 + in1[1];
  out[0] = uint8_t((this_sum * 4 + 8) >> 4);
  out[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int i = 1; i < w - 1; ++i) {
    next_sum = in0[i + 1] * 3 + in1[i + 1];
    out[2 * i] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * i + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * w - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * w - 1] = uint8_t((this_sum * 4 + 7) >> 4);
  return out;
}

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

void write_rgb(const Decoder &d, uint8_t *rgb) {
  const int W = d.width;
  if (d.ncomp == 1) {
    for (int y = 0; y < d.height; ++y) {
      const uint8_t *g = d.comp[0].plane + size_t(y) * d.comp[0].pw;
      uint8_t *o = rgb + size_t(y) * W * 3;
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
    }
    return;
  }
  // jdapimin.c's colour-space guess for three components
  bool is_rgb;
  if (d.jfif)
    is_rgb = false;
  else if (d.adobe)
    is_rgb = d.adobe_transform == 0;
  else
    is_rgb = d.comp[0].id == 'R' && d.comp[1].id == 'G' && d.comp[2].id == 'B';

  // jdcolor.c's build_ycc_rgb_table
  const int kScale = 16;
  const int32_t half = int32_t(1) << (kScale - 1);
  auto fix = [](double x) { return int32_t(x * (1 << 16) + 0.5); };
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int32_t x = i - 128;
    cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
    cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + half;
  }
  for (int y = 0; y < d.height; ++y) {
    const uint8_t *c0 = upsampled_row(d, d.comp[0], y);
    const uint8_t *c1 = upsampled_row(d, d.comp[1], y);
    const uint8_t *c2 = upsampled_row(d, d.comp[2], y);
    uint8_t *o = rgb + size_t(y) * W * 3;
    if (is_rgb) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {
      int Y = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x] = clamp255(Y + cr_r[cr]);
      o[3 * x + 1] = clamp255(Y + int((cb_g[cb] + cr_g[cr]) >> kScale));
      o[3 * x + 2] = clamp255(Y + cb_b[cb]);
    }
  }
}

// ------------------------------------------------------------ entry points

// Reads the markers up to the first SOS (decode) or to SOF (header only).
bool read_headers(Decoder &d, bool to_scan) {
  d.pos = 0;
  if (d.size < 2 || d.data[0] != 0xFF || d.data[1] != 0xD8)
    return fail(d.err, CORRUPT, "not a JPEG file (no SOI marker)"), false;
  d.pos = 2;
  for (;;) {
    int m = read_marker(d);
    if (m < 0) {
      if (d.pos + 1 >= d.size)
        return fail(d.err, TRUNCATED, "the data ends before the scan"), false;
      return fail(d.err, CORRUPT, "garbage where a marker was expected"),
             false;
    }
    const uint8_t *p;
    int n;
    if (m == 0xD8) return fail(d.err, CORRUPT, "a second SOI marker"), false;
    if (m == 0xD9)
      return fail(d.err, TRUNCATED, "EOI before the image data"), false;
    if (m >= 0xD0 && m <= 0xD7)
      return fail(d.err, CORRUPT, "RST%d outside the scan", m - 0xD0), false;
    if (!segment(d, &p, &n)) return false;
    switch (m) {
      case 0xC0:
      case 0xC1:
        if (!parse_sof(d, p, n)) return false;
        if (!to_scan) return true;
        break;
      case 0xC2:
      case 0xC6:
        return fail(d.err, UNSUPPORTED, "a progressive file (SOF%d)",
                    m - 0xC0), false;
      case 0xC3:
      case 0xC7:
        return fail(d.err, UNSUPPORTED, "a lossless file (SOF%d)", m - 0xC0),
               false;
      case 0xC5:
        return fail(d.err, UNSUPPORTED, "a hierarchical file (SOF5)"), false;
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        return fail(d.err, UNSUPPORTED, "arithmetic coding (SOF%d)",
                    m - 0xC0), false;
      case 0xCC:
        return fail(d.err, UNSUPPORTED, "arithmetic coding (DAC)"), false;
      case 0xDC:
        return fail(d.err, UNSUPPORTED, "a DNL marker"), false;
      case 0xC4:
        if (!parse_dht(d, p, n)) return false;
        break;
      case 0xDB:
        if (!parse_dqt(d, p, n)) return false;
        break;
      case 0xDD:
        if (n < 2) return fail(d.err, CORRUPT, "a bad DRI segment"), false;
        d.restart_interval = be16(p);
        break;
      case 0xDA:
        if (!parse_sos(d, p, n)) return false;
        return true;
      case 0xE0:
        if (n >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) d.jfif = true;
        break;
      case 0xEE:
        if (n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          d.adobe = true;
          d.adobe_transform = p[11];
        }
        break;
      default:
        if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE) break;  // APPn, COM
        return fail(d.err, CORRUPT, "an unknown marker 0x%02X", m), false;
    }
  }
}

// After the scan: the markers up to EOI.
bool read_trailer(Decoder &d) {
  for (int m = next_marker(d);; m = read_marker(d)) {
    if (m < 0)
      return fail(d.err, TRUNCATED, "the data ends before the EOI marker"),
             false;
    if (m == 0xD9) return true;
    if (m == 0xDA)
      return fail(d.err, UNSUPPORTED, "a sequential file of more than one "
                  "scan"), false;
    if (m == 0xDC)
      return fail(d.err, UNSUPPORTED, "a DNL marker"), false;
    if (m >= 0xD0 && m <= 0xD7) continue;
    const uint8_t *p;
    int n;
    if (!segment(d, &p, &n)) return false;
    if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xC4 || m == 0xDB ||
        m == 0xDD)
      continue;
    return fail(d.err, CORRUPT, "marker 0x%02X after the scan", m), false;
  }
}

}  // namespace

extern "C" {

// The image's height, width and component count, and the scratch bytes
// ivg_jpeg_decode needs. Returns 0, or an error code with a message.
int ivg_jpeg_header(const uint8_t *data, size_t size, int *height, int *width,
                    int *components, size_t *scratch_bytes, char *msg,
                    size_t msg_len) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.err.msg = msg;
  d.err.len = msg_len;
  if (msg && msg_len) msg[0] = 0;
  if (!read_headers(d, false)) return d.err.code;
  if (!d.sof) return fail(d.err, CORRUPT, "no SOF marker");
  *height = d.height;
  *width = d.width;
  *components = d.ncomp;
  *scratch_bytes = layout(d);
  return OK;
}

// Decodes into rgb, a uint8 [height, width, 3] buffer, using scratch
// (scratch_bytes from ivg_jpeg_header). Returns 0, or an error code with a
// message: 1 corrupt data, 2 an unsupported feature, 3 data that ends
// early, 4 a buffer too small.
int ivg_jpeg_decode(const uint8_t *data, size_t size, uint8_t *rgb,
                    size_t rgb_bytes, uint8_t *scratch, size_t scratch_bytes,
                    char *msg, size_t msg_len) {
  Decoder d;
  d.data = data;
  d.size = size;
  d.err.msg = msg;
  d.err.len = msg_len;
  if (msg && msg_len) msg[0] = 0;
  if (!read_headers(d, true)) return d.err.code;
  if (d.scans == 0) return fail(d.err, CORRUPT, "no SOS marker");
  size_t need = layout(d);
  if (scratch_bytes < need)
    return fail(d.err, BUFFER, "a scratch buffer too small");
  if (rgb_bytes < size_t(d.width) * d.height * 3)
    return fail(d.err, BUFFER, "an output buffer too small");
  uint8_t *p = scratch;
  for (int c = 0; c < d.ncomp; ++c) {
    Component &k = d.comp[c];
    k.plane = p;
    p += size_t(k.pw) * k.ph;
    k.row = p;
    p += 2 * size_t(k.pw) + 64;
  }
  if (!decode_scan(d)) return d.err.code;
  if (!read_trailer(d)) return d.err.code;
  write_rgb(d, rgb);
  return OK;
}

}  // extern "C"
