// Fused host preprocessing of a video segment for the data loaders.
//
// A segment's augmentation is one crop -> bilinear resize -> normalize to
// [0, 1] of every frame with shared parameters (the reference draws them
// once a segment, simple_dataloader.py:364-388). This single pass reads
// the uint8 frames directly, so no float copy of a whole frame is made,
// and a call through ctypes releases the GIL, so loader threads run it
// side by side.
//
// Built by ivideogpt_tpu_torch/_build.py (HOST_SOURCES, HOST_FLAGS: no
// -ffast-math, -march=native or -fopenmp, and no contraction into FMA, so
// the arithmetic is IEEE and the same on every host); bound by
// ivideogpt_tpu_torch/data/native.py, which checks the arguments: the code
// here trusts them. A call runs on its caller's thread: the loader's
// workers already run side by side, so the frame loop carries no OpenMP
// pragma.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Crop [ci:ci+ch, cj:cj+cw] from an HxWxC uint8 frame, bilinear-resize to
// OHxOWxC, scale to [0, 1] float32 as v * mul / 255 + add, clamped.
// cv2.INTER_LINEAR's taps (half-pixel centres, clamped at the borders, no
// antialias). Column indices and weights come from the caller's tables.
void crop_resize_normalize_u8(
    const uint8_t* src, int h, int w, int c,
    int ci, int cj, int ch, int cw,
    float* dst, int oh, int ow,
    float mul, float add,
    const int* x0s, const int* x1s, const float* wxs) {
  const float sy = (float)ch / (float)oh;
  const float scale = mul / 255.0f;
  for (int oy = 0; oy < oh; ++oy) {
    float fy = ((float)oy + 0.5f) * sy - 0.5f;
    int y0 = (int)std::floor(fy);
    float wy = fy - (float)y0;
    int y1 = std::min(y0 + 1, ch - 1);
    y0 = std::max(y0, 0);
    const uint8_t* row0 = src + (size_t)(ci + y0) * w * c + (size_t)cj * c;
    const uint8_t* row1 = src + (size_t)(ci + y1) * w * c + (size_t)cj * c;
    float* out = dst + (size_t)oy * ow * c;
    for (int ox = 0; ox < ow; ++ox) {
      const float wx = wxs[ox];
      const uint8_t* p00 = row0 + (size_t)x0s[ox] * c;
      const uint8_t* p01 = row0 + (size_t)x1s[ox] * c;
      const uint8_t* p10 = row1 + (size_t)x0s[ox] * c;
      const uint8_t* p11 = row1 + (size_t)x1s[ox] * c;
      for (int k = 0; k < c; ++k) {
        float top = (float)p00[k] + wx * ((float)p01[k] - (float)p00[k]);
        float bot = (float)p10[k] + wx * ((float)p11[k] - (float)p10[k]);
        float v = (top + wy * (bot - top)) * scale + add;
        out[(size_t)ox * c + k] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
      }
    }
  }
}

// Whole segment: T frames with one crop and one output size, the column
// tables built once for all of them.
void segment_crop_resize_normalize_u8(
    const uint8_t* src, int t, int h, int w, int c,
    int ci, int cj, int ch, int cw,
    float* dst, int oh, int ow,
    float mul, float add) {
  const size_t in_stride = (size_t)h * w * c;
  const size_t out_stride = (size_t)oh * ow * c;
  std::vector<int> x0s(ow), x1s(ow);
  std::vector<float> wxs(ow);
  const float sx = (float)cw / (float)ow;
  for (int ox = 0; ox < ow; ++ox) {
    float fx = ((float)ox + 0.5f) * sx - 0.5f;
    int x0 = (int)std::floor(fx);
    wxs[ox] = fx - (float)x0;
    x1s[ox] = std::min(x0 + 1, cw - 1);
    x0s[ox] = std::max(x0, 0);
  }
  for (int i = 0; i < t; ++i) {
    crop_resize_normalize_u8(src + (size_t)i * in_stride, h, w, c,
                             ci, cj, ch, cw,
                             dst + (size_t)i * out_stride, oh, ow, mul, add,
                             x0s.data(), x1s.data(), wxs.data());
  }
}

}  // extern "C"
