// ROI warp fused with the [-1, 1] normalize for Hopper (sm_90a), K2 of the
// port.
//
// Replaces: face_detection_tflite_tpu/ops/warp.py::_bilinear_sample, reached
// through extract_rois (the mesh stage's rotated-square crops), followed by
// face_detection_tflite_tpu/ops/letterbox.py::normalize_image.  On the TPU
// XLA generated this gather and Mosaic could not express its scattered taps
// (the gather probes under benchmarks/experiments/).
//
// Function: for every ROI (cx, cy, size, cos, sin, optional mirror) and
// output pixel (oy, ox) of an S x S crop: size rounds with floor(x + 0.5)
// (at least 1), scale = S / size, center = S/2 + 0.5 (scale - 1); the source
// point is c + R^T (dst - center) / scale; four uint8 (or float) taps, each
// with its own inside-mask (outside reads 0); an fp32 bilinear lerp; then
// v / 127.5 - 1.  Output [B, F, S, S, 3] float32, one launch for all images
// and faces.
//
// What bounds it on this card: bytes.  On the main path (16 frames x 16
// faces at S = 192) the crops are 113.2 MB written and the taps touch
// 40.0 MB of distinct source pixels: 153 MB, 0.0458 ms at 3.35 TB/s.
//
// What held the first design back (one thread per output pixel): every
// thread redid the ROI's geometry with three IEEE divisions for one pixel,
// although dx depends only on the column and dy only on the row; it read its
// taps as twelve scattered 1-byte loads, each converted to float on the
// conversion unit, which runs at a fraction of the fp32 rate; and a warp's
// 32 pixels lay on one output row, a rotated line across up to ~80 source
// rows.  It ran at 0.163 ms of device time, 28% of its bound.
//
// This design:
// - a CTA per (ROI, band of 8 output rows).  Once per CTA it computes
//   cx + cos dx and cy - sin dx for every column, and sin dy and cos dy for
//   its rows, into shared memory, with the same divisions; a pixel's source
//   point is then two additions (the same operations, in the same order, as
//   the plain version);
// - each tap row (two neighbouring RGB pixels, 6 bytes) is two or three
//   aligned 32-bit loads and two funnel shifts, not six byte loads; a byte
//   becomes a float by a byte permute into 2^23 + b and one subtraction,
//   which is exact and stays on the fp32 pipes; the loads go to a clamped
//   position, so the common case has no branch or select, and a tap row
//   that crosses the frame's edge is fixed up off that path;
// - a warp covers a 16 x 2 patch of output pixels, which lies in fewer
//   source lines than a 32-pixel row at most angles; each thread keeps one
//   output row and walks along it;
// - stores stay direct (three 4-byte stores a pixel): staging the band in
//   shared memory for 16-byte or bulk-async stores, 16-byte stores of four
//   pixels a thread, and 64- or 128-bit tap loads all measured slower on the
//   main path (PERF.md, "Findings").
// Measured on an H100 80GB HBM3 at 700 W: 0.081 ms of device time on the
// main path, 56% of the bound.  What bounds it now: with the loads and the
// stores cut out the same arithmetic takes 0.048 ms (instruction-bound);
// the stores hide under it, and the scattered tap loads add the rest.
// Built with -fmad=false and explicit _rn intrinsics, so every sample
// matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                         // output rows per CTA
constexpr int kPatchW = 16;                      // a warp: 16 columns ...
constexpr int kPatchH = 32 / kPatchW;            // ... x 2 rows
constexpr int kPatchRows = kRows / kPatchH;      // patch rows of a band
constexpr int kColWarps = kWarps / kPatchRows;   // warps along a patch row
static_assert(kWarps % kPatchRows == 0, "warps must cover the band's rows");
// Largest crop: the per-column geometry (2 S floats) stays within 48 KB of
// shared memory.  ops/warp.py::MAX_OUT_SIZE holds the same number.
constexpr int kMaxOutSize = 4096;

// Byte `sel` of `word` as a float: 0x4B0000bb is 2^23 + b exactly.
__device__ __forceinline__ float byte_f(uint32_t word, unsigned sel) {
  return __fsub_rn(__int_as_float(static_cast<int>(
                       __byte_perm(word, 0x4B000000u, 0x7440u | sel))),
                   8388608.0f);
}

// The two taps of source row y at columns x0 and x0 + 1: l[3] and r[3];
// a tap outside the frame reads 0.  Generic version: one load a channel.
template <typename T>
__device__ __forceinline__ void tap_row_plain(const T* __restrict__ img,
                                              int h, int w, int y, int x0,
                                              float* l, float* r) {
  const unsigned ux = static_cast<unsigned>(x0);
  const bool yin = static_cast<unsigned>(y) < static_cast<unsigned>(h);
  const bool lin = yin && ux < static_cast<unsigned>(w);
  const bool rin = yin && ux + 1u < static_cast<unsigned>(w);
  const size_t row = static_cast<size_t>(min(max(y, 0), h - 1)) * w;
  const int xl = min(max(x0, 0), w - 1);
  const int xr = rin ? x0 + 1 : xl;
  const T* pl = img + (row + xl) * 3;
  const T* pr = img + (row + xr) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = static_cast<float>(__ldg(pl + c));
    const float b = static_cast<float>(__ldg(pr + c));
    l[c] = lin ? a : 0.0f;
    r[c] = rin ? b : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void tap_row(const T* __restrict__ img, int h,
                                        int w, int y, int x0, float* l,
                                        float* r) {
  tap_row_plain(img, h, w, y, x0, l, r);
}

// uint8 frames: the 6 bytes of pixels xc and xc + 1, xc = clamp(x0, 0,
// w - 2), from aligned 32-bit words (a valid byte's aligned word lies inside
// the allocation).
template <>
__device__ __forceinline__ void tap_row<uint8_t>(
    const uint8_t* __restrict__ img, int h, int w, int y, int x0, float* l,
    float* r) {
  if (w < 2) {
    tap_row_plain(img, h, w, y, x0, l, r);
    return;
  }
  const int yc = min(max(y, 0), h - 1);
  const int xc = min(max(x0, 0), w - 2);
  const uintptr_t a = reinterpret_cast<uintptr_t>(
      img + (static_cast<size_t>(yc) * w + xc) * 3);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const unsigned sh = static_cast<unsigned>(a & 3u) * 8u;
  const uint32_t w0 = __ldg(wp);
  const uint32_t w1 = __ldg(wp + 1);
  const uint32_t w2 = sh == 24u ? __ldg(wp + 2) : 0u;
  const uint32_t lo = __funnelshift_r(w0, w1, sh);  // bytes 0-3 of the 6
  const uint32_t hi = __funnelshift_r(w1, w2, sh);  // bytes 4-5
  l[0] = byte_f(lo, 0);
  l[1] = byte_f(lo, 1);
  l[2] = byte_f(lo, 2);
  r[0] = byte_f(lo, 3);
  r[1] = byte_f(hi, 0);
  r[2] = byte_f(hi, 1);
  const bool yin = static_cast<unsigned>(y) < static_cast<unsigned>(h);
  if (yin && x0 == xc) return;
  // At the frame's edge: a tap outside reads 0.  With x0 = w - 1 the left
  // tap is pixel xc + 1; with x0 = -1 the right tap is pixel xc = 0.
  const unsigned ux = static_cast<unsigned>(x0);
  const bool lin = yin && ux < static_cast<unsigned>(w);
  const bool rin = yin && ux + 1u < static_cast<unsigned>(w);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p0 = l[c];
    const float p1 = r[c];
    l[c] = lin ? p1 : 0.0f;
    r[c] = rin ? (ux + 1u == static_cast<unsigned>(xc) ? p0 : p1) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_normalize_kernel(const T* __restrict__ frames, int h, int w,
                      const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ size,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      const uint8_t* __restrict__ flip, int faces, int s,
                      float inv, float* __restrict__ out) {
  extern __shared__ float geom[];
  float* colx = geom;        // [s]      cx + cos * dx(column)
  float* coly = colx + s;    // [s]      cy - sin * dx(column)
  float* rowx = coly + s;    // [kRows]  sin * dy(row)
  float* rowy = rowx + kRows;  // [kRows] cos * dy(row)

  const int bands = (s + kRows - 1) / kRows;
  const int roi = blockIdx.x / bands;  // b * faces + f
  const int y0 = (blockIdx.x - roi * bands) * kRows;
  const int rows = min(kRows, s - y0);

  const float s_out = static_cast<float>(s);
  const float size_int = fmaxf(floorf(__fadd_rn(size[roi], 0.5f)), 1.0f);
  const float scale = __fdiv_rn(s_out, size_int);
  const float center =
      __fadd_rn(__fmul_rn(s_out, 0.5f), __fmul_rn(0.5f, __fsub_rn(scale, 1.0f)));
  const float ct = cos_t[roi];
  const float st = sin_t[roi];
  const bool mirror = flip != nullptr && flip[roi];
  for (int x = threadIdx.x; x < s; x += kThreads) {
    const int xs = mirror ? s - 1 - x : x;
    const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(xs), center), scale);
    colx[x] = __fadd_rn(cx[roi], __fmul_rn(ct, dx));
    coly[x] = __fsub_rn(cy[roi], __fmul_rn(st, dx));
  }
  if (static_cast<int>(threadIdx.x) < rows) {
    const float dy = __fdiv_rn(
        __fsub_rn(static_cast<float>(y0 + static_cast<int>(threadIdx.x)),
                  center),
        scale);
    rowx[threadIdx.x] = __fmul_rn(st, dy);
    rowy[threadIdx.x] = __fmul_rn(ct, dy);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = (warp % kPatchRows) * kPatchH + lane / kPatchW;
  if (r >= rows) return;  // the ragged last band
  const float rx = rowx[r];
  const float ry = rowy[r];
  const T* img = frames + static_cast<size_t>(roi / faces) * h * w * 3;
  float* orow = out + ((static_cast<size_t>(roi) * s + y0 + r) * s) * 3;
  constexpr int kStep = kColWarps * kPatchW;
  for (int x = (warp / kPatchRows) * kPatchW + lane % kPatchW; x < s;
       x += kStep) {
    const float sx = __fadd_rn(colx[x], rx);
    const float sy = __fadd_rn(coly[x], ry);
    const float xf = floorf(sx);
    const float yf = floorf(sy);
    const float wx = __fsub_rn(sx, xf);
    const float wy = __fsub_rn(sy, yf);
    const int x0 = static_cast<int>(xf);
    const int y0i = static_cast<int>(yf);
    float v[4][3];
    tap_row(img, h, w, y0i, x0, v[0], v[1]);
    tap_row(img, h, w, static_cast<int>(static_cast<unsigned>(y0i) + 1u), x0,
            v[2], v[3]);
    const float omx = __fsub_rn(1.0f, wx);
    const float omy = __fsub_rn(1.0f, wy);
    float* o = orow + 3 * x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float top = __fadd_rn(__fmul_rn(v[0][c], omx),
                                  __fmul_rn(v[1][c], wx));
      const float bot = __fadd_rn(__fmul_rn(v[2][c], omx),
                                  __fmul_rn(v[3][c], wx));
      const float val = __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy));
      o[c] = __fsub_rn(__fmul_rn(val, inv), 1.0f);
    }
  }
}

template <typename T>
int launch(const void* frames, int batch, int h, int w, const void* cx,
           const void* cy, const void* size, const void* cos_t,
           const void* sin_t, const void* flip, int faces, int out_size,
           float inv, void* out, int device, void* stream) {
  if (batch <= 0 || faces <= 0) return 0;
  const long long ctas = static_cast<long long>((out_size + kRows - 1) /
                                                kRows) * batch * faces;
  if (out_size < 1 || out_size > kMaxOutSize || h < 1 || w < 1 ||
      ctas > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (2 * static_cast<size_t>(out_size) + 2 * kRows) *
                      sizeof(float);
  warp_normalize_kernel<T><<<static_cast<unsigned>(ctas), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), h, w, static_cast<const float*>(cx),
      static_cast<const float*>(cy), static_cast<const float*>(size),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<const uint8_t*>(flip), faces, out_size, inv,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fdt_warp_normalize_u8(const void* frames, int batch, int h,
                                     int w, const void* cx, const void* cy,
                                     const void* size, const void* cos_t,
                                     const void* sin_t, const void* flip,
                                     int faces, int out_size, float inv,
                                     void* out, int device, void* stream) {
  return launch<uint8_t>(frames, batch, h, w, cx, cy, size, cos_t, sin_t,
                         flip, faces, out_size, inv, out, device, stream);
}

extern "C" int fdt_warp_normalize_f32(const void* frames, int batch, int h,
                                      int w, const void* cx, const void* cy,
                                      const void* size, const void* cos_t,
                                      const void* sin_t, const void* flip,
                                      int faces, int out_size, float inv,
                                      void* out, int device, void* stream) {
  return launch<float>(frames, batch, h, w, cx, cy, size, cos_t, sin_t, flip,
                       faces, out_size, inv, out, device, stream);
}
