// ROI warp fused with the [-1, 1] normalize for Hopper (sm_90a), K2 of the
// port.
//
// Replaces: face_detection_tflite_tpu/ops/warp.py::_bilinear_sample, reached
// through extract_rois (the mesh stage's rotated-square crops), followed by
// face_detection_tflite_tpu/ops/letterbox.py::normalize_image.  On the TPU
// XLA generated this gather and Mosaic could not express its scattered taps.
//
// Function: for every ROI (cx, cy, size, cos, sin, optional mirror) and
// output pixel (oy, ox) of an S x S crop: size rounds with floor(x + 0.5)
// (at least 1), scale = S / size, center = S/2 + 0.5 (scale - 1); the source
// point is c + R^T (dst - center) / scale; four uint8 (or float) taps, each
// with its own inside-mask (outside reads 0); an fp32 bilinear lerp; then
// v / 127.5 - 1.  Output [B, F, S, S, 3] float32, one launch for all images
// and faces.
//
// What bounds it on this card: the bytes it writes.  On the main path
// (16 frames x 16 faces x 192^2 x 3 x 4 B = 113 MB) that is about 34 us at
// 3.35 TB/s; the taps read far fewer bytes (uint8, and neighbouring output
// pixels share source pixels through L1/L2).  The design answers that with
// one thread per output pixel writing its three channels, consecutive
// threads on consecutive pixels so the stores coalesce, the per-ROI
// geometry recomputed in registers instead of staged through memory, and
// the taps read in the frame's own dtype.  Built with -fmad=false and
// explicit _rn intrinsics, so every sample matches the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_normalize_kernel(const T* __restrict__ frames, int h, int w,
                      const float* __restrict__ cx,
                      const float* __restrict__ cy,
                      const float* __restrict__ size,
                      const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t,
                      const uint8_t* __restrict__ flip, int faces,
                      int out_size, float inv, float* __restrict__ out) {
  const int roi = blockIdx.y;  // b * faces + f
  const int npix = out_size * out_size;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= npix) return;
  const int oy = pix / out_size;
  const int ox = pix - oy * out_size;

  const float s_out = static_cast<float>(out_size);
  const float size_int = fmaxf(floorf(__fadd_rn(size[roi], 0.5f)), 1.0f);
  const float scale = __fdiv_rn(s_out, size_int);
  const float center =
      __fadd_rn(s_out * 0.5f, __fmul_rn(0.5f, __fsub_rn(scale, 1.0f)));
  const int xs = (flip != nullptr && flip[roi]) ? out_size - 1 - ox : ox;
  const float dx = __fdiv_rn(__fsub_rn(static_cast<float>(xs), center), scale);
  const float dy = __fdiv_rn(__fsub_rn(static_cast<float>(oy), center), scale);
  const float ct = cos_t[roi];
  const float st = sin_t[roi];
  const float sx = __fadd_rn(__fadd_rn(cx[roi], __fmul_rn(ct, dx)),
                             __fmul_rn(st, dy));
  const float sy = __fadd_rn(__fsub_rn(cy[roi], __fmul_rn(st, dx)),
                             __fmul_rn(ct, dy));

  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0);
  const float wy = __fsub_rn(sy, y0);
  const float omx = __fsub_rn(1.0f, wx);
  const float omy = __fsub_rn(1.0f, wy);
  const int x0i = static_cast<int>(x0);
  const int y0i = static_cast<int>(y0);

  const T* img = frames + static_cast<size_t>(roi / faces) * h * w * 3;
  float v[4][3];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int yi = y0i + (t >> 1);
    const int xi = x0i + (t & 1);
    const bool inside = xi >= 0 && xi < w && yi >= 0 && yi < h;
    const T* p = img + (static_cast<size_t>(inside ? yi : 0) * w +
                        (inside ? xi : 0)) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      v[t][c] = inside ? static_cast<float>(p[c]) : 0.0f;
  }

  float* o = out + (static_cast<size_t>(roi) * npix + pix) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = __fadd_rn(__fmul_rn(v[0][c], omx), __fmul_rn(v[1][c], wx));
    const float bot = __fadd_rn(__fmul_rn(v[2][c], omx), __fmul_rn(v[3][c], wx));
    const float val = __fadd_rn(__fmul_rn(top, omy), __fmul_rn(bot, wy));
    o[c] = __fsub_rn(__fmul_rn(val, inv), 1.0f);
  }
}

template <typename T>
int launch(const void* frames, int batch, int h, int w, const void* cx,
           const void* cy, const void* size, const void* cos_t,
           const void* sin_t, const void* flip, int faces, int out_size,
           float inv, void* out, int device, void* stream) {
  if (batch <= 0 || faces <= 0 || out_size <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int npix = out_size * out_size;
  const dim3 grid((npix + kThreads - 1) / kThreads, batch * faces);
  warp_normalize_kernel<T><<<grid, kThreads, 0,
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
