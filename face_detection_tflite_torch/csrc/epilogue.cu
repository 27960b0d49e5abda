// Residual add and activation in one pass for Hopper (sm_90a), K5 of the
// port.
//
// No TPU kernel corresponds to it: on the TPU, XLA fused the elementwise
// ops after each convolution into the convolution's own fusion.  Run one
// PyTorch op at a time, a BlazeBlock's end (ADD, ReLU or PReLU, the
// channel pad of its residual) took three to five full passes over its
// activation, a PReLU alone three (compare, a broadcast multiply, where):
// 38-46 bytes moved an element.  This kernel does it in one pass:
//
//   out[n,h,w,c] = act(y[n,h,w,c] + (c < C_r ? r[n,h,w,c] : 0.0f))
//   act: ReLU or PReLU(alpha[c]); r optional
//
// over NHWC tensors with C innermost, r with C_r <= C channels (its
// channels past C_r are the zeros of TFLite's channel PAD).  Every value is
// bit for bit that of the unfused ops (ops/epilogue.py, the plain
// version): padded channels compute y + 0.0f (so -0.0 becomes +0.0, as
// F.pad then add), PReLU is x >= 0 ? x : x * a (NaN takes the multiply, as
// torch.where), ReLU is torch.relu's clamp_min: NaN passes, else fmaxf(x, 0).
//
// What bounds it on this card: bytes.  It reads y (and r) and writes the
// output once: 8 bytes an element, 12 with a residual; at 3.35 TB/s the
// iris net's block outputs of a 16-frame batch (about 276 M elements) take
// about 1 ms.  The design does nothing but stream:
// - 128-bit loads and stores (float4) where C and C_r are multiples of 4
//   and every pointer is 16-byte aligned (every width of the benchmark's
//   networks: a float4 then lies wholly inside or outside the padded
//   channels); a scalar path for any other width;
// - each thread issues its four vectors' loads before it computes, so a
//   warp keeps several lines in flight;
// - alpha, a few hundred floats, comes through the read-only cache;
// - a 32-bit index: the host splits a launch at whole rows beyond 2^30
//   vectors.
// It allocates nothing: the wrapper allocates the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // vectors a thread
// Most vectors a launch covers, so that every index fits 32 bits.
constexpr long long kMaxVectors = 1LL << 30;

enum { kActRelu = 1, kActPrelu = 2 };
enum { kResNone = 0, kResSame = 1, kResPadded = 2 };

template <int A>
__device__ __forceinline__ float act(float v, float a) {
  if (A == kActRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  return v >= 0.0f ? v : __fmul_rn(v, a);
}

template <int A, int R>
__device__ __forceinline__ float one(float y, float r, float a) {
  return act<A>(R == kResNone ? y : __fadd_rn(y, r), a);
}

template <int A, int R>
__device__ __forceinline__ float apply(float y, float r, float a) {
  return one<A, R>(y, r, a);
}

template <int A, int R>
__device__ __forceinline__ float4 apply(float4 y, float4 r, float4 a) {
  return make_float4(one<A, R>(y.x, r.x, a.x), one<A, R>(y.y, r.y, a.y),
                     one<A, R>(y.z, r.z, a.z), one<A, R>(y.w, r.w, a.w));
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// V is float4 (c, cr and n counted in vectors) or float; n fits 31 bits.
template <typename V, int A, int R>
__global__ void __launch_bounds__(kThreads)
residual_act_kernel(const V* __restrict__ y, const V* __restrict__ r,
                    const V* __restrict__ alpha, V* __restrict__ out,
                    unsigned n, unsigned c, unsigned cr) {
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  V yv[kItems], rv[kItems], av[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned i = base + k * kThreads;
    yv[k] = rv[k] = av[k] = zero<V>();
    if (i >= n) continue;
    yv[k] = __ldg(y + i);
    if (A == kActPrelu || R == kResPadded) {
      const unsigned row = i / c;
      const unsigned ch = i - row * c;
      if (A == kActPrelu) av[k] = __ldg(alpha + ch);
      if (R == kResPadded && ch < cr) rv[k] = __ldg(r + row * cr + ch);
    }
    if (R == kResSame) rv[k] = __ldg(r + i);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned i = base + k * kThreads;
    if (i < n) out[i] = apply<A, R>(yv[k], rv[k], av[k]);
  }
}

template <typename V, int A, int R>
cudaError_t run(const float* y, const float* r, const float* alpha,
                float* out, long long rows, int c, int cr, int width,
                cudaStream_t stream) {
  // c, cr in floats; width floats a vector.
  const long long cv = c / width;
  const long long crv = cr / width;
  const long long chunk = kMaxVectors / cv > 0 ? kMaxVectors / cv : 1;
  for (long long row0 = 0; row0 < rows; row0 += chunk) {
    const long long n = (rows - row0 < chunk ? rows - row0 : chunk) * cv;
    const long long blocks = (n + kThreads * kItems - 1) / (kThreads * kItems);
    residual_act_kernel<V, A, R><<<static_cast<unsigned>(blocks), kThreads,
                                   0, stream>>>(
        reinterpret_cast<const V*>(y + row0 * c),
        r ? reinterpret_cast<const V*>(r + row0 * cr) : nullptr,
        reinterpret_cast<const V*>(alpha),
        reinterpret_cast<V*>(out + row0 * c), static_cast<unsigned>(n),
        static_cast<unsigned>(cv), static_cast<unsigned>(crv));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename V, int A>
cudaError_t by_residual(const float* y, const float* r, const float* alpha,
                        float* out, long long rows, int c, int cr, int width,
                        cudaStream_t stream) {
  if (r == nullptr)
    return run<V, A, kResNone>(y, r, alpha, out, rows, c, cr, width, stream);
  if (cr == c)
    return run<V, A, kResSame>(y, r, alpha, out, rows, c, cr, width, stream);
  return run<V, A, kResPadded>(y, r, alpha, out, rows, c, cr, width, stream);
}

template <typename V>
cudaError_t by_act(const float* y, const float* r, const float* alpha,
                   float* out, long long rows, int c, int cr, int act_code,
                   int width, cudaStream_t stream) {
  if (act_code == kActRelu)
    return by_residual<V, kActRelu>(y, r, alpha, out, rows, c, cr, width,
                                    stream);
  return by_residual<V, kActPrelu>(y, r, alpha, out, rows, c, cr, width,
                                   stream);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// y, out: [rows, c] float32; r: [rows, cr] or null (cr 0); alpha: [c] for
// PReLU (act 2), else ignored; act 1 ReLU, 2 PReLU.
extern "C" int fdt_residual_act(const void* y, const void* r,
                                const void* alpha, void* out, long long rows,
                                int c, int cr, int act_code, int device,
                                void* stream) {
  if (rows < 0 || c < 1 || cr < 0 || cr > c || (r == nullptr) != (cr == 0) ||
      (act_code != kActRelu && act_code != kActPrelu) ||
      (act_code == kActPrelu && alpha == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  // `device` is made current for the launch only, as in warp.cu.
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const float* yf = static_cast<const float*>(y);
  const float* rf = static_cast<const float*>(r);
  const float* af = act_code == kActPrelu ? static_cast<const float*>(alpha)
                                          : nullptr;
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c % 4 == 0 && cr % 4 == 0 && aligned16(y) &&
                   aligned16(r) && aligned16(af) && aligned16(out);
  err = vec ? by_act<float4>(yf, rf, af, of, rows, c, cr, act_code, 4, s)
            : by_act<float>(yf, rf, af, of, rows, c, cr, act_code, 1, s);
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
