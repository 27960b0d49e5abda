// A convolution's bias, residual add and activation in one pass for Hopper
// (sm_90a), K5 of the port.
//
// No TPU kernel corresponds to it: on the TPU, XLA fused the elementwise
// ops after each convolution into the convolution's own fusion.  Run one
// PyTorch op at a time, a convolution's bias took a broadcast add of its
// own after cuDNN's kernel, and a BlazeBlock's end (ADD, ReLU or PReLU,
// the channel pad of its residual) three to five more full passes over
// its activation, a PReLU alone three (compare, a broadcast multiply,
// where).  This kernel does it in one pass:
//
//   out[n,h,w,c] = act((y[n,h,w,c] + b[c]) + (c < C_r ? r[n,h,w,c] : 0.0f))
//   act: none, ReLU or PReLU(alpha[c]); b and r optional
//
// over NHWC tensors with C innermost, r with C_r <= C channels (its
// channels past C_r are the zeros of TFLite's channel PAD).  Every value is
// bit for bit that of the unfused ops (ops/epilogue.py, the plain
// version): the bias is added first and rounded, as after the
// convolution, then the residual (never y + (b + r)); padded channels
// compute v + 0.0f (so -0.0 becomes +0.0, as F.pad then add), PReLU is
// x >= 0 ? x : x * a (NaN takes the multiply, as torch.where), ReLU is
// torch.relu's clamp_min: NaN passes, else fmaxf(x, 0).
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
// - alpha and the bias, a few hundred floats each, come through the
//   read-only cache;
// - a 32-bit index: the host splits a launch at whole rows beyond 2^30
//   vectors.
// A bias pass with no residual may run in place (out == y), the output
// overwriting the convolution's: that instance reads y with plain loads,
// neither pointer __restrict__, so no read goes through the read-only
// path of a buffer the kernel writes.  It allocates nothing: the wrapper
// allocates the output, or passes y as the output.
//
// The affine instance (residual_act_affine_kernel) also applies a batch
// norm that a graph keeps as a per-channel MUL and ADD after the pass
// (iResNet's pre-activation BN, which a zero-padded convolution follows,
// so no converter folds it):
//
//   z[n,h,w,c] = (out[n,h,w,c] * s[c]) + t[c]
//
// rounded as the two PyTorch ops (__fmul_rn, then __fadd_rn; -fmad=false
// forbids the contraction too), and writes z beside out, or z alone
// where out has no other reader.  It reads what the plain pass reads and
// writes 4 or 8 bytes an element: the two graph ops' own 16 bytes an
// element (read out, write the product, read it, write z) are gone.  It
// has instances only for the two passes such a batch norm follows in
// iResNet (kAffinePass): a PReLU with the bias and no residual (the
// stem), and the bias and a same-width residual with no activation (a
// block's end); the entry point refuses the others.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // vectors a thread
// Most vectors a launch covers, so that every index fits 32 bits.
constexpr long long kMaxVectors = 1LL << 30;

enum { kActNone = 0, kActRelu = 1, kActPrelu = 2 };
enum { kResNone = 0, kResSame = 1, kResPadded = 2 };

template <int A>
__device__ __forceinline__ float act(float v, float a) {
  if (A == kActNone) return v;
  if (A == kActRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  return v >= 0.0f ? v : __fmul_rn(v, a);
}

template <int A, int R, bool B>
__device__ __forceinline__ float one(float y, float b, float r, float a) {
  const float v = B ? __fadd_rn(y, b) : y;
  return act<A>(R == kResNone ? v : __fadd_rn(v, r), a);
}

template <int A, int R, bool B>
__device__ __forceinline__ float apply(float y, float b, float r, float a) {
  return one<A, R, B>(y, b, r, a);
}

template <int A, int R, bool B>
__device__ __forceinline__ float4 apply(float4 y, float4 b, float4 r,
                                        float4 a) {
  return make_float4(one<A, R, B>(y.x, b.x, r.x, a.x),
                     one<A, R, B>(y.y, b.y, r.y, a.y),
                     one<A, R, B>(y.z, b.z, r.z, a.z),
                     one<A, R, B>(y.w, b.w, r.w, a.w));
}

__device__ __forceinline__ float affine(float v, float s, float t) {
  return __fadd_rn(__fmul_rn(v, s), t);
}

__device__ __forceinline__ float4 affine(float4 v, float4 s, float4 t) {
  return make_float4(affine(v.x, s.x, t.x), affine(v.y, s.y, t.y),
                     affine(v.z, s.z, t.z), affine(v.w, s.w, t.w));
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
// InPlace: out is y, read with plain loads.  F (affine): z = out * s + t
// is written too, and out only where it is not null.
template <typename V, int A, int R, bool B, bool InPlace, bool F>
__device__ __forceinline__ void body(const V* y, const V* r, const V* alpha,
                                     const V* bias, const V* scale,
                                     const V* shift, V* out, V* z,
                                     unsigned n, unsigned c, unsigned cr) {
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
  V yv[kItems], rv[kItems], av[kItems], bv[kItems], sv[kItems], tv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned i = base + k * kThreads;
    yv[k] = rv[k] = av[k] = bv[k] = sv[k] = tv[k] = zero<V>();
    if (i >= n) continue;
    yv[k] = InPlace ? y[i] : __ldg(y + i);
    if (A == kActPrelu || R == kResPadded || B || F) {
      const unsigned row = i / c;
      const unsigned ch = i - row * c;
      if (A == kActPrelu) av[k] = __ldg(alpha + ch);
      if (B) bv[k] = __ldg(bias + ch);
      if (F) {
        sv[k] = __ldg(scale + ch);
        tv[k] = __ldg(shift + ch);
      }
      if (R == kResPadded && ch < cr) rv[k] = __ldg(r + row * cr + ch);
    }
    if (R == kResSame) rv[k] = __ldg(r + i);
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned i = base + k * kThreads;
    if (i >= n) continue;
    const V v = apply<A, R, B>(yv[k], bv[k], rv[k], av[k]);
    if (F) {
      if (out != nullptr) out[i] = v;
      z[i] = affine(v, sv[k], tv[k]);
    } else {
      out[i] = v;
    }
  }
}

template <typename V, int A, int R, bool B>
__global__ void __launch_bounds__(kThreads)
residual_act_kernel(const V* __restrict__ y, const V* __restrict__ r,
                    const V* __restrict__ alpha, const V* __restrict__ bias,
                    V* __restrict__ out, unsigned n, unsigned c,
                    unsigned cr) {
  body<V, A, R, B, false, false>(y, r, alpha, bias, nullptr, nullptr, out,
                                 nullptr, n, c, cr);
}

// The in-place bias pass (act none or ReLU): x is both y and the output.
template <typename V, int A>
__global__ void __launch_bounds__(kThreads)
residual_act_inplace_kernel(V* x, const V* __restrict__ bias, unsigned n,
                            unsigned c) {
  body<V, A, kResNone, true, true, false>(x, nullptr, nullptr, bias, nullptr,
                                          nullptr, x, nullptr, n, c, 0);
}

// The pass, then the per-channel affine pair after it: z, and out where
// it is not null.
template <typename V, int A, int R, bool B>
__global__ void __launch_bounds__(kThreads)
residual_act_affine_kernel(const V* __restrict__ y, const V* __restrict__ r,
                           const V* __restrict__ alpha,
                           const V* __restrict__ bias,
                           const V* __restrict__ scale,
                           const V* __restrict__ shift, V* __restrict__ out,
                           V* __restrict__ z, unsigned n, unsigned c,
                           unsigned cr) {
  body<V, A, R, B, false, true>(y, r, alpha, bias, scale, shift, out, z, n,
                                c, cr);
}

struct Args {
  const float* y;
  const float* r;
  const float* alpha;
  const float* bias;
  const float* scale;  // the affine pair's, or null
  const float* shift;
  float* out;          // null in an affine pass whose out has no reader
  float* z;
  long long rows;
  int c, cr;   // in floats
  int width;   // floats a vector
  cudaStream_t stream;
};

// The passes the affine instance has: see the header.
template <int A, int R, bool B>
constexpr bool kAffinePass =
    B && ((A == kActPrelu && R == kResNone) ||
          (A == kActNone && R == kResSame));

template <typename V, int A, int R, bool B>
cudaError_t run(const Args& a) {
  if constexpr (!kAffinePass<A, R, B>) {
    if (a.z != nullptr) return cudaErrorInvalidValue;
  }
  const long long cv = a.c / a.width;
  const long long crv = a.cr / a.width;
  const long long chunk = kMaxVectors / cv > 0 ? kMaxVectors / cv : 1;
  for (long long row0 = 0; row0 < a.rows; row0 += chunk) {
    const long long n =
        (a.rows - row0 < chunk ? a.rows - row0 : chunk) * cv;
    const unsigned blocks = static_cast<unsigned>(
        (n + kThreads * kItems - 1) / (kThreads * kItems));
    V* out = a.out ? reinterpret_cast<V*>(a.out + row0 * a.c) : nullptr;
    const V* bias = reinterpret_cast<const V*>(a.bias);
    const V* yv = reinterpret_cast<const V*>(a.y + row0 * a.c);
    const V* rv =
        a.r ? reinterpret_cast<const V*>(a.r + row0 * a.cr) : nullptr;
    const V* alpha = reinterpret_cast<const V*>(a.alpha);
    bool launched = false;
    if constexpr (kAffinePass<A, R, B>) {
      if (a.z != nullptr) {
        residual_act_affine_kernel<V, A, R, B>
            <<<blocks, kThreads, 0, a.stream>>>(
                yv, rv, alpha, bias, reinterpret_cast<const V*>(a.scale),
                reinterpret_cast<const V*>(a.shift), out,
                reinterpret_cast<V*>(a.z + row0 * a.c),
                static_cast<unsigned>(n), static_cast<unsigned>(cv),
                static_cast<unsigned>(crv));
        launched = true;
      }
    }
    if constexpr (R == kResNone && B && A != kActPrelu) {
      if (!launched && a.out == a.y) {
        residual_act_inplace_kernel<V, A>
            <<<blocks, kThreads, 0, a.stream>>>(
                out, bias, static_cast<unsigned>(n),
                static_cast<unsigned>(cv));
        launched = true;
      }
    }
    if (!launched)
      residual_act_kernel<V, A, R, B><<<blocks, kThreads, 0, a.stream>>>(
          yv, rv, alpha, bias, out, static_cast<unsigned>(n),
          static_cast<unsigned>(cv), static_cast<unsigned>(crv));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename V, int A, int R>
cudaError_t by_bias(const Args& a) {
  if (a.bias != nullptr) return run<V, A, R, true>(a);
  // A pass with no act, no bias and no residual does nothing: the entry
  // point refuses it, so it has no instance.
  if constexpr (A == kActNone && R == kResNone)
    return cudaErrorInvalidValue;
  else
    return run<V, A, R, false>(a);
}

template <typename V, int A>
cudaError_t by_residual(const Args& a) {
  if (a.r == nullptr) return by_bias<V, A, kResNone>(a);
  if (a.cr == a.c) return by_bias<V, A, kResSame>(a);
  return by_bias<V, A, kResPadded>(a);
}

template <typename V>
cudaError_t by_act(int act_code, const Args& a) {
  if (act_code == kActRelu) return by_residual<V, kActRelu>(a);
  if (act_code == kActPrelu) return by_residual<V, kActPrelu>(a);
  return by_residual<V, kActNone>(a);
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Checks the arguments both entry points share, makes `device` current
// for the launch only (as in warp.cu) and launches.
int launch(Args a, int act_code, int device) {
  if (a.rows < 0 || a.c < 1 || a.cr < 0 || a.cr > a.c ||
      (a.r == nullptr) != (a.cr == 0) || act_code < kActNone ||
      act_code > kActPrelu || (act_code == kActPrelu && a.alpha == nullptr) ||
      (act_code == kActNone && a.r == nullptr && a.bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.rows == 0) return 0;
  if (act_code != kActPrelu) a.alpha = nullptr;
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const bool vec = a.c % 4 == 0 && a.cr % 4 == 0 && aligned16(a.y) &&
                   aligned16(a.r) && aligned16(a.alpha) &&
                   aligned16(a.bias) && aligned16(a.scale) &&
                   aligned16(a.shift) && aligned16(a.out) && aligned16(a.z);
  if (vec) {
    a.width = 4;
    err = by_act<float4>(act_code, a);
  } else {
    a.width = 1;
    err = by_act<float>(act_code, a);
  }
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

}  // namespace

// y, out: [rows, c] float32; r: [rows, cr] or null (cr 0); alpha: [c] for
// PReLU (act 2), else ignored; bias: [c] or null; act 0 none, 1 ReLU,
// 2 PReLU.  out == y runs in place: only for a bias pass with no residual
// and act none or ReLU.
extern "C" int fdt_residual_act(const void* y, const void* r,
                                const void* alpha, const void* bias,
                                void* out, long long rows, int c, int cr,
                                int act_code, int device, void* stream) {
  if (out == nullptr ||
      (out == y && (r != nullptr || bias == nullptr ||
                    act_code == kActPrelu)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(y), static_cast<const float*>(r),
         static_cast<const float*>(alpha), static_cast<const float*>(bias),
         nullptr, nullptr, static_cast<float*>(out), nullptr,
         rows, c, cr, 1, static_cast<cudaStream_t>(stream)};
  return launch(a, act_code, device);
}

// The pass of fdt_residual_act, then z = out * scale + shift ([c] each),
// both rounded: z [rows, c] always, out where it is not null.  Never in
// place: z and out are buffers of their own.  Only for a PReLU with the
// bias and no residual, or the bias and a same-width residual (cr == c)
// with act 0; any other pass returns cudaErrorInvalidValue.
extern "C" int fdt_residual_act_affine(const void* y, const void* r,
                                       const void* alpha, const void* bias,
                                       const void* scale, const void* shift,
                                       void* out, void* z, long long rows,
                                       int c, int cr, int act_code,
                                       int device, void* stream) {
  if (scale == nullptr || shift == nullptr || z == nullptr || z == y ||
      z == r || out == y || (out != nullptr && out == z))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(y), static_cast<const float*>(r),
         static_cast<const float*>(alpha), static_cast<const float*>(bias),
         static_cast<const float*>(scale), static_cast<const float*>(shift),
         static_cast<float*>(out), static_cast<float*>(z),
         rows, c, cr, 1, static_cast<cudaStream_t>(stream)};
  return launch(a, act_code, device);
}
