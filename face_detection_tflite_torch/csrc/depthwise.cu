// A depthwise convolution with its bias and activation in one pass for
// Hopper (sm_90a), K7 of the port.
//
// No TPU kernel corresponds to it: on the TPU, XLA fused each depthwise
// convolution with the elementwise ops after it.  On the card cuDNN ran
// every DEPTHWISE_CONV_2D (its conv2d_c1_k1_nhwc kernel), and a K5 pass
// (epilogue.cu) then read the output once more for the bias, alone or
// with the ReLU or PReLU after it.  Before a TF SAME
// convolution at stride 2, whose pads are asymmetric, the executor also
// copied the input into a padded tensor (F.pad).  This kernel reads the
// unpadded NHWC input and writes the output once:
//
//   out[n, y, x, c] = act(sum_{dy, dx} in[n, y*s - pt + dy, x*s - pl + dx, c]
//                         * w[c, dy, dx] + b[c])
//   with in read as 0 outside [0, H) x [0, W) (the pads, asymmetric too);
//   act none, ReLU or PReLU(alpha[c]); b optional
//
// for k x k filters, k in {3, 5, 7}, and strides s in {1, 2} (template
// parameters), channel multiplier 1 and dilation 1.  Each output is the
// float32 FFMA sum of its k^2 taps, dy outer and dx inner, from 0 (no
// TF32); then (sum + b[c]) is rounded and the activation applied, in K5's
// order: ReLU is torch.relu's clamp (NaN passes), PReLU x >= 0 ? x : x * a
// (NaN takes the multiply).
//
// What bounds it on this card: bytes.  It reads the input and writes the
// output once, 4 bytes a value each, and does 2 k^2 operations an output
// value (at most 98), far below the card's float32 ridge of 20 operations a
// byte.  The design moves each byte once from device memory:
// - channels go four at a time (float4) where C is a multiple of 4 and the
//   pointers are 16-byte aligned, one at a time otherwise; neighbouring
//   threads take neighbouring channel vectors of one pixel, so a warp's
//   loads are whole lines;
// - a thread computes R outputs along a row (R in {1, 2, 4}): for each of
//   the k input rows it loads the (R - 1) s + k vectors the run needs into
//   registers once and takes every tap from there, so the taps it shares
//   with its own neighbours cost no load;
// - it does so for NI images, tn apart, with the same filter taps;
// - a block covers a tile of outputs, several rows of runs (and several
//   images where a map is small) over a group of channel vectors, so that
//   the input rows that vertical neighbours share are read from L1 within
//   the block, and the tile's halo from L2;
// - the filter taps: at k = 3 in float4, each thread loads its own k^2
//   vectors (its four channels' 36 taps, contiguous in the filter's
//   [C, k, k] layout) into registers, with no shared memory and no barrier,
//   so that a block's first loads of its input and of its taps are in
//   flight together; at k = 5 and 7, for single channels, and at stride 2
//   on a large problem, where the taps would crowd the registers the runs
//   need, the block's taps go through shared memory, read once from the
//   [C, k, k] layout and stored tap-major, so that each tap is one 16-byte
//   read a thread;
// - the bias and the activation in registers before each store.
// The tiling is chosen on the host from what it can see: the map's size,
// the batch, C, k and the stride (choose(), below).  It allocates nothing:
// the wrapper (ops/depthwise.py) allocates the output.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;  // threads a block, at most
// Blocks an SM must hold: caps a thread at 128 registers, as in the sweep
// the tiling was fitted to; with more the large maps lose occupancy.
constexpr int kMinBlocks = 4;

enum { kActNone = 0, kActRelu = 1, kActPrelu = 2 };

struct Tiling {
  int n, h, w, cv;      // input: images, rows, columns, channel vectors
  int oh, ow;           // output rows and columns
  int pt, pl;           // leading pads (rows, columns)
  int gv;               // channel vectors a group
  int ts, th, tn;       // runs, rows and images a block at a time
  int ni;               // images a thread, tn apart
  int groups, tiles_w, tiles_h;
  int act;
};

__device__ __forceinline__ float act_of(float v, float a, int act) {
  if (act == kActRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  if (act == kActPrelu) return v >= 0.0f ? v : __fmul_rn(v, a);
  return v;
}

__device__ __forceinline__ float fma_of(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ float4 fma_of(float4 a, float4 b, float4 c) {
  return make_float4(__fmaf_rn(a.x, b.x, c.x), __fmaf_rn(a.y, b.y, c.y),
                     __fmaf_rn(a.z, b.z, c.z), __fmaf_rn(a.w, b.w, c.w));
}

__device__ __forceinline__ float add_of(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add_of(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 act_of(float4 v, float4 a, int act) {
  return make_float4(act_of(v.x, a.x, act), act_of(v.y, a.y, act),
                     act_of(v.z, a.z, act), act_of(v.w, a.w, act));
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// x: [n, h, w, C], out: [n, oh, ow, C], bias and alpha: [C] (or null), all
// in vectors V of L = sizeof(V) / 4 channels; w: [C, K, K] float32.
// kRegTaps (float4 only): each thread holds its own taps in registers,
// else the block's taps are in shared memory.
template <typename V, int K, int S, int R, bool kRegTaps>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
depthwise_conv_kernel(const V* __restrict__ x, const float* __restrict__ w,
                      const V* __restrict__ bias, const V* __restrict__ alpha,
                      V* __restrict__ out, Tiling g) {
  constexpr int L = sizeof(V) / sizeof(float);
  constexpr int KK = K * K;
  constexpr int kCols = (R - 1) * S + K;  // input vectors a run's row needs
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);  // [K * K][gv * L]

  int b = blockIdx.x;
  const int group = b % g.groups;
  b /= g.groups;
  const int tile_w = b % g.tiles_w;
  b /= g.tiles_w;
  const int tile_h = b % g.tiles_h;
  const int tile_n = b / g.tiles_h;
  const int c0 = group * g.gv;               // the group's first vector
  const int nv = min(g.gv, g.cv - c0);       // its vectors

  if constexpr (!kRegTaps) {
    // The group's filter taps, contiguous in w, into [tap][channel].
    const float* wg = w + static_cast<long long>(c0) * L * KK;
    for (int i = threadIdx.x; i < nv * L * KK; i += blockDim.x) {
      const int ch = i / KK, t = i - ch * KK;
      taps[t * g.gv * L + ch] = __ldg(wg + i);
    }
    __syncthreads();
  }

  int t = threadIdx.x;
  const int v = t % g.gv;
  t /= g.gv;
  const int run = t % g.ts;
  t /= g.ts;
  const int row = t % g.th;
  const int img = t / g.th;
  const int oy = tile_h * g.th + row;
  const int ox0 = (tile_w * g.ts + run) * R;
  const int n0 = tile_n * g.tn * g.ni + img;  // then every g.tn-th image
  if (v >= nv || n0 >= g.n || oy >= g.oh || ox0 >= g.ow)
    return;
  const int cv = c0 + v;
  const V* vtaps = reinterpret_cast<const V*>(taps) + v;
  // This thread's four channels' taps, [4][K * K] in w (kRegTaps).
  float own[kRegTaps ? 4 * KK : 1];
  if constexpr (kRegTaps) {
    const float4* wv = reinterpret_cast<const float4*>(w) +
                       static_cast<long long>(cv) * KK;
#pragma unroll
    for (int q = 0; q < KK; ++q) {
      const float4 f = __ldg(wv + q);
      own[4 * q] = f.x;
      own[4 * q + 1] = f.y;
      own[4 * q + 2] = f.z;
      own[4 * q + 3] = f.w;
    }
  }
  const V bv = bias != nullptr ? __ldg(bias + cv) : zero<V>();
  const V av = g.act == kActPrelu ? __ldg(alpha + cv) : zero<V>();
  const int iy0 = oy * S - g.pt, ix0 = ox0 * S - g.pl;

  for (int q = 0, ni = n0; q < g.ni && ni < g.n; ++q, ni += g.tn) {
    V acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = zero<V>();
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int iy = iy0 + dy;
      const bool in_rows = iy >= 0 && iy < g.h;
      const V* xr =
          x + (static_cast<long long>(ni) * g.h + iy) * g.w * g.cv + cv;
      V xv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int ix = ix0 + j;
        xv[j] = in_rows && ix >= 0 && ix < g.w
                    ? __ldg(xr + static_cast<long long>(ix) * g.cv)
                    : zero<V>();
      }
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int tap = dy * K + dx;
        V wv;
        if constexpr (kRegTaps)
          wv = make_float4(own[tap], own[KK + tap], own[2 * KK + tap],
                           own[3 * KK + tap]);
        else
          wv = vtaps[tap * g.gv];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = fma_of(xv[r * S + dx], wv, acc[r]);
      }
    }
    V* o = out + ((static_cast<long long>(ni) * g.oh + oy) * g.ow + ox0) *
                     g.cv + cv;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (ox0 + r >= g.ow) break;
      const V y = bias != nullptr ? add_of(acc[r], bv) : acc[r];
      o[static_cast<long long>(r) * g.cv] = act_of(y, av, g.act);
    }
  }
}

template <typename V, int K, int S, int R, bool kRegTaps>
cudaError_t launch(const void* x, const float* w, const void* bias,
                   const void* alpha, void* out, const Tiling& g,
                   long long blocks, cudaStream_t stream) {
  constexpr int L = sizeof(V) / sizeof(float);
  const size_t smem = kRegTaps ? 0 : sizeof(float) * K * K * g.gv * L;
  depthwise_conv_kernel<V, K, S, R, kRegTaps>
      <<<static_cast<unsigned>(blocks), g.gv * g.ts * g.th * g.tn, smem,
         stream>>>(static_cast<const V*>(x), w, static_cast<const V*>(bias),
                   static_cast<const V*>(alpha), static_cast<V*>(out), g);
  return cudaGetLastError();
}

template <typename V, int K, int S, bool kRegTaps>
cudaError_t launch_r(int r, const void* x, const float* w, const void* bias,
                     const void* alpha, void* out, const Tiling& g,
                     long long blocks, cudaStream_t st) {
  switch (r) {
    case 1: return launch<V, K, S, 1, kRegTaps>(x, w, bias, alpha, out, g,
                                                blocks, st);
    case 2: return launch<V, K, S, 2, kRegTaps>(x, w, bias, alpha, out, g,
                                                blocks, st);
    case 4: return launch<V, K, S, 4, kRegTaps>(x, w, bias, alpha, out, g,
                                                blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename V>
cudaError_t launch_ks(int k, int s, int r, bool reg_taps, const void* x,
                      const float* w, const void* bias, const void* alpha,
                      void* out, const Tiling& g, long long blocks,
                      cudaStream_t st) {
  if constexpr (sizeof(V) == sizeof(float4)) {
    if (reg_taps && k == 3)
      return s == 1 ? launch_r<V, 3, 1, true>(r, x, w, bias, alpha, out, g,
                                              blocks, st)
                    : launch_r<V, 3, 2, true>(r, x, w, bias, alpha, out, g,
                                              blocks, st);
  }
  switch (k * 10 + s) {
    case 31: return launch_r<V, 3, 1, false>(r, x, w, bias, alpha, out, g,
                                             blocks, st);
    case 32: return launch_r<V, 3, 2, false>(r, x, w, bias, alpha, out, g,
                                             blocks, st);
    case 51: return launch_r<V, 5, 1, false>(r, x, w, bias, alpha, out, g,
                                             blocks, st);
    case 52: return launch_r<V, 5, 2, false>(r, x, w, bias, alpha, out, g,
                                             blocks, st);
    case 71: return launch_r<V, 7, 1, false>(r, x, w, bias, alpha, out, g,
                                             blocks, st);
    case 72: return launch_r<V, 7, 2, false>(r, x, w, bias, alpha, out, g,
                                             blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The launch's shape from what the host sees: whether channels go in
// float4 (vec) and taps in registers (reg_taps), the run length r, the
// tiling g and the block count.  The thresholds are in threads an SM
// (sms SMs), fitted to a sweep of tilings over the depthwise convolutions
// of the port's networks at batches 1 to 512 on an H100:
// - a thread's work grows with k^2, so at k >= 5 a small problem (under
//   192 channel vectors of output an SM) runs single channels, four times
//   the threads;
// - runs of four outputs, which load each input vector once for four
//   outputs, where the single-output threads would give over 1024 an SM;
//   of two above 128 an SM; single outputs below, where the card's
//   latency, not its bandwidth, is the bound;
// - the taps in registers at k = 3 in float4, except at stride 2 on a
//   large problem, where the wider input rows need the registers;
// - channel groups of 16 vectors on large problems, 8 on small ones (32
//   single channels), and blocks of at most 128 threads: about four rows
//   of runs over the group, more images where the map is small;
// - each thread takes 2, 4 or 8 images while the card keeps 1024 threads
//   an SM, so that its taps serve more outputs.
struct Launch {
  bool vec, reg_taps;
  int r;
  Tiling g;
  long long blocks;
};

Launch choose(int n, int h, int wd, int c, int k, int stride, int pt,
              int pl, int oh, int ow, int act, bool aligned, bool w_aligned,
              int sms) {
  Launch l;
  const long long pixels = static_cast<long long>(n) * oh * ow;
  l.vec = c % 4 == 0 && aligned && !(k >= 5 && pixels * (c / 4) < 192LL * sms);
  const int cv = l.vec ? c / 4 : c;
  const long long singles = pixels * cv;  // threads at one output each
  l.reg_taps = l.vec && w_aligned && k == 3 &&
               (stride == 1 || singles < 1024LL * sms);
  l.r = ow >= 3 && singles >= 1024LL * sms ? 4
        : ow >= 2 && singles >= 128LL * sms ? 2
                                             : 1;
  const int runs = static_cast<int>(cdiv(ow, l.r));
  const long long units = static_cast<long long>(n) * oh * runs * cv;
  Tiling& g = l.g;
  g.n = n; g.h = h; g.w = wd; g.cv = cv; g.oh = oh; g.ow = ow;
  g.pt = pt; g.pl = pl; g.act = act;
  const int group = l.vec ? (units >= 1024LL * sms ? 16 : 8) : 32;
  g.groups = static_cast<int>(cdiv(cv, std::min(group, cv)));
  g.gv = static_cast<int>(cdiv(cv, g.groups));
  g.ts = std::min(runs, std::max(1, kThreads / (g.gv * 4)));
  g.th = std::min(oh, std::max(1, kThreads / (g.gv * g.ts)));
  g.tn = std::min(n, std::max(1, kThreads / (g.gv * g.ts * g.th)));
  g.ni = 1;
  while (g.ni < 8 && units / (2 * g.ni) >= 1024LL * sms &&
         static_cast<long long>(g.tn) * g.ni < n)
    g.ni *= 2;
  g.tiles_w = static_cast<int>(cdiv(runs, g.ts));
  g.tiles_h = static_cast<int>(cdiv(oh, g.th));
  l.blocks = static_cast<long long>(g.groups) * g.tiles_w * g.tiles_h *
             cdiv(n, static_cast<long long>(g.tn) * g.ni);
  return l;
}

}  // namespace

// x: [n, h, w, c] float32 NHWC; w: [c, k, k] float32 (the [c, 1, k, k]
// filter); bias, alpha: [c] or null (alpha for PReLU, act 2, only); out:
// [n, oh, ow, c]; pt, pl: the leading pads (the trailing ones are read as
// zeros past the input's edge); act 0 none, 1 ReLU, 2 PReLU.  k in
// {3, 5, 7}, stride in {1, 2}; oh, ow the output size of the pads given.
extern "C" int fdt_depthwise_conv(const void* x, const void* w,
                                  const void* bias, const void* alpha,
                                  void* out, int n, int h, int wd, int c,
                                  int k, int stride, int pt, int pl, int oh,
                                  int ow, int act, int device, void* stream) {
  if (x == nullptr || w == nullptr || out == nullptr || n < 1 || h < 1 ||
      wd < 1 || c < 1 || oh < 1 || ow < 1 || pt < 0 || pl < 0 ||
      (k != 3 && k != 5 && k != 7) || (stride != 1 && stride != 2) ||
      act < kActNone || act > kActPrelu ||
      (act == kActPrelu) != (alpha != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // `device` is made current for the launch only, as in warp.cu.
  int previous = device;
  cudaError_t err = cudaGetDevice(&previous);
  if (err == cudaSuccess && previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const Launch l = choose(
      n, h, wd, c, k, stride, pt, pl, oh, ow, act,
      aligned16(x) && aligned16(bias) && aligned16(alpha) && aligned16(out),
      aligned16(w), sms);
  if (l.blocks > 0x7fffffffLL ||
      static_cast<long long>(n) * h * wd * c > (1LL << 40)) {
    if (previous != device) cudaSetDevice(previous);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* wf = static_cast<const float*>(w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = l.vec ? launch_ks<float4>(k, stride, l.r, l.reg_taps, x, wf, bias,
                                  alpha, out, l.g, l.blocks, st)
              : launch_ks<float>(k, stride, l.r, false, x, wf, bias, alpha,
                                 out, l.g, l.blocks, st);
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
