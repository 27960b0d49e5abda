// A 1x1 convolution with its bias, residual add and activation in one pass
// for Hopper (sm_90a), K6 of the port.
//
// No TPU kernel corresponds to it: on the TPU, XLA fused each convolution
// with the elementwise ops after it.  On the card cuDNN's float32 path (TF32
// off) ran MobileFaceNet's 1x1 convolutions as an NCHW implicit GEMM between
// two layout transposes of the NHWC activations, and K5 (epilogue.cu) then
// read the output once more for the bias and the PReLU or the residual.
// This kernel reads the NHWC activations once and applies K5's epilogue as
// it stores:
//
//   out[m, n] = act((sum_k x[m, k] * w[k, n] + b[n]) + r[m, n])
//   m over the N*H*W rows of NHWC x; act none, ReLU or PReLU(alpha[n]);
//   b and r optional
//
// The sum is float32 FFMA on the CUDA cores, k in increasing order (no TF32,
// no split); then, rounded one at a time as K5 rounds them, the bias, the
// residual (never sum + (b + r)) and the activation: ReLU is torch.relu's
// clamp (NaN passes), PReLU x >= 0 ? x : x * a (NaN takes the multiply).
//
// What bounds it on this card: per site the larger of its FLOPs (2 M K N)
// at 67 TFLOP/s and its bytes (x read, the output written, and the
// residual read once: 4 M (K + N (+ N)) B) at 3.35 TB/s.  MobileFaceNet's
// expand convolutions (K 64-128, N 128-512) lie near the card's float32
// ridge of 20 FLOP/B, its projections (K 256-512) above it.  The design:
// - a block computes a 128-row x BN-column tile (BN 128, or 64 where N is
//   not a multiple of 128 or the grid would hold under two blocks an SM),
//   256 threads, each an 8 x (BN / 16) register tile of FFMAs, 64 rows
//   apart in two groups of four so that its shared-memory reads are float4
//   broadcasts and conflict-free rows;
// - K in chunks of 16, double-buffered in shared memory: the filter's
//   [K, N] rows (at most 1 MB, held in L2 across the blocks) by cp.async,
//   x's rows (each read from device memory once a column tile; the column
//   tiles of one row tile run in neighbouring blocks, so the others hit L2)
//   by float4 loads into registers, stored transposed after the chunk's
//   FFMAs so that the loads hide under them;
// - the epilogue in registers: the bias, the residual and the activation
//   on each float4 of the tile before its 16-byte store along N, so the
//   output is written once and never read back;
// - act and the residual are runtime arguments, one instance a BN; K or N
//   not a multiple of 4 (rows not 16-byte aligned) takes a third instance
//   (BN 64) with scalar loads and stores on the same tiles, so that the
//   aligned instances keep their registers.
// It allocates nothing: the wrapper (ops/pointwise.py) allocates the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;     // rows a block
constexpr int kBK = 16;      // k a chunk
constexpr int kAStride = kBM + 4;  // padded row of the transposed x tile

enum { kActNone = 0, kActRelu = 1, kActPrelu = 2 };

__device__ __forceinline__ float act_of(float v, float a, int act) {
  if (act == kActRelu) return isnan(v) ? v : fmaxf(v, 0.0f);
  if (act == kActPrelu) return v >= 0.0f ? v : __fmul_rn(v, a);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int BN>
struct Tiles {
  float a[2][kBK][kAStride];  // x's chunk, transposed: [k][row]
  float b[2][kBK][BN];        // the filter's chunk: [k][column]
};

// x: [m, k], w: [k, n], r and out: [m, n], all float32 row-major; with
// kVec, k and n are multiples of 4 and every row is 16-byte aligned.
template <int BN, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pointwise_conv_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ alpha,
                      const float* __restrict__ r, float* __restrict__ out,
                      int m, int k, int n, int act) {
  constexpr int TN = BN / 16;             // columns a thread: 8 or 4
  constexpr int kBVec = kBK * BN / 4;     // float4s of a filter chunk
  static_assert(kBVec % kThreads == 0, "a filter chunk fills the threads");
  __shared__ __align__(16) Tiles<BN> s;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col_tiles = (n + BN - 1) / BN;
  const int row0 = (blockIdx.x / col_tiles) * kBM;
  const int col0 = (blockIdx.x % col_tiles) * BN;
  const int chunks = (k + kBK - 1) / kBK;

  // x's chunk: 128 rows x 16 k = 512 float4s, two a thread, four threads a
  // row (64 contiguous bytes).
  constexpr int kRowVec = kBK / 4;                   // float4s a row
  constexpr int kXPer = kBM * kRowVec / kThreads;    // float4s a thread
  static_assert(kBM * kRowVec % kThreads == 0, "x's chunk fills the threads");
  float4 xa[kXPer];
  auto load_x = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kXPer; ++p) {
      const int v = tid + p * kThreads;
      const int row = row0 + v / kRowVec, kk = k0 + (v % kRowVec) * 4;
      const float* at = x + static_cast<long long>(row) * k + kk;
      if (row >= m || kk >= k)
        xa[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else if constexpr (kVec)
        xa[p] = __ldg(reinterpret_cast<const float4*>(at));
      else
        xa[p] = make_float4(__ldg(at), kk + 1 < k ? __ldg(at + 1) : 0.0f,
                            kk + 2 < k ? __ldg(at + 2) : 0.0f,
                            kk + 3 < k ? __ldg(at + 3) : 0.0f);
    }
  };
  auto store_x = [&](int buf) {
#pragma unroll
    for (int p = 0; p < kXPer; ++p) {
      const int v = tid + p * kThreads;
      const int row = v / kRowVec, kk = (v % kRowVec) * 4;
      s.a[buf][kk + 0][row] = xa[p].x;
      s.a[buf][kk + 1][row] = xa[p].y;
      s.a[buf][kk + 2][row] = xa[p].z;
      s.a[buf][kk + 3][row] = xa[p].w;
    }
  };
  auto load_w = [&](int buf, int k0) {
#pragma unroll
    for (int p = 0; p < kBVec / kThreads; ++p) {
      const int v = tid + p * kThreads;
      const int kk = v / (BN / 4), c = (v % (BN / 4)) * 4;
      float* dst = &s.b[buf][kk][c];
      const int col = col0 + c;
      const float* src = w + static_cast<long long>(k0 + kk) * n + col;
      if (k0 + kk >= k || col >= n)
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      else if constexpr (kVec)
        cp_async16(dst, src);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(
            __ldg(src), col + 1 < n ? __ldg(src + 1) : 0.0f,
            col + 2 < n ? __ldg(src + 2) : 0.0f,
            col + 3 < n ? __ldg(src + 3) : 0.0f);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  load_x(0);
  load_w(0, 0);
  store_x(0);
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < chunks; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < chunks;
    if (more) {
      load_x((t + 1) * kBK);
      load_w(cur ^ 1, (t + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[cur][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.a[cur][kk][64 + ty * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[cur][kk][tx * 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 =
            *reinterpret_cast<const float4*>(&s.b[cur][kk][64 + tx * 4]);
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_x(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // The epilogue: rows ty*4 + i and 64 + ty*4 + i, columns tx*4 + j (and
  // 64 + tx*4 + j where BN is 128), a float4 at a time.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m) continue;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int col = col0 + g * 64 + tx * 4;
      if (col >= n) continue;
      const long long at = static_cast<long long>(row) * n + col;
      if constexpr (!kVec) {
        // Unaligned rows: one column at a time, in the same order (the
        // loop unrolled, so that acc stays in registers).
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j >= n) continue;
          float v = acc[i][g * 4 + j];
          if (bias != nullptr) v = __fadd_rn(v, __ldg(bias + col + j));
          if (r != nullptr) v = __fadd_rn(v, __ldg(r + at + j));
          out[at + j] = act_of(
              v, act == kActPrelu ? __ldg(alpha + col + j) : 0.0f, act);
        }
        continue;
      }
      float v[4] = {acc[i][g * 4 + 0], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                    acc[i][g * 4 + 3]};
      if (bias != nullptr) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
        v[0] = __fadd_rn(v[0], b.x); v[1] = __fadd_rn(v[1], b.y);
        v[2] = __fadd_rn(v[2], b.z); v[3] = __fadd_rn(v[3], b.w);
      }
      if (r != nullptr) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(r + at));
        v[0] = __fadd_rn(v[0], q.x); v[1] = __fadd_rn(v[1], q.y);
        v[2] = __fadd_rn(v[2], q.z); v[3] = __fadd_rn(v[3], q.w);
      }
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (act == kActPrelu)
        a = __ldg(reinterpret_cast<const float4*>(alpha + col));
      *reinterpret_cast<float4*>(out + at) =
          make_float4(act_of(v[0], a.x, act), act_of(v[1], a.y, act),
                      act_of(v[2], a.z, act), act_of(v[3], a.w, act));
    }
  }
}

template <int BN, bool kVec>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* alpha, const float* r, float* out,
                   long long m, int k, int n, int act, cudaStream_t stream) {
  const long long tiles =
      ((m + kBM - 1) / kBM) * static_cast<long long>((n + BN - 1) / BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  pointwise_conv_kernel<BN, kVec>
      <<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
          x, w, bias, alpha, r, out, static_cast<int>(m), k, n, act);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x: [m, k], w: [k, n], out: [m, n] float32 row-major; bias, alpha: [n] or
// null (alpha for PReLU, act 2, only); r: [m, n] or null; act 0 none,
// 1 ReLU, 2 PReLU.  k, n >= 1; where both are multiples of 4, every
// pointer 16-byte aligned; m under 2^31 - 128.
extern "C" int fdt_pointwise_conv(const void* x, const void* w,
                                  const void* bias, const void* alpha,
                                  const void* r, void* out, long long m,
                                  int k, int n, int act, int device,
                                  void* stream) {
  const bool vec = k % 4 == 0 && n % 4 == 0;
  if (m < 0 || m > 0x7fffffffLL - kBM || k < 1 || n < 1 ||
      act < kActNone || act > kActPrelu ||
      (act == kActPrelu) != (alpha != nullptr) || x == nullptr ||
      w == nullptr || out == nullptr ||
      (vec && !(aligned16(x) && aligned16(w) && aligned16(bias) &&
                aligned16(alpha) && aligned16(r) && aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
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
  const long long row_tiles = (m + kBM - 1) / kBM;
  // BN 128 where N takes it and the grid still holds two blocks an SM.
  const bool wide =
      vec && n % 128 == 0 && row_tiles * (n / 128) >= 2LL * sms;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const float* af = static_cast<const float*>(alpha);
  const float* rf = static_cast<const float*>(r);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = !vec  ? launch<64, false>(xf, wf, bf, af, rf, of, m, k, n, act, st)
        : wide ? launch<128, true>(xf, wf, bf, af, rf, of, m, k, n, act, st)
               : launch<64, true>(xf, wf, bf, af, rf, of, m, k, n, act, st);
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
