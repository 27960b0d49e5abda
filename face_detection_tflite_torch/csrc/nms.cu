// Weighted-NMS core for Hopper (sm_90a), K1 of the port.
//
// Replaces: face_detection_tflite_tpu/ops/nms_pallas.py::_nms_kernel (the
// repo's Pallas TPU kernel) and, on the main path, the all-anchor XLA
// fixpoint face_detection_tflite_tpu/ops/detections.py::weighted_nms, which
// computes the same function at k = 896.
//
// Function: candidates sorted by descending score (invalid ones last, so the
// valid ones form a prefix of length n).  Candidate i leads iff it is valid
// and no earlier leader overlaps it with IoU > thr (strict).  Candidate j is
// owned by the first leader i <= j with IoU(i, j) > thr and valid[j].  Each
// leader's output box is the score-weighted average of its owned boxes;
// non-leader rows are 0.
//
// What bounds it on this card: not bytes (about 40 bytes per candidate) nor
// operations (n^2/2 IoUs of ~15 fp32 operations, n ~ 30 on the main path),
// but latency: the greedy scan is a chain of dependent decisions, one
// barrier per leader.  The design answers that with one CTA per image and
// the whole batch in one launch (the TPU form ran one pallas_call per image
// under vmap), work confined to the valid prefix n, IoU computed on the fly
// from shared memory (no [k, k] matrix), and no barrier for a candidate
// that is not a leader.  Each leader sums its members in increasing j with
// no atomics, so runs repeat bit for bit.  The library is built with
// -fmad=false and the IoU uses explicit _rn intrinsics: the strict > thr
// decisions then match the plain PyTorch version exactly.
//
// Shared memory: 26 bytes per candidate, sized by k (about 60 KB at the
// full-range model's k = 2304, above the default 48 KB: opted in below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// IoU of leader a (row) and candidate b (column), in the order of the plain
// version: inter / ((area_a + area_b) - inter), 0 where the union is <= 0.
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b,
                                     float area_b) {
  const float ix0 = fmaxf(a.x, b.x);
  const float iy0 = fmaxf(a.y, b.y);
  const float ix1 = fminf(a.z, b.z);
  const float iy1 = fminf(a.w, b.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix1, ix0), 0.f),
                                fmaxf(__fsub_rn(iy1, iy0), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
nms_core_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ leader, float4* __restrict__ blended,
                int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  int* sowner = reinterpret_cast<int*>(sarea + k);
  uint8_t* svalid = reinterpret_cast<uint8_t*>(sowner + k);
  // 0 = not a leader, 1 = leader, 2 = leader that owns itself (IoU(i,i) > thr)
  uint8_t* slead = svalid + k;
  __shared__ int s_n;

  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const float4* gbox = boxes + base;
  const float* gscore = scores + base;
  const uint8_t* gvalid = valid + base;
  uint8_t* glead = leader + base;
  float4* gblend = blended + base;

  // n = one past the last valid candidate.
  if (tid == 0) s_n = 0;
  __syncthreads();
  int last = 0;
  for (int j = tid; j < k; j += kThreads)
    if (gvalid[j]) last = j + 1;
  for (int off = 16; off > 0; off >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
  if ((tid & 31) == 0 && last > 0) atomicMax(&s_n, last);
  __syncthreads();
  const int n = s_n;

  for (int j = tid; j < n; j += kThreads) {
    const float4 bx = gbox[j];
    sbox[j] = bx;
    sarea[j] = box_area(bx);
    sowner[j] = -1;
    svalid[j] = gvalid[j] ? 1 : 0;
    slead[j] = 0;
  }
  __syncthreads();

  // Greedy scan.  Iteration i only writes sowner[j > i] and slead[i]; the
  // decision reads sowner[i] and svalid[i], last written before a barrier,
  // so every thread takes the same branch.
  for (int i = 0; i < n; ++i) {
    if (!svalid[i] || sowner[i] != -1) continue;  // suppressed or invalid
    const float4 bi = sbox[i];
    const float ai = sarea[i];
    if (tid == 0) slead[i] = iou(bi, ai, bi, ai) > thr ? 2 : 1;
    for (int j = i + 1 + tid; j < n; j += kThreads) {
      if (svalid[j] && sowner[j] == -1 && iou(bi, ai, sbox[j], sarea[j]) > thr)
        sowner[j] = i;
    }
    __syncthreads();
  }
  __syncthreads();

  // Blend: one thread per leader, members in increasing j.
  for (int i = tid; i < n; i += kThreads) {
    const uint8_t li = slead[i];
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    if (li) {
      float ws = 0.f, ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;
      for (int j = i; j < n; ++j) {
        if (j == i ? li != 2 : sowner[j] != i) continue;
        const float s = gscore[j];
        const float4 bx = sbox[j];
        ws = __fadd_rn(ws, s);
        ax = __fadd_rn(ax, __fmul_rn(s, bx.x));
        ay = __fadd_rn(ay, __fmul_rn(s, bx.y));
        az = __fadd_rn(az, __fmul_rn(s, bx.z));
        aw = __fadd_rn(aw, __fmul_rn(s, bx.w));
      }
      const float d = fmaxf(ws, 1e-12f);
      out = make_float4(__fdiv_rn(ax, d), __fdiv_rn(ay, d),
                        __fdiv_rn(az, d), __fdiv_rn(aw, d));
    }
    glead[i] = li ? 1 : 0;
    gblend[i] = out;
  }
  for (int j = n + tid; j < k; j += kThreads) {
    glead[j] = 0;
    gblend[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

extern "C" int fdt_nms_core(const void* boxes, const void* scores,
                            const void* valid, void* leader, void* blended,
                            int batch, int k, float thr, int device,
                            void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(k) * (16 + 4 + 4 + 1 + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_core_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_core_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(leader),
      static_cast<float4*>(blended), k, thr);
  return static_cast<int>(cudaGetLastError());
}
