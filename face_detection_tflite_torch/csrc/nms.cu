// K1 of the port for Hopper (sm_90a): the BlazeFace detection postprocess
// and the weighted-NMS core it runs.
//
// Replaces: face_detection_tflite_tpu/ops/nms_pallas.py:36 `_nms_kernel`
// (the repo's Pallas TPU kernel) and, on the main path, the JAX postprocess
// that XLA compiled around it: face_detection_tflite_tpu/ops/detections.py
// :47 decode_detections, :89 _topk_candidates, :99 _emit_slab,
// :119 weighted_nms (its all-anchor fixpoint), :197 remove_letterbox and
// :219 detection_postprocess, which runs those in that order.
//
// Two entry points share the device code (IoU, greedy scan, blend):
//
// * fdt_detection_postprocess: the detector's raw outputs ([B, A, 16] boxes,
//   [B, A] logits, [A, 2] anchors) -> the [B, D] slab (boxes, keypoints,
//   scores, valid), one CTA per image and the batch in one launch.
// * fdt_nms_core: score-sorted candidates -> leader mask and blended boxes
//   (the function of `_nms_kernel`), one CTA per image.
//
// Function: score = sigmoid(clip(logit, +-100)); an anchor is valid iff
// score >= 0.5 and its decoded w > 0 and h > 0.  The valid anchors are
// ranked by (score descending, anchor index ascending), the order of a
// stable descending sort and of lax.top_k, and the first k are kept.
// Candidate i leads iff no earlier leader overlaps it with IoU > thr
// (strict).  Candidate j is owned by the first leader i <= j with
// IoU(i, j) > thr (so a leader owns itself only when IoU(i, i) > thr).  A
// leader's box is the score-weighted average of the boxes it owns; its
// score and keypoints are its own.  The first D leaders fill the slab in
// order, then the letterbox is removed: (v - pad_lo) / (1 - pad_lo -
// pad_hi).  Rows after the last leader are zero before that removal, as in
// the plain version, which removes the letterbox from the whole slab.
//
// What bounds it on this card: latency, not bytes or operations.  On the
// main path about 30 of 896 anchors are valid per image: the work is a few
// kilobytes and a few thousand IoUs, and the time goes to dependent steps
// (global-memory round trips, barriers, the greedy chain).  The design:
// * one pass over the logits; the box of an anchor is read only when it is
//   valid, its keypoints only when it leads a row of the slab;
// * the valid anchors are compacted in index order with warp ballots and a
//   double-buffered block prefix (one barrier per 256 anchors), then ranked
//   by counting smaller 64-bit (score, index) keys or, above kRankMaxN, by
//   a bitonic sort of those keys in shared memory;
// * up to kRowsMaxN valid candidates, every strict IoU > thr decision is
//   computed in parallel into bit rows in shared memory, and one warp
//   walks the leaders with word operations, 32 candidates a step: the
//   sequential chain holds no division, no block-wide barrier and no
//   memory access per candidate.  Above that (the rows cost n^2/2 IoUs
//   where the leaders' rows alone suffice) or where the rows do not fit,
//   the launch keeps the on-the-fly scan, one barrier per leader.  Both
//   rules are sizes inside one kernel, chosen from n, not fallbacks;
// * each leader sums its members in increasing j with no atomics, so runs
//   repeat bit for bit; the postprocess takes their scores from shared
//   memory, nms_core from its global input.
// The library is built with -fmad=false and every operation below is an
// explicit _rn intrinsic: decode, IoU decisions, blend and letterbox then
// round as the plain PyTorch versions do, and the divisions are true
// divisions (the plain version divides by a device tensor for that).  The
// sigmoid is computed as PyTorch's CUDA sigmoid computes it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The warp walk keeps one suppression word a lane: bit rows of at most 32
// words (n <= 1024).
constexpr int kMaxRowWords = 32;
// Rows a warp decides together in the bit-row pass (divides 32).
constexpr int kRowBlock = 4;
// Size rules, timed on the H100 (PERF.md): counting rank beat the
// bitonic sort up to 256 valid anchors and lost at 2304; the bit rows beat
// the on-the-fly scan at 30 and 128 valid candidates and lost at 256.
constexpr int kRankMaxN = 256;
constexpr int kRowsMaxN = 128;
// Dynamic shared memory a block may opt in to on Hopper (227 KB), less
// room for the kernels' static shared variables.
constexpr size_t kSmemCap = 232448 - 1024;
constexpr float kRawScoreLimit = 100.f;  // pipeline/config.py RAW_SCORE_LIMIT
constexpr float kMinScore = 0.5f;        // pipeline/config.py MIN_SCORE

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

// Views of one image's candidates, in score order, in shared memory but
// for `score`, which may be global.  `owner` (on-the-fly scan) and `rows`
// (bit rows) alias one region.
struct Cands {
  float4* box;
  float* area;
  const float* score;
  uint8_t* valid;
  uint8_t* lead;  // 0 not a leader, 1 leader, 2 leader that owns itself
  int* owner;
  uint32_t* rows;
  int region_words;
};

// Greedy leader scan over candidates [0, n), called by every thread of the
// block; lead[0, n) must be 0.  Bit rows are used when n <= kRowsMaxN and
// they fit.  Leaves lead[], the first `cap` leaders in order in list[] and
// the leader count in *nlead.  Returns true when the members of leader i
// are the bits of row i (its owned row), false when they are the j with
// owner[j] == i.
__device__ bool greedy_scan(const Cands& c, int n, float thr, int* list,
                            int cap, int* nlead) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int words = (n + 31) >> 5;
  const bool use_rows = n <= kRowsMaxN && words <= kMaxRowWords &&
                        static_cast<long long>(n) * words <= c.region_words;
  if (use_rows) {
    // Every decision at once: one warp per (block of kRowBlock rows from
    // i0, word w); bit j = 32w + lane of row i set iff j >= i and
    // IoU(i, j) > thr.  The block's IoUs are independent, so they overlap.
    // Words left of the diagonal are never read.
    const int blocks = (n + kRowBlock - 1) / kRowBlock;
    for (int t = warp; t < blocks * words; t += kWarps) {
      const int i0 = (t / words) * kRowBlock;
      const int w = t - (t / words) * words;
      if (w < (i0 >> 5)) continue;
      const int j = (w << 5) + lane;
      const bool vj = j < n && c.valid[j];
      const float4 bj = c.box[vj ? j : 0];
      const float aj = c.area[vj ? j : 0];
      bool hit[kRowBlock];
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        const int i = i0 + r;
        hit[r] = vj && j >= i && i < n && c.valid[i] &&
                 iou(c.box[i], c.area[i], bj, aj) > thr;
      }
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r) {
        const uint32_t bits = __ballot_sync(0xffffffffu, hit[r]);
        if (lane == r && i0 + r < n)
          c.rows[static_cast<size_t>(i0 + r) * words + w] = bits;
      }
    }
    __syncthreads();
    if (warp == 0) {
      // One word of 32 candidates at a time.  Lane l holds suppression
      // word l.  The word's leaders are resolved from its
      // diagonal block with shuffles that do not wait on each other; then
      // each leader's row, less what earlier leaders took, becomes its
      // owned row, and its bits suppress later words.
      uint32_t supp = 0;
      int count = 0;
      for (int w = 0; w < words; ++w) {
        const int i = (w << 5) + lane;
        const uint32_t diag =
            i < n ? c.rows[static_cast<size_t>(i) * words + w] : 0u;
        const uint32_t valid = __ballot_sync(0xffffffffu, i < n && c.valid[i]);
        uint32_t s = __shfl_sync(0xffffffffu, supp, w);
        uint32_t leaders = 0;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const uint32_t rb = __shfl_sync(0xffffffffu, diag, b);
          if (((valid & ~s) >> b) & 1u) {
            leaders |= 1u << b;
            s |= rb;
          }
        }
        if ((leaders >> lane) & 1u) {
          c.lead[i] = ((diag >> lane) & 1u) ? 2 : 1;
          const int pos = count + __popc(leaders & ((1u << lane) - 1u));
          if (pos < cap) list[pos] = i;
        }
        count += __popc(leaders);
        for (uint32_t m = leaders; m; m &= m - 1) {
          uint32_t* row = c.rows +
                          static_cast<size_t>((w << 5) + __ffs(m) - 1) * words;
          if (lane >= w && lane < words) {
            const uint32_t r = row[lane];
            row[lane] = r & ~supp;
            supp |= r;
          }
        }
      }
      if (lane == 0) *nlead = count;
    }
  } else {
    for (int j = tid; j < n; j += kThreads) c.owner[j] = -1;
    __syncthreads();
    // Iteration i only writes owner[j > i] (each j always by the same
    // thread) and lead[i]; the decision reads owner[i] and valid[i], last
    // written before a barrier, so every thread takes the same branch.
    int count = 0;
    for (int i = 0; i < n; ++i) {
      if (!c.valid[i] || c.owner[i] != -1) continue;
      const float4 bi = c.box[i];
      const float ai = c.area[i];
      if (tid == 0) {
        c.lead[i] = iou(bi, ai, bi, ai) > thr ? 2 : 1;
        if (count < cap) list[count] = i;
      }
      ++count;
      for (int j = i + 1 + tid; j < n; j += kThreads) {
        if (c.valid[j] && c.owner[j] == -1 &&
            iou(bi, ai, c.box[j], c.area[j]) > thr)
          c.owner[j] = i;
      }
      __syncthreads();
    }
    if (tid == 0) *nlead = count;
  }
  __syncthreads();
  return use_rows;
}

// Score-weighted average of the boxes leader i owns, members in increasing
// j.
__device__ float4 blend(const Cands& c, int i, int n, bool use_rows) {
  float ws = 0.f, ax = 0.f, ay = 0.f, az = 0.f, aw = 0.f;
  auto add = [&](int j) {
    const float s = c.score[j];
    const float4 bx = c.box[j];
    ws = __fadd_rn(ws, s);
    ax = __fadd_rn(ax, __fmul_rn(s, bx.x));
    ay = __fadd_rn(ay, __fmul_rn(s, bx.y));
    az = __fadd_rn(az, __fmul_rn(s, bx.z));
    aw = __fadd_rn(aw, __fmul_rn(s, bx.w));
  };
  if (use_rows) {
    const int words = (n + 31) >> 5;
    const uint32_t* row = c.rows + static_cast<size_t>(i) * words;
    for (int w = i >> 5; w < words; ++w) {
      for (uint32_t m = row[w]; m; m &= m - 1) add((w << 5) + __ffs(m) - 1);
    }
  } else {
    const uint8_t li = c.lead[i];
    for (int j = i; j < n; ++j)
      if (j == i ? li == 2 : c.owner[j] == i) add(j);
  }
  const float d = fmaxf(ws, 1e-12f);
  return make_float4(__fdiv_rn(ax, d), __fdiv_rn(ay, d), __fdiv_rn(az, d),
                     __fdiv_rn(aw, d));
}

__global__ void __launch_bounds__(kThreads)
nms_core_kernel(const float4* __restrict__ boxes,
                const float* __restrict__ scores,
                const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ leader, float4* __restrict__ blended,
                int k, float thr, int region_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k;
  const float4* gbox = boxes + base;
  const uint8_t* gvalid = valid + base;
  uint8_t* glead = leader + base;
  float4* gblend = blended + base;

  // 26 bytes a candidate in shared memory (k <= 8192); the blend reads the
  // scores from the input.
  Cands c;
  c.rows = reinterpret_cast<uint32_t*>(smem);
  c.owner = reinterpret_cast<int*>(smem);
  c.region_words = region_words;
  c.box = reinterpret_cast<float4*>(c.rows + region_words);
  c.area = reinterpret_cast<float*>(c.box + k);
  c.score = scores + base;
  c.valid = reinterpret_cast<uint8_t*>(c.area + k);
  c.lead = c.valid + k;
  __shared__ int s_n, s_nlead;

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
    c.box[j] = bx;
    c.area[j] = box_area(bx);
    c.valid[j] = gvalid[j] ? 1 : 0;
    c.lead[j] = 0;
  }
  __syncthreads();

  const bool use_rows = greedy_scan(c, n, thr, nullptr, 0, &s_nlead);

  for (int i = tid; i < n; i += kThreads) {
    const uint8_t li = c.lead[i];
    glead[i] = li ? 1 : 0;
    gblend[i] = li ? blend(c, i, n, use_rows)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int j = n + tid; j < k; j += kThreads) {
    glead[j] = 0;
    gblend[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// torch.sigmoid(torch.clamp(x, -100, 100)) as PyTorch's CUDA kernels
// compute them: clamp keeps NaN, sigmoid is 1 / (1 + exp(-x)).
__device__ __forceinline__ float sigmoid_clipped(float x) {
  const float c =
      x != x ? x : fminf(fmaxf(x, -kRawScoreLimit), kRawScoreLimit);
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-c)));
}

struct Letterbox {
  float size, pl, pt, sx, sy;
};

__device__ __forceinline__ float unpad_x(const Letterbox& p, float v) {
  return __fdiv_rn(__fsub_rn(v, p.pl), p.sx);
}
__device__ __forceinline__ float unpad_y(const Letterbox& p, float v) {
  return __fdiv_rn(__fsub_rn(v, p.pt), p.sy);
}

__global__ void __launch_bounds__(kThreads)
detection_postprocess_kernel(const float* __restrict__ raw_boxes,
                             const float* __restrict__ raw_scores,
                             const float2* __restrict__ anchors,
                             float4* __restrict__ out_boxes,
                             float2* __restrict__ out_kp,
                             float* __restrict__ out_scores,
                             uint8_t* __restrict__ out_valid, int A, int D,
                             int k, int list_cap, Letterbox lb, float thr,
                             int region_words) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Region: the sort keys, then the bit rows or the owner array.
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  Cands c;
  c.rows = reinterpret_cast<uint32_t*>(smem);
  c.owner = reinterpret_cast<int*>(smem);
  c.region_words = region_words;
  c.box = reinterpret_cast<float4*>(c.rows + region_words);
  c.area = reinterpret_cast<float*>(c.box + A);
  float* score = c.area + A;  // by anchor index until the sort, then by rank
  c.score = score;
  int* idx = reinterpret_cast<int*>(score + A);  // anchor of each rank
  int* list = idx + A;                             // leaders of the slab
  c.valid = reinterpret_cast<uint8_t*>(list + list_cap);
  c.lead = c.valid + A;
  __shared__ int s_count[2][kWarps];
  __shared__ int s_nlead;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* gs = raw_scores + static_cast<size_t>(blockIdx.x) * A;
  const float* gb = raw_boxes + static_cast<size_t>(blockIdx.x) * A * 16;
  const float4* gb4 = reinterpret_cast<const float4*>(gb);

  // 1. Score and validity of every anchor; w and h are read only for an
  //    anchor whose score passes.  Bit t of `mask` is anchor tid + t * T.
  uint32_t mask = 0;
  for (int t = 0, j = tid; j < A; ++t, j += kThreads) {
    const float s = sigmoid_clipped(gs[j]);
    bool v = s >= kMinScore;
    if (v) {
      const float2 wh = reinterpret_cast<const float2*>(gb)[j * 8 + 1];
      v = __fdiv_rn(wh.x, lb.size) > 0.f && __fdiv_rn(wh.y, lb.size) > 0.f;
    }
    score[j] = s;
    mask |= static_cast<uint32_t>(v) << t;
  }

  // 2. Compact the valid anchors in index order as (score, index) keys:
  //    the high word ~bits(score) falls as the (positive) score rises, so
  //    ascending keys are descending scores, ties in index order.
  int n = 0;
  const int chunks = (A + kThreads - 1) / kThreads;
  for (int t = 0; t < chunks; ++t) {
    const bool v = (mask >> t) & 1u;
    const uint32_t bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) s_count[t & 1][warp] = __popc(bal);
    __syncthreads();
    int pos = n, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int cnt = s_count[t & 1][w];
      pos += w < warp ? cnt : 0;
      total += cnt;
    }
    if (v) {
      const int j = t * kThreads + tid;
      pos += __popc(bal & ((1u << lane) - 1u));
      keys[pos] = (static_cast<uint64_t>(~__float_as_uint(score[j])) << 32) |
                  static_cast<uint32_t>(j);
    }
    n += total;
  }
  __syncthreads();

  // 3. Rank: up to kRankMaxN candidates by counting smaller keys (keys are
  //    distinct: the index breaks ties), more by a bitonic sort.
  if (n <= kRankMaxN) {
    for (int p = tid; p < n; p += kThreads) {
      const uint64_t key = keys[p];
      int rank = 0;
      for (int q = 0; q < n; ++q) rank += keys[q] < key;
      idx[rank] = static_cast<int>(key & 0xffffffffu);
      score[rank] = __uint_as_float(~static_cast<uint32_t>(key >> 32));
    }
  } else {
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
    for (int q = n + tid; q < p2; q += kThreads) keys[q] = ~0ull;
    __syncthreads();
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = tid; t < (p2 >> 1); t += kThreads) {
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const uint64_t a = keys[lo], b = keys[hi];
          if ((a > b) == ((lo & size) == 0)) {
            keys[lo] = b;
            keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    for (int p = tid; p < n; p += kThreads) {
      const uint64_t key = keys[p];
      idx[p] = static_cast<int>(key & 0xffffffffu);
      score[p] = __uint_as_float(~static_cast<uint32_t>(key >> 32));
    }
  }
  __syncthreads();

  // 4. Decode the boxes of the first k candidates.
  const int m = min(n, k);
  for (int p = tid; p < m; p += kThreads) {
    const int j = idx[p];
    const float4 r = gb4[j * 4];
    const float2 an = anchors[j];
    const float cx = __fadd_rn(__fdiv_rn(r.x, lb.size), an.x);
    const float cy = __fadd_rn(__fdiv_rn(r.y, lb.size), an.y);
    const float hw = __fmul_rn(__fdiv_rn(r.z, lb.size), 0.5f);
    const float hh = __fmul_rn(__fdiv_rn(r.w, lb.size), 0.5f);
    const float4 bx = make_float4(__fsub_rn(cx, hw), __fsub_rn(cy, hh),
                                  __fadd_rn(cx, hw), __fadd_rn(cy, hh));
    c.box[p] = bx;
    c.area[p] = box_area(bx);
    c.valid[p] = 1;
    c.lead[p] = 0;
  }
  __syncthreads();

  // 5. Leaders.
  const bool use_rows = greedy_scan(c, m, thr, list, list_cap, &s_nlead);

  // 6. The slab: the first D leaders, then zero rows, letterbox removed.
  const int nl = min(s_nlead, D);
  for (int t = tid; t < D; t += kThreads) {
    const size_t o = static_cast<size_t>(blockIdx.x) * D + t;
    float4 bx = make_float4(0.f, 0.f, 0.f, 0.f);
    float s = 0.f;
    float2 kp[6];
    for (int q = 0; q < 6; ++q) kp[q] = make_float2(0.f, 0.f);
    if (t < nl) {
      const int i = list[t];
      bx = blend(c, i, m, use_rows);
      s = score[i];
      const int j = idx[i];
      const float2 an = anchors[j];
      for (int q = 0; q < 3; ++q) {
        const float4 r = gb4[j * 4 + 1 + q];
        kp[2 * q] = make_float2(__fadd_rn(__fdiv_rn(r.x, lb.size), an.x),
                                __fadd_rn(__fdiv_rn(r.y, lb.size), an.y));
        kp[2 * q + 1] =
            make_float2(__fadd_rn(__fdiv_rn(r.z, lb.size), an.x),
                        __fadd_rn(__fdiv_rn(r.w, lb.size), an.y));
      }
    }
    out_boxes[o] = make_float4(unpad_x(lb, bx.x), unpad_y(lb, bx.y),
                               unpad_x(lb, bx.z), unpad_y(lb, bx.w));
    for (int q = 0; q < 6; ++q)
      out_kp[o * 6 + q] =
          make_float2(unpad_x(lb, kp[q].x), unpad_y(lb, kp[q].y));
    out_scores[o] = s;
    out_valid[o] = t < nl ? 1 : 0;
  }
}

// Bytes of an n x ceil(n/32) table of 32-bit bit rows.
size_t row_bytes(int n) {
  return static_cast<size_t>(n) * ((n + 31) / 32) * 4;
}

// Dynamic shared memory: a region of at least `need` bytes, grown up to
// the bit rows of n candidates as far as the cap allows, then `rest`
// bytes.  Returns 0 when even `need` does not fit; sets *region_words.
size_t plan_smem(int n, size_t need, size_t rest, int* region_words) {
  if (need + rest > kSmemCap) return 0;
  size_t region = row_bytes(n);
  const size_t room = (kSmemCap - rest) & ~static_cast<size_t>(15);
  if (region > room) region = room;
  if (region < need) region = need;
  region = (region + 15) & ~static_cast<size_t>(15);
  *region_words = static_cast<int>(region / 4);
  return region + rest;
}

// Launches on `device` (made current for the call only) and returns the
// launch's cudaError_t.  Opts a kernel in to more than 48 KB of shared
// memory once per device and size.
template <typename Kernel>
int prepare(Kernel kernel, int device, size_t smem, int* opted,
            int* previous) {
  cudaError_t err = cudaGetDevice(previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (*previous != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (smem > 48 * 1024 && device < 64 &&
      opted[device] < static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[device] = static_cast<int>(smem);
  }
  return 0;
}

int finish(int device, int previous) {
  const cudaError_t err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}

int g_nms_opted[64];
int g_post_opted[64];

// Does nothing: its device time is the launch floor that chip_smoke.py
// prints beside K1's.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int fdt_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fdt_nms_core(const void* boxes, const void* scores,
                            const void* valid, void* leader, void* blended,
                            int batch, int k, float thr, int device,
                            void* stream) {
  if (batch <= 0 || k <= 0) return 0;
  int region_words = 0;
  // Region: owner[k] at least; then box, area, valid, lead.
  const size_t smem = plan_smem(k < kRowsMaxN ? k : kRowsMaxN,
                                static_cast<size_t>(k) * 4,
                                static_cast<size_t>(k) * (16 + 4 + 1 + 1),
                                &region_words);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  int previous = device;
  int rc = prepare(nms_core_kernel, device, smem, g_nms_opted, &previous);
  if (rc) return rc;
  nms_core_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(leader),
      static_cast<float4*>(blended), k, thr, region_words);
  return finish(device, previous);
}

// `out` holds the slab of the batch: boxes [B, D, 4] float, keypoints
// [B, D, 6, 2] float, scores [B, D] float, valid [B, D] bool, in that
// order.  `k` is the number of candidates kept (<= A); sx, sy are
// 1 - (pad_lo + pad_hi) per axis.
extern "C" int fdt_detection_postprocess(
    const void* raw_boxes, const void* raw_scores, const void* anchors,
    void* out, int batch, int A, int D, int k, float input_size, float pl,
    float pt, float sx, float sy, float thr, int device, void* stream) {
  if (batch <= 0 || D <= 0) return 0;
  if (A < 0 || A > 32 * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  int p2 = 1;
  while (p2 < A) p2 <<= 1;
  const int list_cap = A < D ? A : D;
  int region_words = 0;
  // Region: the sort keys (8 B each, padded to a power of two) or owner[A];
  // then box, area, score, idx, list, valid, lead.
  const size_t need = static_cast<size_t>(p2) * 8 > static_cast<size_t>(A) * 4
                          ? static_cast<size_t>(p2) * 8
                          : static_cast<size_t>(A) * 4;
  const size_t smem = plan_smem(
      A < kRowsMaxN ? A : kRowsMaxN, need,
      static_cast<size_t>(A) * (16 + 4 + 4 + 4 + 1 + 1) +
          static_cast<size_t>(list_cap) * 4,
      &region_words);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  int previous = device;
  int rc = prepare(detection_postprocess_kernel, device, smem, g_post_opted,
                   &previous);
  if (rc) return rc;
  const size_t rows = static_cast<size_t>(batch) * D;
  unsigned char* base = static_cast<unsigned char*>(out);
  Letterbox lb{input_size, pl, pt, sx, sy};
  detection_postprocess_kernel<<<batch, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(raw_boxes),
      static_cast<const float*>(raw_scores),
      static_cast<const float2*>(anchors), reinterpret_cast<float4*>(base),
      reinterpret_cast<float2*>(base + rows * 16),
      reinterpret_cast<float*>(base + rows * 64), base + rows * 68, A, D,
      k < A ? k : A, list_cap, lb, thr, region_words);
  return finish(device, previous);
}
