// Fused region-group gather + sentinel attention + shift-gate evidence.
//
// Replaces the TPU kernel vsrcic_tpu/ops/fused_attention.py
// (make_fused_group_attention, body :54-130, pallas_call :163).
//
// What bounds it on the H100: device-memory bytes. Per decode row it needs
// one region group (M x D) and its projection (M x A) from tables that are
// not expanded per beam, plus the row's ha / fc_sentinel vectors, and does
// ~3 flops per byte -- far below the card's compute-to-bandwidth ratio. The
// bound counts each distinct group once and each row's vectors once. What
// holds it back from that bound is latency: a row's work is a chain of
// dependent phases (copy, row sums and det_w, cluster barrier, softmax,
// weighted sum; one row alone on an SM takes most of a 100-row call's
// time), a group staged in shared memory takes 50-60 KB of a block's, so
// few rows are in flight on an SM, and det_w's tanh takes two MUFU
// operations (PERF.md §6).
//
// Design (the launch plan -- cluster size C, rows per run, rows per batch
// P, slice and box widths, shared bytes -- comes from
// ops/fused_attention.py::fused_launch_plan):
//   * A thread-block cluster of C CTAs takes a run of consecutive rows. CTA
//     `rank` owns the slice [rank * d_slice, +d_slice) of D and the slice
//     [rank * a_slice, +a_slice) of A, so one group is split C ways: three
//     CTAs fit an SM with bf16 tables, and the f32 tables at full width fit
//     shared memory at all.
//   * The run's rows are cut into segments of consecutive rows on the same
//     (item, ctrl) group: beams of one item are consecutive rows, so a group
//     is read from device memory once per segment, not once per row. A run
//     owns the segments that start in it, so a run boundary does not cut a
//     segment short (see step 1). An out-of-range row gets NaN outputs, is
//     never read, and ends its segment.
//   * Each segment's slices are copied into shared memory before any
//     arithmetic: with 16-byte rows, by TMA boxes of (M, <= 256 columns)
//     from 2D tensor maps over the tables, completing on an mbarrier with a
//     transaction count (the first segment's as soon as the run's first
//     row is read); otherwise (ragged D or A) by plain loads. Row sums
//     (the mask), det_w, the softmax and the weighted sum all read shared
//     memory: there is no second pass over the tables. One group a CTA at a
//     time: the other CTAs on the SM hide a copy.
//   * A segment's rows go in batches of up to P: one barrier round per batch,
//     not per row. A batch's ha slices and sentinel scalars come one batch
//     ahead by `cp.async`.
//   * Each CTA pushes its partial row sums (once a segment) and partial
//     det_w (per row and region) into every CTA's shared memory through
//     distributed shared memory; after one cluster barrier each CTA adds the
//     C parts in rank order, so all CTAs form the same mask, softmax and
//     gate evidence bit for bit (one warp per row). Rank 0 writes
//     gate_evidence; each CTA writes its own D-slice of out.
// tanh is 1 - 2 / (exp(2|x|) + 1) on the hardware exp and reciprocal
// (absolute error ~1e-7); all arithmetic is f32. Any rows, M, D and A;
// item / ctrl are only read. Every access is tested against its bound in
// the checked build (check.cuh); the default build's code is the plain
// access.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "check.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMinBlocks = 3;      // blocks per SM the registers must allow
constexpr int kIlp = 4;            // (row, region) sums a warp runs at once
constexpr int kMaxBatch = 8;       // rows per barrier round

struct Params {
  const int* item;
  const int* ctrl;
  const float* ha;
  const float* sent_w;
  const float* sent_mask;
  const float* fc_sent;
  const float* att_a;
  const void* det;
  const void* proj;
  int rows, B, L, M, D, A;
  int cluster, run, batch, d_slice, a_slice;
  int box_d, box_a;  // columns per TMA box (a slice is whole boxes)
  CUtensorMap tm_det, tm_proj;  // (B L M, D) and (B L M, A), box (M, box)
  float* out;
  float* gsum;
};

__host__ __device__ inline size_t up16(size_t x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int up4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ inline size_t up128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Byte offsets into one CTA's dynamic shared memory. The same formula is
// ops/fused_attention.py::_smem_bytes; the entry point refuses a plan whose
// shared bytes differ from `total`.
struct Layout {
  size_t box_d;   // bytes of one det box (M x bd elements), 128-aligned
  size_t box_a;   // bytes of one proj box (M x ba elements), 128-aligned
  size_t det;     // the group's det boxes end and its proj boxes start here
  size_t ha;      // P ha slices (floats), one batch
  size_t sc;      // 2 x P x (sent_w, sent_mask)
  size_t atta;    // the att_a slice
  size_t xbuf;    // 2 x C x P x M partial det_w, by batch parity and rank
  size_t rs;      // 2 x C x M partial row sums, by segment parity and rank
  size_t att;     // P x M det_w, then the normalised weights
  size_t mask;    // P x M
  size_t asent;   // P normalised sentinel weights
  size_t ints;    // window rows' keys, segment keys (int64); valid rows,
                  // segments' first valid rows, scan scratch (int32)
  size_t mbar;    // the mbarrier
  size_t total;
};

__host__ __device__ inline Layout make_layout(int M, int dw, int aw, int bd,
                                              int ba, int tb, int run, int P,
                                              int C) {
  Layout l;
  l.box_d = up128((size_t)M * bd * tb);
  l.box_a = up128((size_t)M * ba * tb);
  l.det = (size_t)(dw / bd) * l.box_d;
  l.ha = l.det + (size_t)(aw / ba) * l.box_a;
  l.sc = l.ha + sizeof(float) * (size_t)P * up4(aw);
  l.atta = l.sc + sizeof(float) * 4 * (size_t)P;
  l.xbuf = up16(l.atta + sizeof(float) * up4(aw));
  l.rs = l.xbuf + sizeof(float) * 2 * (size_t)C * P * M;
  l.att = l.rs + sizeof(float) * 2 * (size_t)C * M;
  l.mask = l.att + sizeof(float) * (size_t)P * M;
  l.asent = l.mask + sizeof(float) * (size_t)P * M;
  l.ints = up16(l.asent + sizeof(float) * (size_t)P);
  const size_t rw = (size_t)run + kMaxBatch + 1;  // window rows
  l.mbar = up16(l.ints + 24 * rw + 4 * (2 * kWarps + 2));
  l.total = l.mbar + 16;
  return l;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive table elements (16 bytes when VEC * sizeof(T) == 16)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f32(pk.v[j]);
}

// tanh(x) = sign(x) (1 - 2 / (exp(2|x|) + 1)) in f32 on the hardware exp
// and reciprocal, branch free: absolute error below 3e-7. Against
// libdevice's tanhf it takes 3.5-4% off the beam's and the eval CLI's
// kernel time (rows x M x A calls; PERF.md §6)
__device__ __forceinline__ float fast_tanh(float x) {
  const float e = __expf(2.f * fabsf(x));
  return copysignf(1.f - __fdividef(2.f, e + 1.f), x);
}

// N consecutive f32 (shared or device memory), 16-byte loads when
// N % 4 == 0 (p then 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      out[j] = v.x;
      out[j + 1] = v.y;
      out[j + 2] = v.z;
      out[j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = p[j];
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The memory check's bounds (check.cuh; tools/memcheck.py BOUNDS): the
// global extents the arguments imply, the layout's regions, the window's
// arrays, the mbarrier, the cluster's ranks and the tensor maps' extents
enum Bound {
  kBItem = 1,       // item, ctrl: rows
  kBHa = 2,         // ha: rows x A
  kBSent = 3,       // sent_w, sent_mask: rows
  kBFc = 4,         // fc_sentinel: rows x D
  kBAttA = 5,       // att_a: A
  kBDet = 6,        // det: B L M x D (element copies)
  kBProj = 7,       // proj: B L M x A (element copies)
  kBOut = 8,        // out: rows x D
  kBGsum = 9,       // gate evidence: rows
  kBGroup = 10,     // a group's table rows, B L M (its TMA boxes)
  kBLayout = 11,    // the layout's total: the dynamic shared bytes
  kBSdet = 12,      // the layout's regions, in their elements
  kBSproj = 13,
  kBHaS = 14,
  kBSc = 15,
  kBAttaS = 16,
  kBXbuf = 17,
  kBRs = 18,
  kBAtt = 19,
  kBMask = 20,
  kBAsent = 21,
  kBKeys = 22,      // the window's arrays: rw keys, segment keys, valid
  kBSegKey = 23,    // rows and segments' first rows; the scan scratch
  kBVrow = 24,
  kBSegFirst = 25,
  kBScan = 26,
  kBInts = 27,      // the window's arrays within their region
  kBMbar = 28,      // the mbarrier within the layout
  kBRank = 29,      // a cluster rank written through DSMEM
  kBMapDet = 30,    // host: the tensor maps' extents
  kBMapProj = 31,
};

#define FA_IN(kind, bound_id, lo, len, bound) \
  VSRCIC_IN(kFusedAttention, kind, bound_id, lo, len, bound)
#define FA_LD(kind, bound_id, lo, len, bound, expr, zero) \
  VSRCIC_LD(FA_IN(kind, bound_id, lo, len, bound), expr, zero)
#define FA_DO(kind, bound_id, lo, len, bound, ...) \
  VSRCIC_DO(FA_IN(kind, bound_id, lo, len, bound), __VA_ARGS__)
#define FA_AND(kind, bound_id, lo, len, bound) \
  VSRCIC_AND(FA_IN(kind, bound_id, lo, len, bound))
// each region's elements (the layout's offsets)
#define N_SDET (lay.det / sizeof(T))
#define N_SPROJ ((lay.ha - lay.det) / sizeof(T))
#define N_HA ((lay.sc - lay.ha) / 4)
#define N_SC ((lay.atta - lay.sc) / 4)
#define N_ATTA ((lay.xbuf - lay.atta) / 4)
#define N_XBUF ((lay.rs - lay.xbuf) / 4)
#define N_RS ((lay.att - lay.rs) / 4)
#define N_ATT ((lay.mask - lay.att) / 4)
#define N_MASK ((lay.asent - lay.mask) / 4)
#define N_ASENT ((lay.ints - lay.asent) / 4)
#define N_SCAN (2 * kWarps + 2)
#define N_TABLE ((long long)p.B * p.L * M)
// the window's arrays, read through the check
#define KEY(w) FA_LD(kShared, kBKeys, w, 1, rw, keys_s[w], 0LL)
#define SEGKEY(k) FA_LD(kShared, kBSegKey, k, 1, rw, segkey_s[k], 0LL)
#define VROW(j) FA_LD(kShared, kBVrow, j, 1, rw, vrow_s[j], 0)
#define SCAN(i) FA_LD(kShared, kBScan, i, 1, N_SCAN, scan_s[i], 0)

// BULK: D and A are multiples of 16 / sizeof(T), the slices start and end
// on 16 bytes and every pointer is 16-byte aligned (the wrapper checks);
// otherwise element-wise copies. Every access goes through the check
// (FA_IN, FA_LD, FA_DO, FA_AND: check.cuh; the plain access in the
// default build).
template <typename T, bool BULK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_attention_kernel(const __grid_constant__ Params p) {
  constexpr int VA = BULK ? 16 / (int)sizeof(T) : 1;  // row sums, det_w
  constexpr int VD = BULK ? 4 : 1;                    // the weighted sum
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int C = p.cluster, P = p.batch;
  const int rank = (int)cluster.block_rank();
  const int r0 = (int)(blockIdx.x / C) * p.run;
  const int M = p.M, D = p.D, A = p.A;
  const int d0 = min(rank * p.d_slice, D);
  const int dw = min(d0 + p.d_slice, D) - d0;
  const int a0 = min(rank * p.a_slice, A);
  const int aw = min(a0 + p.a_slice, A) - a0;
  const Layout lay = make_layout(M, p.d_slice, p.a_slice, p.box_d, p.box_a,
                                 sizeof(T), p.run, P, C);
  const int ha_pitch = up4(p.a_slice);
  // a slice is stored box by box: element (m, d) of box j = d / bd at
  // (j * M + m) * bd + d % bd (one box per slice without bulk copies)
  const int bd = p.box_d, ba = p.box_a;
  const int nbd = (dw + bd - 1) / bd, nba = (aw + ba - 1) / ba;
  const size_t pd = lay.box_d / sizeof(T), pa = lay.box_a / sizeof(T);

  T* sdet = reinterpret_cast<T*>(smem);
  T* sproj = reinterpret_cast<T*>(smem + lay.det);
  float* ha_s = reinterpret_cast<float*>(smem + lay.ha);
  float* sc_s = reinterpret_cast<float*>(smem + lay.sc);
  float* atta_s = reinterpret_cast<float*>(smem + lay.atta);
  float* xbuf = reinterpret_cast<float*>(smem + lay.xbuf);
  float* rsx = reinterpret_cast<float*>(smem + lay.rs);
  float* att_s = reinterpret_cast<float*>(smem + lay.att);
  float* mask_s = reinterpret_cast<float*>(smem + lay.mask);
  float* asent_s = reinterpret_cast<float*>(smem + lay.asent);
  const int rw = p.run + kMaxBatch + 1;  // window rows
  long long* keys_s = reinterpret_cast<long long*>(smem + lay.ints);
  long long* segkey_s = keys_s + rw;
  int* vrow_s = reinterpret_cast<int*>(segkey_s + rw);
  int* segfirst_s = vrow_s + rw;
  int* scan_s = segfirst_s + rw;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + lay.mbar);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#if VSRCIC_CHECKED
  // the layout within the dynamic shared bytes, the window's arrays within
  // their region
  if (tid == 0) {
    (void)FA_IN(kShared, kBLayout, 0, lay.total, vsrcic_dynamic_smem());
    (void)FA_IN(kShared, kBInts, 0, 24LL * rw + 4 * N_SCAN,
                lay.mbar - lay.ints);
  }
#endif

  // no CTA writes into another's shared memory before all have started
  // (the matching wait is after step 1)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid == 0) {
    FA_DO(kMbarrier, kBMbar, lay.mbar, 8, lay.total, mbar_init(bar, 1));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int a = tid; a < aw; a += kThreads)
    FA_DO(kShared, kBAttaS, a, 1, N_ATTA,
          atta_s[a] = FA_LD(kGlobal, kBAttA, a0 + a, 1, A, p.att_a[a0 + a],
                            0.f));

  const T* det = static_cast<const T*>(p.det);
  const T* proj = static_cast<const T*>(p.proj);
  // the TMA boxes of group `key` (table rows key * M, +M), issued by one
  // thread: it arrives on the mbarrier with their byte count (the boxes
  // past D, in the last slice, are zero-filled and counted), then issues
  // them (a box the check drops completes its bytes itself)
  auto issue_boxes = [&](long long key) {
    const int y = (int)(key * M);
#if VSRCIC_CHECKED
    (void)FA_IN(kTensorMap, kBGroup, key * M, M, N_TABLE);
    if (!FA_IN(kMbarrier, kBMbar, lay.mbar, 8, lay.total)) return;
#endif
    mbar_expect_tx(bar, (uint32_t)(M * sizeof(T) * (nbd * bd + nba * ba)));
    for (int j = 0; j < nbd; ++j) {
#if VSRCIC_CHECKED
      if (!FA_IN(kShared, kBSdet, j * pd, M * bd, N_SDET)) {
        mbar_complete_tx(bar, (uint32_t)(M * bd * sizeof(T)));
        continue;
      }
#endif
      tma_box(sdet + j * pd, &p.tm_det, d0 + j * bd, y, bar);
    }
    for (int j = 0; j < nba; ++j) {
#if VSRCIC_CHECKED
      if (!FA_IN(kShared, kBSproj, j * pa, M * ba, N_SPROJ)) {
        mbar_complete_tx(bar, (uint32_t)(M * ba * sizeof(T)));
        continue;
      }
#endif
      tma_box(sproj + j * pa, &p.tm_proj, a0 + j * ba, y, bar);
    }
  };
  // the slices of group `key` into shared memory (called by every thread
  // once the previous group's readers are done)
  auto issue = [&](long long key) {
    if constexpr (BULK) {
      if (tid == 0) issue_boxes(key);
    } else {
      const long long y = key * M;
      // one box per slice: element (m, d) at m * bd + d
      for (int i = tid; i < M * dw; i += kThreads) {
        const int m = i / dw, d = i - m * dw;
        FA_DO(kShared, kBSdet, m * bd + d, 1, N_SDET,
              sdet[m * bd + d] = FA_LD(
                  kGlobal, kBDet, (y + m) * D + d0 + d, 1, N_TABLE * D,
                  det[((size_t)y + m) * D + d0 + d], T()));
      }
      for (int i = tid; i < M * aw; i += kThreads) {
        const int m = i / aw, a = i - m * aw;
        FA_DO(kShared, kBSproj, m * ba + a, 1, N_SPROJ,
              sproj[m * ba + a] = FA_LD(
                  kGlobal, kBProj, (y + m) * A + a0 + a, 1, N_TABLE * A,
                  proj[((size_t)y + m) * A + a0 + a], T()));
      }
      __syncthreads();
    }
  };

  // 1. the run's rows. A run owns the segments that start in it: it skips
  //    its first rows while they continue the previous run's last segment,
  //    and extends its own last segment past its end, each by at most
  //    E = kMaxBatch rows (both runs apply the one rule), so a segment that
  //    a run boundary cuts is still copied once. Window row w is row
  //    r0 - 1 + w, w < run + E + 1; its key is item * L + ctrl, or -1 out of
  //    range (never a group). Every CTA of the cluster reads the same item /
  //    ctrl, so all build the same lists.
  const int E = kMaxBatch;
  const int wn = min(p.run + E + 1, p.rows - r0 + 1);
  long long key = -1;
  if (tid < wn && r0 - 1 + tid >= 0) {
    const int it = FA_LD(kGlobal, kBItem, r0 - 1 + tid, 1, p.rows,
                         p.item[r0 - 1 + tid], 0);
    const int ct = FA_LD(kGlobal, kBItem, r0 - 1 + tid, 1, p.rows,
                         p.ctrl[r0 - 1 + tid], 0);
    if (it >= 0 && it < p.B && ct >= 0 && ct < p.L)
      key = (long long)it * p.L + ct;
  }
  if (tid < wn) FA_DO(kShared, kBKeys, tid, 1, rw, keys_s[tid] = key);
  // when row r0 starts a segment (its key is valid and not row r0 - 1's),
  // that segment is the run's first: its group goes in flight at once
  const long long next = __shfl_down_sync(0xffffffffu, key, 1);
  if (BULK && tid == 0 && next >= 0 && next != key) issue_boxes(next);
  __syncthreads();
  if (tid == 0) {
    int skip = 0, ext = 0;
    while (skip < E && 1 + skip < wn && KEY(1 + skip) >= 0 &&
           KEY(1 + skip) == KEY(skip))
      ++skip;
    const int e0 = 1 + p.run;
    while (ext < E && e0 + ext < wn && KEY(e0 + ext) >= 0 &&
           KEY(e0 + ext) == KEY(e0 + ext - 1))
      ++ext;
    FA_DO(kShared, kBScan, 2 * kWarps, 1, N_SCAN,
          scan_s[2 * kWarps] = 1 + skip);
    FA_DO(kShared, kBScan, 2 * kWarps + 1, 1, N_SCAN,
          scan_s[2 * kWarps + 1] = min(wn, e0 + ext));
  }
  __syncthreads();
  const int lo = SCAN(2 * kWarps), hi = SCAN(2 * kWarps + 1);
  // a segment starts at an owned valid row whose predecessor is not owned,
  // invalid or on another group
  const bool valid = tid >= lo && tid < hi && key >= 0;
  const bool start = valid && (tid == lo || KEY(tid - 1) != key);
  const unsigned bv = __ballot_sync(0xffffffffu, valid);
  const unsigned bs = __ballot_sync(0xffffffffu, start);
  if (lane == 0) {
    FA_DO(kShared, kBScan, warp, 1, N_SCAN, scan_s[warp] = __popc(bv));
    FA_DO(kShared, kBScan, kWarps + warp, 1, N_SCAN,
          scan_s[kWarps + warp] = __popc(bs));
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  int pv = __popc(bv & below), ps = __popc(bs & below), nv = 0, nseg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      pv += SCAN(w);
      ps += SCAN(kWarps + w);
    }
    nv += SCAN(w);
    nseg += SCAN(kWarps + w);
  }
  if (valid)
    FA_DO(kShared, kBVrow, pv, 1, rw, vrow_s[pv] = tid - 1);  // r0 + it
  if (start) {
    FA_DO(kShared, kBSegKey, ps, 1, rw, segkey_s[ps] = key);
    FA_DO(kShared, kBSegFirst, ps, 1, rw, segfirst_s[ps] = pv);
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // out-of-range rows: NaN outputs, their group never read
  for (int w = lo; w < hi; ++w) {
    if (KEY(w) >= 0) continue;
    float* o = p.out + (size_t)(r0 - 1 + w) * D + d0;
    for (int d = tid; d < dw; d += kThreads)
      FA_DO(kGlobal, kBOut, (long long)(r0 - 1 + w) * D + d0 + d, 1,
            (long long)p.rows * D, o[d] = NAN);
    if (rank == 0 && tid == 0)
      FA_DO(kGlobal, kBGsum, r0 - 1 + w, 1, p.rows,
            p.gsum[r0 - 1 + w] = NAN);
  }

  // first valid row of segment k (nv past the last)
  auto seg_row = [&](int k) {
    return k < nseg ? FA_LD(kShared, kBSegFirst, k, 1, rw, segfirst_s[k], 0)
                    : nv;
  };

  // the ha slices and sentinel scalars of valid rows [j0, j0 + n), the
  // scalars into batch slot `slot`
  auto prefetch = [&](int j0, int n, int slot) {
    for (int r = 0; r < n; ++r) {
      const size_t row = (size_t)(r0 + VROW(j0 + r));
      const float* ha = p.ha + row * A + a0;
      float* h = ha_s + r * ha_pitch;
      if constexpr (BULK) {
        for (int i = tid * 4; i < aw; i += kThreads * 4)
          FA_DO(kGlobal, kBHa, row * A + a0 + i, 4, (long long)p.rows * A,
                FA_DO(kShared, kBHaS, r * ha_pitch + i, 4, N_HA,
                      cp_async16(h + i, ha + i)));
      } else {
        for (int i = tid; i < aw; i += kThreads)
          FA_DO(kGlobal, kBHa, row * A + a0 + i, 1, (long long)p.rows * A,
                FA_DO(kShared, kBHaS, r * ha_pitch + i, 1, N_HA,
                      cp_async4(h + i, ha + i)));
      }
    }
    if (tid < 2 * n) {
      const size_t row = (size_t)(r0 + VROW(j0 + (tid >> 1)));
      FA_DO(kGlobal, kBSent, row, 1, p.rows,
            FA_DO(kShared, kBSc, (slot * P) * 2 + tid, 1, N_SC,
                  cp_async4(sc_s + (slot * P) * 2 + tid,
                            ((tid & 1) ? p.sent_mask : p.sent_w) + row)));
    }
    cp_async_commit();
  };

  // 2. the first segment's group, unless it went ahead, and the first
  //    batch's vectors
  if (nseg > 0) {
    if (!(BULK && lo == 1 && KEY(1) >= 0)) issue(SEGKEY(0));
    prefetch(0, min(P, seg_row(1)), 0);
  }

  int bi = 0;  // batches done
  for (int k = 0; k < nseg; ++k) {
    if (k > 0) {
      // the previous segment's readers (step 5) are done with its group
      __syncthreads();
      issue(SEGKEY(k));
    }
    const int j_end = seg_row(k + 1);
    // this segment's partial row sums: [rank][region]
    float* rsb = rsx + (size_t)(k & 1) * C * M;
    for (int j0 = seg_row(k); j0 < j_end; j0 += P, ++bi) {
      const int n = min(P, j_end - j0);
      const float* sc = sc_s + (bi & 1) * P * 2;
      // this batch's partial det_w: [rank][row * M + region]
      float* xb = xbuf + (size_t)(bi & 1) * C * P * M;
      cp_async_wait_all();
      __syncthreads();

      // the segment's first batch: its group, then this CTA's partial row
      // sums of it (one warp per region), pushed into every CTA of the
      // cluster (its own included) before the barrier. A warp runs kIlp
      // regions here (and kIlp (row, region) pairs in step 3) at once; one
      // past the end (the test is warp-uniform) is skipped, not repeated
      if (j0 == seg_row(k)) {
        if (BULK)
          FA_DO(kMbarrier, kBMbar, lay.mbar, 8, lay.total,
                mbar_wait(bar, (uint32_t)(k & 1)));
        for (int i0 = warp; i0 < M; i0 += kIlp * kWarps) {
          const T* dm[kIlp];
          float rs[kIlp];
#pragma unroll
          for (int u = 0; u < kIlp; ++u) {
            dm[u] = sdet + (size_t)min(i0 + u * kWarps, M - 1) * bd;
            rs[u] = 0.f;
          }
          for (int j = 0; j * bd < dw; ++j) {
            const size_t off = j * pd;
            for (int d = lane * VA; d < min(bd, dw - j * bd);
                 d += 32 * VA) {
#pragma unroll
              for (int u = 0; u < kIlp; ++u) {
                if (i0 + u * kWarps >= M) continue;
                float x[VA];
                VSRCIC_ZERO(x, VA);
                FA_DO(kShared, kBSdet, dm[u] - sdet + off + d, VA, N_SDET,
                      load_vec<T, VA>(dm[u] + off + d, x));
#pragma unroll
                for (int q = 0; q < VA; ++q) rs[u] += x[q];
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kIlp; ++u) rs[u] = warp_sum(rs[u]);
          if (lane < C FA_AND(kDsmem, kBRank, lane, 1, cluster_size())) {
            float* dst = cluster.map_shared_rank(rsb, lane) + rank * M;
#pragma unroll
            for (int u = 0; u < kIlp; ++u)
              if (i0 + u * kWarps < M FA_AND(kDsmem, kBRs,
                                             rsb - rsx + rank * M + i0 +
                                                 u * kWarps,
                                             1, N_RS))
                dst[i0 + u * kWarps] = rs[u];
          }
        }
      }

      // 3. partial det_w of every (row, region) of the batch
      for (int i0 = warp; i0 < n * M; i0 += kIlp * kWarps) {
        const T* pm[kIlp];
        const float* h[kIlp];
        float w[kIlp];
#pragma unroll
        for (int u = 0; u < kIlp; ++u) {
          const int i = min(i0 + u * kWarps, n * M - 1);
          pm[u] = sproj + (size_t)(i % M) * ba;
          h[u] = ha_s + (i / M) * ha_pitch;
          w[u] = 0.f;
        }
        for (int j = 0; j * ba < aw; ++j) {
          const size_t off = j * pa;
          for (int a = lane * VA; a < min(ba, aw - j * ba); a += 32 * VA) {
            const int ag = j * ba + a;
            float at[VA];
            VSRCIC_ZERO(at, VA);
            FA_DO(kShared, kBAttaS, ag, VA, N_ATTA,
                  load_f32<VA>(atta_s + ag, at));
#pragma unroll
            for (int u = 0; u < kIlp; ++u) {
              if (i0 + u * kWarps >= n * M) continue;
              float x[VA], hv[VA];
              VSRCIC_ZERO(x, VA);
              VSRCIC_ZERO(hv, VA);
              FA_DO(kShared, kBSproj, pm[u] - sproj + off + a, VA, N_SPROJ,
                    load_vec<T, VA>(pm[u] + off + a, x));
              FA_DO(kShared, kBHaS, h[u] - ha_s + ag, VA, N_HA,
                    load_f32<VA>(h[u] + ag, hv));
#pragma unroll
              for (int q = 0; q < VA; ++q)
                w[u] += fast_tanh(x[q] + hv[q]) * at[q];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kIlp; ++u) w[u] = warp_sum(w[u]);
        // pushed into every CTA (its own included) before the barrier, so
        // that after it each CTA reads only its own memory
        if (lane < C FA_AND(kDsmem, kBRank, lane, 1, cluster_size())) {
          float* dst = cluster.map_shared_rank(xb, lane) + rank * P * M;
#pragma unroll
          for (int u = 0; u < kIlp; ++u)
            if (i0 + u * kWarps < n * M FA_AND(kDsmem, kBXbuf,
                                               xb - xbuf + rank * P * M +
                                                   i0 + u * kWarps,
                                               1, N_XBUF))
              dst[i0 + u * kWarps] = w[u];
        }
      }
      cluster.sync();

      // the next batch's ha slices replace this batch's, whose readers
      // (step 3) are past the cluster barrier; its sentinel scalars go into
      // the other slot (step 4 reads this batch's next)
      {
        const int jn = j0 + n;
        if (jn < nv) {
          const int nn = jn < j_end ? min(P, j_end - jn)
                                    : min(P, seg_row(k + 2) - jn);
          prefetch(jn, nn, (bi + 1) & 1);
        }
      }

      // 4. one warp per row: the full sums in rank order, then the masked
      //    softmax over [sentinel ; regions], renormalised
      for (int r = warp; r < n; r += kWarps) {
        const float sw = FA_LD(kShared, kBSc, sc - sc_s + 2 * r, 1, N_SC,
                               sc[2 * r], 0.f),
                    smk = FA_LD(kShared, kBSc, sc - sc_s + 2 * r + 1, 1,
                                N_SC, sc[2 * r + 1], 0.f);
        float* att = att_s + r * M;
        float* mask = mask_s + r * M;
        float mx = -INFINITY;
        for (int m = lane; m < M; m += 32) {
          float rs = 0.f, w = 0.f;
          for (int c = 0; c < C; ++c) {
            rs += FA_LD(kShared, kBRs, rsb - rsx + c * M + m, 1, N_RS,
                        rsb[c * M + m], 0.f);
            w += FA_LD(kShared, kBXbuf, xb - xbuf + c * P * M + r * M + m,
                       1, N_XBUF, xb[c * P * M + r * M + m], 0.f);
          }
          FA_DO(kShared, kBAtt, r * M + m, 1, N_ATT, att[m] = w);
          FA_DO(kShared, kBMask, r * M + m, 1, N_MASK,
                mask[m] = (rs != 0.f) ? 1.f : 0.f);
          mx = fmaxf(mx, w);
        }
        mx = fmaxf(warp_max(mx), sw);
        float den = 0.f, ev = 0.f;
        for (int m = lane; m < M; m += 32) {
          const float w = FA_LD(kShared, kBAtt, r * M + m, 1, N_ATT, att[m],
                                0.f);
          const float e = expf(w - mx) * FA_LD(kShared, kBMask, r * M + m, 1,
                                               N_MASK, mask[m], 0.f);
          ev += FA_LD(kShared, kBMask, r * M + m, 1, N_MASK, mask[m], 0.f) *
                w;
          FA_DO(kShared, kBAtt, r * M + m, 1, N_ATT, att[m] = e);
          den += e;
        }
        const float e_sent = expf(sw - mx) * smk;
        den = warp_sum(den) + e_sent;
        ev = warp_sum(ev);
        for (int m = lane; m < M; m += 32)
          FA_DO(kShared, kBAtt, r * M + m, 1, N_ATT, att[m] = att[m] / den);
        if (lane == 0) {
          FA_DO(kShared, kBAsent, r, 1, N_ASENT, asent_s[r] = e_sent / den);
          if (rank == 0)
            FA_DO(kGlobal, kBGsum, r0 + VROW(j0 + r), 1, p.rows,
                  p.gsum[r0 + VROW(j0 + r)] = ev);
        }
      }
      __syncthreads();

      // 5. out[d0 + d] = sum_m att_m * det[m][d] + att_sent * fc_sentinel[d]
      const int units = (dw + VD - 1) / VD;
      for (int u = tid; u < n * units; u += kThreads) {
        const int r = u / units, d = (u - r * units) * VD;
        const int jb = d / bd;
        const size_t row = (size_t)(r0 + VROW(j0 + r));
        float fc[VD];  // loaded before the sum, which hides its latency
        VSRCIC_ZERO(fc, VD);
        FA_DO(kGlobal, kBFc, row * D + d0 + d, VD, (long long)p.rows * D,
              load_f32<VD>(p.fc_sent + row * D + d0 + d, fc));
        const T* sd = sdet + jb * pd + (d - jb * bd);
        const float* att = att_s + r * M;
        float acc[VD];
#pragma unroll
        for (int q = 0; q < VD; ++q) acc[q] = 0.f;
#pragma unroll 4
        for (int m = 0; m < M; ++m) {
          float x[VD];
          VSRCIC_ZERO(x, VD);
          FA_DO(kShared, kBSdet, sd - sdet + (size_t)m * bd, VD, N_SDET,
                load_vec<T, VD>(sd + (size_t)m * bd, x));
          const float am = FA_LD(kShared, kBAtt, r * M + m, 1, N_ATT, att[m],
                                 0.f);
#pragma unroll
          for (int q = 0; q < VD; ++q) acc[q] += am * x[q];
        }
        const float a_sent = FA_LD(kShared, kBAsent, r, 1, N_ASENT,
                                   asent_s[r], 0.f);
        float* o = p.out + row * D + d0 + d;
        if constexpr (BULK) {
          FA_DO(kGlobal, kBOut, row * D + d0 + d, VD, (long long)p.rows * D,
                *reinterpret_cast<float4*>(o) = make_float4(
                    acc[0] + a_sent * fc[0], acc[1] + a_sent * fc[1],
                    acc[2] + a_sent * fc[2], acc[3] + a_sent * fc[3]));
        } else {
          FA_DO(kGlobal, kBOut, row * D + d0 + d, VD, (long long)p.rows * D,
                o[0] = acc[0] + a_sent * fc[0]);
        }
      }
    }
  }
  // no copy is in flight (the last batch prefetches nothing) and no CTA
  // touches another's shared memory after the last cluster barrier: each
  // may leave
}

#undef FA_IN
#undef FA_LD
#undef FA_DO
#undef FA_AND
#undef KEY
#undef SEGKEY
#undef VROW
#undef SCAN
#undef N_SDET
#undef N_SPROJ
#undef N_HA
#undef N_SC
#undef N_ATTA
#undef N_XBUF
#undef N_RS
#undef N_ATT
#undef N_MASK
#undef N_ASENT
#undef N_SCAN
#undef N_TABLE

int g_smem_set[2][2] = {{0, 0}, {0, 0}};

template <typename T, bool BULK>
cudaError_t launch(const Params& p, int smem, cudaStream_t stream) {
  auto kern = fused_attention_kernel<T, BULK>;
  int& set = g_smem_set[sizeof(T) == 2][BULK];
  if (smem > set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    set = smem;
  }
  const int runs = (p.rows + p.run - 1) / p.run;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(runs * p.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// The plan's fields (cluster, rows per run, rows per batch, slice and box
// widths, shared bytes, bulk) as
// ops/fused_attention.py::fused_launch_plan gives them; a plan that does
// not tile D and A, or whose shared bytes are not this source's layout, is
// refused with cudaErrorInvalidValue.
extern "C" int vsrcic_fused_attention(
    const void* item, const void* ctrl, const void* ha, const void* sent_w,
    const void* sent_mask, const void* fc_sent, const void* att_a,
    const void* det, const void* proj, int table_bf16, int rows, int B,
    int L, int M, int D, int A, int cluster, int run, int batch,
    int d_slice, int a_slice, int box_d, int box_a, int smem, int bulk,
    void* out, void* gsum, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  const int tb = table_bf16 ? 2 : 4;
  if (rows < 1 || M < 1 || D < 1 || A < 1 || cluster < 1 ||
      cluster > kMaxCluster || run < 1 || run + kMaxBatch + 1 > kThreads ||
      batch < 1 ||
      batch > kMaxBatch || d_slice < 1 || a_slice < 1 ||
      (long long)cluster * d_slice < D || (long long)cluster * a_slice < A ||
      box_d < 1 || box_a < 1 || d_slice % box_d || a_slice % box_a ||
      (bulk && ((box_d * tb) % 16 || (box_a * tb) % 16 || box_d > 256 ||
                box_a > 256 || M > 256 || (D * tb) % 16 || (A * tb) % 16)) ||
      (!bulk && (box_d != d_slice || box_a != a_slice)) ||
      make_layout(M, d_slice, a_slice, box_d, box_a, tb, run, batch, cluster)
              .total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.item = static_cast<const int*>(item);
  p.ctrl = static_cast<const int*>(ctrl);
  p.ha = static_cast<const float*>(ha);
  p.sent_w = static_cast<const float*>(sent_w);
  p.sent_mask = static_cast<const float*>(sent_mask);
  p.fc_sent = static_cast<const float*>(fc_sent);
  p.att_a = static_cast<const float*>(att_a);
  p.det = det;
  p.proj = proj;
  p.rows = rows;
  p.B = B;
  p.L = L;
  p.M = M;
  p.D = D;
  p.A = A;
  p.cluster = cluster;
  p.run = run;
  p.batch = batch;
  p.d_slice = d_slice;
  p.a_slice = a_slice;
  p.box_d = box_d;
  p.box_a = box_a;
  const long long table_rows = (long long)B * L * M;
  if (bulk && (!encode_2d(&p.tm_det, det, tb, table_rows, D, M, box_d,
                          kFusedAttention, kBMapDet, table_rows * D * tb) ||
               !encode_2d(&p.tm_proj, proj, tb, table_rows, A, M, box_a,
                          kFusedAttention, kBMapProj, table_rows * A * tb)))
    return (int)cudaErrorInvalidValue;
  p.out = static_cast<float*>(out);
  p.gsum = static_cast<float*>(gsum);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (table_bf16)
    e = bulk ? launch<__nv_bfloat16, true>(p, smem, s)
             : launch<__nv_bfloat16, false>(p, smem, s);
  else
    e = bulk ? launch<float, true>(p, smem, s)
             : launch<float, false>(p, smem, s);
  return (int)e;
}

VSRCIC_CHECK_RECORDS(fused)
