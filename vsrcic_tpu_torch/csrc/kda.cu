// Kimi Delta Attention's recurrence (the KDA layers of Kimi-Linear-48B-A3B):
// per sequence s, head h and position t, over a state S of kD x kD (key by
// value) in f32,
//
//   S <- (I - beta k k^T) Diag(alpha) S + beta k v^T,   o = S^T q,
//
// alpha = exp(g), the decay per key channel. A position that is not valid
// (padding) neither decays nor updates the state, and outputs 0.
//
// Replaces no TPU kernel: the JAX package has no linear-attention layer.
// Added for the Kimi-Linear caption decoder (models/kimi_linear.py), whose
// recurrence is about two thirds of a decode step's least time at the
// benchmark cell's 640 beam rows.
//
// What bounds it on the H100. At decode (T = 1), bytes: each row reads its
// parent's state and writes its own, 64 KB each way a head, against ~7 kD^2
// f32 operations (about one a byte). At prefill (T = the prefix), the state
// stays in registers across a job's positions and is written once; the ~7
// kD^2 operations a position on the CUDA cores (67 TFLOP/s f32) bound it.
//
// Design. Each value column of S evolves on its own given (k, beta, alpha),
// so a lane owns one column, its kD values in registers, and a warp owns 32
// columns of one sequence and head; consecutive lanes hold consecutive
// columns, so each of the column's kD reads and writes is one 128-byte
// line for the warp. A CTA holds a group of G <= kMaxGroup sequences (a
// job's beams at decode, one job at prefill), one head and 32 columns
// (grid: S / G x H x kD / 32). Every lane reads its sequence's starting
// column (its parent's row, or zeros) before the CTA synchronises, and
// only then does any lane write its sequence's final column: a row reads
// its parent and writes its own state in place within the group, so the
// state is held once and the beam's reorder copies none of it. Each
// position's q, k and decay go through the warp's shared vectors, read by
// all lanes (broadcast); beta and the lane's v come from device memory.
// The two sums of a position (u = k . alpha s, o = q . s') run in key
// order in f32, as the plain version's einsums do up to their order.
//
// Every access is tested against its bound in the checked build
// (check.cuh); the default build's code is the plain access.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "check.cuh"

namespace {

// The memory check's bounds (check.cuh; tools/memcheck.py BOUNDS)
enum Bound {
  kBQ = 1,        // q: S x T x H x kD
  kBK = 2,        // k: S x T x H x kD
  kBV = 3,        // v: S x T x H x kD
  kBG = 4,        // g: S x T x H x kD
  kBBeta = 5,     // beta: S x T x H
  kBValid = 6,    // valid: S x T
  kBRowsIn = 7,   // rows_in: S
  kBRowsOut = 8,  // rows_out: S
  kBState = 9,    // state: R x H x kD x kD
  kBOut = 10,     // out: S x T x H x kD (the gated norm's o)
  kBVecs = 11,    // the warps' shared vectors: G x kVec floats
  kBProj = 12,    // in_proj's rows: S x T x ld
  kBF = 13,       // f: S x T x H x kD
  kBRate = 14,    // the decay rates: H
  kBDtBias = 15,  // dt_bias: H x kD
  kBConvW = 16,   // the conv weights: 3 H kD x kTaps
  kBConv = 17,    // the conv windows: R x kWin x 3 H kD
  kBParent = 18,  // parent: S
  kBLengths = 19,  // lengths: S
  kBSums = 20,    // the shared sums of squares: 4 x kConvRows floats
  kBGate = 21,    // gate: N x kD (N = rows x H)
  kBNormW = 22,   // o_norm's weight: kD
  kBNormed = 23,  // the gated norm's output: N x kD
};

constexpr int kD = 128;           // a head's key and value width
constexpr int kCols = 32;         // value columns of a warp (one a lane)
constexpr int kMaxGroup = 8;      // sequences of a CTA
constexpr int kVec = 3 * kD;      // a warp's q, k and alpha of one position

#define KD_IN(kind, bound_id, lo, len, bound) \
  VSRCIC_IN(kKdaRecurrence, kind, bound_id, lo, len, bound)
// an element of the warps' shared vectors (flat index i), through the check
#define VEC_LD(i, expr) \
  VSRCIC_LD(KD_IN(kShared, kBVecs, i, 1, group * kVec), expr, 0.f)
#define VEC_DO(i, ...) \
  VSRCIC_DO(KD_IN(kShared, kBVecs, i, 1, group * kVec), __VA_ARGS__)

__global__ void __launch_bounds__(kMaxGroup * 32)
kda_recurrence_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ beta,
                      const uint8_t* __restrict__ valid,
                      const int* __restrict__ rows_in,
                      const int* __restrict__ rows_out, float* state,
                      float* __restrict__ out, int S, int T, int H, int R) {
  __shared__ __align__(16) float vecs[kMaxGroup * kVec];
  const int group = blockDim.x >> 5;
  const int b = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * group + b;
  const int h = blockIdx.y;
  const int col = blockIdx.z * kCols + lane;
  // the checks' bounds and sv's offset in vecs (unread in the default build)
  [[maybe_unused]] const long long n_pos = (long long)S * T;  // (s, t) pairs
  [[maybe_unused]] const long long n_vec = n_pos * H * kD;  // q, k, v, g, out
  [[maybe_unused]] const long long n_state = (long long)R * H * kD * kD;
  [[maybe_unused]] const int vb = b * kVec;
  float* sv = vecs + b * kVec;

  // this lane's column of the sequence's starting state
  const int in = VSRCIC_LD(KD_IN(kGlobal, kBRowsIn, s, 1, S), rows_in[s], -1);
  float st[kD];
  if (in >= 0) {
    const long long at = ((long long)in * H + h) * kD * kD + col;
#pragma unroll
    for (int i = 0; i < kD; ++i)
      st[i] = VSRCIC_LD(KD_IN(kGlobal, kBState, at + i * kD, 1, n_state),
                        state[at + i * kD], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < kD; ++i) st[i] = 0.f;
  }
  // every sequence of the group has read its start before any writes its
  // end (a row's parent is a row of its group, overwritten in place)
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const long long p = s * T + t;
    const long long base = (p * H + h) * kD;
    const bool live =
        valid == nullptr ||
        VSRCIC_LD(KD_IN(kGlobal, kBValid, p, 1, n_pos), valid[p], 0) != 0;
    if (!live) {  // the whole warp: one (s, t)
      VSRCIC_DO(KD_IN(kGlobal, kBOut, base + col, 1, n_vec),
                out[base + col] = 0.f);
      continue;
    }
#pragma unroll
    for (int j = 0; j < kD / 32; ++j) {
      const int i = j * 32 + lane;
      VEC_DO(vb + i, sv[i] = VSRCIC_LD(
                         KD_IN(kGlobal, kBQ, base + i, 1, n_vec), q[base + i],
                         0.f));
      VEC_DO(vb + kD + i,
             sv[kD + i] = VSRCIC_LD(KD_IN(kGlobal, kBK, base + i, 1, n_vec),
                                    k[base + i], 0.f));
      VEC_DO(vb + 2 * kD + i,
             sv[2 * kD + i] = expf(VSRCIC_LD(
                 KD_IN(kGlobal, kBG, base + i, 1, n_vec), g[base + i], 0.f)));
    }
    const float bt = VSRCIC_LD(KD_IN(kGlobal, kBBeta, p * H + h, 1, n_pos * H),
                               beta[p * H + h], 0.f);
    const float vc = VSRCIC_LD(KD_IN(kGlobal, kBV, base + col, 1, n_vec),
                               v[base + col], 0.f);
    __syncwarp();
    // u = k . (alpha s), the decayed column kept
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      st[i] *= VEC_LD(vb + 2 * kD + i, sv[2 * kD + i]);
      u = fmaf(VEC_LD(vb + kD + i, sv[kD + i]), st[i], u);
    }
    // s' = alpha s + k beta (v - u); o = q . s'
    const float delta = bt * (vc - u);
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      st[i] = fmaf(VEC_LD(vb + kD + i, sv[kD + i]), delta, st[i]);
      o = fmaf(VEC_LD(vb + i, sv[i]), st[i], o);
    }
    VSRCIC_DO(KD_IN(kGlobal, kBOut, base + col, 1, n_vec), out[base + col] = o);
    __syncwarp();  // the vectors are read before the next position's land
  }

  const int dst =
      VSRCIC_LD(KD_IN(kGlobal, kBRowsOut, s, 1, S), rows_out[s], 0);
  const long long at = ((long long)dst * H + h) * kD * kD + col;
#pragma unroll
  for (int i = 0; i < kD; ++i)
    VSRCIC_DO(KD_IN(kGlobal, kBState, at + i * kD, 1, n_state),
              state[at + i * kD] = st[i]);
}

#undef KD_IN
#undef VEC_LD
#undef VEC_DO

// ---------------------------------------------------------------------------
// The layer's elementwise work around the recurrence: its input stage
// (short_conv_kernel) and its output stage (gated_norm_kernel). Neither
// name starts with "kda_", which names the recurrence alone.
//
// short_conv_kernel. For each row (a beam row at decode, a position of a
// prefix at prefill) and head h: the causal depthwise conv4 of h's
// pre-conv q, k and v channels (f32 sums, taps in order), SiLU, q and k
// L2-normed over the head's kD channels (eps 1e-6 under the root), q
// scaled by kD^-1/2; g = -A_h softplus(f + dt_bias) and beta = sigmoid(b)
// in f32; the inputs read from in_proj's rows in place, at their stride.
//
// What bounds it on the H100: bytes, a few operations a byte at most. At
// the Kimi-Linear cell's decode (640 rows, 32 heads) it reads the rows'
// q, k, v (15.7 MB), their parents' windows (each distinct parent once: up
// to 47 MB) and f (5.2 MB), and writes the rows' windows (47 MB) and q, k,
// v, g in f32 (42 MB): up to ~157 MB, ~47 us at 3.35 TB/s, where the chain
// of PyTorch operations it replaces moves ~1 GB through f32 copies.
//
// Design. A CTA holds up to kConvRows rows of one head: 192 threads, two
// warps each for q, k and v, a lane two adjacent channels (one 4-byte
// pair of bf16 or 8 bytes of f32 a load), so that each warp's access is
// one run of consecutive bytes; the conv weights and every tap stay in
// registers. The L2 norms sum each row's squares within a warp
// (shuffles), then across its two warps (shared memory). At decode the
// CTA's rows are a job's beams (the group): every thread reads its rows'
// parent windows before the CTA synchronises, and only then writes the
// rows' own windows in place, so the windows are held once and the beam's
// reorder moves none of them. At prefill the CTA's rows are kConvRows
// consecutive positions of one prefix: a thread also loads its channels
// at the kWin positions before them (zeros before the first) and slides
// the window in registers; positions past the prefix's real tokens are
// written as zeros; the CTA at position 0 writes the prefix's last kWin
// real inputs (zeros where it is shorter) into its job's window row.
//
// gated_norm_kernel. For each row and head: RMSNorm of the recurrence's o
// over the head's kD channels in f32 (o_norm's weight, eps), times
// sigmoid(gate) in f32, rounded once into the storage type for o_proj.
// Bytes bound it too (o in f32, the gate and the output in bf16: ~21 MB
// at the cell's decode, ~6 us). A warp holds one (row, head), a lane four
// adjacent channels (one 16-byte load of o); the sum of squares by
// shuffles.

constexpr int kTaps = 4;          // the conv's width
constexpr int kWin = kTaps - 1;   // the inputs a window keeps
constexpr int kPairs = kD / 2;    // channel pairs of a head (one a lane)
constexpr int kConvThreads = 3 * kPairs;  // q, k and v: two warps each
constexpr int kConvRows = 8;      // rows of a CTA: a decode group's most
constexpr int kNormWarps = 8;     // (row, head) units of a gated norm CTA
constexpr float kL2Eps = 1e-6f;
constexpr float kQScale = 0.08838834764831845f;  // kD^-1/2

// the storage type's single, pair and quad accesses and their zeros
template <typename T>
struct Store;
template <>
struct Store<__nv_bfloat16> {
  using pair = __nv_bfloat162;
  using quad = uint2;
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.f);
  }
  static __device__ __forceinline__ pair zero2() {
    return __floats2bfloat162_rn(0.f, 0.f);
  }
  static __device__ __forceinline__ quad zero4() { return make_uint2(0u, 0u); }
};
template <>
struct Store<float> {
  using pair = float2;
  using quad = float4;
  static __device__ __forceinline__ float zero() { return 0.f; }
  static __device__ __forceinline__ pair zero2() {
    return make_float2(0.f, 0.f);
  }
  static __device__ __forceinline__ quad zero4() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 p) {
  return __bfloat1622float2(p);
}
__device__ __forceinline__ float2 widen(float2 p) { return p; }
__device__ __forceinline__ float4 widen(uint2 p) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&p.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&p.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen(float4 p) { return p; }
// four floats into the storage type (bf16: rounded to nearest even)
__device__ __forceinline__ uint2 narrow(float4 x, uint2) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  return make_uint2(*reinterpret_cast<unsigned*>(&a),
                    *reinterpret_cast<unsigned*>(&b));
}
__device__ __forceinline__ float4 narrow(float4 x, float4) { return x; }

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

#define SC_IN(kind, bound_id, lo, len, bound) \
  VSRCIC_IN(kShortConv, kind, bound_id, lo, len, bound)
// a pair of the storage type at flat index i of `base` under bound `id`
#define SC_LD2(id, base, i, bound)                              \
  VSRCIC_LD(SC_IN(kGlobal, id, i, 2, bound),                    \
            *reinterpret_cast<const P*>((base) + (i)), Store<T>::zero2())
#define SC_ST2(id, base, i, bound, val)       \
  VSRCIC_DO(SC_IN(kGlobal, id, i, 2, bound), \
            *reinterpret_cast<P*>((base) + (i)) = (val))

// proj: S x T x ld (the pre-conv q, k, v in columns [0, 3 H kD), b in the
// last H); f: S x T x H kD; conv: R x kWin x 3 H kD, read at parent[s] and
// written at s (decode, T = 1, groups of `group` rows), or written at
// rows_out[s] (prefill, the first lengths[s] positions real); q, k, v, g:
// S x T x H x kD f32, beta: S x T x H f32. Grid: (S / group, H) at decode,
// (S x ceil(T / kConvRows), H) at prefill.
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
short_conv_kernel(const T* __restrict__ proj, const T* __restrict__ f,
                  const float* __restrict__ rate,
                  const float* __restrict__ dt_bias,
                  const T* __restrict__ w, T* conv,
                  const int* __restrict__ parent,
                  const int* __restrict__ lengths,
                  const int* __restrict__ rows_out, float* __restrict__ q,
                  float* __restrict__ k, float* __restrict__ v,
                  float* __restrict__ g, float* __restrict__ beta, int S,
                  int T_, int H, int R, int ld, int group) {
  using P = typename Store<T>::pair;
  __shared__ float sums[4 * kConvRows];  // q's and k's warps, by row
  const int part = threadIdx.x / kPairs;  // 0 q, 1 k, 2 v
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.y;
  const int width = H * kD;               // channels of each of q, k, v
  const long long C = 3LL * width;        // the conv's channels
  const int c = h * kD + 2 * (threadIdx.x % kPairs);  // within q, k or v
  const long long ch = (long long)part * width + c;   // within the conv's
  // the checks' bounds (unread in the default build)
  [[maybe_unused]] const long long n_rows = (long long)S * T_;
  [[maybe_unused]] const long long n_out = n_rows * width;
  [[maybe_unused]] const long long n_conv = (long long)R * kWin * C;
  const bool decode = parent != nullptr;
  // this CTA's rows: a group of beam rows (decode) or a chunk of positions
  long long s0;
  int t0, n, len;
  if (decode) {
    s0 = (long long)blockIdx.x * group;
    t0 = 0;
    n = group;
    len = 0;  // unread: every decode row is real
  } else {
    const int chunks = (T_ + kConvRows - 1) / kConvRows;
    s0 = blockIdx.x / chunks;
    t0 = (int)(blockIdx.x % chunks) * kConvRows;
    n = min(kConvRows, T_ - t0);
    len = min(max(VSRCIC_LD(SC_IN(kGlobal, kBLengths, s0, 1, S), lengths[s0],
                            0),
                  0),
              T_);
  }
  float wt[2][kTaps];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      wt[e][j] = widen(VSRCIC_LD(
          SC_IN(kGlobal, kBConvW, (ch + e) * kTaps + j, 1, C * kTaps),
          w[(ch + e) * kTaps + j], Store<T>::zero()));

  // each row's taps, oldest first, as stored
  P tap[kConvRows][kTaps];
  if (decode) {
#pragma unroll
    for (int i = 0; i < kConvRows; ++i) {
#pragma unroll
      for (int j = 0; j < kTaps; ++j) tap[i][j] = Store<T>::zero2();
      if (i >= n) continue;
      const long long s = s0 + i;
      const long long pr =
          VSRCIC_LD(SC_IN(kGlobal, kBParent, s, 1, S), parent[s], 0);
#pragma unroll
      for (int j = 0; j < kWin; ++j)
        tap[i][j] = SC_LD2(kBConv, conv, (pr * kWin + j) * C + ch, n_conv);
      tap[i][kWin] = SC_LD2(kBProj, proj, s * ld + ch, n_rows * ld);
    }
    // every row of the group has read its parent's window before any row
    // writes its own (a row's parent is a row of its group)
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kConvRows; ++i) {
      if (i >= n) continue;
#pragma unroll
      for (int j = 0; j < kWin; ++j)
        SC_ST2(kBConv, conv, ((s0 + i) * kWin + j) * C + ch, n_conv,
               tap[i][j + 1]);
    }
  } else {
    P xs[kConvRows + kWin];  // positions t0 - kWin .. t0 + kConvRows - 1
#pragma unroll
    for (int m = 0; m < kConvRows + kWin; ++m) {
      const int t = t0 - kWin + m;
      xs[m] = Store<T>::zero2();
      if (t >= 0 && t < len)
        xs[m] = SC_LD2(kBProj, proj, (s0 * T_ + t) * ld + ch, n_rows * ld);
    }
#pragma unroll
    for (int i = 0; i < kConvRows; ++i)
#pragma unroll
      for (int j = 0; j < kTaps; ++j) tap[i][j] = xs[i + j];
    if (t0 == 0) {  // the job's window: its last kWin real inputs
      const long long dst =
          VSRCIC_LD(SC_IN(kGlobal, kBRowsOut, s0, 1, S), rows_out[s0], 0);
#pragma unroll
      for (int j = 0; j < kWin; ++j) {
        const int t = len - kWin + j;
        P x = Store<T>::zero2();
        if (t >= 0)
          x = SC_LD2(kBProj, proj, (s0 * T_ + t) * ld + ch, n_rows * ld);
        SC_ST2(kBConv, conv, (dst * kWin + j) * C + ch, n_conv, x);
      }
    }
  }

  // the conv sums in f32, taps in order, then SiLU; the squares' sums
  float2 y[kConvRows];
  float ss[kConvRows];
#pragma unroll
  for (int i = 0; i < kConvRows; ++i) {
    float2 a = widen(tap[i][0]);
    a.x *= wt[0][0];
    a.y *= wt[1][0];
#pragma unroll
    for (int j = 1; j < kTaps; ++j) {
      const float2 x = widen(tap[i][j]);
      a.x = fmaf(x.x, wt[0][j], a.x);
      a.y = fmaf(x.y, wt[1][j], a.y);
    }
    y[i] = make_float2(silu(a.x), silu(a.y));
    const bool live = i < n && (decode || t0 + i < len);
    ss[i] = live ? fmaf(y[i].y, y[i].y, y[i].x * y[i].x) : 0.f;
  }
  if (part < 2) {
#pragma unroll
    for (int i = 0; i < kConvRows; ++i) {
      ss[i] = warp_sum(ss[i]);
      if (lane == 0)
        VSRCIC_DO(SC_IN(kShared, kBSums, warp * kConvRows + i, 1,
                        4 * kConvRows),
                  sums[warp * kConvRows + i] = ss[i]);
    }
  }
  __syncthreads();

  const float a_h = part == 2 ? VSRCIC_LD(SC_IN(kGlobal, kBRate, h, 1, H),
                                          rate[h], 0.f)
                              : 0.f;
  float2 dt = make_float2(0.f, 0.f);
  if (part == 2)
    dt = make_float2(
        VSRCIC_LD(SC_IN(kGlobal, kBDtBias, c, 1, width), dt_bias[c], 0.f),
        VSRCIC_LD(SC_IN(kGlobal, kBDtBias, c + 1, 1, width), dt_bias[c + 1],
                  0.f));
#pragma unroll
  for (int i = 0; i < kConvRows; ++i) {
    if (i >= n) continue;
    const bool live = decode || t0 + i < len;
    const long long row = decode ? s0 + i : s0 * T_ + t0 + i;
    const long long at = row * width + c;
    float2 out = make_float2(0.f, 0.f);
    if (part < 2) {
      float* dst = part == 0 ? q : k;
      if (live) {
        const int b = 2 * part * kConvRows + i;
        const float tot =
            VSRCIC_LD(SC_IN(kShared, kBSums, b, 1, 4 * kConvRows), sums[b],
                      0.f) +
            VSRCIC_LD(SC_IN(kShared, kBSums, b + kConvRows, 1, 4 * kConvRows),
                      sums[b + kConvRows], 0.f);
        const float r = rsqrtf(tot + kL2Eps);
        out = make_float2(y[i].x * r, y[i].y * r);
        if (part == 0) out = make_float2(out.x * kQScale, out.y * kQScale);
      }
      VSRCIC_DO(SC_IN(kGlobal, part == 0 ? kBQ : kBK, at, 2, n_out),
                *reinterpret_cast<float2*>(dst + at) = out);
      continue;
    }
    float2 gg = make_float2(0.f, 0.f);
    if (live) {
      out = y[i];
      const float2 fv = widen(SC_LD2(kBF, f, at, n_out));
      gg = make_float2(-a_h * softplus(fv.x + dt.x),
                       -a_h * softplus(fv.y + dt.y));
    }
    VSRCIC_DO(SC_IN(kGlobal, kBV, at, 2, n_out),
              *reinterpret_cast<float2*>(v + at) = out);
    VSRCIC_DO(SC_IN(kGlobal, kBG, at, 2, n_out),
              *reinterpret_cast<float2*>(g + at) = gg);
    if (threadIdx.x % kPairs == 0) {
      float bt = 0.f;
      if (live)
        bt = sigmoid(widen(VSRCIC_LD(
            SC_IN(kGlobal, kBProj, row * ld + ld - H + h, 1, n_rows * ld),
            proj[row * ld + ld - H + h], Store<T>::zero())));
      VSRCIC_DO(SC_IN(kGlobal, kBBeta, row * H + h, 1, n_rows * H),
                beta[row * H + h] = bt);
    }
  }
}

#undef SC_IN
#undef SC_LD2
#undef SC_ST2

#define GN_IN(kind, bound_id, lo, len, bound) \
  VSRCIC_IN(kGatedNorm, kind, bound_id, lo, len, bound)

// o: N x kD f32 (N = rows x H units); gate, out: N x kD; weight: kD.
template <typename T>
__global__ void __launch_bounds__(kNormWarps * 32)
gated_norm_kernel(const float* __restrict__ o, const T* __restrict__ gate,
                  const T* __restrict__ weight, T* __restrict__ out, int N,
                  float eps) {
  using Q = typename Store<T>::quad;
  const long long unit = (long long)blockIdx.x * kNormWarps +
                         (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (unit >= N) return;  // the whole warp; no barrier follows
  [[maybe_unused]] const long long n_el = (long long)N * kD;
  const long long at = unit * kD + 4 * lane;
  const float4 x = VSRCIC_LD(GN_IN(kGlobal, kBOut, at, 4, n_el),
                             *reinterpret_cast<const float4*>(o + at),
                             Store<float>::zero4());
  const float4 gt = widen(VSRCIC_LD(GN_IN(kGlobal, kBGate, at, 4, n_el),
                                    *reinterpret_cast<const Q*>(gate + at),
                                    Store<T>::zero4()));
  float wv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    wv[e] = widen(VSRCIC_LD(GN_IN(kGlobal, kBNormW, 4 * lane + e, 1, kD),
                            weight[4 * lane + e], Store<T>::zero()));
  float ss = x.x * x.x;
  ss = fmaf(x.y, x.y, ss);
  ss = fmaf(x.z, x.z, ss);
  ss = fmaf(x.w, x.w, ss);
  const float r = rsqrtf(warp_sum(ss) * (1.f / kD) + eps);
  const float4 y = make_float4(x.x * r * wv[0] * sigmoid(gt.x),
                               x.y * r * wv[1] * sigmoid(gt.y),
                               x.z * r * wv[2] * sigmoid(gt.z),
                               x.w * r * wv[3] * sigmoid(gt.w));
  VSRCIC_DO(GN_IN(kGlobal, kBNormed, at, 4, n_el),
            *reinterpret_cast<Q*>(out + at) = narrow(y, Q{}));
}

#undef GN_IN

}  // namespace

// q, k, v, g: (S, T, H, 128) f32; beta (S, T, H) f32; valid (S, T) uint8
// or null (every position valid); rows_in, rows_out (S,) int32 (rows_in < 0:
// zeros); state (R, H, 128, 128) f32, in place; out (S, T, H, 128) f32.
// 1 <= group <= 8 sequences a CTA, S a multiple of group; the rows a group
// reads are rows it writes or rows no group writes. Returns a cudaError_t.
extern "C" int vsrcic_kda(const void* q, const void* k, const void* v,
                          const void* g, const void* beta, const void* valid,
                          const void* rows_in, const void* rows_out,
                          void* state, void* out, int S, int T, int H, int R,
                          int group, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (group < 1 || group > kMaxGroup || S < 1 || S % group || T < 1 ||
      H < 1 || H > 65535 || R < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(S / group), (unsigned)H, kD / kCols);
  kda_recurrence_kernel<<<grid, group * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g),
      static_cast<const float*>(beta), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(rows_in), static_cast<const int*>(rows_out),
      static_cast<float*>(state), static_cast<float*>(out), S, T, H, R);
  return (int)cudaGetLastError();
}

// proj (S, T, ld) with the pre-conv q, k, v in columns [0, 3 H 128) and b
// in the last H; f (S, T, H 128); conv (R, 3, 3 H 128), all of the storage
// type (bf16 != 0: bf16, else f32); rate (H,), dt_bias (H 128) f32; w
// (3 H 128, 4) of the storage type. Decode (parent non-null): T = 1, row s
// reads conv[parent[s]] and writes conv[s], 1 <= group <= 8 rows a group,
// S a multiple of group, a row's parent a row of its group. Prefill
// (parent null): positions t < lengths[s] real, conv[rows_out[s]] <- the
// last 3 real inputs (zeros where fewer). q, k, v, g (S, T, H, 128) and
// beta (S, T, H) f32, zeros past the real positions. ld even. Returns a
// cudaError_t.
extern "C" int vsrcic_short_conv(const void* proj, const void* f,
                                 const void* rate, const void* dt_bias,
                                 const void* w, void* conv,
                                 const void* parent, const void* lengths,
                                 const void* rows_out, void* q, void* k,
                                 void* v, void* g, void* beta, int S, int T,
                                 int H, int R, int ld, int group, int bf16,
                                 void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  const bool decode = parent != nullptr;
  if (S < 1 || T < 1 || H < 1 || H > 65535 || R < 1 || ld % 2 ||
      (long long)ld < 3LL * H * kD + H ||
      (decode ? T != 1 || group < 1 || group > kConvRows || S % group ||
                    R < S
              : lengths == nullptr || rows_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      decode ? S / group
             : (long long)S * ((T + kConvRows - 1) / kConvRows);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)H);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SC_LAUNCH(T_)                                                        \
  short_conv_kernel<T_><<<grid, kConvThreads, 0, st>>>(                      \
      static_cast<const T_*>(proj), static_cast<const T_*>(f),               \
      static_cast<const float*>(rate), static_cast<const float*>(dt_bias),   \
      static_cast<const T_*>(w), static_cast<T_*>(conv),                     \
      static_cast<const int*>(parent), static_cast<const int*>(lengths),     \
      static_cast<const int*>(rows_out), static_cast<float*>(q),             \
      static_cast<float*>(k), static_cast<float*>(v), static_cast<float*>(g), \
      static_cast<float*>(beta), S, T, H, R, ld, decode ? group : 1)
  if (bf16)
    SC_LAUNCH(__nv_bfloat16);
  else
    SC_LAUNCH(float);
#undef SC_LAUNCH
  return (int)cudaGetLastError();
}

// o (N, 128) f32 (N = rows x heads); gate, out (N, 128) and weight (128,)
// of the storage type (bf16 != 0: bf16, else f32). Returns a cudaError_t.
extern "C" int vsrcic_gated_norm(const void* o, const void* gate,
                                 const void* weight, void* out, int N,
                                 float eps, int bf16, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (N < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kNormWarps - 1) / kNormWarps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    gated_norm_kernel<__nv_bfloat16><<<blocks, kNormWarps * 32, 0, st>>>(
        static_cast<const float*>(o), static_cast<const __nv_bfloat16*>(gate),
        static_cast<const __nv_bfloat16*>(weight),
        static_cast<__nv_bfloat16*>(out), N, eps);
  else
    gated_norm_kernel<float><<<blocks, kNormWarps * 32, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(gate),
        static_cast<const float*>(weight), static_cast<float*>(out), N, eps);
  return (int)cudaGetLastError();
}

VSRCIC_CHECK_RECORDS(kda)
