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
#include <cuda_runtime.h>
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
  kBOut = 10,     // out: S x T x H x kD
  kBVecs = 11,    // the warps' shared vectors: G x kVec floats
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

VSRCIC_CHECK_RECORDS(kda)
