// Fused vocab head: logits = h2 @ W_t + b, per-row top-k and logsumexp,
// without writing the (rows, V) logits to device memory.
//
// Replaces the TPU kernel vsrcic_tpu/ops/vocab_topk.py
// (make_vocab_topk_lse :47: `kernel` :116 and the default two-stage
// `kernel2` :159, pallas_call :220), in all of its operand configurations
// (lhs_dtype f32 or bf16, table_dtype f32 or bf16). JAX multiplies h2 by
// the upcast table with f32 accumulation (:132-133), 102 GFLOP at rows
// 5120, R 1000, V 10000. The route is chosen by the operands' types and
// layout (ops/vocab_topk.py::vocab_launch_plan):
//
//   TMA routes (W_t's rows a multiple of 16 bytes apart, its base 16-byte
//   aligned; bf16 h2 the same: every table the captioner facade builds,
//   padded once to a pitch of V rounded up to 8). Every operand is taken
//   as bf16 planes: a bf16 tensor is one plane, an f32 one three, hi + mid
//   + lo, 8 significant bits each, summing to it exactly
//   (vocab_split_kernel: hi and mid rounded toward zero, lo the exact
//   rest; a non-finite entry whole in hi). A bf16 x bf16 product is exact
//   in f32, so the planes' products, summed in f32, are the f32 product
//   itself up to the order of the f32 sums, which every route here takes
//   the freedom of. The exception is an infinite entry: it meets the other
//   operand's zero planes, 0 x inf = NaN where the f32 product gives +-inf.
//   vocab_tma_kernel<PA, PB> on PA planes of h2 and PB of W_t:
//     * <1, 1> "tma": bf16 h2 and table (VSRCIC_VOCAB_LHS_BF16=1 on bf16
//       tables). Bound: 102 GFLOP over 989 TFLOP/s (0.1035 ms) against ~30
//       MB over 3.35 TB/s. What holds it back is not the tensor cores:
//       every tile's operands stream from L2 (1.6 GB a call at R 1000 for
//       128 x 128 tiles), at ~5-6 TB/s (PERF.md §6). So: 128 x 256 tiles
//       (24 bytes into shared memory an output, not 32); persistent CTAs,
//       one an SM, in clusters of 2 along the rows that multicast each W_t
//       box to both (16 bytes from L2 an output); wgmma m64n256k16 (f32
//       accumulators) fed by TMA (128-byte-swizzled 64-deep boxes in a
//       ring of mbarrier-guarded stages, one producer thread); both
//       consumer warpgroups on one tile, each folding its 64 x 256 half
//       straight from its accumulators while the producer fills the ring
//       with the next tile: no round trip of the tile through shared
//       memory, branch-free passes, top-k rounds over per-lane group
//       maxima.
//     * <3, 1> "split": f32 h2 on a bf16 table (the beam's default), three
//       bf16 passes (3 x 0.1035 ms);
//       <3, 3> "split9": f32 h2 on an f32 table, nine (0.932 ms);
//       <1, 3> "split_w": bf16 h2 on an f32 table, three. W_t's planes
//       are made once per table (vsrcic_vocab_split on its rows), h2's on
//       every call. Redesigned for the planes where measuring asked
//       (PERF.md §6):
//       - the tensor cores' f32 sums truncate at the accumulator's scale,
//         so one accumulator over the whole depth drifts: 3.15e-6 worst,
//         2.4x the SGEMM's distance from cuBLAS, and phase 6's share of
//         captions equal to the plain path fell to 0.9889, below its 0.99.
//         So each 64-deep stage's products, the lightest first, are summed
//         into 64 fresh accumulators and added to a running total with f32
//         adds: 2.0e-6. Two sets of 128 do not fit, so tiles are 128 x 128
//         (a second set of stage sums, to add one while the next is
//         multiplied, slowed the products);
//       - a stage holds every plane's boxes of both operands (<3, 3>: 96
//         KB, two slots; the others 64 KB, three): each box is copied
//         once, not once a product;
//       - where h2 has three planes they are the larger share of a stage
//         (or an equal one), so a cluster of two CTAs takes two vocab
//         tiles of one row block and multicasts them (each copies half the
//         rows of every box), its W_t boxes alone; where V is one tile the
//         cluster is one CTA. On one plane of h2 W_t's planes are shared,
//         by clusters along the rows as on <1, 1>.
//   mma.sync (bf16 h2 and table TMA cannot describe): mma.sync.m16n8k16
//     fed by ldmatrix from 32-deep slices (element loads, zero-filled past
//     R, rows and V), the 128 x 128 accumulator tile through shared memory
//     into the SGEMM's register layout and fold (vocab_tile_bf16_kernel).
//   SGEMM (f32 h2, or bf16 h2 upcast, on a table TMA cannot describe: an
//     unaligned base, or rows not a multiple of 8 apart; only callers that
//     pass their own tables): f32 operations on the CUDA cores, 102 GFLOP
//     over 67 TFLOP/s. A tiled SGEMM (8-deep slices through
//     double-buffered shared memory, an 8x8 register tile per thread, bf16
//     weights upcast on load), folded from the registers
//     (vsrcic_vocab_topk).
//
// The TPU grid carried running top-k/lse state from one vocab tile to the
// next; CUDA blocks run in no order, so the work is split in two launches
// (three on the split routes, after h2's split pass). Stage 1 folds each
// row of each logits tile (128 x 128; 128 x 256 on the "tma" route) into
// that tile's partial top-k and (max, sum of exp) pair;
// stage 2 (one warp per row) merges the partials of all vocab tiles.
// Every comparison orders by (XLA's total-order key descending, vocab id
// ascending), which is jax.lax.top_k's rule: NaN above +inf, +0 above -0;
// the logsumexp shifts by the max only where it is finite
// (jax.nn.logsumexp), so a row with a NaN gives NaN, one with +inf +inf
// and an all -inf row -inf. Every logit of a tile is summed over R by the
// same instruction sequence (no split along R), so duplicated weight
// columns give bit-equal logits and tie exactly. The ragged edges of rows,
// R and V are masked in the kernel (or zero-filled by TMA): a column past V
// is never a candidate and adds nothing to the sum. Every access is tested
// against its bound in the checked build (check.cuh); the default build's
// code is the plain access.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "check.cuh"
#include "tma.cuh"

namespace {

// The memory check's bounds (check.cuh; tools/memcheck.py BOUNDS), shared
// by the file's kernels (the record names the kernel)
enum Bound {
  kBH2 = 1,        // h2, or its planes: rows x R (planes x rows x R8)
  kBW = 2,         // W_t: (R - 1) x ldw + V
  kBBias = 3,      // bias: V
  kBPart = 4,      // part_m, part_s: tiles x rows
  kBPartK = 5,     // part_vals, part_ids: tiles x rows x k
  kBOutK = 6,      // vals, ids: rows x k
  kBLse = 7,       // lse: rows
  kBPlanes = 8,    // the split pass's planes: 3 x rows x R8 / 8 (uint4)
  kBAs = 9,        // stage 1's h2 slices in shared memory
  kBBs = 10,       // its W_t slices
  kBCs = 11,       // the mma.sync route's f32 tile
  kBSmem = 12,     // what the layout needs within the dynamic shared bytes
  kBSlot = 13,     // a ring slot, < stages
  kBBox = 14,      // a TMA box or a wgmma operand within the ring
  kBRank = 15,     // the cluster rank a release arrives on
  kBMapH2 = 16,    // host: the tensor maps' extents
  kBMapW = 17,
};

// a shared-memory address's byte offset from `base`
__device__ __forceinline__ long long soff(const void* p, const void* base) {
  return static_cast<const unsigned char*>(p) -
         static_cast<const unsigned char*>(base);
}

constexpr int TR = 128;       // rows per CTA
constexpr int TV = 128;       // vocab columns per CTA (ops/vocab_topk.TILE_V)
constexpr int TK = 8;         // depth of one shared-memory slice
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int K_MAX = 16;     // ops/vocab_topk.K_MAX
constexpr int NO_ID = 0x7fffffff;
constexpr int KEY_LOW = (int)0x80000000;  // the lowest total-order key

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// XLA's total-order key of an f32 (core/nn.py::total_order_key): its bits
// as an int32, the negative ones xor-ed with 0x7fffffff. Ordered as ints,
// keys order -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN; the map is
// its own inverse.
__device__ __forceinline__ int order_key(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? b ^ 0x7fffffff : b;
}

__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key < 0 ? key ^ 0x7fffffff : key);
}

// (key descending, id ascending): jax.lax.top_k's order. A slot is seeded
// with (KEY_LOW, NO_ID), which every real candidate beats (its id is lower).
__device__ __forceinline__ bool better(int k1, int i1, int k2, int i2) {
  return k1 > k2 || (k1 == k2 && i1 < i2);
}

// warp-wide best (key, id) pair
__device__ __forceinline__ void warp_best(int& key, int& id) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, o);
    const int oi = __shfl_xor_sync(0xffffffffu, id, o);
    if (better(ok, oi, key, id)) {
      key = ok;
      id = oi;
    }
  }
}

// The logsumexp follows jax.nn.logsumexp: the sum of exp(x - shift), shift
// the max where it is finite, else 0. A part is (m, s): m its max (NaN if
// any of its values is NaN), s its sum of exp(x - shift(m)); (-inf, 0) is
// empty or all -inf.
__device__ __forceinline__ float lse_shift(float m) {
  return isfinite(m) ? m : 0.f;
}

// max that propagates NaN (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

// combine two parts: any NaN gives NaN; a +inf max gives an infinite sum
__device__ __forceinline__ void lse_combine(float& m, float& s, float om,
                                            float os) {
  const float nm = max_nan(m, om);
  if (nm != nm || nm == INFINITY) {
    s = nm;        // the lse is NaN, or +inf
  } else if (nm == -INFINITY) {
    s = 0.f;       // both empty or all -inf: the lse is -inf
  } else {
    const float a = (s == 0.f) ? 0.f : s * expf(m - nm);
    const float b = (os == 0.f) ? 0.f : os * expf(om - nm);
    s = a + b;
  }
  m = nm;
}

__device__ __forceinline__ float lse_final(float m, float s) {
  return lse_shift(m) + logf(s);
}

__device__ __forceinline__ void warp_lse(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    lse_combine(m, s, om, os);
  }
}

// half-warp (16 lanes sharing a row) reductions
__device__ __forceinline__ int half_max(int key) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
  return key;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void half_best(int& key, int& id) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, o);
    const int oi = __shfl_xor_sync(0xffffffffu, id, o);
    if (better(ok, oi, key, id)) {
      key = ok;
      id = oi;
    }
  }
}

// Fold a 128 x 128 logits tile (without bias) into the tile's partial
// top-k and (max, sum of exp) of each row. Thread (tx, ty) = (tid % 16,
// tid / 16) holds rows {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j,
// 64 + tx*4 + j}, i, j < 4, of the tile in acc: the 16 lanes of a half-warp
// share their rows, so each row is folded with half-warp shuffles, straight
// from the registers.
__device__ __forceinline__ void fold_tile(
    float (&acc)[8][8], const float* __restrict__ bias, int tile, int v0,
    int row0, int tx, int ty, int rows, int V, int k,
    float* __restrict__ part_vals, int* __restrict__ part_ids,
    float* __restrict__ part_m, float* __restrict__ part_s, int kid) {
  // the partials: ceil(V / TV) tiles of every row
#define N_PART ((long long)((V + TV - 1) / TV) * rows)
  // Every lane runs every row (the shuffles need all 32 lanes); rows past
  // the edge are computed and not written.
  int col[8];
  float bcol[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = v0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    bcol[j] = (col[j] < V) VSRCIC_AND(
                  VSRCIC_IN(kid, kGlobal, kBBias, col[j], 1, V))
                  ? bias[col[j]]
                  : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    float x[8];
    int xk[8], xi[8];
    int mk = KEY_LOW;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = col[j] < V;
      x[j] = acc[i][j] + bcol[j];
      xk[j] = ok ? order_key(x[j]) : KEY_LOW;
      xi[j] = ok ? col[j] : NO_ID;
      mk = max(mk, xk[j]);
    }
    // the row's max by key: a sum's NaN is the card's canonical one (sign
    // clear), the largest key, so m is NaN if any value is
    const float m = key_value(half_max(mk));
    const float sh = lse_shift(m);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (xi[j] != NO_ID) s += expf(x[j] - sh);
    s = half_sum(s);
    const bool write = gr < rows && tx == 0;
    const size_t prow = (size_t)tile * rows + gr;
    if (write VSRCIC_AND(VSRCIC_IN(kid, kGlobal, kBPart, prow, 1, N_PART))) {
      part_m[prow] = m;
      part_s[prow] = s;
    }
    for (int q = 0; q < k; ++q) {
      int bk = KEY_LOW;
      int bi = NO_ID;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (better(xk[j], xi[j], bk, bi)) {
          bk = xk[j];
          bi = xi[j];
        }
      half_best(bk, bi);
      // drop the winner (a winner of NO_ID resets only empty slots)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (xi[j] == bi) {
          xk[j] = KEY_LOW;
          xi[j] = NO_ID;
        }
      if (write VSRCIC_AND(VSRCIC_IN(kid, kGlobal, kBPartK, prow * k + q, 1,
                                 N_PART * k))) {
        part_vals[prow * k + q] = key_value(bk);
        part_ids[prow * k + q] = bi;
      }
    }
  }
#undef N_PART
}

// f32 stage 1: each thread accumulates its 8 x 8 register tile of the logits
// in fold_tile's layout.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
vocab_tile_kernel(const float* __restrict__ h2, const T* __restrict__ w,
                  const float* __restrict__ bias, int rows, int R, int V,
                  int ldw, int k, float* __restrict__ part_vals,
                  int* __restrict__ part_ids, float* __restrict__ part_m,
                  float* __restrict__ part_s) {
  // two slices in flight: the loop computes on one while the next one's
  // global loads are held in registers (pads keep stores conflict-free)
  __shared__ __align__(16) float As[2][TK][TR + 4];   // h2 slice, transposed
  __shared__ __align__(16) float Bs[2][TK][TV + 4];   // weight slice (f32)

  const int tile = blockIdx.x;
  const int v0 = tile * TV;
  const int row0 = blockIdx.y * TR;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // this thread's share of one slice: 4 h2 values and 4 weights
  constexpr int A_PER = TR * TK / kThreads;
  constexpr int B_PER = TK * TV / kThreads;
  float ra[A_PER], rb[B_PER];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < A_PER; ++l) {
      const int idx = tid + l * kThreads;
      const int gr = row0 + idx / TK, gk = k0 + idx % TK;
      ra[l] = (gr < rows && gk < R) VSRCIC_AND(VSRCIC_IN(
                  kVocabTile, kGlobal, kBH2, (long long)gr * R + gk, 1,
                  (long long)rows * R))
                  ? h2[(size_t)gr * R + gk]
                  : 0.f;
    }
#pragma unroll
    for (int l = 0; l < B_PER; ++l) {
      const int gk = k0 + tid / 32;
      const int gc = v0 + (tid % 32) * B_PER + l;
      rb[l] = (gk < R && gc < V) VSRCIC_AND(VSRCIC_IN(
                  kVocabTile, kGlobal, kBW, (long long)gk * ldw + gc, 1,
                  (long long)(R - 1) * ldw + V))
                  ? to_f32(w[(size_t)gk * ldw + gc])
                  : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < A_PER; ++l) {
      const int idx = tid + l * kThreads;
      VSRCIC_DO(VSRCIC_IN(kVocabTile, kShared, kBAs,
                      (buf * TK + idx % TK) * (TR + 4) + idx / TK, 1,
                      2 * TK * (TR + 4)),
                As[buf][idx % TK][idx / TK] = ra[l]);
    }
    static_assert(B_PER == 4, "one float4 of weights per thread");
    VSRCIC_DO(VSRCIC_IN(kVocabTile, kShared, kBBs,
                    (buf * TK + tid / 32) * (TV + 4) + (tid % 32) * 4, 4,
                    2 * TK * (TV + 4)),
              *reinterpret_cast<float4*>(&Bs[buf][tid / 32][(tid % 32) * 4]) =
                  make_float4(rb[0], rb[1], rb[2], rb[3]));
  };
  // a float4 of slice row kk at column c of As or Bs (their pitches), 0
  // where the check drops it
#define SLICE4(S, P, bid, c)                                               \
  VSRCIC_LD(VSRCIC_IN(kVocabTile, kShared, bid,                            \
                      (buf * TK + kk) * (P) + (c), 4, 2 * TK * (P)),       \
            *reinterpret_cast<const float4*>(&S[buf][kk][c]),              \
            make_float4(0.f, 0.f, 0.f, 0.f))

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_k = (R + TK - 1) / TK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_k; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_k) load((t + 1) * TK);
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a0 = SLICE4(As, TR + 4, kBAs, ty * 4);
      const float4 a1 = SLICE4(As, TR + 4, kBAs, 64 + ty * 4);
      const float4 b0 = SLICE4(Bs, TV + 4, kBBs, tx * 4);
      const float4 b1 = SLICE4(Bs, TV + 4, kBBs, 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < n_k) store(buf ^ 1);
    __syncthreads();
  }

#undef SLICE4

  fold_tile(acc, bias, tile, v0, row0, tx, ty, rows, V, k, part_vals,
            part_ids, part_m, part_s, kVocabTile);
}

// bf16 stage 1 (tensor cores): shared-memory layout. Row pitches are padded
// by 16 bytes so that the 8 rows one ldmatrix phase reads fall in distinct
// banks; the f32 tile of the epilogue reuses the pipeline's buffers.
constexpr int BK = 32;                 // depth of one shared-memory slice
constexpr int A_PITCH = BK + 8;        // bf16 per h2 row (80 bytes)
constexpr int B_PITCH = TV + 8;        // bf16 per W_t row (272 bytes)
constexpr int C_PITCH = TV + 4;        // f32 per logits row (528 bytes)
constexpr int A_STAGE = TR * A_PITCH;  // bf16 per h2 slice
constexpr int B_STAGE = BK * B_PITCH;  // bf16 per W_t slice
constexpr int PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int TILE_BYTES = TR * C_PITCH * 4;
constexpr int BF16_SMEM = PIPE_BYTES > TILE_BYTES ? PIPE_BYTES : TILE_BYTES;
static_assert(TR * BK / 8 == 2 * kThreads && BK * TV / 8 == 2 * kThreads,
              "two 16-byte copies of each slice per thread");

// 8 bf16 elements start..start+7 of a row, those at or past `limit` zero,
// into 16 bytes of shared memory (rows that are not 16-byte aligned). The
// check: the row is element `at` of a tensor of `extent` elements (bound
// `bid`), dst lies within the first `smem` bytes from `base`.
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const unsigned short* row, int start,
                                      int limit, long long at,
                                      long long extent, int bid,
                                      const void* base, int dst_bid,
                                      long long smem) {
  uint32_t u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = start + 2 * e;
    const uint32_t lo =
        c < limit VSRCIC_AND(
                VSRCIC_IN(kVocabTileBf16, kGlobal, bid, at + c, 1, extent))
            ? row[c]
            : 0u;
    const uint32_t hi =
        c + 1 < limit VSRCIC_AND(VSRCIC_IN(kVocabTileBf16, kGlobal, bid,
                                           at + c + 1, 1, extent))
            ? row[c + 1]
            : 0u;
    u[e] = lo | (hi << 16);
  }
  VSRCIC_DO(VSRCIC_IN(kVocabTileBf16, kShared, dst_bid, soff(dst, base), 16,
                      smem),
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(u[0], u[1], u[2], u[3]));
}

// one slice: h2 rows row0.., depth k0..k0+BK; W_t depth k0.., columns v0..
// (W_t's rows ldw apart; element loads: rows need not be 16-byte aligned
// on this route). `base`: the dynamic shared memory (the checks)
__device__ __forceinline__ void load_slice(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* h2,
    const __nv_bfloat16* w, int row0, int v0, int k0, int rows, int R, int V,
    int ldw, int tid, const void* base) {
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int c = tid + l * kThreads;
    const int r = c >> 2, kc = (c & 3) * 8;
    const int gr = row0 + r;
    load8(as + r * A_PITCH + kc,
          reinterpret_cast<const unsigned short*>(h2) + (size_t)gr * R,
          k0 + kc, gr < rows ? R : 0, (long long)gr * R, (long long)rows * R,
          kBH2, base, kBAs, 2LL * A_STAGE * 2);
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int c = tid + l * kThreads;
    const int kr = c >> 4, nc = (c & 15) * 8;
    const int gk = k0 + kr;
    load8(bs + kr * B_PITCH + nc,
          reinterpret_cast<const unsigned short*>(w) + (size_t)gk * ldw,
          v0 + nc, gk < R ? V : 0, (long long)gk * ldw,
          (long long)(R - 1) * ldw + V, kBW,
          static_cast<const unsigned char*>(base) + 2 * A_STAGE * 2, kBBs,
          2LL * B_STAGE * 2);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 stage 1, mma.sync route (shapes TMA cannot describe): warp (wm, wn)
// = (warp / 4, warp % 4) accumulates rows wm*64.. and columns wn*32.. of
// the tile as 4 x 4 mma tiles of 16 x 8
__global__ void __launch_bounds__(kThreads, 2)
vocab_tile_bf16_kernel(const __nv_bfloat16* __restrict__ h2,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, int rows, int R, int V,
                       int ldw, int k, float* __restrict__ part_vals,
                       int* __restrict__ part_ids,
                       float* __restrict__ part_m,
                       float* __restrict__ part_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][TR][A_PITCH]
  __nv_bfloat16* Bs = As + 2 * A_STAGE;               // [2][BK][B_PITCH]
  auto* Cs = reinterpret_cast<float*>(smem);          // [TR][C_PITCH], last

  const int tile = blockIdx.x;
  const int v0 = tile * TV;
  const int row0 = blockIdx.y * TR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) >> 2;
  const int wn = (tid >> 5) & 3;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

#if VSRCIC_CHECKED
  if (tid == 0)
    (void)VSRCIC_IN(kVocabTileBf16, kShared, kBSmem, 0, BF16_SMEM,
                vsrcic_dynamic_smem());
#endif
  const int n_k = (R + BK - 1) / BK;
  load_slice(As, Bs, h2, w, row0, v0, 0, rows, R, V, ldw, tid, smem);
  for (int t = 0; t < n_k; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_k)
      load_slice(As + (buf ^ 1) * A_STAGE, Bs + (buf ^ 1) * B_STAGE, h2, w,
                 row0, v0, (t + 1) * BK, rows, R, V, ldw, tid, smem);
    __syncthreads();  // slice t is in place
    const __nv_bfloat16* as = As + buf * A_STAGE;
    const __nv_bfloat16* bs = Bs + buf * B_STAGE;
    // a lane's 16-byte row of an ldmatrix (a warp-wide instruction: a row
    // the check drops is read from the start of the region instead)
#define LDSM_ROW(p, region, bid, lo, bytes)                                \
  VSRCIC_LD(VSRCIC_IN(kVocabTileBf16, kShared, bid, soff(p, smem) - (lo),  \
                      16, bytes),                                          \
            p, region)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi],
                LDSM_ROW(as + (wm * 64 + mi * 16 + (lane & 15)) * A_PITCH +
                             kk + (lane >> 4) * 8,
                         As, kBAs, 0, 2LL * A_STAGE * 2));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(
            r, LDSM_ROW(bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 B_PITCH +
                            wn * 32 + nj * 16 + (lane >> 4) * 8,
                        Bs, kBBs, 2LL * A_STAGE * 2, 2LL * B_STAGE * 2));
        bf[2 * nj][0] = r[0];
        bf[2 * nj][1] = r[1];
        bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
    __syncthreads();  // before the next slice's copies overwrite buf
  }
#undef LDSM_ROW

  // the accumulators (c0, c1 at row lane/4, columns 2*(lane%4) + {0, 1};
  // c2, c3 eight rows below) into the f32 tile, then into fold_tile's layout
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 64 + mi * 16 + (lane >> 2);
      const int c = wn * 32 + ni * 8 + (lane & 3) * 2;
      VSRCIC_DO(VSRCIC_IN(kVocabTileBf16, kShared, kBCs, r * C_PITCH + c, 2,
                      TR * C_PITCH),
                *reinterpret_cast<float2*>(&Cs[r * C_PITCH + c]) =
                    make_float2(acc[mi][ni][0], acc[mi][ni][1]));
      VSRCIC_DO(VSRCIC_IN(kVocabTileBf16, kShared, kBCs,
                          (r + 8) * C_PITCH + c, 2, TR * C_PITCH),
                *reinterpret_cast<float2*>(&Cs[(r + 8) * C_PITCH + c]) =
                    make_float2(acc[mi][ni][2], acc[mi][ni][3]));
    }
  __syncthreads();
  const int tx = tid % 16;
  const int ty = tid / 16;
  float x[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const float4 x0 = VSRCIC_LD(
        VSRCIC_IN(kVocabTileBf16, kShared, kBCs, r * C_PITCH + tx * 4, 4,
              TR * C_PITCH),
        *reinterpret_cast<const float4*>(&Cs[r * C_PITCH + tx * 4]),
        make_float4(0.f, 0.f, 0.f, 0.f));
    const float4 x1 = VSRCIC_LD(
        VSRCIC_IN(kVocabTileBf16, kShared, kBCs, r * C_PITCH + 64 + tx * 4, 4,
              TR * C_PITCH),
        *reinterpret_cast<const float4*>(&Cs[r * C_PITCH + 64 + tx * 4]),
        make_float4(0.f, 0.f, 0.f, 0.f));
    x[i][0] = x0.x;
    x[i][1] = x0.y;
    x[i][2] = x0.z;
    x[i][3] = x0.w;
    x[i][4] = x1.x;
    x[i][5] = x1.y;
    x[i][6] = x1.z;
    x[i][7] = x1.w;
  }
  fold_tile(x, bias, tile, v0, row0, tx, ty, rows, V, k, part_vals, part_ids,
            part_m, part_s, kVocabTileBf16);
}

// ---------------------------------------------------------------------------
// stage 1 on the TMA routes: wgmma fed by TMA on bf16 planes of h2 and W_t
// (rows of 16 bytes' multiples, 16-byte aligned bases;
// ops/vocab_topk.py::vocab_launch_plan)
// ---------------------------------------------------------------------------
constexpr int T_BM = 128;                     // rows per tile
constexpr int T_BN = 256;                     // vocab columns per tile
constexpr int T_BN_SPLIT = 128;               // the split route's
constexpr int T_BK = 64;                      // depth per stage: 128 bytes
constexpr int T_A_BYTES = T_BM * T_BK * 2;    // h2 box (128 rows x 64)
constexpr int T_B_BOX = T_BK * 64 * 2;        // W_t box (64 deep x 64)
constexpr int T_THREADS = 384;  // consumer warpgroups 0, 1; producer 2
constexpr int T_CLUSTER = 2;    // CTAs of a cluster
constexpr int T_MIN_STAGES = 2;
constexpr int T_MAX_STAGES = 4;
constexpr int T_PLANES = 3;     // bf16 planes of a split f32 h2 or W_t

// the TMA kernel's tile width on pa planes of h2 and pb of W_t: T_BN on
// one of each, T_BN_SPLIT where either is split
__host__ __device__ constexpr int tma_tile_n(int pa, int pb) {
  return pa * pb == 1 ? T_BN : T_BN_SPLIT;
}

// bytes of a stage: the h2 box of each of pa planes and one depth of the
// tile's W_t on each of pb planes
__host__ __device__ constexpr int tma_stage_bytes(int pa, int pb) {
  return pa * T_A_BYTES + pb * (tma_tile_n(pa, pb) / 64) * T_B_BOX;
}

// dynamic shared bytes: 1024 of slack to align the ring, the stages, a
// full and an empty mbarrier per stage (ops/vocab_topk.py::_tma_smem)
constexpr int tma_smem_bytes(int stages, int pa, int pb) {
  return 1024 + stages * tma_stage_bytes(pa, pb) + 2 * 8 * stages;
}

// The order in which a stage sums the (h2 plane, W_t plane) products:
// plane 0 is hi, 1 mid, 2 lo, so a product weighs about 2^-8 (h + w) of
// hi x hi; the lightest come first, so that the sums stay small while
// they are small (PERF.md §6: lo before hi).
struct ProductOrder {
  int h[T_PLANES * T_PLANES], w[T_PLANES * T_PLANES];
};

__host__ __device__ constexpr ProductOrder product_order(int pa,
                                                          int pb) {
  ProductOrder o{};
  int q = 0;
  for (int sum = pa + pb - 2; sum >= 0; --sum)
    for (int h = pa - 1; h >= 0; --h)
      if (sum - h >= 0 && sum - h < pb) {
        o.h[q] = h;
        o.w[q] = sum - h;
        ++q;
      }
  return o;
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (the
// swizzle TMA writes): start address, leading and stride byte offsets in
// 16-byte units, layout type 1 (128B swizzle); base offset 0 (every box
// starts on a 1024-byte swizzle atom)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) = (scale ? d : 0) + A (64 x 16, K-major) * B (16 x 256,
// MN-major: W_t's V is contiguous, so B is taken transposed)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale));
}

// d (64 x 128, f32) = (scale ? d : 0) + A (64 x 16, K-major) * B (16 x 128,
// MN-major), as wgmma_m64n256k16
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b, int scale) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale));
}

// the product of the tile's width: 256 or 128 columns
template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2],
                                           uint64_t desc_a, uint64_t desc_b,
                                           int scale) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, desc_a, desc_b, scale);
  else
    wgmma_m64n128k16(d, desc_a, desc_b, scale);
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (~2 ulp; the logsumexp's sums only)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// quad (4 lanes sharing a row of the wgmma fragment) reductions
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void quad_best(int& key, int& col) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const int ok = __shfl_xor_sync(0xffffffffu, key, o);
    const int oc = __shfl_xor_sync(0xffffffffu, col, o);
    if (better(ok, oc, key, col)) {
      key = ok;
      col = oc;
    }
  }
}

// The fold of a consumer warpgroup's 64 x BN half of a tile (BN = 8 * NC
// columns: 256, or the split route's 128), read in place from its
// accumulators (bias added). Thread (warp w, lane l) holds two rows, r =
// 0, 1: rows w*16 + l/4 + 8*r of the half, each as 2 * NC values, index
// i = j*2 + e (j < NC, e < 2) at tile column j*8 + e + (l % 4)*2, in
// d[j*4 + r*2 + e] (the wgmma fragment). The four lanes of a quad hold a
// row's BN columns. Every pass is branch free and the two rows go side by
// side, so the fold issues independent instructions.
#define TILE_VAL(r, i) d[((i) >> 1) * 4 + (r) * 2 + ((i)&1)]

// best (key, index) of the 2^L leaves B.. in index order: a higher key
// wins, the lower index among equal keys (jax.lax.top_k's order in a
// lane). leaf(i, key, idx) gives leaf i's key and index, in index order.
template <int L, int B>
struct TreeBest {
  template <typename Leaf>
  __device__ __forceinline__ static void run(Leaf leaf, int& key, int& idx) {
    int k0, i0, k1, i1;
    TreeBest<L - 1, B>::run(leaf, k0, i0);
    TreeBest<L - 1, B + (1 << (L - 1))>::run(leaf, k1, i1);
    const bool right = k1 > k0;
    key = right ? k1 : k0;
    idx = right ? i1 : i0;
  }
};

template <int B>
struct TreeBest<0, B> {
  template <typename Leaf>
  __device__ __forceinline__ static void run(Leaf leaf, int& key, int& idx) {
    leaf(B, key, idx);
  }
};

// f(g) for a runtime g < NG (8 or 4), by a tree of selects (no indexed
// registers)
template <int NG, typename F>
__device__ __forceinline__ int select_group(int g, F f) {
  const bool b0 = g & 1, b1 = g & 2;
  const int a0 = b0 ? f(1) : f(0), a1 = b0 ? f(3) : f(2);
  if constexpr (NG == 4) {
    return b1 ? a1 : a0;
  } else {
    const bool b2 = g & 4;
    const int a2 = b0 ? f(5) : f(4), a3 = b0 ? f(7) : f(6);
    const int c0 = b1 ? a1 : a0, c1 = b1 ? a3 : a2;
    return b2 ? c1 : c0;
  }
}

// FULL: every column of the tile is below V (all tiles but the last)
template <bool FULL, int NC>
__device__ __forceinline__ void fold_tile_tma(
    float (&d)[NC * 4], int lane, int row0, int v0, int vt, int n_vt, int V,
    int rows, int k, float* __restrict__ part_vals,
    int* __restrict__ part_ids, float* __restrict__ part_m,
    float* __restrict__ part_s) {
  constexpr int NV = 2 * NC;     // values of a row in a lane
  constexpr int NG = NV / 8;     // groups of 8 of them
  constexpr int LG = NG == 8 ? 3 : 2;
  constexpr int NW = NV / 32;    // words of a taken mask
  static_assert(NC == 32 || NC == 16, "tiles of 256 or 128 columns");
  const int lc = (lane & 3) * 2;  // this lane's first column of a chunk
  // value i, at tile column (i / 2) * 8 + i % 2 + lc, is below V (always on
  // a FULL tile)
  const int lim = V - v0 - lc;
  auto in = [&](int i) { return FULL || (i >> 1) * 8 + (i & 1) < lim; };
  // each row's (max, sum of exp): the max ignores a NaN (fmaxf), which
  // reaches the sum instead and then makes m NaN too
  float m[2], s[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      mx = fmaxf(mx, in(i) ? TILE_VAL(r, i) : -INFINITY);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    m[r] = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  }
  constexpr float kLog2e = 1.4426950408889634f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float shl = lse_shift(m[r]) * kLog2e;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float e = ex2_ftz(fmaf(TILE_VAL(r, i), kLog2e, -shl));
      part[i & 3] += in(i) ? e : 0.f;
    }
    s[r] = quad_sum((part[0] + part[1]) + (part[2] + part[3]));
    if (s[r] != s[r]) m[r] = s[r];
  }
  // keys in place, KEY_LOW past V
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < NV; ++i)
      TILE_VAL(r, i) = __int_as_float(in(i) ? order_key(TILE_VAL(r, i))
                                            : KEY_LOW);
  const bool lead = (lane & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (lead && row < rows VSRCIC_AND(VSRCIC_IN(
                                 kVocabTma, kGlobal, kBPart,
                                 (long long)row * n_vt + vt, 1,
                                 (long long)rows * n_vt))) {
      part_m[(size_t)row * n_vt + vt] = m[r];
      part_s[(size_t)row * n_vt + vt] = s[r];
    }
  }
  // k rounds: each takes the best (key, lowest column) left in the quad.
  // A lane keeps the best of each group of 8 of its values (gk, gi) and a
  // mask of the values taken; a round runs the tree over the NG group
  // bests, and the lane that held the winner marks it taken and recomputes
  // only its group. A winner of KEY_LOW is no candidate (a column past V:
  // no sum gives a sign-set NaN).
  int gk[2][NG], gi[2][NG];
  uint32_t taken[2][NW];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int w = 0; w < NW; ++w) taken[r][w] = 0u;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      TreeBest<3, 0>::run(
          [&](int p, int& key, int& idx) {
            key = __float_as_int(TILE_VAL(r, g * 8 + p));
            idx = g * 8 + p;
          },
          gk[r][g], gi[r][g]);
  for (int q = 0; q < k; ++q) {
    int bk[2], bc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int bi;
      TreeBest<LG, 0>::run(
          [&](int g, int& key, int& idx) {
            key = gk[r][g];
            idx = gi[r][g];
          },
          bk[r], bi);
      bc[r] = (bi >> 1) * 8 + (bi & 1) + lc;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      quad_best(bk[r], bc[r]);
      const int row = row0 + 8 * r;
      if (lead && row < rows VSRCIC_AND(VSRCIC_IN(
                                   kVocabTma, kGlobal, kBPartK,
                                   ((long long)row * n_vt + vt) * k + q, 1,
                                   (long long)rows * n_vt * k))) {
        const size_t prow = (size_t)row * n_vt + vt;
        part_vals[prow * k + q] = key_value(bk[r]);
        part_ids[prow * k + q] = bk[r] == KEY_LOW ? NO_ID : v0 + bc[r];
      }
      // the winner in this lane's values, if it is this lane's
      const int c = bc[r] - lc;
      const bool mine = c >= 0 && (c & 7) < 2;
      const int i = (c >> 3) * 2 + (c & 7);
      if (mine && i < 32) taken[r][0] |= 1u << i;
      if (NW == 2 && mine && i >= 32) taken[r][NW - 1] |= 1u << (i - 32);
      // its group, recomputed from the values not taken
      const int g = mine ? i >> 3 : 0;
      const uint32_t word = NW == 1 || !(g & 4) ? taken[r][0]
                                                : taken[r][NW - 1];
      const uint32_t byte = (word >> ((g & 3) * 8)) & 0xffu;
      int nk, ni;
      TreeBest<3, 0>::run(
          [&](int p, int& key, int& idx) {
            const int v = select_group<NG>(g, [&](int h) {
              return __float_as_int(TILE_VAL(r, h * 8 + p));
            });
            key = (byte >> p) & 1u ? KEY_LOW : v;
            idx = p;
          },
          nk, ni);
#pragma unroll
      for (int h = 0; h < NG; ++h)
        if (mine && h == g) {
          gk[r][h] = nk;
          gi[r][h] = h * 8 + ni;
        }
    }
  }
}
#undef TILE_VAL

// the bias added to a tile's logits in a consumer thread's accumulators,
// once per column pair of this lane; FULL: every column below V
template <bool FULL, int BN>
__device__ __forceinline__ void add_bias(float (&acc)[BN / 2],
                                         const float* __restrict__ bias,
                                         int lane, int v0, int V) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = v0 + c * 8 + (lane & 3) * 2;
    const float b0 = (FULL || col < V) VSRCIC_AND(
                         VSRCIC_IN(kVocabTma, kGlobal, kBBias, col, 1, V))
                         ? __ldg(bias + col)
                         : 0.f;
    const float b1 = (FULL || col + 1 < V) VSRCIC_AND(
                         VSRCIC_IN(kVocabTma, kGlobal, kBBias, col + 1, 1, V))
                         ? __ldg(bias + col + 1)
                         : 0.f;
    acc[c * 4] += b0;
    acc[c * 4 + 1] += b1;
    acc[c * 4 + 2] += b0;
    acc[c * 4 + 3] += b1;
  }
}

// a tile's logits (without bias) in a consumer thread's accumulators: the
// bias added, then the fold
template <int BN>
__device__ __forceinline__ void finish_tile(
    float (&acc)[BN / 2], const float* __restrict__ bias, int lane,
    int row0, int vt, int n_vt, int V, int rows, int k,
    float* __restrict__ part_vals, int* __restrict__ part_ids,
    float* __restrict__ part_m, float* __restrict__ part_s) {
  const int v0 = vt * BN;
  if (v0 + BN <= V) {
    add_bias<true, BN>(acc, bias, lane, v0, V);
    fold_tile_tma<true, BN / 8>(acc, lane, row0, v0, vt, n_vt, V, rows, k,
                                part_vals, part_ids, part_m, part_s);
  } else {
    add_bias<false, BN>(acc, bias, lane, v0, V);
    fold_tile_tma<false, BN / 8>(acc, lane, row0, v0, vt, n_vt, V, rows, k,
                                 part_vals, part_ids, part_m, part_s);
  }
}

// a consumer warp's release of a slot: to every CTA of its cluster (of C,
// 1 or 2), whose producers all write into it
__device__ __forceinline__ void release(uint64_t* bar, int rank, int C) {
  mbar_arrive(bar);
  if (C > 1 VSRCIC_AND(VSRCIC_IN(kVocabTma, kDsmem, kBRank, rank ^ 1, 1,
                                 cluster_size())))
    mbar_arrive_remote(bar, rank ^ 1);
}

// Stage 1, TMA routes, on PA bf16 planes of h2 (tm_h2, (rows, depth)
// each) and PB of W_t (tm_w, (depth, V) each): PA 1 (bf16 h2) or T_PLANES
// (hi, mid, lo of a split f32 h2); PB 1 (a bf16 table) or T_PLANES (the
// split of an f32 table). Persistent clusters of C CTAs walk the (row
// block, vocab tile) list in groups of C tiles; cluster c takes groups p =
// c, c + clusters, ... Warpgroup 2's first thread fills a ring of
// `stages` slots with 64-deep stages, each the h2 box (128 rows x 64) of
// every plane and one depth of the tile's W_t (BN / 64 boxes of 64
// columns) on every plane, plane i of each in slot i. One plane of h2
// (C = T_CLUSTER): a group is C row blocks of one vocab tile (group p of
// n_rbg * n_vt is vocab tile p / n_rbg, row group p % n_rbg; rank m takes
// row block rbg * C + m), and each W_t box is copied by one CTA and
// multicast to all. Three planes of h2 (C = T_CLUSTER, or 1 where V is one
// tile): a group is C vocab tiles of one row block (group p of n_rb *
// n_vtg is row block p % n_rb, vocab tiles (p / n_rb) * C + m), and each
// CTA copies its share of the rows of every h2 box and multicasts it, its
// own W_t boxes alone: the h2 planes are the larger share of a stage, or
// an equal one. Either way the cluster reads what it shares from L2 once;
// a block past the rows or a tile past V is computed on TMA's zero fill
// and not written. A slot is refilled once every CTA it is written into
// has released it (empty: all eight consumer warps of each). Warpgroups 0
// and 1 compute rows 0-63 and 64-127 of the 128 x BN tile, PA x PB
// m64nBNk16 products per 16 of depth each, then fold their halves from
// their registers while the producer fills the ring with the next tile.
//
// The tensor cores' f32 sums truncate at the accumulator's scale, so a
// long sum into one accumulator drifts (toward zero, a fraction of its
// last place every product; PERF.md §6). BN 256 (bf16 h2 and table) sums
// the whole depth into its 128 accumulators. BN 128 (split planes, held to
// the f32 product) sums each stage's PA x PB products, the lightest first
// (product_order), into 64 fresh accumulators and adds them to a running
// total of 64 more with f32 adds, which round to nearest: each truncation
// is then at a 64-deep partial's scale, not the logit's.
template <int PA, int PB>
__global__ void __launch_bounds__(T_THREADS, 1)
vocab_tma_kernel(const __grid_constant__ CUtensorMap tm_h2,
                 const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ bias, int rows, int R, int V,
                 int k, int stages, float* __restrict__ part_vals,
                 int* __restrict__ part_ids, float* __restrict__ part_m,
                 float* __restrict__ part_s) {
  constexpr int BN = tma_tile_n(PA, PB);
  constexpr int STAGE = tma_stage_bytes(PA, PB);
  constexpr int NB = BN / 64;          // W_t boxes of a plane a stage
  constexpr int NACC = BN / 2;         // accumulators a thread
  constexpr bool TOTAL = PA * PB > 1;  // a running total (split planes)
  constexpr bool ALONG_V = PA > 1;     // clusters along the vocab
  constexpr ProductOrder ORD = product_order(PA, PB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;
  const int n_rb = (rows + T_BM - 1) / T_BM;
  const int C = ALONG_V ? (int)cluster_size() : T_CLUSTER;
  const int n_rbg = (n_rb + C - 1) / C;
  const int n_vt = (V + BN - 1) / BN;
  const int n_groups = ALONG_V ? n_rb * ((n_vt + C - 1) / C) : n_rbg * n_vt;
  const int n_k = (R + T_BK - 1) / T_BK;
  const int clusters = gridDim.x / C;
  const int cl = blockIdx.x / C;
  const int rank = (int)cluster_rank();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  // the checks: slot s of the ring and its barriers (s < stages), a box
  // or an operand of `bytes` at byte `off` of slot s within the ring
#define SLOT_OK(s) VSRCIC_IN(kVocabTma, kMbarrier, kBSlot, s, 1, stages)
#define BOX_OK(s, off, bytes)                                     \
  VSRCIC_IN(kVocabTma, kShared, kBBox, (s) * STAGE + (off), bytes, \
            stages * STAGE)

  if (threadIdx.x == 0) {
#if VSRCIC_CHECKED
    (void)VSRCIC_IN(kVocabTma, kShared, kBSmem, soff(ring, smem_raw),
                stages * STAGE + 2 * 8 * stages, vsrcic_dynamic_smem());
#endif
    for (int s = 0; s < stages; ++s) {
#if VSRCIC_CHECKED
      if (!SLOT_OK(s)) continue;
#endif
      mbar_init(&full[s], 1);  // the producer's arrival + the copies' bytes
      mbar_init(&empty[s], 8 * C);  // eight consumer warps of each CTA
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers exist before any copy or arrival

  if (wg == 2) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const uint16_t all = (1u << C) - 1;
      int g = 0;  // ring position: slot g % stages, pass g / stages
      for (int p = cl; p < n_groups; p += clusters) {
        const int rb = ALONG_V ? p % n_rb : (p % n_rbg) * C + rank;
        const int vt = ALONG_V ? p / n_rb * C + rank : p / n_rbg;
        for (int kb = 0; kb < n_k; ++kb, ++g) {
          const int s = g % stages;
#if VSRCIC_CHECKED
          // a slot the check refuses is neither waited on nor filled (its
          // consumers skip it too); a box it drops completes its bytes on
          // every barrier it was bound for (each CTA of `all` where it is
          // multicast)
          if (!SLOT_OK(s)) continue;
          auto drop = [&](uint32_t bytes, bool cast) {
            if (!cast) {
              mbar_complete_tx(&full[s], bytes);
              return;
            }
            for (int c = 0; c < C; ++c)
              mbar_complete_tx_remote(&full[s], (uint32_t)c, bytes);
          };
#endif
          mbar_wait(&empty[s], ((g / stages) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          unsigned char* a = ring + s * STAGE;
          unsigned char* b = a + PA * T_A_BYTES;
          if constexpr (ALONG_V) {
            // rows rank * 64.. of each plane's box to both CTAs (64-row
            // boxes: the 128-byte swizzle repeats every 8 rows), or the
            // whole box in a cluster of one (rank 0)
#pragma unroll
            for (int i = 0; i < PA; ++i) {
              void* dst = a + i * T_A_BYTES + rank * (T_A_BYTES / T_CLUSTER);
              const int y = rb * T_BM + rank * (T_BM / T_CLUSTER);
#if VSRCIC_CHECKED
              if (!BOX_OK(s, i * T_A_BYTES + rank * (T_A_BYTES / T_CLUSTER),
                          T_A_BYTES / C)) {
                drop(T_A_BYTES / C, C > 1);
                continue;
              }
#endif
              if (C == 1)
                tma_box_3d(dst, &tm_h2, kb * T_BK, y, i, &full[s]);
              else
                tma_box_3d_multicast(dst, &tm_h2, kb * T_BK, y, i, &full[s],
                                     all);
            }
#pragma unroll
            for (int j = 0; j < PB; ++j)
#pragma unroll
              for (int x = 0; x < NB; ++x) {
                void* dst = b + (j * NB + x) * T_B_BOX;
#if VSRCIC_CHECKED
                if (!BOX_OK(s, PA * T_A_BYTES + (j * NB + x) * T_B_BOX,
                            T_B_BOX)) {
                  drop(T_B_BOX, false);
                  continue;
                }
#endif
                if constexpr (PB == 1)
                  tma_box(dst, &tm_w, vt * BN + x * 64, kb * T_BK, &full[s]);
                else
                  tma_box_3d(dst, &tm_w, vt * BN + x * 64, kb * T_BK, j,
                             &full[s]);
              }
          } else {
#if VSRCIC_CHECKED
            if (!BOX_OK(s, 0, T_A_BYTES))
              drop(T_A_BYTES, false);
            else
#endif
              tma_box(a, &tm_h2, kb * T_BK, rb * T_BM, &full[s]);
            // box bx of the PB * NB: plane bx / NB, columns (bx % NB) * 64..
            constexpr int SHARE = PB * NB / T_CLUSTER;
#pragma unroll
            for (int x = 0; x < SHARE; ++x) {
              const int bx = rank * SHARE + x;
              void* dst = b + bx * T_B_BOX;
              const int col = vt * BN + (bx % NB) * 64;
#if VSRCIC_CHECKED
              if (!BOX_OK(s, PA * T_A_BYTES + bx * T_B_BOX, T_B_BOX)) {
                drop(T_B_BOX, true);
                continue;
              }
#endif
              if constexpr (PB == 1)
                tma_box_multicast(dst, &tm_w, col, kb * T_BK, &full[s], all);
              else
                tma_box_3d_multicast(dst, &tm_w, col, kb * T_BK, bx / NB,
                                     &full[s], all);
            }
          }
        }
      }
      // the last `stages` positions released everywhere: no CTA arrives on
      // this one's barriers once it may have exited
      for (int i = 0; i < stages; ++i, ++g)
        VSRCIC_DO(SLOT_OK(g % stages),
                  mbar_wait(&empty[g % stages], ((g / stages) & 1) ^ 1));
    }
  } else {
    // consumers: warpgroup wg takes rows wg*64.. of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (threadIdx.x >> 5) & 3;
    float d[NACC];              // the tile's sums, or (TOTAL) the stage's
    float t[TOTAL ? NACC : 1];  // the tile's running total (TOTAL)
    int g = 0;
    for (int p = cl; p < n_groups; p += clusters) {
      const int rb = ALONG_V ? p % n_rb : (p % n_rbg) * C + rank;
      const int vt = ALONG_V ? p / n_rb * C + rank : p / n_rbg;
      if constexpr (TOTAL) {
#pragma unroll
        for (int c = 0; c < NACC; ++c) t[c] = 0.f;
      }
      fence_acc(d);
      for (int kb = 0; kb < n_k; ++kb, ++g) {
        const int s = g % stages;
        // a slot the check refuses is skipped (its producer skips it too);
        // the test is the same in every thread of the warpgroup
        VSRCIC_DO(SLOT_OK(s), mbar_wait(&full[s], (g / stages) & 1));
        const uint32_t a = smem_addr(ring + s * STAGE) + wg * 64 * 128;
        const uint32_t b = smem_addr(ring + s * STAGE) + PA * T_A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < PA * PB; ++q)
#pragma unroll
          for (int kk = 0; kk < T_BK / 16; ++kk)
            // A: K-major, 8-row groups 1024 bytes apart, 16 deep = 32
            // bytes on; B: MN-major, 64-column boxes 8192 bytes apart,
            // 8-deep groups 1024 apart, 16 deep = 2048 bytes on
            VSRCIC_DO(
                SLOT_OK(s) &&
                    BOX_OK(s, wg * 64 * 128 + ORD.h[q] * T_A_BYTES,
                           64 * 128) &&
                    BOX_OK(s, PA * T_A_BYTES + ORD.w[q] * NB * T_B_BOX,
                           NB * T_B_BOX),
                wgmma_tile<BN>(
                    d, sw128_desc(a + ORD.h[q] * T_A_BYTES + kk * 32, 16,
                                  1024),
                    sw128_desc(b + ORD.w[q] * NB * T_B_BOX + kk * 2048,
                               T_B_BOX, 1024),
                    ((TOTAL ? 0 : kb) | q | kk) != 0));
        wgmma_commit();
        if constexpr (TOTAL) {
          wgmma_wait<0>();  // this stage's products are done
          fence_acc(d);
          if (lane == 0) VSRCIC_DO(SLOT_OK(s), release(&empty[s], rank, C));
#pragma unroll
          for (int c = 0; c < NACC; ++c) t[c] += d[c];
        } else {
          wgmma_wait<1>();  // the previous stage's products are done
          if (kb > 0 && lane == 0 VSRCIC_AND(SLOT_OK((g - 1) % stages)))
            release(&empty[(g - 1) % stages], rank, C);
        }
      }
      const int row0 = rb * T_BM + wg * 64 + warp * 16 + (lane >> 2);
      if constexpr (TOTAL) {
        if (vt < n_vt)
          finish_tile<BN>(t, bias, lane, row0, vt, n_vt, V, rows, k,
                          part_vals, part_ids, part_m, part_s);
      } else {
        wgmma_wait<0>();
        fence_acc(d);
        if (lane == 0 VSRCIC_AND(SLOT_OK((g - 1) % stages)))
          release(&empty[(g - 1) % stages], rank, C);
        finish_tile<BN>(d, bias, lane, row0, vt, n_vt, V, rows, k, part_vals,
                        part_ids, part_m, part_s);
      }
    }
  }
#undef SLOT_OK
#undef BOX_OK
}

// The exact split of an f32 value x into three bf16 values, x = hi + mid +
// lo (ops/vocab_topk.py::split_bf16x3_plain does the same bit for bit):
// hi is x rounded toward zero (its top 16 bits: never overflows), mid the
// same of x - hi, lo x - hi - mid rounded to nearest even. Both differences
// are exact in f32, and lo has at most 8 significant bits, so it is exact
// in bf16 wherever its exponent fits (|x| >= 2^-100; below, x loses less
// than 2^-133). A non-finite x goes whole into hi (a NaN stays a NaN, its
// sign kept), mid and lo 0. Returns the three bf16 bit patterns.
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const uint32_t u = __float_as_uint(x);
  if (!isfinite(x)) {
    h = (u >> 16) | (x != x ? 0x40u : 0u);
    m = l = 0u;
    return;
  }
  const float r1 = x - __uint_as_float(u & 0xffff0000u);
  const uint32_t u1 = __float_as_uint(r1);
  const uint32_t u2 = __float_as_uint(r1 - __uint_as_float(u1 & 0xffff0000u));
  h = u >> 16;
  m = u1 >> 16;
  l = (u2 + 0x7fffu + ((u2 >> 16) & 1u)) >> 16;
}

// f32 h2 (rows, R) -> bf16 planes (T_PLANES, rows, R8), R8 = R rounded up
// to 8, columns R..R8 zero: one thread a run of 8 columns of a row (two
// 16-byte loads where `vec`: R a multiple of 8, h2 16-byte aligned; one
// 16-byte store into each plane). Bound by bytes: 4 read and 6 written an
// entry.
__global__ void __launch_bounds__(kThreads)
vocab_split_kernel(const float* __restrict__ h2, int rows, int R, int R8,
                   bool vec, uint4* __restrict__ planes) {
  const int runs = R8 / 8;
  const size_t n = (size_t)rows * runs;
  const size_t plane = n;  // uint4 per plane
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(t / runs);
    const int c0 = (int)(t % runs) * 8;
    const float* row = h2 + (size_t)r * R;
    float x[8];
    if (vec) {
#define H2_8 \
  VSRCIC_IN(kVocabSplit, kGlobal, kBH2, (long long)r * R + c0, 8, \
        (long long)rows * R)
      const float4 x0 =
          VSRCIC_LD(H2_8, *reinterpret_cast<const float4*>(row + c0),
                    make_float4(0.f, 0.f, 0.f, 0.f));
      const float4 x1 =
          VSRCIC_LD(H2_8, *reinterpret_cast<const float4*>(row + c0 + 4),
                    make_float4(0.f, 0.f, 0.f, 0.f));
#undef H2_8
      x[0] = x0.x, x[1] = x0.y, x[2] = x0.z, x[3] = x0.w;
      x[4] = x1.x, x[5] = x1.y, x[6] = x1.z, x[7] = x1.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = c0 + e < R VSRCIC_AND(VSRCIC_IN(kVocabSplit, kGlobal, kBH2,
                                           (long long)r * R + c0 + e, 1,
                                           (long long)rows * R))
                   ? row[c0 + e]
                   : 0.f;
    }
    uint32_t hv[4], mv[4], lv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t h0, m0, l0, h1, m1, l1;
      split3(x[2 * e], h0, m0, l0);
      split3(x[2 * e + 1], h1, m1, l1);
      hv[e] = h0 | (h1 << 16);
      mv[e] = m0 | (m1 << 16);
      lv[e] = l0 | (l1 << 16);
    }
#define PLANES_OK \
  VSRCIC_IN(kVocabSplit, kGlobal, kBPlanes, 2 * plane + t, 1, 3 * plane)
    VSRCIC_DO(PLANES_OK, planes[t] = make_uint4(hv[0], hv[1], hv[2], hv[3]));
    VSRCIC_DO(PLANES_OK,
              planes[plane + t] = make_uint4(mv[0], mv[1], mv[2], mv[3]));
    VSRCIC_DO(PLANES_OK,
              planes[2 * plane + t] = make_uint4(lv[0], lv[1], lv[2], lv[3]));
#undef PLANES_OK
  }
}

__global__ void __launch_bounds__(kThreads)
vocab_merge_kernel(int rows, int k, int n_tiles, int by_row,
                   const float* __restrict__ part_vals,
                   const int* __restrict__ part_ids,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_s,
                   float* __restrict__ vals, int* __restrict__ ids,
                   float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  int lk[K_MAX], li[K_MAX];
#pragma unroll
  for (int j = 0; j < K_MAX; ++j) {
    lk[j] = KEY_LOW;
    li[j] = NO_ID;
  }
  float m = -INFINITY, s = 0.f;
#define N_PART ((long long)n_tiles * rows)
  for (int t = lane; t < n_tiles; t += 32) {
    const size_t prow =
        by_row ? (size_t)r * n_tiles + t : (size_t)t * rows + r;
#define PART_OK VSRCIC_IN(kVocabMerge, kGlobal, kBPart, prow, 1, N_PART)
#define PARTK_OK \
  VSRCIC_IN(kVocabMerge, kGlobal, kBPartK, prow * k + q, 1, N_PART * k)
    lse_combine(m, s, VSRCIC_LD(PART_OK, part_m[prow], 0.f),
                VSRCIC_LD(PART_OK, part_s[prow], 0.f));
    for (int q = 0; q < k; ++q) {
      int xk = order_key(VSRCIC_LD(PARTK_OK, part_vals[prow * k + q], 0.f));
      int xi = VSRCIC_LD(PARTK_OK, part_ids[prow * k + q], 0);
      if (!better(xk, xi, lk[K_MAX - 1], li[K_MAX - 1])) break;  // sorted
#pragma unroll
      for (int j = 0; j < K_MAX; ++j) {
        if (better(xk, xi, lk[j], li[j])) {
          const int tk = lk[j];
          const int ti = li[j];
          lk[j] = xk;
          li[j] = xi;
          xk = tk;
          xi = ti;
        }
      }
    }
  }
  warp_lse(m, s);
  for (int q = 0; q < k; ++q) {
    int bk = lk[0];
    int bi = li[0];
    warp_best(bk, bi);
    if (li[0] == bi) {  // ids are unique across lanes: pop the winner
#pragma unroll
      for (int j = 0; j < K_MAX - 1; ++j) {
        lk[j] = lk[j + 1];
        li[j] = li[j + 1];
      }
      lk[K_MAX - 1] = KEY_LOW;
      li[K_MAX - 1] = NO_ID;
    }
    if (lane == 0 VSRCIC_AND(VSRCIC_IN(kVocabMerge, kGlobal, kBOutK,
                                   (long long)r * k + q, 1,
                                   (long long)rows * k))) {
      vals[(size_t)r * k + q] = key_value(bk);
      ids[(size_t)r * k + q] = bi;
    }
  }
  if (lane == 0 VSRCIC_AND(VSRCIC_IN(kVocabMerge, kGlobal, kBLse, r, 1, rows)))
    lse[r] = lse_final(m, s);
#undef N_PART
#undef PART_OK
#undef PARTK_OK
}

// stage 2 (both operand types): partials (tile, row) or, `by_row`, (row,
// tile)
cudaError_t merge(int rows, int k, int n_tiles, bool by_row,
                  const float* part_vals, const int* part_ids,
                  const float* part_m, const float* part_s, float* vals,
                  int* ids, float* lse, cudaStream_t stream) {
  vocab_merge_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      rows, k, n_tiles, by_row, part_vals, part_ids, part_m, part_s, vals,
      ids, lse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* h2, const void* w, const float* bias,
                   int rows, int R, int V, int ldw, int k, float* part_vals,
                   int* part_ids, float* part_m, float* part_s, float* vals,
                   int* ids, float* lse, cudaStream_t stream) {
  const int n_tiles = (V + TV - 1) / TV;
  const dim3 grid1(n_tiles, (rows + TR - 1) / TR);
  vocab_tile_kernel<T><<<grid1, kThreads, 0, stream>>>(
      h2, static_cast<const T*>(w), bias, rows, R, V, ldw, k, part_vals,
      part_ids, part_m, part_s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge(rows, k, n_tiles, false, part_vals, part_ids, part_m, part_s,
               vals, ids, lse, stream);
}

// the bf16 entry point's mma.sync route (ops/vocab_topk.py::
// vocab_launch_plan); returns the launch's error
cudaError_t launch_bf16_mma_sync(const __nv_bfloat16* h2,
                                 const __nv_bfloat16* w, const float* bias,
                                 int rows, int R, int V, int ldw, int k,
                                 float* part_vals, int* part_ids,
                                 float* part_m, float* part_s,
                                 cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        vocab_tile_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BF16_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid1((V + TV - 1) / TV, (rows + TR - 1) / TR);
  vocab_tile_bf16_kernel<<<grid1, kThreads, BF16_SMEM, stream>>>(
      h2, w, bias, rows, R, V, ldw, k, part_vals, part_ids, part_m, part_s);
  return cudaGetLastError();
}

// the cluster launch of the TMA routes' kernel: clusters of `cluster` CTAs
cudaLaunchConfig_t tma_config(int grid, int cluster, int smem,
                              cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(T_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int PA, int PB>
cudaError_t set_tma_smem(int smem) {
  static int smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        vocab_tma_kernel<PA, PB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  return cudaSuccess;
}

// f(integral_constant PA, integral_constant PB) for the kernel's four
// instances (pa, pb in {1, T_PLANES})
template <typename F>
cudaError_t on_planes(int pa, int pb, F f) {
  using One = std::integral_constant<int, 1>;
  using Three = std::integral_constant<int, T_PLANES>;
  if (pa == 1) return pb == 1 ? f(One{}, One{}) : f(One{}, Three{});
  return pb == 1 ? f(Three{}, One{}) : f(Three{}, Three{});
}

// h2: PA (rows, R8) bf16 planes (R8 = R on one plane, R rounded up to 8 on
// the split's three); w: PB (R, V) bf16 planes, rows ldw apart (one plane:
// a table's rows; three: vsrcic_vocab_split's (3, R, ldw) of an f32 table)
template <int PA, int PB>
cudaError_t launch_tma(const __nv_bfloat16* h2, const __nv_bfloat16* w,
                       const float* bias, int rows, int R, int V, int ldw,
                       int k, int stages, int cluster, int grid, int smem,
                       float* part_vals, int* part_ids, float* part_m,
                       float* part_s, cudaStream_t stream) {
  cudaError_t e = set_tma_smem<PA, PB>(smem);
  if (e != cudaSuccess) return e;
  CUtensorMap tm_h2, tm_w;
  const int R8 = PA == 1 ? R : (R + 7) / 8 * 8;
  // the split's planes: each CTA of a cluster copies its share of a box's
  // rows
  // the extents the entry point's contract states: h2's PA planes of (rows,
  // R8), contiguous; W_t's rows ldw apart, or its (PB, R, ldw) planes
  const long long w_extent =
      PB == 1 ? (long long)(R - 1) * ldw + V : (long long)PB * R * ldw;
  if (!encode_planes(&tm_h2, h2, 2, PA, rows, R8,
                     PA == 1 ? T_BM : T_BM / cluster, T_BK, kVocabTma,
                     kBMapH2, 2LL * PA * rows * R8,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_planes(&tm_w, w, 2, PB, R, V, T_BK, 64, kVocabTma, kBMapW,
                     2 * w_extent, CU_TENSOR_MAP_SWIZZLE_128B, ldw))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tma_config(grid, cluster, smem, stream,
                                            &attr);
  e = cudaLaunchKernelEx(&cfg, vocab_tma_kernel<PA, PB>, tm_h2, tm_w, bias,
                         rows, R, V, k, stages, part_vals, part_ids, part_m,
                         part_s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// f32 h2 (rows, R) and W_t (R, V) of bf16 or f32 (`table_bf16`), rows ldw
// apart: the SGEMM (ops/vocab_topk.py::vocab_launch_plan's "sgemm", for
// operands TMA cannot describe)
extern "C" int vsrcic_vocab_topk(const void* h2, const void* w,
                                 const void* bias, int table_bf16, int rows,
                                 int R, int V, int ldw, int k,
                                 void* part_vals, void* part_ids,
                                 void* part_m, void* part_s, void* vals,
                                 void* ids, void* lse, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (k < 1 || k > K_MAX || k > V || rows < 1 || R < 1 || ldw < V)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto fh2 = static_cast<const float*>(h2);
  auto fb = static_cast<const float*>(bias);
  auto pv = static_cast<float*>(part_vals);
  auto pi = static_cast<int*>(part_ids);
  auto pm = static_cast<float*>(part_m);
  auto ps = static_cast<float*>(part_s);
  auto ov = static_cast<float*>(vals);
  auto oi = static_cast<int*>(ids);
  auto ol = static_cast<float*>(lse);
  cudaError_t e =
      table_bf16
          ? launch<__nv_bfloat16>(fh2, w, fb, rows, R, V, ldw, k, pv, pi, pm,
                                  ps, ov, oi, ol, s)
          : launch<float>(fh2, w, fb, rows, R, V, ldw, k, pv, pi, pm, ps, ov,
                          oi, ol, s);
  return (int)e;
}

// f32 h2 (rows, R) -> bf16 planes (3, rows, R8), R8 = R rounded up to 8
// (vocab_split_kernel); `planes` 16-byte aligned
extern "C" int vsrcic_vocab_split(const void* h2, int rows, int R,
                                  void* planes, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (rows < 1 || R < 1 || reinterpret_cast<uintptr_t>(planes) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int R8 = (R + 7) / 8 * 8;
  const size_t runs = (size_t)rows * (R8 / 8);
  const size_t blocks = (runs + kThreads - 1) / kThreads;
  vocab_split_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h2), rows, R, R8,
      R % 8 == 0 && reinterpret_cast<uintptr_t>(h2) % 16 == 0,
      static_cast<uint4*>(planes));
  return (int)cudaGetLastError();
}

// bf16 planes of h2 and W_t (R, V), W_t's rows ldw apart, by the route of
// ops/vocab_topk.py::vocab_launch_plan: route 1 (TMA and wgmma; W_t's
// rows a multiple of 8 apart, its base 16-byte aligned) on `planes` bf16
// planes of h2 and `w_planes` of W_t, each 1 or T_PLANES: h2 a bf16 (rows,
// R) (R a multiple of 8, 16-byte aligned) or the split of an f32 h2,
// vsrcic_vocab_split's (3, rows, R8); W_t a bf16 table or the split of an
// f32 one, (3, R, ldw); tiles of T_BN columns on one plane of each, else
// T_BN_SPLIT; `stages` ring slots on `grid` persistent CTAs in clusters of
// `cluster` (T_CLUSTER; 1 also on three planes of h2), `smem` dynamic
// shared bytes a CTA; route 0 (mma.sync, one plane of each; tiles of TV
// columns) with the grid and shared bytes it fixes and no cluster (1); a
// plan that differs is refused. `tile_n` is the route's vocab columns per
// tile (partials per row: ceil(V / tile_n)). The rest as
// vsrcic_vocab_topk.
extern "C" int vsrcic_vocab_topk_bf16(const void* h2, const void* w,
                                      const void* bias, int rows, int R,
                                      int V, int ldw, int k, int route,
                                      int tile_n, int planes, int w_planes,
                                      int stages, int cluster, int grid,
                                      int smem, void* part_vals,
                                      void* part_ids, void* part_m,
                                      void* part_s, void* vals, void* ids,
                                      void* lse, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  auto valid = [](int p) { return p == 1 || p == T_PLANES; };
  if (k < 1 || k > K_MAX || k > V || rows < 1 || R < 1 || ldw < V ||
      (route != 0 && route != 1) || !valid(planes) || !valid(w_planes) ||
      (route == 0 && planes * w_planes != 1) ||
      tile_n != (route ? tma_tile_n(planes, w_planes) : TV))
    return (int)cudaErrorInvalidValue;
  const int n_rb = (rows + TR - 1) / TR;
  const int n_vt = (V + tile_n - 1) / tile_n;
  static_assert(T_BM == TR, "both routes tile 128 rows");
  const bool tma_ok = (planes > 1 || R % 8 == 0) && ldw % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(h2) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  // the groups of `cluster` tiles: row blocks of one vocab tile on one
  // plane of h2 (clusters of T_CLUSTER), vocab tiles of one row block on
  // three (clusters of T_CLUSTER or 1)
  const bool along_v = planes > 1;
  const bool cluster_ok = cluster == T_CLUSTER || (along_v && cluster == 1);
  const int groups = along_v ? n_rb * ((n_vt + cluster - 1) / cluster)
                             : (n_rb + cluster - 1) / cluster * n_vt;
  if ((route == 1 &&
       (!tma_ok || stages < T_MIN_STAGES || stages > T_MAX_STAGES ||
        !cluster_ok || grid < cluster || grid % cluster != 0 ||
        grid / cluster > groups ||
        smem != tma_smem_bytes(stages, planes, w_planes))) ||
      (route == 0 &&
       (grid != n_rb * n_vt || smem != BF16_SMEM || cluster != 1)))
    return (int)cudaErrorInvalidValue;
  auto bh2 = static_cast<const __nv_bfloat16*>(h2);
  auto bw = static_cast<const __nv_bfloat16*>(w);
  auto fb = static_cast<const float*>(bias);
  auto pv = static_cast<float*>(part_vals);
  auto pi = static_cast<int*>(part_ids);
  auto pm = static_cast<float*>(part_m);
  auto ps = static_cast<float*>(part_s);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == 0)
    e = launch_bf16_mma_sync(bh2, bw, fb, rows, R, V, ldw, k, pv, pi, pm, ps,
                             s);
  else
    e = on_planes(planes, w_planes, [&](auto pa, auto pb) {
      return launch_tma<decltype(pa)::value, decltype(pb)::value>(
          bh2, bw, fb, rows, R, V, ldw, k, stages, cluster, grid, smem, pv,
          pi, pm, ps, s);
    });
  if (e != cudaSuccess) return (int)e;
  return (int)merge(rows, k, n_vt, route == 1, pv, pi, pm, ps,
                    static_cast<float*>(vals), static_cast<int*>(ids),
                    static_cast<float*>(lse), s);
}

// the clusters of T_CLUSTER TMA-kernel CTAs of `smem` dynamic shared
// bytes on `planes` h2 planes and `w_planes` W_t planes that the card holds
// at once (the launch plan's grid)
extern "C" int vsrcic_vocab_tma_clusters(int smem, int planes, int w_planes,
                                         int* out) {
  cudaGetLastError();
  if ((planes != 1 && planes != T_PLANES) ||
      (w_planes != 1 && w_planes != T_PLANES))
    return (int)cudaErrorInvalidValue;
  const int stages =
      (smem - 1024) / (tma_stage_bytes(planes, w_planes) + 16);
  if (stages < T_MIN_STAGES || stages > T_MAX_STAGES ||
      smem != tma_smem_bytes(stages, planes, w_planes))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = tma_config(T_CLUSTER, T_CLUSTER, smem, 0,
                                            &attr);
  return (int)on_planes(planes, w_planes, [&](auto pa, auto pb) {
    constexpr int PA = decltype(pa)::value, PB = decltype(pb)::value;
    cudaError_t e = set_tma_smem<PA, PB>(smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveClusters(out, vocab_tma_kernel<PA, PB>,
                                          &cfg);
  });
}

extern "C" const char* vsrcic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

VSRCIC_CHECK_RECORDS(vocab)
