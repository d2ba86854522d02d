// Fused vocab head: logits = h2 @ W_t + b, per-row top-k and logsumexp,
// without writing the (rows, V) logits to device memory.
//
// Replaces the TPU kernel vsrcic_tpu/ops/vocab_topk.py
// (make_vocab_topk_lse: `kernel` :116 and the default two-stage `kernel2`
// :159, pallas_call :220).
//
// What bounds it on the H100: f32 operations. The product is 2*rows*R*V
// flops (102 GFLOP at rows 5120, R 1000, V 10000) against ~40 MB of
// operands, and it must run in full f32 on the CUDA cores: the JAX path
// multiplies the f32 h2 by the upcast weights with f32 accumulation, and
// TF32 or a bf16 rounding of h2 would change the numbers.
//
// Design: the TPU grid carried running top-k/lse state from one vocab tile
// to the next; CUDA blocks run in no order, so the work is split in two
// launches.
//   Stage 1: a CTA computes a 128-row x 128-column logits tile as a tiled
//     f32 SGEMM (8-deep slices of h2 and W through double-buffered shared
//     memory, the next slice's loads in flight during the current one's
//     products; an 8x8 register tile per thread, bf16 weights upcast on
//     load) and folds each row of it, from the registers, into that tile's
//     partial top-k and (max, sum of exp) pair.
//   Stage 2: one warp per row merges the partials of all vocab tiles.
// Every comparison orders by (value descending, vocab id ascending), which
// is jax.lax.top_k's rule. Every logit is summed over R in the same order,
// so duplicated weight columns give bit-equal logits and tie exactly. The
// ragged edges of rows, R and V are masked in the kernel: a column past V
// is never a candidate and adds nothing to the sum.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TR = 128;       // rows per CTA
constexpr int TV = 128;       // vocab columns per CTA (ops/vocab_topk.TILE_V)
constexpr int TK = 8;         // depth of one shared-memory slice
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int K_MAX = 16;     // ops/vocab_topk.K_MAX
constexpr int NO_ID = 0x7fffffff;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (value descending, id ascending)
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// warp-wide best (value, id) pair
__device__ __forceinline__ void warp_best(float& v, int& id) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, id, o);
    if (better(ov, oi, v, id)) {
      v = ov;
      id = oi;
    }
  }
}

// combine two (max, sum of exp(x - max)) pairs; s == 0 marks an empty pair
__device__ __forceinline__ void lse_combine(float& m, float& s, float om,
                                            float os) {
  const float nm = fmaxf(m, om);
  const float a = (s == 0.f) ? 0.f : s * expf(m - nm);
  const float b = (os == 0.f) ? 0.f : os * expf(om - nm);
  m = nm;
  s = a + b;
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
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void half_best(float& v, int& id) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, id, o);
    if (better(ov, oi, v, id)) {
      v = ov;
      id = oi;
    }
  }
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns rows {ty*4 + i, 64 + ty*4 + i}
// and columns {tx*4 + j, 64 + tx*4 + j}, i, j < 4: an 8 x 8 register tile.
// The 16 lanes of a half-warp share their rows, so each row of the logits
// tile is folded with half-warp shuffles, straight from the registers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
vocab_tile_kernel(const float* __restrict__ h2, const T* __restrict__ w,
                  const float* __restrict__ bias, int rows, int R, int V,
                  int k, float* __restrict__ part_vals,
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
      ra[l] = (gr < rows && gk < R) ? h2[(size_t)gr * R + gk] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < B_PER; ++l) {
      const int gk = k0 + tid / 32;
      const int gc = v0 + (tid % 32) * B_PER + l;
      rb[l] = (gk < R && gc < V) ? to_f32(w[(size_t)gk * V + gc]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int l = 0; l < A_PER; ++l) {
      const int idx = tid + l * kThreads;
      As[buf][idx % TK][idx / TK] = ra[l];
    }
    static_assert(B_PER == 4, "one float4 of weights per thread");
    *reinterpret_cast<float4*>(&Bs[buf][tid / 32][(tid % 32) * 4]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

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
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
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

  // fold each row into the tile's partial top-k and (max, sumexp). Every
  // lane runs every row (the shuffles need all 32 lanes); rows past the
  // edge are computed and not written.
  int col[8];
  float bcol[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = v0 + ((j < 4) ? tx * 4 + j : 64 + tx * 4 + (j - 4));
    bcol[j] = (col[j] < V) ? bias[col[j]] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + ((i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    float x[8];
    int xi[8];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool ok = col[j] < V;
      x[j] = ok ? acc[i][j] + bcol[j] : -INFINITY;
      xi[j] = ok ? col[j] : NO_ID;
      if (ok) m = fmaxf(m, x[j]);
    }
    m = half_max(m);   // every row has a valid column in some lane
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (xi[j] != NO_ID) s += expf(x[j] - m);
    s = half_sum(s);
    const bool write = gr < rows && tx == 0;
    const size_t prow = (size_t)tile * rows + gr;
    if (write) {
      part_m[prow] = m;
      part_s[prow] = s;
    }
    for (int q = 0; q < k; ++q) {
      float bv = -INFINITY;
      int bi = NO_ID;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (better(x[j], xi[j], bv, bi)) {
          bv = x[j];
          bi = xi[j];
        }
      half_best(bv, bi);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (xi[j] == bi && bi != NO_ID) {
          x[j] = -INFINITY;
          xi[j] = NO_ID;
        }
      if (write) {
        part_vals[prow * k + q] = bv;
        part_ids[prow * k + q] = bi;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
vocab_merge_kernel(int rows, int k, int n_tiles,
                   const float* __restrict__ part_vals,
                   const int* __restrict__ part_ids,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_s,
                   float* __restrict__ vals, int* __restrict__ ids,
                   float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  float lv[K_MAX];
  int li[K_MAX];
#pragma unroll
  for (int j = 0; j < K_MAX; ++j) {
    lv[j] = -INFINITY;
    li[j] = NO_ID;
  }
  float m = -INFINITY, s = 0.f;
  for (int t = lane; t < n_tiles; t += 32) {
    const size_t prow = (size_t)t * rows + r;
    lse_combine(m, s, part_m[prow], part_s[prow]);
    for (int q = 0; q < k; ++q) {
      float x = part_vals[prow * k + q];
      int xi = part_ids[prow * k + q];
      if (!better(x, xi, lv[K_MAX - 1], li[K_MAX - 1])) break;  // sorted
#pragma unroll
      for (int j = 0; j < K_MAX; ++j) {
        if (better(x, xi, lv[j], li[j])) {
          const float tv = lv[j];
          const int ti = li[j];
          lv[j] = x;
          li[j] = xi;
          x = tv;
          xi = ti;
        }
      }
    }
  }
  warp_lse(m, s);
  for (int q = 0; q < k; ++q) {
    float bv = lv[0];
    int bi = li[0];
    warp_best(bv, bi);
    if (li[0] == bi) {  // ids are unique across lanes: pop the winner
#pragma unroll
      for (int j = 0; j < K_MAX - 1; ++j) {
        lv[j] = lv[j + 1];
        li[j] = li[j + 1];
      }
      lv[K_MAX - 1] = -INFINITY;
      li[K_MAX - 1] = NO_ID;
    }
    if (lane == 0) {
      vals[(size_t)r * k + q] = bv;
      ids[(size_t)r * k + q] = bi;
    }
  }
  if (lane == 0) lse[r] = m + logf(s);
}

template <typename T>
cudaError_t launch(const float* h2, const void* w, const float* bias,
                   int rows, int R, int V, int k, float* part_vals,
                   int* part_ids, float* part_m, float* part_s, float* vals,
                   int* ids, float* lse, cudaStream_t stream) {
  const int n_tiles = (V + TV - 1) / TV;
  const dim3 grid1(n_tiles, (rows + TR - 1) / TR);
  vocab_tile_kernel<T><<<grid1, kThreads, 0, stream>>>(
      h2, static_cast<const T*>(w), bias, rows, R, V, k, part_vals, part_ids,
      part_m, part_s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  vocab_merge_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      rows, k, n_tiles, part_vals, part_ids, part_m, part_s, vals, ids, lse);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vsrcic_vocab_topk(const void* h2, const void* w,
                                 const void* bias, int table_bf16, int rows,
                                 int R, int V, int k, void* part_vals,
                                 void* part_ids, void* part_m, void* part_s,
                                 void* vals, void* ids, void* lse,
                                 void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (k < 1 || k > K_MAX || k > V || rows < 1 || R < 1)
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
          ? launch<__nv_bfloat16>(fh2, w, fb, rows, R, V, k, pv, pi, pm, ps,
                                  ov, oi, ol, s)
          : launch<float>(fh2, w, fb, rows, R, V, k, pv, pi, pm, ps, ov, oi,
                          ol, s);
  return (int)e;
}

extern "C" const char* vsrcic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
