// Fused vocab head: logits = h2 @ W_t + b, per-row top-k and logsumexp,
// without writing the (rows, V) logits to device memory.
//
// Replaces the TPU kernel vsrcic_tpu/ops/vocab_topk.py
// (make_vocab_topk_lse: `kernel` :116 and the default two-stage `kernel2`
// :159, pallas_call :220), in both of its operand configurations:
//
//   vsrcic_vocab_topk: f32 h2 (lhs_dtype=float32, the default). What bounds
//     it on the H100: f32 operations. The product is 2*rows*R*V flops
//     (102 GFLOP at rows 5120, R 1000, V 10000) against ~40 MB of operands,
//     and it must run in full f32 on the CUDA cores: the JAX path multiplies
//     the f32 h2 by the upcast weights with f32 accumulation, and TF32 or a
//     bf16 rounding of h2 would change the numbers.
//   vsrcic_vocab_topk_bf16: bf16 h2 and bf16 W_t (make_vocab_topk_lse
//     (lhs_dtype=jnp.bfloat16), :47, selected by VSRCIC_VOCAB_LHS_BF16=1 on
//     bf16 tables), products accumulated in f32. What bounds it: tensor-core
//     operations, the same 102 GFLOP over 989 TFLOP/s (0.1035 ms) against
//     ~30 MB over 3.35 TB/s (0.009 ms). A bf16 x bf16 product is exact in
//     f32, so this is the f32-operand function of the bf16-rounded h2; only
//     the order of the f32 sums differs from a sequential loop. Identical
//     inputs give identical mma outputs at every position of the tile, so
//     duplicated weight columns still give bit-equal logits and tie
//     exactly.
//
// Design: the TPU grid carried running top-k/lse state from one vocab tile
// to the next; CUDA blocks run in no order, so the work is split in two
// launches.
//   Stage 1: a CTA computes a 128-row x 128-column logits tile and folds
//     each row of it into that tile's partial top-k and (max, sum of exp)
//     pair. f32: a tiled SGEMM (8-deep slices of h2 and W through
//     double-buffered shared memory, the next slice's loads in flight during
//     the current one's products; an 8x8 register tile per thread, bf16
//     weights upcast on load), folded straight from the registers. bf16:
//     32-deep slices of h2 and W_t brought into double-buffered shared
//     memory by cp.async (16-byte copies, zero-filled past R, rows and V;
//     element loads where a row is not 16-byte aligned), fed to
//     mma.sync.m16n8k16 (bf16 in, f32 accumulators) by ldmatrix (.trans for
//     W_t, whose V is contiguous); each of the 8 warps owns a 64 x 32 block
//     of the tile. The accumulators then go through shared memory into the
//     f32 kernel's register layout and the same fold.
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
    float* __restrict__ part_m, float* __restrict__ part_s) {
  // Every lane runs every row (the shuffles need all 32 lanes); rows past
  // the edge are computed and not written.
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

// f32 stage 1: each thread accumulates its 8 x 8 register tile of the logits
// in fold_tile's layout.
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

  fold_tile(acc, bias, tile, v0, row0, tx, ty, rows, V, k, part_vals,
            part_ids, part_m, part_s);
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for every committed group but the newest
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 8 bf16 elements start..start+7 of a row, those at or past `limit` zero,
// into 16 bytes of shared memory (rows that are not 16-byte aligned)
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const unsigned short* row, int start,
                                      int limit) {
  uint32_t u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = start + 2 * e;
    const uint32_t lo = c < limit ? row[c] : 0u;
    const uint32_t hi = c + 1 < limit ? row[c + 1] : 0u;
    u[e] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
}

// one slice: h2 rows row0.., depth k0..k0+BK; W_t depth k0.., columns v0..
// VEC: every row is 16-byte aligned (R, V multiples of 8, aligned bases), so
// a 16-byte chunk is wholly inside or wholly past each edge
template <bool VEC>
__device__ __forceinline__ void load_slice(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* h2,
    const __nv_bfloat16* w, int row0, int v0, int k0, int rows, int R, int V,
    int tid) {
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int c = tid + l * kThreads;
    const int r = c >> 2, kc = (c & 3) * 8;
    const int gr = row0 + r, gk = k0 + kc;
    __nv_bfloat16* dst = as + r * A_PITCH + kc;
    if (VEC) {
      const bool ok = gr < rows && gk < R;
      cp_async16(dst, ok ? h2 + (size_t)gr * R + gk : h2, ok);
    } else {
      load8(dst, reinterpret_cast<const unsigned short*>(h2) + (size_t)gr * R,
            gk, gr < rows ? R : 0);
    }
  }
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int c = tid + l * kThreads;
    const int kr = c >> 4, nc = (c & 15) * 8;
    const int gk = k0 + kr, gc = v0 + nc;
    __nv_bfloat16* dst = bs + kr * B_PITCH + nc;
    if (VEC) {
      const bool ok = gk < R && gc < V;
      cp_async16(dst, ok ? w + (size_t)gk * V + gc : w, ok);
    } else {
      load8(dst, reinterpret_cast<const unsigned short*>(w) + (size_t)gk * V,
            gc, gk < R ? V : 0);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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

// bf16 stage 1: warp (wm, wn) = (warp / 4, warp % 4) accumulates rows
// wm*64.. and columns wn*32.. of the tile as 4 x 4 mma tiles of 16 x 8
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
vocab_tile_bf16_kernel(const __nv_bfloat16* __restrict__ h2,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias, int rows, int R, int V,
                       int k, float* __restrict__ part_vals,
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

  const int n_k = (R + BK - 1) / BK;
  load_slice<VEC>(As, Bs, h2, w, row0, v0, 0, rows, R, V, tid);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_k)
      load_slice<VEC>(As + (buf ^ 1) * A_STAGE, Bs + (buf ^ 1) * B_STAGE, h2,
                      w, row0, v0, (t + 1) * BK, rows, R, V, tid);
    cp_async_commit();     // (an empty group on the last slice)
    cp_async_wait_prev();  // slice t has landed
    __syncthreads();
    const __nv_bfloat16* as = As + buf * A_STAGE;
    const __nv_bfloat16* bs = Bs + buf * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * A_PITCH + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  B_PITCH +
                             wn * 32 + nj * 16 + (lane >> 4) * 8);
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

  // the accumulators (c0, c1 at row lane/4, columns 2*(lane%4) + {0, 1};
  // c2, c3 eight rows below) into the f32 tile, then into fold_tile's layout
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = wm * 64 + mi * 16 + (lane >> 2);
      const int c = wn * 32 + ni * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(&Cs[r * C_PITCH + c]) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(&Cs[(r + 8) * C_PITCH + c]) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  const int tx = tid % 16;
  const int ty = tid / 16;
  float x[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4) ? ty * 4 + i : 64 + ty * 4 + (i - 4);
    const float4 x0 =
        *reinterpret_cast<const float4*>(&Cs[r * C_PITCH + tx * 4]);
    const float4 x1 =
        *reinterpret_cast<const float4*>(&Cs[r * C_PITCH + 64 + tx * 4]);
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
            part_m, part_s);
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

// stage 2 (both operand types)
cudaError_t merge(int rows, int k, int n_tiles, const float* part_vals,
                  const int* part_ids, const float* part_m,
                  const float* part_s, float* vals, int* ids, float* lse,
                  cudaStream_t stream) {
  vocab_merge_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      rows, k, n_tiles, part_vals, part_ids, part_m, part_s, vals, ids, lse);
  return cudaGetLastError();
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
  return merge(rows, k, n_tiles, part_vals, part_ids, part_m, part_s, vals,
               ids, lse, stream);
}

template <bool VEC>
cudaError_t launch_bf16(const __nv_bfloat16* h2, const __nv_bfloat16* w,
                        const float* bias, int rows, int R, int V, int k,
                        float* part_vals, int* part_ids, float* part_m,
                        float* part_s, float* vals, int* ids, float* lse,
                        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      vocab_tile_bf16_kernel<VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, BF16_SMEM);
  if (e != cudaSuccess) return e;
  const int n_tiles = (V + TV - 1) / TV;
  const dim3 grid1(n_tiles, (rows + TR - 1) / TR);
  vocab_tile_bf16_kernel<VEC><<<grid1, kThreads, BF16_SMEM, stream>>>(
      h2, w, bias, rows, R, V, k, part_vals, part_ids, part_m, part_s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge(rows, k, n_tiles, part_vals, part_ids, part_m, part_s, vals,
               ids, lse, stream);
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

// bf16 h2 (rows, R) and bf16 W_t (R, V); the rest as vsrcic_vocab_topk
extern "C" int vsrcic_vocab_topk_bf16(const void* h2, const void* w,
                                      const void* bias, int rows, int R,
                                      int V, int k, void* part_vals,
                                      void* part_ids, void* part_m,
                                      void* part_s, void* vals, void* ids,
                                      void* lse, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  if (k < 1 || k > K_MAX || k > V || rows < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  auto bh2 = static_cast<const __nv_bfloat16*>(h2);
  auto bw = static_cast<const __nv_bfloat16*>(w);
  const bool vec = R % 8 == 0 && V % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(h2) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  auto fn = vec ? launch_bf16<true> : launch_bf16<false>;
  return (int)fn(bh2, bw, static_cast<const float*>(bias), rows, R, V, k,
                 static_cast<float*>(part_vals), static_cast<int*>(part_ids),
                 static_cast<float*>(part_m), static_cast<float*>(part_s),
                 static_cast<float*>(vals), static_cast<int*>(ids),
                 static_cast<float*>(lse), static_cast<cudaStream_t>(stream));
}

extern "C" const char* vsrcic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
