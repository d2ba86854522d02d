// Fused region-group gather + sentinel attention + shift-gate evidence.
//
// Replaces the TPU kernel vsrcic_tpu/ops/fused_attention.py
// (make_fused_group_attention, body :54-130, pallas_call :163).
//
// What bounds it on the H100: device-memory bytes. Per decode row it reads
// one region group (M x D) and its projection (M x A) from tables that are
// not expanded per beam, plus the row's ha / fc_sentinel vectors, and does
// ~3 flops per byte read -- far below the card's compute-to-bandwidth ratio.
//
// Design: one CTA per decode row. The row loads its own item/ctrl, so the
// gathered (rows, M, D) tensor never exists in device memory and beams of
// one item that point at the same group share it through L2.
//   1. ha and att_a are staged in shared memory.
//   2. One warp per region computes the region's full-D row sum (the mask)
//      and its attention logit det_w = tanh(proj + ha) . att_a.
//   3. Warp 0 takes the masked softmax over [sentinel ; regions] exactly as
//      the JAX step does: max, exp, multiply by the mask, renormalise.
//   4. Every thread owns VEC consecutive features and sums att_m * det[m]
//      over the regions.
// The group is read twice (step 2 and step 4) rather than staged in shared
// memory: the second read follows the first within microseconds and is
// served by the 50 MB L2, and no shared-memory limit ties M or D to the
// table dtype. All arithmetic is f32. M need not be padded; padded regions
// are all zero and masked. An out-of-range item/ctrl yields NaN outputs
// instead of an out-of-bounds read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive table elements, 16 bytes when VEC * sizeof(T) == 16
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

// VEC > 1 requires D % VEC == 0 and A % VEC == 0 (aligned vector loads).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_attention_kernel(const int* __restrict__ item,
                       const int* __restrict__ ctrl,
                       const float* __restrict__ ha,
                       const float* __restrict__ sent_w,
                       const float* __restrict__ sent_mask,
                       const float* __restrict__ fc_sent,
                       const float* __restrict__ att_a,
                       const T* __restrict__ det,
                       const T* __restrict__ proj,
                       int B, int L, int M, int D, int A,
                       float* __restrict__ out,
                       float* __restrict__ gsum) {
  extern __shared__ float smem[];
  float* ha_s = smem;              // (A,)
  float* atta_s = ha_s + A;        // (A,)
  float* detw_s = atta_s + A;      // (M,)
  float* mask_s = detw_s + M;      // (M,)
  float* att_s = mask_s + M;       // (M,) normalised region weights
  __shared__ float att_sent_s;

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int it = item[r];
  const int ct = ctrl[r];
  if (it < 0 || it >= B || ct < 0 || ct >= L) {
    for (int d = tid; d < D; d += kThreads) out[(size_t)r * D + d] = NAN;
    if (tid == 0) gsum[r] = NAN;
    return;
  }
  const size_t group = (size_t)it * L + ct;
  const T* g = det + group * M * D;
  const T* p = proj + group * M * A;

  for (int a = tid; a < A; a += kThreads) {
    ha_s[a] = ha[(size_t)r * A + a];
    atta_s[a] = att_a[a];
  }
  __syncthreads();

  // 2. per-region mask (full-D row sum) and attention logit
  for (int m = warp; m < M; m += kWarps) {
    const T* gm = g + (size_t)m * D;
    float s = 0.f;
    for (int d = lane * VEC; d < D; d += 32 * VEC) {
      float x[VEC];
      load_vec<T, VEC>(gm + d, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += x[j];
    }
    const T* pm = p + (size_t)m * A;
    float w = 0.f;
    for (int a = lane * VEC; a < A; a += 32 * VEC) {
      float x[VEC];
      load_vec<T, VEC>(pm + a, x);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        w += tanhf(x[j] + ha_s[a + j]) * atta_s[a + j];
    }
    s = warp_sum(s);
    w = warp_sum(w);
    if (lane == 0) {
      mask_s[m] = (s != 0.f) ? 1.f : 0.f;
      detw_s[m] = w;
    }
  }
  __syncthreads();

  // 3. masked softmax over [sentinel ; regions], renormalised
  if (warp == 0) {
    const float sw = sent_w[r];
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, detw_s[m]);
    mx = fmaxf(warp_max(mx), sw);
    float den = 0.f, ev = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(detw_s[m] - mx) * mask_s[m];
      att_s[m] = e;
      den += e;
      ev += mask_s[m] * detw_s[m];
    }
    const float e_sent = expf(sw - mx) * sent_mask[r];
    den = warp_sum(den) + e_sent;
    ev = warp_sum(ev);
    __syncwarp();
    for (int m = lane; m < M; m += 32) att_s[m] = att_s[m] / den;
    if (lane == 0) {
      att_sent_s = e_sent / den;
      gsum[r] = ev;
    }
  }
  __syncthreads();

  // 4. out = sum_m att_m * det[m] + att_sent * fc_sentinel
  const float a_sent = att_sent_s;
  for (int d = tid * VEC; d < D; d += kThreads * VEC) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int m = 0; m < M; ++m) {
      float x[VEC];
      load_vec<T, VEC>(g + (size_t)m * D + d, x);
      const float am = att_s[m];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += am * x[j];
    }
    const float* fc = fc_sent + (size_t)r * D + d;
    float* o = out + (size_t)r * D + d;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = acc[j] + a_sent * fc[j];
  }
}

template <typename T, int VEC>
cudaError_t launch(const int* item, const int* ctrl, const float* ha,
                   const float* sent_w, const float* sent_mask,
                   const float* fc_sent, const float* att_a, const void* det,
                   const void* proj, int rows, int B, int L, int M, int D,
                   int A, float* out, float* gsum, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)A + 3 * (size_t)M);
  auto kern = fused_attention_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<rows, kThreads, smem, stream>>>(
      item, ctrl, ha, sent_w, sent_mask, fc_sent, att_a,
      static_cast<const T*>(det), static_cast<const T*>(proj), B, L, M, D, A,
      out, gsum);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vsrcic_fused_attention(
    const void* item, const void* ctrl, const void* ha, const void* sent_w,
    const void* sent_mask, const void* fc_sent, const void* att_a,
    const void* det, const void* proj, int table_bf16, int rows, int B,
    int L, int M, int D, int A, void* out, void* gsum, void* stream) {
  cudaGetLastError();  // a stale error must not be reported as this launch's
  auto s = static_cast<cudaStream_t>(stream);
  const int* it = static_cast<const int*>(item);
  const int* ct = static_cast<const int*>(ctrl);
  const float* h = static_cast<const float*>(ha);
  const float* sw = static_cast<const float*>(sent_w);
  const float* sm = static_cast<const float*>(sent_mask);
  const float* fc = static_cast<const float*>(fc_sent);
  const float* aa = static_cast<const float*>(att_a);
  float* o = static_cast<float*>(out);
  float* gs = static_cast<float*>(gsum);
  cudaError_t e;
  if (table_bf16) {
    if (D % 8 == 0 && A % 8 == 0)
      e = launch<__nv_bfloat16, 8>(it, ct, h, sw, sm, fc, aa, det, proj,
                                   rows, B, L, M, D, A, o, gs, s);
    else
      e = launch<__nv_bfloat16, 1>(it, ct, h, sw, sm, fc, aa, det, proj,
                                   rows, B, L, M, D, A, o, gs, s);
  } else {
    if (D % 4 == 0 && A % 4 == 0)
      e = launch<float, 4>(it, ct, h, sw, sm, fc, aa, det, proj, rows, B, L,
                           M, D, A, o, gs, s);
    else
      e = launch<float, 1>(it, ct, h, sw, sm, fc, aa, det, proj, rows, B, L,
                           M, D, A, o, gs, s);
  }
  return (int)e;
}
