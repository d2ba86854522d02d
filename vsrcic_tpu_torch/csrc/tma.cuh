// The Tensor Memory Accelerator as the port's kernels use it: 2-D tensor
// maps (encoded on the host through the runtime, no -lcuda), box copies
// into shared memory that complete on an mbarrier with a transaction count,
// and the mbarrier operations around them. Included by fused_attention.cu
// and vocab_topk.cu; everything is internal to the including file. A map's
// extent is checked against its caller's statement in checked builds
// (check.cuh).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "check.cuh"

namespace {

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled itself, looked up once; null if the driver lacks it
EncodeTiled encoder() {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || !fn)
      return nullptr;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// `planes` row-major (rows, cols) tables of `tb`-byte elements one after
// another, rows `pitch` elements apart (0: cols; a multiple of 16 bytes),
// box (box_rows, box_cols) of one plane, shared-memory swizzle `swizzle`;
// elements of a box past the table's edges (columns past `cols` too) are
// zero-filled. A map of one plane is 2-D, of more 3-D (column, row,
// plane). false if cuTensorMapEncodeTiled refuses it, or (checked builds)
// if the bytes it spans, up to its last element, exceed `extent`, the
// bytes its caller states for `base` (a fault of `kernel` on `bound_id`)
bool encode_planes(CUtensorMap* map, const void* base, int tb, int planes,
                   long long rows, int cols, int box_rows, int box_cols,
                   int kernel, int bound_id, long long extent,
                   CUtensorMapSwizzle swizzle, long long pitch = 0) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  if (pitch == 0) pitch = cols;
  if (!VSRCIC_IN_HOST(kernel, kTensorMap, bound_id, 0,
                      ((planes - 1) * rows * pitch + (rows - 1) * pitch +
                       cols) * tb,
                      extent))
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * tb,
                                 (cuuint64_t)rows * pitch * tb};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map,
                tb == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                planes > 1 ? 3 : 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (rows, cols) row-major table of `tb`-byte elements, box (box_rows,
// box_cols), as encode_planes with one plane
bool encode_2d(CUtensorMap* map, const void* base, int tb, long long rows,
               int cols, int box_rows, int box_cols, int kernel,
               int bound_id, long long extent,
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE,
               long long pitch = 0) {
  return encode_planes(map, base, tb, 1, rows, cols, box_rows, box_cols,
                       kernel, bound_id, extent, swizzle, pitch);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` more of copies to complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// `bytes` of the transaction count completed without a copy: a box that
// the memory check drops (check.cuh) still lets the barrier's phase end
__device__ __forceinline__ void mbar_complete_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.complete_tx.shared::cluster.relaxed.cluster.b64 [%0], %1;\n"
      ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// the same on the mbarrier at `bar`'s offset in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_complete_tx_remote(uint64_t* bar,
                                                        uint32_t cta,
                                                        uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.complete_tx.shared::cluster.relaxed.cluster.b64 [ra], %2;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(cta), "r"(bytes) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one (rows, cols) box of a 2D tensor map at column x, row y -> shared
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar)) : "memory");
}

// the same box copied into the same offset of every CTA of the cluster in
// `mask`, completing on each one's mbarrier at `bar`'s offset
__device__ __forceinline__ void tma_box_multicast(void* dst,
                                                  const CUtensorMap* map,
                                                  int x, int y, uint64_t* bar,
                                                  uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar)), "h"(mask) : "memory");
}

// one (rows, cols) box of plane z of a 3-D tensor map at column x, row y
__device__ __forceinline__ void tma_box_3d(void* dst, const CUtensorMap* map,
                                           int x, int y, int z,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar)) : "memory");
}

// one (rows, cols) box of plane z of a 3-D tensor map at column x, row y,
// multicast as tma_box_multicast
__device__ __forceinline__ void tma_box_3d_multicast(void* dst,
                                                     const CUtensorMap* map,
                                                     int x, int y, int z,
                                                     uint64_t* bar,
                                                     uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// one arrival on the mbarrier at `bar`'s offset in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(cta) : "memory");
}

}  // namespace
