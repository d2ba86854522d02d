// The port's memory check, written by hand (compute-sanitizer does not run
// on the card's machine). Every access of the port's kernels goes through
// VSRCIC_IN, which tests the accessed range [lo, lo + len) against the
// bound that the kernel's own size arguments imply (rows, B, L, M, D, A, R,
// V, ldw, k, S, n, the plan's tile counts, the shared layout's offsets):
//
//   * without VSRCIC_CHECKED, VSRCIC_IN is the constant `true` and its
//     arguments are never evaluated, and VSRCIC_LD / VSRCIC_DO /
//     VSRCIC_AND / VSRCIC_ZERO give the plain access token for token: the
//     default build's code is the plain access;
//   * with VSRCIC_CHECKED=1 (ops/_build.py::library(checked=True)), a range
//     outside its bound is a fault: the first one is recorded (kernel,
//     source line, block, thread, kind of access, bound id, index, bound)
//     and every one is counted, and the access is dropped (a load gives 0,
//     a store is skipped). No thread returns early, so no barrier hangs.
//
// Each translation unit keeps its own records: one on the device, one on
// the host (the tensor maps' extents, checked when they are encoded).
// VSRCIC_CHECK_RECORDS(name) gives a file's records an accessor; check.cu's
// extern "C" vsrcic_check_read / _reset / _cut gather them.
// vsrcic_check_cut(kernel, bound) makes one bound one element short (the
// card tests' proof that a check is live): the kernel's work is unchanged,
// so its last access under that bound faults.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// the record's `kernel` (tools/memcheck.py KERNELS)
enum VsrcicKernel {
  kFusedAttention = 0,  // fused_attention.cu fused_attention_kernel
  kVocabTile = 1,       // vocab_topk.cu vocab_tile_kernel ("sgemm")
  kVocabTileBf16 = 2,   // vocab_tile_bf16_kernel ("mma_sync")
  kVocabTma = 3,        // vocab_tma_kernel (the TMA routes)
  kVocabSplit = 4,      // vocab_split_kernel
  kVocabMerge = 5,      // vocab_merge_kernel
  kSinkhornPacked = 6,  // sinkhorn.cu sinkhorn_packed_kernel
  kSinkhornBlock = 7,   // sinkhorn_block_kernel
  kStepPlanes = 8,      // vocab_topk.cu step_planes_kernel
  kStepPlanesSplit = 9,  // step_planes_split_kernel
  kStepPlanesGrad = 10,   // step_planes_grad_kernel
  kStepPlanesSplitT = 11,  // step_planes_split_t_kernel
  kKdaRecurrence = 12,     // kda.cu kda_recurrence_kernel
  kShortConv = 13,         // kda.cu short_conv_kernel
  kGatedNorm = 14,         // kda.cu gated_norm_kernel
};

// the record's `kind` (tools/memcheck.py KINDS)
enum VsrcicAccess {
  kGlobal = 0,     // device memory
  kShared = 1,     // this CTA's shared memory
  kDsmem = 2,      // another CTA's shared memory (mapa, cluster ranks)
  kTensorMap = 3,  // a tensor map's extent or a box's coordinates
  kMbarrier = 4,   // an mbarrier's address
};

// one record: the first fault since the last reset, and the count of all
struct VsrcicFault {
  unsigned long long count;
  int kernel, line, block, thread, kind, bound_id;
  long long index, bound;  // the last element the access touched
};

// the dynamic shared bytes this CTA was launched with (the checks of a
// shared layout's total)
__device__ __forceinline__ unsigned vsrcic_dynamic_smem() {
  unsigned n;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(n));
  return n;
}

#if VSRCIC_CHECKED

namespace {

__device__ VsrcicFault g_fault;
__device__ int g_cut[2] = {-1, -1};  // (kernel, bound id) one element short
VsrcicFault h_fault;
int h_cut[2] = {-1, -1};

__device__ __noinline__ void vsrcic_fault(int kernel, int line, int kind,
                                          int bound_id, long long index,
                                          long long bound) {
  if (atomicAdd(&g_fault.count, 1ull) == 0ull) {
    g_fault.kernel = kernel;
    g_fault.line = line;
    g_fault.block = (int)(blockIdx.x + gridDim.x * blockIdx.y);
    g_fault.thread = (int)threadIdx.x;
    g_fault.kind = kind;
    g_fault.bound_id = bound_id;
    g_fault.index = index;
    g_fault.bound = bound;
  }
}

__device__ __forceinline__ bool vsrcic_in(int kernel, int line, int kind,
                                          int bound_id, long long lo,
                                          long long len, long long bound) {
  if (kernel == g_cut[0] && bound_id == g_cut[1]) --bound;
  if (lo >= 0 && lo + len <= bound) return true;
  vsrcic_fault(kernel, line, kind, bound_id, lo < 0 ? lo : lo + len - 1,
               bound);
  return false;
}

inline bool vsrcic_in_host(int kernel, int line, int kind, int bound_id,
                           long long lo, long long len, long long bound) {
  if (kernel == h_cut[0] && bound_id == h_cut[1]) --bound;
  if (lo >= 0 && lo + len <= bound) return true;
  if (h_fault.count++ == 0ull) {
    h_fault.kernel = kernel;
    h_fault.line = line;
    h_fault.block = -1;
    h_fault.thread = -1;
    h_fault.kind = kind;
    h_fault.bound_id = bound_id;
    h_fault.index = lo < 0 ? lo : lo + len - 1;
    h_fault.bound = bound;
  }
  return false;
}

}  // namespace

#define VSRCIC_IN(kernel, kind, bound_id, lo, len, bound)                  \
  vsrcic_in((kernel), __LINE__, (kind), (bound_id), (long long)(lo),       \
            (long long)(len), (long long)(bound))
#define VSRCIC_IN_HOST(kernel, kind, bound_id, lo, len, bound)             \
  vsrcic_in_host((kernel), __LINE__, (kind), (bound_id), (long long)(lo),  \
                 (long long)(len), (long long)(bound))

// op 0: out[0] = the device record, out[1] = the host record; 1: reset
// both; 2: cut (kernel, bound) (-1, -1: none). Returns a cudaError_t.
#define VSRCIC_CHECK_RECORDS(name)                                         \
  int vsrcic_check_##name(VsrcicFault* out, int op, int kernel,            \
                          int bound) {                                     \
    if (op == 0) {                                                         \
      out[1] = h_fault;                                                    \
      return (int)cudaMemcpyFromSymbol(&out[0], g_fault,                   \
                                       sizeof(VsrcicFault));               \
    }                                                                      \
    if (op == 1) {                                                         \
      h_fault = VsrcicFault{};                                             \
      const VsrcicFault zero{};                                            \
      return (int)cudaMemcpyToSymbol(g_fault, &zero, sizeof(zero));        \
    }                                                                      \
    h_cut[0] = kernel;                                                     \
    h_cut[1] = bound;                                                      \
    const int cut[2] = {kernel, bound};                                    \
    return (int)cudaMemcpyToSymbol(g_cut, cut, sizeof(cut));               \
  }

// a load through a check: `expr`, or `zero` where the check fails
#define VSRCIC_LD(check, expr, zero) ((check) ? (expr) : (zero))
// a statement through a check (one statement, the caller's `;` ending it)
#define VSRCIC_DO(check, ...) \
  if (!(check)) {              \
  } else                       \
    __VA_ARGS__
// a check joined to a condition: `if (c VSRCIC_AND(check))`
#define VSRCIC_AND(check) &&(check)
// `n` elements of `arr` zeroed (what a dropped load gives)
#define VSRCIC_ZERO(arr, n) \
  for (int vsrcic_z = 0; vsrcic_z < (n); ++vsrcic_z) (arr)[vsrcic_z] = 0

#else

// the default build: the plain access, token for token
#define VSRCIC_IN(kernel, kind, bound_id, lo, len, bound) true
#define VSRCIC_IN_HOST(kernel, kind, bound_id, lo, len, bound) true
#define VSRCIC_CHECK_RECORDS(name)
#define VSRCIC_LD(check, expr, zero) expr
#define VSRCIC_DO(check, ...) __VA_ARGS__
#define VSRCIC_AND(check)
#define VSRCIC_ZERO(arr, n)

#endif
