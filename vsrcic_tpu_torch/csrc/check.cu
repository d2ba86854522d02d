// The memory check's records (check.cuh), gathered from the four kernel
// files of the checked build; the default build compiles nothing here.
// tools/memcheck.py reads them through ctypes.
#include "check.cuh"

#if VSRCIC_CHECKED

int vsrcic_check_fused(VsrcicFault* out, int op, int kernel, int bound);
int vsrcic_check_vocab(VsrcicFault* out, int op, int kernel, int bound);
int vsrcic_check_sinkhorn(VsrcicFault* out, int op, int kernel, int bound);
int vsrcic_check_kda(VsrcicFault* out, int op, int kernel, int bound);

namespace {

constexpr int kFiles = 4;

int each_file(VsrcicFault* out, int op, int kernel, int bound) {
  int (*const files[kFiles])(VsrcicFault*, int, int, int) = {
      vsrcic_check_fused, vsrcic_check_vocab, vsrcic_check_sinkhorn,
      vsrcic_check_kda};
  VsrcicFault scratch[2];
  for (int f = 0; f < kFiles; ++f) {
    const int e = files[f](out ? out + 2 * f : scratch, op, kernel, bound);
    if (e) return e;
  }
  return 0;
}

}  // namespace

// out: 2 * 4 records, each file's device record then its host record (the
// tensor maps), in the order fused_attention.cu, vocab_topk.cu,
// sinkhorn.cu, kda.cu; call after the launches have finished. Returns a
// cudaError_t.
extern "C" int vsrcic_check_read(void* out) {
  return each_file(static_cast<VsrcicFault*>(out), 0, -1, -1);
}

// every record cleared
extern "C" int vsrcic_check_reset() { return each_file(nullptr, 1, -1, -1); }

// bound `bound` of kernel `kernel` (check.cuh's VsrcicKernel, the files'
// Bound enums) one element short from the next launch on, in every file;
// (-1, -1) restores every bound
extern "C" int vsrcic_check_cut(int kernel, int bound) {
  return each_file(nullptr, 2, kernel, bound);
}

#endif
