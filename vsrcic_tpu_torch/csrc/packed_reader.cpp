// Native batch reader for the packed feature store.
//
// The reference's input path opens the HDF5 file per example inside Python
// workers (reference data/field.py:70-73). The packed store already memmaps
// flat arrays; this reader gathers a batch of variable-length row ranges into
// one padded, contiguous batch buffer with multithreaded memcpy — the plain
// version (data/native_reader.py::fill_padded_batch_plain) does the same with
// a per-item numpy loop.
//
// A copy of native/packed_reader.cpp. Build: ops/_build.py::host_library
// ("packed_reader") at first use (build/libpacked_reader.so; loaded via
// ctypes).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// src: (total_rows, dim) float32 (memmapped)
// starts/counts: per-item row ranges into src
// dst: (n_items, max_rows, dim) float32, fully overwritten (zero padded)
void fill_padded_batch_f32(const float* src, int64_t dim,
                           const int64_t* starts, const int64_t* counts,
                           int64_t n_items, int64_t max_rows, float* dst,
                           int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      float* out = dst + i * max_rows * dim;
      const int64_t n = std::min<int64_t>(counts[i], max_rows);
      std::memcpy(out, src + starts[i] * dim, n * dim * sizeof(float));
      if (n < max_rows)
        std::memset(out + n * dim, 0, (max_rows - n) * dim * sizeof(float));
    }
  };
  if (nthreads == 1 || n_items < 2 * nthreads) {
    worker(0, n_items);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_items + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(b + chunk, n_items);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

// Row-subset gather: dst[j] = src[rows[j]] for j in [0, n_rows)
void gather_rows_f32(const float* src, int64_t dim, const int64_t* rows,
                     int64_t n_rows, float* dst, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t j = begin; j < end; ++j)
      std::memcpy(dst + j * dim, src + rows[j] * dim, dim * sizeof(float));
  };
  if (nthreads == 1 || n_rows < 4 * nthreads) {
    worker(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  const int64_t chunk = (n_rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min<int64_t>(b + chunk, n_rows);
    if (b >= e) break;
    threads.emplace_back(worker, b, e);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
