// Native CIDEr-D scorer for the SCST reward's hot loop.
//
// A copy of the JAX package's native/cider_scorer.cpp: the PyTorch port
// builds nothing from outside its own package. The reference computes
// CIDEr inside every RL step through speaksee's Python scorer after a Java
// tokenizer round trip (reference coco_scripts/train.py:165-170); the
// port's Python copy (vsrcic_tpu_torch/metrics/cider.py) spends most of
// the reward's host time on dict-of-tuple ngram math. This scorer keeps
// the corpus document frequency resident and scores the sampled and
// baseline decodes from interned word-id arrays, so the per-step Python
// work drops to building int32 id arrays.
//
// Value contract: the formulas of metrics/cider.py (CIDEr-D: count
// clipping, gaussian length penalty sigma 6, x10) in the same float64
// operations; equality to 1e-12 is held in tests/test_torch_cider_native.py
// (only the order of the terms' summation differs). Ngrams are keyed by a
// 64-bit FNV-1a over their word ids (collision probability ~(#ngrams)^2 /
// 2^64, negligible at corpus scale; a collision would break the 1e-12
// equality on the corpus it hits).
//
// Built at first use by vsrcic_tpu_torch/ops/_build.py::host_library with
// the host C++ compiler (c++ -O3 -fPIC -std=c++17 -pthread -shared) into
// vsrcic_tpu_torch/build/, and loaded with ctypes
// (vsrcic_tpu_torch/metrics/cider_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int N_MAX = 4;
constexpr double SIGMA = 6.0;

inline uint64_t fnv1a(const int32_t* words, int n) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < n; ++i) {
    uint64_t w = static_cast<uint64_t>(static_cast<uint32_t>(words[i]));
    for (int b = 0; b < 4; ++b) {
      h ^= (w >> (8 * b)) & 0xff;
      h *= 1099511628211ull;
    }
  }
  return h;
}

struct Vec {
  // tf-idf vectors per ngram order + norms + unigram length
  std::unordered_map<uint64_t, double> v[N_MAX];
  double norm[N_MAX] = {0, 0, 0, 0};
  long length = 0;  // bigram-counted "length" parity: k == 1 term count
};

struct Scorer {
  std::unordered_map<uint64_t, double> df;
  double ref_len = 0.0;
};

void count_ngrams(const int32_t* words, int len,
                  std::unordered_map<uint64_t, double> cnt[N_MAX]) {
  for (int n = 1; n <= N_MAX; ++n)
    for (int i = 0; i + n <= len; ++i)
      cnt[n - 1][fnv1a(words + i, n)] += 1.0;
}

void counts2vec(const std::unordered_map<uint64_t, double> cnt[N_MAX],
                const Scorer& s, Vec& out) {
  for (int k = 0; k < N_MAX; ++k) {
    for (const auto& kv : cnt[k]) {
      auto it = s.df.find(kv.first);
      double d = std::log(std::max(1.0, it == s.df.end() ? 0.0 : it->second));
      double val = kv.second * (s.ref_len - d);
      out.v[k][kv.first] = val;
      out.norm[k] += val * val;
      if (k == 1) out.length += static_cast<long>(kv.second);
    }
    out.norm[k] = std::sqrt(out.norm[k]);
  }
}

double sim_score(const Vec& h, const Vec& r) {
  double delta = static_cast<double>(h.length - r.length);
  double gauss = std::exp(-(delta * delta) / (2.0 * SIGMA * SIGMA));
  double total = 0.0;
  for (int k = 0; k < N_MAX; ++k) {
    double acc = 0.0;
    for (const auto& kv : h.v[k]) {
      auto it = r.v[k].find(kv.first);
      if (it != r.v[k].end() && it->second != 0.0)
        acc += std::min(kv.second, it->second) * it->second;
    }
    if (h.norm[k] != 0.0 && r.norm[k] != 0.0) acc /= h.norm[k] * r.norm[k];
    total += acc * gauss;
  }
  return total;  // sum over k; caller divides by N_MAX and scales x10
}

}  // namespace

extern "C" {

void* cider_new(double ref_len) {
  auto* s = new Scorer();
  s->ref_len = ref_len;
  return s;
}

void cider_free(void* handle) { delete static_cast<Scorer*>(handle); }

// Bulk-load the document-frequency table in CSR form: ngram i is
// words[off[i]:off[i+1]] with df value values[i]. Hashing stays in C++
// (the single definition of the key function) and the whole table loads
// in ONE ctypes call — a per-ngram ctypes loop measured 10 us/ngram,
// which is tens of seconds at real-corpus scale.
void cider_df_load_csr(void* handle, const int32_t* words,
                       const int64_t* off, const double* values,
                       int64_t n) {
  auto* s = static_cast<Scorer*>(handle);
  s->df.reserve(static_cast<size_t>(n * 2));
  for (int64_t i = 0; i < n; ++i)
    s->df[fnv1a(words + off[i], static_cast<int>(off[i + 1] - off[i]))] =
        values[i];
}

// Score two hypothesis sets against one gts set (single-ref per key, the
// SCST configuration). Captions are flattened int32 word ids with offsets
// (CSR: caption i = words[off[i]:off[i+1]]). Writes per-image CIDEr-D
// scores (x10) for both hyp sets. Keys are independent, so the loop
// splits over nthreads (the df map is read-only here); per-key values
// are unaffected by the split.
void cider_score_pair(void* handle, int64_t n_keys,
                      const int32_t* gt_words, const int64_t* gt_off,
                      const int32_t* a_words, const int64_t* a_off,
                      const int32_t* b_words, const int64_t* b_off,
                      double* out_a, double* out_b, int nthreads) {
  auto* s = static_cast<Scorer*>(handle);
  auto worker = [&](int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      std::unordered_map<uint64_t, double> cnt_r[N_MAX];
      count_ngrams(gt_words + gt_off[i],
                   static_cast<int>(gt_off[i + 1] - gt_off[i]), cnt_r);
      Vec ref;
      counts2vec(cnt_r, *s, ref);

      const int32_t* hw[2] = {a_words + a_off[i], b_words + b_off[i]};
      const int hl[2] = {static_cast<int>(a_off[i + 1] - a_off[i]),
                         static_cast<int>(b_off[i + 1] - b_off[i])};
      double* outs[2] = {out_a + i, out_b + i};
      for (int j = 0; j < 2; ++j) {
        std::unordered_map<uint64_t, double> cnt_h[N_MAX];
        count_ngrams(hw[j], hl[j], cnt_h);
        Vec hyp;
        counts2vec(cnt_h, *s, hyp);
        *outs[j] = sim_score(hyp, ref) / N_MAX * 10.0;
      }
    }
  };
  if (nthreads < 1) nthreads = 1;
  nthreads = static_cast<int>(
      std::min<int64_t>(nthreads, std::max<int64_t>(n_keys, 1)));
  if (nthreads == 1) {
    worker(0, n_keys);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n_keys + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t b = t * chunk, e = std::min<int64_t>(n_keys, b + chunk);
    if (b < e) ts.emplace_back(worker, b, e);
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"
