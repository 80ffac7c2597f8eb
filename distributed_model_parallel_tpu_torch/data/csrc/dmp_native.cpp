// The C++ row gather of the host data path for
// distributed_model_parallel_tpu_torch: the gather of native/dmp_native.cpp,
// copied, built by data/native.py at first use (c++ -O3 -shared -fPIC).
//
// The batch-assembly half of the reference's DataLoader workers
// (data_parallel.py:31-51): out[i] = src[idx[i]] over uint8 rows, split
// across threads started for the call. Plain C interface, loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_for(int n, int n_threads, F&& fn) {
  if (n_threads <= 1 || n < 2) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  int t = std::min(n_threads, n);
  std::vector<std::thread> workers;
  workers.reserve(t);
  int chunk = (n + t - 1) / t;
  for (int w = 0; w < t; ++w) {
    int lo = w * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([lo, hi, &fn]() {
      for (int i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : workers) th.join();
}

}  // namespace

extern "C" {

// Gather rows: out[i] = src[idx[i]], each row item_bytes long.
void dmp_gather_rows(const uint8_t* src, const int64_t* idx, uint8_t* out,
                     int64_t n_sel, int64_t item_bytes, int n_threads) {
  parallel_for(static_cast<int>(n_sel), n_threads, [&](int i) {
    std::memcpy(out + static_cast<int64_t>(i) * item_bytes,
                src + idx[i] * item_bytes, item_bytes);
  });
}

}  // extern "C"
