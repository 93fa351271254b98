// Native batched episode-window gather (a copy of csrc/episode_loader.cpp,
// built for the port by tacorl_tpu_torch/data/native.py).
//
// Packed storage (tacorl_tpu_torch/data/storage.py PackedStorage) keeps each
// modality in one contiguous memmap ordered by step; this library turns a
// training batch of B sliding windows into B parallel memcpy streams from the
// mapped file into one contiguous batch buffer, overlapping page faults
// across a thread pool.
//
// C ABI (ctypes):
//   gather_windows(src, row_bytes, rows, n_windows, window_rows, pad_rows,
//                  out)
//     src        : base pointer of the memmapped (n_steps, ...) array
//     row_bytes  : bytes per step-row
//     rows       : int64[n_windows] starting row per window
//     window_rows: rows to copy per window
//     pad_rows   : extra rows appended by repeating the window's last row
//                  (the play-window padding semantics)
//     out        : (n_windows, window_rows + pad_rows, row_bytes) buffer
//
//   gather_rows(src, row_bytes, rows, n_rows, out)
//     single-frame gather (goal images, transitions).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 2 : static_cast<int>(n);
}

// Run fn(i) for i in [0, n) over a transient pool. For small n the calling
// thread does the work directly (thread spawn would dominate).
template <typename Fn>
void parallel_for(int64_t n, Fn&& fn, int max_threads) {
  if (n <= 0) return;
  int threads = static_cast<int>(
      std::min({static_cast<int64_t>(max_threads), n, int64_t{16}}));
  if (threads <= 1 || n < 4) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&] {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void gather_windows(const uint8_t* src, int64_t row_bytes, const int64_t* rows,
                    int64_t n_windows, int64_t window_rows, int64_t pad_rows,
                    uint8_t* out) {
  const int64_t out_rows = window_rows + pad_rows;
  parallel_for(
      n_windows,
      [&](int64_t w) {
        uint8_t* dst = out + w * out_rows * row_bytes;
        const uint8_t* s = src + rows[w] * row_bytes;
        std::memcpy(dst, s, static_cast<size_t>(window_rows * row_bytes));
        if (pad_rows > 0) {
          const uint8_t* last = dst + (window_rows - 1) * row_bytes;
          uint8_t* p = dst + window_rows * row_bytes;
          for (int64_t r = 0; r < pad_rows; ++r, p += row_bytes)
            std::memcpy(p, last, static_cast<size_t>(row_bytes));
        }
      },
      hardware_threads());
}

void gather_rows(const uint8_t* src, int64_t row_bytes, const int64_t* rows,
                 int64_t n_rows, uint8_t* out) {
  parallel_for(
      n_rows,
      [&](int64_t i) {
        std::memcpy(out + i * row_bytes, src + rows[i] * row_bytes,
                    static_cast<size_t>(row_bytes));
      },
      hardware_threads());
}

}  // extern "C"
