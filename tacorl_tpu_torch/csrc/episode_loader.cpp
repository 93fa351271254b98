// Native batched episode-window gather and pad fill for the port's loader,
// built by tacorl_tpu_torch/data/native.py.
//
// Packed storage (tacorl_tpu_torch/data/storage.py PackedStorage) keeps each
// modality in one contiguous memmap ordered by step; this library turns a
// training batch of B sliding windows into B parallel memcpy streams from the
// mapped file into one contiguous batch buffer given by the caller (on a card
// the page-locked tensor the copy to the device reads), overlapping page
// faults across a thread pool. The pad fill then completes each window's rows
// past its real length in that same buffer.
//
// C ABI (ctypes):
//   gather_windows(src, row_bytes, rows, lengths, n_windows, out_rows, out)
//     src        : base pointer of the memmapped (n_steps, ...) array
//     row_bytes  : bytes per step-row
//     rows       : int64[n_windows] starting row per window
//     lengths    : int64[n_windows] rows to copy per window (its real rows);
//                  rows lengths[w] .. out_rows - 1 of window w are not written
//     out        : (n_windows, out_rows, row_bytes) buffer
//
//   pad_windows(out, row_bytes, lengths, n_windows, out_rows, keep_bytes)
//     writes rows lengths[w] .. out_rows - 1 of each window of out in place
//     (lengths[w] >= 1): each such row's first row_bytes - keep_bytes bytes
//     are zeroed and its last keep_bytes bytes repeat those of row
//     lengths[w] - 1. keep_bytes == row_bytes repeats the last real row (the
//     play-window padding of frames and states); the size of one element
//     keeps only the last (relative actions: zeros but the gripper channel).
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
                    const int64_t* lengths, int64_t n_windows,
                    int64_t out_rows, uint8_t* out) {
  parallel_for(
      n_windows,
      [&](int64_t w) {
        std::memcpy(out + w * out_rows * row_bytes, src + rows[w] * row_bytes,
                    static_cast<size_t>(lengths[w] * row_bytes));
      },
      hardware_threads());
}

void pad_windows(uint8_t* out, int64_t row_bytes, const int64_t* lengths,
                 int64_t n_windows, int64_t out_rows, int64_t keep_bytes) {
  const int64_t zero_bytes = row_bytes - keep_bytes;
  parallel_for(
      n_windows,
      [&](int64_t w) {
        uint8_t* window = out + w * out_rows * row_bytes;
        const uint8_t* last = window + (lengths[w] - 1) * row_bytes;
        for (int64_t r = lengths[w]; r < out_rows; ++r) {
          uint8_t* p = window + r * row_bytes;
          std::memset(p, 0, static_cast<size_t>(zero_bytes));
          std::memcpy(p + zero_bytes, last + zero_bytes,
                      static_cast<size_t>(keep_bytes));
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
