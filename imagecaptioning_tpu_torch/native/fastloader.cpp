// fastloader — the host's batch gather over the RAM-cached uint8 image
// store (and any other fixed-stride record array), multi-threaded; a copy
// of the JAX package's `native/fastloader.cpp` with the same extern "C"
// surface.
//
// The reference's data loaders assemble every batch in Python: h5py
// fancy reads + np.stack per batch (AlexCap/MyDataLoader.py:85,
// DenseCap/densecap/DataLoader.py:142-151). Here the gather runs as
// threads of memcpy over the records, bound with ctypes (`build.py`).
//
// Contract: all arrays are C-contiguous; `src` holds N records of
// `record_bytes` each; `indices` selects B records scattered into
// `dst` (B * record_bytes). Threads split the batch by record. An index
// or a crop out of range returns -1 before anything is written.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

extern "C" {

// Gather: dst[b] = src[indices[b]] for b in [0, batch). Returns 0 on
// success, -1 on bad args.
int gather_records(const uint8_t* src, int64_t num_records,
                   int64_t record_bytes, const int64_t* indices,
                   int64_t batch, uint8_t* dst, int num_threads) {
  if (!src || !indices || !dst || record_bytes <= 0 || batch < 0)
    return -1;
  for (int64_t b = 0; b < batch; ++b) {
    if (indices[b] < 0 || indices[b] >= num_records) return -1;
  }
  if (num_threads < 1) num_threads = 1;
  num_threads = static_cast<int>(
      std::min<int64_t>(num_threads, std::max<int64_t>(batch, 1)));

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      std::memcpy(dst + b * record_bytes,
                  src + indices[b] * record_bytes,
                  static_cast<size_t>(record_bytes));
    }
  };
  if (num_threads == 1 || batch <= 1) {
    worker(0, batch);
    return 0;
  }
  std::vector<std::thread> threads;
  int64_t per = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min<int64_t>(lo + per, batch);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Gather with per-record row crop: records are (H, W, C) uint8 images;
// copy only the top-left (h_i, w_i) window of each into dst at full
// (H, W, C) stride, zeroing the padding — the VG loader's true-size
// crop (DataLoader.py:142-145) without leaving native code.
int gather_images_cropped(const uint8_t* src, int64_t num_records,
                          int64_t height, int64_t width, int64_t channels,
                          const int64_t* indices,
                          const int64_t* crop_h, const int64_t* crop_w,
                          int64_t batch, uint8_t* dst, int num_threads) {
  if (!src || !indices || !dst) return -1;
  const int64_t record_bytes = height * width * channels;
  for (int64_t b = 0; b < batch; ++b) {
    if (indices[b] < 0 || indices[b] >= num_records) return -1;
    if (crop_h[b] < 0 || crop_h[b] > height) return -1;
    if (crop_w[b] < 0 || crop_w[b] > width) return -1;
  }
  if (num_threads < 1) num_threads = 1;
  num_threads = static_cast<int>(
      std::min<int64_t>(num_threads, std::max<int64_t>(batch, 1)));

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t b = lo; b < hi; ++b) {
      const uint8_t* s = src + indices[b] * record_bytes;
      uint8_t* d = dst + b * record_bytes;
      const int64_t h = crop_h[b], w = crop_w[b];
      const int64_t row_bytes = width * channels;
      const int64_t copy_bytes = w * channels;
      for (int64_t y = 0; y < h; ++y) {
        std::memcpy(d + y * row_bytes, s + y * row_bytes,
                    static_cast<size_t>(copy_bytes));
        if (copy_bytes < row_bytes)
          std::memset(d + y * row_bytes + copy_bytes, 0,
                      static_cast<size_t>(row_bytes - copy_bytes));
      }
      if (h < height)
        std::memset(d + h * row_bytes, 0,
                    static_cast<size_t>((height - h) * row_bytes));
    }
  };
  if (num_threads == 1 || batch <= 1) {
    worker(0, batch);
    return 0;
  }
  std::vector<std::thread> threads;
  int64_t per = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min<int64_t>(lo + per, batch);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
