// Native batch generation / image preprocessing.
//
// The input pipeline is host-side and competes with the Python process for
// cycles; the path that feeds the card must not be GIL-bound. This
// library provides the hot loops — synthetic batch fills (benchmarking)
// and uint8->float32 image normalization (the real decode-side hot path) —
// multithreaded in C++, exposed through a plain C ABI for ctypes.
//
// Built with g++ on first use by tf_operator_tpu_torch/native/__init__.py
// (into build/torch_native/).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxThreads = 16;

inline uint64_t splitmix64(uint64_t& state) {
  state += 0x9E3779B97F4A7C15ULL;
  uint64_t z = state;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

template <typename Fn>
void parallel_chunks(int64_t n, Fn fn) {
  int threads = std::min<int64_t>(
      kMaxThreads, std::max<int64_t>(1, n / (1 << 16)));
  if (threads <= 1) {
    fn(0, 0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min<int64_t>(n, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back([=] { fn(t, begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Uniform [0, 1) float fill.
void tpuop_fill_uniform_f32(float* out, int64_t n, uint64_t seed) {
  parallel_chunks(n, [&](int t, int64_t begin, int64_t end) {
    uint64_t state = seed + 0x632BE59BD9B4E019ULL * (t + 1);
    for (int64_t i = begin; i < end; ++i) {
      out[i] = static_cast<float>(splitmix64(state) >> 40) * 0x1.0p-24f;
    }
  });
}

// Uniform integer fill in [low, high).
void tpuop_fill_randint_i32(int32_t* out, int64_t n, int32_t low,
                            int32_t high, uint64_t seed) {
  uint64_t range = static_cast<uint64_t>(high - low);
  if (range == 0) {
    std::memset(out, 0, n * sizeof(int32_t));
    return;
  }
  parallel_chunks(n, [&](int t, int64_t begin, int64_t end) {
    uint64_t state = seed + 0x9E3779B97F4A7C15ULL * (t + 1);
    for (int64_t i = begin; i < end; ++i) {
      out[i] = low + static_cast<int32_t>(splitmix64(state) % range);
    }
  });
}

// uint8 HWC image -> float32, per-channel (x/255 - mean) / std.
void tpuop_normalize_u8_f32(const uint8_t* in, float* out, int64_t n_pixels,
                            const float* mean, const float* std_dev,
                            int32_t channels) {
  std::vector<float> scale(channels), shift(channels);
  for (int c = 0; c < channels; ++c) {
    scale[c] = 1.0f / (255.0f * std_dev[c]);
    shift[c] = -mean[c] / std_dev[c];
  }
  int64_t n = n_pixels * channels;
  parallel_chunks(n, [&](int, int64_t begin, int64_t end) {
    for (int64_t i = begin; i < end; ++i) {
      int c = static_cast<int>(i % channels);
      out[i] = static_cast<float>(in[i]) * scale[c] + shift[c];
    }
  });
}

}  // extern "C"
