// Native host-side preprocessing for echoflow_torch (a copy of
// echoflow/native/preprocess.cc, the same loops and C ABI).
//
// Per-channel [0, 1] intensity normalization (echonet_dataset.py:38-50
// semantics), fused single-pass for uint8 decoder output, on a
// std::thread pool, exposed through a C ABI consumed via ctypes
// (echoflow_torch/ops/native.py). ops/normalize.zeroone_normalizer routes
// uint8 input here (the CLI's decoded video); float input keeps the
// in-place numpy path, which is faster once the data is float. The engine
// ships raw uint8 to the device and normalizes there.
//
// Built at first use with the host C++ compiler ($CXX, default g++):
//   g++ -O3 -march=native -fPIC -std=c++17 -pthread -shared
// into echoflow_torch/_build/ (echoflow_torch/ops/_build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_for(int64_t n, int threads, F&& fn) {
  if (threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  const int t = static_cast<int>(std::min<int64_t>(threads, n));
  std::vector<std::thread> pool;
  pool.reserve(t);
  std::int64_t chunk = (n + t - 1) / t;
  for (int k = 0; k < t; ++k) {
    const int64_t lo = k * chunk;
    const int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([lo, hi, &fn] {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Per-channel [0, 1] normalization: out[c, i] = (in[c, i] - min_c) /
// (max_c - min_c). `per_channel` elements per channel. Matches the
// reference zeroone_normalizer bit-for-bit on float32 input.
void ef_zeroone_f32(const float* in, float* out, int64_t channels,
                    int64_t per_channel, int threads) {
  parallel_for(channels, threads, [=](int64_t c) {
    const float* src = in + c * per_channel;
    float* dst = out + c * per_channel;
    float lo = std::numeric_limits<float>::infinity();
    float hi = -std::numeric_limits<float>::infinity();
    for (int64_t i = 0; i < per_channel; ++i) {
      lo = std::min(lo, src[i]);
      hi = std::max(hi, src[i]);
    }
    const float range = hi - lo;
    for (int64_t i = 0; i < per_channel; ++i) {
      dst[i] = (src[i] - lo) / range;
    }
  });
}

// uint8 variant with fused convert + normalize.
void ef_zeroone_u8(const uint8_t* in, float* out, int64_t channels,
                   int64_t per_channel, int threads) {
  parallel_for(channels, threads, [=](int64_t c) {
    const uint8_t* src = in + c * per_channel;
    float* dst = out + c * per_channel;
    uint8_t lo = 255, hi = 0;
    for (int64_t i = 0; i < per_channel; ++i) {
      lo = std::min(lo, src[i]);
      hi = std::max(hi, src[i]);
    }
    const float flo = static_cast<float>(lo);
    const float range = static_cast<float>(hi) - flo;
    for (int64_t i = 0; i < per_channel; ++i) {
      dst[i] = (static_cast<float>(src[i]) - flo) / range;
    }
  });
}

}  // extern "C"
