// Host emulation of the CUDA subset that echoflow_torch/csrc/warp.cu and
// csrc/spans.cu use, so their kernels can be compiled with g++ and run on a
// machine without a GPU (tests/test_torch_warp_emulated.py,
// tests/test_torch_tracing.py). Not a CUDA implementation: only
// what those kernels need.
//
// A launch runs its blocks one after another and each warp as 32
// std::threads. Every warp collective (shuffle, ballot, any) is a barrier
// across the warp's 32 lanes that records an error if the lanes called it
// from different source lines (a collective behind a lane-dependent branch,
// such as the right side of &&) or after a lane of the warp has returned.
// The rounded arithmetic intrinsics go through volatile so that g++ cannot
// contract them: each result is the IEEE single-precision one, as on the
// card. Atomics take a mutex; the lanes of a warp reach them in whatever
// order their threads run. Compiled with -DEMU_REVERSE_BLOCKS, a launch
// runs its blocks, and the warps of each block, last to first: a kernel
// whose result depends on the order its blocks run in shows it there.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local emu_dim3 threadIdx, blockIdx;
inline emu_dim3 blockDim, gridDim;
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, cudaStream_t = nullptr) {
  std::memset(p, value, bytes);
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 132;   // an H100's SMs
  return cudaSuccess;
}

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float __ldg(const float* p) { return *p; }
inline float2 __ldg(const float2* p) { return *p; }
inline float4 __ldg(const float4* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }

inline std::mutex emu_atomic_mutex;
inline float4 atomicAdd(float4* a, float4 v) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const float4 old = *a;
  a->x += v.x; a->y += v.y; a->z += v.z; a->w += v.w;
  return old;
}
inline int atomicAdd(int* a, int v) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const int old = *a;
  *a += v;
  return old;
}

inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  std::lock_guard<std::mutex> lock(emu_atomic_mutex);
  const unsigned long long old = *a;
  *a += v;
  return old;
}

// %globaltimer: nanoseconds of the host's system clock.
#define ECHOFLOW_CUDA_HOST_EMU 1
inline unsigned long long emu_globaltimer() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::system_clock::now().time_since_epoch()).count();
}

inline std::atomic<int> emu_error_total{0};

struct EmuWarp {
  std::barrier<> barrier{32};
  uint64_t value[32];
  int line[32];
  std::atomic<int> returned{0};
};
inline thread_local EmuWarp* emu_warp = nullptr;

// Every lane publishes v; returns the values of all 32 lanes in `all`.
inline void emu_collective(uint64_t v, int line, uint64_t* all) {
  const int lane = threadIdx.x & 31;
  EmuWarp& w = *emu_warp;
  if (w.returned.load()) {
    std::fprintf(stderr, "warp collective at line %d after a lane returned\n", line);
    emu_error_total += 1;
  }
  w.value[lane] = v;
  w.line[lane] = line;
  w.barrier.arrive_and_wait();
  for (int l = 0; l < 32; ++l) {
    all[l] = w.value[l];
    if (w.line[l] != line) {
      std::fprintf(stderr, "divergent warp collective: lines %d and %d\n", line, w.line[l]);
      emu_error_total += 1;
    }
  }
  w.barrier.arrive_and_wait();
}

template <class T> inline uint64_t emu_bits(T t) { uint64_t u = 0; std::memcpy(&u, &t, sizeof(T)); return u; }
template <class T> inline T emu_value(uint64_t u) { T t; std::memcpy(&t, &u, sizeof(T)); return t; }

template <class T>
inline T __shfl_down_sync(unsigned, T v, int d, int line = __builtin_LINE()) {
  uint64_t all[32];
  emu_collective(emu_bits(v), line, all);
  const int src = (threadIdx.x & 31) + d;
  return src < 32 ? emu_value<T>(all[src]) : v;
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, int d, int line = __builtin_LINE()) {
  uint64_t all[32];
  emu_collective(emu_bits(v), line, all);
  const int src = (int)(threadIdx.x & 31) - d;
  return src >= 0 ? emu_value<T>(all[src]) : v;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int line = __builtin_LINE()) {
  uint64_t all[32];
  emu_collective(emu_bits(v), line, all);
  return emu_value<T>(all[src & 31]);
}
inline unsigned __ballot_sync(unsigned, bool p, int line = __builtin_LINE()) {
  uint64_t all[32];
  emu_collective(p, line, all);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (all[l] ? 1u : 0u) << l;
  return r;
}
inline bool __any_sync(unsigned m, bool p, int line = __builtin_LINE()) {
  return __ballot_sync(m, p, line) != 0;
}

// `kernel<<<grid, block, smem, stream>>>(args)` is rewritten to
// `emu_launch([&] { kernel(args); }, grid, block, smem, stream)`.
template <class F>
inline void emu_launch(F kernel, unsigned grid, int block, int = 0, cudaStream_t = nullptr) {
  blockDim.x = block;
  gridDim.x = grid;
#ifdef EMU_REVERSE_BLOCKS
  constexpr bool reverse = true;
#else
  constexpr bool reverse = false;
#endif
  const int warps = (block + 31) / 32;
  for (unsigned i = 0; i < grid; ++i)
    for (int j = 0; j < warps; ++j) {
      const unsigned b = reverse ? grid - 1 - i : i;
      const int w0 = 32 * (reverse ? warps - 1 - j : j);
      EmuWarp warp;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([&, l] {
          threadIdx.x = w0 + l;
          blockIdx.x = b;
          emu_warp = &warp;
          kernel();
          warp.returned += 1;
          warp.barrier.arrive_and_drop();
        });
      for (auto& t : lanes) t.join();
    }
}

// Errors recorded since the last call (the header is compiled into one
// translation unit, the kernel source).
extern "C" int emu_errors() { return emu_error_total.exchange(0); }
