// Device stamps of echoflow_torch's spans (utils/profiling.py).
//
// Replaces no TPU kernel. It exists because the port's timed paths are
// CUDA graph replays: a host clock sees none of the work inside a replay,
// and a CUDA event recorded during a capture is one fixed graph node that
// every replay records again, so with several replays in flight an
// elapsed_time pair would mix two of them. A stamp instead writes each
// replay's times into ring slots of their own.
//
// `span_stamp_kernel` runs one thread. It reads the live flag (state[0])
// and returns at once while it is 0: a stamp captured into a graph costs
// one near-empty kernel node when tracing is off. While the flag is on it
// reads %globaltimer, takes the next slot of the ring with an atomic add
// on state[1], and writes (word, id, time) there: word = 2 * the span's
// code + the edge (0 opens the span, 1 closes it); id is the replay's
// (read from `id_slot`, where a graph wrapper writes it before each
// replay, or else the launch's own `id`). The slot counter keeps counting
// past the ring's capacity: the excess is the number of stamps dropped;
// no slot is ever written twice in a session. Bound: the launch itself
// (a few microseconds of latency); it moves 24 bytes.
//
// `span_clock_kernel` writes %globaltimer once: the host pairs it with its
// own clock to put the ring's times on the host's clock.
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned long long global_timer_ns() {
#if defined(__CUDA_ARCH__)
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
#elif defined(ECHOFLOW_CUDA_HOST_EMU)
  return emu_globaltimer();   // the host emulation's clock (tests/cuda_host_emu)
#else
  return 0;                   // nvcc's host pass: never runs
#endif
}

extern "C" __global__ void span_stamp_kernel(long long* state, long long* ring, int capacity,
                                             long long word, const long long* id_slot,
                                             long long id) {
  if (threadIdx.x != 0 || state[0] == 0) return;
  const unsigned long long now = global_timer_ns();
  const long long value = id_slot != nullptr ? *id_slot : id;
  const unsigned long long slot =
      atomicAdd(reinterpret_cast<unsigned long long*>(state + 1), 1ULL);
  if (slot < static_cast<unsigned long long>(capacity)) {
    long long* entry = ring + 3 * slot;
    entry[0] = word;
    entry[1] = value;
    entry[2] = static_cast<long long>(now);
  }
}

extern "C" __global__ void span_clock_kernel(long long* out) {
  if (threadIdx.x == 0) *out = static_cast<long long>(global_timer_ns());
}

// state: (live flag, next slot) int64 on the device; ring: (capacity, 3)
// int64; id_slot may be null. Returns the launch's CUDA error (0: none).
extern "C" int echoflow_span_stamp(long long* state, long long* ring, int capacity,
                                   long long word, const long long* id_slot, long long id,
                                   cudaStream_t stream) {
  span_stamp_kernel<<<1, 1, 0, stream>>>(state, ring, capacity, word, id_slot, id);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int echoflow_span_clock(long long* out, cudaStream_t stream) {
  span_clock_kernel<<<1, 1, 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}
