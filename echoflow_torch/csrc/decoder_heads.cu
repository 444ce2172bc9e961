// Fused MotionNet decoder tail for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of
// echoflow/ops/pallas/decoder_kernel.py (called by `fused_decoder_heads`).
// For every (clip, frame, output pixel) it computes
//
//     y   = relu(sum_r bilinear_up(proj_r)[pixel] + b1)        (64 ch)
//     z_d = relu(W2[:, d] . y + b2[d])                          (64 ch)
//     seg = Ws^T z + bs,   motion = tanh(Wm^T z + bm)           (2 / 4 ch)
//
// reading only the native-resolution 64-channel projections and writing
// only the 2 (+4) output channels: the full-resolution 64-channel
// activations never reach device memory.
//
// What bounds it on an H100: at the main path's shapes (4 sources at
// 56/28/14/7 squared, 112x112 output) a frame reads ~1.07 MB and does
// ~10.5 kFLOP per output pixel (upsample 2,048, comb2 8,192, seg head 256),
// about 123 FLOP per byte in fp32 on CUDA cores, far above the card's ~20
// FLOP/byte balance point (67 TFLOP/s / 3.35 TB/s): it is bound by
// operations, mostly the 64x64 comb2.
//
// What the design does about that: one thread per output pixel keeps its
// 64-channel sum in registers; comb2 runs one output channel at a time,
// folded straight into the head sums, so no second 64-vector is held.
// W2 (transposed), b1, b2 and the head weights sit in shared memory and are
// read as float4 broadcasts (one shared load feeds four FMAs), four partial
// sums per output channel keep the FMA pipes busy. The bilinear corners
// come from per-axis (lo, hi, w_lo, w_hi) tables that the wrapper derives
// from the same float32 resize matrices as the plain version, so the
// upsample weights are bitwise those of the plain version. fp32 operands
// and fp32 accumulation throughout.
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// every int is int. The kernel launches on the given stream, allocates
// nothing and does not synchronise; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kC = 64;       // projection channels (comb1 output)
constexpr int kC2 = 64;      // comb2 output channels
constexpr int kSeg = 2;
constexpr int kMot = 4;
constexpr int kMaxSrc = 4;
constexpr int kThreads = 128;

struct Sources {
  const float* p[kMaxSrc];   // (B*T, h, w, 64) channels-last, contiguous
  int h[kMaxSrc];
  int w[kMaxSrc];
  int n;
};

template <bool kWithMotion>
__global__ void __launch_bounds__(kThreads)
decoder_heads_kernel(Sources src,
                     const int2* __restrict__ y_idx, const float2* __restrict__ y_w,
                     const int2* __restrict__ x_idx, const float2* __restrict__ x_w,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ ws,
                     const float* __restrict__ bs, const float* __restrict__ wm,
                     const float* __restrict__ bm,
                     float* __restrict__ seg_out, float* __restrict__ mot_out,
                     int t_len, int h_out, int w_out) {
  __shared__ float4 s_w2t[kC2 * kC / 4];   // row d holds W2[:, d]
  __shared__ float s_b1[kC];
  __shared__ float s_b2[kC2];
  __shared__ float s_ws[kC2 * kSeg];
  __shared__ float s_wm[kC2 * kMot];

  float* w2t = reinterpret_cast<float*>(s_w2t);
  for (int i = threadIdx.x; i < kC * kC2; i += kThreads) {
    const int c = i / kC2, d = i - c * kC2;    // w2 is (C, C2) row-major
    w2t[d * kC + c] = w2[i];
  }
  for (int i = threadIdx.x; i < kC; i += kThreads) s_b1[i] = b1[i];
  for (int i = threadIdx.x; i < kC2; i += kThreads) s_b2[i] = b2[i];
  for (int i = threadIdx.x; i < kC2 * kSeg; i += kThreads) s_ws[i] = ws[i];
  if (kWithMotion) {
    for (int i = threadIdx.x; i < kC2 * kMot; i += kThreads) s_wm[i] = wm[i];
  }
  __syncthreads();

  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= h_out * w_out) return;
  const int y = pix / w_out;
  const int x = pix - y * w_out;
  const size_t frame = (size_t)blockIdx.z * t_len + blockIdx.y;

  float acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0.f;

  for (int r = 0; r < src.n; ++r) {
    const int hr = src.h[r], wr = src.w[r];
    const int2 yi = y_idx[r * h_out + y];
    const float2 yw = y_w[r * h_out + y];
    const int2 xi = x_idx[r * w_out + x];
    const float2 xw = x_w[r * w_out + x];
    const float* base = src.p[r] + frame * hr * wr * kC;
    // Corners: (row lo | hi) x (col lo | hi); 16 float4 per 64-ch vector.
    const float4* q00 = reinterpret_cast<const float4*>(base + ((size_t)yi.x * wr + xi.x) * kC);
    const float4* q10 = reinterpret_cast<const float4*>(base + ((size_t)yi.y * wr + xi.x) * kC);
    const float4* q01 = reinterpret_cast<const float4*>(base + ((size_t)yi.x * wr + xi.y) * kC);
    const float4* q11 = reinterpret_cast<const float4*>(base + ((size_t)yi.y * wr + xi.y) * kC);
#pragma unroll
    for (int v = 0; v < kC / 4; ++v) {
      const float4 a = __ldg(q00 + v), b = __ldg(q10 + v);
      const float4 c = __ldg(q01 + v), d = __ldg(q11 + v);
      // Rows first (the plain version's H resize), then columns (W resize).
      acc[4 * v + 0] += xw.x * (yw.x * a.x + yw.y * b.x) + xw.y * (yw.x * c.x + yw.y * d.x);
      acc[4 * v + 1] += xw.x * (yw.x * a.y + yw.y * b.y) + xw.y * (yw.x * c.y + yw.y * d.y);
      acc[4 * v + 2] += xw.x * (yw.x * a.z + yw.y * b.z) + xw.y * (yw.x * c.z + yw.y * d.z);
      acc[4 * v + 3] += xw.x * (yw.x * a.w + yw.y * b.w) + xw.y * (yw.x * c.w + yw.y * d.w);
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = fmaxf(acc[c] + s_b1[c], 0.f);

  float seg[kSeg] = {0.f, 0.f};
  float mot[kMot] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int d = 0; d < kC2; ++d) {
    const float4* row = s_w2t + d * (kC / 4);
    float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
#pragma unroll
    for (int v = 0; v < kC / 4; ++v) {
      const float4 w = row[v];
      z0 = fmaf(acc[4 * v + 0], w.x, z0);
      z1 = fmaf(acc[4 * v + 1], w.y, z1);
      z2 = fmaf(acc[4 * v + 2], w.z, z2);
      z3 = fmaf(acc[4 * v + 3], w.w, z3);
    }
    const float z = fmaxf((z0 + z1) + (z2 + z3) + s_b2[d], 0.f);
#pragma unroll
    for (int k = 0; k < kSeg; ++k) seg[k] = fmaf(z, s_ws[d * kSeg + k], seg[k]);
    if (kWithMotion) {
#pragma unroll
      for (int k = 0; k < kMot; ++k) mot[k] = fmaf(z, s_wm[d * kMot + k], mot[k]);
    }
  }

  const size_t o = frame * h_out * w_out + pix;
  reinterpret_cast<float2*>(seg_out)[o] = make_float2(seg[0] + bs[0], seg[1] + bs[1]);
  if (kWithMotion) {
    reinterpret_cast<float4*>(mot_out)[o] =
        make_float4(tanhf(mot[0] + bm[0]), tanhf(mot[1] + bm[1]),
                    tanhf(mot[2] + bm[2]), tanhf(mot[3] + bm[3]));
  }
}

}  // namespace

extern "C" int echoflow_decoder_heads(
    const void* p0, const void* p1, const void* p2, const void* p3,
    int h0, int w0, int h1, int w1, int h2, int w2_, int h3, int w3,
    int n_src,
    const void* y_idx, const void* y_w, const void* x_idx, const void* x_w,
    const void* b1, const void* w2, const void* b2, const void* ws,
    const void* bs, const void* wm, const void* bm,
    void* seg_out, void* mot_out,
    int batch, int t_len, int h_out, int w_out, int with_motion,
    void* stream) {
  if (n_src < 1 || n_src > kMaxSrc) return (int)cudaErrorInvalidValue;
  Sources src;
  const void* ps[kMaxSrc] = {p0, p1, p2, p3};
  const int hs[kMaxSrc] = {h0, h1, h2, h3};
  const int wsz[kMaxSrc] = {w0, w1, w2_, w3};
  for (int r = 0; r < kMaxSrc; ++r) {
    src.p[r] = static_cast<const float*>(ps[r]);
    src.h[r] = hs[r];
    src.w[r] = wsz[r];
  }
  src.n = n_src;
  const dim3 grid((h_out * w_out + kThreads - 1) / kThreads, t_len, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EF_ARGS                                                                  \
  src, static_cast<const int2*>(y_idx), static_cast<const float2*>(y_w),        \
      static_cast<const int2*>(x_idx), static_cast<const float2*>(x_w),         \
      static_cast<const float*>(b1), static_cast<const float*>(w2),             \
      static_cast<const float*>(b2), static_cast<const float*>(ws),             \
      static_cast<const float*>(bs), static_cast<const float*>(wm),             \
      static_cast<const float*>(bm), static_cast<float*>(seg_out),              \
      static_cast<float*>(mot_out), t_len, h_out, w_out
  if (with_motion) {
    decoder_heads_kernel<true><<<grid, kThreads, 0, s>>>(EF_ARGS);
  } else {
    decoder_heads_kernel<false><<<grid, kThreads, 0, s>>>(EF_ARGS);
  }
#undef EF_ARGS
  return (int)cudaGetLastError();
}
