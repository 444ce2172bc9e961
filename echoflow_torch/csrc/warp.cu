// Bilinear border-clamped warp for Hopper (sm_90a): forward and both
// backward kernels of `echoflow_torch.ops.warp_kernel.WarpCoords`.
//
// Replaces the three TPU kernels of echoflow/ops/pallas/warp_kernel.py:
//   K2 `_fwd_kernel`        (called by `warp_pallas_coords` / `_warp_fwd_impl`)
//   K3 `_bwd_dimg_kernel`   (called by `_warp_bwd_rule`)
//   K4 `_bwd_dflow_kernel`  (called by `_warp_bwd_rule`)
//
// Semantics (grid_sample, align_corners=False, padding_mode='border', at
// unclamped pixel coordinates px, py):
//
//   x = clamp(px, 0, W-1), x0 = floor(x), fx = x - x0   (y likewise)
//   out[c] = top + (bot - top) fy,  top = v00 + (v01 - v00) fx,
//                                   bot = v10 + (v11 - v10) fx
//
// with the x0+1 / y0+1 corners clamped to the image in the forward. The
// backward differentiates the Pallas kernel's one-hot weights
// R = (1-fy) 1[y0] + fy 1[y0+1] and C = (1-fx) 1[x0] + fx 1[x0+1], whose
// x0+1 = W (y0+1 = H) column falls outside the image and weighs nothing:
//
//   K3  d_img[c, y0(+1), x0(+1)] += wy (wx g[c])        (four corners)
//   K4  d_px = [0 <= px <= W-1] sum_c g[c] ((1-fy)(v01-v00) + fy (v11-v10))
//       d_py = [0 <= py <= H-1] sum_c g[c] ((1-fx)(v10-v00) + fx (v11-v01))
//       where a corner outside the image reads 0.
//
// At a raw coordinate of exactly W-1, K4 gives -sum_c g v(y, W-1) as the
// Pallas kernel does; the gather formulation's autodiff gives 0 there.
//
// What bounds them on an H100: each kernel moves its tensors once (image
// and output N*C*H*W floats, coordinates 2*N*H*W) and does ~6-12 FLOP per
// element, far below the card's ~20 FLOP/byte balance: they are bound by
// bytes, and at the training path's shapes (8 x 4 x 112 x 112, about 4 MB
// per call, ~1.2 us at 3.35 TB/s) by the launch itself.
//
// What the design does about that: one thread per output pixel computes
// its corners and weights once and loops over the channels, so the
// coordinates are read once and neighbouring threads read neighbouring
// pixels (coalesced coordinate and output traffic; the four corner loads
// of a warp fall on at most a few rows of the image, which L1/L2 serve).
// The TPU kernel's one-hot matrices and MXU row interpolation were a
// workaround for slow TPU gathers and are not carried over: a Hopper thread
// gathers its four corners directly, for any H and W. K3 scatters with
// fp32 atomicAdd, so its sums are taken in an order that changes from run
// to run (the Pallas kernel accumulated in order in VMEM); the wrapper
// zeroes d_img. Arithmetic uses __fadd_rn/__fmul_rn so no multiply-add is
// contracted: every value the plain PyTorch versions compute elementwise
// is reproduced bit for bit, and only K3's summation order differs.
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// every int is int. Each function launches on the given stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Corner {
  int x0, y0;      // top-left corner, inside the image
  float fx, fy;    // fractions of the clamped coordinate
  bool hx, hy;     // x0 + 1 < W, y0 + 1 < H
};

__device__ __forceinline__ Corner corner(float px, float py, int h, int w) {
  const float x = fminf(fmaxf(px, 0.f), (float)(w - 1));
  const float y = fminf(fmaxf(py, 0.f), (float)(h - 1));
  const float x0 = floorf(x), y0 = floorf(y);
  Corner k;
  k.x0 = (int)x0;
  k.y0 = (int)y0;
  k.fx = __fsub_rn(x, x0);
  k.fy = __fsub_rn(y, y0);
  k.hx = k.x0 + 1 < w;
  k.hy = k.y0 + 1 < h;
  return k;
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), f));   // a + (b - a) f
}

// K2: out (N, C, H, W) = bilinear sample of img at (px, py) (N, H, W).
__global__ void __launch_bounds__(kThreads)
warp_forward_kernel(const float* __restrict__ img, const float* __restrict__ px,
                    const float* __restrict__ py, float* __restrict__ out,
                    int n, int c, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n * hw) return;
  const int64_t b = i / hw, p = i - b * hw;
  const Corner k = corner(px[i], py[i], h, w);
  const int x1 = k.hx ? k.x0 + 1 : k.x0, y1 = k.hy ? k.y0 + 1 : k.y0;
  const int64_t o00 = (int64_t)k.y0 * w + k.x0, o01 = (int64_t)k.y0 * w + x1;
  const int64_t o10 = (int64_t)y1 * w + k.x0, o11 = (int64_t)y1 * w + x1;
  const float* src = img + b * c * hw;
  float* dst = out + b * c * hw + p;
  for (int ch = 0; ch < c; ++ch) {
    const float* s = src + ch * hw;
    const float top = lerp_rn(__ldg(s + o00), __ldg(s + o01), k.fx);
    const float bot = lerp_rn(__ldg(s + o10), __ldg(s + o11), k.fx);
    dst[ch * hw] = lerp_rn(top, bot, k.fy);
  }
}

// K3: d_img (N, C, H, W), zeroed by the caller, += the four weighted g.
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel(const float* __restrict__ g, const float* __restrict__ px,
                       const float* __restrict__ py, float* __restrict__ dimg,
                       int n, int c, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n * hw) return;
  const int64_t b = i / hw, p = i - b * hw;
  const Corner k = corner(px[i], py[i], h, w);
  const float wx0 = __fsub_rn(1.f, k.fx), wy0 = __fsub_rn(1.f, k.fy);
  const int64_t o00 = (int64_t)k.y0 * w + k.x0;
  const float* gs = g + b * c * hw + p;
  float* d = dimg + b * c * hw;
  for (int ch = 0; ch < c; ++ch) {
    const float gv = gs[ch * hw];
    float* dc = d + ch * hw + o00;
    const float gx0 = __fmul_rn(wx0, gv), gx1 = __fmul_rn(k.fx, gv);
    atomicAdd(dc, __fmul_rn(wy0, gx0));
    if (k.hx) atomicAdd(dc + 1, __fmul_rn(wy0, gx1));
    if (k.hy) atomicAdd(dc + w, __fmul_rn(k.fy, gx0));
    if (k.hx && k.hy) atomicAdd(dc + w + 1, __fmul_rn(k.fy, gx1));
  }
}

// K4: d_px, d_py (N, H, W): the channel sum of g times the derivative of
// the bilinear weights, zeroed where the raw coordinate leaves [0, size-1].
__global__ void __launch_bounds__(kThreads)
warp_coord_grad_kernel(const float* __restrict__ img, const float* __restrict__ g,
                       const float* __restrict__ px, const float* __restrict__ py,
                       float* __restrict__ dpx, float* __restrict__ dpy,
                       int n, int c, int h, int w) {
  const int64_t hw = (int64_t)h * w;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (int64_t)n * hw) return;
  const int64_t b = i / hw, p = i - b * hw;
  const float rx = px[i], ry = py[i];
  const Corner k = corner(rx, ry, h, w);
  const float wx0 = __fsub_rn(1.f, k.fx), wy0 = __fsub_rn(1.f, k.fy);
  const int64_t o00 = (int64_t)k.y0 * w + k.x0;
  const float* src = img + b * c * hw + o00;
  const float* gs = g + b * c * hw + p;
  float ax = 0.f, ay = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float* s = src + ch * hw;
    const float v00 = __ldg(s);
    const float v01 = k.hx ? __ldg(s + 1) : 0.f;
    const float v10 = k.hy ? __ldg(s + w) : 0.f;
    const float v11 = (k.hx && k.hy) ? __ldg(s + w + 1) : 0.f;
    const float ddx = __fadd_rn(__fmul_rn(wy0, __fsub_rn(v01, v00)),
                                __fmul_rn(k.fy, __fsub_rn(v11, v10)));
    const float ddy = __fadd_rn(__fmul_rn(wx0, __fsub_rn(v10, v00)),
                                __fmul_rn(k.fx, __fsub_rn(v11, v01)));
    const float gv = gs[ch * hw];
    ax = __fadd_rn(ax, __fmul_rn(gv, ddx));
    ay = __fadd_rn(ay, __fmul_rn(gv, ddy));
  }
  dpx[i] = (rx >= 0.f && rx <= (float)(w - 1)) ? ax : 0.f;
  dpy[i] = (ry >= 0.f && ry <= (float)(h - 1)) ? ay : 0.f;
}

inline unsigned blocks_for(int n, int h, int w) {
  return (unsigned)(((int64_t)n * h * w + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int echoflow_warp_forward(const void* img, const void* px, const void* py,
                                     void* out, int n, int c, int h, int w, void* stream) {
  if ((int64_t)n * h * w == 0 || c == 0) return 0;
  warp_forward_kernel<<<blocks_for(n, h, w), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(px),
      static_cast<const float*>(py), static_cast<float*>(out), n, c, h, w);
  return (int)cudaGetLastError();
}

extern "C" int echoflow_warp_image_grad(const void* g, const void* px, const void* py,
                                        void* dimg, int n, int c, int h, int w,
                                        void* stream) {
  if ((int64_t)n * h * w == 0 || c == 0) return 0;
  warp_image_grad_kernel<<<blocks_for(n, h, w), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(px),
      static_cast<const float*>(py), static_cast<float*>(dimg), n, c, h, w);
  return (int)cudaGetLastError();
}

extern "C" int echoflow_warp_coord_grad(const void* img, const void* g, const void* px,
                                        const void* py, void* dpx, void* dpy,
                                        int n, int c, int h, int w, void* stream) {
  if ((int64_t)n * h * w == 0) return 0;
  warp_coord_grad_kernel<<<blocks_for(n, h, w), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(g),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<float*>(dpx), static_cast<float*>(dpy), n, c, h, w);
  return (int)cudaGetLastError();
}
