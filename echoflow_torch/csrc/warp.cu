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
// per call, ~1.2 us at 3.35 TB/s) by the launch itself (an empty grid of
// the same size takes ~1 us on the card).
//
// K2: one thread per output pixel reads its coordinates and computes its
// corners and weights once, for one image or for two images that share the
// coordinates (the training chain step warps its label stack and its video
// stack at the same px, py: one launch instead of two, whose floor is
// about 1 us each). The TPU kernel's one-hot matrices and MXU row
// interpolation were a workaround for slow TPU gathers and are not carried
// over: a Hopper thread gathers its four corners directly, for any H and
// W. The kernel is compiled for 1-4 channels per image (and a generic
// version in chunks of 4), and a thread issues every corner load of a
// chunk, of both images, before its arithmetic: two dependent round trips
// (coordinates, then corners). Taking the x0 + 1 corners from the next lane
// by shuffle, as K4 does, measured slower here (the shuffles wait on the
// neighbour's loads; the loads they replace hit the same L1 lines). Under
// rough motion the scattered gathers bound it, and what decides their cost
// is how many contiguous pixels an SM holds: the corners of neighbouring
// pixels overlap in L1. So the block is about one SM's share of the pixels
// (768 threads at the chain step), not 256 threads that several SMs take
// in turns (PERF.md).
//
// K3 is a scatter: every pixel adds a term to each of its four corners in
// every channel, and each element of d_img takes terms from about four
// pixels. On an H100 what bounds it is the count of atomics each thread
// issues, not their bytes: 4*C scalar fp32 atomics per pixel (one per
// corner and channel, four channel planes apart) cost 6-10 us at the
// label shape under near-identity to smooth motion and 22 us under rough
// motion, where the same terms as one 16-byte atomic per corner (4
// channels) cost 3.4-3.8 and 5.9 us (PERF.md). Summing in shared memory
// instead does not pay here: fp32 atomicAdd on shared memory compiles to
// a compare-and-swap loop (ATOMS.CAST.SPIN), and every window design
// measured slower than the parent on smooth motion. So K3 makes two launches:
//   1. scatter into a zeroed channels-last scratch accumulator (N*H*W x C
//      rounded up to 4): one float4 atomicAdd (sm_90) carries a corner's 4
//      channels; lanes hold consecutive pixels, and where a pixel's right
//      corner is the next pixel's left corner a shuffle joins the two
//      terms, so under smooth motion a row costs one atomic per pixel, not
//      two;
//   2. transpose the accumulator into d_img (N, C, H, W) with plain
//      stores: every element is written once, so d_img needs no memset
//      (the scratch does; the caller zeroes it).
// Both are bound by latency and the launch (an empty grid of the same size
// takes ~1 us), not by the 1.2 us byte bound. The summation order is still
// run-dependent (atomics arrive in any order, and a joined pair is summed
// before its atomic), so K3 holds its per-element bound
// (`image_grad_tolerance`) and is not bitwise reproducible.
//
// K4 is a gather: per pixel 4*C corner loads and C loads of g, then a
// channel sum. With C a runtime loop each channel's loads waited on the
// previous channel's, C round trips to memory per thread. The kernel is
// templated on C (1-4, and a generic version in chunks of 4 channels), so a
// thread issues all loads of a chunk before its arithmetic, and, where the
// next lane's pixel has the next corner in at least half the warp (smooth
// motion), takes its own x0 + 1 corners from that lane by a shuffle
// instead of loading them. It
// is bound by two dependent round trips (coordinates, then corners) and
// the launch; under rough motion by the scattered gathers.
//
// Arithmetic uses __fadd_rn/__fmul_rn so no multiply-add is contracted:
// every value the plain PyTorch versions compute elementwise is reproduced
// bit for bit (K2 and K4 bitwise; K3's terms bitwise, their sums in another
// order).
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// every int is int. Each function launches on the given stream, allocates
// nothing (K3's scratch comes from the caller, sized by
// echoflow_warp_image_grad_scratch), does not synchronise and returns a
// cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// K2's corner values of K channels (c0 .. c0 + K - 1, those below c) at one
// pixel, with x1 = x0 + dx and y1 = y0 + dy / w clamped to the image.
template <int K>
struct Taps {
  float v00[K], v01[K], v10[K], v11[K];

  __device__ __forceinline__ void load(const float* s, int c0, int c, int hw, int dx, int dy) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const bool ch = c0 + j < c;
      const float* sj = s + (c0 + j) * hw;
      v00[j] = ch ? __ldg(sj) : 0.f;
      v01[j] = ch ? __ldg(sj + dx) : 0.f;
      v10[j] = ch ? __ldg(sj + dy) : 0.f;
      v11[j] = ch ? __ldg(sj + dy + dx) : 0.f;
    }
  }

  // top = v00 + (v01 - v00) fx, bot likewise, out = top + (bot - top) fy:
  // the plain version's order, each step rounded.
  __device__ __forceinline__ void store(float* d, int c0, int c, int hw, float fx,
                                        float fy) const {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (c0 + j < c)
        d[(c0 + j) * hw] = lerp_rn(lerp_rn(v00[j], v01[j], fx), lerp_rn(v10[j], v11[j], fx), fy);
  }
};

constexpr int kAny = -1;          // a channel count known only at run time
constexpr int kForwardMax = 1024;  // K2's largest block

// K2: out_a (N, CA, H, W) and, unless CB = 0, out_b (N, CB, H, W): the
// bilinear samples of img_a and img_b at (px, py) (N, H, W). CA, CB: 1-4
// compiled, kAny: any count (ca_any, cb_any), in chunks of 4. Per chunk of
// 4 channels (one chunk when both counts are compiled) every corner load of
// both images is issued before any arithmetic. The block size is chosen at
// launch (`forward_threads`). Offsets are int: the host refuses images of
// 2^31 elements or more.
template <int CA, int CB>
__global__ void __launch_bounds__(kForwardMax)
warp_forward_kernel(const float* __restrict__ img_a, const float* __restrict__ img_b,
                    const float* __restrict__ px, const float* __restrict__ py,
                    float* __restrict__ out_a, float* __restrict__ out_b,
                    int n, int ca_any, int cb_any, int h, int w) {
  constexpr int KA = CA > 0 ? CA : 4, KB = CB > 0 ? CB : 4;
  const int ca = CA > 0 ? CA : ca_any;
  const int cb = CB == kAny ? cb_any : CB;
  const int hw = h * w, total = n * hw;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / hw, p = i - b * hw;
  const Corner k = corner(__ldg(px + i), __ldg(py + i), h, w);
  const int o00 = k.y0 * w + k.x0;
  const int dx = k.hx ? 1 : 0, dy = k.hy ? w : 0;
  const float* sa = img_a + b * ca * hw + o00;
  const float* sb = CB != 0 ? img_b + b * cb * hw + o00 : nullptr;
  float* da = out_a + b * ca * hw + p;
  float* db = CB != 0 ? out_b + b * cb * hw + p : nullptr;
  const int c = ca > cb ? ca : cb;
  for (int c0 = 0; c0 < c; c0 += 4) {
    Taps<KA> ta;
    Taps<KB> tb;
    ta.load(sa, c0, ca, hw, dx, dy);
    if (CB != 0) tb.load(sb, c0, cb, hw, dx, dy);
    ta.store(da, c0, ca, hw, k.fx, k.fy);
    if (CB != 0) tb.store(db, c0, cb, hw, k.fx, k.fy);
  }
}

// K3 helper: whether a lane's row term joins its neighbours'. Lanes hold
// consecutive pixels, and under smooth motion a pixel's right corner
// (key_r) is the next pixel's left corner (key): the next lane then adds
// this lane's right term to its left term ("take") and this lane skips its
// own atomic for it ("give"). Keys are flat pixel indices, -1 for none.
struct RowJoin {
  bool take, give;
};

__device__ __forceinline__ RowJoin row_join(int key, int key_r) {
  const int lane = threadIdx.x & 31;
  const int prev_r = __shfl_up_sync(kFull, key_r, 1);
  const int next = __shfl_down_sync(kFull, key, 1);
  return {lane > 0 && key >= 0 && prev_r == key, lane < 31 && key_r >= 0 && next == key_r};
}

// K3, pass 1: scatter. acc is a zeroed channels-last accumulator, N*H*W
// pixels x C4 floats (C rounded up to 4). A thread takes a pixel and, per
// chunk of 4 channels (C compiled when it is 1-4; 0: any, in chunks), adds
// its corners' terms to acc with 16-byte atomics: one atomic carries a
// corner's 4 channels. A row's right term is joined to the next lane's
// left term where they meet.
template <int C>
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel(const float* __restrict__ g, const float* __restrict__ px,
                       const float* __restrict__ py, float* __restrict__ acc,
                       int n, int c_any, int h, int w) {
  const int c = C > 0 ? C : c_any;
  const int c4 = (c + 3) & ~3;
  const int hw = h * w, total = n * hw;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool on = i < total;
  const int q = on ? i : 0;
  const int b = q / hw, p = q - b * hw;
  const Corner k = corner(__ldg(px + q), __ldg(py + q), h, w);
  const int kt = on ? b * hw + k.y0 * w + k.x0 : -1;
  const int kb = on && k.hy ? kt + w : -1;
  const RowJoin jt = row_join(kt, kt >= 0 && k.hx ? kt + 1 : -1);
  const RowJoin jb = row_join(kb, kb >= 0 && k.hx ? kb + 1 : -1);
  const float wx0 = __fsub_rn(1.f, k.fx), wy0 = __fsub_rn(1.f, k.fy);
  const float* gs = g + (int64_t)b * c * hw + p;
  for (int c0 = 0; c0 < c; c0 += 4) {
    float tl[4], tr[4], bl[4], br[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gv = on && c0 + j < c ? __ldg(gs + (int64_t)(c0 + j) * hw) : 0.f;
      const float gx0 = __fmul_rn(wx0, gv), gx1 = __fmul_rn(k.fx, gv);
      tl[j] = __fmul_rn(wy0, gx0);
      tr[j] = __fmul_rn(wy0, gx1);
      bl[j] = __fmul_rn(k.fy, gx0);
      br[j] = __fmul_rn(k.fy, gx1);
      const float tr_prev = __shfl_up_sync(kFull, tr[j], 1);
      const float br_prev = __shfl_up_sync(kFull, br[j], 1);
      if (jt.take) tl[j] = __fadd_rn(tl[j], tr_prev);
      if (jb.take) bl[j] = __fadd_rn(bl[j], br_prev);
    }
    if (!on) continue;
    float4* at = reinterpret_cast<float4*>(acc + (int64_t)kt * c4 + c0);
    atomicAdd(at, make_float4(tl[0], tl[1], tl[2], tl[3]));
    if (k.hx && !jt.give) atomicAdd(at + c4 / 4, make_float4(tr[0], tr[1], tr[2], tr[3]));
    if (k.hy) {
      float4* ab = reinterpret_cast<float4*>(acc + (int64_t)kb * c4 + c0);
      atomicAdd(ab, make_float4(bl[0], bl[1], bl[2], bl[3]));
      if (k.hx && !jb.give) atomicAdd(ab + c4 / 4, make_float4(br[0], br[1], br[2], br[3]));
    }
  }
}

// K3, pass 2: d_img (N, C, H, W) from acc, a thread a pixel, every element
// written once.
template <int C>
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel_transpose(const float* __restrict__ acc, float* __restrict__ dimg,
                                 int n, int c_any, int h, int w) {
  const int c = C > 0 ? C : c_any;
  const int c4 = (c + 3) & ~3;
  const int hw = h * w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * hw) return;
  const int b = i / hw, p = i - b * hw;
  float* d = dimg + (int64_t)b * c * hw + p;
  for (int c0 = 0; c0 < c; c0 += 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(acc + (int64_t)i * c4 + c0));
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c0 + q < c) d[(int64_t)(c0 + q) * hw] = vs[q];
  }
}

// K4: d_px, d_py (N, H, W): the channel sum of g times the derivative of
// the bilinear weights, zeroed where the raw coordinate leaves [0, size-1].
// A thread takes a pixel; C is compiled (C = 0: any count, in chunks of 4),
// and every load of a chunk is issued before its arithmetic, which keeps
// the plain version's order: per channel its ddx, ddy, then ax += g ddx in
// channel order. Under smooth motion a pixel's right corners (x0 + 1) are
// the next lane's left corners: they come from that lane by a shuffle, the
// same values as a load would give, and only the other lanes load them.
template <int C>
__global__ void __launch_bounds__(kThreads)
warp_coord_grad_kernel(const float* __restrict__ img, const float* __restrict__ g,
                       const float* __restrict__ px, const float* __restrict__ py,
                       float* __restrict__ dpx, float* __restrict__ dpy,
                       int n, int c_any, int h, int w) {
  constexpr int kChunk = C > 0 ? C : 4;
  const int c = C > 0 ? C : c_any;
  const int hw = h * w, total = n * hw;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool on = i < total;
  const int q0 = on ? i : 0;
  const int b = q0 / hw, p = q0 - b * hw;
  const float rx = __ldg(px + q0), ry = __ldg(py + q0);
  const Corner k = corner(rx, ry, h, w);
  const float wx0 = __fsub_rn(1.f, k.fx), wy0 = __fsub_rn(1.f, k.fy);
  const int key = on ? b * hw + k.y0 * w + k.x0 : -1;
  const int key_next = __shfl_down_sync(kFull, key, 1);
  const bool next_holds = (threadIdx.x & 31) < 31 && key >= 0 && k.hx && key_next == key + 1;
  // Shuffles pay only where most of the warp can use them (smooth motion);
  // under scattered motion every lane loads its own corners.
  const unsigned holders = __ballot_sync(kFull, next_holds);
  const bool share = next_holds && __popc(holders) >= 16;
  const float* src = img + (int64_t)b * c * hw + k.y0 * w + k.x0;
  const float* gs = g + (int64_t)b * c * hw + p;
  float ax = 0.f, ay = 0.f;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    float gv[kChunk], v00[kChunk], v01[kChunk], v10[kChunk], v11[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const bool ch = on && (C > 0 || c0 + q < c);
      const float* s = src + (int64_t)(c0 + q) * hw;
      gv[q] = ch ? __ldg(gs + (int64_t)(c0 + q) * hw) : 0.f;
      v00[q] = ch ? __ldg(s) : 0.f;
      v10[q] = ch && k.hy ? __ldg(s + w) : 0.f;
      v01[q] = ch && k.hx && !share ? __ldg(s + 1) : 0.f;
      v11[q] = ch && k.hx && k.hy && !share ? __ldg(s + w + 1) : 0.f;
    }
    if (__any_sync(kFull, share)) {
#pragma unroll
      for (int q = 0; q < kChunk; ++q) {
        const float r0 = __shfl_down_sync(kFull, v00[q], 1);
        const float r1 = __shfl_down_sync(kFull, v10[q], 1);
        if (share) {
          v01[q] = r0;
          v11[q] = k.hy ? r1 : 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (C > 0 || c0 + q < c) {
        const float ddx = __fadd_rn(__fmul_rn(wy0, __fsub_rn(v01[q], v00[q])),
                                    __fmul_rn(k.fy, __fsub_rn(v11[q], v10[q])));
        const float ddy = __fadd_rn(__fmul_rn(wx0, __fsub_rn(v10[q], v00[q])),
                                    __fmul_rn(k.fx, __fsub_rn(v11[q], v01[q])));
        ax = __fadd_rn(ax, __fmul_rn(gv[q], ddx));
        ay = __fadd_rn(ay, __fmul_rn(gv[q], ddy));
      }
    }
  }
  if (!on) return;
  dpx[i] = (rx >= 0.f && rx <= (float)(w - 1)) ? ax : 0.f;
  dpy[i] = (ry >= 0.f && ry <= (float)(h - 1)) ? ay : 0.f;
}

inline unsigned blocks_for(int n, int h, int w) {
  return (unsigned)(((int64_t)n * h * w + kThreads - 1) / kThreads);
}

// K2's block size: about one SM's share of the pixels, 256 to 1024 threads.
// A block covers contiguous pixels (whole rows at the training shapes), so
// under scattered motion the corners its threads gather overlap in the SM's
// L1; blocks that many SMs take in turns would each bring rows from
// elsewhere. At the chain step's 100,352 pixels: 768 threads, 131 blocks.
int forward_threads(int64_t pixels) {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const int64_t share = ((pixels + sms - 1) / sms + 31) / 32 * 32;
  return (int)(share < 256 ? 256 : share > kForwardMax ? kForwardMax : share);
}

struct ForwardArgs {
  const float *img_a, *img_b, *px, *py;
  float *out_a, *out_b;
  int n, ca, cb, h, w;
};

template <int CA, int CB>
void launch_forward(const ForwardArgs& a, int threads, cudaStream_t s) {
  const int64_t pixels = (int64_t)a.n * a.h * a.w;
  warp_forward_kernel<CA, CB><<<(unsigned)((pixels + threads - 1) / threads), threads, 0, s>>>(
      a.img_a, a.img_b, a.px, a.py, a.out_a, a.out_b, a.n, a.ca, a.cb, a.h, a.w);
}

template <int CA>
void launch_forward_cb(const ForwardArgs& a, int threads, cudaStream_t s) {
  switch (a.cb) {
    case 0: launch_forward<CA, 0>(a, threads, s); break;
    case 1: launch_forward<CA, 1>(a, threads, s); break;
    case 2: launch_forward<CA, 2>(a, threads, s); break;
    case 3: launch_forward<CA, 3>(a, threads, s); break;
    case 4: launch_forward<CA, 4>(a, threads, s); break;
    default: launch_forward<CA, kAny>(a, threads, s); break;
  }
}

// K2 for one image (cb = 0) or two at the same coordinates; ca >= 1.
int forward(const ForwardArgs& a, int threads, void* stream) {
  const int64_t pixels = (int64_t)a.n * a.h * a.w;
  if (pixels == 0) return 0;
  if (a.ca < 1 || a.cb < 0 || pixels * (a.ca > a.cb ? a.ca : a.cb) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (a.ca) {
    case 1: launch_forward_cb<1>(a, threads, s); break;
    case 2: launch_forward_cb<2>(a, threads, s); break;
    case 3: launch_forward_cb<3>(a, threads, s); break;
    case 4: launch_forward_cb<4>(a, threads, s); break;
    default: launch_forward_cb<kAny>(a, threads, s); break;
  }
  return (int)cudaGetLastError();
}

// K3's scratch, in floats: the channels-last accumulator.
inline int64_t image_grad_scratch(int n, int c, int h, int w) {
  return (int64_t)n * h * w * ((c + 3) & ~3);
}

}  // namespace

extern "C" int echoflow_warp_forward(const void* img, const void* px, const void* py,
                                     void* out, int n, int c, int h, int w, void* stream) {
  if (c == 0) return 0;
  return forward({static_cast<const float*>(img), nullptr, static_cast<const float*>(px),
                  static_cast<const float*>(py), static_cast<float*>(out), nullptr,
                  n, c, 0, h, w}, forward_threads((int64_t)n * h * w), stream);
}

// K2 for two images (N, ca, H, W) and (N, cb, H, W), ca, cb >= 1, sampled
// at the same coordinates in one launch.
extern "C" int echoflow_warp_forward2(const void* img_a, const void* img_b, const void* px,
                                      const void* py, void* out_a, void* out_b,
                                      int n, int ca, int cb, int h, int w, void* stream) {
  if (cb < 1) return (int)cudaErrorInvalidValue;
  return forward({static_cast<const float*>(img_a), static_cast<const float*>(img_b),
                  static_cast<const float*>(px), static_cast<const float*>(py),
                  static_cast<float*>(out_a), static_cast<float*>(out_b),
                  n, ca, cb, h, w}, forward_threads((int64_t)n * h * w), stream);
}

// Floats of scratch the caller passes to echoflow_warp_image_grad.
extern "C" long long echoflow_warp_image_grad_scratch(int n, int c, int h, int w) {
  return image_grad_scratch(n, c, h, w);
}

// K3: scatter into the scratch (the accumulator, zeroed by the caller),
// then write d_img from it. d_img needs no zeroing: pass 2 writes every
// element. The scratch must be 16-byte aligned (the accumulator's vector
// atomics), and its size below 2^31 floats (int pixel indices).
extern "C" int echoflow_warp_image_grad(const void* g, const void* px, const void* py,
                                        void* dimg, void* scratch, int n, int c, int h, int w,
                                        void* stream) {
  if ((int64_t)n * h * w == 0 || c == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(scratch) & 15) != 0 ||
      image_grad_scratch(n, c, h, w) >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto G = static_cast<const float*>(g);
  const auto X = static_cast<const float*>(px);
  const auto Y = static_cast<const float*>(py);
  const auto D = static_cast<float*>(dimg);
  const auto A = static_cast<float*>(scratch);
  const unsigned blocks = blocks_for(n, h, w);
#define ECHOFLOW_K3(CC)                                                              \
  warp_image_grad_kernel<CC><<<blocks, kThreads, 0, s>>>(G, X, Y, A, n, c, h, w);   \
  warp_image_grad_kernel_transpose<CC><<<blocks, kThreads, 0, s>>>(A, D, n, c, h, w)
  switch (c) {
    case 1: ECHOFLOW_K3(1); break;
    case 2: ECHOFLOW_K3(2); break;
    case 3: ECHOFLOW_K3(3); break;
    case 4: ECHOFLOW_K3(4); break;
    default: ECHOFLOW_K3(0); break;
  }
#undef ECHOFLOW_K3
  return (int)cudaGetLastError();
}

extern "C" int echoflow_warp_coord_grad(const void* img, const void* g, const void* px,
                                        const void* py, void* dpx, void* dpy,
                                        int n, int c, int h, int w, void* stream) {
  if ((int64_t)n * h * w == 0) return 0;
  if ((int64_t)n * h * w >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = blocks_for(n, h, w);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto I = static_cast<const float*>(img);
  const auto G = static_cast<const float*>(g);
  const auto X = static_cast<const float*>(px);
  const auto Y = static_cast<const float*>(py);
  const auto DX = static_cast<float*>(dpx);
  const auto DY = static_cast<float*>(dpy);
#define ECHOFLOW_K4(CC) \
  warp_coord_grad_kernel<CC><<<blocks, kThreads, 0, s>>>(I, G, X, Y, DX, DY, n, c, h, w)
  switch (c) {
    case 1: ECHOFLOW_K4(1); break;
    case 2: ECHOFLOW_K4(2); break;
    case 3: ECHOFLOW_K4(3); break;
    case 4: ECHOFLOW_K4(4); break;
    default: ECHOFLOW_K4(0); break;
  }
#undef ECHOFLOW_K4
  return (int)cudaGetLastError();
}
