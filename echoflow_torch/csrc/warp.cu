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
// pixels. echoflow's Pallas K3 adds its row blocks in grid order, so its
// training repeats bit for bit; fp32 atomics add in whatever order the
// blocks and warps run, and an earlier float4-atomic K3 made two training
// runs from one state drift apart. This K3 sums every element's terms in
// one fixed order, whatever order its blocks run in, by sorting each
// destination's sources (a counting sort: only integer atomics, which are
// order-free, decide where an entry lands, and the sort undoes that):
//   1. count: each source pixel adds 1 to count[dest] for each corner
//      inside the image (integer atomics) and keeps the count it found,
//      its entry's rank in dest's list;
//   2. place: each destination gets a segment of count[dest] slots of the
//      entry list (a warp sums 256 destinations' counts with shuffles and
//      takes its segments with one atomic on a running total);
//   3. fill: each source writes the key corner * N*H*W + source into its
//      rank's slot of each corner's segment (no atomics);
//   4. reduce (`warp_image_grad_kernel<C>`): a thread a destination sorts
//      its segment by key (segments are short, ~4 entries; an insertion
//      sort in place), then, per channel, sums wy (wx g) of each corner's sources
//      in source order from 0 and adds each corner's sum to the element in
//      corner order (top-left, top-right, bottom-left, bottom-right): the
//      order of the plain version's four `index_add_` calls, each of which
//      sums one destination's duplicates before adding them, as torch's
//      deterministic `index_add_` on CUDA does. Every element of d_img is
//      written once (0 where no source lands), so d_img needs no zeroing.
// The scratch (count, the running total, the segments' starts, 4*N*H*W
// ranks and 4*N*H*W entries, int32) comes from the caller; the function
// zeroes the counts itself (cudaMemsetAsync), so a graph of it replays
// from nothing. On an H100 at the label warp's shape it takes about 40 us
// against a 1.2 us byte bound, most of it the reduce pass (PERF.md),
// several times the float4-atomic K3's time.
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
// bit for bit (K2 and K4 bitwise; K3's terms bitwise, and summed in the
// plain version's order of corners and sources).
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

// K3's corners of a source pixel, in the plain version's order: 0 top-left,
// 1 top-right, 2 bottom-left, 3 bottom-right; -1 for a corner outside the
// image. Destinations are flat pixel indices in [0, N*H*W).
struct Dests {
  int d[4];
};

__device__ __forceinline__ Dests dests(const Corner& k, int b, int hw, int w) {
  const int tl = b * hw + k.y0 * w + k.x0;
  return {{tl, k.hx ? tl + 1 : -1, k.hy ? tl + w : -1, k.hx && k.hy ? tl + w + 1 : -1}};
}

// K3, pass 1: count[dest] += 1 for each corner of each source pixel i;
// rank[corner * m + i] = the count before (the entry's slot in dest's
// segment, in the order the atomics arrived).
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel_count(const float* __restrict__ px, const float* __restrict__ py,
                             int* __restrict__ count, int* __restrict__ rank,
                             int n, int h, int w) {
  const int hw = h * w, m = n * hw;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const Dests t = dests(corner(__ldg(px + i), __ldg(py + i), h, w), i / hw, hw, w);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (t.d[q] >= 0) rank[q * m + i] = atomicAdd(count + t.d[q], 1);
}

constexpr int kPlacePerLane = 8;   // consecutive destinations a lane places

// K3, pass 2: start[dest] = the first slot of dest's segment of the entry
// list. A warp takes 32 x kPlacePerLane consecutive destinations, scans
// their counts with shuffles and claims its segments with one atomic on
// the running total: where a warp's segments land depends on the order the
// warps run in; what a destination's segment holds does not.
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel_place(const int* __restrict__ count, int* __restrict__ total,
                             int* __restrict__ start, int m) {
  const int lane = threadIdx.x & 31;
  const int64_t first = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * kPlacePerLane;
  int c[kPlacePerLane];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPlacePerLane; ++j) {
    c[j] = first + j < m ? count[first + j] : 0;
    sum += c[j];
  }
  int inclusive = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, inclusive, off);
    if (lane >= off) inclusive += v;
  }
  int base = 0;
  if (lane == 31 && inclusive > 0) base = atomicAdd(total, inclusive);
  int at = __shfl_sync(kFull, base, 31) + inclusive - sum;
#pragma unroll
  for (int j = 0; j < kPlacePerLane; ++j) {
    if (first + j < m) start[first + j] = at;
    at += c[j];
  }
}

// K3, pass 3: each corner of each source writes its key, corner * m +
// source, into its rank's slot of the corner's segment.
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel_fill(const float* __restrict__ px, const float* __restrict__ py,
                            const int* __restrict__ start, const int* __restrict__ rank,
                            int* __restrict__ entries, int n, int h, int w) {
  const int hw = h * w, m = n * hw;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const Dests t = dests(corner(__ldg(px + i), __ldg(py + i), h, w), i / hw, hw, w);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (t.d[q] >= 0) entries[start[t.d[q]] + rank[q * m + i]] = q * m + i;
}

// K3, pass 4, the sum of one destination's sorted keys key[0..n-1] for the
// channels c0 .. c0 + 3 (those below c): each corner's terms wy (wx g) in
// source order from 0, the corners' sums added in corner order.
__device__ __forceinline__ void sum_sorted(const int* key, int n, const float* __restrict__ gb,
                                           const float* __restrict__ px,
                                           const float* __restrict__ py, int m, int c0, int c,
                                           int hw, int h, int w, float acc[4]) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  int group = -1;
  for (int e = 0; e < n; ++e) {
    const int k = key[e];
    const int q = k / m, src = k - q * m;
    if (q != group) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (group >= 0) acc[j] = __fadd_rn(acc[j], part[j]);
        part[j] = 0.f;
      }
      group = q;
    }
    const Corner t = corner(__ldg(px + src), __ldg(py + src), h, w);
    const float wx = (q & 1) ? t.fx : __fsub_rn(1.f, t.fx);
    const float wy = (q & 2) ? t.fy : __fsub_rn(1.f, t.fy);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < c)
        part[j] = __fadd_rn(part[j], __fmul_rn(wy, __fmul_rn(wx, __ldg(
            gb + (int64_t)(c0 + j) * hw + src))));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc[j] = group >= 0 ? __fadd_rn(acc[j], part[j]) : 0.f;
}

// K3, pass 4: d_img (N, C, H, W), a thread a destination pixel. It sorts
// its segment by key in place (insertion sort: segments hold about 4
// entries at the training shapes, 2-4% more than 8), then per chunk of 4
// channels (C compiled when it is 1-4; 0: any, in chunks) sums each
// corner's terms wy (wx g) in source order from 0 and adds the corner's
// sum to the element, corners in order (`sum_sorted`). (Sorting up to 8
// entries in registers with every gather issued at once, or up to 32 in
// shared memory, measured no faster.)
template <int C>
__global__ void __launch_bounds__(kThreads)
warp_image_grad_kernel(const float* __restrict__ g, const float* __restrict__ px,
                       const float* __restrict__ py, const int* __restrict__ count,
                       const int* __restrict__ start, int* __restrict__ entries,
                       float* __restrict__ dimg, int n, int c_any, int h, int w) {
  const int c = C > 0 ? C : c_any;
  const int hw = h * w, m = n * hw;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= m) return;
  const int b = d / hw, p = d - b * hw;
  const int size = count[d], begin = start[d];
  const float* gb = g + (int64_t)b * c * hw - (int64_t)b * hw;   // + source index
  float* out = dimg + (int64_t)b * c * hw + p;
  int* list = entries + begin;
  for (int a = 1; a < size; ++a) {
    const int k = list[a];
    int z = a;
    for (; z > 0 && list[z - 1] > k; --z) list[z] = list[z - 1];
    list[z] = k;
  }
  for (int c0 = 0; c0 < c; c0 += 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    sum_sorted(list, size, gb, px, py, m, c0, c, hw, h, w, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < c) out[(int64_t)(c0 + j) * hw] = acc[j];
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

// K3's scratch, in int32: count[m], the running total, start[m], rank[4 m]
// and entries[4 m], m = N*H*W.
inline int64_t image_grad_scratch(int n, int h, int w) {
  return 10 * (int64_t)n * h * w + 1;
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

// int32 elements of scratch the caller passes to echoflow_warp_image_grad.
extern "C" long long echoflow_warp_image_grad_scratch(int n, int c, int h, int w) {
  (void)c;
  return image_grad_scratch(n, h, w);
}

// K3: count, place, fill and reduce (the four passes above) on the stream,
// the counts zeroed first. The scratch needs no zeroing; d_img needs none
// either (pass 4 writes every element). Refuses 2^29 pixels or more (the
// entry keys, corner * N*H*W + source, are int).
extern "C" int echoflow_warp_image_grad(const void* g, const void* px, const void* py,
                                        void* dimg, void* scratch, int n, int c, int h, int w,
                                        void* stream) {
  const int64_t m = (int64_t)n * h * w;
  if (m == 0 || c == 0) return 0;
  if (4 * m >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto G = static_cast<const float*>(g);
  const auto X = static_cast<const float*>(px);
  const auto Y = static_cast<const float*>(py);
  const auto D = static_cast<float*>(dimg);
  int* count = static_cast<int*>(scratch);
  int* total = count + m;
  int* start = total + 1;
  int* rank = start + m;
  int* entries = rank + 4 * m;
  const cudaError_t err = cudaMemsetAsync(count, 0, (size_t)(m + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = blocks_for(n, h, w);
  const int64_t per_block = (int64_t)kThreads * kPlacePerLane;
  const unsigned place_blocks = (unsigned)((m + per_block - 1) / per_block);
  warp_image_grad_kernel_count<<<blocks, kThreads, 0, s>>>(X, Y, count, rank, n, h, w);
  warp_image_grad_kernel_place<<<place_blocks, kThreads, 0, s>>>(count, total, start, (int)m);
  warp_image_grad_kernel_fill<<<blocks, kThreads, 0, s>>>(X, Y, start, rank, entries, n, h, w);
#define ECHOFLOW_K3(CC)                                                                      \
  warp_image_grad_kernel<CC><<<blocks, kThreads, 0, s>>>(G, X, Y, count, start, entries, D,  \
                                                         n, c, h, w)
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
