// Fused MotionNet decoder tail for Hopper (sm_90a), comb2 on the tensor cores.
//
// Replaces the TPU kernel `_kernel` of
// echoflow/ops/pallas/decoder_kernel.py (called by `fused_decoder_heads`).
// For every (clip, frame, output pixel) it computes
//
//     y   = relu(sum_r bilinear_up(proj_r)[pixel] + b1)        (64 ch)
//     z   = relu(y W2 + b2)                                     (64 ch)
//     seg = z Ws + bs,   motion = tanh(z Wm + bm)               (2 / 4 ch)
//
// reading only the native-resolution 64-channel projections and writing
// only the 2 (+4) output channels: the full-resolution 64-channel
// activations never reach device memory.
//
// What bounds it on an H100: at the main path's shapes (4 sources at
// 56/28/14/7 squared, 112x112 output) a pixel needs 2,432 FLOP on the CUDA
// cores (upsample 2,048, +b1/ReLU 128, seg head 256) and the 8,192 FLOP of
// the 64x64 comb2, which runs on the tensor cores as 3xTF32: y and W2 are
// each split into TF32 hi + lo parts (cvt.rna.tf32.f32; fed raw fp32, the
// tensor cores would drop the low 13 bits) and three TF32 products
// lo*W2hi + hi*W2lo + hi*W2hi keep fp32 accuracy, the least-cost route to
// it on this card. At 495 TFLOP/s those 3 x 8,192 FLOP/px set the bound
// (0.60 ms for 30 clips x 32 frames), above the CUDA cores' 0.44 ms and
// memory's 0.33 ms.
//
// What the design does about that:
//  - A tile is up to 64 output pixels of one output row (a row's tiles as
//    even as possible: 2 x 56 at 112 wide), and a warpgroup owns a tile
//    (wgmma's M = 64). A block of four warpgroups, one per SM and
//    persistent, takes a contiguous run of tiles in (frame, row, tile
//    column) order, one tile per warpgroup a round.
//  - The upsample runs in two stages, with lanes over channels. Stage 1
//    loads each source column the tile touches, in both of the row's
//    source rows (a half-warp per column, 16 lanes x float4 = 256
//    contiguous bytes), and blends it over the rows into a column buffer
//    in shared memory: once per tile, however many pixels use it. Stage 2
//    builds comb2's A fragments in registers: a thread blends, for its two
//    pixels and its 16 channels, the two columns of each source, reading 8
//    bytes a column per load. A wgmma row may hold any pixel, so a
//    thread's two rows (g and g + 8) hold neighbouring pixels, which
//    mostly share their columns: a shared column is loaded once for both.
//    A warp load covers 8 pixels, and pixels that read one column share
//    the read. The order is
//    the plain version's, rows first, then columns, with weights that the
//    wrapper reads off the plain version's float32 resize matrices. +b1
//    and ReLU finish y, which never goes through shared memory.
//  - comb2 as 24 wgmma.m64n64k8.tf32 (3 passes x 8 k-steps) with A (y) in
//    registers and B (W2^T, hi and lo, 128-byte swizzled, resident for the
//    block's life) in shared memory, fp32 accumulators in registers. Each
//    k-step's input channels are permuted (in W2^T alike) so that a
//    thread's two values of a row are adjacent channels. It runs in two
//    halves of K, so that one half's hi and lo fragments (32 registers)
//    are live beside the accumulators (16 warps an SM leave 128 registers
//    a thread).
//  - Epilogue in registers: +b2, ReLU, the head dot products over each
//    thread's 16 columns, reduced across the 4 lanes of a quad; only the
//    2 (+4) output channels are stored.
//  - The four warpgroups synchronise within themselves (named barriers)
//    and take turns at comb2, a token passed round-robin on named
//    barriers once a warpgroup has issued its last wgmma: their phases
//    stay staggered, so one upsamples while another uses the tensor cores
//    (in lockstep they reached comb2 together and queued on the tensor
//    cores).
//  - On the card the time goes to each warpgroup's chain of dependent
//    phases (stage 1, stage 2, comb2, epilogue) more than to any one unit:
//    memory, shared memory, the FP32 pipe and the tensor cores each stay
//    well below their rates (PERF.md).
//
// Plain C interface for ctypes: every pointer and the stream are void*,
// every int is int. The kernel launches on the given stream, allocates
// nothing and does not synchronise; the function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // comb2 in and out channels
constexpr int kSeg = 2;
constexpr int kMot = 4;
constexpr int kMaxSrc = 4;
constexpr int kTile = 64;              // output pixels per warpgroup tile (wgmma M)
constexpr int kRowsPerWarp = kTile / 4;
constexpr int kWarpGroups = 4;
constexpr int kThreads = 128 * kWarpGroups;
constexpr int kAtom = 64 * 128;        // 64 rows x 32 fp32 channels, 128-byte swizzle
constexpr int kOperand = 2 * kAtom;    // a 64 x 64 fp32 operand, K-major
// A column of the column buffer: 64 channels padded to 72 floats, so that
// stage 2's reads of 8 pixels x 32 bytes hit distinct banks for up to 4
// consecutive columns.
constexpr int kColStride = 72;
constexpr int kColBytes = kColStride * 4;
// Dynamic shared memory, from a 1024-byte aligned base: W2^T hi, W2^T lo,
// b1, b2, Ws, Wm, each warpgroup's SourceTile sets and x plan, then each
// warpgroup's column buffer of n_cols_max columns (a launch parameter, at
// most `echoflow_decoder_heads_column_budget()`).
constexpr int kSmemParams = 2 * kOperand;
constexpr int kSmemTiles = kSmemParams + (2 * kC + kC * kSeg + kC * kMot) * 4;
constexpr int kSmemTileBytes = 2 * kMaxSrc * 32;   // two sets of SourceTile[4]
constexpr int kSmemXPlan = kSmemTiles + kWarpGroups * kSmemTileBytes;
constexpr int kSmemFixed = kSmemXPlan + kWarpGroups * kMaxSrc * (kTile + 1) * 16;
constexpr int kSmemLimit = 227 * 1024;   // a block's most dynamic shared memory on an H100
constexpr int kColumnBudget = (kSmemLimit - 1024 - kSmemFixed) / (kWarpGroups * kColBytes);

struct Sources {
  const float* p[kMaxSrc];   // (B*T, h, w, 64) channels-last, contiguous
  int h[kMaxSrc];
  int w[kMaxSrc];
  int n;
};

// Byte offset of element (row, k) of a 64 x 64 K-major fp32 operand: two
// atoms of 32 channels; in each, row r is 128 bytes whose 16-byte chunks
// are permuted by chunk ^ (r % 8) (wgmma's 128-byte swizzle).
__device__ __forceinline__ uint32_t swizzled(int row, int k) {
  return (k >> 5) * kAtom + row * 128 + ((((k & 31) >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2);
}

// The wgmma k index of input channel c: within each k-step of 8 channels,
// even channels take k 0-3 and odd ones k 4-7, so the A fragment's pair
// (k, k + 4) of a row is the adjacent channel pair (2k, 2k + 1).
__device__ __forceinline__ int k_of_channel(int c) {
  return (c & ~7) + ((c & 1) << 2) + ((c & 7) >> 1);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused for this layout).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Descriptor offset of k-step s (8 channels): 32 bytes within an atom.
__device__ __forceinline__ uint64_t k_step(int s) {
  return (uint64_t)((s >> 2) * (kAtom >> 4) + (s & 3) * 2);
}

// D (64 x 64, fp32) += A (64 x 8, TF32 fragments in registers) * B (from shared memory).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// The comb2 token: warpgroup wg waits on named barrier 5 + wg until the
// warpgroup before it has passed the token (256 = its 128 threads + ours).
__device__ __forceinline__ void token_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(kWarpGroups + 1 + wg) : "memory");
}

__device__ __forceinline__ void token_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(kWarpGroups + 1 + (wg + 1) % kWarpGroups) : "memory");
}

// Per tile and source, in the warpgroup's shared memory: the tile's first
// column in source row lo (`row_lo`, channels 0-3; a lane adds its quad),
// the step from row lo to row hi and the row weights, the number of
// columns the tile touches and where they start in `cols`.
struct __align__(16) SourceTile {
  const float4* row_lo;
  int row_step;
  int n_cols;
  float2 wy;
  int cols_at;
};

// acc + w.x * lo + w.y * hi, channel by channel.
__device__ __forceinline__ float4 blend4(float4 acc, float2 w, float4 lo, float4 hi) {
  acc.x = fmaf(w.y, hi.x, fmaf(w.x, lo.x, acc.x));
  acc.y = fmaf(w.y, hi.y, fmaf(w.x, lo.y, acc.y));
  acc.z = fmaf(w.y, hi.z, fmaf(w.x, lo.z, acc.z));
  acc.w = fmaf(w.y, hi.w, fmaf(w.x, lo.w, acc.w));
  return acc;
}

// Stage 1 of the upsample for one tile: every source column the tile's
// pixels touch, blended over the tile row's two source rows (rows first,
// with the table weights, as the plain version), into the warpgroup's
// column buffer `cols` (kColStride floats a column; source r's columns
// from st[r].cols_at). A half-warp moves one column (16 lanes x float4 =
// 256 contiguous bytes), so a warp instruction moves two; each warp issues
// kBatch such loads before it blends any of them.
constexpr int kBatch = 2;
__device__ __forceinline__ void stage_columns(const SourceTile* tiles, int warp, int lane,
                                              float* cols) {
  const int4 n_cols = make_int4(tiles[0].n_cols, tiles[1].n_cols, tiles[2].n_cols,
                                tiles[3].n_cols);
  const int total = n_cols.x + n_cols.y + n_cols.z + n_cols.w;
  const int half = lane >> 4, quad = lane & 15;
  for (int k0 = 2 * warp + half; k0 < total; k0 += 8 * kBatch) {
    float4 a[kBatch], b[kBatch];
    int at[kBatch];
    float2 w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // Column k: source r, its column j.
      int j = k0 + 8 * u, r = 0;
      if (j >= n_cols.x) { j -= n_cols.x; r = 1;
        if (j >= n_cols.y) { j -= n_cols.y; r = 2;
          if (j >= n_cols.z) { j -= n_cols.z; r = 3; } } }
      at[u] = -1;
      if (k0 + 8 * u < total) {
        const SourceTile& st = tiles[r];
        const float4* q = st.row_lo + j * (kC / 4) + quad;
        a[u] = __ldg(q);
        b[u] = __ldg(q + st.row_step);
        w[u] = st.wy;
        at[u] = (st.cols_at + j) * kColStride + 4 * quad;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (at[u] >= 0) {
        *reinterpret_cast<float4*>(cols + at[u]) =
            blend4(make_float4(0.f, 0.f, 0.f, 0.f), w[u], a[u], b[u]);
      }
    }
  }
}

// acc + w.x * lo + w.y * hi, for a channel pair.
__device__ __forceinline__ float2 blend2(float2 acc, float2 w, float2 lo, float2 hi) {
  acc.x = fmaf(w.y, hi.x, fmaf(w.x, lo.x, acc.x));
  acc.y = fmaf(w.y, hi.y, fmaf(w.x, lo.y, acc.y));
  return acc;
}

// Stage 2, straight into comb2's A fragments: the thread's two pixels
// (tile pixels `pix` and pix + 1, in wgmma's rows g and g + 8 of the warp)
// and its channels 8s + 2q, 8s + 2q + 1 (s = 0..7, the pair that
// `k_of_channel` puts at k = q and q + 4 of k-step s). Per source it
// blends each pixel's two columns (columns after rows: the plain version's
// order), loading a column the second pixel shares with the first only
// once; a warp load reads 32 bytes of a column for each of 8 pixels. Then
// +b1 and ReLU, in fragment order: y[s] = (row g, row g + 8) at k = q,
// then at k = q + 4 of k-step s. `xs` is the tile column's x plan in
// shared memory, kTile + 1 entries a source: a head, then per pixel its lo
// and hi columns in `cols` and their weights. Entries past the tile's
// pixels are 0 (column 0, weights 0), so those pixels need no branch; the
// epilogue stores nothing for them.
__device__ __forceinline__ void blend_fragments(int n_src, const int4* xs, const float* cols,
                                                int pix, int q, const float* s_b1,
                                                float (&y)[kC / 8][4]) {
  float2 ya[kC / 8], yb[kC / 8];
#pragma unroll
  for (int s = 0; s < kC / 8; ++s) ya[s] = yb[s] = make_float2(0.f, 0.f);
  const float* my_cols = cols + 2 * q;
#pragma unroll
  for (int r = 0; r < kMaxSrc; ++r) {
    if (r < n_src) {
      const int4 ea = xs[r * (kTile + 1) + 1 + pix];
      const int4 eb = xs[r * (kTile + 1) + 2 + pix];
      const float2 wa = make_float2(__int_as_float(ea.z), __int_as_float(ea.w));
      const float2 wb = make_float2(__int_as_float(eb.z), __int_as_float(eb.w));
      const float* la = my_cols + ea.x * kColStride;
      const float* ha = my_cols + ea.y * kColStride;
      const float* lb = my_cols + eb.x * kColStride;
      const float* hb = my_cols + eb.y * kColStride;
      const bool new_lo = eb.x != ea.x, new_hi = eb.y != ea.y;
#pragma unroll
      for (int s0 = 0; s0 < kC / 8; s0 += 4) {
        float2 l[4], h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          l[j] = *reinterpret_cast<const float2*>(la + 8 * (s0 + j));
          h[j] = *reinterpret_cast<const float2*>(ha + 8 * (s0 + j));
          ya[s0 + j] = blend2(ya[s0 + j], wa, l[j], h[j]);
        }
        if (new_lo) {
#pragma unroll
          for (int j = 0; j < 4; ++j) l[j] = *reinterpret_cast<const float2*>(lb + 8 * (s0 + j));
        }
        if (new_hi) {
#pragma unroll
          for (int j = 0; j < 4; ++j) h[j] = *reinterpret_cast<const float2*>(hb + 8 * (s0 + j));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) yb[s0 + j] = blend2(yb[s0 + j], wb, l[j], h[j]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kC / 8; ++s) {
    const float2 b = *reinterpret_cast<const float2*>(s_b1 + 8 * s + 2 * q);
    y[s][0] = fmaxf(ya[s].x + b.x, 0.f);
    y[s][1] = fmaxf(yb[s].x + b.x, 0.f);
    y[s][2] = fmaxf(ya[s].y + b.y, 0.f);
    y[s][3] = fmaxf(yb[s].y + b.y, 0.f);
  }
}

template <bool kWithMotion>
__global__ void __launch_bounds__(kThreads, 1)
decoder_heads_kernel(Sources src, const int4* __restrict__ y_tab, const int4* __restrict__ x_plan,
                     const float* __restrict__ b1, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ ws,
                     const float* __restrict__ bs, const float* __restrict__ wm,
                     const float* __restrict__ bm, float* __restrict__ seg_out,
                     float* __restrict__ mot_out, int n_frames, int h_out, int w_out,
                     int tile_w, int n_cols_max) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (1024 - (raw_addr & 1023)) & 1023;
  unsigned char* smem = smem_raw + pad;
  const uint32_t base = raw_addr + pad;
  float* s_b1 = reinterpret_cast<float*>(smem + kSmemParams);
  float* s_b2 = s_b1 + kC;
  float* s_ws = s_b2 + kC;
  float* s_wm = s_ws + kC * kSeg;
  // Two sets of SourceTile per warpgroup, by tile parity: a tile's set is
  // written while the other warps may still read the previous tile's.
  SourceTile* tiles =
      reinterpret_cast<SourceTile*>(smem + kSmemTiles + (threadIdx.x >> 7) * kSmemTileBytes);
  int parity = 0;
  int4* xs =
      reinterpret_cast<int4*>(smem + kSmemXPlan) + (threadIdx.x >> 7) * kMaxSrc * (kTile + 1);
  int xs_col = -1;   // the tile column whose x plan xs holds
  float* cols = reinterpret_cast<float*>(smem + kSmemFixed) +
                (threadIdx.x >> 7) * n_cols_max * kColStride;

  // W2^T (row d = output channel, k = permuted input channel), split into
  // TF32 hi and lo.
  for (int i = threadIdx.x; i < kC * kC; i += kThreads) {
    const int d = i >> 6, c = i & 63;
    const float v = w2[c * kC + d];   // w2 is (C, C2) row-major
    const uint32_t hi = tf32_rna(v);
    const uint32_t off = swizzled(d, k_of_channel(c));
    *reinterpret_cast<uint32_t*>(smem + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + kOperand + off) = tf32_rna(v - __uint_as_float(hi));
  }
  for (int i = threadIdx.x; i < kC; i += kThreads) {
    s_b1[i] = b1[i];
    s_b2[i] = b2[i];
  }
  for (int i = threadIdx.x; i < kC * kSeg; i += kThreads) s_ws[i] = ws[i];
  if (kWithMotion) {
    for (int i = threadIdx.x; i < kC * kMot; i += kThreads) s_wm[i] = wm[i];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // W2^T: generic -> wgmma
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const uint64_t desc_w_hi = smem_desc(base), desc_w_lo = smem_desc(base + kOperand);
  const float seg_b0 = bs[0], seg_b1 = bs[1];
  const int tiles_per_row = (w_out + tile_w - 1) / tile_w;
  const int n_tiles = n_frames * h_out * tiles_per_row;
  // This thread's A-fragment rows and accumulator rows (wgmma's m64nNk8
  // layouts): warp rows g and g + 8, columns 2q, 2q + 1 of each 8; the
  // rows hold the warp's pixels 2g and 2g + 1.
  const int g = lane >> 2, q = lane & 3;

  // Tiles in the order (frame, row, tile column). A block takes a
  // contiguous run of them in rounds of one tile per warpgroup, so its
  // warpgroups work on neighbouring rows and read their source rows while
  // the rows are in L1 or L2: each frame's projections come from device
  // memory about once. Every warpgroup runs every round (with no tile past
  // the end) to keep the comb2 token going round.
  const int rounds = ((n_tiles + gridDim.x - 1) / gridDim.x + kWarpGroups - 1) / kWarpGroups;
  const int first_tile = blockIdx.x * rounds * kWarpGroups;
  const int tiles_end = min(n_tiles, first_tile + rounds * kWarpGroups);
  for (int round = 0; round < rounds; ++round) {
    const int tile = first_tile + round * kWarpGroups + wg;
    const bool active = tile < tiles_end;   // uniform in the warpgroup
    const int out_row = tile / tiles_per_row, tile_col = tile - out_row * tiles_per_row;
    const int frame = out_row / h_out, y = out_row - frame * h_out;
    const int x0 = tile_col * tile_w, x_end = min(x0 + tile_w, w_out);
    float d[32];
    float yf[kC / 8][4];
    if (active) {
      // Thread r of the warpgroup describes source r's part of the tile.
      const int4* plan = x_plan + (size_t)tile_col * src.n * (kTile + 1);
      SourceTile* st = tiles + parity * kMaxSrc;
      parity ^= 1;
      if (t < kMaxSrc) {
        SourceTile v = {nullptr, 0, 0, make_float2(0.f, 0.f), 0};
        if (t < src.n) {
          const int4 yt = __ldg(y_tab + t * h_out + y);
          const int4 head = __ldg(plan + t * (kTile + 1));   // (first column, columns, cols_at)
          // Source t's fields, by selects (an index would copy `src` to local memory).
          const float* p = t == 0 ? src.p[0] : t == 1 ? src.p[1] : t == 2 ? src.p[2] : src.p[3];
          const int h = t == 0 ? src.h[0] : t == 1 ? src.h[1] : t == 2 ? src.h[2] : src.h[3];
          const int w = t == 0 ? src.w[0] : t == 1 ? src.w[1] : t == 2 ? src.w[2] : src.w[3];
          const int row = w * (kC / 4);
          v.row_lo = reinterpret_cast<const float4*>(p) + ((size_t)frame * h + yt.x) * row +
                     head.x * (kC / 4);
          v.row_step = (yt.y - yt.x) * row;
          v.n_cols = head.y;
          v.wy = make_float2(__int_as_float(yt.z), __int_as_float(yt.w));
          v.cols_at = head.z;
        }
        st[t] = v;
      }
      warpgroup_sync(wg);   // st written; the previous tile's columns and x plan are read
      // A warpgroup keeps its tile column when the tiles of a row divide
      // kWarpGroups (1, 2 or 4 of them; 2 at 112 wide).
      if (tile_col != xs_col) {
        for (int e = t; e < src.n * (kTile + 1); e += 128) xs[e] = __ldg(plan + e);
        xs_col = tile_col;
      }
      stage_columns(st, warp, lane, cols);
      warpgroup_sync(wg);
      blend_fragments(src.n, xs, cols, warp * kRowsPerWarp + 2 * g, q, s_b1, yf);
    }
    if (round > 0 || wg > 0) token_wait(wg);
    if (active) {
      // comb2 in two halves of K, so that one half's TF32 hi and lo
      // fragments (32 registers) are live beside the accumulators, not
      // both halves': per half, lo * W2hi first (the small terms), then
      // hi * W2lo and hi * W2hi.
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.f;
      fence_operands(d);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t hi[kC / 16][4], lo[kC / 16][4];
#pragma unroll
        for (int j = 0; j < kC / 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = yf[kC / 16 * h + j][e];
            hi[j][e] = tf32_rna(v);
            lo[j][e] = tf32_rna(v - __uint_as_float(hi[j][e]));
          }
          fence_operands(hi[j]);
          fence_operands(lo[j]);
        }
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int j = 0; j < kC / 16; ++j) wgmma_tf32(d, lo[j], desc_w_hi + k_step(kC / 16 * h + j));
#pragma unroll
        for (int j = 0; j < kC / 16; ++j) wgmma_tf32(d, hi[j], desc_w_lo + k_step(kC / 16 * h + j));
#pragma unroll
        for (int j = 0; j < kC / 16; ++j) wgmma_tf32(d, hi[j], desc_w_hi + k_step(kC / 16 * h + j));
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        if (h == 1 && (round < rounds - 1 || wg < kWarpGroups - 1)) token_pass(wg);
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_operands(d);
#pragma unroll
        for (int j = 0; j < kC / 16; ++j) {
          fence_operands(hi[j]);
          fence_operands(lo[j]);
        }
      }
    } else if (round < rounds - 1 || wg < kWarpGroups - 1) {
      token_pass(wg);
    }
    if (active) {
      // d[4j + 0..3] = rows (g, g, g+8, g+8) x columns (c, c+1, c, c+1), c = 8j + 2q.
      float seg[2][kSeg] = {{0.f, 0.f}, {0.f, 0.f}};
      float mot[2][kMot] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < kC / 8; ++j) {
        const int c = 8 * j + 2 * q;
        const float2 bb = *reinterpret_cast<const float2*>(s_b2 + c);
        const float4 sw = *reinterpret_cast<const float4*>(s_ws + c * kSeg);
        float4 ma, mb;
        if (kWithMotion) {
          ma = *reinterpret_cast<const float4*>(s_wm + c * kMot);
          mb = *reinterpret_cast<const float4*>(s_wm + c * kMot + kMot);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float z0 = fmaxf(d[4 * j + 2 * h] + bb.x, 0.f);
          const float z1 = fmaxf(d[4 * j + 2 * h + 1] + bb.y, 0.f);
          seg[h][0] += z0 * sw.x + z1 * sw.z;
          seg[h][1] += z0 * sw.y + z1 * sw.w;
          if (kWithMotion) {
            mot[h][0] += z0 * ma.x + z1 * mb.x;
            mot[h][1] += z0 * ma.y + z1 * mb.y;
            mot[h][2] += z0 * ma.z + z1 * mb.z;
            mot[h][3] += z0 * ma.w + z1 * mb.w;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < kSeg; ++k) {
          seg[h][k] += __shfl_xor_sync(0xffffffffu, seg[h][k], 1);
          seg[h][k] += __shfl_xor_sync(0xffffffffu, seg[h][k], 2);
        }
        if (kWithMotion) {
#pragma unroll
          for (int k = 0; k < kMot; ++k) {
            mot[h][k] += __shfl_xor_sync(0xffffffffu, mot[h][k], 1);
            mot[h][k] += __shfl_xor_sync(0xffffffffu, mot[h][k], 2);
          }
        }
      }
      // Lane q of a quad stores: q = 0, 1 the seg of rows g, g+8 (pixels
      // 2g, 2g + 1); q = 2, 3
      // their motion (selects, not a runtime index, keep the sums in registers).
      const bool upper = q & 1;
      const int x = x0 + warp * kRowsPerWarp + 2 * g + (upper ? 1 : 0);
      if (x < x_end) {
        const size_t o = ((size_t)frame * h_out + y) * w_out + x;
        if (q < 2) {
          reinterpret_cast<float2*>(seg_out)[o] =
              make_float2((upper ? seg[1][0] : seg[0][0]) + seg_b0,
                          (upper ? seg[1][1] : seg[0][1]) + seg_b1);
        } else if (kWithMotion) {
          reinterpret_cast<float4*>(mot_out)[o] =
              make_float4(tanhf((upper ? mot[1][0] : mot[0][0]) + bm[0]),
                          tanhf((upper ? mot[1][1] : mot[0][1]) + bm[1]),
                          tanhf((upper ? mot[1][2] : mot[0][2]) + bm[2]),
                          tanhf((upper ? mot[1][3] : mot[0][3]) + bm[3]));
        }
      }
    }
  }
}

template <bool kWithMotion>
cudaError_t launch(const Sources& src, const int4* y_tab, const int4* x_plan, const float* b1,
                   const float* w2, const float* b2, const float* ws, const float* bs,
                   const float* wm, const float* bm, float* seg_out, float* mot_out,
                   int n_frames, int h_out, int w_out, int tile_w, int n_cols_max,
                   cudaStream_t stream) {
  auto kernel = decoder_heads_kernel<kWithMotion>;
  const int smem = kSmemFixed + 1024 + kWarpGroups * n_cols_max * kColBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)n_frames * h_out * ((w_out + tile_w - 1) / tile_w);
  const long long blocks = (tiles + kWarpGroups - 1) / kWarpGroups;
  const int grid = (int)(blocks < (long long)sms * per_sm ? blocks : (long long)sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(src, y_tab, x_plan, b1, w2, b2, ws, bs, wm, bm, seg_out,
                                           mot_out, n_frames, h_out, w_out, tile_w, n_cols_max);
  return cudaGetLastError();
}

}  // namespace

// The most columns a warpgroup's column buffer can hold in shared memory:
// the caller cuts tiles narrow enough that a tile's columns fit.
extern "C" int echoflow_decoder_heads_column_budget(void) { return kColumnBudget; }

// y_tab (S, h_out, 4): per output row and source, the source rows lo, hi
// and the float32 bits of their weights. x_plan (tiles of a row, S,
// kTile + 1, 4): per tile column and source, a head (first source column,
// columns touched, first place in the column buffer), then per pixel the
// places of its lo and hi columns in the column buffer and the bits of
// their weights (zeros past the tile's pixels). tile_w: output pixels per
// tile (1..64); n_cols_max: columns of the column buffer, at most the
// column budget.
extern "C" int echoflow_decoder_heads(
    const void* p0, const void* p1, const void* p2, const void* p3,
    int h0, int w0, int h1, int w1, int h2, int w2_, int h3, int w3,
    int n_src, int n_cols_max, int tile_w,
    const void* y_tab, const void* x_plan,
    const void* b1, const void* w2, const void* b2, const void* ws,
    const void* bs, const void* wm, const void* bm,
    void* seg_out, void* mot_out,
    int batch, int t_len, int h_out, int w_out, int with_motion,
    void* stream) {
  if (n_src < 1 || n_src > kMaxSrc || batch < 1 || t_len < 1 || h_out < 1 || w_out < 1 ||
      tile_w < 1 || tile_w > kTile || n_cols_max < 1 || n_cols_max > kColumnBudget)
    return (int)cudaErrorInvalidValue;
  const long long n_frames = (long long)batch * t_len;
  if (n_frames * h_out * ((w_out + tile_w - 1) / tile_w) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EF_ARGS                                                                        \
  src, static_cast<const int4*>(y_tab), static_cast<const int4*>(x_plan),             \
      static_cast<const float*>(b1), static_cast<const float*>(w2),                   \
      static_cast<const float*>(b2), static_cast<const float*>(ws),                   \
      static_cast<const float*>(bs), static_cast<const float*>(wm),                   \
      static_cast<const float*>(bm), static_cast<float*>(seg_out),                    \
      static_cast<float*>(mot_out), (int)n_frames, h_out, w_out, tile_w, n_cols_max, s
  const cudaError_t err = with_motion ? launch<true>(EF_ARGS) : launch<false>(EF_ARGS);
#undef EF_ARGS
  return (int)err;
}
