// Weight gradient of a stride-1 SAME conv for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel dd3d_tpu/ops/pallas_conv.py::_dw_kernel (reached
// through conv_dw_s1_same_pallas and the conv2d_s1_same custom_vjp). Same
// function, in the port's layouts: x (B, H, W, CI) and dy (B, H, W, CO),
// both NHWC-contiguous (channels_last NCHW tensors), bf16 or f32, an odd
// k <= 9, and
//
//     dW[co, ci, dh, dw] = sum_{b,h,w} xpad[b, h+dh, w+dw, ci] * dy[b, h, w, co]
//
// in f32 (OIHW). It is a GEMM-shaped contraction with a tiny output
// (M = k*k*CI rows m = (dh, dw, ci) by CO columns: 147 x 16 and 144 x 16 at
// the DLA-34 stem) and a huge reduction (P = B*H*W pixels, 3.9 M at batch 8,
// 384x1280).
//
// What bounds it on this card: at the stem shapes 2*M*CO*P is about 18.5
// GFLOP against 150-250 MB of input. On the tensor cores (989 TFLOP/s bf16)
// the reads bound it (~0.05-0.08 ms at 3.35 TB/s); on the CUDA cores
// (67 TFLOP/s f32) the FMAs do (~0.28 ms). The TPU kernel stacked the k*k
// shifts into the MXU's M dimension; here the same stacking is an offset
// table: the x value of pixel q for row m lies at `tile[q] + off[m]` in a
// shared-memory halo tile.
//
// Two paths, one design around them:
// - bf16 (the train step's): tensor cores, mma.sync.m16n8k16 bf16 -> f32.
//   D[co, m] = sum_p dy[p, co] * xpad[p + off(m)]: A is the dy tile (16
//   output channels as rows, pixels as K), read with ldmatrix.trans from
//   the NHWC tile; B is the implicit-im2col x tile (pixels as K, m as
//   columns, M padded to a multiple of 8), gathered from the bf16 halo tile
//   through the offset table. Products of two bf16 are exact in f32, so
//   only the order of the f32 sums differs from the plain version. The halo
//   and dy tiles are double-buffered with 16-byte cp.async (zero-fill
//   outside the image), so the next tile's loads overlap the MMAs. This
//   path takes W*CI and CO multiples of 8 and 16-byte aligned x and dy, so
//   that every 16-byte chunk lies inside one image row or wholly outside
//   it; the wrapper pads W and CO with zeros (which add nothing to dW) and
//   copies an unaligned input.
//   The gathers, not the MMAs, set the pace: two warps split a 160-column
//   slice (40 accumulators each, two blocks an SM) and four such pairs
//   split the tile's pixels, so that enough warps hide the load latency;
//   K slots map to pixels four apart, so a row's four lanes hit different
//   banks.
// - f32: CUDA cores, explicit __fmaf_rn. Tensor cores would round f32 to
//   TF32 (10 mantissa bits), far outside the 1e-5 bound that the fp32 train
//   step on the card is held to; that step is f32 by choice, so it keeps
//   the f32 arithmetic. Each thread owns kMR rows m and kNR channels.
// Both: pass 1 cuts the pixels into tiles of th rows x 32 columns of one
// image; a fixed grid of blocks (a function of the shapes only) walks the
// tiles in a fixed order (tile = blockIdx.x + i * gridDim.x); each warp or
// pixel group keeps its partial sums, which the block adds in a fixed order
// through shared memory into one partial per block. Pass 2
// (dw_reduce_kernel) sums the blocks' partials, one warp per output, in a
// fixed order, and writes dW in OIHW. No float atomics, so two runs give
// identical bits.
// gridDim.y splits M into slices (kTcNS rows on tensor cores,
// kThreads * kMR on CUDA cores) and CO into slices of 16 channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMR = 4;    // output rows m per thread
constexpr int kNR = 16;   // output channels per block slice
constexpr int kTW = 32;   // tile width in pixels
constexpr int kBlocksX = 264;  // fixed: two blocks for each of 132 SMs
constexpr int kSmemBudget = 100 * 1024;

struct Params {
  int b, h, w, ci, co, k;
  int th;        // tile height (8, 4, 2 or 1 rows)
  int tiles_h, tiles_w, ntiles;
  int m;         // k * k * ci
  int co_slices;
};

// Floats of the x halo tile, rounded up to 4 so that the dy tile behind it
// is 16-byte aligned for its float4 reads.
__host__ __device__ __forceinline__ int x_tile_floats(const Params& p) {
  return ((p.th + p.k - 1) * (kTW + p.k - 1) * p.ci + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kThreads) dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                                                               float* __restrict__ ws, Params p) {
  extern __shared__ float smem[];
  const int pad = (p.k - 1) / 2;
  const int xw = kTW + p.k - 1;
  const int xh = p.th + p.k - 1;
  const int tp = p.th * kTW;
  float* xs = smem;                      // xh * xw * ci
  float* ys = smem + x_tile_floats(p);   // max(tp, kThreads) * kNR: the dy tile, then the group sums

  const int m_slice = blockIdx.y / p.co_slices;
  const int co0 = (blockIdx.y % p.co_slices) * kNR;
  const int m0 = m_slice * kThreads * kMR;
  const int items = min(kThreads, (p.m - m0 + kMR - 1) / kMR);
  const int groups = kThreads / items;
  const int tid = threadIdx.x;
  const int item = tid % items;
  const int group = tid / items;
  const bool active = group < groups;

  int off[kMR];
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    const int m = m0 + item * kMR + r;
    if (m < p.m) {
      const int tap = m / p.ci, c = m % p.ci;
      off[r] = ((tap / p.k) * xw + tap % p.k) * p.ci + c;
    } else {
      off[r] = 0;  // a padding row: computed and never written
    }
  }

  float acc[kMR][kNR];
#pragma unroll
  for (int r = 0; r < kMR; ++r)
#pragma unroll
    for (int n = 0; n < kNR; ++n) acc[r][n] = 0.0f;

  const int per_image = p.tiles_h * p.tiles_w;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int bi = tile / per_image;
    const int rem = tile % per_image;
    const int h0 = (rem / p.tiles_w) * p.th;
    const int w0 = (rem % p.tiles_w) * kTW;
    __syncthreads();  // the previous tile is consumed
    const size_t img = static_cast<size_t>(bi) * p.h;
    for (int i = tid; i < xh * xw * p.ci; i += kThreads) {
      const int c = i % p.ci;
      const int t = i / p.ci;
      const int gh = h0 - pad + t / xw;
      const int gw = w0 - pad + t % xw;
      float v = 0.0f;
      if (gh >= 0 && gh < p.h && gw >= 0 && gw < p.w) v = x[((img + gh) * p.w + gw) * p.ci + c];
      xs[i] = v;
    }
    for (int i = tid; i < tp * kNR; i += kThreads) {
      const int n = i % kNR;
      const int q = i / kNR;
      const int gh = h0 + q / kTW;
      const int gw = w0 + q % kTW;
      float v = 0.0f;
      if (gh < p.h && gw < p.w && co0 + n < p.co) v = dy[((img + gh) * p.w + gw) * p.co + co0 + n];
      ys[i] = v;
    }
    __syncthreads();
    if (active) {
      for (int q = group; q < tp; q += groups) {
        const float* xq = xs + ((q / kTW) * xw + q % kTW) * p.ci;
        const float4* yq = reinterpret_cast<const float4*>(ys + q * kNR);
        float yv[kNR];
#pragma unroll
        for (int j = 0; j < kNR / 4; ++j) {
          const float4 v = yq[j];
          yv[4 * j] = v.x;
          yv[4 * j + 1] = v.y;
          yv[4 * j + 2] = v.z;
          yv[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < kMR; ++r) {
          const float xv = xq[off[r]];
#pragma unroll
          for (int n = 0; n < kNR; ++n) acc[r][n] = __fmaf_rn(xv, yv[n], acc[r][n]);
        }
      }
    }
  }

  // Sum the pixel groups in group order, one row r at a time, through ys.
  float* ws_block = ws + static_cast<size_t>(blockIdx.x) * p.m * p.co;
#pragma unroll
  for (int r = 0; r < kMR; ++r) {
    __syncthreads();
    if (active) {
#pragma unroll
      for (int n = 0; n < kNR; ++n) ys[tid * kNR + n] = acc[r][n];
    }
    __syncthreads();
    const int m = m0 + item * kMR + r;
    if (active && group == 0 && m < p.m) {
      for (int n = 0; n < kNR && co0 + n < p.co; ++n) {
        float s = ys[item * kNR + n];
        for (int g = 1; g < groups; ++g) s += ys[(g * items + item) * kNR + n];
        ws_block[static_cast<size_t>(m) * p.co + co0 + n] = s;
      }
    }
  }
}

// One warp per output: lane l sums the partials of blocks l, l + 32, ... in
// order, then the lanes are added by a fixed butterfly. The order depends on
// the block count alone, so the bits do not change from run to run.
__global__ void dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out, int blocks, int m_total,
                                 int ci, int co, int k) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;  // OIHW index
  const int lane = threadIdx.x % 32;
  if (o >= m_total * co) return;
  const int dw = o % k;
  const int dh = (o / k) % k;
  const int c = (o / (k * k)) % ci;
  const int n = o / (k * k * ci);
  const size_t idx = static_cast<size_t>((dh * k + dw) * ci + c) * co + n;
  const size_t stride = static_cast<size_t>(m_total) * co;
  float s = 0.0f;
  for (int blk = lane; blk < blocks; blk += 32) s += ws[idx + blk * stride];
#pragma unroll
  for (int d = 16; d > 0; d /= 2) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) out[o] = s;
}

// ---- bf16 on the tensor cores ---------------------------------------------

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcGroups = kTcWarps / 2;  // pixel groups, each a pair of warps
constexpr int kTcWarpNT = 10;            // n8 tiles a warp: half of the block's slice
constexpr int kTcNS = 2 * kTcWarpNT * 8;  // M in slices of 160 rows
constexpr int kTcSmemBudget = 96 * 1024;  // the two tile stages
constexpr int kTcReduceBytes = kTcGroups * kTcNS * 16 * 4;

struct TcParams {
  int b, h, w, ci, co, k;
  int th, tiles_h, tiles_w, ntiles;
  int m, m_slices, co_slices;
  int xh;           // halo rows, th + k - 1
  int xrow;         // bf16 elements a halo row holds, a multiple of 8
  int lead;         // elements before halo column 0 in a row (16-byte chunk alignment)
  int x_elems;      // the halo tile, a multiple of 8
  int stage_elems;  // halo tile + dy tile (th * 32 pixels x 16 channels)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

// Stage tile `tile` (x halo and the dy slice co0..co0+15) into `xs`, zeros
// outside the image and beyond CO.
__device__ __forceinline__ void tc_stage(const unsigned short* __restrict__ x, const unsigned short* __restrict__ dy,
                                         unsigned short* xs, const TcParams& p, int tile, int co0) {
  const int pad = (p.k - 1) / 2;
  const int per_image = p.tiles_h * p.tiles_w;
  const int bi = tile / per_image;
  const int rem = tile % per_image;
  const int h0 = (rem / p.tiles_w) * p.th;
  const int w0 = (rem % p.tiles_w) * kTW;
  const long long row_elems = static_cast<long long>(p.w) * p.ci;
  unsigned short* ys = xs + p.x_elems;
  // Every 16-byte chunk lies inside one image row or wholly outside it
  // (W*CI % 8 == 0), so a chunk is copied or zero-filled as a whole.
  const int chunks = p.xrow / 8;
  const long long e0 = static_cast<long long>(w0 - pad) * p.ci - p.lead;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < p.xh; r += kTcWarps) {  // a warp a halo row, a lane a 16-byte chunk
    const int gh = h0 - pad + r;
    const unsigned short* row = x + (static_cast<long long>(bi) * p.h + gh) * row_elems;
    const bool row_ok = gh >= 0 && gh < p.h;
    for (int c = lane; c < chunks; c += 32) {
      const long long e = e0 + c * 8;
      const bool ok = row_ok && e >= 0 && e < row_elems;
      cp_async16(xs + r * p.xrow + c * 8, ok ? row + e : x, ok);
    }
  }
  for (int i = threadIdx.x; i < p.th * kTW * 2; i += kTcThreads) {
    const int q = i >> 1, c = co0 + (i & 1) * 8;
    const int gh = h0 + q / kTW, gw = w0 + q % kTW;
    const bool ok = gh < p.h && gw < p.w && c < p.co;
    const unsigned short* src = ok ? dy + ((static_cast<long long>(bi) * p.h + gh) * p.w + gw) * p.co + c : dy;
    cp_async16(ys + q * 16 + (i & 1) * 8, src, ok);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kTcThreads, 2) dw_partial_tc_kernel(const unsigned short* __restrict__ x,
                                                                    const unsigned short* __restrict__ dy,
                                                                    float* __restrict__ ws, TcParams p) {
  extern __shared__ __align__(16) unsigned short tc_smem[];
  const int m_slice = blockIdx.y / p.co_slices;
  const int co0 = (blockIdx.y % p.co_slices) * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Warp pairs split the slice's columns in two halves; the kTcGroups pairs
  // split the tile's pixels.
  const int group = warp / 2;
  const int m0 = m_slice * kTcNS + (warp % 2) * kTcWarpNT * 8;

  // This lane's column m = m0 + 8j + g of each n8 tile, as an offset into
  // the halo tile; padding columns read offset 0 and are never written.
  int off[kTcWarpNT];
#pragma unroll
  for (int j = 0; j < kTcWarpNT; ++j) {
    const int m = m0 + j * 8 + g;
    if (m < p.m) {
      const int tap = m / p.ci, c = m % p.ci;
      off[j] = (tap / p.k) * p.xrow + (tap % p.k) * p.ci + c;
    } else {
      off[j] = 0;
    }
  }
  float acc[kTcWarpNT][4];
#pragma unroll
  for (int j = 0; j < kTcWarpNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // K slot s of a 16-pixel chunk is pixel pi(s) = (s & 8) + (s & 7) / 2 +
  // (s & 1) * 4: this lane's B rows 2t, 2t+1, 2t+8, 2t+9 are pixels t, t+4,
  // t+8, t+12, four pixels apart, so the four lanes t of a row hit other
  // banks when CI = 16. ldmatrix.x4.trans of the dy chunk: lane L gives the
  // row (slot L % 8 of matrix L / 8: slots 0-7 / 8-15, channels 0-7 / 8-15),
  // so that a0..a3 are A = dy^T's (co 0-7 | 8-15) x (slots 0-7 | 8-15).
  const int a_slot = ((lane >> 4) & 1) * 8 + (lane & 7);
  const int a_pix = (a_slot & 8) + ((a_slot & 7) >> 1) + (a_slot & 1) * 4;
  const int a_co = ((lane >> 3) & 1) * 8;
  const int chunks = p.th * kTW / 16;

  int buf = 0;
  if (blockIdx.x < p.ntiles) tc_stage(x, dy, tc_smem, p, blockIdx.x, co0);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.ntiles) tc_stage(x, dy, tc_smem + (buf ^ 1) * p.stage_elems, p, next, co0);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const unsigned short* xs = tc_smem + buf * p.stage_elems;
    const unsigned short* ys = xs + p.x_elems;
    for (int c = group; c < chunks; c += kTcGroups) {
      const int r = c / (kTW / 16), col0 = (c % (kTW / 16)) * 16;
      uint32_t a[4];
      const unsigned a_addr =
          static_cast<unsigned>(__cvta_generic_to_shared(ys + (r * kTW + col0 + a_pix) * 16 + a_co));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                   : "r"(a_addr));
      const unsigned short* xq = xs + r * p.xrow + p.lead + (col0 + t) * p.ci;
      const int c4 = 4 * p.ci, c8 = 8 * p.ci, c12 = 12 * p.ci;
      // Every n8 tile of the half, the padding ones too (they read offset
      // 0 and are never written): no branch between the loads and the MMAs.
#pragma unroll
      for (int j = 0; j < kTcWarpNT; ++j) {
        const unsigned short* xp = xq + off[j];
        const uint32_t b0 = static_cast<uint32_t>(xp[0]) | (static_cast<uint32_t>(xp[c4]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(xp[c8]) | (static_cast<uint32_t>(xp[c12]) << 16);
        mma_bf16(acc[j], a, b0, b1);
      }
    }
    __syncthreads();
    buf ^= 1;
  }

  // Sum the pixel groups' partials in group order through shared memory:
  // red[group][m][co], then one partial per block into the workspace.
  float* red = reinterpret_cast<float*>(tc_smem);
  const int ml0 = (warp % 2) * kTcWarpNT * 8;
#pragma unroll
  for (int j = 0; j < kTcWarpNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(group * kTcNS + ml0 + j * 8 + 2 * t + (e & 1)) * 16 + g + (e >> 1) * 8] = acc[j][e];
  __syncthreads();
  float* ws_block = ws + static_cast<size_t>(blockIdx.x) * p.m * p.co;
  for (int i = threadIdx.x; i < kTcNS * 16; i += kTcThreads) {
    const int ml = i / 16, n = i % 16;
    const int m = m_slice * kTcNS + ml, co = co0 + n;
    if (m < p.m && co < p.co) {
      float s = red[ml * 16 + n];
      for (int gi = 1; gi < kTcGroups; ++gi) s += red[(gi * kTcNS + ml) * 16 + n];
      ws_block[static_cast<size_t>(m) * p.co + co] = s;
    }
  }
}

bool valid_shape(int b, int h, int w, int ci, int co, int k) {
  return b > 0 && h > 0 && w > 0 && ci > 0 && co > 0 && k > 0 && k <= 9 && k % 2 == 1;
}

// The tensor-core path's 16-byte chunks: W*CI and CO multiples of 8.
bool tc_shape(int w, int ci, int co) { return (static_cast<long long>(w) * ci) % 8 == 0 && co % 8 == 0; }

bool make_tc_params(int b, int h, int w, int ci, int co, int k, TcParams* p, size_t* smem) {
  if (!valid_shape(b, h, w, ci, co, k) || !tc_shape(w, ci, co)) return false;
  const int pad = (k - 1) / 2;
  // Halo column 0 sits at (w0 - pad) * CI elements into an image row, and
  // w0 is a multiple of 32: the same offset mod 8 for every tile.
  const int lead = ((-pad * ci) % 8 + 8) % 8;
  const long long xrow = ((static_cast<long long>(kTW + k - 1) * ci + lead) + 7) / 8 * 8;
  for (int th = 16; th >= 1; th /= 2) {
    const long long x_elems = (th + k - 1) * xrow;
    const long long stage = x_elems + th * kTW * 16;
    if (2 * stage * 2 > kTcSmemBudget) continue;
    p->b = b;
    p->h = h;
    p->w = w;
    p->ci = ci;
    p->co = co;
    p->k = k;
    p->th = th;
    p->tiles_h = (h + th - 1) / th;
    p->tiles_w = (w + kTW - 1) / kTW;
    p->ntiles = b * p->tiles_h * p->tiles_w;
    p->m = k * k * ci;
    p->m_slices = (p->m + kTcNS - 1) / kTcNS;
    p->co_slices = (co + 15) / 16;
    p->xh = th + k - 1;
    p->xrow = static_cast<int>(xrow);
    p->lead = lead;
    p->x_elems = static_cast<int>(x_elems);
    p->stage_elems = static_cast<int>(stage);
    const size_t stages = static_cast<size_t>(2 * stage * 2);
    *smem = stages > kTcReduceBytes ? stages : kTcReduceBytes;
    return true;
  }
  return false;
}

bool make_params(int b, int h, int w, int ci, int co, int k, Params* p, size_t* smem) {
  if (!valid_shape(b, h, w, ci, co, k)) return false;
  for (int th = 8; th >= 1; th /= 2) {
    const size_t tile = (static_cast<size_t>(th + k - 1) * (kTW + k - 1) * ci + 3) / 4 * 4;
    const size_t rest = static_cast<size_t>(th * kTW > kThreads ? th * kTW : kThreads) * kNR;
    const size_t bytes = (tile + rest) * sizeof(float);
    if (bytes <= kSmemBudget) {
      p->b = b;
      p->h = h;
      p->w = w;
      p->ci = ci;
      p->co = co;
      p->k = k;
      p->th = th;
      p->tiles_h = (h + th - 1) / th;
      p->tiles_w = (w + kTW - 1) / kTW;
      p->ntiles = b * p->tiles_h * p->tiles_w;
      p->m = k * k * ci;
      p->co_slices = (co + kNR - 1) / kNR;
      *smem = bytes;
      return true;
    }
  }
  return false;
}

int blocks_for(int ntiles) { return ntiles < kBlocksX ? ntiles : kBlocksX; }

int reduce(const float* ws, float* out, int blocks, int m, int ci, int co, int k, cudaStream_t stream) {
  const int outputs = m * co;  // one warp each, 8 a block
  dw_reduce_kernel<<<(outputs + 7) / 8, 256, 0, stream>>>(ws, out, blocks, m, ci, co, k);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* dy, float* ws, float* out, const Params& p, size_t smem,
               cudaStream_t stream) {
  const int blocks = blocks_for(p.ntiles);
  const int m_slices = (p.m + kThreads * kMR - 1) / (kThreads * kMR);
  cudaError_t err = cudaFuncSetAttribute(dw_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_partial_kernel<<<dim3(blocks, m_slices * p.co_slices), kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), ws, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(ws, out, blocks, p.m, p.ci, p.co, p.k, stream);
}

int launch_tc(const void* x, const void* dy, float* ws, float* out, const TcParams& p, size_t smem,
              cudaStream_t stream) {
  const int blocks = blocks_for(p.ntiles);
  cudaError_t err =
      cudaFuncSetAttribute(dw_partial_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dw_partial_tc_kernel<<<dim3(blocks, p.m_slices * p.co_slices), kTcThreads, smem, stream>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(dy), ws, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce(ws, out, blocks, p.m, p.ci, p.co, p.k, stream);
}

}  // namespace

extern "C" {

// Floats of workspace dd3d_conv_dw_s1_same needs for either dtype (the
// bf16 one where W*CI and CO are multiples of 8), or -1 for a shape it does
// not take (even or > 9 kernel, or a halo tile beyond the shared memory).
long long dd3d_conv_dw_workspace(int b, int h, int w, int ci, int co, int k) {
  Params p;
  TcParams tp;
  size_t smem;
  if (!make_params(b, h, w, ci, co, k, &p, &smem)) return -1;
  long long blocks = blocks_for(p.ntiles);
  if (tc_shape(w, ci, co)) {
    if (!make_tc_params(b, h, w, ci, co, k, &tp, &smem)) return -1;
    if (blocks_for(tp.ntiles) > blocks) blocks = blocks_for(tp.ntiles);
  }
  return blocks * p.m * p.co;
}

// dW (CO, CI, k, k) f32 of x (B, H, W, CI) and dy (B, H, W, CO), both
// bf16 (is_bf16 = 1: tensor cores; W*CI and CO multiples of 8, x and dy
// 16-byte aligned) or f32 (CUDA cores). Launches two kernels on `stream`,
// does not synchronise; returns a cudaError_t (1, cudaErrorInvalidValue,
// for a shape or an alignment it does not take).
int dd3d_conv_dw_s1_same(const void* x, const void* dy, int is_bf16, int b, int h, int w, int ci, int co, int k,
                         float* workspace, float* out, void* stream) {
  size_t smem;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    TcParams p;
    const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    if (!aligned || !make_tc_params(b, h, w, ci, co, k, &p, &smem)) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tc(x, dy, workspace, out, p, smem, s);
  }
  Params p;
  if (!make_params(b, h, w, ci, co, k, &p, &smem)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(x, dy, workspace, out, p, smem, s);
}

}  // extern "C"
