// DLA's full-resolution stem convs for Hopper (sm_90a), hand-written CUDA
// C++: conv -> folded-BN bias -> ReLU in one kernel, `stem_conv_kernel`.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA. On the
// card they were cuDNN bf16 convs at Ampere-class kernels (C = 3 and 16 are
// too narrow for its Hopper ones), each followed by PyTorch's bias add and
// ReLU passes, with four f32 passes of DD3D.preprocess_image before the
// first. One source, three instantiations, each a direct conv on the tensor
// cores (mma.sync m16n8k16 bf16 -> f32) with its NHWC halo tile in shared
// memory:
// - kind 0, `base_layer`: 7x7, stride 1, 3 -> 16, reading the uint8 BGR
//   frames (B, H, W, 3) and normalizing them as it stages them;
// - kind 1, `level0`: 3x3, stride 1, 16 -> 16, bf16 NHWC in;
// - kind 2, `level1`: 3x3, stride 2, 16 -> 32, bf16 NHWC in.
// Every output (B, Ho, Wo, O) is written once, NHWC bf16.
//
// Arithmetic, that of the unfused path (ops/stem_conv.py::stem_conv_plain):
// - frames: f32 (v - mean[c]) / std[c] with a division, rounded to bf16,
//   from a 3 x 256 table each block builds once; the conv's padding outside
//   the image is 0 in the normalized domain;
// - the sum of bf16 products in f32 (products of two bf16 are exact in f32,
//   so only the order of the sums differs from the plain version), rounded
//   to bf16 as cuDNN's output is; the bf16 bias added in f32 and rounded to
//   bf16, as PyTorch's separate add_; then the ReLU. Built with -fmad=false
//   and explicitly rounded intrinsics.
//
// What bounds it on this card, at batch 128 and 384x1280: the three convs do
// 731 GFLOP (0.739 ms at 989 TFLOP/s bf16); one fused chain would move only
// the frames in and level1's output out, 1.2 GB (0.36 ms). Three separate
// kernels move 0.19 + 2.0 (base_layer), 2.0 + 2.0 (level0) and 2.0 + 1.0 GB
// (level1): 9.2 GB, 2.75 ms at 3.35 TB/s, so each kernel is bound by its
// bytes, and the design is about moving them at the card's rate:
// - level0 / level1: a block walks output tiles (8 x 64 pixels, 8 x 32 at
//   stride 2) in a fixed order, double-buffered: the next tile's halo is in
//   flight as 16-byte cp.async (zero-filled outside the image) while the
//   tensor cores work on this one. K = 9 taps x 16 channels: one k16 step a
//   tap, whose A fragment (16 pixels x 16 channels) is one ldmatrix.x4 from
//   the NHWC halo tile. The tile's 16-byte units are XOR-swizzled within
//   128-byte lines (u ^ (u >> 3 & 1) at stride 1, u ^ (u >> 2 & 7) at stride
//   2), so the eight rows of every ldmatrix phase fall in eight different
//   bank groups. The weights (B fragments) and the bias stay in registers
//   for the whole kernel.
// - base_layer: C = 3, so a pixel's channels are not 16-byte rows. K runs
//   over a kernel row's 7 taps x 3 channels (21 values that lie next to each
//   other in a halo row) plus three zero-weight slots: 7 x 24 = 168, 11 k16
//   steps, so that every 8-value chunk of K lies in one kernel row at an
//   offset known at compile time. A register's pair of K values is a 32-bit
//   shared load, aligned only at even pixels, so the halo is held twice: as
//   it is, and shifted by one value for the odd pixels. Each warp stages
//   whole halo rows, so the bounds are one comparison a value; the next
//   tile's frame bytes are loaded into registers before this tile's MMAs
//   and normalized into the halo after them.
// - Every kernel stages its 16 x O output fragment through a padded
//   shared-memory row per warp and writes it with 16-byte stores, 512 or
//   1024 contiguous bytes a warp.
// The wrapper cuts the batch into runs of images below 2^31 elements a
// tensor (ops/int8_conv.batch_chunks), one launch a run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8;  // output rows of a tile

struct Params {
  int b, h, w;   // input images of this launch
  int ho, wo;    // output
  int tiles_h, tiles_w, ntiles;
};

__device__ __forceinline__ float bf16_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}
__device__ __forceinline__ unsigned short float_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// The conv's sum as cuDNN's bf16 output, the bias added as PyTorch's bf16
// add_ (in f32, rounded), then the ReLU (NaN passes, as F.relu's).
__device__ __forceinline__ unsigned epilogue(float acc, float bias) {
  const float z = bf16_to_float(float_to_bf16(__fadd_rn(bf16_to_float(float_to_bf16(acc)), bias)));
  return float_to_bf16((z > 0.0f || z != z) ? z : 0.0f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tile_origin(const Params& p, int tile, int tw, int* bi, int* oh0, int* ow0) {
  const int per_image = p.tiles_h * p.tiles_w;
  *bi = tile / per_image;
  const int rem = tile % per_image;
  *oh0 = (rem / p.tiles_w) * kTH;
  *ow0 = (rem % p.tiles_w) * tw;
}

// Output row stride of the per-warp staging area, in bf16: O + 8, so that
// the fragment's 32-bit writes (pixel g, channel pair t) hit 32 banks.
template <int COUT>
struct Staging {
  static constexpr int kRow = COUT + 8;
  static constexpr int kElems = 16 * kRow;  // a warp's 16 pixels
};

// Write a warp's 16 x COUT fragment (pixels ox0.. of output row oh) from
// the accumulators, through the warp's staging rows, as 16-byte stores.
template <int COUT>
__device__ __forceinline__ void store_fragment(const float (&acc)[COUT / 8][4], const float (&bias)[COUT / 8][2],
                                               unsigned short* st, unsigned short* __restrict__ out,
                                               const Params& p, int bi, int oh, int ox0) {
  using S = Staging<COUT>;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < COUT / 8; ++nt) {
    const int ch = nt * 8 + 2 * t;
    *reinterpret_cast<unsigned*>(st + g * S::kRow + ch) =
        epilogue(acc[nt][0], bias[nt][0]) | (epilogue(acc[nt][1], bias[nt][1]) << 16);
    *reinterpret_cast<unsigned*>(st + (g + 8) * S::kRow + ch) =
        epilogue(acc[nt][2], bias[nt][0]) | (epilogue(acc[nt][3], bias[nt][1]) << 16);
  }
  __syncwarp();
  constexpr int kChunks = COUT / 8;  // 16-byte chunks a pixel
  if (oh < p.ho) {
    const size_t row = (static_cast<size_t>(bi) * p.ho + oh) * p.wo;
#pragma unroll
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int px = i / kChunks, c = i % kChunks;
      const int ow = ox0 + px;
      if (ow < p.wo)
        *reinterpret_cast<uint4*>(out + (row + ow) * COUT + c * 8) =
            *reinterpret_cast<const uint4*>(st + px * S::kRow + c * 8);
    }
  }
  __syncwarp();
}

// ---- level0 / level1: 3x3 over 16 bf16 channels ----------------------------

template <int STRIDE, int COUT>
struct Level {
  static constexpr int kTW = STRIDE == 1 ? 64 : 32;            // output columns of a tile
  static constexpr int kHR = (kTH - 1) * STRIDE + 3;           // halo rows
  static constexpr int kHC = (kTW - 1) * STRIDE + 3;           // halo columns
  static constexpr int kUnits = (kHR * kHC * 2 + 7) / 8 * 8;   // 16-byte units of a stage, whole lines
  static constexpr int kMTiles = kTH * kTW / 16;
  static constexpr int kNT = COUT / 8;
  static constexpr size_t kSmem = 2 * kUnits * 16 + kWarps * Staging<COUT>::kElems * 2;
};

template <int STRIDE>
__device__ __forceinline__ int swizzle(int u) {
  return STRIDE == 1 ? u ^ ((u >> 3) & 1) : u ^ ((u >> 2) & 7);
}

// Stage tile `tile`'s halo (rows oh0*S - 1 .., columns ow0*S - 1 ..) into
// `buf`, zeros outside the image.
template <int STRIDE, int COUT>
__device__ __forceinline__ void stage_level(const unsigned short* __restrict__ x, uint4* buf, const Params& p,
                                            int tile) {
  using L = Level<STRIDE, COUT>;
  int bi, oh0, ow0;
  tile_origin(p, tile, L::kTW, &bi, &oh0, &ow0);
  const int ih0 = oh0 * STRIDE - 1, iw0 = ow0 * STRIDE - 1;
  for (int i = threadIdx.x; i < L::kHR * L::kHC * 2; i += kThreads) {
    const int px = i >> 1, half = i & 1;
    const int gh = ih0 + px / L::kHC, gw = iw0 + px % L::kHC;
    const bool ok = gh >= 0 && gh < p.h && gw >= 0 && gw < p.w;
    const unsigned short* src = ok ? x + ((static_cast<size_t>(bi) * p.h + gh) * p.w + gw) * 16 + half * 8 : x;
    cp_async16(buf + swizzle<STRIDE>(i), src, ok);
  }
}

template <int STRIDE, int COUT>
__device__ __forceinline__ void level_conv(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                                           const unsigned short* __restrict__ bias, unsigned short* __restrict__ out,
                                           const Params& p) {
  using L = Level<STRIDE, COUT>;
  extern __shared__ __align__(128) uint4 smem[];
  uint4* bufs = smem;
  unsigned short* staging =
      reinterpret_cast<unsigned short*>(smem + 2 * L::kUnits) + (threadIdx.x / 32) * Staging<COUT>::kElems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // B fragments: k = channel within tap `tap`, n = output channel; lane
  // (g, t) holds rows k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column g.
  uint32_t bf[9][L::kNT][2];
  float bs[L::kNT][2];
#pragma unroll
  for (int nt = 0; nt < L::kNT; ++nt) {
    const int n = nt * 8 + g;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 2 * t + 8 * j;
        const uint32_t lo = w[(n * 16 + c) * 9 + tap], hi = w[(n * 16 + c + 1) * 9 + tap];
        bf[tap][nt][j] = lo | (hi << 16);
      }
    }
    bs[nt][0] = bf16_to_float(bias[nt * 8 + 2 * t]);
    bs[nt][1] = bf16_to_float(bias[nt * 8 + 2 * t + 1]);
  }
  // ldmatrix.x4: lane L gives row L % 16 (a pixel) and channel half L / 16.
  const int lrow = lane & 15, lhalf = lane >> 4;

  int buf = 0;
  if (blockIdx.x < p.ntiles) stage_level<STRIDE, COUT>(x, bufs, p, blockIdx.x);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.ntiles) stage_level<STRIDE, COUT>(x, bufs + (buf ^ 1) * L::kUnits, p, next);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const uint4* tb = bufs + buf * L::kUnits;
    int bi, oh0, ow0;
    tile_origin(p, tile, L::kTW, &bi, &oh0, &ow0);
#pragma unroll 1
    for (int mt = warp; mt < L::kMTiles; mt += kWarps) {
      const int oy = mt / (L::kTW / 16), ox0 = (mt % (L::kTW / 16)) * 16;
      const int px0 = oy * STRIDE * L::kHC + (ox0 + lrow) * STRIDE;
      float acc[L::kNT][4];
#pragma unroll
      for (int nt = 0; nt < L::kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int u = (px0 + (tap / 3) * L::kHC + tap % 3) * 2 + lhalf;
        const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(tb + swizzle<STRIDE>(u)));
        uint32_t a[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                     : "r"(addr));
#pragma unroll
        for (int nt = 0; nt < L::kNT; ++nt) mma_bf16(acc[nt], a, bf[tap][nt][0], bf[tap][nt][1]);
      }
      store_fragment<COUT>(acc, bs, staging, out, p, bi, oh0 + oy, ow0 + ox0);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// ---- base_layer: 7x7 over the uint8 frames, normalized in the load -------

constexpr int kStemTW = 64;
constexpr int kStemHR = kTH + 6;                    // 14 halo rows
constexpr int kStemValues = (kStemTW + 6) * 3;      // 210 values a halo row (70 pixels x 3 channels)
constexpr int kStemRow = 224;                       // bf16 a halo row holds; zeros past 210
constexpr int kStemCopy = kStemHR * kStemRow + 32;  // one copy; +32 puts the second on other banks
constexpr int kStemChunks = 7 * 3;                  // K in chunks of 8: 3 a kernel row (21 values + 3 zero slots)
constexpr int kStemKSteps = (kStemChunks + 1) / 2;  // 11 k16 steps
constexpr int kStemRowsPerWarp = (kStemHR + kWarps - 1) / kWarps;  // halo rows a warp stages
constexpr int kStemPerLane = (kStemValues + 31) / 32;              // values a lane stages a row
constexpr unsigned kOutside = 0x100;                // a loaded "byte" outside the image

// This thread's frame bytes of tile `tile`'s halo: warp w stages rows w and
// w + 8, lane l values l, l + 32, ... of a row (kOutside outside the image).
__device__ __forceinline__ void load_frames(const unsigned char* __restrict__ frames, const Params& p, int tile,
                                            unsigned (&v)[kStemRowsPerWarp][kStemPerLane]) {
  int bi, oh0, ow0;
  tile_origin(p, tile, kStemTW, &bi, &oh0, &ow0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = (ow0 - 3) * 3;  // the halo row's first value in an image row
#pragma unroll
  for (int rr = 0; rr < kStemRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    const int gh = oh0 - 3 + r;
    const bool row_ok = r < kStemHR && gh >= 0 && gh < p.h;
    const unsigned char* row = frames + (static_cast<size_t>(bi) * p.h + (row_ok ? gh : 0)) * p.w * 3;
#pragma unroll
    for (int m = 0; m < kStemPerLane; ++m) {
      const int e = lane + 32 * m, col = col0 + e;
      const bool ok = row_ok && e < kStemValues && col >= 0 && col < p.w * 3;
      v[rr][m] = ok ? static_cast<unsigned>(row[col]) : kOutside;
    }
  }
}

// Normalize the loaded bytes into both halo copies: copy0[e] = X[e] and
// copy1[e - 1] = X[e] (X a halo row's values), 0 outside the image.
__device__ __forceinline__ void store_frames(const unsigned (&v)[kStemRowsPerWarp][kStemPerLane],
                                             const unsigned short* lut, unsigned short* copy0,
                                             unsigned short* copy1) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int rr = 0; rr < kStemRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= kStemHR) continue;
#pragma unroll
    for (int m = 0; m < kStemPerLane; ++m) {
      const int e = lane + 32 * m;
      if (e < kStemValues) {
        const unsigned short val = v[rr][m] == kOutside ? 0 : lut[(e % 3) * 256 + v[rr][m]];
        copy0[r * kStemRow + e] = val;
        if (e > 0) copy1[r * kStemRow + e - 1] = val;
      }
    }
  }
}

// K chunk q = 2 ks + j holds kernel row q / 3's values 8 (q % 3) .. + 7 (tap
// s = value / 3, channel value % 3; values 21-23 and chunk 21 weigh 0), at
// halo offset chunk_offset(q) + 2t (+1) from a pixel's first value for lane
// t's pair.
__host__ __device__ constexpr int chunk_offset(int q) {
  return q < kStemChunks ? (q / 3) * kStemRow + 8 * (q % 3) : 0;
}

__device__ __forceinline__ void frames_conv(const unsigned char* __restrict__ frames,
                                            const unsigned short* __restrict__ w,
                                            const unsigned short* __restrict__ bias, const float* __restrict__ mean,
                                            const float* __restrict__ stdev, unsigned short* __restrict__ out,
                                            const Params& p) {
  __shared__ __align__(16) unsigned short halo[2 * kStemCopy];
  __shared__ unsigned short lut[3 * 256];
  __shared__ __align__(16) unsigned short staging_all[kWarps * Staging<16>::kElems];
  unsigned short* copy0 = halo;
  unsigned short* copy1 = halo + kStemCopy;
  unsigned short* staging = staging_all + (threadIdx.x / 32) * Staging<16>::kElems;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  for (int i = threadIdx.x; i < 3 * 256; i += kThreads) {
    const int c = i / 256;
    lut[i] = float_to_bf16(__fdiv_rn(__fsub_rn(static_cast<float>(i % 256), mean[c]), stdev[c]));
  }
  // The slots past a row's values are read with zero weights only; they
  // stay 0 (store_frames writes below 210 and 209).
  for (int i = threadIdx.x; i < kStemHR * kStemRow; i += kThreads) {
    const int e = i % kStemRow;
    if (e >= kStemValues) copy0[i] = 0;
    if (e >= kStemValues - 1) copy1[i] = 0;
  }

  // B fragments: lane (g, t) holds K rows 2t, 2t+1 of chunks 2 ks (b0) and
  // 2 ks + 1 (b1), column g.
  uint32_t bf[kStemKSteps][2][2];
  float bs[2][2];
#pragma unroll
  for (int ks = 0; ks < kStemKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = 2 * ks + j, r = q / 3;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int n = nt * 8 + g;
        uint32_t pair = 0;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {
          const int jj = 8 * (q % 3) + 2 * t + qq;
          if (q < kStemChunks && jj < 21)
            pair |= static_cast<uint32_t>(w[((n * 3 + jj % 3) * 7 + r) * 7 + jj / 3]) << (16 * qq);
        }
        bf[ks][nt][j] = pair;
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    bs[nt][0] = bf16_to_float(bias[nt * 8 + 2 * t]);
    bs[nt][1] = bf16_to_float(bias[nt * 8 + 2 * t + 1]);
  }
  // Pixels g and g + 8 of an m16 tile have the parity of g: an odd one
  // reads copy1, one value back, so that its pairs are 32-bit aligned.
  const unsigned short* base = ((g & 1) ? copy1 - 1 : copy0) + 3 * g + 2 * t;

  unsigned v[kStemRowsPerWarp][kStemPerLane];
  if (blockIdx.x < p.ntiles) load_frames(frames, p, blockIdx.x, v);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's MMAs are done with the halo (and the table is built)
    store_frames(v, lut, copy0, copy1);
    __syncthreads();
    const int next = tile + gridDim.x;
    if (next < p.ntiles) load_frames(frames, p, next, v);  // in flight during the MMAs
    int bi, oh0, ow0;
    tile_origin(p, tile, kStemTW, &bi, &oh0, &ow0);
#pragma unroll 1
    for (int mt = warp; mt < kTH * kStemTW / 16; mt += kWarps) {
      const int oy = mt / (kStemTW / 16), ox0 = (mt % (kStemTW / 16)) * 16;
      const unsigned short* cp = base + oy * kStemRow + 3 * ox0;
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kStemKSteps; ++ks) {
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(cp + chunk_offset(2 * ks));
        a[1] = *reinterpret_cast<const uint32_t*>(cp + chunk_offset(2 * ks) + 24);  // pixel + 8
        a[2] = *reinterpret_cast<const uint32_t*>(cp + chunk_offset(2 * ks + 1));
        a[3] = *reinterpret_cast<const uint32_t*>(cp + chunk_offset(2 * ks + 1) + 24);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) mma_bf16(acc[nt], a, bf[ks][nt][0], bf[ks][nt][1]);
      }
      store_fragment<16>(acc, bs, staging, out, p, bi, oh0 + oy, ow0 + ox0);
    }
  }
}

// The one kernel, instantiated per shape: <7, 1, 3, 16> base_layer (the
// frames), <3, 1, 16, 16> level0, <3, 2, 16, 32> level1.
template <int KH, int STRIDE, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads, 2)
    stem_conv_kernel(const void* __restrict__ x, const unsigned short* __restrict__ w,
                     const unsigned short* __restrict__ bias, const float* __restrict__ mean,
                     const float* __restrict__ stdev, unsigned short* __restrict__ out, Params p) {
  if constexpr (CIN == 3) {
    static_assert(KH == 7 && STRIDE == 1 && COUT == 16, "the frames' conv is base_layer's");
    frames_conv(static_cast<const unsigned char*>(x), w, bias, mean, stdev, out, p);
  } else {
    static_assert(KH == 3 && CIN == 16 && COUT == 16 * STRIDE, "the 16-channel convs are level0's and level1's");
    level_conv<STRIDE, COUT>(static_cast<const unsigned short*>(x), w, bias, out, p);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// A fixed grid of resident blocks (a function of the kernel and the card),
// no more than there are tiles.
template <class Kernel>
int grid_for(Kernel kernel, size_t smem, int ntiles, int* grid) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const long long blocks = static_cast<long long>(per_sm) * sm_count();
  *grid = static_cast<int>(blocks < ntiles ? blocks : ntiles);
  return 0;
}

Params make_params(int b, int h, int w, int stride, int tw) {
  Params p;
  p.b = b;
  p.h = h;
  p.w = w;
  p.ho = (h - 1) / stride + 1;
  p.wo = (w - 1) / stride + 1;
  p.tiles_h = (p.ho + kTH - 1) / kTH;
  p.tiles_w = (p.wo + tw - 1) / tw;
  p.ntiles = b * p.tiles_h * p.tiles_w;
  return p;
}

template <int KH, int STRIDE, int CIN, int COUT>
int launch(const void* x, const void* w, const void* bias, const float* mean, const float* stdev, void* out, int b,
           int h, int wd, cudaStream_t stream) {
  constexpr int kTW = CIN == 3 ? kStemTW : Level<STRIDE, COUT>::kTW;
  constexpr size_t kSmem = CIN == 3 ? 0 : Level<STRIDE, COUT>::kSmem;  // the frames' conv: static only
  const Params p = make_params(b, h, wd, STRIDE, kTW);
  auto kernel = stem_conv_kernel<KH, STRIDE, CIN, COUT>;
  if (kSmem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int grid = 0;
  const int e = grid_for(kernel, kSmem, p.ntiles, &grid);
  if (e != 0) return e;
  kernel<<<grid, kThreads, kSmem, stream>>>(x, static_cast<const unsigned short*>(w),
                                            static_cast<const unsigned short*>(bias), mean, stdev,
                                            static_cast<unsigned short*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One stem conv on `stream`, no synchronisation; returns a cudaError_t
// (1, cudaErrorInvalidValue, for what it does not take).
// kind 0: x the uint8 frames (B, H, W, 3), mean and stdev 3 floats each,
//         w (16, 3, 7, 7) bf16 OIHW, out (B, H, W, 16);
// kind 1: x bf16 (B, H, W, 16), w (16, 16, 3, 3), out (B, H, W, 16);
// kind 2: x bf16 (B, H, W, 16), w (32, 16, 3, 3), out (B, ceil(H/2), ceil(W/2), 32).
// bias: O bf16. Kinds 1 and 2 need x 16-byte aligned; out is 16-byte aligned.
int dd3d_stem_conv(int kind, const void* x, const void* w, const void* bias, const float* mean, const float* stdev,
                   void* out, int b, int h, int wd, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || h <= 0 || wd <= 0 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 0) return launch<7, 1, 3, 16>(x, w, bias, mean, stdev, out, b, h, wd, s);
  if (reinterpret_cast<uintptr_t>(x) % 16) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 1) return launch<3, 1, 16, 16>(x, w, bias, nullptr, nullptr, out, b, h, wd, s);
  if (kind == 2) return launch<3, 2, 16, 32>(x, w, bias, nullptr, nullptr, out, b, h, wd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
