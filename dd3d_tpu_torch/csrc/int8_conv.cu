// int8 x int8 -> int32 convolution with a per-output-channel dequant
// epilogue, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces dd3d_tpu/models/layers.py::_int8_conv (:246-276), which XLA
// generates for the TPU (there is no Pallas source): an NHWC/HWIO
// conv_general_dilated of int8 operands with preferred_element_type=int32,
// then
//
//   out = cast_out(f32(acc) * scale[o]);  out = cast_out(out + cast_out(bias[o]))
//
// with scale = xs * ws formed as an (O,) f32 vector beforehand (:276) and the
// bias added in the output dtype (:364-365). PyTorch has no int8 convolution
// on CUDA, so the port needs this one by hand.
//
// Layout: x int8 (B, H, W, C) NHWC; w int8 (O, KH, KW, C) "OHWI"; out
// (B, Ho, Wo, O) NHWC, f32 or bf16. As an implicit GEMM: M = B*Ho*Wo output
// pixels, N = O, K = KH*KW*C, and both operands are K-contiguous (a pixel's
// receptive field walks (r, s, c) with c fastest, exactly the weight's
// OHWI order), which is the row.col operand order of mma.sync.
//
// What bounds it on this card: the tensor-core rate. A tower conv at P3,
// (8, 48, 160, 256) -> 256, 3x3, is 72.5 GOP against 1979 int8 TOP/s; it
// reads 15.7 MB and writes 31 MB (bf16), far below what 3.35 TB/s allows.
// This first kernel is simple and exact rather than fast: a 128x64 output
// tile per 256-thread block, 8 warps of 32x32, K in 64-byte steps through
// double-buffered shared memory (one barrier a step; the next step's global
// loads are in flight in registers while the tensor cores work), and
// mma.sync.m16n8k32 s8*s8 -> s32. Rows in shared memory are padded from
// 64 to 80 bytes, so the fragment loads of a warp hit 32 different banks.
// wgmma, TMA, a deeper pipeline and a fused next-layer quantize are later
// work.
//
// Exact: int32 accumulation cannot overflow for |codes| <= 127 and
// K < 2^31 / 127^2 = 133,000 (the largest K of the path is 3*3*512 = 4608).
// The epilogue uses explicitly rounded intrinsics and the library is built
// with -fmad=false, so it gives the bits of the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;   // output pixels a block
constexpr int kBN = 64;    // output channels a block
constexpr int kBK = 64;    // bytes of K a step (two mma k32 steps)
constexpr int kRow = 80;   // padded shared-memory row, bytes (16-byte aligned)

struct ConvShape {
  int batch, h, w, c, o, kh, kw, stride, pad, ho, wo;
  int k;       // KH*KW*C
  int m;       // B*Ho*Wo
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int VEC>
struct Chunk;
template <>
struct Chunk<16> {
  using T = uint4;
  __device__ static T zero() { return make_uint4(0, 0, 0, 0); }
};
template <>
struct Chunk<4> {
  using T = uint32_t;
  __device__ static T zero() { return 0u; }
};

__device__ __forceinline__ void store_out(float* out, long long idx, float v, const float* bias, int o) {
  if (bias != nullptr) v = __fadd_rn(v, bias[o]);
  out[idx] = v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* out, long long idx, float v, const float* bias, int o) {
  __nv_bfloat16 y = __float2bfloat16_rn(v);
  if (bias != nullptr) {
    const float b = __bfloat162float(__float2bfloat16_rn(bias[o]));
    y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
  }
  out[idx] = y;
}

// VEC: bytes a global load moves (16 needs C % 16 == 0, 4 needs C % 4 == 0),
// so a chunk never straddles two (r, s) positions of the receptive field.
template <int VEC, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, OutT* __restrict__ out, ConvShape s) {
  using C = Chunk<VEC>;
  constexpr int kChunksPerRow = kBK / VEC;            // 4 or 16
  constexpr int kRowsPerPass = kThreads / kChunksPerRow;  // 64 or 16
  constexpr int kAPasses = kBM / kRowsPerPass;        // 2 or 8
  constexpr int kBPasses = kBN / kRowsPerPass;        // 1 or 4

  __shared__ __align__(16) unsigned char smem_a[2][kBM][kRow];
  __shared__ __align__(16) unsigned char smem_b[2][kBN][kRow];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kc = tid % kChunksPerRow;
  const int r0 = tid / kChunksPerRow;

  // Per-row receptive-field origin of this thread's A rows.
  int a_base[kAPasses], a_h0[kAPasses], a_w0[kAPasses];
  const int hw_out = s.ho * s.wo;
#pragma unroll
  for (int i = 0; i < kAPasses; ++i) {
    const int m = m0 + r0 + i * kRowsPerPass;
    if (m < s.m) {
      const int img = m / hw_out;
      const int rem = m - img * hw_out;
      const int ho = rem / s.wo;
      const int wo = rem - ho * s.wo;
      a_base[i] = img * s.h * s.w * s.c;
      a_h0[i] = ho * s.stride - s.pad;
      a_w0[i] = wo * s.stride - s.pad;
    } else {
      a_base[i] = 0;
      a_h0[i] = -(1 << 29);  // never in bounds
      a_w0[i] = 0;
    }
  }

  typename C::T a_reg[kAPasses], b_reg[kBPasses];
  auto load_tile = [&](int kt) {
    const int k = kt * kBK + kc * VEC;
    const bool k_ok = k < s.k;
    int r = 0, q = 0, c = 0;
    if (k_ok) {
      const int rs = k / s.c;
      c = k - rs * s.c;
      r = rs / s.kw;
      q = rs - r * s.kw;
    }
#pragma unroll
    for (int i = 0; i < kAPasses; ++i) {
      const int hi = a_h0[i] + r, wi = a_w0[i] + q;
      if (k_ok && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w) {
        a_reg[i] = *reinterpret_cast<const typename C::T*>(x + a_base[i] + (hi * s.w + wi) * s.c + c);
      } else {
        a_reg[i] = C::zero();
      }
    }
#pragma unroll
    for (int i = 0; i < kBPasses; ++i) {
      const int o = n0 + r0 + i * kRowsPerPass;
      if (k_ok && o < s.o) {
        b_reg[i] = *reinterpret_cast<const typename C::T*>(w + static_cast<long long>(o) * s.k + k);
      } else {
        b_reg[i] = C::zero();
      }
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPasses; ++i)
      *reinterpret_cast<typename C::T*>(&smem_a[buf][r0 + i * kRowsPerPass][kc * VEC]) = a_reg[i];
#pragma unroll
    for (int i = 0; i < kBPasses; ++i)
      *reinterpret_cast<typename C::T*>(&smem_b[buf][r0 + i * kRowsPerPass][kc * VEC]) = b_reg[i];
  };

  const int warp = tid / 32, lane = tid % 32;
  const int warp_m = warp % 4, warp_n = warp / 4;  // 4 x 2 warps of 32 x 32
  const int g = lane / 4, t = lane % 4;             // mma groupID, threadID_in_group

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int k_tiles = (s.k + kBK - 1) / kBK;
  load_tile(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    store_tile(buf);
    __syncthreads();
    if (kt + 1 < k_tiles) load_tile(kt + 1);
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = warp_m * 32 + mt * 16 + g;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&smem_a[buf][row][ks + t * 4]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&smem_a[buf][row + 8][ks + t * 4]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&smem_a[buf][row][ks + 16 + t * 4]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&smem_a[buf][row + 8][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp_n * 32 + nt * 8 + g;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(&smem_b[buf][col][ks + t * 4]);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(&smem_b[buf][col][ks + 16 + t * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }

  // Epilogue: c0, c1 at (g, 2t), (g, 2t+1); c2, c3 eight rows below.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 32 + mt * 16 + g + half * 8;
      if (m >= s.m) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = n0 + warp_n * 32 + nt * 8 + t * 2 + e;
          if (o >= s.o) continue;
          const float v = __fmul_rn(__int2float_rn(acc[mt][nt][half * 2 + e]), scale[o]);
          store_out(out, static_cast<long long>(m) * s.o + o, v, bias, o);
        }
      }
    }
  }
}

template <int VEC, typename OutT>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out, const ConvShape& s,
           void* stream) {
  const dim3 grid((s.m + kBM - 1) / kBM, (s.o + kBN - 1) / kBN);
  int8_conv_kernel<VEC, OutT><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, bias, static_cast<OutT*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x int8 (batch, h, w, c); w int8 (o, kh, kw, c); scale f32 (o); bias f32 (o)
// or null; out (batch, ho, wo, o), bf16 when out_bf16 else f32. c must be a
// multiple of 4, every tensor contiguous, x and w 16-byte aligned, and each
// tensor under 2^31 elements (the wrapper checks). Launches on `stream`,
// does not synchronise; returns cudaGetLastError(), or -1 on a shape the
// kernel does not take.
int dd3d_int8_conv(const void* x, const void* w, const float* scale, const float* bias, void* out, int out_bf16,
                   int batch, int h, int w_, int c, int o, int kh, int kw, int stride, int pad, void* stream) {
  ConvShape s;
  s.batch = batch; s.h = h; s.w = w_; s.c = c; s.o = o; s.kh = kh; s.kw = kw; s.stride = stride; s.pad = pad;
  s.ho = (h + 2 * pad - kh) / stride + 1;
  s.wo = (w_ + 2 * pad - kw) / stride + 1;
  s.k = kh * kw * c;
  s.m = batch * s.ho * s.wo;
  if (c % 4 != 0 || s.ho <= 0 || s.wo <= 0 || o <= 0) return -1;
  if (s.m == 0) return 0;
  if (c % 16 == 0) {
    return out_bf16 ? launch<16, __nv_bfloat16>(x, w, scale, bias, out, s, stream)
                    : launch<16, float>(x, w, scale, bias, out, s, stream);
  }
  return out_bf16 ? launch<4, __nv_bfloat16>(x, w, scale, bias, out, s, stream)
                  : launch<4, float>(x, w, scale, bias, out, s, stream);
}

}  // extern "C"
