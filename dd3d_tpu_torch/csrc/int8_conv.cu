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
// Layout: x int8 (B, H, W, C) NHWC with C % 16 == 0 (the wrapper pads C
// with zero channels); w int8 (O, KH, KW, C) "OHWI"; out (B, Ho, Wo, O)
// NHWC, f32 or bf16. As an implicit GEMM: M = B*Ho*Wo output pixels, N = O,
// K = KH*KW*C, and both operands are K-contiguous (a pixel's receptive
// field walks (r, s, c) with c fastest, exactly the weight's OHWI order).
//
// What bounds it on this card: the tensor-core rate. A tower conv at P3,
// (8, 48, 160, 256) -> 256, 3x3, is 72.5 GOP against 1979 int8 TOP/s
// (0.037 ms); it reads 15.7 MB and writes 31 MB (bf16), ~0.014 ms at
// 3.35 TB/s.
//
// Design: warpgroup MMAs (wgmma.mma_async m64nNk32 s8 * s8 -> s32), the only
// way to the int8 tensor-core rate on Hopper; the first version's mma.sync
// reached 12 % of it.
// - A block computes 128 output pixels x BN output channels (BN = 128, or
//   64 where O <= 64) with two warpgroups of 64 rows each; each thread
//   keeps BN/2 int32 accumulators.
// - K runs in stages of 128 bytes through a ring of 3 buffers in shared
//   memory. (A 6-deep ring, one block an SM, was no faster at the small
//   grids of the P5-P7 convs and 1.4x slower at P3.) Both operands are
//   K-major, 128-byte rows with the 128-byte swizzle (16-byte chunk c of
//   row r at chunk c ^ (r % 8)), the layout the wgmma descriptors name, so
//   the MMAs read them without bank conflicts. Every thread stages its share of each tile with 16-byte
//   cp.async: the weight tile (OHWI seen as (O, K)) and the implicit-im2col
//   activation tile, zero-filled for padding, the ragged M edge and K
//   beyond the end. A 16-byte chunk never straddles two (r, s) taps, as
//   C % 16 == 0. The other stages are in flight while the tensor cores work
//   on one; one barrier a stage (cp.async.wait_group, a proxy fence, then
//   __syncthreads) hands a stage from the copies to the MMAs.
// - 96 KB of shared memory a block with 3 stages, so two blocks share an SM
//   and one's epilogue and barriers overlap the other's MMAs.
// - The epilogue dequantizes in registers, stages the output tile in the
//   freed ring and writes whole rows with 16-byte stores.
//
// Exact: int32 accumulation cannot overflow for |codes| <= 127 and
// K < 2^31 / 127^2 = 133,000 (the largest K of the path is 3*3*512 = 4608),
// and integer sums are exact in any order. The epilogue uses explicitly
// rounded intrinsics and the library is built with -fmad=false, so it gives
// the bits of the plain PyTorch version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // output pixels a block
constexpr int kBK = 128;       // bytes of K a stage: one 128-byte swizzled row
constexpr int kStages = 3;     // the K ring: 96 KB a block, two blocks an SM

struct ConvShape {
  int batch, h, w, c, o, kh, kw, stride, pad, ho, wo;
  int k;  // KH*KW*C
  int m;  // B*Ho*Wo
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows with the
// 128-byte swizzle: start address, leading offset (unused for this layout),
// stride between 8-row groups (1024 bytes), swizzle mode 1 = 128 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1)
      : "memory");
}

__device__ __forceinline__ float dequant(int acc, const float* scale, const float* bias, int o, float) {
  const float v = __fmul_rn(__int2float_rn(acc), scale[o]);
  return bias != nullptr ? __fadd_rn(v, bias[o]) : v;
}

__device__ __forceinline__ __nv_bfloat16 dequant(int acc, const float* scale, const float* bias, int o,
                                                 __nv_bfloat16) {
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale[o]));
  if (bias != nullptr) {
    const float b = __bfloat162float(__float2bfloat16_rn(bias[o]));
    y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
  }
  return y;
}

template <typename OutT>
struct alignas(2 * sizeof(OutT)) Pair {  // two neighbouring channels, one store
  OutT v[2];
};

template <int BN, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, OutT* __restrict__ out, ConvShape s) {
  constexpr int kATile = kBM * kBK;
  constexpr int kStage = (kBM + BN) * kBK;
  constexpr int kARows = kBM / (kThreads / 8);  // rows a thread stages: 4
  constexpr int kBRows = BN / (kThreads / 8);   // 4 or 2
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of address bits 4-9: stages 1024-byte aligned
  const uint32_t smem0 = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int kc = tid % 8;      // this thread's 16-byte chunk of each 128-byte row
  const int r0 = tid / 8;      // and its rows r0 + 32 i
  const uint32_t swz = static_cast<uint32_t>(((kc ^ (r0 & 7)) * 16));

  // Receptive-field origin of this thread's A rows.
  int a_base[kARows], a_h0[kARows], a_w0[kARows];
  const int hw_out = s.ho * s.wo;
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int m = m0 + r0 + 32 * i;
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

  auto load_stage = [&](int kt, int stage) {
    const uint32_t a_dst = smem0 + stage * kStage;
    const uint32_t b_dst = a_dst + kATile;
    const int k = kt * kBK + kc * 16;
    const bool k_ok = k < s.k;
    int r = 0, q = 0, c = 0;
    if (k_ok) {
      const int rs = k / s.c;
      c = k - rs * s.c;
      r = rs / s.kw;
      q = rs - r * s.kw;
    }
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int hi = a_h0[i] + r, wi = a_w0[i] + q;
      const bool ok = k_ok && hi >= 0 && hi < s.h && wi >= 0 && wi < s.w;
      cp_async16(a_dst + (r0 + 32 * i) * kBK + swz, ok ? x + a_base[i] + (hi * s.w + wi) * s.c + c : x, ok);
    }
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int o = n0 + r0 + 32 * i;
      const bool ok = k_ok && o < s.o;
      cp_async16(b_dst + (r0 + 32 * i) * kBK + swz, ok ? w + static_cast<long long>(o) * s.k + k : w, ok);
    }
  };

  const int wg = tid / 128;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  const int k_tiles = (s.k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_tiles) load_stage(st, st);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    // the copies went through the generic proxy; wgmma reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage kt complete for all; stage kt - 1 released by all
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next, next % kStages);
    asm volatile("cp.async.commit_group;\n" ::);

    const uint32_t a_tile = smem0 + (kt % kStages) * kStage + wg * 64 * kBK;
    const uint32_t b_tile = smem0 + (kt % kStages) * kStage + kATile;
    const uint64_t desc_a = smem_desc(a_tile), desc_b = smem_desc(b_tile);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      // 32 bytes of K further along the swizzled rows: +2 in 16-byte units
      wgmma_s8(acc, desc_a + 2 * ks, desc_b + 2 * ks);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }

  // Epilogue: dequantize in registers, stage the 128 x BN tile in shared
  // memory (the ring is free once every warpgroup is past its last MMA),
  // then write whole rows with 16-byte stores. Accumulator 4j + e of a
  // thread: row 16 * warp + g (+8 for e >= 2) of its warpgroup's 64,
  // column 8j + 2t (+1 for odd e).
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  constexpr int kRowBytes = BN * static_cast<int>(sizeof(OutT)) + 16;  // +16: rows in other banks
  unsigned char* tile = smem_raw + (smem0 - smem_u32(smem_raw));
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wg * 64 + warp * 16 + g + half * 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + t * 2, o = n0 + col;
      const OutT v0 = o < s.o ? dequant(acc[4 * j + 2 * half], scale, bias, o, OutT()) : OutT();
      const OutT v1 = o + 1 < s.o ? dequant(acc[4 * j + 2 * half + 1], scale, bias, o + 1, OutT()) : OutT();
      *reinterpret_cast<Pair<OutT>*>(tile + rl * kRowBytes + col * sizeof(OutT)) = Pair<OutT>{{v0, v1}};
    }
  }
  __syncthreads();
  constexpr int kVec = 16 / static_cast<int>(sizeof(OutT));
  constexpr int kChunks = BN / kVec;
  const bool rows_aligned = s.o % kVec == 0;
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int rl = i / kChunks, o = n0 + (i % kChunks) * kVec;
    const int m = m0 + rl;
    if (m >= s.m || o >= s.o) continue;
    const unsigned char* src = tile + rl * kRowBytes + (i % kChunks) * 16;
    OutT* dst = out + static_cast<long long>(m) * s.o + o;
    if (rows_aligned && o + kVec <= s.o) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kVec && o + e < s.o; ++e) dst[e] = reinterpret_cast<const OutT*>(src)[e];
    }
  }
}

template <int BN, typename OutT>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out, const ConvShape& s,
           cudaStream_t stream) {
  constexpr int smem = kStages * (kBM + BN) * kBK + 1024;  // + slack for the 1024-byte alignment
  static_assert(kStages * (kBM + BN) * kBK >= kBM * (BN * 4 + 16), "the epilogue tile must fit the ring");
  cudaError_t err =
      cudaFuncSetAttribute(int8_conv_kernel<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.m + kBM - 1) / kBM, (s.o + BN - 1) / BN);
  int8_conv_kernel<BN, OutT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, bias, static_cast<OutT*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_out(const void* x, const void* w, const float* scale, const float* bias, void* out, const ConvShape& s,
               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.o <= 64 ? launch<64, OutT>(x, w, scale, bias, out, s, st) : launch<128, OutT>(x, w, scale, bias, out, s, st);
}

}  // namespace

extern "C" {

// x int8 (batch, h, w, c); w int8 (o, kh, kw, c); scale f32 (o); bias f32 (o)
// or null; out (batch, ho, wo, o), bf16 when out_bf16 else f32. c must be a
// multiple of 16, every tensor contiguous, x and w 16-byte aligned, and each
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
  if (c % 16 != 0 || s.ho <= 0 || s.wo <= 0 || o <= 0) return -1;
  if (s.m == 0) return 0;
  return out_bf16 ? launch_out<__nv_bfloat16>(x, w, scale, bias, out, s, stream)
                  : launch_out<float>(x, w, scale, bias, out, s, stream);
}

}  // extern "C"
