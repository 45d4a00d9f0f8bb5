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
// - s8 output (out_kind 2 and 3): where a head tower chains two int8 convs
//   (tower conv i -> i + 1, the last -> the fused predictors), the epilogue
//   also applies the ReLU and the next conv's quantize at its static scale
//   (`quantize_one` of quantize.cuh, the standalone kernel's arithmetic),
//   so the conv writes 1 byte an element in place of a bf16 tensor that a
//   ReLU would read and write and the quantize kernel read again (9 bytes
//   an element, three launches). The dequantized tile is staged as for a
//   bf16 (f32) output; the pass that writes it out reads 16 values a
//   thread and stores their 16 codes at once. Quantizing in that pass, and
//   not on the 64 accumulators a thread holds, keeps one inlined copy of
//   `quantize_one` for 16 values instead of 64 (a first version that
//   quantized in registers ran the P3 tower conv 23 % slower than its bf16
//   epilogue).
//
// Exact: int32 accumulation cannot overflow for |codes| <= 127 and
// K < 2^31 / 127^2 = 133,000 (the largest K of the path is 3*3*512 = 4608),
// and integer sums are exact in any order. The epilogue uses explicitly
// rounded intrinsics and the library is built with -fmad=false, so it gives
// the bits of the plain PyTorch version.

// A second entry, dd3d_int8_conv_grouped, is the same function with
// feature_group_count = g > 1 (layers.py:273): output channel o reads the
// input channels of its group, (o / (O/g)) * C/g onward. The caller names one
// of four routes (ops/int8_conv.py::grouped_route picks one by shape); each
// keeps the plain version's bits, through the same epilogue operations
// (`dequant`, `dequant_pair`).
// Sizes are those of the dd3d_kitti_regnety_006_bifpn forward (depthwise,
// mma) and of the DLA-X-60 forward (narrow) at batch 8, 384x1280, where
// every grouped conv is bound by bytes.
//
// - depthwise (C/g = 1, O = C, C % 16 == 0, 3x3, stride 1 or 2): BiFPN's
//   24 `dw` convs, (8, 48, 160, 160) at P3 down to (8, 3, 10, 160) at P7.
//   What bounds it: reading x once and writing the output once (P3: 9.8 MB
//   in, 19.7 MB of bf16 out, 8.8 us at 3.35 TB/s). The work, 9 multiply-adds
//   an output, is small, but a thread that fetched every tap from L1 one byte
//   at a time (the direct route) is bound by load instructions. Design: a
//   block owns 8 output rows x 32 columns x 32 channels and stages its input
//   tile with the halo in shared memory with 16-byte cp.async, zero-filled
//   for the padding, so each input byte comes from device memory ~1.33
//   times (10 x 34 pixels for 8 x 32 at stride 1). The 9 x 32 weights sit
//   in shared memory as f32. A thread owns 8 channels at 4 neighbouring
//   columns of one row: it reads each staged pixel's 8 bytes once a tap row,
//   converts the codes to f32 exactly (a byte permute under the exponent of
//   2^23, then one subtraction) and sums with f32 FMAs, exact because every
//   partial sum is an integer below 9 * 127^2 < 2^24. The tile's row stride
//   puts the four rows a half-warp reads on distinct banks. The epilogue
//   writes 8 channels a pixel: one 16-byte store of bf16, two of f32. A
//   thread is held to 128 registers (two blocks an SM): unbounded, the
//   compiler kept every staged read and weight live (216 registers, one
//   block an SM, 1.6x slower at P3).
// - mma (C/g 16 or 32, O/g a multiple of 8 up to 64, 3x3, stride 1 or 2):
//   RegNet's 15 Y-block `b` convs (C/g = O/g = 16; stride 2 in each stage's
//   first block). s1_b0/b, (8, 192, 640, 48) -> (8, 96, 320, 48), is 1.70 G
//   multiply-adds (245,760 outputs x 48 channels x 144), 0.42 G __dp4a on
//   the CUDA cores: instruction-bound there. On the tensor cores it is bound
//   by bytes (47 MB read, 24 MB of bf16 written: 21 us). Design: an implicit
//   GEMM a group, M = output pixels, N = O/g, K = 9 taps x C/g, on mma.sync
//   m16n8k32 (s8 x s8 -> s32). A 32-byte k-step covers two taps of 16
//   channels, and the ninth tap of C/g = 16 takes one m16n8k16 step, so K is
//   not padded. A block owns 8 x 16 output pixels for a run of groups of at
//   most 64 channels (each pixel's slice one coalesced read). It stages the
//   input tile with its halo ((2*8+1) x (2*16+1) pixels at stride 2) and
//   the run's weights with cp.async, and feeds A with ldmatrix: each 16-byte
//   matrix row is one pixel's channels of one tap, at a per-lane address. A
//   pixel takes an odd number of 16-byte units and a stride-2 tile keeps the
//   even and odd input columns in separate halves, so the 8 rows of each
//   ldmatrix lie on distinct banks. A warp owns one output row of the tile
//   (16 pixels) and takes the run's groups in turn, up to 16 output channels
//   at a time; its epilogue dequantizes the MMA fragments into shared memory
//   and writes 16-byte rows. The tile's geometry is fixed at compile time,
//   so the loops hold no division by a runtime value, and a thread is held
//   to 64 registers (four blocks an SM).
// - narrow (C/g = O/g = 2, 4 or 8, C % 16 == 0, 3x3, stride 1 or 2): the 3x3
//   of DLA-X's BottleneckX (cardinality 32 or 64), the XLA op of
//   dd3d_tpu/models/layers.py:273 at C/g 4 and 8 in DLA-X-60 and DLA-X-102
//   (levels 2-3), 2 to 8 in the -C variants. What bounds it: bytes. Level 2's stride-2 conv,
//   (8, 192, 640, 128) -> (8, 96, 320, 128) at C/g 4, reads 126 MB and writes
//   63 MB of bf16 (56 us at 3.35 TB/s) for 1.13 G multiply-adds, 0.28 G
//   __dp4a: 17 us at 64 __dp4a a clock an SM (the IMAD rate; a __dp4a loop
//   issues as fast as an IMAD loop on this card), so once each input byte
//   comes from device memory about once, the memory sets the time. (At stride 1 and C/g 8, (8, 48, 160, 256), the
//   bytes take 14 us and the same 0.28 G __dp4a 17 us.) Design: the
//   depthwise route's tile (8 output rows x 32 columns x 32 channels, the
//   input halo staged with 16-byte cp.async, zero-filled, on rows that put a
//   half-warp's reads on distinct banks); 32 channels are whole groups at
//   C/g <= 8. A thread owns 8 channels at 4 neighbouring columns, and since
//   O/g = C/g its 8 outputs read exactly its 8 input channels: one 8-byte
//   shared load a pixel and tap feeds 16 __dp4a at C/g 8 (two words of one
//   group), 8 at C/g 4 (a word a group) and 8 at C/g 2 (two groups a word:
//   each output's weight word is zero in the other group's half), where the
//   direct route loads a word for one __dp4a. The weights are expanded once
//   a block into such words, block-diagonal, in shared memory ([tap][octet]
//   rows padded so the four octets a warp reads lie on distinct banks), and
//   read as 16-byte vectors, one tap's at a time. A block sums kNarrowTiles
//   tiles of one image in turn, two staging buffers deep: the copies of
//   tile i + 1 are in flight while tile i is summed. Blocks of the same
//   tiles and neighbouring channel runs are neighbours in the grid. Sums are
//   exact int32s below 2^24, so the epilogue's float conversion is exact;
//   it writes 8 channels a pixel with 16-byte stores (store8). A thread is
//   held to 128 registers (two blocks an SM; 74 KB of shared memory a block
//   at stride 2). Measured against it on the card, each slower or no faster
//   on DLA-X-60's six convs: one tile a block held to 80 registers (three
//   blocks an SM, a few bytes spilled), 2 or 8 tiles a block, the channel
//   runs slowest in the grid, and the tensor cores: the mma kernel on
//   block-diagonal weights, every 32 channels one group of C/g 32
//   (dd3d_tpu_torch/bench_grouped.py times it beside this route).
// - direct (any shape; served alone where no other route admits it: C/g
//   3, O = 2C, 5x5, stride 3, C % 16 != 0, ...): the first version, kept as
//   the general route. A thread owns one output channel at kPix
//   neighbouring output columns, so each
//   weight it loads serves kPix sums; neighbouring threads own neighbouring
//   channels, so a warp's stores and input reads are contiguous. With
//   C % 4 == 0 and C/g % 4 == 0 it takes four channels a __dp4a, else one
//   a multiply-add. What bounds it: load instructions, not bytes. Nothing
//   is staged in shared memory, so each input is loaded again, from L1 or
//   L2, by every thread whose window covers it (9 times at stride 1); at
//   the regnety shapes it reaches 0.02-0.07 of the byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "quantize.cuh"

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

// The tiled routes' epilogue, for two neighbouring channels at once: the
// operations of `dequant` on the sums as exact floats, with the bias already
// rounded as the output dtype adds it (bias_term, once a channel) and a bf16
// pair rounded by one conversion (to nearest even, each element: the same
// bits).
__device__ __forceinline__ float bias_term(const float* bias, int o, float) {
  return bias != nullptr ? __ldg(bias + o) : 0.0f;
}

__device__ __forceinline__ float bias_term(const float* bias, int o, __nv_bfloat16) {
  return bias != nullptr ? __bfloat162float(__float2bfloat16_rn(__ldg(bias + o))) : 0.0f;
}

__device__ __forceinline__ Pair<__nv_bfloat16> dequant_pair(float s0, float s1, float sc0, float sc1, float b0,
                                                            float b1, bool has_bias, __nv_bfloat16) {
  __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(s0, sc0), __fmul_rn(s1, sc1));
  if (has_bias) y = __floats2bfloat162_rn(__fadd_rn(__low2float(y), b0), __fadd_rn(__high2float(y), b1));
  return Pair<__nv_bfloat16>{{__low2bfloat16(y), __high2bfloat16(y)}};
}

__device__ __forceinline__ Pair<float> dequant_pair(float s0, float s1, float sc0, float sc1, float b0, float b1,
                                                    bool has_bias, float) {
  float v0 = __fmul_rn(s0, sc0), v1 = __fmul_rn(s1, sc1);
  if (has_bias) {
    v0 = __fadd_rn(v0, b0);
    v1 = __fadd_rn(v1, b1);
  }
  return Pair<float>{{v0, v1}};
}

// The s8 output's 16 codes from 16 staged dequantized values (MathT, the
// epilogue's dtype; 32 or 64 bytes of the tile): the next conv's codes of
// their ReLU at its scale (`quantize_one`, the standalone kernel's
// arithmetic), packed into one 16-byte word.
template <typename MathT>
__device__ __forceinline__ uint4 requant16(const unsigned char* src, const QuantScale& next) {
  constexpr int kLoads = 16 * static_cast<int>(sizeof(MathT)) / 16;
  uint4 raw[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) raw[i] = reinterpret_cast<const uint4*>(src)[i];
  const MathT* v = reinterpret_cast<const MathT*>(raw);
  uint32_t words[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float f = fmaxf(to_f32(v[4 * w + i]), 0.0f);  // the ReLU, then the quantize
      word |= static_cast<uint32_t>(static_cast<unsigned char>(quantize_one(f, next))) << (8 * i);
    }
    words[w] = word;
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

template <int BN, typename OutT, typename MathT>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, OutT* __restrict__ out, const float* __restrict__ xs_next,
                 ConvShape s) {
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
  // then write whole rows with 16-byte stores (8 bf16 or 4 f32; for s8 out,
  // 16 codes of 16 staged values, ReLU and quantize applied on the way).
  // Accumulator 4j + e of a thread: row 16 * warp + g (+8 for e >= 2) of
  // its warpgroup's 64, column 8j + 2t (+1 for odd e).
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  constexpr int kRowBytes = BN * static_cast<int>(sizeof(MathT)) + 16;  // +16: rows in other banks
  unsigned char* tile = smem_raw + (smem0 - smem_u32(smem_raw));
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wg * 64 + warp * 16 + g + half * 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + t * 2, o = n0 + col;
      const MathT v0 = o < s.o ? dequant(acc[4 * j + 2 * half], scale, bias, o, MathT()) : MathT();
      const MathT v1 = o + 1 < s.o ? dequant(acc[4 * j + 2 * half + 1], scale, bias, o + 1, MathT()) : MathT();
      *reinterpret_cast<Pair<MathT>*>(tile + rl * kRowBytes + col * sizeof(MathT)) = Pair<MathT>{{v0, v1}};
    }
  }
  __syncthreads();
  constexpr int kVec = 16 / static_cast<int>(sizeof(OutT));  // elements a 16-byte store
  constexpr int kChunks = BN / kVec;
  constexpr int kSrcBytes = kVec * static_cast<int>(sizeof(MathT));  // their staged bytes
  const bool rows_aligned = s.o % kVec == 0;
  QuantScale next;
  if constexpr (std::is_same<OutT, int8_t>::value) next = make_quant_scale(*xs_next);
  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int rl = i / kChunks, o = n0 + (i % kChunks) * kVec;
    const int m = m0 + rl;
    if (m >= s.m || o >= s.o) continue;
    const unsigned char* src = tile + rl * kRowBytes + (i % kChunks) * kSrcBytes;
    OutT* dst = out + static_cast<long long>(m) * s.o + o;
    if (rows_aligned && o + kVec <= s.o) {
      if constexpr (std::is_same<OutT, int8_t>::value) {
        *reinterpret_cast<uint4*>(dst) = requant16<MathT>(src, next);
      } else {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      }
    } else {
      for (int e = 0; e < kVec && o + e < s.o; ++e) {
        if constexpr (std::is_same<OutT, int8_t>::value) {
          dst[e] = quantize_one(fmaxf(to_f32(reinterpret_cast<const MathT*>(src)[e]), 0.0f), next);
        } else {
          dst[e] = reinterpret_cast<const OutT*>(src)[e];
        }
      }
    }
  }
}

template <int BN, typename OutT, typename MathT>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out, const float* xs_next,
           const ConvShape& s, cudaStream_t stream) {
  constexpr int smem = kStages * (kBM + BN) * kBK + 1024;  // + slack for the 1024-byte alignment
  static_assert(kStages * (kBM + BN) * kBK >= kBM * (BN * 4 + 16), "the epilogue tile must fit the ring");
  cudaError_t err =
      cudaFuncSetAttribute(int8_conv_kernel<BN, OutT, MathT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.m + kBM - 1) / kBM, (s.o + BN - 1) / BN);
  int8_conv_kernel<BN, OutT, MathT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), scale, bias, static_cast<OutT*>(out), xs_next,
      s);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, typename MathT = OutT>
int launch_out(const void* x, const void* w, const float* scale, const float* bias, void* out, const float* xs_next,
               const ConvShape& s, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.o <= 64 ? launch<64, OutT, MathT>(x, w, scale, bias, out, xs_next, s, st)
                   : launch<128, OutT, MathT>(x, w, scale, bias, out, xs_next, s, st);
}

constexpr int kGroupedThreads = 256;
constexpr int kPix = 4;  // output columns a thread of the grouped kernel

// x int8 (B, H, W, C); w int8 (O, KH, KW, C/g); out (B, Ho, Wo, O). Thread
// index -> (o fastest, then the run of kPix columns, the row, the image).
template <bool kVec, typename OutT>
__global__ void __launch_bounds__(kGroupedThreads)
int8_conv_grouped_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                         const float* __restrict__ bias, OutT* __restrict__ out, ConvShape s, int groups,
                         int runs, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kGroupedThreads + threadIdx.x;
  if (idx >= total) return;
  const int o = static_cast<int>(idx % s.o);
  long long rest = idx / s.o;
  const int run = static_cast<int>(rest % runs);
  rest /= runs;
  const int ho = static_cast<int>(rest % s.ho);
  const int b = static_cast<int>(rest / s.ho);
  const int cg = s.c / groups;
  const int c0 = (o / (s.o / groups)) * cg;
  const int wo0 = run * kPix;

  int acc[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) acc[p] = 0;
  const int8_t* wo_ = w + static_cast<size_t>(o) * s.kh * s.kw * cg;
  for (int r = 0; r < s.kh; ++r) {
    const int hi = ho * s.stride - s.pad + r;
    if (hi < 0 || hi >= s.h) continue;
    const int8_t* xrow = x + (static_cast<size_t>(b) * s.h + hi) * s.w * s.c + c0;
    for (int q = 0; q < s.kw; ++q) {
      const int8_t* wt = wo_ + (r * s.kw + q) * cg;
      int wi[kPix];
      bool in[kPix];
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        wi[p] = (wo0 + p) * s.stride - s.pad + q;
        in[p] = wo0 + p < s.wo && wi[p] >= 0 && wi[p] < s.w;
      }
      if (kVec) {
        for (int c = 0; c < cg; c += 4) {
          const int wv = __ldg(reinterpret_cast<const int*>(wt + c));
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            if (in[p]) acc[p] = __dp4a(__ldg(reinterpret_cast<const int*>(xrow + static_cast<size_t>(wi[p]) * s.c + c)),
                                       wv, acc[p]);
          }
        }
      } else {
        for (int c = 0; c < cg; ++c) {
          const int wv = wt[c];
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            if (in[p]) acc[p] += static_cast<int>(__ldg(xrow + static_cast<size_t>(wi[p]) * s.c + c)) * wv;
          }
        }
      }
    }
  }
  OutT* dst = out + ((static_cast<size_t>(b) * s.ho + ho) * s.wo + wo0) * s.o + o;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    if (wo0 + p < s.wo) dst[static_cast<size_t>(p) * s.o] = dequant(acc[p], scale, bias, o, OutT());
  }
}

template <typename OutT>
int launch_grouped(const void* x, const void* w, const float* scale, const float* bias, void* out,
                   const ConvShape& s, int groups, void* stream) {
  const int cg = s.c / groups;
  const bool vec = s.c % 4 == 0 && cg % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const int runs = (s.wo + kPix - 1) / kPix;
  const long long total = static_cast<long long>(s.batch) * s.ho * runs * s.o;
  const long long blocks = (total + kGroupedThreads - 1) / kGroupedThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  OutT* o = static_cast<OutT*>(out);
  if (vec) {
    int8_conv_grouped_kernel<true, OutT><<<static_cast<unsigned>(blocks), kGroupedThreads, 0, st>>>(
        xi, wi, scale, bias, o, s, groups, runs, total);
  } else {
    int8_conv_grouped_kernel<false, OutT><<<static_cast<unsigned>(blocks), kGroupedThreads, 0, st>>>(
        xi, wi, scale, bias, o, s, groups, runs, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- The depthwise route ----

constexpr int kDwThreads = 256;    // 8 warps
constexpr int kDwPix = 4;          // output columns a thread
constexpr int kDwTH = 8;           // output rows a block: lane / 4
constexpr int kDwTW = 8 * kDwPix;  // output columns a block: a run of kDwPix a warp
constexpr int kDwCB = 32;          // channels a block: 8 a thread, lane % 4

// Bytes between the staged tile's rows: at least a row of pixels, a multiple
// of 16 (cp.async), and such that the four rows a half-warp reads (lane / 4,
// so `s` input rows apart) start 32 or 96 bytes apart modulo 128: their
// 32-byte runs then cover the 32 banks once.
__host__ __device__ constexpr int dw_row_bytes(int s) {
  int rs = ((kDwTW - 1) * s + 3) * kDwCB;
  while ((s * rs) % 128 != 32 && (s * rs) % 128 != 96) rs += 16;
  return rs;
}

// Four int8 codes of a word to exact floats: byte b ^ 0x80 = b + 128 goes
// under the exponent of 2^23 (the float 2^23 + b + 128), then 2^23 + 128 is
// subtracted.
__device__ __forceinline__ void s8x4_to_f32(uint32_t word, float* v) {
  const uint32_t u = word ^ 0x80808080u;
  v[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)), 8388736.0f);
  v[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)), 8388736.0f);
  v[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)), 8388736.0f);
  v[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)), 8388736.0f);
}

// 8 neighbouring channels of one output pixel from their exact sums, with
// their scales and bias terms: one 16-byte store of bf16, two of f32.
template <typename OutT>
__device__ __forceinline__ void store8(OutT* dst, const float (&sum)[8], const float (&sc)[8], const float (&bi)[8],
                                       bool has_bias) {
  alignas(16) Pair<OutT> v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = dequant_pair(sum[2 * e], sum[2 * e + 1], sc[2 * e], sc[2 * e + 1], bi[2 * e], bi[2 * e + 1], has_bias,
                        OutT());
  }
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(v)) / 16; ++i) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(v)[i];
  }
}

// The staged halo tile of a kDwTH x kDwTW output tile at stride S: rows,
// columns (pixels of kDwCB bytes), bytes between rows.
template <int S>
struct DwTile {
  static constexpr int kRows = (kDwTH - 1) * S + 3;
  static constexpr int kCols = (kDwTW - 1) * S + 3;
  static constexpr int kRowBytes = dw_row_bytes(S);
};

// Stages the input tile with its halo (input rows and columns from h0 and
// w0, channels c0 onward of image b) with 16-byte cp.async, two chunks a
// pixel; zeros outside the image and past the last channel. Commits the
// copies as one group.
template <int S>
__device__ __forceinline__ void stage_dw_tile(unsigned char* tile, const int8_t* x, const ConvShape& s, int b, int h0,
                                              int w0, int c0) {
  using Tile = DwTile<S>;
  const int8_t* xb = x + static_cast<size_t>(b) * s.h * s.w * s.c;
  for (int i = threadIdx.x; i < Tile::kRows * Tile::kCols * 2; i += kDwThreads) {
    const int half = i & 1, pix = i >> 1;
    const int r = pix / Tile::kCols, q = pix - r * Tile::kCols;
    const int hi = h0 + r, wi = w0 + q, c = c0 + half * 16;
    const bool ok = hi >= 0 && hi < s.h && wi >= 0 && wi < s.w && c < s.c;
    cp_async16(smem_u32(tile + r * Tile::kRowBytes + q * kDwCB + half * 16),
               ok ? xb + (static_cast<size_t>(hi) * s.w + wi) * s.c + c : x, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// x int8 (B, H, W, C); w int8 (C, 3, 3, 1); out (B, Ho, Wo, C). Grid: (output
// tiles of kDwTH x kDwTW, runs of kDwCB channels, images).
template <int S, typename OutT>
__global__ void __launch_bounds__(kDwThreads, 2)  // <= 128 registers: two blocks an SM
int8_conv_depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                           const float* __restrict__ scale, const float* __restrict__ bias, OutT* __restrict__ out,
                           ConvShape s, int tiles_w) {
  constexpr int kRowBytes = DwTile<S>::kRowBytes;
  __shared__ __align__(16) unsigned char tile[DwTile<S>::kRows * kRowBytes];
  __shared__ __align__(16) float wsm[9][kDwCB];

  const int tid = threadIdx.x;
  const int oh0 = (blockIdx.x / tiles_w) * kDwTH, ow0 = (blockIdx.x % tiles_w) * kDwTW;
  const int c0 = blockIdx.y * kDwCB;
  const int b = blockIdx.z;
  stage_dw_tile<S>(tile, x, s, b, oh0 * S - s.pad, ow0 * S - s.pad, c0);
  for (int i = tid; i < 9 * kDwCB; i += kDwThreads) {
    const int tap = i / kDwCB, c = c0 + i % kDwCB;
    wsm[tap][i % kDwCB] = c < s.c ? static_cast<float>(w[c * 9 + tap]) : 0.0f;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32;
  const int oct = lane % 4, row = lane / 4;
  float acc[kDwPix][8];
#pragma unroll
  for (int p = 0; p < kDwPix; ++p) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[p][e] = 0.0f;
  }
  const unsigned char* src = tile + row * S * kRowBytes + warp * kDwPix * S * kDwCB + oct * 8;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float wr[3][8];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float4 lo = *reinterpret_cast<const float4*>(&wsm[r * 3 + q][oct * 8]);
      const float4 hi = *reinterpret_cast<const float4*>(&wsm[r * 3 + q][oct * 8 + 4]);
      wr[q][0] = lo.x; wr[q][1] = lo.y; wr[q][2] = lo.z; wr[q][3] = lo.w;
      wr[q][4] = hi.x; wr[q][5] = hi.y; wr[q][6] = hi.z; wr[q][7] = hi.w;
    }
    // Column k of the thread's window feeds output p through tap q where
    // k = p * S + q.
#pragma unroll
    for (int k = 0; k < (kDwPix - 1) * S + 3; ++k) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + r * kRowBytes + k * kDwCB);
      float v[8];
      s8x4_to_f32(raw.x, v);
      s8x4_to_f32(raw.y, v + 4);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (k < q || (k - q) % S != 0 || (k - q) / S >= kDwPix) continue;
        const int p = (k - q) / S;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[p][e] = __fmaf_rn(wr[q][e], v[e], acc[p][e]);
      }
    }
  }

  const int oh = oh0 + row, c = c0 + oct * 8;
  if (oh >= s.ho || c >= s.c) return;
  float sc[8], bi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = __ldg(scale + c + e);
    bi[e] = bias_term(bias, c + e, OutT());
  }
#pragma unroll
  for (int p = 0; p < kDwPix; ++p) {
    const int ow = ow0 + warp * kDwPix + p;
    if (ow < s.wo) {
      store8(out + ((static_cast<size_t>(b) * s.ho + oh) * s.wo + ow) * s.o + c, acc[p], sc, bi, bias != nullptr);
    }
  }
}

template <typename OutT>
int launch_grouped_depthwise(const void* x, const void* w, const float* scale, const float* bias, void* out,
                             const ConvShape& s, void* stream) {
  const int tiles_w = (s.wo + kDwTW - 1) / kDwTW, tiles_h = (s.ho + kDwTH - 1) / kDwTH;
  const dim3 grid(tiles_h * tiles_w, (s.c + kDwCB - 1) / kDwCB, s.batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  OutT* o = static_cast<OutT*>(out);
  if (s.stride == 1) {
    int8_conv_depthwise_kernel<1, OutT><<<grid, kDwThreads, 0, st>>>(xi, wi, scale, bias, o, s, tiles_w);
  } else {
    int8_conv_depthwise_kernel<2, OutT><<<grid, kDwThreads, 0, st>>>(xi, wi, scale, bias, o, s, tiles_w);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- The narrow route ----

constexpr int kNarrowTiles = 4;  // output tiles a block: each staged while the one before is summed

// The expanded weights of the narrow route at C/g = CG: for each tap and
// octet of the block's channels, the 8 outputs' weight words over the
// octet's 8 input channels, zero outside each output's group. Only the
// words that can be non-zero are kept: both at C/g 8, at C/g 2 and 4 the one
// that holds the output's group (input word e / 4 for output e).
template <int CG>
struct NarrowWeights {
  static constexpr int kWords = CG == 8 ? 2 : 1;          // words an output a tap
  static constexpr int kOctBytes = 8 * kWords * 4 + 16;  // an octet's row, +16: four octets on distinct banks
  static constexpr int kBytes = 9 * 4 * kOctBytes;
};

// x int8 (B, H, W, C); w int8 (C, 3, 3, CG); out (B, Ho, Wo, C), with C/g =
// O/g = CG. Grid: (runs of kDwCB channels; runs of kNarrowTiles of the
// image's output tiles of kDwTH x kDwTW, in row-major order; images).
template <int S, int CG, typename OutT>
__global__ void __launch_bounds__(kDwThreads, 2)  // <= 128 registers: two blocks an SM
int8_conv_grouped_narrow_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                OutT* __restrict__ out, ConvShape s, int tiles_w, int tiles) {
  using Wt = NarrowWeights<CG>;
  constexpr int kRowBytes = DwTile<S>::kRowBytes;
  constexpr int kTileBytes = DwTile<S>::kRows * kRowBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wsm = smem + 2 * kTileBytes;

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kDwCB;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kNarrowTiles, t1 = min(t0 + kNarrowTiles, tiles);
  auto stage = [&](int t, int buf) {
    stage_dw_tile<S>(smem + buf * kTileBytes, x, s, b, (t / tiles_w) * kDwTH * S - s.pad,
                     (t % tiles_w) * kDwTW * S - s.pad, c0);
  };
  stage(t0, 0);
  // Weight word k of output e (channel c0 + 8 oct + e) at tap t: input
  // channels 4 kx .. 4 kx + 3 of the octet, kx = k at C/g 8 and e / 4
  // otherwise; byte i holds the weight of channel 4 kx + i where that
  // channel lies in the output's group, else 0.
  for (int i = tid; i < 9 * kDwCB * Wt::kWords; i += kDwThreads) {
    const int k = i % Wt::kWords, ol = (i / Wt::kWords) % kDwCB, t = i / (Wt::kWords * kDwCB);
    const int o = c0 + ol, e = ol % 8;
    const int kx = Wt::kWords == 2 ? k : e / 4;
    uint32_t word = 0;
    if (o < s.c) {
      const int8_t* wo = w + (static_cast<size_t>(o) * 9 + t) * CG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 4 * kx + j;  // input channel within the octet
        if (ch / CG == e / CG) word |= static_cast<uint32_t>(static_cast<uint8_t>(wo[ch % CG])) << (8 * j);
      }
    }
    *reinterpret_cast<uint32_t*>(wsm + (t * 4 + ol / 8) * Wt::kOctBytes + (e * Wt::kWords + k) * 4) = word;
  }

  // Thread: 8 channels (octet lane % 4) at kDwPix neighbouring columns
  // (warp) of one output row (lane / 4) of each tile, as the depthwise
  // route's.
  const int lane = tid % 32, warp = tid / 32;
  const int oct = lane % 4, row = lane / 4;
  const int c = c0 + oct * 8;
  float sc[8], bi[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sc[e] = c < s.c ? __ldg(scale + c + e) : 0.0f;
    bi[e] = c < s.c ? bias_term(bias, c + e, OutT()) : 0.0f;
  }
  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < t1) {
      stage(t + 1, buf ^ 1);  // into the buffer the previous tile was summed from
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile t staged by all (and the weights, before the first)

    int acc[kDwPix][8];
#pragma unroll
    for (int p = 0; p < kDwPix; ++p) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[p][e] = 0;
    }
    const unsigned char* src = smem + buf * kTileBytes + row * S * kRowBytes + warp * kDwPix * S * kDwCB + oct * 8;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int r = tap / 3, q = tap % 3;
      uint32_t wt[8 * Wt::kWords];
#pragma unroll
      for (int v = 0; v < 2 * Wt::kWords; ++v) {
        const uint4 u = reinterpret_cast<const uint4*>(wsm + (tap * 4 + oct) * Wt::kOctBytes)[v];
        wt[4 * v] = u.x; wt[4 * v + 1] = u.y; wt[4 * v + 2] = u.z; wt[4 * v + 3] = u.w;
      }
#pragma unroll
      for (int p = 0; p < kDwPix; ++p) {
        const uint2 xv = *reinterpret_cast<const uint2*>(src + r * kRowBytes + (p * S + q) * kDwCB);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (Wt::kWords == 2) {
            acc[p][e] = __dp4a(static_cast<int>(xv.y), static_cast<int>(wt[2 * e + 1]),
                               __dp4a(static_cast<int>(xv.x), static_cast<int>(wt[2 * e]), acc[p][e]));
          } else {
            acc[p][e] = __dp4a(static_cast<int>(e < 4 ? xv.x : xv.y), static_cast<int>(wt[e]), acc[p][e]);
          }
        }
      }
    }

    const int oh = (t / tiles_w) * kDwTH + row, ow0 = (t % tiles_w) * kDwTW + warp * kDwPix;
    if (oh < s.ho && c < s.c) {
#pragma unroll
      for (int p = 0; p < kDwPix; ++p) {
        if (ow0 + p < s.wo) {
          float sum[8];  // exact: |sum| <= 9 * 8 * 127^2 < 2^24
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] = __int2float_rn(acc[p][e]);
          store8(out + ((static_cast<size_t>(b) * s.ho + oh) * s.wo + ow0 + p) * s.o + c, sum, sc, bi,
                 bias != nullptr);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
}

template <int S, int CG, typename OutT>
int launch_narrow_kernel(const int8_t* x, const int8_t* w, const float* scale, const float* bias, OutT* out,
                         const ConvShape& s, cudaStream_t stream) {
  constexpr int smem = 2 * DwTile<S>::kRows * DwTile<S>::kRowBytes + NarrowWeights<CG>::kBytes;  // 2 tiles, weights
  cudaError_t err = cudaFuncSetAttribute(int8_conv_grouped_narrow_kernel<S, CG, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (s.wo + kDwTW - 1) / kDwTW, tiles = ((s.ho + kDwTH - 1) / kDwTH) * tiles_w;
  const dim3 grid((s.c + kDwCB - 1) / kDwCB, (tiles + kNarrowTiles - 1) / kNarrowTiles, s.batch);
  int8_conv_grouped_narrow_kernel<S, CG, OutT><<<grid, kDwThreads, smem, stream>>>(x, w, scale, bias, out, s,
                                                                                   tiles_w, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_grouped_narrow(const void* x, const void* w, const float* scale, const float* bias, void* out,
                          const ConvShape& s, int groups, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  OutT* o = static_cast<OutT*>(out);
  const int cg = s.c / groups;
  if (s.stride == 1) {
    return cg == 2   ? launch_narrow_kernel<1, 2>(xi, wi, scale, bias, o, s, st)
           : cg == 4 ? launch_narrow_kernel<1, 4>(xi, wi, scale, bias, o, s, st)
                     : launch_narrow_kernel<1, 8>(xi, wi, scale, bias, o, s, st);
  }
  return cg == 2   ? launch_narrow_kernel<2, 2>(xi, wi, scale, bias, o, s, st)
         : cg == 4 ? launch_narrow_kernel<2, 4>(xi, wi, scale, bias, o, s, st)
                   : launch_narrow_kernel<2, 8>(xi, wi, scale, bias, o, s, st);
}

// ---- The mma route ----

constexpr int kMmaThreads = 256;  // 8 warps, one an output row of the tile
constexpr int kMmaTH = 8;         // output rows a block
constexpr int kMmaTW = 16;        // output columns a block: the 16 rows of an m16 tile
constexpr int kMmaRunBytes = 64;  // channels of a block's run of groups, at most: 4 units of 16 bytes
static_assert(kMmaTH == kMmaThreads / 32, "a warp an output row");

// The staged halo tile of stride S: rows, columns, and the column at which
// the odd input columns start (stride 2) or 0.
template <int S>
struct MmaTile {
  static constexpr int kRows = (kMmaTH - 1) * S + 3;
  static constexpr int kCols = (kMmaTW - 1) * S + 3;
  static constexpr int kHalf = S == 1 ? 0 : (kCols + 1) / 2;
  static constexpr int kColsAlloc = S == 1 ? kCols : 2 * kHalf;
};

// The mma route's shared-memory plan, set on the host.
struct MmaPlan {
  int groups, cg, og;
  int gb;         // groups a block
  int pix_bytes;  // a staged pixel: gb * cg bytes, + 16 where that is an even number of 16-byte units
  int w_row;      // a staged weight row: 9 * cg bytes, + 16 likewise
  int tile_bytes, w_bytes;
  int tiles_w;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&a)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n" : "=r"(a[0]), "=r"(a[1]) : "r"(addr));
}

__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// An int32 sum as a float, exactly. With C/g = 16 (kM = 1) |sum| <= 144 *
// 127^2 < 2^22: the sum goes into the mantissa of 1.5 * 2^23, which is then
// subtracted (an integer add and a float add, where the conversion
// instruction runs at a quarter of their rate).
template <int kM>
__device__ __forceinline__ float exact_float(int sum) {
  if (kM == 1) return __fsub_rn(__int_as_float(sum + 0x4B400000), 12582912.0f);
  return __int2float_rn(sum);
}

// x int8 (B, H, W, C); w int8 (O, 3, 3, C/g); out (B, Ho, Wo, O). kM = C/g / 16:
// K runs over 9 * kM 16-byte chunks, chunk t * kM + u holding tap t's
// channels 16u onward (the weight's OHWI order). Grid: (output tiles of
// kMmaTH x kMmaTW, runs of p.gb groups, images).
template <int S, int kM, typename OutT>
__global__ void __launch_bounds__(kMmaThreads, 4)  // <= 64 registers: four blocks an SM
int8_conv_grouped_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                             const float* __restrict__ scale, const float* __restrict__ bias,
                             OutT* __restrict__ out, ConvShape s, MmaPlan p) {
  using Tile = MmaTile<S>;
  constexpr int kChunks = 9 * kM;
  constexpr int kStageRow = 16 * static_cast<int>(sizeof(OutT)) + 16;  // a staged output pixel, padded
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tile = smem;
  unsigned char* wsm = smem + p.tile_bytes;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  unsigned char* stage = wsm + p.w_bytes + warp * 16 * kStageRow;
  const int oh0 = (blockIdx.x / p.tiles_w) * kMmaTH, ow0 = (blockIdx.x % p.tiles_w) * kMmaTW;
  const int g0 = blockIdx.y * p.gb, ng = min(p.gb, p.groups - g0);
  const int b = blockIdx.z;
  const int h0 = oh0 * S - s.pad, w0 = ow0 * S - s.pad;
  const int8_t* xb = x + static_cast<size_t>(b) * s.h * s.w * s.c;

  // The input tile with its halo: the run's channels of each pixel (unit u,
  // 16 bytes, a thread), zeros outside the image and past the last group.
  const int units = p.gb * p.cg / 16, u = tid % 4;
  for (int pix = tid / 4; pix < Tile::kRows * Tile::kCols; pix += kMmaThreads / 4) {
    if (u >= units) break;
    const int r = pix / Tile::kCols, q = pix - r * Tile::kCols;
    const int hi = h0 + r, wi = w0 + q, c = g0 * p.cg + u * 16;
    const bool ok = hi >= 0 && hi < s.h && wi >= 0 && wi < s.w && c < s.c;
    const int qs = S == 1 ? q : (q & 1) * Tile::kHalf + (q >> 1);
    cp_async16(smem_u32(tile + (r * Tile::kColsAlloc + qs) * p.pix_bytes + u * 16),
               ok ? xb + (static_cast<size_t>(hi) * s.w + wi) * s.c + c : x, ok);
  }
  // The run's weights: output channels g0 * O/g onward, 9 * C/g bytes each.
  for (int i = tid; i < p.gb * p.og * kChunks; i += kMmaThreads) {
    const int n = i / kChunks, v = i - n * kChunks;
    const int o = g0 * p.og + n;
    const bool ok = o < s.o;
    cp_async16(smem_u32(wsm + n * p.w_row + v * 16), ok ? w + static_cast<size_t>(o) * kChunks * 16 + v * 16 : w,
               ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // Warp `warp` computes output row `warp` of the tile for every group of
  // the run and every pass of up to 16 output channels (two n8 tiles).
  // ldmatrix: lane l gives the row address of matrix l / 8, which is output
  // pixel l % 16 at chunk kk + l / 16; chunk t * kM + v is tap t = (r, q),
  // channels 16v onward, and at stride 2 input column 2c + q lies at
  // (q & 1) * kHalf + c + (q >> 1).
  auto chunk_offset = [&](int ch) {
    const int t = ch / kM, r = t / 3, q = t % 3;
    return (r * Tile::kColsAlloc + (S == 1 ? q : (q & 1) * Tile::kHalf + (q >> 1))) * p.pix_bytes + (ch % kM) * 16;
  };
  const uint32_t a_row = smem_u32(tile) + (warp * S * Tile::kColsAlloc + (lane & 15)) * p.pix_bytes;
  const int gid = lane / 4, tig = lane % 4;
  const int oh = oh0 + warp;
  for (int j = 0; j < ng; ++j) {
    for (int n0 = 0; n0 < p.og; n0 += 16) {
      const int ntiles = p.og - n0 >= 16 ? 2 : 1;
      const uint32_t a_base = a_row + j * p.cg;
      const unsigned char* b_base = wsm + (j * p.og + n0 + gid) * p.w_row + tig * 4;
      int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk + 1 < kChunks; kk += 2) {
        uint32_t a[4];
        ldmatrix_x4(a, a_base + chunk_offset(kk + (lane >> 4)));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < ntiles) {
            const unsigned char* bp = b_base + h * 8 * p.w_row + kk * 16;
            mma_k32(acc[h], a, *reinterpret_cast<const uint32_t*>(bp), *reinterpret_cast<const uint32_t*>(bp + 16));
          }
        }
      }
      if (kChunks % 2) {
        uint32_t a[2];
        ldmatrix_x2(a, a_base + chunk_offset(kChunks - 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < ntiles) {
            mma_k16(acc[h], a, *reinterpret_cast<const uint32_t*>(b_base + h * 8 * p.w_row + (kChunks - 1) * 16));
          }
        }
      }

      // Epilogue: accumulator e of n8 tile h is pixel gid (+8 for e >= 2),
      // channel 8h + 2 tig (+1 for odd e). Dequantize into the warp's
      // staging rows, then write each pixel's channels in 16-byte runs.
      const int o0 = (g0 + j) * p.og + n0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= ntiles) continue;
        const int col = h * 8 + tig * 2, o = o0 + col;
        const float sc0 = __ldg(scale + o), sc1 = __ldg(scale + o + 1);
        const float b0 = bias_term(bias, o, OutT()), b1 = bias_term(bias, o + 1, OutT());
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          *reinterpret_cast<Pair<OutT>*>(stage + (gid + 8 * e2) * kStageRow + col * sizeof(OutT)) =
              dequant_pair(exact_float<kM>(acc[h][2 * e2]), exact_float<kM>(acc[h][2 * e2 + 1]), sc0, sc1, b0, b1,
                           bias != nullptr, OutT());
        }
      }
      __syncwarp();
      // 16-byte units a pixel: 8 channels of bf16, 4 of f32; 1, 2 or 4
      const int shift = (ntiles - 1) + (sizeof(OutT) == 4 ? 1 : 0);
      for (int i = lane; i < (16 << shift); i += 32) {
        const int px = i >> shift, v = i & ((1 << shift) - 1);
        const int ow = ow0 + px;
        if (oh < s.ho && ow < s.wo) {
          OutT* dst = out + ((static_cast<size_t>(b) * s.ho + oh) * s.wo + ow) * s.o + o0 + v * (16 / sizeof(OutT));
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(stage + px * kStageRow + v * 16);
        }
      }
      __syncwarp();
    }
  }
}

template <int S, int kM, typename OutT>
int launch_mma_kernel(const int8_t* x, const int8_t* w, const float* scale, const float* bias, OutT* out,
                      const ConvShape& s, const MmaPlan& p, cudaStream_t stream) {
  const int smem = p.tile_bytes + p.w_bytes + (kMmaThreads / 32) * 16 * (16 * static_cast<int>(sizeof(OutT)) + 16);
  cudaError_t err = cudaFuncSetAttribute(int8_conv_grouped_mma_kernel<S, kM, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((s.ho + kMmaTH - 1) / kMmaTH) * p.tiles_w, (p.groups + p.gb - 1) / p.gb, s.batch);
  int8_conv_grouped_mma_kernel<S, kM, OutT><<<grid, kMmaThreads, smem, stream>>>(x, w, scale, bias, out, s, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_grouped_mma(const void* x, const void* w, const float* scale, const float* bias, void* out,
                       const ConvShape& s, int groups, void* stream) {
  MmaPlan p;
  p.groups = groups;
  p.cg = s.c / groups;
  p.og = s.o / groups;
  p.gb = groups < kMmaRunBytes / p.cg ? groups : kMmaRunBytes / p.cg;
  p.pix_bytes = p.gb * p.cg + ((p.gb * p.cg / 16) % 2 ? 0 : 16);
  p.w_row = 9 * p.cg + ((9 * p.cg / 16) % 2 ? 0 : 16);
  p.tile_bytes = (s.stride == 1 ? MmaTile<1>::kRows * MmaTile<1>::kColsAlloc
                                : MmaTile<2>::kRows * MmaTile<2>::kColsAlloc) * p.pix_bytes;
  p.w_bytes = p.gb * p.og * p.w_row;
  p.tiles_w = (s.wo + kMmaTW - 1) / kMmaTW;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  OutT* o = static_cast<OutT*>(out);
  if (p.cg == 16) {
    return s.stride == 1 ? launch_mma_kernel<1, 1>(xi, wi, scale, bias, o, s, p, st)
                         : launch_mma_kernel<2, 1>(xi, wi, scale, bias, o, s, p, st);
  }
  return s.stride == 1 ? launch_mma_kernel<1, 2>(xi, wi, scale, bias, o, s, p, st)
                       : launch_mma_kernel<2, 2>(xi, wi, scale, bias, o, s, p, st);
}

}  // namespace

extern "C" {

// x int8 (batch, h, w, c); w int8 (o, kh, kw, c); scale f32 (o); bias f32 (o)
// or null; out (batch, ho, wo, o) of the output kind `out_kind`:
//   0 f32, 1 bf16: the dequantized conv in that dtype;
//   2 s8 (bf16 epilogue), 3 s8 (f32 epilogue): the int8 codes of the next
//   conv, quantize(ReLU(the dequantized conv in that dtype)) at the scale
//   xs_next (one f32 on the device; null for kinds 0 and 1).
// c must be a multiple of 16, every tensor contiguous, x and w 16-byte
// aligned, and each tensor under 2^31 elements (the wrapper checks).
// Launches on `stream`, does not synchronise; returns cudaGetLastError(), or
// -1 on a shape or output kind the kernel does not take.
int dd3d_int8_conv(const void* x, const void* w, const float* scale, const float* bias, void* out, int out_kind,
                   const float* xs_next, int batch, int h, int w_, int c, int o, int kh, int kw, int stride, int pad,
                   void* stream) {
  ConvShape s;
  s.batch = batch; s.h = h; s.w = w_; s.c = c; s.o = o; s.kh = kh; s.kw = kw; s.stride = stride; s.pad = pad;
  s.ho = (h + 2 * pad - kh) / stride + 1;
  s.wo = (w_ + 2 * pad - kw) / stride + 1;
  s.k = kh * kw * c;
  s.m = batch * s.ho * s.wo;
  if (c % 16 != 0 || s.ho <= 0 || s.wo <= 0 || o <= 0) return -1;
  if (out_kind < 0 || out_kind > 3 || (out_kind >= 2) != (xs_next != nullptr)) return -1;
  if (s.m == 0) return 0;
  switch (out_kind) {
    case 0: return launch_out<float>(x, w, scale, bias, out, nullptr, s, stream);
    case 1: return launch_out<__nv_bfloat16>(x, w, scale, bias, out, nullptr, s, stream);
    case 2: return launch_out<int8_t, __nv_bfloat16>(x, w, scale, bias, out, xs_next, s, stream);
    default: return launch_out<int8_t, float>(x, w, scale, bias, out, xs_next, s, stream);
  }
}

// The grouped conv: x int8 (batch, h, w, c); w int8 (o, kh, kw, c / groups);
// scale, bias and out as dd3d_int8_conv. c and o must be multiples of
// groups; no channel padding is needed. Every tensor contiguous and under
// 2^31 elements (the wrapper checks). `route` names the kernel: 0 direct
// (any shape), 1 depthwise (c / groups == 1, o == c, c % 16 == 0), 2 mma
// (c / groups 16 or 32, o / groups a multiple of 8 up to 64), 3 narrow
// (c / groups == o / groups, 2, 4 or 8, c % 16 == 0); 1, 2 and 3 take 3x3
// kernels at stride 1 or 2 and 16-byte aligned x, w and out. Launches on
// `stream`, does not synchronise; returns cudaGetLastError(), or -1 on a
// shape or route the kernels do not take.
int dd3d_int8_conv_grouped(const void* x, const void* w, const float* scale, const float* bias, void* out,
                           int out_bf16, int batch, int h, int w_, int c, int o, int kh, int kw, int stride, int pad,
                           int groups, int route, void* stream) {
  ConvShape s;
  s.batch = batch; s.h = h; s.w = w_; s.c = c; s.o = o; s.kh = kh; s.kw = kw; s.stride = stride; s.pad = pad;
  s.ho = (h + 2 * pad - kh) / stride + 1;
  s.wo = (w_ + 2 * pad - kw) / stride + 1;
  s.k = kh * kw * (groups > 0 ? c / groups : 0);
  s.m = batch * s.ho * s.wo;
  if (groups <= 0 || c % groups != 0 || o % groups != 0 || s.ho <= 0 || s.wo <= 0 || o <= 0) return -1;
  const int cg = c / groups, og = o / groups;
  const bool tiled = kh == 3 && kw == 3 && (stride == 1 || stride == 2) && pad >= 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (route == 1 && !(tiled && cg == 1 && og == 1 && c % 16 == 0)) return -1;
  if (route == 2 && !(tiled && (cg == 16 || cg == 32) && og % 8 == 0 && og <= 64)) return -1;
  if (route == 3 && !(tiled && (cg == 2 || cg == 4 || cg == 8) && og == cg && c % 16 == 0)) return -1;
  if (route < 0 || route > 3) return -1;
  if (s.m == 0) return 0;
  if (route == 1) {
    return out_bf16 ? launch_grouped_depthwise<__nv_bfloat16>(x, w, scale, bias, out, s, stream)
                    : launch_grouped_depthwise<float>(x, w, scale, bias, out, s, stream);
  }
  if (route == 2) {
    return out_bf16 ? launch_grouped_mma<__nv_bfloat16>(x, w, scale, bias, out, s, groups, stream)
                    : launch_grouped_mma<float>(x, w, scale, bias, out, s, groups, stream);
  }
  if (route == 3) {
    return out_bf16 ? launch_grouped_narrow<__nv_bfloat16>(x, w, scale, bias, out, s, groups, stream)
                    : launch_grouped_narrow<float>(x, w, scale, bias, out, s, groups, stream);
  }
  return out_bf16 ? launch_grouped<__nv_bfloat16>(x, w, scale, bias, out, s, groups, stream)
                  : launch_grouped<float>(x, w, scale, bias, out, s, groups, stream);
}

}  // extern "C"
