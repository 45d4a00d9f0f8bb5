// Per-tensor symmetric int8 quantize for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel scripts/bench_quantize_kernel.py::make_pallas
// (inner `kernel`, launched by `quant_pallas` through pl.pallas_call), which
// is the quantize step of dd3d_tpu/models/layers.py::_int8_conv (:255-263):
//
//   q = clip(round_half_even(f32(x) / xs), -127, 127) as int8
//
// over a bf16 or f32 NHWC activation, with xs the per-tensor f32 scale read
// from device memory (a dynamic scale stays on the card; no host sync).
//
// Division, not multiplication: the package's serving path divides by xs
// (layers.py:263); the Pallas benchmark kernel multiplies by a precomputed
// 1/xs, which rounds to the other code where x/xs lies next to a .5 tie.
// This kernel gives the division's codes, bit for bit, but divides only
// where the product by 1/xs lies within 2^-15 of a .5 tie (quantize.cuh,
// `quantize_one`, shared with the int8 conv's s8 epilogue, states the
// margin and why it suffices).
//
// Where the head towers chain two int8 convs, the quantize runs inside the
// first conv's epilogue instead (int8_conv.cu, s8 output); this kernel
// serves the other links: the backbone, the FPN and each tower's first conv.
//
// What bounds it on this card: bytes. It reads 2 (bf16) or 4 (f32) bytes and
// writes 1 byte an element, so at 3.35 TB/s an (8, 48, 160, 256) bf16 tensor
// (15.7M elements, 47 MB moved) takes ~14 us at best. Design:
// - each thread takes 16 elements a turn: two (bf16) or four (f32) 16-byte
//   loads, all issued before any arithmetic, then one 16-byte store of the
//   16 codes, so that 32 or 64 bytes a thread are in flight;
// - one wave: as many blocks as the card holds at once (the occupancy the
//   compiler's registers allow, times the SMs), or fewer where fewer cover
//   the tensor; a grid-stride loop takes the rest, with no second wave of
//   blocks and their start-up;
// - a tensor too small to give every thread of that wave 16 elements (the
//   P5-P7 and the narrow backbone inputs, 4M elements and below at batch
//   8) takes 8 a thread instead (one 16-byte load of bf16, an 8-byte
//   store): there the time is a thread's serial chain, not bytes, and a
//   first version with 16 a thread everywhere ran those shapes up to 1.5x
//   slower than the 8-wide kernel before it (PERF.md, bench_quantize);
// - a tail shorter than 16 elements, or a base pointer of x or q that is
//   not 16-byte aligned, goes element by element, through the same
//   `quantize_one`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;

// kVec elements a thread a turn (16 or 8): kLoads 16-byte loads, one store
// of kVec codes.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ xs_ptr, signed char* __restrict__ q, long long n,
                int vectorized) {
  constexpr int kLoads = kVec * static_cast<int>(sizeof(T)) / 16;  // 1, 2 or 4
  constexpr int kWords = kVec / 4;
  const QuantScale s = make_quant_scale(*xs_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorized) {
    const long long packets = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long p = tid; p < packets; p += stride) {
      uint4 raw[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) raw[i] = __ldg(xv + p * kLoads + i);
      const T* v = reinterpret_cast<const T*>(raw);
      uint32_t words[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          word |= static_cast<uint32_t>(static_cast<unsigned char>(quantize_one(to_f32(v[4 * w + i]), s))) << (8 * i);
        }
        words[w] = word;
      }
      if constexpr (kVec == 16) {
        reinterpret_cast<uint4*>(q)[p] = make_uint4(words[0], words[1], words[2], words[3]);
      } else {
        reinterpret_cast<uint2*>(q)[p] = make_uint2(words[0], words[1]);
      }
    }
    done = packets * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) q[i] = quantize_one(to_f32(x[i]), s);
}

// Blocks of one wave of quantize_kernel<T, kVec> on the current device,
// into *blocks; looked up once a device (the occupancy query costs host
// time on every one of a forward's launches otherwise).
template <typename T, int kVec>
cudaError_t wave_blocks(int* blocks) {
  static int cached[64] = {0};  // by device; a race writes the same value
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && cached[device] > 0) {
    *blocks = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_kernel<T, kVec>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (device < 64) cached[device] = *blocks;
  return cudaSuccess;
}

template <typename T, int kVec>
int launch_vec(const void* x, const float* xs, void* q, long long n, int wave, cudaStream_t stream) {
  const int vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(q) % kVec == 0);
  const long long work = vectorized ? (n + kVec - 1) / kVec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  quantize_kernel<T, kVec><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), xs, static_cast<signed char*>(q), n, vectorized);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const float* xs, void* q, long long n, void* stream) {
  if (n <= 0) return 0;
  int wave = 0;
  const cudaError_t err = wave_blocks<T, 16>(&wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n >= 16LL * kThreads * wave) return launch_vec<T, 16>(x, xs, q, n, wave, st);
  int wave8 = 0;
  const cudaError_t err8 = wave_blocks<T, 8>(&wave8);
  if (err8 != cudaSuccess) return static_cast<int>(err8);
  return launch_vec<T, 8>(x, xs, q, n, wave8, st);
}

}  // namespace

extern "C" {

// x: n contiguous bf16 (is_bf16 = 1) or f32 (is_bf16 = 0) values; xs: one
// f32 on the device; q: n int8. Launches on `stream`, does not synchronise;
// returns cudaGetLastError().
int dd3d_quantize_int8(const void* x, int is_bf16, const float* xs, void* q, long long n, void* stream) {
  return is_bf16 ? launch<__nv_bfloat16>(x, xs, q, n, stream) : launch<float>(x, xs, q, n, stream);
}

}  // extern "C"
