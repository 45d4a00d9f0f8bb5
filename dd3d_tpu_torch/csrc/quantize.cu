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
// This kernel follows the package: __fdiv_rn is IEEE division, the library
// is built without --use_fast_math, and rintf rounds half to even.
//
// What bounds it on this card: bytes. It reads 2 (bf16) or 4 (f32) bytes and
// writes 1 byte an element, a handful of ALU operations in between, so at
// 3.35 TB/s an (8, 48, 160, 256) bf16 tensor (15.7M elements, 47 MB moved)
// takes ~14 us at best. The design moves the bytes in wide accesses: each
// thread loads 16 bytes (8 bf16 or 4 f32) and stores 8 or 4 int8 bytes at
// once, in a grid-stride loop over 16-byte packets; the ragged tail (and a
// base pointer that is not 16-byte aligned) goes element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ signed char quantize_one(float v, float xs) {
  const float q = rintf(__fdiv_rn(v, xs));  // round half to even
  return static_cast<signed char>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One packet: 16 bytes of input -> kVec int8 codes.
template <typename T>
struct Packet {
  static constexpr int kVec = 16 / sizeof(T);
};

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x, const float* __restrict__ xs_ptr,
                                signed char* __restrict__ q, long long n, int vectorized) {
  constexpr int kVec = Packet<T>::kVec;
  const float xs = *xs_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorized) {
    const long long packets = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long p = tid; p < packets; p += stride) {
      const uint4 raw = xv[p];
      const T* v = reinterpret_cast<const T*>(&raw);
      uint32_t words[kVec / 4];
#pragma unroll
      for (int w = 0; w < kVec / 4; ++w) {
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t code = static_cast<unsigned char>(quantize_one(to_float(v[4 * w + i]), xs));
          word |= code << (8 * i);
        }
        words[w] = word;
      }
      if constexpr (kVec == 8) {
        *reinterpret_cast<uint2*>(q + p * kVec) = make_uint2(words[0], words[1]);
      } else {
        *reinterpret_cast<uint32_t*>(q + p * kVec) = words[0];
      }
    }
    done = packets * kVec;
  }
  for (long long i = done + tid; i < n; i += stride) q[i] = quantize_one(to_float(x[i]), xs);
}

template <typename T>
int launch(const void* x, const float* xs, void* q, long long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int kVec = Packet<T>::kVec;
  // 16-byte input packets and 8/4-byte output packets need aligned bases.
  const int vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(q) % kVec == 0);
  const long long work = vectorized ? (n + kVec - 1) / kVec : n;
  // Enough blocks to fill 132 SMs several times over; the loop covers the rest.
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  quantize_kernel<T><<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), xs, static_cast<signed char*>(q), n, vectorized);
  return static_cast<int>(cudaGetLastError());
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
