// The per-tensor symmetric int8 quantize of one value, shared by the
// standalone kernel (quantize.cu) and the int8 conv's s8 epilogue
// (int8_conv.cu), so that the two forms cannot drift:
//
//   q = clip(rint(fl(v / xs)), -127, 127)
//
// with fl the IEEE division rounded to nearest and rint half to even, the
// quantize step of dd3d_tpu/models/layers.py::_int8_conv (:255-263). No
// division per element: the codes are the division's, bit for bit, from a
// product and, next to a .5 tie, one FMA.
//
// For 2^-100 <= xs <= 2^100 (every scale of the path; `fast`), with
// r = fl(1 / xs) formed once, t = fl(v * r), n = rint(t), k = floor(t),
// b = k + 0.5:
// 1. Error of t. t = (v / xs)(1 + e1)(1 + e2) and fl(v / xs) =
//    (v / xs)(1 + e3), each |e| <= u = 2^-24, so where |t| < 128,
//    |t - fl(v / xs)| < 128 (3u + u^2) / (1 - u)^2 < 2.3e-5 (t below 2^-126
//    in magnitude: both round to 0).
// 2. |t| >= 128: |fl(v / xs)| >= 128 (1 - 3u) > 127.5, so the division's
//    code clips to +-127 with t's sign, and so does every code below (each
//    lies at or past 128 in magnitude, or is b's step where |b| = 127.5).
// 3. rint only looks at which interval (j - 0.5, j + 0.5) a value lies in.
//    b is the half-integer nearest t, at d = |t - b| = 0.5 - |t - n|, and
//    |t - n| is exact (t - 0 below 0.5 in magnitude, else a multiple of
//    ulp(t) at most 0.5). Where d > kQuantMargin = 2^-15 > 2.3e-5, that is
//    |t - n| < 0.5 - 2^-15, fl(v / xs) lies in t's interval: n is the code.
// 4. Within the margin (and |b| < 128), |v / xs - b| < 2^-14, and the code
//    follows from the exact quotient's place against b:
//    - s = fma(-b, xs, v) is exact: with e = xs's exponent, b * xs is a
//      multiple of 2^(e - 24) (b an odd multiple of 0.5 below 128) and v
//      of 2^(e - 25) (|v| > |xs| / 4 here), while |s| = |xs| |v / xs - b|
//      < 2^(e - 13): s needs at most 12 bits, none below 2^-149.
//    - b is even (its last bit lies far above its ulp), so fl(v / xs) == b
//      exactly where |v / xs - b| <= ulp(b) / 2 = h (the neighbour on the
//      other side of 0.5 in magnitude is no concern: on that side both
//      codes are 0), that is where |s| <= h * xs, h * xs exact (a power of
//      two times xs, no underflow). Then the code is rint(b).
//    - Else fl(v / xs) lies on s's side of b: k + 1 where s > 0, k where
//      s < 0 (rounding is monotonic, and |v / xs - b| < 2^-14 keeps it
//      inside that interval).
// A NaN v gives code 0 (the conversion of a NaN to an integer). Outside
// `fast` (xs = 0, negative, NaN or out of range), every value takes the
// division. It holds for every f32 v, so for bf16 inputs too;
// tests/test_torch_requant.py checks a numpy model of these steps against
// the division on all 65,536 bf16 patterns at the path's scales, and
// tests/test_torch_cuda.py the kernels themselves against the plain
// version on the card.
//
// Built with -fmad=false (kernels/__init__.py): no product fuses into a
// later add but the explicit FMA. The common path is a multiply, a round,
// a subtract and a compare, the conversion to an integer and the clip.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr float kQuantMargin = 3.0517578125e-05f;  // 2^-15

struct QuantScale {
  float xs;   // the scale
  float r;    // fl(1 / xs)
  bool fast;  // 2^-100 <= xs <= 2^100: the steps above hold
};

__device__ __forceinline__ QuantScale make_quant_scale(float xs) {
  QuantScale s;
  s.xs = xs;
  s.r = __fdiv_rn(1.0f, xs);
  s.fast = xs >= 7.88860905e-31f && xs <= 1.26765060e+30f;  // a NaN fails both
  return s;
}

// ulp(b) / 2 for a normal b: 2^(exponent(b) - 24).
__device__ __forceinline__ float half_ulp(float b) {
  return __int_as_float((__float_as_int(b) & 0x7f800000) - (24 << 23));
}

__device__ __forceinline__ signed char quantize_one(float v, const QuantScale& s) {
  const float t = __fmul_rn(v, s.r);
  float n = rintf(t);
  if (!s.fast) {  // the same for every value of a launch
    n = rintf(__fdiv_rn(v, s.xs));
  } else if (fabsf(__fsub_rn(t, n)) >= 0.5f - kQuantMargin) {  // step 4, rare
    const float k = floorf(t);
    const float b = __fadd_rn(k, 0.5f);
    const float r = __fmaf_rn(-b, s.xs, v);  // v - b * xs, exact
    n = fabsf(r) <= __fmul_rn(half_ulp(b), s.xs) ? rintf(b) : (r > 0.0f ? __fadd_rn(k, 1.0f) : k);
  }
  const int q = __float2int_rz(n);  // n is integral (or saturates, or a NaN gives 0)
  return static_cast<signed char>(max(-127, min(q, 127)));
}
