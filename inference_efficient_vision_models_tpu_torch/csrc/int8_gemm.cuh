// Shared core of the int8 kernels: the scalar affine-int8 epilogue of the
// JAX package's Pallas kernels (affine_y, act_t, requant_u8; every int8
// kernel takes it) and the mma.sync m16n8k32 step (int8 x int8 -> int32)
// of the kernels that multiply from registers:
//
//   acc  = X_s . W_q                      (int32, exact)
//   acc -= zp_s * sum_k W_q[k, n]         (affine-input correction)
//   y    = acc * (s_x * s_w[n]) + b[n]    (fp32)
//   y    = act(y)                         (none | relu | erf-GELU | tanh-GELU)
//   out  = clip(rint(y * (1/s_y)) + zp_y, 0, 255) - 128   (int8), or y as fp32/bf16
//
// Rounding follows jnp.round (half to even): rintf, never roundf. The
// epilogue uses __fmul_rn/__fadd_rn so nvcc cannot contract it into an FMA;
// the plain PyTorch versions then agree with the kernels bit for bit on the
// integer paths. Build without --use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ievm {

constexpr int BM = 128;  // rows of a panel_gemm.cuh slice

enum OutKind { OUT_I8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Correctly rounded fp32 quotients without the slow-path branch of
// __fdiv_rn, which keeps the compiler from overlapping one element's
// division with the next one's. Both equal __fdiv_rn bit for bit:
// a quotient of two binary32 numbers lies at least 2^-49 (relative) away
// from every midpoint between adjacent binary32 numbers (x - s m, with m a
// 25-bit midpoint, is a nonzero multiple of 2^-48 |s m|, and no quotient is
// a midpoint), so any approximation within 2^-52 rounds to the same float.
//
// x / s, given rs = RN_f64(1 / s) (s > 0, normal): the double product errs
// by at most 2^-53 + 2^-53.
__device__ __forceinline__ float div_rn_by(float x, double rs) {
  return __double2float_rn(__dmul_rn((double)x, rs));
}

// 1 / d for d >= 1 (and +inf -> 0): an approximate double reciprocal and two
// Newton steps (2^-22 -> 2^-44 -> 2^-53 rounding).
__device__ __forceinline__ float rcp_rn_ge1(float d) {
  const double dd = d;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(dd));
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  r = __fma_rn(r, __fma_rn(-dd, r, 1.0), r);
  return d == INFINITY ? 0.f : __double2float_rn(r);
}

// RN(1 / d) for d >= 1 without a double: an approximate reciprocal and one
// Newton step leave t within an ulp of 1 / d, so the residual e = 1 - d t is
// exact, and t is correctly rounded iff |e| < d u / 2, u the ulp below t
// (exact; stricter than needed just above a power of two). Sets `redo`
// otherwise (about one value in 10^6, inf, NaN): rcp_rn_ge1 then gives it.
// Loops take this form for every element and redo the flagged ones after the
// loop, so that no per-element branch serialises them.
__device__ __forceinline__ float rcp_ge1_fast(float d, bool& redo) {
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(d));
  t = __fmaf_rn(t, __fmaf_rn(-d, t, 1.0f), t);
  const float e = __fmaf_rn(-d, t, 1.0f);
  const float u = __fsub_rn(t, __int_as_float(__float_as_int(t) - 1));
  redo = !(fabsf(e) < __fmul_rn(__fmul_rn(d, u), 0.5f));
  return t;
}

// The erf-GELU of the plain versions (ops/int8_matmul.py:gelu_as): GELU(y) =
// y * 0.5 * (1 + erf(y / sqrt(2))) in that order, erf by Abramowitz & Stegun
// 7.1.26 (the Pallas kernel's _erf) rounded step by step (no FMA), given
// t = RN(1 / gelu_den(y)) (1 + 0.3275911 |x| >= 1): from rcp_ge1_fast where
// it is settled, else from rcp_rn_ge1 (gelu_erf_nb).
__device__ __forceinline__ float gelu_den(float y) {
  return __fadd_rn(1.0f, __fmul_rn(0.3275911f, fabsf(__fmul_rn(y, 0.70710678118654752f))));
}

__device__ __forceinline__ float gelu_erf_t(float y, float t) {
  const float x = __fmul_rn(y, 0.70710678118654752f);
  const float a = fabsf(x);
  float p = __fadd_rn(-1.453152027f, __fmul_rn(t, 1.061405429f));
  p = __fadd_rn(1.421413741f, __fmul_rn(t, p));
  p = __fadd_rn(-0.284496736f, __fmul_rn(t, p));
  p = __fadd_rn(0.254829592f, __fmul_rn(t, p));
  p = __fmul_rn(t, p);
  // sign(x) * r as r with x's sign: the same value for x != 0; x = y / sqrt(2)
  // rounds to zero only for y = +-0 (y / sqrt(2) of the least denormal rounds
  // up to it), and then the result is (y * 0.5) * (1 +- r) = y * 0.5 either
  // way, zero of y's sign, since 1 +- r > 0
  const float r = __fadd_rn(1.0f, -__fmul_rn(p, expf(__fmul_rn(-a, a))));
  const float erf = copysignf(r, x);
  return __fmul_rn(__fmul_rn(y, 0.5f), __fadd_rn(1.0f, erf));
}

__device__ __forceinline__ float gelu_erf_nb(float y) { return gelu_erf_t(y, rcp_rn_ge1(gelu_den(y))); }

// gelu_erf_nb of four values: the reciprocals by rcp_ge1_fast, the rare
// unsettled ones redone after them.
__device__ __forceinline__ float4 gelu4(float4 v) {
  const float y[4] = {v.x, v.y, v.z, v.w};
  float t[4];
  bool rd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = rcp_ge1_fast(gelu_den(y[i]), rd[i]);
  if (rd[0] || rd[1] || rd[2] || rd[3]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (rd[i]) t[i] = rcp_rn_ge1(gelu_den(y[i]));
  }
  return make_float4(gelu_erf_t(y[0], t[0]), gelu_erf_t(y[1], t[1]), gelu_erf_t(y[2], t[2]),
                     gelu_erf_t(y[3], t[3]));
}

// The scalar epilogue of one output element, the one definition every kernel
// shares: a = acc - zp_s * sum_k W[k, n] (int32), scale = s_x * s_w[n] (fp32,
// rounded once), y = act(a * scale + b[n]).
__device__ __forceinline__ float affine_y(int a, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(a), scale), bias);
}

template <int ACT>
__device__ __forceinline__ float act_t(float y) {
  if constexpr (ACT == ACT_RELU) {
    y = fmaxf(y, 0.f);
  } else if constexpr (ACT == ACT_GELU) {
    y = gelu_erf_nb(y);
  } else if constexpr (ACT == ACT_GELU_TANH) {
    // y * (0.5 * (1 + tanh(0.79788456 * (y + 0.044715 * (y * y * y))))), step by step
    const float u = __fadd_rn(y, __fmul_rn(0.044715f, __fmul_rn(__fmul_rn(y, y), y)));
    y = __fmul_rn(y, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(__fmul_rn(0.7978845608028654f, u)))));
  }
  return y;
}

constexpr float RINT_MAGIC = 12582912.f;  // 1.5 * 2^23: q + M - M = rint(q) for |q| < 2^22

// v an integer-valued float (or +-inf): clip(v, 0, 255) as a byte, without a
// conversion instruction (2^23 + v holds v in its low bits). Conversions and
// rint run at an eighth of the fp32 rate on Hopper; these additions do not.
__device__ __forceinline__ uint32_t clip_u8(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.f), 255.f), 8388608.f)) & 0xffu;
}

// clip(v, 0, 255) + 2^23 as bits (v integer-valued or +-inf): the low byte
// is the byte clip(v, 0, 255) (clip_u8 without the mask).
__device__ __forceinline__ uint32_t clip_bits(float v) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(v, 0.f), 255.f), 8388608.f));
}

// The low bytes of a, b, c, d as one word (a in byte 0).
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// clip(rint(y * inv) + zp, 0, 255) as a byte, rint and the conversion done by
// adding RINT_MAGIC: (q + M) - (M - zp) = rint(q) + zp exactly for |q| < 2^22,
// and beyond that it stays past the clip on the same side. zpm = M - zp.
__device__ __forceinline__ uint32_t requant_u8(float y, float inv, float zpm) {
  return clip_u8(__fsub_rn(__fadd_rn(__fmul_rn(y, inv), RINT_MAGIC), zpm));
}

}  // namespace ievm
