// Shared core of the two int8 kernels: a shared-memory tiled int8 GEMM on
// mma.sync m16n8k32 (int8 x int8 -> int32) with the affine-int8 epilogue of
// the JAX package's Pallas kernels:
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
//
// Tiling: a block computes a BM x BN output tile with 8 warps (4 along M,
// 2 along N, 32 x 32 each), stepping K in BK-byte slices through shared
// memory; the next slice is loaded into registers while the current one is
// multiplied. The A operand comes through a loader (plain rows, rows quantized
// from float, or implicit 3x3 im2col), B from weights packed once at load time
// as (Np, Kp) int8, K contiguous per output column, zero-padded to the tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ievm {

constexpr int BM = 128;
constexpr int BN = 64;   // must match ops/_lib.py TILE_N
constexpr int BK = 64;   // must match ops/_lib.py TILE_K
constexpr int SROW = BK + 16;  // 80-byte smem rows: the 32 lanes of a fragment load hit 32 banks
constexpr int THREADS = 256;
constexpr int A_WORDS = BM * BK / 4 / THREADS;  // 8 four-byte A words per thread per slice

enum OutKind { OUT_I8 = 0, OUT_F32 = 1, OUT_BF16 = 2 };
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_GELU_TANH = 3 };

struct Epilogue {
  const float* w_scale;
  const float* bias;
  const int* w_sum;
  void* out;
  int out_kind;
  int act;
  int zp_s;
  int out_zp;
  float in_scale;
  float inv_out;
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Abramowitz & Stegun 7.1.26, the polynomial of the Pallas kernel's _erf.
__device__ __forceinline__ float erf_as(float x) {
  float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  float a = fabsf(x);
  float t = 1.0f / (1.0f + 0.3275911f * a);
  float poly = t * (0.254829592f +
                    t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-a * a));
}

__device__ __forceinline__ void store_out(const Epilogue& e, int m, int n, int N, int acc) {
  int a = acc - e.zp_s * e.w_sum[n];
  float y = __fadd_rn(__fmul_rn(__int2float_rn(a), __fmul_rn(e.in_scale, e.w_scale[n])), e.bias[n]);
  if (e.act == ACT_RELU) {
    y = fmaxf(y, 0.f);
  } else if (e.act == ACT_GELU) {
    y = y * 0.5f * (1.0f + erf_as(y * 0.70710678118654752f));
  } else if (e.act == ACT_GELU_TANH) {
    y = y * (0.5f * (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * (y * y * y)))));
  }
  size_t idx = (size_t)m * N + n;
  if (e.out_kind == OUT_I8) {
    float q = __fadd_rn(rintf(__fmul_rn(y, e.inv_out)), (float)e.out_zp);
    q = fminf(fmaxf(q, 0.f), 255.f);
    static_cast<int8_t*>(e.out)[idx] = (int8_t)((int)q - 128);
  } else if (e.out_kind == OUT_F32) {
    static_cast<float*>(e.out)[idx] = y;
  } else {
    static_cast<__nv_bfloat16*>(e.out)[idx] = __float2bfloat16_rn(y);
  }
}

// Thread t loads A words (row (t >> 4) + 16 j, bytes 4 (t & 15) .. +3) of each
// BM x BK slice; loaders fill `r[j]` for slice `kt`, zero outside the matrix.
template <class ALoader>
__device__ __forceinline__ void gemm_block(ALoader& al, const int8_t* __restrict__ wt, int Kp, int M,
                                           int N, const Epilogue& e) {
  __shared__ __align__(16) int8_t As[BM * SROW];
  __shared__ __align__(16) int8_t Bs[BN * SROW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int bm = blockIdx.x * BM, bn = blockIdx.y * BN;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int8_t* wrow = wt + (size_t)(bn + (tid >> 2)) * Kp + (tid & 3) * 16;
  uint32_t areg[A_WORDS];
  uint4 breg;
  const int nk = Kp / BK;
  al.load(0, areg);
  breg = *reinterpret_cast<const uint4*>(wrow);

  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j)
      *reinterpret_cast<uint32_t*>(&As[((tid >> 4) + 16 * j) * SROW + (tid & 15) * 4]) = areg[j];
    *reinterpret_cast<uint4*>(&Bs[(tid >> 2) * SROW + (tid & 3) * 16]) = breg;
    __syncthreads();
    if (kt + 1 < nk) {
      al.load(kt + 1, areg);
      breg = *reinterpret_cast<const uint4*>(wrow + (size_t)(kt + 1) * BK);
    }
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = wm * 32 + mt * 16 + gid;
        const int c0 = ks + tig * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r0 * SROW + c0]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[(r0 + 8) * SROW + c0]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r0 * SROW + c0 + 16]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[(r0 + 8) * SROW + c0 + 16]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn * 32 + nt * 8 + gid;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[c * SROW + ks + tig * 4]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[c * SROW + ks + 16 + tig * 4]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = bm + wm * 32 + mt * 16 + gid + (r >= 2 ? 8 : 0);
        const int n = bn + wn * 32 + nt * 8 + tig * 2 + (r & 1);
        if (m < M && n < N) store_out(e, m, n, N, acc[mt][nt][r]);
      }
}

}  // namespace ievm
