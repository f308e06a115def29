// dense_gelu on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/fused_dense.py:dense_gelu.
//
// out (M, N) = gelu_erf(X (M, K) . W (K, N) + b), X, W, b and out all bf16 or
// all fp32: the product accumulates in fp32, the bias is added in fp32, the
// GELU is the A&S 7.1.26 erf polynomial in fp32 (int8_gemm.cuh gelu_erf, the
// Pallas kernel's _erf), and the result is cast once to the input's type. The
// pre-activation never reaches device memory.
//
// Bound on an H100 at the ViT-Tiny mlp1 shape (M = 50,432 tokens at batch
// 256, K = 192, N = 768): bf16 moves 97 MB (x 19 MB, out 77 MB) for 14.9
// GFLOP, so it is bound by bytes (0.029 ms at 3.35 TB/s, against 0.015 ms of
// tensor-core work); the output write dominates. fp32 runs on the CUDA cores
// in exact fp32 FMAs (TF32 would change the function), 7.4 G FMA at 33.5 T/s
// = 0.22 ms, so it is bound by operations.
//
// Design (simple and right first):
// * bf16: a 128 x 128 output tile per block of 8 warps (4 along M, 2 along N,
//   32 x 64 each) on mma.sync m16n8k16 (bf16 -> fp32). K steps in 32-wide
//   slices through two shared-memory stages filled by cp.async (16 bytes a
//   thread, the ragged edge zero-filled), so the next slice loads while the
//   current one multiplies. A fragments are read as 32-bit words from 80-byte
//   rows, B fragments by ldmatrix.trans from 272-byte rows (both free of bank
//   conflicts). W is read in its (K, N) layout, as the caller holds it.
// * fp32: a 128 x 128 tile per block, 8 x 8 outputs a thread, K in slices of
//   8 staged through shared memory with the next slice prefetched into
//   registers; each output is one fmaf chain over k.
// * Shapes that break 16-byte alignment (K or N not a multiple of 8 for bf16,
//   of 4 for fp32) take the same kernels with element-wise loads and stores.
// wgmma/TMA, a persistent grid and writing the output through shared memory
// are later work.
#include "int8_gemm.cuh"

namespace ievm {
namespace dense {

constexpr int THREADS = 256;

// ----------------------------------------------------------------- bf16 ----
constexpr int HBM = 128, HBN = 128, HBK = 32;
constexpr int SA = HBK + 8;  // 80-byte A rows
constexpr int SB = HBN + 8;  // 272-byte B rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive bf16 of `row` from column c0 (zero where c0 + i >= lim or the
// row is out of range) into 16 bytes of shared memory.
__device__ __forceinline__ void load8_bf16(__nv_bfloat16* dst, const __nv_bfloat16* row, bool row_ok,
                                           int c0, int lim) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = (row_ok && c0 + 2 * i < lim) ? p[c0 + 2 * i] : 0u;
    const uint32_t hi = (row_ok && c0 + 2 * i + 1 < lim) ? p[c0 + 2 * i + 1] : 0u;
    v[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// VEC: K % 8 == 0, N % 8 == 0 and 16-byte aligned pointers, so every
// 16-byte chunk of a tile row lies wholly inside or wholly outside the matrix.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    dense_gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int M,
                           int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[2][HBM * SA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][HBK * SB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int bm = (int)blockIdx.x * HBM, bn = (int)blockIdx.y * HBN;
  const int nk = (K + HBK - 1) / HBK;

  auto load_slice = [&](int kt, int st) {
    const int k0 = kt * HBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      // A: 128 rows x 4 chunks of 8
      const int r = c >> 2, ka = k0 + (c & 3) * 8, m = bm + r;
      __nv_bfloat16* da = &As[st][r * SA + (c & 3) * 8];
      // B: 32 rows x 16 chunks of 8
      const int kr = c >> 4, nb = bn + (c & 15) * 8, k = k0 + kr;
      __nv_bfloat16* db = &Bs[st][kr * SB + (c & 15) * 8];
      if (VEC) {
        const bool oka = m < M && ka < K, okb = k < K && nb < N;
        cp_async16(da, oka ? x + (size_t)m * K + ka : x, oka ? 16 : 0);
        cp_async16(db, okb ? w + (size_t)k * N + nb : w, okb ? 16 : 0);
      } else {
        load8_bf16(da, x + (size_t)(m < M ? m : 0) * K, m < M, ka, K);
        load8_bf16(db, w + (size_t)(k < K ? k : 0) * N, k < K, nb, N);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_slice(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_slice(kt + 1, (kt + 1) & 1);  // that stage was last read before the previous barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < HBK; ks += 16) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = wm * 32 + mt * 16 + gid, c0 = ks + tig * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&as[r0 * SA + c0]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&as[(r0 + 8) * SA + c0]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&as[r0 * SA + c0 + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&as[(r0 + 8) * SA + c0 + 8]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // lanes 0-7 / 8-15 / 16-23 / 24-31 address the rows of the four 8x8
        // matrices: k 0-7 and 8-15 of n-tile 2np, then of n-tile 2np + 1
        const int kr = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int nc = wn * 64 + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0], bf[2 * np + 1][1],
                          &bs[kr * SB + nc]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = bm + wm * 32 + mt * 16 + gid + h * 8;
        const int n = bn + wn * 64 + nt * 8 + tig * 2;
        if (m >= M || n >= N) continue;
        __nv_bfloat16* o = out + (size_t)m * N + n;
        const __nv_bfloat16 y0 =
            __float2bfloat16_rn(gelu_erf(__fadd_rn(acc[mt][nt][2 * h], __bfloat162float(b[n]))));
        if (n + 1 < N) {
          const __nv_bfloat16 y1 =
              __float2bfloat16_rn(gelu_erf(__fadd_rn(acc[mt][nt][2 * h + 1], __bfloat162float(b[n + 1]))));
          if (VEC) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);
          } else {
            o[0] = y0;
            o[1] = y1;
          }
        } else {
          o[0] = y0;
        }
      }
}

// ----------------------------------------------------------------- fp32 ----
constexpr int FBM = 128, FBN = 128, FBK = 8;

// VEC: K % 4 == 0, N % 4 == 0 and 16-byte aligned pointers.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    dense_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[FBK][FBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bm = (int)blockIdx.x * FBM, bn = (int)blockIdx.y * FBN;
  const int nk = (K + FBK - 1) / FBK;
  // loader: A row tid / 2, k (tid % 2) * 4 .. +3; B row k tid / 32, n (tid % 32) * 4 .. +3
  const int am = bm + (tid >> 1), ak = (tid & 1) * 4;
  const int bk = tid >> 5, bnn = bn + (tid & 31) * 4;
  float ra[4], rb[4];

  auto gload = [&](int kt) {
    const int k0 = kt * FBK;
    const int ka = k0 + ak, kb = k0 + bk;
    if (VEC && am < M && ka < K) {
      const float4 v = *reinterpret_cast<const float4*>(x + (size_t)am * K + ka);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = (am < M && ka + i < K) ? x[(size_t)am * K + ka + i] : 0.f;
    }
    if (VEC && kb < K && bnn < N) {
      const float4 v = *reinterpret_cast<const float4*>(w + (size_t)kb * N + bnn);
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) rb[i] = (kb < K && bnn + i < N) ? w[(size_t)kb * N + bnn + i] : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gload(0);
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[ak + i][tid >> 1] = ra[i];
    *reinterpret_cast<float4*>(&Bs[bk][(tid & 31) * 4]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (kt + 1 < nk) gload(kt + 1);
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = bn + half * 64 + tx * 4;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = n0 + j < N ? gelu_erf(__fadd_rn(acc[i][half * 4 + j], b[n0 + j])) : 0.f;
      float* o = out + (size_t)m * N + n0;
      if (VEC && n0 < N) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < N) o[j] = y[j];
      }
    }
  }
}

}  // namespace dense
}  // namespace ievm

// kind: 1 fp32, 2 bf16 (x, w, b and out all of that type). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ievm_dense_gelu(const void* x, const void* w, const void* b, void* out, int kind, int M,
                               int K, int N, void* stream) {
  using namespace ievm::dense;
  if (M <= 0 || N <= 0 || K <= 0 || (kind != 1 && kind != 2)) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const auto* bb = static_cast<const __nv_bfloat16*>(b);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    dim3 grid((M + HBM - 1) / HBM, (N + HBN - 1) / HBN);
    if (aligned && K % 8 == 0 && N % 8 == 0)
      dense_gelu_bf16_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, K, N);
    else
      dense_gelu_bf16_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, K, N);
  } else {
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    const auto* bf = static_cast<const float*>(b);
    auto* of = static_cast<float*>(out);
    dim3 grid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
    if (aligned && K % 4 == 0 && N % 4 == 0)
      dense_gelu_f32_kernel<true><<<grid, THREADS, 0, s>>>(xf, wf, bf, of, M, K, N);
    else
      dense_gelu_f32_kernel<false><<<grid, THREADS, 0, s>>>(xf, wf, bf, of, M, K, N);
  }
  return (int)cudaGetLastError();
}
