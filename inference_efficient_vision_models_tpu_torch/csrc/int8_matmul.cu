// int8_matmul_requant on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/int8_matmul.py:int8_matmul_requant.
//
// out (M, N) = requant/act(X (M, K) . W (K, N)) with the affine-int8 epilogue
// of int8_gemm.cuh. X is shifted-quint8 int8, or fp32/bf16 that the kernel
// quantizes while it loads each tile (round(x / s_x) + zp, clip, -128), so the
// int8 copy of a float activation never exists in device memory.
//
// Bound on an H100: at the serving shapes (im2col patches of the stem and the
// stride-2 convs, K = 56..2016, N = 56..456) the work is 2*M*K*N int8 ops
// against about M*K + M*N*out_bytes bytes. Only the last stage's stride-2 conv
// (K = 2016, N = 456) lies above the card's ~590 int8 ops/byte balance point;
// the stem, the other stride-2 convs, the 1x1 downsamples and the fc are
// bound by bytes, so the patch read dominates. The design reads each A byte
// once per N tile (one N tile for N <= 64), feeds mma.sync from shared memory,
// and loads the next K slice into registers during the current slice's
// multiply; wgmma/TMA, deeper pipelines and an implicit-im2col stem that
// skips the patch matrix are later work.
#include "int8_gemm.cuh"

namespace ievm {

struct MatmulArgs {
  const void* x;
  const int8_t* wt;
  int Kp;
  int M, K, N;
  int vec;  // K % 4 == 0 and X 4-byte aligned: one 32-bit load per A word
  int zp_s;
  float in_scale;
};

struct LoadI8 {
  const int8_t* x;
  int M, K, vec, bm;
  __device__ __forceinline__ void load(int kt, uint32_t (&r)[A_WORDS]) const {
    const int k0 = kt * BK + (threadIdx.x & 15) * 4;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      const int m = bm + (threadIdx.x >> 4) + 16 * j;
      uint32_t v = 0;
      if (m < M) {
        const int8_t* p = x + (size_t)m * K + k0;
        if (vec) {
          if (k0 < K) v = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < K) v |= (uint32_t)(uint8_t)p[i] << (8 * i);
        }
      }
      r[j] = v;
    }
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct LoadFloat {
  const T* x;
  int M, K, bm, zp;  // zp: the unshifted zero point, zp_s + 128
  float in_scale;
  __device__ __forceinline__ void load(int kt, uint32_t (&r)[A_WORDS]) const {
    const int k0 = kt * BK + (threadIdx.x & 15) * 4;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      const int m = bm + (threadIdx.x >> 4) + 16 * j;
      uint32_t v = 0;
      if (m < M) {
        const T* p = x + (size_t)m * K + k0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (k0 + i < K) {
            float q = __fadd_rn(rintf(__fdiv_rn(to_f32(p[i]), in_scale)), (float)zp);
            q = fminf(fmaxf(q, 0.f), 255.f);
            v |= (uint32_t)(uint8_t)(int8_t)((int)q - 128) << (8 * i);
          }
        }
      }
      r[j] = v;
    }
  }
};

__global__ void __launch_bounds__(THREADS) matmul_i8_kernel(MatmulArgs a, Epilogue e) {
  LoadI8 al{static_cast<const int8_t*>(a.x), a.M, a.K, a.vec, (int)blockIdx.x * BM};
  gemm_block(al, a.wt, a.Kp, a.M, a.N, e);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) matmul_float_kernel(MatmulArgs a, Epilogue e) {
  LoadFloat<T> al{static_cast<const T*>(a.x), a.M, a.K, (int)blockIdx.x * BM, a.zp_s + 128, a.in_scale};
  gemm_block(al, a.wt, a.Kp, a.M, a.N, e);
}

}  // namespace ievm

// x_kind: 0 int8, 1 fp32, 2 bf16.  out_kind / act: see int8_gemm.cuh.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ievm_int8_matmul_requant(const void* x, int x_kind, const void* wt, int Kp,
                                        const void* w_scale, const void* bias, const void* w_sum,
                                        void* out, int out_kind, int act, int M, int K, int N,
                                        int zp_s, int out_zp, float in_scale, float inv_out,
                                        void* stream) {
  using namespace ievm;
  if (M <= 0 || N <= 0 || K <= 0 || Kp % BK != 0 || Kp < K || x_kind < 0 || x_kind > 2)
    return (int)cudaErrorInvalidValue;
  MatmulArgs a{x, static_cast<const int8_t*>(wt), Kp, M, K, N,
               (K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) ? 1 : 0, zp_s, in_scale};
  Epilogue e{static_cast<const float*>(w_scale), static_cast<const float*>(bias),
             static_cast<const int*>(w_sum), out, out_kind, act, zp_s, out_zp, in_scale, inv_out};
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_kind == 0)
    matmul_i8_kernel<<<grid, THREADS, 0, s>>>(a, e);
  else if (x_kind == 1)
    matmul_float_kernel<float><<<grid, THREADS, 0, s>>>(a, e);
  else
    matmul_float_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a, e);
  return (int)cudaGetLastError();
}
