// conv3x3_s1_int8 on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/conv3x3.py:conv3x3_s1_int8.
//
// 3x3, stride 1, same-padded int8 conv on NHWC activations as an implicit
// GEMM: M = N*H*W output pixels, K = 9*C (tap-major, then channel, the order
// of an HWIO kernel reshaped to (9C, O)), N = O. The A loader gathers each
// K slice straight from the activation tensor; a tap that falls outside the
// image reads the shifted zero point zp_s, so the halo is never materialised
// and neither are im2col patches. The epilogue is int8_gemm.cuh's.
//
// Bound on an H100: 2*M*9C*O int8 ops against M*C + M*O*out_bytes bytes.
// At the ResNet18 serving widths the requantizing convs of stages 2-4
// (C = O = 112..456) lie above the ~590 ops/byte balance point and are
// bound by the tensor cores; stage 1 (C = O = 56) sits near it, and the
// fp32-output conv2 of stage 1 is bound by bytes. The design reads each
// activation byte from device memory once per N tile (the 8 taps that revisit
// it hit L1/L2) and spends its effort on mma.sync; wgmma, TMA halo tiles and
// a persistent schedule are later work.
#include "int8_gemm.cuh"

namespace ievm {

struct ConvArgs {
  const int8_t* x;
  const int8_t* wt;
  int Kp;
  int nb, H, W, C, O;
  int vec;  // C % 4 == 0 and x 4-byte aligned: a 4-byte A word lies in one tap
  int zp_s;
};

struct LoadConv {
  const int8_t* x;
  int H, W, C, K, vec;
  uint32_t zp_word;
  int8_t zp_s;
  int h[A_WORDS], w[A_WORDS];      // output pixel of each A row this thread loads (h = -1: past M)
  long long base[A_WORDS];          // element offset of that pixel's channel 0

  __device__ __forceinline__ LoadConv(const ConvArgs& a) {
    x = a.x;
    H = a.H;
    W = a.W;
    C = a.C;
    K = 9 * a.C;
    vec = a.vec;
    zp_s = (int8_t)a.zp_s;
    zp_word = (uint32_t)(uint8_t)zp_s * 0x01010101u;
    const int M = a.nb * a.H * a.W;
    const int hw = a.H * a.W;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      const int m = blockIdx.x * BM + (threadIdx.x >> 4) + 16 * j;
      if (m < M) {
        const int rem = m % hw;
        h[j] = rem / a.W;
        w[j] = rem % a.W;
        base[j] = (long long)m * a.C;
      } else {
        h[j] = -1;
        w[j] = 0;
        base[j] = 0;
      }
    }
  }

  __device__ __forceinline__ uint32_t tap_byte(int j, int k) const {
    const int tap = k / C, c = k - tap * C;
    const int dy = tap / 3, dx = tap - dy * 3;
    const int hh = h[j] + dy - 1, ww = w[j] + dx - 1;
    if (hh < 0 || hh >= H || ww < 0 || ww >= W) return (uint8_t)zp_s;
    return (uint8_t)x[base[j] + ((long long)(dy - 1) * W + (dx - 1)) * C + c];
  }

  __device__ __forceinline__ void load(int kt, uint32_t (&r)[A_WORDS]) const {
    const int k0 = kt * BK + (threadIdx.x & 15) * 4;
    if (vec) {
      const int tap = k0 / C, c = k0 - tap * C;
      const int dy = tap / 3, dx = tap - dy * 3;
      const long long off = ((long long)(dy - 1) * W + (dx - 1)) * C + c;
#pragma unroll
      for (int j = 0; j < A_WORDS; ++j) {
        uint32_t v = 0;
        if (h[j] >= 0 && k0 < K) {
          const int hh = h[j] + dy - 1, ww = w[j] + dx - 1;
          v = (hh < 0 || hh >= H || ww < 0 || ww >= W)
                  ? zp_word
                  : *reinterpret_cast<const uint32_t*>(x + base[j] + off);
        }
        r[j] = v;
      }
    } else {
#pragma unroll
      for (int j = 0; j < A_WORDS; ++j) {
        uint32_t v = 0;
        if (h[j] >= 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < K) v |= tap_byte(j, k0 + i) << (8 * i);
        }
        r[j] = v;
      }
    }
  }
};

__global__ void __launch_bounds__(THREADS) conv3x3_kernel(ConvArgs a, Epilogue e) {
  LoadConv al(a);
  gemm_block(al, a.wt, a.Kp, a.nb * a.H * a.W, a.O, e);
}

}  // namespace ievm

// x (nb, H, W, C) int8 NHWC; wt (Np, Kp) packed; out (nb, H, W, O) int8 or fp32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ievm_conv3x3_s1_int8(const void* x, const void* wt, int Kp, const void* w_scale,
                                    const void* bias, const void* w_sum, void* out, int out_kind,
                                    int relu, int nb, int H, int W, int C, int O, int zp_s,
                                    int out_zp, float in_scale, float inv_out, void* stream) {
  using namespace ievm;
  const long long M = (long long)nb * H * W;
  if (M <= 0 || M > 0x7fffffffLL || C <= 0 || O <= 0 || Kp % BK != 0 || Kp < 9 * C ||
      out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt), Kp, nb, H, W, C, O,
             (C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) ? 1 : 0, zp_s};
  Epilogue e{static_cast<const float*>(w_scale), static_cast<const float*>(bias),
             static_cast<const int*>(w_sum), out, out_kind, relu ? ACT_RELU : ACT_NONE,
             zp_s, out_zp, in_scale, inv_out};
  dim3 grid((unsigned)((M + BM - 1) / BM), (O + BN - 1) / BN);
  conv3x3_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, e);
  return (int)cudaGetLastError();
}
