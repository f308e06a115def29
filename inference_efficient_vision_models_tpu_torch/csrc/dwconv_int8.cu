// dwconv_int8 on Hopper: the int8 depthwise conv of the unfused static-INT8
// MBConv executor (compress/quant/qeffnet.py:block_int8). It replaces no
// Pallas kernel: the JAX package computes
// inference_efficient_vision_models_tpu/ops/dwconv_int8.py:depthwise_conv_int8
// with XLA (k*k shifted int32 multiply-adds, or its grouped conv on a TPU),
// and then the epilogue of compress/quant/qeffnet.py:_conv_q; PyTorch has no
// int8 convolution on CUDA, so the port needs this kernel. The contract and
// the plain version are in ops/dwconv_int8.py:
//
//   acc[n, i, j, c] = sum_{dy, dx} (x[n, i s + dy - p, j s + dx - p, c] - zp_s) * w[dy, dx, c]
//   y   = silu(acc * (s_in * s_w[c]) + b[c])
//   out = clip(rint(y / s_out) + zp_out, 0, 255) - 128   (int8, shifted quint8)
//
// with x shifted quint8 (q - 128), zp_s = zp_in - 128, and the halo at zp_s:
// an outside pixel adds nothing, which is the JAX sequence's pad with zp_s
// and its "- zp_s * sum(w)" correction, exactly (every term is an integer,
// |acc| <= 25 * 255 * 128 < 2^23).
//
// What bounds it on an H100: bytes. A depthwise conv does k*k MACs per output
// value and reads one input value per output at stride 1 (four at stride 2),
// so at EfficientNet-B0's shapes it moves some 6 MB per image for 34.5 M MACs:
// 0.47 ms for batch 256 at 3.35 TB/s, against 0.26 ms for the MACs at the
// CUDA cores' 33.5 T/s. Past the bound, the epilogue (an expf, a
// reciprocal and a division per output value) is the cost.
//
// Design (a first, simple kernel): one thread per output pixel and V
// channels, V = 16, 8 or 4 int8 values loaded as one 16-, 8- or 4-byte word
// along C where C and the pointers allow it, single bytes otherwise (odd C);
// adjacent threads take adjacent channel groups of one pixel, then adjacent
// pixels, so a warp's loads are contiguous runs of the NHWC rows. The k*k
// taps re-read their input words through L1 (no shared-memory tile), the
// weights (k*k x C int8, a few KB) stay in L1 and L2. The epilogue follows
// the plain version step by step: __fmul_rn/__fadd_rn so nvcc cannot
// contract, SiLU as y * RN(1 / RN(1 + expf(-y))) with the correctly rounded
// reciprocal of rcp_rn_ge1, the division by s_out as div_rn_by (equal to
// __fdiv_rn for every input, int8_gemm.cuh), rint half to even. Build
// without --use_fast_math.
#include "int8_gemm.cuh"

namespace ievm {

struct DwArgs {
  const int8_t* x;       // (N, H, W, C)
  const int8_t* w;       // (K, K, C)
  const float* w_scale;  // (C,)
  const float* bias;     // (C,)
  int8_t* out;           // (N, Ho, Wo, C)
  int N, H, W, C, Ho, Wo, stride, pad, zp_s;
  float in_scale, out_zp;
  double rs_out;         // RN_f64(1 / s_out)
};

// V bytes at p (aligned to V) as V/4 words (V >= 4) or one byte
template <int V>
__device__ __forceinline__ void load_words(const int8_t* p, uint32_t (&r)[(V + 3) / 4]) {
  if constexpr (V == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else if constexpr (V == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = v.x; r[1] = v.y;
  } else if constexpr (V == 4) {
    r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r[0] = (uint32_t)(uint8_t)__ldg(reinterpret_cast<const signed char*>(p));
  }
}

template <int V>
__device__ __forceinline__ void store_words(int8_t* p, const uint32_t (&r)[(V + 3) / 4]) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
  } else if constexpr (V == 4) {
    *reinterpret_cast<uint32_t*>(p) = r[0];
  } else {
    *p = (int8_t)(uint8_t)r[0];
  }
}

// the signed byte j of the words
template <int V>
__device__ __forceinline__ int sbyte(const uint32_t (&r)[(V + 3) / 4], int j) {
  return (int)(int8_t)(uint8_t)(r[j >> 2] >> (8 * (j & 3)));
}

// y * RN(1 / RN(1 + expf(-y))), the plain version's SiLU (1 + e^-y >= 1, or +inf)
__device__ __forceinline__ float silu(float y) {
  return __fmul_rn(y, rcp_rn_ge1(__fadd_rn(1.0f, expf(-y))));
}

template <int V, int K>
__global__ void __launch_bounds__(256) dwconv_int8_kernel(const DwArgs a) {
  constexpr int NW = (V + 3) / 4;
  const int cgroups = a.C / V;
  const long long total = (long long)a.N * a.Ho * a.Wo * cgroups;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(idx % cgroups) * V;
    long long pix = idx / cgroups;
    const int ox = (int)(pix % a.Wo);
    pix /= a.Wo;
    const int oy = (int)(pix % a.Ho);
    const int n = (int)(pix / a.Ho);
    const int iy0 = oy * a.stride - a.pad, ix0 = ox * a.stride - a.pad;
    int acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0;
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const int iy = iy0 + dy;
      if ((unsigned)iy >= (unsigned)a.H) continue;  // halo row: adds nothing
      const int8_t* row = a.x + ((long long)n * a.H + iy) * a.W * a.C + c0;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int ix = ix0 + dx;
        if ((unsigned)ix >= (unsigned)a.W) continue;
        uint32_t xv[NW], wv[NW];
        load_words<V>(row + (long long)ix * a.C, xv);
        load_words<V>(a.w + (dy * K + dx) * a.C + c0, wv);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += (sbyte<V>(xv, j) - a.zp_s) * sbyte<V>(wv, j);
      }
    }
    uint32_t ov[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) ov[i] = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j;
      const float y = silu(affine_y(acc[j], __fmul_rn(__ldg(a.w_scale + c), a.in_scale),
                                    __ldg(a.bias + c)));
      const uint32_t q = clip_u8(__fadd_rn(rintf(div_rn_by(y, a.rs_out)), a.out_zp));
      ov[j >> 2] |= (q ^ 0x80u) << (8 * (j & 3));  // q - 128 as a byte
    }
    store_words<V>(a.out + ((((long long)n * a.Ho + oy) * a.Wo + ox) * a.C + c0), ov);
  }
}

template <int V>
static cudaError_t launch_v(const DwArgs& a, int k, cudaStream_t stream) {
  const long long total = (long long)a.N * a.Ho * a.Wo * (a.C / V);
  const long long want = (total + 255) / 256;
  const int grid = (int)(want < (1LL << 30) ? want : (1LL << 30));
  if (k == 3) {
    dwconv_int8_kernel<V, 3><<<grid, 256, 0, stream>>>(a);
  } else {
    dwconv_int8_kernel<V, 5><<<grid, 256, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace ievm

// x, w, w_scale, bias, out: device pointers (see DwArgs); vec: V in {16, 8,
// 4, 1}, chosen by the wrapper so that C % V == 0 and every pointer is
// aligned to V. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int ievm_dwconv_int8(const void* x, const void* w, const void* w_scale,
                                const void* bias, void* out, int N, int H, int W, int C, int Ho,
                                int Wo, int k, int stride, int pad, int vec, int zp_s,
                                float in_scale, double rs_out, float out_zp, void* stream) {
  using namespace ievm;
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || C <= 0 || C % vec != 0 || N <= 0 ||
      Ho <= 0 || Wo <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  DwArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
           static_cast<const float*>(w_scale), static_cast<const float*>(bias),
           static_cast<int8_t*>(out), N, H, W, C, Ho, Wo, stride, pad, zp_s, in_scale,
           out_zp, rs_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return (int)launch_v<16>(a, k, s);
    case 8: return (int)launch_v<8>(a, k, s);
    case 4: return (int)launch_v<4>(a, k, s);
    case 1: return (int)launch_v<1>(a, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
