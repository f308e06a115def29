// fused_mbconv_block on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/fused_mbconv.py:fused_mbconv_block
// (the contract is in ops/fused_mbconv.py).
//
// What bounds it on an H100: per block, the TPU kernel's own device-memory
// traffic is x_in + x_res + y_out + weights, while its work is two int8 GEMMs
// (expand, project) for the tensor cores and k*k*Ho*Wo*Ce depthwise MACs for
// the CUDA cores. At EfficientNet-B0's serving shapes the early blocks
// (112^2 and 56^2 maps, Ce <= 144) are bound by bytes and the depthwise
// MACs; the late ones (7^2 and 14^2, Ce = 480..1152, k = 5) by the depthwise
// MACs; the GEMMs never are.
//
// Design. The TPU kernel keeps a whole image's expanded map in VMEM; on
// Hopper a block has at most 227 KB of shared memory, and the SE gate needs a
// mean over the whole image, which blocks cannot share. So the block is
// split around that reduction, into three launches:
//
//  1. expand_dw: one CUDA block per (spatial output tile, 64 expanded
//     channels, image). It recomputes the 1x1 expand on the halo'd input tile
//     with mma.sync (int8_gemm.cuh's core; a tile of at most 19 x 19 input
//     pixels), applies act + requant into a shared-memory fp32 map of exact
//     integers (zero outside the image: zero-point padding), runs the k x k
//     depthwise conv from it (exact fp32 integer MACs), act, dw requant, and
//     writes yq_d int8 (N, Ho, Wo, Ce). It adds sum(yq_d - d_zp) per (image,
//     channel) into an int32 buffer with atomics: an integer sum, exact and
//     the same in any order. Expand columns and the depthwise conv are per
//     channel, so Ce splits across blocks with no exchange.
//  2. se_gate: one block per image, the two SE FCs and their activations in
//     float64 from that exact sum, rounded to fp32 once (the plain version
//     does the same, so the two agree whatever order each sums in).
//  3. project: an int8 GEMM over (N*Ho*Wo, Ce) x (Ce, Co) whose A loader
//     forms requant(dequant(yq_d) * g) on the fly, in the plain version's
//     order, and whose epilogue adds the residual and requantizes.
//
// The expanded hidden tensor thus makes one int8 round trip through device
// memory (yq_d written once, read once per 64 output channels), where the
// unfused op chain makes five; a block without SE runs launches 1 and 3.
// Numerics follow the Pallas kernel: multiply by the inv_* scalars, rintf
// (half to even), __fmul_rn/__fadd_rn so nvcc cannot contract, SiLU as
// y * (1 / (1 + expf(-y))). Build without --use_fast_math.
#include "int8_gemm.cuh"

namespace ievm {

constexpr int CC = BN;             // expanded channels per expand_dw block (one expand N tile)
constexpr int MAX_REGION = 361;    // input pixels of a halo'd tile: 19 x 19 -> 92 KB of fp32
constexpr int DW_GROUPS = THREADS / CC;
enum MbAct { MB_SILU = 0, MB_RELU6 = 1 };

__device__ __forceinline__ float act_f(float y, int act) {
  if (act == MB_SILU) return __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
  return fminf(fmaxf(y, 0.f), 6.f);
}

// clip(rint(y * inv) + zp, 0, 255): the quint8 value, as a float
__device__ __forceinline__ float requant_q(float y, float inv, float zp) {
  const float q = __fadd_rn(rintf(__fmul_rn(y, inv)), zp);
  return fminf(fmaxf(q, 0.f), 255.f);
}

// ---------------------------------------------------------------------------
// launch 1: expand + depthwise
// ---------------------------------------------------------------------------

struct Pass1Args {
  const int8_t* x;
  const int8_t* we;  // packed (Np, Kp_e) or null: no expand
  int Kp_e;
  const float* ve;   // (2, Ce)
  const float* wdw;  // (k*k, Ce)
  const float* vdw;  // (2, Ce)
  int8_t* yq;        // (N, Ho, Wo, Ce)
  int* pool;         // (N, Ce) or null: no SE
  int H, W, Cin, Ce, Ho, Wo, stride, pad, act, vec;
  int TH, TW, RH, RW, tiles_x;
  float zp_s_in, inv_e, e_zp, inv_d, d_zp;
};

// A rows of the expand GEMM: the input pixels of the halo'd tile, row-major.
struct LoadRegion {
  const int8_t* x;
  int Cin, vec;
  long long base[A_WORDS];  // offset of the pixel's channel 0; -1 outside the image / tile

  __device__ __forceinline__ LoadRegion(const Pass1Args& a, int n, int iy0, int ix0, int bm, int R) {
    x = a.x;
    Cin = a.Cin;
    vec = a.vec;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      const int m = bm + (threadIdx.x >> 4) + 16 * j;
      base[j] = -1;
      if (m < R) {
        const int ry = m / a.RW, rx = m - ry * a.RW;
        const int iy = iy0 + ry, ix = ix0 + rx;
        if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
          base[j] = (((long long)n * a.H + iy) * a.W + ix) * a.Cin;
      }
    }
  }

  __device__ __forceinline__ void load(int kt, uint32_t (&r)[A_WORDS]) const {
    const int k0 = kt * BK + (threadIdx.x & 15) * 4;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      uint32_t v = 0;
      if (base[j] >= 0) {
        const int8_t* p = x + base[j] + k0;
        if (vec) {
          if (k0 < Cin) v = *reinterpret_cast<const uint32_t*>(p);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < Cin) v |= (uint32_t)(uint8_t)p[i] << (8 * i);
        }
      }
      r[j] = v;
    }
  }
};

// Expand epilogue into the shared hidden map: act, requant, minus e_zp.
struct ExpandStore {
  float* hid;
  const float* ve;
  int Ce, c0, RW, iy0, ix0, H, W, act;
  float inv_e, e_zp;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    const int ry = m / RW, rx = m - ry * RW;
    const int iy = iy0 + ry, ix = ix0 + rx;
    float v = 0.f;  // zero padding in the hidden domain
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const float y = act_f(__fadd_rn(__fmul_rn(__int2float_rn(acc), ve[n]), ve[Ce + n]), act);
      v = __fsub_rn(requant_q(y, inv_e, e_zp), e_zp);
    }
    hid[m * CC + (n - c0)] = v;
  }
};

template <int K>
__global__ void __launch_bounds__(THREADS) expand_dw_kernel(Pass1Args a) {
  extern __shared__ __align__(16) float hid[];  // (RH * RW, CC)
  __shared__ int pool_s[CC];
  const int n = blockIdx.z, c0 = blockIdx.y * CC;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int oy0 = ty * a.TH, ox0 = tx * a.TW;
  const int iy0 = oy0 * a.stride - a.pad, ix0 = ox0 * a.stride - a.pad;
  const int R = a.RH * a.RW;
  if (threadIdx.x < CC) pool_s[threadIdx.x] = 0;

  if (a.we != nullptr) {
    const ExpandStore st{hid, a.ve, a.Ce, c0, a.RW, iy0, ix0, a.H, a.W, a.act, a.inv_e, a.e_zp};
    for (int bm = 0; bm < R; bm += BM) {
      LoadRegion al(a, n, iy0, ix0, bm, R);
      gemm_tile(al, a.we, a.Kp_e, R, a.Ce, bm, c0, st);
    }
  } else {
    for (int i = threadIdx.x; i < R * CC; i += THREADS) {
      const int m = i / CC, c = i - m * CC;
      const int ry = m / a.RW, rx = m - ry * a.RW;
      const int iy = iy0 + ry, ix = ix0 + rx;
      float v = 0.f;
      if (c0 + c < a.Ce && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        v = __fsub_rn((float)a.x[(((long long)n * a.H + iy) * a.W + ix) * a.Cin + c0 + c], a.zp_s_in);
      hid[i] = v;
    }
  }
  __syncthreads();

  // depthwise: thread -> one channel, every DW_GROUPS-th pixel of the tile
  const int c = threadIdx.x % CC, grp = threadIdx.x / CC, cg = c0 + c;
  int psum = 0;
  if (cg < a.Ce) {
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = a.wdw[t * a.Ce + cg];
    const float s0 = a.vdw[cg], s1 = a.vdw[a.Ce + cg];
    for (int p = grp; p < a.TH * a.TW; p += DW_GROUPS) {
      const int py = p / a.TW, px = p - py * a.TW;
      const int oy = oy0 + py, ox = ox0 + px;
      if (oy >= a.Ho || ox >= a.Wo) continue;
      const float* hp = hid + ((py * a.stride) * a.RW + px * a.stride) * CC + c;
      float acc = 0.f;  // integers below 2^24: every partial sum is exact
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) acc = fmaf(hp[(dy * a.RW + dx) * CC], wk[dy * K + dx], acc);
      const float y = act_f(__fadd_rn(__fmul_rn(acc, s0), s1), a.act);
      const float q = requant_q(y, a.inv_d, a.d_zp);
      a.yq[(((long long)n * a.Ho + oy) * a.Wo + ox) * a.Ce + cg] = (int8_t)((int)q - 128);
      psum += (int)__fsub_rn(q, a.d_zp);
    }
  }
  if (a.pool != nullptr) {
    atomicAdd(&pool_s[c], psum);
    __syncthreads();
    if (threadIdx.x < CC && c0 + (int)threadIdx.x < a.Ce)
      atomicAdd(&a.pool[(long long)n * a.Ce + c0 + threadIdx.x], pool_s[threadIdx.x]);
  }
}

template <int K>
cudaError_t launch_expand_dw(const Pass1Args& a, dim3 grid, size_t smem, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(expand_dw_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  expand_dw_kernel<K><<<grid, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch 2: the SE gate, one block per image, float64
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) se_gate_kernel(const int* __restrict__ pool,
                                                          const float* __restrict__ srw,
                                                          const float* __restrict__ srb,
                                                          const float* __restrict__ sew,
                                                          const float* __restrict__ seb,
                                                          float* __restrict__ g, int Ce, int Se,
                                                          double pool_scale) {
  extern __shared__ __align__(16) double gate_sm[];  // pooled (Ce), r (Se)
  double* pooled = gate_sm;
  double* r = gate_sm + Ce;
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c = tid; c < Ce; c += THREADS) pooled[c] = (double)pool[(long long)n * Ce + c] * pool_scale;
  __syncthreads();
  for (int j = warp; j < Se; j += THREADS / 32) {
    double s = 0.0;
    for (int c = lane; c < Ce; c += 32) s += pooled[c] * (double)srw[(long long)c * Se + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const double v = s + (double)srb[j];
      r[j] = v * (1.0 / (1.0 + exp(-v)));  // SiLU
    }
  }
  __syncthreads();
  for (int c = tid; c < Ce; c += THREADS) {
    double v = 0.0;
    for (int j = 0; j < Se; ++j) v += r[j] * (double)sew[(long long)j * Ce + c];
    v += (double)seb[c];
    g[(long long)n * Ce + c] = (float)(1.0 / (1.0 + exp(-v)));
  }
}

// ---------------------------------------------------------------------------
// launch 3: gated requant + project GEMM + residual + output requant
// ---------------------------------------------------------------------------

struct Pass2Args {
  const int8_t* yq;  // (M, Ce)
  const float* g;    // (N, Ce) or null: no SE
  const int8_t* wp;
  int Kp_p;
  const float* vp;        // (2, Co)
  const int8_t* x_res;    // (M, Co) or null
  int8_t* out;            // (M, Co)
  int M, HWo, Ce, Co, vec;
  float d_zp, d_scale, inv_q, q_zp, res_scale, res_zp_s, inv_o, o_zp;
};

struct LoadProject {
  const int8_t* yq;
  int Ce, vec;
  float d_zp, d_scale, inv_q, q_zp;
  long long base[A_WORDS];      // row offset into yq; -1 past M
  const float* grow[A_WORDS];   // the row's image's gate, or null

  __device__ __forceinline__ LoadProject(const Pass2Args& a) {
    yq = a.yq;
    Ce = a.Ce;
    vec = a.vec;
    d_zp = a.d_zp;
    d_scale = a.d_scale;
    inv_q = a.inv_q;
    q_zp = a.q_zp;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      const int m = blockIdx.x * BM + (threadIdx.x >> 4) + 16 * j;
      base[j] = m < a.M ? (long long)m * a.Ce : -1;
      grow[j] = (a.g != nullptr && m < a.M) ? a.g + (long long)(m / a.HWo) * a.Ce : nullptr;
    }
  }

  // (yq - d_zp) * d_scale [* g], requantized to the project input domain
  __device__ __forceinline__ uint32_t byte(int8_t b, const float* gr, int c) const {
    float h = __fmul_rn(__fsub_rn((float)((int)b + 128), d_zp), d_scale);
    if (gr != nullptr) h = __fmul_rn(h, gr[c]);
    return (uint32_t)(uint8_t)(int8_t)((int)requant_q(h, inv_q, q_zp) - 128);
  }

  __device__ __forceinline__ void load(int kt, uint32_t (&r)[A_WORDS]) const {
    const int k0 = kt * BK + (threadIdx.x & 15) * 4;
#pragma unroll
    for (int j = 0; j < A_WORDS; ++j) {
      uint32_t v = 0;
      if (base[j] >= 0 && k0 < Ce) {
        const int8_t* p = yq + base[j] + k0;
        if (vec) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
          for (int i = 0; i < 4; ++i) v |= byte((int8_t)(w >> (8 * i)), grow[j], k0 + i) << (8 * i);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + i < Ce) v |= byte(p[i], grow[j], k0 + i) << (8 * i);
        }
      }
      r[j] = v;
    }
  }
};

struct ProjectStore {
  const float* vp;
  const int8_t* x_res;
  int8_t* out;
  int Co;
  float res_scale, res_zp_s, inv_o, o_zp;
  __device__ __forceinline__ void operator()(int m, int n, int acc) const {
    float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), vp[n]), vp[Co + n]);
    const size_t idx = (size_t)m * Co + n;
    if (x_res != nullptr)
      y = __fadd_rn(y, __fmul_rn(__fsub_rn((float)x_res[idx], res_zp_s), res_scale));
    out[idx] = (int8_t)((int)requant_q(y, inv_o, o_zp) - 128);
  }
};

__global__ void __launch_bounds__(THREADS) project_kernel(Pass2Args a) {
  LoadProject al(a);
  const ProjectStore st{a.vp, a.x_res, a.out, a.Co, a.res_scale, a.res_zp_s, a.inv_o, a.o_zp};
  gemm_tile(al, a.wp, a.Kp_p, a.M, a.Co, (int)blockIdx.x * BM, (int)blockIdx.y * BN, st);
}

}  // namespace ievm

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success). Pointers that may be null: we/ve (no expand), pool (no SE),
// g (no SE), x_res (no residual).

extern "C" int ievm_fused_mbconv_expand_dw(const void* x, const void* we, int Kp_e, const void* ve,
                                           const void* wdw, const void* vdw, void* yq, void* pool,
                                           int N, int H, int W, int Cin, int Ce, int Ho, int Wo,
                                           int k, int stride, int act, float zp_s_in, float inv_e,
                                           float e_zp, float inv_d, float d_zp, void* stream) {
  using namespace ievm;
  const int pad = (k - 1) / 2;
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || (k != 1 && k != 3 && k != 5) ||
      (stride != 1 && stride != 2) || (act != MB_SILU && act != MB_RELU6) ||
      Ho != (H + 2 * pad - k) / stride + 1 || Wo != (W + 2 * pad - k) / stride + 1 ||
      (we != nullptr && (ve == nullptr || Kp_e % BK != 0 || Kp_e < Cin)) || (we == nullptr && Cin != Ce))
    return (int)cudaErrorInvalidValue;
  int T = 16;
  while (T > 1 && ((T - 1) * stride + k) * ((T - 1) * stride + k) > MAX_REGION) --T;
  Pass1Args a{};
  a.x = static_cast<const int8_t*>(x);
  a.we = static_cast<const int8_t*>(we);
  a.Kp_e = Kp_e;
  a.ve = static_cast<const float*>(ve);
  a.wdw = static_cast<const float*>(wdw);
  a.vdw = static_cast<const float*>(vdw);
  a.yq = static_cast<int8_t*>(yq);
  a.pool = static_cast<int*>(pool);
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Ce = Ce;
  a.Ho = Ho;
  a.Wo = Wo;
  a.stride = stride;
  a.pad = pad;
  a.act = act;
  a.vec = (Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) ? 1 : 0;
  a.TH = Ho < T ? Ho : T;
  a.TW = Wo < T ? Wo : T;
  a.RH = (a.TH - 1) * stride + k;
  a.RW = (a.TW - 1) * stride + k;
  a.tiles_x = (Wo + a.TW - 1) / a.TW;
  a.zp_s_in = zp_s_in;
  a.inv_e = inv_e;
  a.e_zp = e_zp;
  a.inv_d = inv_d;
  a.d_zp = d_zp;
  const int tiles_y = (Ho + a.TH - 1) / a.TH;
  dim3 grid(tiles_y * a.tiles_x, (Ce + CC - 1) / CC, N);
  const size_t smem = (size_t)a.RH * a.RW * CC * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) return (int)launch_expand_dw<1>(a, grid, smem, s);
  if (k == 3) return (int)launch_expand_dw<3>(a, grid, smem, s);
  return (int)launch_expand_dw<5>(a, grid, smem, s);
}

extern "C" int ievm_fused_mbconv_se_gate(const void* pool, const void* srw, const void* srb,
                                         const void* sew, const void* seb, void* g, int N, int Ce,
                                         int Se, double pool_scale, void* stream) {
  using namespace ievm;
  const size_t smem = (size_t)(Ce + Se) * sizeof(double);
  if (N <= 0 || Ce <= 0 || Se <= 0 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  se_gate_kernel<<<N, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pool), static_cast<const float*>(srw), static_cast<const float*>(srb),
      static_cast<const float*>(sew), static_cast<const float*>(seb), static_cast<float*>(g), Ce, Se,
      pool_scale);
  return (int)cudaGetLastError();
}

extern "C" int ievm_fused_mbconv_project(const void* yq, const void* g, const void* wp, int Kp_p,
                                         const void* vp, const void* x_res, void* out, int M, int HWo,
                                         int Ce, int Co, float d_zp, float d_scale, float inv_q,
                                         float q_zp, float res_scale, float res_zp_s, float inv_o,
                                         float o_zp, void* stream) {
  using namespace ievm;
  if (M <= 0 || HWo <= 0 || M % HWo != 0 || Ce <= 0 || Co <= 0 || Kp_p % BK != 0 || Kp_p < Ce)
    return (int)cudaErrorInvalidValue;
  Pass2Args a{static_cast<const int8_t*>(yq), static_cast<const float*>(g),
              static_cast<const int8_t*>(wp), Kp_p, static_cast<const float*>(vp),
              static_cast<const int8_t*>(x_res), static_cast<int8_t*>(out), M, HWo, Ce, Co,
              (Ce % 4 == 0 && reinterpret_cast<uintptr_t>(yq) % 4 == 0) ? 1 : 0,
              d_zp, d_scale, inv_q, q_zp, res_scale, res_zp_s, inv_o, o_zp};
  dim3 grid((M + BM - 1) / BM, (Co + BN - 1) / BN);
  project_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
