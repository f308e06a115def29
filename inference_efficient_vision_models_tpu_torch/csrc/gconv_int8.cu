// gconv_int8 on Hopper: the int8 grouped 3x3 conv of a ResNeXt bottleneck
// (conv2 of compress/quant/qresnet.py:apply_int8), with ReLU and the requant
// by true division. It replaces no Pallas kernel: the JAX package computes
// inference_efficient_vision_models_tpu/compress/quant/qresnet.py:330
// _qconv_int8 with XLA's feature_group_count, then _epilogue (:358) and
// _requant (:363); PyTorch has no int8 convolution on CUDA, so the port needs
// this kernel. The contract and the plain version are in ops/gconv_int8.py:
//
//   acc[n, i, j, co] = sum_{dy, dx, ci < Cg} (x[n, i s + dy - 1, j s + dx - 1, g Cg + ci] - zp_s)
//                                            * w[dy, dx, ci, co],   g = co / Cg
//   y   = relu(f32(acc) * (s_in * s_w[co]) + b[co])
//   out = clip(rint(y / s_out) + zp_out, 0, 255) - 128   (int8, shifted quint8)
//
// with x shifted quint8 (q - 128), zp_s = zp_in - 128, the halo at zp_s (an
// outside pixel adds nothing: the JAX sequence's pad with zp_s and its
// "- zp_s * w_sum" correction, exactly), C = G Cg channels, group-major.
//
// What bounds it on an H100, at resnext26_32x4d's 8 grouped calls (224x224,
// batch 256; Cg 4, 8, 16, 32 at 56, 28, 14, 7):
// - bytes: each input value read once and each output written once, ~1.04 GB,
//   ~0.31 ms at 3.35 TB/s;
// - MACs: 29.6 G, 7.4 G dp4a; at 64 dp4a a clock per SM (the integer
//   multiply-add rate), ~0.44 ms at 1.98 GHz;
// - the epilogue: ~385 M output values at ~16 instructions each.
// Tensor cores do not fit this first design: a group's GEMM has K = 9 Cg =
// 36..288 and N = Cg = 4..32 (mma tiles mostly padding at Cg 4); a later
// redesign may batch groups into block-diagonal tiles.
//
// Design.
// - Blocks: one slab of gs whole groups (gs Cg4 <= 128 bytes a pixel, Cg4 =
//   Cg rounded up to 4; the last slab ragged past G) and nb consecutive tiles
//   of the N x bands (image, band of bh output rows at full width) tiles, as
//   ops/gconv_int8.py:gconv_plan chooses; the kernel refuses any other plan.
// - The slab's weights are staged once per block by cp.async from the
//   packed layout (ops/gconv_int8.py:pack_grouped_weight: words (g, tap, i,
//   co), input channels 4i .. 4i + 3 of output co in one word, zeros past
//   Cg), each group at a stride of 4 (Cg4 / 4) words modulo 32 so that a
//   quarter warp's 16-byte loads hit distinct banks.
// - Bytes move once: a tile's input rows x wp padded pixels x the slab's
//   channels are staged in shared memory by cp.async (16, 8 or 4 bytes per
//   copy, as C and the slab allow; plain byte copies for Cg not a multiple
//   of 4, which also spread each group over Cg4 bytes), the halo and the pad
//   channels written as zp_s. With more than one tile per block the next
//   tile's copies are in flight while this one is computed (two buffers).
// - MACs: a thread owns 4 output channels of one group at 4 adjacent
//   outputs along x of one row. Per tap row and word of 4 input channels it
//   loads its window's (4 - 1) s + 3 words once and, per tap, one 16-byte
//   word of weights (4 output channels); each dp4a multiplies 4 input bytes
//   by 4 weight bytes and adds to an int32 sum: 9 ceil(Cg / 4) dp4a per
//   output channel. The sums are exact int32, so any order equals the
//   plain version's.
// - Epilogue, bit for bit the plain version's: the sum less zp_s * w_sum as
//   an exact int-to-float conversion (|.| < 2^24), __fmul_rn/__fadd_rn so
//   nvcc cannot contract, fmaxf for the ReLU, y / s_out as div_rn_by (equal
//   to __fdiv_rn for every input), rint and the clip as magic-constant
//   additions (kernel E's clip_bits), four bytes packed into one 32-bit
//   store. Build without --use_fast_math.
#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace ievm {

constexpr int GC_THREADS = 256;
constexpr int GC_SMEM_LIMIT = 232448;
constexpr int GC_P = 4;           // outputs per thread along x (ops/gconv_int8.py GC_P)
constexpr int GC_MAX_SLAB = 128;  // bytes of a slab's pixel

struct GcArgs {
  const int8_t* x;       // (N, H, W, C)
  const int* wpk;        // (G, 9, Cg4 / 4, Cg4) words
  const float* w_scale;  // (C,)
  const float* bias;     // (C,)
  const int* w_sum;      // (C,)
  int8_t* out;           // (N, Ho, Wo, C)
  int N, H, W, C, G, Cg, Cg4, nch, Ho, Wo, zp_s;
  float in_scale, out_zp;
  double rs_out;         // RN_f64(1 / s_out)
  int gs, cs, bh, nb, vec, rh, wp, bands, runs, gw, wstride;  // the plan
};

// Words between two groups' weights in shared memory (ops/gconv_int8.py
// group_stride_words): 9 Cg4^2 / 4, padded to Cg4 modulo 32.
__host__ __device__ inline int group_stride_words(int cg4) {
  const int gw = 9 * cg4 * cg4 / 4;
  return gw + ((cg4 - gw) % 32 + 32) % 32;
}

// Byte offsets in the dynamic shared memory; ops/gconv_int8.py:gconv_smem
// computes the same total: the slab's weights, the int correction -zp_s
// w_sum, the fp32 scale s_in s_w and bias of each padded channel of the
// slab, then one tile buffer (rh x wp x cs bytes, rounded to 16) per stage,
// two when the block takes more than one tile.
struct GcLayout {
  int base, scale, bias, buf, buf_bytes, total;
  __host__ __device__ GcLayout(int gs, int cg4, int rh, int wp, int nb)
      : base(4 * gs * group_stride_words(cg4)),
        scale(base + 4 * gs * cg4),
        bias(scale + 4 * gs * cg4),
        buf(bias + 4 * gs * cg4),
        buf_bytes((rh * wp * gs * cg4 + 15) / 16 * 16),
        total(buf + (nb > 1 ? 2 : 1) * buf_bytes) {}
};

// Rows iy0 .. iy0 + rh - 1 of image n, pixels ix = -1 .. wp - 2, the slab's
// channels into buf (pixel stride cs bytes, group g at g Cg4), zp_s outside
// the image, past the slab's gsl groups and in the pad channels.
__device__ __forceinline__ void stage_tile(const GcArgs& a, uint8_t* buf, int n, int g0, int gsl,
                                           int iy0) {
  const uint32_t zw = (uint32_t)(uint8_t)a.zp_s * 0x01010101u;
  if (a.vec == 1) {  // bytes: thread j of a pixel takes byte j (group j / Cg4)
    const int lanes = GC_THREADS / a.cs, j = threadIdx.x % a.cs, pl = threadIdx.x / a.cs;
    if (pl >= lanes) return;
    const int g = j / a.Cg4, b = j - g * a.Cg4;
    const bool ch_ok = g < gsl && b < a.Cg;
    const int c = ch_ok ? (g0 + g) * a.Cg + b : 0;
    for (int r = 0; r < a.rh; ++r) {
      const int iy = iy0 + r;
      const bool row_in = ch_ok && iy >= 0 && iy < a.H;
      const int8_t* src = a.x + ((long long)n * a.H + (row_in ? iy : 0)) * a.W * a.C + c;
      uint8_t* dst = buf + r * a.wp * a.cs + j;
      for (int px = pl; px < a.wp; px += lanes) {
        const int ix = px - 1;
        const bool in = row_in && ix >= 0 && ix < a.W;
        dst[px * a.cs] = in ? (uint8_t)src[(long long)ix * a.C] : (uint8_t)zw;
      }
    }
    return;
  }
  // Cg a multiple of 4: the slab's channels lie contiguous at g0 Cg
  const int cpp = a.cs / a.vec, lanes = GC_THREADS / cpp;
  const int j = threadIdx.x % cpp, pl = threadIdx.x / cpp;
  if (pl >= lanes) return;
  const bool ch_ok = j * a.vec < gsl * a.Cg;
  const int c = g0 * a.Cg + j * a.vec;
  for (int r = 0; r < a.rh; ++r) {
    const int iy = iy0 + r;
    const bool row_in = ch_ok && iy >= 0 && iy < a.H;
    const int8_t* src = a.x + ((long long)n * a.H + (row_in ? iy : 0)) * a.W * a.C + (ch_ok ? c : 0);
    uint8_t* dst = buf + r * a.wp * a.cs + j * a.vec;
    for (int px = pl; px < a.wp; px += lanes) {
      const int ix = px - 1;
      uint8_t* d = dst + px * a.cs;
      const bool in = row_in && ix >= 0 && ix < a.W;
      const int8_t* s = src + (long long)(in ? ix : 0) * a.C;
      switch (a.vec) {  // the same case for every thread of the block
        case 16:
          if (in) sm90::cp_async_ca<16>(d, s);
          else *reinterpret_cast<uint4*>(d) = make_uint4(zw, zw, zw, zw);
          break;
        case 8:
          if (in) sm90::cp_async_ca<8>(d, s);
          else *reinterpret_cast<uint2*>(d) = make_uint2(zw, zw);
          break;
        default:
          if (in) sm90::cp_async_ca<4>(d, s);
          else *reinterpret_cast<uint32_t*>(d) = zw;
      }
    }
  }
}

// The outputs of band rows oy0 .. oy0 + bh - 1 of image n from the staged
// tile. Item (row, run, g, j), j fastest: output row oy0 + row (skipped past
// Ho), outputs run * P .. + P - 1 along x (those past Wo not stored), output
// channels 4 j .. 4 j + 3 of slab group g (skipped past the slab's gsl
// groups); thread t takes items t, t + 256, ...
template <int S>
__device__ __forceinline__ void compute_tile(const GcArgs& a, const uint8_t* buf, const int* wsm,
                                             const int* base, const float* scv, const float* bv,
                                             int n, int g0, int gsl, int oy0) {
  constexpr int P = GC_P;
  constexpr int NW = (P - 1) * S + 3;  // window words of a tap row
  const int nch = a.nch, gs = a.gs, runs = a.runs;
  const int items = a.bh * runs * gs * nch;
  const float zpm = __fsub_rn(RINT_MAGIC, a.out_zp);
  const bool words = (a.Cg & 3) == 0;  // a thread's 4 channels: one aligned word
  const int tap_words = nch * a.Cg4;   // weight words of one tap of a group
  // the item index as mixed-radix digits (j, g, run, row), advanced by
  // GC_THREADS without a division
  int j = threadIdx.x % nch, rest = threadIdx.x / nch;
  int g = rest % gs, run = (rest / gs) % runs, row = rest / gs / runs;
  const int sj = GC_THREADS % nch, sq = GC_THREADS / nch;
  const int sg = sq % gs, srun = (sq / gs) % runs, srow = sq / gs / runs;
  for (int it = threadIdx.x; it < items; it += GC_THREADS) {
    const int oy = oy0 + row;
    if (g < gsl && oy < a.Ho) {
      int acc[P][4];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int o = 0; o < 4; ++o) acc[p][o] = 0;
      const uint8_t* px0 = buf + (row * S * a.wp + run * P * S) * a.cs + g * a.Cg4;
      const int* wg = wsm + g * a.wstride + 4 * j;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint8_t* rp = px0 + dy * a.wp * a.cs;
        const int* wt = wg + dy * 3 * tap_words;
        for (int i = 0; i < nch; ++i) {
          uint32_t wd[NW];
#pragma unroll
          for (int u = 0; u < NW; ++u) wd[u] = *reinterpret_cast<const uint32_t*>(rp + u * a.cs + 4 * i);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int4 w4 = *reinterpret_cast<const int4*>(wt + dx * tap_words + i * a.Cg4);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const int v = (int)wd[p * S + dx];
              acc[p][0] = __dp4a(v, w4.x, acc[p][0]);
              acc[p][1] = __dp4a(v, w4.y, acc[p][1]);
              acc[p][2] = __dp4a(v, w4.z, acc[p][2]);
              acc[p][3] = __dp4a(v, w4.w, acc[p][3]);
            }
          }
        }
      }
      const int cl = g * a.Cg4 + 4 * j;  // the slab's padded channel of output 0
      const int4 b4i = *reinterpret_cast<const int4*>(base + cl);
      const float4 s4 = *reinterpret_cast<const float4*>(scv + cl);
      const float4 f4 = *reinterpret_cast<const float4*>(bv + cl);
      const int bse[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
      const float sc[4] = {s4.x, s4.y, s4.z, s4.w}, bs[4] = {f4.x, f4.y, f4.z, f4.w};
      int8_t* orow = a.out + (((long long)n * a.Ho + oy) * a.Wo + run * P) * a.C +
                     (g0 + g) * a.Cg + 4 * j;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (run * P + p >= a.Wo) continue;
        uint32_t q[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          // the sum less zp_s * w_sum, as the float it is (exact: |.| < 2^24)
          const float s = __int2float_rn(acc[p][o] + bse[o]);
          const float y = fmaxf(__fadd_rn(__fmul_rn(s, sc[o]), bs[o]), 0.f);
          q[o] = clip_bits(__fsub_rn(__fadd_rn(div_rn_by(y, a.rs_out), RINT_MAGIC), zpm));
        }
        const uint32_t word = pack4(q[0], q[1], q[2], q[3]) ^ 0x80808080u;  // q - 128 as bytes
        int8_t* o = orow + p * a.C;
        if (words) {
          *reinterpret_cast<uint32_t*>(o) = word;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (4 * j + k < a.Cg) o[k] = (int8_t)(word >> (8 * k));
        }
      }
    }
    j += sj;
    int carry = j >= nch;
    if (carry) j -= nch;
    g += sg + carry;
    carry = g >= gs;
    if (carry) g -= gs;
    run += srun + carry;
    carry = run >= runs;
    if (carry) run -= runs;
    row += srow + carry;
  }
}

// At most 128 registers a thread, so that two blocks share an SM; gconv_plan
// weighs the blocks its shared memory lets an SM hold.
template <int S>
__global__ void __launch_bounds__(GC_THREADS, 2) gconv_kernel(const GcArgs a) {
  extern __shared__ __align__(16) uint8_t gc_smem[];
  const GcLayout L(a.gs, a.Cg4, a.rh, a.wp, a.nb);
  int* wsm = reinterpret_cast<int*>(gc_smem);
  int* base = reinterpret_cast<int*>(gc_smem + L.base);
  float* scv = reinterpret_cast<float*>(gc_smem + L.scale);
  float* bv = reinterpret_cast<float*>(gc_smem + L.bias);
  // tiles t0 .. t0 + nt - 1 of the N x bands (image, band) tiles of slab
  // blockIdx.y; tile buffer i & 1 at gc_smem + L.buf + (i & 1) * L.buf_bytes
  // (computed, not taken from an array, so that its loads stay shared-memory
  // loads)
  const int g0 = blockIdx.y * a.gs, gsl = min(a.gs, a.G - g0);
  const int t0 = blockIdx.x * a.nb, nt = min(a.nb, a.N * a.bands - t0);
  const bool async = a.vec != 1;

  // the slab's weights, 16 bytes a copy, each group at its padded stride;
  // groups past gsl are never read
  const int pieces = a.gw / 4;
  const int* wsrc = a.wpk + (long long)g0 * a.gw;
  for (int i = threadIdx.x; i < gsl * pieces; i += GC_THREADS) {
    const int g = i / pieces;
    sm90::cp_async_ca<16>(wsm + g * a.wstride + 4 * (i - g * pieces), wsrc + 4 * i);
  }
  sm90::cp_async_commit();
  if (!async) sm90::cp_async_wait<0>();
  for (int i = threadIdx.x; i < a.cs; i += GC_THREADS) {
    const int g = i / a.Cg4, co = i - g * a.Cg4;
    const bool ok = g < gsl && co < a.Cg;
    const int ch = ok ? (g0 + g) * a.Cg + co : 0;
    base[i] = ok ? -a.zp_s * a.w_sum[ch] : 0;
    scv[i] = ok ? __fmul_rn(a.w_scale[ch], a.in_scale) : 0.f;
    bv[i] = ok ? a.bias[ch] : 0.f;
  }
  const auto stage = [&](int t, uint8_t* buf) {
    const int n = t / a.bands, band = t - n * a.bands;
    stage_tile(a, buf, n, g0, gsl, band * a.bh * S - 1);
    if (async) sm90::cp_async_commit();
  };
  stage(t0, gc_smem + L.buf);
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {  // the next tile's copies fly while this one is computed
      stage(t0 + i + 1, gc_smem + L.buf + ((i + 1) & 1) * L.buf_bytes);
      if (async) sm90::cp_async_wait<1>();
    } else if (async) {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int t = t0 + i, n = t / a.bands;
    compute_tile<S>(a, gc_smem + L.buf + (i & 1) * L.buf_bytes, wsm, base, scv, bv, n, g0, gsl,
                    (t - n * a.bands) * a.bh);
    __syncthreads();
  }
}

template <int S>
static cudaError_t launch(const GcArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(gconv_kernel<S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  gconv_kernel<S><<<grid, GC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ievm

// x, wpk, w_scale, bias, w_sum, out: device pointers (see GcArgs); the plan
// (gs, bh, nb, vec, smem) is ops/gconv_int8.py:gconv_plan's, with vec
// lowered to the alignment of x. Only the ReLU + requant route exists.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments or a plan the kernel does not take.
extern "C" int ievm_gconv_int8(const void* x, const void* wpk, const void* w_scale,
                               const void* bias, const void* w_sum, void* out, int N, int H, int W,
                               int C, int G, int stride, int zp_s, float in_scale, double rs_out,
                               float out_zp, int gs, int bh, int nb, int vec, int smem,
                               void* stream) {
  using namespace ievm;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int Cg = C / G, Cg4 = (Cg + 3) / 4 * 4;
  const int gs_want = GC_MAX_SLAB / Cg4 < G ? (GC_MAX_SLAB / Cg4 > 1 ? GC_MAX_SLAB / Cg4 : 1) : G;
  if (Cg4 > GC_MAX_SLAB || gs != gs_want) return (int)cudaErrorInvalidValue;
  const int cs = gs * Cg4;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  if (bh < 1 || bh > Ho || nb < 1) return (int)cudaErrorInvalidValue;
  if (vec != 1 && ((vec != 4 && vec != 8 && vec != 16) || Cg % 4 != 0 || C % vec != 0 ||
                   cs % vec != 0 || reinterpret_cast<uintptr_t>(x) % vec != 0))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wpk) % 16 != 0 ||
      (Cg % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const int rh = (bh - 1) * stride + 3;
  const int runs = (Wo + GC_P - 1) / GC_P, wp = (runs * GC_P - 1) * stride + 3;
  const int bands = (Ho + bh - 1) / bh, slabs = (G + gs - 1) / gs;
  if ((long long)N * bands > 0x7fffffffLL || nb > N * bands || slabs > 65535 ||
      smem != GcLayout(gs, Cg4, rh, wp, nb).total || smem > GC_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const GcArgs a{static_cast<const int8_t*>(x), static_cast<const int*>(wpk),
                 static_cast<const float*>(w_scale), static_cast<const float*>(bias),
                 static_cast<const int*>(w_sum), static_cast<int8_t*>(out),
                 N, H, W, C, G, Cg, Cg4, Cg4 / 4, Ho, Wo, zp_s, in_scale, out_zp, rs_out,
                 gs, cs, bh, nb, vec, rh, wp, bands, runs, 9 * Cg4 * Cg4 / 4,
                 group_stride_words(Cg4)};
  const dim3 grid((N * bands + nb - 1) / nb, slabs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(stride == 1 ? launch<1>(a, grid, smem, s) : launch<2>(a, grid, smem, s));
}
