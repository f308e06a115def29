// dwconv_int8 on Hopper: the int8 depthwise conv of the unfused static-INT8
// MBConv executors (compress/quant/qeffnet.py:block_int8 with SiLU,
// compress/quant/qmobilenet.py:block_int8 with ReLU6). It replaces no
// Pallas kernel: the JAX package computes
// inference_efficient_vision_models_tpu/ops/dwconv_int8.py:depthwise_conv_int8
// (:50) with XLA (k*k shifted int32 multiply-adds, or its grouped conv on a
// TPU), and then the epilogue of compress/quant/qeffnet.py:_conv_q or
// qmobilenet.py:_conv_q; PyTorch has no int8 convolution on CUDA, so the
// port needs this kernel. The contract and the plain version are in
// ops/dwconv_int8.py:
//
//   acc[n, i, j, c] = sum_{dy, dx} (x[n, i s + dy - p, j s + dx - p, c] - zp_s) * w[dy, dx, c]
//   y   = act(acc * (s_in * s_w[c]) + b[c])      act: SiLU or ReLU6 (min(max(., 0), 6))
//   out = clip(rint(y / s_out) + zp_out, 0, 255) - 128   (int8, shifted quint8)
//
// with x shifted quint8 (q - 128), zp_s = zp_in - 128, and the halo at zp_s:
// an outside pixel adds nothing, which is the JAX sequence's pad with zp_s
// and its "- zp_s * sum(w)" correction, exactly.
//
// What bounds it on an H100, at EfficientNet-B0's 16 calls (batch 256):
// - bytes: each input value read once and each output written once, 1.56 GB,
//   0.47 ms at 3.35 TB/s;
// - the depthwise MACs: 8.8 G, 0.26 ms as fp32 FMAs at 33.5 T/s;
// - the epilogue: ~590 M output values at ~30 instructions each (an expf, a
//   reciprocal, a division, the requant), ~0.5 ms of issue slots.
// Tensor cores do not fit: a depthwise conv has no sum across channels, so
// an mma tile, whose K runs across channels, would use at most one of every
// 8 of its products (the rest multiplied by zero weights).
//
// Design.
// - Blocks: one group of cg <= 128 channels (a multiple of 4, the last group
//   ragged past C) and nb consecutive tiles of the N x bands (image, band of
//   bh output rows at full width) tiles, as ops/dwconv_int8.py:dw_plan
//   chooses; the kernel refuses any other plan. Large maps with few channels
//   take bands of a few rows; small maps with many channels one band, the
//   whole map, per image.
// - Bytes move once: a tile's input rows x wp padded pixels x cg bytes are
//   staged in shared memory by cp.async (16, 8 or 4 bytes per copy, as C and
//   cg allow; plain byte copies for C not a multiple of 4), the halo and the
//   channels past C written as zp_s. With more than one tile per block, the
//   next tile's copies are in flight while this one is computed (two
//   buffers). Only the k - s overlap rows of two bands are read twice.
// - MACs: a thread owns one 4-channel word of p adjacent outputs along x in
//   two adjacent rows. For each staged row it reads the (p - 1) s + k words
//   of its window once and builds, per channel, pairs of horizontally
//   adjacent inputs as two sign-extended 16-bit lanes (one byte permute a
//   pair); a dp2a multiplies a pair by two taps' int8 weights and adds both
//   products to an int32 sum, so k taps take (k + 1) / 2 dp2a, and each pair
//   serves every output of the thread's rows that reads it: (k + 1) / 2
//   instructions per k MACs and one per pair, where fp32 FMAs on inputs
//   converted once (XOR, byte permute into 2^23 + q, subtraction: kernel C's
//   form) take k, and ~2 for each input. The weights are packed once per
//   block into tap pairs (w0 w1 | w2 w3, w4 0) in shared memory. The sums
//   are exact int32 (|sum| < 2^22), so any order gives the plain version's;
//   the correction - zp_s * sum(w) is folded into the magic constant that
//   turns the int into a float (1.5 * 2^23 + sum).
// - Epilogue, bit for bit the plain version's: __fmul_rn/__fadd_rn so nvcc
//   cannot contract; SiLU as y * RN(1 / RN(1 + expf(-y))), the reciprocal by
//   rcp_ge1_fast, and a group of eight values with one it cannot settle
//   redone by rcp_rn_ge1 after the loop (no per-element branch); ReLU6 as
//   fminf(fmaxf(y, 0), 6), exact; y / s_out as div_rn_by (equal to
//   __fdiv_rn for every input); rint and the clip as magic-constant
//   additions (int8_gemm.cuh clip_u8), four bytes packed by byte permutes
//   into one 32-bit store. The activation is a template parameter, one
//   instance each: a runtime switch per value would serialise the loop.
//   Build without --use_fast_math.
#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace ievm {

constexpr int DWE_THREADS = 256;
constexpr int DWE_SMEM_LIMIT = 232448;
constexpr int DWE_MAX_GROUP = 128;
constexpr int DWE_ROWS = 2;  // output rows per thread (ops/dwconv_int8.py ROWS_PER_THREAD)
constexpr float MAGIC_I2F = 12582912.f;  // 1.5 * 2^23: bits 0x4B400000 + v is this + v, |v| < 2^22
enum DwAct { DW_SILU = 0, DW_RELU6 = 1 };  // ops/dwconv_int8.py _ACTS

struct DwArgs {
  const int8_t* x;       // (N, H, W, C)
  const int8_t* w;       // (K, K, C)
  const float* w_scale;  // (C,)
  const float* bias;     // (C,)
  int8_t* out;           // (N, Ho, Wo, C)
  int N, H, W, C, Ho, Wo, pad, zp_s;
  float in_scale, out_zp;
  double rs_out;         // RN_f64(1 / s_out)
  int cg, bh, nb, vec, rh, wp, bands;  // the plan
};

// Byte offsets in the dynamic shared memory; ops/dwconv_int8.py:dw_smem
// computes the same total: per channel of the group, the k tap-pair words
// (w[dy][0..3]) and k more (w[dy][4], k = 5), the int bits 0x4B400000 -
// zp_s * sum(w), the fp32 scale s_in * s_w and bias; then one tile buffer
// (rh x wp x cg bytes, rounded to 16) per stage, two when the block takes
// more than one tile.
struct DwLayout {
  int base, scale, bias, buf, buf_bytes, total;
  __host__ __device__ DwLayout(int k, int cg, int rh, int wp, int nb)
      : base(4 * 2 * k * cg),
        scale(base + 4 * cg),
        bias(scale + 4 * cg),
        buf(bias + 4 * cg),
        buf_bytes((rh * wp * cg + 15) / 16 * 16),
        total(buf + (nb > 1 ? 2 : 1) * buf_bytes) {}
};

// Rows iy0 .. iy0 + rh - 1 of image n, pixels ix = -pad .. wp - pad - 1,
// channels c0 .. c0 + cg - 1 into buf (pixel stride cg bytes), zp_s outside
// the image and past C. Thread: copy j of each pixel (vec bytes), pixels
// pl, pl + lanes, ... (lanes = 256 / copies per pixel).
__device__ __forceinline__ void stage_band(const DwArgs& a, uint8_t* buf, int n, int c0, int iy0) {
  const int cpp = a.cg / a.vec, lanes = DWE_THREADS / cpp;
  const int j = threadIdx.x % cpp, pl = threadIdx.x / cpp;
  if (pl >= lanes) return;
  const int c = c0 + j * a.vec;
  const uint32_t zw = (uint32_t)(uint8_t)a.zp_s * 0x01010101u;
  for (int r = 0; r < a.rh; ++r) {
    const int iy = iy0 + r;
    const bool row_in = iy >= 0 && iy < a.H && c < a.C;
    const int8_t* src = a.x + ((long long)n * a.H + (row_in ? iy : 0)) * a.W * a.C + c;
    uint8_t* dst = buf + r * a.wp * a.cg + j * a.vec;
    for (int px = pl; px < a.wp; px += lanes) {
      const int ix = px - a.pad;
      uint8_t* d = dst + px * a.cg;
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
        case 4:
          if (in) sm90::cp_async_ca<4>(d, s);
          else *reinterpret_cast<uint32_t*>(d) = zw;
          break;
        default:
          *d = in ? (uint8_t)*s : (uint8_t)zw;
      }
    }
  }
}

// Byte ch of lo and byte ch of hi, each sign-extended into a 16-bit lane
// (prmt: a selector nibble with its top bit set replicates that byte's sign).
__device__ __forceinline__ int pair16(uint32_t lo, uint32_t hi, int ch) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(lo), "r"(hi), "r"(0xC480u + 0x1111u * ch));
  return (int)r;
}

// q[i]: low byte clip(rint(act(y[i]) / s_out) + zp_out, 0, 255) (zpm =
// RINT_MAGIC - zp_out), bit for bit as the plain version takes it: ReLU6 by
// fminf/fmaxf; SiLU as
// y * RN(1 / RN(1 + expf(-y))) with the reciprocals by rcp_ge1_fast (1 +
// e^-y >= 1, or +inf), and where any of them is unsettled (about one group
// in 10^5) all of the group's by rcp_rn_ge1 after the loop (a settled one is
// the same value); the quotient by div_rn_by; rint + zp as (q + M) - (M -
// zp), exact for |q| < 2^22 and past the clip on the same side beyond.
template <int ACT, int NV>
__device__ __forceinline__ void act_requant(const float (&y)[NV], double rs_out, float zpm,
                                            uint32_t (&q)[NV]) {
  if constexpr (ACT == DW_RELU6) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      q[i] = clip_bits(__fsub_rn(
          __fadd_rn(div_rn_by(fminf(fmaxf(y[i], 0.f), 6.f), rs_out), RINT_MAGIC), zpm));
    return;
  }
  float t[NV];
  bool redo = false;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    bool rd;
    t[i] = rcp_ge1_fast(__fadd_rn(1.0f, expf(-y[i])), rd);
    redo |= rd;
  }
  if (redo) {
#pragma unroll
    for (int i = 0; i < NV; ++i) t[i] = rcp_rn_ge1(__fadd_rn(1.0f, expf(-y[i])));
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
    q[i] = clip_bits(__fsub_rn(__fadd_rn(div_rn_by(__fmul_rn(y[i], t[i]), rs_out), RINT_MAGIC), zpm));
}

// The outputs of band rows oy0 .. oy0 + bh - 1 of image n from the staged
// tile. Item (pair, run, cw), cw fastest: output rows oy0 + ROWS pair .. +
// ROWS - 1 (a row past the band or Ho skipped), outputs run * P .. + P - 1
// along x, channels c0 + 4 cw .. + 3; thread t takes items t, t + 256, ...
template <int K, int S, int P, int ACT>
__device__ __forceinline__ void compute_band(const DwArgs& a, const uint8_t* buf, const int* wpair,
                                             const int* base, const float* scv, const float* bv,
                                             int n, int c0, int oy0) {
  constexpr int R = DWE_ROWS;
  constexpr int NW = (P - 1) * S + K;  // window words per staged row
  constexpr int NR = (R - 1) * S + K;  // staged rows per item
  // input pairs per staged row, pair i at pixel i * S: output p's taps 2j, 2j + 1
  // read pixels p S + 2j and + 1, the pair p + 2j (stride 1) or p + j (stride 2)
  constexpr int NPR = S == 1 ? NW : (NW + 1) / 2, STEP = S == 1 ? 2 : 1;
  const int cwn = a.cg >> 2, runs = (a.Wo + P - 1) / P, pairs = (a.bh + R - 1) / R;
  const int items = pairs * runs * cwn;
  const float zpm = __fsub_rn(RINT_MAGIC, a.out_zp);
  const int row_bytes = a.wp * a.cg;
  // the item index as mixed-radix digits, advanced by DWE_THREADS without a division
  int cw = threadIdx.x % cwn, rest = threadIdx.x / cwn;
  int run = rest % runs, pair = rest / runs;
  const int dcw = DWE_THREADS % cwn, drest = DWE_THREADS / cwn;
  const int drun0 = drest % runs, dpair0 = drest / runs;
  const int drun1 = (drest + 1) % runs, dpair1 = (drest + 1) / runs;
  for (int it = threadIdx.x; it < items; it += DWE_THREADS) {
    const int c = cw * 4, ox0 = run * P, py0 = pair * R;
    int acc[R][P][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) acc[r][p][ch] = 0;
#pragma unroll
    for (int sr = 0; sr < NR; ++sr) {
      const uint8_t* row = buf + (py0 * S + sr) * row_bytes + ox0 * S * a.cg + c;
      uint32_t wd[NW];
#pragma unroll
      for (int u = 0; u < NW; ++u) wd[u] = *reinterpret_cast<const uint32_t*>(row + u * a.cg);
      int pr[NPR][4];
#pragma unroll
      for (int i = 0; i < NPR; ++i) {
        // the last pair's second pixel lies past the window: its weight is 0
        const uint32_t hi = wd[i * S + 1 < NW ? i * S + 1 : i * S];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) pr[i][ch] = pair16(wd[i * S], hi, ch);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int dy = sr - r * S;  // the tap row of staged row sr for output row r
        if (dy < 0 || dy >= K) continue;
        const int4 w01 = *reinterpret_cast<const int4*>(wpair + dy * a.cg + c);
        const int wa[4] = {w01.x, w01.y, w01.z, w01.w};
        int wb[4] = {0, 0, 0, 0};
        if constexpr (K == 5) {
          const int4 w4 = *reinterpret_cast<const int4*>(wpair + (K + dy) * a.cg + c);
          wb[0] = w4.x, wb[1] = w4.y, wb[2] = w4.z, wb[3] = w4.w;
        }
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            int v = __dp2a_lo(pr[p][ch], wa[ch], acc[r][p][ch]);  // taps 0, 1
            v = __dp2a_hi(pr[p + STEP][ch], wa[ch], v);            // taps 2, 3 (k 3: 2, -)
            if constexpr (K == 5) v = __dp2a_lo(pr[p + 2 * STEP][ch], wb[ch], v);  // 4, -
            acc[r][p][ch] = v;
          }
      }
    }
    const int4 b4i = *reinterpret_cast<const int4*>(base + c);
    const float4 s4 = *reinterpret_cast<const float4*>(scv + c);
    const float4 b4 = *reinterpret_cast<const float4*>(bv + c);
    const int bse[4] = {b4i.x, b4i.y, b4i.z, b4i.w};
    const float sc[4] = {s4.x, s4.y, s4.z, s4.w}, bs[4] = {b4.x, b4.y, b4.z, b4.w};
    const bool words = (a.C & 3) == 0, live_c = c0 + c < a.C;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int oy = oy0 + py0 + r;
      if (py0 + r >= a.bh || oy >= a.Ho || !live_c) continue;
      int8_t* orow = a.out + (((long long)n * a.Ho + oy) * a.Wo + ox0) * a.C + c0 + c;
      // two outputs (eight values) at a time, which bounds the live registers
#pragma unroll
      for (int p = 0; p < P; p += 2) {
        float y[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          // the sum less zp_s * sum(w), as the float it is (exact: |.| < 2^22)
          const float s = __fsub_rn(__int_as_float(bse[u % 4] + acc[r][p + u / 4][u % 4]), MAGIC_I2F);
          y[u] = __fadd_rn(__fmul_rn(s, sc[u % 4]), bs[u % 4]);
        }
        uint32_t q[8];
        act_requant<ACT>(y, a.rs_out, zpm, q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ox0 + p + h >= a.Wo) continue;
          const uint32_t word = pack4(q[4 * h], q[4 * h + 1], q[4 * h + 2], q[4 * h + 3]) ^
                                0x80808080u;  // q - 128 as bytes
          int8_t* o = orow + (p + h) * a.C;
          if (words) {
            *reinterpret_cast<uint32_t*>(o) = word;
          } else {
#pragma unroll
            for (int ch = 0; ch < 4; ++ch)
              if (c0 + c + ch < a.C) o[ch] = (int8_t)(word >> (8 * ch));
          }
        }
      }
    }
    cw += dcw;
    const bool carry = cw >= cwn;
    if (carry) cw -= cwn;
    run += carry ? drun1 : drun0;
    pair += carry ? dpair1 : dpair0;
    if (run >= runs) {
      run -= runs;
      ++pair;
    }
  }
}

// At most 128 registers a thread, so that two blocks share an SM; dw_plan
// weighs the blocks its shared memory lets an SM hold.
template <int K, int S, int P, int ACT>
__global__ void __launch_bounds__(DWE_THREADS, 2) dw_band_kernel(const DwArgs a) {
  extern __shared__ __align__(16) uint8_t dw_smem[];
  const DwLayout L(K, a.cg, a.rh, a.wp, a.nb);
  int* wpair = reinterpret_cast<int*>(dw_smem);
  int* base = reinterpret_cast<int*>(dw_smem + L.base);
  float* scv = reinterpret_cast<float*>(dw_smem + L.scale);
  float* bv = reinterpret_cast<float*>(dw_smem + L.bias);
  // tiles t0 .. t0 + nt - 1 of the N x bands (image, band) tiles of channel
  // group c0; tile buffer i & 1 at dw_smem + L.buf + (i & 1) * L.buf_bytes
  // (computed, not taken from an array, so that its loads stay shared-memory
  // loads)
  const int c0 = blockIdx.y * a.cg;
  const int t0 = blockIdx.x * a.nb, nt = min(a.nb, a.N * a.bands - t0);
  const bool async = a.vec != 1;

  // tap pairs: word dy = bytes (w[dy][0], w[dy][1], w[dy][2], w[dy][3] or 0),
  // word K + dy = (w[dy][4], 0, 0, 0) for k 5; zeros past C
  for (int i = threadIdx.x; i < K * a.cg; i += DWE_THREADS) {
    const int dy = i / a.cg, j = i - dy * a.cg;
    uint32_t lo = 0, hi = 0;
    if (c0 + j < a.C) {
      const int8_t* wr = a.w + dy * K * a.C + c0 + j;  // w[dy][dx] at wr[dx * C]
      lo = (uint32_t)(uint8_t)wr[0] | (uint32_t)(uint8_t)wr[a.C] << 8 |
           (uint32_t)(uint8_t)wr[2 * a.C] << 16;
      if (K == 5) {
        lo |= (uint32_t)(uint8_t)wr[3 * a.C] << 24;
        hi = (uint32_t)(uint8_t)wr[4 * a.C];
      }
    }
    wpair[i] = (int)lo;
    wpair[K * a.cg + i] = (int)hi;
  }
  for (int j = threadIdx.x; j < a.cg; j += DWE_THREADS) {
    const bool ok = c0 + j < a.C;
    int sw = 0;
    for (int t = 0; ok && t < K * K; ++t) sw += a.w[t * a.C + c0 + j];
    base[j] = 0x4B400000 - a.zp_s * sw;
    scv[j] = ok ? __fmul_rn(a.w_scale[c0 + j], a.in_scale) : 0.f;
    bv[j] = ok ? a.bias[c0 + j] : 0.f;
  }
  const auto stage = [&](int t, uint8_t* buf) {
    const int n = t / a.bands, band = t - n * a.bands;
    stage_band(a, buf, n, c0, band * a.bh * S - a.pad);
    if (async) sm90::cp_async_commit();
  };
  stage(t0, dw_smem + L.buf);
  for (int i = 0; i < nt; ++i) {
    if (i + 1 < nt) {  // the next tile's copies fly while this one is computed
      stage(t0 + i + 1, dw_smem + L.buf + ((i + 1) & 1) * L.buf_bytes);
      if (async) sm90::cp_async_wait<1>();
    } else if (async) {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int t = t0 + i, n = t / a.bands;
    compute_band<K, S, P, ACT>(a, dw_smem + L.buf + (i & 1) * L.buf_bytes, wpair, base, scv,
                               bv, n, c0, (t - n * a.bands) * a.bh);
    __syncthreads();
  }
}

template <int K, int S, int P, int ACT>
static cudaError_t launch(const DwArgs& a, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(dw_band_kernel<K, S, P, ACT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dw_band_kernel<K, S, P, ACT><<<grid, DWE_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int ACT>
static cudaError_t launch_act(int key, const DwArgs& a, dim3 grid, int smem, cudaStream_t s) {
  switch (key) {
    case 312: return launch<3, 1, 2, ACT>(a, grid, smem, s);
    case 314: return launch<3, 1, 4, ACT>(a, grid, smem, s);
    case 322: return launch<3, 2, 2, ACT>(a, grid, smem, s);
    case 324: return launch<3, 2, 4, ACT>(a, grid, smem, s);
    case 512: return launch<5, 1, 2, ACT>(a, grid, smem, s);
    case 514: return launch<5, 1, 4, ACT>(a, grid, smem, s);
    case 522: return launch<5, 2, 2, ACT>(a, grid, smem, s);
    default: return launch<5, 2, 4, ACT>(a, grid, smem, s);
  }
}

}  // namespace ievm

// x, w, w_scale, bias, out: device pointers (see DwArgs); act: DW_SILU or
// DW_RELU6; the plan (cg, bh, nb, p, vec, smem) is ops/dwconv_int8.py:dw_plan's,
// with vec lowered to the alignment of x. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments, an act code or a plan
// the kernel does not take.
extern "C" int ievm_dwconv_int8(const void* x, const void* w, const void* w_scale,
                                const void* bias, void* out, int N, int H, int W, int C, int k,
                                int stride, int act, int zp_s, float in_scale, double rs_out,
                                float out_zp, int cg, int bh, int nb, int p, int vec, int smem,
                                void* stream) {
  using namespace ievm;
  if ((k != 3 && k != 5) || (stride != 1 && stride != 2) || (p != 2 && p != 4) || N <= 0 ||
      H <= 0 || W <= 0 || C <= 0 || (act != DW_SILU && act != DW_RELU6))
    return (int)cudaErrorInvalidValue;
  const int pad = (k - 1) / 2;
  const int Ho = (H + 2 * pad - k) / stride + 1, Wo = (W + 2 * pad - k) / stride + 1;
  if (Ho <= 0 || Wo <= 0 || cg < 4 || cg > DWE_MAX_GROUP || cg % 4 != 0 || bh < 1 || bh > Ho ||
      nb < 1)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && ((vec != 4 && vec != 8 && vec != 16) || C % vec != 0 || cg % vec != 0 ||
                   reinterpret_cast<uintptr_t>(x) % vec != 0))
    return (int)cudaErrorInvalidValue;
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 4 != 0) return (int)cudaErrorInvalidValue;
  const int rh = ((bh + DWE_ROWS - 1) / DWE_ROWS * DWE_ROWS - 1) * stride + k;
  const int runs = (Wo + p - 1) / p, wp = (runs * p - 1) * stride + k;
  const int bands = (Ho + bh - 1) / bh, groups = (C + cg - 1) / cg;
  if ((long long)N * bands > 0x7fffffffLL || nb > N * bands || groups > 65535 ||
      smem != DwLayout(k, cg, rh, wp, nb).total || smem > DWE_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const DwArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                 static_cast<const float*>(w_scale), static_cast<const float*>(bias),
                 static_cast<int8_t*>(out), N, H, W, C, Ho, Wo, pad, zp_s, in_scale, out_zp,
                 rs_out, cg, bh, nb, vec, rh, wp, bands};
  const dim3 grid((N * bands + nb - 1) / nb, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = k * 100 + stride * 10 + p;
  return (int)(act == DW_RELU6 ? launch_act<DW_RELU6>(key, a, grid, smem, s)
                               : launch_act<DW_SILU>(key, a, grid, smem, s));
}
