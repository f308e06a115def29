// conv3x3_s1_int8 on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/conv3x3.py:conv3x3_s1_int8.
//
// 3x3, stride 1, same-padded int8 conv on NHWC activations as an implicit
// GEMM: M = N*H*W output pixels, K = 9*C (tap-major, then channel, the order
// of an HWIO kernel reshaped to (9C, O)), N = O, on the Hopper pipeline of
// panel_gemm.cuh that kernel A runs on (wgmma over a shared-memory A panel,
// TMA weight tiles from the same (Np, Kp) pack, persistent blocks). What
// this file adds is the A panel loader and the epilogues:
//
// - The panel loader gathers each row's K = 9C bytes straight from the
//   activation tensor into the 128-byte-swizzled panel by cp.async, once per
//   slice (not once per N tile); a tap outside the image writes the shifted
//   zero point zp_s, so neither the halo nor im2col patches are ever
//   materialised. A thread always fills the same 16 bytes of K of four rows,
//   so the tap and channel of a piece are computed once for the four rows.
//   Pieces are 16 bytes where C % 16 == 0 (C = 112, 224), 8 where C % 8 == 0
//   (C = 56, 456): a piece never crosses a tap; 4-byte pieces, and bytes
//   through registers, serve other C.
// - An int8 output is converted in registers from the accumulators (no fp32
//   staging): requant(relu?(y)) through 1/s_y as kernel A's epilogue, or,
//   with the block's identity (its int8 input, dequantized as (q - zp_s) * s,
//   or the fp32 output of the downsample), the end of a ResNet basic block,
//     out = clip(rint(max(y + id, 0) / s_out) + zp_out, 0, 255) - 128
//   with y the conv's fp32 epilogue and the quotient correctly rounded, the
//   executor's unfused sequence (qresnet.py apply_int8), so the block's fp32
//   sum never reaches device memory. The identity rows are asked into L2 as
//   each tile starts and loaded without branches.
// - One N tile whose K chunks fit in the ring keeps its weights resident
//   (stage 1), and each chunk's wgmmas start before the previous chunk's end.
//
// Bound on an H100: 2*M*9C*O int8 ops against M*C + M*O*out bytes (plus the
// identity). At the ResNet18 serving widths every call does 45.3 G int8 ops
// (0.023 ms at the tensor cores' peak). What holds it above that: at stage 1
// (C = O = 56, N 64 wide) wgmma with both operands in shared memory needs
// about the SM's whole shared-memory bandwidth, which the gather and the
// epilogue share, so their times add (the 64-wide tile runs two blocks per
// SM); at stages 3-4 the K = 2016 / 4104 panel streams in windows, each
// loaded while its warpgroup waits, and stage 4 has 98 row slices x 2 N
// tiles for 132 SMs.
#include <string.h>

#include "panel_gemm.cuh"

namespace ievm {

enum ResKind { RES_NONE = 0, RES_I8 = 1, RES_F32 = 2 };

struct ConvArgs : GemmArgs {
  const uint8_t* x;
  const void* res;  // the identity, (nb, H, W, O) int8 (shifted) or fp32
  int H, W, C;
  int vec;          // bytes per activation load: 16, 8, 4 or 1 (C % vec == 0, x aligned to vec)
  int res_kind;
  int res_zp_s;     // its shifted zero point (RES_I8)
  float res_scale;  // its scale (RES_I8)
  double inv_out_d; // RN_f64(1 / s_out): the residual requant's division (div_rn_by)
};

// What the panel loader reads, held in registers.
struct ConvSrc {
  const uint8_t* x;
  int M, H, W, C, K;
  uint32_t zpw;  // the shifted zero point in every byte of a word
};

// V bytes of `word` (every byte of it the same, V = 4, 8, 16) at d.
template <int V>
__device__ __forceinline__ void set_piece(uint8_t* d, uint32_t word) {
  if constexpr (V == 16)
    *reinterpret_cast<uint4*>(d) = make_uint4(word, word, word, word);
  else if constexpr (V == 8)
    *reinterpret_cast<uint2*>(d) = make_uint2(word, word);
  else
    *reinterpret_cast<uint32_t*>(d) = word;
}

// A warpgroup's panel chunks [c0, c0 + nc) of output pixels m0w..m0w+63,
// swizzled. Thread lt fills bytes kb = 16 (lt % 8) .. +15 of K chunk c of
// rows lt / 8 + 16 j (j < 4): 16 / V pieces of V bytes, each inside one tap
// (C % V == 0), the tap and channel taken once per piece for the four rows.
// A piece inside the image is copied by cp.async (V = 4, 8, 16; nothing
// waits for it until ConvJob::wait), one outside is set to zp_s, one past K
// to zero. V = 1 (C not a multiple of 4) gathers bytes through registers.
template <int V>
__device__ __forceinline__ void conv_panel(const ConvSrc& s, uint8_t* half, int m0w, int c0, int nc) {
  const int lt = threadIdx.x & 127, kb = (lt & 7) * 16;
  const int hw = s.H * s.W;
  int ph[4], pw[4];
  const uint8_t* px[4];  // the pixel's channel 0
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0w + (lt >> 3) + 16 * j;
    const int rem = m % hw, h = rem / s.W;
    const bool ok = m < s.M;
    ph[j] = ok ? h : -2;  // past M: every tap outside the image (the row is never stored)
    pw[j] = rem - h * s.W;
    px[j] = s.x + (size_t)(ok ? m : 0) * s.C;
  }
  for (int c = 0; c < nc; ++c) {
    const int k0 = (c0 + c) * KS + kb;
    uint8_t* chunk = half + c * CHUNK;
    uint32_t w[4][4] = {};  // V = 1: the 16 bytes of each row, then one store
#pragma unroll
    for (int p = 0; p < 16 / V; ++p) {
      const int k = k0 + p * V;
      const int tap = k / s.C, ch = k - tap * s.C;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool kin = k < s.K;
      const long off = ((long)dy * s.W + dx) * s.C + ch;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = kin && (unsigned)(ph[j] + dy) < (unsigned)s.H &&
                        (unsigned)(pw[j] + dx) < (unsigned)s.W;
        if constexpr (V == 1) {
          const uint32_t b = in ? (uint32_t)px[j][off] : (kin ? s.zpw & 0xffu : 0u);
          w[j][p / 4] |= b << (8 * (p % 4));
        } else {
          uint8_t* d = chunk + swz128((lt >> 3) + 16 * j, kb) + p * V;
          if (in)
            cp_async_ca<V>(d, px[j] + off);
          else
            set_piece<V>(d, kin ? s.zpw : 0u);
        }
      }
    }
    if constexpr (V == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint4*>(chunk + swz128((lt >> 3) + 16 * j, kb)) =
            make_uint4(w[j][0], w[j][1], w[j][2], w[j][3]);
    }
  }
  if constexpr (V != 1) cp_async_commit();
}

// The identity of accumulator pair (m, n), (m, n + 1) of a residual
// epilogue, as fp32: (q - zp_s) * s of the int8 input (observers.py
// dequantize_affine_shifted) or the fp32 tensor's values. Rows and columns
// past the edge read a clamped address (their outputs are never stored), so
// the loads carry no branch and a thread's loads all fly together.
template <int RK>
__device__ __forceinline__ float2 identity2(const ConvArgs& a, int m, int n) {
  const size_t e0 = (size_t)min(m, a.M - 1) * a.N;
  const size_t i0 = e0 + min(n, a.N - 1), i1 = e0 + min(n + 1, a.N - 1);
  if constexpr (RK == RES_I8) {
    const int8_t* p = static_cast<const int8_t*>(a.res);
    return make_float2(__fmul_rn(__int2float_rn((int)p[i0] - a.res_zp_s), a.res_scale),
                       __fmul_rn(__int2float_rn((int)p[i1] - a.res_zp_s), a.res_scale));
  } else {
    const float* p = static_cast<const float*>(a.res);
    return make_float2(p[i0], p[i1]);
  }
}

// The quantized byte of t >= 0 with the quotient correctly rounded:
// quant_byte, redone exactly in the rare case it cannot settle.
__device__ __forceinline__ uint32_t quant_div_byte(float t, float rs, double inv_d, float zp) {
  bool redo;
  const uint32_t b = quant_byte(t, rs, zp, redo);
  return redo ? quant_byte_exact(t, inv_d, zp) : b;
}

// A warpgroup's 64 x TN accumulators -> int8 out rows m0w.., columns n0.., in
// 64-column slices, converted in registers: y = acc * scale + bias, then
// either requant(relu?(y)) through 1/s_y (RK = RES_NONE, kernel A's
// epilogue) or, ending a basic block, clip(rint(max(y + id, 0) / s_out) +
// zp_out, 0, 255) - 128 with a true division. The bytes go to the staging
// rows, then leave as full rows. The identity of a slice's 16 pairs is loaded
// in two groups of eight before the arithmetic that needs it.
template <int TN, int RK>
__device__ __forceinline__ void store_int8(const ConvArgs& a, const int (&acc)[TN / 2], uint8_t* ost,
                                           const float* ps, const float* pb, const int* pc, int m0w,
                                           int n0) {
  constexpr int row_b = stage_row(OUT_I8);
  const int bar = BAR_WG0 + (threadIdx.x >> 7);
  const bool relu = a.act == ACT_RELU;
  const float zpm = RINT_MAGIC - (float)a.out_zp, zp = (float)a.out_zp;
  const float rs = static_cast<float>(a.inv_out_d);  // RN, as every device conversion
#pragma unroll
  for (int j = 0; j < TN / 64; ++j) {
    const int nc0 = n0 + 64 * j;
    if (nc0 >= a.N) break;
#pragma unroll
    for (int h = 0; h < 32; h += 16) {
      float2 id[8];
      if constexpr (RK != RES_NONE) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          id[q] = identity2<RK>(a, m0w + acc_row(h + 2 * q), nc0 + acc_col(h + 2 * q));
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = h + 2 * q;
        if (64 * j + (i >> 2) * 8 >= a.N - n0) break;  // 8-column groups past N: nothing to store
        const int col = acc_col(i), c = 64 * j + col;
        const float y0 = affine_y(acc[32 * j + i] - pc[c], ps[c], pb[c]);
        const float y1 = affine_y(acc[32 * j + i + 1] - pc[c + 1], ps[c + 1], pb[c + 1]);
        uint32_t b0, b1;
        if constexpr (RK == RES_NONE) {
          b0 = requant_byte(relu_if(relu, y0), a.inv_out, zpm);
          b1 = requant_byte(relu_if(relu, y1), a.inv_out, zpm);
        } else {
          b0 = quant_div_byte(fmaxf(__fadd_rn(y0, id[q].x), 0.f), rs, a.inv_out_d, zp);
          b1 = quant_div_byte(fmaxf(__fadd_rn(y1, id[q].y), 0.f), rs, a.inv_out_d, zp);
        }
        *reinterpret_cast<uint16_t*>(ost + acc_row(i) * row_b + col) = (uint16_t)(b0 | b1 << 8);
      }
    }
    named_bar(bar, 128);
    store_rows(a, ost, m0w, nc0);
    named_bar(bar, 128);
  }
}

// A consumer thread's side of kernel B (panel_gemm's Job): the panel is
// gathered by cp.async, the identity of a residual epilogue is asked into L2
// as the tile starts (its loads then wait on L2, not on device memory), and
// an int8 output is converted in registers (no fp32 staging).
struct ConvJob {
  static constexpr bool STAGED_Y = false;
  static constexpr bool RESIDENT = true;
  static constexpr bool OVERLAP = true;
  const ConvArgs& a;
  const ConvSrc src;
  const int vec;

  __device__ __forceinline__ explicit ConvJob(const ConvArgs& args)
      : a(args),
        src{args.x, args.M, args.H, args.W, args.C, args.K, (uint32_t)(uint8_t)args.zp_s * 0x01010101u},
        vec(args.vec) {}

  __device__ __forceinline__ void begin(uint8_t*, int) {}

  // The identity rows m0w..m0w+63 of the tile, whole rows (all N columns:
  // contiguous), asked into L2 by one thread of the warpgroup.
  __device__ __forceinline__ void tile(int m0w, int) {
    if (a.res_kind == RES_NONE || (threadIdx.x & 127) != 0 || m0w >= a.M) return;
    const size_t row = (size_t)a.N * (a.res_kind == RES_F32 ? 4 : 1);
    const size_t at = (size_t)m0w * row, end = min((size_t)(m0w + 64), (size_t)a.M) * row;
    const size_t lo = (at + 15) & ~(size_t)15, hi = end & ~(size_t)15;  // whole 16-byte units inside
    if (hi > lo && (reinterpret_cast<uintptr_t>(a.res) & 15) == 0)
      prefetch_l2(static_cast<const uint8_t*>(a.res) + lo, (uint32_t)(hi - lo));
  }

  __device__ __forceinline__ void load(uint8_t* half, uint8_t*, int m0w, int c0, int nc) {
    if (vec == 16)
      conv_panel<16>(src, half, m0w, c0, nc);
    else if (vec == 8)
      conv_panel<8>(src, half, m0w, c0, nc);
    else if (vec == 4)
      conv_panel<4>(src, half, m0w, c0, nc);
    else
      conv_panel<1>(src, half, m0w, c0, nc);
  }

  __device__ __forceinline__ void wait() { cp_async_wait<0>(); }

  template <int TN>
  __device__ __forceinline__ void store(const int (&acc)[TN / 2], uint8_t* stg, const float* ps,
                                        const float* pb, const int* pc, int m0w, int n0) {
    if (a.out_kind == OUT_F32)
      store_tile<TN>(a, acc, stg, ps, pb, pc, m0w, n0, false, [](float, const uint8_t*, uint8_t*, int, int) {});
    else if (a.res_kind == RES_I8)
      store_int8<TN, RES_I8>(a, acc, stg, ps, pb, pc, m0w, n0);
    else if (a.res_kind == RES_F32)
      store_int8<TN, RES_F32>(a, acc, stg, ps, pb, pc, m0w, n0);
    else
      store_int8<TN, RES_NONE>(a, acc, stg, ps, pb, pc, m0w, n0);
  }
};

// A 64-wide tile is built for two blocks per SM (conv3x3_plan gives it a
// ring and panel that fit twice when they can), the wider ones for one.
template <int TN>
constexpr int conv_blocks = TN == 64 ? 2 : 1;

template <int TN>
__global__ void __launch_bounds__(A_THREADS, conv_blocks<TN>)
    conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap wmap, const ConvArgs a) {
  panel_gemm<TN, conv_blocks<TN>, ConvJob>(wmap, a);
}

template <int TN>
int launch(const CUtensorMap& map, const ConvArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;  // the opt-in to more than 48 KB, once per kernel
  return launch_panel_gemm(conv3x3_sm90_kernel<TN>, attr_set, map, a, grid, smem, s);
}

}  // namespace ievm

// x (nb, H, W, C) int8 NHWC; wmap: the tensor map of the packed weight
// (ievm_int8_weight_tensor_map in the int8_matmul library); out (nb, H, W, O)
// int8 or fp32. res_kind 0: out = requant/ReLU of the conv as kernel A's
// epilogue; 1 / 2: the residual epilogue with res (nb, H, W, O) int8 of scale
// res_scale and shifted zero point res_zp_s, or fp32 (int8 out, relu 0).
// inv_out_d: 1 / s_out in double. bn .. window: the tile plan
// (ops/conv3x3.py:conv3x3_plan). Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int ievm_conv3x3_s1_int8(const void* x, const void* wmap, const void* w_scale, const void* bias,
                                    const void* w_sum, void* out, int out_kind, int relu, int nb, int H,
                                    int W, int C, int O, int zp_s, int out_zp, float in_scale,
                                    float inv_out, const void* res, int res_kind, int res_zp_s,
                                    float res_scale, double inv_out_d, int bn, int grid_m, int groups,
                                    int tiles_per_group, int stages, int window, void* stream) {
  using namespace ievm;
  const long long M = (long long)nb * H * W, K = 9LL * C;
  int smem;
  if (nb <= 0 || H <= 0 || W <= 0 || M > 0x7fffffffLL || K > 0x7fffffffLL || out_kind < 0 ||
      out_kind > 1 || res_kind < 0 || res_kind > 2 ||
      (res_kind != RES_NONE && (out_kind != OUT_I8 || relu || res == nullptr)) ||
      !plan_ok((int)M, (int)K, O, out_kind, false, bn, grid_m, groups, tiles_per_group, stages, window,
               &smem))
    return (int)cudaErrorInvalidValue;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const int vec = (C % 16 == 0 && xp % 16 == 0)  ? 16
                  : (C % 8 == 0 && xp % 8 == 0) ? 8
                  : (C % 4 == 0 && xp % 4 == 0) ? 4
                                                : 1;
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  const ConvArgs a{{static_cast<const float*>(w_scale), static_cast<const float*>(bias),
                    static_cast<const int*>(w_sum), out, (int)M, (int)K, O, out_kind,
                    relu ? ACT_RELU : ACT_NONE, zp_s, out_zp, in_scale, inv_out, tiles_per_group,
                    stages, window, (int)((K + KS - 1) / KS)},
                   static_cast<const uint8_t*>(x), res, H, W, C, vec, res_kind, res_zp_s,
                   res_scale, inv_out_d};
  const dim3 grid(grid_m, groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return launch<64>(map, a, grid, smem, s);
    case 128:
      return launch<128>(map, a, grid, smem, s);
    case 192:
      return launch<192>(map, a, grid, smem, s);
    default:
      return launch<256>(map, a, grid, smem, s);
  }
}
