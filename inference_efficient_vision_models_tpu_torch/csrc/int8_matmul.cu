// int8_matmul_requant on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/int8_matmul.py:int8_matmul_requant.
//
// out (M, N) = act/requant(X (M, K) . W (K, N)) with the affine-int8 epilogue
// of int8_gemm.cuh (affine_y, act_t). X is shifted-quint8 int8, or
// fp32/bf16 that the kernel quantizes as rint(x / s_x) + zp, clip, -128, the
// quotient correctly rounded as the JAX quantize takes it, so the int8 copy
// of a float activation never exists in device memory.
//
// What bounds it on an H100: every served call is bound by bytes, not by the
// tensor cores. The ViT's calls (M = 197 B tokens, K = 192 or 768) do about
// one int8 multiply-add per byte moved against the card's ~590 ops/byte
// balance point, and their output (fp32/bf16, 576 or 768 wide) is the
// largest stream; the ResNet's im2col calls read a patch matrix of K = 9 C
// bytes per row; the EfficientNet stem (K = 27) reads 27 bytes and writes 32
// per row. What the design does about it:
//
// - Each byte moves once, each float is quantized once. A block owns 128-row
//   slices of X, 64 rows per consumer warpgroup, and a group of N tiles. A
//   warpgroup loads its (64, K) panel once per slice, with 16-byte loads
//   where row stride and pointer allow (contiguous 64-row runs for short
//   int8 rows such as the stem's K = 27, 4-byte or element loads for the
//   ResNet's K = 504), quantizes a float input on the
//   way in and writes the 128-byte-swizzled K-major layout wgmma reads; it
//   then walks all its N tiles against that panel. There is one N group
//   whenever M has at least one 128-row slice per SM.
// - Weights by TMA. W is packed once as (Np, Kp) int8, K contiguous: the
//   K-major operand 8-bit wgmma needs. A producer warp streams BN x 128-byte
//   tiles through a ring of 2-6 stages with mbarriers; ragged N and K edges
//   come from TMA's zero fill. The tensor map is encoded once per weight
//   (ievm_int8_weight_tensor_map) and cached beside it.
// - wgmma m64 x BN x k32 (s8.s8 -> s32), A and B from shared memory, BN in
//   {64, 128, 192, 256}, k32 steps past K skipped (the stem's K = 27 takes
//   one of four); setmaxnreg moves registers from the producer to the
//   consumers. One kernel instance per BN and loader kind (int8 vectors,
//   fp32, bf16, contiguous int8 rows), so no instance carries the registers
//   of a loader it never runs.
// - Latency is hidden by overlap more than by occupancy (one block per SM,
//   two at BN = 64): the blocks are persistent over M, and the two consumer
//   warpgroups share only the weight ring and start staggered, so one loads
//   or stores while the other multiplies.
// - The served calls are issue-bound once the bytes move once, so the
//   per-element arithmetic is cut to fp32 work without conversions, and
//   stays bit-identical to the plain version: the quantize multiplies by
//   RN(1 / s) and redoes the rare values near a rounding tie with the exact
//   double quotient (quant_byte); rint and the float-to-byte conversions add
//   2^23-scale constants (clip_byte, requant_byte); the GELU's reciprocal is
//   an approximate one with one Newton step whose exact residual shows when
//   it is not correctly rounded (rcp_ge1_fast). The rare redo paths run after
//   the branch-free loops.
// - Large K: where the whole panel does not fit beside the ring, a warpgroup
//   loads it in windows of K chunks for each tile (int8 inputs with K = 9 C
//   up to 2016).
// - Epilogue per 64-column slice: w_scale, bias and w_sum come from shared
//   memory (loaded once per block), y = acc * scale + bias (and ReLU) is
//   staged in shared memory, GELU and the conversion to int8 or bf16 run as
//   a second pass over it, and full rows leave with 16-byte stores where N
//   allows.
// - The dynamic route (a per-batch activation scale, torch quantize_dynamic
//   semantics; the dynamic INT8 ViT's dense layers): the input qparams are
//   found on the device by the caller and passed as a pointer to
//   {RN_f64(1 / s), s, zp_s}, which each thread reads once per block in place
//   of the scalar arguments (GemmArgs::qp, null for the static route), so no
//   launch waits for the host. The same instances run it: the loaders and
//   the epilogue are the static route's, bit for bit.
// The pipeline (blocks, rings, wgmma, persistent slices, staged epilogue) is
// panel_gemm.cuh's, shared with the direct 3x3 conv; this file holds the
// panel loaders of a matrix X and the epilogue's second pass. The tile plan
// is chosen by ops/int8_matmul.py:tile_plan and checked here (plan_ok).
#include <string.h>

#include "panel_gemm.cuh"

namespace ievm {

struct MatmulArgs : GemmArgs {
  const void* x;
  int vec;  // elements per load (int8 16/4/1, 0 contiguous rows; fp32 4/1; bf16 8/2/1)
  double inv_in;  // RN_f64(1 / in_scale), for div_rn_by
};

// What the panel loaders read, held in registers: read from the kernel's
// arguments, every field would be reloaded after each shared-memory store.
struct PanelSrc {
  const uint8_t* x;
  int M, K, vec;
  float zp;       // the unshifted zero point
  double inv_in;  // RN_f64(1 / in_scale)
  float rs;       // RN_f32(inv_in)
};

// E <= 16 values val(0..E-1) quantized into the first E / 4 words of o,
// bytes at k0 + e >= K or in a dead row zero. The rare values quant_byte cannot settle are redone
// after the loop, so the loop itself has no branch.
template <int E, typename Val>
__device__ __forceinline__ void quantize_run(Val val, bool live, int k0, int K, const PanelSrc& a,
                                             uint32_t (&o)[4]) {
  static_assert(E % 4 == 0 && E <= 16, "E values fill whole words of o");
  uint32_t redo = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    bool rd;
    const uint32_t byte = quant_byte(val(e), a.rs, a.zp, rd);
    const bool in = live && k0 + e < K;
    o[e / 4] |= (in ? byte : 0u) << (8 * (e % 4));
    redo |= (uint32_t)(in && rd) << e;
  }
  if (redo) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (redo >> e & 1u)
        o[e / 4] = (o[e / 4] & ~(0xffu << (8 * (e % 4)))) |
                   quant_byte_exact(val(e), a.inv_in, a.zp) << (8 * (e % 4));
  }
}

// The 16 elements of X at row m, columns k0..k0+15, as raw words; zero
// outside the matrix. W elements per load; K % W == 0.
template <int ESZ, int W>
__device__ __forceinline__ void load_unit(const uint8_t* __restrict__ p, int k0, int K, bool row_ok,
                                          uint32_t (&w)[4 * ESZ]) {
  constexpr int VB = ESZ * W;
  static_assert(VB == 16 || VB == 4 || VB == 2 || VB == 1, "unsupported load width");
#pragma unroll
  for (int i = 0; i < 4 * ESZ; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < 16; i += W) {
    if (row_ok && k0 + i < K) {
      const uint8_t* q = p + i * ESZ;
      const int b = i * ESZ;
      if constexpr (VB == 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(q);
        w[b / 4] = v.x;
        w[b / 4 + 1] = v.y;
        w[b / 4 + 2] = v.z;
        w[b / 4 + 3] = v.w;
      } else if constexpr (VB == 4) {
        w[b / 4] = *reinterpret_cast<const uint32_t*>(q);
      } else if constexpr (VB == 2) {
        w[b / 4] |= (uint32_t)*reinterpret_cast<const uint16_t*>(q) << (8 * (b % 4));
      } else {
        w[b / 4] |= (uint32_t)*q << (8 * (b % 4));
      }
    }
  }
}

// 16 int8 panel bytes from a unit: copied (int8) or quantized (fp32/bf16) as
// clip(rint(x / s) + zp, 0, 255) - 128; zero at k >= K.
// The float at element e of raw words w: fp32 (ESZ 4) or bf16 (ESZ 2).
template <int ESZ, int N>
__device__ __forceinline__ float raw_val(const uint32_t (&w)[N], int e) {
  if constexpr (ESZ == 4)
    return __uint_as_float(w[e]);
  else
    return __uint_as_float(e % 2 ? (w[e / 2] & 0xffff0000u) : (w[e / 2] << 16));
}

template <int ESZ>
__device__ __forceinline__ uint4 pack_unit(const PanelSrc& a, const uint32_t (&w)[4 * ESZ], int k0) {
  if constexpr (ESZ == 1) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    quantize_run<16>([&](int e) { return raw_val<ESZ>(w, e); }, true, k0, a.K, a, o);
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <int ESZ, int W>
__device__ __forceinline__ void load_chunk(const PanelSrc& a, int m0w, int kc,
                                           uint32_t (&w)[4][4 * ESZ]) {
  const uint8_t* x = a.x;
  const int lt = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = lt + 128 * j;  // row u / 8, K bytes (u % 8) * 16 .. +15
    const int m = m0w + (u >> 3);
    const int k0 = kc * KS + (u & 7) * 16;
    load_unit<ESZ, W>(x + ((size_t)m * a.K + k0) * ESZ, k0, a.K, m < a.M, w[j]);
  }
}

template <int ESZ>
__device__ __forceinline__ void store_chunk(const PanelSrc& a, uint8_t* dst, int m0w, int kc,
                                            const uint32_t (&w)[4][4 * ESZ]) {
  const int lt = threadIdx.x & 127;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = lt + 128 * j;
    *reinterpret_cast<uint4*>(dst + swz128(u >> 3, (u & 7) * 16)) =
        m0w + (u >> 3) < a.M ? pack_unit<ESZ>(a, w[j], kc * KS + (u & 7) * 16)
                             : make_uint4(0u, 0u, 0u, 0u);  // rows past M: nothing to quantize
  }
}

// A warpgroup's half of panel chunks [0, nc): K bytes [c0 * 128, (c0 + nc) * 128)
// of rows m0w..m0w+63, swizzled. Each thread moves 4 units of 16 bytes per
// chunk, all loads before the first store.
template <int ESZ, int W>
__device__ __forceinline__ void load_panel_t(const PanelSrc& a, uint8_t* half, int m0w, int c0,
                                             int nc) {
  for (int c = 0; c < nc; ++c) {
    uint32_t w[4][4 * ESZ];
    load_chunk<ESZ, W>(a, m0w, c0 + c, w);
    store_chunk<ESZ>(a, half + c * CHUNK, m0w, c0 + c, w);
  }
}

// Float rows that allow 16-byte copies (the served ViT and fc inputs): the
// panel goes through a ring of four 4 KB raw slots in `raw` (16- or 8-row
// pieces of a chunk), filled by cp.async three pieces ahead of the one being
// quantized, so that the loads overlap the conversions instead of waiting
// for them. A thread quantizes 32 raw bytes (16 bf16 or 8 fp32 values).
template <int ESZ>
__device__ __forceinline__ void load_panel_async(const PanelSrc& a, uint8_t* half, uint8_t* raw,
                                                 int m0w, int c0, int nc) {
  constexpr int SLOT = 4096, SLOTS = 4;
  constexpr int ROW = KS * ESZ;           // raw bytes of one row of a chunk
  constexpr int ROWS = SLOT / ROW;        // rows per piece: bf16 16, fp32 8
  constexpr int PER_CHUNK = 64 / ROWS;    // pieces per chunk
  constexpr int E = 32 / ESZ;             // values a thread quantizes per piece
  const int lt = threadIdx.x & 127;
  const int bar = BAR_WG0 + (threadIdx.x >> 7);
  // 2^lg pieces a chunk, enough for the rows below M: rows past M are never
  // stored, so their panel rows may keep what they held
  const int rows = max(min(64, a.M - m0w), 1);
  const int lg = min(32 - __clz((rows + ROWS - 1) / ROWS - 1), 31 - __clz(PER_CHUNK));
  const int pieces = nc << lg;
  auto issue = [&](int s) {
    if (s < pieces) {
      const int kc = c0 + (s >> lg), r0 = (s & ((1 << lg) - 1)) * ROWS;
      uint8_t* slot = raw + (s % SLOTS) * SLOT;
#pragma unroll
      for (int q = lt; q < SLOT / 16; q += 128) {
        const int r = q / (ROW / 16), col = q % (ROW / 16);
        const int m = m0w + r0 + r, k = kc * KS + col * (16 / ESZ);
        const bool ok = m < a.M && k < a.K;
        cp_async16(slot + q * 16, ok ? a.x + ((size_t)m * a.K + k) * ESZ : a.x, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < SLOTS - 1; ++s) issue(s);
  for (int s = 0; s < pieces; ++s) {
    cp_async_wait<SLOTS - 2>();  // this thread's copies of piece s have landed
    named_bar(bar, 128);         // everyone's have, and piece s - 1 is quantized
    issue(s + SLOTS - 1);
    const int kc = s >> lg, row = (s & ((1 << lg) - 1)) * ROWS + lt * 32 / ROW;
    const int kb = (lt * 32 % ROW) / ESZ;  // first value within the chunk
    const uint8_t* src = raw + (s % SLOTS) * SLOT + lt * 32;
    const uint4 v0 = *reinterpret_cast<const uint4*>(src);
    const uint4 v1 = *reinterpret_cast<const uint4*>(src + 16);
    const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    quantize_run<E>([&](int e) { return raw_val<ESZ>(w, e); }, m0w + row < a.M, (c0 + kc) * KS + kb,
                    a.K, a, o);
    uint8_t* dst = half + kc * CHUNK + swz128(row, kb);
    if constexpr (ESZ == 4)
      *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  }
  cp_async_wait<0>();
}

// int8 rows whose K (<= 128) breaks 16-byte alignment (the EfficientNet
// stem's 27, the 1x1 downsample's 56): the 64 rows are one contiguous run of
// at most 8 KB. flat_fetch reads it as 16-byte pieces into registers (a
// slice ahead); flat_store puts them in `scratch` and gathers each row's
// units inside K into the panel, whose other units stay zero from the start.
__device__ __forceinline__ void flat_fetch(const PanelSrc& a, int m0w, uint4 (&v)[4]) {
  const int lt = threadIdx.x & 127;
  const int total = max(0, min(64, a.M - m0w)) * a.K;
  const uint8_t* src = a.x + (size_t)max(m0w, 0) * a.K;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = (lt + 128 * q) * 16;
    if (i + 16 <= total) {
      v[q] = *reinterpret_cast<const uint4*>(src + i);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (i + e < total) w[e / 4] |= (uint32_t)src[i + e] << (8 * (e % 4));
      v[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void flat_store(const PanelSrc& a, uint8_t* half, uint8_t* scratch,
                                           int m0w, const uint4 (&v)[4]) {
  const int lt = threadIdx.x & 127;
  const int rows = min(64, a.M - m0w);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = (lt + 128 * q) * 16;
    if (i < rows * a.K) *reinterpret_cast<uint4*>(scratch + i) = v[q];
  }
  named_bar(BAR_WG0 + (threadIdx.x >> 7), 128);
  const int units = (a.K + 15) >> 4;  // 16-byte units of a row inside K
  for (int u = lt; u < 64 * units; u += 128) {
    const int r = u / units, kb = (u - r * units) * 16;
    uint4 o = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {  // bytes r K + kb .. + 15 of the run, by aligned words and funnel shifts
      const int s0 = r * a.K + kb, sh = (s0 & 3) * 8, valid = min(16, a.K - kb);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(scratch + (s0 & ~3));
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int keep = min(max(valid - 4 * i, 0), 4);  // bytes of word i inside K
        x[i] = __funnelshift_r(w[i], w[i + 1], sh) & (keep == 4 ? 0xffffffffu : (1u << (8 * keep)) - 1u);
      }
      o = make_uint4(x[0], x[1], x[2], x[3]);
    }
    *reinterpret_cast<uint4*>(half + swz128(r, kb)) = o;
  }
}

// The loaders a kernel instance holds (its XK): int8 rows by vectors, fp32
// or bf16 rows quantized, or short int8 rows as one contiguous run.
constexpr int XK_I8 = 0, XK_F32 = 1, XK_BF16 = 2, XK_FLAT = 3;

template <int XK>
__device__ __forceinline__ void load_panel(const PanelSrc& a, uint8_t* half, uint8_t* raw, int m0w, int c0,
                                           int nc) {
  if constexpr (XK == XK_I8) {
    if (a.vec == 16)
      load_panel_t<1, 16>(a, half, m0w, c0, nc);
    else if (a.vec == 4)
      load_panel_t<1, 4>(a, half, m0w, c0, nc);
    else
      load_panel_t<1, 1>(a, half, m0w, c0, nc);
  } else if constexpr (XK == XK_F32) {
    if (a.vec == 4)
      load_panel_async<4>(a, half, raw, m0w, c0, nc);
    else
      load_panel_t<4, 1>(a, half, m0w, c0, nc);
  } else if constexpr (XK == XK_BF16) {
    if (a.vec == 8)
      load_panel_async<2>(a, half, raw, m0w, c0, nc);
    else if (a.vec == 2)
      load_panel_t<2, 2>(a, half, m0w, c0, nc);
    else
      load_panel_t<2, 1>(a, half, m0w, c0, nc);
  }
}

// The second pass of a slice: the GELUs and every int8 or bf16 conversion.
// None is left for an fp32 output without GELU (ReLU is the first pass's).
template <int OUT>
__device__ __forceinline__ void finish_slice_act(const MatmulArgs& a, float zpm, const uint8_t* fst,
                                                 uint8_t* ost) {
  if (a.act == ACT_GELU)
    finish_slice<ACT_GELU, OUT>(a.inv_out, zpm, fst, ost);
  else if (a.act == ACT_GELU_TANH)
    finish_slice<ACT_GELU_TANH, OUT>(a.inv_out, zpm, fst, ost);
  else if constexpr (OUT != OUT_F32)
    finish_slice<ACT_NONE, OUT>(a.inv_out, zpm, fst, ost);
}

// A consumer thread's side of kernel A: the panel loader of its XK and the
// second pass of the epilogue (panel_gemm's Job).
template <int XK>
struct MatmulJob {
  static constexpr bool STAGED_Y = true;   // GELU and conversions run as a second pass
  static constexpr bool RESIDENT = false;  // the ring streams the weights for every slice
  static constexpr bool OVERLAP = false;   // each chunk's wgmmas finish before the next
  const MatmulArgs& a;
  const PanelSrc src;
  uint4 run[4];  // XK_FLAT: the next slice's rows, loaded while this one is multiplied and stored

  // src.rs = RN_f32(inv_in): a device conversion rounds to nearest. The
  // dynamic route (args.qp) reads inv_in and zp_s from the device buffer.
  __device__ __forceinline__ explicit MatmulJob(const MatmulArgs& args)
      : a(args),
        src{static_cast<const uint8_t*>(args.x), args.M, args.K, args.vec,
            (float)(zp_s_of(args) + 128), args.qp ? args.qp[0] : args.inv_in,
            static_cast<float>(args.qp ? args.qp[0] : args.inv_in)} {}

  __device__ __forceinline__ void begin(uint8_t* half, int m0w) {
    if constexpr (XK == XK_FLAT) {
      flat_fetch(src, m0w, run);
      for (int i = (threadIdx.x & 127) * 16; i < 64 * KS; i += 128 * 16)
        *reinterpret_cast<uint4*>(half + i) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void load(uint8_t* half, uint8_t* scratch, int m0w, int c0, int nc) {
    if constexpr (XK == XK_FLAT) {
      flat_store(src, half, scratch, m0w, run);
      flat_fetch(src, m0w + (int)gridDim.x * BM, run);
    } else {
      load_panel<XK>(src, half, scratch, m0w, c0, nc);
    }
  }

  __device__ __forceinline__ void tile(int, int) {}
  __device__ __forceinline__ void wait() {}

  template <int TN>
  __device__ __forceinline__ void store(const int (&acc)[TN / 2], uint8_t* stg, const float* ps,
                                        const float* pb, const int* pc, int m0w, int n0) {
    const bool second = a.out_kind != OUT_F32 || a.act == ACT_GELU || a.act == ACT_GELU_TANH;
    store_tile<TN>(a, acc, stg, ps, pb, pc, m0w, n0, second,
                   [&](float zpm, const uint8_t* fst, uint8_t* ost, int, int) {
                     if (a.out_kind == OUT_I8)
                       finish_slice_act<OUT_I8>(a, zpm, fst, ost);
                     else if (a.out_kind == OUT_F32)
                       finish_slice_act<OUT_F32>(a, zpm, fst, ost);
                     else
                       finish_slice_act<OUT_BF16>(a, zpm, fst, ost);
                   });
  }
};

// a 64-wide tile leaves room for two blocks per SM (tile_plan)
template <int TN>
constexpr int matmul_blocks = TN == 64 ? 2 : 1;

template <int TN, int XK>
__global__ void __launch_bounds__(A_THREADS, matmul_blocks<TN>)
    matmul_sm90_kernel(const __grid_constant__ CUtensorMap wmap, const MatmulArgs a) {
  panel_gemm<TN, matmul_blocks<TN>, MatmulJob<XK>>(wmap, a);
}

template <int TN, int XK>
int launch(const CUtensorMap& map, const MatmulArgs& a, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;  // the opt-in to more than 48 KB, once per kernel
  return launch_panel_gemm(matmul_sm90_kernel<TN, XK>, attr_set, map, a, grid, smem, s);
}

template <int TN>
int launch_xk(int xk, const CUtensorMap& map, const MatmulArgs& a, dim3 grid, int smem, cudaStream_t s) {
  switch (xk) {
    case XK_I8:
      return launch<TN, XK_I8>(map, a, grid, smem, s);
    case XK_F32:
      return launch<TN, XK_F32>(map, a, grid, smem, s);
    case XK_BF16:
      return launch<TN, XK_BF16>(map, a, grid, smem, s);
    default:
      return launch<TN, XK_FLAT>(map, a, grid, smem, s);
  }
}

}  // namespace ievm

// The TMA descriptor of a packed weight (Np, Kp) int8, K contiguous: boxes
// of 64 rows x 128 bytes, 128-byte swizzle, zero fill outside. Writes the
// 128-byte CUtensorMap to map_out. Returns 0, a cudaError_t, or 1000 + the
// CUresult of the encode.
extern "C" int ievm_int8_weight_tensor_map(const void* wt, int Np, int Kp, void* map_out) {
  ievm::sm90::TensorMapEncode encode;
  const cudaError_t e = ievm::sm90::tensor_map_encoder(&encode);
  if (e != cudaSuccess) return (int)e;
  if (Np <= 0 || Kp <= 0 || Kp % 16 != 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)Kp, (cuuint64_t)Np};
  const cuuint64_t strides[1] = {(cuuint64_t)Kp};
  const cuuint32_t box[2] = {(cuuint32_t)ievm::KS, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt), dims, strides,
                            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  memcpy(map_out, &map, sizeof(map));
  return 0;
}

// x_kind: 0 int8, 1 fp32, 2 bf16.  out_kind / act: see int8_gemm.cuh.  wmap:
// the weight's tensor map (ievm_int8_weight_tensor_map).  inv_in: 1 / in_scale
// in double.  bn, grid_m, groups, tiles_per_group, stages, window: the tile
// plan (ops/int8_matmul.py:tile_plan).  qp: null, or (the dynamic route, a
// float input and a float output) the device buffer {inv_in, in_scale, zp_s}
// that replaces zp_s, in_scale and inv_in.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ievm_int8_matmul_requant(const void* x, int x_kind, const void* wmap, const void* w_scale,
                                        const void* bias, const void* w_sum, void* out, int out_kind,
                                        int act, int M, int K, int N, int zp_s, int out_zp,
                                        float in_scale, float inv_out, double inv_in, int bn,
                                        int grid_m, int groups, int tiles_per_group, int stages,
                                        int window, const void* qp, void* stream) {
  using namespace ievm;
  int smem;
  if (x_kind < 0 || x_kind > 2 || act < 0 || act > 3 ||
      (qp != nullptr && (x_kind == 0 || out_kind == OUT_I8 || reinterpret_cast<uintptr_t>(qp) % 8)) ||
      !plan_ok(M, K, N, out_kind, true, bn, grid_m, groups, tiles_per_group, stages, window, &smem))
    return (int)cudaErrorInvalidValue;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  int vec;  // 0: int8 rows read as one contiguous run (flat_fetch)
  if (x_kind == 0)
    vec = (K % 16 == 0 && xp % 16 == 0) ? 16
          : (K <= KS && xp % 16 == 0) ? 0
          : (K % 4 == 0 && xp % 4 == 0) ? 4 : 1;
  else if (x_kind == 1)
    vec = (K % 4 == 0 && xp % 16 == 0) ? 4 : 1;
  else
    vec = (K % 8 == 0 && xp % 16 == 0) ? 8 : (K % 2 == 0 && xp % 4 == 0) ? 2 : 1;
  CUtensorMap map;
  memcpy(&map, wmap, sizeof(map));
  const MatmulArgs a{{static_cast<const float*>(w_scale), static_cast<const float*>(bias),
                      static_cast<const int*>(w_sum), out, M, K, N, out_kind, act, zp_s, out_zp,
                      in_scale, inv_out, tiles_per_group, stages, window, (K + KS - 1) / KS,
                      static_cast<const double*>(qp)},
                     x, vec, inv_in};
  const dim3 grid(grid_m, groups);
  const int xk = x_kind == 0 && vec == 0 ? XK_FLAT : x_kind;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 64:
      return launch_xk<64>(xk, map, a, grid, smem, s);
    case 128:
      return launch_xk<128>(xk, map, a, grid, smem, s);
    case 192:
      return launch_xk<192>(xk, map, a, grid, smem, s);
    default:
      return launch_xk<256>(xk, map, a, grid, smem, s);
  }
}
