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
// MACs; the GEMMs never are. Past the bound, the per-element epilogues (a
// SiLU and a requant for every expanded and every depthwise value, some 25
// fp32 instructions each) are what the card spends its time on.
//
// Design. The TPU kernel keeps a whole image's expanded map in VMEM; on
// Hopper a block has at most 227 KB of shared memory, and the SE gate needs a
// mean over the whole image, which blocks cannot share. So the block is
// split around that reduction, into three launches:
//
//  1. expand_dw: one CUDA block per (spatial output tile, CT expanded
//     channels, image). It recomputes the 1x1 expand on the halo'd input
//     tile and keeps the hidden map in shared memory as one byte per value:
//     the requantized quint8 q in [0, 255] (the shifted input x + 128 for a
//     block without expand), pixels outside the image holding the hidden
//     zero e_zp (or zp_s_in + 128). The depthwise conv then sums
//     w * (q - e_zp) in fp32: each product and partial sum is an integer
//     below 2^24 (|w| <= 128, 25 taps), so every order gives the plain
//     version's value. The byte map is 4x smaller than an fp32 one, which
//     buys tiles of up to 56 KB of map (28 x 28 outputs at stride 1, k 3),
//     so less of the expand is recomputed on the halo, and three blocks per
//     SM, so one block's expand overlaps another's depthwise. Choices, made
//     by ops/fused_mbconv.py:expand_dw_plan and checked here:
//     - CT = 32 or 48 channels, whichever pads Ce least (32 on a tie);
//     - the tile side that minimises expand-plus-depthwise work over the
//       map limit (halo recompute against ragged edges).
//     The expand runs on mma.sync m16n8k32 with K padded only to 32, its A
//     fragments read straight from the input rows (the next tile's first
//     k-step loaded before this one's epilogue), its B tile in shared
//     memory; each warp applies act + requant to its own fragments, eight
//     values at a time, and writes byte pairs into map rows of CT + 4 bytes.
//     The depthwise thread owns 4 channels (one map word) of 4 adjacent
//     outputs along x: it reads each map word of a row once for every tap
//     that uses it, turns the 4
//     bytes into q - e_zp with one byte permute and one subtraction each,
//     takes 4-channel weight vectors from shared memory, and writes the 4
//     requantized channels of a pixel as one 32-bit store. Both epilogues
//     (a SiLU and a requant per value) are what the launch spends its time
//     on, so they avoid slow paths: rint and the byte conversion are
//     magic-constant additions (int8_gemm.cuh requant_u8), and SiLU's
//     reciprocal is division-free and exact (rcp_ge1_fast, the rare
//     unsettled values redone after the loop: act_requant). A faster SiLU
//     (ex2.approx, rcp.approx, exact redo near rounding ties) was slower:
//     with a provable margin, half the warps took the redo branch. The
//     block adds sum(yq_d - d_zp) per (image, channel) into an int32 buffer
//     with one atomic per channel: an integer sum, exact and the same in
//     any order.
//  2. se_gate: a group of images per block (ops/fused_mbconv.py:se_gate_group),
//     each SE weight read once per block and coalesced, the two SE FCs and
//     their activations in float64 from that exact sum, rounded to fp32 once
//     (the plain version does the same, so the two agree whatever order each
//     sums in).
//  3. project: persistent blocks that own row panels and all of Co (or half),
//     yq arriving by cp.async through a ring in shared memory, transformed
//     there once per byte into requant(dequant(yq_d) * g) in the plain
//     version's order, then wgmma and an epilogue that adds the residual,
//     requantizes and stores whole rows (its note is at the launch).
//
// The expanded hidden tensor thus makes one int8 round trip through device
// memory (yq_d written once, read once), where the unfused op chain makes
// five; a block without SE runs launches 1 and 3.
// Numerics follow the Pallas kernel: multiply by the inv_* scalars, rintf
// (half to even), __fmul_rn/__fadd_rn so nvcc cannot contract, SiLU as
// y * (1 / (1 + expf(-y))). Build without --use_fast_math.
#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace ievm {

using namespace sm90;

enum MbAct { MB_SILU = 0, MB_RELU6 = 1 };

// q[i] = clip(rint(act(y[i]) * inv) + zp, 0, 255) as bytes, bit for bit as
// the plain version takes it (zpm = RINT_MAGIC - zp): ReLU6, or SiLU as
// y * RN(1 / RN(1 + expf(-y))) with the reciprocals by rcp_ge1_fast (1 +
// e^-y >= 1, or +inf) and the rare unsettled ones redone after the loop.
template <int NV>
__device__ __forceinline__ void act_requant(const float (&y)[NV], int act, float inv, float zpm,
                                            uint32_t (&q)[NV]) {
  static_assert(NV <= 32, "one redo bit per value");
  if (act != MB_SILU) {
#pragma unroll
    for (int i = 0; i < NV; ++i) q[i] = requant_u8(fminf(fmaxf(y[i], 0.f), 6.f), inv, zpm);
    return;
  }
  float t[NV];
  uint32_t redo = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    bool rd;
    t[i] = rcp_ge1_fast(__fadd_rn(1.0f, expf(-y[i])), rd);
    redo |= (uint32_t)rd << i;
  }
  if (redo) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (redo >> i & 1u) t[i] = rcp_rn_ge1(__fadd_rn(1.0f, expf(-y[i])));
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) q[i] = requant_u8(__fmul_rn(y[i], t[i]), inv, zpm);
}

// ---------------------------------------------------------------------------
// launch 1: expand + depthwise
// ---------------------------------------------------------------------------

constexpr int DW_THREADS = 256;
constexpr int DW_P = 4;        // adjacent outputs along x per depthwise thread
constexpr int MAP_PAD = 4;     // bytes after the CT of a map row
constexpr int DW_SMEM_LIMIT = 232448;

struct Pass1Args {
  const int8_t* x;
  const int8_t* we;  // packed (Np, Kp_e) or null: no expand
  int Kp_e;
  const float* ve;   // (2, Ce)
  const float* wdw;  // (k*k, Ce), integer-valued
  const float* vdw;  // (2, Ce)
  int8_t* yq;        // (N, Ho, Wo, Ce)
  int* pool;         // (N, Ce) or null: no SE
  int H, W, Cin, Ce, Ho, Wo, pad, act, vec;
  int TH, TW, RH, RW, tiles_x, kc;  // kc: the expand's K, Cin rounded up to 32
  float map_zp;  // the byte of a hidden zero: e_zp, or zp_s_in + 128 without expand
  float inv_e, inv_d, d_zp;
};

// Byte offsets in the dynamic shared memory; ops/fused_mbconv.py:expand_dw_smem
// computes the same total: the map (R rows of CT + 4 bytes), the expand's B
// tile (CT rows of kc + 16 bytes), the depthwise weights (k*k x CT fp32),
// ve0, ve1, vdw0, vdw1 (CT fp32 each) and the pool sums (CT int32).
struct DwLayout {
  int wexp, wdw, vec, pool, total;
  __host__ __device__ DwLayout(int R, int ct, int kc, int k, bool expand)
      : wexp((R * (ct + MAP_PAD) + 15) & ~15),
        wdw(wexp + (expand ? ct * (kc + 16) : 0)),
        vec(wdw + k * k * ct * 4),
        pool(vec + 4 * ct * 4),
        total(pool + ct * 4) {}
};

// 4 bytes of row p from byte k, zero at k + i >= lim (vec: lim % 4 == 0 and p aligned).
__device__ __forceinline__ uint32_t load4(const int8_t* p, int k, int lim, int vec) {
  if (vec) return k < lim ? *reinterpret_cast<const uint32_t*>(p + k) : 0u;
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < lim) v |= (uint32_t)(uint8_t)p[k + i] << (8 * i);
  return v;
}

// The map from the expand: each warp takes 16-row tiles of the region's R
// pixels, multiplies them by the CT-column B tile (mma.sync m16n8k32), and
// writes act + requant of its fragments as byte pairs; pixels outside the
// image get the hidden zero.
template <int CT>
__device__ __forceinline__ void expand_tile(const Pass1Args& a, uint8_t* map, const uint8_t* wexp,
                                            const float* ve0, const float* ve1, int n, int iy0, int ix0) {
  constexpr int NT = CT / 8, CTP = CT + MAP_PAD;
  const int krow = a.kc + 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
  const int R = a.RH * a.RW;
  const uint32_t zp = (uint32_t)(int)a.map_zp;
  const float zpm = __fsub_rn(RINT_MAGIC, a.map_zp);
  // the fragment rows of m-tile mt: region pixels mt * 16 + gid and + 8
  auto rows_of = [&](int mt, const int8_t* (&rowp)[2], bool (&inside)[2], int (&rows)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + gid + 8 * h;
      const int ry = r / a.RW, rx = r - ry * a.RW;
      const int iy = iy0 + ry, ix = ix0 + rx;
      rows[h] = r;
      inside[h] = r < R && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W;
      rowp[h] = a.x + (inside[h] ? (((long long)n * a.H + iy) * a.W + ix) * a.Cin : 0);
    }
  };
  // A fragment words of k-step ks: a0 row gid, a1 row gid + 8; a2, a3 16 bytes further along K
  auto frag = [&](const int8_t* const (&rowp)[2], const bool (&inside)[2], int ks, uint32_t (&af)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      af[q] = inside[q & 1] ? load4(rowp[q & 1], ks + tig * 4 + (q >> 1) * 16, a.Cin, a.vec) : 0u;
  };
  const int8_t* rowp[2];
  bool inside[2];
  int rows[2];
  uint32_t next[4];  // the first k-step of the next m-tile, loaded before this one's epilogue
  rows_of(warp, rowp, inside, rows);
  frag(rowp, inside, 0, next);
  for (int mt = warp; mt * 16 < R; mt += DW_THREADS / 32) {
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    for (int ks = 0; ks < a.kc; ks += 32) {
      uint32_t af[4];
      if (ks == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) af[q] = next[q];
      } else {
        frag(rowp, inside, ks, af);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* bp = wexp + (nt * 8 + gid) * krow + ks + tig * 4;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(bp),
                                *reinterpret_cast<const uint32_t*>(bp + 16)};
        mma_s8(acc[nt], af, bf);
      }
    }
    const int cur_rows[2] = {rows[0], rows[1]};
    const bool cur_inside[2] = {inside[0], inside[1]};
    rows_of(mt + DW_THREADS / 32, rowp, inside, rows);
    frag(rowp, inside, 0, next);
    // acc[nt][e]: row gid + 8 (e >= 2), column nt * 8 + 2 tig + (e & 1); act
    // and requant in groups of two n-tiles, which bounds the live registers
#pragma unroll
    for (int g = 0; g < NT; g += 2) {
      float y[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int nt = g + u / 4, e = u % 4, col = nt * 8 + tig * 2 + (e & 1);
        y[u] = __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][e]), ve0[col]), ve1[col]);
      }
      uint32_t qv[8];
      act_requant(y, a.act, a.inv_e, zpm, qv);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (cur_rows[h] >= R) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t q0 = cur_inside[h] ? qv[t * 4 + 2 * h] : zp;
          const uint32_t q1 = cur_inside[h] ? qv[t * 4 + 2 * h + 1] : zp;
          *reinterpret_cast<uint16_t*>(map + cur_rows[h] * CTP + (g + t) * 8 + tig * 2) =
              (uint16_t)(q0 | q1 << 8);
        }
      }
    }
  }
}

// The map of a block without expand: x + 128 (the byte x ^ 0x80), the hidden
// zero outside the image.
template <int CT>
__device__ __forceinline__ void copy_tile(const Pass1Args& a, uint8_t* map, int n, int iy0, int ix0,
                                          int c0) {
  constexpr int CW = CT / 4, CTP = CT + MAP_PAD;
  const uint32_t zw = (uint32_t)(int)a.map_zp * 0x01010101u;
  const int R = a.RH * a.RW;
  for (int i = threadIdx.x; i < R * CW; i += DW_THREADS) {
    const int m = i / CW, cw = i - m * CW, c = c0 + cw * 4;
    const int ry = m / a.RW, rx = m - ry * a.RW;
    const int iy = iy0 + ry, ix = ix0 + rx;
    uint32_t v = zw;
    if (c < a.Ce && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W) {
      const int8_t* p = a.x + (((long long)n * a.H + iy) * a.W + ix) * a.Cin;
      if (a.vec) {
        v = *reinterpret_cast<const uint32_t*>(p + c) ^ 0x80808080u;
      } else {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          if (c + ch < a.Cin)
            v = (v & ~(0xffu << (8 * ch))) | ((uint32_t)((uint8_t)p[c + ch] ^ 0x80u) << (8 * ch));
      }
    }
    *reinterpret_cast<uint32_t*>(map + m * CTP + cw * 4) = v;
  }
}

// The depthwise conv of the tile from the map, act, requant, yq stores and the
// block's pool sums. Thread: channels 4 cw .. 4 cw + 3 (fixed), runs of DW_P
// outputs along x.
template <int K, int S, int CT>
__device__ __forceinline__ void depthwise_tile(const Pass1Args& a, const uint8_t* map, const float* wdw_s,
                                               const float* s0v, const float* s1v, int* pool_s, int n,
                                               int oy0, int ox0, int c0) {
  constexpr int CW = CT / 4, CTP = CT + MAP_PAD, NW = (DW_P - 1) * S + K;
  const int cw = threadIdx.x % CW, g = threadIdx.x / CW, groups = DW_THREADS / CW;
  if (g >= groups) return;
  const int c = c0 + cw * 4;
  const int nrun = (a.TW + DW_P - 1) / DW_P;
  const float magic = __fadd_rn(8388608.f, a.map_zp);  // 2^23 + zp: (2^23 + q) - magic = q - zp
  const float zpm = __fsub_rn(RINT_MAGIC, a.d_zp);
  const int d_zp = (int)a.d_zp;
  const float4 s0 = *reinterpret_cast<const float4*>(s0v + cw * 4);
  const float4 s1 = *reinterpret_cast<const float4*>(s1v + cw * 4);
  const float sc0[4] = {s0.x, s0.y, s0.z, s0.w}, sc1[4] = {s1.x, s1.y, s1.z, s1.w};
  int psum[4] = {0, 0, 0, 0};
  for (int run = g; run < a.TH * nrun; run += groups) {
    const int py = run / nrun, px0 = (run - py * nrun) * DW_P;
    const int oy = oy0 + py;
    if (oy >= a.Ho) continue;
    float acc[DW_P][4];
#pragma unroll
    for (int p = 0; p < DW_P; ++p)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) acc[p][ch] = 0.f;
    const int lim = a.RW - px0 * S;  // map words left in a region row
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const uint8_t* row = map + ((py * S + dy) * a.RW + px0 * S) * CTP + cw * 4;
      float v[NW][4];
#pragma unroll
      for (int u = 0; u < NW; ++u) {
        const uint32_t wd = u < lim ? *reinterpret_cast<const uint32_t*>(row + u * CTP) : 0u;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          v[u][ch] = __fsub_rn(__uint_as_float(__byte_perm(wd, 0x4B000000u, 0x7540 + ch)), magic);
      }
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const float4 w4 = *reinterpret_cast<const float4*>(wdw_s + (dy * K + dx) * CT + cw * 4);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int p = 0; p < DW_P; ++p)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) acc[p][ch] = fmaf(v[p * S + dx][ch], w[ch], acc[p][ch]);
      }
    }
    // act, requant and stores two outputs at a time, which bounds the live registers
    uint32_t qv[8];
#pragma unroll
    for (int p = 0; p < DW_P; ++p) {
      if (p % 2 == 0) {
        float y[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          y[u] = __fadd_rn(__fmul_rn(acc[p + u / 4][u % 4], sc0[u % 4]), sc1[u % 4]);
        act_requant(y, a.act, a.inv_d, zpm, qv);
      }
      const int ox = ox0 + px0 + p;
      if (px0 + p >= a.TW || ox >= a.Wo) continue;
      uint32_t word = 0;
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const uint32_t q = qv[(p % 2) * 4 + ch];
        word |= (q ^ 0x80u) << (8 * ch);
        if (c + ch < a.Ce) psum[ch] += (int)q - d_zp;
      }
      int8_t* o = a.yq + (((long long)n * a.Ho + oy) * a.Wo + ox) * a.Ce + c;
      if ((a.Ce & 3) == 0) {
        if (c < a.Ce) *reinterpret_cast<uint32_t*>(o) = word;
      } else {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          if (c + ch < a.Ce) o[ch] = (int8_t)(word >> (8 * ch));
      }
    }
  }
  if (a.pool != nullptr) {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      if (psum[ch] != 0) atomicAdd(&pool_s[cw * 4 + ch], psum[ch]);
  }
}

// Three blocks per SM (80 registers a thread): the phases of one block
// overlap another's. Measured against two blocks (128 registers, no
// spills), three win at every B0 block shape but one, and overall by 12%,
// though ptxas spills up to 32 bytes in some instances.
template <int K, int S, int CT>
__global__ void __launch_bounds__(DW_THREADS, 3) expand_dw_kernel(const Pass1Args a) {
  extern __shared__ __align__(16) uint8_t dw_smem[];
  const bool expand = a.we != nullptr;
  const DwLayout L(a.RH * a.RW, CT, a.kc, K, expand);
  uint8_t* map = dw_smem;
  uint8_t* wexp = dw_smem + L.wexp;
  float* wdw_s = reinterpret_cast<float*>(dw_smem + L.wdw);
  float* ve0 = reinterpret_cast<float*>(dw_smem + L.vec);
  float* ve1 = ve0 + CT;
  float* s0v = ve1 + CT;
  float* s1v = s0v + CT;
  int* pool_s = reinterpret_cast<int*>(dw_smem + L.pool);
  const int tid = threadIdx.x;
  const int n = blockIdx.z, c0 = blockIdx.y * CT;
  const int ty = blockIdx.x / a.tiles_x, tx = blockIdx.x - ty * a.tiles_x;
  const int oy0 = ty * a.TH, ox0 = tx * a.TW;
  const int iy0 = oy0 * S - a.pad, ix0 = ox0 * S - a.pad;

  for (int i = tid; i < CT; i += DW_THREADS) {
    const bool ok = c0 + i < a.Ce;
    ve0[i] = ok && expand ? a.ve[c0 + i] : 0.f;
    ve1[i] = ok && expand ? a.ve[a.Ce + c0 + i] : 0.f;
    s0v[i] = ok ? a.vdw[c0 + i] : 0.f;
    s1v[i] = ok ? a.vdw[a.Ce + c0 + i] : 0.f;
    pool_s[i] = 0;
  }
  for (int i = tid; i < K * K * CT; i += DW_THREADS) {
    const int t = i / CT, j = i - t * CT;
    wdw_s[i] = c0 + j < a.Ce ? a.wdw[t * a.Ce + c0 + j] : 0.f;
  }
  if (expand) {
    const int units = a.kc / 16, krow = a.kc + 16;
    for (int i = tid; i < CT * units; i += DW_THREADS) {
      const int r = i / units, u = i - r * units;
      *reinterpret_cast<uint4*>(wexp + r * krow + u * 16) =
          c0 + r < a.Ce ? *reinterpret_cast<const uint4*>(a.we + (size_t)(c0 + r) * a.Kp_e + u * 16)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
  if (expand)
    expand_tile<CT>(a, map, wexp, ve0, ve1, n, iy0, ix0);
  else
    copy_tile<CT>(a, map, n, iy0, ix0, c0);
  __syncthreads();
  depthwise_tile<K, S, CT>(a, map, wdw_s, s0v, s1v, pool_s, n, oy0, ox0, c0);
  if (a.pool != nullptr) {
    __syncthreads();
    if (tid < CT && c0 + tid < a.Ce) atomicAdd(&a.pool[(long long)n * a.Ce + c0 + tid], pool_s[tid]);
  }
}

template <int K, int S, int CT>
cudaError_t launch_expand_dw(const Pass1Args& a, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;  // the opt-in to more than 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(expand_dw_kernel<K, S, CT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  expand_dw_kernel<K, S, CT><<<grid, DW_THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_expand_dw_ct(int ct, const Pass1Args& a, dim3 grid, int smem, cudaStream_t s) {
  return ct == 32 ? launch_expand_dw<K, S, 32>(a, grid, smem, s) : launch_expand_dw<K, S, 48>(a, grid, smem, s);
}

// ---------------------------------------------------------------------------
// launch 2: the SE gate, a group of images per block, float64
// ---------------------------------------------------------------------------
//
// Its bound is a few microseconds: reading the two SE weights (Ce x Se fp32
// each) and 2 N Ce Se float64 multiply-adds. A block of G images reads each
// weight once and uses it G times (ops/fused_mbconv.py:se_gate_group). The
// weights stream through a ring of SE_STAGES chunks of about 32 KB
// (cp.async), srw's chunks then sew's, so the block keeps ~96 KB of reads in
// flight; a thread that reads them itself, one float per step, waits one L2
// round trip per step, which is what held the launch before.
// - FC1 (srw, Ce x Se): thread (row group q, column j) of the R = 512 / Se
//   groups sums the chunk's rows q, q + R, ... of column j for its G images;
//   the R partial sums of a column are then added in group order.
// - FC2 (sew, Se x Ce): each thread owns channels c, tid + 512, ..., whose
//   sums for the G images live in shared memory across chunks.
// Measured on the H100 (port_block_launches.py --ablate): at B0's 7 x 7
// blocks the launch takes ~22 us; taking out FC1's or FC2's multiply-adds,
// the weight copies or the sigmoid saves 2-5 us each. What is left is the
// latency of the block's float64 chains and phases, one block per SM; 1024
// threads a block, one stream per weight, or both FCs on the float64 tensor
// cores (mma m8n8k4, 8 images a block, FC2's channels split over blocks:
// 0.23 against 0.18 ms over B0's 16 launches) measured no faster.

constexpr int SE_THREADS = 512;
constexpr int SE_MAX_SQUEEZE = 256;  // FC1 gives each of Se columns a thread per row group
constexpr int SE_STAGES = 4;
constexpr int SE_CHUNK = 8192;  // floats a chunk takes at most, unless one row is longer

// Chunks and dynamic shared memory of a block of G images (ops/fused_mbconv.py
// se_gate_smem computes the same): the pooled means and FC2's sums (G x Ce
// doubles each), FC1's partial sums by row group (R x G x Se) and its
// activations (G x Se), then the ring.
struct SeLayout {
  int rows1, rows2, stage, part, r, acc, ring, total;
  __host__ __device__ SeLayout(int G, int Ce, int Se)
      : rows1(SE_CHUNK / Se >= 8 ? SE_CHUNK / Se / 4 * 4 : 4),  // FC1 rows a chunk (a multiple of 4)
        rows2(SE_CHUNK / Ce >= 1 ? SE_CHUNK / Ce : 1),            // FC2 rows a chunk
        stage(((rows1 * Se > rows2 * Ce ? rows1 * Se : rows2 * Ce) + 3) / 4 * 4),
        part(G * Ce * 8),
        r(part + (SE_THREADS / Se) * G * Se * 8),
        acc(r + G * Se * 8),
        ring((acc + G * Ce * 8 + 15) / 16 * 16),
        total(ring + SE_STAGES * stage * 4) {}
};

// One weight matrix streamed through the ring: rows [0, nrows) of (nrows,
// len) fp32 at src, `rows` a chunk, `nck` chunks, 16-byte copies when `v16`
// (the matrix 16-byte aligned, rows * len % 4 == 0), else 4-byte. Block b
// takes its chunks from chunk b mod nck on, wrapping around, so that the
// blocks' copies spread over L2.
struct SeStream {
  const float* src;
  int nrows, len, rows, nck, rot;
  bool v16;
  __device__ __forceinline__ SeStream(const float* s, int nr, int ln, int rw, bool v)
      : src(s), nrows(nr), len(ln), rows(rw), nck((nr + rw - 1) / rw), rot(blockIdx.x % nck), v16(v) {}
  __device__ __forceinline__ int first_row(int k) const { return (k + rot < nck ? k + rot : k + rot - nck) * rows; }
  __device__ __forceinline__ int rows_of(int k) const { return min(rows, nrows - first_row(k)); }
  __device__ __forceinline__ void copy(float* dst, int k) const {
    const int nf = rows_of(k) * len;
    const float* s = src + (size_t)first_row(k) * len;
    if (v16) {
      for (int e = threadIdx.x * 4; e < nf; e += SE_THREADS * 4) cp_async16(dst + e, s + e, min(16, (nf - e) * 4));
    } else {
      for (int e = threadIdx.x; e < nf; e += SE_THREADS) cp_async_ca<4>(dst + e, s + e);
    }
  }
};

template <int G>
__global__ void __launch_bounds__(SE_THREADS) se_gate_kernel(const int* __restrict__ pool,
                                                             const float* __restrict__ srw,
                                                             const float* __restrict__ srb,
                                                             const float* __restrict__ sew,
                                                             const float* __restrict__ seb,
                                                             float* __restrict__ g, int N, int Ce, int Se,
                                                             double pool_scale, int v16_1, int v16_2) {
  extern __shared__ __align__(16) uint8_t se_raw[];
  const SeLayout L(G, Ce, Se);
  double* pooled = reinterpret_cast<double*>(se_raw);       // [G][Ce]
  double* part = reinterpret_cast<double*>(se_raw + L.part);  // [R][G][Se]
  double* r = reinterpret_cast<double*>(se_raw + L.r);        // [G][Se]
  double* acc2 = reinterpret_cast<double*>(se_raw + L.acc);   // [G][Ce]
  float* ring = reinterpret_cast<float*>(se_raw + L.ring);
  const int R = SE_THREADS / Se;
  const int n0 = blockIdx.x * G, tid = threadIdx.x, gn = min(G, N - n0);
  // srw's chunks, then sew's, through one ring: sew's first chunks are in
  // flight while FC1 runs, and the first copies while the pooled sums load
  const SeStream fc1(srw, Ce, Se, L.rows1, v16_1), fc2(sew, Se, Ce, L.rows2, v16_2);
  const int nck = fc1.nck + fc2.nck;
  auto copy_chunk = [&](int k) {
    float* dst = ring + (k % SE_STAGES) * L.stage;
    if (k < fc1.nck)
      fc1.copy(dst, k);
    else if (k < nck)
      fc2.copy(dst, k - fc1.nck);
    cp_async_commit();
  };
  for (int k = 0; k + 1 < SE_STAGES; ++k) copy_chunk(k);
  for (int i = tid; i < G * Ce; i += SE_THREADS) {
    pooled[i] = i / Ce < gn ? (double)pool[(long long)n0 * Ce + i] * pool_scale : 0.0;
    acc2[i] = 0.0;
  }
  const int q = tid / Se, j = tid - q * Se;
  double acc[G];
#pragma unroll
  for (int im = 0; im < G; ++im) acc[im] = 0.0;
  for (int k = 0; k < nck; ++k) {
    cp_async_wait<SE_STAGES - 2>();
    __syncthreads();  // chunk k has landed; chunk k - 1's stage is free
    copy_chunk(k + SE_STAGES - 1);
    const float* w = ring + (k % SE_STAGES) * L.stage;
    if (k < fc1.nck) {
      const int c0 = fc1.first_row(k), nr = fc1.rows_of(k);
      if (q < R)
#pragma unroll 4
        for (int cl = q; cl < nr; cl += R) {
          const double wv = (double)w[cl * Se + j];
#pragma unroll
          for (int im = 0; im < G; ++im) acc[im] += pooled[im * Ce + c0 + cl] * wv;
        }
      continue;
    }
    if (k == fc1.nck) {  // FC1 done: its partial sums, in group order, and the SiLU
      if (q < R) {
#pragma unroll
        for (int im = 0; im < G; ++im) part[(q * G + im) * Se + j] = acc[im];
      }
      __syncthreads();
      for (int i = tid; i < G * Se; i += SE_THREADS) {
        const int im = i / Se, jj = i - im * Se;
        double sum = 0.0;
        for (int qq = 0; qq < R; ++qq) sum += part[(qq * G + im) * Se + jj];
        const double v = sum + (double)srb[jj];
        r[i] = v * (1.0 / (1.0 + exp(-v)));  // SiLU
      }
      __syncthreads();
    }
    const int j0 = fc2.first_row(k - fc1.nck), nr = fc2.rows_of(k - fc1.nck);
    for (int c = tid; c < Ce; c += SE_THREADS) {
      double sum[G];
#pragma unroll
      for (int im = 0; im < G; ++im) sum[im] = acc2[im * Ce + c];
#pragma unroll 4
      for (int jl = 0; jl < nr; ++jl) {
        const double wv = (double)w[jl * Ce + c];
#pragma unroll
        for (int im = 0; im < G; ++im) sum[im] += r[im * Se + j0 + jl] * wv;
      }
#pragma unroll
      for (int im = 0; im < G; ++im) acc2[im * Ce + c] = sum[im];
    }
  }
  cp_async_wait<0>();
  for (int c = tid; c < Ce; c += SE_THREADS) {
    const double b = (double)seb[c];
#pragma unroll
    for (int im = 0; im < G; ++im)
      if (im < gn) g[(long long)(n0 + im) * Ce + c] = (float)(1.0 / (1.0 + exp(-(acc2[im * Ce + c] + b))));
  }
}

template <int G>
cudaError_t launch_se_gate(const int* pool, const float* srw, const float* srb, const float* sew,
                           const float* seb, float* g, int N, int Ce, int Se, double pool_scale,
                           cudaStream_t s) {
  static bool attr_set = false;  // the opt-in to more than 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(se_gate_kernel<G>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const SeLayout L(G, Ce, Se);
  auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  se_gate_kernel<G><<<(N + G - 1) / G, SE_THREADS, L.total, s>>>(
      pool, srw, srb, sew, seb, g, N, Ce, Se, pool_scale, a16(srw) && L.rows1 * Se % 4 == 0,
      a16(sew) && L.rows2 * Ce % 4 == 0);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch 3: gated requant + project GEMM + residual + output requant
// ---------------------------------------------------------------------------
//
// The block's activations enter here as yq (M, Ce) int8 and leave as out
// (M, Co): the launch is bound by those bytes (and x_res's), never by its
// int8 operations. A block owns panels of BM = 64 rows and the columns n0 ..
// n0 + nb - 1 (all of Co, unless the plan splits Co across blocks where the
// panels alone would not fill the SMs). It is persistent:
// it walks its panels chunk by chunk, 128 bytes of K at a time, through a
// ring of `stages` units in shared memory. A unit is one chunk of the panel
// (16-byte cp.async straight into the 128-byte-swizzled rows wgmma reads,
// 8-, 4- or 1-byte pieces when Ce is not a multiple of 16), the gate of the
// panel's images for those channels (SE), the weight chunk (when the weights
// do not stay resident) and, with the panel's last chunk, its residual rows.
// (At Ce 32 three quarters of a 128-byte row go unused; a K-piece-major
// stage without swizzle, holding only the pieces Ce has, measured slower on
// the H100: 1.22 against 0.98 ms over B0's 16 launches.)
// So each byte of yq is read and transformed once, whatever Co. Block b
// takes a panel's chunks from chunk b mod nch on, wrapping around.
// - The transform runs in place, once per byte, in the plain version's
//   order: (yq - d_zp) * d_scale * g, the image of each row found by a
//   multiply and a shift (image_of), then the requant in the integer domain
//   (requant_zi: the float's bits less a constant, one DPX min-and-ReLU).
//   Without SE it depends on the byte alone: a 256-entry table built by the
//   same fp32 operations (requant_u8).
// - wgmma m64 x TN x k32 (s8.s8 -> s32) from shared memory: warpgroup wn
//   multiplies the panel by columns wn TN .. of the block (one warpgroup up
//   to 160 columns, two past). K is padded to 32 only (k-steps past kc are
//   skipped: the packed weight is zero past Ce), N to TN, the narrowest of
//   the s8 wgmma's widths that the served Co need (16, 24, 32, 48, 64, 80,
//   96, 112, 128, 160: B0's, MobileNetV2's and their pruned chains').
// - The weights of the block's columns stay in shared memory when they fit
//   (`resident`), else their chunk streams through the ring with A's.
// - The epilogue takes vp from shared memory (float2 pairs) and the residual
//   rows from the unit, converts the sums by a magic constant where Ce <=
//   256 (acc_float), requantizes by requant_zi and writes the int8 output
//   rows into shared memory; after the next unit's barrier the block stores
//   them as one contiguous span, 16 bytes a thread.
// - mma.sync is not used: wgmma reads both operands from shared memory, so
//   the transform writes the panel once and no warp loads fragments; the
//   launch's time is in the transform, the epilogue and the copies, not in
//   the MMA (taking the MMA out saves ~5-10%, port_block_launches.py
//   --ablate on the H100).
// The tile plan (TN, warpgroups along N, split, stages, residency, grid)
// comes from ops/fused_mbconv.py:project_plan; the host entry checks it.

constexpr int PJ_KS = 128;           // K bytes per chunk: one 128-byte-swizzled row
constexpr int PJ_BM = 64;            // rows a panel: one warpgroup's wgmma M
constexpr int PJ_THREADS = 256;      // at most two warpgroups, along N
constexpr int PJ_MAX_STAGES = 6;

struct ProjArgs {
  const int8_t* yq;     // (M, Ce)
  const float* g;       // (M / HWo, Ce) or null: no SE
  const int8_t* wp;     // packed (Np, Kp)
  const float* vp;      // (2, Co)
  const int8_t* x_res;  // (M, Co) or null
  int8_t* out;          // (M, Co)
  int M, HWo, nimg, Ce, Co, Np, Kp;  // nimg = M / HWo
  int kc, nch, nb, stages, resident, gi;  // gi: images a panel spans, at most
  int a_vec, g_vec, flat16;  // yq piece bytes (16, 8, 4, 1); gate piece bytes (16, 4); 16-byte spans
  unsigned hw_mul, hw_shift;  // x / HWo = (x * hw_mul) >> hw_shift for 0 <= x < 2^31
  float d_zp, d_scale, inv_q, q_zp, res_scale, res_zp_s, inv_o, o_zp;
};

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// The image of row m: m / HWo by a multiply (ceil(2^(31 + l) / HWo), l =
// ceil(log2 HWo), shifted by 31 + l), exact for every m < 2^31.
__device__ __forceinline__ int image_of(const ProjArgs& a, int m) {
  return (int)(((unsigned long long)(unsigned)m * a.hw_mul) >> a.hw_shift);
}

// Byte offsets in the (1024-aligned) dynamic shared memory, after the A ring
// (stages x BM x 128); ops/fused_mbconv.py:project_smem computes the same total.
struct ProjLayout {
  int w, gate, xres, outs, vec, lut, total;
  __host__ __device__ ProjLayout(const ProjArgs& a, bool se, bool res)
      : w(a.stages * PJ_BM * PJ_KS),
        gate(w + (a.resident ? a.nch : a.stages) * a.nb * PJ_KS),
        xres(gate + (se ? a.stages * a.gi * PJ_KS * 4 : 0)),
        outs(xres + (res ? a.stages * round16(PJ_BM * a.Co) : 0)),
        vec(outs + round16(PJ_BM * a.nb)),
        lut(vec + 8 * a.nb),
        total(lut + 256 + 1024) {}
};

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// A thread's share of a chunk whose rows hold kv bytes: the 16-byte piece at
// K byte kb of rows r0, r0 + step, ... (none past the pieces the threads cover).
struct PieceMap {
  int r0, kb, step;
  __device__ __forceinline__ explicit PieceMap(int kv) {
    const int npc = (kv + 15) >> 4, t = threadIdx.x;
    step = blockDim.x / npc;
    r0 = t / npc < step ? t / npc : 1 << 30;
    kb = (t - t / npc * npc) * 16;
  }
  __device__ __forceinline__ PieceMap(const PieceMap& a, const PieceMap& b, bool first)
      : r0(first ? a.r0 : b.r0), kb(first ? a.kb : b.kb), step(first ? a.step : b.step) {}
};

// Weight rows n0 .. n0 + nb - 1, K bytes 128 c .. up to kc, into a swizzled
// chunk; rows past Np are left as they are (their columns are never stored).
__device__ __forceinline__ void pj_load_weights(const ProjArgs& a, uint8_t* dst, int n0, int c) {
  const int kv = min(PJ_KS, a.kc - c * PJ_KS);
  for (int i = threadIdx.x; i < a.nb * 8; i += blockDim.x) {
    const int n = i >> 3, j = i & 7;
    if (j * 16 < kv && n0 + n < a.Np)
      cp_async16(dst + swz128(n, j * 16), a.wp + (size_t)(n0 + n) * a.Kp + c * PJ_KS + j * 16, 16);
  }
}

// Rows m0 .. m0 + rows - 1 of yq, K bytes 128 c .. up to Ce, into a swizzled
// chunk. Bytes past Ce keep what they held: the weight is zero there.
__device__ __forceinline__ void pj_load_a(const ProjArgs& a, const PieceMap& pm, uint8_t* dst, int m0, int rows,
                                          int c) {
  const int kv = min(PJ_KS, a.Ce - c * PJ_KS);
  const int8_t* src = a.yq + (size_t)m0 * a.Ce + c * PJ_KS;
  if (a.a_vec == 16) {
    for (int r = pm.r0; r < rows; r += pm.step) cp_async16(dst + swz128(r, pm.kb), src + (size_t)r * a.Ce + pm.kb, 16);
  } else if (a.a_vec == 8) {
    for (int i = threadIdx.x; i < rows * 16; i += blockDim.x) {
      const int r = i >> 4, kb = (i & 15) * 8;
      if (kb < kv) cp_async_ca<8>(dst + swz128(r, kb), src + (size_t)r * a.Ce + kb);
    }
  } else if (a.a_vec == 4) {
    for (int i = threadIdx.x; i < rows * 32; i += blockDim.x) {
      const int r = i >> 5, kb = (i & 31) * 4;
      if (kb < kv) cp_async_ca<4>(dst + swz128(r, kb), src + (size_t)r * a.Ce + kb);
    }
  } else {
    for (int i = threadIdx.x; i < rows * PJ_KS; i += blockDim.x) {
      const int r = i >> 7, kb = i & 127;
      if (kb < kv) dst[swz128(r, kb)] = (uint8_t)src[(size_t)r * a.Ce + kb];
    }
  }
}

// The gate of images n_a .. n_a + gi - 1, channels 128 c .. up to Ce: gi rows
// of 128 floats.
__device__ __forceinline__ void pj_load_gate(const ProjArgs& a, float* dst, int n_a, int c) {
  const int kv = min(PJ_KS, a.Ce - c * PJ_KS);
  for (int i = threadIdx.x; i < a.gi * 32; i += blockDim.x) {
    const int im = i >> 5, k = (i & 31) * 4, n = n_a + im;
    if (n >= a.nimg || k >= kv) continue;
    const float* src = a.g + (size_t)n * a.Ce + c * PJ_KS + k;
    if (a.g_vec == 16) {
      cp_async16(dst + im * PJ_KS + k, src, 16);
    } else {
      for (int e = 0; e < 4 && k + e < kv; ++e) cp_async_ca<4>(dst + im * PJ_KS + k + e, src + e);
    }
  }
}

// `bytes` from global to shared memory: 16-byte copies (the last one cut)
// where both ends are 16-byte aligned, else bytes.
__device__ __forceinline__ void pj_load_flat(uint8_t* dst, const int8_t* src, int bytes, bool v16) {
  if (v16) {
    for (int e = threadIdx.x * 16; e < bytes; e += blockDim.x * 16) cp_async16(dst + e, src + e, min(16, bytes - e));
  } else {
    for (int e = threadIdx.x; e < bytes; e += blockDim.x) dst[e] = (uint8_t)src[e];
  }
}

// clip(rint(y * inv) + zp, 0, 255) for an integer zp, zc = bits(RINT_MAGIC) - zp:
// the bits of v + RINT_MAGIC are bits(RINT_MAGIC) + rint(v) for |v| <= 2^22.
// v = y * inv is first raised to -2^22 (below the clip either way): further
// down, v + RINT_MAGIC would be a float whose bits, less zc, wrap past 2^31
// (v in (-3 * 2^23, -1.5 * 2^23)) or fall below 0. Above 2^22 the bits only
// grow, past the clip. One DPX min-and-ReLU clips the integer.
__device__ __forceinline__ uint32_t requant_zi(float y, float inv, int zc) {
  const float v = fmaxf(__fmul_rn(y, inv), -4194304.f);
  return (uint32_t)__vimin_s32_relu(__float_as_int(__fadd_rn(v, RINT_MAGIC)) - zc, 255);
}

// Four bytes of yq -> the project input, by the table.
__device__ __forceinline__ uint32_t lut4(const uint8_t* lut, uint32_t w) {
  return (uint32_t)lut[w & 255u] | (uint32_t)lut[(w >> 8) & 255u] << 8 | (uint32_t)lut[(w >> 16) & 255u] << 16 |
         (uint32_t)lut[w >> 24] << 24;
}

// Four bytes of yq and their gates -> requant((q - d_zp) * d_scale * g) - 128.
// dzm = 2^23 + d_zp (d_zp an integer): (2^23 + q) - dzm = q - d_zp exactly.
__device__ __forceinline__ uint32_t gate4(uint32_t w, float4 g4, float dzm, float d_scale, float inv_q,
                                          int zc_q) {
  w ^= 0x80808080u;  // the quint8 values q
  const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
  uint32_t b[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + e));  // 2^23 + q
    b[e] = requant_zi(__fmul_rn(__fmul_rn(__fsub_rn(q, dzm), d_scale), gv[e]), inv_q, zc_q);
  }
  return pack4(b[0], b[1], b[2], b[3]) ^ 0x80808080u;
}

// The chunk of a unit, in place: rows < rows, the 16-byte pieces up to Ce
// (the thread's share: pm); the panel starts in image n_a.
__device__ __forceinline__ void pj_transform(const ProjArgs& a, const PieceMap& pm, uint8_t* as, const float* gs,
                                             const uint8_t* lut, int m0, int rows, int n_a, float dzm,
                                             int zc_q) {
  for (int r = pm.r0; r < rows; r += pm.step) {
    uint4* p = reinterpret_cast<uint4*>(as + swz128(r, pm.kb));
    uint4 v = *p;
    if (gs == nullptr) {
      v = make_uint4(lut4(lut, v.x), lut4(lut, v.y), lut4(lut, v.z), lut4(lut, v.w));
    } else {
      const float4* gr = reinterpret_cast<const float4*>(gs + (image_of(a, m0 + r) - n_a) * PJ_KS + pm.kb);
      v = make_uint4(gate4(v.x, gr[0], dzm, a.d_scale, a.inv_q, zc_q),
                     gate4(v.y, gr[1], dzm, a.d_scale, a.inv_q, zc_q),
                     gate4(v.z, gr[2], dzm, a.d_scale, a.inv_q, zc_q),
                     gate4(v.w, gr[3], dzm, a.d_scale, a.inv_q, zc_q));
    }
    *p = v;
  }
}

// acc as a float: exactly 1.5 * 2^23 + v in the float's bits, less 1.5 *
// 2^23, where |v| <= 2^22 (`small`: Ce <= 256, |v| <= Ce 2^14), else I2F, an
// eighth of the fp32 rate.
__device__ __forceinline__ float acc_float(int v, bool small) {
  return small ? __fsub_rn(__int_as_float(v + 0x4B400000), RINT_MAGIC) : __int2float_rn(v);
}

// A warpgroup's accumulators -> output bytes of rows < rows, block columns <
// ncb, in the staging rows (ncb bytes apart): y = acc * vp0 + vp1 [+ (x_res -
// res_zp_s) * res_scale], requantized, as the plain version takes them. The
// fragment's column pairs go as pairs (vp as float2, residual and output
// bytes as 16-bit words where the row widths are even).
template <int TN>
__device__ __forceinline__ void pj_epilogue(const ProjArgs& a, const int (&acc)[TN / 2], const float* vp0,
                                            const float* vp1, const uint8_t* xs, uint8_t* ost, int rows,
                                            int ncb, int n0, int wn) {
  const int lt = threadIdx.x & 127;
  const int rb = (lt >> 5) * 16 + ((lt & 31) >> 2), cb = wn * TN + (lt & 3) * 2;
  const int zc_o = __float_as_int(RINT_MAGIC) - (int)a.o_zp;
  const bool small = a.Ce <= 256, x2 = (a.Co & 1) == 0, o2 = (ncb & 1) == 0;
#pragma unroll
  for (int i = 0; i < TN / 2; i += 2) {
    const int r = rb + 8 * ((i >> 1) & 1), col = cb + (i >> 2) * 8;
    if (r >= rows || col >= ncb) continue;
    const float2 s = *reinterpret_cast<const float2*>(vp0 + col);
    const float2 b = *reinterpret_cast<const float2*>(vp1 + col);
    float y0 = __fadd_rn(__fmul_rn(acc_float(acc[i], small), s.x), b.x);
    float y1 = __fadd_rn(__fmul_rn(acc_float(acc[i + 1], small), s.y), b.y);
    if (xs != nullptr) {  // the residual byte x: (2^23 + x + 128) - (2^23 + 128) = x exactly
      const uint8_t* xp = xs + r * a.Co + n0 + col;
      const uint32_t u = (x2 ? (uint32_t)*reinterpret_cast<const uint16_t*>(xp) : (uint32_t)xp[0] | (uint32_t)xp[1] << 8) ^
                         0x8080u;
      const float x0 = __fsub_rn(__uint_as_float(0x4B000000u | (u & 255u)), 8388736.f);
      const float x1 = __fsub_rn(__uint_as_float(0x4B000000u | (u >> 8)), 8388736.f);
      y0 = __fadd_rn(y0, __fmul_rn(__fsub_rn(x0, a.res_zp_s), a.res_scale));
      y1 = __fadd_rn(y1, __fmul_rn(__fsub_rn(x1, a.res_zp_s), a.res_scale));
    }
    const uint32_t q = (requant_zi(y0, a.inv_o, zc_o) | requant_zi(y1, a.inv_o, zc_o) << 8) ^ 0x8080u;
    uint8_t* o = ost + r * ncb + col;
    if (o2) {
      *reinterpret_cast<uint16_t*>(o) = (uint16_t)q;
    } else {
      o[0] = (uint8_t)q;
      if (col + 1 < ncb) o[1] = (uint8_t)(q >> 8);
    }
  }
}

// The staged output rows -> out: one contiguous span of 16-byte stores when
// the block holds whole rows, else row pieces byte by byte.
__device__ __forceinline__ void pj_store(const ProjArgs& a, const uint8_t* ost, int m0, int rows, int n0,
                                         int ncb) {
  if (ncb == a.Co && a.flat16) {
    const int bytes = rows * a.Co, full = bytes & ~15;
    int8_t* dst = a.out + (size_t)m0 * a.Co;
    for (int e = threadIdx.x * 16; e < full; e += blockDim.x * 16)
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(ost + e);
    for (int e = full + threadIdx.x; e < bytes; e += blockDim.x) dst[e] = (int8_t)ost[e];
  } else {
    for (int e = threadIdx.x; e < rows * ncb; e += blockDim.x) {
      const int r = e / ncb, cc = e - r * ncb;
      a.out[(size_t)(m0 + r) * a.Co + n0 + cc] = (int8_t)ost[e];
    }
  }
}

// Narrow tiles (TN <= 48) leave registers for 1024 threads an SM, wider ones for 512.
template <int TN>
__global__ void __launch_bounds__(PJ_THREADS, TN <= 48 ? 4 : 2) project_kernel(const ProjArgs a) {
  extern __shared__ uint8_t pj_raw[];
  uint8_t* sm = pj_raw + ((1024 - (smem_u32(pj_raw) & 1023)) & 1023);
  const bool se = a.g != nullptr, res = a.x_res != nullptr;
  const ProjLayout L(a, se, res);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * a.nb, ncb = min(a.nb, a.Co - n0);
  const int panels = (a.M + PJ_BM - 1) / PJ_BM;
  const int units =
      ((int)blockIdx.x < panels ? (panels - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0) * a.nch;
  uint8_t* wsm = sm + L.w;
  float* gsm = reinterpret_cast<float*>(sm + L.gate);
  uint8_t* xsm = sm + L.xres;
  uint8_t* ost = sm + L.outs;
  float* vp0 = reinterpret_cast<float*>(sm + L.vec);
  float* vp1 = vp0 + a.nb;
  uint8_t* lut = sm + L.lut;
  const int xstride = round16(PJ_BM * a.Co);
  const float zpm_q = __fsub_rn(RINT_MAGIC, a.q_zp), dzm = __fadd_rn(8388608.f, a.d_zp);
  const int zc_q = __float_as_int(RINT_MAGIC) - (int)a.q_zp;
  // the thread's 16-byte pieces of a full chunk and of the last one
  const PieceMap pm_full(min(PJ_KS, a.Ce)), pm_last(a.Ce - (a.nch - 1) * PJ_KS);

  for (int i = tid; i < a.nb; i += blockDim.x) {
    const bool ok = n0 + i < a.Co;
    vp0[i] = ok ? a.vp[n0 + i] : 0.f;
    vp1[i] = ok ? a.vp[a.Co + n0 + i] : 0.f;
  }
  if (!se)  // the table of the byte u = q ^ 0x80 (q the quint8 value)
    for (int u = tid; u < 256; u += blockDim.x)
      lut[u] = (uint8_t)(requant_u8(__fmul_rn(__fsub_rn((float)(u ^ 0x80), a.d_zp), a.d_scale), a.inv_q, zpm_q) ^
                         0x80u);
  if (a.resident)
    for (int c = 0; c < a.nch; ++c) pj_load_weights(a, wsm + c * a.nb * PJ_KS, n0, c);
  cp_async_commit();

  // Unit u is the (u mod nch)-th chunk of the block's panel u / nch (rows
  // m0 .. m0 + rows - 1), in stage u mod stages; the copies run stages - 1
  // units ahead. Block b takes a panel's chunks from chunk b mod nch on,
  // wrapping around, so that the blocks' weight copies spread over L2.
  const int rot = blockIdx.x % a.nch;
  auto chunk = [&](int ci) { return ci + rot < a.nch ? ci + rot : ci + rot - a.nch; };
  int in_u = 0, in_c = 0, in_s = 0, in_m0 = blockIdx.x * PJ_BM;  // the next unit to copy, its stage
  auto copy_next = [&]() {
    if (in_u < units) {
      const int rows = min(PJ_BM, a.M - in_m0), s = in_s, ck = chunk(in_c);
      pj_load_a(a, PieceMap(pm_last, pm_full, ck == a.nch - 1), sm + s * PJ_BM * PJ_KS, in_m0, rows, ck);
      if (se) pj_load_gate(a, gsm + s * a.gi * PJ_KS, image_of(a, in_m0), ck);
      if (res && in_c == a.nch - 1)
        pj_load_flat(xsm + s * xstride, a.x_res + (size_t)in_m0 * a.Co, rows * a.Co, a.flat16);
      if (!a.resident) pj_load_weights(a, wsm + s * a.nb * PJ_KS, n0, ck);
      if (++in_c == a.nch) {
        in_c = 0;
        in_m0 += gridDim.x * PJ_BM;
      }
      ++in_u;
      if (++in_s == a.stages) in_s = 0;
    }
    cp_async_commit();
  };
  for (int s = 0; s + 1 < a.stages; ++s) copy_next();

  const int wn = tid >> 7;  // the warpgroup's columns: wn TN ..
  const bool has_cols = wn * TN < ncb;  // uniform over the warpgroup
  int staged_m0 = 0, staged_rows = 0;   // the panel whose output rows wait in ost
  int c = 0, s = 0, m0 = blockIdx.x * PJ_BM, n_a = image_of(a, m0);  // unit u's chunk, stage, panel
  int acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
  for (int u = 0; u < units; ++u) {
    cp_async_wait_upto(a.stages - 2);  // unit u has landed (this thread's copies)
    __syncthreads();                   // everyone's; unit u - 1's stage is free, ost is written
    copy_next();
    if (staged_rows > 0) {
      pj_store(a, ost, staged_m0, staged_rows, n0, ncb);
      staged_rows = 0;
    }
    const int rows = min(PJ_BM, a.M - m0), ck = chunk(c);
    uint8_t* as = sm + s * PJ_BM * PJ_KS;
    pj_transform(a, PieceMap(pm_last, pm_full, ck == a.nch - 1), as, se ? gsm + s * a.gi * PJ_KS : nullptr,
                 lut, m0, rows, n_a, dzm, zc_q);
    fence_proxy_async();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
    }
    if (has_cols) {
      const uint8_t* pa = as;
      const uint8_t* pw = wsm + (a.resident ? ck : s) * a.nb * PJ_KS + wn * TN * PJ_KS;
      fence_regs(acc);
      wgmma_fence();
      if (ck * PJ_KS + PJ_KS <= a.kc) {  // a whole chunk: four k-steps, no test between them
#pragma unroll
        for (int kk = 0; kk < PJ_KS / 32; ++kk) WgmmaS8<TN>::mma(acc, desc_sw128(pa + kk * 32), desc_sw128(pw + kk * 32));
      } else {
#pragma unroll
        for (int kk = 0; kk < PJ_KS / 32 - 1; ++kk)
          if (ck * PJ_KS + kk * 32 < a.kc) WgmmaS8<TN>::mma(acc, desc_sw128(pa + kk * 32), desc_sw128(pw + kk * 32));
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
    }
    if (c == a.nch - 1) {  // the panel's output rows, stored after the next barrier
      if (has_cols) pj_epilogue<TN>(a, acc, vp0, vp1, res ? xsm + s * xstride : nullptr, ost, rows, ncb, n0, wn);
      staged_m0 = m0;
      staged_rows = rows;
      c = 0;
      m0 += gridDim.x * PJ_BM;
      n_a = image_of(a, m0);
    } else {
      ++c;
    }
    if (++s == a.stages) s = 0;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (staged_rows > 0) pj_store(a, ost, staged_m0, staged_rows, n0, ncb);
}

template <int TN>
cudaError_t launch_project(const ProjArgs& a, dim3 grid, int threads, int smem, cudaStream_t s) {
  static bool attr_set = false;  // the opt-in to more than 48 KB, once per instance
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(project_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  project_kernel<TN><<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace ievm

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success). Pointers that may be null: we/ve (no expand), pool (no SE),
// g (no SE), x_res (no residual).

extern "C" int ievm_fused_mbconv_expand_dw(const void* x, const void* we, int Kp_e, const void* ve,
                                           const void* wdw, const void* vdw, void* yq, void* pool,
                                           int N, int H, int W, int Cin, int Ce, int Ho, int Wo,
                                           int k, int stride, int act, int ct, int th, int tw,
                                           float map_zp, float inv_e, float inv_d, float d_zp,
                                           void* stream) {
  using namespace ievm;
  const int pad = (k - 1) / 2;
  const bool expand = we != nullptr;
  const int kc = expand ? (Cin + 31) / 32 * 32 : 0;
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0 || Cin <= 0 || Ce <= 0 || (k != 1 && k != 3 && k != 5) ||
      (stride != 1 && stride != 2) || (act != MB_SILU && act != MB_RELU6) ||
      Ho != (H + 2 * pad - k) / stride + 1 || Wo != (W + 2 * pad - k) / stride + 1 ||
      (expand && (ve == nullptr || Kp_e % 16 != 0 || Kp_e < kc)) || (!expand && Cin != Ce) ||
      (ct != 32 && ct != 48) || th < 1 || th > Ho || tw < 1 || tw > Wo || (Ce + ct - 1) / ct > 65535 ||
      !(map_zp >= 0.f && map_zp <= 255.f) || map_zp != rintf(map_zp))
    return (int)cudaErrorInvalidValue;
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
  a.pad = pad;
  a.act = act;
  a.vec = (Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) ? 1 : 0;
  a.TH = th;
  a.TW = tw;
  a.RH = (th - 1) * stride + k;
  a.RW = (tw - 1) * stride + k;
  a.tiles_x = (Wo + tw - 1) / tw;
  a.kc = kc;
  a.map_zp = map_zp;
  a.inv_e = inv_e;
  a.inv_d = inv_d;
  a.d_zp = d_zp;
  const long long tiles = (long long)((Ho + th - 1) / th) * a.tiles_x;
  const DwLayout L(a.RH * a.RW, ct, kc, k, expand);
  if (tiles > 0x7fffffff || L.total > DW_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (Ce + ct - 1) / ct, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k * 10 + stride) {
    case 11:
      return (int)launch_expand_dw_ct<1, 1>(ct, a, grid, L.total, s);
    case 12:
      return (int)launch_expand_dw_ct<1, 2>(ct, a, grid, L.total, s);
    case 31:
      return (int)launch_expand_dw_ct<3, 1>(ct, a, grid, L.total, s);
    case 32:
      return (int)launch_expand_dw_ct<3, 2>(ct, a, grid, L.total, s);
    case 51:
      return (int)launch_expand_dw_ct<5, 1>(ct, a, grid, L.total, s);
    default:
      return (int)launch_expand_dw_ct<5, 2>(ct, a, grid, L.total, s);
  }
}

// groups of `group` images (1, 2, 4 or 8) per block; Se <= 256
extern "C" int ievm_fused_mbconv_se_gate(const void* pool, const void* srw, const void* srb,
                                         const void* sew, const void* seb, void* g, int N, int Ce,
                                         int Se, double pool_scale, int group, void* stream) {
  using namespace ievm;
  if (N <= 0 || Ce <= 0 || Se <= 0 || Se > SE_MAX_SQUEEZE ||
      (group != 1 && group != 2 && group != 4 && group != 8) || SeLayout(group, Ce, Se).total > DW_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pool);
  const float *rw = static_cast<const float*>(srw), *rb = static_cast<const float*>(srb);
  const float *ew = static_cast<const float*>(sew), *eb = static_cast<const float*>(seb);
  float* gp = static_cast<float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 1:
      return (int)launch_se_gate<1>(p, rw, rb, ew, eb, gp, N, Ce, Se, pool_scale, s);
    case 2:
      return (int)launch_se_gate<2>(p, rw, rb, ew, eb, gp, N, Ce, Se, pool_scale, s);
    case 4:
      return (int)launch_se_gate<4>(p, rw, rb, ew, eb, gp, N, Ce, Se, pool_scale, s);
    default:
      return (int)launch_se_gate<8>(p, rw, rb, ew, eb, gp, N, Ce, Se, pool_scale, s);
  }
}

// wp: the packed (Np, Kp_p) weight; the tile plan (tn, wg_n, nsplit,
// stages, resident, grid) is ops/fused_mbconv.py:project_plan's
extern "C" int ievm_fused_mbconv_project(const void* yq, const void* g, const void* wp, int Np, int Kp_p,
                                         const void* vp, const void* x_res, void* out, int M, int HWo,
                                         int Ce, int Co, float d_zp, float d_scale, float inv_q,
                                         float q_zp, float res_scale, float res_zp_s, float inv_o,
                                         float o_zp, int tn, int wg_n, int nsplit, int stages,
                                         int resident, int grid, void* stream) {
  using namespace ievm;
  auto aligned = [](const void* p, int b) { return reinterpret_cast<uintptr_t>(p) % b == 0; };
  if (M <= 0 || HWo <= 0 || M % HWo != 0 || Ce <= 0 || Co <= 0 || Np < Co || Kp_p % 16 != 0 ||
      Kp_p < (Ce + 31) / 32 * 32 || !aligned(wp, 16) || vp == nullptr || out == nullptr ||
      wg_n < 1 || 128 * wg_n > PJ_THREADS || nsplit < 1 || nsplit > 65535 ||
      stages < 2 || stages > PJ_MAX_STAGES || (resident != 0 && resident != 1) || grid < 1)
    return (int)cudaErrorInvalidValue;
  ProjArgs a{};
  a.yq = static_cast<const int8_t*>(yq);
  a.g = static_cast<const float*>(g);
  a.wp = static_cast<const int8_t*>(wp);
  a.vp = static_cast<const float*>(vp);
  a.x_res = static_cast<const int8_t*>(x_res);
  a.out = static_cast<int8_t*>(out);
  a.M = M;
  a.HWo = HWo;
  a.nimg = M / HWo;
  int l = 0;
  while ((1LL << l) < HWo) ++l;
  a.hw_shift = 31 + l;
  a.hw_mul = (unsigned)(((1ULL << a.hw_shift) + HWo - 1) / HWo);
  a.Ce = Ce;
  a.Co = Co;
  a.Np = Np;
  a.Kp = Kp_p;
  a.kc = (Ce + 31) / 32 * 32;
  a.nch = (Ce + PJ_KS - 1) / PJ_KS;
  a.nb = wg_n * tn;
  a.stages = stages;
  a.resident = resident;
  a.gi = (PJ_BM - 1) / HWo + 2 < M / HWo ? (PJ_BM - 1) / HWo + 2 : M / HWo;
  a.a_vec = 1;
  for (int v = 16; v >= 4; v /= 2)
    if (Ce % v == 0 && aligned(yq, v)) {
      a.a_vec = v;
      break;
    }
  a.g_vec = (g != nullptr && Ce % 4 == 0 && aligned(g, 16)) ? 16 : 4;
  a.flat16 = aligned(out, 16) && (x_res == nullptr || aligned(x_res, 16));
  a.d_zp = d_zp;
  a.d_scale = d_scale;
  a.inv_q = inv_q;
  a.q_zp = q_zp;
  a.res_scale = res_scale;
  a.res_zp_s = res_zp_s;
  a.inv_o = inv_o;
  a.o_zp = o_zp;
  const int panels = (M + PJ_BM - 1) / PJ_BM;
  const ProjLayout L(a, g != nullptr, x_res != nullptr);
  // the gate path takes q - d_zp as (2^23 + q) - (2^23 + d_zp) and requantizes
  // by requant_zi, as does the epilogue: zero points that are integers
  auto zp_ok = [](float zp) { return zp >= 0.f && zp <= 255.f && zp == rintf(zp); };
  if ((long long)a.nb * nsplit < Co || (long long)a.nb * (nsplit - 1) >= Co || grid > panels ||
      (g != nullptr && !(zp_ok(d_zp) && zp_ok(q_zp))) || !zp_ok(o_zp) || L.total > DW_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid3(grid, nsplit);
  const int threads = 128 * wg_n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 16:
      return (int)launch_project<16>(a, grid3, threads, L.total, s);
    case 24:
      return (int)launch_project<24>(a, grid3, threads, L.total, s);
    case 32:
      return (int)launch_project<32>(a, grid3, threads, L.total, s);
    case 48:
      return (int)launch_project<48>(a, grid3, threads, L.total, s);
    case 64:
      return (int)launch_project<64>(a, grid3, threads, L.total, s);
    case 80:
      return (int)launch_project<80>(a, grid3, threads, L.total, s);
    case 96:
      return (int)launch_project<96>(a, grid3, threads, L.total, s);
    case 112:
      return (int)launch_project<112>(a, grid3, threads, L.total, s);
    case 128:
      return (int)launch_project<128>(a, grid3, threads, L.total, s);
    case 160:
      return (int)launch_project<160>(a, grid3, threads, L.total, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
