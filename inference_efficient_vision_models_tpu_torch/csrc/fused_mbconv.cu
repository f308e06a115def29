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

enum MbAct { MB_SILU = 0, MB_RELU6 = 1 };

// clip(rint(y * inv) + zp, 0, 255): the quint8 value, as a float
__device__ __forceinline__ float requant_q(float y, float inv, float zp) {
  const float q = __fadd_rn(rintf(__fmul_rn(y, inv)), zp);
  return fminf(fmaxf(q, 0.f), 255.f);
}

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
