// dense_gelu on Hopper: replaces the Pallas TPU kernel
// inference_efficient_vision_models_tpu/ops/fused_dense.py:dense_gelu.
//
// out (M, N) = gelu_erf(X (M, K) . W (K, N) + b), X, W, b and out all bf16 or
// all fp32: the product accumulates in fp32, the bias is added in fp32, the
// GELU is the A&S 7.1.26 erf polynomial in fp32 (int8_gemm.cuh gelu4, the
// Pallas kernel's _erf), and the result is cast once to the input's type. The
// pre-activation never reaches device memory.
//
// Bound on an H100 at the ViT-Tiny mlp1 shape (M = 50,432 tokens at batch
// 256, K = 192, N = 768): bf16 moves 97 MB (x 19 MB, out 77 MB) for 14.9
// GFLOP, so it is bound by bytes (0.029 ms at 3.35 TB/s, against 0.015 ms of
// tensor-core work); the output write dominates. Its 38.7 M exact GELUs are
// the next limit: some 35 fp32 instructions each, ~0.05 ms at the card's
// issue rate. fp32 runs on the CUDA cores in exact fp32 FMAs (TF32 would
// change the function), 7.4 G FMA at 33.5 T/s = 0.22 ms, bound by operations.
//
// Design.
// * bf16, K <= 192 with 16-byte rows (the served shape): a persistent block
//   of 384 threads owns a 128-column slice of W, which one TMA load brings
//   into shared memory once (the (K, N) matrix as it arrives: rows of 64 N
//   values, 128-byte swizzle, read by wgmma as an MN-major B operand, so no
//   transposed copy exists). Three consumer warpgroups take turns at the
//   64-row tiles of X; a producer warp per warpgroup brings each tile by TMA
//   (64 x 64-value boxes, the swizzled K-major A layout) into that
//   warpgroup's A buffer, signalled by mbarriers. A tile is K / 16 wgmma
//   m64n128k16 (fp32 accumulate); its epilogue (bias, exact GELU, bf16)
//   stages the 64 x 128 output in shared memory, swizzled as the output's
//   tensor map reads it, and one thread hands it to TMA stores (rows past M
//   clipped), while the other warpgroups multiply or run their epilogues
//   and the next tile loads. The epilogue is what takes the time (38.7 M
//   GELUs): three warpgroups with one A buffer and one staging buffer each
//   beat two with two of each (0.095 against 0.116 ms at mlp1, H100 at
//   700 W), since they give the issue slots more independent work. The
//   GELU's reciprocal is division-free and exact: rcp_ge1_fast, with the
//   rare unsettled values redone after each group of four (gelu4): all 64
//   at once cost more (registers) than they saved. The grid
//   (ops/fused_dense.py:dense_plan) is one block per SM: N slices times M
//   groups.
// * bf16 otherwise (K > 192, K or N not a multiple of 8, unaligned
//   pointers): a 128 x 128 output tile per block of 8 warps on mma.sync
//   m16n8k16, K in 32-wide slices through two cp.async stages (16-byte
//   copies where rows allow, element loads otherwise), W fragments by
//   ldmatrix.trans from its (K, N) layout.
// * fp32: a 128 x 128 tile per block, 8 x 8 outputs a thread, K in slices of
//   8 staged through shared memory with the next slice prefetched into
//   registers; each output is one fmaf chain over k.
// Every route ends in the same division-free GELU (gelu4).
#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace ievm {
namespace dense {

using namespace sm90;

constexpr int THREADS = 256;

// ------------------------------------------------------- bf16, Hopper ----
constexpr int W_CONSUMERS = 3;   // consumer warpgroups; then one warpgroup of producer warps
constexpr int W_THREADS = 128 * (W_CONSUMERS + 1);
constexpr int W_BN = 128;        // output columns per block
constexpr int W_TM = 64;         // rows per consumer tile
constexpr int W_KCH = 64;        // K values per A box (128 bytes)
constexpr int W_MAX_K = 192;     // K that keeps the W slice resident beside the ring
constexpr int W_STAGES = 1;      // A tiles in flight per consumer warpgroup
constexpr int W_BUFS = 1;        // staged output tiles per consumer warpgroup
constexpr int A_BOX = W_TM * 128;  // one 64 x 64 bf16 box: 8 KB (also one staged output half)
constexpr int STG_BUF = 2 * A_BOX;  // a staged 64 x 128 output tile: two swizzled boxes
constexpr int SMEM_LIMIT = 232448;

// Byte offsets in the (1024-aligned) dynamic shared memory; ops/fused_dense.py:wgmma_smem_bytes
// computes the same total. kb: K rounded up to 16; nch: 64-value K chunks.
struct WLayout {
  int w, a, stg, bias, bars, total;
  __host__ __device__ WLayout(int kb, int nch)
      : w(0),
        a(2 * kb * 128),
        stg(a + W_CONSUMERS * W_STAGES * nch * A_BOX),
        bias(stg + W_CONSUMERS * W_BUFS * STG_BUF),
        bars(bias + W_BN * 4),
        total(bars + (1 + 2 * W_CONSUMERS * W_STAGES) * 8 + 1024) {}
};

__global__ void __launch_bounds__(W_THREADS, 1)
    dense_gelu_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap omap, const __nv_bfloat16* __restrict__ b,
                           int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kb = (K + 15) & ~15, ksteps = kb / 16, nch = (K + W_KCH - 1) / W_KCH;
  const WLayout L(kb, nch);
  uint8_t* wsm = smem + L.w;
  float* bias = reinterpret_cast<float*>(smem + L.bias);
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* full = wbar + 1;               // [wg][stage]
  uint64_t* empty = full + W_CONSUMERS * W_STAGES;   // [wg][stage]
  const int tid = threadIdx.x;
  const int n0 = (int)blockIdx.y * W_BN;
  const int mtiles = (M + W_TM - 1) / W_TM;
  const int step = W_CONSUMERS * (int)gridDim.x;

  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < W_CONSUMERS * W_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  if (tid < W_BN) bias[tid] = n0 + tid < N ? __bfloat162float(b[n0 + tid]) : 0.f;
  __syncthreads();

  if (tid >= 128 * W_CONSUMERS) {  // producers: lane 0 of producer warp w feeds warpgroup w; warp 0 loads W
    const int pw = (tid - 128 * W_CONSUMERS) >> 5;
    if (pw < W_CONSUMERS && (tid & 31) == 0) {
      if (pw == 0) {
        mbar_arrive_expect_tx(wbar, 2 * kb * 128);
        tma_load_2d(wsm, &wmap, wbar, n0, 0);
        tma_load_2d(wsm + kb * 128, &wmap, wbar, n0 + 64, 0);
      }
      uint8_t* ring = smem + L.a + pw * W_STAGES * nch * A_BOX;
      int stage = 0;
      uint32_t phase = 0;
      for (int mt = (int)blockIdx.x * W_CONSUMERS + pw; mt < mtiles; mt += step) {
        mbar_wait(&empty[pw * W_STAGES + stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[pw * W_STAGES + stage], nch * A_BOX);
        for (int c = 0; c < nch; ++c)
          tma_load_2d(ring + (stage * nch + c) * A_BOX, &xmap, &full[pw * W_STAGES + stage], c * W_KCH,
                      mt * W_TM);
        if (++stage == W_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers
  const int wg = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = lt & 31;
  const int bar = 1 + wg;
  const uint8_t* ring = smem + L.a + wg * W_STAGES * nch * A_BOX;
  uint8_t* stg0 = smem + L.stg + wg * W_BUFS * STG_BUF;
  const int row0 = warp * 16 + (lane >> 2), col = 2 * (lane & 3);
  int stage = 0, buf = 0;
  uint32_t phase = 0;
  float acc[64];
  mbar_wait(wbar, 0);
  for (int mt = (int)blockIdx.x * W_CONSUMERS + wg; mt < mtiles; mt += step) {
    mbar_wait(&full[wg * W_STAGES + stage], phase);
    const uint8_t* a = ring + stage * nch * A_BOX;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
    for (int s = 0; s < ksteps; ++s)
      wgmma_bf16_n128_tb(acc, desc_sw128(a + (s >> 2) * A_BOX + (s & 3) * 32),
                         desc_sw128_mn(wsm + s * 2048, kb * 128));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[wg * W_STAGES + stage]);
    if (++stage == W_STAGES) {
      stage = 0;
      phase ^= 1;
    }

    // epilogue into staging buffer `buf`, once the TMA store that last read it is done
    uint8_t* stg = stg0 + buf * STG_BUF;
    if (lt == 0) bulk_wait_read<W_BUFS - 1>();
    named_bar(bar, 128);
    // d[4 j + 2 h + e] is row row0 + 8 h, column 8 j + col + e; the tile is
    // staged as two 64 x 64 boxes in the 128-byte swizzle the store map reads
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + col;
      const float4 g = gelu4(make_float4(__fadd_rn(acc[4 * j], bias[c]), __fadd_rn(acc[4 * j + 1], bias[c + 1]),
                                         __fadd_rn(acc[4 * j + 2], bias[c]),
                                         __fadd_rn(acc[4 * j + 3], bias[c + 1])));
      uint8_t* half = stg + (j >> 3) * A_BOX;
      const int cb = (c & 63) * 2;
      *reinterpret_cast<__nv_bfloat162*>(half + swz128(row0, cb)) = __floats2bfloat162_rn(g.x, g.y);
      *reinterpret_cast<__nv_bfloat162*>(half + swz128(row0 + 8, cb)) = __floats2bfloat162_rn(g.z, g.w);
    }
    fence_proxy_async();
    named_bar(bar, 128);
    if (lt == 0) {  // TMA clips rows past M and columns past N
      tma_store_2d(&omap, stg, n0, mt * W_TM);
      tma_store_2d(&omap, stg + A_BOX, n0 + 64, mt * W_TM);
      bulk_commit();
    }
    if (++buf == W_BUFS) buf = 0;
  }
  if (lt == 0) bulk_wait<0>();
}

// ------------------------------------------------------ bf16, general ----
constexpr int HBM = 128, HBN = 128, HBK = 32;
constexpr int SA = HBK + 8;  // 80-byte A rows
constexpr int SB = HBN + 8;  // 272-byte B rows

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                                  const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(smem)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 consecutive bf16 of `row` from column c0 (zero where c0 + i >= lim or the
// row is out of range) into 16 bytes of shared memory.
__device__ __forceinline__ void load8_bf16(__nv_bfloat16* dst, const __nv_bfloat16* row, bool row_ok,
                                           int c0, int lim) {
  const unsigned short* p = reinterpret_cast<const unsigned short*>(row);
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = (row_ok && c0 + 2 * i < lim) ? p[c0 + 2 * i] : 0u;
    const uint32_t hi = (row_ok && c0 + 2 * i + 1 < lim) ? p[c0 + 2 * i + 1] : 0u;
    v[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
}

// VEC: K % 8 == 0, N % 8 == 0 and 16-byte aligned pointers, so every
// 16-byte chunk of a tile row lies wholly inside or wholly outside the matrix.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    dense_gelu_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                           const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out, int M,
                           int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[2][HBM * SA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][HBK * SB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int bm = (int)blockIdx.x * HBM, bn = (int)blockIdx.y * HBN;
  const int nk = (K + HBK - 1) / HBK;

  auto load_slice = [&](int kt, int st) {
    const int k0 = kt * HBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;
      // A: 128 rows x 4 chunks of 8
      const int r = c >> 2, ka = k0 + (c & 3) * 8, m = bm + r;
      __nv_bfloat16* da = &As[st][r * SA + (c & 3) * 8];
      // B: 32 rows x 16 chunks of 8
      const int kr = c >> 4, nb = bn + (c & 15) * 8, k = k0 + kr;
      __nv_bfloat16* db = &Bs[st][kr * SB + (c & 15) * 8];
      if (VEC) {
        const bool oka = m < M && ka < K, okb = k < K && nb < N;
        cp_async16(da, oka ? x + (size_t)m * K + ka : x, oka ? 16 : 0);
        cp_async16(db, okb ? w + (size_t)k * N + nb : w, okb ? 16 : 0);
      } else {
        load8_bf16(da, x + (size_t)(m < M ? m : 0) * K, m < M, ka, K);
        load8_bf16(db, w + (size_t)(k < K ? k : 0) * N, k < K, nb, N);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_slice(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_slice(kt + 1, (kt + 1) & 1);  // that stage was last read before the previous barrier
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* as = As[kt & 1];
    const __nv_bfloat16* bs = Bs[kt & 1];
#pragma unroll
    for (int ks = 0; ks < HBK; ks += 16) {
      uint32_t af[2][4], bf[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = wm * 32 + mt * 16 + gid, c0 = ks + tig * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&as[r0 * SA + c0]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&as[(r0 + 8) * SA + c0]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&as[r0 * SA + c0 + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&as[(r0 + 8) * SA + c0 + 8]);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // lanes 0-7 / 8-15 / 16-23 / 24-31 address the rows of the four 8x8
        // matrices: k 0-7 and 8-15 of n-tile 2np, then of n-tile 2np + 1
        const int kr = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int nc = wn * 64 + np * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf[2 * np][0], bf[2 * np][1], bf[2 * np + 1][0], bf[2 * np + 1][1],
                          &bs[kr * SB + nc]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();
  }

  // fragment values 0, 1 at row m, columns n, n + 1; 2, 3 at row m + 8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int m = bm + wm * 32 + mt * 16 + gid;
      const int n = bn + wn * 64 + nt * 8 + tig * 2;
      const float b0 = n < N ? __bfloat162float(b[n]) : 0.f;
      const float b1 = n + 1 < N ? __bfloat162float(b[n + 1]) : 0.f;
      const float4 g = gelu4(make_float4(__fadd_rn(acc[mt][nt][0], b0), __fadd_rn(acc[mt][nt][1], b1),
                                         __fadd_rn(acc[mt][nt][2], b0), __fadd_rn(acc[mt][nt][3], b1)));
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m + 8 * h;
        if (mm >= M || n >= N) continue;
        __nv_bfloat16* o = out + (size_t)mm * N + n;
        const __nv_bfloat16 y0 = __float2bfloat16_rn(gv[2 * h]);
        if (n + 1 < N) {
          const __nv_bfloat16 y1 = __float2bfloat16_rn(gv[2 * h + 1]);
          if (VEC) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);
          } else {
            o[0] = y0;
            o[1] = y1;
          }
        } else {
          o[0] = y0;
        }
      }
    }
}

// ----------------------------------------------------------------- fp32 ----
constexpr int FBM = 128, FBN = 128, FBK = 8;

// VEC: K % 4 == 0, N % 4 == 0 and 16-byte aligned pointers.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    dense_gelu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[FBK][FBN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bm = (int)blockIdx.x * FBM, bn = (int)blockIdx.y * FBN;
  const int nk = (K + FBK - 1) / FBK;
  // loader: A row tid / 2, k (tid % 2) * 4 .. +3; B row k tid / 32, n (tid % 32) * 4 .. +3
  const int am = bm + (tid >> 1), ak = (tid & 1) * 4;
  const int bk = tid >> 5, bnn = bn + (tid & 31) * 4;
  float ra[4], rb[4];

  auto gload = [&](int kt) {
    const int k0 = kt * FBK;
    const int ka = k0 + ak, kb = k0 + bk;
    if (VEC && am < M && ka < K) {
      const float4 v = *reinterpret_cast<const float4*>(x + (size_t)am * K + ka);
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = (am < M && ka + i < K) ? x[(size_t)am * K + ka + i] : 0.f;
    }
    if (VEC && kb < K && bnn < N) {
      const float4 v = *reinterpret_cast<const float4*>(w + (size_t)kb * N + bnn);
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) rb[i] = (kb < K && bnn + i < N) ? w[(size_t)kb * N + bnn + i] : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  gload(0);
  for (int kt = 0; kt < nk; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[ak + i][tid >> 1] = ra[i];
    *reinterpret_cast<float4*>(&Bs[bk][(tid & 31) * 4]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
    __syncthreads();
    if (kt + 1 < nk) gload(kt + 1);
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = bm + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = bn + half * 64 + tx * 4;
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = n0 + j < N ? b[n0 + j] : 0.f;
      const float4 g = gelu4(make_float4(
          __fadd_rn(acc[i][half * 4], bv[0]), __fadd_rn(acc[i][half * 4 + 1], bv[1]),
          __fadd_rn(acc[i][half * 4 + 2], bv[2]), __fadd_rn(acc[i][half * 4 + 3], bv[3])));
      const float y[4] = {g.x, g.y, g.z, g.w};
      float* o = out + (size_t)m * N + n0;
      if (VEC && n0 < N) {
        *reinterpret_cast<float4*>(o) = g;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < N) o[j] = y[j];
      }
    }
  }
}

// The tensor maps of the Hopper route, all bf16 with the 128-byte swizzle:
// X (M, K) in 64 x 64 boxes and W (K, N) in boxes of 64 columns by kb rows,
// zero-filled outside the matrix; out (M, N) in 64 x 64 boxes, clipped.
int encode_maps(const void* x, const void* w, void* out, int M, int K, int N, int kb, CUtensorMap* xmap,
                CUtensorMap* wmap, CUtensorMap* omap) {
  TensorMapEncode encode;
  const cudaError_t e = tensor_map_encoder(&encode);
  if (e != cudaSuccess) return (int)e;
  const cuuint32_t elem[2] = {1, 1};
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M}, xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {(cuuint32_t)W_KCH, (cuuint32_t)W_TM};
  CUresult r = encode(xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xd, xs, xb, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const cuuint64_t wd[2] = {(cuuint64_t)N, (cuuint64_t)K}, ws[1] = {(cuuint64_t)N * 2};
  const cuuint32_t wb[2] = {64, (cuuint32_t)kb};
  r = encode(wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wd, ws, wb, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + (int)r;
  const cuuint64_t od[2] = {(cuuint64_t)N, (cuuint64_t)M}, os[1] = {(cuuint64_t)N * 2};
  const cuuint32_t ob[2] = {64, (cuuint32_t)W_TM};
  r = encode(omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, od, os, ob, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r != CUDA_SUCCESS ? 1000 + (int)r : 0;
}

}  // namespace dense
}  // namespace ievm

// kind: 1 fp32, 2 bf16 (x, w, b and out all of that type). route (bf16 only,
// ops/fused_dense.py:dense_plan): 1 the Hopper kernel on a (grid_m, N / 128)
// grid, 0 the general one. Returns cudaGetLastError() after the launch (0 on
// success), or an error the tensor-map encoder gave (1000 + CUresult).
extern "C" int ievm_dense_gelu(const void* x, const void* w, const void* b, void* out, int kind, int M,
                               int K, int N, int route, int grid_m, void* stream) {
  using namespace ievm::dense;
  if (M <= 0 || N <= 0 || K <= 0 || (kind != 1 && kind != 2)) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const auto* bb = static_cast<const __nv_bfloat16*>(b);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (route == 1) {
      const int kb = (K + 15) & ~15, nch = (K + W_KCH - 1) / W_KCH;
      const int ntiles = (N + W_BN - 1) / W_BN;
      const WLayout L(kb, nch);
      if (!aligned || K % 8 != 0 || N % 8 != 0 || K > W_MAX_K || grid_m < 1 ||
          grid_m > ((M + W_TM - 1) / W_TM + W_CONSUMERS - 1) / W_CONSUMERS || ntiles > 65535 || L.total > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
      CUtensorMap xmap, wmap, omap;
      const int rc = encode_maps(x, w, out, M, K, N, kb, &xmap, &wmap, &omap);
      if (rc != 0) return rc;
      static bool attr_set = false;  // the opt-in to more than 48 KB, once
      if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(dense_gelu_sm90_kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
      }
      dense_gelu_sm90_kernel<<<dim3(grid_m, ntiles), W_THREADS, L.total, s>>>(xmap, wmap, omap, bb, M, K, N);
      return (int)cudaGetLastError();
    }
    if (route != 0) return (int)cudaErrorInvalidValue;
    dim3 grid((M + HBM - 1) / HBM, (N + HBN - 1) / HBN);
    if (aligned && K % 8 == 0 && N % 8 == 0)
      dense_gelu_bf16_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, K, N);
    else
      dense_gelu_bf16_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, K, N);
  } else {
    if (route != 0) return (int)cudaErrorInvalidValue;
    const auto* xf = static_cast<const float*>(x);
    const auto* wf = static_cast<const float*>(w);
    const auto* bf = static_cast<const float*>(b);
    auto* of = static_cast<float*>(out);
    dim3 grid((M + FBM - 1) / FBM, (N + FBN - 1) / FBN);
    if (aligned && K % 4 == 0 && N % 4 == 0)
      dense_gelu_f32_kernel<true><<<grid, THREADS, 0, s>>>(xf, wf, bf, of, M, K, N);
    else
      dense_gelu_f32_kernel<false><<<grid, THREADS, 0, s>>>(xf, wf, bf, of, M, K, N);
  }
  return (int)cudaGetLastError();
}
