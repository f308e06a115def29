// The Hopper int8 GEMM pipeline that kernels A (int8_matmul.cu) and B
// (conv3x3.cu) share: out (M, N) = epilogue(A (M, K) . W (K, N)), where each
// kernel brings its own A panel loader and its epilogue.
//
// - Blocks of 384 threads: two consumer warpgroups and one producer warp
//   (setmaxnreg moves registers from the producer to the consumers). A block
//   owns 128-row slices of A, 64 rows per consumer warpgroup, and a group of N
//   tiles; it is persistent over the slices (every gridDim.x-th one).
// - A warpgroup fills its (64, K) panel, 128-byte-swizzled and K-major, once
//   per slice (or in windows of K chunks for each tile when the whole panel
//   does not fit), and walks all its N tiles against it.
// - Weights by TMA. W is packed once as (Np, Kp) int8, K contiguous: the
//   K-major operand 8-bit wgmma needs. The producer streams BN x 128-byte
//   tiles through a ring of 2-6 stages with mbarriers; ragged N and K edges
//   come from TMA's zero fill.
// - wgmma m64 x BN x k32 (s8.s8 -> s32), A and B from shared memory, BN in
//   {64, 128, 192, 256}, k32 steps past K skipped.
// - The two consumer warpgroups share only the weight ring and start
//   staggered, so one loads or stores while the other multiplies.
// - Epilogue per 64-column slice: w_scale, bias and w_sum come from shared
//   memory (loaded once per block), y = acc * scale + bias (and ReLU) is
//   staged in shared memory as fp32 and a second pass (the kernel's own)
//   turns it into the output rows (store_tile), or the kernel converts in
//   registers and stages only output rows; full rows leave with 16-byte
//   stores where N allows (store_rows).
// The tile plan (BN, N groups, ring depth, panel or windows, grid) is chosen
// by ops/int8_matmul.py:tile_plan (kernel B: ops/conv3x3.py:conv3x3_plan)
// and checked by plan_ok.
#pragma once

#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace ievm {

using namespace sm90;

constexpr int A_THREADS = 384;   // warpgroups 0 and 1 consume, warpgroup 2 produces
constexpr int CONSUMERS = 256;
constexpr int KS = 128;          // K bytes per ring stage and per panel chunk
constexpr int CHUNK = BM * KS;   // one panel chunk: 128 rows x 128 bytes
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;  // the most shared memory a block may take
constexpr int BAR_WG0 = 1;       // named barriers 1, 2: one per consumer warpgroup
constexpr int BAR_STAGGER = 3;   // warpgroup 0 -> warpgroup 1, once

__host__ __device__ constexpr int out_bytes(int kind) {
  return kind == OUT_I8 ? 1 : (kind == OUT_F32 ? 4 : 2);
}
// a staged row: 64 output columns and padding that spreads a warp's writes over the banks
__host__ __device__ constexpr int stage_row(int kind) {
  return 64 * out_bytes(kind) + (kind == OUT_F32 ? 32 : 16);
}

// A staged slice: 64 rows of 64 fp32 values y = acc * scale + bias, each row
// padded to 288 bytes so that a warp's pair stores hit distinct banks; for an
// int8 or bf16 output a second area holds the converted rows (stage_row).
// A kernel that converts in registers (staged_y false) keeps only the rows
// of its output.
constexpr int FROW = 288;
__host__ __device__ constexpr int wg_stage_bytes(int kind, bool staged_y) {
  return staged_y ? 64 * FROW + (kind == OUT_F32 ? 0 : 64 * stage_row(kind)) : 64 * stage_row(kind);
}

// Byte offsets in the (1024-aligned) dynamic shared memory; ops/int8_matmul.py:smem_bytes
// computes the same total.
struct Layout {
  int ring, staging, params, bars, total;
  __host__ __device__ Layout(int bn, int stages, int window, int out_kind, int group_cols, bool staged_y)
      : ring(window * CHUNK),
        staging(ring + stages * bn * KS),
        params(staging + 2 * wg_stage_bytes(out_kind, staged_y)),
        bars(params + 3 * 4 * group_cols),
        total(bars + 2 * MAX_STAGES * 8 + 1024) {}
};

// What the pipeline and the shared epilogue read; each kernel's arguments
// derive from it and add what its loader and second pass need.
struct GemmArgs {
  const float* w_scale;
  const float* bias;
  const int* w_sum;
  void* out;
  int M, K, N;
  int out_kind, act, zp_s, out_zp;
  float in_scale, inv_out;
  int tiles_per_group, stages, window, nchunks;
};

// The tile plan of ops/int8_matmul.py:tile_plan, as the launch takes it:
// true when it is one the kernel can run (and sets *smem to its bytes).
inline bool plan_ok(int M, int K, int N, int out_kind, bool staged_y, int bn, int grid_m, int groups,
                    int tiles_per_group, int stages, int window, int* smem) {
  const int nchunks = K > 0 ? (K + KS - 1) / KS : 0;
  const int tiles = bn > 0 ? (N + bn - 1) / bn : 0;
  if (M <= 0 || N <= 0 || K <= 0 || out_kind < 0 || out_kind > 2 ||
      (bn != 64 && bn != 128 && bn != 192 && bn != 256) || stages < 2 || stages > MAX_STAGES ||
      window < 1 || window > nchunks || groups < 1 || groups > 65535 || grid_m < 1 ||
      grid_m > (M + BM - 1) / BM || tiles_per_group < 1 ||
      (long long)groups * tiles_per_group < tiles || (groups - 1) * tiles_per_group >= tiles)
    return false;
  *smem = Layout(bn, stages, window, out_kind, tiles_per_group * bn, staged_y).total;
  return *smem <= SMEM_LIMIT;
}

// v an integer-valued float (or +-inf, NaN): clip(v, 0, 255) - 128 as a
// byte, without a conversion instruction (int8_gemm.cuh clip_u8).
__device__ __forceinline__ uint32_t clip_byte(float v) { return clip_u8(v) ^ 0x80u; }

// The quantized byte of x, clip(rint(x / s) + zp, 0, 255) - 128, with the
// quotient correctly rounded: one double product (div_rn_by).
__device__ __forceinline__ uint32_t quant_byte_exact(float x, double inv_s, float zp) {
  return clip_byte(__fadd_rn(rintf(div_rn_by(x, inv_s)), zp));
}

// The same byte from q = RN_f32(x * rs), which lies within |q| 2^-23 (1 +
// 2^-20) of x / s: where no half-integer is within |q| 2^-20 of q, rint(q)
// equals rint(x / s) (q - rint(q) and |.| - 0.5 are exact). Sets `redo`
// where that does not hold (about one value in 10^4, and |q| >= 2^21, inf,
// NaN): the caller then takes quant_byte_exact.
__device__ __forceinline__ uint32_t quant_byte(float x, float rs, float zp, bool& redo) {
  const float q = __fmul_rn(x, rs);
  const float r = __fsub_rn(__fadd_rn(q, RINT_MAGIC), RINT_MAGIC);
  const float tie = fabsf(__fsub_rn(fabsf(__fsub_rn(q, r)), 0.5f));
  redo = !(fabsf(q) < 0x1p21f) || tie <= __fmul_rn(fabsf(q), 0x1p-20f);
  return clip_byte(__fadd_rn(r, zp));
}

// requant_i8 as a byte (int8_gemm.cuh requant_u8, shifted). zpm = RINT_MAGIC - zp.
__device__ __forceinline__ uint32_t requant_byte(float y, float inv_out, float zpm) {
  return requant_u8(y, inv_out, zpm) ^ 0x80u;
}

// act_t for four values, the erf-GELU's reciprocal by rcp_ge1_fast (int8_gemm.cuh gelu4).
template <int ACT>
__device__ __forceinline__ float4 act4(float4 v) {
  if constexpr (ACT == ACT_GELU) {
    return gelu4(v);
  } else {
    return make_float4(act_t<ACT>(v.x), act_t<ACT>(v.y), act_t<ACT>(v.z), act_t<ACT>(v.w));
  }
}

// act and the output conversion over a staged 64 x 64 slice, 4 values per
// step: a short loop, so the per-element code stays in the instruction cache.
template <int ACT, int OUT>
__device__ __noinline__ void finish_slice(const float inv_out, const float zpm, const uint8_t* fst,
                                          uint8_t* ost) {
  constexpr int esz = out_bytes(OUT), row_b = stage_row(OUT);
#pragma unroll 2
  for (int g = threadIdx.x & 127; g < 64 * 16; g += 128) {
    const int row = g >> 4, c = (g & 15) * 4;
    const float4 v = act4<ACT>(*reinterpret_cast<const float4*>(fst + row * FROW + c * 4));
    const float y0 = v.x, y1 = v.y, y2 = v.z, y3 = v.w;
    uint8_t* o = ost + row * row_b + c * esz;
    if constexpr (OUT == OUT_I8) {
      *reinterpret_cast<uint32_t*>(o) = requant_byte(y0, inv_out, zpm) |
                                        requant_byte(y1, inv_out, zpm) << 8 |
                                        requant_byte(y2, inv_out, zpm) << 16 |
                                        requant_byte(y3, inv_out, zpm) << 24;
    } else if constexpr (OUT == OUT_F32) {
      *reinterpret_cast<float4*>(o) = make_float4(y0, y1, y2, y3);
    } else {
      const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
      const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(y2), __float2bfloat16_rn(y3));
      *reinterpret_cast<uint2*>(o) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// `bytes` (a multiple of vw) from shared to global memory, vw bytes at a time.
__device__ __forceinline__ void copy_out(uint8_t* g, const uint8_t* s, int bytes, int vw) {
  for (int e = 0; e < bytes; e += vw) {
    if (vw == 16)
      *reinterpret_cast<uint4*>(g + e) = *reinterpret_cast<const uint4*>(s + e);
    else if (vw == 8)
      *reinterpret_cast<uint2*>(g + e) = *reinterpret_cast<const uint2*>(s + e);
    else if (vw == 4)
      *reinterpret_cast<uint32_t*>(g + e) = *reinterpret_cast<const uint32_t*>(s + e);
    else if (vw == 2)
      *reinterpret_cast<uint16_t*>(g + e) = *reinterpret_cast<const uint16_t*>(s + e);
    else
      g[e] = s[e];
  }
}

__device__ __forceinline__ float relu_if(bool relu, float y) { return relu ? fmaxf(y, 0.f) : y; }

// A warpgroup's staged output rows (stage_row apart) of columns nc0..nc0+63
// -> out rows m0w.., full rows with 16-byte stores where N allows.
__device__ __forceinline__ void store_rows(const GemmArgs& a, const uint8_t* ost, int m0w, int nc0) {
  const int lt = threadIdx.x & 127;
  const int esz = out_bytes(a.out_kind), row_b = stage_row(a.out_kind);
  const int ush = a.out_kind == OUT_I8 ? 2 : (a.out_kind == OUT_F32 ? 4 : 3);  // log2 16-byte units a row
  const int ob = (a.N * esz) & 15;
  const int vw = ob == 0 ? 16 : (ob & 7) == 0 ? 8 : (ob & 3) == 0 ? 4 : (ob & 1) == 0 ? 2 : 1;
  uint8_t* out = static_cast<uint8_t*>(a.out) + ((size_t)m0w * a.N + nc0) * esz;
  const int ncols = min(64, a.N - nc0), nbytes = ncols * esz;
  if (vw == 16 && nbytes % 16 == 0 && m0w + 64 <= a.M) {  // whole rows of 16-byte units
    for (int u = lt; u < 64 << ush; u += 128) {
      const int r = u >> ush, cb = (u & ((1 << ush) - 1)) * 16;
      if (cb < nbytes)
        *reinterpret_cast<uint4*>(out + (size_t)r * a.N * esz + cb) =
            *reinterpret_cast<const uint4*>(ost + r * row_b + cb);
    }
  } else {
    for (int u = lt; u < 64 << ush; u += 128) {
      const int r = u >> ush, cb = (u & ((1 << ush) - 1)) * 16;
      const int bytes = min(16, nbytes - cb);
      if (m0w + r < a.M && bytes > 0)
        copy_out(out + (size_t)r * a.N * esz + cb, ost + r * row_b + cb, bytes, vw);
    }
  }
}

// The warpgroup accumulator pair i (even, < 32) of a 64-column slice: its row
// and first column (wgmma's m64nNk32 register layout).
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x & 127) / 32 * 16 + (threadIdx.x & 31) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return (i >> 2) * 8 + (threadIdx.x & 3) * 2; }

// One warpgroup's 64 x TN accumulators -> out rows m0w.., columns n0.., in
// 64-column slices: y = acc * scale + bias (and ReLU) into the staging rows,
// then, where `second`, the second pass fin(zpm, staged fp32 rows, output
// rows, m0w, first column) into the output rows, then full rows out. ps/pb/pc
// hold the tile's epilogue vectors.
template <int TN, class Fin>
__device__ __forceinline__ void store_tile(const GemmArgs& a, const int (&acc)[TN / 2], uint8_t* stg,
                                           const float* ps, const float* pb, const int* pc, int m0w,
                                           int n0, bool second, const Fin& fin) {
  uint8_t* ost = a.out_kind == OUT_F32 ? stg : stg + 64 * FROW;
  const int bar = BAR_WG0 + (threadIdx.x >> 7);
  const bool relu = a.act == ACT_RELU;
  const float zpm = RINT_MAGIC - (float)a.out_zp;
#pragma unroll
  for (int j = 0; j < TN / 64; ++j) {
    const int nc0 = n0 + 64 * j;
    if (nc0 >= a.N) break;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      if (64 * j + (i >> 2) * 8 >= a.N - n0) break;  // 8-column groups past N: nothing to store
      const int col = acc_col(i), c = 64 * j + col, row = acc_row(i);
      *reinterpret_cast<float2*>(stg + row * FROW + col * 4) =
          make_float2(relu_if(relu, affine_y(acc[32 * j + i] - pc[c], ps[c], pb[c])),
                      relu_if(relu, affine_y(acc[32 * j + i + 1] - pc[c + 1], ps[c + 1], pb[c + 1])));
    }
    named_bar(bar, 128);
    if (second) {
      fin(zpm, stg, ost, m0w, nc0);
      named_bar(bar, 128);
    }
    store_rows(a, ost, m0w, nc0);
    named_bar(bar, 128);
  }
}

// A kernel built for BLOCKS (1 or 2) blocks per SM, and its consumers'
// registers after setmaxnreg (the producer keeps 40).
template <int BLOCKS>
struct Occupancy {
  static constexpr int blocks = BLOCKS;
  static constexpr int consumer_regs = BLOCKS == 2 ? 96 : 232;
};

// The body of a kernel on this pipeline, built for Occupancy<BLOCKS>. Each
// consumer thread makes a Job(a) after setmaxnreg (so that what it holds
// lives in registers) and the pipeline calls
// With Job::RESIDENT, a plan of one N tile whose K chunks fit in the ring
// loads the weights once. With Job::OVERLAP a chunk's wgmmas are issued
// before the previous chunk's have finished (wait_group 1), so the tensor
// cores never drain between chunks; the last ones are waited for at the end
// of each window.
//   job.begin(half, m0w)                  once, m0w the warpgroup's first rows;
//   job.tile(m0w, n0)                     as the tile of columns n0.. starts;
//   job.load(half, scratch, m0w, c0, nc)  start loading panel chunks
//                                         [c0, c0 + nc) of rows m0w..m0w+63
//                                         into `half` (scratch: the
//                                         warpgroup's staging area, free);
//   job.wait()                            this thread's loads have landed;
//   job.template store<TN>(acc, stg, ps, pb, pc, m0w, n0)  the tile's epilogue
//                                         (stg: its staging rows, whose layout
//                                         Job::STAGED_Y picks).
template <int TN, int BLOCKS, class Job, class Args>
__device__ __forceinline__ void panel_gemm(const CUtensorMap& wmap, const Args& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int t0 = (int)blockIdx.y * a.tiles_per_group;
  const int ntiles = min(a.tiles_per_group, (a.N + TN - 1) / TN - t0);
  const int mblocks = (a.M + BM - 1) / BM;
  const int gcols = a.tiles_per_group * TN;
  const Layout L(TN, a.stages, a.window, a.out_kind, gcols, Job::STAGED_Y);
  uint8_t* panel = smem;
  uint8_t* ring = smem + L.ring;
  float* ps = reinterpret_cast<float*>(smem + L.params);
  float* pb = ps + gcols;
  int* pc = reinterpret_cast<int*>(pb + gcols);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + MAX_STAGES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    fence_mbar_init();
  }
  for (int i = tid; i < gcols; i += A_THREADS) {  // the group's epilogue vectors, once
    const int n = t0 * TN + i;
    const bool ok = n < a.N;
    ps[i] = ok ? __fmul_rn(a.in_scale, a.w_scale[n]) : 0.f;
    pb[i] = ok ? a.bias[n] : 0.f;
    pc[i] = ok ? a.zp_s * a.w_sum[n] : 0;
  }
  __syncthreads();

  // One N tile whose K chunks all fit in the ring (Job::RESIDENT): the
  // weights are loaded once and stay, stage c holding chunk c.
  const bool resident = Job::RESIDENT && ntiles == 1 && a.nchunks <= a.stages;
  if (tid >= CONSUMERS) {  // producer: weight tiles, in the order the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS && resident) {
      for (int c = 0; c < a.nchunks; ++c) {
        mbar_arrive_expect_tx(&full[c], TN * KS);
        for (int r = 0; r < TN; r += 64)
          tma_load_2d(ring + c * TN * KS + r * KS, &wmap, &full[c], c * KS, t0 * TN + r);
      }
    } else if (tid == CONSUMERS) {
      int stage = 0;
      uint32_t phase = 0;
      for (int mb = blockIdx.x; mb < mblocks; mb += gridDim.x) {
        for (int t = 0; t < ntiles; ++t) {
          for (int c = 0; c < a.nchunks; ++c) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], TN * KS);
            uint8_t* dst = ring + stage * TN * KS;
            for (int r = 0; r < TN; r += 64)
              tma_load_2d(dst + r * KS, &wmap, &full[stage], c * KS, (t0 + t) * TN + r);
            if (++stage == a.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each slice
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Occupancy<BLOCKS>::consumer_regs) : "memory");
    const int wg = tid >> 7, lane = tid & 31;
    const int bar = BAR_WG0 + wg;
    uint8_t* half = panel + wg * 64 * KS;
    uint8_t* stg = smem + L.staging + wg * wg_stage_bytes(a.out_kind, Job::STAGED_Y);
    const bool stream = a.window < a.nchunks;
    Job job(a);
    int stage = 0;
    uint32_t phase = 0;
    int acc[TN / 2];
    job.begin(half, blockIdx.x * BM + wg * 64);
    // With more than one slice per block, warpgroup 1 starts once warpgroup 0
    // has its first panel, so that one loads while the other multiplies and stores.
    const bool stagger = (int)(blockIdx.x + gridDim.x) < mblocks;
    if (stagger && wg == 1) named_bar(BAR_STAGGER, CONSUMERS);
    for (int mb = blockIdx.x; mb < mblocks; mb += gridDim.x) {
      const int m0w = mb * BM + wg * 64;
      for (int t = 0; t < ntiles; ++t) {
        job.tile(m0w, (t0 + t) * TN);
        for (int c0 = 0; c0 < a.nchunks; c0 += a.window) {
          const int nc = min(a.window, a.nchunks - c0);
          if (stream || t == 0) {  // every wgmma on the old panel has completed (wait 0)
            job.load(half, stg, m0w, c0, nc);
            job.wait();
            fence_proxy_async();
            named_bar(bar, 128);
            if (stagger && wg == 0 && mb == blockIdx.x && t == 0 && c0 == 0)
              named_bar_arrive(BAR_STAGGER, CONSUMERS);
          }
          if (c0 == 0) {
#pragma unroll
            for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
          }
          int pend = -1;  // Job::OVERLAP: the ring stage of the chunk still multiplying
          for (int c = 0; c < nc; ++c) {
            const int st = resident ? c0 + c : stage;
            mbar_wait(&full[st], resident ? 0u : phase);
            const uint8_t* pa = half + c * CHUNK;
            const uint8_t* pw = ring + st * TN * KS;
            fence_regs(acc);
            wgmma_fence();
            const int kend = a.K - (c0 + c) * KS;  // past K both operands hold zeros: skip them
#pragma unroll
            for (int kk = 0; kk < KS / 32; ++kk)
              if (kk * 32 < kend) WgmmaS8<TN>::mma(acc, desc_sw128(pa + kk * 32), desc_sw128(pw + kk * 32));
            wgmma_commit();
            if constexpr (Job::OVERLAP) {  // the previous chunk's wgmmas are done: free its stage
              wgmma_wait1();
              fence_regs(acc);
              if (!resident && pend >= 0) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[pend]);
              }
              pend = st;
            } else {
              wgmma_wait0();
              fence_regs(acc);
              if (resident) continue;
              __syncwarp();
              if (lane == 0) mbar_arrive(&empty[stage]);
            }
            if (resident) continue;
            if (++stage == a.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
          if constexpr (Job::OVERLAP) {  // the window's last wgmmas: the panel and the ring stage free
            wgmma_wait0();
            fence_regs(acc);
            if (!resident && pend >= 0) {
              __syncwarp();
              if (lane == 0) mbar_arrive(&empty[pend]);
            }
          }
        }
        job.template store<TN>(acc, stg, ps + t * TN, pb + t * TN, pc + t * TN, m0w, (t0 + t) * TN);
      }
    }
  }
}

// Launches kernel<<<grid, A_THREADS, smem, s>>>(map, args), opting in to more
// than 48 KB of shared memory on the kernel's first launch.
template <class Kernel, class Args>
int launch_panel_gemm(Kernel kernel, bool& attr_set, const CUtensorMap& map, const Args& a, dim3 grid,
                      int smem, cudaStream_t s) {
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kernel<<<grid, A_THREADS, smem, s>>>(map, a);
  return (int)cudaGetLastError();
}

}  // namespace ievm
