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
// batch 256; Cg 4, 8, 16, 32 at 56, 28, 14, 7): the bytes, ~1.04 GB, ~0.31
// ms at 3.35 TB/s; the 29.6 G MACs take 0.03 ms at the int8 tensor-core
// peak. The first design of this kernel (dp4a, 4 outputs x 4 channels a
// thread) took 1.280 ms there (PERF.md): 64 dp4a a clock per SM put a
// floor of 0.055 ms under every call, and its exact epilogue (an
// int-to-float conversion and a double-precision quotient, both at an
// eighth of the fp32 rate) cost ~36 issue slots a value. This design:
// - MACs on the tensor cores: mma.sync m16n8k32 s8.s8.s32, exact. A window
//   (one group in a slot of Cg rounded up to 8 bytes, or two groups of Cg
//   <= 4 in slots of 4) is an implicit GEMM: M = output pixels, N = the
//   window's columns, K = 9 taps x its bytes in 4-byte words, padded to k32
//   steps and ordered so that a lane's two A words of a step lie side by
//   side (ops/gconv_int8.py:k_word); its weights are block-diagonal, zero
//   at every pad byte, laid out once at load time as B fragments
//   (ops/gconv_int8.py:pack_grouped_weight). The int32 sums equal any
//   order's, so exactness rests on the epilogue alone. mma.sync is not
//   Hopper's fastest route: with the pad of K (72 of 96 at Cg 8) and of the
//   block diagonal (half of K at Cg 4) it holds stage 1 above its bytes
//   (PERF.md, port_block_launches.py --gconv --ablate); wgmma is later work.
// - An epilogue of ~9 fp32 and integer issue slots a value, bit for bit the
//   plain version's: the mma starts from -zp_s w_sum; __int2float_rn (exact:
//   |sum| < 2^24; a magic-constant form where the sum's range allows it was
//   measured no faster and is gone); __fmul_rn and __fadd_rn so nvcc cannot
//   contract; the quotient RN(y / s_out) as
//   q = RN(y r), r = RN(1 / s_out), then q + RN(y - q s) r in one fma
//   (quot_rn: checked equal to the division on the card over every float32
//   y from 2^-90 to the clip, and rounded to the same integer from 0, at
//   each served s_out, chip_smoke.py gconv_quotient; at sampled and
//   constructed near-midpoint quotients on the CPU); rint, the zero point
//   and the clip as one magic-constant addition and an integer minimum.
// What the rest of the design does about the bytes:
// - Blocks: one slab of ws whole windows (ws win <= 128 bytes a pixel; the
//   last slab ragged past G) and nb consecutive (image, band of bh output
//   rows at full width) tiles, as ops/gconv_int8.py:gconv_plan chooses (a
//   cost model fitted to timed plans); the kernel refuses any other plan.
//   The slab's B fragments, the A offsets of each k step and a 16-byte
//   record per column (-zp_s w_sum, s_in s_w, the bias, the column's byte
//   in the output pixel) are staged once a block.
// - Bytes move once: a tile's input rows x wp pixels x the slab's bytes
//   are staged in shared memory at ps bytes a pixel (the pad chosen so that
//   the A fragment loads meet few bank conflicts), the halo at zp_s, by
//   cp.async (16, 8 or 4 bytes a copy; the next tile's in flight while one
//   is computed): the slab's bytes where the groups fill their slots, else
//   the aligned bytes around them, which a warp a pixel then spreads into
//   the slots in place by __byte_perm (spread_words: the pruned chain's Cg
//   7, 14, 28); for an unaligned x, words gathered from two aligned loads
//   of x and shifted into place. Pad bytes meet zero weights.
// - A warp item is MT m16 tiles (2 output rows x 8 outputs along x each;
//   MT = 8 / ntw, or 7 on rows of 56 outputs) of one window and ntw n8
//   tiles (1, 2 or 4): per k32 step 2 MT 64-bit A loads, ntw 64-bit B loads
//   and MT ntw independent mma.
// - Output through shared memory: each item's bytes go to the tile's output
//   pixels, which leave with 16-byte stores where C and the slab allow.
// Build without --use_fast_math.
#include <string.h>

#include "int8_gemm.cuh"
#include "sm90.cuh"

namespace ievm {

constexpr int GC_THREADS = 256;
constexpr int GC_WARPS = GC_THREADS / 32;
constexpr int GC_SMEM_LIMIT = 232448;
constexpr int GC_MAX_SLAB = 128;  // bytes of a slab's pixel
constexpr int GC_NTW = 4;         // n8 tiles of a warp item at most
constexpr int RINT_BITS = 0x4B400000;  // bits of RINT_MAGIC = 1.5 * 2^23

// ops/gconv_int8.py:gc_geom
struct GcGeom {
  int Cg, slot, gw, win, nwt, ks, nt, ntw, nwin, ws, gs, slabs;
};

__host__ __device__ inline GcGeom gc_geom(int C, int G) {
  GcGeom g;
  g.Cg = C / G;
  g.slot = g.Cg <= 4 ? 4 : (g.Cg + 7) / 8 * 8;
  g.gw = g.Cg <= 4 ? 2 : 1;
  g.win = g.gw * g.slot;
  g.nwt = g.win / 4;
  g.ks = (9 * g.nwt + 7) / 8;
  const int nt0 = (g.win + 7) / 8;
  g.ntw = nt0 <= 2 ? nt0 : GC_NTW;
  int chunks = 1;  // n chunks a window: a power of 2
  while (chunks * g.ntw < nt0) chunks *= 2;
  g.nt = chunks * g.ntw;
  g.nwin = (G + g.gw - 1) / g.gw;
  const int fit = GC_MAX_SLAB / g.win;
  g.ws = g.nwin < (fit > 1 ? fit : 1) ? g.nwin : (fit > 1 ? fit : 1);
  g.gs = g.ws * g.gw;
  g.slabs = (g.nwin + g.ws - 1) / g.ws;
  return g;
}

// ops/gconv_int8.py:koff: byte offset of a window's K word kw from an output
// pixel's first tap in the staged tile; 0 for the pad words (zero weights).
__host__ __device__ inline int koff_of(const GcGeom& g, int kw, int wp, int ps) {
  if (kw >= 9 * g.nwt) return 0;
  const int tap = kw / g.nwt, i = kw - tap * g.nwt;
  return ((tap / 3) * wp + tap % 3) * ps + 4 * i;
}

// ops/gconv_int8.py:out_stride: bytes of an output tile pixel, at least 2
// past the slab's (the pad columns' stores go there), 16 modulo 32 (the 8
// rows of an accumulator store hit 8 distinct 4-bank groups).
__host__ __device__ inline int out_stride(int bytes) {
  const int v = (bytes + 2 + 15) / 16 * 16;
  return v % 32 == 16 ? v : v + 16;
}

// ops/gconv_int8.py:item_tiles: m16 tiles a warp item (MT), 8 / ntw, or 7
// where a row holds 7 runs of 8. out_rows: rows of the output tile, the band's bh and
// those the last warp item's m16 tiles past the band write to (they are
// computed on the band's first tile and never copied out).
__host__ __device__ inline int item_tiles(const GcGeom& g, int runs) {
  return g.ntw == 1 && runs % 7 == 0 ? 7 : 8 / g.ntw;  // 7: rows of 56 leave none over
}

__host__ __device__ inline int out_rows(const GcGeom& g, int bh, int runs) {
  const int mt = item_tiles(g, runs), groups = (bh / 2 * runs + mt - 1) / mt;
  return 2 * ((groups * mt - 1) / runs + 1);
}

// ops/gconv_int8.py:spread_extent: the most aligned bytes (vec a copy) the
// staging copies around one slab's, where they are spread into the slots.
inline int spread_extent(const GcGeom& g, int G, int C, int vec) {
  int most = 0;
  for (int s = 0; s < g.slabs; ++s) {
    const int g0 = s * g.gs, gsl = G - g0 < g.gs ? G - g0 : g.gs;
    const int lo = (g0 * g.Cg) & -vec, hi0 = ((g0 + gsl) * g.Cg + vec - 1) & -vec;
    const int hi = hi0 < C ? hi0 : C;
    most = hi - lo > most ? hi - lo : most;
  }
  return most;
}

// Byte offsets in the dynamic shared memory; ops/gconv_int8.py:gconv_smem
// computes the same total.
struct GcLayout {
  int koff, cols, buf, buf_bytes, obuf, total;
  __host__ __device__ GcLayout(const GcGeom& g, int rh, int wp, int ps, int bh, int ow, int cso,
                               int nb)
      : koff(g.ws * g.ks * g.nt * 256),
        cols(koff + g.ks * 32),
        buf(cols + g.ws * g.nt * 128),
        buf_bytes((rh * wp * ps + 15) / 16 * 16),
        obuf(buf + (nb > 1 ? 2 : 1) * buf_bytes),
        total(obuf + (out_rows(g, bh, ow / 8) * ow * cso + 15) / 16 * 16) {}
};

struct GcArgs {
  const int8_t* x;       // (N, H, W, C)
  const int8_t* x_end;   // one past x's last byte
  const uint8_t* wpk;    // B fragments (nwin, ks, nt, 32, 2) words
  const float* w_scale;  // (C,)
  const float* bias;     // (C,)
  const int* w_sum;      // (C,)
  int8_t* out;           // (N, Ho, Wo, C)
  GcGeom g;
  int N, H, W, C, G, Ho, Wo, zp_s, out_zp;
  float in_scale, s_out, r_out;  // r_out = RN(1 / s_out)
  int bh, nb, vec, ps, vec_out, rh, wp, runs, ow, cso, bands;  // the plan
};

// Rows iy0 .. iy0 + rh - 1 of image n, pixels ix = -1 .. wp - 2: bytes c0 ..
// c0 + cpp vec - 1 of each pixel into buf at ps bytes a pixel by cp.async,
// vec bytes each, zp_s outside the image; pieces at or past `valid` bytes
// skipped. Where the groups fill their slots (Cg 4 or a multiple of 8), that
// is the slab itself (c0 = g0 Cg, its gsl Cg bytes valid; the pieces past
// them meet zero weights); else the aligned bytes around the slab's, which
// spread_words then moves into the slots.
__device__ __forceinline__ void stage_async(const GcArgs& a, uint8_t* buf, int n, int c0, int cpp,
                                            int valid, int iy0) {
  const uint32_t zw = (uint32_t)(uint8_t)a.zp_s * 0x01010101u;
  const int lanes = GC_THREADS / cpp;
  const int j = threadIdx.x % cpp, pl = threadIdx.x / cpp;
  if (pl >= lanes) return;
  const bool ch_ok = j * a.vec < valid;
  const int c = c0 + j * a.vec;
  for (int r = 0; r < a.rh; ++r) {
    const int iy = iy0 + r;
    const bool row_in = ch_ok && iy >= 0 && iy < a.H;
    const int8_t* src = a.x + ((long long)n * a.H + (row_in ? iy : 0)) * a.W * a.C + (ch_ok ? c : 0);
    uint8_t* dst = buf + r * a.wp * a.ps + j * a.vec;
    for (int px = pl; px < a.wp; px += lanes) {
      const int ix = px - 1;
      uint8_t* d = dst + px * a.ps;
      const bool in = row_in && ix >= 0 && ix < a.W;
      const int8_t* s = src + (long long)(in ? ix : 0) * a.C;
      switch (a.vec) {  // the same case for every thread of the block
        case 16:
          if (in) sm90::cp_async16(d, s, 16);  // L2 only: the bytes are read once
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

// The slab's words spread into their slots in place, after stage_async
// copied the aligned bytes raw_lo .. of x's pixels to the start of each staged
// pixel: word d = (window wd, word i) of a pixel takes the 4 bytes at the
// slab's byte (g0 + grp) Cg + 4 i - gi slot (its group grp = wd gw + gi) by
// one __byte_perm of two staged words; a warp reads every word of its pixels
// before it writes any (4 x 32 / nd pixels a warp pass, nd words a pixel).
// zp_s outside the image.
__device__ __forceinline__ void spread_words(const GcArgs& a, uint8_t* buf, int g0, int gsl,
                                             int raw_lo, int iy0) {
  const uint32_t zw = (uint32_t)(uint8_t)a.zp_s * 0x01010101u;
  const int nd = a.g.ws * a.g.nwt, ppw = 32 / nd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = lane % nd, sub = lane / nd;
  const bool act = sub < ppw;
  const int wd = d / a.g.nwt, i = d - wd * a.g.nwt;
  const int gi = 4 * i / a.g.slot, grp = wd * a.g.gw + gi;
  const bool ch_ok = act && grp < gsl;
  const int o = ch_ok ? (g0 + grp) * a.g.Cg + 4 * i - gi * a.g.slot - raw_lo : 0;
  const int oa = o & ~3;
  const uint32_t sel = 0x3210u + 0x1111u * (uint32_t)(o & 3);
  const int npix = a.rh * a.wp, stride = GC_WARPS * ppw;
  constexpr int PU = 4;  // pixels a lane moves a pass: their reads, then their writes
  int pix = warp * ppw + sub, r = pix / a.wp, px = pix - r * a.wp;
  for (int base = warp * ppw; base < npix; base += PU * stride) {  // the same trips in a warp
    uint32_t w[PU];
    uint8_t* pb[PU];
    bool on[PU];
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      const int iy = iy0 + r, ix = px - 1;
      on[u] = act && pix < npix;
      pb[u] = buf + pix * a.ps;
      w[u] = zw;
      if (on[u] && ch_ok && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        w[u] = __byte_perm(*reinterpret_cast<const uint32_t*>(pb[u] + oa),
                           *reinterpret_cast<const uint32_t*>(pb[u] + oa + 4), sel);
      pix += stride;
      px += stride;
      while (px >= a.wp) {
        px -= a.wp;
        ++r;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PU; ++u)
      if (on[u]) *reinterpret_cast<uint32_t*>(pb[u] + 4 * d) = w[u];
  }
}

// The same tile for any Cg and any alignment of x: word i of window wd of a
// staged pixel holds input channels 4 i' .. 4 i' + 3 of the window's group gi
// (4 i = gi slot + 4 i'), bytes past Cg whatever follows them in x. Each word
// comes from the two aligned words of x around its first byte by one
// __byte_perm (the second clamped to x's last word: it then holds no byte of
// the group). Four pixels' loads are issued before their stores.
__device__ __forceinline__ void stage_words(const GcArgs& a, uint8_t* buf, int n, int g0, int gsl,
                                            int iy0) {
  constexpr int U = 4;
  const uint32_t zw = (uint32_t)(uint8_t)a.zp_s * 0x01010101u;
  const int nd = a.g.ws * a.g.nwt, lanes = GC_THREADS / nd;
  const int d = threadIdx.x % nd, pl = threadIdx.x / nd;
  if (pl >= lanes) return;
  const int wd = d / a.g.nwt, i = d - wd * a.g.nwt;
  const int gi = 4 * i / a.g.slot, grp = wd * a.g.gw + gi;
  const bool ch_ok = grp < gsl;
  const int ch = ch_ok ? (g0 + grp) * a.g.Cg + 4 * i - gi * a.g.slot : 0;
  const uintptr_t last = (reinterpret_cast<uintptr_t>(a.x_end) - 1) & ~(uintptr_t)3;
  for (int r = 0; r < a.rh; ++r) {
    const int iy = iy0 + r;
    const bool row_in = ch_ok && iy >= 0 && iy < a.H;
    const int8_t* src = a.x + ((long long)n * a.H + (row_in ? iy : 0)) * a.W * a.C + ch;
    uint8_t* dst = buf + r * a.wp * a.ps + 4 * d;
    for (int px0 = pl; px0 < a.wp; px0 += U * lanes) {
      uint32_t lo[U], hi[U], sel[U];
      bool in[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int ix = px0 + u * lanes - 1;
        in[u] = row_in && ix >= 0 && ix < a.W;
        const uintptr_t p = reinterpret_cast<uintptr_t>(src + (long long)(in[u] ? ix : 0) * a.C);
        const uintptr_t pa = p & ~(uintptr_t)3, pb = pa + 4 < last ? pa + 4 : last;
        sel[u] = 0x3210u + 0x1111u * (uint32_t)(p & 3);
        lo[u] = in[u] ? *reinterpret_cast<const uint32_t*>(pa) : zw;
        hi[u] = in[u] ? *reinterpret_cast<const uint32_t*>(pb) : zw;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int px = px0 + u * lanes;
        if (px < a.wp)
          *reinterpret_cast<uint32_t*>(dst + px * a.ps) = in[u] ? __byte_perm(lo[u], hi[u], sel[u])
                                                                 : zw;
      }
    }
  }
}

// The quotient RN(y / s) for y >= 0 in fp32 alone: r = RN(1 / s), q = RN(y r)
// (within 1.5 ulp of y / s), then one correction q + RN(y - q s) r in a
// single fma (y - q s by an fma too). ops/gconv_int8.py:quotient_rn is the
// same sequence; chip_smoke.py's gconv_quotient phase holds it equal to
// div_rn_by (== __fdiv_rn) over every y below the clip at each served s.
__device__ __forceinline__ float quot_rn(float y, float s, float r) {
  const float q = __fmul_rn(y, r);
  return __fmaf_rn(__fmaf_rn(-q, s, y), r, q);
}

// The output value rint(y / s_out) + zp_out clipped to [0, 255] of the sum
// `acc` (from the mma, started at the column's base) for column record c =
// {base, s_in s_w, bias, out byte}: the plain version's epilogue step by
// step. q >= 0, so RINT_MAGIC + q rounds to the bits of RINT_MAGIC + rint(q)
// for q < 2^22 and to larger bits past it (and a NaN from an overflowing
// quotient is CUDA's positive canonical one): less zpk = bits(RINT_MAGIC) -
// zp_out that is rint(q) + zp_out, and past 255 for every larger q; an
// unsigned minimum clips it (a negative NaN's bits would clip to 255 too).
__device__ __forceinline__ uint32_t out_q(int acc, const int4& c, float s, float r, int zpk) {
  const float y = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), __int_as_float(c.y)),
                                  __int_as_float(c.z)), 0.f);
  const uint32_t t = (uint32_t)(__float_as_int(__fadd_rn(quot_rn(y, s, r), RINT_MAGIC)) - zpk);
  return min(t, 255u);
}

// mma_s8 without `volatile`: the compiler may then move the step's shared
// loads ahead of all its mma.
__device__ __forceinline__ void mma_f(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two output values as the 16 bits of their shifted int8 bytes (q - 128).
__device__ __forceinline__ uint32_t pack2(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x0040) ^ 0x8080u;
}

// The outputs of the staged tile into the output tile ob (output row oy_l,
// x ox at (oy_l ow + ox) cso). A warp item is (window chunk p: window w, n8
// tiles c0 .. c0 + NTW - 1; group mg of MT (item_tiles) consecutive m16 tiles),
// p fastest, item it = warp + 8 k: MT NTW mma a k32 step, the step's A
// offsets and B fragments loaded once for all MT tiles. Items of windows past
// the slab's wsl (a ragged last slab) and m16 tiles past the tile's are
// skipped.
template <int S, int NTW, int MT>
__device__ __forceinline__ void compute_tile(const GcArgs& a, const uint8_t* buf,
                                             const uint8_t* bsm, const int2* kof,
                                             const int4* cols, uint8_t* ob, int wsl) {
  const GcGeom& g = a.g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
  const int ncs = __ffs(g.nt / NTW) - 1, P = g.ws << ncs;  // chunks a window: a power of 2
  const int mtn = (a.bh >> 1) * a.runs, items = (mtn + MT - 1) / MT * P;
  const int sp = GC_WARPS % P, smg = GC_WARPS / P;
  const int zpk = RINT_BITS - a.out_zp;
  const bool even = (g.Cg & 1) == 0;
  const int orow = a.ow * a.cso;  // the m16 tile's second output row
  int p = warp % P, mg = warp / P;
  for (int it = warp; it < items; it += GC_WARPS) {
    const int w = p >> ncs, c0 = (p - (w << ncs)) * NTW;
    if (w < wsl) {
      // consecutive m16 tiles: along x, then the next row pair; those past
      // the band's (the last item's) load the first one's inputs and store
      // to rows of the output tile that are never copied out
      const int m0 = mg * MT, nm = mtn - m0;
      int rp = m0 / a.runs, run = m0 - rp * a.runs;
      int base[MT], obase[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        base[m] = (2 * rp * S * a.wp + (run * 8 + gid) * S) * a.ps + w * g.win;
        obase[m] = (2 * rp * a.ow + run * 8 + gid) * a.cso;
        if (m > 0 && m >= nm) base[m] = base[0];
        if (++run == a.runs) {
          run = 0;
          ++rp;
        }
      }
      const int4* cw = cols + (w * g.nt + c0) * 8 + 2 * tig;
      int acc[MT][NTW][4];
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int b0 = cw[8 * j].x, b1 = cw[8 * j + 1].x;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][j][0] = b0;
          acc[m][j][1] = b1;
          acc[m][j][2] = b0;
          acc[m][j][3] = b1;
        }
      }
      const uint2* bw = reinterpret_cast<const uint2*>(bsm) + (w * g.ks * g.nt + c0) * 32 + lane;
      for (int s = 0; s < g.ks; ++s) {
        const int2 ko = kof[4 * s + tig];
        uint32_t bf[NTW][2];
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const uint2 b = bw[(s * g.nt + j) * 32];
          bf[j][0] = b.x;
          bf[j][1] = b.y;
        }
        uint32_t af[MT][4];  // every load of the step before its mma
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint8_t* px = buf + base[m];
          const uint2 r0 = *reinterpret_cast<const uint2*>(px + ko.x);  // row gid
          const uint2 r1 = *reinterpret_cast<const uint2*>(px + ko.y);  // row gid + 8
          af[m][0] = r0.x;
          af[m][1] = r1.x;
          af[m][2] = r0.y;
          af[m][3] = r1.y;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NTW; ++j) mma_f(acc[m][j], af[m], bf[j]);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int4 k0 = cw[8 * j], k1 = cw[8 * j + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const uint32_t q00 = out_q(acc[m][j][0], k0, a.s_out, a.r_out, zpk);
          const uint32_t q01 = out_q(acc[m][j][1], k1, a.s_out, a.r_out, zpk);
          const uint32_t q10 = out_q(acc[m][j][2], k0, a.s_out, a.r_out, zpk);
          const uint32_t q11 = out_q(acc[m][j][3], k1, a.s_out, a.r_out, zpk);
          uint8_t* o0 = ob + obase[m];
          if (even) {  // columns 2 tig, 2 tig + 1: both real or both pad, adjacent bytes
            *reinterpret_cast<uint16_t*>(o0 + k0.w) = (uint16_t)pack2(q00, q01);
            *reinterpret_cast<uint16_t*>(o0 + orow + k0.w) = (uint16_t)pack2(q10, q11);
          } else {
            o0[k0.w] = (uint8_t)(q00 ^ 0x80u);
            o0[orow + k0.w] = (uint8_t)(q10 ^ 0x80u);
            o0[k1.w] = (uint8_t)(q01 ^ 0x80u);
            o0[orow + k1.w] = (uint8_t)(q11 ^ 0x80u);
          }
        }
      }
    }
    p += sp;
    if (p >= P) {
      p -= P;
      ++mg;
    }
    mg += smg;
  }
}

// The output tile's rows oy0 .. (those below Ho) and x below Wo to out, the
// slab's gsl Cg bytes of each pixel in vec_out-byte pieces.
__device__ __forceinline__ void copy_out(const GcArgs& a, const uint8_t* ob, int n, int oy0,
                                         int g0, int gsl) {
  // thread: piece k of pixels p0, p0 + step, ... (row r, x ox kept by steps,
  // not divisions)
  const int cpp = gsl * a.g.Cg / a.vec_out, rows = min(a.bh, a.Ho - oy0);
  const int step = GC_THREADS / cpp, k = threadIdx.x % cpp;
  if (threadIdx.x >= step * cpp) return;
  int r = 0, ox = threadIdx.x / cpp;
  while (ox >= a.Wo) {
    ox -= a.Wo;
    ++r;
  }
  for (; r < rows;) {
    const uint8_t* s = ob + (r * a.ow + ox) * a.cso + k * a.vec_out;
    int8_t* d = a.out + (((long long)n * a.Ho + oy0 + r) * a.Wo + ox) * a.C + g0 * a.g.Cg +
                k * a.vec_out;
    switch (a.vec_out) {  // the same case for every thread of the block
      case 16: *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s); break;
      case 8: *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s); break;
      case 4: *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s); break;
      case 2: *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s); break;
      default: *d = (int8_t)*s;
    }
    ox += step;
    while (ox >= a.Wo) {
      ox -= a.Wo;
      ++r;
    }
  }
}

// At most 128 registers a thread, so that two blocks share an SM; gconv_plan
// weighs the blocks its shared memory lets an SM hold.
template <int S>
__global__ void __launch_bounds__(GC_THREADS, 2) gconv_kernel(const GcArgs a) {
  extern __shared__ __align__(16) uint8_t gc_smem[];
  const GcGeom& g = a.g;
  const GcLayout L(g, a.rh, a.wp, a.ps, a.bh, a.ow, a.cso, a.nb);
  int2* kof = reinterpret_cast<int2*>(gc_smem + L.koff);
  int4* cols = reinterpret_cast<int4*>(gc_smem + L.cols);
  uint8_t* ob = gc_smem + L.obuf;
  // windows w0 .. w0 + wsl - 1 (groups g0 .. g0 + gsl - 1) of slab blockIdx.y;
  // tiles t0 .. t0 + nt - 1 of the N x bands (image, band) tiles; tile buffer
  // i & 1 at gc_smem + L.buf + (i & 1) * L.buf_bytes (computed, not taken
  // from an array, so that its loads stay shared-memory loads)
  const int w0 = blockIdx.y * g.ws, wsl = min(g.ws, g.nwin - w0);
  const int g0 = blockIdx.y * g.gs, gsl = min(g.gs, a.G - g0);
  const int t0 = blockIdx.x * a.nb, nt = min(a.nb, a.N * a.bands - t0);
  const bool async = a.vec != 1, spread = async && g.Cg != g.slot;
  // the bytes the staging copies: the slab's, or, to be spread, the aligned
  // bytes around them
  const int raw_lo = (g0 * g.Cg) & -a.vec;
  const int raw_hi = min(a.C, ((g0 + gsl) * g.Cg + a.vec - 1) & -a.vec);
  const int c0 = spread ? raw_lo : g0 * g.Cg;
  const int cpp = spread ? (raw_hi - raw_lo) / a.vec : g.ws * g.win / a.vec;
  const int valid = spread ? raw_hi - raw_lo : gsl * g.Cg;

  // the slab's B fragments: contiguous in wpk, 16 bytes a copy
  const uint8_t* wsrc = a.wpk + (long long)w0 * g.ks * g.nt * 256;
  for (int i = threadIdx.x; i < wsl * g.ks * g.nt * 16; i += GC_THREADS)
    sm90::cp_async16(gc_smem + 16 * i, wsrc + 16 * i, 16);
  sm90::cp_async_commit();
  const auto stage = [&](int t, uint8_t* buf) {
    const int n = t / a.bands, band = t - n * a.bands;
    if (async) {
      stage_async(a, buf, n, c0, cpp, valid, band * a.bh * S - 1);
      sm90::cp_async_commit();
    } else {
      stage_words(a, buf, n, g0, gsl, band * a.bh * S - 1);
    }
  };
  if (async) stage(t0, gc_smem + L.buf);  // in flight while the tables are made
  // the A offsets of k step s, lane quarter tig: K words 8 s + 2 tig and
  // the next (ops/gconv_int8.py:k_word), from the m16 tile's first and
  // second output rows
  const int sr = S * a.wp * a.ps;
  for (int i = threadIdx.x; i < 4 * g.ks; i += GC_THREADS) {
    const int lo = koff_of(g, 8 * (i >> 2) + 2 * (i & 3), a.wp, a.ps);
    kof[i] = make_int2(lo, lo + sr);
  }
  // a record per column of the slab's windows: the mma's start (-zp_s w_sum),
  // s_in s_w, the bias, the output byte (for a
  // pad column, or a group past G, the last two pad bytes of the pixel,
  // never copied out)
  for (int i = threadIdx.x; i < g.ws * g.nt * 8; i += GC_THREADS) {
    const int wl = i / (g.nt * 8), col = i - wl * g.nt * 8;
    const int gi = col / g.slot, co = col - gi * g.slot, grp = wl * g.gw + gi;
    const bool ok = wl < wsl && col < g.win && co < g.Cg && grp < gsl;
    const int ch = ok ? (g0 + grp) * g.Cg + co : 0;
    const int b = ok ? -a.zp_s * a.w_sum[ch] : 0;
    cols[i] = make_int4(b,
                        __float_as_int(ok ? __fmul_rn(a.w_scale[ch], a.in_scale) : 0.f),
                        __float_as_int(ok ? a.bias[ch] : 0.f), ok ? grp * g.Cg + co : a.cso - 2);
  }
  for (int i = 0; i < nt; ++i) {
    uint8_t* buf = gc_smem + L.buf + (async ? (i & 1) * L.buf_bytes : 0);
    if (!async) {
      __syncthreads();  // the previous tile's items are done with the buffer
      stage(t0 + i, buf);
      sm90::cp_async_wait<0>();
    } else if (i + 1 < nt) {  // the next tile's copies fly while this one is computed
      stage(t0 + i + 1, gc_smem + L.buf + ((i + 1) & 1) * L.buf_bytes);
      sm90::cp_async_wait<1>();
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    const int t = t0 + i, n = t / a.bands, band = t - n * a.bands;
    if (spread) {
      spread_words(a, buf, g0, gsl, raw_lo, band * a.bh * S - 1);
      __syncthreads();
    }
    if (g.ntw == 1 && a.runs % 7 == 0)  // item_tiles
      compute_tile<S, 1, 7>(a, buf, gc_smem, kof, cols, ob, wsl);
    else if (g.ntw == 1)
      compute_tile<S, 1, 8>(a, buf, gc_smem, kof, cols, ob, wsl);
    else if (g.ntw == 2)
      compute_tile<S, 2, 4>(a, buf, gc_smem, kof, cols, ob, wsl);
    else
      compute_tile<S, 4, 2>(a, buf, gc_smem, kof, cols, ob, wsl);
    __syncthreads();
    copy_out(a, ob, n, band * a.bh, g0, gsl);
  }
}

// The check of quot_rn on the card, over every float32 y >= 0 below +inf,
// against div_rn_by(y) and __fdiv_rn(y, s): bad[0] counts the y in
// [2^-90, y_hi) whose quotient differs in any bit; bad[1] the y below y_hi
// whose rint (q + RINT_MAGIC, the byte the epilogue writes for every zero
// point) differs; bad[2] the y from y_hi on (past 511 s) whose quotient is
// neither NaN nor at least 511 (the division's clips to 255); bad[3] the
// largest bits of a y whose quotient differs anywhere below y_hi (where
// the fp32 steps leave the normal range: their rint is 0 alike).
__global__ void quotient_check_kernel(float s, float r, double rs, uint32_t y_hi,
                                      unsigned long long* bad) {
  constexpr uint32_t Y_LO = 0x12800000u;  // 2^-90
  unsigned long long nq = 0, nr = 0, nc = 0, top = 0;
  const uint32_t step = gridDim.x * blockDim.x;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b < 0x7F800000u; b += step) {
    const float y = __uint_as_float(b);
    const float q = quot_rn(y, s, r);
    if (b < y_hi) {
      const float qd = div_rn_by(y, rs), qf = __fdiv_rn(y, s);
      const bool differs = __float_as_uint(q) != __float_as_uint(qd) ||
                           __float_as_uint(q) != __float_as_uint(qf);
      nq += differs && b >= Y_LO;
      top = differs && b > top ? b : top;
      const uint32_t rq = __float_as_uint(__fadd_rn(q, RINT_MAGIC));
      nr += rq != __float_as_uint(__fadd_rn(qd, RINT_MAGIC)) ||
            rq != __float_as_uint(__fadd_rn(qf, RINT_MAGIC));
    } else {
      nc += q < 511.f;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    nq += __shfl_xor_sync(0xffffffffu, nq, o);
    nr += __shfl_xor_sync(0xffffffffu, nr, o);
    nc += __shfl_xor_sync(0xffffffffu, nc, o);
    const unsigned long long t = __shfl_xor_sync(0xffffffffu, top, o);
    top = t > top ? t : top;
  }
  if ((threadIdx.x & 31) == 0) {
    if (nq) atomicAdd(bad, nq);
    if (nr) atomicAdd(bad + 1, nr);
    if (nc) atomicAdd(bad + 2, nc);
    if (top) atomicMax(bad + 3, top);
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
// (ws, bh, nb, vec, ps, vec_out, smem) is ops/gconv_int8.py:gconv_plan's, with vec the
// widest x's address allows. Only the ReLU + requant route exists. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments or a plan the kernel does not take.
extern "C" int ievm_gconv_int8(const void* x, const void* wpk, const void* w_scale,
                               const void* bias, const void* w_sum, void* out, int N, int H, int W,
                               int C, int G, int stride, int zp_s, float in_scale, float s_out,
                               float out_zp, int ws, int bh, int nb, int vec,
                               int ps, int vec_out, int smem, void* stream) {
  using namespace ievm;
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || G <= 0 || C % G != 0 ||
      (stride != 1 && stride != 2) || zp_s < -128 || zp_s > 127 || !(s_out > 0.f) ||
      !(out_zp >= 0.f && out_zp <= 255.f) || out_zp != (float)(int)out_zp)
    return (int)cudaErrorInvalidValue;
  GcGeom g = gc_geom(C, G);
  if (g.Cg > GC_MAX_SLAB || ws < 1 || ws > g.ws) return (int)cudaErrorInvalidValue;
  g.ws = ws;  // the plan's slab: at most the geometry's widest
  g.gs = ws * g.gw;
  g.slabs = (g.nwin + ws - 1) / ws;
  const float r_out = 1.0f / s_out;  // RN: the host divides in IEEE single precision
  if (!(r_out < INFINITY)) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int runs = (Wo + 7) / 8, ow = runs * 8;
  const int rh = (bh - 1) * stride + 3, wp = (ow - 1) * stride + 3;
  const int cs = g.ws * g.win, cso = out_stride(g.gs * g.Cg);
  const int last = (G - (g.slabs - 1) * g.gs) * g.Cg;
  if (bh < 2 || bh % 2 != 0 || bh > Ho + 1 || nb < 1) return (int)cudaErrorInvalidValue;
  if (vec != 1 && ((vec != 4 && vec != 8 && vec != 16) || C % vec != 0 ||
                   (g.Cg == g.slot && cs % vec != 0) ||
                   reinterpret_cast<uintptr_t>(x) % vec != 0))
    return (int)cudaErrorInvalidValue;
  if (ps < cs || ps % 8 != 0 || (vec != 1 && ps % vec != 0)) return (int)cudaErrorInvalidValue;
  if (vec != 1 && g.Cg != g.slot && ps < spread_extent(g, G, C, vec) + 8)
    return (int)cudaErrorInvalidValue;
  if ((vec_out != 1 && vec_out != 2 && vec_out != 4 && vec_out != 8 && vec_out != 16) ||
      C % vec_out != 0 || (g.gs * g.Cg) % vec_out != 0 || last % vec_out != 0 ||
      reinterpret_cast<uintptr_t>(out) % vec_out != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wpk) % 16 != 0) return (int)cudaErrorInvalidValue;
  const int bands = (Ho + bh - 1) / bh;
  if ((long long)N * bands > 0x7fffffffLL || nb > N * bands || g.slabs > 65535 ||
      smem != GcLayout(g, rh, wp, ps, bh, ow, cso, nb).total || smem > GC_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int8_t* xb = static_cast<const int8_t*>(x);
  GcArgs a{xb, xb + (long long)N * H * W * C, static_cast<const uint8_t*>(wpk),
           static_cast<const float*>(w_scale), static_cast<const float*>(bias),
           static_cast<const int*>(w_sum), static_cast<int8_t*>(out), g,
           N, H, W, C, G, Ho, Wo, zp_s, (int)out_zp, in_scale, s_out, r_out,
           bh, nb, vec, ps, vec_out, rh, wp, runs, ow, cso, bands};
  const dim3 grid((N * bands + nb - 1) / nb, g.slabs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(stride == 1 ? launch<1>(a, grid, smem, st) : launch<2>(a, grid, smem, st));
}

// quotient_check_kernel for s > 0 (normal, 1 / s finite), y_hi past 512 s;
// bad: 4 device counters, zeroed by the caller. Returns cudaGetLastError()
// after the launch.
extern "C" int ievm_gconv_quotient_check(float s, void* bad, void* stream) {
  using namespace ievm;
  const float r = 1.0f / s;
  if (!(s > 0.f) || !(r < INFINITY) || !(512.f * s < INFINITY)) return (int)cudaErrorInvalidValue;
  const float y_max = 512.f * s;
  uint32_t hi;
  memcpy(&hi, &y_max, sizeof hi);
  quotient_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, r, 1.0 / (double)s, hi + 1u, static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}
