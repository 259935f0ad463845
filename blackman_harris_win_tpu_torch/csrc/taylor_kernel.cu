// Quarter-wave-LUT + 1st-order-Taylor sine/cosine (the TAYLOR source) on
// Hopper (sm_90a).
//
// Replaces blackman_harris_win_tpu/kernels/pallas/taylor_kernel.py:
// make_checksum_fn_taylor with three kernels over one generator:
//   taylor_sincos_kernel    writes c and s for [n0, n0+count);
//   taylor_window_kernel    the HLS 2/3-term TAYLOR window: harmonic 1 at PW,
//                           harmonic 2 at PW-1 (the reference's one-bit-
//                           narrower generator), wrap or saturate to W bits;
//   taylor_checksum_kernel  the int32-wrap sum of c+s over [n0, n0+count),
//                           nothing stored.
// A fourth, taylor_window_rtl_kernel, replaces no Pallas kernel: it is the
// TAYLOR window under the RTL (VHDL) contract, the jnp of
// blackman_harris_win_tpu/kernels/window.py:_window_rtl with the TAYLOR
// cosine, which the JAX package leaves to XLA.  It runs the window
// kernel's tiles and generators and only accumulates differently (see
// rtl_field and taylor_window_rtl_kernel).
// The semantics are those of model/golden.py:taylor_sincos and
// tay1_correction (src/taylor_sincos.vhd, src/tay1_order.vhd).
//
// What bounds it on the H100: integer issue (the write-outs also store 8
// or 4 bytes a sample).  The design follows from the generator's structure:
//
// - Regimes at compile time.  kLut covers the LUT regimes (PW-LS < 2
//   over-wide, PW-LS == 2 exact, and tay1 where ramb_pi rounds to 0, PW-LS
//   >= 23, whose correction is 0); kTayNarrow and kTayWide are tay1 with
//   the W < 19 and W >= 19 arithmetic.  The host picks the instance; W, PW
//   and LS stay runtime values.
// - Runs.  R = 2^(PW-LS-2) consecutive samples share one ROM entry and one
//   quadrant, and along a run mpi = ramb_pi * acnt steps by ramb_pi.  A lane
//   takes kG samples of one run (8 in the write-outs, 16 in the checksum):
//   it reads the entry once, picks the quadrant's form once (which ROM word
//   is the base, which is multiplied, the signs, the W < 19 rounding
//   offset), and advances the run's mpi by the exact step ramb_pi from
//   sample to sample; each product is one 32x32+64 multiply-add (see
//   walk_out for why not an advanced 64-bit product).  The products are
//   scaled by 2^sc so that the shift by 19+LS is the high word (LS <= 13)
//   or the high word shifted by LS-13: no 64-bit shift.  A lane whose
//   samples leave their run (run boundaries, R < kG, LS = 0) computes each
//   sample on its own, in the int64 form.
// - 32-bit words.  Everything after the shift is done mod 2^32 in uint32
//   and wrapped to W bits once per output.  Why that is exact:
//     * ROM entries are in [0, 2^(W-1) - 1] (first-quadrant cos/sin at
//       amplitude 2^(W-1) - 1), so they fit int32.
//     * mpi = ramb_pi * acnt < 2^20: with STAGE = PW-LS-3 and acnt <
//       2^(STAGE+1), ramb_pi <= pi * 2^(17-STAGE) + 1/2 gives mpi < pi * 2^18
//       + 2^STAGE < 2^20 for STAGE <= 17; STAGE 18 and 19 have ramb_pi 2 and
//       1 (mpi < 2^20); from STAGE 20 on ramb_pi is 0 (kLut).  So
//       |mult * mpi| < 2^31 * 2^20 = 2^51 is exact in int64 and (mult * mpi)
//       >> (19+LS) is the exact floor.  In the run walk, sc = max(13-LS, 0)
//       gives mpi * 2^sc < 2^(33-LS) <= 2^32 for LS >= 1 (and so J * ramb_pi
//       * 2^sc, which is at most that), and mult * mpi * 2^sc + 2^(32+rs) <
//       2^63 + 2^49: each fits its unsigned word.
//     * Every later step of the reference is +, -, or a wrap to W <= 32
//       bits, and x -> x mod 2^W factors through x mod 2^32.  So the low 32
//       bits of the shifted product, added in uint32 and wrapped to W bits,
//       give the reference's W-bit value, whatever the magnitudes before the
//       wrap (wrapw(a - wrapw(b)) == wrapw(a - b): the reference's inner
//       wrap of the sliced product is the same ring map).
//     * The W >= 19 clamp acts on the wrapped W-bit value, as the
//       reference's does; the steered negations then act on values in [0,
//       2^(W-1) - 1] and need no wrap.  With W < 19 the negation is taken
//       before the one wrap: wrapw(-wrapw(x)) == wrapw(-x).
//   Wrapping arithmetic is done in unsigned types (defined); right shifts of
//   negative values are arithmetic under nvcc.
// - Stores.  The write-outs lay a warp's 32 * kG samples out so that lane l
//   holds samples 4l + 128h + j (h < kG/4, j < 4): each int4 store of the
//   warp covers 512 contiguous bytes.  The checksum gives each lane kG
//   consecutive samples and sums mod 2^32 (per lane, warp, block, then one
//   atomicAdd per block: exact in any order).
// - The ROM is read through the read-only cache: one load per lane per run
//   walk, the same address across a warp.  Staging it in shared memory
//   measured within 2% of this (PERF.md, Findings), so the simpler stays.
// - The write-outs' int4 stores need c, s and out 16-byte aligned; their C
//   entries refuse other pointers (cudaErrorInvalidValue).
//
// The ROM comes from the host (numpy float64, as the JAX package builds
// it): cos() on the device rounds differently.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned u32;

constexpr int kThreads = 256;
constexpr int kMaxTerms = 3;

enum Regime { kNone = 0, kLut = 1, kTayNarrow = 2, kTayWide = 3 };

// One generator instance: phase width, data width, LUT size, and the
// correction's phase constant round(pi * 2^(17-STAGE)) (tay1 regime only).
struct Gen {
  int pw, w, ls, ramb_pi;
};

// A generator's per-launch constants.
struct GenK {
  u64 pmask;     // 2^PW - 1
  u64 qmask;     // 2^(PW-2) - 1
  int qshift;    // PW - 2
  int shr, shl;  // ROM address = (phase >> shr) << shl
  u32 rmask;     // R - 1 (tay1 regimes, R <= 2^20)
  int ramb, xs, ws;  // ramb_pi, 19 + LS, 32 - W
  int top;           // 2^(W-1) - 1
  // the run walk's unsigned form: products scaled by 2^sc, floor(./2^xs) =
  // hi32 >> rs (sc = max(32 - xs, 0), rs = max(xs - 32, 0)), rambs =
  // ramb_pi << sc, off = 2^(32+rs) - 1, pw2 = 2^ws; walk: a tay1 regime
  // with LS >= 1 (mpi * 2^sc < 2^(33-LS) <= 2^32)
  int sc, rs;
  u32 rambs, pw2;
  u64 off;
  bool walk;
};

int regime_of(const Gen& g) {
  if (g.pw - g.ls <= 2 || g.ramb_pi == 0) return kLut;
  return g.w < 19 ? kTayNarrow : kTayWide;
}

GenK consts(const Gen& g) {
  const int d = g.pw - g.ls;
  GenK k;
  k.pmask = (1ull << g.pw) - 1;
  k.qmask = (1ull << (g.pw - 2)) - 1;
  k.qshift = g.pw - 2;
  k.shr = d >= 2 ? d - 2 : 0;
  k.shl = d >= 2 ? 0 : 2 - d;
  k.rmask = regime_of(g) == kLut ? 0u : (u32)((1ull << (d - 2)) - 1);
  k.ramb = g.ramb_pi;
  k.xs = 19 + g.ls;
  k.ws = 32 - g.w;
  k.top = (int)((1ll << (g.w - 1)) - 1);
  k.sc = k.xs < 32 ? 32 - k.xs : 0;
  k.rs = k.xs > 32 ? k.xs - 32 : 0;
  k.rambs = (u32)g.ramb_pi << k.sc;
  k.pw2 = 1u << k.ws;
  k.off = (1ull << (32 + k.rs)) - 1;
  k.walk = regime_of(g) != kLut && g.ls >= 1;
  return k;
}

// Two's-complement wrap of a 32-bit word to W = 32 - ws bits.
__device__ __forceinline__ int wrapw(u32 v, int ws) { return (int)(v << ws) >> ws; }

// One output (cos: kSin = 0, sin: kSin = 1) in quadrant q from ROM entry e,
// sample by sample: value = sgn * clamp(wrap(base + tsgn * floor(mult * mpi
// / 2^xs))) for kTayWide, wrap(sgn * (base + floor(mult * mpi / 2^xs))) for
// kTayNarrow, sgn * base for kLut.  The reference's steering: c = (mc, -ms,
// -mc, ms), s = (ms, mc, -ms, -mc) for q = 0..3, with mc = cos +
// corr(-sin) and ms = sin + corr(cos).
struct Form {
  int base, mult, tsgn, sgn;
};

__device__ __forceinline__ bool ms_form(int q, int sin) { return ((q & 1) != 0) != (sin != 0); }
__device__ __forceinline__ int steer_sign(int q, int sin) {
  return (sin ? q >= 2 : (q == 1 || q == 2)) ? -1 : 1;
}

template <int kReg, int kSin>
__device__ __forceinline__ Form form(int q, int2 e) {
  Form f;
  f.sgn = steer_sign(q, kSin);
  if (ms_form(q, kSin)) {
    f.base = e.y;
    f.mult = e.x;
    f.tsgn = 1;
  } else {
    f.base = e.x;
    f.mult = kReg == kTayNarrow ? -e.y : e.y;
    f.tsgn = kReg == kTayNarrow ? 1 : -1;
  }
  return f;
}

template <int kReg>
__device__ __forceinline__ int finish(const Form& f, i64 p, const GenK& g) {
  if constexpr (kReg == kLut) {
    return f.sgn * f.base;
  } else {
    const u32 v = (u32)f.base + (u32)f.tsgn * (u32)(p >> g.xs);
    if constexpr (kReg == kTayNarrow) {
      return wrapw((u32)f.sgn * v, g.ws);
    } else {
      int m = wrapw(v, g.ws);
      m = m < 0 ? g.top : m;
      return f.sgn * m;
    }
  }
}

// (cos, sin) at one sample index n (taken mod 2^PW), on its own.
template <int kReg, bool kSin>
__device__ __forceinline__ void sample(u64 n, const GenK& g, const int2* rom, int& c, int& s) {
  const u64 cnt = n & g.pmask;
  const int q = (int)(cnt >> g.qshift);
  const u64 ph = cnt & g.qmask;
  const int2 e = __ldg(rom + ((ph >> g.shr) << g.shl));
  const int mpi = kReg == kLut ? 0 : g.ramb * (int)((u32)ph & g.rmask);
  const Form fc = form<kReg, 0>(q, e);
  c = finish<kReg>(fc, (i64)fc.mult * mpi, g);
  if constexpr (kSin) {
    const Form fs = form<kReg, 1>(q, e);
    s = finish<kReg>(fs, (i64)fs.mult * mpi, g);
  }
}

// One output along a run, in unsigned words: the product P = mult * mpi *
// 2^sc (+ off) gives floor(mult * mpi / 2^xs) = hi32(P) >> rs (xs = 32 + rs
// - sc).  P is one 32x32+64 multiply-add from the run's mpi * 2^sc, which
// advances by the exact step J * ramb_pi * 2^sc (one 32-bit add for cos and
// sin).  Forming the two products once a run and advancing them by 64-bit
// adds of mult * ramb_pi * 2^sc takes two dependent instructions per output
// where the multiply-add is one, and measured 12-15% slower in the checksum
// (PERF.md, Findings).  Every factor is >= 0 (mult is the ROM word itself),
// so the W < 19 form's floor(-sin * mpi / 2^xs) = -ceil(sin * mpi / 2^xs) adds off = 2^(32+rs) -
// 1 once, to the run's first product.  The W >= 19 clamp: with u =
// wrapped-value * 2^ws as a 32-bit word, min(u, 2^31 - 1) >> ws is the
// W-bit value where it is >= 0 and top = 2^(W-1) - 1 where it is < 0.
struct Walk {
  u32 base, mult, tsgn, msgn;  // msgn: the steering sign times 2^ws (W < 19)
  int sgn;
  u64 off;
};

template <int kReg, int kSin>
__device__ __forceinline__ Walk walk_form(int q, int2 e, const GenK& g) {
  Walk f;
  f.sgn = steer_sign(q, kSin);
  f.msgn = (u32)f.sgn << g.ws;
  f.off = 0;
  if (ms_form(q, kSin)) {
    f.base = (u32)e.y;
    f.mult = (u32)e.x;
    f.tsgn = 1u;
  } else {
    f.base = (u32)e.x;
    f.mult = (u32)e.y;
    f.tsgn = ~0u;
    if (kReg == kTayNarrow) f.off = g.off;
  }
  return f;
}

template <int kReg, bool kRs>
__device__ __forceinline__ int walk_out(const Walk& f, u64 p, const GenK& g) {
  u32 t = (u32)(p >> 32);
  if constexpr (kRs) t >>= g.rs;
  const u32 v = f.base + f.tsgn * t;
  if constexpr (kReg == kTayNarrow) {
    return (int)(v * f.msgn) >> g.ws;
  } else {
    return f.sgn * (int)(min(v * g.pw2, 0x7fffffffu) >> g.ws);
  }
}

// Lane layouts: the write-outs (kVec) give a lane 8 samples, 4 consecutive
// and the 4 a warp's 128 samples on, so each int4 store of a warp covers
// 512 contiguous bytes; the checksum gives a lane 16 consecutive samples.
template <bool kVec>
constexpr int kG = kVec ? 8 : 16;
template <bool kVec>
__host__ __device__ constexpr int lane_step(int k) {
  return kVec ? 128 * (k / 4) + k % 4 : k;
}
template <bool kVec>
constexpr int kSpan = lane_step<kVec>(kG<kVec> - 1);

// One generator's values at a lane's samples n_a + lane_step(k), k < kG,
// those with lane_step(k) < left: walking the run where all lie in one (and
// LS >= 1, which the unsigned form needs), sample by sample otherwise.
template <int kReg, bool kSin, bool kVec, bool kRs>
__device__ __forceinline__ void gen_values(u64 n_a, i64 left, const GenK& g, const int2* rom,
                                           int (&c)[kG<kVec>], int (&s)[kG<kVec>]) {
  if constexpr (kReg != kLut) {
    const u64 cnt = n_a & g.pmask;
    const u64 ph = cnt & g.qmask;
    const u32 acnt = (u32)ph & g.rmask;
    if (g.walk && left > kSpan<kVec> && acnt + kSpan<kVec> <= g.rmask) {
      const int q = (int)(cnt >> g.qshift);
      const int2 e = __ldg(rom + (ph >> g.shr));
      const u32 mpi0s = (u32)g.ramb * acnt << g.sc;
      const Walk fc = walk_form<kReg, 0>(q, e, g);
      const Walk fs = walk_form<kReg, 1>(q, e, g);
#pragma unroll
      for (int k = 0; k < kG<kVec>; ++k) {
        // mpi * 2^sc at the k-th sample: < 2^32 inside the run
        const u32 mpis = mpi0s + (u32)lane_step<kVec>(k) * g.rambs;
        c[k] = walk_out<kReg, kRs>(fc, (u64)mpis * fc.mult + fc.off, g);
        if constexpr (kSin) s[k] = walk_out<kReg, kRs>(fs, (u64)mpis * fs.mult + fs.off, g);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kG<kVec>; ++k)
    if (lane_step<kVec>(k) < left) sample<kReg, kSin>(n_a + lane_step<kVec>(k), g, rom, c[k], s[k]);
}

// Store a lane's 8 write-out values: int4 stores when all are in range.
__device__ __forceinline__ void store(int* __restrict__ out, i64 i0, i64 left,
                                      const int (&v)[kG<true>]) {
  if (left > kSpan<true>) {
#pragma unroll
    for (int h = 0; h < kG<true> / 4; ++h)
      *reinterpret_cast<int4*>(out + i0 + 128 * h) =
          make_int4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kG<true>; ++k)
      if (lane_step<true>(k) < left) out[i0 + lane_step<true>(k)] = v[k];
  }
}

// The grid-stride walk over warp tiles of 32 * kG samples: body(n_a, i0,
// left) for each lane, n_a its first sample index, i0 its first output,
// left = count - i0 > 0.
template <bool kVec, class Body>
__device__ __forceinline__ void tiles(u64 n0, i64 count, Body body) {
  constexpr int tile = 32 * kG<kVec>;
  const int lane = threadIdx.x & 31;
  const i64 first = kVec ? 4 * lane : kG<kVec> * lane;
  const i64 warps = (i64)gridDim.x * (blockDim.x / 32);
  for (i64 t = ((i64)blockIdx.x * blockDim.x + threadIdx.x) / 32; t * tile < count; t += warps) {
    const i64 i0 = t * tile + first;
    if (i0 < count) body(n0 + (u64)i0, i0, count - i0);
  }
}

// Run kernel body<kRs> with kRs = (rs != 0), decided once per launch (the
// LS <= 13 generators need no shift after the high word).
#define BHW_BY_RS(rs, ...)        \
  do {                            \
    if (rs) {                     \
      constexpr bool kRs = true;  \
      __VA_ARGS__;                \
    } else {                      \
      constexpr bool kRs = false; \
      __VA_ARGS__;                \
    }                             \
  } while (0)

template <int kReg>
__global__ void __launch_bounds__(kThreads)
taylor_sincos_kernel(int* __restrict__ c_out, int* __restrict__ s_out, u64 n0, i64 count,
                     const int2* __restrict__ rom, const GenK g) {
  BHW_BY_RS(g.rs, tiles<true>(n0, count, [&](u64 n_a, i64 i0, i64 left) {
    int c[kG<true>], s[kG<true>];
    gen_values<kReg, true, true, kRs>(n_a, left, g, rom, c, s);
    store(c_out, i0, left, c);
    store(s_out, i0, left, s);
  }));
}

struct WinParams {
  int coeffs[kMaxTerms];
  GenK gen[kMaxTerms - 1];  // harmonic k runs gen[k-1]
  int w, saturate;
  // taylor_window_rtl_kernel's tree (rtl_tree_consts): the fields' scale
  // 2^(32-W) and its negation, n1's bias beta and the constant c
  u32 rscale, rnscale, rbeta;
  u64 rc;
};

// The window write-outs' walk: per lane, harmonic 1's cosine (gen[0], at
// PW) and, for a 3-term window (kReg2 != kNone), harmonic 2's (gen[1], at
// PW-1) at its 8 samples, then acc(c1, c2, v) turns them into the 8
// outputs v, which are stored.  c2 is not written for a 2-term window.
template <int kReg1, int kReg2, class Acc>
__device__ __forceinline__ void window_tiles(int* __restrict__ out, u64 n0, i64 count,
                                             const int2* __restrict__ rom, const WinParams& P,
                                             Acc acc) {
  BHW_BY_RS(P.gen[0].rs, tiles<true>(n0, count, [&](u64 n_a, i64 i0, i64 left) {
    int c1[kG<true>], c2[kG<true>], unused[kG<true>], v[kG<true>];
    gen_values<kReg1, false, true, kRs>(n_a, left, P.gen[0], rom, c1, unused);
    if constexpr (kReg2 != kNone)
      gen_values<kReg2, false, true, kRs>(n_a, left, P.gen[1], rom, c2, unused);
    acc(c1, c2, v);
    store(out, i0, left, v);
  }));
}

// HLS: a0 - m1 + m2, m_k = (a_k * cos_k) >> (W-1) (full-scale source); kReg2
// is kNone for a 2-term window.  |a_k| < 2^31 and |cos_k| <= 2^(W-1) make
// each product exact in int64 and |m_k| < 2^31, so m_k is the funnel shift
// of the product's two words by W-1 <= 31.  Wrap needs the sum mod 2^32
// only; saturate clamps the exact int64 sum.
template <int kReg1, int kReg2>
__global__ void __launch_bounds__(kThreads)
taylor_window_kernel(int* __restrict__ out, u64 n0, i64 count, const int2* __restrict__ rom,
                     const WinParams P) {
  const int sh = P.w - 1, ws = 32 - P.w;
  const i64 hi = (1ll << sh) - 1, lo = -(1ll << sh);
  const u32 pw2 = 1u << ws;
  window_tiles<kReg1, kReg2>(out, n0, count, rom, P, [&](const int (&c1)[kG<true>],
                                                         const int (&c2)[kG<true>],
                                                         int (&v)[kG<true>]) {
    int m1[kG<true>], m2[kG<true>];
#pragma unroll
    for (int k = 0; k < kG<true>; ++k) {
      const i64 p1 = (i64)P.coeffs[1] * c1[k];
      m1[k] = (int)__funnelshift_r((u32)p1, (u32)(p1 >> 32), sh);
      m2[k] = 0;
      if constexpr (kReg2 != kNone) {
        const i64 p2 = (i64)P.coeffs[2] * c2[k];
        m2[k] = (int)__funnelshift_r((u32)p2, (u32)(p2 >> 32), sh);
      }
    }
    if (P.saturate) {
#pragma unroll
      for (int k = 0; k < kG<true>; ++k) {
        const i64 acc = (i64)P.coeffs[0] - m1[k] + m2[k];
        v[k] = (int)(acc > hi ? hi : (acc < lo ? lo : acc));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kG<true>; ++k)
        v[k] = (int)(((u32)P.coeffs[0] - (u32)m1[k] + (u32)m2[k]) * pw2) >> ws;
    }
  });
}

// RTL term of harmonic k (src/bh_win_3term.vhd:257-280, hamming_win.vhd:
// 194-210): b_k = wrap(rhu0(wrap(p >> (W-2), W+1)), W), p = a_k * cos_k,
// rhu0(r) = (r >> 1) + (r & 1) = floor((r + 1) / 2).  The W+1-bit wrap
// subtracts a multiple of 2^(W+1) from t = floor(p / 2^(W-2)), which moves
// floor((t + 1) / 2) by a multiple of 2^W, and the W-bit wrap after it
// removes that; floor((floor(p / 2^(W-2)) + 1) / 2) = floor((p + 2^(W-2)) /
// 2^(W-1)).  So b_k = wrap((p + 2^(W-2)) >> (W-1), W): one multiply-add
// (|p| < 2^62, exact in int64) and the funnel shift of its two words by
// W-1 <= 31, whose low W bits are b_k's (W <= 32).  rtl_field returns that
// word times scale plus bias, mod 2^32: with scale = +-2^(32-W) (pw2) it is
// bias +- b_k * 2^(32-W), the field f_k = b_k * 2^(32-W) being an exact
// int32.  The scale and the bias are one IMAD on the FMA pipe, beside the
// ALU's funnel shift.
__device__ __forceinline__ u32 rtl_field(int a, int c, i64 half, int sh, u32 scale, u32 bias) {
  const i64 p = (i64)a * c + half;
  return __funnelshift_r((u32)p, (u32)(p >> 32), sh) * scale + bias;
}

// RTL: the alternating tree T = a0 - b1 (+ b2) is wrapped to W+s bits and
// rounded half up off bit s-1 to W bits: s = 1 for the 2-term core
// (hamming_win.vhd:211-231, a W+1-bit subtract, (pp >> 1) + (pp & 1)), s =
// 2 for the 3-term one (bh_win_3term.vhd:282-306, a W+2-bit tree, (pp >> 2)
// + ((pp >> 1) & 1)).  Both are floor((T + 2^(s-1)) / 2^s) wrapped to W
// bits, which depends on T mod 2^(W+s) only: out = bits [s, s+W-1] of T +
// 2^(s-1), sign-extended.  The tree is 33 or 34 bits wide at W = 31, 32, so
// it is taken at the fields' scale in 32-bit words, T' = (T + 2^(s-1)) *
// 2^(32-W) = A - f1 + f2 with A = (a0 + 2^(s-1)) * 2^(32-W), and out =
// floor(T' / 2^s) mod 2^32, shifted right by 32-W (arithmetic).  The terms
// enter as unsigned words, biased in their IMAD so that each lies in [0,
// 2^32) for every int32 field: n1 = beta - f1, u2 = f2 + 2^31.
// - 3 terms: n1 = 2^31 - 1 - f1, T' = C + n1 + u2 with the constant C = A +
//   1 - 2^32.  Its low word is (C_lo + n1 + u2) mod 2^32 and its high word
//   C_hi plus the two carries out of that sum: one IADD3 with two carry-outs
//   and one IADD3.X, and floor(T' / 4) mod 2^32 is the funnel shift of the
//   two words by 2.
// - 2 terms: T' = C + n1 with C = A - beta odd, so floor(T' / 2) = (C - 1) /
//   2 + ceil(n1 / 2) = (C - 1) / 2 + n1 - (n1 >> 1): one shift, one IADD3,
//   no carry.  beta = 2^31 - 1 + (A & 1): where A is even (always, for W <
//   32) n1 = 2^31 - 1 - f1 is in [0, 2^32) for every f1; A is odd only at W
//   = 32, where f1 = b1 >= -(2^31 - 1) (|a_1| < 2^31, |cos_1| <= 2^31: b1 =
//   floor((p + 2^30) / 2^31) >= floor(-(2^31 - 1) + 1/2)), so n1 = 2^31 - f1
//   is too.
// Every W from 2 to 32 takes this code, with as many ALU instructions a
// sample as a tree held in one uint32 word (the fields' two shifts to its
// scale, a sum, the output's shift) would take: a sum, its carry word, the
// funnel shift and the output's shift for 3 terms; a shift, a sum and the
// output's shift for 2.  The output register is W bits wide: "saturate" and
// "wrap" give the same result and nothing is clamped.  Five blocks an SM (up
// to 48 registers a thread): without the bound, ptxas held 3 of the
// instantiations to 32 or 40 registers by spilling a value to the stack;
// with it none spills.
template <int kReg1, int kReg2>
__global__ void __launch_bounds__(kThreads, 5)
taylor_window_rtl_kernel(int* __restrict__ out, u64 n0, i64 count,
                         const int2* __restrict__ rom, const WinParams P) {
  constexpr int s = kReg2 == kNone ? 1 : 2;
  const int sh = P.w - 1, ws = 32 - P.w;
  const i64 half = 1ll << (P.w - 2);
  window_tiles<kReg1, kReg2>(out, n0, count, rom, P, [&](const int (&c1)[kG<true>],
                                                         const int (&c2)[kG<true>],
                                                         int (&v)[kG<true>]) {
#pragma unroll
    for (int k = 0; k < kG<true>; ++k) {
      const u32 n1 = rtl_field(P.coeffs[1], c1[k], half, sh, P.rnscale, P.rbeta);
      u32 t;
      if constexpr (s == 1) {
        t = (u32)P.rc + n1 - (n1 >> 1);
      } else {
        const u32 u2 = rtl_field(P.coeffs[2], c2[k], half, sh, P.rscale, 0x80000000u);
        // zero-extended words: ptxas adds them as one IADD3 with two
        // carry-outs and an IADD3.X of c's high word
        const u64 acc = P.rc + n1 + u2;
        t = __funnelshift_r((u32)acc, (u32)(acc >> 32), 2);
      }
      v[k] = (int)t >> ws;
    }
  });
}

// The constants of taylor_window_rtl_kernel's tree, from a0, W and the
// term count, set on the host: read from the parameter bank they cost the
// kernel nothing, and the scale, unknown to the compiler, stays a multiply
// (an IMAD with the bias as its addend) where 1u << ws would become a shift
// and an XOR on the ALU pipe.
void rtl_tree_consts(WinParams& P, int nterms) {
  const int s = nterms - 1, ws = 32 - P.w;
  const i64 a = ((i64)P.coeffs[0] + (1 << (s - 1))) * (1ll << ws);  // A, |A| < 2^62
  P.rscale = 1u << ws;
  P.rnscale = 0u - P.rscale;
  P.rbeta = s == 1 ? 0x7fffffffu + (u32)(a & 1) : 0x7fffffffu;
  // 2 terms: (C - 1) / 2 with C = A - beta; 3 terms: C = A + 1 - 2^32
  P.rc = s == 1 ? (u64)((a - (i64)P.rbeta - 1) >> 1) : (u64)(a + 1 - (1ll << 32));
}

// Sum mod 2^32 is associative and commutative, so the per-lane, per-warp
// and cross-block (atomicAdd) partial sums give a bit-exact total in any
// block order.  *out holds the bias on entry.  The lanes' groups are
// aligned to multiples of kG in n (runs are too), so an unaligned n0 sends
// no lane off its run but the first: the walk starts lead = n0 mod kG
// samples early and leaves them out of the sum.
template <int kReg>
__global__ void __launch_bounds__(kThreads)
taylor_checksum_kernel(unsigned* __restrict__ out, u64 n0, i64 count,
                       const int2* __restrict__ rom, const GenK g) {
  const int lead = (int)(n0 & (kG<false> - 1));
  unsigned acc = 0;
  BHW_BY_RS(g.rs, tiles<false>(n0 - lead, count + lead, [&](u64 n_a, i64 i0, i64 left) {
    int c[kG<false>], s[kG<false>];
    gen_values<kReg, true, false, kRs>(n_a, left, g, rom, c, s);
    if (left > kSpan<false> && i0 >= lead) {
#pragma unroll
      for (int k = 0; k < kG<false>; ++k) acc += (unsigned)c[k] + (unsigned)s[k];
    } else {
#pragma unroll
      for (int k = 0; k < kG<false>; ++k)
        if (k < left && i0 + k >= lead) acc += (unsigned)c[k] + (unsigned)s[k];
    }
  }));
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ unsigned warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sum[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) atomicAdd(out, acc);
  }
}

bool valid_gen(const Gen& g) {
  // ramb_pi > 0 only where the correction's products keep to the proof's
  // bounds (PW - LS <= 22, as round(pi * 2^(17-STAGE)) gives)
  return g.pw >= 2 && g.pw <= 62 && g.ls >= 0 && g.ls < g.pw && g.ls <= 30 && g.w >= 2 &&
         g.w <= 32 && g.ramb_pi >= 0 && g.ramb_pi <= 411775 &&
         (g.ramb_pi == 0 || g.pw - g.ls <= 22);
}

// One persistent grid of as many blocks as fit on the card at once, or
// fewer where count needs fewer.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), i64 count, cudaStream_t stream, A... args) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  i64 blocks = (count + (i64)kThreads * 8 - 1) / ((i64)kThreads * 8);
  if (blocks > (i64)sms * per_sm) blocks = (i64)sms * per_sm;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// What both window entries check and set up: 2..kMaxTerms terms, |a_k| <
// 2^31, valid generators at PW (and PW-1 for a third term), n0 >= 0, an
// output on 16 bytes.  False on a refusal; else P and the generators'
// regimes r1, r2 (kNone without a third term).
bool win_setup(WinParams& P, int& r1, int& r2, const int* out, i64 n0, int pw, int w, int ls,
               const i64* coeffs, int nterms, int ramb_pi1, int ramb_pi2, int saturate) {
  if (nterms < 2 || nterms > kMaxTerms || n0 < 0 || !aligned16(out)) return false;
  P = WinParams{};
  for (int k = 0; k < kMaxTerms; ++k) {
    const i64 a = k < nterms ? coeffs[k] : 0;
    if (a <= -(1ll << 31) || a >= (1ll << 31)) return false;
    P.coeffs[k] = (int)a;
  }
  const Gen g1{pw, w, ls, ramb_pi1}, g2{pw - 1, w, ls, ramb_pi2};
  if (!valid_gen(g1) || (nterms == 3 && !valid_gen(g2))) return false;
  P.gen[0] = consts(g1);
  P.gen[1] = nterms == 3 ? consts(g2) : P.gen[0];
  P.w = w;
  P.saturate = saturate;
  r1 = regime_of(g1);
  r2 = nterms == 3 ? regime_of(g2) : kNone;
  return true;
}

}  // namespace

extern "C" {

int bhw_taylor_sincos_block(int* c, int* s, i64 n0, i64 count, const int* rom, int pw,
                            int w, int ls, int ramb_pi, void* stream) {
  const Gen g{pw, w, ls, ramb_pi};
  if (!valid_gen(g) || n0 < 0 || !aligned16(c) || !aligned16(s)) return (int)cudaErrorInvalidValue;
  const GenK k = consts(g);
  const cudaStream_t st = (cudaStream_t)stream;
  const int2* r = (const int2*)rom;
  switch (regime_of(g)) {
    case kLut: return launch(taylor_sincos_kernel<kLut>, count, st, c, s, (u64)n0, count, r, k);
    case kTayNarrow: return launch(taylor_sincos_kernel<kTayNarrow>, count, st, c, s, (u64)n0, count, r, k);
    default: return launch(taylor_sincos_kernel<kTayWide>, count, st, c, s, (u64)n0, count, r, k);
  }
}

int bhw_taylor_window_block(int* out, i64 n0, i64 count, const int* rom, int pw, int w,
                            int ls, const i64* coeffs, int nterms, int ramb_pi1,
                            int ramb_pi2, int saturate, void* stream) {
  WinParams P;
  int r1, r2;
  if (!win_setup(P, r1, r2, out, n0, pw, w, ls, coeffs, nterms, ramb_pi1, ramb_pi2, saturate))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int2* r = (const int2*)rom;
#define BHW_WIN(A, B)             \
  if (r1 == A && r2 == B)         \
    return launch(taylor_window_kernel<A, B>, count, st, out, (u64)n0, count, r, P);
  BHW_WIN(kLut, kNone) BHW_WIN(kLut, kLut) BHW_WIN(kLut, kTayNarrow) BHW_WIN(kLut, kTayWide)
  BHW_WIN(kTayNarrow, kNone) BHW_WIN(kTayNarrow, kLut) BHW_WIN(kTayNarrow, kTayNarrow)
  BHW_WIN(kTayWide, kNone) BHW_WIN(kTayWide, kLut) BHW_WIN(kTayWide, kTayWide)
#undef BHW_WIN
  return (int)cudaErrorInvalidValue;
}

int bhw_taylor_window_rtl(int* out, i64 n0, i64 count, const int* rom, int pw, int w, int ls,
                          const i64* coeffs, int nterms, int ramb_pi1, int ramb_pi2,
                          void* stream) {
  WinParams P;
  int r1, r2;
  if (!win_setup(P, r1, r2, out, n0, pw, w, ls, coeffs, nterms, ramb_pi1, ramb_pi2, 0))
    return (int)cudaErrorInvalidValue;
  rtl_tree_consts(P, nterms);
  const cudaStream_t st = (cudaStream_t)stream;
  const int2* r = (const int2*)rom;
#define BHW_RTL(A, B)         \
  if (r1 == A && r2 == B)     \
    return launch(taylor_window_rtl_kernel<A, B>, count, st, out, (u64)n0, count, r, P);
  // every regime pair the HLS entry takes
  BHW_RTL(kLut, kNone) BHW_RTL(kTayNarrow, kNone) BHW_RTL(kTayWide, kNone)
  BHW_RTL(kLut, kLut) BHW_RTL(kLut, kTayNarrow) BHW_RTL(kLut, kTayWide)
  BHW_RTL(kTayNarrow, kLut) BHW_RTL(kTayNarrow, kTayNarrow)
  BHW_RTL(kTayWide, kLut) BHW_RTL(kTayWide, kTayWide)
#undef BHW_RTL
  return (int)cudaErrorInvalidValue;
}

int bhw_taylor_checksum(unsigned* out, i64 n0, i64 count, const int* rom, int pw, int w,
                        int ls, int ramb_pi, void* stream) {
  const Gen g{pw, w, ls, ramb_pi};
  if (!valid_gen(g) || n0 < 0) return (int)cudaErrorInvalidValue;
  const GenK k = consts(g);
  const cudaStream_t st = (cudaStream_t)stream;
  const int2* r = (const int2*)rom;
  switch (regime_of(g)) {
    case kLut: return launch(taylor_checksum_kernel<kLut>, count, st, out, (u64)n0, count, r, k);
    case kTayNarrow: return launch(taylor_checksum_kernel<kTayNarrow>, count, st, out, (u64)n0, count, r, k);
    default: return launch(taylor_checksum_kernel<kTayWide>, count, st, out, (u64)n0, count, r, k);
  }
}

}  // extern "C"
