// The taylor2 window (second-order-Taylor fast mode, the -180 dB regime)
// written out on Hopper (sm_90a).
//
// Replaces the jnp of blackman_harris_win_tpu/kernels/fastwin.py:75
// cos_sin_taylor2 and :123 window_values_fast (no pallas_call: XLA fuses
// it); in eager torch the same window is some 40 int64 launches a harmonic
// over the whole block (kernels/fastwin.py's plain version).  One launch
// writes the int32 window over [n0, n0 + count).  Per sample n (mod 2^32)
// and harmonic k:
//
//   ph     = (k * n) mod 2^PW              one uint32 product: 2^PW | 2^32
//   q, low = ph >> (PW-2), ph mod 2^(PW-2)
//   rb <= 0: (c0, s0) = rom[low << -rb], no correction
//   else:    (c0, s0) = rom[low >> rb], acnt = low mod 2^rb
//            d  = acnt * P_hi (+ (acnt * P_lo) >> 12 when P_lo and rb+12 <= 31)
//            dh = d >> 15, e = dh * dh
//            mc = c0 - (d * s0 >> S) - (e * c0 >> 2S-29)
//            ms = s0 + (d * c0 >> S) - (e * s0 >> 2S-29)
//   cos    = mc, -ms, -mc, ms for q = 0..3            (wrapped to 32 bits)
//   acc   -+= (a_k * cos) >> (W-2)                    (wrapped to 32 bits)
//
// then the W-bit wrap, or the clamp when W < 32 and the overflow mode
// saturates (at W = 32 the int32 accumulator is the output and nothing is
// clamped: the JAX function's behaviour).
//
// Exactness.  The ROM holds first-quadrant values in [0, 2^(W-2)-1], d <
// (pi/2) 2^29 < 2^29.66 (plus < 2^rb from P_lo), e < 2^30: every product
// is non-negative and below 2^62, so each 64-bit unsigned product and its
// shift is the reference's exact floor.  Only one of mc, ms is the cosine
// of a quadrant (odd q takes ms), so a harmonic computes two products, not
// four.  Everything after the shifts is +, -, or a wrap to 32 or W bits,
// and x -> x mod 2^W factors through x mod 2^32: the sums are taken in
// uint32 (defined wrapping), and only the low 32 bits of (a_k * cos) >>
// (W-2) are kept (W-2 <= 30, one funnel shift).  Further, for the run walk:
//
// - With S = LS + 29 >= 32 (LS >= 3), floor(d * b / 2^S) is the high word
//   of the 32 x 32 product shifted by S - 32 (a floor of a floor), and
//   floor(e * a / 2^(2S-29)) the high word shifted by 2S - 61: no 64-bit
//   shift.
// - The first-order term is a (t1 ^ 0) or a (-t1) by the quadrant, so
//   val = a - t2 + s1 * t1 with s1 = +-1, one IMAD.  |val| < 2^(W-2) + 2^28
//   < 2^31 (t1 < 2^(59.66-S) <= 2^27.66, t2 < 2^(59.32-2S+29) < 2^25), so
//   the quadrant's negation of val never wraps, and a_k * (-val) ==
//   (-a_k) * val exactly: the sign goes into the coefficient once a run.
// - Along a run (the samples that share a ROM entry and a quadrant) the
//   residual count acnt steps by k from sample to sample, so d's P_hi part
//   acnt * P_hi and its P_lo numerator acnt * P_lo step by k P_hi and k
//   P_lo times the gap to the lane's next sample.  The walk checks acnt *
//   P_hi >= 2^rb * P_hi (P_hi > 0) at every sample and, past it, enters the
//   sample's own ROM entry and quadrant from its phase (any number of
//   entries on), so d is always that of an acnt below 2^rb, as the
//   reference's.  Between two checks acnt grows by at most k * kMaxGap, so
//   each product the check and d read stays below 2^32 when (2^rb - 1 +
//   kMaxGap (K-1)) * P_hi and (with P_lo) * P_lo do: the host's condition
//   for the walk (fastwin_kernel.py:walk_regime), which this file checks
//   again.
// - The re-entry is rare (a lane leaves a run about k * 387 / 2^rb times a
//   harmonic) and must stay a branch: where ptxas if-converted it into
//   some 15 predicated instructions on every sample (builds that stepped
//   acnt itself and took both products a sample, or that took a_k * val
//   through an inline PTX mul.wide.s32), the walk took 0.58-0.60 ms against
//   0.46-0.49 at BH-7 W=32 LS=12 pw=26 on an H100 (probe_kernel_variants.py).
//   chip_smoke.py prints the predicated instructions of a pass.
//
// What bounds it on the H100: integer issue.  Each sample writes 4 bytes
// (0.08 ms for 2^26 samples at 3.35 TB/s) and needs per harmonic the
// Taylor correction's products and shifts (utils/profiling.py:
// taylor2_window_ops).  Four compile-time regimes, picked by the host:
//
//   kRomOnly    rb <= 0: a ROM read a sample and harmonic;
//   kPerSample  short runs or LS < 3: each sample computes its phase, ROM
//               entry, quadrant and correction on its own, 4 consecutive
//               samples a thread, one 16-byte store;
//   kWalk,      the run walk, without and with the P_lo term.  At rb > 0
//   kWalkLo     harmonic k keeps one ROM entry and one quadrant for 2^rb/k
//               consecutive samples (682 at BH-7, pw=26, LS=12), so a lane
//               reads the entry and picks the quadrant's form (which word is
//               the base and which multiplied, the signs) once a run, and a
//               sample costs d from two exact steps (an add or IMAD each and
//               one LEA.HI) and its check, dh, e, two high-word products and
//               shifts, the IMAD of val, a_k * val and its funnel shift,
//               and the accumulate: two harmonics a pass share one IADD3.
//
// The walk lays a warp's 512 samples out as the Taylor kernel's write-outs
// do (csrc/taylor_kernel.cu): lane l holds samples 4l + 128h + j (h, j <
// 4), so each int4 store of the warp covers 512 contiguous bytes; a lane's
// samples span 387, and leaving a run among them is one check's branch a
// sample, taken where a lane's acnt passes 2^rb.  Three blocks an SM
// (__launch_bounds__): 3% faster than the register count ptxas picks
// alone at BH-7 W=32 LS=12 pw=26 on an H100 (probe_kernel_variants.py).  The coefficients are read from shared memory (the
// harmonic loop runs at the runtime count, two harmonics a pass), the
// quarter-wave ROM (2^LS x (cos, sin) int32: 32 KB at LS = 12, 128 KB at
// LS = 14) through the read-only cache (__ldg), once a run.  A copy of the
// ROM in shared memory, loaded once a block of a persistent grid, measured
// 7% slower than the read-only cache for the per-sample form at BH-7 W=32
// LS=12 pw=26 on an H100 (0.805 against 0.751 ms, chip_smoke.py).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;
constexpr int kVec = 4;  // samples a thread writes with one 16-byte store
constexpr int kGroups = 4;  // run walk: the int4 stores of a lane
constexpr int kWarpSamples = 32 * kVec * kGroups;  // 512 samples a warp in the run walk
constexpr int kMaxGap = 32 * kVec - (kVec - 1);  // 125: the widest step between a lane's samples

enum Regime : int { kRomOnly = 0, kPerSample = 1, kWalk = 2, kWalkLo = 3 };

struct Params {
  int a[kMaxTerms];  // a_0 .. a_{K-1}, |a_k| < 2^30
  int nterms;
  unsigned n0;       // n0 mod 2^32
  i64 count;
  unsigned pmask;    // 2^PW - 1
  int qshift;        // PW - 2
  unsigned lowmask;  // 2^(PW-2) - 1
  int rb;            // PW - 2 - LS
  unsigned amask;    // 2^rb - 1 (rb > 0)
  unsigned p_hi, p_lo;
  int use_lo;        // P_lo != 0 and rb + 12 <= 31
  int s, s2;         // S = LS + 29 and 2S - 29
  int s_hi, s2_hi;   // run walk: S - 32 and 2S - 61
  unsigned thr;      // run walk: 2^rb * P_hi
  int wshift;        // W - 2
  int w;
  int saturate;      // W < 32 and the overflow mode saturates
};

// the taylor2 cosine of phase ph as a 32-bit word
template <bool ROM_ONLY>
__device__ __forceinline__ unsigned cos_t2(unsigned ph, const int2* __restrict__ rom,
                                           const Params& P) {
  const unsigned q = ph >> P.qshift, low = ph & P.lowmask;
  const bool odd = q & 1;
  unsigned val;
  if constexpr (ROM_ONLY) {
    const int2 ent = __ldg(rom + (low << -P.rb));
    val = (unsigned)(odd ? ent.y : ent.x);
  } else {
    const int2 ent = __ldg(rom + (low >> P.rb));
    const unsigned acnt = low & P.amask;
    unsigned d = acnt * P.p_hi;
    if (P.use_lo) d += (acnt * P.p_lo) >> 12;
    const unsigned dh = d >> 15, e = dh * dh;
    const unsigned a = (unsigned)(odd ? ent.y : ent.x), b = (unsigned)(odd ? ent.x : ent.y);
    const unsigned t1 = (unsigned)(((u64)d * b) >> P.s);
    const unsigned t2 = (unsigned)(((u64)e * a) >> P.s2);
    val = odd ? a + t1 - t2 : a - t1 - t2;
  }
  return ((q + 1) & 2) ? 0u - val : val;  // q = 1, 2 negate
}

template <bool ROM_ONLY>
__device__ __forceinline__ unsigned sample(unsigned n, const int2* __restrict__ rom,
                                           const Params& P) {
  unsigned acc = (unsigned)P.a[0];
#pragma unroll
  for (int k = 1; k < kMaxTerms; ++k) {
    if (k >= P.nterms) break;
    const int c = (int)cos_t2<ROM_ONLY>(((unsigned)k * n) & P.pmask, rom, P);
    const unsigned m = (unsigned)(((i64)P.a[k] * c) >> P.wshift);
    acc = (k & 1) ? acc - m : acc + m;
  }
  return acc;
}

// the int32 accumulator to the output: the W-bit wrap, or the clamp
__device__ __forceinline__ int finish(unsigned acc, const Params& P) {
  if (P.saturate) {
    const int hi = (1 << (P.w - 1)) - 1;
    const int v = (int)acc;
    return v > hi ? hi : (v < -hi - 1 ? -hi - 1 : v);
  }
  const int up = 32 - P.w;
  return (int)(acc << up) >> up;
}

// one harmonic's run in the walk: its ROM entry and quadrant, and d's two
// parts at the lane's current sample
struct Run {
  unsigned dhi, lo;  // acnt * P_hi and acnt * P_lo (lo: with the P_lo term)
  unsigned a, b;     // the quadrant's base ROM word and its multiplied one
  unsigned s1;       // +1 (odd quadrant, cos = +-ms) or -1: the first-order term's sign
  int ak;            // a_k, negated in quadrants 1 and 2
};

// harmonic k's constants
struct Harmonic {
  unsigned k, kphi, kplo;  // k, k * P_hi, k * P_lo
  int a;                   // a_k
};

// the run that holds sample n (mod 2^32)
template <int R>
__device__ __forceinline__ Run enter(unsigned n, const Harmonic& h, const int2* __restrict__ rom,
                                     const Params& P) {
  const unsigned ph = (h.k * n) & P.pmask;
  const unsigned q = ph >> P.qshift, low = ph & P.lowmask;
  const int2 ent = __ldg(rom + (low >> P.rb));
  const unsigned acnt = low & P.amask;
  const bool odd = q & 1;
  Run r;
  r.a = (unsigned)(odd ? ent.y : ent.x);
  r.b = (unsigned)(odd ? ent.x : ent.y);
  r.s1 = odd ? 1u : ~0u;
  r.ak = ((q + 1) & 2) ? -h.a : h.a;
  r.dhi = acnt * P.p_hi;
  r.lo = R == kWalkLo ? acnt * P.p_lo : 0u;
  return r;
}

// (a_k * cos) >> (W-2), low word, of harmonic h at sample n, GAP samples
// past the lane's previous one
template <int R, int GAP>
__device__ __forceinline__ unsigned walk_term(Run& r, unsigned n, const Harmonic& h,
                                              const int2* __restrict__ rom, const Params& P) {
  if constexpr (GAP > 0) {
    r.dhi += GAP * h.kphi;  // acnt * P_hi: acnt steps by k a sample
    if constexpr (R == kWalkLo) r.lo += GAP * h.kplo;
    if (r.dhi >= P.thr) r = enter<R>(n, h, rom, P);  // acnt >= 2^rb: the sample left the run
  }
  unsigned d = r.dhi;
  if constexpr (R == kWalkLo) d += r.lo >> 12;
  const unsigned dh = d >> 15, e = dh * dh;
  const unsigned t1 = __umulhi(d, r.b) >> P.s_hi;
  const unsigned t2 = __umulhi(e, r.a) >> P.s2_hi;
  const int val = (int)(r.a - t2 + r.s1 * t1);
  return (unsigned)(((i64)r.ak * val) >> P.wshift);
}

// the lane's 16 samples nl + o of harmonic pass: acc[s] += (m1 - m0) for
// two harmonics (TWO) or -= m0 for one
template <int R, bool TWO>
__device__ __forceinline__ void walk_pass(unsigned (&acc)[kGroups * kVec], unsigned nl,
                                          const Harmonic& h0, const Harmonic& h1,
                                          const int2* __restrict__ rom, const Params& P) {
  Run r0 = enter<R>(nl, h0, rom, P), r1;
  if constexpr (TWO) r1 = enter<R>(nl, h1, rom, P);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const unsigned n = nl + (unsigned)(32 * kVec * g + j);
      unsigned m;
      if (j > 0) {
        m = walk_term<R, 1>(r0, n, h0, rom, P);
        if constexpr (TWO) m = walk_term<R, 1>(r1, n, h1, rom, P) - m;
      } else if (g > 0) {
        m = walk_term<R, kMaxGap>(r0, n, h0, rom, P);
        if constexpr (TWO) m = walk_term<R, kMaxGap>(r1, n, h1, rom, P) - m;
      } else {
        m = walk_term<R, 0>(r0, n, h0, rom, P);
        if constexpr (TWO) m = walk_term<R, 0>(r1, n, h1, rom, P) - m;
      }
      if constexpr (TWO) {
        acc[g * kVec + j] += m;
      } else {
        acc[g * kVec + j] -= m;
      }
    }
  }
}

__device__ __forceinline__ Harmonic harmonic(int k, const int* a, const Params& P) {
  return {(unsigned)k, (unsigned)k * P.p_hi, (unsigned)k * P.p_lo, a[k]};
}

template <int R>
__global__ void __launch_bounds__(kThreads, 3)
taylor2_window_kernel(int* __restrict__ out, const int2* __restrict__ rom, const Params P) {
  if constexpr (R == kWalk || R == kWalkLo) {
    __shared__ int coef[kMaxTerms];
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < kMaxTerms; ++k) coef[k] = P.a[k];  // constant indices
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const i64 warps = (P.count + kWarpSamples - 1) / kWarpSamples;
    const i64 stride = ((i64)gridDim.x * kThreads) >> 5;
    for (i64 wi = ((i64)blockIdx.x * kThreads + threadIdx.x) >> 5; wi < warps; wi += stride) {
      const i64 base = wi * kWarpSamples + kVec * lane;  // lane sample o at base + o
      const unsigned nl = P.n0 + (unsigned)(u64)base;
      unsigned acc[kGroups * kVec];
#pragma unroll
      for (int s = 0; s < kGroups * kVec; ++s) acc[s] = (unsigned)coef[0];
      int k = 1;
#pragma unroll 1
      for (; k + 1 < P.nterms; k += 2) {  // harmonics k (subtracted) and k + 1 (added)
        walk_pass<R, true>(acc, nl, harmonic(k, coef, P), harmonic(k + 1, coef, P), rom, P);
      }
      if (k < P.nterms) {  // the last harmonic, odd: subtracted
        const Harmonic h = harmonic(k, coef, P);
        walk_pass<R, false>(acc, nl, h, h, rom, P);
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const i64 at = base + 32 * kVec * g;
        int v[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = finish(acc[g * kVec + j], P);
        if (at + kVec <= P.count) {
          *reinterpret_cast<int4*>(out + at) = make_int4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            if (at + j < P.count) out[at + j] = v[j];
          }
        }
      }
    }
  } else {
    const i64 groups = (P.count + kVec - 1) / kVec;
    for (i64 g = (i64)blockIdx.x * kThreads + threadIdx.x; g < groups;
         g += (i64)gridDim.x * kThreads) {
      const i64 base = g * kVec;
      const unsigned n = P.n0 + (unsigned)(u64)base;
      int v[kVec];  // past the end of the range too: every phase is a valid ROM index
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = finish(sample<R == kRomOnly>(n + j, rom, P), P);
      if (base + kVec <= P.count) {
        *reinterpret_cast<int4*>(out + base) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (base + j < P.count) out[base + j] = v[j];
        }
      }
    }
  }
}

// whether the run walk's checks and steps stay in uint32 (see the note)
bool walk_fits(const Params& P) {
  if (P.rb <= 0 || P.s < 32) return false;
  const u64 reach = (1ull << P.rb) - 1 + (u64)kMaxGap * (P.nterms - 1);
  return reach * P.p_hi < (1ull << 32) && (!P.use_lo || reach * P.p_lo < (1ull << 32));
}

template <int R>
void launch(int* out, const int2* rom, const Params& P, i64 per_block, cudaStream_t st) {
  const i64 need = (P.count + per_block - 1) / per_block;
  const unsigned grid = (unsigned)(need < (1 << 20) ? need : (1 << 20));
  taylor2_window_kernel<R><<<grid, kThreads, 0, st>>>(out, rom, P);
}

}  // namespace

extern "C" {

// out: count int32, 16-byte aligned; rom: 2^ls (cos, sin) int32 pairs at
// amplitude 2^(w-2) - 1 on the card; coeffs: nterms int32 a_k.  p_hi,
// p_lo: kernels/fastwin.py:_phase_consts.  regime: kRomOnly (rb <= 0),
// kPerSample, or the run walk kWalk / kWalkLo (kernels/fastwin_kernel.py:
// walk_regime); a regime that does not fit the widths is refused.
int bhw_taylor2_window_block(void* out, i64 n0, i64 count, const void* rom, int pw, int w, int ls,
                             const int* coeffs, int nterms, unsigned p_hi, unsigned p_lo,
                             int saturate, int regime, void* stream) {
  if (pw < 2 || pw > 32 || w < 2 || w > 32 || ls < 0 || ls > 14 || nterms < 1 ||
      nterms > kMaxTerms || count < 1 || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  Params P;
  for (int k = 0; k < kMaxTerms; ++k) P.a[k] = k < nterms ? coeffs[k] : 0;
  P.nterms = nterms;
  P.n0 = (unsigned)(u64)n0;
  P.count = count;
  P.pmask = pw == 32 ? 0xFFFFFFFFu : (1u << pw) - 1;
  P.qshift = pw - 2;
  P.lowmask = (1u << (pw - 2)) - 1;
  P.rb = pw - 2 - ls;
  P.amask = P.rb > 0 ? (1u << P.rb) - 1 : 0;
  P.p_hi = p_hi;
  P.p_lo = p_lo;
  P.use_lo = p_lo != 0 && P.rb + 12 <= 31;
  P.s = ls + 29;
  P.s2 = 2 * P.s - 29;
  P.s_hi = P.s - 32;
  P.s2_hi = P.s2 - 32;
  P.thr = P.rb > 0 && P.rb < 32 ? (unsigned)(((u64)p_hi << P.rb) & 0xFFFFFFFFu) : 0u;
  P.wshift = w - 2;
  P.w = w;
  P.saturate = saturate != 0 && w < 32;
  const bool walk = regime == kWalk || regime == kWalkLo;
  if ((regime == kRomOnly) != (P.rb <= 0) || (walk && (!walk_fits(P) ||
                                                      (regime == kWalkLo) != (P.use_lo != 0))) ||
      regime < kRomOnly || regime > kWalkLo) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  int* o = (int*)out;
  const int2* r = (const int2*)rom;
  // a grid-stride walk: enough blocks to fill the card, a warp 512 samples
  // a step in the run walk, a thread 4 in the per-sample forms
  switch (regime) {
    case kRomOnly: launch<kRomOnly>(o, r, P, (i64)kVec * kThreads, st); break;
    case kPerSample: launch<kPerSample>(o, r, P, (i64)kVec * kThreads, st); break;
    case kWalk: launch<kWalk>(o, r, P, (i64)kWarpSamples * (kThreads / 32), st); break;
    default: launch<kWalkLo>(o, r, P, (i64)kWarpSamples * (kThreads / 32), st); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
