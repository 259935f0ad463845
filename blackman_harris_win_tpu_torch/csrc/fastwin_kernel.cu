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
// (W-2) are kept (W-2 <= 30, one funnel shift).
//
// What bounds it on the H100: integer issue.  Each sample writes 4 bytes
// (0.08 ms for 2^26 samples at 3.35 TB/s) and needs some 24 operations a
// harmonic (BH-7: 6 harmonics, 0.29 ms at the int32 issue rate).  So a
// thread computes 4 consecutive samples and writes them with one 16-byte
// store, the harmonics unroll with every coefficient a constant-bank
// operand, and the quarter-wave ROM (2^LS x (cos, sin) int32: 32 KB at
// LS = 12, 128 KB at LS = 14) is read through the read-only cache
// (__ldg): consecutive samples step the phase by k, so the 32 lanes of a
// warp read one or two neighbouring ROM entries in most steps.  A copy of
// the ROM in shared memory, loaded once a block of a persistent grid,
// measured 7% slower at BH-7 W=32 LS=12 pw=26 on an H100 (0.805 against
// 0.751 ms, chip_smoke.py), so the kernel does not keep one.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxTerms = 16;
constexpr int kVec = 4;  // samples a thread writes with one 16-byte store

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
__device__ __forceinline__ int sample(unsigned n, const int2* __restrict__ rom, const Params& P) {
  unsigned acc = (unsigned)P.a[0];
#pragma unroll
  for (int k = 1; k < kMaxTerms; ++k) {
    if (k >= P.nterms) break;
    const int c = (int)cos_t2<ROM_ONLY>(((unsigned)k * n) & P.pmask, rom, P);
    const unsigned m = (unsigned)(((i64)P.a[k] * c) >> P.wshift);
    acc = (k & 1) ? acc - m : acc + m;
  }
  if (P.saturate) {
    const int hi = (1 << (P.w - 1)) - 1;
    const int v = (int)acc;
    return v > hi ? hi : (v < -hi - 1 ? -hi - 1 : v);
  }
  const int up = 32 - P.w;
  return (int)(acc << up) >> up;
}

template <bool ROM_ONLY>
__global__ void __launch_bounds__(kThreads)
taylor2_window_kernel(int* __restrict__ out, const int2* __restrict__ rom, const Params P) {
  const i64 groups = (P.count + kVec - 1) / kVec;
  for (i64 g = (i64)blockIdx.x * kThreads + threadIdx.x; g < groups;
       g += (i64)gridDim.x * kThreads) {
    const i64 base = g * kVec;
    const unsigned n = P.n0 + (unsigned)(u64)base;
    int v[kVec];  // past the end of the range too: every phase is a valid ROM index
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = sample<ROM_ONLY>(n + j, rom, P);
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

}  // namespace

extern "C" {

// out: count int32, 16-byte aligned; rom: 2^ls (cos, sin) int32 pairs at
// amplitude 2^(w-2) - 1 on the card; coeffs: nterms int32 a_k.  p_hi,
// p_lo: kernels/fastwin.py:_phase_consts.
int bhw_taylor2_window_block(void* out, i64 n0, i64 count, const void* rom, int pw, int w, int ls,
                             const int* coeffs, int nterms, unsigned p_hi, unsigned p_lo,
                             int saturate, void* stream) {
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
  P.wshift = w - 2;
  P.w = w;
  P.saturate = saturate != 0 && w < 32;
  // a grid-stride walk: enough blocks to fill the card, each thread kVec
  // samples a step
  const i64 need = ((count + kVec - 1) / kVec + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(need < (1 << 20) ? need : (1 << 20));
  const cudaStream_t st = (cudaStream_t)stream;
  if (P.rb <= 0) {
    taylor2_window_kernel<true><<<grid, kThreads, 0, st>>>((int*)out, (const int2*)rom, P);
  } else {
    taylor2_window_kernel<false><<<grid, kThreads, 0, st>>>((int*)out, (const int2*)rom, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
