// The vectoring-mode CORDIC atan2 and the FM discriminators built on it, on
// Hopper (sm_90a).
//
// Replaces the jnp of blackman_harris_win_tpu/kernels/cordic.py:275
// _atan2_core, :320 cordic_atan2 and :343 atan2_fixed, and of
// pipeline/demod.py:30 fm_demod_phase and :38 fm_demod_conj (no pallas_call:
// XLA fuses the unrolled iterations into one loop).  In eager torch the
// same work is some 12 int64 launches an iteration over the whole input
// (kernels/cordic.py's plain version); here it is one launch.  Three front
// ends over one device function (atan2_word):
//
//   atan2_kernel      elementwise cordic_atan2 / atan2_fixed on int32 or
//                     int64 (y, x) of one shape, int64 out;
//   demod_int_kernel  fm_demod_conj / fm_demod_phase from integer I/Q
//                     (rows, T) with any strides, read in place, to
//                     (rows, T-1) int64 in the input's stride order;
//   demod_iq_kernel   sdr_chain's discriminator from the complex64 (or
//                     complex128) channelizer output (batches, nf, bins): the
//                     quantizer rint(re * iq_scale) (round half to even, as
//                     torch.round then .to(int32)), then fm_demod_conj,
//                     written as (batches, nf-1, C) int64 in the (frame,
//                     channel) layout: no transpose, no int64 copy.  bins is
//                     C (the full spectrum) or C/2 + 1 (torch.fft.rfft of a
//                     real stream): channel k > C/2 is then the conjugate of
//                     bin C - k, quantized as rint(-im * iq_scale), which is
//                     what the full spectrum's conjugate fill would give.
//
// The datapath (src/cordic_atan2.vhd:146-219, model/golden.py:cordic_atan2):
// the quadrant from bit input_width-1 of x and y, the one's-complement abs
// of their low AW-1 bits, AW-1 iterations on an iw = AW+P bit state that
// wraps after every add, z stepped by LUT_ATAN_PI[i] >> (49-AW-P), then
// wrap(z >> P, AW) and the quadrant fix of either convention.
//
// What bounds it on the H100: the iterations.  At the SDR chain's AW=20 a
// discriminator output needs 8 bytes read (its complex64 sample, or 4.5
// from a half spectrum; the neighbour's is the next output's) and 8
// written, against 19 iterations: their instructions, not the bytes, set
// the time.  So the design keeps an iteration short and spreads it over
// the integer ALU pipe (shifts, logic) and the FMA pipe (IMAD), which
// issue 64 lanes a clock an SM each:
//
// - The state sits at the top of a word: X = x << sh, sh = B - iw, for a
//   B-bit word (B = 32 while iw <= 32 and P >= 1, else 64).  An add of two
//   such words wraps at iw bits by itself, so the reference's per-add wrap
//   costs nothing.  The wrap does fire: with P=1 the state reaches 1.16 *
//   2^(iw-1) near |x| == |y| (the CORDIC gain 1.647 times sqrt 2), and
//   tests/test_torch_demod_kernel.py holds a case where it does.
// - 32-bit words: the shifted operand floor(x / 2^i) << sh is the shift
//   pair (X >> (i + sh)) << sh, and its left shift folds into the steering
//   product: with m the sign mask of y (0 or all ones) and d = +-1 its
//   steering, d << sh = m * 2^(sh+1) + 2^sh (one IMAD), X += (d << sh) *
//   (Y >> (i + sh)) and Y -= (d << sh) * (X >> (i + sh)) are one shift and
//   one IMAD each.  z, which steers nothing, is zbase + sum m_i * (-2
//   lut[i]) (zbase = -sum lut[i]), one IMAD an iteration.  The sign and the
//   two shifts issue on the ALU pipe, the four IMAD on the FMA pipe, and
//   ptxas puts Y's negated operand on either: 8 SASS instructions an
//   iteration (chip_smoke.py prints them by pipe).  Moving that negation to
//   its own IMAD of m, building d << sh with a LOP3, or a shift or the sign
//   as the high word of a multiply (IMAD.HI) each measured slower in turns
//   on the H100 (PERF.md, Findings).
// - 32-bit words, the count: the iterations are one unrolled chain of
//   positions 2..31 in which position j shifts by the immediate j - 2, and
//   a switch jumps into it at position sh + 2 (fill's entry): iteration i
//   runs at position i + sh + 2 and the last, AW-2, at 32 - P, so no
//   iteration tests the count and no shift amount needs a register.  The
//   z steps sit at their positions in the parameter bank (zpos, 0 where no
//   iteration runs: the P - 1 positions after the last move x and y, which
//   nothing reads).  P = 0 would need a 32nd position and takes the 64-bit
//   word (words32).
// - 64-bit words: the shifted operand is (X >> i) with its low sh bits
//   cleared (one AND a word), steered by a xor and subtract with m; the
//   iterations unroll up to 48 and stop at AW-1 by a uniform branch.
// - z needs no wrap: |z| <= sum lut[i] < 0.56 * 2^(iw-1) on every path.
// - All wrapping adds, negations and the 32-bit conjugate products are done
//   in unsigned types (signed overflow is undefined); right shifts of
//   negative values are arithmetic under nvcc.
//
// Grids: atan2 walks its outputs in a grid-stride loop over at most one
// full load of the card (stride_blocks), so each warp's loads and stores
// are coalesced and a thread, taking many outputs, reads the chain's z
// steps from the parameter bank once for them all, not once an output.
// The complex front end gives each thread a strip of consecutive frames of
// one channel: it reads and quantizes each sample once, carries it in
// registers to the next output and has the next sample's load in flight
// while it computes this one; consecutive lanes take consecutive channels, then the next strip, so
// each warp's loads and stores are whole 32-byte sectors (a 128-byte line
// at 16 channels), and the strip length is chosen so the grid holds at
// least one full load of the card (2048 threads an SM), within 4 to 64
// frames.  demod_int computes each angle (phase) or re-quantized sample
// (conj) once, whichever stride of the I/Q is the unit one, in one of two
// walks the host picks (kernels/demod_kernel.py:walk_of):
//
// - kWalkRows, for I/Q whose row stride is the shorter (the (T, C) array
//   of a channel bank read as its (C, T) transpose, as the SDR chain's
//   plain path and chip_smoke.py pass it): the complex front end's strip
//   walk, lanes on
//   consecutive rows, and the output written (T-1, rows), the input's
//   stride order, the layout torch's own elementwise ops give the plain
//   version (the wrapper returns its transpose).  Consecutive t on the
//   lanes would read such a 16-row int32 bank at 4 useful bytes of each
//   32-byte sector, with each sector read again for a later row: 3.117 ms
//   at config 5 against a 0.32 ms byte bound on an H100 (PERF.md).
// - kWalkT, for rows with a unit (or the shorter) t stride: a warp walks a
//   chunk of one row, a sample a lane a step, and takes each output's
//   predecessor from the next lane down (__shfl_up_sync) and lane 0's
//   from lane 31 of the step before; the chunk's first from sample t0 - 1,
//   computed once a chunk.  Output (rows, T-1), a warp's store one run of
//   32 int64.
//
// Both carry the value across their strip or chunk in registers: no
// shared memory, no barrier, each sample read and quantized once.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxLut = 48;  // LUT_ATAN_PI entries: AW - 1 <= 48
constexpr int kChain = 32;   // 32-bit words: chain positions 2..31
constexpr int kThreadsPerSm = 2048;
constexpr i64 kMinStrip = 4, kMaxStrip = 64;  // frames a thread of demod_iq walks

enum Convention : int { kCordic = 0, kFixed = 1 };  // cordic_atan2, atan2_fixed
enum Mode : int { kConj = 0, kPhase = 1 };          // fm_demod_conj, fm_demod_phase

struct Params {
  i64 lut[kMaxLut];  // LUT_ATAN_PI[i] >> (49 - AW - P), i < AW - 1
  // 32-bit words: iteration i runs at chain position j = i + entry, entry =
  // sh + 2, and shifts by j - 2; zpos[j] is its z step -2 lut[i], 0 at the
  // positions of no iteration
  int entry;
  unsigned zpos[kChain];
  i64 zbase;  // -sum lut[i], i < AW - 1
  int aw;            // angle width AW
  int p;             // guard bits P
  int in_sign;       // min(input_width, 64) - 1: the quadrant's bit
  int convention;
  int drop;          // fm_demod_conj: the re-quantization shift to <= 15 bits
  int shift;         // fm_demod_conj: products >> shift into the engine's range
  double iq_scale;   // demod_iq: the quantizer's gain
};

template <typename S> struct Word;
template <> struct Word<int> {
  typedef unsigned U;
  static constexpr int kBits = 32;
};
template <> struct Word<i64> {
  typedef u64 U;
  static constexpr int kBits = 64;
  static constexpr int kMaxIter = kMaxLut;  // AW - 1 with AW + P <= 49
};

// One vectoring iteration in 32-bit words at chain position J: its shift
// J - 2 an immediate, its z step a parameter-bank operand.
#define BHW_ITER(J)                                                     \
  case J: {                                                             \
    const U m = (U)((S)ys >> (B - 1)); /* 0 for y >= 0, all ones below */ \
    const U dsh = m * p2x2 + p2;       /* d << sh, d = +-1 */             \
    const U xa = (U)((S)xs >> ((J) - 2)), ya = (U)((S)ys >> ((J) - 2));   \
    xs += dsh * ya;                                                     \
    ys -= dsh * xa;                                                     \
    z += m * P.zpos[J];                                                 \
  }                                                                     \
    [[fallthrough]];
#define BHW_ITER4(J) BHW_ITER(J) BHW_ITER((J) + 1) BHW_ITER((J) + 2) BHW_ITER((J) + 3)

// the angle of (x, y), an AW-bit word in an int64, of the convention
// (y and x arrive sign-extended to int64, whatever they were read as)
template <typename S>
__device__ __forceinline__ i64 atan2_word(i64 y, i64 x, const Params& P) {
  typedef typename Word<S>::U U;
  constexpr int B = Word<S>::kBits;
  const int sh = B - (P.aw + P.p);
  const i64 sx = (x >> P.in_sign) & 1, sy = (y >> P.in_sign) & 1;
  const int quadrant = (int)((sx << 1) | sy);
  const i64 mask_lo = (1ll << (P.aw - 1)) - 1;
  U xs = (U)((x ^ -sx) & mask_lo) << sh;  // one's-complement abs, low AW-1 bits
  U ys = (U)((y ^ -sy) & mask_lo) << sh;
  U z;
  if constexpr (B == 32) {
    const U p2 = (U)1 << sh, p2x2 = p2 << 1;
    z = (U)P.zbase;
    // a jump into the unrolled chain: iterations 0..AW-2 are positions
    // entry..32-P, whatever AW, so the shifts are immediates and no
    // iteration tests the count (P >= 1; the P - 1 positions past the last
    // run with z steps of 0)
    switch (P.entry) {
      BHW_ITER4(2) BHW_ITER4(6) BHW_ITER4(10) BHW_ITER4(14) BHW_ITER4(18) BHW_ITER4(22)
      BHW_ITER4(26) BHW_ITER(30) BHW_ITER(31)
      default: break;
    }
  } else {
    const int niter = P.aw - 1;
    const U keep = ~(U)0 << sh;
    z = 0;
#pragma unroll
    for (int i = 0; i < Word<S>::kMaxIter; ++i) {
      if (i >= niter) break;
      const U xi = (U)((S)xs >> i) & keep, yi = (U)((S)ys >> i) & keep;
      const U lut = (U)(S)P.lut[i];
      const U m = (U)((S)ys >> (B - 1));  // 0 for y >= 0, all ones below
      xs += (yi ^ m) - m;
      ys -= (xi ^ m) - m;
      z -= (lut ^ m) - m;
    }
  }
  // dat_phi = wrap(z >> P, AW): z is an iw-bit value, so its arithmetic
  // shift in the word is exact
  const U phi = (U)((S)z >> P.p);
  const U pi_half = (U)1 << (P.aw - 2), pi_u = (U)1 << (P.aw - 1);
  U out;
  if (P.convention == kCordic) {
    out = quadrant == 0 ? phi : quadrant == 1 ? phi + pi_half : quadrant == 2 ? 0 - phi
                                                                              : phi - pi_half;
  } else {  // base = -phi
    out = quadrant == 0 ? 0 - phi : quadrant == 1 ? phi : quadrant == 2 ? pi_u + phi
                                                                        : 0 - phi - pi_u;
  }
  const int up = 64 - P.aw;
  return (i64)((u64)out << up) >> up;  // wrap to AW bits
}

// a sample of the conjugate-product discriminator: I and Q re-quantized by
// >> drop, as the 32-bit words its products take
struct Iq {
  unsigned a, b;
};

__device__ __forceinline__ Iq requant(i64 i, i64 q, const Params& P) {
  return {(unsigned)(i >> P.drop), (unsigned)(q >> P.drop)};
}

// the discriminator of samples s0 -> s1: atan2_fixed(im >> shift, re >>
// shift, AW, AW) of the products in wrapping 32-bit arithmetic
template <typename S>
__device__ __forceinline__ i64 conj_word(Iq s0, Iq s1, const Params& P) {
  const int re = (int)(s1.a * s0.a + s1.b * s0.b);
  const int im = (int)(s1.b * s0.a - s1.a * s0.b);
  return atan2_word<S>((i64)(im >> P.shift), (i64)(re >> P.shift), P);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
atan2_kernel(i64* __restrict__ out, const T* __restrict__ y, const T* __restrict__ x, i64 n,
             const Params P) {
  for (i64 e = (i64)blockIdx.x * kThreads + threadIdx.x; e < n; e += (i64)gridDim.x * kThreads) {
    out[e] = atan2_word<S>((i64)__ldg(y + e), (i64)__ldg(x + e), P);
  }
}

enum Walk : int { kWalkT = 0, kWalkRows = 1 };  // demod_int: lanes on t, or on rows

// strides are in elements: row r, sample t of i at i[r * ir + t * it]
struct Layout {
  i64 rows, t;
  i64 ir, it, qr, qt;
  i64 span;     // kWalkRows: outputs a thread walks; kWalkT: 32-sample steps a warp walks
  i64 per_row;  // strips (kWalkRows) or chunks (kWalkT) a row
  i64 tasks;    // threads (kWalkRows) or warps (kWalkT) with work
};

template <typename T>
struct Raw {
  T i, q;
};

template <typename T>
__device__ __forceinline__ Raw<T> load(const T* ip, const T* qp, i64 t, const Layout& L) {
  return {__ldg(ip + t * L.it), __ldg(qp + t * L.qt)};
}

// what the discriminator carries from a sample to the next output: its
// angle (phase) or its re-quantized I/Q (conj)
struct Val {
  i64 phi;
  Iq s;
};

template <typename S, int MODE, typename T>
__device__ __forceinline__ Val value(Raw<T> x, const Params& P) {
  Val v{0, {0u, 0u}};
  if constexpr (MODE == kPhase) {
    v.phi = atan2_word<S>((i64)x.q, (i64)x.i, P);
  } else {
    v.s = requant((i64)x.i, (i64)x.q, P);
  }
  return v;
}

// the output of samples prev -> cur: phase_wrap(phi1 - phi0) or the
// conjugate-product angle
template <typename S, int MODE>
__device__ __forceinline__ i64 output(Val prev, Val cur, const Params& P) {
  if constexpr (MODE == kPhase) {
    const u64 half = 1ull << (P.aw - 1), full = 1ull << P.aw;
    const u64 d = (u64)cur.phi - (u64)prev.phi;
    return (i64)((d + half) & (full - 1)) - (i64)half;
  } else {
    return conj_word<S>(prev.s, cur.s, P);
  }
}

// lane l - 1's value (lane 0: its own), and lane src's, across the warp
template <int MODE>
__device__ __forceinline__ Val from_lane_below(Val v) {
  if constexpr (MODE == kPhase) {
    v.phi = __shfl_up_sync(0xffffffffu, v.phi, 1);
  } else {
    v.s.a = __shfl_up_sync(0xffffffffu, v.s.a, 1);
    v.s.b = __shfl_up_sync(0xffffffffu, v.s.b, 1);
  }
  return v;
}

template <int MODE>
__device__ __forceinline__ Val from_lane(Val v, int src) {
  if constexpr (MODE == kPhase) {
    v.phi = __shfl_sync(0xffffffffu, v.phi, src);
  } else {
    v.s.a = __shfl_sync(0xffffffffu, v.s.a, src);
    v.s.b = __shfl_sync(0xffffffffu, v.s.b, src);
  }
  return v;
}

template <typename T, typename S, int MODE, int WALK>
__global__ void __launch_bounds__(kThreads)
demod_int_kernel(i64* __restrict__ out, const T* __restrict__ i, const T* __restrict__ q,
                 const Layout L, const Params P) {
  if constexpr (WALK == kWalkRows) {
    // a strip of span outputs of one row a thread, the rows fastest: each
    // warp load and store touches consecutive rows of one t
    const i64 g = (i64)blockIdx.x * kThreads + threadIdx.x;
    if (g >= L.tasks) return;
    const i64 r = g % L.rows, t0 = g / L.rows * L.span;
    const i64 t1 = t0 + L.span < L.t - 1 ? t0 + L.span : L.t - 1;  // outputs t0 .. t1-1
    const T* ip = i + r * L.ir;
    const T* qp = q + r * L.qr;
    i64* o = out + t0 * L.rows + r;  // out is (t - 1, rows)
    Val prev = value<S, MODE>(load(ip, qp, t0, L), P);
    Raw<T> next = load(ip, qp, t0 + 1, L);
    for (i64 t = t0; t < t1; ++t) {
      const Raw<T> cur = next;
      if (t + 2 <= t1) next = load(ip, qp, t + 2, L);  // in flight during this output
      const Val v = value<S, MODE>(cur, P);
      *o = output<S, MODE>(prev, v, P);
      o += L.rows;
      prev = v;
    }
  } else {
    // a chunk of 32 * span samples of one row a warp, a sample a lane a
    // step: each value computed once, its predecessor from the next lane
    // down, lane 0's from lane 31 of the step before (the chunk's first
    // from sample t0 - 1)
    const i64 w = ((i64)blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (w >= L.tasks) return;  // whole warps
    const int lane = threadIdx.x & 31;
    const i64 r = w / L.per_row, t0 = w % L.per_row * 32 * L.span;
    const i64 tend = t0 + 32 * L.span < L.t ? t0 + 32 * L.span : L.t;
    const T* ip = i + r * L.ir;
    const T* qp = q + r * L.qr;
    i64* o = out + r * (L.t - 1);  // out is (rows, t - 1): sample t's output at o[t - 1]
    Val carry{0, {0u, 0u}};
    if (t0 > 0) carry = value<S, MODE>(load(ip, qp, t0 - 1, L), P);
    Raw<T> next = load(ip, qp, t0 + lane < tend ? t0 + lane : tend - 1, L);
    for (i64 tb = t0; tb < tend; tb += 32) {
      const i64 t = tb + lane;
      const Raw<T> cur = next;
      if (tb + 32 < tend) next = load(ip, qp, t + 32 < tend ? t + 32 : tend - 1, L);
      const Val v = value<S, MODE>(cur, P);
      Val prev = from_lane_below<MODE>(v);
      if (lane == 0) prev = carry;
      carry = from_lane<MODE>(v, 31);
      if (t < tend && t > 0) o[t - 1] = output<S, MODE>(prev, v, P);
    }
  }
}

// The 32-bit word takes AW + P <= 32 with P >= 1: its chain ends at
// position 31, where the last iteration of P = 1 runs; P = 0 would need a
// 32nd position and takes the 64-bit word.
bool words32(int aw, int p) { return aw + p <= 32 && p >= 1; }

bool fill(Params& P, const i64* lut, int aw, int p, int input_width, int convention, int drop,
          int shift, double iq_scale) {
  if (aw < 2 || p < 0 || aw + p > 49 || input_width < 1 || input_width > 64) return false;
  if (drop < 0 || drop > 63 || shift < 0 || shift > 31) return false;
  if (convention != kCordic && convention != kFixed) return false;
  P.zbase = 0;
  for (int k = 0; k < kMaxLut; ++k) {
    P.lut[k] = k < aw - 1 ? lut[k] : 0;
    P.zbase -= P.lut[k];
  }
  P.entry = 34 - aw - p;  // sh + 2 for 32-bit words (aw + p <= 32, p >= 1)
  for (int j = 0; j < kChain; ++j) {
    const int i = j - P.entry;
    P.zpos[j] = words32(aw, p) && i >= 0 && i < aw - 1 ? (unsigned)(-2 * P.lut[i]) : 0u;
  }
  P.aw = aw;
  P.p = p;
  P.in_sign = input_width - 1;
  P.convention = convention;
  P.drop = drop;
  P.shift = shift;
  P.iq_scale = iq_scale;
  return true;
}

// blocks of a grid-stride walk over n items: at most one full load of the
// card (kThreadsPerSm threads an SM), so a thread takes several items and
// reads the parameter bank's chain steps into registers once for them all
unsigned stride_blocks(i64 n, int sms) {
  const i64 want = (n + kThreads - 1) / kThreads, most = (i64)sms * (kThreadsPerSm / kThreads);
  return (unsigned)(want < most ? (want > 0 ? want : 1) : most);
}

// the quantizer of sdr_chain: rint(v * iq_scale) to int32 in the
// channelizer's precision, one rounding of the product as torch's
__device__ __forceinline__ int quantize(float v, const Params& P) {
  return __float2int_rn(__fmul_rn(v, (float)P.iq_scale));
}
__device__ __forceinline__ int quantize(double v, const Params& P) {
  return __double2int_rn(__dmul_rn(v, P.iq_scale));
}

// the strips of demod_iq: the outputs (batches, nf-1, c) as items of
// strip consecutive frames of one channel, item g = (batch, strip, channel)
// with the channel fastest
struct Strips {
  i64 nf, c, bins;  // frames, channels, bins a frame of the input
  i64 strip, nstrips, items;
};

// one input sample of channel k, quantized and re-quantized; cj: the
// conjugate of its bin
template <typename C>
__device__ __forceinline__ Iq sample(C v, bool cj, const Params& P) {
  return requant(quantize(v.x, P), quantize(cj ? -v.y : v.y, P), P);
}

template <typename C, typename S>
__global__ void __launch_bounds__(kThreads)
demod_iq_kernel(i64* __restrict__ out, const C* __restrict__ y, const Strips L, const Params P) {
  const i64 g = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (g >= L.items) return;
  const i64 k = g % L.c, sb = g / L.c;
  const i64 s = sb % L.nstrips, b = sb / L.nstrips;
  const i64 f0 = s * L.strip;
  const i64 f1 = f0 + L.strip < L.nf - 1 ? f0 + L.strip : L.nf - 1;  // outputs f0 .. f1-1
  const bool cj = k >= L.bins;  // a half spectrum's channel past C/2
  const C* yk = y + b * L.nf * L.bins + (cj ? L.c - k : k);
  i64* o = out + (b * (L.nf - 1) + f0) * L.c + k;
  Iq prev = sample(__ldg(yk + f0 * L.bins), cj, P);
  C next = __ldg(yk + (f0 + 1) * L.bins);
  for (i64 f = f0; f < f1; ++f) {
    const C cur = next;
    if (f + 2 <= f1) next = __ldg(yk + (f + 2) * L.bins);  // in flight during this output
    const Iq s1 = sample(cur, cj, P);
    *o = conj_word<S>(prev, s1, P);
    o += L.c;
    prev = s1;
  }
}

template <typename S>
int launch_iq(int elem, i64* out, const void* y, i64 batches, i64 nf, i64 c, i64 bins,
              const Params& P, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  Strips L{nf, c, bins, 0, 0, 0};
  const i64 outs = batches * (nf - 1) * c;
  const i64 target = (i64)sms * kThreadsPerSm;
  L.strip = outs / target;  // rounded down: at least one full load unless clamped
  L.strip = L.strip < kMinStrip ? kMinStrip : (L.strip > kMaxStrip ? kMaxStrip : L.strip);
  if (L.strip > nf - 1) L.strip = nf - 1;
  L.nstrips = (nf - 1 + L.strip - 1) / L.strip;
  L.items = batches * L.nstrips * c;
  const i64 blocks = (L.items + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (elem == 8) {
    demod_iq_kernel<float2, S><<<(unsigned)blocks, kThreads, 0, st>>>(out, (const float2*)y, L, P);
  } else {
    demod_iq_kernel<double2, S><<<(unsigned)blocks, kThreads, 0, st>>>(out, (const double2*)y, L,
                                                                      P);
  }
  return (int)cudaGetLastError();
}

template <typename S>
int launch_atan2(int elem, i64* out, const void* y, const void* x, i64 n, const Params& P,
                 cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned g = stride_blocks(n, sms);
  if (elem == 4) {
    atan2_kernel<int, S><<<g, kThreads, 0, st>>>(out, (const int*)y, (const int*)x, n, P);
  } else {
    atan2_kernel<i64, S><<<g, kThreads, 0, st>>>(out, (const i64*)y, (const i64*)x, n, P);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_demod(int mode, int walk, i64* out, const void* i, const void* q, Layout L,
                 const Params& P, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // a thread's outputs (a strip, or a warp's steps): at least one full load
  // of the card unless clamped, within kMinStrip to kMaxStrip
  const i64 outs = L.rows * (L.t - 1);
  i64 span = outs / ((i64)sms * kThreadsPerSm);
  span = span < kMinStrip ? kMinStrip : (span > kMaxStrip ? kMaxStrip : span);
  i64 threads;
  if (walk == kWalkRows) {
    L.span = span < L.t - 1 ? span : L.t - 1;
    L.per_row = (L.t - 1 + L.span - 1) / L.span;
    L.tasks = L.rows * L.per_row;
    threads = L.tasks;
  } else {
    const i64 steps = (L.t + 31) / 32;
    L.span = span < steps ? span : steps;
    L.per_row = (L.t + 32 * L.span - 1) / (32 * L.span);
    L.tasks = L.rows * L.per_row;
    threads = 32 * L.tasks;
  }
  const i64 blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  const T* ip = (const T*)i;
  const T* qp = (const T*)q;
  if (mode == kPhase) {
    if (walk == kWalkRows) {
      demod_int_kernel<T, S, kPhase, kWalkRows><<<grid, kThreads, 0, st>>>(out, ip, qp, L, P);
    } else {
      demod_int_kernel<T, S, kPhase, kWalkT><<<grid, kThreads, 0, st>>>(out, ip, qp, L, P);
    }
  } else {
    if (walk == kWalkRows) {
      demod_int_kernel<T, S, kConj, kWalkRows><<<grid, kThreads, 0, st>>>(out, ip, qp, L, P);
    } else {
      demod_int_kernel<T, S, kConj, kWalkT><<<grid, kThreads, 0, st>>>(out, ip, qp, L, P);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: n int64; y, x: n int32 (elem = 4) or int64 (elem = 8), contiguous.
// lut: the AW-1 z steps LUT_ATAN_PI[i] >> (49 - AW - P).
int bhw_cordic_atan2(void* out, const void* y, const void* x, i64 n, int elem, const i64* lut,
                     int aw, int p, int input_width, int convention, void* stream) {
  Params P;
  if (!fill(P, lut, aw, p, input_width, convention, 0, 0, 0.0) || n < 1 ||
      (elem != 4 && elem != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return words32(aw, p) ? launch_atan2<int>(elem, (i64*)out, y, x, n, P, st)
                        : launch_atan2<i64>(elem, (i64*)out, y, x, n, P, st);
}

// out: int64, contiguous, (rows, t - 1) for walk 0 (lanes on t) or (t - 1,
// rows) for walk 1 (lanes on rows: the layout of I/Q whose row stride is
// the shorter); i, q: (rows, t) int32 (elem = 4) or int64 (elem = 8) at
// element strides (ir, it) and (qr, qt).  mode 0: fm_demod_conj
// (input_width 15 after >> drop, atan2 at AW with P = 1 on the products >>
// shift); mode 1: fm_demod_phase (atan2_fixed at input_width, then
// phase_wrap of the differences).
int bhw_fm_demod(void* out, const void* i, const void* q, i64 rows, i64 t, i64 ir, i64 it, i64 qr,
                 i64 qt, int elem, int mode, const i64* lut, int aw, int input_width, int drop,
                 int shift, int walk, void* stream) {
  Params P;
  const int iw = mode == kConj ? aw : input_width;  // conj: atan2 reads the products at AW
  if (!fill(P, lut, aw, 1, iw, kFixed, drop, shift, 0.0) || rows < 1 || t < 2 ||
      (elem != 4 && elem != 8) || (mode != kConj && mode != kPhase) ||
      (walk != kWalkT && walk != kWalkRows)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L{rows, t, ir, it, qr, qt, 0, 0, 0};
  const cudaStream_t st = (cudaStream_t)stream;
  i64* o = (i64*)out;
  if (words32(aw, 1)) {
    return elem == 4 ? launch_demod<int, int>(mode, walk, o, i, q, L, P, st)
                     : launch_demod<i64, int>(mode, walk, o, i, q, L, P, st);
  }
  return elem == 4 ? launch_demod<int, i64>(mode, walk, o, i, q, L, P, st)
                   : launch_demod<i64, i64>(mode, walk, o, i, q, L, P, st);
}

// out: (batches, nf - 1, c) int64; y: (batches, nf, bins) complex64 (elem =
// 8) or complex128 (elem = 16), both contiguous; bins = c, or c / 2 + 1 for
// the half spectrum of a real stream (channel k > c / 2 is the conjugate of
// bin c - k).  The quantizer rint(. * iq_scale) to int32, then
// fm_demod_conj at AW (drop, shift as above).
int bhw_fm_demod_iq(void* out, const void* y, i64 batches, i64 nf, i64 c, i64 bins, int elem,
                    double iq_scale, const i64* lut, int aw, int drop, int shift, void* stream) {
  Params P;
  if (!fill(P, lut, aw, 1, aw, kFixed, drop, shift, iq_scale) || batches < 1 || nf < 2 || c < 1 ||
      (bins != c && bins != c / 2 + 1) || (elem != 8 && elem != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return words32(aw, 1) ? launch_iq<int>(elem, (i64*)out, y, batches, nf, c, bins, P, st)
                        : launch_iq<i64>(elem, (i64*)out, y, batches, nf, c, bins, P, st);
}

}  // extern "C"
