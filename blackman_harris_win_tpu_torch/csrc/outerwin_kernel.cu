// Outer-product window tiles on Hopper (sm_90a): the int, float32 and
// compensated-pair fast modes.
//
// Replaces blackman_harris_win_tpu/kernels/pallas/outerwin_kernel.py:
//   make_checksum_fn       (_reduce_kernel over tile_window)      -> int_kernel
//   make_checksum_fn_f32   (_reduce_kernel_f32)                   -> float_kernel<kF32>
//   make_checksum_fn_comp  (_reduce_kernel_comp over comp_tile)   -> float_kernel<kComp>
// each with two epilogues: the checksum (the port of those three kernels:
// the window is summed, never stored) and the write-out (the samples of
// kernels/outerwin.py window_block_outer, floatwin.py float_window_block and
// compwin.py comp_window_block).
//
// Sample n = h * 2^m + lo.  The host builds, per configuration, an h-table
// hi (nh, hc) and a lo-table lo (lr, nl), row-major, exactly as the JAX
// package builds them:
//   kInt, kF32: hi row = [ch_0..ch_{K-2} | sh_0..sh_{K-2}], lo = [cl ; sl];
//   kComp:      hi row = [hic (4C) | hip (2P)], lo = [loc (6C) ; lop (2P)];
//               a compensated harmonic's four h values (ch_hi, ch_lo, sh_hi,
//               sh_lo) are one aligned float4 of the row, a plain one's
//               (ch, sh) one float2.
//
// The float kernels (float_kernel).  What bounds them on the H100: the
// write-outs store 4 (f32) or 8 (comp) bytes per sample, 268 or 537 MB at
// 2^26 samples, against 2 FFMA per harmonic (f32) or 28 FFMA per sample
// (comp at BH-7); so the write-outs are bound by bytes and the checksums,
// which store nothing, by FFMA issue.
//
// The int kernel (int_kernel).  What bounds it on the H100: the checksum
// stores nothing and is bound by integer issue; the write-out stores 4
// bytes a sample, 268 MB at 2^26 samples (0.080 ms at 3.35 TB/s), about
// what its operations take at the integer issue rate (0.078 ms at BH-7 for
// the 6 a harmonic of utils/profiling.py).  The exact product of two
// 31-bit values needs a 64-bit result, so each harmonic and sample costs
// two IMAD.WIDE (32 x 32 -> 64 bits) on the FMA pipe, and three ALU
// instructions for the three-way 64-bit add, the shift and the accumulate;
// the IMAD.WIDE rate sets the pace (PERF.md: about 6 issue cycles a warp).
//
// Both generators keep everything but their arithmetic and the stores off
// the per-sample path, with one geometry (tile_geom):
// - Harmonic counts are template parameters (int and f32: K-1 = 1..7; comp:
//   the catalog's (C, P) = (1,0) (2,0) (3,0) (3,1) (4,2)); every loop is
//   unrolled and every per-lane array index is a compile-time constant, so
//   the lane values stay in registers.  Other comp counts, and lane counts
//   that are not a multiple of 4, take one instantiation per mode with
//   runtime counts (loops to kMaxH with guards, one lane a thread).
// - Each thread owns V = 4 consecutive lo lanes (all in or all out of
//   [0, nl), as nl % 4 == 0 there): their lo values are loaded into
//   registers once per block, and each h value read from shared memory
//   serves V samples.
// - A block walks a contiguous range of h rows, sized from the row count and
//   what fits on the card at once (SMs x resident blocks), so the lane loads
//   are amortized over hundreds of samples a thread.  The h rows pass
//   through a double-buffered cp.async ring of kTileRows rows, each row
//   padded to a multiple of 4 words, read back as 16-byte loads.
// - The write-out stores V consecutive samples as one 16-byte store (s and
//   e to their own outputs for comp); the outputs must be 16-byte aligned
//   (the C entry refuses others; the wrapper's fresh tensors are).
// - int only: the shift s = 30 + guard is a template parameter too (an
//   immediate, and the rounding half a constant), sh is negated once a row
//   for all V lanes, and the W-step is one uniform branch per row outside
//   the harmonic loop.
//
// Arithmetic:
// - kInt, per harmonic and lane: d = ch*cl + 2^(s-1) + (-sh)*sl in int64
//   (|d| < 2^62: no overflow), then the low 32 bits of d >> s (logical),
//   added mod 2^32 in uint32.  Bits s..s+31 of a 64-bit word do not depend
//   on how the shift fills from the left when s <= 32, so this is the JAX
//   package's round-half-up mulsub_shift30 (an arithmetic shift of the
//   exact difference) mod 2^32, and the uint32 sum is its int32 wrap.  Then
//   the W < 32 wrap (sign extension from W bits) or saturate clamp.  At
//   W = 32 saturate does nothing, as in the JAX package.  The checksum is
//   a uint32 sum: warp, block, then one atomicAdd a block onto the biased
//   output, exact in any order.
// - kF32: acc = fma(-sh, sl, fma(ch, cl, acc)) per harmonic, explicit fmaf.
// - kComp: FFMA chains.  s = fma(-sh_hi, sl_hi, fma(ch_hi, cl_hi, s)): every
//   product is a multiple of 2^-22 below 1 and every partial sum stays below
//   2 (sum |a_k| < 1.9), so each FFMA's exact result is an f32 and s equals
//   the plain version's bits under any order.  e takes the four correction
//   products of a compensated harmonic as four FFMAs (ch_hi*cl_lo,
//   ch_lo*cl_f, -sh_hi*sl_lo, -sh_lo*sl_f) and a plain harmonic's two as
//   two: 4C + 2P roundings, each of a partial sum of those products, so of
//   a value below E (outerwin_kernel.py comp_e_bound).  The plain version
//   (comp_tile, JAX's order) rounds 8C + 4P times, so the two differ by at
//   most (12C + 6P) E u, inside comp_e_bound's 2 (8C + 4P) E u; e is not
//   the plain version's bits.  No TwoSum here: the raw (s, e) pair is the
//   contract and its normalization stays on the host.
// - Float checksums: per thread, one accumulator per lane (and per s and e)
//   over a chunk of kTileRows rows, folded (lanes as a tree, then s + e)
//   into a chunk partial that is added to the thread's running sum; a fixed
//   block tree into one partial per block; a second one-block kernel sums
//   the partials in a fixed order and adds the bias.  No float atomics, so
//   repeated calls on one card return the same bits;
//   bhw_outer_checksum_depth gives the longest addition chain.
//
// No allocation here: the wrapper passes the outputs and the partials.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kMaxH = 7;           // harmonics a_1..a_7 (8 terms)
constexpr int kFinalThreads = 256;
constexpr int kTileThreads = 128;  // tile kernels: threads per block
constexpr int kTileRows = 32;      // tile kernels: h rows per ring slot

enum Mode : int { kInt = 0, kF32 = 1, kComp = 2 };

struct OuterParams {
  const void* hi;  // (nh, hc) int32 (kInt) or float32, row-major
  const void* lo;  // (lr, nl) row-major
  i64 h0, rows;    // h rows [h0, h0 + rows)
  int nl, hc;
  int nk;          // kInt/kF32: harmonics K-1; kComp: compensated C
  int np;          // kComp: plain harmonics P
  int a0, shift, w, saturate;  // kInt
  float a0f, a0lo;             // kF32: a0; kComp: a0_hi, a0_lo
};

template <class T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  static_assert(sizeof(T) == 4, "4-byte copies");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// --- kInt: V lanes a thread, a row range a block ---

// The counts of one int instantiation: NK = K-1 harmonics (1..7) and the
// shift SH (30 or 31).  NK < 0 takes the count and the shift at run time
// (loops to kMaxH with guards) and one lane a thread: it serves lane counts
// that are not a multiple of 4 (m <= 1).
template <int NK>
struct IShape {
  static constexpr bool kRt = NK < 0;
  static constexpr int kK = kRt ? kMaxH : NK;
  static constexpr int kHc = 2 * kK;
  static constexpr int kHcp = (kHc + 3) / 4 * 4;  // shared-memory row stride
  static constexpr int kV = kRt ? 1 : 4;
  static_assert(kK >= 1 && kK <= kMaxH, "harmonic count");
};

// One thread's lo values, V lanes each, in registers: cl and sl.
template <class S> struct ILanes { int c[S::kK][S::kV], s[S::kK][S::kV]; };

template <class S>
__device__ __forceinline__ void load_ilanes(const OuterParams& p, i64 lane0, ILanes<S>& L) {
  const int* lo = static_cast<const int*>(p.lo);
  const i64 nl = p.nl;
  const int nk = S::kRt ? p.nk : S::kK;
#pragma unroll
  for (int v = 0; v < S::kV; ++v) {
    const int* col = lo + (lane0 + v < nl ? lane0 + v : nl - 1);
#pragma unroll
    for (int k = 0; k < S::kK; ++k) {
      const bool on = !S::kRt || k < p.nk;
      L.c[k][v] = on ? __ldg(col + k * nl) : 0;
      L.s[k][v] = on ? __ldg(col + (nk + k) * nl) : 0;
    }
  }
}

// a * b + c, 32 x 32 + 64 -> 64 bits.  Written as PTX: from the same
// arithmetic in C (64-bit multiplies of sign-extended words, then >> s)
// nvcc made 274 instructions a row of 4 samples at K-1 = 6, where this and
// __funnelshift_r make 158 (chip_smoke.py's SASS report).
__device__ __forceinline__ i64 mad_wide(int a, int b, i64 c) {
  i64 d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// acc[v] = a0 + sum_k lo32((ch*cl + 2^(s-1) + (-sh)*sl) >> s), mod 2^32, for
// one h row (shared memory, 16-byte aligned) at the V lanes.  ptxas makes
// each harmonic and lane two IMAD.WIDE, an IADD3 and an IADD3.X (the
// three-way 64-bit add) and one LEA.HI (the funnel shift and the
// accumulate).  sh is negated once a row for the V lanes (|sh| <= 2^30 - 1,
// so -sh fits); ptxas rematerializes a negated lo value held in registers
// inside the loop, once a lane.
template <int NK, int SH>
__device__ __forceinline__ void int_row(const OuterParams& p, const int* __restrict__ h,
                                        const ILanes<IShape<NK>>& L,
                                        unsigned (&acc)[IShape<NK>::kV]) {
  typedef IShape<NK> S;
  if constexpr (S::kRt) {
    const int s = p.shift;
    const i64 half = 1ll << (s - 1);
    acc[0] = (unsigned)p.a0;
#pragma unroll
    for (int k = 0; k < S::kK; ++k) {
      if (k >= p.nk) break;
      const i64 d = mad_wide(-h[p.nk + k], L.s[k][0], mad_wide(h[k], L.c[k][0], half));
      acc[0] += __funnelshift_r((unsigned)d, (unsigned)(d >> 32), s);
    }
  } else {
    constexpr i64 kHalf = 1ll << (SH - 1);
    int hv[S::kHcp];
#pragma unroll
    for (int j = 0; j < S::kHcp / 4; ++j) {
      const int4 t = reinterpret_cast<const int4*>(h)[j];
      hv[4 * j] = t.x;
      hv[4 * j + 1] = t.y;
      hv[4 * j + 2] = t.z;
      hv[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int v = 0; v < S::kV; ++v) acc[v] = (unsigned)p.a0;
#pragma unroll
    for (int k = 0; k < S::kK; ++k) {
      const int nsh = -hv[NK + k];
#pragma unroll
      for (int v = 0; v < S::kV; ++v) {
        const i64 d = mad_wide(nsh, L.s[k][v], mad_wide(hv[k], L.c[k][v], kHalf));
        acc[v] += __funnelshift_r((unsigned)d, (unsigned)(d >> 32), SH);
      }
    }
  }
}

// The W-step of one launch: sample = clamp(sign extension of acc from
// 32 - sw bits, lo, hi).  wrap: sw = 32 - W; saturate: the clamp to W bits;
// on = false (W = 32, where saturate is a no-op too): acc as it is.
struct WStep {
  bool on;
  int sw, lo, hi;
};

__device__ __forceinline__ WStep wstep_of(const OuterParams& p) {
  WStep s;
  s.on = p.w < 32;
  s.sw = s.on && !p.saturate ? 32 - p.w : 0;
  s.hi = s.on && p.saturate ? (1 << (p.w - 1)) - 1 : INT_MAX;
  s.lo = -s.hi - 1;
  return s;
}

// grid.x covers the lo lanes (kTileThreads * V a block), grid.y the h rows
// in ranges of rpb rows.  kSum = false: write samples to out, V at a time.
// kSum = true: add the block's uint32 sum onto *sum (atomicAdd).
template <int NK, int SH, bool kSum>
__global__ void __launch_bounds__(kTileThreads)
int_kernel(const OuterParams p, int* __restrict__ out, unsigned* __restrict__ sum, i64 rpb) {
  typedef IShape<NK> S;
  constexpr int V = S::kV;
  __shared__ __align__(16) int hs[2][kTileRows * S::kHcp];
  const i64 lane0 = ((i64)blockIdx.x * kTileThreads + threadIdx.x) * V;
  ILanes<S> L;
  load_ilanes<S>(p, lane0, L);
  // V = 4 only where nl % 4 == 0: a thread's lanes are all in or all out
  const bool valid = lane0 < p.nl;
  const WStep ws = wstep_of(p);

  const int hc = S::kRt ? p.hc : S::kHc;
  const i64 r_begin = (i64)blockIdx.y * rpb;
  const i64 nrows = p.rows - r_begin < rpb ? p.rows - r_begin : rpb;
  const int nchunks = (int)((nrows + kTileRows - 1) / kTileRows);
  const int* src = static_cast<const int*>(p.hi) + (p.h0 + r_begin) * hc;
  auto rows_of = [&](int c) {
    return (int)(nrows - (i64)c * kTileRows < kTileRows ? nrows - (i64)c * kTileRows
                                                        : kTileRows);
  };
  auto stage = [&](int c) {  // rows of chunk c into slot c & 1, rows padded to kHcp
    const int nr = rows_of(c);
    const int* s = src + (i64)c * kTileRows * hc;
    int* d = hs[c & 1];
    for (int i = threadIdx.x; i < nr * hc; i += kTileThreads) {
      const int r = i / hc;
      cp_async4(d + r * S::kHcp + (i - r * hc), s + i);
    }
    cp_commit();
  };

  unsigned run = 0u;
  stage(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage(c + 1);  // its slot's readers passed the previous chunk's barrier
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int* buf = hs[c & 1];
    const i64 r0 = r_begin + (i64)c * kTileRows;
    const int nr = rows_of(c);
#pragma unroll 1
    for (int r = 0; valid && r < nr; ++r) {
      unsigned acc[V];
      int_row<NK, SH>(p, buf + r * S::kHcp, L, acc);
      int x[V];
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = (int)acc[v];
      if (ws.on) {  // uniform over the launch
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int e = (int)(acc[v] << ws.sw) >> ws.sw;
          x[v] = e < ws.lo ? ws.lo : (e > ws.hi ? ws.hi : e);
        }
      }
      if constexpr (kSum) {
#pragma unroll
        for (int v = 0; v < V; ++v) run += (unsigned)x[v];
      } else if constexpr (V == 4) {
        // the intrinsic keeps the 16-byte store (st.global.v4), as in
        // float_kernel
        __stwb(reinterpret_cast<int4*>(out + (r0 + r) * p.nl + lane0),
               make_int4(x[0], x[1], x[2], x[3]));
      } else {
        out[(r0 + r) * p.nl + lane0] = x[0];
      }
    }
    __syncthreads();  // every reader is done with slot c & 1
  }
  if constexpr (kSum) {
    for (int o = 16; o > 0; o >>= 1) run += __shfl_down_sync(0xffffffffu, run, o);
    __shared__ unsigned warp_sum[kTileThreads / 32];
    const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (wl == 0) warp_sum[warp] = run;
    __syncthreads();
    if (warp == 0) {
      run = wl < kTileThreads / 32 ? warp_sum[wl] : 0u;
      for (int o = 16; o > 0; o >>= 1) run += __shfl_down_sync(0xffffffffu, run, o);
      if (wl == 0) atomicAdd(sum, run);
    }
  }
}

// --- kF32 / kComp: V lanes a thread, a row range a block ---

// The counts of one float instantiation.  kF32: NC = K-1, NP = 0.  kComp:
// NC = C, NP = P.  NC < 0 takes the counts at run time (loops to kMaxH with
// guards) and one lane a thread: it serves the comp counts no catalog
// window has, and any lane count that is not a multiple of 4.
template <int M, int NC, int NP>
struct Shape {
  static constexpr bool kRt = NC < 0;
  static constexpr int kC = kRt ? kMaxH : NC;
  static constexpr int kP = M == kF32 ? 0 : (kRt ? kMaxH : NP);
  static constexpr int kPa = kP > 0 ? kP : 1;  // array extent
  static constexpr int kHc = kRt ? 4 * kMaxH : (M == kF32 ? 2 * NC : 4 * NC + 2 * NP);
  static constexpr int kHcp = (kHc + 3) / 4 * 4;  // shared-memory row stride
  static constexpr int kV = kRt ? 1 : 4;
  static_assert(kC + kP <= 2 * kMaxH && kPa >= 1, "harmonic counts");
};

// One thread's lo values, V lanes each, in registers.
template <int M, class S> struct FLanes;
template <class S> struct FLanes<kF32, S> { float c[S::kC][S::kV], s[S::kC][S::kV]; };
template <class S> struct FLanes<kComp, S> {
  float chi[S::kC][S::kV], clo[S::kC][S::kV], cf[S::kC][S::kV];
  float shi[S::kC][S::kV], slo[S::kC][S::kV], sf[S::kC][S::kV];
  float pc[S::kPa][S::kV], ps[S::kPa][S::kV];
};

template <int M, class S>
__device__ __forceinline__ void load_flanes(const OuterParams& p, i64 lane0, FLanes<M, S>& L) {
  const float* lo = static_cast<const float*>(p.lo);
  const i64 nl = p.nl;
  const int nc = S::kRt ? p.nk : S::kC;
#pragma unroll
  for (int v = 0; v < S::kV; ++v) {
    const float* col = lo + (lane0 + v < nl ? lane0 + v : nl - 1);
#pragma unroll
    for (int k = 0; k < S::kC; ++k) {
      const bool on = !S::kRt || k < p.nk;
      if constexpr (M == kF32) {
        L.c[k][v] = on ? __ldg(col + k * nl) : 0.f;
        L.s[k][v] = on ? __ldg(col + (nc + k) * nl) : 0.f;
      } else {
        const float* r = col + 6 * k * nl;
        L.chi[k][v] = on ? __ldg(r) : 0.f;
        L.clo[k][v] = on ? __ldg(r + nl) : 0.f;
        L.cf[k][v] = on ? __ldg(r + 2 * nl) : 0.f;
        L.shi[k][v] = on ? __ldg(r + 3 * nl) : 0.f;
        L.slo[k][v] = on ? __ldg(r + 4 * nl) : 0.f;
        L.sf[k][v] = on ? __ldg(r + 5 * nl) : 0.f;
      }
    }
    if constexpr (M == kComp) {
#pragma unroll
      for (int k = 0; k < S::kP; ++k) {
        const bool on = !S::kRt || k < p.np;
        const float* r = col + (6 * nc + 2 * k) * nl;
        L.pc[k][v] = on ? __ldg(r) : 0.f;
        L.ps[k][v] = on ? __ldg(r + nl) : 0.f;
      }
    }
  }
}

// The samples of one h row (shared memory, 16-byte aligned) at the V lanes:
// x[v] (kF32: the sample; kComp: s) and y[v] (kComp: e).
template <int M, class S>
__device__ __forceinline__ void row_samples(const OuterParams& p, const float* __restrict__ h,
                                            const FLanes<M, S>& L, float (&x)[S::kV],
                                            float (&y)[S::kV]) {
  if constexpr (M == kF32 && S::kRt) {
    x[0] = p.a0f;
#pragma unroll
    for (int k = 0; k < S::kC; ++k) {
      if (k >= p.nk) break;
      x[0] = fmaf(h[k], L.c[k][0], x[0]);
      x[0] = fmaf(-h[p.nk + k], L.s[k][0], x[0]);
    }
  } else if constexpr (M == kF32) {
    float hv[S::kHcp];
#pragma unroll
    for (int j = 0; j < S::kHcp / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(h)[j];
      hv[4 * j] = t.x;
      hv[4 * j + 1] = t.y;
      hv[4 * j + 2] = t.z;
      hv[4 * j + 3] = t.w;
    }
#pragma unroll
    for (int v = 0; v < S::kV; ++v) x[v] = p.a0f;
#pragma unroll
    for (int k = 0; k < S::kC; ++k) {
#pragma unroll
      for (int v = 0; v < S::kV; ++v) {
        x[v] = fmaf(hv[k], L.c[k][v], x[v]);
        x[v] = fmaf(-hv[S::kC + k], L.s[k][v], x[v]);
      }
    }
  } else {
#pragma unroll
    for (int v = 0; v < S::kV; ++v) {
      x[v] = p.a0f;
      y[v] = p.a0lo;
    }
#pragma unroll
    for (int k = 0; k < S::kC; ++k) {
      if (S::kRt && k >= p.nk) break;
      const float4 t = reinterpret_cast<const float4*>(h)[k];  // ch_hi ch_lo sh_hi sh_lo
#pragma unroll
      for (int v = 0; v < S::kV; ++v) {
        x[v] = fmaf(t.x, L.chi[k][v], x[v]);  // exact on the 2^-22 grid
        x[v] = fmaf(-t.z, L.shi[k][v], x[v]);
        float e = fmaf(t.x, L.clo[k][v], y[v]);
        e = fmaf(t.y, L.cf[k][v], e);
        e = fmaf(-t.z, L.slo[k][v], e);
        y[v] = fmaf(-t.w, L.sf[k][v], e);
      }
    }
    const float* hp = h + 4 * (S::kRt ? p.nk : S::kC);
#pragma unroll
    for (int k = 0; k < S::kP; ++k) {
      if (S::kRt && k >= p.np) break;
      const float2 t = reinterpret_cast<const float2*>(hp)[k];  // ch sh
#pragma unroll
      for (int v = 0; v < S::kV; ++v) {
        y[v] = fmaf(t.x, L.pc[k][v], y[v]);
        y[v] = fmaf(-t.y, L.ps[k][v], y[v]);
      }
    }
  }
}

template <int kN>
__device__ __forceinline__ float tree_sum(const float (&a)[kN]) {
  if constexpr (kN == 1) {
    return a[0];
  } else if constexpr (kN == 2) {
    return a[0] + a[1];
  } else {
    static_assert(kN == 4, "tree_sum takes 1, 2 or 4 values");
    return (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// Deterministic block sum (fixed tree) of one float per thread.
template <int T>
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = T / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// grid.x covers the lo lanes (kTileThreads * V a block), grid.y the h rows in
// ranges of rpb rows.  kSum = false: write samples to out0 (and e to out1
// for kComp), V at a time.  kSum = true: write one partial per block to
// partials[block].
template <int M, int NC, int NP, bool kSum>
__global__ void __launch_bounds__(kTileThreads)
float_kernel(const OuterParams p, float* __restrict__ out0, float* __restrict__ out1,
             float* __restrict__ partials, i64 rpb) {
  typedef Shape<M, NC, NP> S;
  constexpr int V = S::kV;
  __shared__ __align__(16) float hs[2][kTileRows * S::kHcp];
  const i64 lane0 = ((i64)blockIdx.x * kTileThreads + threadIdx.x) * V;
  FLanes<M, S> L;
  load_flanes<M, S>(p, lane0, L);
  // V = 4 only where nl % 4 == 0: a thread's lanes are all in or all out
  const bool valid = lane0 < p.nl;

  const int hc = S::kRt ? p.hc : S::kHc;
  const i64 r_begin = (i64)blockIdx.y * rpb;
  const i64 nrows = p.rows - r_begin < rpb ? p.rows - r_begin : rpb;
  const int nchunks = (int)((nrows + kTileRows - 1) / kTileRows);
  const float* src = static_cast<const float*>(p.hi) + (p.h0 + r_begin) * hc;
  auto rows_of = [&](int c) {
    return (int)(nrows - (i64)c * kTileRows < kTileRows ? nrows - (i64)c * kTileRows
                                                        : kTileRows);
  };
  auto stage = [&](int c) {  // rows of chunk c into slot c & 1, rows padded to kHcp
    const int nr = rows_of(c);
    const float* s = src + (i64)c * kTileRows * hc;
    float* d = hs[c & 1];
    for (int i = threadIdx.x; i < nr * hc; i += kTileThreads) {
      const int r = i / hc;
      cp_async4(d + r * S::kHcp + (i - r * hc), s + i);
    }
    cp_commit();
  };

  float run = 0.f;
  stage(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage(c + 1);  // its slot's readers passed the previous chunk's barrier
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* buf = hs[c & 1];
    const i64 r0 = r_begin + (i64)c * kTileRows;
    const int nr = rows_of(c);
    float cx[V], cy[V];
#pragma unroll
    for (int v = 0; v < V; ++v) cx[v] = cy[v] = 0.f;
#pragma unroll 1
    for (int r = 0; valid && r < nr; ++r) {
      float x[V], y[V];
      row_samples<M, S>(p, buf + r * S::kHcp, L, x, y);
      if constexpr (kSum) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          cx[v] += x[v];
          if constexpr (M == kComp) cy[v] += y[v];
        }
      } else if constexpr (V == 4) {
        // the intrinsic keeps the 16-byte store (st.global.v4): nvcc splits
        // a plain float4 assignment here into four 4-byte stores
        const i64 o = (r0 + r) * p.nl + lane0;
        __stwb(reinterpret_cast<float4*>(out0 + o), make_float4(x[0], x[1], x[2], x[3]));
        if constexpr (M == kComp)
          __stwb(reinterpret_cast<float4*>(out1 + o), make_float4(y[0], y[1], y[2], y[3]));
      } else {
        const i64 o = (r0 + r) * p.nl + lane0;
        out0[o] = x[0];
        if constexpr (M == kComp) out1[o] = y[0];
      }
    }
    if constexpr (kSum) {
      const float part = M == kComp ? tree_sum(cx) + tree_sum(cy) : tree_sum(cx);
      run += part;
    }
    __syncthreads();  // every reader is done with slot c & 1
  }
  if constexpr (kSum) {
    __shared__ float red[kTileThreads];
    const float total = block_sum<kTileThreads>(run, red);
    if (threadIdx.x == 0) partials[(i64)blockIdx.y * gridDim.x + blockIdx.x] = total;
  }
}

// *out = bias + (sum of the partials, in a fixed order).
__global__ void __launch_bounds__(kFinalThreads)
finalize_kernel(const float* __restrict__ partials, i64 n, int bias,
                float* __restrict__ out) {
  __shared__ float red[kFinalThreads];
  float acc = 0.f;
  for (i64 i = threadIdx.x; i < n; i += kFinalThreads) acc += partials[i];
  red[threadIdx.x] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kFinalThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)bias + red[0];
}

typedef void (*FloatFn)(const OuterParams, float*, float*, float*, i64);

struct FloatKernel {
  FloatFn fn;
  int v;  // lanes a thread
};

template <int M, int NC, int NP, bool kSum>
FloatKernel fk() {
  return {float_kernel<M, NC, NP, kSum>, Shape<M, NC, NP>::kV};
}

// The instantiation for a mode, its counts (validated by make_params) and
// the lane count.
template <bool kSum>
FloatKernel pick(int mode, int nk, int np, int nl) {
  if (nl % 4) return mode == kF32 ? fk<kF32, -1, 0, kSum>() : fk<kComp, -1, -1, kSum>();
  if (mode == kF32) {
    switch (nk) {
      case 1: return fk<kF32, 1, 0, kSum>();
      case 2: return fk<kF32, 2, 0, kSum>();
      case 3: return fk<kF32, 3, 0, kSum>();
      case 4: return fk<kF32, 4, 0, kSum>();
      case 5: return fk<kF32, 5, 0, kSum>();
      case 6: return fk<kF32, 6, 0, kSum>();
      default: return fk<kF32, 7, 0, kSum>();
    }
  }
  if (np == 0 && nk == 1) return fk<kComp, 1, 0, kSum>();  // hann, hamming
  if (np == 0 && nk == 2) return fk<kComp, 2, 0, kSum>();  // blackman, bh3
  if (np == 0 && nk == 3) return fk<kComp, 3, 0, kSum>();  // bh4, nuttall, blackman_nuttall
  if (np == 1 && nk == 3) return fk<kComp, 3, 1, kSum>();  // bh5, flattop1, flattop2
  if (np == 2 && nk == 4) return fk<kComp, 4, 2, kSum>();  // bh7
  return fk<kComp, -1, -1, kSum>();
}

typedef void (*IntFn)(const OuterParams, int*, unsigned*, i64);

struct IntKernel {
  IntFn fn;
  int v;  // lanes a thread
};

template <int NK, int SH, bool kSum>
IntKernel ik() {
  return {int_kernel<NK, SH, kSum>, IShape<NK>::kV};
}

template <int SH, bool kSum>
IntKernel pick_int_count(int nk) {
  switch (nk) {
    case 1: return ik<1, SH, kSum>();
    case 2: return ik<2, SH, kSum>();
    case 3: return ik<3, SH, kSum>();
    case 4: return ik<4, SH, kSum>();
    case 5: return ik<5, SH, kSum>();
    case 6: return ik<6, SH, kSum>();
    default: return ik<7, SH, kSum>();
  }
}

// The int instantiation for a harmonic count and shift (validated by
// make_params) and the lane count.
template <bool kSum>
IntKernel pick_int(int nk, int shift, int nl) {
  if (nl % 4) return ik<-1, 0, kSum>();
  return shift == 30 ? pick_int_count<30, kSum>(nk) : pick_int_count<31, kSum>(nk);
}

struct TileGeom {
  dim3 grid;
  i64 rpb;  // h rows a block walks
};

// Lane blocks to cover nl, and row blocks so that the grid fills the card
// once (SMs x resident blocks of this instantiation), each a contiguous
// range of rpb rows.  K: FloatKernel or IntKernel.
template <class K>
cudaError_t tile_geom(const K& k, i64 rows, int nl, TileGeom* g) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, kTileThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const i64 lanes = (i64)kTileThreads * k.v;
  const i64 gx = (nl + lanes - 1) / lanes;
  i64 gy = (i64)sms * per_sm / gx;
  if (gy < 1) gy = 1;
  g->rpb = (rows + gy - 1) / gy;
  gy = (rows + g->rpb - 1) / g->rpb;
  g->grid = dim3((unsigned)gx, (unsigned)gy);
  return cudaSuccess;
}

// The harmonic counts a mode takes.
bool valid_counts(int mode, int nk, int np) {
  if (nk < 0 || np < 0) return false;
  if (mode == kComp) return nk + np >= 1 && nk + np <= kMaxH;
  return (mode == kInt || mode == kF32) && nk >= 1 && nk <= kMaxH && np == 0;
}

bool make_params(OuterParams* P, int mode, const void* hi, const void* lo, i64 h0,
                 i64 rows, int nl, int hc, int nk, int np, int a0, int shift, int w,
                 int saturate, float a0f, float a0lo) {
  if (!hi || !lo || h0 < 0 || rows < 1 || nl < 1 || !valid_counts(mode, nk, np)) return false;
  if (hc != (mode == kComp ? 4 * nk + 2 * np : 2 * nk)) return false;
  if (mode == kInt && (shift < 30 || shift > 31 || w < 2)) return false;
  P->hi = hi;
  P->lo = lo;
  P->h0 = h0;
  P->rows = rows;
  P->nl = nl;
  P->hc = hc;
  P->nk = nk;
  P->np = np;
  P->a0 = a0;
  P->shift = shift;
  P->w = w;
  P->saturate = saturate;
  P->a0f = a0f;
  P->a0lo = a0lo;
  return true;
}

i64 log2_of(i64 v) {
  i64 r = 0;
  while ((1ll << r) < v) ++r;
  return r;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" {

// Most harmonics (terms - 1) the kernels take.
int bhw_outer_max_harmonics() { return kMaxH; }

// Blocks of a kF32/kComp checksum launch over `rows` h rows of `nl` lanes on
// the current device: the number of f32 partials it needs.  kInt needs none
// (0); -1 for arguments the kernels do not take or a failed device query.
i64 bhw_outer_npartials(int mode, i64 rows, int nl, int nk, int np) {
  if (mode == kInt) return 0;
  TileGeom g;
  if (rows < 1 || nl < 1 || !valid_counts(mode, nk, np) ||
      tile_geom(pick<true>(mode, nk, np, nl), rows, nl, &g) != cudaSuccess)
    return -1;
  return (i64)g.grid.x * g.grid.y;
}

// Longest chain of f32 additions any term (bias included) passes through in
// a kF32/kComp checksum over `rows` h rows of `nl` lanes on the current
// device: a lane's chunk accumulator (kTileRows rows), the tree over V lanes,
// s + e (kComp), the running sum over the chunks of a block's row range, the
// block tree, the finalize thread's run over partials, the finalize tree
// and the bias.  The sum's error is at most gamma(depth) * sum |terms|.
// -1 as bhw_outer_npartials.
i64 bhw_outer_checksum_depth(int mode, i64 rows, int nl, int nk, int np) {
  const i64 npart = bhw_outer_npartials(mode, rows, nl, nk, np);
  if (npart < 1) return -1;
  const FloatKernel k = pick<true>(mode, nk, np, nl);
  TileGeom g;
  if (tile_geom(k, rows, nl, &g) != cudaSuccess) return -1;
  const i64 chunks = (g.rpb + kTileRows - 1) / kTileRows;
  return kTileRows + log2_of(k.v) + (mode == kComp) + chunks + log2_of(kTileThreads) +
         (npart + kFinalThreads - 1) / kFinalThreads + log2_of(kFinalThreads) + 1;
}

// Write-out: samples of h rows [h0, h0 + rows) to out0 (int32 for kInt,
// float32 otherwise; sample (h - h0) * nl + lo), and e to out1 for kComp.
// The outputs must be 16-byte aligned.
int bhw_outer_block(int mode, void* out0, float* out1, const void* hi, const void* lo,
                    i64 h0, i64 rows, int nl, int hc, int nk, int np, int a0, int shift,
                    int w, int saturate, float a0f, float a0lo, void* stream) {
  OuterParams P;
  if (!out0 || (mode == kComp && !out1) ||
      !make_params(&P, mode, hi, lo, h0, rows, nl, hc, nk, np, a0, shift, w, saturate,
                   a0f, a0lo))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(out0) || (mode == kComp && !aligned16(out1))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TileGeom g;
  if (mode == kInt) {
    const IntKernel k = pick_int<false>(nk, shift, P.nl);
    const cudaError_t e = tile_geom(k, P.rows, P.nl, &g);
    if (e != cudaSuccess) return (int)e;
    k.fn<<<g.grid, kTileThreads, 0, s>>>(P, (int*)out0, nullptr, g.rpb);
    return (int)cudaGetLastError();
  }
  const FloatKernel k = pick<false>(mode, nk, np, P.nl);
  const cudaError_t e = tile_geom(k, P.rows, P.nl, &g);
  if (e != cudaSuccess) return (int)e;
  k.fn<<<g.grid, kTileThreads, 0, s>>>(P, (float*)out0, out1, nullptr, g.rpb);
  return (int)cudaGetLastError();
}

// Checksum over h rows [h0, h0 + rows).  kInt: *out (uint32) holds the bias
// on entry and the sum is added to it; partials and bias are unused.
// kF32/kComp: partials holds npartials floats (bhw_outer_npartials; the
// count must match), and *out (float) = bias + sum.
int bhw_outer_checksum(int mode, void* out, float* partials, i64 npartials, int bias,
                       const void* hi, const void* lo, i64 h0, i64 rows, int nl, int hc,
                       int nk, int np, int a0, int shift, int w, int saturate, float a0f,
                       float a0lo, void* stream) {
  OuterParams P;
  if (!out || !make_params(&P, mode, hi, lo, h0, rows, nl, hc, nk, np, a0, shift, w,
                           saturate, a0f, a0lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  TileGeom g;
  if (mode == kInt) {
    const IntKernel k = pick_int<true>(nk, shift, P.nl);
    const cudaError_t e = tile_geom(k, P.rows, P.nl, &g);
    if (e != cudaSuccess) return (int)e;
    k.fn<<<g.grid, kTileThreads, 0, s>>>(P, nullptr, static_cast<unsigned*>(out), g.rpb);
    return (int)cudaGetLastError();
  }
  const FloatKernel k = pick<true>(mode, nk, np, P.nl);
  cudaError_t err = tile_geom(k, P.rows, P.nl, &g);
  if (err != cudaSuccess) return (int)err;
  if (!partials || npartials != (i64)g.grid.x * g.grid.y) return (int)cudaErrorInvalidValue;
  k.fn<<<g.grid, kTileThreads, 0, s>>>(P, nullptr, nullptr, partials, g.rpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<1, kFinalThreads, 0, s>>>(partials, npartials, bias, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
