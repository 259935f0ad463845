// Quantized cosine-sum window generation on Hopper (sm_90a).
//
// Replaces blackman_harris_win_tpu/kernels/pallas/window_kernel.py:
// pallas_window_block (body window_values / window_values_rtl) with two
// kernels:
//   window_block_kernel     (1a) writes int32 samples [n0, n0+length);
//   window_checksum_kernel  (1b) sums them mod 2^32 without storing them.
//
// Per sample and harmonic k: the closed-form phase (k*n) mod 2^PW, a
// fixed-point CORDIC cosine (HLS flavor, W+2-bit state; or the dds flavor,
// W+P-bit state, for the RTL contract), the product a_k*cos, and the
// alternating accumulate with the contract's rounding and wrap/saturate.
// The semantics are those of native/golden.cpp and model/golden.py.
//
// What bounds it on the H100: integer issue rate.  A sample costs
// (K-1) * ITERS CORDIC iterations (6 x 32 at BH-7, W=32) and touches 4
// bytes of memory at most, so the kernel is compute bound and the checksum
// twin writes nothing at all.  The design therefore spends its effort on
// the instructions of one CORDIC iteration:
//
// - One datapath per register width, chosen on the host
//   (window_kernel.py:_datapath) and passed as a template parameter:
//     kI32  internal width iw <= 32 (HLS W <= 30, RTL W+P <= 32): x, y, z
//           in one 32-bit word each (JAX: _cos_i32);
//     kR2s  iw in {33, 34} (HLS W = 31, 32; RTL W+P = 33, 34): x and y as
//           v = 2^S*h + l with h a 32-bit word and l in [0, 2^S),
//           S = iw - 32, z in one 32-bit word after iteration 0 (JAX:
//           _cos_wide4 with its z-fold, cordic_wide._cos_sin_dds_r2s);
//     kI64  any iw <= 40 (the RTL widths W+P = 35..39): int64 state.
// - Every iteration unrolled (#pragma unroll over k < 32 with a
//   warp-uniform k < ITERS exit), so each shift count is an immediate and
//   each lut[k] a constant-bank operand.  Steering is by d = +-1, so
//   x - d*(y>>k) issues as one IMAD on the FMA pipe beside the shifts on
//   the ALU pipe.
// - Two harmonics' CORDIC chains advance in one loop: their independent
//   instructions hide each other's latency.
//
// Exactness.  The reference wraps x, y and z to iw bits after every add;
// on this algorithm those wraps never change a value, so each datapath
// may carry the values unwrapped as long as it holds them exactly:
// - z: HLS z0 = init_z lies in [0, 2^W) (the quadrant bits are cleared and
//   the iw-bit wrap of init_z folds a negative signed phase onto its
//   residue); RTL z0 in [0, 2^(iw-2)) (init_t is masked non-negative,
//   src/cordic_dds.vhd:179).  lut[0] is 2^(W-1) (HLS) or 2^(iw-3) (RTL), so
//   after iteration 0 |z1| <= 2^31 at iw <= 34, and thereafter
//   |z_{k+1}| = ||z_k| - lut[k]| <= max(|z_k|, lut[k]): z stays in one
//   int32 from iteration 1 on (the z-fold of _cos_wide4), and in int64
//   with room to spare.
// - x, y: the vector starts at (gain, 0) with gain = 2^W/K (HLS) or
//   2^(iw-2)/K (RTL), K = 1.6468 the CORDIC gain; each iteration scales
//   its length by sqrt(1 + 2^-2k) and the floored shifts add less than 2
//   per iteration, so |x|, |y| < 2^W + 64 (HLS) or 2^(iw-2) + 64 (RTL),
//   well inside the iw-bit range: no wrap occurs.  For kI32 the values fit
//   int32 (iw <= 32); for kR2s h = v >> S fits int32 (|v| < 2^32 + 64).
// - kR2s step k >= S: y >> k = h_y >> (k - S) exactly (l < 2^S), and
//   x - d*(y>>k) = 2^S*(h_x + (t >> S)) + (t & (2^S - 1)) with
//   t = l_x - d*(y>>k), |t| < 2^31.  Iterations 0 and 1 run in int64
//   (y >> 1 does not fit int32 at S = 2), then the state is split.
// - Output: HLS cos = x >> 2, RTL cos = x >> P; for kR2s that is
//   h_x >> (2 - S) or h_x >> (P - S) (P >= S since W <= 32).
// All 32-bit adds and multiplies go through uint32_t and all int64 left
// shifts through uint64_t, so even a wrap would be defined (ROADMAP "Wrap
// arithmetic must stay defined"); right shifts of negative values are
// arithmetic under nvcc.
//
// Per harmonic, outside the iterations: the product a_k*cos is one
// 32x32->64 multiply (|a_k| < 2^31 is checked on the host), and the
// accumulator is an exact int64 for every contract: 2 instructions a term
// out of some 450 per harmonic, exact for saturate and for the RTL W+2-bit
// tree at any W, where the JAX int32 forms need overflow counting and a
// radix-4 tree only because the TPU has no int64.
//
// Checksum grid: SMs x the occupancy of the kernel (cudaOccupancy...), a
// grid-stride loop of several samples per thread; the uint32 sum is exact
// mod 2^32 in any order.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kMaxTerms = 8;
constexpr int kMaxLut = 48;
constexpr int kMaxIters = 32;
constexpr int kThreads = 256;

// datapath codes, in the order of window_kernel.py:_DATAPATHS
enum Datapath : int { kI32 = 0, kR2s = 1, kI64 = 2 };

struct WinParams {
  i64 lut[kMaxLut];
  i64 gain;
  int coeffs[kMaxTerms];
  int nterms, pw, w, p, iters, rtl, saturate;
};

// Two's-complement wrap to `width` bits (sign-extended low bits).
__device__ __forceinline__ i64 wrapw(i64 v, int width) {
  const int s = 64 - width;
  return (i64)((u64)v << s) >> s;
}

__device__ __forceinline__ i64 shl(i64 v, int s) { return (i64)((u64)v << s); }

// v when m == 0, -v when m == -1
__device__ __forceinline__ i64 cneg(i64 v, i64 m) { return (i64)(((u64)v ^ (u64)m) - (u64)m); }

// One CORDIC chain after iteration 0: int64 state and the quadrant.
struct Chain {
  i64 x, y, z;
  int q;
};

// Phase front end (HLS: hls/windows/win_function.cpp:47-156; RTL:
// src/cordic_dds.vhd) and iteration 0, where y0 = 0.
__device__ __forceinline__ Chain front(i64 un, const WinParams& P) {
  const int pw = P.pw, w = P.w;
  Chain c;
  c.q = (int)(un >> (pw - 2));
  i64 z;
  if (!P.rtl) {
    const int iw = w + 2;
    const i64 sphi = (un >> (pw - 1)) ? un - (1ll << pw) : un;
    const i64 init_t = sphi & ~(3ll << (pw - 2));
    z = (pw - 1 < w) ? wrapw(shl(init_t, w - pw + 2), iw)
                     : wrapw(shl(init_t >> (pw - w), 2), iw);
  } else {
    const i64 init_t = un & ((1ll << (pw - 2)) - 1);
    z = (pw >= w) ? shl(init_t >> (pw - w), P.p) : shl(init_t, w - pw + P.p);
  }
  const i64 m = z >> 63;  // -1 where z < 0: x += y>>k, y -= x>>k, z += lut
  c.x = P.gain;
  c.y = cneg(P.gain, m);
  c.z = z - cneg(P.lut[0], m);
  return c;
}

// Iteration k on int64 state.
__device__ __forceinline__ void step64(i64& x, i64& y, i64& z, int k, i64 lut) {
  const i64 m = z >> 63;
  const i64 ys = y >> k, xs = x >> k;
  x = (i64)((u64)x - (u64)cneg(ys, m));
  y = (i64)((u64)y + (u64)cneg(xs, m));
  z = (i64)((u64)z - (u64)cneg(lut, m));
}

// The steering sign d = +1 (z >= 0) or -1 (z < 0).
__device__ __forceinline__ unsigned steer(int z) { return (unsigned)((z >> 31) | 1); }

// Iteration k on one 32-bit word per register.
__device__ __forceinline__ void step32(int& x, int& y, int& z, int k, int lut) {
  const unsigned d = steer(z);
  const int ys = y >> k, xs = x >> k;
  x = (int)((unsigned)x - d * (unsigned)ys);
  y = (int)((unsigned)y + d * (unsigned)xs);
  z = (int)((unsigned)z - d * (unsigned)lut);
}

// Iteration k >= S on radix-2^S state v = 2^S*h + l, z in one word.
template <int S>
__device__ __forceinline__ void step_r2s(int& xh, int& xl, int& yh, int& yl, int& z, int k,
                                         int lut) {
  constexpr int ms = (1 << S) - 1;
  const unsigned d = steer(z);
  const int ys = yh >> (k - S), xs = xh >> (k - S);  // y >> k, x >> k
  const int tx = (int)((unsigned)xl - d * (unsigned)ys);
  const int ty = (int)((unsigned)yl + d * (unsigned)xs);
  xh = (int)((unsigned)xh + (unsigned)(tx >> S));
  xl = tx & ms;
  yh = (int)((unsigned)yh + (unsigned)(ty >> S));
  yl = ty & ms;
  z = (int)((unsigned)z - d * (unsigned)lut);
}

// Output-side quadrant fix of cos from xo = x >> (2 | P) and yo = y >> (2 | P).
__device__ __forceinline__ int quadrant(i64 xo, i64 yo, int q, const WinParams& P) {
  const int w = P.w;
  if (P.rtl) {  // dat = wrap(v >> P, W) before the fix (src/cordic_dds.vhd:225-249)
    xo = wrapw(xo, w);
    yo = wrapw(yo, w);
  }
  return (int)wrapw(q == 0 ? xo : q == 1 ? -yo : q == 2 ? -xo : yo, w);
}

// The cosines of harmonics k0 .. k0+NC-1 at sample n, NC chains in flight.
template <int DP, int S, int NC>
__device__ __forceinline__ void cos_chains(i64 n, int k0, int* out, const WinParams& P) {
  const u64 mask = (1ull << P.pw) - 1;
  const int iters = P.iters;
  const int oshift = P.rtl ? P.p : 2;
  Chain ch[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) ch[j] = front((i64)(((u64)(k0 + j) * (u64)n) & mask), P);

  if constexpr (DP == kI64) {
#pragma unroll
    for (int k = 1; k < kMaxIters; ++k) {
      if (k >= iters) break;
      const i64 lut = P.lut[k];
#pragma unroll
      for (int j = 0; j < NC; ++j) step64(ch[j].x, ch[j].y, ch[j].z, k, lut);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
      out[j] = quadrant(ch[j].x >> oshift, ch[j].y >> oshift, ch[j].q, P);
  } else if constexpr (DP == kI32) {
    int x[NC], y[NC], z[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      x[j] = (int)ch[j].x;
      y[j] = (int)ch[j].y;
      z[j] = (int)ch[j].z;
    }
#pragma unroll
    for (int k = 1; k < kMaxIters; ++k) {
      if (k >= iters) break;
      const int lut = (int)P.lut[k];
#pragma unroll
      for (int j = 0; j < NC; ++j) step32(x[j], y[j], z[j], k, lut);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) out[j] = quadrant(x[j] >> oshift, y[j] >> oshift, ch[j].q, P);
  } else {
    static_assert(S == 1 || S == 2, "radix-2^S state needs iw = 32 + S");
    constexpr int ms = (1 << S) - 1;
    int xh[NC], xl[NC], yh[NC], yl[NC], z[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      step64(ch[j].x, ch[j].y, ch[j].z, 1, P.lut[1]);
      xh[j] = (int)(ch[j].x >> S);
      xl[j] = (int)(ch[j].x & ms);
      yh[j] = (int)(ch[j].y >> S);
      yl[j] = (int)(ch[j].y & ms);
      z[j] = (int)ch[j].z;
    }
#pragma unroll
    for (int k = 2; k < kMaxIters; ++k) {
      if (k >= iters) break;
      const int lut = (int)P.lut[k];
#pragma unroll
      for (int j = 0; j < NC; ++j) step_r2s<S>(xh[j], xl[j], yh[j], yl[j], z[j], k, lut);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
      out[j] = quadrant(xh[j] >> (oshift - S), yh[j] >> (oshift - S), ch[j].q, P);
  }
}

// The contract's term of harmonic k from its cosine c (|a_k| < 2^31).
__device__ __forceinline__ i64 term(int a, int c, const WinParams& P) {
  const i64 prod = (i64)a * (i64)c;
  if (!P.rtl) return prod >> (P.w - 2);  // HLS: m_k = (a_k * cos_k) >> (W-2)
  // RTL (src/bh_win_3term.vhd:257-280): product slice -> W+1 bits, round
  // half up off bit 0 -> W bits
  const i64 r = wrapw(prod >> (P.w - 2), P.w + 1);
  return wrapw((r >> 1) + (r & 1), P.w);
}

// One window sample at index n (any n >= 0; phases are taken mod 2^PW).
template <int DP, int S>
__device__ __forceinline__ int window_sample(i64 n, const WinParams& P) {
  const int w = P.w;
  i64 acc = P.coeffs[0];  // a0 - t1 + t2 - ...: k odd subtracts
  int k = 1;
  for (; k + 1 < P.nterms; k += 2) {
    int c[2];
    cos_chains<DP, S, 2>(n, k, c, P);
    acc -= term(P.coeffs[k], c[0], P);
    acc += term(P.coeffs[k + 1], c[1], P);
  }
  if (k < P.nterms) {
    int c[1];
    cos_chains<DP, S, 1>(n, k, c, P);
    acc -= term(P.coeffs[k], c[0], P);
  }
  if (!P.rtl) {
    if (P.saturate) {  // the int64 accumulator is exact: clamp the true sum
      const i64 hi = (1ll << (w - 1)) - 1, lo = -(1ll << (w - 1));
      return (int)(acc > hi ? hi : (acc < lo ? lo : acc));
    }
    return (int)wrapw(acc, w);
  }
  // RTL: the output register is W bits, so saturate and wrap agree
  if (P.nterms == 2) {  // src/hamming_win.vhd:194-231: W+1-bit subtract, round off bit 0
    const i64 pp = wrapw(acc, w + 1);
    return (int)wrapw((pp >> 1) + (pp & 1), w);
  }
  // W+2-bit alternating tree, round half up off bit 1 (src/bh_win_3term.vhd:282-306)
  const i64 pp = wrapw(acc, w + 2);
  return (int)wrapw((pp >> 2) + ((pp >> 1) & 1), w);
}

template <int DP, int S>
__global__ void __launch_bounds__(kThreads)
window_block_kernel(int* __restrict__ out, i64 n0, i64 length, const WinParams P) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < length) out[i] = window_sample<DP, S>(n0 + i, P);
}

// Sum mod 2^32 is associative and commutative, so the per-thread, per-warp
// and cross-block (atomicAdd) partial sums give a bit-exact total in any
// block order.  *out holds the bias on entry.
template <int DP, int S>
__global__ void __launch_bounds__(kThreads)
window_checksum_kernel(unsigned* __restrict__ out, i64 n_start, i64 count, const WinParams P) {
  unsigned acc = 0;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride)
    acc += (unsigned)window_sample<DP, S>(n_start + i, P);
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

typedef void (*BlockKernel)(int*, i64, i64, WinParams);
typedef void (*ChecksumKernel)(unsigned*, i64, i64, WinParams);

// The instantiation for a datapath code at internal width iw, or null
// where that datapath cannot hold the width.
BlockKernel block_kernel(int dp, int iw) {
  if (dp == kI32 && iw <= 32) return window_block_kernel<kI32, 0>;
  if (dp == kR2s && iw == 33) return window_block_kernel<kR2s, 1>;
  if (dp == kR2s && iw == 34) return window_block_kernel<kR2s, 2>;
  if (dp == kI64 && iw <= 40) return window_block_kernel<kI64, 0>;
  return nullptr;
}

ChecksumKernel checksum_kernel(int dp, int iw) {
  if (dp == kI32 && iw <= 32) return window_checksum_kernel<kI32, 0>;
  if (dp == kR2s && iw == 33) return window_checksum_kernel<kR2s, 1>;
  if (dp == kR2s && iw == 34) return window_checksum_kernel<kR2s, 2>;
  if (dp == kI64 && iw <= 40) return window_checksum_kernel<kI64, 0>;
  return nullptr;
}

bool make_params(WinParams* P, const i64* coeffs, int nterms, const i64* lut, int nlut,
                 i64 gain, int pw, int w, int p, int rtl, int saturate) {
  if (nterms < 2 || nterms > kMaxTerms || nlut < 1 || nlut > kMaxLut) return false;
  if (pw < 4 || pw > 48 || w < 8 || w > 32 || p < 0 || p > 7) return false;
  for (int i = 0; i < kMaxTerms; ++i) {
    const i64 c = i < nterms ? coeffs[i] : 0;
    if (c < INT_MIN || c > INT_MAX) return false;
    P->coeffs[i] = (int)c;
  }
  for (int i = 0; i < kMaxLut; ++i) P->lut[i] = i < nlut ? lut[i] : 0;
  P->gain = gain;
  P->nterms = nterms;
  P->pw = pw;
  P->w = w;
  P->p = p;
  P->iters = rtl ? w - 1 : w;
  P->rtl = rtl;
  P->saturate = saturate;
  return true;
}

int internal_width(const WinParams& P) { return P.rtl ? P.w + P.p : P.w + 2; }

}  // namespace

extern "C" {

int bhw_window_block(int* out, i64 n0, i64 length, const i64* coeffs, int nterms,
                     const i64* lut, int nlut, i64 gain, int pw, int w, int p, int rtl,
                     int saturate, int datapath, void* stream) {
  WinParams P;
  if (!make_params(&P, coeffs, nterms, lut, nlut, gain, pw, w, p, rtl, saturate))
    return (int)cudaErrorInvalidValue;
  const BlockKernel kern = block_kernel(datapath, internal_width(P));
  const i64 blocks = (length + kThreads - 1) / kThreads;
  if (!kern || blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(out, n0, length, P);
  return (int)cudaGetLastError();
}

int bhw_window_checksum(unsigned* out, i64 n_start, i64 count, const i64* coeffs, int nterms,
                        const i64* lut, int nlut, i64 gain, int pw, int w, int p, int rtl,
                        int saturate, int datapath, void* stream) {
  WinParams P;
  if (!make_params(&P, coeffs, nterms, lut, nlut, gain, pw, w, p, rtl, saturate))
    return (int)cudaErrorInvalidValue;
  const ChecksumKernel kern = checksum_kernel(datapath, internal_width(P));
  if (!kern || count < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  i64 blocks = (count + kThreads - 1) / kThreads;
  const i64 full = (i64)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > full) blocks = full;
  kern<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(out, n_start, count, P);
  return (int)cudaGetLastError();
}

const char* bhw_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
