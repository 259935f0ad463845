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
// (K-1) * W CORDIC iterations of 64-bit add/shift/select (about 6 x 32 at
// BH-7, W=32) and touches 4 bytes of memory at most, so the kernel is
// compute bound and the checksum twin writes nothing at all.  The TPU
// datapath split every 34-bit register into int32 limbs because the TPU
// has no int64; Hopper emulates int64 add/shift in a couple of 32-bit
// instructions, so the state is kept as plain int64 (the limb tricks of
// limb.py / cordic_wide.py are not ported).  One thread per sample (1a) or
// a grid-stride loop (1b) gives enough independent work to hide latency;
// the coefficients and atan LUT (up to 31 entries, lut[0] = 2^31 at W=32)
// travel in the kernel's parameter block.
//
// Defined arithmetic: every wrap and left shift goes through uint64_t (a
// left shift of a negative signed value is undefined in C++17); right
// shifts of negative values are arithmetic under nvcc.  No sum can
// overflow int64: states are < 2^49 and products < 2^63 (checked by the
// Python wrapper).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kMaxTerms = 8;
constexpr int kMaxLut = 48;
constexpr int kThreads = 256;
constexpr i64 kChecksumBlocks = 4096;

struct WinParams {
  i64 coeffs[kMaxTerms];
  i64 lut[kMaxLut];
  i64 gain;
  int nterms, pw, w, p, rtl, saturate;
};

// Two's-complement wrap to `width` bits (sign-extended low bits).
__device__ __forceinline__ i64 wrapw(i64 v, int width) {
  const int s = 64 - width;
  return (i64)((u64)v << s) >> s;
}

__device__ __forceinline__ i64 shl(i64 v, int s) { return (i64)((u64)v << s); }

// HLS win_function CORDIC cosine (hls/windows/win_function.cpp:47-156).
__device__ __forceinline__ i64 cos_hls(i64 un, const WinParams& P) {
  const int pw = P.pw, w = P.w, iw = w + 2;
  const i64 q = un >> (pw - 2);
  const i64 sphi = (un >> (pw - 1)) ? un - (1ll << pw) : un;
  const i64 init_t = sphi & ~(3ll << (pw - 2));
  i64 z = (pw - 1 < w) ? wrapw(shl(init_t, w - pw + 2), iw)
                       : wrapw(shl(init_t >> (pw - w), 2), iw);
  i64 x = P.gain, y = 0;
  for (int k = 0; k < w; ++k) {
    const bool neg = z < 0;
    const i64 ys = y >> k, xs = x >> k;
    const i64 xn = wrapw(neg ? x + ys : x - ys, iw);
    y = wrapw(neg ? y - xs : y + xs, iw);
    x = xn;
    if (k < w - 1) z = wrapw(neg ? z + P.lut[k] : z - P.lut[k], iw);
  }
  const i64 c = x >> 2, s = y >> 2;
  return wrapw(q == 0 ? c : q == 1 ? -s : q == 2 ? -c : s, w);
}

// dds CORDIC cosine (src/cordic_dds.vhd), W+P-bit state.
__device__ __forceinline__ i64 cos_dds(i64 un, const WinParams& P) {
  const int pw = P.pw, w = P.w, p = P.p, iw = w + p;
  const i64 q = un >> (pw - 2);
  const i64 init_t = un & ((1ll << (pw - 2)) - 1);
  i64 z = (pw >= w) ? shl(init_t >> (pw - w), p) : shl(init_t, w - pw + p);
  i64 x = P.gain, y = 0;
  for (int i = 0; i < w - 1; ++i) {
    const bool neg = z < 0;
    const i64 ys = y >> i, xs = x >> i;
    const i64 xn = wrapw(neg ? x + ys : x - ys, iw);
    y = wrapw(neg ? y - xs : y + xs, iw);
    x = xn;
    z = wrapw(neg ? z + P.lut[i] : z - P.lut[i], iw);
  }
  const i64 c = wrapw(x >> p, w), s = wrapw(y >> p, w);
  return wrapw(q == 0 ? c : q == 1 ? -s : q == 2 ? -c : s, w);
}

// One window sample at index n (any n >= 0; phases are taken mod 2^PW).
__device__ __forceinline__ i64 window_sample(i64 n, const WinParams& P) {
  const u64 mask = (1ull << P.pw) - 1;
  const int w = P.w;
  if (!P.rtl) {
    // HLS: a0 - m1 + m2 - ..., m_k = (a_k * cos_k) >> (W-2)
    i64 acc = P.coeffs[0];
    for (int k = 1; k < P.nterms; ++k) {
      const i64 ph = (i64)(((u64)k * (u64)n) & mask);
      const i64 m = (P.coeffs[k] * cos_hls(ph, P)) >> (w - 2);
      acc = (k & 1) ? acc - m : acc + m;
    }
    if (P.saturate) {
      // the int64 accumulator is exact: clamp the true sum
      const i64 hi = (1ll << (w - 1)) - 1, lo = -(1ll << (w - 1));
      return acc > hi ? hi : (acc < lo ? lo : acc);
    }
    return wrapw(acc, w);
  }
  // RTL (src/bh_win_3term.vhd:257-306): product slice -> W+1 bits, round
  // half up off bit 0 -> W bits, W+2-bit alternating tree, round off bit 1.
  // The output register is W bits, so saturate and wrap agree.
  if (P.nterms == 2) {  // src/hamming_win.vhd:194-231
    const i64 r = wrapw((P.coeffs[1] * cos_dds((i64)((u64)n & mask), P)) >> (w - 2), w + 1);
    const i64 b = wrapw((r >> 1) + (r & 1), w);
    const i64 pp = wrapw(P.coeffs[0] - b, w + 1);
    return wrapw((pp >> 1) + (pp & 1), w);
  }
  i64 acc = P.coeffs[0];
  for (int k = 1; k < P.nterms; ++k) {
    const i64 ph = (i64)(((u64)k * (u64)n) & mask);
    const i64 r = wrapw((P.coeffs[k] * cos_dds(ph, P)) >> (w - 2), w + 1);
    const i64 b = wrapw((r >> 1) + (r & 1), w);
    acc = (k & 1) ? acc - b : acc + b;
  }
  const i64 pp = wrapw(acc, w + 2);
  return wrapw((pp >> 2) + ((pp >> 1) & 1), w);
}

__global__ void __launch_bounds__(kThreads)
window_block_kernel(int* __restrict__ out, i64 n0, i64 length, const WinParams P) {
  const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < length) out[i] = (int)window_sample(n0 + i, P);
}

// Sum mod 2^32 is associative and commutative, so the per-thread, per-warp
// and cross-block (atomicAdd) partial sums give a bit-exact total in any
// block order.  *out holds the bias on entry.
__global__ void __launch_bounds__(kThreads)
window_checksum_kernel(unsigned* __restrict__ out, i64 n_start, i64 count,
                       const WinParams P) {
  unsigned acc = 0;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride)
    acc += (unsigned)window_sample(n_start + i, P);
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

bool make_params(WinParams* P, const i64* coeffs, int nterms, const i64* lut,
                 int nlut, i64 gain, int pw, int w, int p, int rtl, int saturate) {
  if (nterms < 2 || nterms > kMaxTerms || nlut < 0 || nlut > kMaxLut) return false;
  if (pw < 4 || pw > 48 || w < 8 || w > 32 || p < 0 || p > 7) return false;
  for (int i = 0; i < kMaxTerms; ++i) P->coeffs[i] = i < nterms ? coeffs[i] : 0;
  for (int i = 0; i < kMaxLut; ++i) P->lut[i] = i < nlut ? lut[i] : 0;
  P->gain = gain;
  P->nterms = nterms;
  P->pw = pw;
  P->w = w;
  P->p = p;
  P->rtl = rtl;
  P->saturate = saturate;
  return true;
}

}  // namespace

extern "C" {

int bhw_window_block(int* out, i64 n0, i64 length, const i64* coeffs, int nterms,
                     const i64* lut, int nlut, i64 gain, int pw, int w, int p,
                     int rtl, int saturate, void* stream) {
  WinParams P;
  if (!make_params(&P, coeffs, nterms, lut, nlut, gain, pw, w, p, rtl, saturate))
    return (int)cudaErrorInvalidValue;
  const i64 blocks = (length + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  window_block_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, n0, length, P);
  return (int)cudaGetLastError();
}

int bhw_window_checksum(unsigned* out, i64 n_start, i64 count, const i64* coeffs,
                        int nterms, const i64* lut, int nlut, i64 gain, int pw,
                        int w, int p, int rtl, int saturate, void* stream) {
  WinParams P;
  if (!make_params(&P, coeffs, nterms, lut, nlut, gain, pw, w, p, rtl, saturate))
    return (int)cudaErrorInvalidValue;
  i64 blocks = (count + kThreads - 1) / kThreads;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  if (blocks > kChecksumBlocks) blocks = kChecksumBlocks;
  window_checksum_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, n_start, count, P);
  return (int)cudaGetLastError();
}

const char* bhw_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
