// Outer-product window tiles on Hopper (sm_90a): the int, float32 and
// compensated-pair fast modes.
//
// Replaces blackman_harris_win_tpu/kernels/pallas/outerwin_kernel.py:
//   make_checksum_fn       (_reduce_kernel over tile_window)      -> kInt
//   make_checksum_fn_f32   (_reduce_kernel_f32)                   -> kF32
//   make_checksum_fn_comp  (_reduce_kernel_comp over comp_tile)   -> kComp
// with one templated tile generator and two epilogues: the checksum (the
// port of those three kernels: the window is summed, never stored) and the
// write-out (the samples of kernels/outerwin.py window_block_outer,
// floatwin.py float_window_block and compwin.py comp_window_block).
//
// Sample n = h * 2^m + lo.  The host builds, per configuration, an h-table
// hi (nh, hc) and a lo-table lo (lr, nl), row-major, exactly as the JAX
// package builds them:
//   kInt, kF32: hi row = [ch_0..ch_{K-2} | sh_0..sh_{K-2}], lo = [cl ; sl];
//   kComp:      hi row = [hic (4C) | hip (2P)], lo = [loc (6C) ; lop (2P)].
//
// Design: one thread per lo lane.  A thread loads its lane's lo values into
// registers once (2(K-1) values, or 6C + 2P <= 42 for comp) and walks h
// rows; the block stages kRows h rows (at most 28 values each) in shared
// memory per step, since every lane of a row reads the same h values.  The
// lo table is not staged: the comp table is 6C x 2048 x 4 B = 192 KB at
// BH-7, m = 11.
//
// What bounds it on the H100: arithmetic issue.  Per sample and harmonic,
// kInt costs two 64-bit products, a subtract, a round and a 32-bit add
// (about 8-10 instructions; 64-bit multiplies are emulated), kF32 two FMAs
// (12 per sample at BH-7), kComp 12 multiply/add.  Memory traffic is the
// 4-8 output bytes per sample in the write-out and nothing in the
// checksum.
//
// Arithmetic:
// - kInt: v = ch*cl - sh*sl in int64 (|v| < 2^61), (v + 2^(s-1)) >> s with
//   s = 30 + guard (right shifts of negative int64 are arithmetic under
//   nvcc), accumulated mod 2^32 in uint32 (the JAX int32 wrap), then the
//   W < 32 wrap (sign extension from W bits, done on the unsigned word) or
//   saturate clamp.  At W = 32 saturate does nothing, as in the JAX
//   package.  The checksum is a uint32 sum: warp, block, then atomicAdd,
//   bit-exact in any order.
// - kF32: acc = fma(-sh, sl, fma(ch, cl, acc)) per harmonic, written as
//   explicit fmaf so that every instantiation computes the same bits.
// - kComp: comp_tile's expression in comp_tile's order with round-to-
//   nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
//   contracts: s is exact on the 2^-22 grid either way, and e then equals
//   the plain PyTorch version's bits.  No TwoSum here: the raw (s, e) pair
//   is the contract and its normalization stays on the host.
// - kF32/kComp checksums: per-thread running sums, a fixed block tree into
//   one partial per block, and a second one-block kernel that sums the
//   partials in a fixed order and adds the bias.  No float atomics, so
//   repeated calls return the same bits.
//
// No allocation here: the wrapper passes the outputs and the partials.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kThreads = 256;      // lo lanes per block
constexpr int kRows = 32;          // h rows staged per block step
constexpr int kMaxH = 7;           // harmonics a_1..a_7 (8 terms)
constexpr int kMaxHiCols = 4 * kMaxH;
constexpr i64 kMaxRowBlocks = 65535;
constexpr int kFinalThreads = 256;

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

template <int M> struct Elem { typedef float T; };
template <> struct Elem<kInt> { typedef int T; };

// One lane's lo-table values, in registers (indices are compile-time after
// unrolling).
template <int M> struct Lanes;
template <> struct Lanes<kInt> { int c[kMaxH], s[kMaxH]; };
template <> struct Lanes<kF32> { float c[kMaxH], s[kMaxH]; };
template <> struct Lanes<kComp> {
  float chi[kMaxH], clo[kMaxH], cf[kMaxH], shi[kMaxH], slo[kMaxH], sf[kMaxH];
  float pc[kMaxH], ps[kMaxH];
};

template <int M>
__device__ __forceinline__ void load_lanes(const OuterParams& p, int lane, Lanes<M>& L) {
  typedef typename Elem<M>::T T;
  const T* lo = static_cast<const T*>(p.lo) + lane;
  const i64 nl = p.nl;
  if constexpr (M == kComp) {
#pragma unroll
    for (int k = 0; k < kMaxH; ++k) {
      const bool c = k < p.nk, q = k < p.np;
      const float* r = lo + (i64)(6 * k) * nl;
      L.chi[k] = c ? __ldg(r) : 0.f;
      L.clo[k] = c ? __ldg(r + nl) : 0.f;
      L.cf[k] = c ? __ldg(r + 2 * nl) : 0.f;
      L.shi[k] = c ? __ldg(r + 3 * nl) : 0.f;
      L.slo[k] = c ? __ldg(r + 4 * nl) : 0.f;
      L.sf[k] = c ? __ldg(r + 5 * nl) : 0.f;
      const float* rp = lo + (i64)(6 * p.nk + 2 * k) * nl;
      L.pc[k] = q ? __ldg(rp) : 0.f;
      L.ps[k] = q ? __ldg(rp + nl) : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxH; ++k) {
      const bool c = k < p.nk;
      L.c[k] = c ? __ldg(lo + (i64)k * nl) : T(0);
      L.s[k] = c ? __ldg(lo + (i64)(p.nk + k) * nl) : T(0);
    }
  }
}

__device__ __forceinline__ int sample_int(const OuterParams& p, const int* h,
                                          const Lanes<kInt>& L) {
  const i64 half = 1ll << (p.shift - 1);
  unsigned acc = (unsigned)p.a0;
#pragma unroll
  for (int k = 0; k < kMaxH; ++k) {
    if (k < p.nk) {
      const i64 v = (i64)h[k] * L.c[k] - (i64)h[p.nk + k] * L.s[k];
      acc += (unsigned)((v + half) >> p.shift);
    }
  }
  if (p.w < 32) {
    if (p.saturate) {
      const int hi = (1 << (p.w - 1)) - 1, lo = -hi - 1;
      const int a = (int)acc;
      return a > hi ? hi : (a < lo ? lo : a);
    }
    const int sw = 32 - p.w;
    return (int)(acc << sw) >> sw;
  }
  return (int)acc;
}

__device__ __forceinline__ float sample_f32(const OuterParams& p, const float* h,
                                            const Lanes<kF32>& L) {
  float acc = p.a0f;
#pragma unroll
  for (int k = 0; k < kMaxH; ++k) {
    if (k < p.nk) {
      acc = fmaf(h[k], L.c[k], acc);
      acc = fmaf(-h[p.nk + k], L.s[k], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ float2 sample_comp(const OuterParams& p, const float* h,
                                              const Lanes<kComp>& L) {
  float s = p.a0f, e = p.a0lo;
#pragma unroll
  for (int k = 0; k < kMaxH; ++k) {
    if (k < p.nk) {
      const float chh = h[4 * k], chl = h[4 * k + 1];
      const float shh = h[4 * k + 2], shl = h[4 * k + 3];
      // exact on the 2^-22 grid
      s = __fadd_rn(s, __fsub_rn(__fmul_rn(chh, L.chi[k]), __fmul_rn(shh, L.shi[k])));
      e = __fadd_rn(e, __fsub_rn(
                           __fadd_rn(__fmul_rn(chh, L.clo[k]), __fmul_rn(chl, L.cf[k])),
                           __fadd_rn(__fmul_rn(shh, L.slo[k]), __fmul_rn(shl, L.sf[k]))));
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxH; ++k) {
    if (k < p.np) {
      const float* hp = h + 4 * p.nk + 2 * k;
      e = __fadd_rn(e, __fsub_rn(__fmul_rn(hp[0], L.pc[k]), __fmul_rn(hp[1], L.ps[k])));
    }
  }
  return make_float2(s, e);
}

// Deterministic block sum (fixed tree) of one float per thread.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// grid.x covers the lo lanes, grid.y strides over runs of kRows h rows.
// kSum = false: write samples to out0 (and e to out1 for kComp).
// kSum = true: kInt adds the uint32 sum onto *(unsigned*)sum_out; kF32 and
// kComp write one partial per block to ((float*)sum_out)[block].
template <int M, bool kSum>
__global__ void __launch_bounds__(kThreads)
outer_kernel(const OuterParams p, typename Elem<M>::T* __restrict__ out0,
             float* __restrict__ out1, void* __restrict__ sum_out) {
  typedef typename Elem<M>::T T;
  __shared__ T hs[kRows * kMaxHiCols];
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool active = lane < p.nl;
  Lanes<M> L;
  load_lanes<M>(p, active ? lane : 0, L);
  const T* hi = static_cast<const T*>(p.hi);
  const i64 nruns = (p.rows + kRows - 1) / kRows;
  unsigned isum = 0;
  float fsum = 0.f, esum = 0.f;
  for (i64 run = blockIdx.y; run < nruns; run += gridDim.y) {
    const i64 r0 = run * kRows;
    const int nr = (int)(p.rows - r0 < kRows ? p.rows - r0 : kRows);
    __syncthreads();  // the previous run's readers are done with hs
    const T* src = hi + (p.h0 + r0) * p.hc;
    for (int i = threadIdx.x; i < nr * p.hc; i += kThreads) hs[i] = __ldg(src + i);
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const T* h = hs + r * p.hc;
      const i64 o = (r0 + r) * p.nl + lane;
      if constexpr (M == kInt) {
        const int v = sample_int(p, h, L);
        if constexpr (kSum) {
          if (active) isum += (unsigned)v;
        } else if (active) {
          out0[o] = v;
        }
      } else if constexpr (M == kF32) {
        const float v = sample_f32(p, h, L);
        if constexpr (kSum) {
          if (active) fsum += v;
        } else if (active) {
          out0[o] = v;
        }
      } else {
        const float2 v = sample_comp(p, h, L);
        if constexpr (kSum) {
          if (active) {
            fsum += v.x;
            esum += v.y;
          }
        } else if (active) {
          out0[o] = v.x;
          out1[o] = v.y;
        }
      }
    }
  }
  if constexpr (kSum) {
    if constexpr (M == kInt) {
      for (int o = 16; o > 0; o >>= 1) isum += __shfl_down_sync(0xffffffffu, isum, o);
      __shared__ unsigned warp_sum[kThreads / 32];
      const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
      if (wl == 0) warp_sum[warp] = isum;
      __syncthreads();
      if (warp == 0) {
        isum = wl < kThreads / 32 ? warp_sum[wl] : 0u;
        for (int o = 16; o > 0; o >>= 1) isum += __shfl_down_sync(0xffffffffu, isum, o);
        if (wl == 0) atomicAdd(static_cast<unsigned*>(sum_out), isum);
      }
    } else {
      __shared__ float red[kThreads];
      const float total = block_sum(fsum + esum, red);
      if (threadIdx.x == 0)
        static_cast<float*>(sum_out)[(i64)blockIdx.y * gridDim.x + blockIdx.x] = total;
    }
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

bool make_params(OuterParams* P, int mode, const void* hi, const void* lo, i64 h0,
                 i64 rows, int nl, int hc, int nk, int np, int a0, int shift, int w,
                 int saturate, float a0f, float a0lo) {
  if (!hi || !lo || h0 < 0 || rows < 1 || nl < 1 || nk < 0 || np < 0) return false;
  if (mode == kComp) {
    if (nk + np < 1 || nk + np > kMaxH || hc != 4 * nk + 2 * np) return false;
  } else if (mode == kInt || mode == kF32) {
    if (nk < 1 || nk > kMaxH || np != 0 || hc != 2 * nk) return false;
    if (mode == kInt && (shift < 30 || shift > 31 || w < 2)) return false;
  } else {
    return false;
  }
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

dim3 grid_of(i64 rows, int nl) {
  const i64 runs = (rows + kRows - 1) / kRows;
  return dim3((unsigned)((nl + kThreads - 1) / kThreads),
              (unsigned)(runs < kMaxRowBlocks ? runs : kMaxRowBlocks));
}

i64 log2_of(i64 v) {
  i64 r = 0;
  while ((1ll << r) < v) ++r;
  return r;
}

}  // namespace

extern "C" {

// Most harmonics (terms - 1) the kernels take.
int bhw_outer_max_harmonics() { return kMaxH; }

// Blocks of a launch over `rows` h rows of `nl` lanes: the number of f32
// partials a kF32/kComp checksum needs.
i64 bhw_outer_npartials(i64 rows, int nl) {
  const dim3 g = grid_of(rows, nl);
  return (i64)g.x * g.y;
}

// Longest chain of f32 additions any term passes through in a kF32/kComp
// checksum over `rows` h rows of `nl` lanes: the thread's running sums over
// its rows, s + e, the block tree, the finalize thread's run over partials,
// the finalize tree and the bias.  The sum's error is at most
// gamma(depth) * sum |terms|.
i64 bhw_outer_checksum_depth(i64 rows, int nl) {
  const dim3 g = grid_of(rows, nl);
  const i64 runs = (rows + kRows - 1) / kRows;
  const i64 rows_per_thread = kRows * ((runs + g.y - 1) / g.y);
  const i64 npart = (i64)g.x * g.y;
  return rows_per_thread + 1 + log2_of(kThreads) + (npart + kFinalThreads - 1) / kFinalThreads +
         log2_of(kFinalThreads) + 1;
}

// Write-out: samples of h rows [h0, h0 + rows) to out0 (int32 for kInt,
// float32 otherwise; sample (h - h0) * nl + lo), and e to out1 for kComp.
int bhw_outer_block(int mode, void* out0, float* out1, const void* hi, const void* lo,
                    i64 h0, i64 rows, int nl, int hc, int nk, int np, int a0, int shift,
                    int w, int saturate, float a0f, float a0lo, void* stream) {
  OuterParams P;
  if (!out0 || (mode == kComp && !out1) ||
      !make_params(&P, mode, hi, lo, h0, rows, nl, hc, nk, np, a0, shift, w, saturate,
                   a0f, a0lo))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(P.rows, P.nl);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kInt)
    outer_kernel<kInt, false><<<grid, kThreads, 0, s>>>(P, (int*)out0, nullptr, nullptr);
  else if (mode == kF32)
    outer_kernel<kF32, false><<<grid, kThreads, 0, s>>>(P, (float*)out0, nullptr, nullptr);
  else
    outer_kernel<kComp, false><<<grid, kThreads, 0, s>>>(P, (float*)out0, out1, nullptr);
  return (int)cudaGetLastError();
}

// Checksum over h rows [h0, h0 + rows).  kInt: *out (uint32) holds the bias
// on entry and the sum is added to it; partials and bias are unused.
// kF32/kComp: partials holds npartials floats (one per block of the launch;
// the count must match), and *out (float) = bias + sum.
int bhw_outer_checksum(int mode, void* out, float* partials, i64 npartials, int bias,
                       const void* hi, const void* lo, i64 h0, i64 rows, int nl, int hc,
                       int nk, int np, int a0, int shift, int w, int saturate, float a0f,
                       float a0lo, void* stream) {
  OuterParams P;
  if (!out || !make_params(&P, mode, hi, lo, h0, rows, nl, hc, nk, np, a0, shift, w,
                           saturate, a0f, a0lo))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(P.rows, P.nl);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kInt) {
    outer_kernel<kInt, true><<<grid, kThreads, 0, s>>>(P, nullptr, nullptr, out);
    return (int)cudaGetLastError();
  }
  if (!partials || npartials != (i64)grid.x * grid.y) return (int)cudaErrorInvalidValue;
  if (mode == kF32)
    outer_kernel<kF32, true><<<grid, kThreads, 0, s>>>(P, nullptr, nullptr, partials);
  else
    outer_kernel<kComp, true><<<grid, kThreads, 0, s>>>(P, nullptr, nullptr, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finalize_kernel<<<1, kFinalThreads, 0, s>>>(partials, npartials, bias, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
