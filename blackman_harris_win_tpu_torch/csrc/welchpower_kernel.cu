// Welch power mean: the mean over frames of |X|^2 for an rfft half
// spectrum, in one pass, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this step as
// jnp.mean(jnp.abs(spec) ** 2, axis=-2) in the rfft branch of
// blackman_harris_win_tpu/pipeline/spectral.py:frame_mean_power, which XLA
// fuses.  Eager PyTorch does not: spec.abs() writes a complex buffer, copies
// its real part out, ** 2 reads and writes the floats and the mean reads
// them again, some 5 GB at the analyzer's size.  This kernel reads the
// complex spectrum once and writes the mean.
//
// What bounds it on the H100: device memory bandwidth.  The input is the
// (B, nF, K) spectrum, K = nfft/2 + 1; the analyzer's call at nfft 2^20
// reads 255 x 524289 complex64 (1.07 GB) and writes 524289 floats: at
// 3.35 TB/s no less than 0.320 ms.  The arithmetic is a few FP64 operations
// a bin, far below the card's FP64 rate.
//
// Design: one thread owns one column (batch b, bin k) and walks its frames,
// so a warp reads 32 neighbouring bins of one frame, 256 contiguous bytes
// of complex64.  K is odd, so from the second frame on a row is only
// 8-byte aligned: each load is one 8-byte float2 (double2 for complex128),
// never wider.  Loads are streaming (__ldcs, evict-first): every byte is
// read once.  Each thread issues kUnroll frames' loads before it adds any,
// so each SM keeps tens of KB of loads in flight.  re*re + im*im is summed
// in float64 (the squares of float32 values are exact there), in frame
// order, then divided by nF and rounded once to the output's type.  Where
// the columns alone are too few to fill the card (a small K, few batches),
// the wrapper splits the frames into slabs over gridDim.y: each slab
// writes its float64 partial sum to scratch the wrapper allocates, and a
// second small kernel adds the partials in slab order.  No atomics: the
// result is the same bits on every run.  Each entry runs on the stream it
// is given, allocates nothing, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kThreads = 256;
// frames whose loads a thread issues before it adds them
constexpr int kUnroll = 8;

__device__ __forceinline__ double power(float2 v) {
  const double re = v.x, im = v.y;
  return fma(re, re, im * im);
}

__device__ __forceinline__ double power(double2 v) { return fma(v.x, v.x, v.y * v.y); }

// Column c = b * k + bin sums frames [blockIdx.y * per, + per) of batch b.
// One slab: out[c] = sum / nf; else part[blockIdx.y * cols + c] = sum.
template <typename C, typename R>
__global__ void __launch_bounds__(kThreads)
    power_mean_kernel(R* __restrict__ out, double* __restrict__ part,
                      const C* __restrict__ spec, i64 cols, i64 nf, i64 k, i64 per) {
  const i64 c = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const i64 b = c / k;
  const i64 f0 = (i64)blockIdx.y * per;
  const i64 f1 = f0 + per < nf ? f0 + per : nf;
  const C* p = spec + (b * nf + f0) * k + (c - b * k);
  double acc = 0.0;
  i64 f = f0;
  for (; f + kUnroll <= f1; f += kUnroll, p += kUnroll * k) {
    C v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(p + u * k);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += power(v[u]);
  }
  for (; f < f1; ++f, p += k) acc += power(__ldcs(p));
  if (gridDim.y == 1)
    out[c] = (R)(acc / (double)nf);
  else
    part[(i64)blockIdx.y * cols + c] = acc;
}

// out[c] = (sum of the slabs' partials of column c, in slab order) / nf
template <typename R>
__global__ void __launch_bounds__(kThreads)
    sum_slabs_kernel(R* __restrict__ out, const double* __restrict__ part, i64 cols,
                     int slabs, i64 nf) {
  const i64 c = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  double acc = 0.0;
  for (int s = 0; s < slabs; ++s) acc += part[(i64)s * cols + c];
  out[c] = (R)(acc / (double)nf);
}

template <typename C, typename R>
int launch(void* out, void* part, const void* spec, i64 cols, i64 nf, i64 k, int slabs,
           cudaStream_t stream) {
  const i64 per = (nf + slabs - 1) / slabs;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads), (unsigned)slabs);
  power_mean_kernel<C, R><<<grid, kThreads, 0, stream>>>(
      static_cast<R*>(out), static_cast<double*>(part), static_cast<const C*>(spec), cols, nf,
      k, per);
  if (slabs > 1) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_slabs_kernel<R><<<grid.x, kThreads, 0, stream>>>(
        static_cast<R*>(out), static_cast<const double*>(part), cols, slabs, nf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out: (batches, k) of float (elem 8, complex64 input) or double (elem 16,
// complex128); spec: (batches, nf, k) contiguous, elem-byte aligned;
// part: slabs x batches x k doubles, or null for one slab; the frames are
// cut into slabs of ceil(nf / slabs) (an empty last slab adds 0).
int bhw_welch_power_mean(void* out, const void* spec, void* part, i64 batches, i64 nf, i64 k,
                         int slabs, int elem, void* stream) {
  if (batches < 0 || nf < 1 || k < 1 || slabs < 1 || slabs > 65535 || slabs > nf ||
      (slabs > 1 && part == nullptr) || (elem != 8 && elem != 16) ||
      (uintptr_t)spec % (uintptr_t)elem)
    return (int)cudaErrorInvalidValue;
  const i64 cols = batches * k;
  if (cols == 0) return (int)cudaSuccess;
  if ((cols + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem == 8) return launch<float2, float>(out, part, spec, cols, nf, k, slabs, st);
  return launch<double2, double>(out, part, spec, cols, nf, k, slabs, st);
}

}  // extern "C"
