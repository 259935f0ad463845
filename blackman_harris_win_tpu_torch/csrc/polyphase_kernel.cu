// Polyphase branch FIRs of a critically sampled DFT filter bank, in one
// pass, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's channelizer
// (blackman_harris_win_tpu/pipeline/channelizer.py) is jnp, which XLA
// fuses.  Eager PyTorch does not: the commutator's strided real and
// imaginary views are copied into a grouped conv1d's (B, C, frames) layout,
// ATen's generic depthwise convolution runs twice, its transposed results
// are copied back and torch.complex interleaves them (at the SDR monitor's
// size, 6.6 ms of an 8.7 ms call on an H100, the copies 4.4 ms of it).
// This kernel reads the capture in place and writes the branch outputs in
// the layout torch.fft reads.
//
// What it computes: x is (rows, nf * c) real or complex interleaved, h the
// prototype (tpb * c taps, tap t of branch p at h[t * c + p]).  For every
// valid frame m of nout = nf - tpb + 1,
//   y[m, p] = sum_{t = 0}^{tpb - 1} h[t * c + p] * x[(m + tpb - 1 - t) * c + p],
// written (rows, nout, c) contiguous in x's type.
//
// What bounds it on the H100: device memory bandwidth.  The monitor's call
// reads 2^26 complex64 samples (512 MiB) and writes (524273, 128) complex64
// (512 MiB): at 3.35 TB/s no less than 0.321 ms.  Its 4 * tpb flops a
// complex sample (64 at 16 taps) take a fifth of that at the float32 rate.
//
// Design: one thread owns one branch p of one strip of output frames and
// walks the strip.  Consecutive threads hold consecutive branches, so a
// warp reads 32 neighbouring samples of one frame row (256 contiguous bytes
// of complex64) and writes 32 neighbouring outputs: the commutator is
// indexing, no copy.  A thread keeps its branch's taps and its last K
// samples in registers (a ring whose slots are fixed at compile time by
// unrolling the walk K frames at a time).  Its loads go ahead of it into
// its own column of shared memory as asynchronous copies (cp.async), K
// frames a group, two groups ahead of the one it sums, so each SM keeps
// some 100 KB of loads in flight whatever the registers hold; no barrier,
// since a thread reads back only what it copied.  (Loading the next K
// frames into registers instead held 140-146 registers a thread and
// reached 67% of the bound at the monitor's size, 33% on a real
// 16-branch stream, calls queued on an H100: too few bytes in flight.
// This design: 81% and 77%.)  Each sample is loaded once by its strip;
// only the tpb - 1 frames before a strip are loaded again, by the strip
// before it (the launch sizes strips at about 256 frames or more where
// the card stays full, so that halo is under 6% at 16 taps).  Taps past K
// are summed in further passes over the strip of K taps each, added into
// the output the first pass wrote.  Each output's sum runs over t in one
// fixed order, FMA by FMA in the input's real type (never TF32): t from 0
// in each pass of K taps, the passes added in order.  Which strip or block
// an output falls in changes nothing, so a channelizer that re-reads a halo
// (the sharded chain) gives the same bits.  The samples are 8-byte loads
// for complex64 (4 for float32, 16 for complex128): a warp's loads of one
// row already cover whole 32-byte sectors, and wider vectors would double
// the ring's registers.  Indexing is 64-bit.  The entry runs on the stream
// it is given, allocates nothing, and returns cudaGetLastError().

#include <atomic>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kThreads = 128;
// groups of K frames a thread has in flight: the one it sums and the next
// kStages - 1 (32 KB of loads a block of complex64 threads)
constexpr int kStages = 3;

// One sample: a real value, or a complex one as (re, im).
template <typename R, int L>
struct Sample;
template <>
struct Sample<float, 1> { typedef float T; };
template <>
struct Sample<float, 2> { typedef float2 T; };
template <>
struct Sample<double, 1> { typedef double T; };
template <>
struct Sample<double, 2> { typedef double2 T; };

__device__ __forceinline__ float fma_s(float h, float x, float a) { return fmaf(h, x, a); }
__device__ __forceinline__ double fma_s(double h, double x, double a) { return fma(h, x, a); }
__device__ __forceinline__ float2 fma_s(float h, float2 x, float2 a) {
  return make_float2(fmaf(h, x.x, a.x), fmaf(h, x.y, a.y));
}
__device__ __forceinline__ double2 fma_s(double h, double2 x, double2 a) {
  return make_double2(fma(h, x.x, a.x), fma(h, x.y, a.y));
}
__device__ __forceinline__ float add_s(float a, float b) { return a + b; }
__device__ __forceinline__ double add_s(double a, double b) { return a + b; }
__device__ __forceinline__ float2 add_s(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 add_s(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

template <typename T>
__device__ __forceinline__ T zero_s();
template <>
__device__ __forceinline__ float zero_s<float>() { return 0.0f; }
template <>
__device__ __forceinline__ double zero_s<double>() { return 0.0; }
template <>
__device__ __forceinline__ float2 zero_s<float2>() { return make_float2(0.0f, 0.0f); }
template <>
__device__ __forceinline__ double2 zero_s<double2>() { return make_double2(0.0, 0.0); }

// Start the copies of the K frames from q0 of the pass (those inside the
// strip) into the thread's column of one stage, as one commit group.
template <typename T, int K>
__device__ __forceinline__ void fetch_group(T (*stage)[kThreads], const T* __restrict__ xs,
                                            i64 q0, i64 len, i64 c) {
  const T* src = xs + q0 * c;
#pragma unroll
  for (int i = 0; i < K; ++i, src += c)
    if (q0 + i < len) __pipeline_memcpy_async(&stage[i][threadIdx.x], src, sizeof(T));
  __pipeline_commit();
}

// The K outputs from q0 of the pass, from the stage that holds their
// current samples: frame q0 + i goes to ring slot i, and output q0 + i is
// the sum over d of g[d] times the sample d frames before it, slot
// (i - d) mod K.  kFull: all K lie in the strip, else those below len;
// kAll: all K taps are in use, else the first kc.
template <typename R, typename T, int K, bool kFull, bool kAll>
__device__ __forceinline__ void sum_group(T (&ring)[K], const R (&g)[K], int kc,
                                          const T (*stage)[kThreads], T* __restrict__ ys,
                                          i64 q0, i64 len, i64 c, bool first) {
  T* out = ys + q0 * c;
#pragma unroll
  for (int i = 0; i < K; ++i, out += c) {
    if (kFull || q0 + i < len) {
      ring[i] = stage[i][threadIdx.x];
      T acc = zero_s<T>();
#pragma unroll
      for (int d = 0; d < K; ++d)
        if (kAll || d < kc) acc = fma_s(g[d], ring[(i - d + K) % K], acc);
      *out = first ? acc : add_s(*out, acc);
    }
  }
}

// One pass of the thread's strip over the taps g (kc of them in use): the
// pass's current sample for output q of the strip is xs[q * c].
template <typename R, typename T, int K, bool kAll>
__device__ __forceinline__ void walk_pass(T (*stages)[K][kThreads], const R (&g)[K], int kc,
                                          const T* __restrict__ xs, T* __restrict__ ys,
                                          i64 len, i64 c, bool first) {
  const i64 groups = (len + K - 1) / K;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch_group<T, K>(stages[k], xs, (i64)k * K, len, c);
  // the kc - 1 frames before the first one go to ring slots K - 1 .. K - kc + 1
  T ring[K];
#pragma unroll
  for (int j = 1; j < K; ++j) ring[K - j] = kAll || j < kc ? xs[-(i64)j * c] : zero_s<T>();
  ring[0] = zero_s<T>();
  for (i64 gi = 0; gi < groups; ++gi) {
    fetch_group<T, K>(stages[(gi + kStages - 1) % kStages], xs, (gi + kStages - 1) * K, len, c);
    __pipeline_wait_prior(kStages - 1);
    const T(*stage)[kThreads] = stages[gi % kStages];
    if ((gi + 1) * K <= len)
      sum_group<R, T, K, true, kAll>(ring, g, kc, stage, ys, gi * K, len, c, first);
    else
      sum_group<R, T, K, false, kAll>(ring, g, kc, stage, ys, gi * K, len, c, first);
  }
}

// Thread u = (row * strips + strip) * c + p.  Strip s holds output frames
// [s * strip, min((s + 1) * strip, nout)).  Each thread copies its own
// samples into its own column of shared memory and reads back only those,
// so no barrier is needed.
template <typename R, int L, int K>
__global__ void __launch_bounds__(kThreads)
    polyphase_kernel(typename Sample<R, L>::T* __restrict__ y,
                     const typename Sample<R, L>::T* __restrict__ x, const R* __restrict__ h,
                     i64 units, i64 nf, i64 c, int tpb, i64 strip, i64 strips) {
  typedef typename Sample<R, L>::T T;
  static_assert(sizeof(T) * kStages * K * kThreads <= 48 * 1024, "static shared memory");
  __shared__ T stages[kStages][K][kThreads];
  const i64 u = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const i64 p = u % c, rs = u / c;
  const i64 s = rs % strips, row = rs / strips;
  const i64 nout = nf - tpb + 1;
  const i64 m0 = s * strip;
  const i64 len = m0 + strip < nout ? strip : nout - m0;
  const T* xb = x + row * nf * c + p;
  T* ys = y + (row * nout + m0) * c + p;
  for (int t0 = 0; t0 < tpb; t0 += K) {
    const int kc = tpb - t0 < K ? tpb - t0 : K;
    R g[K];
#pragma unroll
    for (int d = 0; d < K; ++d) g[d] = d < kc ? h[(i64)(t0 + d) * c + p] : R(0);
    const T* xs = xb + (m0 + tpb - 1 - t0) * c;
    if (kc == K)
      walk_pass<R, T, K, true>(stages, g, kc, xs, ys, len, c, t0 == 0);
    else
      walk_pass<R, T, K, false>(stages, g, kc, xs, ys, len, c, t0 == 0);
  }
}

// Taps a pass: 16 for float beyond 8 taps, else 8, so that up to 8 taps
// sum no unused tap.  Double takes 8 only: a complex128 thread's ring is
// then 32 registers and its stages 48 KB a block, as a complex64 one's at
// 16 (at 16 they would pass the 48 KB of static shared memory a block).
template <typename R>
constexpr bool wide_pass() { return sizeof(R) == 4; }

// The fewest output frames a strip holds where the card stays full: the
// tpb - 1 frames before a strip, which its thread loads again, stay under
// 6% at 16 taps.
constexpr i64 kMinStrip = 256;
constexpr int kMaxDevices = 64;

// Threads of polyphase_kernel<R, L, K> resident on the current device at
// once, asked of the runtime once a device; 1 if it cannot say.
template <typename R, int L, int K>
i64 resident_threads() {
  static std::atomic<i64> known[kMaxDevices];
  int dev = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  if (dev < kMaxDevices && known[dev].load() > 0) return known[dev].load();
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, polyphase_kernel<R, L, K>, kThreads,
                                                    0) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  const i64 n = (i64)blocks * sms * kThreads > 0 ? (i64)blocks * sms * kThreads : 1;
  if (dev < kMaxDevices) known[dev].store(n);
  return n;
}

// Output frames a strip for units = rows * c threads a strip index and
// nout >= 1 frames a row, where resident threads fit on the card at once:
// as many whole loads of the card as strips of at least kMinStrip frames
// give (at least one load, with shorter strips where the threads are too
// few to fill it), the strips then evened out.
i64 chosen_strip(i64 units, i64 nout, i64 resident) {
  i64 waves = units * (nout / kMinStrip) / resident;
  if (waves < 1) waves = 1;
  i64 strips = waves * resident / units;
  strips = strips < 1 ? 1 : strips > nout ? nout : strips;
  return (nout + strips - 1) / strips;
}

template <typename R, int L, int K>
int launch_k(void* y, const void* x, const void* h, i64 rows, i64 nf, i64 c, int tpb, i64 strip,
             cudaStream_t stream) {
  typedef typename Sample<R, L>::T T;
  const i64 nout = nf - tpb + 1;
  if (strip == 0) strip = chosen_strip(rows * c, nout, resident_threads<R, L, K>());
  const i64 strips = (nout + strip - 1) / strip;
  const i64 units = rows * strips * c;
  const i64 blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  polyphase_kernel<R, L, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(x), static_cast<const R*>(h), units, nf, c,
      tpb, strip, strips);
  return (int)cudaGetLastError();
}

template <typename R, int L>
int launch(void* y, const void* x, const void* h, i64 rows, i64 nf, i64 c, int tpb, i64 strip,
           cudaStream_t stream) {
  if constexpr (wide_pass<R>())
    if (tpb > 8) return launch_k<R, L, 16>(y, x, h, rows, nf, c, tpb, strip, stream);
  return launch_k<R, L, 8>(y, x, h, rows, nf, c, tpb, strip, stream);
}

}  // namespace

extern "C" {

// y: (rows, nf - tpb + 1, c), x: (rows, nf * c), both contiguous, of
// lanes (1: real, 2: complex) values of elem bytes (4: float, 8: double)
// each; h: tpb * c taps of elem bytes; strip: output frames a strip (the
// last may be shorter), 0 to leave it to the launch (chosen_strip).
int bhw_polyphase_fir(void* y, const void* x, const void* h, i64 rows, i64 nf, i64 c, int tpb,
                      i64 strip, int lanes, int elem, void* stream) {
  if (rows < 0 || c < 1 || tpb < 1 || nf < tpb || strip < 0 || (lanes != 1 && lanes != 2) ||
      (elem != 4 && elem != 8) || (uintptr_t)x % (uintptr_t)(lanes * elem) ||
      (uintptr_t)y % (uintptr_t)(lanes * elem) || (uintptr_t)h % (uintptr_t)elem)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (elem == 4)
    return lanes == 1 ? launch<float, 1>(y, x, h, rows, nf, c, tpb, strip, st)
                      : launch<float, 2>(y, x, h, rows, nf, c, tpb, strip, st);
  return lanes == 1 ? launch<double, 1>(y, x, h, rows, nf, c, tpb, strip, st)
                    : launch<double, 2>(y, x, h, rows, nf, c, tpb, strip, st);
}

}  // extern "C"
