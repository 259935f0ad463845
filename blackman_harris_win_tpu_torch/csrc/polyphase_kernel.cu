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
//
// The fused entry (bhw_polyphase_dft) is the same walk with the DFT across
// the branches as its epilogue, for complex64 at C = 128 and up to 16 taps
// a branch (the SDR monitor's call): it writes the channel bins
//   Y[m, k] = sum_{p = 0}^{127} e^{-2 pi i p k / 128} y[m, p],
// (rows, nout, 128) contiguous in natural order, what polyphase_fir and a
// 128-point FFT along the last dim give, so the branch outputs never reach
// device memory and no FFT reads them back.  Its bound is the branch
// kernel's bytes (0.321 ms at the monitor's size; the two launches it
// replaces moved twice that); the DFT's 5 log2(128) = 35 flops a channel
// sample add a tenth of that time at the float32 rate, under the loads.
// At C = kThreads one block is one (row, strip) and holds every branch of
// every frame it walks.  A thread leaves each of its group's K = 16 sums in
// the slot of the stage it read the sample from (its own column: no
// barrier yet).  That stage is free until the next group's copies, which
// target exactly it, so the DFT stages its values there: no shared memory
// beyond the copies' 48 KB, and the branch kernel's occupancy.  Between
// barriers that every thread of the block reaches (the block's threads
// share one strip, so one count of groups), thread t = 8 f + r takes frame
// f of the group: a 16-point DFT over the branches 8 n1 + r (two radix-4
// passes), times W_128^{r k1}; written back into the frame's row in pairs
// of bins (2 q, 2 q + 1) at slot 16 r + 2 (q ^ r), so that neither those
// 16-byte writes nor the next reads meet one bank twice in a quarter warp;
// then the 8-point DFT over r of bins 2 r and 2 r + 1 gives Y[f, k1 +
// 16 k2], stored 16 bytes a thread, 128 contiguous bytes by 8 threads.
// Frames past the strip's end take part with zero sums and are not stored.
// The twiddles W_128^e are a float64 table rounded once to float32 (from
// the wrapper, read through the L1 cache: the copies fill the static shared
// memory); the arithmetic is float32 adds and FMAs (never fast math or
// TF32), in one fixed order for every frame whatever strip, block or slot
// of its group it falls in, so a shard with its halo gives the whole
// stream's bits.

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

// --- the fused entry's DFT across the 128 branches of a group of frames ---

// the fused entry's channels, one a thread of a block, and its most taps a
// branch (one pass)
constexpr int kDftC = kThreads;
constexpr int kDftTaps = 16;

__device__ __forceinline__ float2 sub_s(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a times -i, exact
__device__ __forceinline__ float2 mul_mi(float2 a) { return make_float2(a.y, -a.x); }
// a times the twiddle w
__device__ __forceinline__ float2 mul_w(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -(a.y * w.y)), fmaf(a.x, w.y, a.y * w.x));
}

// The 4-point forward DFT of (a, b, c, d), in place.
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 s0 = add_s(a, c), d0 = sub_s(a, c), s1 = add_s(b, d), d1 = mul_mi(sub_s(b, d));
  a = add_s(s0, s1);
  b = add_s(d0, d1);
  c = sub_s(s0, s1);
  d = sub_s(d0, d1);
}

// The 8-point forward DFT of v, in place, natural order: n = 2 a + b, a
// DFT-4 over a for each b, W_8^{b k} = W_128^{16 b k}, a DFT-2 over b.
__device__ __forceinline__ void dft8(float2 (&v)[8], const float2* __restrict__ tw) {
  dft4(v[0], v[2], v[4], v[6]);
  dft4(v[1], v[3], v[5], v[7]);
  v[3] = mul_w(v[3], __ldg(tw + 16));
  v[5] = mul_mi(v[5]);
  v[7] = mul_w(v[7], __ldg(tw + 48));
  float2 e[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[k] = add_s(v[2 * k], v[2 * k + 1]);
    e[k + 4] = sub_s(v[2 * k], v[2 * k + 1]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = e[k];
}

// The first pass's reads, by thread t = 8 f + r: frame f's branches
// 8 n1 + r, n1 = 0..15 (the stage holds branch p of frame f at [f][p]).
__device__ __forceinline__ void dft_load16(const float2 (*stage)[kThreads], int t,
                                           float2 (&u)[16]) {
  const float2* row = stage[t >> 3] + (t & 7);
#pragma unroll
  for (int n1 = 0; n1 < 16; ++n1) u[n1] = row[8 * n1];
}

// The first pass: the 16-point DFT over n1 (n1 = 4 a + b: a DFT-4 over a
// for each b, W_16^{b ka} = W_128^{8 b ka}, a DFT-4 over b for each ka,
// which leaves bin k1 = ka + 4 kb at u[4 ka + kb]), bin k1 times
// W_128^{r k1}, written to frame f's row in pairs (2 q, 2 q + 1) at slot
// 16 r + 2 (q ^ r).  Only after every thread's dft_load16.
__device__ __forceinline__ void dft_pass16(float2 (*stage)[kThreads], int t, float2 (&u)[16],
                                           const float2* __restrict__ tw) {
  const int r = t & 7;
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4(u[b], u[4 + b], u[8 + b], u[12 + b]);
  u[5] = mul_w(u[5], __ldg(tw + 8));
  u[6] = mul_w(u[6], __ldg(tw + 16));
  u[7] = mul_w(u[7], __ldg(tw + 24));
  u[9] = mul_w(u[9], __ldg(tw + 16));
  u[10] = mul_mi(u[10]);
  u[11] = mul_w(u[11], __ldg(tw + 48));
  u[13] = mul_w(u[13], __ldg(tw + 24));
  u[14] = mul_w(u[14], __ldg(tw + 48));
  u[15] = mul_w(u[15], __ldg(tw + 72));
#pragma unroll
  for (int ka = 0; ka < 4; ++ka) dft4(u[4 * ka], u[4 * ka + 1], u[4 * ka + 2], u[4 * ka + 3]);
  float2* row = stage[t >> 3];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int k0 = 2 * q, k1 = 2 * q + 1;
    float2 a = u[4 * (k0 & 3) + (k0 >> 2)];
    if (q > 0) a = mul_w(a, __ldg(tw + r * k0));
    const float2 b = mul_w(u[4 * (k1 & 3) + (k1 >> 2)], __ldg(tw + r * k1));
    *reinterpret_cast<float4*>(row + 16 * r + 2 * (q ^ r)) = make_float4(a.x, a.y, b.x, b.y);
  }
}

// The second pass's reads, by thread t = 8 f + r: bins 2 r (into v) and
// 2 r + 1 (into w) of frame f from each s = 0..7 of the first pass.  Only
// after every thread's dft_pass16.
__device__ __forceinline__ void dft_load8(const float2 (*stage)[kThreads], int t,
                                          float2 (&v)[8], float2 (&w)[8]) {
  const int r = t & 7;
  const float2* row = stage[t >> 3];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float4 pr = *reinterpret_cast<const float4*>(row + 16 * s + 2 * (r ^ s));
    v[s] = make_float2(pr.x, pr.y);
    w[s] = make_float2(pr.z, pr.w);
  }
}

// The second pass: the 8-point DFTs over s give frame f's bins 2 r + 16 k2
// and 2 r + 1 + 16 k2, stored from out + f * 128 where f < nv.
__device__ __forceinline__ void dft_pass8(float2 (&v)[8], float2 (&w)[8], int t,
                                          const float2* __restrict__ tw,
                                          float2* __restrict__ out, int nv) {
  dft8(v, tw);
  dft8(w, tw);
  if ((t >> 3) >= nv) return;
  float2* o = out + (t >> 3) * kDftC + 2 * (t & 7);
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2)
    *reinterpret_cast<float4*>(o + 16 * k2) = make_float4(v[k2].x, v[k2].y, w[k2].x, w[k2].y);
}

// The DFT across the branches of a group's frames, whose sums every thread
// has left in the stage; the first nv frames stored from out.  Every
// thread of the block calls it; after it the stage is free for copies.
__device__ __forceinline__ void dft_group(float2 (*stage)[kThreads],
                                          const float2* __restrict__ tw,
                                          float2* __restrict__ out, int nv) {
  const int t = threadIdx.x;
  float2 u[16], v[8], w[8];
  __syncthreads();  // every branch's sums are in the stage
  dft_load16(stage, t, u);
  __syncthreads();  // every first-pass input is read: its slots may be written
  dft_pass16(stage, t, u, tw);
  __syncthreads();
  dft_load8(stage, t, v, w);
  __syncthreads();  // every second-pass input is read: the next copies may land
  dft_pass8(v, w, t, tw, out, nv);
}

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
// kAll: all K taps are in use, else the first kc.  kDft: each sum goes to
// the stage's slot it read its sample from (zero past len), the DFT's
// input, and not to ys.
template <typename R, typename T, int K, bool kFull, bool kAll, bool kDft>
__device__ __forceinline__ void sum_group(T (&ring)[K], const R (&g)[K], int kc,
                                          T (*stage)[kThreads], T* __restrict__ ys, i64 q0,
                                          i64 len, i64 c, bool first) {
  T* out = ys + q0 * c;
#pragma unroll
  for (int i = 0; i < K; ++i, out += c) {
    if (kFull || q0 + i < len) {
      ring[i] = stage[i][threadIdx.x];
      T acc = zero_s<T>();
#pragma unroll
      for (int d = 0; d < K; ++d)
        if (kAll || d < kc) acc = fma_s(g[d], ring[(i - d + K) % K], acc);
      if constexpr (kDft)
        stage[i][threadIdx.x] = acc;
      else
        *out = first ? acc : add_s(*out, acc);
    } else if constexpr (kDft) {
      stage[i][threadIdx.x] = zero_s<T>();
    }
  }
}

// One pass of the thread's strip over the taps g (kc of them in use): the
// pass's current sample for output q of the strip is xs[q * c].  kDft: the
// strip's channel bins from ys (the block's), the DFT of each group of
// sums with the twiddles tw.
template <typename R, typename T, int K, bool kAll, bool kDft>
__device__ __forceinline__ void walk_pass(T (*stages)[K][kThreads], const R (&g)[K], int kc,
                                          const T* __restrict__ xs, T* __restrict__ ys,
                                          i64 len, i64 c, bool first,
                                          const float2* __restrict__ tw) {
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
    T(*stage)[kThreads] = stages[gi % kStages];
    if ((gi + 1) * K <= len)
      sum_group<R, T, K, true, kAll, kDft>(ring, g, kc, stage, ys, gi * K, len, c, first);
    else
      sum_group<R, T, K, false, kAll, kDft>(ring, g, kc, stage, ys, gi * K, len, c, first);
    if constexpr (kDft) {
      const i64 left = len - gi * K;
      dft_group(stage, tw, ys + gi * K * c, left < K ? (int)left : K);
    }
  }
}

// Thread u = (row * strips + strip) * c + p.  Strip s holds output frames
// [s * strip, min((s + 1) * strip, nout)).  Each thread copies its own
// samples into its own column of shared memory and reads back only those,
// so the sums need no barrier.  kDft (complex float, c = kThreads, tpb <=
// K, the twiddles tw): y takes the channel bins; a block is one (row,
// strip), and units a multiple of kThreads, so every thread of a block
// reaches the DFT's barriers.
template <typename R, int L, int K, bool kDft>
__device__ __forceinline__ void walk_strip(typename Sample<R, L>::T* __restrict__ y,
                                           const typename Sample<R, L>::T* __restrict__ x,
                                           const R* __restrict__ h,
                                           const float2* __restrict__ tw, i64 units, i64 nf,
                                           i64 c, int tpb, i64 strip, i64 strips) {
  typedef typename Sample<R, L>::T T;
  static_assert(sizeof(T) * kStages * K * kThreads <= 48 * 1024, "static shared memory");
  // 16-byte aligned: the DFT moves pairs of bins
  __shared__ __align__(16) T stages[kStages][K][kThreads];
  const i64 u = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (u >= units) return;
  const i64 p = u % c, rs = u / c;
  const i64 s = rs % strips, row = rs / strips;
  const i64 nout = nf - tpb + 1;
  const i64 m0 = s * strip;
  const i64 len = m0 + strip < nout ? strip : nout - m0;
  const T* xb = x + row * nf * c + p;
  T* ys = y + (row * nout + m0) * c + (kDft ? 0 : p);
  for (int t0 = 0; t0 < tpb; t0 += K) {
    const int kc = tpb - t0 < K ? tpb - t0 : K;
    R g[K];
#pragma unroll
    for (int d = 0; d < K; ++d) g[d] = d < kc ? h[(i64)(t0 + d) * c + p] : R(0);
    const T* xs = xb + (m0 + tpb - 1 - t0) * c;
    if (kc == K)
      walk_pass<R, T, K, true, kDft>(stages, g, kc, xs, ys, len, c, t0 == 0, tw);
    else
      walk_pass<R, T, K, false, kDft>(stages, g, kc, xs, ys, len, c, t0 == 0, tw);
  }
}

template <typename R, int L, int K>
__global__ void __launch_bounds__(kThreads)
    polyphase_kernel(typename Sample<R, L>::T* __restrict__ y,
                     const typename Sample<R, L>::T* __restrict__ x, const R* __restrict__ h,
                     i64 units, i64 nf, i64 c, int tpb, i64 strip, i64 strips) {
  walk_strip<R, L, K, false>(y, x, h, nullptr, units, nf, c, tpb, strip, strips);
}

// Blocks of the fused kernel an SM: at most 170 registers a thread (it
// takes 168), the three the branch kernel's <float, 2, 16> keeps at 135.
// Four cap it at 128 and it spills: 4-5% slower on an H100.
constexpr int kDftBlocks = 3;

__global__ void __launch_bounds__(kThreads, kDftBlocks)
    polyphase_dft_kernel(float2* __restrict__ y, const float2* __restrict__ x,
                         const float* __restrict__ h, const float2* __restrict__ tw, i64 units,
                         i64 nf, int tpb, i64 strip, i64 strips) {
  walk_strip<float, 2, kDftTaps, true>(y, x, h, tw, units, nf, kDftC, tpb, strip, strips);
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

// Threads of Kernel resident on the current device at once, asked of the
// runtime once a device; 1 if it cannot say.
template <auto Kernel>
i64 resident_threads() {
  static std::atomic<i64> known[kMaxDevices];
  int dev = 0, sms = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 1;
  }
  if (dev < kMaxDevices && known[dev].load() > 0) return known[dev].load();
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel, kThreads, 0) !=
          cudaSuccess) {
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

// The launch geometry of Kernel over rows rows of nf frames of c branches
// at tpb taps: output frames a strip (strip 0: chosen_strip's), strips a
// row, threads (units) and blocks.
struct Geometry {
  i64 strip, strips, units, blocks;
};
template <auto Kernel>
Geometry geometry(i64 rows, i64 nf, i64 c, int tpb, i64 strip) {
  const i64 nout = nf - tpb + 1;
  if (strip == 0) strip = chosen_strip(rows * c, nout, resident_threads<Kernel>());
  const i64 strips = (nout + strip - 1) / strip;
  const i64 units = rows * strips * c;
  return {strip, strips, units, (units + kThreads - 1) / kThreads};
}

template <typename R, int L, int K>
int launch_k(void* y, const void* x, const void* h, i64 rows, i64 nf, i64 c, int tpb, i64 strip,
             cudaStream_t stream) {
  typedef typename Sample<R, L>::T T;
  const Geometry g = geometry<polyphase_kernel<R, L, K>>(rows, nf, c, tpb, strip);
  if (g.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  polyphase_kernel<R, L, K><<<(unsigned)g.blocks, kThreads, 0, stream>>>(
      static_cast<T*>(y), static_cast<const T*>(x), static_cast<const R*>(h), g.units, nf, c,
      tpb, g.strip, g.strips);
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

// The fused entry: y (rows, nf - tpb + 1, 128) complex64 channel bins,
// 16-byte aligned; x (rows, nf * 128) complex64, both contiguous; h
// tpb * 128 float taps, 1 <= tpb <= 16; tw the 128 complex64 twiddles
// W_128^e = exp(-2 pi i e / 128); strip as bhw_polyphase_fir's.
int bhw_polyphase_dft(void* y, const void* x, const void* h, const void* tw, i64 rows, i64 nf,
                      int tpb, i64 strip, void* stream) {
  if (rows < 0 || tpb < 1 || tpb > kDftTaps || nf < tpb || strip < 0 || (uintptr_t)x % 8 ||
      (uintptr_t)y % 16 || (uintptr_t)h % 4 || (uintptr_t)tw % 8)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const Geometry g = geometry<polyphase_dft_kernel>(rows, nf, kDftC, tpb, strip);
  if (g.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  polyphase_dft_kernel<<<(unsigned)g.blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<float2*>(y), static_cast<const float2*>(x), static_cast<const float*>(h),
      static_cast<const float2*>(tw), g.units, nf, tpb, g.strip, g.strips);
  return (int)cudaGetLastError();
}

}  // extern "C"
