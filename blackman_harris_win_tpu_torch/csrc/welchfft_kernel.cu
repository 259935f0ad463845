// Welch analyzer front half on Hopper (sm_90a): framing + window + frame-pair
// packing + the first DFT stage (radix 128) + the stage-1 twiddle.
//
// Replaces blackman_harris_win_tpu/kernels/pallas/welchfft_kernel.py:
// welch_stage1_fused, with the same contract and output layout:
//   out[b, k0, j] = tw1[k0, j] * sum_n0 W128^(k0*n0) * z[n0, j],
//   z[n0, j] = (x[b*nfft + n0*rest + j] + i*x[b*nfft + hop + n0*rest + j])
//              * win[n0*rest + j],
// for frame pair b (even frame at b*nfft, odd at b*nfft + hop, hop =
// nfft/2), rest = nfft/128, tw1[k0, j] = W_nfft^(k0*j).  When the frame
// count is odd, the last pair's odd member is the zero pad frame.  Samples
// past the end of x read as zero (no padded copy of x is made).
//
// What bounds it on the H100: device memory.  The function reads x once
// (4 bytes a sample) and writes 8 bytes per output; an FFT-128 costs about
// 5 * 128 * 7 flops per column, some 9 flops per byte moved, under the
// card's fp32 ridge.  The design keeps the work at that:
//
// - An FFT-128, not the direct DFT product: n0 = n1 + 16*n2, k0 = k2 + 8*k1,
//   so W128^(n0*k0) = W8^(n2*k2) * W128^(n1*k2) * W16^(n1*k1): an 8-point
//   DFT over n2 for each n1, the twiddle W128^(n1*k2), then a 16-point DFT
//   over n1 for each k2, out in natural k0 order.  Both small DFTs are
//   radix-2 in registers; one exchange through shared memory between the
//   passes.  All roots are W128^m (m < 64, and -W128^(m-64)), a table the
//   host builds in float64 and rounds to f32, as it built the DFT matrix;
//   nothing calls sincosf.  Full fp32 FMAs; no tensor cores (TF32 misses the
//   analyzer's error budget).
// - Tables read once per block: a block owns a 32-column tile and walks a
//   range of frame pairs in order (the ranges balanced so the grid fills the
//   card).  Each thread keeps its 16 window values and its 16 stage-1
//   twiddles in registers for the whole walk.
// - x read once: seen as half-blocks of hop samples (64 rows of rest), pair
//   b's even frame is half-blocks 2b, 2b+1 and its odd frame 2b+1, 2b+2,
//   and 2b+2 is pair b+1's first.  A ring of five
//   half-block slots in shared memory holds them; cp.async (16 bytes a copy
//   where x is 16-byte aligned, 4 otherwise) fills the slots two pairs ahead
//   of the FFT, so the loads of pairs b+1 and b+2 are in flight while pair b
//   is transformed.  Half-blocks past the end of x are zero-filled.
// - Coalesced access: lane = column, warp = row class; every global load,
//   shared-memory access and output store of a warp is 32 consecutive
//   floats of one row.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kR0 = 128;      // leading radix (rows of the DFT stage)
constexpr int kJT = 32;       // columns per block (one per lane)
constexpr int kWarps = 8;     // row classes: warp t owns rows = t (mod 8)
constexpr int kThreads = 32 * kWarps;
constexpr int kHalf = 64;     // rows of a half-block
constexpr int kSlots = 5;     // half-block ring: pair b's three + pair b+1's two in flight
constexpr int kSlotFloats = kHalf * kJT;
// ring, exchange (re, im), roots (re, im)
constexpr size_t kSmemBytes = sizeof(float) * (kSlots * kSlotFloats + 2 * kR0 * kJT + 2 * 64);

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;  // 0 source bytes: the copy zero-fills
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Copy half-block h of the tile (64 rows x 32 columns) into its slot;
// kVec floats per copy.
template <int kVec>
__device__ __forceinline__ void load_half(float* ring, const float* __restrict__ x, i64 t,
                                          i64 h, int hop, int rest, int j0) {
  float* slot = ring + (int)(h % kSlots) * kSlotFloats;
  const bool valid = (h + 1) * (i64)hop <= t;  // T % hop == 0: all of it or none
  const float* base = x + (valid ? h * hop + j0 : 0);
  constexpr int per_row = kJT / kVec;
#pragma unroll
  for (int c = threadIdx.x; c < kHalf * per_row; c += kThreads) {
    const int row = c / per_row, col = (c % per_row) * kVec;
    cp_async(slot + row * kJT + col, valid ? base + (i64)row * rest + col : x, valid,
             4 * kVec);
  }
}

// Complex multiply-by-root helpers: W128^m for 0 <= m < 128 from the
// 64-entry table (W128^(m+64) = -W128^m).
__device__ __forceinline__ void root(const float* wr, const float* wi, int m, float& c, float& s) {
  const float sg = m >= 64 ? -1.f : 1.f;
  c = sg * wr[m & 63];
  s = sg * wi[m & 63];
}

template <int A, int B, int N>
__device__ __forceinline__ void swap_pt(float (&re)[N], float (&im)[N]) {
  const float tr = re[A], ti = im[A];
  re[A] = re[B];
  im[A] = im[B];
  re[B] = tr;
  im[B] = ti;
}

// Butterfly I of the stage of length LEN: indices and root are template
// constants, so the arrays stay in registers (a loop here is re-rolled by
// the compiler, which then keeps the arrays in local memory).
template <int N, int LEN, int I>
__device__ __forceinline__ void butterfly(float (&re)[N], float (&im)[N], const float* wr,
                                          const float* wi) {
  constexpr int half = LEN / 2, k = I % half, a = (I / half) * LEN + k, b = a + half;
  float vr = re[b], vi = im[b];
  if constexpr (k != 0) {
    const float c = wr[k * (kR0 / LEN)], s = wi[k * (kR0 / LEN)];
    vr = fmaf(re[b], c, -im[b] * s);
    vi = fmaf(re[b], s, im[b] * c);
  }
  re[b] = re[a] - vr;
  im[b] = im[a] - vi;
  re[a] += vr;
  im[a] += vi;
}

template <int N, int LEN, int... I>
__device__ __forceinline__ void stage(float (&re)[N], float (&im)[N], const float* wr,
                                     const float* wi, std::integer_sequence<int, I...>) {
  (butterfly<N, LEN, I>(re, im, wr, wi), ...);
}

// In-register radix-2 DFT of N points (N = 8, 16), natural order in and
// out: the bit-reversal permutation, then log2 N butterfly stages with the
// roots W_len^k = W128^(k*128/len).  Multiplications by W^0 = 1 are left
// out (exact either way).
template <int N>
__device__ __forceinline__ void dft(float (&re)[N], float (&im)[N], const float* wr,
                                   const float* wi) {
  static_assert(N == 8 || N == 16, "N is 8 or 16");
  // the bit-reversal permutation as swaps at literal indices, so that the
  // arrays stay in registers
  if constexpr (N == 8) {
    swap_pt<1, 4>(re, im);
    swap_pt<3, 6>(re, im);
  } else {
    swap_pt<1, 8>(re, im);
    swap_pt<2, 4>(re, im);
    swap_pt<3, 12>(re, im);
    swap_pt<5, 10>(re, im);
    swap_pt<7, 14>(re, im);
    swap_pt<11, 13>(re, im);
  }
  stage<N, 2>(re, im, wr, wi, std::make_integer_sequence<int, N / 2>{});
  stage<N, 4>(re, im, wr, wi, std::make_integer_sequence<int, N / 2>{});
  stage<N, 8>(re, im, wr, wi, std::make_integer_sequence<int, N / 2>{});
  if constexpr (N == 16) stage<N, 16>(re, im, wr, wi, std::make_integer_sequence<int, N / 2>{});
}

// Pass 1 for one n1: the windowed, packed points z[n1 + 16*n2] (rows n0 <
// 64 from slots 0 and 1, rows n0 >= 64 from slots 1 and 2 at row n0 - 64),
// their 8-point DFT over n2, the twiddle W128^(n1*k2), into the exchange.
__device__ __forceinline__ void pass1(const float* s0, const float* s1, const float* s2,
                                      const float (&wv)[8], int n1, bool odd_zero,
                                      const float* wr, const float* wi, float* xr, float* xi,
                                      int j) {
  float ar[8], ai[8];
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    const int e = ((n1 + 16 * n2) & 63) * kJT + j;
    ar[n2] = (n2 < 4 ? s0 : s1)[e] * wv[n2];
    ai[n2] = odd_zero ? 0.f : (n2 < 4 ? s1 : s2)[e] * wv[n2];
  }
  dft<8>(ar, ai, wr, wi);
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    float c, s;
    root(wr, wi, n1 * k2, c, s);
    const int e = (n1 * 8 + k2) * kJT + j;
    xr[e] = fmaf(ar[k2], c, -ai[k2] * s);
    xi[e] = fmaf(ar[k2], s, ai[k2] * c);
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads, 2)
welch_stage1_kernel(const float* __restrict__ x, i64 t, const float* __restrict__ win,
                    const float* __restrict__ roots_r, const float* __restrict__ roots_i,
                    const float* __restrict__ t1r, const float* __restrict__ t1i,
                    float* __restrict__ out_r, float* __restrict__ out_i, int rest, int nfft,
                    int npair, int mask_last, int nranges) {
  extern __shared__ float smem[];
  float* ring = smem;
  float* xr = ring + kSlots * kSlotFloats;  // exchange: A[n1][k2][j], re then im
  float* xi = xr + kR0 * kJT;
  float* wr = xi + kR0 * kJT;  // W128^m, m < 64
  float* wi = wr + 64;
  const int j = threadIdx.x & 31, tw = threadIdx.x >> 5;
  const int j0 = blockIdx.x * kJT;
  const int hop = nfft / 2;
  const int b_lo = (int)((i64)blockIdx.y * npair / nranges);
  const int b_hi = (int)((i64)(blockIdx.y + 1) * npair / nranges);
  if (threadIdx.x < 64) {
    wr[threadIdx.x] = roots_r[threadIdx.x];
    wi[threadIdx.x] = roots_i[threadIdx.x];
  }
  // the loads of the first two pairs: half-blocks 2b_lo .. 2b_lo + 4
  load_half<kVec>(ring, x, t, 2 * (i64)b_lo, hop, rest, j0);
  load_half<kVec>(ring, x, t, 2 * (i64)b_lo + 1, hop, rest, j0);
  load_half<kVec>(ring, x, t, 2 * (i64)b_lo + 2, hop, rest, j0);
  cp_commit();
  if (b_lo + 1 < b_hi) {
    load_half<kVec>(ring, x, t, 2 * (i64)b_lo + 3, hop, rest, j0);
    load_half<kVec>(ring, x, t, 2 * (i64)b_lo + 4, hop, rest, j0);
  }
  cp_commit();

  // this thread's window values (rows n0 = n1 + 16*n2, n1 in {tw, tw + 8})
  // and stage-1 twiddles (rows k0 = tw + 8*k1), kept for the whole walk
  float wv0[8], wv1[8], twr[16], twi[16];
#pragma unroll
  for (int n2 = 0; n2 < 8; ++n2) {
    wv0[n2] = win[(i64)(tw + 16 * n2) * rest + j0 + j];
    wv1[n2] = win[(i64)(tw + 8 + 16 * n2) * rest + j0 + j];
  }
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) {
    const i64 o = (i64)(tw + 8 * k1) * rest + j0 + j;
    twr[k1] = t1r[o];
    twi[k1] = t1i[o];
  }

  for (int b = b_lo; b < b_hi; ++b) {
    cp_wait_one();    // this thread's copies of pair b have landed
    __syncthreads();  // everyone's; and pair b-1's exchange reads are done
    const float* s0 = ring + (int)((2 * (i64)b) % kSlots) * kSlotFloats;
    const float* s1 = ring + (int)((2 * (i64)b + 1) % kSlots) * kSlotFloats;
    const float* s2 = ring + (int)((2 * (i64)b + 2) % kSlots) * kSlotFloats;
    const bool odd_zero = mask_last && b == npair - 1;
    // pass 1: for n1 in {tw, tw + 8}, the 8-point DFT over n2, then the
    // twiddle W128^(n1*k2)
    pass1(s0, s1, s2, wv0, tw, odd_zero, wr, wi, xr, xi, j);
    pass1(s0, s1, s2, wv1, tw + 8, odd_zero, wr, wi, xr, xi, j);
    __syncthreads();  // the exchange is written; the slots of pair b are read
    // the loads of pair b+2 go to the slots of half-blocks 2b and 2b+1
    if (b + 2 < b_hi) {
      load_half<kVec>(ring, x, t, 2 * (i64)b + 5, hop, rest, j0);
      load_half<kVec>(ring, x, t, 2 * (i64)b + 6, hop, rest, j0);
    }
    cp_commit();
    // pass 2: k2 = tw, the 16-point DFT over n1, then the stage-1 twiddle;
    // output rows k0 = k2 + 8*k1
    float yr[16], yi[16];
#pragma unroll
    for (int n1 = 0; n1 < 16; ++n1) {
      yr[n1] = xr[(n1 * 8 + tw) * kJT + j];
      yi[n1] = xi[(n1 * 8 + tw) * kJT + j];
    }
    dft<16>(yr, yi, wr, wi);
#pragma unroll
    for (int k1 = 0; k1 < 16; ++k1) {
      const i64 o = ((i64)b * kR0 + tw + 8 * k1) * rest + j0 + j;
      out_r[o] = fmaf(yr[k1], twr[k1], -yi[k1] * twi[k1]);
      out_i[o] = fmaf(yr[k1], twi[k1], yi[k1] * twr[k1]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

}  // namespace

extern "C" {

int bhw_welch_stage1(const float* x, i64 t, const float* win, const float* roots_r,
                     const float* roots_i, const float* t1r, const float* t1i, float* out_r,
                     float* out_i, int nfft, int npair, int mask_last, void* stream) {
  if (nfft <= 0 || nfft % kR0 || (nfft / kR0) % kJT || npair < 1 || t < nfft / 2)
    return (int)cudaErrorInvalidValue;
  const int rest = nfft / kR0;
  // 16-byte copies where every row start is 16-byte aligned (rest and j0
  // are multiples of 32 floats, so x's own alignment decides)
  const bool vec = ((uintptr_t)x & 15) == 0;
  void (*kernel)(const float*, i64, const float*, const float*, const float*, const float*,
                 const float*, float*, float*, int, int, int, int, int) =
      vec ? welch_stage1_kernel<4> : welch_stage1_kernel<1>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int slots = sms * per_sm;
  // column tiles x pair ranges: as many ranges as fit beside the tiles in
  // one wave of resident blocks, each range as long as possible (its first
  // half-block is read twice: by it and by the range before)
  const int tiles = rest / kJT;
  int nranges = slots / tiles;
  if (nranges < 1) nranges = 1;
  if (nranges > npair) nranges = npair;
  if (nranges > 65535) nranges = 65535;
  const dim3 grid(tiles, nranges);
  kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      x, t, win, roots_r, roots_i, t1r, t1i, out_r, out_i, rest, nfft, npair, mask_last,
      nranges);
  return (int)cudaGetLastError();
}

}  // extern "C"
