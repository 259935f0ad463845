// Welch analyzer front half on Hopper (sm_90a): framing + window + frame-pair
// packing + the first DFT stage (radix 128) + the stage-1 twiddle.
//
// Replaces blackman_harris_win_tpu/kernels/pallas/welchfft_kernel.py:
// welch_stage1_fused, with the same contract and output layout:
//   out[b, k0, j] = tw1[k0, j] * sum_n0 M[k0, n0] * z[n0, j],
//   z[n0, j] = (x[b*nfft + n0*rest + j] + i*x[b*nfft + hop + n0*rest + j])
//              * win[n0*rest + j],
// for frame pair b (even frame at b*nfft, odd at b*nfft + hop, hop =
// nfft/2), rest = nfft/128, M the 128-point DFT matrix, tw1[k0, j] =
// W_nfft^(k0*j).  When the frame count is odd, the last pair's odd member
// is the zero pad frame.  Samples past the end of x read as zero (no padded
// copy of x is made).
//
// What bounds it on the H100: fp32 FMA issue.  Each pair costs
// 4 * 128 * nfft FMAs against 12 * nfft bytes of x read and output
// written, about 40 FMA per byte, above the card's fp32 ridge.  The DFT
// product must stay in full fp32 (TF32 tensor cores keep ~10 mantissa
// bits and miss the analyzer's error budget), so it is a register-tiled
// FMA loop: each block owns one (pair, 64-column) tile of the 128 x 64
// complex output, each of its 256 threads an 8 x 4 complex micro-tile.
// On the TPU the whole 128 x 128 table and the tiles sat in VMEM; here a
// block has at most 227 KB of shared memory, so the table and the z tile
// are staged through shared memory in chunks of 16 contraction rows
// (24 KB per block, so several blocks share an SM).  z is formed from x
// and the window while it is staged, so framing and windowing never touch
// device memory.  M is symmetric, so its rows are read as its columns
// (coalesced, bank-conflict free).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;

constexpr int kR0 = 128;  // leading radix (rows of the DFT stage)
constexpr int kJT = 64;   // output columns per block
constexpr int kKC = 16;   // contraction rows staged per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
welch_stage1_kernel(const float* __restrict__ x, i64 t,
                    const float* __restrict__ win,
                    const float* __restrict__ m0r, const float* __restrict__ m0i,
                    const float* __restrict__ t1r, const float* __restrict__ t1i,
                    float* __restrict__ out_r, float* __restrict__ out_i,
                    int rest, int nfft, int npair, int mask_last) {
  __shared__ float mr_s[kKC][kR0], mi_s[kKC][kR0];
  __shared__ float zr_s[kKC][kJT], zi_s[kKC][kJT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y, j0 = blockIdx.x * kJT;
  const i64 even0 = (i64)b * nfft, odd0 = even0 + nfft / 2;
  const bool odd_zero = mask_last && b == npair - 1;

  float accr[8][4], acci[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) accr[i][jj] = acci[i][jj] = 0.f;

  for (int c0 = 0; c0 < kR0; c0 += kKC) {
    for (int e = tid; e < kKC * kR0; e += kThreads) {
      const int kk = e / kR0, k0 = e % kR0;
      mr_s[kk][k0] = m0r[(c0 + kk) * kR0 + k0];  // M[k0, c0+kk] by symmetry
      mi_s[kk][k0] = m0i[(c0 + kk) * kR0 + k0];
    }
    for (int e = tid; e < kKC * kJT; e += kThreads) {
      const int kk = e / kJT, j = e % kJT;
      const i64 off = (i64)(c0 + kk) * rest + j0 + j;
      const float wv = win[off];
      const i64 se = even0 + off, so = odd0 + off;
      const float xe = se < t ? x[se] : 0.f;
      const float xo = (!odd_zero && so < t) ? x[so] : 0.f;
      zr_s[kk][j] = xe * wv;
      zi_s[kk][j] = xo * wv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      float mr[8], mi[8], zr[4], zi[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mr[i] = mr_s[kk][ty + 16 * i];
        mi[i] = mi_s[kk][ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        zr[jj] = zr_s[kk][tx + 16 * jj];
        zi[jj] = zi_s[kk][tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          accr[i][jj] = fmaf(mr[i], zr[jj], accr[i][jj]);
          accr[i][jj] = fmaf(-mi[i], zi[jj], accr[i][jj]);
          acci[i][jj] = fmaf(mr[i], zi[jj], acci[i][jj]);
          acci[i][jj] = fmaf(mi[i], zr[jj], acci[i][jj]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k0 = ty + 16 * i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = j0 + tx + 16 * jj;
      const i64 ti = (i64)k0 * rest + col;
      const float twr = t1r[ti], twi = t1i[ti];
      const float yr = accr[i][jj], yi = acci[i][jj];
      const i64 o = ((i64)b * kR0 + k0) * rest + col;
      out_r[o] = yr * twr - yi * twi;
      out_i[o] = yr * twi + yi * twr;
    }
  }
}

}  // namespace

extern "C" {

int bhw_welch_stage1(const float* x, i64 t, const float* win, const float* m0r,
                     const float* m0i, const float* t1r, const float* t1i,
                     float* out_r, float* out_i, int nfft, int npair,
                     int mask_last, void* stream) {
  if (nfft <= 0 || nfft % kR0 || (nfft / kR0) % kJT || npair < 1 || npair > 65535)
    return (int)cudaErrorInvalidValue;
  const int rest = nfft / kR0;
  const dim3 grid(rest / kJT, npair);
  welch_stage1_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, t, win, m0r, m0i, t1r, t1i, out_r, out_i, rest, nfft, npair, mask_last);
  return (int)cudaGetLastError();
}

}  // extern "C"
