// Quarter-wave-LUT + 1st-order-Taylor sine/cosine (the TAYLOR source) on
// Hopper (sm_90a).
//
// Replaces blackman_harris_win_tpu/kernels/pallas/taylor_kernel.py:
// make_checksum_fn_taylor with three kernels that share one device function
// (taylor_cs: (cos, sin) at a sample index, in all three PW-LS regimes):
//   taylor_sincos_kernel    writes c and s for [n0, n0+count);
//   taylor_window_kernel    the HLS 2/3-term TAYLOR window: harmonic 1 at PW,
//                           harmonic 2 at PW-1 (the reference's one-bit-
//                           narrower generator), wrap or saturate to W bits;
//   taylor_checksum_kernel  the int32-wrap sum of c+s over [n0, n0+count),
//                           nothing stored.
// The semantics are those of model/golden.py:taylor_sincos and
// tay1_correction (src/taylor_sincos.vhd, src/tay1_order.vhd).
//
// The TPU kernel walked the ROM in (rows, R) tiles through a modular
// BlockSpec to avoid an XLA gather.  Here each thread indexes its samples
// itself and reads its ROM entry from shared memory: a block stages the
// whole quarter-wave ROM once (2^LS int2 entries, 32 KB at LS=12, up to the
// 227 KB opt-in at LS=14) and then walks a grid-stride loop, so the staging
// is amortised over many samples.  Larger ROMs are read through the
// read-only cache.  Neighbouring threads share a ROM entry (R = 2^(PW-LS-2)
// consecutive samples per entry), so the loads are broadcasts.
//
// What bounds it on the H100: integer issue.  A sample costs the index
// split, one ROM load, two 32x32->64 products (mpi * sin, mpi * cos; mpi <
// pi * 2^18 and |ROM| < 2^31), shifts, wraps and the quadrant select: a few
// tens of instructions.  The write-out also stores 8 bytes per sample (c, s).
//
// The ROM comes from the host (numpy float64, as the JAX package builds
// it): cos() on the device rounds differently.  Defined arithmetic: every
// wrap and left shift goes through uint64_t; right shifts of negative
// values are arithmetic under nvcc; no product or sum can overflow int64
// (products < 2^22 * 2^31, coefficients |a_k| < 2^31 checked by the
// wrapper).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMaxTerms = 3;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemOptIn = 232448;  // 227 KB: a block's opt-in maximum on sm_90

// One generator instance: phase width, data width, LUT size, and the
// correction's phase constant round(pi * 2^(17-STAGE)) (tay1 regime only).
struct Gen {
  int pw, w, ls, ramb_pi;
};

struct WinParams {
  i64 coeffs[kMaxTerms];
  Gen gen[kMaxTerms - 1];  // harmonic k runs gen[k-1]
  int nterms, saturate;
};

// Two's-complement wrap to `width` bits (sign-extended low bits).
__device__ __forceinline__ i64 wrapw(i64 v, int width) {
  const int s = 64 - width;
  return (i64)((u64)v << s) >> s;
}

// ROM readers: the copy staged in shared memory, or the table in device
// memory through the read-only cache.
struct SmemRom {
  const int2* p;
  __device__ __forceinline__ int2 operator()(u64 a) const { return p[a]; }
};
struct LdgRom {
  const int2* p;
  __device__ __forceinline__ int2 operator()(u64 a) const { return __ldg(p + a); }
};

// (cos, sin) of the TAYLOR generator at sample index n (taken mod 2^PW).
template <class Rom>
__device__ __forceinline__ void taylor_cs(u64 n, const Gen& g, const Rom& rom, i64& c,
                                          i64& s) {
  const int pw = g.pw, w = g.w, ls = g.ls, d = g.pw - g.ls;
  const u64 cnt = n & ((1ull << pw) - 1);
  const int quadrant = (int)(cnt >> (pw - 2));
  const u64 ph = cnt & ((1ull << (pw - 2)) - 1);
  i64 mc, ms;
  if (d < 2) {  // over-wide LUT: top-aligned address (taylor_sincos.vhd:159-160)
    const int2 e = rom(ph << (ls - pw + 2));
    mc = e.x;
    ms = e.y;
  } else if (d == 2) {  // exact quarter-wave LUT
    const int2 e = rom(ph);
    mc = e.x;
    ms = e.y;
  } else {  // tay1 correction, STAGE = PW-LS-3, VAL_SHIFT = LS
    const int2 e = rom(ph >> (d - 2));
    // acnt can exceed 32 bits only where ramb_pi rounds to 0 (PW-LS >= 23)
    const int acnt = (int)(ph & ((1ull << (d - 2)) - 1));
    const int mpi = g.ramb_pi * acnt;  // < pi * 2^18 (tay1_order.vhd:130-147)
    const int xs = 19 + ls;
    const i64 pc = ((i64)mpi * e.x) >> xs, ps = ((i64)mpi * e.y) >> xs;
    if (w < 19) {
      // 48-bit DSP accumulate then slice, no saturation (vhd:180-504):
      // (cos<<X - mpi*sin) >> X == cos + ((mpi*(-sin)) >> X)
      mc = wrapw(e.x + (((i64)mpi * -(i64)e.y) >> xs), w);
      ms = wrapw(e.y + pc, w);
    } else {
      // product sliced to W bits, W-bit add, negatives clamp to +max
      // ("scale overflow", vhd:601-617)
      const i64 top = (1ll << (w - 1)) - 1;
      mc = wrapw(e.x - wrapw(ps, w), w);
      ms = wrapw(e.y + wrapw(pc, w), w);
      if (mc < 0) mc = top;
      if (ms < 0) ms = top;
    }
  }
  const i64 nc = wrapw(-mc, w), ns = wrapw(-ms, w);
  c = quadrant == 0 ? mc : quadrant == 1 ? ns : quadrant == 2 ? nc : ms;
  s = quadrant == 0 ? ms : quadrant == 1 ? mc : quadrant == 2 ? ns : nc;
}

// Stage the ROM in shared memory (kSmem) or hand out the device table.
template <bool kSmem>
__device__ __forceinline__ auto rom_reader(const int2* rom, int ls) {
  if constexpr (kSmem) {
    extern __shared__ int2 rom_s[];
    for (int i = threadIdx.x; i < (1 << ls); i += blockDim.x) rom_s[i] = __ldg(rom + i);
    __syncthreads();
    return SmemRom{rom_s};
  } else {
    return LdgRom{rom};
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
taylor_sincos_kernel(int* __restrict__ c_out, int* __restrict__ s_out, u64 n0, i64 count,
                     const int2* __restrict__ rom, const Gen g) {
  const auto rd = rom_reader<kSmem>(rom, g.ls);
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    i64 c, s;
    taylor_cs(n0 + (u64)i, g, rd, c, s);
    c_out[i] = (int)c;
    s_out[i] = (int)s;
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
taylor_window_kernel(int* __restrict__ out, u64 n0, i64 count, const int2* __restrict__ rom,
                     const WinParams P) {
  const auto rd = rom_reader<kSmem>(rom, P.gen[0].ls);
  const int w = P.gen[0].w;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    // HLS: a0 - m1 + m2, m_k = (a_k * cos_k) >> (W-1) (full-scale source)
    i64 acc = P.coeffs[0];
#pragma unroll
    for (int k = 1; k < kMaxTerms; ++k) {
      if (k >= P.nterms) break;
      i64 c, s;
      taylor_cs(n0 + (u64)i, P.gen[k - 1], rd, c, s);
      const i64 m = (P.coeffs[k] * c) >> (w - 1);
      acc = (k & 1) ? acc - m : acc + m;
    }
    if (P.saturate) {  // the int64 accumulator is exact: clamp the true sum
      const i64 hi = (1ll << (w - 1)) - 1, lo = -(1ll << (w - 1));
      acc = acc > hi ? hi : (acc < lo ? lo : acc);
    } else {
      acc = wrapw(acc, w);
    }
    out[i] = (int)acc;
  }
}

// Sum mod 2^32 is associative and commutative, so the per-thread, per-warp
// and cross-block (atomicAdd) partial sums give a bit-exact total in any
// block order.  *out holds the bias on entry.
template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
taylor_checksum_kernel(unsigned* __restrict__ out, u64 n0, i64 count,
                       const int2* __restrict__ rom, const Gen g) {
  const auto rd = rom_reader<kSmem>(rom, g.ls);
  unsigned acc = 0;
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    i64 c, s;
    taylor_cs(n0 + (u64)i, g, rd, c, s);
    acc += (unsigned)c + (unsigned)s;
  }
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

bool valid_gen(const Gen& g) {
  return g.pw >= 2 && g.pw <= 62 && g.ls >= 0 && g.ls < g.pw && g.ls <= 30 && g.w >= 2 &&
         g.w <= 32 && g.ramb_pi >= 0;
}

// Launch the shared-memory variant where the ROM fits a block's opt-in
// shared memory, the read-only-cache variant otherwise; one persistent
// grid of as many blocks as fit on the card at once (a block stages the
// ROM once and walks a grid-stride loop).
template <typename... P, typename... A>
int launch(void (*smem_kernel)(P...), void (*ldg_kernel)(P...), int ls, i64 count,
           cudaStream_t stream, A... args) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(int2) << ls;
  const bool smem = bytes <= kSmemOptIn;
  void (*kernel)(P...) = smem ? smem_kernel : ldg_kernel;
  const size_t shm = smem ? bytes : 0;
  cudaError_t e = cudaSuccess;
  if (shm > kSmemDefault)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  i64 blocks = (count + kThreads - 1) / kThreads;
  if (blocks > (i64)sms * per_sm) blocks = (i64)sms * per_sm;
  kernel<<<(unsigned)blocks, kThreads, shm, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bhw_taylor_sincos_block(int* c, int* s, i64 n0, i64 count, const int* rom, int pw,
                            int w, int ls, int ramb_pi, void* stream) {
  const Gen g{pw, w, ls, ramb_pi};
  if (!valid_gen(g) || n0 < 0) return (int)cudaErrorInvalidValue;
  return launch(taylor_sincos_kernel<true>, taylor_sincos_kernel<false>, ls, count,
                (cudaStream_t)stream, c, s, (u64)n0, count, (const int2*)rom, g);
}

int bhw_taylor_window_block(int* out, i64 n0, i64 count, const int* rom, int pw, int w,
                            int ls, const i64* coeffs, int nterms, int ramb_pi1,
                            int ramb_pi2, int saturate, void* stream) {
  if (nterms < 2 || nterms > kMaxTerms || n0 < 0) return (int)cudaErrorInvalidValue;
  WinParams P;
  for (int k = 0; k < kMaxTerms; ++k) {
    P.coeffs[k] = k < nterms ? coeffs[k] : 0;
    if (P.coeffs[k] <= -(1ll << 31) || P.coeffs[k] >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
  }
  P.gen[0] = Gen{pw, w, ls, ramb_pi1};
  P.gen[1] = Gen{pw - 1, w, ls, ramb_pi2};
  for (int k = 1; k < nterms; ++k)
    if (!valid_gen(P.gen[k - 1])) return (int)cudaErrorInvalidValue;
  P.nterms = nterms;
  P.saturate = saturate;
  return launch(taylor_window_kernel<true>, taylor_window_kernel<false>, ls, count,
                (cudaStream_t)stream, out, (u64)n0, count, (const int2*)rom, P);
}

int bhw_taylor_checksum(unsigned* out, i64 n0, i64 count, const int* rom, int pw, int w,
                        int ls, int ramb_pi, void* stream) {
  const Gen g{pw, w, ls, ramb_pi};
  if (!valid_gen(g) || n0 < 0) return (int)cudaErrorInvalidValue;
  return launch(taylor_checksum_kernel<true>, taylor_checksum_kernel<false>, ls, count,
                (cudaStream_t)stream, out, (u64)n0, count, (const int2*)rom, g);
}

}  // extern "C"
