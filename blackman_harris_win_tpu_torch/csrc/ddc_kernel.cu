// The DDC's front half on Hopper (sm_90a): input quantization, NCO,
// integer I/Q mixer and f32 rescale.
//
// Replaces blackman_harris_win_tpu/pipeline/ddc.py:49-80 (nco_iq,
// mix_iq_int and the start of ddc()), jnp that XLA fuses into a few loops;
// the JAX package has no pallas_call for it.  In eager torch the same work
// is some 320 elementwise launches (pipeline/ddc.py's plain version).  Per
// sample i of a row of x (..., T), global index n = n0 + i (n < 0 takes
// n + period: the sharded DDC's circular halo), nl = n mod 2^32:
//
//   xq    = rint(x * (2^15 - 1))                 round half even, as torch.round
//   ph    = (nl * fw) mod 2^PW
//   c, ns = the pre-rotated CORDIC (cos, -sin) of the dds48 or scaled flavor
//           (kernels/cordic.py:cordic_dds48 / cordic_scaled)
//   I, Q  = xq * c, xq * ns                      int32, wrapping
//   out   = (f32(I) * scale, f32(Q) * scale)     one rounding each
//
// written as (2, ..., T) f32 (or, through the raw entry, the int32 I and Q).
//
// What bounds it on the H100: 4 bytes read and 8 written a sample (0.240 ms
// at 2^26 samples and 3.35 TB/s).  The NCO is W CORDIC iterations on a
// 48-bit state (dds48) and, computed for every sample, it and not the
// bytes set the time (an int64 iteration was 24 SASS instructions, most of
// them on the integer ALU pipe, which issues 64 lanes a clock an SM).  But
// the phase depends on nl mod P alone, P = 2^(PW - tz(fw mod 2^PW)) (tz:
// trailing zeros; P = 1 for fw = 0), and P divides 2^PW, which divides
// 2^32.  So the kernel has two paths, chosen on the host
// (kernels/ddc_kernel.py:table_period):
//
// - The period table, where P <= 2^20 and P <= T/4 (the bench's fc = 1/8
//   at PW = 20 has P = 8; an odd word at PW = 20 has P = 2^20).  A short
//   launch first (bhw_ddc_nco_table) writes the P pairs NCO((j * fw) mod
//   2^PW), j < P, with the same nco<F, W> as the other path, into a device
//   buffer the wrapper allocates each call (nothing is cached across
//   calls); the mixer pass then reads pair nl & (P - 1), which is phase ph.
//   The buffer, and no shared memory, serves every P: a small table stays
//   in L1 (a warp's reads fall in a few lines), one of 2^20 pairs (8 MB) in
//   L2, read in order along a row; the stream of x and of the outputs goes
//   through with evict-first loads and stores so that it does not push the
//   table out.  The table costs P NCOs against T a row.
// - The compute path otherwise (PW = 31 with an odd word, short rows,
//   small shards): each sample's NCO, its iterations unrolled at compile
//   time on (flavor, W).  dds48 runs on the FP64 pipe, which no other part
//   of the kernel uses: x, y and z are integers below 2^47 (see Exactness),
//   so a double holds each exactly, and one iteration is
//     d      = copysign(1, z)                       (one LOP3 on the high word)
//     y >> k = fma_rd(y, 2^-k, 1.5 * 2^52) - 1.5 * 2^52
//                                                  (floor: the sum lies in
//                                                   [2^52, 2^53), ulp 1)
//     x     += d * (y >> k), y -= d * (x >> k), z -= d * lut[k]  (DFMA)
//   seven DFMA/DADD and one LOP3 against the int64 datapath's 24.  The
//   scaled flavor's state is one 32-bit word a register (x/y SEL_SIZE <= 31
//   bits, z max(SIZE, PW) <= 31 at the mixer's widths), steered by d = +-1
//   so that x + d*(y >> k) issues as one IMAD.
//
// Both mixer passes: a thread takes kPer samples of a row, kThreads apart,
// so every load and store of a warp is one coalesced 128-byte line and a
// thread has kPer loads in flight; the (cos, -sin) pairs are looked up or
// computed once and mixed into a stride of rows (blockIdx.y splits the
// rows only as far as a short row needs blocks to fill the card).
//
// Exactness.  The reference wraps x and y to the state width and z to its
// own after every add; those wraps never change a value here:
// - z starts in [-2^(Z-2), 2^(Z-2)) (Z its width: the pre-rotated start
//   angle init_t lies in [-2^(PW-2), 2^(PW-2)) and is shifted up by Z - PW,
//   or kept when PW > SIZE in the scaled flavor), lut[0] = 2^(Z-3), and
//   |z_{k+1}| = ||z_k| - lut[k]| <= max(|z_k|, lut[k]): |z| <= 2^(Z-2).
// - x, y start at (gain, 0), (0, -+gain) with gain = 2^(S-2)/K (S the
//   state width, K = 1.6468 the CORDIC gain); each iteration scales the
//   length by sqrt(1 + 2^-2k) and the floored shifts add less than 2, so
//   |x|, |y| < 2^(S-2) + 64, inside the S-bit range (dds48: below 2^47).
// - cos = x >> (S - W) then lies in [-2^(W-2) - 1, 2^(W-2)], so its W-bit
//   wrap is the identity too.  dds48 takes it as floor(x * 2^-(S-W)).
// - In the doubles every operation's exact result is an integer below 2^47
//   (or, in the floor, a value in [2^52, 2^53) whose rounding down is the
//   floor), so none rounds; the FP64 operations are intrinsics, which the
//   compiler neither fuses nor reorders.  An exact zero sum is +0 under
//   round to nearest, so copysign(1, z) is +1 exactly where z >= 0.
// tests/test_torch_ddc_kernel.py emulates both datapaths and the table in
// numpy, asserts these ranges and holds them 0 LSB against the plain
// version and JAX.  All 32-bit adds and multiplies go through uint32_t, so
// every wrap (the phase product, an input past the mixer's 15 bits) is
// defined (ROADMAP "Wrap arithmetic must stay defined"); right shifts of
// negative values are arithmetic under nvcc.  The rescale is __fmul_rn, one
// rounding whatever -fmad says.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kPer = 4;  // samples a thread, kThreads apart
constexpr i64 kTile = (i64)kThreads * kPer;
constexpr int kMinW = 8;
constexpr int kMaxW = 17;  // MIX_IN_BITS + W - 1 <= 31: the product fits int32
constexpr int kTargetBlocks = 2048;
constexpr i64 kMaxTable = 1 << 20;
constexpr float kAmp = 32767.0f;  // 2^MIX_IN_BITS - 1
constexpr double kFloorMagic = 6755399441055744.0;  // 1.5 * 2^52

// flavor codes, in the order of kernels/ddc_kernel.py:FLAVORS
enum Flavor : int { kDds48 = 0, kScaled = 1 };

struct DdcParams {
  i64 lut[kMaxW];     // the z steps lut[0..W-2] of the flavor's z width
  double lutd[kMaxW];  // the same, as doubles (dds48)
  i64 gain;           // seed length of the x/y state
  double gaind;
  double zscale;      // 2^zshift: init_z = init_t << zshift
  double oscale;      // 2^-oshift: cos = x >> oshift
  i64 n0;             // global index of x[..., 0]
  i64 period;         // an index n < 0 takes n + period
  i64 t;              // samples a row
  i64 rows;
  i64 table_len;      // P, the entries of the (cos, -sin) table
  unsigned fw;        // tuning word mod 2^PW
  int pw;
  int zshift;
  int oshift;
  float scale;        // float32(1 / (amp * 2^(W-2)))
};

// The pre-rotation of src/cordic_dds48.vhd:172-216 (shared by the scaled
// flavor): the start angle, and the quadrant that picks the start vector.
struct Front {
  int init_t;
  unsigned q;
};

__device__ __forceinline__ Front prerotate(unsigned ph, int pw) {
  Front f;
  f.q = ph >> (pw - 2);
  const int low = (int)(ph & ((1u << (pw - 2)) - 1));
  const int sphi = (int)(ph << (32 - pw)) >> (32 - pw);  // ph as a signed PW-bit value
  f.init_t = (f.q == 0 || f.q == 3) ? sphi : (f.q == 1 ? low : low - (1 << (pw - 2)));
  return f;
}

// floor(v * 2^-k) of an integer-valued double |v| < 2^47, exactly
template <int K>
__device__ __forceinline__ double floor_shift(double v) {
  const double s = __hiloint2double((1023 - K) << 20, 0);  // 2^-K
  return __dsub_rn(__fma_rd(v, s, kFloorMagic), kFloorMagic);
}

template <int W, int K = 0>
__device__ __forceinline__ void iterate48(double& x, double& y, double& z, const DdcParams& P) {
  if constexpr (K < W) {
    const double d = copysign(1.0, z);  // +1 for z >= 0 (z is never -0)
    const double ys = K ? floor_shift<K>(y) : y, xs = K ? floor_shift<K>(x) : x;
    x = __fma_rn(d, ys, x);
    y = __fma_rn(-d, xs, y);
    if constexpr (K < W - 1) z = __fma_rn(-d, P.lutd[K], z);
    iterate48<W, K + 1>(x, y, z, P);
  }
}

// (cos, -sin) of phase ph: W x/y iterations, W-1 z steps, pre-rotated
// steering (z >= 0: x += y >> k, y -= x >> k, z -= lut[k]).
template <int F, int W>
__device__ __forceinline__ void nco(unsigned ph, const DdcParams& P, int& c, int& ns) {
  const Front f = prerotate(ph, P.pw);
  if constexpr (F == kDds48) {
    const double g = P.gaind;
    double x = (f.q == 0 || f.q == 3) ? g : 0.0;
    double y = f.q == 1 ? -g : (f.q == 2 ? g : 0.0);
    double z = __dmul_rn(__int2double_rn(f.init_t), P.zscale);
    iterate48<W>(x, y, z, P);
    c = __double2int_rd(__dmul_rn(x, P.oscale));
    ns = __double2int_rd(__dmul_rn(y, P.oscale));
  } else {
    const int g = (int)P.gain;
    int x = (f.q == 0 || f.q == 3) ? g : 0;
    int y = f.q == 1 ? -g : (f.q == 2 ? g : 0);
    int z = (int)((unsigned)f.init_t << P.zshift);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const unsigned d = (unsigned)((z >> 31) | 1);  // +1 for z >= 0, -1 below
      const int ys = y >> k, xs = x >> k;
      x = (int)((unsigned)x + d * (unsigned)ys);
      y = (int)((unsigned)y - d * (unsigned)xs);
      if (k < W - 1) z = (int)((unsigned)z - d * (unsigned)(int)P.lut[k]);
    }
    c = x >> P.oshift;
    ns = y >> P.oshift;
  }
}

// nl = n mod 2^32 of row sample i, n = n0 + i (n < 0 takes n + period)
__device__ __forceinline__ unsigned index_of(i64 i, const DdcParams& P) {
  const i64 n = P.n0 + i;
  return (unsigned)(u64)(n < 0 ? n + P.period : n);
}

// quantize, mix and write the samples i0 + j * kThreads (j < kPer) of every
// row of this block's stride, given their (cos, -sin)
template <bool RAW>
__device__ __forceinline__ void mix_rows(void* __restrict__ out, const float* __restrict__ x,
                                         const DdcParams& P, i64 i0, const int (&c)[kPer],
                                         const int (&ns)[kPer]) {
  const i64 total = P.rows * P.t;
  for (i64 r = blockIdx.y; r < P.rows; r += gridDim.y) {
    const i64 base = r * P.t + i0;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      v[j] = i0 + j * kThreads < P.t ? __ldcs(x + base + j * kThreads) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (i0 + j * kThreads >= P.t) break;
      const i64 e = base + j * kThreads;
      const int xq = __float2int_rn(__fmul_rn(v[j], kAmp));
      const int mi = (int)((unsigned)xq * (unsigned)c[j]);
      const int mq = (int)((unsigned)xq * (unsigned)ns[j]);
      if constexpr (RAW) {
        int* o = static_cast<int*>(out);
        __stcs(o + e, mi);
        __stcs(o + total + e, mq);
      } else {
        float* o = static_cast<float*>(out);
        __stcs(o + e, __fmul_rn(__int2float_rn(mi), P.scale));
        __stcs(o + total + e, __fmul_rn(__int2float_rn(mq), P.scale));
      }
    }
  }
}

// the compute path: each sample's NCO
template <int F, int W, bool RAW>
__global__ void __launch_bounds__(kThreads)
ddc_mixer_kernel(void* __restrict__ out, const float* __restrict__ x, const DdcParams P) {
  const i64 i0 = (i64)blockIdx.x * kTile + threadIdx.x;
  const unsigned mask = (1u << P.pw) - 1;
  int c[kPer], ns[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {  // past the row's end: a phase nobody writes
    nco<F, W>((index_of(i0 + j * kThreads, P) * P.fw) & mask, P, c[j], ns[j]);
  }
  mix_rows<RAW>(out, x, P, i0, c, ns);
}

// the table path's mixer pass: pair nl & (P - 1) of the table
template <bool RAW>
__global__ void __launch_bounds__(kThreads)
ddc_table_mixer_kernel(void* __restrict__ out, const float* __restrict__ x,
                       const int2* __restrict__ table, const DdcParams P) {
  const i64 i0 = (i64)blockIdx.x * kTile + threadIdx.x;
  const unsigned pmask = (unsigned)(P.table_len - 1);
  int c[kPer], ns[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int2 v = __ldg(table + (index_of(i0 + j * kThreads, P) & pmask));
    c[j] = v.x;
    ns[j] = v.y;
  }
  mix_rows<RAW>(out, x, P, i0, c, ns);
}

// the table: entry j < P is the NCO at phase (j * fw) mod 2^PW
template <int F, int W>
__global__ void __launch_bounds__(kThreads)
ddc_nco_table_kernel(int2* __restrict__ table, const DdcParams P) {
  const i64 j = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (j >= P.table_len) return;
  int c, ns;
  nco<F, W>(((unsigned)j * P.fw) & ((1u << P.pw) - 1), P, c, ns);
  table[j] = make_int2(c, ns);
}

typedef void (*MixerKernel)(void*, const float*, DdcParams);
typedef void (*TableKernel)(int2*, DdcParams);

template <int F, int W>
MixerKernel pick_width(int w, bool raw) {
  if constexpr (W > kMaxW) {
    return nullptr;
  } else if (w == W) {
    return raw ? ddc_mixer_kernel<F, W, true> : ddc_mixer_kernel<F, W, false>;
  } else {
    return pick_width<F, W + 1>(w, raw);
  }
}

template <int F, int W>
TableKernel pick_table(int w) {
  if constexpr (W > kMaxW) {
    return nullptr;
  } else {
    return w == W ? ddc_nco_table_kernel<F, W> : pick_table<F, W + 1>(w);
  }
}

MixerKernel mixer_kernel(int flavor, int w, bool raw) {
  if (flavor == kDds48) return pick_width<kDds48, kMinW>(w, raw);
  if (flavor == kScaled) return pick_width<kScaled, kMinW>(w, raw);
  return nullptr;
}

TableKernel table_kernel(int flavor, int w) {
  if (flavor == kDds48) return pick_table<kDds48, kMinW>(w);
  if (flavor == kScaled) return pick_table<kScaled, kMinW>(w);
  return nullptr;
}

// the NCO's parameters, checked; false for what the kernels do not take
bool fill(DdcParams& P, unsigned fw, int pw, int w, int flavor, const i64* lut, int nlut,
          i64 gain, int zshift, int oshift) {
  if (flavor != kDds48 && flavor != kScaled) return false;
  if (w < kMinW || w > kMaxW || pw < 4 || pw > 31 || nlut != w - 1) return false;
  const int zmax = flavor == kDds48 ? 48 : 31;
  if (zshift < 0 || zshift > zmax - pw || oshift < 0 || oshift > 47) return false;
  for (int k = 0; k < kMaxW; ++k) {
    P.lut[k] = k < nlut ? lut[k] : 0;
    P.lutd[k] = (double)P.lut[k];
  }
  P.gain = gain;
  P.gaind = (double)gain;
  P.zscale = (double)(1ll << zshift);
  P.oscale = 1.0 / (double)(1ll << oshift);
  P.fw = fw & ((1u << pw) - 1);
  P.pw = pw;
  P.zshift = zshift;
  P.oshift = oshift;
  return true;
}

// a table of len entries holds the whole period of fw: len is a power of
// two at most kMaxTable and (len * fw) mod 2^PW == 0
bool table_len_ok(i64 len, const DdcParams& P) {
  if (len < 1 || len > kMaxTable || (len & (len - 1))) return false;
  return ((unsigned)len * P.fw & ((1u << P.pw) - 1)) == 0;
}

}  // namespace

extern "C" {

// table: len int32 (cos, -sin) pairs, contiguous; len the NCO's period P
// (kernels/ddc_kernel.py:nco_period) or a multiple of it, at most 2^20.
// lut, gain, zshift, oshift as for bhw_ddc_mixer.
int bhw_ddc_nco_table(void* table, i64 len, unsigned fw, int pw, int w, int flavor,
                      const i64* lut, int nlut, i64 gain, int zshift, int oshift, void* stream) {
  DdcParams P{};
  if (!fill(P, fw, pw, w, flavor, lut, nlut, gain, zshift, oshift) || !table_len_ok(len, P)) {
    return (int)cudaErrorInvalidValue;
  }
  P.table_len = len;
  const TableKernel kern = table_kernel(flavor, w);
  const unsigned blocks = (unsigned)((len + kThreads - 1) / kThreads);
  kern<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(static_cast<int2*>(table), P);
  return (int)cudaGetLastError();
}

// out: (2, rows, t) float32 (raw = 0) or int32 (raw = 1); x: (rows, t)
// float32, both contiguous.  lut: nlut = W - 1 z steps; gain, zshift and
// oshift of the flavor at (PW, W) (kernels/ddc_kernel.py:mixer_constants).
// table: null for the compute path, else the table_len pairs that
// bhw_ddc_nco_table wrote for this (fw, PW, W, flavor).
int bhw_ddc_mixer(void* out, const float* x, i64 rows, i64 t, i64 n0, i64 period, unsigned fw,
                  int pw, int w, int flavor, const i64* lut, int nlut, i64 gain, int zshift,
                  int oshift, float scale, int raw, const void* table, i64 table_len,
                  void* stream) {
  DdcParams P{};
  if (!fill(P, fw, pw, w, flavor, lut, nlut, gain, zshift, oshift) || rows < 1 || t < 1 ||
      (table && !table_len_ok(table_len, P))) {
    return (int)cudaErrorInvalidValue;
  }
  P.n0 = n0;
  P.period = period;
  P.t = t;
  P.rows = rows;
  P.table_len = table ? table_len : 0;
  P.scale = scale;
  const i64 bx = (t + kTile - 1) / kTile;
  if (bx > INT_MAX) return (int)cudaErrorInvalidValue;
  const i64 want = (kTargetBlocks + bx - 1) / bx;  // row groups a short row needs
  const dim3 grid((unsigned)bx, (unsigned)(rows < want ? rows : want));
  const cudaStream_t st = (cudaStream_t)stream;
  if (table) {
    const int2* tab = static_cast<const int2*>(table);
    if (raw) {
      ddc_table_mixer_kernel<true><<<grid, kThreads, 0, st>>>(out, x, tab, P);
    } else {
      ddc_table_mixer_kernel<false><<<grid, kThreads, 0, st>>>(out, x, tab, P);
    }
  } else {
    mixer_kernel(flavor, w, raw != 0)<<<grid, kThreads, 0, st>>>(out, x, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
