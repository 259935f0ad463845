// The DDC's front half on Hopper (sm_90a): input quantization, NCO,
// integer I/Q mixer and f32 rescale in one pass.
//
// Replaces blackman_harris_win_tpu/pipeline/ddc.py:49-80 (nco_iq,
// mix_iq_int and the start of ddc()), jnp that XLA fuses into a few loops;
// the JAX package has no pallas_call for it.  In eager torch the same work
// is some 320 elementwise launches (pipeline/ddc.py's plain version); here
// it is one.  Per sample i of a row of x (..., T), global index n = n0 + i
// (n < 0 takes n + period: the sharded DDC's circular halo):
//
//   xq    = rint(x * (2^15 - 1))                 round half even, as torch.round
//   ph    = ((n mod 2^32) * fw) mod 2^PW
//   c, ns = the pre-rotated CORDIC (cos, -sin) of the dds48 or scaled flavor
//           (kernels/cordic.py:cordic_dds48 / cordic_scaled)
//   I, Q  = xq * c, xq * ns                      int32, wrapping
//   out   = (f32(I) * scale, f32(Q) * scale)     one rounding each
//
// written as (2, ..., T) f32 (or, through the raw entry, the int32 I and Q).
//
// What bounds it on the H100: 4 bytes read and 8 written a sample (0.240 ms
// at 2^26 samples and 3.35 TB/s) against W CORDIC iterations of some 6
// integer operations (about 0.23 ms at W=16 and the issue rate): the two
// bounds meet, so the design keeps the iterations cheap and makes one
// coalesced pass over memory.
//
// - The iterations unroll at compile time on (flavor, W): every shift count
//   is an immediate and lut[k] a constant-bank operand.  PW only moves the
//   phase front end's shifts, which take it from a uniform register.
// - scaled: x/y are SEL_SIZE <= 31 bits wide and z max(SIZE, PW) <= 31 at
//   the mixer's widths (W <= 17, PW <= 31), so the whole state is one
//   32-bit word a register, steered by d = +-1 so that x + d*(y >> k)
//   issues as one IMAD.  dds48: x, y, z are 48-bit, so the state is int64
//   (the only place the kernel needs it).
// - The phase product is 32-bit: 2^PW divides 2^32, so
//   ((n mod 2^32) * fw mod 2^32) mod 2^PW is the phase for any n.
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
//   |x|, |y| < 2^(S-2) + 64, inside the S-bit range.
// - cos = x >> (S - W) then lies in [-2^(W-2) - 1, 2^(W-2)], so its W-bit
//   wrap is the identity too.
// tests/test_torch_ddc_kernel.py emulates this datapath in numpy, asserts
// these ranges and holds it 0 LSB against the plain version and JAX.
// All 32-bit adds and multiplies go through uint32_t and the int64 ones
// through uint64_t, so every wrap (the phase product, an input past the
// mixer's 15 bits) is defined (ROADMAP "Wrap arithmetic must stay
// defined"); right shifts of negative values are arithmetic under nvcc.
// The rescale is __fmul_rn, one rounding whatever -fmad says.
//
// Grid: blockIdx.x walks a row in blocks of kThreads samples, one index a
// thread, so every load and store of a warp is one coalesced 128-byte
// line.  The NCO depends on the index alone, so a thread computes it once
// and mixes it into a stride of rows; blockIdx.y splits the rows only as
// far as a short row needs blocks to fill the card (kTargetBlocks).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

typedef long long i64;
typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMinW = 8;
constexpr int kMaxW = 17;  // MIX_IN_BITS + W - 1 <= 31: the product fits int32
constexpr int kTargetBlocks = 2048;
constexpr float kAmp = 32767.0f;  // 2^MIX_IN_BITS - 1

// flavor codes, in the order of kernels/ddc_kernel.py:FLAVORS
enum Flavor : int { kDds48 = 0, kScaled = 1 };

struct DdcParams {
  i64 lut[kMaxW];  // the z steps lut[0..W-2] of the flavor's z width
  i64 gain;        // seed length of the x/y state
  i64 n0;          // global index of x[..., 0]
  i64 period;      // an index n < 0 takes n + period
  i64 t;           // samples a row
  i64 rows;
  unsigned fw;     // tuning word mod 2^PW
  int pw;
  int zshift;      // init_z = init_t << zshift
  int oshift;      // cos = x >> oshift
  float scale;     // float32(1 / (amp * 2^(W-2)))
};

__device__ __forceinline__ i64 add64(i64 a, i64 b) { return (i64)((u64)a + (u64)b); }
__device__ __forceinline__ i64 sub64(i64 a, i64 b) { return (i64)((u64)a - (u64)b); }

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

// (cos, -sin) of phase ph: W x/y iterations, W-1 z steps, pre-rotated
// steering (z >= 0: x += y >> k, y -= x >> k, z -= lut[k]).
template <int F, int W>
__device__ __forceinline__ void nco(unsigned ph, const DdcParams& P, int& c, int& ns) {
  const Front f = prerotate(ph, P.pw);
  if constexpr (F == kDds48) {
    const i64 g = P.gain;
    i64 x = (f.q == 0 || f.q == 3) ? g : 0;
    i64 y = f.q == 1 ? -g : (f.q == 2 ? g : 0);
    i64 z = (i64)((u64)(i64)f.init_t << P.zshift);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const bool neg = z < 0;
      const i64 ys = y >> k, xs = x >> k;
      x = neg ? sub64(x, ys) : add64(x, ys);
      y = neg ? add64(y, xs) : sub64(y, xs);
      if (k < W - 1) z = neg ? add64(z, P.lut[k]) : sub64(z, P.lut[k]);
    }
    c = (int)(x >> P.oshift);
    ns = (int)(y >> P.oshift);
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

template <int F, int W, bool RAW>
__global__ void __launch_bounds__(kThreads)
ddc_mixer_kernel(void* __restrict__ out, const float* __restrict__ x, const DdcParams P) {
  const i64 i = (i64)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P.t) return;
  const i64 n = P.n0 + i;
  const unsigned nl = (unsigned)(u64)(n < 0 ? n + P.period : n);
  const unsigned ph = (nl * P.fw) & ((1u << P.pw) - 1);
  int c, ns;
  nco<F, W>(ph, P, c, ns);
  const i64 total = P.rows * P.t;
  for (i64 r = blockIdx.y; r < P.rows; r += gridDim.y) {
    const i64 e = r * P.t + i;
    const int xq = __float2int_rn(__fmul_rn(__ldg(x + e), kAmp));
    const int mi = (int)((unsigned)xq * (unsigned)c);
    const int mq = (int)((unsigned)xq * (unsigned)ns);
    if constexpr (RAW) {
      int* o = static_cast<int*>(out);
      o[e] = mi;
      o[total + e] = mq;
    } else {
      float* o = static_cast<float*>(out);
      o[e] = __fmul_rn(__int2float_rn(mi), P.scale);
      o[total + e] = __fmul_rn(__int2float_rn(mq), P.scale);
    }
  }
}

typedef void (*MixerKernel)(void*, const float*, DdcParams);

template <int F, int W>
MixerKernel pick_raw(bool raw) {
  return raw ? ddc_mixer_kernel<F, W, true> : ddc_mixer_kernel<F, W, false>;
}

template <int F, int W>
MixerKernel pick_width(int w, bool raw) {
  if constexpr (W > kMaxW) {
    return nullptr;
  } else {
    return w == W ? pick_raw<F, W>(raw) : pick_width<F, W + 1>(w, raw);
  }
}

MixerKernel mixer_kernel(int flavor, int w, bool raw) {
  if (flavor == kDds48) return pick_width<kDds48, kMinW>(w, raw);
  if (flavor == kScaled) return pick_width<kScaled, kMinW>(w, raw);
  return nullptr;
}

}  // namespace

extern "C" {

// out: (2, rows, t) float32 (raw = 0) or int32 (raw = 1); x: (rows, t)
// float32, both contiguous.  lut: nlut = W - 1 z steps; gain, zshift and
// oshift of the flavor at (PW, W) (kernels/ddc_kernel.py:mixer_constants).
int bhw_ddc_mixer(void* out, const float* x, i64 rows, i64 t, i64 n0, i64 period, unsigned fw,
                  int pw, int w, int flavor, const i64* lut, int nlut, i64 gain, int zshift,
                  int oshift, float scale, int raw, void* stream) {
  const MixerKernel kern = mixer_kernel(flavor, w, raw != 0);
  if (!kern || pw < 4 || pw > 31 || nlut != w - 1 || rows < 1 || t < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const i64 zmax = flavor == kDds48 ? 48 : 31;
  if (zshift < 0 || zshift > zmax - pw || oshift < 0 || oshift > 47) {
    return (int)cudaErrorInvalidValue;
  }
  DdcParams P;
  for (int k = 0; k < kMaxW; ++k) P.lut[k] = k < nlut ? lut[k] : 0;
  P.gain = gain;
  P.n0 = n0;
  P.period = period;
  P.t = t;
  P.rows = rows;
  P.fw = fw & ((1u << pw) - 1);
  P.pw = pw;
  P.zshift = zshift;
  P.oshift = oshift;
  P.scale = scale;
  const i64 bx = (t + kThreads - 1) / kThreads;
  if (bx > INT_MAX) return (int)cudaErrorInvalidValue;
  const i64 want = (kTargetBlocks + bx - 1) / bx;  // row groups a short row needs
  const unsigned by = (unsigned)(rows < want ? rows : want);
  kern<<<dim3((unsigned)bx, by), kThreads, 0, (cudaStream_t)stream>>>(out, x, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
