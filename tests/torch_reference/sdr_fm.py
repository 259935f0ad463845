"""The FM-band monitor's chain in plain torch: a polyphase DFT channelizer in
float64, the I/Q quantizer and the conjugate-product FM discriminator with
its vectoring CORDIC atan2, written from the contract.

Independent of the code under test: it imports nothing of the program and
nothing of JAX, and takes nothing the program made.

- :func:`channelize`: Y[m, k] = sum_p e^{-j 2 pi p k / C} sum_t h_p[t]
  x[(m - t) C + p] with h_p[t] = h[t C + p], over the frames whose taps
  all lie in the capture (frame m of the output is frame m + T - 1 of the
  formula, T taps a branch): the branch FIRs as T shifted products, the DFT
  as a product with the C x C matrix of its twiddles, every step in
  complex128, in blocks of frames.  TF32 is off while it runs.
- :func:`quantize`: round(y * iq_scale) (half to even) to int32 I and Q.
- :func:`conj_products`: the discriminator's engine inputs.  The I/Q are
  ``IQ_WIDTH`` = 16-bit words, re-quantized by >> drop (drop = IQ_WIDTH -
  15) and wrapped to 32 bits; z[m+1] conj(z[m]) = (i1 i0 + q1 q0) + j (q1
  i0 - i1 q0), each wrapped to 32 bits, then >> shift (shift = 2 (IQ_WIDTH
  - drop) - (AW - 1)) into the engine's AW-1 bit range.
- :func:`atan2`: the vectoring CORDIC in the standard atan2 convention:
  the quadrant from bit AW-1 of x and y, the one's-complement abs of their
  low AW-1 bits, AW-1 iterations on an AW+1 bit state wrapped after every
  add, z stepped by LUT_ATAN_PI[i] >> (48 - AW), then wrap(z >> 1, AW)
  and the quadrant fix; pi is 2^(AW-1).
- :func:`discriminate` and :func:`sdr_chain`: the whole chain, its output
  (n_frames - 1, C) int64 angle LSBs a frame, the instantaneous frequency
  of each channel.
- :func:`angle_budget`: how far an output can move when the I/Q it reads
  move by 1 LSB, the reach of a float32 channelizer under this contract.

:func:`channelize_tf32` is the control: the same channelizer in float32
with the capture and the taps rounded to TF32 (10 mantissa bits, round to
nearest even), the operands a TF32 convolution would take, and a float32
DFT: one precision step below the float32 with TF32 off that the chain
states.
"""

from __future__ import annotations

import math

import torch

#: the width of the quantized channel I/Q
IQ_WIDTH = 16
#: round(atan(2^-i) * 2^48 / pi), i = 0..47
LUT_ATAN_PI = (
    0x400000000000, 0x25C80A3B3BE6, 0x13F670B6BDC7, 0x0A2223A83BBB,
    0x05161A861CB1, 0x028BAFC2B209, 0x0145EC3CB850, 0x00A2F8AA23A9,
    0x00517CA68DA2, 0x0028BE5D7661, 0x00145F300123, 0x000A2F982950,
    0x000517CC19C0, 0x00028BE60D83, 0x000145F306D6, 0x0000A2F9836D,
    0x0000517CC1B7, 0x000028BE60DC, 0x0000145F306E, 0x00000A2F9837,
    0x00000517CC1B, 0x0000028BE60E, 0x00000145F307, 0x000000A2F983,
    0x000000517CC2, 0x00000028BE61, 0x000000145F30, 0x0000000A2F98,
    0x0000000517CC, 0x000000028BE6, 0x0000000145F3, 0x00000000A2FA,
    0x00000000517D, 0x0000000028BE, 0x00000000145F, 0x000000000A30,
    0x000000000518, 0x00000000028C, 0x000000000146, 0x0000000000A3,
    0x000000000051, 0x000000000029, 0x000000000014, 0x00000000000A,
    0x000000000005, 0x000000000003, 0x000000000001, 0x000000000000,
)


def wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of int64 values to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((v + half) & ((1 << bits) - 1)) - half


def conj_shifts(angle_width: int) -> tuple[int, int]:
    """(drop, shift) of the discriminator at ``IQ_WIDTH``."""
    drop = max(0, IQ_WIDTH - 15)
    return drop, max(0, 2 * (IQ_WIDTH - drop) - (angle_width - 1))


def _twiddles(c: int, dtype, device) -> torch.Tensor:
    """W[p, k] = e^{-j 2 pi p k / C}, the product p k reduced mod C first."""
    p = torch.arange(c, dtype=torch.int64, device=device)
    ang = (p[:, None] * p[None, :] % c).to(torch.float64) * (-2.0 * math.pi / c)
    return torch.polar(torch.ones_like(ang), ang).to(dtype)


def _branches_then_dft(xb: torch.Tensor, hp: torch.Tensor, w: torch.Tensor, block: int):
    """(frames, C) branch samples, (taps, C) branch taps, (C, C) twiddles ->
    (frames - taps + 1, C) channels, in blocks of frames."""
    tpb = hp.shape[0]
    nf = xb.shape[0] - tpb + 1
    out = torch.empty((nf, xb.shape[1]), dtype=w.dtype, device=xb.device)
    for a in range(0, nf, block):
        b = min(nf, a + block)
        v = hp[0] * xb[a + tpb - 1:b + tpb - 1]
        for t in range(1, tpb):
            v = v + hp[t] * xb[a + tpb - 1 - t:b + tpb - 1 - t]
        out[a:b] = v @ w
    return out


class _NoTf32:
    """TF32 off for matmuls and convolutions while inside; both flags
    restored on leaving."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def _check(x: torch.Tensor, h: torch.Tensor, c: int) -> None:
    if h.numel() % c or x.numel() % c:
        raise ValueError("the capture and the prototype must be whole multiples of C")


def channelize(x: torch.Tensor, h, c: int, block: int = 1 << 16) -> torch.Tensor:
    """The channels of capture ``x`` (T,) by prototype ``h`` (C * taps,),
    complex128 (n_frames, C), n_frames = T / C - taps + 1, on x's device."""
    h = torch.as_tensor(h, dtype=torch.float64, device=x.device)
    _check(x, h, c)
    with _NoTf32():
        xb = x.to(torch.complex128).reshape(-1, c)
        hp = h.reshape(-1, c).to(torch.complex128)
        return _branches_then_dft(xb, hp, _twiddles(c, torch.complex128, x.device), block)


def to_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest even."""
    b = v.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def channelize_tf32(x: torch.Tensor, h, c: int, block: int = 1 << 16) -> torch.Tensor:
    """The control: :func:`channelize` in float32 with the capture and the
    taps rounded to TF32 first, complex64 out."""
    h = torch.as_tensor(h, dtype=torch.float64, device=x.device)
    _check(x, h, c)
    xc = x.to(torch.complex64).reshape(-1, c)
    xb = torch.complex(to_tf32(xc.real), to_tf32(xc.imag))
    hp = to_tf32(h.to(torch.float32).reshape(-1, c)).to(torch.complex64)
    return _branches_then_dft(xb, hp, _twiddles(c, torch.complex64, x.device), block)


def quantize(y: torch.Tensor, iq_scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """round(y * iq_scale), half to even, as int32 I and Q."""
    return (torch.round(y.real * iq_scale).to(torch.int32),
            torch.round(y.imag * iq_scale).to(torch.int32))


def _engine_inputs(i0, q0, i1, q1, shift: int):
    """(y, x): the conjugate product z1 conj(z0) of re-quantized words,
    each part wrapped to 32 bits, >> shift."""
    re = wrap(i1 * i0 + q1 * q0, 32)
    im = wrap(q1 * i0 - i1 * q0, 32)
    return im >> shift, re >> shift


def conj_products(i: torch.Tensor, q: torch.Tensor, angle_width: int):
    """(y, x) int64 engine inputs of the discriminator of I/Q (..., n, C):
    each (..., n - 1, C), from frames m and m + 1."""
    drop, shift = conj_shifts(angle_width)
    i15 = wrap(i.to(torch.int64) >> drop, 32)
    q15 = wrap(q.to(torch.int64) >> drop, 32)
    return _engine_inputs(i15[..., :-1, :], q15[..., :-1, :], i15[..., 1:, :], q15[..., 1:, :],
                          shift)


def atan2(y: torch.Tensor, x: torch.Tensor, angle_width: int) -> torch.Tensor:
    """The vectoring CORDIC atan2(y, x) of AW-bit int64 words (input width
    AW, precision 1), int64 angle LSBs in [-2^(AW-1), 2^(AW-1))."""
    aw = angle_width
    iw = aw + 1
    sx = (x >> (aw - 1)) & 1
    sy = (y >> (aw - 1)) & 1
    mask = (1 << (aw - 1)) - 1
    xx = (x ^ -sx) & mask
    yy = (y ^ -sy) & mask
    z = torch.zeros_like(xx)
    for i in range(aw - 1):
        step = LUT_ATAN_PI[i] >> (48 - aw)
        pos = yy >= 0
        ys, xs = yy >> i, xx >> i
        xx, yy = (wrap(torch.where(pos, xx + ys, xx - ys), iw),
                  wrap(torch.where(pos, yy - xs, yy + xs), iw))
        z = wrap(torch.where(pos, z - step, z + step), iw)
    base = -wrap(z >> 1, aw)
    pi = 1 << (aw - 1)
    quad = (sx << 1) | sy
    out = torch.where(quad == 0, base, torch.where(quad == 1, -base,
                                                   torch.where(quad == 2, pi - base, base - pi)))
    return wrap(out, aw)


def discriminate(i: torch.Tensor, q: torch.Tensor, angle_width: int,
                 block: int = 1 << 16) -> torch.Tensor:
    """The conjugate-product discriminator of int I/Q (n, C): (n - 1, C)
    int64, in blocks of frames."""
    n = i.shape[0]
    out = torch.empty((max(n - 1, 0), i.shape[1]), dtype=torch.int64, device=i.device)
    for a in range(0, n - 1, block):
        b = min(n - 1, a + block)
        out[a:b] = atan2(*conj_products(i[a:b + 1], q[a:b + 1], angle_width), angle_width)
    return out


def sdr_chain(x: torch.Tensor, h, c: int, angle_width: int = 20,
              iq_scale: float = 2.0**14) -> torch.Tensor:
    """The whole chain of capture ``x``: (n_frames - 1, C) int64."""
    return discriminate(*quantize(channelize(x, h, c), iq_scale), angle_width)


def angle_budget(i: torch.Tensor, q: torch.Tensor, angle_width: int, m: torch.Tensor,
                 k: torch.Tensor, block: int = 1 << 22) -> torch.Tensor:
    """For the discriminator outputs (m, k) of int I/Q (n, C), output m of
    channel k reading frames m and m + 1: how far the output can move when
    each of I and Q at its two frames moves by at most 1 LSB, plus the
    CORDIC's own LSB; int64, one a pair (m, k).

    A word w that moves by at most 1 re-quantizes to (w - 1) >> drop or
    (w + 1) >> drop (for drop >= 1, w >> drop is one of the two), so the
    four words reach at most 16 re-quantized quadruples; each goes through
    the conjugate products, their >> shift and :func:`atan2`, and the
    widest gap (wrapped to +-2^(AW-1)) of those outputs from the unmoved
    one is the reach.  In blocks of ``block`` outputs."""
    drop, shift = conj_shifts(angle_width)
    if drop < 1:
        raise ValueError("the budget takes I/Q that are re-quantized (drop >= 1)")
    out = torch.empty(m.shape, dtype=torch.int64, device=i.device)
    for a in range(0, m.numel(), block):
        mb, kb = m[a:a + block], k[a:a + block]
        words = [t[f, kb].to(torch.int64) for f in (mb, mb + 1) for t in (i, q)]
        base = atan2(*_engine_inputs(*(wrap(w >> drop, 32) for w in words), shift),
                     angle_width)
        reach = torch.zeros_like(base)
        for moves in range(16):
            u = [wrap((w + (1 if moves >> j & 1 else -1)) >> drop, 32)
                 for j, w in enumerate(words)]
            moved = atan2(*_engine_inputs(*u, shift), angle_width)
            reach = torch.maximum(reach, wrap(moved - base, angle_width).abs())
        out[a:a + block] = reach + 1
    return out
