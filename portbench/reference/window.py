"""The quantized cosine-sum window under the HLS contract, in plain int64.

A frozen copy of the fixed-point math of ``hls/windows/win_function.cpp``
(upstream ``hukenovs/blackman_harris_win``): the coefficients quantized as
``round(a_k * (2^(W-shift) - 1))``; per harmonic k the phase (k n) mod
2^PW into a CORDIC of W iterations on a W+2-bit wrapping state, seeded
with 2^48 (1/K)/4, with its quadrant fixed at the output; then
``w[n] = a0 - (a1 cos_1 >> (W-2)) + (a2 cos_2 >> (W-2)) - ...``, wrapped
or clamped to W bits.

``state_bits`` narrows the CORDIC state below W+2 bits: the control, a
datapath one step narrower than the contract states.
"""

from __future__ import annotations

import torch

#: published cosine-sum coefficients a0..aK and the quantization headroom
#: ``shift`` (1 for 2..4 terms, 2 for 5 and 7): README.md:30-41,
#: hls/windows/win_function.cpp:176,349
PUBLISHED = {
    "bh4": ((0.35875, 0.48829, 0.14128, 0.01168), 1),
    "bh7": ((0.271220360585039, 0.433444612327442, 0.218004122892930,
             0.065785343295606, 0.010761867305342, 0.000770012710581,
             0.000013680883060), 2),
}

#: round(atan(2^-i) * 2^48 / pi), i = 0..47 (win_function.cpp:59-72)
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
#: (1/K)/4 * 2^48, K the CORDIC gain (win_function.cpp)
GAIN48_QUARTER = 0x26DD3B6A10D8


def _wrap_int(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    v = v & ((1 << bits) - 1)
    return torch.where(v >> (bits - 1) != 0, v - (1 << bits), v)


def quantized(name: str, data_width: int) -> tuple[int, ...]:
    coeffs, shift = PUBLISHED[name]
    return tuple(int(round(a * (2.0 ** (data_width - shift) - 1.0))) for a in coeffs)


def scale(name: str, data_width: int) -> float:
    """The float value of one LSB of the quantized window."""
    return 1.0 / (2.0 ** (data_width - PUBLISHED[name][1]) - 1.0)


def cordic_cos(phase: torch.Tensor, pw: int, w: int, state_bits: int | None = None):
    """The HLS CORDIC cosine (amplitude about 2^(W-2)) at int64 phases."""
    iw = state_bits or w + 2
    luts = [_wrap_int((LUT_ATAN_PI[i] >> (47 - w)) & 0xFFFFFFFFFF, w + 2) for i in range(w - 1)]
    un = phase & ((1 << pw) - 1)
    q = un >> (pw - 2)
    sphi = torch.where(un >> (pw - 1) != 0, un - (1 << pw), un)
    t = sphi & ~(3 << (pw - 2))
    z = _wrap(t << (w - pw + 2), iw) if pw - 1 < w else _wrap((t >> (pw - w)) << 2, iw)
    x = torch.full_like(un, _wrap_int(GAIN48_QUARTER >> (46 - w), iw))
    y = torch.zeros_like(un)
    for k in range(w):
        sub = z >= 0
        ys, xs = y >> k, x >> k
        x, y = (_wrap(torch.where(sub, x - ys, x + ys), iw),
                _wrap(torch.where(sub, y + xs, y - xs), iw))
        if k < w - 1:
            z = _wrap(torch.where(z < 0, z + luts[k], z - luts[k]), iw)
    c, s = x >> 2, y >> 2
    c = torch.where(q == 0, c, torch.where(q == 1, -s, torch.where(q == 2, -c, s)))
    return _wrap(c, w)


def window(n: torch.Tensor, name: str, pw: int, w: int, overflow: str,
           state_bits: int | None = None) -> torch.Tensor:
    """Window samples at int64 indices ``n`` as int64."""
    q = quantized(name, w)
    acc = torch.full_like(n, q[0])
    for k in range(1, len(q)):
        m = (q[k] * cordic_cos(k * n, pw, w, state_bits)) >> (w - 2)
        acc = acc - m if k % 2 else acc + m
    if overflow == "saturate":
        return acc.clamp(-(1 << (w - 1)), (1 << (w - 1)) - 1)
    return _wrap(acc, w)


def window_range(n0: int, length: int, name: str, pw: int, w: int, overflow: str,
                 device, state_bits: int | None = None, block: int = 1 << 23):
    """Samples [n0, n0 + length) as int32 on ``device``, in blocks."""
    out = torch.empty(length, dtype=torch.int32, device=device)
    for a in range(0, length, block):
        n = torch.arange(n0 + a, n0 + min(a + block, length), device=device)
        out[a:a + n.numel()] = window(n, name, pw, w, overflow, state_bits).to(torch.int32)
    return out
