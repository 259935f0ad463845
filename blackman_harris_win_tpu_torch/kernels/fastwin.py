"""Second-order-Taylor fast window path ("taylor2"), the -180 dB fast mode
(counterpart of ``blackman_harris_win_tpu/kernels/fastwin.py``).

The reference's LUT+Taylor generator (``src/taylor_sincos.vhd`` +
``src/tay1_order.vhd``) re-sized for the -180 dB regime (W=32): a 2^LS-entry
quarter-wave ROM at amplitude 2^(W-2) plus a SECOND-order correction

    cos(t + d) = cos t - d*sin t - d^2/2 * cos t
    sin(t + d) = sin t + d*cos t - d^2/2 * sin t

The JAX package evaluates it on int32 lanes with exact 15-bit-limb
multiply-shifts (``limb.mul_shift30``); each is an exact floor
``(a*c) >> s`` and is one int64 product and shift here.  Where the JAX
function adds in int32, the sum is wrapped to 32 bits.  Error <= ~3 LSB at
amplitude 2^30; NOT bit-exact vs the CORDIC path, validated spectrally:
BH-7 W=32 keeps its -180 dB sidelobe floor.  No Pallas kernel exists for
it; it runs in torch ops on the device of its input.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.config import WindowSpec
from ..core.fixedpoint import wrap

# Default quarter-wave ROM depth: 2^12 x 2 x int32 = 32 KiB.
DEFAULT_LUT_SIZE = 12


@lru_cache(maxsize=16)
def _rom_q(lut_size: int, data_width: int) -> np.ndarray:
    """Quarter-wave (cos, sin) ROM at amplitude 2^(data_width-2) - 1 — the
    CORDIC flavors' amplitude (hls/windows/win_function.cpp:130), so taylor2
    drops into the same window product/accumulate datapath."""
    n = 1 << lut_size
    ang = np.arange(n) * (math.pi / (2.0 * n))
    amp = 2.0 ** (data_width - 2) - 1.0
    cos_e = np.floor(amp * np.cos(ang) + 0.5).astype(np.int64)
    sin_e = np.floor(amp * np.sin(ang) + 0.5).astype(np.int64)
    return np.stack([cos_e, sin_e], axis=-1).astype(np.int32)


def _phase_consts(pw: int, ls: int):
    """Split fixed-point representation of the per-residual-count angle:
    d ~= delta * 2^S with S = ls + 29, P = (pi/2)*2^(29-rb) split into an
    integer part and a 12-bit fractional part (rb = pw-2-ls)."""
    rb = pw - 2 - ls
    s = ls + 29
    p_exact = (math.pi / 2.0) * (2.0 ** (29 - rb))
    p_hi = int(math.floor(p_exact))
    p_lo = int(math.floor((p_exact - p_hi) * 4096.0 + 0.5))
    return s, p_hi, p_lo, rb


def cos_sin_taylor2(p, pw: int, w: int, ls: int = DEFAULT_LUT_SIZE):
    """(cos, sin) at integer phases ``p`` (period 2^pw), amplitude
    2^(w-2)-1, as int64 tensors on ``p``'s device.  w <= 32."""
    if w > 32:
        raise ValueError("taylor2 path supports data_width <= 32")
    if ls > 14:
        raise ValueError("lut_size > 14 would overflow the d-scale headroom")
    p = torch.as_tensor(p, dtype=torch.int64) & ((1 << pw) - 1)
    q = p >> (pw - 2)
    ph = p & ((1 << (pw - 2)) - 1)

    rom = torch.from_numpy(_rom_q(ls, w).astype(np.int64)).to(p.device)
    rb = pw - 2 - ls

    if rb <= 0:
        ent = rom[ph if rb == 0 else ph << (-rb)]
        mc, ms = ent[..., 0], ent[..., 1]
    else:
        ent = rom[ph >> rb]
        acnt = ph & ((1 << rb) - 1)
        c0, s0 = ent[..., 0], ent[..., 1]

        s, p_hi, p_lo, _ = _phase_consts(pw, ls)
        # d = delta * 2^s, exact to ~2^-12 counts (acnt*p_lo < 2^(rb+12))
        d = acnt * p_hi
        if p_lo and rb + 12 <= 31:
            d = d + ((acnt * p_lo) >> 12)
        dh = d >> 15
        e = dh * dh
        # first-order: -+ d*{sin,cos} >> s; second-order: - e*{cos,sin}/2
        mc = wrap(c0 - ((d * s0) >> s) - ((e * c0) >> (2 * s - 29)), 32)
        ms = wrap(s0 + ((d * c0) >> s) - ((e * s0) >> (2 * s - 29)), 32)

    c = torch.where(q == 0, mc, torch.where(q == 1, -ms, torch.where(q == 2, -mc, ms)))
    sn = torch.where(q == 0, ms, torch.where(q == 1, mc, torch.where(q == 2, -ms, -mc)))
    return wrap(c, 32), wrap(sn, 32)


def window_values_fast(n, coeffs_q, spec: WindowSpec):
    """Quantized cosine-sum window at indices ``n`` via the taylor2
    generators, as int64 on ``n``'s device.  HLS accumulate semantics
    (w[n] = a0 - m1 + m2 - ..., m_k = (a_k * cos_k) >> (W-2),
    hls/windows/win_function.cpp:361-375) in the JAX package's int32
    accumulator; at W=32 that accumulator is the output, so "saturate" does
    not clamp there (the JAX function's behaviour, kept)."""
    if spec.rounding != "hls":
        raise NotImplementedError("taylor2 implements HLS rounding")
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    coeffs_q = tuple(int(c) for c in coeffs_q)
    amax = max(abs(c) for c in coeffs_q)
    if amax >= 1 << 30:
        raise ValueError(
            "taylor2 window path needs |coeffs| < 2^30 (5/7-term headroom "
            "quantization, win_function.cpp:349-355)"
        )
    mask = (1 << pw) - 1
    n = torch.as_tensor(n, dtype=torch.int64)
    acc = torch.full(n.shape, coeffs_q[0], dtype=torch.int64, device=n.device)
    for k in range(1, len(coeffs_q)):
        c, _ = cos_sin_taylor2((k * n) & mask, pw, w, ls)
        m = (coeffs_q[k] * c) >> (w - 2)
        acc = acc - m if k % 2 == 1 else acc + m
    acc = wrap(acc, 32)  # the int32 accumulator
    if spec.overflow == "saturate" and w < 32:
        return torch.clamp(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    return wrap(acc, w)  # w == 32: the int32 wrap IS the win_t cast
