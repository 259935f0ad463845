"""Vectorized fixed-point CORDIC engines on torch int64 lanes (counterpart of
``blackman_harris_win_tpu/kernels/cordic.py``, ``hls`` and ``dds`` flavors).

The reference unrolls the W iterations into pipeline stages at one
sample/clock (``src/cordic_dds.vhd:184-216``); here the iterations unroll
into a sequence of tensor ops while the sample axis is the vectorized axis.
int64 lanes hold every state (at most W+P <= 49 bits) exactly, so the JAX
package's int32 two-limb datapaths have no counterpart here.  Phases are
taken mod 2^phase_width; any input shape.  These functions are the plain
reference math of the window kernel (``window_kernel.py``).
"""

from __future__ import annotations

import torch

from ..core.config import CordicSpec
from ..core.fixedpoint import wrap
from ..core.luts import GAIN48_HALF, GAIN48_QUARTER, LUT_ATAN_PI, hls_atan_lut


def _as_i64(phase) -> torch.Tensor:
    return torch.as_tensor(phase, dtype=torch.int64)


def _rotate(x, y, z, luts, n_xy: int, n_z: int, iw: int):
    """Shared unrolled iteration core of the output-side flavors
    (hls/dds: z < 0 => x += y >> k), all registers iw bits wide."""
    for k in range(n_xy):
        neg = z < 0
        ys, xs = y >> k, x >> k
        x, y = (
            wrap(torch.where(neg, x + ys, x - ys), iw),
            wrap(torch.where(neg, y - xs, y + xs), iw),
        )
        if k < n_z:
            lk = luts[k]
            z = wrap(torch.where(neg, z + lk, z - lk), iw)
    return x, y, z


def _quadrant_fix_out(q, out_c, out_s, w: int):
    """Output-side quadrant correction (two's-complement negation):
    hls/windows/win_function.cpp:135-150 / src/cordic_dds.vhd:232-246."""
    nc, ns = -out_c, -out_s
    c = torch.where(q == 0, out_c, torch.where(q == 1, ns, torch.where(q == 2, nc, out_s)))
    s = torch.where(q == 0, out_s, torch.where(q == 1, out_c, torch.where(q == 2, ns, nc)))
    return wrap(c, w), wrap(s, w)


def _not_ported(flavor: str) -> NotImplementedError:
    return NotImplementedError(
        f"CORDIC flavor {flavor!r} is not ported yet (ROADMAP.md queue 1 item 2)"
    )


def cordic_constants(spec: CordicSpec) -> tuple[list[int], int]:
    """The atan LUT and the seed gain of an ``hls`` or ``dds`` generator,
    which the CUDA window kernel also takes as parameters."""
    w, p = spec.data_width, spec.precision
    if spec.flavor == "hls":
        # lut[i] = (LUT_ATAN_PI[i] >> (48-W-1)) & 0xFFFFFFFFFF into
        # ap_int<W+2> (win_function.cpp:78)
        return hls_atan_lut(w), GAIN48_QUARTER >> (46 - w)
    if spec.flavor == "dds":  # src/cordic_dds.vhd:97-117 at W+P bits
        lut = [LUT_ATAN_PI[i] >> (49 - w - p) for i in range(w - 1)]
        return lut, GAIN48_HALF >> (49 - w - p)
    raise _not_ported(spec.flavor)


def cordic_sincos(phase, spec: CordicSpec):
    """Dispatch by flavor.  Returns ``(cos, sin)`` signed data_width-bit
    values in int64 tensors."""
    if spec.flavor == "hls":
        return cordic_hls(phase, spec)
    if spec.flavor == "dds":
        return cordic_dds(phase, spec)
    raise _not_ported(spec.flavor)


def cordic_hls(phase, spec: CordicSpec):
    """HLS win_function flavor (hls/windows/win_function.cpp:47-156):
    W+2-bit wrapping state, 2^48/pi LUT, output-side quadrant fix.
    Amplitude ~2^(W-2)."""
    pw, w = spec.phase_width, spec.data_width
    iw = w + 2
    luts, gain = cordic_constants(spec)

    un = _as_i64(phase) & ((1 << pw) - 1)
    q = un >> (pw - 2)
    # init_t = signed(phi) & ~(3 << (pw-2)) at full phase width
    # (model/golden.py cordic_hls has the ap_int<W+2> deviation note)
    sphi = torch.where(un >> (pw - 1) != 0, un - (1 << pw), un)
    init_t = sphi & ~(0x3 << (pw - 2))
    if pw - 1 < w:
        init_z = wrap(init_t << (w - pw + 2), iw)
    else:
        init_z = wrap((init_t >> (pw - w)) << 2, iw)

    x = torch.full_like(un, gain)
    y = torch.zeros_like(un)
    x, y, _ = _rotate(x, y, init_z, luts, w, w - 1, iw)
    return _quadrant_fix_out(q, x >> 2, y >> 2, w)


def cordic_dds(phase, spec: CordicSpec):
    """Main VHDL flavor (src/cordic_dds.vhd): W+P-bit state, PRECISION guard
    bits, W-1 iterations, output-side quadrant fix.  Amplitude ~2^(W-2)."""
    pw, w, p = spec.phase_width, spec.data_width, spec.precision
    iw = w + p
    luts, gain = cordic_constants(spec)

    un = _as_i64(phase) & ((1 << pw) - 1)
    q = un >> (pw - 2)
    init_t = un & ((1 << (pw - 2)) - 1)  # "00" & low bits (vhd:179)
    if pw >= w:
        init_z = (init_t >> (pw - w)) << p
    else:
        init_z = init_t << (w - pw + p)

    x = torch.full_like(un, gain)
    y = torch.zeros_like(un)
    x, y, _ = _rotate(x, y, init_z, luts, w - 1, w - 1, iw)
    return _quadrant_fix_out(q, wrap(x >> p, w), wrap(y >> p, w), w)
