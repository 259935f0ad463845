"""Quarter-wave-LUT + 1st-order-Taylor sine/cosine, the TAYLOR source
(counterpart of ``blackman_harris_win_tpu/kernels/taylor.py``).

The reference's ``src/taylor_sincos.vhd`` + ``src/tay1_order.vhd``: a
quarter-wave ROM of (cos, sin) entries at amplitude 2^(W-1)-1 (full scale,
twice the CORDIC flavors'), read at the high phase bits, and a first-order
correction from the residual count through the DSP48 MACCs.  Bit-exact
against ``model/golden.py:taylor_sincos``.

The per-width arithmetic split is faithful: W<19 accumulates in the wide
(48-bit DSP P) domain then slices; W>=19 slices the product first, adds in W
bits, and clamps negative results to +max ("scale overflow",
tay1_order.vhd:601-617).

``taylor_sincos`` is the indexed reference math on int64 lanes, on any
device: each of the JAX package's int32 limb products (``limb.mul_shift30``,
``mul_small_shift``, ``mul_wide_parts31``) is an exact floor ``(a*c) >> s``,
which is one int64 product and one arithmetic shift here.  The block
functions produce consecutive samples through the Taylor kernel's wrappers
(``taylor_kernel``): the CUDA kernel for a CUDA device, its plain version on
the CPU.  The kernel indexes every sample itself, so the blocks need none of
the JAX blocked form's R-alignment or per-call row bound.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.fixedpoint import wrap


@lru_cache(maxsize=32)
def _rom(lut_size: int, data_width: int):
    """Quarter-wave ROM: (2^LS, 2) array of (cos, sin) entries
    (src/taylor_sincos.vhd:91-109), built on the host in float64 exactly as
    the JAX package builds it."""
    n = 1 << lut_size
    ii = np.arange(n)
    ang = ii * math.pi / (2.0 * n)
    amp = 2.0 ** (data_width - 1) - 1.0
    cos_e = np.floor(amp * np.cos(ang) + 0.5).astype(np.int64)
    sin_e = np.floor(amp * np.sin(ang) + 0.5).astype(np.int64)
    dt = np.int32 if data_width <= 32 else np.int64
    return np.stack([cos_e, sin_e], axis=-1).astype(dt)


def check_widths(phase_width: int, data_width: int, lut_size: int) -> None:
    """The generator's static guards (the JAX package's, plus the bounds the
    int64 lanes need)."""
    if lut_size >= phase_width:
        raise ValueError("LUT_SIZE must be < PHASE_WIDTH (src/win_selector.vhd:68)")
    if data_width > 32:
        # the reference's DSP48 MACC datapaths top out at 32-bit outputs
        raise ValueError("taylor_sincos supports data_width <= 32")
    if not 2 <= data_width or not 2 <= phase_width <= 62 or lut_size < 0:
        raise ValueError("taylor needs 2 <= data_width, 2 <= phase_width <= 62, lut_size >= 0")


def ramb_pi(stage: int) -> int:
    """The correction's phase constant round(pi * 2^(17-STAGE))
    (src/tay1_order.vhd:112)."""
    return int(math.floor(math.pi * 2.0 ** (17 - stage) + 0.5))


def _tay1(cos_v, sin_v, acnt, stage: int, val_shift: int, w: int):
    """1st-order correction (src/tay1_order.vhd); see golden.tay1_correction.
    ``mpi * x`` stays below pi*2^18 * 2^31, so int64 holds every product."""
    xshift = 19 + val_shift
    mpi = ramb_pi(stage) * acnt
    if w < 19:
        # 48-bit accumulate then slice (no saturation), tay1_order.vhd:180-504:
        # (cos<<X - mpi*sin) >> X == cos + ((mpi*(-sin)) >> X)
        return (wrap(cos_v + ((mpi * -sin_v) >> xshift), w),
                wrap(sin_v + ((mpi * cos_v) >> xshift), w))
    # W>=19: product sliced to W bits first, W-bit add (wrap), clamp
    # negatives to +max ("scale overflow", tay1_order.vhd:601-617)
    bb_sin = wrap((mpi * sin_v) >> xshift, w)
    bb_cos = wrap((mpi * cos_v) >> xshift, w)
    cos_p = wrap(cos_v - bb_sin, w)
    sin_p = wrap(sin_v + bb_cos, w)
    clamp = (1 << (w - 1)) - 1
    return (torch.where(cos_p < 0, clamp, cos_p),
            torch.where(sin_p < 0, clamp, sin_p))


def taylor_sincos(n, phase_width: int, data_width: int, lut_size: int):
    """(cos, sin) at sample indices ``n`` (any shape; reduced mod 2^PW) as
    int64 tensors on ``n``'s device."""
    pw, w, ls = phase_width, data_width, lut_size
    check_widths(pw, w, ls)
    cnt = torch.as_tensor(n, dtype=torch.int64) & ((1 << pw) - 1)
    rom = torch.from_numpy(_rom(ls, w).astype(np.int64)).to(cnt.device)
    quadrant = cnt >> (pw - 2)
    ph = cnt & ((1 << (pw - 2)) - 1)

    if pw - ls < 2:  # over-wide LUT: top-aligned address (vhd:159-160)
        ent = rom[ph << (ls - pw + 2)]
        mem_cos, mem_sin = ent[..., 0], ent[..., 1]
    elif pw - ls == 2:  # exact quarter-wave LUT
        ent = rom[ph]
        mem_cos, mem_sin = ent[..., 0], ent[..., 1]
    else:
        ent = rom[ph >> (pw - ls - 2)]
        acnt = ph & ((1 << (pw - ls - 2)) - 1)
        mem_cos, mem_sin = _tay1(ent[..., 0], ent[..., 1], acnt, pw - ls - 3, ls, w)

    nc, ns = wrap(-mem_cos, w), wrap(-mem_sin, w)
    c = torch.where(quadrant == 0, mem_cos,
                    torch.where(quadrant == 1, ns, torch.where(quadrant == 2, nc, mem_sin)))
    s = torch.where(quadrant == 0, mem_sin,
                    torch.where(quadrant == 1, mem_cos, torch.where(quadrant == 2, ns, nc)))
    return c, s


def taylor_sincos_block(n0, count: int, phase_width: int, data_width: int,
                        lut_size: int, device=None):
    """(cos, sin) over the consecutive index block [n0, n0 + count) as int32
    (count,) tensors on ``device``, bit-exact vs :func:`taylor_sincos`."""
    from .taylor_kernel import sincos_block

    return sincos_block(n0, count, phase_width, data_width, lut_size, device)


def taylor_window_block(n0, count: int, coeffs_q, spec, device=None):
    """TAYLOR-source window block [n0, n0+count) as int32 on ``device`` —
    bit-exact vs ``window_samples`` with ``sin_type="taylor"`` (HLS
    rounding, 2/3-term only; the reference doubles harmonic frequency by
    instantiating the generator one phase bit narrower,
    src/bh_win_3term.vhd:221-233).  At W=32 "saturate" clamps the exact sum,
    as the JAX package's overflow tracking does."""
    from .taylor_kernel import window_block

    return window_block(coeffs_q, spec, n0, count, device)


def taylor_window_range(n0, count: int, coeffs_q, spec, device=None):
    """:func:`taylor_window_block` over an arbitrary range: the JAX package
    chunks it for its per-call row bound, which the port's kernel does not
    have, so this is one block."""
    return taylor_window_block(n0, count, coeffs_q, spec, device)
