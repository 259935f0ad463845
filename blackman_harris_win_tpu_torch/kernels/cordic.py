"""Vectorized fixed-point CORDIC engines on torch int64 lanes (counterpart of
``blackman_harris_win_tpu/kernels/cordic.py``): the five rotation-mode
flavors and the vectoring-mode atan2.

The reference unrolls the W iterations into pipeline stages at one
sample/clock (``src/cordic_dds.vhd:184-216``); here the iterations unroll
into a sequence of tensor ops while the sample axis is the vectorized axis.
int64 lanes hold every state (at most 48 bits, or cmodel's unwrapped
64-bit C state) exactly, so the JAX package's int32 two-limb datapaths have
no counterpart here.  Phases are taken mod 2^phase_width; any input shape.
These functions are the plain reference math of the window kernel
(``window_kernel.py``) and the DDC's NCO (``pipeline/ddc.py``).  The atan2
(``cordic_atan2``, ``atan2_fixed``) dispatches by device: the atan2 kernel
(``demod_kernel.py``) for a CUDA tensor, its plain version here otherwise.
"""

from __future__ import annotations

import torch

from ..core.config import CordicSpec
from ..core.fixedpoint import wrap
from ..core.luts import (
    GAIN48_HALF,
    GAIN48_QUARTER,
    LUT_ATAN_2PI,
    LUT_ATAN_PI,
    hls_atan_lut,
    scaled_internal_width,
)


def _as_i64(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64)


def _rotate(x, y, z, luts, n_xy: int, n_z: int, iw_xy: int, iw_z: int,
            prerotated: bool = False):
    """Shared unrolled iteration core.  Sign convention: the output-side
    flavors (hls/cmodel/dds) take z < 0 => x += y >> k, the pre-rotated ones
    (dds48/scaled) z >= 0 => x += y >> k (src/cordic_dds48.vhd:234-242).
    x/y wrap at iw_xy bits, z at iw_z (64: cmodel's unwrapped C state)."""
    for k in range(n_xy):
        sub = (z < 0) if prerotated else (z >= 0)
        ys, xs = y >> k, x >> k
        x, y = (
            wrap(torch.where(sub, x - ys, x + ys), iw_xy),
            wrap(torch.where(sub, y + xs, y - xs), iw_xy),
        )
        if k < n_z:
            lk = luts[k]
            z = wrap(torch.where(z < 0, z + lk, z - lk), iw_z)
    return x, y, z


def _quadrant_select(q, out_c, out_s, nc, ns):
    """Output-side quadrant correction, given the negations to use."""
    c = torch.where(q == 0, out_c, torch.where(q == 1, ns, torch.where(q == 2, nc, out_s)))
    s = torch.where(q == 0, out_s, torch.where(q == 1, out_c, torch.where(q == 2, ns, nc)))
    return c, s


def _quadrant_fix_out(q, out_c, out_s, w: int):
    """Output-side quadrant correction (two's-complement negation):
    hls/windows/win_function.cpp:135-150 / src/cordic_dds.vhd:232-246."""
    c, s = _quadrant_select(q, out_c, out_s, -out_c, -out_s)
    return wrap(c, w), wrap(s, w)


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
    raise ValueError(f"the window generators take the hls and dds flavors, not {spec.flavor!r}")


def cordic_sincos(phase, spec: CordicSpec):
    """Dispatch by flavor.  Returns ``(cos, sin)`` signed data_width-bit
    values in int64 tensors (dds48/scaled: ``(cos, -sin)``, the reference's
    axis convention)."""
    fn = {
        "hls": cordic_hls,
        "cmodel": cordic_cmodel,
        "dds": cordic_dds,
        "dds48": cordic_dds48,
        "scaled": cordic_scaled,
    }[spec.flavor]
    return fn(phase, spec)


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
    x, y, _ = _rotate(x, y, init_z, luts, w, w - 1, iw, iw)
    return _quadrant_fix_out(q, x >> 2, y >> 2, w)


def cordic_cmodel(phase, spec: CordicSpec):
    """Plain C model flavor (cpp/cordic_sincos.cpp:10-92): 64-bit state (no
    wrap), 2^48/(2pi) LUT, one's-complement quadrant fix, then the int cast
    (wrap to 32 bits)."""
    pw, w, p = spec.phase_width, spec.data_width, spec.precision
    luts = [(LUT_ATAN_2PI[i] >> (48 - w - p)) & 0xFFFFFFFFFFFF for i in range(w - 1)]
    gain = GAIN48_QUARTER >> (48 - w - 2)

    un = _as_i64(phase) & ((1 << pw) - 1)
    q = un >> (pw - 2)
    init_t = un & ~(0x3 << (pw - 2)) & ((1 << pw) - 1)
    if pw - 1 < w:
        init_z = init_t << (w - pw + p)
    else:
        init_z = (init_t >> (pw - w)) << p

    x = torch.full_like(un, gain)
    y = torch.zeros_like(un)
    x, y, _ = _rotate(x, y, init_z, luts, w, w - 1, 64, 64)
    out_c, out_s = x >> 2, y >> 2
    c, s = _quadrant_select(q, out_c, out_s, ~out_c, ~out_s)  # cpp:75-85
    return wrap(c, 32), wrap(s, 32)


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
    x, y, _ = _rotate(x, y, init_z, luts, w - 1, w - 1, iw, iw)
    return _quadrant_fix_out(q, wrap(x >> p, w), wrap(y >> p, w), w)


def _prerotated_inputs(un, pw: int, gain: int, iw: int):
    """Quadrant pre-rotation shared by dds48/scaled
    (src/cordic_dds48.vhd:172-216): the start angle and vector."""
    q = un >> (pw - 2)
    low = un & ((1 << (pw - 2)) - 1)
    sphi = torch.where(un >> (pw - 1) != 0, un - (1 << pw), un)
    q03 = (q == 0) | (q == 3)
    init_t = torch.where(q03, sphi, torch.where(q == 1, low, low - (1 << (pw - 2))))
    zero = torch.zeros_like(un)
    x0 = torch.where(q03, torch.full_like(un, gain), zero)
    y0 = torch.where(q == 1, torch.full_like(un, wrap(-gain, iw)),
                     torch.where(q == 2, torch.full_like(un, gain), zero))
    return init_t, x0, y0


def cordic_dds48(phase, spec: CordicSpec):
    """Max-precision flavor (src/cordic_dds48.vhd): 48-bit x/y/z state,
    input-side pre-rotation, W x/y iterations, no output fix.

    Axis convention quirk of the reference: DT_COS is the true cosine;
    DT_SIN carries -sin (the window cores only consume DT_COS; the DDC's
    mixer uses it as the downconversion phase)."""
    pw, w = spec.phase_width, spec.data_width
    luts = list(LUT_ATAN_2PI[: w - 1])
    un = _as_i64(phase) & ((1 << pw) - 1)
    init_t, x0, y0 = _prerotated_inputs(un, pw, GAIN48_QUARTER, 48)
    init_z = wrap(init_t << (48 - pw), 48)
    x, y, _ = _rotate(x0, y0, init_z, luts, w, w - 1, 48, 48, prerotated=True)
    return wrap(x >> (48 - w), w), wrap(y >> (48 - w), w)


def cordic_scaled(phase, spec: CordicSpec):
    """Empirical-width flavor (src/cordic_dds_scaled.vhd): x/y width from
    SEL_SIZE, z width max(SIZE, PW), input-side pre-rotation (the dds48
    axis convention: the second output is -sin)."""
    pw, w = spec.phase_width, spec.data_width
    size = scaled_internal_width(w)
    dwph = max(size, pw)
    luts = [LUT_ATAN_2PI[i] >> (48 - dwph) for i in range(w - 1)]
    un = _as_i64(phase) & ((1 << pw) - 1)
    init_t, x0, y0 = _prerotated_inputs(un, pw, GAIN48_QUARTER >> (48 - size), size)
    init_z = wrap(init_t << (size - pw) if size >= pw else init_t, dwph)
    x, y, _ = _rotate(x0, y0, init_z, luts, w, w - 1, size, dwph, prerotated=True)
    return wrap(x >> (size - w), w), wrap(y >> (size - w), w)


def _atan2_core(y, x, input_width: int, angle_width: int, precision: int):
    """Shared vectoring-mode engine (src/cordic_atan2.vhd:146-196): returns
    (quadrant, dat_phi) where dat_phi ~ -atan(|y|/|x|) * 2^(AW-1)/pi."""
    aw, p = angle_width, precision
    iw = aw + p
    luts = [LUT_ATAN_PI[i] >> (49 - aw - p) for i in range(aw - 1)]

    x, y = _as_i64(x), _as_i64(y)
    sx = (x >> (input_width - 1)) & 1
    sy = (y >> (input_width - 1)) & 1
    quadrant = (sx << 1) | sy

    mask_lo = (1 << (aw - 1)) - 1
    xx = (x ^ -sx) & mask_lo  # one's-complement abs, low AW-1 bits
    yy = (y ^ -sy) & mask_lo

    z = torch.zeros_like(xx)
    for i in range(aw - 1):
        pos = yy >= 0
        ys, xs = yy >> i, xx >> i
        xx, yy = (
            wrap(torch.where(pos, xx + ys, xx - ys), iw),
            wrap(torch.where(pos, yy - xs, yy + xs), iw),
        )
        z = wrap(torch.where(pos, z - luts[i], z + luts[i]), iw)
    return quadrant, wrap(z >> p, aw)


def _on_card(*vs) -> bool:
    return any(isinstance(v, torch.Tensor) and v.device.type == "cuda" for v in vs)


def _atan2(y, x, input_width: int, angle_width: int, precision: int, convention: str):
    """Dispatch by device: a CUDA tensor (either input; the other goes to
    its card) launches the atan2 kernel, anything else runs the plain
    version in torch ops."""
    if _on_card(y, x):
        from .demod_kernel import atan2

        dev = (y if _on_card(y) else x).device
        return atan2(torch.as_tensor(y, device=dev), torch.as_tensor(x, device=dev),
                     input_width, angle_width, precision, convention)
    plain = cordic_atan2_plain if convention == "cordic" else atan2_fixed_plain
    return plain(y, x, input_width, angle_width, precision)


def cordic_atan2(y, x, input_width: int, angle_width: int, precision: int = 1):
    """Bit-exact vectorized ``src/cordic_atan2.vhd``.  Angle scale:
    pi == 2^(AW-1).

    Faithful to the reference's quadrant fix (vhd:204-219), whose output
    convention is NON-standard: Q1(x,y>0) -> -theta; Q2 -> pi-theta;
    Q3 -> pi/2-theta; Q4 -> theta-3pi/2.  Use :func:`atan2_fixed` for the
    standard atan2(y, x) convention with the same datapath.  On a CUDA
    tensor: the atan2 kernel (``demod_kernel.atan2``).
    """
    return _atan2(y, x, input_width, angle_width, precision, "cordic")


def atan2_fixed(y, x, input_width: int, angle_width: int, precision: int = 1):
    """Standard-convention atan2(y, x) on the reference datapath: returns
    the angle in (-pi, pi], scaled pi == 2^(AW-1).  Same iteration core as
    :func:`cordic_atan2`; only the quadrant reconstruction differs.  On a
    CUDA tensor: the atan2 kernel (``demod_kernel.atan2``)."""
    return _atan2(y, x, input_width, angle_width, precision, "fixed")


def cordic_atan2_plain(y, x, input_width: int, angle_width: int, precision: int = 1):
    """Plain version of :func:`cordic_atan2` in int64 torch ops, on the
    inputs' device."""
    q, dat_phi = _atan2_core(y, x, input_width, angle_width, precision)
    phi_pi = 1 << (angle_width - 2)
    out = torch.where(q == 0, dat_phi,
                      torch.where(q == 1, dat_phi + phi_pi,
                                  torch.where(q == 2, -dat_phi, dat_phi - phi_pi)))
    return wrap(out, angle_width)


def atan2_fixed_plain(y, x, input_width: int, angle_width: int, precision: int = 1):
    """Plain version of :func:`atan2_fixed` in int64 torch ops, on the
    inputs' device."""
    q, dat_phi = _atan2_core(y, x, input_width, angle_width, precision)
    base = -dat_phi  # +atan(|y|/|x|)
    pi_u = 1 << (angle_width - 1)
    out = torch.where(q == 0, base,
                      torch.where(q == 1, -base,
                                  torch.where(q == 2, pi_u - base, base - pi_u)))
    return wrap(out, angle_width)
