"""Fused cosine-sum window generation (counterpart of
``blackman_harris_win_tpu/kernels/window.py``).

The reference's K-1 spatially replicated CORDIC instances become a harmonic
loop; the per-instance phase counters stepping +k mod 2^PHI become the
closed form ``(k * n) mod 2^PHI``, so any block of the window is computed
from its indices alone.  Three sine sources (``WindowSpec.sin_type``): the
CORDIC generators, the TAYLOR generator (``taylor.py``, 2/3-term windows
only) and the taylor2 fast mode (``fastwin.py``, HLS only).

Two rounding modes (see ``WindowSpec``): "hls" (the coherent functional
spec) and "rtl" (the VHDL cores' two round-half-up stages).

``window_samples`` is the indexed reference math on int64 lanes, on any
device.  ``make_window`` and ``window_block`` produce contiguous blocks,
each source and contract through its kernel's wrapper:

- CORDIC: ``window_kernel.window_block``;
- TAYLOR, HLS: ``taylor_kernel.window_block``;
- TAYLOR, RTL: ``taylor_kernel.window_rtl_block`` (a jnp path in the JAX
  package, a hand-written kernel here);
- taylor2: ``fastwin_kernel.window_block``.

A kernel wrapper runs the CUDA kernel for a CUDA device and its plain
version on the CPU; there is no fallback between them.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..core.config import WindowSpec
from ..core.fixedpoint import round_half_up_bit0, round_half_up_bit1, wrap
from ..windows import catalog
from . import cordic as _cordic
from .fastwin import window_values_fast
from .taylor import taylor_sincos

TAYLOR_TERMS_MSG = ("TAYLOR sin_type supports 2/3-term windows only "
                    "(src/win_selector.vhd: 4/5/7-term cores are CORDIC-only)")


def _harmonic_cos(n, k: int, spec: WindowSpec):
    """cos of harmonic k at sample indices n.

    CORDIC: closed-form phase (k*n) mod 2^PW into one generator (amplitude
    2^(W-2)).  TAYLOR: the reference doubles frequency by instantiating the
    generator one phase bit narrower (src/bh_win_3term.vhd:221-233), so
    harmonic k=2^j uses taylor at PW-j with phase n mod 2^(PW-j) (amplitude
    2^(W-1)); only 2/3-term windows support TAYLOR, matching
    src/win_selector.vhd:93-147.
    """
    pw = spec.phase_width
    if spec.sin_type == "cordic":
        c, _ = _cordic.cordic_sincos((k * n) & ((1 << pw) - 1), spec.cordic_spec)
        return c
    if k not in (1, 2):
        raise ValueError(TAYLOR_TERMS_MSG)
    pwk = pw - (k - 1)
    c, _ = taylor_sincos(n & ((1 << pwk) - 1), pwk, spec.data_width, spec.lut_size)
    return c


def _cos_shift(spec: WindowSpec) -> int:
    """log2 of the cosine source's amplitude: 2^(W-2) for CORDIC, full scale
    2^(W-1) for TAYLOR."""
    return spec.data_width - (2 if spec.sin_type == "cordic" else 1)


def _check_lanes(coeffs_q, spec: WindowSpec) -> None:
    """Every product a_k * cos_k and the W+2-bit tree must fit int64."""
    w = spec.data_width
    amax = max(abs(int(c)) for c in coeffs_q)
    prod_bits = amax.bit_length() + _cos_shift(spec) + 1
    if max(prod_bits, w + 2) > 63:
        raise ValueError(
            f"this configuration needs {max(prod_bits, w + 2)}-bit products; "
            "int64 lanes hold at most 63"
        )


def window_samples(n, coeffs_q, spec: WindowSpec):
    """Quantized window samples at indices ``n`` (any shape, ints).

    ``coeffs_q``: integer coefficients (a0..aK), e.g. from
    ``catalog.get(name).quantized(data_width)``.  Returns signed
    data_width-bit values in an int64 tensor on ``n``'s device.
    """
    n = torch.as_tensor(n, dtype=torch.int64)
    if spec.sin_type == "taylor2":
        return window_values_fast(n, coeffs_q, spec)
    coeffs_q = tuple(int(c) for c in coeffs_q)
    _check_lanes(coeffs_q, spec)
    if spec.rounding == "hls":
        return _window_hls(n, coeffs_q, spec)
    return _window_rtl(n, coeffs_q, spec)


def _window_hls(n, coeffs_q, spec: WindowSpec):
    """HLS semantics: ``w[n] = a0 - m1 + m2 - ...``,
    ``m_k = (a_k * cos_k) >> (W-2)`` (hls/windows/win_function.cpp:361-375).

    The shift is W-1 for the full-scale TAYLOR source.  The accumulator is
    exact in int64, so saturate clamps the true sum (at W=32 the JAX int32
    datapath recovers the same value by counting signed overflows,
    pallas/window_kernel.py:332-360)."""
    w, shift = spec.data_width, _cos_shift(spec)
    acc = torch.full(n.shape, coeffs_q[0], dtype=torch.int64, device=n.device)
    for k in range(1, len(coeffs_q)):
        m = (coeffs_q[k] * _harmonic_cos(n, k, spec)) >> shift
        acc = acc - m if k % 2 == 1 else acc + m
    if spec.overflow == "saturate":
        return torch.clamp(acc, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    return wrap(acc, w)  # win_t cast (ap_int<W>)


def _window_rtl(n, coeffs_q, spec: WindowSpec):
    """VHDL datapath semantics with raw AA-port coefficients
    (src/bh_win_3term.vhd:257-306, src/hamming_win.vhd:194-231):
    product slice [2W-2:W-2] -> W+1 bits, round-half-up off bit 0 -> W bits,
    alternating adder tree in W+2 bits (W+1 for 2-term), final round-half-up
    off bit 1 (bit 0 for 2-term) -> W bits.  The output register is W bits
    wide, so "saturate" and "wrap" agree here.  The datapath is scaled for
    the full-scale TAYLOR source; the CORDIC source needs
    :func:`rtl_cordic_coeffs`."""
    w = spec.data_width
    bs = []
    for k in range(1, len(coeffs_q)):
        r = wrap((coeffs_q[k] * _harmonic_cos(n, k, spec)) >> (w - 2), w + 1)
        bs.append(wrap(round_half_up_bit0(r), w))

    if len(coeffs_q) == 2:  # hamming_win.vhd:211-231
        pp = wrap(coeffs_q[0] - bs[0], w + 1)
        return wrap(round_half_up_bit0(pp), w)
    acc = torch.full(n.shape, coeffs_q[0], dtype=torch.int64, device=n.device)
    for k, b in enumerate(bs, start=1):
        acc = acc - b if k % 2 == 1 else acc + b
    return wrap(round_half_up_bit1(wrap(acc, w + 2)), w)


def make_window(name: str, spec: WindowSpec, coeffs=None, device=None):
    """The full 2^phase_width-point quantized window for a named coefficient
    set (the ``win_selector`` equivalent, src/win_selector.vhd:93-199), as
    int32 on ``device`` (routed as :func:`window_block`)."""
    coeffs_q = coeffs if coeffs is not None else _quantized(name, spec.data_width)
    return window_block(0, spec.n, coeffs_q, spec, device)


@lru_cache(maxsize=64)
def _quantized(name: str, data_width: int) -> tuple[int, ...]:
    """A named set's coefficients quantized to ``data_width``, once per pair."""
    return catalog.get(name).quantized(data_width)


def rtl_cordic_coeffs(coeffs_q) -> tuple[int, ...]:
    """Corrected AA-port values for the RTL (VHDL) cores with the CORDIC
    source: **AA0 halved** (round-half-up).

    The VHDL product datapath is scaled for a full-scale 2^(W-1) cosine
    source (the TAYLOR generator); the CORDIC source's amplitude is
    2^(W-2), so with same-scale AA ports every harmonic lands at a_k/2
    against a full a0.  Halving AA0 restores cancellation; the full
    derivation is in the JAX package's ``kernels/window.py``.
    """
    q = tuple(int(c) for c in coeffs_q)
    return ((q[0] + 1) >> 1,) + q[1:]


def win_function(sel: int, n, spec: WindowSpec):
    """HLS runtime selector semantics (hls/windows/win_function.cpp:380-422):
    selector code -> window; unknown code -> zeros (win_empty)."""
    n = torch.as_tensor(n)
    if sel not in catalog.HLS_SEL:
        return torch.zeros(n.shape, dtype=torch.int64, device=n.device)
    d = catalog.get(catalog.HLS_SEL[sel])
    return window_samples(n, d.quantized(spec.data_width), spec)


def window_block(n0: int, block_len: int, coeffs_q, spec: WindowSpec,
                 device=None):
    """A contiguous block [n0, n0+block_len) of the window as int32 on
    ``device`` — the streaming building block (no host ever needs the full
    window) — through the kernel wrapper of its source and contract."""
    if spec.sin_type == "cordic":
        from .window_kernel import window_block as _block
    elif spec.sin_type == "taylor2":
        from .fastwin_kernel import window_block as _block
    elif spec.rounding == "hls":
        from .taylor_kernel import window_block as _block
    else:
        from .taylor_kernel import window_rtl_block as _block
    return _block(coeffs_q, spec, n0, block_len, device)
