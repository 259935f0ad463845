"""TAYLOR-source kernels: wrappers and plain versions (counterpart of
``blackman_harris_win_tpu/kernels/pallas/taylor_kernel.py``).

One CUDA source (``csrc/taylor_kernel.cu``) replaces the Pallas kernel
``make_checksum_fn_taylor`` with three entry points around one device
function, (cos, sin) of the quarter-wave-LUT + 1st-order-Taylor generator at
a sample index, and adds a fourth:

- ``sincos_block`` writes (c, s) for [n0, n0+count) (the engine
  ``taylor.taylor_sincos_block`` times);
- ``window_block`` writes the HLS 2/3-term TAYLOR window
  (``taylor.taylor_window_block``, ``window.make_window``);
- ``window_rtl_block`` writes the 2/3-term TAYLOR window under the RTL
  (VHDL) contract (``window.window_block``, ``window.make_window``, the
  sharded windows): the jnp path ``_window_rtl`` of the JAX package, which
  has no Pallas kernel, on the same tiles and generators (kernel
  ``taylor_window_rtl``);
- ``checksum_range`` sums c+s over [n0, n0+count) in the kernel, nothing
  stored, exact mod 2^32 in any block order; ``make_checksum_fn_taylor``
  (the TPU kernel's interface) runs it over one full period.  Over a full
  period the quadrants cancel (c and s take each value once with each
  sign), so that sum is the bias unless a W<19 wrap reaches -2^(W-1): the
  tests and the smoke run check the kernel's arithmetic on other ranges.

Each wrapper runs its plain PyTorch version (``taylor_sincos_plain``,
``taylor_window_plain``, ``taylor_window_rtl_plain``,
``taylor_checksum_plain``) for the CPU and launches
the kernel for a CUDA device; there is no fallback between them.  The ROM
is built on the host (numpy float64, as the JAX package builds it) and put on
each device once per (LS, W).  Sample indices are taken mod 2^PW, so any
``n0`` is accepted and reduced.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..core.config import WindowSpec
from ..core.fixedpoint import wrap
from .taylor import _rom, check_widths, ramb_pi, taylor_sincos
from .window import TAYLOR_TERMS_MSG, window_samples

#: checksum plain version: samples generated per step
_CHUNK = 1 << 22


def _check_count(count: int) -> int:
    count = int(count)
    if not 0 <= count < 1 << 61:
        raise ValueError("count must lie in [0, 2^61)")
    return count


def _ramb(pw: int, ls: int) -> int:
    """The tay1 phase constant of a generator, 0 outside the tay1 regime."""
    return ramb_pi(pw - ls - 3) if pw - ls > 2 else 0


@lru_cache(maxsize=16)
def _rom_on(ls: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rom(ls, w)).to(device)


def _window_params(coeffs_q, spec: WindowSpec) -> tuple[int, ...]:
    """Validate a TAYLOR window for the kernels (either contract): 2/3
    terms, both generators (PW and PW-1) valid, |a_k| < 2^31 (int32
    coefficients)."""
    coeffs = tuple(int(c) for c in coeffs_q)
    if len(coeffs) not in (2, 3):
        raise ValueError(TAYLOR_TERMS_MSG)
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    for k in range(1, len(coeffs)):
        check_widths(pw - (k - 1), w, ls)
    if max(abs(c) for c in coeffs) >= 1 << 31:
        raise ValueError("the Taylor window kernel takes |coefficients| < 2^31")
    return coeffs


def _taylor_hls(spec: WindowSpec) -> WindowSpec:
    """The spec the Taylor window functions compute: the TAYLOR source under
    the HLS contract, whatever ``spec`` names (as the JAX package's
    ``taylor_window_block`` does)."""
    return spec.with_(sin_type="taylor", rounding="hls")


def _taylor_rtl(spec: WindowSpec) -> WindowSpec:
    """The spec the RTL Taylor window functions compute: the TAYLOR source
    under the RTL contract, whatever ``spec`` names."""
    return spec.with_(sin_type="taylor", rounding="rtl")


def taylor_sincos_plain(n, pw: int, w: int, ls: int):
    """Plain version of ``sincos_block``: (c, s) at int64 indices ``n`` as
    int32, in int64 torch ops on ``n``'s device."""
    c, s = taylor_sincos(n, pw, w, ls)
    return c.to(torch.int32), s.to(torch.int32)


def taylor_window_plain(n, coeffs_q, spec: WindowSpec):
    """Plain version of ``window_block``: the HLS TAYLOR window at int64
    indices ``n`` as int32, in int64 torch ops on ``n``'s device."""
    coeffs = _window_params(coeffs_q, spec)
    return window_samples(n, coeffs, _taylor_hls(spec)).to(torch.int32)


def taylor_window_rtl_plain(n, coeffs_q, spec: WindowSpec):
    """Plain version of ``window_rtl_block``: the RTL TAYLOR window at int64
    indices ``n`` as int32, in int64 torch ops on ``n``'s device."""
    coeffs = _window_params(coeffs_q, spec)
    return window_samples(n, coeffs, _taylor_rtl(spec)).to(torch.int32)


def taylor_checksum_plain(pw: int, w: int, ls: int, n0: int = 0, bias: int = 0,
                          device=None, count: int | None = None):
    """Plain version of the checksum kernel: the int32-wrap sum of c+s over
    the ``count`` (default 2^pw) samples from ``n0``, plus bias (0-d int32
    on ``device``), generated and summed in chunks."""
    check_widths(pw, w, ls)
    device = _build.resolve_device(device)
    n0 = int(n0) % (1 << pw)
    end = n0 + (1 << pw if count is None else _check_count(count))
    acc = torch.zeros((), dtype=torch.int64, device=device)
    for a in range(n0, end, _CHUNK):
        n = torch.arange(a, min(a + _CHUNK, end), device=device)
        c, s = taylor_sincos(n, pw, w, ls)
        acc = wrap(acc + c.sum() + s.sum(), 32)
    return wrap(acc + int(bias), 32).to(torch.int32)


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        rc = getattr(_build.lib(), "bhw_" + name)(*args, _build.stream_of(device))
    _build.check(name, rc)


def sincos_block(n0, count: int, pw: int, w: int, ls: int, device=None):
    """(c, s) int32 (count,) over [n0, n0+count) on ``device`` (kernel
    ``taylor_sincos_block``)."""
    check_widths(pw, w, ls)
    n0, count = int(n0) % (1 << pw), _check_count(count)
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return taylor_sincos_plain(torch.arange(n0, n0 + count), pw, w, ls)
    c = torch.empty(count, dtype=torch.int32, device=device)
    s = torch.empty(count, dtype=torch.int32, device=device)
    if count:
        _launch("taylor_sincos_block", device, c.data_ptr(), s.data_ptr(), n0, count,
                _rom_on(ls, w, device).data_ptr(), pw, w, ls, _ramb(pw, ls))
    return c, s


@lru_cache(maxsize=64)
def _window_consts(coeffs: tuple[int, ...], spec: WindowSpec):
    """What a window write-out's launch needs and only its coefficients and
    spec decide, validated once per (coefficients, spec): the coefficients,
    their int64 buffer for the C entry (read-only) and the two generators'
    tay1 constants."""
    coeffs = _window_params(coeffs, spec)
    cbuf = np.asarray(coeffs, np.int64)
    cbuf.flags.writeable = False
    pw, ls = spec.phase_width, spec.lut_size
    return coeffs, cbuf, _ramb(pw, ls), _ramb(pw - 1, ls)


def _window_write(entry: str, plain, coeffs_q, spec: WindowSpec, n0, count: int, device,
                  *extra):
    """A TAYLOR window write-out over [n0, n0+count) as int32 on ``device``:
    ``plain`` on the CPU, the C entry ``bhw_<entry>`` on a card (its
    launch counter ``entry``), given ``extra`` after the generators."""
    coeffs, cbuf, ramb1, ramb2 = _window_consts(tuple(int(c) for c in coeffs_q), spec)
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    n0, count = int(n0) % (1 << pw), _check_count(count)
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return plain(torch.arange(n0, n0 + count), coeffs, spec)
    out = torch.empty(count, dtype=torch.int32, device=device)
    if count:
        _launch(entry, device, out.data_ptr(), n0, count, _rom_on(ls, w, device).data_ptr(),
                pw, w, ls, cbuf.ctypes.data, len(coeffs), ramb1, ramb2, *extra)
    return out


def window_block(coeffs_q, spec: WindowSpec, n0, count: int, device=None):
    """The HLS TAYLOR window over [n0, n0+count) as int32 on ``device``
    (kernel ``taylor_window_block``)."""
    return _window_write("taylor_window_block", taylor_window_plain, coeffs_q, spec, n0, count,
                         device, int(spec.overflow == "saturate"))


def window_rtl_block(coeffs_q, spec: WindowSpec, n0, count: int, device=None):
    """The RTL TAYLOR window over [n0, n0+count) as int32 on ``device``
    (kernel ``taylor_window_rtl``).  Its output register is W bits wide, so
    ``spec.overflow`` does not change it."""
    return _window_write("taylor_window_rtl", taylor_window_rtl_plain, coeffs_q, spec, n0, count,
                         device)


def checksum_range(n0, count: int, pw: int, w: int, ls: int, bias: int = 0, device=None):
    """The int32-wrap sum of c+s over [n0, n0+count), plus ``bias``, as a 0-d
    int32 tensor on ``device`` (kernel ``taylor_checksum``); the samples are
    never stored."""
    check_widths(pw, w, ls)
    n0, count = int(n0) % (1 << pw), _check_count(count)
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return taylor_checksum_plain(pw, w, ls, n0, bias, device, count=count)
    out = torch.full((), wrap(int(bias), 32), dtype=torch.int32, device=device)
    if count:
        _launch("taylor_checksum", device, out.data_ptr(), n0, count,
                _rom_on(ls, w, device).data_ptr(), pw, w, ls, _ramb(pw, ls))
    return out


def make_checksum_fn_taylor(pw: int, w: int, ls: int, rows: int = 64, device=None):
    """Build ``fn(n0, bias)`` -> 0-d int32 tensor on ``device``: the
    int32-wrap sum of (cos + sin) over one full 2^pw period starting at
    ``n0``, plus ``bias``, reduced in the kernel (replaces the Pallas
    ``make_checksum_fn_taylor``).  As there, the tay1 regime (PW - LS > 2)
    is required, ``rows`` must divide 2^LS and ``n0`` must be a multiple of
    rows * 2^(PW-LS-2).  ``rows`` is the TPU kernel's tile; the CUDA kernel
    takes no tile, so it only sets the alignment."""
    if pw - ls <= 2:
        raise ValueError("in-kernel taylor checksum needs the tay1 regime "
                         "(PW - LS > 2)")
    if w > 32:
        raise ValueError("taylor supports data_width <= 32")
    check_widths(pw, w, ls)
    if rows < 1 or (1 << ls) % rows:
        raise ValueError(f"rows = {rows} must divide 2^LS = {1 << ls}")
    align = rows << (pw - ls - 2)
    device = _build.resolve_device(device)

    def checksum(n0, bias):
        n0 = int(n0)
        if n0 % align:
            raise ValueError(f"n0 {n0} must be a multiple of rows * 2^(PW-LS-2) = {align}")
        return checksum_range(n0, 1 << pw, pw, w, ls, bias, device)

    return checksum
