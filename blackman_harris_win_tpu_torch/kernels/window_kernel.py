"""Window generation kernels: wrappers and plain versions (counterpart of
``blackman_harris_win_tpu/kernels/pallas/window_kernel.py``).

Two CUDA kernels (``csrc/window_kernel.cu``) replace the Pallas kernel
``pallas_window_block``:

- ``window_block`` writes samples [n0, n0+length) as int32 (kernel 1a);
- ``window_checksum`` returns the int32-wrap sum of the samples at indices
  n_start .. n_start+count-1, plus a bias, without storing the window
  (kernel 1b: the shape ``bench.py`` times).

Both implement the HLS and the RTL rounding contracts with wrap/saturate,
for the CORDIC source, W <= 32.  Each wrapper runs its plain PyTorch version
(``window_values_plain`` / ``window_checksum_plain``) for the CPU and
launches the kernel for a CUDA device; there is no fallback between them.
The kernel's datapath (the word layout of the CORDIC state) follows from the
configuration alone, by :func:`_datapath`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build, _trace
from ..core.config import WindowSpec
from ..core.fixedpoint import wrap
from .cordic import cordic_constants
from .window import _check_lanes, window_samples

#: most terms (a0..aK) the kernels take; the catalog's largest set has 7
MAX_TERMS = 8
#: checksum plain version: samples generated per step
_CHUNK = 1 << 22
#: the kernel's CORDIC datapaths, in the order of their codes in
#: ``csrc/window_kernel.cu`` (enum Datapath)
_DATAPATHS = ("i32", "r2s", "i64")


def _datapath(spec: WindowSpec) -> str:
    """The kernel's datapath for a configuration, from the CORDIC state's
    internal width iw (W+2 for the HLS flavor, W+P for the RTL one):

    - ``"i32"``: iw <= 32 (HLS W <= 30, RTL W+P <= 32), one 32-bit word per
      register;
    - ``"r2s"``: iw in {33, 34} (HLS W = 31, 32; RTL W+P = 33, 34), x and y
      as 2^S*h + l with h a 32-bit word, S = iw - 32;
    - ``"i64"``: the wider RTL registers, W+P in 35..39.

    Raises for a width no datapath takes (W > 32)."""
    w = spec.data_width
    if not 8 <= w <= 32:
        raise ValueError("the window kernels write int32 samples: data_width <= 32")
    iw = w + (spec.precision if spec.rounding == "rtl" else 2)
    if iw <= 32:
        return "i32"
    return "r2s" if iw <= 34 else "i64"


def _kernel_params(coeffs_q, spec: WindowSpec):
    """Validate a configuration for the kernels and return the host-side
    parameters (coeffs, lut, gain) they take."""
    if spec.sin_type != "cordic":
        raise NotImplementedError("the window kernels support the CORDIC source only")
    coeffs = tuple(int(c) for c in coeffs_q)
    if not 2 <= len(coeffs) <= MAX_TERMS:
        raise ValueError(f"the window kernels take 2..{MAX_TERMS} coefficients")
    _datapath(spec)  # validates the width
    if any(not -(1 << 31) <= c < 1 << 31 for c in coeffs):
        # the TPU kernel's coefficients are int32 lanes too
        raise ValueError("the window kernels take int32 coefficients")
    _check_lanes(coeffs, spec)
    lut, gain = cordic_constants(spec.cordic_spec)  # validates the widths
    return np.asarray(coeffs, np.int64), np.asarray(lut, np.int64), gain


def _check_range(start: int, count: int) -> None:
    if start < 0 or count < 0 or start + count >= 1 << 62:
        raise ValueError("sample indices must lie in [0, 2^62)")


def window_values_plain(n, coeffs_q, spec: WindowSpec):
    """Plain version of kernel 1a: window samples at int64 indices ``n``
    as int32, in int64 torch ops on ``n``'s device."""
    _kernel_params(coeffs_q, spec)
    return window_samples(n, coeffs_q, spec).to(torch.int32)


def window_checksum_plain(coeffs_q, spec: WindowSpec, n_start: int, count: int,
                          bias: int = 0, device=None):
    """Plain version of kernel 1b: ``torch.sum`` of ``window_values_plain``
    over [n_start, n_start+count), plus bias, wrapped to int32 (0-d)."""
    _check_range(n_start, count)
    device = _build.resolve_device(device)
    acc = torch.zeros((), dtype=torch.int64, device=device)
    for s in range(n_start, n_start + count, _CHUNK):
        n = torch.arange(s, min(s + _CHUNK, n_start + count), device=device)
        acc += window_values_plain(n, coeffs_q, spec).sum(dtype=torch.int64)
    return wrap(acc + bias, 32).to(torch.int32)


def _c_args(params, spec: WindowSpec) -> tuple:
    """The C entry points' arguments after (out, start, count), from
    :func:`_kernel_params`; the caller holds ``params`` over the launch."""
    coeffs, lut, gain = params
    return (coeffs.ctypes.data, len(coeffs), lut.ctypes.data, len(lut), gain,
            spec.phase_width, spec.data_width, spec.precision,
            int(spec.rounding == "rtl"), int(spec.overflow == "saturate"),
            _DATAPATHS.index(_datapath(spec)))


def window_block(coeffs_q, spec: WindowSpec, n0: int, length: int, device=None):
    """Window samples [n0, n0+length) as int32 (length,) on ``device``
    (kernel 1a; replaces ``pallas_window_block``)."""
    with _trace.span("bhw.params"):
        n0, length = int(n0), int(length)
        _check_range(n0, length)
        device = _build.resolve_device(device)
        if device.type != "cpu" and length:
            params = _kernel_params(coeffs_q, spec)
    if device.type == "cpu":
        return window_values_plain(torch.arange(n0, n0 + length), coeffs_q, spec)
    with _trace.span("bhw.alloc"):
        out = torch.empty(length, dtype=torch.int32, device=device)
    if length:
        _build.launch("window_block", device, out.data_ptr(), n0, length,
                      *_c_args(params, spec))
    return out


def window_checksum(coeffs_q, spec: WindowSpec, n_start: int, count: int,
                    bias: int = 0, device=None):
    """int32-wrap sum of the window samples at indices n_start ..
    n_start+count-1 (mod 2^PW), plus ``bias``, as a 0-d int32 tensor on
    ``device`` (kernel 1b).  The window is never stored."""
    n_start, count = int(n_start), int(count)
    _check_range(n_start, count)
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return window_checksum_plain(coeffs_q, spec, n_start, count, bias, device)
    out = torch.full((), wrap(int(bias), 32), dtype=torch.int32, device=device)
    if count:
        params = _kernel_params(coeffs_q, spec)
        _build.launch("window_checksum", device, out.data_ptr(), n_start, count,
                      *_c_args(params, spec))
    return out
