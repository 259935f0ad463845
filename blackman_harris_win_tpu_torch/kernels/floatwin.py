"""Float32 outer-product window generation, the native mode for float
consumers (counterpart of ``blackman_harris_win_tpu/kernels/floatwin.py``).

The angle-addition split of ``outerwin.py`` in float32:

    n = h * 2^m + lo
    w[n] = a0 + sum_k ( CH_k[h] * CL_k[lo] - SH_k[h] * SL_k[lo] )

with CH_k = (-1)^k a_k cos(theta_hi), etc., each rounded once from float64.
Per-sample error ~K * 2^-23 absolute (unit amplitude).  The f32 floor equals
the f64 floor through 5-term windows; BH-7 holds about -163 dB of its -180.
The CPU runs the plain PyTorch version, a CUDA device the f32 outer
write-out kernel (``outerwin_kernel``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .outerwin import DEFAULT_SPLIT, block_rows, check_split


def _resolve_coeffs(name_or_coeffs) -> tuple[float, ...]:
    if isinstance(name_or_coeffs, str):
        from ..windows import catalog

        return catalog.get(name_or_coeffs).coeffs
    return tuple(float(c) for c in name_or_coeffs)


@lru_cache(maxsize=16)
def _tables_f32(coeffs: tuple, pw: int, m: int):
    """(hi, lo) float32 tables: hi (K-1, 2^(pw-m), 2) with (-1)^k a_k
    folded; lo (K-1, 2^m, 2) unit amplitude.  Values computed in float64
    (phase reduced exactly with integer mod) and rounded once to f32."""
    nh, nl = 1 << (pw - m), 1 << m
    ks = np.arange(1, len(coeffs))
    sgn = np.where(ks % 2 == 1, -1.0, 1.0)
    a = np.asarray(coeffs[1:], np.float64)[:, None] * sgn[:, None]

    h = np.arange(nh)
    kh = np.mod(np.outer(ks, h), nh)  # theta_hi = 2*pi*(k*h mod nh)/nh
    ang_h = (2.0 * math.pi / nh) * kh
    hi = np.stack(
        [a * np.cos(ang_h), a * np.sin(ang_h)], axis=-1
    ).astype(np.float32)

    lo = np.arange(nl)
    klo = np.mod(np.outer(ks, lo), 1 << pw)
    ang_l = (2.0 * math.pi / (1 << pw)) * klo
    lo_t = np.stack([np.cos(ang_l), np.sin(ang_l)], axis=-1).astype(np.float32)
    return hi, lo_t


def _host_f64_window(coeffs, pw: int) -> np.ndarray:
    """Degenerate tiny windows (m <= 0): direct float64 evaluation on the host."""
    n = np.arange(1 << pw)
    acc = np.full(n.shape, coeffs[0], np.float64)
    for k, a in enumerate(coeffs[1:], start=1):
        acc += ((-1.0) ** k) * a * np.cos(2.0 * math.pi * k * n / (1 << pw))
    return acc


def float_window_block(n0, rows: int, name_or_coeffs, pw: int,
                       m: int = DEFAULT_SPLIT, device=None):
    """Window samples [n0, n0 + rows*2^m) as a (rows * 2^m,) float32 tensor
    on ``device`` at unit amplitude.  ``n0`` must be a multiple of 2^m with
    the block inside one period (the API of ``outerwin.window_block_outer``)."""
    from .outerwin_kernel import outer_block_f32

    check_split(pw, m)
    coeffs = _resolve_coeffs(name_or_coeffs)
    h0 = block_rows(n0, rows, pw, m)
    return outer_block_f32(coeffs, pw, m, h0, rows, device)


def float_window(name_or_coeffs, pw: int, m: int | None = None, device=None):
    """Full-period (2^pw,) float32 window on ``device``, generated on the fly
    (no stored table of window values; only the 2^(pw-m) + 2^m trig tables)."""
    if m is None:
        m = min(DEFAULT_SPLIT, pw - 1) if pw > 1 else 0
    if m <= 0:
        acc = _host_f64_window(_resolve_coeffs(name_or_coeffs), pw)
        return torch.from_numpy(acc.astype(np.float32)).to(_build.resolve_device(device))
    return float_window_block(0, 1 << (pw - m), name_or_coeffs, pw, m=m, device=device)


def float_window_flops(n_samples: int, n_terms: int) -> int:
    """No-fusion f32 op model: 2 multiplies + 2 adds per harmonic per
    sample (the FMA pairs cover it in 2 slots; this counts 4, matching the
    int model's no-fusion convention)."""
    return n_samples * (n_terms - 1) * 4
