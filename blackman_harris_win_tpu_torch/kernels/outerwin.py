"""Outer-product window generation, the int fast mode (counterpart of
``blackman_harris_win_tpu/kernels/outerwin.py``).

The angle-addition identity over a split index replaces the per-sample
CORDIC:

    n = h * 2^m + lo,   theta_k(n) = 2*pi*k*n / 2^pw
    cos(theta_k) = cos(A_k(h)) * cos(B_k(lo)) - sin(A_k(h)) * sin(B_k(lo))

with per-harmonic tables over h (2^(pw-m) entries, signed coefficients
+-a_k folded in) and lo (2^m entries, amplitude 2^30 - 1), exactly rounded
from float64 on the host.  Per sample and harmonic, one exact
multiply-subtract-shift with round-half-up (``fixedpoint.mulsub_shift30``),
then an int32-wrap accumulate and the W-bit wrap or saturate.

Not bit-exact against the CORDIC datapath; the contract is spectral: BH-7
at W=32 holds its -180 dB floor.  The CPU runs the plain PyTorch version
(``outerwin_kernel.tile_window``), a CUDA device the outer write-out kernel.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from ..core.config import WindowSpec

DEFAULT_SPLIT = 11  # lo axis 2^11 = 2048 lanes; h table 2^(pw-11)


@lru_cache(maxsize=8)
def _tables(coeffs_q: tuple, pw: int, m: int):
    """(hi_tabs, lo_tabs, guard): hi (K-1, 2^(pw-m), 2) int32 with
    +-a_k * 2^guard folded; lo (K-1, 2^m, 2) int32 at amplitude 2^30 - 1.
    Exact float64 rounding (all magnitudes < 2^31).  guard=1 when the
    coefficients leave headroom (|a_k| < 2^29), halving the hi-table
    rounding error.  The same math as the JAX package, bit for bit."""
    amp = 2.0**30 - 1.0
    nh, nl = 1 << (pw - m), 1 << m
    ks = np.arange(1, len(coeffs_q))
    sgn = np.where(ks % 2 == 1, -1.0, 1.0)
    amax = max(abs(int(c)) for c in coeffs_q[1:])
    guard = 1 if amax < (1 << 29) else 0

    h = np.arange(nh)
    # theta_hi = 2*pi*k*h*2^m/2^pw = 2*pi*(k*h mod nh)/nh  (exact reduction)
    kh = np.mod(np.outer(ks, h), nh)
    ang_h = (2.0 * math.pi / nh) * kh
    a = np.array([float(int(c)) * 2.0**guard for c in coeffs_q[1:]])[:, None]
    ch = np.floor(sgn[:, None] * a * np.cos(ang_h) + 0.5).astype(np.int64)
    sh = np.floor(sgn[:, None] * a * np.sin(ang_h) + 0.5).astype(np.int64)
    hi = np.stack([ch, sh], axis=-1).astype(np.int32)

    lo = np.arange(nl)
    klo = np.mod(np.outer(ks, lo), 1 << pw)
    ang_l = (2.0 * math.pi / (1 << pw)) * klo
    cl = np.floor(amp * np.cos(ang_l) + 0.5).astype(np.int64)
    sl = np.floor(amp * np.sin(ang_l) + 0.5).astype(np.int64)
    lo_t = np.stack([cl, sl], axis=-1).astype(np.int32)
    return hi, lo_t, guard


def check_split(pw: int, m: int) -> None:
    if m >= pw:
        raise ValueError("split m must be < phase_width")
    if m < 0:
        raise ValueError("split m must be >= 0")


def block_rows(n0, rows: int, pw: int, m: int) -> int:
    """Validate a block [n0, n0 + rows*2^m) and return its first h row:
    n0 a multiple of 2^m, the block inside one period."""
    n0, rows = int(n0), int(rows)
    if n0 % (1 << m):
        raise ValueError(f"n0 = {n0} must be a multiple of 2^m = {1 << m}")
    if rows < 1 or n0 < 0 or n0 + (rows << m) > 1 << pw:
        raise ValueError("the block [n0, n0 + rows*2^m) must lie inside one period")
    return n0 >> m


def check_int_coeffs(coeffs_q) -> tuple[int, ...]:
    coeffs_q = tuple(int(c) for c in coeffs_q)
    if max(abs(c) for c in coeffs_q) >= 1 << 30:
        raise ValueError(
            "outer-product path needs |coeffs| < 2^30 (use the 5/7-term "
            "headroom quantization, win_function.cpp:349-355)"
        )
    return coeffs_q


def window_block_outer(n0, rows: int, coeffs_q, spec: WindowSpec,
                       m: int = DEFAULT_SPLIT, device=None):
    """Window samples [n0, n0 + rows*2^m) as a (rows * 2^m,) int32 tensor on
    ``device``.  ``n0`` must be a multiple of 2^m with the block inside one
    period.  HLS accumulate semantics with the ideal-rounded outer-product
    cosine; wrap/saturate to W as the JAX package does (saturate clamps only
    for W < 32)."""
    from .outerwin_kernel import outer_block_int

    pw = spec.phase_width
    check_split(pw, m)
    coeffs_q = check_int_coeffs(coeffs_q)
    h0 = block_rows(n0, rows, pw, m)
    return outer_block_int(coeffs_q, spec, m, h0, rows, device)
