"""The taylor2 window write-out as one CUDA kernel: binding of
``csrc/fastwin_kernel.cu``.

The kernel computes ``window_values_fast`` (``kernels/fastwin.py``) over a
contiguous block [n0, n0+count) as int32, bit for bit: per harmonic the
phase (k*n) mod 2^PW as one uint32 product, the quarter-wave ROM read and
the second-order Taylor correction with its exact floors, the alternating
accumulate in 32 bits, then the W-bit wrap or the clamp.  It replaces the
jnp of ``blackman_harris_win_tpu/kernels/fastwin.py:75-157`` (no
``pallas_call``).  Where the ROM entries hold long runs of samples, it
walks them: each lane reads a run's entry and picks its quadrant's form
once, and steps the residual count's products exactly from sample to
sample (:func:`walk_regime` says where; ``csrc/fastwin_kernel.cu`` why it
is exact).

:func:`window_block` is the entry point: the plain version
(:func:`taylor2_window_plain`, ``window_values_fast`` in torch ops) for the
CPU, the kernel ``taylor2_window_block`` for a CUDA device, no fallback
between them.  The host constants (the ROM and ``_phase_consts``) are made
once per (LS, W) and (PW, LS); the ROM is put on each card once and read
through the read-only cache.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..core.config import WindowSpec
from .fastwin import _phase_consts, _rom_q, window_values_fast

#: the most window terms (a_0 .. a_{K-1}) the kernel takes
MAX_TERMS = 16
#: the widest phase the kernel takes: its phase product is 32-bit
MAX_PHASE_WIDTH = 32
#: the kernel's compile-time forms, in the order of their codes in the source
REGIMES = ("rom_only", "per_sample", "walk", "walk_lo")
#: the run walk's lane layout: lane l of a warp holds its 512 samples' 4l
#: + o for these offsets o = 128h + j (h, j < 4), in this order
WALK_OFFSETS = tuple(128 * h + j for h in range(4) for j in range(4))
#: the widest step between two of a lane's samples in the walk
MAX_GAP = max(b - a for a, b in zip(WALK_OFFSETS, WALK_OFFSETS[1:]))


@lru_cache(maxsize=64)
def walk_regime(pw: int, ls: int, nterms: int) -> str:
    """The kernel's form for phase width ``pw``, LUT size ``ls`` and
    ``nterms`` terms: "rom_only" where rb = pw-2-ls <= 0; the run walk
    ("walk_lo" with the P_lo term, "walk" without) where S = ls+29 >= 32
    (its high-word products), each run check's acnt * P_hi (and acnt *
    P_lo) stays below 2^32 (acnt reaches at most 2^rb - 1 + MAX_GAP *
    (nterms-1) at a check) and the highest harmonic's runs of 2^rb/k
    samples span the widest gap between a lane's samples, MAX_GAP, so that
    a lane leaves few runs; else "per_sample"."""
    _, p_hi, p_lo, rb = _phase_consts(pw, ls)
    if rb <= 0:
        return "rom_only"
    reach = (1 << rb) - 1 + MAX_GAP * (nterms - 1)
    use_lo = p_lo != 0 and rb + 12 <= 31
    if (ls + 29 >= 32 and 1 << rb >= MAX_GAP * (nterms - 1) and reach * p_hi < 1 << 32
            and (not use_lo or reach * p_lo < 1 << 32)):
        return "walk_lo" if use_lo else "walk"
    return "per_sample"


@lru_cache(maxsize=16)
def _rom_on(ls: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rom_q(ls, w)).to(device)


def taylor2_params(coeffs_q, spec: WindowSpec) -> tuple[int, ...]:
    """Validate a taylor2 window for the kernel, as ``window_values_fast``
    does (HLS rounding, |a_k| < 2^30, W <= 32, LS <= 14), and for the
    kernel's own limits (PW 2..32, W >= 2, at most MAX_TERMS terms).
    Returns the coefficients as ints."""
    if spec.rounding != "hls":
        raise NotImplementedError("taylor2 implements HLS rounding")
    coeffs = tuple(int(c) for c in coeffs_q)
    if max(abs(c) for c in coeffs) >= 1 << 30:
        raise ValueError(
            "taylor2 window path needs |coeffs| < 2^30 (5/7-term headroom "
            "quantization, win_function.cpp:349-355)"
        )
    if spec.data_width > 32:
        raise ValueError("taylor2 path supports data_width <= 32")
    if spec.lut_size > 14:
        raise ValueError("lut_size > 14 would overflow the d-scale headroom")
    if not 2 <= spec.phase_width <= MAX_PHASE_WIDTH or spec.data_width < 2 or spec.lut_size < 0:
        raise ValueError(f"the taylor2 kernel takes phase_width 2..{MAX_PHASE_WIDTH}, "
                         "data_width >= 2 and lut_size >= 0")
    if len(coeffs) > MAX_TERMS:
        raise ValueError(f"the taylor2 kernel takes at most {MAX_TERMS} terms")
    return coeffs


def taylor2_window_plain(n, coeffs_q, spec: WindowSpec) -> torch.Tensor:
    """Plain version of :func:`window_block`: the taylor2 window at int64
    indices ``n`` as int32, in int64 torch ops on ``n``'s device."""
    return window_values_fast(n, coeffs_q, spec).to(torch.int32)


def window_block(coeffs_q, spec: WindowSpec, n0, count: int, device=None) -> torch.Tensor:
    """The taylor2 window over [n0, n0+count) as int32 on ``device``
    (kernel ``taylor2_window_block``).  Only n mod 2^32 reaches a phase, so
    any ``n0`` is taken."""
    coeffs = taylor2_params(coeffs_q, spec)
    n0, count = int(n0), int(count)
    if not 0 <= count < 1 << 62:
        raise ValueError("count must lie in [0, 2^62)")
    device = _build.resolve_device(device)
    if device.type == "cpu":
        return taylor2_window_plain(torch.arange(n0, n0 + count), coeffs, spec)
    out = torch.empty(count, dtype=torch.int32, device=device)
    if not count:
        return out
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    _, p_hi, p_lo, rb = _phase_consts(pw, ls)
    if rb <= 0:
        p_hi = p_lo = 0  # the ROM-only regime takes no correction
    cbuf = np.asarray(coeffs, np.int32)
    _build.launch("taylor2_window_block", device, out.data_ptr(), n0 % (1 << 32), count,
                  _rom_on(ls, w, device).data_ptr(), pw, w, ls, cbuf.ctypes.data, len(coeffs),
                  p_hi, p_lo, int(spec.overflow == "saturate"),
                  REGIMES.index(walk_regime(pw, ls, len(coeffs))))
    return out
