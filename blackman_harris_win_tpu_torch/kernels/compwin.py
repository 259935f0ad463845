"""Compensated-float32 window generation, the full -180 dB contract for float
consumers (counterpart of ``blackman_harris_win_tpu/kernels/compwin.py``).

Error-free f32 arithmetic by construction, robust to FMA contraction:

1. the angle-addition split of ``floatwin.py``;
2. each table value of a *compensated* harmonic (|a_k| >= 2^-7) is split
   against an absolute 2^-g grid (g = 11): ``hi`` on the grid, ``lo`` the
   f32 residual;
3. products of two hi-parts are multiples of 2^-22 with |.| < 1, exact in
   f32, and their running sum stays exact while |s| < 2 (sum |a_k| < 1.9):
   the accumulator ``s`` carries no rounding error, under any contraction;
4. first-order corrections and the below-threshold (plain) harmonics
   accumulate in a second f32 accumulator ``e``;
5. generation returns the RAW (s, e) pair, whose sum is exact to ~3e-10;
   the TwoSum that folds it into a non-overlapping (hi, lo) runs on the
   host in numpy (:func:`normalize_pair`), never in a kernel.

The CPU runs the plain PyTorch version (:func:`comp_tile`), a CUDA device
the comp outer write-out kernel (``outerwin_kernel``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .floatwin import _host_f64_window, _resolve_coeffs
from .outerwin import DEFAULT_SPLIT, block_rows, check_split

DEFAULT_THRESH = 2.0 ** -7  # compensate harmonics with |a_k| >= this
GRID_BITS = 11  # absolute split grid 2^-g; products land on 2^-22 exactly


def _grid_round(x: np.ndarray, g: int) -> np.ndarray:
    return (np.round(np.asarray(x, np.float64) * (1 << g)) / (1 << g)).astype(
        np.float32
    )


def _split(x: np.ndarray, g: int):
    """(hi, lo) with hi on the 2^-g grid and lo = f32(x - hi)."""
    hi = _grid_round(x, g)
    return hi, (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(
        np.float32
    )


@lru_cache(maxsize=16)
def _tables_comp(coeffs: tuple, pw: int, m: int, g: int, thresh: float):
    """Compensated + plain table sets, the JAX package's math bit for bit.

    Returns (hi_c, lo_c, hi_p, lo_p, a0_hi, a0_lo):
      hi_c (C, nh, 4): ch_hi, ch_lo, sh_hi, sh_lo   (signed a_k folded)
      lo_c (C, nl, 6): cl_hi, cl_lo, cl_f, sl_hi, sl_lo, sl_f
      hi_p (P, nh, 2) / lo_p (P, nl, 2): plain-f32 tables for the
        below-threshold harmonics.
    C or P may be 0 (the empty set is a (0, 1, width) array).
    """
    if sum(abs(c) for c in coeffs) > 1.9:
        raise ValueError(
            "sum |a_k| must stay < 1.9 for the exact-grid accumulator "
            f"(got {sum(abs(c) for c in coeffs):.3f})"
        )
    nh, nl, n = 1 << (pw - m), 1 << m, 1 << pw
    h = np.arange(nh)
    lo = np.arange(nl)
    hi_c, lo_c, hi_p, lo_p = [], [], [], []
    for k in range(1, len(coeffs)):
        a = ((-1.0) ** k) * coeffs[k]
        ang_h = (2.0 * math.pi / nh) * np.mod(k * h, nh)
        ang_l = (2.0 * math.pi / n) * np.mod(k * lo, n)
        ch, sh = a * np.cos(ang_h), a * np.sin(ang_h)
        cl, sl = np.cos(ang_l), np.sin(ang_l)
        if abs(coeffs[k]) >= thresh:
            ch_hi, ch_lo = _split(ch, g)
            sh_hi, sh_lo = _split(sh, g)
            cl_hi, cl_lo = _split(cl, g)
            sl_hi, sl_lo = _split(sl, g)
            hi_c.append(np.stack([ch_hi, ch_lo, sh_hi, sh_lo], axis=-1))
            lo_c.append(
                np.stack(
                    [cl_hi, cl_lo, cl.astype(np.float32),
                     sl_hi, sl_lo, sl.astype(np.float32)],
                    axis=-1,
                )
            )
        else:
            hi_p.append(np.stack([ch, sh], axis=-1).astype(np.float32))
            lo_p.append(np.stack([cl, sl], axis=-1).astype(np.float32))

    def _stack(parts, width):
        if parts:
            return np.stack(parts, axis=0)
        return np.zeros((0, 1, width), np.float32)

    a0_hi = float(_grid_round(np.float64(coeffs[0]), g))
    a0_lo = np.float32(coeffs[0] - a0_hi)
    return (_stack(hi_c, 4), _stack(lo_c, 6), _stack(hi_p, 2),
            _stack(lo_p, 2), np.float32(a0_hi), a0_lo)


def _two_sum(s, e):
    """Branch-free TwoSum: (hi, lo) f32 with hi + lo == s + e exactly."""
    hi = s + e
    v = hi - s
    lo = (s - (hi - v)) + (e - v)
    return hi, lo


def normalize_pair(s, e):
    """Host-side (numpy) TwoSum: non-overlapping f32 (hi, lo) with
    hi + lo == s + e exactly and |lo| <= ulp(hi)/2.

    Deliberately not a kernel or any fused device code: a compiler that
    contracts or recomputes the (s, e) producers differently for TwoSum's
    several reads breaks exactness at rounding ties.  The raw pair's SUM is
    exact under any compilation; only the normalization is
    rounding-sensitive, so it runs in numpy, where evaluation is
    deterministic.  Takes numpy arrays or tensors (copied to the host)."""
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    if isinstance(e, torch.Tensor):
        e = e.detach().cpu().numpy()
    s = np.asarray(s, np.float32)
    e = np.asarray(e, np.float32)
    return _two_sum(s, e)


def pack_tables(hi_c, lo_c, hi_p, lo_p):
    """Pack the stacked tables into 2D arrays whose sliced axis is a plain
    leading/trailing dim:

      hic (nh, 4C): columns 4k+{0..3} = ch_hi, ch_lo, sh_hi, sh_lo of
        compensated harmonic k;
      loc (6C, nl): rows 6k+{0..5} = cl_hi, cl_lo, cl_f, sl_hi, sl_lo, sl_f;
      hip (nh, 2P) / lop (2P, nl): the plain-harmonic pairs likewise.
    """
    c, nh = hi_c.shape[0], hi_c.shape[1]
    p, nhp = hi_p.shape[0], hi_p.shape[1]
    hic = np.transpose(hi_c, (1, 0, 2)).reshape(nh, 4 * c)
    loc = np.transpose(lo_c, (0, 2, 1)).reshape(6 * c, lo_c.shape[1])
    hip = np.transpose(hi_p, (1, 0, 2)).reshape(nhp, 2 * p)
    lop = np.transpose(lo_p, (0, 2, 1)).reshape(2 * p, lo_p.shape[1])
    return hic, loc, hip, lop


def comp_tile(s, e, hic_blk, loc_t, hip_blk, lop_t):
    """Accumulate all harmonics onto (s, e) float32 tiles: the plain
    version of the comp kernels' per-sample arithmetic, in the JAX order.

    hic_blk (rows, 4C) / hip_blk (rows, 2P): h-axis slices of the packed
    tables (:func:`pack_tables`); loc_t (6C, nl) / lop_t (2P, nl).
    """
    for k in range(hic_blk.shape[1] // 4):
        ch_hi = hic_blk[:, 4 * k + 0][:, None]
        ch_lo = hic_blk[:, 4 * k + 1][:, None]
        sh_hi = hic_blk[:, 4 * k + 2][:, None]
        sh_lo = hic_blk[:, 4 * k + 3][:, None]
        cl_hi = loc_t[6 * k + 0][None, :]
        cl_lo = loc_t[6 * k + 1][None, :]
        cl_f = loc_t[6 * k + 2][None, :]
        sl_hi = loc_t[6 * k + 3][None, :]
        sl_lo = loc_t[6 * k + 4][None, :]
        sl_f = loc_t[6 * k + 5][None, :]
        s = s + (ch_hi * cl_hi - sh_hi * sl_hi)  # exact on the 2^-22 grid
        e = e + ((ch_hi * cl_lo + ch_lo * cl_f)
                 - (sh_hi * sl_lo + sh_lo * sl_f))
    for k in range(hip_blk.shape[1] // 2):
        ch = hip_blk[:, 2 * k + 0][:, None]
        sh = hip_blk[:, 2 * k + 1][:, None]
        cl = lop_t[2 * k + 0][None, :]
        sl = lop_t[2 * k + 1][None, :]
        e = e + (ch * cl - sh * sl)
    return s, e


def comp_window_block(n0, rows: int, name_or_coeffs, pw: int,
                      m: int = DEFAULT_SPLIT, g: int = GRID_BITS,
                      thresh: float = DEFAULT_THRESH, device=None):
    """Window samples [n0, n0 + rows*2^m) as the RAW f32 (s, e) pair on
    ``device``, each (rows * 2^m,), with s + e == w[n] to ~3e-10 (BH-7).
    The components are not normalized; consumers apply the pair as
    ``x*s + x*e``, or fold it on the host with :func:`normalize_pair`."""
    from .outerwin_kernel import outer_block_comp

    check_split(pw, m)
    coeffs = _resolve_coeffs(name_or_coeffs)
    h0 = block_rows(n0, rows, pw, m)
    return outer_block_comp(coeffs, pw, m, g, thresh, h0, rows, device)


def comp_window_pair(name_or_coeffs, pw: int, m: int | None = None,
                     g: int = GRID_BITS, thresh: float = DEFAULT_THRESH,
                     device=None):
    """Full-period RAW (s, e) pair on ``device`` (see :func:`comp_window_block`)."""
    if m is None:
        m = min(DEFAULT_SPLIT, pw - 1) if pw > 1 else 0
    if m <= 0:
        # degenerate tiny windows: f64 on the host, split once
        acc = _host_f64_window(_resolve_coeffs(name_or_coeffs), pw)
        hi = acc.astype(np.float32)
        lo = (acc - hi.astype(np.float64)).astype(np.float32)
        device = _build.resolve_device(device)
        return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)
    return comp_window_block(0, 1 << (pw - m), name_or_coeffs, pw, m=m, g=g,
                             thresh=thresh, device=device)


def comp_window(name_or_coeffs, pw: int, m: int | None = None,
                pair: bool = False, g: int = GRID_BITS,
                thresh: float = DEFAULT_THRESH, device=None):
    """Full-period compensated window, folded on the host.

    ``pair=False`` returns the folded (2^pw,) f32 tensor (the best window
    float32 can express); ``pair=True`` the normalized, non-overlapping
    (hi, lo) tuple holding the full f64 floor.  Both on ``device``."""
    s, e = comp_window_pair(name_or_coeffs, pw, m=m, g=g, thresh=thresh,
                            device=device)
    hi, lo = normalize_pair(s, e)
    hi, lo = torch.from_numpy(hi).to(s.device), torch.from_numpy(lo).to(s.device)
    return (hi, lo) if pair else hi


def comp_window_flops(n_samples: int, coeffs, thresh: float = DEFAULT_THRESH,
                      g: int = GRID_BITS) -> int:
    """No-fusion f32 op model: 12 slots per compensated harmonic (6 mul +
    6 add), 4 per plain harmonic, + 6 for the final TwoSum."""
    coeffs = _resolve_coeffs(coeffs)
    nc = sum(1 for c in coeffs[1:] if abs(c) >= thresh)
    npl = len(coeffs) - 1 - nc
    return n_samples * (12 * nc + 4 * npl + 6)
