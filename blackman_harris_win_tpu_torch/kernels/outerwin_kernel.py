"""Outer-product window tiles: wrappers and plain versions (counterpart of
``blackman_harris_win_tpu/kernels/pallas/outerwin_kernel.py``).

Three fast modes share one tile structure: an h-table slice (rows, K-1)
times a lo-table (K-1, 2^m), a rank-1 accumulate per harmonic, sample index
n = h*2^m + lo:

- int (``outerwin``): a0 + sum_k mulsub_shift30(ch, cl, sh, sl), int32 wrap,
  then the W-bit wrap or saturate;
- f32 (``floatwin``): a0 + sum_k (ch*cl - sh*sl) in float32;
- comp (``compwin``): the raw (s, e) compensated pair.

``csrc/outerwin_kernel.cu`` serves them with two tile generators on one
geometry (compile-time harmonic counts, four lo lanes a thread, a row range
a block): the int one (compile-time shift, two 64-bit integer products per
harmonic) and the f32/comp one (FFMA chains), each with two epilogues:

- write-out: ``outer_block``, ``outer_block_f32``, ``outer_block_comp``
  store the samples (the generators of ``outerwin``/``floatwin``/``compwin``
  call them for a CUDA device, and through them the analyzer);
- checksum: ``outer_checksum``, ``outer_checksum_f32`` and
  ``outer_checksum_comp`` sum the full period in the kernel, the window never
  stored (the ports of ``make_checksum_fn``, ``make_checksum_fn_f32`` and
  ``make_checksum_fn_comp``).  The int sum is exact mod 2^32 in any order;
  the f32 and comp sums go through per-block partials and a fixed-order
  second pass, so repeated calls return the same bits.

The comp kernels' s is the plain version's bits; their e (FFMA chains, half
the roundings of the plain version's JAX order) lies within
:func:`comp_e_bound` of the plain e, and their f32 samples within
:func:`f32_pair_bound` of the plain ones.

Each wrapper runs its plain PyTorch version for the CPU and launches its
kernel for a CUDA device; there is no fallback between them.  The tables are
built on the host exactly as the JAX package builds them and put on each
device once per configuration.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..core.config import WindowSpec
from ..core.fixedpoint import mulsub_shift30, saturate, wrap
from .compwin import DEFAULT_THRESH, GRID_BITS, _tables_comp, comp_tile, pack_tables
from .floatwin import _resolve_coeffs, _tables_f32
from .outerwin import _tables, check_int_coeffs, check_split

_INT, _F32, _COMP = 0, 1, 2


class _Tiles(NamedTuple):
    """One configuration's tables on one device, packed for the kernels:
    hi (nh, hc) and lo (lr, nl), row-major.  int/f32: hi = [ch | sh],
    lo = [cl ; sl].  comp: hi = [hic | hip], lo = [loc ; lop]."""

    mode: int
    hi: torch.Tensor
    lo: torch.Tensor
    nk: int  # int/f32: harmonics K-1; comp: compensated harmonics C
    npl: int  # comp: plain harmonics P
    a0: float  # int/f32: a0; comp: a0_hi
    a0lo: float = 0.0  # comp: a0_lo
    guard: int = 0  # int: the h-table guard bit
    spec: WindowSpec | None = None  # int: width and overflow


def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@lru_cache(maxsize=16)
def _int_tiles(coeffs_q: tuple, spec: WindowSpec, m: int, device) -> _Tiles:
    hi, lo, guard = _tables(coeffs_q, spec.phase_width, m)
    hi_p = np.concatenate([hi[:, :, 0].T, hi[:, :, 1].T], axis=1)
    lo_p = np.concatenate([lo[:, :, 0], lo[:, :, 1]], axis=0)
    return _Tiles(_INT, _on(hi_p, device), _on(lo_p, device), len(coeffs_q) - 1, 0,
                  coeffs_q[0], guard=guard, spec=spec)


@lru_cache(maxsize=16)
def _f32_tiles(coeffs: tuple, pw: int, m: int, device, table_dtype=None) -> _Tiles:
    hi, lo = _tables_f32(coeffs, pw, m)
    hi_p = torch.from_numpy(np.concatenate([hi[:, :, 0].T, hi[:, :, 1].T], axis=1))
    lo_p = torch.from_numpy(np.concatenate([lo[:, :, 0], lo[:, :, 1]], axis=0))
    if table_dtype is not None:
        # the JAX probe's half-width tables: round to table_dtype, widen back
        hi_p, lo_p = (t.to(table_dtype).to(torch.float32) for t in (hi_p, lo_p))
    return _Tiles(_F32, hi_p.contiguous().to(device), lo_p.contiguous().to(device),
                  len(coeffs) - 1, 0, float(coeffs[0]))


@lru_cache(maxsize=16)
def _comp_tiles(coeffs: tuple, pw: int, m: int, g: int, thresh: float, device) -> _Tiles:
    hi_c, lo_c, hi_p, lo_p, a0_hi, a0_lo = _tables_comp(coeffs, pw, m, g, thresh)
    hic, loc, hip, lop = pack_tables(hi_c, lo_c, hi_p, lo_p)
    nc, npl = hi_c.shape[0], hi_p.shape[0]
    hi = np.concatenate([t for t, n in ((hic, nc), (hip, npl)) if n], axis=1)
    lo = np.concatenate([t for t, n in ((loc, nc), (lop, npl)) if n], axis=0)
    return _Tiles(_COMP, _on(hi, device), _on(lo, device), nc, npl,
                  float(a0_hi), float(a0_lo))


# --- plain versions -------------------------------------------------------


def tile_window(ch_blk, sh_blk, cl_t, sl_t, a0: int, guard: int, spec: WindowSpec):
    """One (rows, 2^m) int window tile from table slices: the exact
    ``window_block_outer`` accumulate, one round-half-up ``mulsub_shift30``
    per harmonic, in int64 torch ops.  The JAX package accumulates in int32,
    so the sum wraps to 32 bits before the W step; saturate clamps only for
    W < 32 (at W = 32 it is a no-op, as in the JAX package).

    ch_blk/sh_blk: (rows, K-1) signed-coefficient-folded h-table slices;
    cl_t/sl_t: (K-1, 2^m) lo-tables at amplitude 2^30 - 1."""
    rows, km1 = ch_blk.shape
    acc = torch.full((rows, cl_t.shape[1]), int(a0), dtype=torch.int64,
                     device=ch_blk.device)
    for k in range(km1):
        acc = acc + mulsub_shift30(ch_blk[:, k:k + 1], cl_t[k:k + 1, :],
                                   sh_blk[:, k:k + 1], sl_t[k:k + 1, :],
                                   round=True, shift=30 + guard)
    acc = wrap(acc, 32)
    w = spec.data_width
    if spec.overflow == "saturate" and w < 32:
        acc = saturate(acc, w)
    elif w < 32:
        acc = wrap(acc, w)
    return acc.to(torch.int32)


def tile_window_f32(ch_blk, sh_blk, cl_t, sl_t, a0: float):
    """One (rows, 2^m) float32 tile: acc = a0 + sum_k (ch*cl - sh*sl), the
    ``floatwin`` math in torch float32 ops."""
    rows, km1 = ch_blk.shape
    acc = torch.full((rows, cl_t.shape[1]), float(a0), dtype=torch.float32,
                     device=ch_blk.device)
    for k in range(km1):
        acc = acc + (ch_blk[:, k:k + 1] * cl_t[k:k + 1, :]
                     - sh_blk[:, k:k + 1] * sl_t[k:k + 1, :])
    return acc


def _plain_tile(t: _Tiles, h0: int, rows: int):
    """Rows [h0, h0+rows) of the tables as a (rows, 2^m) tile, or an (s, e)
    pair of them, by the plain version of ``t``'s mode."""
    blk = t.hi[h0:h0 + rows]
    k = t.nk
    if t.mode == _INT:
        return tile_window(blk[:, :k], blk[:, k:], t.lo[:k], t.lo[k:], int(t.a0),
                           t.guard, t.spec)
    if t.mode == _F32:
        return tile_window_f32(blk[:, :k], blk[:, k:], t.lo[:k], t.lo[k:], t.a0)
    shape = (rows, t.lo.shape[1])
    s = torch.full(shape, t.a0, dtype=torch.float32, device=blk.device)
    e = torch.full(shape, t.a0lo, dtype=torch.float32, device=blk.device)
    return comp_tile(s, e, blk[:, :4 * k], t.lo[:6 * k], blk[:, 4 * k:], t.lo[6 * k:])


def _flat(tile):
    if isinstance(tile, tuple):
        return tile[0].reshape(-1), tile[1].reshape(-1)
    return tile.reshape(-1)


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Pairwise sum of a tensor of 2^k elements, one rounding per level:
    every term passes through exactly k additions, whatever the device."""
    x = x.reshape(-1)
    while x.numel() > 1:
        x = x.view(2, -1)
        x = x[0] + x[1]
    return x[0]


def _checksum_plain(t: _Tiles, rows: int, bias: int):
    """Full-period checksum by the plain version, tile by tile of ``rows``
    h rows, summed in the JAX kernel's order (per-tile sum, then a running
    sum over tiles that starts at the bias).  A float tile is summed as a
    pairwise tree (comp: sum s + sum e), so the error bound
    (:func:`checksum_plain_depth`) holds on any device."""
    nh = t.hi.shape[0]
    dev = t.hi.device
    bias = wrap(int(bias), 32)
    if t.mode == _INT:
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for h0 in range(0, nh, rows):
            total += _plain_tile(t, h0, rows).sum(dtype=torch.int64)
        return wrap(total + bias, 32).to(torch.int32)
    out = torch.tensor(float(bias), dtype=torch.float32, device=dev)
    for h0 in range(0, nh, rows):
        tile = _plain_tile(t, h0, rows)
        out = out + (_tree_sum(tile) if t.mode == _F32
                     else _tree_sum(tile[0]) + _tree_sum(tile[1]))
    return out


def checksum_plain(coeffs_q, spec: WindowSpec, m: int = 11, rows: int = 128, bias: int = 0,
                   device=None):
    """Plain version of the int checksum kernel on ``device`` (0-d int32)."""
    t = _int_tiles(check_int_coeffs(coeffs_q), spec, m, _build.resolve_device(device))
    return _checksum_plain(t, rows, bias)


def checksum_plain_f32(name_or_coeffs, pw: int, m: int = 11, rows: int = 128,
                       bias: int = 0, table_dtype=None, device=None):
    """Plain version of the f32 checksum kernel on ``device`` (0-d float32)."""
    t = _f32_tiles(_resolve_coeffs(name_or_coeffs), pw, m, _build.resolve_device(device), table_dtype)
    return _checksum_plain(t, rows, bias)


def checksum_plain_comp(name_or_coeffs, pw: int, m: int = 11, rows: int = 128,
                        bias: int = 0, device=None):
    """Plain version of the comp checksum kernel on ``device`` (0-d float32)."""
    t = _comp_tiles(_resolve_coeffs(name_or_coeffs), pw, m, GRID_BITS, DEFAULT_THRESH,
                    _build.resolve_device(device))
    return _checksum_plain(t, rows, bias)


def outer_block_int_plain(coeffs_q, spec: WindowSpec, m: int, h0: int, rows: int,
                          device=None):
    """Plain version of the int write-out kernel: (rows * 2^m,) int32 samples
    of h rows [h0, h0+rows), in int64 torch ops on ``device``."""
    t = _int_tiles(check_int_coeffs(coeffs_q), spec, m, _build.resolve_device(device))
    return _flat(_plain_tile(t, h0, rows))


def outer_block_f32_plain(coeffs, pw: int, m: int, h0: int, rows: int, device=None,
                          table_dtype=None):
    """Plain version of the f32 write-out kernel (torch float32 ops)."""
    t = _f32_tiles(_resolve_coeffs(coeffs), pw, m, _build.resolve_device(device), table_dtype)
    return _flat(_plain_tile(t, h0, rows))


def outer_block_comp_plain(coeffs, pw: int, m: int, g: int, thresh: float, h0: int,
                           rows: int, device=None):
    """Plain version of the comp write-out kernel: the raw (s, e) pair."""
    t = _comp_tiles(_resolve_coeffs(coeffs), pw, m, g, thresh, _build.resolve_device(device))
    return _flat(_plain_tile(t, h0, rows))


# --- kernel launches ------------------------------------------------------


def _c_args(t: _Tiles, h0: int, rows: int) -> tuple:
    """The table arguments shared by the C entry points."""
    w, sat = 32, 0
    if t.mode == _INT:
        w, sat = t.spec.data_width, int(t.spec.overflow == "saturate")
    a0 = int(t.a0) if t.mode == _INT else 0
    a0f = 0.0 if t.mode == _INT else float(t.a0)
    return (t.hi.data_ptr(), t.lo.data_ptr(), h0, rows, t.lo.shape[1], t.hi.shape[1],
            t.nk, t.npl, a0, 30 + t.guard, w, sat, a0f, float(t.a0lo))


def _check_kernel(t: _Tiles) -> None:
    most = _build.lib().bhw_outer_max_harmonics()
    if not 1 <= t.nk + t.npl <= most:
        raise ValueError(f"the outer kernels take 2..{most + 1} coefficients")


def _block(name: str, t: _Tiles, h0: int, rows: int, device: torch.device):
    if device.type == "cpu":
        return _flat(_plain_tile(t, h0, rows))
    _check_kernel(t)
    n = rows * t.lo.shape[1]
    dt = torch.int32 if t.mode == _INT else torch.float32
    out0 = torch.empty(n, dtype=dt, device=device)
    out1 = torch.empty(n, dtype=torch.float32, device=device) if t.mode == _COMP else None
    with torch.cuda.device(device):
        rc = _build.lib().bhw_outer_block(
            t.mode, out0.data_ptr(), None if out1 is None else out1.data_ptr(),
            *_c_args(t, h0, rows), _build.stream_of(device))
    _build.check(name, rc)
    return out0 if out1 is None else (out0, out1)


def outer_block_int(coeffs_q, spec: WindowSpec, m: int, h0: int, rows: int, device=None):
    """int32 samples of h rows [h0, h0+rows) (rows * 2^m,) on ``device``:
    the plain version on the CPU, the int write-out kernel on CUDA."""
    device = _build.resolve_device(device)
    t = _int_tiles(check_int_coeffs(coeffs_q), spec, m, device)
    return _block("outer_block", t, h0, rows, device)


def outer_block_f32(coeffs, pw: int, m: int, h0: int, rows: int, device=None,
                    table_dtype=None):
    """float32 samples of h rows [h0, h0+rows) on ``device`` (f32 write-out)."""
    device = _build.resolve_device(device)
    t = _f32_tiles(_resolve_coeffs(coeffs), pw, m, device, table_dtype)
    return _block("outer_block_f32", t, h0, rows, device)


def outer_block_comp(coeffs, pw: int, m: int, g: int, thresh: float, h0: int, rows: int,
                     device=None):
    """The raw (s, e) pair of h rows [h0, h0+rows) on ``device`` (comp
    write-out)."""
    device = _build.resolve_device(device)
    t = _comp_tiles(_resolve_coeffs(coeffs), pw, m, g, thresh, device)
    return _block("outer_block_comp", t, h0, rows, device)


def _checksum_fn(name: str, t: _Tiles, rows: int, device: torch.device):
    nh = t.hi.shape[0]
    if nh % rows:
        raise ValueError(f"2^(pw-m) = {nh} not divisible by rows = {rows}")
    if device.type == "cpu":
        return lambda bias: _checksum_plain(t, rows, bias)
    _check_kernel(t)
    with torch.cuda.device(device):  # the launch geometry is the card's
        npart = _build.lib().bhw_outer_npartials(t.mode, nh, t.lo.shape[1], t.nk, t.npl)
    if npart < 0:
        raise RuntimeError(f"{name}: no launch geometry for these tables")

    def checksum(bias):
        bias = wrap(int(bias), 32)
        partials = None
        if t.mode == _INT:  # the kernel adds onto the bias
            out = torch.full((), bias, dtype=torch.int32, device=device)
        else:  # per call, on the stream it launches on
            out = torch.empty((), dtype=torch.float32, device=device)
            partials = torch.empty(npart, dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            rc = _build.lib().bhw_outer_checksum(
                t.mode, out.data_ptr(), None if partials is None else partials.data_ptr(),
                npart, bias, *_c_args(t, 0, nh), _build.stream_of(device))
        _build.check(name, rc)
        return out

    return checksum


def make_checksum_fn(coeffs_q, spec: WindowSpec, m: int = 11, rows: int = 128,
                     device=None):
    """``fn(bias)`` -> 0-d int32 tensor on ``device``: the int32-wrap sum of
    all 2^pw int outer-product samples plus ``bias`` (replaces the Pallas
    ``make_checksum_fn``).  ``fn(b) == fn(0) + b`` mod 2^32.  ``rows`` must
    divide 2^(pw-m); it is the plain version's tile (the kernel walks its own
    row ranges; the sum is exact in any order)."""
    check_split(spec.phase_width, m)
    device = _build.resolve_device(device)
    t = _int_tiles(check_int_coeffs(coeffs_q), spec, m, device)
    return _checksum_fn("outer_checksum", t, rows, device)


def make_checksum_fn_f32(name_or_coeffs, pw: int, m: int = 11, rows: int = 128,
                         table_dtype=None, device=None):
    """``fn(bias)`` -> 0-d float32 tensor: the full-period f32 window sum plus
    ``bias`` (replaces the Pallas ``make_checksum_fn_f32``).  A timing
    checksum: the f32 sum of 2^pw terms carries rounding.  ``table_dtype``
    (e.g. ``torch.bfloat16``) rounds the tables to that type before use."""
    check_split(pw, m)
    device = _build.resolve_device(device)
    t = _f32_tiles(_resolve_coeffs(name_or_coeffs), pw, m, device, table_dtype)
    return _checksum_fn("outer_checksum_f32", t, rows, device)


def make_checksum_fn_comp(name_or_coeffs, pw: int, m: int = 11, rows: int = 128,
                          device=None):
    """``fn(bias)`` -> 0-d float32 tensor: sum s + sum e of the raw
    compensated pair over the full period, plus ``bias`` (replaces the
    Pallas ``make_checksum_fn_comp``)."""
    check_split(pw, m)
    device = _build.resolve_device(device)
    t = _comp_tiles(_resolve_coeffs(name_or_coeffs), pw, m, GRID_BITS, DEFAULT_THRESH,
                    device)
    if t.nk == 0:
        raise ValueError(
            "no harmonic exceeds the compensation threshold; use "
            "make_checksum_fn_f32 (plain f32) for this coefficient set"
        )
    return _checksum_fn("outer_checksum_comp", t, rows, device)


# --- error bounds of the float modes, from their op counts -----------------

_U = 2.0**-24  # f32 unit roundoff


def f32_pair_bound(coeffs) -> float:
    """Bound on |f32 sample - f32 sample| between two evaluation orders of
    the f32 mode (kernel: two FMAs per harmonic; plain: 2 mul + sub + add).
    Each evaluation rounds at most 4 times per harmonic, and every rounded
    value is at most 2 * sum|a_k|, so each rounding is at most
    2 * sum|a_k| * 2^-24."""
    coeffs = _resolve_coeffs(coeffs)
    return 2 * 4 * (len(coeffs) - 1) * 2 * sum(abs(c) for c in coeffs) * _U


def comp_e_bound(coeffs, g: int = GRID_BITS, thresh: float = DEFAULT_THRESH) -> float:
    """Bound on |e - e'| between two evaluation orders of the comp mode's
    correction accumulator, each rounding at most 8 times per compensated
    harmonic and 4 times per plain one, each time a value at most E:
    2 (8C + 4P) E u.  The plain version (JAX's order) rounds that often (4
    mul, 2 add, 1 sub, 1 accumulate; 2 mul, sub, accumulate); the kernel's
    FFMA chains round 4C + 2P times, so kernel and plain differ by at most
    (12C + 6P) E u, inside the bound.  E bounds |e| and every intermediate
    (each is a partial sum of the products): |a0_lo| <= 2^-(g+1) plus, per
    compensated harmonic, 2 * ((|a_k| + 2^-(g+1)) * 2^-(g+1) + 2^-(g+1))
    (hi * lo-part and lo-part * f32 value, cos and sin; lo-parts are at most
    2^-(g+1)), and 2|a_k| per plain harmonic."""
    coeffs = _resolve_coeffs(coeffs)
    r = 2.0 ** -(g + 1)
    big = [abs(a) for a in coeffs[1:] if abs(a) >= thresh]
    small = [abs(a) for a in coeffs[1:] if abs(a) < thresh]
    e_max = r + sum(2 * ((a + r) * r + r) for a in big) + sum(2 * a for a in small)
    return 2 * (8 * len(big) + 4 * len(small)) * e_max * _U


def sum_bound(depth: int, sum_abs: float) -> float:
    """Bound on the error of an f32 sum in which every term passes through
    at most ``depth`` roundings: gamma(depth) * sum |terms|, with
    gamma(d) = d u / (1 - d u) and u = 2^-24."""
    return depth * _U / (1 - depth * _U) * sum_abs


def checksum_depth(name_or_coeffs, pw: int, m: int = 11, comp: bool = False,
                   device=None) -> int:
    """Longest chain of f32 additions any term (bias included) passes
    through in the f32 (``comp=False``) or comp checksum kernel over the
    full period of ``name_or_coeffs`` at (pw, m) on ``device``, as the kernel
    source derives it from its launch geometry (CUDA only: it asks the built
    library, and the geometry follows the card)."""
    device = _build.resolve_device(device)
    coeffs = _resolve_coeffs(name_or_coeffs)
    if comp:
        t = _comp_tiles(coeffs, pw, m, GRID_BITS, DEFAULT_THRESH, device)
    else:
        t = _f32_tiles(coeffs, pw, m, device)
    with torch.cuda.device(device):
        depth = _build.lib().bhw_outer_checksum_depth(t.mode, t.hi.shape[0], t.lo.shape[1],
                                                      t.nk, t.npl)
    if depth < 0:
        raise RuntimeError("no launch geometry for these tables")
    return depth


def checksum_plain_depth(nh: int, nl: int, rows: int, comp: bool = False) -> int:
    """Longest chain of f32 additions any term (bias included) passes
    through in the plain f32/comp checksum: the pairwise tree over a tile of
    rows * nl terms, s + e for comp, then the running sum over the nh / rows
    tiles."""
    return int(math.log2(rows * nl)) + int(comp) + nh // rows
