"""Windowed Welch power spectrum analyzer, single device (counterpart of
``blackman_harris_win_tpu/pipeline/spectral.py``).

    sample stream -> overlapped frames -> quantized window apply
    -> FFT -> |.|^2 -> Welch average

The window is generated on the fly: by the window kernel (quantized), the
f32 outer write-out kernel (``win_mode="float"``) or the comp outer
write-out kernel (``win_mode="comp"``, the raw (s, e) pair applied as
``frame*s + frame*e``).  With
``fft_mode="mxu"``, 1-D CUDA input at 50% overlap runs the fused stage-1
kernel (framing + window + pack + first DFT stage, ``welchfft_kernel``)
followed by matmul DFT stages; other input runs the same matmul stages on
materialized frames.  Every DFT table is built on the host in float64.

Float matmuls here must run in full fp32: the functions below turn TF32 off
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) while they run and restore both flags
after, as the JAX package pins ``Precision.HIGHEST`` per operation.

Array-like ``x`` goes to ``device`` (default the card); a tensor runs where
it lies.  :func:`make_sharded_welch` is the analyzer over a device mesh
(``dist/``).
"""

from __future__ import annotations

from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from .. import _build, _trace
from ..core.config import WindowSpec
from ..dist.collectives import pmean
from ..dist.halo import right_halo
from ..dist.mesh import Mesh, from_rows, local_map, shard
from ..kernels import window as _window
from ..kernels.compwin import comp_window_pair
from ..kernels.floatwin import float_window
from ..kernels.welchfft_kernel import welch_stage1_fused
from ..windows import catalog


@contextmanager
def _full_fp32():
    """TF32 off for float32 matmuls and cuDNN convolutions inside the block
    (or the decorated function), both flags restored as they were after it."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _float_dtype(t: torch.Tensor) -> torch.dtype:
    """The real floating dtype that goes with ``t``: its own (the real part's
    for complex), float32 for integer tensors."""
    return t.real.dtype if t.is_floating_point() or t.is_complex() else torch.float32


def window_scale(spec: WindowSpec, shift: int) -> float:
    """Float scale of the quantized window: values are round(w * (2^(W-shift)-1))."""
    return 1.0 / (2.0 ** (spec.data_width - shift) - 1.0)


def _check_float_window_arg(name_or_coeffs):
    """Guard the ``win_mode="float"|"comp"`` argument: it must be a catalog
    name or a *float* coefficient tuple (|a_k| <= 1).  A caller that flips
    the mode flag while still passing the usual quantized-integer tuple
    would otherwise get a silently wrong window with integer-count
    amplitudes."""
    if isinstance(name_or_coeffs, str):
        return name_or_coeffs
    coeffs = tuple(float(c) for c in name_or_coeffs)
    if not coeffs or max(abs(c) for c in coeffs) > 1.0:
        raise ValueError(
            "win_mode='float' takes a window name or float coefficients "
            f"with |a_k| <= 1, got {name_or_coeffs!r} (looks like a "
            "quantized integer set — use win_mode='quantized' for those)"
        )
    return coeffs


def _nbytes(*ts) -> int:
    """The bytes of tensors, from their sizes (a view counts its elements)."""
    return sum(t.numel() * t.element_size() for t in ts)


def frames_view(x, nfft: int, hop: int):
    """Overlapped frames of the last axis: (..., T) -> (..., nF, nfft) with
    frame m = x[..., m*hop : m*hop+nfft]; requires T >= nfft and exact
    tiling ((T - nfft) % hop == 0).  A strided view: nothing is copied."""
    return x.unfold(-1, nfft, hop)


@_full_fp32()
def welch_power(x, win, nfft: int, hop: int, fft_mode: str = "rfft", device=None):
    """Single-device Welch periodogram: mean |rfft(frame * win)|^2 over
    frames.  x: (..., T) float (array-likes go to ``device``); win: (nfft,)
    float, cast to x's floating dtype.

    ``fft_mode="packed"`` transforms two real frames per complex FFT and
    reads the summed power back out of conjugate symmetry:
    |F_even|^2 + |F_odd|^2 = (|Z(k)|^2 + |Z(-k)|^2) / 2.
    ``fft_mode="mxu"`` does the same through matmul DFT stages; 1-D CUDA
    input at hop == nfft/2 goes through the fused stage-1 kernel.
    """
    x = _build.as_tensor(x, device=device)
    win = torch.as_tensor(win, dtype=_float_dtype(x), device=x.device)
    if (fft_mode == "mxu" and hop * 2 == nfft and x.ndim == 1
            and x.shape[-1] % hop == 0 and x.shape[-1] >= nfft
            and _fused_ok(nfft) and x.is_cuda):
        return _mxu_fused_mean_power(x, win, nfft)
    fr = frames_view(x, nfft, hop)
    with _trace.span("bhw.welch.apply", x.device, 2 * _nbytes(fr) + _nbytes(win)):
        fr = fr * win
    return frame_mean_power(fr, fft_mode)


def _fused_ok(nfft: int) -> bool:
    try:
        radices = _mxu_radices(nfft)
    except ValueError:
        return False
    return radices[0] == 128 and len(radices) >= 2


@_full_fp32()
def _mxu_fused_mean_power(x, win, nfft: int):
    """Welch mean power via the stage-1 kernel + tensordot tail."""
    radices = _mxu_radices(nfft)
    r0 = radices[0]
    # one of the (xr, xi) pair: a frame of each pair of frames
    pair_bytes = ((x.shape[-1] - nfft) // (nfft // 2) + 2) // 2 * nfft * x.element_size()
    with _trace.span("bhw.welch.fft", x.device, _nbytes(x, win) + 2 * pair_bytes):
        xr, xi, nf = welch_stage1_fused(x, win, nfft, r0=r0)
        npair = xr.shape[0]
        xr = xr.reshape((npair, r0) + radices[1:])
        xi = xi.reshape((npair, r0) + radices[1:])
        mats, tws = _dft_tables_on(nfft, x.device)
        ns = len(radices)
        for s in range(1, ns):
            mr, mi = mats[s]
            # contract the first remaining sample axis (always axis 2); the
            # output digit k_s lands at the tail
            yr = (torch.tensordot(xr, mr, dims=([2], [1]))
                  - torch.tensordot(xi, mi, dims=([2], [1])))
            yi = (torch.tensordot(xr, mi, dims=([2], [1]))
                  + torch.tensordot(xi, mr, dims=([2], [1])))
            xr, xi = yr, yi
            if s < ns - 1:
                # layout (pair, k_0, rest_dims..., k_1..k_{s-1}, k_s): k_0
                # sits ahead of the rest dims because the kernel did stage 0
                shape = (1, 1) + tuple(radices[s + 1:]) + (1,) * (s - 1) + (radices[s],)
                twr, twi = (v.T.reshape(shape) for v in tws[s])
                xr, xi = (xr * twr - xi * twi, xr * twi + xi * twr)
    with _trace.span("bhw.welch.power", x.device, 3 * pair_bytes):
        power = xr * xr + xi * xi
    with _trace.span("bhw.welch.mean", x.device,
                     pair_bytes + (nfft // 2 + 1) * x.element_size()):
        p = torch.sum(power, dim=0)  # (k_0, .., k_{ns-1})
        pk = p.permute(tuple(reversed(range(ns)))).reshape(nfft)
        k = nfft // 2 + 1
        pk_rev = torch.cat([pk[:1], torch.flip(pk[1:], dims=(0,))])
        return 0.5 * (pk[:k] + pk_rev[:k]) / nf


@_full_fp32()
def frame_mean_power(fr, fft_mode: str = "rfft"):
    """Mean half-spectrum power over windowed frames (..., nF, nfft) ->
    (..., nfft//2+1); the FFT stage shared by every welch path.

    ``fft_mode="mxu"``: packed complex frame pairs through mixed-radix
    Cooley-Tukey stages whose small DFTs are fp32 matmuls (radices <= 128,
    f64-host-exact tables).  Requires power-of-two nfft >= 256.
    """
    if fft_mode == "mxu":
        return _mxu_packed_mean_power(fr)
    if fft_mode not in ("rfft", "packed"):
        raise ValueError("fft_mode must be 'rfft', 'packed' or 'mxu'")
    dev, es = fr.device, fr.element_size()
    nfft, nf = fr.shape[-1], fr.shape[-2]
    k = nfft // 2 + 1
    half = fr.numel() // nfft * k * es  # one float per bin of every frame
    if fft_mode == "rfft":
        with _trace.span("bhw.welch.fft", dev, _nbytes(fr) + 2 * half):
            spec = torch.fft.rfft(fr, dim=-1)
        with _trace.span("bhw.welch.power", dev, 3 * half):
            mag = spec.abs()
            power = mag ** 2
        with _trace.span("bhw.welch.mean", dev, half + half // nf):
            return torch.mean(power, dim=-2)
    with _trace.span("bhw.welch.fft", dev, 2 * _nbytes(fr)):
        if nf % 2:  # pad one zero frame; it adds nothing to the power sum
            fr = torch.nn.functional.pad(fr, (0, 0, 0, 1))
        z = torch.complex(fr[..., 0::2, :], fr[..., 1::2, :])
        zf = torch.fft.fft(z, dim=-1)
    with _trace.span("bhw.welch.power", dev, _nbytes(zf) + half // nf * ((nf + 1) // 2)):
        p = zf.abs()
        del zf  # freed where the one expression freed it
        p = p ** 2  # (..., nF/2, nfft)
        # |Z(-k)|^2 for k = 0..nfft/2 is p reversed with the k=0 bin fixed
        p_rev = torch.cat([p[..., :1], torch.flip(p[..., 1:], dims=(-1,))], dim=-1)
        ps = 0.5 * (p[..., :k] + p_rev[..., :k])
    with _trace.span("bhw.welch.mean", dev, _nbytes(ps) + half // nf):
        return torch.sum(ps, dim=-2) / nf


def _mxu_radices(nfft: int) -> tuple[int, ...]:
    """Factor a power-of-two nfft into DFT radices: the fewest stages with
    every radix <= 128, split as evenly as possible."""
    if nfft < 256 or nfft & (nfft - 1):
        raise ValueError(
            "fft_mode='mxu' needs a power-of-two nfft >= 256 "
            f"(got {nfft}); use 'rfft' or 'packed'"
        )
    k = nfft.bit_length() - 1
    s = -(-k // 7)  # ceil: minimum stages with radix <= 2^7
    base, extra = divmod(k, s)
    return tuple(1 << (base + (1 if i < extra else 0)) for i in range(s))


@lru_cache(maxsize=8)
def _dft_tables(nfft: int):
    """Host-f64-exact DFT matrices and inter-stage twiddles for
    :func:`_mxu_radices`, as (real, imag) f32 numpy pairs."""
    radices = _mxu_radices(nfft)
    mats, tws = [], []
    for s_i, r in enumerate(radices):
        k = np.arange(r)
        ang = -2.0 * np.pi * (k[:, None] * k[None, :] % r) / r
        mats.append((np.cos(ang).astype(np.float32),
                     np.sin(ang).astype(np.float32)))
        if s_i < len(radices) - 1:
            nt = 1
            for rr in radices[s_i:]:
                nt *= rr
            ii, jj = np.arange(r), np.arange(nt // r)
            ang = -2.0 * np.pi * (ii[:, None] * jj[None, :] % nt) / nt
            tws.append((np.cos(ang).astype(np.float32),
                        np.sin(ang).astype(np.float32)))
    return radices, mats, tws


@lru_cache(maxsize=8)
def _dft_tables_on(nfft: int, device: torch.device):
    """``_dft_tables`` as float32 tensor pairs on ``device``."""
    _, mats, tws = _dft_tables(nfft)
    on = lambda pair: tuple(torch.from_numpy(v).to(device) for v in pair)
    return [on(m) for m in mats], [on(t) for t in tws]


@_full_fp32()
def _mxu_stages(xr, xi, nfft: int, nlead: int):
    """Run the mixed-radix matmul DFT stages over the trailing radix axes
    of (lead..., r_0, .., r_{ns-1}) real/imag tensors.  On return, axis
    nlead+i indexes output digit k_i with bin k = k_0 + r_0*k_1 + ...

    tensordot appends the contracted-output axis, so stage s always
    contracts the FIRST remaining sample axis (position ``nlead``) and the
    k axes accumulate at the tail in stage order, with no transposes."""
    radices = _mxu_radices(nfft)
    mats, tws = _dft_tables_on(nfft, xr.device)
    ns = len(radices)
    for s_i, r in enumerate(radices):
        mr, mi = mats[s_i]
        yr = (torch.tensordot(xr, mr, dims=([nlead], [1]))
              - torch.tensordot(xi, mi, dims=([nlead], [1])))
        yi = (torch.tensordot(xr, mi, dims=([nlead], [1]))
              + torch.tensordot(xi, mr, dims=([nlead], [1])))
        xr, xi = yr, yi
        if s_i < ns - 1:
            # table is (k_s, rest); broadcast it TRANSPOSED in the layout
            # (lead, rest_dims..., k_0..k_{s-1}, k_s)
            shape = (1,) * nlead + tuple(radices[s_i + 1:]) + (1,) * s_i + (r,)
            twr, twi = (v.T.reshape(shape) for v in tws[s_i])
            xr, xi = (xr * twr - xi * twi, xr * twi + xi * twr)
    return xr, xi, radices


def mxu_cfft(zr, zi):
    """Complex FFT over the last axis through matmul DFT stages, natural
    bin order: (..., M) real/imag f32 -> (..., M) real/imag f32.
    M must satisfy :func:`_mxu_radices` (power of two >= 256)."""
    m = zr.shape[-1]
    radices = _mxu_radices(m)
    lead = tuple(zr.shape[:-1])
    nl = len(lead)
    xr, xi, _ = _mxu_stages(zr.reshape(lead + radices),
                            zi.reshape(lead + radices), m, nl)
    perm = tuple(range(nl)) + tuple(nl + i for i in reversed(range(len(radices))))
    return (xr.permute(perm).reshape(lead + (m,)),
            xi.permute(perm).reshape(lead + (m,)))


def _mxu_packed_mean_power(fr):
    """The fft_mode="mxu" body: two real frames per complex input, matmul
    DFT stages, power-only unpack via conjugate symmetry."""
    nfft = fr.shape[-1]
    nf = fr.shape[-2]
    radices = _mxu_radices(nfft)
    lead = tuple(fr.shape[:-2])
    npair = (nf + 1) // 2
    nlead = len(lead) + 1
    # one of the (xr, xi) pair
    dev, pair_bytes = fr.device, _nbytes(fr) // nf * npair
    with _trace.span("bhw.welch.fft", dev, 4 * pair_bytes):
        if nf % 2:
            fr = torch.nn.functional.pad(fr, (0, 0, 0, 1))
        xr = fr[..., 0::2, :].reshape(lead + (npair,) + radices)
        xi = fr[..., 1::2, :].reshape(lead + (npair,) + radices)
        xr, xi, radices = _mxu_stages(xr, xi, nfft, nlead)
    ns = len(radices)
    with _trace.span("bhw.welch.power", dev, 3 * pair_bytes):
        power = xr * xr + xi * xi
    k = nfft // 2 + 1
    with _trace.span("bhw.welch.mean", dev, pair_bytes + _nbytes(power) // npair // nfft * k):
        p = torch.sum(power, dim=nlead - 1)  # sum over frame pairs
        # natural bin order = transpose to reversed radix axes, flatten
        nl = len(lead)
        perm = tuple(range(nl)) + tuple(nl + i for i in reversed(range(ns)))
        pk = p.permute(perm).reshape(lead + (nfft,))
        pk_rev = torch.cat([pk[..., :1], torch.flip(pk[..., 1:], dims=(-1,))], dim=-1)
        return 0.5 * (pk[..., :k] + pk_rev[..., :k]) / nf


@_full_fp32()
def rfft_power_split(x, fft_mode: str = "rfft", device=None):
    """``|rfft(x)|**2`` through one half-length complex FFT (JAX:
    ``rfft_power_split``): the even/odd split z[m] = x[2m] + j x[2m+1]
    (length N/2), Z = fft(z); with E(k) = (Z(k) + Z*(-k))/2 and O(k) =
    (Z(k) - Z*(-k))/(2j), X(k) = E(k) + e^{-2 pi j k / N} O(k) for k < N/2
    and X(N/2) = E(0) - O(0).  The twiddles are float32, as in JAX (bin
    error ~2e-7 relative).  x: (..., N) float32, N even; returns (...,
    N//2+1) float32.  ``fft_mode``: ``"rfft"`` takes ``torch.fft.fft`` for
    the half-length FFT, ``"mxu"`` the matmul DFT stages (:func:`mxu_cfft`,
    N/2 a power of two >= 256).  Array-like ``x`` goes to ``device``
    (default the card); a tensor runs where it lies."""
    x = _build.as_tensor(x, device=device)
    n = x.shape[-1]
    if n % 2:
        raise ValueError("rfft_power_split needs an even length")
    m = n // 2
    if fft_mode == "mxu":
        zf = torch.complex(*mxu_cfft(x[..., 0::2], x[..., 1::2]))
    else:
        zf = torch.fft.fft(torch.complex(x[..., 0::2], x[..., 1::2]), dim=-1)
    # Z*(-k)
    zrc = torch.conj(torch.cat([zf[..., :1], torch.flip(zf[..., 1:], dims=(-1,))], dim=-1))
    e = 0.5 * (zf + zrc)
    o = -0.5j * (zf - zrc)
    ang = np.float32(np.pi) * (torch.arange(m, dtype=torch.float32, device=x.device)
                               / np.float32(m))
    tw = torch.complex(torch.cos(ang), -torch.sin(ang))
    p = (e + tw * o).abs() ** 2
    pny = (e[..., :1] - o[..., :1]).abs() ** 2  # the Nyquist bin
    return torch.cat([p, pny], dim=-1)


def windowed_power_spectrum(x, name_or_coeffs, spec: WindowSpec, hop=None,
                            win_mode: str = "quantized",
                            fft_mode: str = "rfft", device=None):
    """Single-device analyzer: window generated on the fly (window kernel on
    x's device), applied, Welch-averaged.  nfft = spec.n.  Array-like ``x``
    goes to ``device`` (default the card); a tensor runs where it lies.

    ``win_mode="quantized"`` reproduces the reference's integer window
    datapath (``kernels.window.window_block``: the kernel of the window's
    source and contract), then scales to float for the FFT.
    ``win_mode="float"`` generates the window natively in float32
    (``kernels/floatwin.py``) and runs the same Welch path, so 1-D CUDA
    input at ``fft_mode="mxu"`` reaches the fused stage-1 kernel.
    ``win_mode="comp"`` generates the raw compensated (s, e) pair
    (``kernels/compwin.py``) and applies it as two products per sample,
    ``frame*s + frame*e``.

    Under a profiler session the call is the span ``bhw.welch`` and its
    stages ``bhw.welch.window``, ``.apply``, ``.fft``, ``.power`` and
    ``.mean`` (``_trace``).
    """
    with _trace.span("bhw.welch"):
        x = _build.as_tensor(x, device=device)
        nfft = spec.n
        hop = hop or nfft // 2
        if win_mode == "comp":
            with _trace.span("bhw.welch.window", x.device, 8 * nfft):
                whi, wlo = comp_window_pair(_check_float_window_arg(name_or_coeffs),
                                            spec.phase_width, device=x.device)
            fr = frames_view(x, nfft, hop)
            with _trace.span("bhw.welch.apply", x.device, 2 * _nbytes(fr) + 8 * nfft):
                fr = fr * whi + fr * wlo
            return frame_mean_power(fr, fft_mode)
        if win_mode not in ("quantized", "float"):
            raise ValueError("win_mode must be 'quantized', 'float' or 'comp'")
        with _trace.span("bhw.welch.window", x.device, 4 * nfft):
            if win_mode == "float":
                win = float_window(_check_float_window_arg(name_or_coeffs), spec.phase_width,
                                   device=x.device)
            else:
                if isinstance(name_or_coeffs, str):
                    d = catalog.get(name_or_coeffs)
                    coeffs_q, shift = d.quantized(spec.data_width), d.shift
                else:
                    coeffs_q, shift = tuple(name_or_coeffs), 1
                wq = _window.window_block(0, nfft, coeffs_q, spec, x.device)
                win = wq.to(torch.float32) * window_scale(spec, shift)
        return welch_power(x, win, nfft, hop, fft_mode)


def _quantized_window_fn(spec: WindowSpec, coeffs_q, shift: int, nfft: int):
    """win(device): the quantized float32 window of the sharded steps,
    generated on a shard's device by ``kernels.window.window_block`` (the
    window kernel for the CORDIC source) and scaled in float32."""
    coeffs_q = tuple(int(c) for c in coeffs_q)
    scale = float(np.float32(window_scale(spec, shift)))
    return lambda device: (_window.window_block(0, nfft, coeffs_q, spec, device)
                           .to(torch.float32) * scale)


def make_sharded_welch(mesh: Mesh, spec: WindowSpec, coeffs_q, shift: int, nfft: int, hop: int,
                       win_mode: str = "quantized", fft_mode: str = "rfft"):
    """Build the sharded analyzer step (JAX: ``make_sharded_welch``).

    The step takes a global x of shape (C, T) (a tensor, an array-like or a
    ``Sharded``), split ('channels', 'blocks'), and returns the (C,
    nfft//2+1) Welch spectrum as a ``Sharded`` with spec ('channels', None):
    replicated over 'blocks'.

    Per shard: the window is generated on the shard's device, the shard's
    time chunk is framed with a circular right halo of nfft - hop samples
    (one ppermute), its mean power is taken, and the powers are averaged
    over 'blocks' by ``pmean``.  ``win_mode="quantized"`` generates the
    window with ``kernels.window.window_block`` (the window kernel for the
    CORDIC source); ``"float"`` with the f32 outer write-out and ``"comp"``
    with the raw compensated pair, applied as ``fr*s + fr*e`` (for these two
    pass the window's name or float coefficients in ``coeffs_q``;
    ``shift`` is then unused).  Each shard's input is 2-D, so
    ``fft_mode="mxu"`` runs the matmul stages on materialized frames (the
    fused stage-1 kernel takes 1-D input only, in both packages).
    """
    halo = nfft - hop
    if win_mode in ("float", "comp"):
        if nfft != spec.n:
            raise ValueError(f"{win_mode} win_mode needs nfft == 2^phase_width")
        name_or_coeffs = _check_float_window_arg(coeffs_q)
        if win_mode == "float":
            def make_win(device):
                return float_window(name_or_coeffs, spec.phase_width, device=device)
        else:
            def make_win(device):
                return comp_window_pair(name_or_coeffs, spec.phase_width, device=device)
    elif win_mode == "quantized":
        make_win = _quantized_window_fn(spec, coeffs_q, shift, nfft)
    else:
        raise ValueError("win_mode must be 'quantized', 'float' or 'comp'")

    def shard_power(x, head):
        win = make_win(x.device)
        xh = torch.cat([x, head], dim=-1)
        if isinstance(win, tuple):  # the raw compensated (s, e) pair
            fr = frames_view(xh, nfft, hop)
            return frame_mean_power(fr * win[0] + fr * win[1], fft_mode)
        return welch_power(xh, win, nfft, hop, fft_mode)

    def step(x):
        xs = shard(x, mesh, ("channels", "blocks"))
        b = xs.piece().shape[-1]
        if b % hop:
            raise ValueError(f"shard block {b} must be a multiple of hop {hop}")
        rows = []
        for row in xs.shards:
            # the small halos first, then one shard's frames at a time
            heads = right_halo(row, halo, circular=True)
            rows.append(pmean(local_map(shard_power, row, heads)))
        return from_rows(mesh, ("channels", None), rows)

    return step
