"""Welch front half: framing + window + frame-pair packing + DFT stage 1 +
twiddle in one kernel (counterpart of
``blackman_harris_win_tpu/kernels/pallas/welchfft_kernel.py``).

At 50% overlap the Welch frame pairs are contiguous in x (pair b's even
frame starts at b*nfft, odd at b*nfft + hop), so one pass over x forms

    z = (even * w) + j (odd * w)          [pack]
    y = M_r0 @ z                          [r0-point DFT, full fp32]
    out = y * W_N^{k0 * rest}             [stage-1 twiddle]

``welch_stage1_fused`` runs the CUDA kernel (``csrc/welchfft_kernel.cu``)
for a CUDA tensor and ``welch_stage1_plain`` for a CPU tensor.
Requires hop == nfft/2 and leading radix r0 == 128.  The kernel computes
the DFT-128 as an FFT (an 8-point DFT over n2 for each n1 of n0 = n1 +
16*n2, the twiddle W128^(n1*k2), a 16-point DFT over n1 for each k2 of
k0 = k2 + 8*k1) whose roots all come from ``_fft128_roots``; the plain
version keeps the direct DFT-matrix product.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build

#: output columns per CUDA block (csrc/welchfft_kernel.cu kJT)
_KERNEL_COLS = 32


@lru_cache(maxsize=8)
def _tables(nfft: int, r0: int):
    """DFT-r0 matrix + stage-1 twiddle W_nfft^{k0*rest}, f64-host-exact
    (real, imag) f32 numpy pairs (the same formula as the JAX package)."""
    k = np.arange(r0)
    ang = -2.0 * np.pi * (k[:, None] * k[None, :] % r0) / r0
    m0 = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    rest = nfft // r0
    ii, jj = np.arange(r0), np.arange(rest)
    ang = -2.0 * np.pi * (ii[:, None] * jj[None, :] % nfft) / nfft
    t1 = (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))
    return m0, t1


@lru_cache(maxsize=1)
def _fft128_roots():
    """W128^m = exp(-2 pi i m / 128) for m < 64, the CUDA kernel's only roots
    (W128^(m+64) = -W128^m), built in float64 and rounded to float32 as
    ``_tables`` builds the DFT matrix: (real, imag) f32 numpy pair."""
    ang = -2.0 * np.pi * np.arange(64) / 128
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=8)
def _tables_on(nfft: int, r0: int, device: torch.device):
    """``_tables`` as four float32 tensors (m0r, m0i, t1r, t1i) on ``device``."""
    (m0r, m0i), (t1r, t1i) = _tables(nfft, r0)
    return tuple(torch.from_numpy(v).to(device) for v in (m0r, m0i, t1r, t1i))


@lru_cache(maxsize=8)
def _kernel_tables_on(nfft: int, device: torch.device):
    """The CUDA kernel's tables on ``device``: the FFT-128 roots and the
    stage-1 twiddle (wr, wi, t1r, t1i), float32."""
    (t1r, t1i) = _tables(nfft, 128)[1]
    return tuple(torch.from_numpy(v).to(device) for v in (*_fft128_roots(), t1r, t1i))


def _geometry(x, nfft: int, r0: int):
    t = x.shape[-1]
    hop = nfft // 2
    if x.ndim != 1 or t % hop or t < nfft:
        raise ValueError("welch_stage1_fused needs 1-D x, T % (nfft/2) == 0")
    if nfft % r0 or r0 % 2:
        raise ValueError(f"nfft {nfft} must be a multiple of r0 {r0}")
    nf = (t - nfft) // hop + 1
    return t, nf, (nf + 1) // 2


def welch_stage1_plain(x, win, nfft: int, r0: int = 128):
    """Plain version of the kernel: the JAX ``_kernel`` math in torch
    float32 ops.  Returns (out_r, out_i): (npair, r0, nfft//r0) each, and
    the frame count nf."""
    t, nf, npair = _geometry(x, nfft, r0)
    rest, half = nfft // r0, r0 // 2
    pad = npair * nfft + nfft // 2 - t
    xp = torch.cat([x, x.new_zeros(pad)]).reshape(2 * npair + 1, half, rest)
    even = torch.cat([xp[0:-1:2], xp[1::2]], dim=1)  # (npair, r0, rest)
    odd = torch.cat([xp[1::2], xp[2::2]], dim=1)
    if nf % 2:
        odd[-1] = 0.0  # the last pair's odd member is the zero pad frame
    w = win.to(torch.float32).reshape(r0, rest)
    zr, zi = even * w, odd * w
    m0r, m0i, t1r, t1i = _tables_on(nfft, r0, x.device)
    yr = torch.matmul(m0r, zr) - torch.matmul(m0i, zi)
    yi = torch.matmul(m0r, zi) + torch.matmul(m0i, zr)
    return yr * t1r - yi * t1i, yr * t1i + yi * t1r, nf


def welch_stage1_fused(x, win, nfft: int, r0: int = 128):
    """Stage-1 output A[b, k0, rest] = tw1 * (DFT_r0 over n0 of the packed
    windowed frame pairs of ``x``), framing fused (hop = nfft/2).

    x: (T,) float32 with T a multiple of hop; win: (nfft,) float32.
    Returns (out_r, out_i): (npair, r0, nfft//r0) f32 each, plus the frame
    count nf.  CPU tensors take the plain version, CUDA tensors the kernel.
    """
    t, nf, npair = _geometry(x, nfft, r0)
    device = _build.resolve_device(x.device)
    if device.type == "cpu":
        return welch_stage1_plain(x, win, nfft, r0)
    rest = nfft // r0
    if r0 != 128 or rest % _KERNEL_COLS or npair >= 1 << 31:
        raise ValueError(
            "the CUDA stage-1 kernel needs r0 == 128, nfft/128 a multiple of "
            f"{_KERNEL_COLS} and fewer than 2^31 frame pairs"
        )
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 tensor")
    if (win.shape != (nfft,) or win.dtype != torch.float32
            or win.device != x.device or not win.is_contiguous()):
        raise ValueError("win must be a contiguous (nfft,) float32 tensor on x's device")
    wr, wi, t1r, t1i = _kernel_tables_on(nfft, device)
    out_r = torch.empty((npair, r0, rest), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    _build.launch("welch_stage1", device, x.data_ptr(), t, win.data_ptr(), wr.data_ptr(),
                  wi.data_ptr(), t1r.data_ptr(), t1i.data_ptr(), out_r.data_ptr(),
                  out_i.data_ptr(), nfft, npair, nf % 2)
    return out_r, out_i, nf
