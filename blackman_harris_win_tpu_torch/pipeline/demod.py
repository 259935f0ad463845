"""Quadrature (FM) demodulation on the fixed-point atan2 engine (counterpart
of ``blackman_harris_win_tpu/pipeline/demod.py``).

- :func:`fm_demod_phase`: unwrap-free phase-difference demod,
  d[n] = wrap(phi[n] - phi[n-1]) with phi from :func:`atan2_fixed`.
- :func:`fm_demod_conj`: conjugate-product demod, the discriminator
  atan2(Im(z[n] conj(z[n-1])), Re(...)), more robust near the +-pi seam.

Both return the instantaneous frequency in angle LSBs (pi == 2^(AW-1));
multiply by fs / 2^AW for Hz.  On a card both are one launch of the demod
kernel (``kernels/demod_kernel.py:fm_demod``), which reads int32 or int64
I/Q in place; elsewhere their plain versions run, int64 torch ops in which
the conjugate products wrap to 32 bits as the JAX package's int32 lanes do.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.fixedpoint import wrap
from ..kernels.cordic import atan2_fixed_plain


def phase_wrap(d, angle_width: int):
    """Wrap angle differences into [-pi, pi) == [-2^(AW-1), 2^(AW-1))."""
    full = 1 << angle_width
    half = 1 << (angle_width - 1)
    return ((d + half) & (full - 1)) - half


def _iq(i, q, device):
    i = _build.as_tensor(i, device=device)
    return i, _build.as_tensor(q, device=i.device)


def fm_demod_phase(i, q, input_width: int, angle_width: int = 24, device=None):
    """Instantaneous frequency from I/Q integer streams (..., T) ->
    (..., T-1) in angle LSBs."""
    i, q = _iq(i, q, device)
    if i.device.type == "cuda":
        from ..kernels.demod_kernel import fm_demod

        return fm_demod(i, q, input_width, angle_width, "phase")
    return fm_demod_phase_plain(i, q, input_width, angle_width)


def fm_demod_conj(i, q, input_width: int, angle_width: int = 24, device=None):
    """Conjugate-product discriminator.  z[n] * conj(z[n-1]) =
    (i1 i0 + q1 q0) + j (q1 i0 - i1 q0); inputs are re-quantized to <= 15
    bits so the products fit 32 bits (as a DSP48-based discriminator
    would truncate)."""
    i, q = _iq(i, q, device)
    if i.device.type == "cuda":
        from ..kernels.demod_kernel import fm_demod

        return fm_demod(i, q, input_width, angle_width, "conj")
    return fm_demod_conj_plain(i, q, input_width, angle_width)


def fm_demod_phase_plain(i, q, input_width: int, angle_width: int = 24):
    """Plain version of :func:`fm_demod_phase`: int64 torch ops on the
    inputs' device."""
    i = torch.as_tensor(i, dtype=torch.int64)
    q = torch.as_tensor(q, dtype=torch.int64)
    phi = atan2_fixed_plain(q, i, input_width, angle_width)
    return phase_wrap(phi[..., 1:] - phi[..., :-1], angle_width)


def fm_demod_conj_plain(i, q, input_width: int, angle_width: int = 24):
    """Plain version of :func:`fm_demod_conj`: int64 torch ops on the
    inputs' device."""
    i = torch.as_tensor(i, dtype=torch.int64)
    q = torch.as_tensor(q, dtype=torch.int64)
    drop = max(0, input_width - 15)
    i15, q15 = wrap(i >> drop, 32), wrap(q >> drop, 32)
    iw15 = input_width - drop

    i0, i1 = i15[..., :-1], i15[..., 1:]
    q0, q1 = q15[..., :-1], q15[..., 1:]
    re = wrap(i1 * i0 + q1 * q0, 32)
    im = wrap(q1 * i0 - i1 * q0, 32)
    # products fit 2*iw15 bits; the atan2 datapath consumes the low AW-1
    # bits, so scale down into the engine's input range
    shift = max(0, 2 * iw15 - (angle_width - 1))
    return atan2_fixed_plain(im >> shift, re >> shift, angle_width, angle_width)
