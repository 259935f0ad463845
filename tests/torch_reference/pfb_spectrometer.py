"""The PFB spectrometer in plain torch: a critically sampled polyphase filter
bank over each input's real stream, its half spectrum, and each bin's power
integrated as the mean over ``n_acc`` spectra, every step in float64.

Independent of the code under test: it imports nothing of the program and
nothing of JAX, and takes nothing the program made.

- :func:`pfb_power`: x (..., T) ADC words (int8, or any real dtype) and the
  prototype h (C * taps,) -> (..., n_int, C//2 + 1) float64.  Per input,
  the capture as float64 frames of C, the branch FIRs as ``taps`` shifted
  products, v[m, p] = sum_t h[t C + p] x[(m + taps - 1 - t) C + p] over the
  frames whose taps all lie in the capture, then ``torch.fft.rfft`` of each
  frame of v in complex128, then P[i, k] = the mean of |Y[m, k]|^2 over
  the ``n_acc`` frames m of integration i, in blocks of integrations.  TF32
  is off while it runs.
- :func:`integrations`: n_int = (T // C - taps + 1) // n_acc, raising
  unless it is a positive whole number.
- :func:`prototype`: the filter bank's taps built here, not taken from the
  program: a C * taps windowed sinc, cutoff 1/C of Nyquist, under the
  four-term Blackman-Harris window (Harris 1978's coefficients), the
  window's cosine sum taken in float64 and rounded to W bits as the
  window's quantized golden model is, round((2^(W-1) - 1) w), sampled on a
  grid of 2^ceil(log2(C taps)) (at least 16) at the taps' positions, and
  the taps scaled to unity DC gain.

:func:`pfb_power_tf32` is the control: the same bank with the branch FIRs'
operands (the capture's words and the taps) rounded to TF32 (10 mantissa
bits, round to nearest even), the operands a TF32 convolution would take,
their products summed in float32 and a float32 ``rfft``, the power then
integrated in float64: one precision step below the float32 with TF32 off
that the spectrometer states.
"""

from __future__ import annotations

import torch

#: frames a block of the reference holds, about (a whole number of
#: integrations at least)
BLOCK_FRAMES = 1 << 12
#: the four-term Blackman-Harris window's coefficients (Harris 1978)
BH4 = (0.35875, 0.48829, 0.14128, 0.01168)


class _NoTf32:
    """TF32 off for matmuls and convolutions while inside; both flags
    restored on leaving."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def integrations(n_samples: int, c: int, taps: int, n_acc: int) -> int:
    """The whole integrations of ``n_acc`` spectra in a stream of
    ``n_samples``; raises unless its valid frames are a positive whole
    number of them."""
    if n_samples % c:
        raise ValueError("the capture must be a whole number of frames of C")
    valid = n_samples // c - taps + 1
    if n_acc < 1 or valid < n_acc or valid % n_acc:
        raise ValueError(f"{valid} valid frames are no whole number of integrations of {n_acc}")
    return valid // n_acc


def prototype(c: int, taps: int, data_width: int = 24) -> torch.Tensor:
    """The (C * taps,) float64 prototype of a C-channel bank with ``taps``
    taps a branch: h[n] = sinc(m / C) w[n] / C, m = n - (C taps - 1) / 2,
    over its sum; w the BH-4 window at ``data_width`` bits (module
    docstring)."""
    n_taps = c * taps
    grid = 1 << max(4, (n_taps - 1).bit_length())
    pos = (torch.arange(n_taps, dtype=torch.int64) * grid) // n_taps
    phase = 2.0 * torch.pi * pos.to(torch.float64) / grid
    w = torch.full((n_taps,), BH4[0], dtype=torch.float64)
    for k in range(1, len(BH4)):
        w = w + (-1) ** k * BH4[k] * torch.cos(k * phase)
    full = 2.0 ** (data_width - 1) - 1.0
    w = torch.round(full * w) / full
    m = torch.arange(n_taps, dtype=torch.float64) - (n_taps - 1) / 2.0
    h = torch.sinc(m / c) / c * w
    return h / h.sum()


def to_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest even."""
    b = v.contiguous().view(torch.int32)
    b = (b + (0xFFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


def _power(x: torch.Tensor, hp: torch.Tensor, c: int, n_acc: int,
           block: int) -> torch.Tensor:
    """(..., T) capture words already in the operands' dtype, (taps, C)
    branch taps -> (..., n_int, C//2 + 1) float64 integrated power."""
    taps = hp.shape[0]
    n_int = integrations(x.shape[-1], c, taps, n_acc)
    lead = x.shape[:-1]
    xs = x.reshape((-1, x.shape[-1] // c, c))
    out = torch.empty((xs.shape[0], n_int, c // 2 + 1), dtype=torch.float64, device=x.device)
    step = max(1, block // n_acc)  # integrations a block
    for f in range(xs.shape[0]):
        for i0 in range(0, n_int, step):
            i1 = min(n_int, i0 + step)
            a, b = i0 * n_acc, i1 * n_acc  # valid frames a..b-1
            v = hp[0] * xs[f, a + taps - 1:b + taps - 1]
            for t in range(1, taps):
                v = v + hp[t] * xs[f, a + taps - 1 - t:b + taps - 1 - t]
            y = torch.fft.rfft(v, dim=-1).to(torch.complex128)
            p = y.real ** 2 + y.imag ** 2
            out[f, i0:i1] = p.reshape(i1 - i0, n_acc, -1).mean(dim=1)
    return out.reshape(lead + out.shape[1:])


def pfb_power(x: torch.Tensor, h, c: int, n_acc: int, block: int = BLOCK_FRAMES) -> torch.Tensor:
    """The integrated power of capture ``x`` (..., T) by prototype ``h``
    (C * taps,) at C channels, float64 (..., n_int, C//2 + 1), on x's
    device."""
    h = torch.as_tensor(h, dtype=torch.float64, device=x.device)
    if h.numel() % c:
        raise ValueError("the prototype must be a whole number of frames of C")
    with _NoTf32():
        return _power(x.to(torch.float64), h.reshape(-1, c), c, n_acc, block)


def pfb_power_tf32(x: torch.Tensor, h, c: int, n_acc: int,
                   block: int = BLOCK_FRAMES) -> torch.Tensor:
    """The control: :func:`pfb_power` with the branch FIRs' operands rounded
    to TF32 and summed in float32, and a float32 ``rfft``."""
    h = torch.as_tensor(h, dtype=torch.float64, device=x.device)
    if h.numel() % c:
        raise ValueError("the prototype must be a whole number of frames of C")
    return _power(to_tf32(x.to(torch.float32)), to_tf32(h.to(torch.float32)).reshape(-1, c), c,
                  n_acc, block)
