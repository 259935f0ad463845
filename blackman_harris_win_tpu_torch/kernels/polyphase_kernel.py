"""The polyphase channelizer's branch FIRs as one CUDA kernel: binding of
``csrc/polyphase_kernel.cu``.

``branch_fir(x, prototype, n_channels)`` is the commutator and the C branch
FIRs of a critically sampled DFT filter bank: x (..., T) real or complex, T
a multiple of C, the prototype C * tpb taps -> (..., n_frames, C) in x's
dtype, n_frames = T // C - tpb + 1 (the valid region):

    y[..., m, p] = sum_t h[t C + p] * x[..., (m + tpb - 1 - t) C + p]

The kernel reads x in place (branch p of frame m is x[m C + p], so the
commutator is indexing) and writes the output contiguous, the layout
``torch.fft.fft`` and ``torch.fft.rfft`` read along the last dim with no
copy.  It sums each output over t in one fixed order, FMA by FMA in x's
real type, whatever strip of frames the output falls in: a channelizer
that re-reads a halo (the sharded chain) gives the same bits.  It replaces
no Pallas kernel: the JAX package's channelizer is jnp
(``blackman_harris_win_tpu/pipeline/channelizer.py``), which XLA fuses; it
is bound by bytes, and the source says what its design does about that.

A CPU tensor takes the plain version, :func:`branch_fir_plain` (the
commutator reshape and grouped ``conv1d``s, TF32 off); a CUDA tensor the
kernel (counter ``polyphase_fir``), which takes float32, float64, complex64
and complex128: a half type (float16, bfloat16, complex32) is widened to
float32 or complex64 for it and its output rounded back, and any other dtype
raises.  A conjugated or negated view is read as its value.  The taps reach
the card once per prototype, dtype and device (:func:`prototype_taps`).  An
input with no valid frame gives an empty (..., 0, C) output, with no launch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import _build

#: the dtypes the kernel takes
KERNEL_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)
_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
#: half types the wrapper widens for the kernel, and back
_WIDEN = {torch.float16: torch.float32, torch.bfloat16: torch.float32,
          torch.complex32: torch.complex64}


def check_prototype(prototype, n_channels: int) -> tuple[np.ndarray, int]:
    """The prototype as float64 taps and its taps a branch; raises unless
    its length is a multiple of ``n_channels``."""
    h = np.asarray(prototype, np.float64)
    if h.size % n_channels:
        raise ValueError("prototype length must be a multiple of n_channels")
    return h, h.size // n_channels


def prototype_taps(prototype, dtype: torch.dtype, device) -> torch.Tensor:
    """The prototype's taps as a (tpb * C,) ``dtype`` tensor on ``device``
    (read-only by contract), made once per prototype (by its float64
    bytes), dtype and device."""
    return _taps_on(np.asarray(prototype, np.float64).tobytes(), dtype, torch.device(device))


@lru_cache(maxsize=16)
def _taps_on(key: bytes, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(key, np.float64).copy(), dtype=dtype, device=device)


def branch_fir_plain(x: torch.Tensor, prototype, n_channels: int) -> torch.Tensor:
    """Plain version of the kernel, on ``x``'s device: the commutator
    reshape, then the C branch FIRs as one grouped ``conv1d`` (groups = C)
    with flipped taps (``conv1d`` correlates) over the real and imaginary
    views of a complex ``x`` in turn, TF32 off, and ``torch.complex``."""
    from ..pipeline.spectral import _full_fp32

    c = n_channels
    h, tpb = check_prototype(prototype, c)
    if x.shape[-1] % c:
        raise ValueError("input length must be a multiple of n_channels")

    lead = x.shape[:-1]
    # commutator: sample n -> branch p = n mod C, frame n // C
    xp = x.reshape(lead + (x.shape[-1] // c, c))  # (..., frame, branch)
    rdt = x.real.dtype if x.is_complex() else x.dtype
    # branch FIR y_p[m] = sum_t h[t*C + p] x[(m - t)*C + p] is a true
    # convolution: flip the taps for conv1d's correlation
    hp = torch.as_tensor(h.reshape(tpb, c), dtype=rdt, device=x.device)
    kk = torch.flip(hp, dims=(0,)).T.reshape(c, 1, tpb)  # (out, in/groups, width)

    def branches_conv(sig):  # (..., nf, c) -> (..., nf_out, c)
        s = sig.reshape((-1,) + tuple(sig.shape[-2:])).transpose(1, 2)  # (B, c, nf)
        y = torch.nn.functional.conv1d(s, kk, groups=c).transpose(1, 2)  # (B, nf_out, c)
        return y.reshape(tuple(sig.shape[:-2]) + tuple(y.shape[-2:]))

    with _full_fp32():
        if xp.is_complex():
            return torch.complex(branches_conv(xp.real), branches_conv(xp.imag))
        return branches_conv(xp)


def branch_fir(x: torch.Tensor, prototype, n_channels: int) -> torch.Tensor:
    """The polyphase branch FIRs of ``x``: (..., T) -> (..., n_frames, C),
    real or complex as ``x``.  A CPU tensor takes the plain version, a CUDA
    tensor one launch of the kernel (a half type widened for it); a
    prototype or an input whose length is no multiple of C raises, and so
    does a CUDA tensor of a dtype the kernel does not take."""
    c = n_channels
    h, tpb = check_prototype(prototype, c)
    if x.shape[-1] % c:
        raise ValueError("input length must be a multiple of n_channels")
    device = _build.resolve_device(x.device)
    nf = x.shape[-1] // c
    if nf < tpb:
        return x.new_empty(x.shape[:-1] + (0, c))
    if device.type == "cpu":
        return branch_fir_plain(x, h, c)
    if x.dtype in _WIDEN:
        return branch_fir(x.to(_WIDEN[x.dtype]), h, c).to(x.dtype)
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the polyphase kernel takes float32, float64, complex64 or complex128, "
                        f"got {x.dtype}")
    nout = nf - tpb + 1
    y = torch.empty(x.shape[:-1] + (nout, c), dtype=x.dtype, device=device)
    rows = y.numel() // (nout * c)
    if not rows:
        return y
    # a conjugated or negated view keeps its bit through contiguous(): the
    # kernel reads the storage, so the bits are resolved first
    x = x.resolve_conj().resolve_neg().contiguous()
    taps = prototype_taps(h, _REAL.get(x.dtype, x.dtype), device)
    lanes = 2 if x.is_complex() else 1
    # strip 0: the launch sizes the strips to the card's resident threads
    _build.launch("polyphase_fir", device, y.data_ptr(), x.data_ptr(), taps.data_ptr(), rows, nf,
                  c, tpb, 0, lanes, taps.element_size())
    return y
