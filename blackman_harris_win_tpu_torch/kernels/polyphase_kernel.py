"""The polyphase channelizer's branch FIRs as one CUDA kernel, and with
the DFT across the branches as a second one: bindings of
``csrc/polyphase_kernel.cu``.

``branch_fir(x, prototype, n_channels)`` is the commutator and the C branch
FIRs of a critically sampled DFT filter bank: x (..., T) real or complex, T
a multiple of C, the prototype C * tpb taps -> (..., n_frames, C) in x's
dtype (float32 for int8 ADC words), n_frames = T // C - tpb + 1 (the valid
region):

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
float32 or complex64 for it and its output rounded back; int8 (an ADC's
words) is taken as float32 on both routes, which holds it exactly, and its
output stays float32, the bits of its float32 copy's; any other dtype
raises.  A conjugated or negated view is read as its value.  The taps reach
the card once per prototype, dtype and device (:func:`prototype_taps`).  An
input with no valid frame gives an empty (..., 0, C) output, with no launch.

``branch_dft(x, prototype, n_channels)`` is the filter bank's whole output,
the channel bins Y[..., m, k] = sum_p e^{-2 pi i p k / C} y[..., m, p]: on a
card, where :func:`fuses_dft` admits the input (complex64, C = 128, at most
16 taps a branch: the SDR monitor's call), one launch (counter
``polyphase_dft``) that runs the DFT on the branch sums inside the kernel,
so they never reach device memory and no FFT reads them back; on the CPU
the plain versions, :func:`branch_fir_plain` then ``torch.fft.fft``.  Its
twiddles are :func:`dft_twiddles`, a float64 table rounded once.
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
#: integer words taken as float32 on both routes (exactly), the output kept
#: float32
_EXACT = {torch.int8: torch.float32}
#: the fused launch's channels and its most taps a branch
DFT_CHANNELS, DFT_MAX_TAPS = 128, 16


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


def fuses_dft(dtype: torch.dtype, n_channels: int, taps_per_branch: int) -> bool:
    """Whether a card runs the branch FIRs of this input and the DFT across
    its branches as one launch (:func:`branch_dft`): complex64 (complex32
    widened for it), C = 128 and at most 16 taps a branch, so that one block
    holds every branch of its frames and the taps fit one pass.  Anything
    else takes :func:`branch_fir`, then ``torch.fft``."""
    return (dtype in (torch.complex64, torch.complex32) and n_channels == DFT_CHANNELS
            and 1 <= taps_per_branch <= DFT_MAX_TAPS)


@lru_cache(maxsize=1)
def dft_twiddles() -> np.ndarray:
    """W_128^e = exp(-2 pi i e / 128), e = 0..127, the fused kernel's
    twiddles: float64 values rounded once to complex64 (read-only)."""
    e = np.arange(DFT_CHANNELS)
    t = np.exp(-2j * np.pi * e / DFT_CHANNELS).astype(np.complex64)
    t.flags.writeable = False
    return t


@lru_cache(maxsize=16)
def _twiddles_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(dft_twiddles().copy()).to(device)


def route(x: torch.Tensor, prototype, n_channels: int) -> tuple[np.ndarray, bool]:
    """The prototype's float64 taps, checked against ``n_channels``, and
    whether ``x``'s channel bins are one launch of the fused kernel
    (:func:`branch_dft`): on a card, for what :func:`fuses_dft` admits."""
    h, tpb = check_prototype(prototype, n_channels)
    return h, x.device.type == "cuda" and fuses_dft(x.dtype, n_channels, tpb)


def branch_fir(x: torch.Tensor, prototype, n_channels: int) -> torch.Tensor:
    """The polyphase branch FIRs of ``x``: (..., T) -> (..., n_frames, C),
    real or complex as ``x`` (float32 for int8).  A CPU tensor takes the
    plain version, a CUDA tensor one launch of the kernel (a half type
    widened for it, int8 taken as float32); a prototype or an input whose
    length is no multiple of C raises, and so does a CUDA tensor of a dtype
    the kernel does not take."""
    return _bank(x, prototype, n_channels, dft=False)


def branch_dft(x: torch.Tensor, prototype, n_channels: int) -> torch.Tensor:
    """The channel bins of ``x``: (..., T) -> (..., n_frames, C) complex,
    the DFT across the branches (``torch.fft.fft``'s sign) of
    :func:`branch_fir`'s output.  A CPU tensor takes the plain versions; a
    CUDA tensor one launch of the fused kernel, which takes what
    :func:`fuses_dft` admits and raises on anything else.  A conjugated view
    is read as its value; an input with no valid frame gives an empty
    (..., 0, C) output, with no launch."""
    return _bank(x, prototype, n_channels, dft=True)


def _bank(x: torch.Tensor, prototype, n_channels: int, dft: bool) -> torch.Tensor:
    """:func:`branch_fir` (``dft`` false) or :func:`branch_dft`: the checks,
    the CPU's plain route, widening, and one launch of ``polyphase_fir`` or
    ``polyphase_dft`` into a new (..., n_frames, C) output.  Takes what the
    kernel takes, half types (widened, the output rounded back) and int8
    (taken as float32, the output float32)."""
    c = n_channels
    h, tpb = check_prototype(prototype, c)
    if x.shape[-1] % c:
        raise ValueError("input length must be a multiple of n_channels")
    device = _build.resolve_device(x.device)
    if dft and device.type == "cuda" and not fuses_dft(x.dtype, c, tpb):
        raise TypeError(f"the fused polyphase kernel takes complex64 or complex32 at "
                        f"{DFT_CHANNELS} channels and up to {DFT_MAX_TAPS} taps a branch, got "
                        f"{x.dtype} at {c} channels and {tpb} taps")
    if x.dtype in _EXACT:
        x = x.to(_EXACT[x.dtype])
    nf = x.shape[-1] // c
    if nf < tpb:
        return x.new_empty(x.shape[:-1] + (0, c), dtype=torch.promote_types(
            x.dtype, torch.complex64) if dft else x.dtype)
    if device.type == "cpu":
        y = branch_fir_plain(x, h, c)
        return torch.fft.fft(y, dim=-1) if dft else y
    if x.dtype in _WIDEN:
        return _bank(x.to(_WIDEN[x.dtype]), h, c, dft).to(x.dtype)
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
    # strip 0: the launch sizes the strips to the card's resident threads
    if dft:
        _build.launch("polyphase_dft", device, y.data_ptr(), x.data_ptr(), taps.data_ptr(),
                      _twiddles_on(device).data_ptr(), rows, nf, tpb, 0)
    else:
        _build.launch("polyphase_fir", device, y.data_ptr(), x.data_ptr(), taps.data_ptr(), rows,
                      nf, c, tpb, 0, 2 if x.is_complex() else 1, taps.element_size())
    return y
