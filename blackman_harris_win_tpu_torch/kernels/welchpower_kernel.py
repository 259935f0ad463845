"""The Welch analyzer's power mean over frames as one CUDA kernel: binding
of ``csrc/welchpower_kernel.cu``.

``frame_power_mean(spec)`` is ``torch.mean(spec.abs() ** 2, dim=-2)`` for
an rfft half spectrum ``spec`` of shape (..., nF, K): the kernel reads the
complex spectrum once, sums re*re + im*im over the frames of each bin in
float64 and writes the mean in the real dtype of ``spec``.  No complex
``abs`` buffer, real-part copy or squared array is written.  It replaces no
Pallas kernel: the JAX package's rfft branch of ``frame_mean_power`` is
jnp (``blackman_harris_win_tpu/pipeline/spectral.py:172-174``), which XLA
fuses.

Where the columns (leading dims x K) alone cannot fill the card, the frames
are cut into slabs (:func:`frame_slabs`); each slab's float64 partial sums
go to scratch and a second pass adds them in slab order, so the result is
the same bits on every run.

Under a profiler session the card's pass is one span, ``<span>.power``
(the spectrum read once, the mean written); the plain version keeps two,
``<span>.power`` (``abs``, ``** 2``) and ``<span>.mean``: ``span`` is the
caller's root, the Welch analyzer's ``bhw.welch`` unless given (the
spectrometer's ``bhw.pfb``).
"""

from __future__ import annotations

import torch

from .. import _build, _trace

#: columns (leading dims x bins) at or above which the frames stay one slab:
#: about two loads of the H100's 132 x 2048 resident threads (the analyzer's
#: 524289 columns ran 0.369 ms as one slab, 0.388-0.414 ms as 2-8)
FULL_COLUMNS = 1 << 19
#: the fewest frames a slab sums
MIN_SLAB_FRAMES = 16
#: gridDim.y's limit
MAX_SLABS = 65535


def frame_slabs(cols: int, nf: int) -> int:
    """The slabs the kernel cuts ``nf`` frames into for ``cols`` columns:
    one where the columns fill the card, else enough to bring the columns
    times the slabs to :data:`FULL_COLUMNS`, each slab at least
    :data:`MIN_SLAB_FRAMES` frames; trimmed so that no slab of
    ceil(nf / slabs) frames is empty."""
    if cols >= FULL_COLUMNS or nf < 2 * MIN_SLAB_FRAMES:
        return 1
    slabs = min(-(-FULL_COLUMNS // max(cols, 1)), nf // MIN_SLAB_FRAMES, MAX_SLABS)
    per = -(-nf // slabs)
    return -(-nf // per)


def check_spec(spec: torch.Tensor) -> torch.device:
    """The device :func:`frame_power_mean` runs ``spec`` on; raises unless
    ``spec`` is a contiguous complex64 or complex128 tensor (..., nF, K)
    with at least one frame, on the CPU or a CUDA device."""
    device = _build.resolve_device(spec.device)
    if spec.dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"spec must be complex64 or complex128, got {spec.dtype}")
    if spec.ndim < 2 or not spec.is_contiguous():
        raise ValueError("spec must be a contiguous (..., nF, K) tensor")
    if spec.shape[-2] == 0:
        raise ValueError("spec has no frames to average")
    return device


def frame_power_mean_plain(spec: torch.Tensor, span: str = "bhw.welch") -> torch.Tensor:
    """Plain version of the kernel: ``torch.mean(spec.abs() ** 2, dim=-2)``."""
    with _trace.span(f"{span}.power", spec.device):
        power = spec.abs() ** 2
    with _trace.span(f"{span}.mean", spec.device):
        return torch.mean(power, dim=-2)


def frame_power_mean(spec: torch.Tensor, span: str = "bhw.welch") -> torch.Tensor:
    """Mean over frames of ``|spec|**2``: (..., nF, K) complex -> (..., K)
    real.  A CPU tensor takes the plain version, a CUDA tensor the kernel
    (counter ``welch_power_mean``); anything :func:`check_spec` refuses
    raises.  ``span``: the root of its spans (the module's docstring)."""
    device = check_spec(spec)
    if device.type == "cpu":
        return frame_power_mean_plain(spec, span)
    nf, k = spec.shape[-2], spec.shape[-1]
    out = torch.empty(spec.shape[:-2] + (k,), dtype=spec.real.dtype, device=device)
    cols = out.numel()
    if not cols:
        return out
    with _trace.span(f"{span}.power", device):
        slabs = frame_slabs(cols, nf)
        part = torch.empty((slabs, cols), dtype=torch.float64, device=device) if slabs > 1 else None
        _build.launch("welch_power_mean", device, out.data_ptr(), spec.data_ptr(),
                      None if part is None else part.data_ptr(), cols // k, nf, k, slabs,
                      spec.element_size())
    return out
