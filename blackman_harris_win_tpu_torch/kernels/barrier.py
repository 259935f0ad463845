"""Materialization barrier: an identity copy (counterpart of
``blackman_harris_win_tpu/kernels/pallas/barrier.py``).

In the JAX package this Pallas copy kept XLA from fusing the DDC's CORDIC
mixer into the strided conv of ``pipeline/fir.py``'s bulk branch, where it
was recomputed once per overlapping tap window.  Eager PyTorch already
materialises the mixer output, so the port's kernel (``csrc/barrier_kernel.cu``,
kernel 7) is the copy alone: one read and one write of the array,
bandwidth-bound.  It stays on the DDC path as in the JAX package, and its
cost is measured there.
"""

from __future__ import annotations

import torch

from .. import _build


def materialize_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``x.clone()``."""
    return x.clone()


def materialize(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in a new tensor: the plain version for a CPU tensor,
    the copy kernel for a CUDA tensor (never ``x`` itself).  A strided input
    is made contiguous first (a torch copy), and the kernel copies that; the
    output is contiguous.  A zero-size tensor needs no launch."""
    device = _build.resolve_device(x.device)
    if device.type == "cpu":
        return materialize_plain(x)
    src = x.contiguous()
    out = torch.empty_like(src)
    nbytes = src.numel() * src.element_size()
    if nbytes:
        with torch.cuda.device(device):
            rc = _build.lib().bhw_materialize(out.data_ptr(), src.data_ptr(), nbytes,
                                              _build.stream_of(device))
        _build.check("materialize", rc)
    return out
