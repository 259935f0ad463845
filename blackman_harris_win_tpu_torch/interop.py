"""Carry parameters across from the JAX package without importing it.

A window generator's only "weights" are its spec and its quantized
coefficients.  These helpers read the JAX package's objects by their fields
(duck-typed), so this package never imports ``jax``.  The DFT tables are
not carried: both packages build them from the same float64 numpy formula.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import CordicSpec, WindowSpec


def window_spec_from_reference(spec):
    """The port's ``WindowSpec`` or ``CordicSpec`` with the fields of a JAX
    package ``WindowSpec`` or ``CordicSpec`` (validated again here)."""
    if hasattr(spec, "sin_type"):
        return WindowSpec(
            phase_width=int(spec.phase_width),
            data_width=int(spec.data_width),
            sin_type=str(spec.sin_type),
            rounding=str(spec.rounding),
            overflow=str(spec.overflow),
            precision=int(spec.precision),
            lut_size=int(spec.lut_size),
        )
    if hasattr(spec, "flavor"):
        return CordicSpec(
            phase_width=int(spec.phase_width),
            data_width=int(spec.data_width),
            flavor=str(spec.flavor),
            precision=int(spec.precision),
        )
    raise TypeError(f"not a WindowSpec or CordicSpec: {spec!r}")


def coeffs_from_reference(coeffs_q) -> torch.Tensor:
    """A quantized coefficient tuple or numpy/JAX array as a 1-D torch int64
    tensor (the form the port's functions take, as do tuples of ints)."""
    a = np.asarray(coeffs_q)
    if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"expected a 1-D integer coefficient set, got {coeffs_q!r}")
    return torch.tensor([int(c) for c in a], dtype=torch.int64)
