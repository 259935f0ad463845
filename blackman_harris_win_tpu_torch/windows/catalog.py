"""Window catalog: every cosine-sum coefficient set the reference supports
(counterpart of ``blackman_harris_win_tpu/windows/catalog.py``; the
coefficients are copied verbatim and a test holds the two catalogs equal).

Window *shape* is data (runtime coefficients), window *length/width* is
config — the reference's split between AA0..AA6 runtime ports and
PHI_WIDTH/DAT_WIDTH generics (``src/win_selector.vhd:61-81``).  The sources
of each set are cited in the JAX package's catalog.

``shift`` is the coefficient-quantization headroom rule: 1 for 2..4-term,
2 for 5/7-term (``hls/windows/win_function.cpp:176,349``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.fixedpoint import quantize_coeffs


@dataclass(frozen=True)
class WindowDef:
    name: str
    coeffs: tuple[float, ...]  # a0, a1, ... aK (signs alternate: +,-,+,-,...)
    shift: int  # quantization headroom: round(a * (2^(W-shift)-1))
    sidelobe_db: float | None  # published side-lobe level (README.md:30-41)
    hls_sel: int | None = None  # win_function() selector code, if any

    @property
    def n_terms(self) -> int:
        return len(self.coeffs)

    def quantized(self, data_width: int) -> tuple[int, ...]:
        return quantize_coeffs(self.coeffs, data_width, self.shift)


_DEFS = [
    WindowDef("hamming", (0.5434783, 1.0 - 0.5434783), 1, -43.0, hls_sel=0x1),
    WindowDef("hann", (0.5, 0.5), 1, -32.0, hls_sel=0x2),
    WindowDef("bh3_hls", (0.21, 0.25, 0.04), 1, None, hls_sel=0x3),
    WindowDef("blackman", (0.42, 0.5, 0.08), 1, -58.0),
    WindowDef("bh3", (0.4243801, 0.4973406, 0.0782793), 1, -71.0),
    WindowDef("bh4", (0.35875, 0.48829, 0.14128, 0.01168), 1, -92.0, hls_sel=0x4),
    WindowDef("nuttall", (0.355768, 0.487396, 0.144323, 0.012604), 1, -93.0),
    WindowDef(
        "blackman_nuttall", (0.3635819, 0.4891775, 0.1365995, 0.0106411), 1, -98.0
    ),
    WindowDef(
        "bh5",
        (
            0.3232153788877343,
            0.4714921439576260,
            0.1755341299601972,
            0.0284969901061499,
            0.0012613570882927,
        ),
        2,
        -124.0,
        hls_sel=0x5,
    ),
    WindowDef("flattop1", (0.25, 0.4925, 0.3225, 0.097, 0.0075), 2, -69.0),
    WindowDef(
        "flattop2",
        (0.215578950, 0.416631580, 0.277263158, 0.083578947, 0.006947368),
        2,
        -69.0,
    ),
    WindowDef(
        "bh7",
        (
            0.271220360585039,
            0.433444612327442,
            0.218004122892930,
            0.065785343295606,
            0.010761867305342,
            0.000770012710581,
            0.000013680883060,
        ),
        2,
        -180.0,
        hls_sel=0x7,
    ),
    WindowDef(
        "bh7_readme",
        (
            0.27105140069342,
            0.43329793923448,
            0.21812299954311,
            0.06592544638803,
            0.01081174209837,
            0.00077658482522,
            0.00001388721735,
        ),
        2,
        -180.0,
    ),
]

CATALOG: dict[str, WindowDef] = {d.name: d for d in _DEFS}

#: HLS win_function() selector code -> window name
HLS_SEL: dict[int, str] = {d.hls_sel: d.name for d in _DEFS if d.hls_sel is not None}


def names() -> list[str]:
    """Catalog window names, in definition order."""
    return [d.name for d in _DEFS]


def get(name: str) -> WindowDef:
    try:
        return CATALOG[name]
    except KeyError:
        raise KeyError(
            f"unknown window {name!r}; available: {sorted(CATALOG)}"
        ) from None


def float_window_value(name: str, n, N: int):
    """Float reference ``w[n] = a0 - a1 cos(2 pi n/N) + a2 cos(4 pi n/N) - ...``
    (math/window_test.m:122-138).  Host numpy, float64, vectorized over ``n``."""
    d = get(name)
    n = np.asarray(n, dtype=np.float64)
    acc = np.full_like(n, d.coeffs[0], dtype=np.float64)
    for k in range(1, d.n_terms):
        term = d.coeffs[k] * np.cos(2.0 * np.pi * k * n / N)
        acc = acc - term if k % 2 == 1 else acc + term
    return acc


def golden_quantized_window(name: str, n, N: int, data_width: int):
    """The reference's quantized golden model:
    ``round((2^(W-shift) - 1) * w_float[n])`` (hls/windows/window_test.cpp:196,
    math/window_test.m:139), as int64 numpy."""
    d = get(name)
    w = float_window_value(name, n, N)
    return np.round((2.0 ** (data_width - d.shift) - 1.0) * w).astype(np.int64)
