"""win_selector parity front-end (counterpart of
``blackman_harris_win_tpu/windows/selector.py``; same surface, same
validation).

The reference's entire user API is one entity with string generics
(``src/win_selector.vhd:60-87``): ``WIN_TYPE`` in {HAMMING, BH3TERM, BH4TERM,
BH5TERM, BH7TERM}, ``SIN_TYPE`` in {CORDIC, TAYLOR}, plus PHI_WIDTH /
DAT_WIDTH / LUT_SIZE / XSERIES generics and AA0..AA6 runtime coefficient
ports.  Elaboration-time generate dispatch becomes a spec construction, and
the coefficient ports stay runtime data.

XSERIES picks the DSP48 primitive family in hardware; it is accepted for
signature parity and has no effect on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build
from ..core.config import WindowSpec
from ..kernels.window import rtl_cordic_coeffs, window_block, window_samples
from . import catalog

#: WIN_TYPE generic -> (window core term count, default coefficient set)
_WIN_TYPES = {
    "HAMMING": (2, "hamming"),
    "BH3TERM": (3, "bh3"),
    "BH4TERM": (4, "bh4"),
    "BH5TERM": (5, "bh5"),
    "BH7TERM": (7, "bh7"),
}


@dataclass(frozen=True)
class WinSelector:
    """Instantiated window front-end (the win_selector entity).

    ``aa``: the AA0..AAk coefficient ports (quantized ints).  If omitted,
    the default set for the WIN_TYPE is quantized at DAT_WIDTH.  SIN_TYPE
    TAYLOR is only legal for HAMMING/BH3TERM (src/win_selector.vhd:93-147:
    only the 2/3-term cores receive SIN_TYPE/LUT_SIZE).
    """

    win_type: str
    phi_width: int
    dat_width: int
    sin_type: str = "CORDIC"
    lut_size: int = 9
    xseries: str = "ULTRA"  # accepted for parity; no effect on the card
    aa: tuple[int, ...] | None = None
    rounding: str = "hls"
    overflow: str = "saturate"
    #: rounding="rtl" + CORDIC only: halve the AA0 port so the window has
    #: its published floor instead of the half-gain DC pedestal (the VHDL
    #: product datapath is scaled for the full-scale TAYLOR cos source;
    #: kernels/window.rtl_cordic_coeffs).  Default False = faithful raw-port
    #: semantics.
    rtl_a0_correction: bool = False

    def __post_init__(self):
        if self.win_type not in _WIN_TYPES:
            raise ValueError(
                f"WIN_TYPE must be one of {sorted(_WIN_TYPES)} "
                "(src/win_selector.vhd:60-87)"
            )
        if self.sin_type not in ("CORDIC", "TAYLOR"):
            raise ValueError("SIN_TYPE must be CORDIC or TAYLOR")
        nterms, _ = _WIN_TYPES[self.win_type]
        if self.sin_type == "TAYLOR" and nterms > 3:
            raise ValueError(
                f"{self.win_type} is CORDIC-only in the reference "
                "(src/win_selector.vhd: SIN_TYPE reaches only 2/3-term cores)"
            )
        if self.aa is not None and len(self.aa) != nterms:
            raise ValueError(
                f"{self.win_type} needs {nterms} coefficient ports, "
                f"got {len(self.aa)}"
            )

    @property
    def spec(self) -> WindowSpec:
        return WindowSpec(
            phase_width=self.phi_width,
            data_width=self.dat_width,
            sin_type=self.sin_type.lower(),
            lut_size=self.lut_size,
            rounding=self.rounding,
            overflow=self.overflow,
        )

    @property
    def coeffs_q(self) -> tuple[int, ...]:
        if self.aa is not None:
            q = tuple(int(a) for a in self.aa)
        else:
            _, default = _WIN_TYPES[self.win_type]
            q = catalog.get(default).quantized(self.dat_width)
        if (
            self.rtl_a0_correction
            and self.rounding == "rtl"
            and self.sin_type == "CORDIC"
        ):
            q = rtl_cordic_coeffs(q)
        return q

    def __call__(self, n=None, device=None):
        """Window samples at indices ``n``.

        ``n=None``: the full 2^PHI_WIDTH window (the ENABLE-for-NFFT-clocks
        streaming pattern) as int32 on ``device`` (default the card),
        through ``kernels/window.window_block``: the CORDIC or TAYLOR
        kernel on a CUDA device.  Explicit ``n``: ``window_samples`` (int64)
        where a tensor ``n`` lies, or on ``device`` for array-likes."""
        if n is None:
            return window_block(0, 1 << self.phi_width, self.coeffs_q, self.spec,
                                device)
        n = _build.as_tensor(n, torch.int64, device)
        return window_samples(n, self.coeffs_q, self.spec)
