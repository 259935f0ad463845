"""Static configuration dataclasses (counterpart of
``blackman_harris_win_tpu/core/config.py``; same fields, same validation).

The reference splits its configuration surface into elaboration-time generics
(window length 2^PHI_WIDTH, data width, sine-generator type, LUT size —
``src/win_selector.vhd:61-70``) and runtime ports (the window coefficients,
``src/win_selector.vhd:75-81``).  These frozen dataclasses hold the former;
coefficients travel separately as data.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

VALID_CORDIC_FLAVORS = ("hls", "cmodel", "dds", "dds48", "scaled")
VALID_SIN_TYPES = ("cordic", "taylor", "taylor2")
VALID_ROUNDING = ("hls", "rtl")
VALID_OVERFLOW = ("wrap", "saturate")


@dataclass(frozen=True)
class CordicSpec:
    """Static shape/width config of one CORDIC sine/cosine generator.

    flavor:
      - "hls":    W+2-bit wrapping state, output-side quadrant fix
                  (hls/windows/win_function.cpp:47-156) — window spec flavor.
      - "cmodel": 64-bit state, one's-complement quadrant fix
                  (cpp/cordic_sincos.cpp:10-92).
      - "dds":    W+P-bit state, PRECISION guard bits (src/cordic_dds.vhd).
      - "dds48":  48-bit state, input-side pre-rotation (src/cordic_dds48.vhd).
      - "scaled": SEL_SIZE empirical internal width (src/cordic_dds_scaled.vhd).
    """

    phase_width: int
    data_width: int
    flavor: str = "hls"
    precision: int = 1  # guard bits; "dds"/"cmodel" flavors only

    def __post_init__(self):
        if self.flavor not in VALID_CORDIC_FLAVORS:
            raise ValueError(f"flavor must be one of {VALID_CORDIC_FLAVORS}")
        if not 4 <= self.phase_width <= 48:
            raise ValueError("phase_width must be in [4, 48]")
        if not 8 <= self.data_width <= 46:
            raise ValueError("data_width must be in [8, 46]")
        if self.flavor == "dds" and not 1 <= self.precision <= 7:
            raise ValueError("dds precision (guard bits) must be in 1..7")

    @property
    def internal_width(self) -> int:
        from .luts import scaled_internal_width

        if self.flavor == "hls":
            return self.data_width + 2
        if self.flavor == "cmodel":
            return 64
        if self.flavor == "dds":
            return self.data_width + self.precision
        if self.flavor == "dds48":
            return 48
        return scaled_internal_width(self.data_width)

    @property
    def n(self) -> int:
        """Window/period length 2^phase_width (16 .. 64M in the reference)."""
        return 1 << self.phase_width


@dataclass(frozen=True)
class WindowSpec:
    """Static config of a window generator (the win_selector equivalent).

    ``rounding="hls"`` follows hls/windows/win_function.cpp:361-375 (products
    ``>> (W-2)``, single accumulate, win_t wrap); ``rounding="rtl"`` follows
    the VHDL cores' two round-half-up stages (src/bh_win_3term.vhd:257-306).

    ``overflow="wrap"`` reproduces the reference's two's-complement wrap
    bit-for-bit; ``overflow="saturate"`` clamps instead.
    """

    phase_width: int
    data_width: int
    sin_type: str = "cordic"  # "cordic" | "taylor" | "taylor2"
    rounding: str = "hls"
    overflow: str = "saturate"
    precision: int = 1  # guard bits of the dds flavor (rtl mode)
    lut_size: int = 9  # taylor path ROM depth default (src/win_selector.vhd:68)

    def __post_init__(self):
        if self.sin_type not in VALID_SIN_TYPES:
            raise ValueError(f"sin_type must be one of {VALID_SIN_TYPES}")
        if self.rounding not in VALID_ROUNDING:
            raise ValueError(f"rounding must be one of {VALID_ROUNDING}")
        if self.overflow not in VALID_OVERFLOW:
            raise ValueError(f"overflow must be one of {VALID_OVERFLOW}")

    @property
    def n(self) -> int:
        return 1 << self.phase_width

    @property
    def cordic_spec(self) -> CordicSpec:
        flavor = "hls" if self.rounding == "hls" else "dds"
        return CordicSpec(
            self.phase_width, self.data_width, flavor, self.precision
        )

    def with_(self, **kw) -> "WindowSpec":
        return replace(self, **kw)
