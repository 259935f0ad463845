"""Shared fixed-point constants of the CORDIC/window engines (counterpart of
``blackman_harris_win_tpu/core/luts.py``, copied verbatim; a test holds the
two equal).

- ``LUT_ATAN_PI``:  48-bit entries ``round(atan(2^-i) * 2^48 / pi)``
  (``src/cordic_dds.vhd:104-117``, ``hls/windows/win_function.cpp:59-72``).
- ``LUT_ATAN_2PI``: 48-bit entries ``round(atan(2^-i) * 2^48 / (2*pi))``
  (``src/cordic_dds48.vhd:115-128``, ``cpp/cordic_sincos.cpp:97-110``).
- ``GAIN48_HALF = (1/K)/2 * 2^48`` and ``GAIN48_QUARTER = (1/K)/4 * 2^48``,
  ``K = prod(sqrt(1 + 2^-2i))`` (``src/cordic_dds.vhd:97``,
  ``src/cordic_dds48.vhd:110``).
- ``SEL_SIZE``: internal-width table of ``cordic_dds_scaled``
  (``src/cordic_dds_scaled.vhd:102-107``).
"""

from __future__ import annotations

import math

# atan(2^-i) * 2^48 / pi, i = 0..47  (entry 0 = 2^46).
LUT_ATAN_PI: tuple[int, ...] = (
    0x400000000000, 0x25C80A3B3BE6, 0x13F670B6BDC7, 0x0A2223A83BBB,
    0x05161A861CB1, 0x028BAFC2B209, 0x0145EC3CB850, 0x00A2F8AA23A9,
    0x00517CA68DA2, 0x0028BE5D7661, 0x00145F300123, 0x000A2F982950,
    0x000517CC19C0, 0x00028BE60D83, 0x000145F306D6, 0x0000A2F9836D,
    0x0000517CC1B7, 0x000028BE60DC, 0x0000145F306E, 0x00000A2F9837,
    0x00000517CC1B, 0x0000028BE60E, 0x00000145F307, 0x000000A2F983,
    0x000000517CC2, 0x00000028BE61, 0x000000145F30, 0x0000000A2F98,
    0x0000000517CC, 0x000000028BE6, 0x0000000145F3, 0x00000000A2FA,
    0x00000000517D, 0x0000000028BE, 0x00000000145F, 0x000000000A30,
    0x000000000518, 0x00000000028C, 0x000000000146, 0x0000000000A3,
    0x000000000051, 0x000000000029, 0x000000000014, 0x00000000000A,
    0x000000000005, 0x000000000003, 0x000000000001, 0x000000000000,
)

# atan(2^-i) * 2^48 / (2*pi), i = 0..47  (entry 0 = 2^45).
LUT_ATAN_2PI: tuple[int, ...] = (
    0x200000000000, 0x12E4051D9DF3, 0x09FB385B5EE4, 0x051111D41DDE,
    0x028B0D430E59, 0x0145D7E15904, 0x00A2F61E5C28, 0x00517C5511D4,
    0x0028BE5346D1, 0x00145F2EBB31, 0x000A2F980092, 0x000517CC14A8,
    0x00028BE60CE0, 0x000145F306C1, 0x0000A2F9836B, 0x0000517CC1B7,
    0x000028BE60DC, 0x0000145F306E, 0x00000A2F9837, 0x00000517CC1B,
    0x0000028BE60E, 0x00000145F307, 0x000000A2F983, 0x000000517CC2,
    0x00000028BE61, 0x000000145F30, 0x0000000A2F98, 0x0000000517CC,
    0x000000028BE6, 0x0000000145F3, 0x00000000A2FA, 0x00000000517D,
    0x0000000028BE, 0x00000000145F, 0x000000000A30, 0x000000000518,
    0x00000000028C, 0x000000000146, 0x0000000000A3, 0x000000000051,
    0x000000000029, 0x000000000014, 0x00000000000A, 0x000000000005,
    0x000000000003, 0x000000000001, 0x000000000001, 0x000000000000,
)

#: CORDIC magnitude gain K = prod_{i=0..47} sqrt(1 + 2^-2i).
CORDIC_GAIN = 1.64676025812106541

#: (1/K)/2 * 2^48 — seed X value of cordic_dds (src/cordic_dds.vhd:97).
GAIN48_HALF = 0x4DBA76D421AF

#: (1/K)/4 * 2^48 — seed X value of cordic_dds48 / cordic_dds_scaled / HLS
#: cores (src/cordic_dds48.vhd:110, cpp/cordic_sincos.cpp:21).
GAIN48_QUARTER = 0x26DD3B6A10D8

#: Internal-width table of cordic_dds_scaled, indexed by (data_width - 8).
SEL_SIZE: tuple[int, ...] = (
    15, 15, 15, 18, 21, 22, 23, 26, 30, 31, 32, 33,
    38, 38, 38, 42, 42, 45, 47, 47, 47, 48, 48, 48, 48,
)


def scaled_internal_width(data_width: int) -> int:
    """Internal x/y width of the 'scaled' CORDIC flavor for a given output width."""
    if not 8 <= data_width <= 32:
        raise ValueError(f"scaled CORDIC supports data_width 8..32, got {data_width}")
    return SEL_SIZE[data_width - 8]


def hls_atan_lut(data_width: int) -> list[int]:
    """The HLS flavor's quantized atan LUT: entry i is the ap_int<W+2> value
    of ``(LUT_ATAN_PI[i] >> (48 - W - 2 + 1)) & 0xFFFFFFFFFF``
    (``hls/windows/win_function.cpp:78``).  Entry 0 is 2^(W-1): 2^31 at
    W=32, which does not fit int32."""
    from .fixedpoint import wrap

    w = data_width
    return [
        wrap((LUT_ATAN_PI[i] >> (47 - w)) & 0xFFFFFFFFFF, w + 2)
        for i in range(w - 1)
    ]


def regenerate_atan_lut(turn_div: int) -> list[int]:
    """Recompute the 48-bit atan LUT from first principles (``turn_div=1``:
    ``LUT_ATAN_PI``, ``turn_div=2``: ``LUT_ATAN_2PI``)."""
    scale = 2.0**48 / (math.pi * turn_div)
    return [round(math.atan(2.0**-i) * scale) for i in range(48)]
