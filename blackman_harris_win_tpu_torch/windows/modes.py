"""Generation-mode advisor: pick the fastest mode that meets a floor /
exactness requirement (counterpart of
``blackman_harris_win_tpu/windows/modes.py``; the same decision for every
input, with this card's rates).

Six generation modes with different contracts:

  exact    bit-exact HLS CORDIC datapath          (full int contract)
  rtl      bit-exact VHDL rounding contract
  taylor   bit-exact TAYLOR-source contract       (2/3-term only)
  outer    int fast mode (floor-held approx)
  float    native f32 (floor == f64 thru 5 terms; BH-7: -163 dB)
  comp     compensated-f32 (hi, lo) pair          (full f64 floor)

The non-obvious rules this encodes:

- For 2/3-term windows needing a *bit-exact integer* contract, the TAYLOR
  source is itself a reference contract (src/taylor_sincos.vhd) and its
  kernel runs many times the CORDIC kernel's rate (``MODE_GSPS``), so
  exactness does not force the slow path there.
- Plain f32 serves every catalog window through 5 terms at full floor;
  only the 7-term contracts need the compensated pair (pure-f32 output
  physically floors at -178.6 dB at pw=16).
- The int fast mode ("outer") only wins when the consumer needs *integer*
  samples but not bit-exactness.
"""

from __future__ import annotations

from dataclasses import dataclass

from .catalog import get

#: generation rate per mode, Gsamples/s: 2^26 samples over the kernel's
#: CUDA-event time, one call alone (``chip_smoke.py``'s mode rates, PERF.md
#: §5: outer from the run after its kernel's redesign, the others from the
#: front end's first run; NVIDIA H100 80GB HBM3, power limit 700.00 W).
#: exact / rtl: ``window_block`` HLS / RTL BH-7 W=32; taylor:
#: ``taylor_window_block`` Blackman W=32; outer / float / comp:
#: ``outer_block`` / ``outer_block_f32`` / ``outer_block_comp`` at BH-7
#: pw=26 m=11.
MODE_GSPS = {
    "exact": 7.512,
    "rtl": 7.816,
    "taylor": 293.554,
    "outer": 325.847,
    "float": 394.127,
    "comp": 250.526,
}

# deepest floor plain f32 can hold (measured: BH-7 reads -163 of -180;
# everything at or above this level matches the f64 floor exactly)
_F32_FLOOR_DB = -160.0


@dataclass(frozen=True)
class ModeChoice:
    mode: str  # exact | rtl | taylor | outer | float | comp
    est_gsamp_s: float
    rationale: str


def recommend_mode(
    name_or_coeffs,
    consumer: str = "float",
    exactness: str = "floor",
    target_db: float | None = None,
) -> ModeChoice:
    """Fastest generation mode meeting the requirement.

    consumer:  "float" (downstream multiplies f32 frames — Welch/STFT/
               WOLA) or "int" (integer samples leave the generator, e.g.
               feeding an integer FFT core like the reference's).
    exactness: "bit-exact" (sample-for-sample reference contract) or
               "floor" (the published side-lobe floor must hold
               spectrally; samples may differ — the fast modes).
    target_db: required floor; defaults to the window's published level
               (coefficient tuples default to the -180 dB class).
    """
    if consumer not in ("float", "int"):
        raise ValueError("consumer must be 'float' or 'int'")
    if exactness not in ("bit-exact", "floor"):
        raise ValueError("exactness must be 'bit-exact' or 'floor'")

    if isinstance(name_or_coeffs, str):
        d = get(name_or_coeffs)
        n_terms = d.n_terms
        published = d.sidelobe_db
    else:
        n_terms = len(tuple(name_or_coeffs))
        published = None
    if target_db is None:
        target_db = published if published is not None else -180.0

    def choice(mode, why):
        return ModeChoice(mode, MODE_GSPS[mode], why)

    if consumer == "int":
        if exactness == "bit-exact":
            if n_terms <= 3:
                ratio = MODE_GSPS["taylor"] / MODE_GSPS["exact"]
                return choice(
                    "taylor",
                    "2/3-term + bit-exact: the TAYLOR-source datapath is "
                    "itself a reference contract and its kernel runs "
                    f"{ratio:.0f}x the CORDIC kernel's rate on the H100 "
                    "(kernels/taylor_kernel.py:window_block)",
                )
            return choice(
                "exact",
                "bit-exact integer contract at 4+ terms: the fused HLS "
                "CORDIC datapath (kernels/window.py; RTL rounding via "
                "rounding='rtl' ties it)",
            )
        return choice(
            "outer",
            "integer samples with a spectrally-held floor: the "
            "outer-product angle-addition fast mode "
            "(kernels/outerwin.py, floor-validated)",
        )

    # float consumer
    if exactness == "bit-exact":
        # "bit-exact" has no meaning for float output; the strictest float
        # statement is the compensated pair (exact to ~3e-10)
        return choice(
            "comp",
            "float consumer wanting the strongest accuracy statement: the "
            "compensated (hi, lo) pair carries the f64 window to ~3e-10 "
            "(kernels/compwin.py)",
        )
    if target_db >= _F32_FLOOR_DB:
        return choice(
            "float",
            f"plain f32 holds {target_db:.0f} dB (f32 floor == f64 floor "
            "through 5-term windows; kernels/floatwin.py) — the fastest "
            "mode",
        )
    return choice(
        "comp",
        f"{target_db:.0f} dB exceeds plain f32's ~-163 dB reach: the "
        "compensated (hi, lo) pair holds the full f64 floor "
        "(kernels/compwin.py; apply as x*hi + x*lo)",
    )
