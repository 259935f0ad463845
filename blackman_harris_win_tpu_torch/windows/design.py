"""Cosine-sum window *design*, the optimization behind the catalog
(counterpart of ``blackman_harris_win_tpu/windows/design.py``; same math).

The published Blackman-Harris sets solve a minimax problem: choose
``a_0..a_{K-1}`` minimizing the peak side-lobe of

    w[n] = sum_k (-1)^k a_k cos(2*pi*k*n/N)

whose large-N DTFT magnitude is the trig polynomial

    |W(f)| = |sum_k a_k (sinc(f - k) + sinc(f + k)) / 2|      [f in bins]

with *all-positive* sinc weights: the alternating time-domain signs are a
half-period shift, pure linear phase, which cancels out of the magnitude.
The model is linear in the coefficients, so minimax design is a linear
program:

    minimize t  s.t.  -t <= W(f_j) <= t  on a dense stop-band grid
                      W(0) = 1  (main-lobe normalization)

solved exactly by scipy's HiGHS.  It regenerates the catalog's
min-sidelobe family (3-term: the -71 dB BH-3 set; 4-term: Nuttall's
-98 dB minimum-sidelobe set, the catalog's blackman_nuttall; 7-term: a
-253 dB window) and generalizes it: any term count, a custom stop-band
edge (main-lobe width against floor), and prescribed spectral nulls.

Design is host-side (numpy/scipy, milliseconds); the output coefficients
feed the port's quantized generation path like the catalog's
(``quantized_coeffs`` + ``kernels/window.window_samples`` or
``window_block``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def cosine_sum_spectrum(coeffs, f):
    """Large-N DTFT of the *centered* cosine-sum window at frequency ``f``
    (bins), normalized so W(0) = a0 (the k>0 sincs vanish at integers).

    Takes catalog-convention coefficients (``catalog.float_window_value``'s
    alternating time-domain signs); the weights here are all-positive because
    the alternation is a half-period shift — linear phase only.  Matches
    ``|FFT(w)|`` of the sampled window to ~1e-7 for N >= 4096 (the sampled
    window additionally carries phase e^{-i pi f (N-1)/N} plus aliasing of
    the periodic sinc tails, both invisible in magnitude at this scale)."""
    a = np.asarray(coeffs, np.float64)
    f = np.atleast_1d(np.asarray(f, np.float64))
    k = np.arange(len(a))
    # np.sinc is sin(pi x)/(pi x)
    m = 0.5 * (np.sinc(f[:, None] - k[None, :]) + np.sinc(f[:, None] + k[None, :]))
    return m @ a


def _design_matrix(n_terms: int, f):
    """Rows of the linear map a -> W(f) (all-positive sinc weights — see
    cosine_sum_spectrum)."""
    k = np.arange(n_terms)
    f = np.asarray(f, np.float64)
    return 0.5 * (
        np.sinc(f[:, None] - k[None, :]) + np.sinc(f[:, None] + k[None, :])
    )


@dataclass(frozen=True)
class DesignResult:
    coeffs: tuple[float, ...]  # normalized: sum(coeffs) == 1 (unit peak)
    sidelobe_db: float  # achieved minimax stop-band level
    stop_bin: float  # stop-band edge used (bins)

    @property
    def n_terms(self) -> int:
        return len(self.coeffs)

    def suggest_shift(self) -> int:
        """Quantization headroom, the catalog's rule: shift 1 for 2..4-term
        sets, 2 for 5+-term (hls/windows/win_function.cpp:176,349 — e.g.
        hamming's a0=0.5435 still gets shift 1), provided every coefficient
        fits the W-1-bit magnitude range (< 1.0); otherwise shift 2."""
        if max(abs(c) for c in self.coeffs) >= 1.0:
            return 2
        return 1 if self.n_terms <= 4 else 2


def design_min_sidelobe(
    n_terms: int,
    stop_bin: float | None = None,
    grid: int = 2000,
    f_max: float = 60.0,
    nulls: tuple[float, ...] = (),
) -> DesignResult:
    """Minimax (equal-ripple) side-lobe design of a K-term cosine-sum
    window — the optimization whose K=4 solution is the published -92 dB
    Blackman-Harris set.

    ``stop_bin`` is the side-lobe region edge in bins (default K, the
    K-term main-lobe half-width: the catalog family's choice).  Lowering it
    narrows the main lobe at the cost of the floor; raising it buys floor.
    ``nulls`` adds exact-zero constraints W(f)=0 at the given bin offsets
    (e.g. place nulls on known interferer frequencies).

    Returns coefficients normalized to unit peak (sum = 1), matching the
    catalog convention, and the achieved stop-band level in dB.
    """
    try:
        from scipy.optimize import linprog
    except ImportError as e:  # pragma: no cover - scipy is in the image
        raise RuntimeError(
            "window design needs scipy.optimize.linprog; install scipy or "
            "use the precomputed sets in windows.catalog"
        ) from e
    if n_terms < 2:
        raise ValueError("need at least 2 terms")
    if stop_bin is None:
        stop_bin = float(n_terms)
    if stop_bin <= 1.0:
        raise ValueError(f"stop_bin {stop_bin} must exceed 1 bin")

    # dense near the edge (where the binding ripples crowd), log-spread out
    f = stop_bin * np.exp(np.linspace(0.0, math.log(f_max / stop_bin), grid))
    rows = _design_matrix(n_terms, f)

    # variables: [a_0..a_{K-1}, t];  minimize t
    c = np.zeros(n_terms + 1)
    c[-1] = 1.0
    ones = np.ones((len(f), 1))
    a_ub = np.vstack(
        [np.hstack([rows, -ones]), np.hstack([-rows, -ones])]
    )
    b_ub = np.zeros(2 * len(f))
    # normalize the MAIN-LOBE peak: W(0) = a0 = 1.  (Normalizing the time
    # peak sum(a_k) instead lets the LP inflate a0 against a fixed t —
    # a degenerate 'window' with a huge DC term.)  Rescaled to the
    # catalog's unit-time-peak convention after solving.
    a_eq = [np.append(np.eye(n_terms)[0], 0.0)]
    b_eq = [1.0]
    for fn in nulls:
        a_eq.append(np.append(_design_matrix(n_terms, [fn])[0], 0.0))
        b_eq.append(0.0)

    res = linprog(
        c,
        A_ub=a_ub,
        b_ub=b_ub,
        A_eq=np.asarray(a_eq),
        b_eq=np.asarray(b_eq),
        bounds=[(None, None)] * n_terms + [(0.0, None)],
        method="highs",
    )
    if not res.success:  # pragma: no cover
        raise RuntimeError(f"window design LP failed: {res.message}")
    a = res.x[:n_terms]
    level = float(res.x[-1])  # relative to the pinned W(0) = 1 peak
    a = a / a.sum()  # catalog convention: unit time peak (sum == 1)
    return DesignResult(
        coeffs=tuple(float(v) for v in a),
        sidelobe_db=20.0 * math.log10(max(level, 1e-300)),
        stop_bin=float(stop_bin),
    )


def sampled_window(result: DesignResult, n: int) -> np.ndarray:
    """Float samples of a designed window over one period (catalog sign
    convention), for metrology or direct use."""
    a = np.asarray(result.coeffs)
    k = np.arange(len(a))
    idx = np.arange(n)
    ph = np.cos(2.0 * np.pi * np.outer(idx, k) / n)
    return ph @ (a * (-1.0) ** k)


def quantized_coeffs(result: DesignResult, data_width: int,
                     shift: int | None = None) -> tuple[int, ...]:
    """Reference quantization of a designed set (``round(a*(2^(W-s)-1))``,
    catalog.WindowDef.quantized) — drop-in for ``window_samples``.

    ``shift=None`` uses the catalog headroom rule (:meth:`suggest_shift`);
    ``shift=1`` packs a unit-sum design to the full W-1 magnitude bits (one
    extra bit ~ 6 dB of floor, README.md:5-6) — safe because of the trim
    below.

    Per-coefficient rounding of a unit-sum designed set can push the window
    peak past Q0.(W-1) full scale.  At n=N/2 every harmonic phase k*N/2
    lands on a quadrant-exact CORDIC cos of magnitude **2^(W-2)+1** (the
    flavor's one-LSB quadrant overshoot, e.g. hls cos(0) = 0x40000001); the
    odd-k products are negative there and the arithmetic-shift truncation
    (toward -inf) adds one more LSB each, so the exact datapath peak is

        q0 + sum_k  ceil(q_k*(2^(W-2)+1) / 2^(W-2))   (k odd)
                  + floor(q_k*(2^(W-2)+1) / 2^(W-2))  (k even)

    The excess over full scale is trimmed from a0 so the peak fits — the
    catalog's published sets already carry this headroom; without the trim
    the faithful ``overflow="wrap"`` path wraps the peak to negative full
    scale (``overflow="saturate"`` clamps it, at w=32 via the kernel's
    overflow-count tracking)."""
    from ..core.fixedpoint import quantize_coeffs

    if shift is not None and shift < 1:
        raise ValueError(f"shift must be >= 1, got {shift}")
    q = list(quantize_coeffs(result.coeffs, data_width,
                             result.suggest_shift() if shift is None
                             else shift))
    w2 = data_width - 2
    amp = (1 << w2) + 1
    peak = q[0]
    for k, c in enumerate(q[1:], start=1):
        p = c * amp
        peak += -((-p) >> w2) if k % 2 == 1 else (p >> w2)
    excess = peak - (2 ** (data_width - 1) - 1)
    if excess > 0:
        q[0] -= excess
    return tuple(q)
