"""Window figures of merit, the harris-table metrology for the catalog
(counterpart of ``blackman_harris_win_tpu/windows/metrics.py``; same math,
host numpy on top of the port's ``utils/spectral.py``).

The reference documents each window by its peak side-lobe level alone
(``README.md:30-41``); a spectral front-end designer choosing between them
also needs the classic figures of merit (F. J. harris, "On the use of
windows for harmonic analysis with the DFT", Proc. IEEE 1978): equivalent
noise bandwidth, coherent gain, scalloping loss, worst-case processing
loss, main-lobe widths, and the overlap flatness/correlation numbers that
decide a Welch/WOLA hop.

Two evaluation paths: the closed form for periodic cosine-sum windows (over
a full period the cosines are orthogonal, so ``mean(w) = a0`` and
``mean(w^2) = a0^2 + sum(a_k^2)/2``), and the numeric one on any sampled
window, quantized fixed-point outputs included (ENBW and scalloping are
scale-invariant; no dequantization needed).  Host-side analysis, not a hot
path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..utils.spectral import window_sidelobe_db


@dataclass(frozen=True)
class WindowMetrics:
    """harris-style figure-of-merit row for one window."""

    enbw_bins: float  # equivalent noise bandwidth, DFT bins
    coherent_gain: float  # mean(w) / peak(w)
    processing_gain_db: float  # -10 log10(ENBW)
    scalloping_loss_db: float  # |W(1/2 bin)| / |W(0)|, dB (negative)
    worst_case_loss_db: float  # scalloping + noise-bandwidth loss (negative)
    main_lobe_3db_bins: float  # full width of the main lobe at -3 dB
    main_lobe_6db_bins: float  # full width at -6 dB
    peak_sidelobe_db: float  # utils.spectral.window_sidelobe_db


def cosine_sum_enbw_bins(coeffs) -> float:
    """Closed-form ENBW (bins) of a periodic cosine-sum window: for
    ``w[n] = a0 -+ a_k cos(2 pi k n / N)`` the full-period sums give
    ``ENBW = N * sum(w^2) / sum(w)^2 = (a0^2 + sum_{k>=1} a_k^2 / 2) / a0^2``
    (exact for any N > 2*K; term signs cancel in the squares)."""
    a = np.asarray(coeffs, np.float64)
    return float((a[0] ** 2 + 0.5 * np.sum(a[1:] ** 2)) / a[0] ** 2)


def cosine_sum_coherent_gain(coeffs) -> float:
    """Closed-form coherent gain: mean(w)/peak with peak normalized to the
    all-terms-aligned value ``sum(a_k)`` (the window's center value for the
    alternating-sign convention of ``catalog.float_window_value``)."""
    a = np.asarray(coeffs, np.float64)
    return float(a[0] / np.sum(a))


def _interp_crossing(freq_bins, db, level_db: float) -> float:
    """First frequency (bins) where ``db`` falls below ``level_db``,
    linearly interpolated; the spectrum must start above the level."""
    below = np.flatnonzero(db < level_db)
    if below.size == 0:
        raise ValueError(f"spectrum never crosses {level_db} dB")
    i = int(below[0])
    if i == 0:
        return float(freq_bins[0])
    # linear interpolation in (freq, dB) between samples i-1 and i
    f0, f1, d0, d1 = freq_bins[i - 1], freq_bins[i], db[i - 1], db[i]
    return float(f0 + (level_db - d0) * (f1 - f0) / (d1 - d0))


def window_metrics(
    win, n_terms: int | None = None, oversample: int = 64
) -> WindowMetrics:
    """Numeric figures of merit of a sampled window (float or quantized
    ints; all ratios are scale-invariant).  ``n_terms`` sizes the main-lobe
    guard for the side-lobe search (``utils.spectral.window_sidelobe_db``);
    ``oversample`` sets the DTFT grid (64*N points resolves scalloping and
    lobe widths to ~1/64 bin)."""
    w = np.asarray(win, np.float64)
    n = len(w)
    s1, s2 = float(np.sum(w)), float(np.sum(w * w))
    enbw = n * s2 / s1**2
    cg = s1 / (n * float(np.max(np.abs(w))))

    m = oversample * n
    mag = np.abs(np.fft.rfft(w, m))
    db = 20.0 * np.log10(mag / mag[0] + 1e-300)
    freq_bins = np.arange(len(mag)) / oversample

    scallop = float(db[oversample // 2])  # response at a half-bin offset
    # worst-case processing loss: tone at the bin edge + ENBW noise penalty
    wcl = scallop - 10.0 * math.log10(enbw)
    return WindowMetrics(
        enbw_bins=enbw,
        coherent_gain=cg,
        processing_gain_db=-10.0 * math.log10(enbw),
        scalloping_loss_db=scallop,
        worst_case_loss_db=wcl,
        main_lobe_3db_bins=2.0 * _interp_crossing(freq_bins, db, -3.0103),
        main_lobe_6db_bins=2.0 * _interp_crossing(freq_bins, db, -6.0206),
        # a K-term cosine-sum main lobe spans exactly +-K bins (null at K),
        # so guard K bins — the window_sidelobe_db default (2K) would skip
        # the first side lobes of the fast-decaying 2-term windows
        peak_sidelobe_db=window_sidelobe_db(
            w, guard_bins=n_terms, n_terms=n_terms
        ),
    )


def overlap_flatness(win, hop: int) -> tuple[float, float]:
    """(amplitude, power) flatness of the periodic overlap-add tiling
    ``s[t] = sum_m w[t - m*hop]`` — min/max ratio of the tiled sum; 1.0
    means constant-overlap-add (COLA) at this hop.  Any 2-term cosine
    window is amplitude-COLA at hop = N/2 (the k=1 harmonics cancel in
    pairs); >= 3 terms are not, which is why WOLA synthesis normalizes per
    sample (``pipeline/stft.istft``) instead of assuming COLA."""
    w = np.asarray(win, np.float64)
    n = len(w)
    if n % hop:
        raise ValueError(f"hop {hop} must divide the window length {n}")
    amp = w.reshape(n // hop, hop).sum(axis=0)
    pwr = (w * w).reshape(n // hop, hop).sum(axis=0)
    return (
        float(amp.min() / amp.max()),
        float(pwr.min() / pwr.max()),
    )


def overlap_correlation(win, hop: int) -> float:
    """harris's overlap correlation ``c(hop) = sum w[n] w[n+hop] / sum w^2``
    (fraction of redundancy between adjacent Welch frames; drives the
    variance reduction of averaged overlapped periodograms)."""
    w = np.asarray(win, np.float64)
    num = float(np.sum(w[: len(w) - hop] * w[hop:]))
    return num / float(np.sum(w * w))


def catalog_metrics(
    n: int = 4096, data_width: int | None = None, oversample: int = 64
) -> dict[str, WindowMetrics]:
    """Figure-of-merit table for the whole catalog at length ``n`` —
    float windows by default; pass ``data_width`` to measure the
    *quantized* windows instead (reference quantization rule,
    ``catalog.golden_quantized_window``)."""
    from . import catalog

    out: dict[str, WindowMetrics] = {}
    idx = np.arange(n)
    for name in catalog.names():
        d = catalog.get(name)
        if data_width is None:
            w = catalog.float_window_value(name, idx, n)
        else:
            w = catalog.golden_quantized_window(name, idx, n, data_width)
        out[name] = window_metrics(w, n_terms=d.n_terms, oversample=oversample)
    return out
