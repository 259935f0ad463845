"""Spectral acceptance utilities (counterpart of
``blackman_harris_win_tpu/utils/spectral.py``; numpy only, same math).

The reference validates its windows spectrally: generate, add tiny dither,
|FFT|^2, normalize, 10*log10, inspect the side-lobe floor
(``math/cordic_main.m:108-155``, ``math/cordic_test.m:104-141``).  These
helpers turn that procedure into assertable numbers.
"""

from __future__ import annotations

import math

import numpy as np


def power_spectrum_db(sig, dither: float = 1e-12, seed: int = 1) -> np.ndarray:
    """Normalized power spectrum in dB of a (possibly integer) signal, with
    the reference's tiny-dither trick (math/cordic_main.m:112-116) so exact
    zeros don't produce -inf bins."""
    sig = np.asarray(sig, np.float64)
    if dither:
        sig = sig + dither * np.random.default_rng(seed).normal(size=sig.shape)
    spec = np.abs(np.fft.fft(sig)) ** 2
    spec = spec / spec.max()
    return 10.0 * np.log10(spec + 1e-300)


def tone_spectral_floor_db(sig, carrier_bins: int = 1) -> float:
    """Worst spur level (dB) of a generated tone, excluding DC and the
    carrier +- carrier_bins — the cordic_test.m purity check."""
    db = power_spectrum_db(sig)
    n = len(db)
    mask = np.ones(n, bool)
    mask[0] = False
    peak = int(np.argmax(db))
    for d in range(-carrier_bins, carrier_bins + 1):
        mask[(peak + d) % n] = False
        mask[(-peak + d) % n] = False
    return float(db[mask].max())


def window_sidelobe_db(win, oversample: int = 8, guard_bins: int | None = None,
                       n_terms: int | None = None) -> float:
    """Peak side-lobe level (dB relative to the main lobe) of a window,
    measured on an ``oversample``-padded FFT.  ``guard_bins`` excludes the
    main lobe; by default 2 * n_terms original bins (cosine-sum main-lobe
    width), n_terms inferred as 4 if not given."""
    win = np.asarray(win, np.float64)
    n = len(win)
    if guard_bins is None:
        guard_bins = 2 * (n_terms or 4)
    m = oversample * n
    spec = np.abs(np.fft.fft(win, m))
    db = 20.0 * np.log10(spec / spec.max() + 1e-300)
    g = oversample * guard_bins
    side = np.concatenate([db[g : m // 2], db[m // 2 : m - g]])
    return float(side.max())


def required_width_for_sidelobe(sidelobe_db: float) -> int:
    """The reference's sizing rule: '1 digital bit equals 6 dB'; e.g. -92 dB
    (BH-4) needs ceil(92/6)=16 magnitude bits + sign = 17 (README.md:5-6)."""
    return int(math.ceil(abs(sidelobe_db) / 6.0)) + 1
