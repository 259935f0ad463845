"""The Welch analyzer through ``pipeline.spectral.windowed_power_spectrum``.

A call turns one float32 capture on the card into its Welch power
spectrum; the traffic's captures are made from the seed and taken in turn,
so no call repeats the input of the one before.  The analyzer makes its
quantized window through ``kernels.window.window_block``; the entry
watches that function and keeps, with each compared spectrum, the window
the call used (the program offers no other way to hand it back).  The
comparison: the window 0 LSB against the plain reference's, and the
spectrum per bin against float64 Welch over the same capture with the
reference's window.
"""

from __future__ import annotations

import torch

from portbench import roofline, traffic as gen_traffic
from portbench.reference import welch as ref_welch, window as ref_window

#: adjacent bins summed for ``spectrum_band_max``
BAND = 16


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from blackman_harris_win_tpu_torch.core.config import WindowSpec
        from blackman_harris_win_tpu_torch.kernels import window as kw
        from blackman_harris_win_tpu_torch.pipeline import spectral

        c = config
        self.name, self.device, self.limits = c["window"], device, c["limits"]
        self.spec = WindowSpec(phase_width=c["phase_width"], data_width=c["data_width"],
                               sin_type=c["sin_type"], rounding=c["rounding"],
                               overflow=c["overflow"])
        self.nfft, self.hop = self.spec.n, c["hop"]
        self.win_mode, self.fft_mode = c["win_mode"], c["fft_mode"]
        self.captures = gen_traffic.captures(traffic, seed, device)
        self._analyze = spectral.windowed_power_spectrum
        # watch the window the analyzer makes: the last one, for keep()
        self._kw, self._block = kw, kw.window_block
        self.last_window = None

        def watched(*args, **kwargs):
            self.last_window = self._block(*args, **kwargs)
            return self.last_window

        kw.window_block = watched

    def warm_calls(self) -> list[int]:
        return list(range(len(self.captures)))

    def samples(self, i: int) -> int:
        return self.captures[i % len(self.captures)].numel()

    def work(self, i: int) -> dict:
        return roofline.welch_work(self.samples(i), self.nfft, self.hop)

    def call(self, i: int) -> torch.Tensor:
        self.last_window = None
        return self._analyze(self.captures[i % len(self.captures)], self.name, self.spec,
                             hop=self.hop, win_mode=self.win_mode, fft_mode=self.fft_mode)

    def keep(self, i: int, out: torch.Tensor):
        return (i % len(self.captures), out, self.last_window)

    def release(self) -> None:
        self._kw.window_block = self._block

    def _win_ref(self) -> torch.Tensor:
        s = self.spec
        return ref_window.window_range(0, self.nfft, self.name, s.phase_width, s.data_width,
                                       s.overflow, self.device)

    def control(self, kept: list) -> list:
        """The reference in the program's place, in TF32."""
        wq = self._win_ref()
        win64 = wq.double() * ref_window.scale(self.name, self.spec.data_width)
        spectra = {}
        for cap, _, _ in kept:
            if cap not in spectra:
                spectra[cap] = ref_welch.welch_tf32(self.captures[cap], win64, self.nfft,
                                                    self.hop)
        return [(cap, spectra[cap], wq) for cap, _, _ in kept]

    def judge(self, kept: list) -> dict:
        """window_unseen: kept calls in which the analyzer made no window
        through ``kernels.window.window_block`` for the entry to keep;
        window_lsb: the widest gap of a kept window from the reference's
        (every sample; as many LSB as the whole range where its shape is
        wrong); spectrum_rel_p99: of a kept spectrum's per-bin gaps from
        float64 Welch, each over its float64 bin, the 99th percentile;
        spectrum_band_max: over every bin, in bands of ``BAND`` adjacent
        bins from bin 0 (the last holds what is left), the widest gap of a
        band's sum from float64's, over float64's sum plus ``BAND`` median
        bins (the noise floor).  Each the worst over the kept spectra.
        The float32 FFT leaves a few error spurs of about 1% of the floor
        in single bins far below the strongest tone, nearly as wide as the
        control's per-bin error: the percentile steps over them, and a
        band sums them away while the control's error, in every bin,
        stays; a fault in a few bins or a band shows in its band's sum."""
        wq = self._win_ref()
        win64 = wq.double() * ref_window.scale(self.name, self.spec.data_width)
        refs, unseen, lsb, rel, band = {}, 0, 0, 0.0, 0.0
        for cap, spec, win in kept:
            if win is None:
                unseen += 1
            elif win.shape != wq.shape:
                lsb = max(lsb, 1 << self.spec.data_width)
            else:
                lsb = max(lsb, int((win.to(torch.int64) - wq).abs().max()))
            if cap not in refs:
                refs[cap] = ref_welch.welch64(self.captures[cap], win64, self.nfft, self.hop)
            want = refs[cap]
            if spec.shape != want.shape or not bool(spec.isfinite().all()):
                rel = band = float("inf")
                continue
            gap = spec.double() - want
            rel = max(rel, float(torch.quantile(gap.abs() / want, 0.99)))
            pad = -want.numel() % BAND
            g, w = (torch.nn.functional.pad(v, (0, pad)).view(-1, BAND).sum(dim=1)
                    for v in (gap, want))
            band = max(band, float((g.abs() / (w + BAND * want.median())).max()))
        return {"window_unseen": (unseen, self.limits["window_unseen"]),
                "window_lsb": (lsb, self.limits["window_lsb"]),
                "spectrum_rel_p99": (rel, self.limits["spectrum_rel_p99"]),
                "spectrum_band_max": (band, self.limits["spectrum_band_max"])}
