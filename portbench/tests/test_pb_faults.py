"""A run with the timed path broken underneath comes out not correct: once
for each fault a cell can have, and for the control in the program's
place.  The look for a card is skipped; the rest of the run is the
benchmark's own, at the sizes of :mod:`portbench.tests.tiny`."""

from functools import lru_cache
from types import SimpleNamespace

import pytest

from blackman_harris_win_tpu_torch.kernels import window as kw, window_kernel
from blackman_harris_win_tpu_torch.pipeline import spectral
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("faults"))


def _altered(fn, index=7):
    """fn, its output altered where it is produced: one sample one LSB off."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[index] += 1
        return out
    return broken


def _unchanged(fn):
    """fn, returning its first output on every later call."""
    first = []

    def broken(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    return broken


def _half_batch(fn):
    """frame_mean_power over half of the frames: the mean over the rest."""
    def broken(fr, *args, **kwargs):
        return fn(fr[..., ::2, :], *args, **kwargs)
    return broken


def _peak_bin_doubled(fn):
    """The strongest bin of the answer doubled, every other bin as made."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[out.argmax()] *= 2.0
        return out
    return broken


def _edge_bins_zeroed(fn, count=4):
    """A band at the Nyquist edge of the answer left at 0."""
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[-count:] = 0.0
        return out
    return broken


def _scaled(fn, by=1.01):
    def broken(*args, **kwargs):
        return fn(*args, **kwargs) * by
    return broken


@pytest.mark.parametrize("cell", [tiny.GEN, tiny.WELCH])
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, cell, trace):
    code, out = tiny.run(root, cell, trace=trace)
    assert code == 0 and out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("cell,check", [(tiny.GEN, "samples_off"),
                                        (tiny.WELCH, "spectrum_rel_p99"),
                                        (tiny.WELCH, "spectrum_band_max")])
def test_control_is_not_correct(root, cell, check):
    code, out = tiny.run(root, cell, control=True)
    assert code == 0 and not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"]


FAULTS = [
    (tiny.GEN, "answer altered", window_kernel, "window_block", _altered, "samples_off"),
    (tiny.GEN, "state unchanged", kw, "window_block", _unchanged, "stale_calls"),
    (tiny.WELCH, "window altered", window_kernel, "window_block", _altered, "window_lsb"),
    (tiny.WELCH, "answer altered", spectral, "windowed_power_spectrum", _scaled,
     "spectrum_rel_p99"),
    (tiny.WELCH, "state unchanged", spectral, "windowed_power_spectrum", _unchanged,
     "stale_calls"),
    (tiny.WELCH, "half the batch", spectral, "frame_mean_power", _half_batch,
     "spectrum_rel_p99"),
    (tiny.WELCH, "peak bin altered", spectral, "windowed_power_spectrum", _peak_bin_doubled,
     "spectrum_band_max"),
    (tiny.WELCH, "edge band altered", spectral, "windowed_power_spectrum", _edge_bins_zeroed,
     "spectrum_band_max"),
]


@pytest.mark.parametrize("cell,fault,module,name,wrap,check", FAULTS,
                         ids=[f"{c}-{f}" for c, f, *_ in FAULTS])
def test_fault_is_not_correct(root, monkeypatch, cell, fault, module, name, wrap, check):
    monkeypatch.setattr(module, name, wrap(getattr(module, name)))
    code, out = tiny.run(root, cell)
    assert code == 0 and not out["correct"], fault
    c = out["checks"][check]
    assert c["value"] > c["limit"], (fault, out["checks"])


def test_state_unchanged_reads_stale_in_spectrum_too(root, monkeypatch):
    """A spectrum kept from one capture and returned for the other is wrong
    there as well as stale."""
    monkeypatch.setattr(spectral, "windowed_power_spectrum",
                        _unchanged(spectral.windowed_power_spectrum))
    code, out = tiny.run(root, tiny.WELCH)
    assert out["checks"]["spectrum_rel_p99"]["value"] > out["checks"]["spectrum_rel_p99"]["limit"]


@pytest.mark.parametrize("fault", [_peak_bin_doubled, _edge_bins_zeroed])
def test_a_few_bins_pass_the_percentile(root, monkeypatch, fault):
    """What the 99th percentile lets through, the widest band over the floor
    catches."""
    monkeypatch.setattr(spectral, "windowed_power_spectrum",
                        fault(spectral.windowed_power_spectrum))
    code, out = tiny.run(root, tiny.WELCH)
    c = out["checks"]
    assert c["spectrum_rel_p99"]["value"] <= c["spectrum_rel_p99"]["limit"]
    assert c["spectrum_band_max"]["value"] > c["spectrum_band_max"]["limit"]


def test_window_made_elsewhere_reads_unseen(root, monkeypatch):
    """An analyzer that keeps its window and no longer calls
    ``kernels.window.window_block`` reads as its own check, not as a window
    off by the whole range."""
    cached = lru_cache(maxsize=None)(kw.window_block)
    monkeypatch.setattr(spectral, "_window", SimpleNamespace(
        window_block=lambda n0, n, coeffs, spec, device: cached(n0, n, tuple(coeffs), spec,
                                                                device)))
    code, out = tiny.run(root, tiny.WELCH)
    c = out["checks"]
    assert code == 0 and not out["correct"]
    assert c["window_unseen"]["value"] > 0 and c["window_lsb"]["value"] == 0
    assert c["spectrum_rel_p99"]["value"] <= c["spectrum_rel_p99"]["limit"]
