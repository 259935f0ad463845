"""PyTorch port, the PFB spectrometer (``pipeline/spectrometer.py``,
``pfb_power``) against its plain reference
(``tests/torch_reference/pfb_spectrometer.py``; the benchmark's copy is
``portbench/reference/pfb.py``), on seeded int8 captures: sky noise, a
carrier and the ADC's clip.

On the CPU, at C in {16, 64, 2048}, 1, 4 and 5 taps a branch, 1 and 3
feeds, 1 and 8 spectra an integration: each bin within 4 n u (P64 + the
integration's mean bin) of the float64 reference (the tolerance's reason is
at :func:`_within`); an int8 capture gives the bits of its float32 copy in
``branch_fir``, ``polyphase_channelize`` and ``pfb_power``; a length that
is no whole number of integrations raises; the reference against the
formula in numpy, its TF32 control out of the tolerance, and the two copies
one text.  The tests marked ``gpu`` run the card's route (one
``polyphase_fir`` and one ``welch_power_mean`` launch a call) and skip
where torch sees no card (decided in a fixture).  This file imports no
JAX, so on the card:

    python -m pytest tests/test_torch_spectrometer.py -m gpu --noconftest -q
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.kernels import polyphase_kernel as pk
from blackman_harris_win_tpu_torch.kernels import welchpower_kernel as wp
from blackman_harris_win_tpu_torch.pipeline import channelizer, spectrometer

HERE = Path(__file__).resolve().parent
REF_PATH = HERE / "torch_reference" / "pfb_spectrometer.py"
BENCH_REF_PATH = HERE.parent / "portbench" / "reference" / "pfb.py"
#: float32's unit roundoff
U = 2.0**-24


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(REF_PATH, "_pfb_spectrometer_reference")


def _capture(feeds: int, c: int, tpb: int, n_acc: int, n_int: int = 2,
             seed: int = 0) -> torch.Tensor:
    """Seeded int8 words (feeds, (n_acc n_int + tpb - 1) C): Gaussian noise
    of rms 10 LSB per feed, a common carrier at 0.3 of a bin above bin
    C / 5 with its own amplitude (up to 60 LSB) and phase per feed, rounded
    and clipped at +-127 (some words of the strongest feed clip)."""
    rng = np.random.default_rng(seed)
    n = (n_acc * n_int + tpb - 1) * c
    t = np.arange(n)
    amp = rng.uniform(5.0, 60.0, (feeds, 1))
    x = rng.normal(size=(feeds, n)) * 10.0 + amp * np.cos(
        2 * np.pi * np.mod((c // 5 + 0.3) / c * t, 1.0) + rng.uniform(0, 2 * np.pi, (feeds, 1)))
    x[0, ::97] += 300.0  # a few words past full scale
    return torch.from_numpy(np.clip(np.round(x), -127, 127).astype(np.int8))


def _within(got: torch.Tensor, want: torch.Tensor, c: int, tpb: int, factor: float = 4.0):
    """Each bin within factor x n u x (P64 + the integration's mean P64),
    n = tpb + 1 + log2 C: a branch sum rounds tpb + 1 times in float32, the
    real FFT about once a stage of its log2 C, each rounding spread by the
    FFT over every bin of the frame (so the frame's mean power, not the
    bin's, is its scale where a bin is faint), |Y|^2 doubles the relative
    error and the mean over spectra only averages it.  Over every case here
    the worst bin reads 0.87 n u, so 4 leaves room for other seeds while a
    TF32 operand (2^-11, 8192 u) stays far outside."""
    scale = want + want.mean(dim=-1, keepdim=True)
    n = tpb + 1 + int(math.log2(c))
    return bool(((got.double() - want).abs() <= factor * n * U * scale).all())


@pytest.mark.parametrize("n_acc", [1, 8])
@pytest.mark.parametrize("feeds", [1, 3])
@pytest.mark.parametrize("tpb", [1, 4, 5])
@pytest.mark.parametrize("c", [16, 64, 2048])
def test_against_the_reference(c, tpb, feeds, n_acc):
    x = _capture(feeds, c, tpb, n_acc, seed=c * 10 + tpb + feeds * n_acc)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    got = spectrometer.pfb_power(x, proto, c, n_acc, device="cpu")
    assert got.shape == (feeds, 2, c // 2 + 1) and got.dtype == torch.float32
    assert not any(_build.launches.values())
    want = REF.pfb_power(x, proto, c, n_acc)
    assert bool((want > 0).all())
    assert _within(got, want, c, tpb)


@pytest.mark.parametrize("c,tpb", [(16, 4), (2048, 4)])
def test_int8_is_its_float32_copy_bit_for_bit(c, tpb):
    x = _capture(3, c, tpb, 8, seed=c)
    xf = x.to(torch.float32)
    proto = channelizer.design_prototype(c, tpb)
    for fn in (pk.branch_fir, channelizer.polyphase_channelize, channelizer.channel_bins):
        got = fn(x, proto, c)
        assert got.dtype in (torch.float32, torch.complex64)
        assert torch.equal(got, fn(xf, proto, c))
    got = spectrometer.pfb_power(x, proto, c, 8)
    assert torch.equal(got, spectrometer.pfb_power(xf, proto, c, 8))


def test_int8_with_no_valid_frame_is_an_empty_float32_output():
    proto = channelizer.design_prototype(4, 6)
    got = pk.branch_fir(torch.zeros((2, 20), dtype=torch.int8), proto, 4)
    assert got.shape == (2, 0, 4) and got.dtype == torch.float32


@pytest.mark.parametrize("frames,n_acc", [(3 + 9, 8), (3 + 7, 8), (3 + 16, 0), (2, 1)])
def test_no_whole_number_of_integrations_raises(frames, n_acc):
    c, tpb = 16, 4
    x = torch.zeros((2, frames * c), dtype=torch.int8)
    proto = channelizer.design_prototype(c, tpb)
    with pytest.raises(ValueError):
        spectrometer.pfb_power(x, proto, c, n_acc)
    with pytest.raises(ValueError):
        REF.pfb_power(x, proto, c, n_acc)


def test_no_whole_number_of_frames_raises():
    proto = channelizer.design_prototype(16, 4)
    with pytest.raises(ValueError, match="multiple of n_channels"):
        spectrometer.pfb_power(torch.zeros(16 * 12 + 3, dtype=torch.int8), proto, 16, 1)


def test_integrations():
    assert spectrometer.integrations((8 * 1024 + 3) * 2048, 2048, 4, 1024) == 8
    assert REF.integrations((8 * 1024 + 3) * 2048, 2048, 4, 1024) == 8
    assert spectrometer.integrations(12 * 16, 16, 1, 4) == 3


def test_each_integration_is_the_mean_of_its_spectra():
    """Integration i is the mean of the half spectra of valid frames
    i n_acc .. (i + 1) n_acc - 1, feed by feed, taken here from the
    channelizer itself."""
    c, tpb, n_acc = 16, 4, 8
    x = _capture(3, c, tpb, n_acc, n_int=3, seed=5)
    proto = channelizer.design_prototype(c, tpb)
    bins = channelizer.channel_bins(x, proto, c)
    want = (bins.abs() ** 2).reshape(3, 3, n_acc, c // 2 + 1).mean(dim=2)
    got = spectrometer.pfb_power(x, proto, c, n_acc)
    # the same float32 bins, squared and averaged in another order: the
    # square rounds twice and the mean of 8 three times, so within 8 u
    torch.testing.assert_close(got, want, rtol=4 * 8 * U, atol=0)
    # a feed alone is its row of the whole
    for f in range(3):
        torch.testing.assert_close(spectrometer.pfb_power(x[f], proto, c, n_acc), got[f],
                                   rtol=4 * 8 * U, atol=0)


def test_a_complex_stream_keeps_every_channel():
    c, tpb = 16, 4
    x = _capture(2, c, tpb, 4, seed=9).to(torch.float32)
    z = torch.complex(x[0], x[1])
    proto = channelizer.design_prototype(c, tpb)
    got = spectrometer.pfb_power(z, proto, c, 4)
    assert got.shape == (2, c) and got.dtype == torch.float32
    y = channelizer.polyphase_channelize(z, proto, c)
    torch.testing.assert_close(got, (y.abs() ** 2).reshape(2, 4, c).mean(dim=1),
                               rtol=4 * 8 * U, atol=0)


def test_reference_against_the_formula_in_numpy():
    c, tpb, n_acc = 8, 3, 4
    x = _capture(2, c, tpb, n_acc, seed=3)
    h = channelizer.design_prototype(c, tpb)
    xs = x.numpy().astype(np.float64)
    frames = xs.shape[1] // c
    want = np.zeros((2, 2, c // 2 + 1))
    for f in range(2):
        spectra = []
        for m in range(tpb - 1, frames):
            v = [sum(h[t * c + p] * xs[f, (m - t) * c + p] for t in range(tpb)) for p in range(c)]
            spectra.append([abs(sum(np.exp(-2j * np.pi * p * k / c) * v[p] for p in range(c))) ** 2
                            for k in range(c // 2 + 1)])
        want[f] = np.array(spectra).reshape(2, n_acc, -1).mean(axis=1)
    got = REF.pfb_power(x, h, c, n_acc, block=5)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("c", [64, 2048])
def test_the_tf32_control_leaves_the_tolerance(c):
    x = _capture(3, c, 4, 8, seed=c + 1)
    proto = channelizer.design_prototype(c, 4)
    want = REF.pfb_power(x, proto, c, 8)
    assert not _within(REF.pfb_power_tf32(x, proto, c, 8), want, c, 4)
    assert _within(spectrometer.pfb_power(x, proto, c, 8), want, c, 4)


@pytest.mark.parametrize("c,tpb", [(2048, 4), (16, 4), (64, 5), (16, 1), (4, 6)])
def test_the_reference_s_prototype_is_the_program_s(c, tpb):
    """The reference builds its taps from the BH-4 cosine sum in float64,
    rounded to W = 24; the program's come from its fixed-point window
    generator, within a few LSB of that rounding (5 at most here).  Each tap
    within 16 LSB of 2^-23 of the largest: 8 for the window, as much again
    for the rescaling to unity DC gain."""
    h = channelizer.design_prototype(c, tpb)
    want = REF.prototype(c, tpb, 24)
    assert want.dtype == torch.float64 and want.shape == (c * tpb,)
    assert float(want.sum()) == pytest.approx(1.0, abs=1e-15)
    assert np.abs(h - want.numpy()).max() <= 16 * 2.0**-23 * np.abs(h).max()


def test_the_reference_s_window_is_the_quantized_golden_model():
    """At a grid of the taps' own length the reference's window is the
    catalog's quantized golden model, round((2^23 - 1) w), exactly."""
    from blackman_harris_win_tpu_torch.windows import catalog

    c, tpb = 2048, 4
    n = c * tpb
    w = catalog.golden_quantized_window("bh4", np.arange(n), n, 24) / (2.0**23 - 1)
    m = np.arange(n) - (n - 1) / 2
    h = np.sinc(m / c) / c * w
    np.testing.assert_allclose(REF.prototype(c, tpb, 24).numpy(), h / h.sum(), rtol=1e-13,
                               atol=1e-18)


def test_the_two_copies_are_one():
    assert REF_PATH.read_text() == BENCH_REF_PATH.read_text()
    bench = _load(BENCH_REF_PATH, "_pfb_bench_reference")
    x, proto = _capture(2, 16, 4, 8, seed=4), channelizer.design_prototype(16, 4)
    assert torch.equal(REF.pfb_power(x, proto, 16, 8), bench.pfb_power(x, proto, 16, 8))
    assert torch.equal(REF.pfb_power_tf32(x, proto, 16, 8), bench.pfb_power_tf32(x, proto, 16, 8))
    assert torch.equal(REF.prototype(2048, 4), bench.prototype(2048, 4))


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("c,tpb,feeds,n_acc", [(2048, 4, 16, 64), (2048, 5, 3, 8),
                                               (64, 4, 1, 8), (16, 1, 3, 1)])
def test_card_against_the_reference(cuda, c, tpb, feeds, n_acc):
    x = _capture(feeds, c, tpb, n_acc, n_int=3, seed=c + tpb).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    got = spectrometer.pfb_power(x, proto, c, n_acc)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"polyphase_fir": 1,
                                                               "welch_power_mean": 1}
    assert got.shape == (feeds, 3, c // 2 + 1) and got.dtype == torch.float32
    assert got.device == cuda
    want = REF.pfb_power(x, proto, c, n_acc)
    assert _within(got, want, c, tpb)
    assert torch.equal(got, spectrometer.pfb_power(x, proto, c, n_acc))


@pytest.mark.gpu
def test_card_int8_is_its_float32_copy_bit_for_bit(cuda):
    c, tpb = 2048, 4
    x = _capture(16, c, tpb, 16, seed=1).to(cuda)
    xf = x.to(torch.float32)
    proto = channelizer.design_prototype(c, tpb)
    for fn in (pk.branch_fir, channelizer.polyphase_channelize, channelizer.channel_bins):
        got = fn(x, proto, c)
        assert got.dtype in (torch.float32, torch.complex64)
        assert torch.equal(got, fn(xf, proto, c))
    assert torch.equal(spectrometer.pfb_power(x, proto, c, 16),
                       spectrometer.pfb_power(xf, proto, c, 16))
    # and the card's branch sums are the plain version's to rounding
    y64 = REF.pfb_power(x, proto, c, 16)
    assert _within(spectrometer.pfb_power(x.cpu(), proto, c, 16), y64.cpu(), c, tpb)


@pytest.mark.gpu
def test_the_cell_s_integration_runs_the_slab_path(cuda):
    # the cell's (16, 8, 1025) columns fill no card alone: four slabs
    assert wp.frame_slabs(16 * 8 * 1025, 1024) == 4
    c, tpb, n_acc = 2048, 4, 1024
    x = _capture(16, c, tpb, n_acc, n_int=1, seed=2).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    got = spectrometer.pfb_power(x, proto, c, n_acc)
    assert _within(got, REF.pfb_power(x, proto, c, n_acc), c, tpb)
