"""PyTorch port, the Welch power mean kernel (``csrc/welchpower_kernel.cu``,
``kernels/welchpower_kernel.py``).

On the CPU the wrapper runs its plain version, ``torch.mean(spec.abs() ** 2,
dim=-2)``, bit for bit, and the analyzer's rfft branch goes through it
without a launch.  The kernel's arithmetic (float64 sums in frame order, per
slab, the slabs' partials in slab order, one rounding to float32) is pinned
by a numpy emulation: exact to a float32 rounding of the true mean, and
within the 2e-6 per bin that ``chip_smoke.py`` holds the kernel to against
the plain version on the card.  The tests marked ``gpu`` run the kernel
itself and skip where torch sees no card (the decision is made in a
fixture); this file imports no JAX, so on the card:

    python -m pytest tests/test_torch_welchpower.py -m gpu --noconftest -q
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.kernels import welchpower_kernel as wp
from blackman_harris_win_tpu_torch.pipeline import spectral
from blackman_harris_win_tpu_torch.utils import profiling

#: the benchmark's Welch call: 255 frames of the nfft 2^20 half spectrum
CELL = (255, (1 << 19) + 1)
#: the per-bin relative gap chip_smoke.py allows between kernel and plain
PLAIN_REL = 2e-6


def _spec(shape, dtype=torch.complex64, seed=0):
    """An rfft half spectrum of windowed noise and a tone: (*lead, nF, K)."""
    *lead, nf, k = shape
    nfft = 2 * (k - 1) if k > 1 else 2
    g = torch.Generator().manual_seed(seed)
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    n = torch.arange(nfft, dtype=torch.float64)
    x = torch.randn((*lead, nf, nfft), generator=g, dtype=torch.float64) * 1e-3
    x = x + torch.cos(2 * math.pi * 0.1234 * n)
    win = torch.hann_window(nfft, periodic=True, dtype=torch.float64)
    spec = torch.fft.rfft((x * win).to(real), dim=-1)
    return spec[..., :k].contiguous()


def _emulate(spec: np.ndarray, slabs: int = 1) -> np.ndarray:
    """The kernel's arithmetic on a (B, nF, K) complex64 array: per slab of
    ceil(nF / slabs) frames, re*re + im*im summed in float64 in frame order
    from 0 (the squares of float32 values are exact in float64, so numpy's
    product and add round as the kernel's FMA does); the partials summed in
    slab order from 0; divided by nF; rounded once to float32."""
    nf = spec.shape[-2]
    per = -(-nf // slabs)
    re = spec.real.astype(np.float64)
    im = spec.imag.astype(np.float64)
    total = np.zeros(spec.shape[:-2] + spec.shape[-1:])
    for s in range(slabs):
        acc = np.zeros_like(total)
        for f in range(s * per, min(nf, (s + 1) * per)):
            acc = acc + (re[..., f, :] * re[..., f, :] + im[..., f, :] * im[..., f, :])
        total = total + acc
    return (total / nf).astype(np.float32)


# --- the plain version and the analyzer's route on the CPU ---

@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("nf", [1, 2, 255])
@pytest.mark.parametrize("k", [129, 128])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_plain_bit_for_bit(lead, k, nf, dtype):
    spec = _spec((*lead, nf, k), dtype, seed=nf * k)
    got = wp.frame_power_mean(spec)
    want = torch.mean(spec.abs() ** 2, dim=-2)
    assert got.dtype == spec.real.dtype and got.shape == (*lead, k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_rfft_branch_goes_through_the_wrapper(monkeypatch, lead):
    calls = []
    wrapped = wp.frame_power_mean

    def spy(spec):
        calls.append(tuple(spec.shape))
        return wrapped(spec)

    monkeypatch.setattr(wp, "frame_power_mean", spy)
    g = torch.Generator().manual_seed(3)
    fr = torch.randn((*lead, 7, 256), generator=g)
    _build.reset_launches()
    got = spectral.frame_mean_power(fr, "rfft")
    assert calls == [(*lead, 7, 129)]
    assert _build.launches["welch_power_mean"] == 0
    assert torch.equal(got, torch.mean(torch.fft.rfft(fr, dim=-1).abs() ** 2, dim=-2))


def _real(spec):
    return spec.real.contiguous()


def _strided(spec):
    return spec[..., ::2]


def _transposed(spec):
    return spec.mT


def _one_dim(spec):
    return spec[0].contiguous()


def _no_frames(spec):
    return spec[:0].contiguous()


def _meta(spec):
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


@pytest.mark.parametrize("make,error,match", [
    (_real, ValueError, "complex64 or complex128"),
    (_strided, ValueError, "contiguous"),
    (_transposed, ValueError, "contiguous"),
    (_one_dim, ValueError, "contiguous"),
    (_no_frames, ValueError, "no frames"),
    (_meta, ValueError, "unsupported device"),
])
def test_check_spec_refuses(make, error, match):
    spec = make(_spec((4, 9)))
    with pytest.raises(error, match=match):
        wp.check_spec(spec)
    with pytest.raises(error, match=match):
        wp.frame_power_mean(spec)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_check_spec_takes_the_rfft_output(dtype):
    assert wp.check_spec(_spec((3, 5, 9), dtype)) == torch.device("cpu")


def test_signature_and_counter_are_registered():
    sig = _build._SIGNATURES["bhw_welch_power_mean"]
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert sig == (p, p, p, ll, ll, ll, i, i, p)
    assert "welch_power_mean" in _build.launches
    _build.reset_launches()
    assert _build.launches["welch_power_mean"] == 0


def test_bound_is_perf_md_s():
    # PERF.md section 6, row 12: the cell's spectrum read once, the mean written
    bounds = profiling.kernel_bounds(1 << 26, 7, 128 << 20, 1 << 20, 1 << 19, 2 * 4 << 26,
                                     ((1 << 22) - 7, 16, 20), 8, dft_shape=(1 << 26, 128, 16),
                                     pfb_shape=(16, (8 * 1024 + 3) * 2048, 2048, 4, 1024))
    assert bounds["welch_power_mean"] == (pytest.approx(0.3199, abs=5e-5), "bytes")


def test_cpu_spans_are_the_plain_version_s():
    from torch.profiler import ProfilerActivity, profile

    from blackman_harris_win_tpu_torch import _trace

    spec = _spec((5, 129))
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        wp.frame_power_mean(spec)
    spans = _trace.snapshot()["spans"]
    assert spans["bhw.welch.power"]["count"] == 1
    assert spans["bhw.welch.mean"]["count"] == 1
    for row in spans.values():
        assert set(row) == {"count", "host_s", "self_s", "stream_s", "stream_n"}


# --- the slab rule ---

@pytest.mark.parametrize("cols,nf,want", [
    (CELL[1], CELL[0], 1),            # the benchmark's call: the columns fill the card
    (2 * CELL[1], 127, 1),            # make_sharded_welch's (2, T) on one shard row pair
    (wp.FULL_COLUMNS, 65535, 1),
    (2049, 31, 1),                    # too few frames for two slabs
    (2049, 65535, 256),               # nfft 4096 over 128 * 2^20 samples
    (1, 1000, 59),                    # one column: 62 slabs of 16, trimmed to 59 of 17
    (4097, 65535, 128),
])
def test_frame_slabs(cols, nf, want):
    slabs = wp.frame_slabs(cols, nf)
    assert slabs == want
    per = -(-nf // slabs)
    assert (slabs - 1) * per < nf  # no empty slab
    assert slabs == 1 or per >= wp.MIN_SLAB_FRAMES
    assert slabs <= wp.MAX_SLABS


# --- the kernel's arithmetic, emulated ---

@pytest.mark.parametrize("shape,slabs", [
    ((255, 1025), 1), ((255, 1025), 4), ((2, 127, 513), 1), ((64, 65), 3), ((1, 9), 1),
])
def test_emulation_is_the_mean_rounded_once(shape, slabs):
    spec = _spec(shape, seed=len(shape) * 31 + slabs).numpy()
    got = _emulate(spec.reshape((-1,) + spec.shape[-2:]), slabs).reshape(shape[:-2] + shape[-1:])
    re, im = spec.real.astype(np.float64), spec.imag.astype(np.float64)
    exact = (re * re + im * im).mean(axis=-2)  # float64: within 2^-45 of the true mean
    rel = np.abs(got.astype(np.float64) - exact) / exact
    assert float(rel.max()) <= 2.0**-24 * (1 + 1e-5)


@pytest.mark.parametrize("shape", [CELL[:1] + (4097,), (2, 127, 4097), (65, 2049)])
def test_emulation_is_within_the_card_s_limit_of_plain(shape):
    spec = _spec(shape, seed=shape[-2])
    got = _emulate(spec.numpy().reshape((-1,) + tuple(spec.shape[-2:])),
                   wp.frame_slabs(spec.numel() // shape[-2], shape[-2]))
    plain = wp.frame_power_mean_plain(spec).numpy().reshape(got.shape).astype(np.float64)
    rel = np.abs(got - plain) / plain
    assert float(rel.max()) <= PLAIN_REL


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((255, 4097), torch.complex64),
    ((2, 127, 4097), torch.complex64),
    ((2047, 129), torch.complex64),     # slabs
    ((3, 1, 9), torch.complex64),
    ((31, 1025), torch.complex128),
    ((600, 65), torch.complex128),      # slabs
])
def test_kernel_matches_plain_and_repeats(cuda, shape, dtype):
    spec = _spec(shape, dtype, seed=shape[-1]).to(cuda)
    _build.reset_launches()
    got = wp.frame_power_mean(spec)
    assert _build.launches["welch_power_mean"] == 1
    again = wp.frame_power_mean(spec)
    assert torch.equal(got, again)
    plain = wp.frame_power_mean_plain(spec)
    assert got.dtype == plain.dtype and got.shape == plain.shape
    rel = ((got.double() - plain.double()).abs() / plain.double()).max()
    assert float(rel) <= PLAIN_REL
    if dtype == torch.complex64:
        flat = spec.cpu().numpy().reshape((-1,) + shape[-2:])
        want = _emulate(flat, wp.frame_slabs(flat.shape[0] * shape[-1], shape[-2]))
        assert np.array_equal(got.cpu().numpy().reshape(want.shape), want)


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    spec = _spec((4, 9)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        wp.frame_power_mean(spec[..., ::2])
    with pytest.raises(ValueError, match="complex64 or complex128"):
        wp.frame_power_mean(spec.real.contiguous())
