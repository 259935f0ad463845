"""PyTorch port, the polyphase branch FIR kernel (``csrc/polyphase_kernel.cu``,
``kernels/polyphase_kernel.py``).

On the CPU the wrapper runs its plain version, the commutator reshape and
grouped ``conv1d`` the channelizer ran before the kernel, bit for bit, each
output within gamma(tpb + 1) x sum |h| |x| of a float64 channelizer, and
the channelizer goes through it without a launch; a conjugated or negated
view is read as its value; the argument checks and the tap cache are pure
Python and tested here.  The tests marked ``gpu`` run the kernel itself and
skip where torch sees no card (the decision is made in a fixture): against
its plain version on the card and the float64 channelizer; the same bits
whatever the strip length, for a shard's halo as for the whole stream; one
launch a ``channel_bins`` call.  This file imports no JAX, so on the card:

    python -m pytest tests/test_torch_polyphase_kernel.py -m gpu --noconftest -q
"""

import ctypes

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.kernels import polyphase_kernel as pk
from blackman_harris_win_tpu_torch.pipeline import channelizer
from blackman_harris_win_tpu_torch.pipeline.spectral import _full_fp32
from blackman_harris_win_tpu_torch.utils import profiling

#: the SDR cell's call: 2^26 complex64 samples, 128 branches of 16 taps
CELL = (1 << 26, 128, 16)


def _stream(lead, frames, c, dtype, seed=0):
    """Seeded noise (..., frames * c) of ``dtype``, made with numpy."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (frames * c,)
    x = rng.normal(size=shape)
    if dtype.is_complex:
        x = x + 1j * rng.normal(size=shape)
    return torch.from_numpy(x).to(dtype)


def _f64(x: torch.Tensor, h: np.ndarray, c: int):
    """The branch FIRs in float64 of ``x`` (…, nf * c) with the taps ``h``
    (already rounded to x's real type), and the per-output sum of |h| |x|
    (real and imaginary parts apart): (y, s), each (..., nout, c)."""
    tpb = h.size // c
    xp = x.cpu().numpy().astype(np.complex128 if x.is_complex() else np.float64)
    xp = xp.reshape(xp.shape[:-1] + (xp.shape[-1] // c, c))
    nout = xp.shape[-2] - tpb + 1
    hp = h.astype(np.float64).reshape(tpb, c)
    y = np.zeros(xp.shape[:-2] + (nout, c), xp.dtype)
    s = np.zeros_like(y)
    ax = np.abs(xp.real) + 1j * np.abs(xp.imag) if x.is_complex() else np.abs(xp)
    for t in range(tpb):
        win = slice(tpb - 1 - t, tpb - 1 - t + nout)
        y += hp[t] * xp[..., win, :]
        s += np.abs(hp[t]) * ax[..., win, :]
    return y, s


def _gamma(n: int, dtype: torch.dtype) -> float:
    u = 2.0**-24 if dtype in (torch.float32, torch.complex64) else 2.0**-53
    return n * u / (1 - n * u)


def _within(got: torch.Tensor, y64, s64, n: int) -> bool:
    g = got.cpu().numpy().astype(y64.dtype)
    bound = _gamma(n, got.dtype) * s64
    if np.iscomplexobj(y64):
        return bool((np.abs(g.real - y64.real) <= bound.real).all()
                    and (np.abs(g.imag - y64.imag) <= bound.imag).all())
    return bool((np.abs(g - y64) <= bound).all())


# --- the plain version and the channelizer's route on the CPU ---

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
@pytest.mark.parametrize("c,tpb", [(4, 6), (16, 8), (5, 1), (128, 16)])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_cpu_is_todays_branches_bit_for_bit(lead, c, tpb, dtype):
    # the CPU takes the plain version, the channelizer's conv1d route moved
    # unchanged (tests/test_torch_sdr.py holds it to the JAX package), and
    # that is the float64 channelizer's to rounding
    x = _stream(lead, 40, c, dtype, seed=c * tpb)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    want = pk.branch_fir_plain(x, proto, c)
    got = pk.branch_fir(x, proto, c)
    assert got.dtype == x.dtype and got.shape == lead + (40 - tpb + 1, c)
    assert torch.equal(got, want)
    assert _build.launches["polyphase_fir"] == 0
    rdt = np.float32 if dtype in (torch.float32, torch.complex64) else np.float64
    y64, s64 = _f64(x, proto.astype(rdt), c)
    assert _within(got, y64, s64, tpb + 1)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("c,tpb", [(4, 6), (16, 8), (5, 1), (128, 16)])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_conjugated_view_is_read_as_its_value(lead, c, tpb, dtype):
    # x.conj() and x.conj().imag carry a conj or neg bit over x's storage;
    # the branches are those of their values: the conjugate, the negation
    x = _stream(lead, 40, c, dtype, seed=c + tpb)
    proto = channelizer.design_prototype(c, tpb)
    y = pk.branch_fir(x, proto, c)
    got = pk.branch_fir(x.conj(), proto, c)
    assert got.dtype == dtype and torch.equal(got, y.conj().resolve_conj())
    neg = x.conj().imag
    assert neg.is_neg()
    assert torch.equal(pk.branch_fir(neg, proto, c), -pk.branch_fir(x.imag, proto, c))


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_channel_bins_goes_through_the_wrapper(monkeypatch, kind):
    calls = []
    wrapped = pk.branch_fir

    def spy(x, prototype, n_channels):
        calls.append((tuple(x.shape), n_channels))
        return wrapped(x, prototype, n_channels)

    monkeypatch.setattr(channelizer, "branch_fir", spy)
    x = _stream((), 64, 8, torch.complex64 if kind == "complex" else torch.float32)
    proto = channelizer.design_prototype(8, 4)
    y = channelizer.channel_bins(x, proto, 8, device="cpu")
    assert calls == [((512,), 8)]
    fft = torch.fft.fft if kind == "complex" else torch.fft.rfft
    assert torch.equal(y, fft(pk.branch_fir_plain(x, proto, 8), dim=-1))


@pytest.mark.parametrize("fn", [pk.branch_fir, pk.branch_fir_plain])
def test_argument_checks_keep_their_messages(fn):
    proto = channelizer.design_prototype(4, 6)
    with pytest.raises(ValueError, match="input length must be a multiple of n_channels"):
        fn(torch.zeros(33), proto, 4)
    with pytest.raises(ValueError, match="prototype length must be a multiple of n_channels"):
        fn(torch.zeros(32), proto[:-1], 4)


@pytest.mark.parametrize("n", [0, 4, 20])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_no_valid_frame_is_an_empty_output(n, dtype):
    # 6 taps a branch need 6 frames: 0, 1 and 5 frames give none
    proto = channelizer.design_prototype(4, 6)
    _build.reset_launches()
    got = pk.branch_fir(torch.zeros((2, n), dtype=dtype), proto, 4)
    assert got.shape == (2, 0, 4) and got.dtype == dtype
    assert _build.launches["polyphase_fir"] == 0


def test_meta_tensors_are_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        pk.branch_fir(torch.empty(64, device="meta"), channelizer.design_prototype(4, 2), 4)


# --- the tap cache ---

def test_tap_cache_is_one_tensor_per_prototype_and_dtype():
    a = channelizer.design_prototype(8, 4)
    b = channelizer.design_prototype(8, 6)
    t32 = pk.prototype_taps(a, torch.float32, "cpu")
    assert pk.prototype_taps(a.copy(), torch.float32, "cpu") is t32  # by value, not identity
    assert pk.prototype_taps(list(a), torch.float32, torch.device("cpu")) is t32
    assert torch.equal(t32, torch.from_numpy(a.astype(np.float32)))
    t64 = pk.prototype_taps(a, torch.float64, "cpu")
    assert t64 is not t32 and t64.dtype == torch.float64
    assert torch.equal(t64, torch.from_numpy(a))
    tb = pk.prototype_taps(b, torch.float32, "cpu")
    assert tb is not t32 and tb.numel() == b.size


# --- the registrations and the bound ---

def test_signature_query_and_counter_are_registered():
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    assert _build._SIGNATURES["bhw_polyphase_fir"] == (p, p, p, ll, ll, ll, i, ll, i, i, p)
    assert "polyphase_fir" in _build.launches
    _build.reset_launches()
    assert _build.launches["polyphase_fir"] == 0


def test_bounds_are_perf_md_s():
    # PERF.md section 6, row 13: the stream read once, the branches written once
    assert profiling.polyphase_fir_bound(CELL[0], CELL[1], CELL[2], 2, 4) == (
        pytest.approx(0.32052, abs=5e-5), "bytes")
    bounds = profiling.kernel_bounds(1 << 26, 7, 128 << 20, 1 << 20, 1 << 19, 2 * 4 << 26,
                                     ((1 << 22) - 7, 16, 20), 8)
    assert bounds["polyphase_fir"] == (pytest.approx(0.16026, abs=5e-5), "bytes")


# --- on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda", torch.cuda.current_device())


def _launch(y, x, taps, rows, nf, c, tpb, strip):
    """The C entry on its own, at a strip length the test chooses (0: the
    launch's own)."""
    lanes = 2 if x.is_complex() else 1
    _build.launch("polyphase_fir", x.device, y.data_ptr(), x.data_ptr(), taps.data_ptr(), rows,
                  nf, c, tpb, strip, lanes, taps.element_size())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
@pytest.mark.parametrize("tpb", [1, 6, 8, 16])
@pytest.mark.parametrize("c", [4, 16, 100, 128])
def test_kernel_matches_plain_and_float64(cuda, c, tpb, dtype):
    lead = (2,) if c in (4, 100) else ()
    frames = 700 + tpb  # 701 outputs: no multiple of a strip or of the ring
    x = _stream(lead, frames, c, dtype, seed=c * 31 + tpb).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    rdt = torch.float32 if dtype in (torch.float32, torch.complex64) else torch.float64
    h = proto.astype(np.float32 if rdt == torch.float32 else np.float64)
    _build.reset_launches()
    got = pk.branch_fir(x, proto, c)
    torch.cuda.synchronize()
    assert _build.launches["polyphase_fir"] == 1
    assert got.dtype == dtype and got.shape == lead + (frames - tpb + 1, c)
    assert got.is_contiguous()
    assert torch.equal(got, pk.branch_fir(x, proto, c))
    y64, s64 = _f64(x, h, c)
    assert _within(got, y64, s64, tpb + 1)
    plain = pk.branch_fir_plain(x, proto, c)
    assert _within(plain, y64, s64, tpb + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tpb", [(torch.complex64, 16), (torch.float32, 8),
                                       (torch.float32, 40), (torch.complex128, 16),
                                       (torch.float64, 3)])
def test_strip_length_changes_no_bit(cuda, dtype, tpb):
    # every output sums over t in one order: the launch's own strips, strips
    # of 1 frame (the ring's warm-up alone), of 7 and 33 (a partial group),
    # 16 and 256 (whole groups) and the whole row give the same bits; 40
    # float taps and 16 double ones take passes of 16 and 8 taps
    c, frames = 8, 1000
    x = _stream((3,), frames, c, dtype, seed=tpb).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    rdt = x.real.dtype if x.is_complex() else x.dtype
    taps = pk.prototype_taps(proto, rdt, cuda)
    nout = frames - tpb + 1
    outs = []
    for strip in (0, 1, 7, 16, 33, 256, nout):
        y = torch.full((3, nout, c), float("nan"), dtype=dtype, device=cuda)
        _launch(y, x, taps, 3, frames, c, tpb, strip)
        outs.append(y)
    torch.cuda.synchronize()
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
    y64, s64 = _f64(x, taps.cpu().numpy(), c)
    assert _within(outs[0], y64, s64, tpb + 1)


@pytest.mark.gpu
def test_a_shard_with_its_halo_gives_the_whole_stream_s_bits(cuda):
    # the sharded chain channelizes each shard with a left halo of one
    # prototype length: its frames are the whole stream's, bit for bit
    c, tpb, shards = 128, 16, 4
    x = _stream((), 4 * 4096, c, torch.complex64, seed=4).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    whole = pk.branch_fir(x, proto, c)
    per = x.numel() // shards
    for s in range(1, shards):
        piece = pk.branch_fir(x[s * per - c * tpb:(s + 1) * per], proto, c)
        first = s * per // c - tpb  # the halo's first frame
        assert torch.equal(piece, whole[first:first + piece.shape[0]])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sharded_chain_is_the_card_s_chain_bit_for_bit(cuda, kind):
    # make_sharded_sdr_chain's shards (a left halo of one prototype length
    # each) against sdr_chain of the circularly extended stream, both on
    # the card: the same branch bits, so the same output wherever cuFFT
    # rounds a shard's rows as it rounds the whole's
    from blackman_harris_win_tpu_torch.dist.mesh import make_mesh, unshard
    from blackman_harris_win_tpu_torch.pipeline.sdr import make_sharded_sdr_chain, sdr_chain

    c, tpb = 8, 8
    dtype = torch.complex64 if kind == "complex" else torch.float32
    x = _stream((), 4096, c, dtype, seed=9).to(cuda)
    step = make_sharded_sdr_chain(make_mesh(blocks=4, devices=[cuda] * 4), c, tpb)
    out = unshard(step(x))
    want = sdr_chain(torch.cat([x[-c * tpb:], x]), channelizer.design_prototype(c, tpb), c)
    assert out.shape == want.shape and torch.equal(out.to(cuda), want)


@pytest.mark.gpu
def test_cell_shape_once(cuda):
    # 2^26 complex64 samples, 128 branches of 16 taps: 64-bit offsets past
    # 2^31 bytes of neither tensor, but the cell's launch geometry
    n, c, tpb = CELL
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn(n, generator=g, device=cuda, dtype=torch.complex64)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    got = pk.branch_fir(x, proto, c)
    torch.cuda.synchronize()
    assert _build.launches["polyphase_fir"] == 1 and got.shape == (n // c - tpb + 1, c)
    assert torch.equal(got, pk.branch_fir(x, proto, c))
    # against float64 on the first, a middle and the last 4096 frames
    h = proto.astype(np.float32)
    nout = got.shape[0]
    for f0 in (0, nout // 2 - 2048, nout - 4096):
        seg = x[f0 * c:(f0 + 4096 + tpb - 1) * c]
        y64, s64 = _f64(seg, h, c)
        assert _within(got[f0:f0 + 4096], y64, s64, tpb + 1), f0
    plain = pk.branch_fir_plain(x, proto, c)
    rel = float((got - plain).abs().max() / plain.abs().max())
    assert rel < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_one_launch_a_channel_bins_call(cuda, kind):
    from blackman_harris_win_tpu_torch.pipeline.sdr import sdr_chain

    dtype = torch.complex64 if kind == "complex" else torch.float32
    x = _stream((), 2048, 16, dtype, seed=1).to(cuda)
    proto = channelizer.design_prototype(16, 8)
    _build.reset_launches()
    y = channelizer.channel_bins(x, proto, 16)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"polyphase_fir": 1}
    want = (torch.fft.fft if kind == "complex" else torch.fft.rfft)(
        pk.branch_fir(x, proto, 16), dim=-1)
    assert torch.equal(y, want)
    _build.reset_launches()
    sdr_chain(x, proto, 16)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"polyphase_fir": 1, "fm_demod": 1}


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    proto = channelizer.design_prototype(4, 2)
    with pytest.raises(TypeError, match="float32, float64, complex64 or complex128"):
        pk.branch_fir(torch.zeros(64, dtype=torch.int32, device=cuda), proto, 4)
    with pytest.raises(ValueError, match="input length must be a multiple of n_channels"):
        pk.branch_fir(torch.zeros(65, device=cuda), proto, 4)
    _build.reset_launches()
    got = pk.branch_fir(torch.zeros((2, 4), device=cuda), proto, 4)
    assert got.shape == (2, 0, 4) and got.device == cuda
    assert _build.launches["polyphase_fir"] == 0


@pytest.mark.gpu
def test_taps_reach_the_card_once(cuda):
    proto = channelizer.design_prototype(16, 8)
    t = pk.prototype_taps(proto, torch.float32, cuda)
    assert t.device == cuda and pk.prototype_taps(proto.copy(), torch.float32, cuda) is t
    assert pk.prototype_taps(proto, torch.float64, cuda) is not t


@pytest.mark.gpu
@pytest.mark.parametrize("half,wide", [(torch.float16, torch.float32),
                                       (torch.bfloat16, torch.float32),
                                       (torch.complex32, torch.complex64)])
def test_half_types_are_widened_for_the_kernel(cuda, half, wide):
    proto = channelizer.design_prototype(16, 8)
    x = _stream((2,), 300, 16, wide, seed=5).to(cuda).to(half)
    _build.reset_launches()
    got = pk.branch_fir(x, proto, 16)
    torch.cuda.synchronize()
    assert _build.launches["polyphase_fir"] == 1
    assert got.dtype == half and got.shape == (2, 300 - 8 + 1, 16)
    want = pk.branch_fir(x.to(wide), proto, 16).to(half)
    assert torch.equal(got.to(wide), want.to(wide))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_conjugated_capture_on_the_card(cuda, dtype):
    # the kernel reads storage: a conj view (contiguous, its bit set) and a
    # neg view are resolved first, so the card agrees with the plain version
    c, tpb = 128, 16
    x = _stream((), 600, c, dtype, seed=11).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    xc = x.conj()
    assert xc.is_conj() and xc.is_contiguous()
    got = pk.branch_fir(xc, proto, c)
    assert torch.equal(got, pk.branch_fir(x, proto, c).conj().resolve_conj())
    rdt = np.float32 if dtype == torch.complex64 else np.float64
    y64, s64 = _f64(xc.resolve_conj(), proto.astype(rdt), c)
    assert _within(got, y64, s64, tpb + 1)
    assert _within(pk.branch_fir_plain(xc, proto, c), y64, s64, tpb + 1)
    neg = x.conj().imag
    assert torch.equal(pk.branch_fir(neg, proto, c), -pk.branch_fir(x.imag, proto, c))
    bins = channelizer.channel_bins(xc, proto, c)
    assert torch.equal(bins, torch.fft.fft(got, dim=-1))
