"""PyTorch port, the polyphase branch FIR kernel and the fused entry that
adds the DFT across the branches (``csrc/polyphase_kernel.cu``,
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
launch a ``channel_bins`` call.  The fused entry (``branch_dft``, counter
``polyphase_dft``): on the CPU its route (complex64 or complex32, C = 128,
at most 16 taps a branch), its twiddle table, its plain version, and the
kernel source's DFT passes compiled with the host's C++ compiler and run
thread by thread; on the card the kernel against a float64 DFT of the
float64 branches and the two launches it replaces, the same bits for every
strip and for a shard with its halo, and the launches of each route.  This
file imports no JAX, so on the card:

    python -m pytest tests/test_torch_polyphase_kernel.py -m gpu --noconftest -q
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

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


def _f64_bins(x: torch.Tensor, h: np.ndarray, c: int):
    """The channel bins in float64 (the DFT of :func:`_f64`'s branches) and,
    for each frame, S = sum_p (s_p.real + s_p.imag), the bound's scale."""
    y64, s64 = _f64(x, h, c)
    return np.fft.fft(y64, axis=-1), (s64.real + s64.imag).sum(-1, keepdims=True)


def _dft_terms(tpb: int, c: int) -> int:
    """Rounding steps a bin's bound counts: the branch sum's tpb + 1, then
    4 for each of the log2 C stages of the DFT (an add, or a product with a
    twiddle rounded to float32)."""
    return tpb + 1 + 4 * int(math.log2(c))


def _bins_within(got: torch.Tensor, b64, scale, n: int, factor: float = 1.0) -> bool:
    """Each bin's real and imaginary part within factor x gamma(n) x S of
    the float64 bins."""
    g = got.cpu().numpy().astype(np.complex128)
    bound = factor * _gamma(n, got.dtype) * scale
    return bool((np.abs(g.real - b64.real) <= bound).all()
                and (np.abs(g.imag - b64.imag) <= bound).all())


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


# --- the fused entry on the CPU: its route, its twiddles, its plain version ---

@pytest.mark.parametrize("dtype,c,tpb,fused", [
    (torch.complex64, 128, 16, True), (torch.complex64, 128, 1, True),
    (torch.complex64, 128, 8, True), (torch.complex32, 128, 16, True),
    (torch.complex64, 128, 17, False), (torch.complex64, 128, 24, False),
    (torch.complex64, 256, 16, False), (torch.complex64, 64, 16, False),
    (torch.complex64, 16, 8, False), (torch.complex128, 128, 16, False),
    (torch.float32, 128, 16, False), (torch.float32, 16, 8, False),
    (torch.float64, 128, 16, False),
])
def test_fused_route_is_complex64_at_128_channels_and_16_taps(dtype, c, tpb, fused):
    # one block of 128 threads holds every branch of its frames, one pass
    # of 16 taps; everything else keeps the branch kernel and torch.fft
    assert pk.fuses_dft(dtype, c, tpb) is fused


@pytest.mark.parametrize("c,tpb", [(128, 16), (8, 4)])
def test_route_checks_the_prototype_once_and_keeps_the_cpu_off_the_fused_kernel(c, tpb):
    # the channelizer's one routing decision: the checked float64 taps, and
    # the fused launch only for a card's tensor
    proto = channelizer.design_prototype(c, tpb).astype(np.float32)
    h, fused = pk.route(torch.zeros(c * 40, dtype=torch.complex64), proto, c)
    assert h.dtype == np.float64 and np.array_equal(h, proto) and fused is False
    with pytest.raises(ValueError, match="prototype length must be a multiple of n_channels"):
        pk.route(torch.zeros(c * 40, dtype=torch.complex64), proto[:-1], c)


def test_dft_twiddles_are_float64_rounded_once():
    t = pk.dft_twiddles()
    assert t.dtype == np.complex64 and t.shape == (128,) and not t.flags.writeable
    e = np.arange(128)
    w64 = np.exp(-2j * np.pi * e / 128)
    for got, want in ((t.real, w64.real), (t.imag, w64.imag)):
        half_ulp = np.spacing(np.abs(want).astype(np.float32)) / 2
        assert (np.abs(got.astype(np.float64) - want) <= half_ulp).all()
    assert t[0] == 1 and pk.dft_twiddles() is t


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128, torch.float32])
@pytest.mark.parametrize("c,tpb", [(128, 16), (128, 3), (8, 4)])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_branch_dft_on_the_cpu_is_the_plain_branches_and_fft(lead, c, tpb, dtype):
    x = _stream(lead, 40, c, dtype, seed=c + 7 * tpb)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    got = pk.branch_dft(x, proto, c)
    assert torch.equal(got, torch.fft.fft(pk.branch_fir_plain(x, proto, c), dim=-1))
    assert got.shape == lead + (40 - tpb + 1, c) and not any(_build.launches.values())
    assert pk.branch_dft(x[..., :c * (tpb - 1)], proto, c).shape == lead + (0, c)


@pytest.mark.parametrize("fn", ["channel_bins", "polyphase_channelize"])
def test_the_cpu_channelizer_keeps_its_two_stages_at_128_channels(monkeypatch, fn):
    # the fused route is a card's: the CPU still runs the branches, then
    # torch.fft, bit for bit as before
    calls = []
    monkeypatch.setattr(channelizer, "branch_dft", lambda *a: calls.append(a))
    x = _stream((), 40, 128, torch.complex64, seed=3)
    proto = channelizer.design_prototype(128, 16)
    got = getattr(channelizer, fn)(x, proto, 128)
    assert not calls
    assert torch.equal(got, torch.fft.fft(pk.branch_fir_plain(x, proto, 128), dim=-1))


def _kernel_dft_source() -> str:
    """The fused kernel's DFT passes as they are in the CUDA source, from
    their heading to the group function (which holds the barriers)."""
    src = (Path(pk.__file__).resolve().parent.parent / "csrc" / "polyphase_kernel.cu").read_text()
    start = src.index("// --- the fused entry's DFT")
    return src[start:src.index("// The DFT across the branches of a group's frames")]


#: CUDA names for the host's C++ compiler, and a main that runs each pass
#: for the 128 threads in turn (so each pass sees every thread's last one,
#: as the kernel's barriers make it): frames from stdin, nv, bins to stdout
_HOST_PRELUDE = """
#include <cmath>
#include <cstdio>
#define __device__
#define __forceinline__ inline
#define __restrict__
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 __ldg(const float2* p) { return *p; }
constexpr int kThreads = 128;
inline float2 add_s(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
"""
_HOST_MAIN = """
int main() {
  static float2 tw[128], u[128][16], v[128][8], w[128][8];
  alignas(16) static float2 stage[16][128], out[16][128];
  int nv = 0;
  if (fread(tw, sizeof tw, 1, stdin) != 1 || fread(stage, sizeof stage, 1, stdin) != 1 ||
      fread(out, sizeof out, 1, stdin) != 1 || fread(&nv, sizeof nv, 1, stdin) != 1)
    return 2;
  for (int t = 0; t < 128; ++t) dft_load16(stage, t, u[t]);
  for (int t = 0; t < 128; ++t) dft_pass16(stage, t, u[t], tw);
  for (int t = 0; t < 128; ++t) dft_load8(stage, t, v[t], w[t]);
  for (int t = 0; t < 128; ++t) dft_pass8(v[t], w[t], t, tw, &out[0][0], nv);
  return fwrite(out, sizeof out, 1, stdout) == 1 ? 0 : 3;
}
"""


@pytest.fixture(scope="module")
def host_dft(tmp_path_factory):
    """The kernel's DFT passes built for the host: (16, 128) complex64
    frames and nv -> the (16, 128) output buffer, NaN where not stored."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    d = tmp_path_factory.mktemp("host_dft")
    (d / "dft.cpp").write_text(_HOST_PRELUDE + _kernel_dft_source() + _HOST_MAIN)
    # -ffp-contract=off: only the FMAs the source writes are fused
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-o", str(d / "dft"),
                        str(d / "dft.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr

    def run(frames: np.ndarray, nv: int) -> np.ndarray:
        out = np.full((16, 128), np.nan, np.complex64)
        stdin = (pk.dft_twiddles().tobytes() + frames.astype(np.complex64).tobytes()
                 + out.tobytes() + np.int32(nv).tobytes())
        r = subprocess.run([str(d / "dft")], input=stdin, capture_output=True, check=True)
        return np.frombuffer(r.stdout, np.complex64).reshape(16, 128)

    return run


@pytest.mark.parametrize("nv", [16, 13, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_dft_passes_on_the_host(host_dft, seed, nv):
    # the source's two passes, its twiddle indices and its slot layout (a
    # wrong slot overwrites another thread's values): each stored frame is
    # the float64 DFT within gamma(4 log2 128) x sum |re| + |im| of its
    # inputs; frames from nv on are not stored
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(16, 128)) + 1j * rng.normal(size=(16, 128))).astype(np.complex64)
    frames[3] *= 1e3  # rows of other scales keep their own bound
    got = host_dft(frames, nv)
    want = np.fft.fft(frames.astype(np.complex128), axis=-1)
    scale = (np.abs(frames.real) + np.abs(frames.imag)).astype(np.float64).sum(-1, keepdims=True)
    bound = _gamma(4 * 7, torch.complex64) * scale
    assert (np.abs(got.real[:nv] - want.real[:nv]) <= bound[:nv]).all()
    assert (np.abs(got.imag[:nv] - want.imag[:nv]) <= bound[:nv]).all()
    assert np.isnan(got[nv:]).all()


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
    assert _build._SIGNATURES["bhw_polyphase_dft"] == (p, p, p, p, ll, ll, i, ll, p)
    assert "polyphase_fir" in _build.launches and "polyphase_dft" in _build.launches
    _build.reset_launches()
    assert _build.launches["polyphase_fir"] == _build.launches["polyphase_dft"] == 0


def test_bounds_are_perf_md_s():
    # PERF.md section 6, row 13: the stream read once, the branches written once
    assert profiling.polyphase_fir_bound(CELL[0], CELL[1], CELL[2], 2, 4) == (
        pytest.approx(0.32052, abs=5e-5), "bytes")
    # the fused entry: the same bytes (the branch output never written),
    # 64 + 35 flops a channel sample, under them
    assert profiling.polyphase_dft_bound(*CELL) == (pytest.approx(0.32052, abs=5e-5), "bytes")
    bins = (CELL[0] // CELL[1] - CELL[2] + 1) * CELL[1]
    assert (4 * 16 + 5 * 7) * bins / profiling.F32_FLOPS * 1e3 < 0.32 / 3
    bounds = profiling.kernel_bounds(1 << 26, 7, 128 << 20, 1 << 20, 1 << 19, 2 * 4 << 26,
                                     ((1 << 22) - 7, 16, 20), 8, dft_shape=CELL,
                                     pfb_shape=(16, (8 * 1024 + 3) * 2048, 2048, 4, 1024))
    assert bounds["polyphase_fir"] == (pytest.approx(0.16026, abs=5e-5), "bytes")
    assert bounds["polyphase_dft"] == profiling.polyphase_dft_bound(*CELL)


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
@pytest.mark.parametrize("kind", ["real", "complex", "fused"])
def test_sharded_chain_is_the_card_s_chain_bit_for_bit(cuda, kind):
    # make_sharded_sdr_chain's shards (a left halo of one prototype length
    # each) against sdr_chain of the circularly extended stream, both on
    # the card: the same branch bits, so the same output wherever cuFFT
    # rounds a shard's rows as it rounds the whole's; fused: complex64 at
    # 128 channels of 16 taps, every frame's DFT in the kernel's one order
    from blackman_harris_win_tpu_torch.dist.mesh import make_mesh, unshard
    from blackman_harris_win_tpu_torch.pipeline.sdr import make_sharded_sdr_chain, sdr_chain

    c, tpb, frames = (128, 16, 1024) if kind == "fused" else (8, 8, 4096)
    dtype = torch.float32 if kind == "real" else torch.complex64
    x = _stream((), frames, c, dtype, seed=9).to(cuda)
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
    # real: the branch kernel, then cuFFT's half spectrum; complex (the SDR
    # cell's 128 channels of 16 taps): the fused kernel alone, within its
    # bound of the float64 bins and twice that of the two launches
    from blackman_harris_win_tpu_torch.pipeline.sdr import sdr_chain

    c, tpb, counter = (128, 16, "polyphase_dft") if kind == "complex" else (16, 8, "polyphase_fir")
    dtype = torch.complex64 if kind == "complex" else torch.float32
    x = _stream((), 2048, c, dtype, seed=1).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    y = channelizer.channel_bins(x, proto, c)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {counter: 1}
    fft = torch.fft.fft if kind == "complex" else torch.fft.rfft
    two = fft(pk.branch_fir(x, proto, c), dim=-1)
    if kind == "complex":
        b64, scale = _f64_bins(x, proto.astype(np.float32), c)
        assert _bins_within(y, b64, scale, _dft_terms(tpb, c))
        assert _bins_within(y, two.cpu().numpy().astype(np.complex128), scale,
                            _dft_terms(tpb, c), factor=2)
    else:
        assert torch.equal(y, two)
    _build.reset_launches()
    sdr_chain(x, proto, c)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {counter: 1, "fm_demod": 1}


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
    if dtype == torch.complex64:  # the fused kernel reads the view as its value
        assert torch.equal(bins, pk.branch_dft(xc.resolve_conj(), proto, c))
    else:
        assert torch.equal(bins, torch.fft.fft(got, dim=-1))


# --- the fused entry on the card ---

def _dft_launch(y, x, taps, rows, nf, tpb, strip):
    """The fused C entry on its own, at a strip length the test chooses."""
    _build.launch("polyphase_dft", x.device, y.data_ptr(), x.data_ptr(), taps.data_ptr(),
                  pk._twiddles_on(x.device).data_ptr(), rows, nf, tpb, strip)


@pytest.mark.gpu
@pytest.mark.parametrize("tpb", [1, 6, 8, 16])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_fused_matches_float64_and_the_two_launches(cuda, lead, tpb):
    c, frames = 128, 700 + tpb  # 701 outputs: no multiple of a strip or a group
    x = _stream(lead, frames, c, torch.complex64, seed=tpb + len(lead)).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    got = pk.branch_dft(x, proto, c)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"polyphase_dft": 1}
    assert got.dtype == torch.complex64 and got.shape == lead + (frames - tpb + 1, c)
    assert got.is_contiguous() and torch.equal(got, pk.branch_dft(x, proto, c))
    b64, scale = _f64_bins(x, proto.astype(np.float32), c)
    n = _dft_terms(tpb, c)
    assert _bins_within(got, b64, scale, n)
    two = torch.fft.fft(pk.branch_fir(x, proto, c), dim=-1)
    assert _bins_within(got, two.cpu().numpy().astype(np.complex128), scale, n, factor=2)
    assert torch.equal(channelizer.polyphase_channelize(x, proto, c), got)


@pytest.mark.gpu
@pytest.mark.parametrize("tpb", [16, 5])
def test_fused_strip_length_changes_no_bit(cuda, tpb):
    # every frame's sums and DFT run in one order: the launch's own strips,
    # strips of 1 frame, of 7 and 33 (a partial group), 16 and 256 (whole
    # groups) and the whole row give the same bits
    c, frames = 128, 1000
    x = _stream((2,), frames, c, torch.complex64, seed=tpb).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    taps = pk.prototype_taps(proto, torch.float32, cuda)
    nout = frames - tpb + 1
    outs = []
    for strip in (0, 1, 7, 16, 33, 256, nout):
        y = torch.full((2, nout, c), float("nan"), dtype=torch.complex64, device=cuda)
        _dft_launch(y, x, taps, 2, frames, tpb, strip)
        outs.append(y)
    torch.cuda.synchronize()
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
    b64, scale = _f64_bins(x, proto.astype(np.float32), c)
    assert _bins_within(outs[0], b64, scale, _dft_terms(tpb, c))


@pytest.mark.gpu
def test_fused_shard_with_its_halo_gives_the_whole_stream_s_bits(cuda):
    c, tpb, shards = 128, 16, 4
    x = _stream((), 4 * 4096, c, torch.complex64, seed=4).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    whole = pk.branch_dft(x, proto, c)
    per = x.numel() // shards
    for s in range(1, shards):
        piece = pk.branch_dft(x[s * per - c * tpb:(s + 1) * per], proto, c)
        first = s * per // c - tpb  # the halo's first frame
        assert torch.equal(piece, whole[first:first + piece.shape[0]])


@pytest.mark.gpu
def test_fused_cell_shape_once(cuda):
    # the SDR cell's call: 2^26 complex64 samples, 128 branches of 16 taps,
    # against float64 on the first, a middle and the last 4096 frames
    n, c, tpb = CELL
    g = torch.Generator(device=cuda).manual_seed(26)
    x = torch.randn(n, generator=g, device=cuda, dtype=torch.complex64)
    proto = channelizer.design_prototype(c, tpb)
    _build.reset_launches()
    got = pk.branch_dft(x, proto, c)
    torch.cuda.synchronize()
    assert _build.launches["polyphase_dft"] == 1 and got.shape == (n // c - tpb + 1, c)
    assert torch.equal(got, pk.branch_dft(x, proto, c))
    h = proto.astype(np.float32)
    nout = got.shape[0]
    for f0 in (0, nout // 2 - 2048, nout - 4096):
        seg = x[f0 * c:(f0 + 4096 + tpb - 1) * c]
        b64, scale = _f64_bins(seg, h, c)
        assert _bins_within(got[f0:f0 + 4096], b64, scale, _dft_terms(tpb, c)), f0


@pytest.mark.gpu
def test_fused_views_and_empty_inputs(cuda):
    c, tpb = 128, 16
    x = _stream((), 300, c, torch.complex64, seed=12).to(cuda)
    proto = channelizer.design_prototype(c, tpb)
    for view in (x.conj(), torch._neg_view(x)):
        assert view.is_conj() or view.is_neg()
        assert torch.equal(pk.branch_dft(view, proto, c),
                           pk.branch_dft(view.resolve_conj().resolve_neg(), proto, c))
    _build.reset_launches()
    for shape in ((2, c * (tpb - 1)), (0, c * 300), (2, 0)):
        got = pk.branch_dft(torch.zeros(shape, dtype=torch.complex64, device=cuda), proto, c)
        assert got.dtype == torch.complex64 and got.device == cuda
        assert got.shape == shape[:1] + (max(shape[1] // c - tpb + 1, 0), c)
    assert _build.launches["polyphase_dft"] == 0
    with pytest.raises(TypeError, match="complex64 or complex32 at 128 channels"):
        pk.branch_dft(x.real.contiguous(), proto, c)


@pytest.mark.gpu
@pytest.mark.parametrize("case,counts", [
    ("complex64, 128 channels, 16 taps", {"polyphase_dft": 1}),
    ("complex32, 128 channels, 16 taps", {"polyphase_dft": 1}),
    ("float32, 128 channels, 16 taps", {"polyphase_fir": 1}),
    ("complex64, 256 channels, 16 taps", {"polyphase_fir": 1}),
    ("complex64, 128 channels, 24 taps", {"polyphase_fir": 1}),
    ("complex128, 128 channels, 16 taps", {"polyphase_fir": 1}),
])
def test_each_route_s_launches(cuda, case, counts):
    # the fused launch where fuses_dft admits the input, else the branch
    # kernel with today's bits, for channel_bins and polyphase_channelize
    dtype, c, tpb = case.split(", ")
    dtype, c, tpb = getattr(torch, dtype), int(c.split()[0]), int(tpb.split()[0])
    wide = {torch.complex32: torch.complex64}.get(dtype, dtype)
    x = _stream((), 200, c, wide, seed=c + tpb).to(cuda).to(dtype)
    proto = channelizer.design_prototype(c, tpb)
    for fn in (channelizer.channel_bins, channelizer.polyphase_channelize):
        _build.reset_launches()
        y = fn(x, proto, c)
        torch.cuda.synchronize()
        assert {k: v for k, v in _build.launches.items() if v} == counts
        if "polyphase_fir" in counts:
            full = fn is channelizer.polyphase_channelize or dtype.is_complex
            fft = torch.fft.fft if full else torch.fft.rfft
            assert torch.equal(y, fft(pk.branch_fir(x, proto, c), dim=-1))
        else:
            assert y.dtype == dtype and torch.equal(y, pk.branch_dft(x, proto, c))

