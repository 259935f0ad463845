"""PyTorch port, ``_trace``: the spans of the window router, the window
wrapper, the launch helper, the Welch analyzer's stages, the SDR chain's
(``bhw.sdr``: on a card one ``polyphase_fir`` and one ``fm_demod`` launch a
call, or for the SDR cell's complex capture at 128 channels one
``polyphase_dft`` and one ``fm_demod``) and the PFB spectrometer's
(``bhw.pfb``: on a card one ``polyphase_fir`` and one ``welch_power_mean``
launch a call), each chain's stage paths those the benchmark reads.

Without a profiler session a span is one shared no-op (``record_function``
is never entered); under one each span is a ``user_annotation`` of the
Chrome trace inside its root, and the table counts the calls.  Outputs are
the same bits either way.  ``utils.profiling.trace`` writes the table as
``spans.json``.  ``_build.launch`` raises on a non-zero code and counts a
launch (a stub C entry here)."""

import contextlib
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blackman_harris_win_tpu_torch import _build, _trace
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.pipeline import sdr as sdr_pipe
from blackman_harris_win_tpu_torch.pipeline import channelizer, spectral, spectrometer
from blackman_harris_win_tpu_torch.utils import profiling
from blackman_harris_win_tpu_torch.windows import catalog

WIN_MODES = ("quantized", "float", "comp")
FFT_MODES = ("rfft", "packed", "mxu")
STAGES = ("window", "apply", "fft", "power", "mean")
#: the sums a span path keeps
ROW_KEYS = {"count", "host_s", "self_s", "stream_s", "stream_n"}
SPEC = WindowSpec(phase_width=10, data_width=17)
#: (name, spec): one window of each route of ``kernels.window.window_block``
ROUTES = {
    "cordic": ("bh4", SPEC),
    "taylor_hls": ("blackman", WindowSpec(phase_width=10, data_width=16, sin_type="taylor",
                                          lut_size=6)),
    "taylor_rtl": ("hamming", WindowSpec(phase_width=10, data_width=16, sin_type="taylor",
                                         lut_size=6, rounding="rtl")),
    "taylor2": ("bh7", WindowSpec(phase_width=12, data_width=24, sin_type="taylor2",
                                  lut_size=8)),
}


def _capture(frames: int = 15) -> torch.Tensor:
    """A float32 capture of ``frames`` half-overlapped frames of SPEC.n (an
    odd count, so the packed and mxu paths pad a frame)."""
    g = torch.Generator().manual_seed(7)
    return torch.randn((frames + 1) * SPEC.n // 2, generator=g)


def _welch(win_mode: str, fft_mode: str, x=None):
    return spectral.windowed_power_spectrum(_capture() if x is None else x, "bh4", SPEC,
                                            win_mode=win_mode, fft_mode=fft_mode,
                                            device="cpu")


def _route(route: str):
    name, spec = ROUTES[route]
    q = catalog.get(name).quantized(spec.data_width)
    return kw.window_block(5, spec.n - 9, q, spec, "cpu")


def _annotations(prof, tmp_path) -> list[dict]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("bhw.")]


def _inside(e: dict, roots: list[dict]) -> bool:
    """Whether ``e`` lies within one of ``roots`` (the trace's microseconds
    carry 3 decimals: 2 ns for the rounding of a start and a length)."""
    return any(r["ts"] - 2e-3 <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"] + 2e-3
               for r in roots)


@pytest.fixture
def no_record_function(monkeypatch):
    """``record_function`` raises wherever the spans could reach it."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler session")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _trace.reset()
    yield
    assert _trace.snapshot()["spans"] == {}


def test_a_span_without_a_session_is_one_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert _trace.span("bhw.a") is _trace.span("bhw.b", torch.device("cpu"))


@pytest.mark.parametrize("fft_mode", FFT_MODES)
@pytest.mark.parametrize("win_mode", WIN_MODES)
def test_welch_enters_no_record_function_without_a_session(no_record_function, win_mode,
                                                           fft_mode):
    assert _welch(win_mode, fft_mode).shape == (SPEC.n // 2 + 1,)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_window_block_enters_no_record_function_without_a_session(no_record_function, route):
    assert _route(route).shape == (ROUTES[route][1].n - 9,)


@pytest.mark.parametrize("fft_mode", FFT_MODES)
@pytest.mark.parametrize("win_mode", WIN_MODES)
def test_welch_spans_in_the_trace_and_the_table(tmp_path, win_mode, fft_mode):
    x = _capture()
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _welch(win_mode, fft_mode, x)
    events = _annotations(prof, tmp_path)
    roots = [e for e in events if e["name"] == "bhw.welch"]
    assert len(roots) == 3
    names = {e["name"] for e in events}
    want = {f"bhw.welch.{s}" for s in STAGES}
    if win_mode == "quantized":
        want |= {"bhw.window_block", "bhw.params"}
    assert want <= names
    assert all(_inside(e, roots) for e in events)
    spans = _trace.snapshot()["spans"]
    assert spans["bhw.welch"]["count"] == 3
    for s in STAGES:
        row = spans[f"bhw.welch/bhw.welch.{s}"]
        assert row["count"] == 3 and set(row) == ROW_KEYS
        assert row["stream_n"] == 0  # no stream on the CPU
    for row in spans.values():
        assert 0 <= row["self_s"] <= row["host_s"]
    if win_mode == "quantized":
        assert spans["bhw.welch/bhw.welch.window/bhw.window_block/bhw.params"]["count"] == 3


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_window_block_spans(tmp_path, route):
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _route(route)
        _route(route)
    events = _annotations(prof, tmp_path)
    roots = [e for e in events if e["name"] == "bhw.window_block"]
    assert len(roots) == 2 and all(_inside(e, roots) for e in events)
    spans = _trace.snapshot()["spans"]
    assert spans["bhw.window_block"]["count"] == 2
    if route == "cordic":  # the window kernel's wrapper; on the CPU no alloc or launch
        assert {e["name"] for e in events} == {"bhw.window_block", "bhw.params"}
        assert spans["bhw.window_block/bhw.params"]["count"] == 2


@pytest.mark.parametrize("fft_mode", FFT_MODES)
@pytest.mark.parametrize("win_mode", WIN_MODES)
def test_welch_bits_are_the_same_traced(win_mode, fft_mode):
    x = _capture()
    off = _welch(win_mode, fft_mode, x)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _welch(win_mode, fft_mode, x)
    assert torch.equal(on, off)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_window_bits_are_the_same_traced(route):
    off = _route(route)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _route(route)
    assert torch.equal(on, off)


def test_paths_and_self_time():
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with _trace.span("bhw.a"):
            with _trace.span("bhw.b"):
                time.sleep(0.02)
            with _trace.span("bhw.b"):
                pass
        with _trace.span("bhw.b"):
            pass
    spans = _trace.snapshot()["spans"]
    assert set(spans) == {"bhw.a", "bhw.a/bhw.b", "bhw.b"}
    a, ab = spans["bhw.a"], spans["bhw.a/bhw.b"]
    assert ab["count"] == 2 and ab["host_s"] >= 0.02
    assert all(set(row) == ROW_KEYS for row in spans.values())
    assert a["host_s"] >= ab["host_s"]
    assert a["self_s"] == pytest.approx(a["host_s"] - ab["host_s"])
    _trace.reset()
    assert _trace.snapshot()["spans"] == {}


def test_trace_writes_spans_json(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with _trace.span("bhw.outside"):
            pass
    assert "bhw.outside" in _trace.snapshot()["spans"]
    with profiling.trace(tmp_path / "t"):
        _welch("quantized", "rfft")
    got = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert set(got) == {"spans", "launches"}
    assert set(got["launches"]) == set(_build.launches)
    # emptied when the session started: the span before it is gone
    assert "bhw.outside" not in got["spans"]
    assert got["spans"]["bhw.welch"]["count"] == 1
    assert got["spans"]["bhw.welch/bhw.welch.fft"]["count"] == 1
    assert (tmp_path / "t" / "trace.json").is_file()


class _StubLib:
    """A kernel library whose one C entry returns a chosen code."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def bhw_stub(self, *args):
        self.calls.append(("bhw_stub", args))
        return self.rc

    def bhw_stub_entry(self, *args):
        self.calls.append(("bhw_stub_entry", args))
        return self.rc

    def bhw_error_string(self, rc):
        return b"a stub error"


@pytest.fixture
def stub(monkeypatch):
    """``_build.launch`` against a stub library, without a card: the device
    context a no-op, the stream a number."""
    def make(rc):
        lib = _StubLib(rc)
        monkeypatch.setattr(_build, "_lib", lib)
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(_build, "stream_of", lambda d: 77)
        monkeypatch.setitem(_build.launches, "stub", 0)
        return lib
    return make


def test_launch_counts_and_passes_the_stream(stub):
    lib = stub(0)
    _build.launch("stub", torch.device("cpu"), 1, 2)
    _build.launch("stub", torch.device("cpu"), 3, entry="stub_entry")
    assert lib.calls == [("bhw_stub", (1, 2, 77)), ("bhw_stub_entry", (3, 77))]
    assert _build.launches["stub"] == 2


def test_launch_raises_on_a_code_and_counts_nothing(stub):
    stub(700)
    with pytest.raises(RuntimeError, match=r"stub kernel launch failed: CUDA error 700 "
                                           r"\(a stub error\)"):
        _build.launch("stub", torch.device("cpu"))
    assert _build.launches["stub"] == 0


def test_launch_span_under_a_session(stub, tmp_path):
    stub(0)
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _trace.span("bhw.window_block"):
            _build.launch("stub", torch.device("cpu"), 1)
    assert [e["name"] for e in _annotations(prof, tmp_path)] == ["bhw.window_block",
                                                                 "bhw.launch.stub"]
    snap = _trace.snapshot()
    assert snap["spans"]["bhw.window_block/bhw.launch.stub"]["count"] == 1
    assert snap["launches"]["stub"] == 1


# --- the SDR chain: bhw.sdr and its stages ---

SDR_STAGES = ("branches", "dft", "demod")


def _sdr_input(kind: str, c: int = 8, tpb: int = 4, frames: int = 64):
    g = torch.Generator().manual_seed(5)
    dtype = torch.complex64 if kind == "complex" else torch.float32
    return torch.randn(c * frames, generator=g, dtype=dtype), sdr_pipe.design_prototype(c, tpb)


def _chain(x, proto, c: int = 8):
    return sdr_pipe.sdr_chain(x, proto, c, angle_width=20, iq_scale=2.0**12)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sdr_chain_enters_no_record_function_without_a_session(no_record_function, kind):
    x, proto = _sdr_input(kind)
    assert _chain(x, proto).shape == (64 - 4, 8)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sdr_spans_in_the_trace_and_the_table(tmp_path, kind):
    x, proto = _sdr_input(kind)
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _chain(x, proto)
    events = _annotations(prof, tmp_path)
    roots = [e for e in events if e["name"] == "bhw.sdr"]
    assert len(roots) == 3
    assert {e["name"] for e in events} == {"bhw.sdr"} | {f"bhw.sdr.{s}" for s in SDR_STAGES}
    assert all(_inside(e, roots) for e in events)
    spans = _trace.snapshot()["spans"]
    assert set(spans) == {"bhw.sdr"} | {f"bhw.sdr/bhw.sdr.{s}" for s in SDR_STAGES}
    assert spans["bhw.sdr"]["count"] == 3
    for stage in SDR_STAGES:
        row = spans[f"bhw.sdr/bhw.sdr.{stage}"]
        assert row["count"] == 3 and set(row) == ROW_KEYS
        assert row["stream_n"] == 0  # no stream on the CPU
    for row in spans.values():
        assert 0 <= row["self_s"] <= row["host_s"]


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sdr_bits_are_the_same_traced(kind):
    x, proto = _sdr_input(kind)
    off = _chain(x, proto)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _chain(x, proto)
    assert torch.equal(on, off)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "two-stage"])
def test_sdr_chain_on_the_card_is_one_fm_demod_launch_a_call(tmp_path, route):
    """On a card: one launch of the channelizer a chain call inside its
    branches stage and one ``fm_demod`` inside its demod stage, and every
    stage timed on the stream.  At the SDR cell's 128 channels of 16 taps
    (``fused``) the launch is ``polyphase_dft``, with the DFT in it: no
    ``bhw.sdr.dft``; at 8 channels of the same prototype (``two-stage``)
    it is ``polyphase_fir``, and cuFFT runs in ``bhw.sdr.dft``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    x, proto = _sdr_input("complex", c=128, tpb=16, frames=4096)
    x = x.cuda()
    c, kernel, stages = ((128, "polyphase_dft", ("branches", "demod")) if route == "fused"
                         else (8, "polyphase_fir", SDR_STAGES))
    want = _chain(x, proto, c)
    _build.reset_launches()
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            got = _chain(x, proto, c)
        torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {kernel: 3, "fm_demod": 3}
    assert torch.equal(got, want)
    spans = _trace.snapshot()["spans"]
    assert spans[f"bhw.sdr/bhw.sdr.branches/bhw.launch.{kernel}"]["count"] == 3
    assert spans["bhw.sdr/bhw.sdr.demod/bhw.launch.fm_demod"]["count"] == 3
    assert ("bhw.sdr/bhw.sdr.dft" in spans) == ("dft" in stages)
    for s in stages:
        row = spans[f"bhw.sdr/bhw.sdr.{s}"]
        assert row["count"] == row["stream_n"] == 3 and row["stream_s"] > 0


# --- the PFB spectrometer: bhw.pfb and its stages ---

PFB_STAGES = ("branches", "dft", "power")


def _pfb_input(c: int = 16, tpb: int = 4, feeds: int = 3, n_acc: int = 8, n_int: int = 2):
    g = torch.Generator().manual_seed(6)
    x = (torch.randn((feeds, (n_acc * n_int + tpb - 1) * c), generator=g) * 10).round()
    return x.clamp(-127, 127).to(torch.int8), channelizer.design_prototype(c, tpb)


def _pfb(x, proto, c: int = 16, n_acc: int = 8):
    return spectrometer.pfb_power(x, proto, c, n_acc)


def test_pfb_enters_no_record_function_without_a_session(no_record_function):
    x, proto = _pfb_input()
    assert _pfb(x, proto).shape == (3, 2, 9)


def test_pfb_spans_in_the_trace_and_the_table(tmp_path):
    """The root ``bhw.pfb`` with the filter bank's ``.branches`` and ``.dft``
    and the integration's ``.power``; the plain power mean keeps ``.mean``
    apart, as the Welch analyzer's does on the CPU."""
    x, proto = _pfb_input()
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            _pfb(x, proto)
    events = _annotations(prof, tmp_path)
    roots = [e for e in events if e["name"] == "bhw.pfb"]
    assert len(roots) == 3
    stages = PFB_STAGES + ("mean",)
    assert {e["name"] for e in events} == {"bhw.pfb"} | {f"bhw.pfb.{s}" for s in stages}
    assert all(_inside(e, roots) for e in events)
    spans = _trace.snapshot()["spans"]
    assert set(spans) == {"bhw.pfb"} | {f"bhw.pfb/bhw.pfb.{s}" for s in stages}
    assert spans["bhw.pfb"]["count"] == 3
    for stage in stages:
        row = spans[f"bhw.pfb/bhw.pfb.{stage}"]
        assert row["count"] == 3 and set(row) == ROW_KEYS and row["stream_n"] == 0


def test_pfb_bits_are_the_same_traced():
    x, proto = _pfb_input()
    off = _pfb(x, proto)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _pfb(x, proto)
    assert torch.equal(on, off)


def test_the_chains_keep_the_span_paths_their_metrics_read():
    """The SDR chain's and the Welch analyzer's stage paths, which
    ``sdr_channelize_ms_per_call`` and ``welch_passes_ms_per_call`` read,
    are theirs alone after a spectrometer call, and its are its own."""
    x, proto = _pfb_input()
    xs, sproto = _sdr_input("real")
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _pfb(x, proto)
        _chain(xs, sproto)
        _welch("quantized", "rfft")
    paths = set(_trace.snapshot()["spans"])
    assert {"bhw.sdr/bhw.sdr.branches", "bhw.sdr/bhw.sdr.dft"} <= paths
    assert {f"bhw.welch/bhw.welch.{s}" for s in ("apply", "fft", "power", "mean")} <= paths
    assert {f"bhw.pfb/bhw.pfb.{s}" for s in PFB_STAGES} <= paths
    # every stage lies under its own chain's root, named after it
    stages = [p.split("/") for p in paths if p.count("/") == 1]
    assert stages and all(stage.startswith(root + ".") for root, stage in stages)


@pytest.mark.gpu
def test_pfb_on_the_card_is_one_branch_and_one_power_launch_a_call():
    """On a card: one ``polyphase_fir`` launch a call inside
    ``bhw.pfb.branches`` (the int8 widening there too), cuFFT in
    ``bhw.pfb.dft`` and one ``welch_power_mean`` inside ``bhw.pfb.power``,
    every stage timed on the stream, and no ``.mean``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    x, proto = _pfb_input(c=2048, feeds=16, n_acc=64)
    x = x.cuda()
    want = _pfb(x, proto, 2048, 64)
    _build.reset_launches()
    _trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            got = _pfb(x, proto, 2048, 64)
        torch.cuda.synchronize()
    assert {k: v for k, v in _build.launches.items() if v} == {"polyphase_fir": 3,
                                                               "welch_power_mean": 3}
    assert torch.equal(got, want)
    spans = _trace.snapshot()["spans"]
    assert spans["bhw.pfb/bhw.pfb.branches/bhw.launch.polyphase_fir"]["count"] == 3
    assert spans["bhw.pfb/bhw.pfb.power/bhw.launch.welch_power_mean"]["count"] == 3
    assert "bhw.pfb/bhw.pfb.mean" not in spans
    for s in PFB_STAGES:
        row = spans[f"bhw.pfb/bhw.pfb.{s}"]
        assert row["count"] == row["stream_n"] == 3 and row["stream_s"] > 0
