"""PyTorch port, ``_trace``: the spans of the window router, the window
wrapper, the launch helper and the Welch analyzer's stages.

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
from blackman_harris_win_tpu_torch.pipeline import spectral
from blackman_harris_win_tpu_torch.utils import profiling
from blackman_harris_win_tpu_torch.windows import catalog

WIN_MODES = ("quantized", "float", "comp")
FFT_MODES = ("rfft", "packed", "mxu")
STAGES = ("window", "apply", "fft", "power", "mean")
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
    assert _trace.span("bhw.a") is _trace.span("bhw.b", torch.device("cpu"), 1 << 20)


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
        assert row["count"] == 3 and row["nbytes"] > 0
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
            with _trace.span("bhw.b", nbytes=10):
                time.sleep(0.02)
            with _trace.span("bhw.b", nbytes=5):
                pass
        with _trace.span("bhw.b"):
            pass
    spans = _trace.snapshot()["spans"]
    assert set(spans) == {"bhw.a", "bhw.a/bhw.b", "bhw.b"}
    a, ab = spans["bhw.a"], spans["bhw.a/bhw.b"]
    assert ab["count"] == 2 and ab["nbytes"] == 15 and ab["host_s"] >= 0.02
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
