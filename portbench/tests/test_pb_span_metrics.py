"""The ``program_span`` metrics: each reader on a synthetic span table,
nothing read without a trace or a span, and in a tiny CPU ``--trace 1`` run
the program's root spans counted once a call of the traced window."""

import pytest

from portbench import harness, layout, spans
from portbench.tests import tiny

METRICS = ("program_host_us_per_call", "welch_fft_ms_per_call", "welch_passes_ms_per_call")
TRACE = {"window_s": 2.0, "busy_s": 1.5, "device_ops": 12, "device_ops_top": [],
         "idle_top": []}


def _row(count, host_s, stream_s=0.0, stream_n=0):
    return {"count": count, "host_s": host_s, "self_s": host_s / 2, "stream_s": stream_s,
            "stream_n": stream_n, "nbytes": 0}


#: four analyzer calls, one of them outside the window's root (a sharded
#: step's stage), which adds stream time but no call
WELCH = {
    "bhw.welch": _row(4, 4 * 800e-6),
    "bhw.welch/bhw.welch.window": _row(4, 4 * 100e-6, 4 * 0.05e-3, 4),
    "bhw.welch/bhw.welch.window/bhw.window_block": _row(4, 4 * 60e-6),
    "bhw.welch/bhw.welch.apply": _row(4, 4 * 50e-6, 4 * 0.8e-3, 4),
    "bhw.welch/bhw.welch.fft": _row(4, 4 * 70e-6, 4 * 2.9e-3, 4),
    "bhw.welch/bhw.welch.power": _row(4, 4 * 40e-6, 4 * 1.2e-3, 4),
    "bhw.welch/bhw.welch.mean": _row(4, 4 * 20e-6, 4 * 0.3e-3, 4),
    "bhw.welch.fft": _row(1, 70e-6, 2.9e-3, 1),
}
GEN = {"bhw.window_block": _row(3, 3 * 90e-6),
       "bhw.window_block/bhw.params": _row(3, 3 * 40e-6),
       "bhw.window_block/bhw.launch.window_block": _row(3, 3 * 20e-6)}


def _read(name, s):
    return layout.load_module(layout.ROOT, "metrics", name).read(s)


@pytest.fixture
def table(monkeypatch):
    def use(t):
        monkeypatch.setattr(spans, "table", lambda: t)
    return use


def test_welch_readers(table):
    table(WELCH)
    s = {"calls": 4, "trace": TRACE}
    assert _read("program_host_us_per_call", s) == pytest.approx(800.0)
    assert _read("welch_fft_ms_per_call", s) == pytest.approx(2.9 * 5 / 4)
    assert _read("welch_passes_ms_per_call", s) == pytest.approx(0.05 + 0.8 + 1.2 + 0.3)


def test_gen_readers(table):
    table(GEN)
    s = {"calls": 3, "trace": TRACE}
    assert _read("program_host_us_per_call", s) == pytest.approx(90.0)
    assert _read("welch_fft_ms_per_call", s) is None
    assert _read("welch_passes_ms_per_call", s) is None


def test_no_stream_time_reads_nothing(table):
    table({k: dict(v, stream_s=0.0, stream_n=0) for k, v in WELCH.items()})
    s = {"calls": 4, "trace": TRACE}
    assert _read("welch_fft_ms_per_call", s) is None
    assert _read("welch_passes_ms_per_call", s) is None
    assert _read("program_host_us_per_call", s) == pytest.approx(800.0)


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("t", [None, {}, {"bhw.other": _row(2, 1e-3, 1e-3, 2)}],
                         ids=["no program table", "empty", "no root"])
def test_nothing_to_read(table, name, t):
    table(t)
    assert _read(name, {"calls": 2, "trace": TRACE}) is None


@pytest.mark.parametrize("name", METRICS)
def test_no_trace_reads_nothing(table, name):
    table(WELCH)
    assert _read(name, {"calls": 4, "trace": None}) is None


def test_the_program_table_is_read():
    from blackman_harris_win_tpu_torch import _trace

    _trace.reset()
    assert spans.table() == {}


@pytest.mark.parametrize("cell, root", [(tiny.GEN, "bhw.window_block"),
                                        (tiny.WELCH, "bhw.welch")])
def test_roots_count_the_traced_calls(tmp_path, monkeypatch, cell, root):
    from blackman_harris_win_tpu_torch import _trace

    traced = []
    measure = harness.measure

    def watched(entry, seconds, sync, kept_calls, trace, cuda):
        rec, kept = measure(entry, seconds, sync, kept_calls, trace, cuda)
        if trace:
            traced.append(rec["calls"])
        return rec, kept

    monkeypatch.setattr(harness, "measure", watched)
    _trace.reset()
    code, out = tiny.run(tiny.make_root(tmp_path), cell, trace=1)
    assert code == 0 and out["correct"]
    assert spans.table()[root]["count"] == traced[0] > 0
    assert out["metrics"]["program_host_us_per_call"]["value"] > 0
    # the CPU has no stream
    assert "welch_fft_ms_per_call" not in out["metrics"]
    assert "welch_passes_ms_per_call" not in out["metrics"]
