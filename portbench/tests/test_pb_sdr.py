"""The SDR cell at a size a CPU test holds: a sound run is correct, the
control and a chain with two stations' channels swapped are not, the three
readers read nothing without their spans, and the work model at the
cell's shape."""

import json

import numpy as np
import pytest

from blackman_harris_win_tpu_torch.pipeline import sdr
from portbench import harness, layout, roofline_sdr, spans, traffic as gen_traffic
from portbench.tests import tiny

SDR = "sdr_fmband_c128.fm60"
SEED = 2**31 + 11
READERS = ("sdr_channelize_ms_per_call", "sdr_demod_roofline_pct", "sdr_roofline_pct")
#: the cell cut to 16 channels of 4 taps and 2^14 samples a capture, its
#: raster and channel width kept (so 3.2 Msps and 12 slots)
CUTS = {"channels": 16, "taps_per_branch": 4}
FM_CUTS = {"samples": 1 << 14, "sample_rate_hz": 3200000, "slots": [-6, 5], "stations": 6}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("sdr"))
    tiny.edit(root / "portbench/configs/sdr_fmband_c128.json", {},
              deployment=CUTS)
    tiny.edit(root / "portbench/traffic/fm60.json", {}, fm=FM_CUTS)
    return root


def _run(root, **kwargs):
    return tiny.run(root, SDR, seed=SEED, **kwargs)


def _strongest_channels(root, count=2):
    """The channels of the first capture's ``count`` strongest stations."""
    fm = json.loads((root / "portbench/traffic/fm60.json").read_text())["fm"]
    entry = layout.load_module(root, "entries", "sdr")
    p = entry._station_params(fm, gen_traffic.rng(SEED, 11))
    return [int(s) % CUTS["channels"] for s in p["slots"][np.argsort(-p["amp"])[:count]]]


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, trace):
    code, out = _run(root, trace=trace)
    assert code == 0 and out["correct"] and out["failed"] == 0
    assert out["checks"]["angle_over_budget"]["value"] == 0
    if not trace:
        assert set(out["metrics"]) == {"msamples_per_s", "call_ms_p95", "peak_mem_gib",
                                       "setup_s"}


def test_control_is_not_correct(root):
    code, out = _run(root, control=True)
    assert code == 0 and not out["correct"]
    c = out["checks"]["angle_over_budget"]
    assert c["value"] > c["limit"], out["checks"]


def test_swapped_channels_are_not_correct(root, monkeypatch):
    a, b = _strongest_channels(root)
    chain = sdr.sdr_chain

    def swapped(*args, **kwargs):
        out = chain(*args, **kwargs).clone()
        out[:, [a, b]] = out[:, [b, a]]
        return out

    monkeypatch.setattr(sdr, "sdr_chain", swapped)
    code, out = _run(root)
    assert code == 0 and not out["correct"]
    c = out["checks"]["angle_over_budget"]
    assert c["value"] > c["limit"]


def test_one_frame_late_is_not_correct(root, monkeypatch):
    """Every channel's output one frame late: the stations' frequencies
    stay, the samples do not."""
    chain = sdr.sdr_chain

    def late(*args, **kwargs):
        out = chain(*args, **kwargs)
        return out.roll(1, dims=0)

    monkeypatch.setattr(sdr, "sdr_chain", late)
    code, out = _run(root)
    assert code == 0 and out["checks"]["angle_over_budget"]["value"] > 0


def _summary(trace=True, calls=4):
    work = roofline_sdr.sdr_work(1 << 26, 128, 16, 20)
    work = dict(work, bytes=work["bytes"] * calls, ops=work["ops"] * calls)
    t = {"window_s": 2.0, "busy_s": 0.04, "device_ops": 40, "device_ops_top": [],
         "idle_top": []}
    return {"calls": calls, "work": work, "trace": t if trace else None}


def _row(count, stream_s=0.0, stream_n=0):
    return {"count": count, "host_s": 1e-3 * count, "self_s": 1e-4, "stream_s": stream_s,
            "stream_n": stream_n, "nbytes": 1}


TABLE = {"bhw.sdr": _row(4),
         "bhw.sdr/bhw.sdr.branches": _row(4, 4 * 3e-3, 4),
         "bhw.sdr/bhw.sdr.dft": _row(4, 4 * 1e-3, 4),
         "bhw.sdr/bhw.sdr.demod": _row(4, 4 * 0.8e-3, 4),
         "bhw.sdr/bhw.sdr.demod/bhw.launch.fm_demod": _row(4)}


def _read(name, s):
    return layout.load_module(layout.ROOT, "metrics", name).read(s)


def test_readers_on_a_span_table(monkeypatch):
    monkeypatch.setattr(spans, "table", lambda: TABLE)
    s = _summary()
    assert _read("sdr_channelize_ms_per_call", s) == pytest.approx(4.0)
    demod = roofline_sdr.demod_bound(s["work"])
    assert _read("sdr_demod_roofline_pct", s) == pytest.approx(100 * demod / 0.8e-3)
    chain = roofline_sdr.chain_bound(s["work"], 4)
    assert _read("sdr_roofline_pct", s) == pytest.approx(100 * chain / 0.04)


@pytest.mark.parametrize("name", READERS[:2])
@pytest.mark.parametrize("t", [None, {}, {"bhw.welch": _row(2), "bhw.welch/bhw.welch.fft":
                                          _row(2, 1e-3, 2)}],
                         ids=["no program table", "empty", "another program's spans"])
def test_span_readers_read_nothing_without_the_chain(monkeypatch, name, t):
    """A program without the chain's spans, as the parent commit is."""
    monkeypatch.setattr(spans, "table", lambda: t)
    assert _read(name, _summary()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_trace(monkeypatch, name):
    monkeypatch.setattr(spans, "table", lambda: TABLE)
    assert _read(name, _summary(trace=False)) is None


@pytest.mark.parametrize("name", READERS[1:])
def test_rooflines_read_nothing_on_another_work_model(monkeypatch, name):
    from portbench import roofline

    monkeypatch.setattr(spans, "table", lambda: TABLE)
    s = dict(_summary(), work=roofline.welch_work(8 << 20, 1 << 20, 1 << 19))
    assert _read(name, s) is None


def test_roots_count_the_traced_calls(root, monkeypatch):
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
    code, out = _run(root, trace=1)
    assert code == 0 and out["correct"]
    table = spans.table()
    assert table["bhw.sdr"]["count"] == traced[0] > 0
    for stage in ("branches", "dft", "demod"):
        assert table[f"bhw.sdr/bhw.sdr.{stage}"]["count"] == traced[0]
    # the CPU has no stream and no device busy time
    assert not set(READERS) & set(out["metrics"])


def test_work_model_at_the_cell():
    from blackman_harris_win_tpu_torch.utils import profiling

    assert roofline_sdr.fm_demod_conj_ops(20) == profiling.fm_demod_conj_ops(20) == 143
    w = roofline_sdr.sdr_work(1 << 26, 128, 16, 20)
    frames = (1 << 20 >> 1) - 15
    assert w["demod_bytes"] == 8 * frames * 128 + 8 * (frames - 1) * 128
    assert round(roofline_sdr.demod_bound(w) * 1e3, 2) == 0.32
    assert w["flops"] == 64 * (1 << 26) + 35 * frames * 128
    chain = roofline_sdr.chain_bound(w, 1)
    assert chain == pytest.approx(w["bytes"] / roofline_sdr.roofline.HBM_BPS)
