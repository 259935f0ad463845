"""The PFB spectrometer cell at a size a CPU test holds: its traffic, a
sound run correct, the TF32 control and a few faults not, the three readers
on a span table and reading nothing without their spans, and the work
model at the cell's shape.  Where a card is seen, the entry's captures and
the program at the cell's own size (marked ``gpu``)."""

import json
import math

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu_torch.pipeline import channelizer, spectrometer
from portbench import harness, layout, roofline, roofline_pfb, spans
from portbench.tests import tiny

PFB = "pfb_spec_c2048.board16"
SEED = 2**31 + 13
READERS = ("pfb_channelize_ms_per_call", "pfb_power_ms_per_call", "pfb_roofline_pct")
#: the cell cut to 64 channels and 8 spectra an integration, 3 feeds of 4
#: integrations (the taps, window and traffic levels kept)
CUTS = {"channels": 64, "n_acc": 8}
BOARD_CUTS = {"feeds": 3, "samples": (8 * 4 + 3) * 64}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("pfb"))
    tiny.edit(root / "portbench/configs/pfb_spec_c2048.json", {}, deployment=CUTS)
    tiny.edit(root / "portbench/traffic/board16.json", {}, board=BOARD_CUTS)
    return root


def _run(root, **kwargs):
    return tiny.run(root, PFB, seed=SEED, **kwargs)


def _entry(root):
    return layout.load_module(root, "entries", "pfb")


def _board(root):
    return json.loads((root / "portbench/traffic/board16.json").read_text())["board"]


# --- the traffic ---

def test_captures_come_from_the_seed(root):
    board, entry = _board(root), _entry(root)
    a, lines = entry.board_captures(board, 64, SEED, "cpu")
    b, _ = entry.board_captures(board, 64, SEED, "cpu")
    c, _ = entry.board_captures(board, 64, SEED + 1, "cpu")
    assert len(a) == board["count"] == 2
    assert all(x.dtype == torch.int8 and x.shape == (3, BOARD_CUTS["samples"]) for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    for x, p in zip(a, lines):
        assert int(x.abs().max()) <= board["full_scale"]
        # 12 carriers and the faint line on distinct bins, none at DC or Nyquist
        assert len(set(p["bins"])) == board["rfi_carriers"] + 1
        assert p["bins"].min() >= 1 and p["bins"].max() <= 64 // 2 - 1
        assert np.all(np.abs(p["freq"] * 64 - p["bins"]) <= board["rfi_bin_offset"])


def test_levels_against_the_noise_power(root):
    board, entry = _board(root), _entry(root)
    p = entry._line_params(board, 64, np.random.default_rng(1))
    db = 10 * np.log10(p["amp"] ** 2 / 2 / board["noise_rms_lsb"] ** 2)
    lo, hi = board["rfi_db"]
    assert np.all((db[:, :-1] >= lo - 1e-9) & (db[:, :-1] <= hi + 1e-9))
    np.testing.assert_allclose(db[:, -1], board["line_db"])
    assert p["amp"].shape == p["phase"].shape == (board["feeds"], board["rfi_carriers"] + 1)


def test_the_carriers_are_the_strongest_bins(root):
    """Each feed's strongest bins in the float64 reference's power are the
    carriers' own (or a neighbour, a carrier lying up to a quarter bin off
    its bin's centre)."""
    board, entry = _board(root), _entry(root)
    caps, lines = entry.board_captures(dict(board, samples=(64 * 2 + 3) * 64), 64, SEED, "cpu")
    proto = channelizer.design_prototype(64, 4)
    p = entry.ref.pfb_power(caps[0], proto, 64, 64)[:, 0]  # (feeds, bins)
    strong = lines[0]["amp"][:, :-1]
    for f in range(board["feeds"]):
        top = lines[0]["bins"][:-1][np.argsort(-strong[f])[:3]]
        loudest = set(torch.topk(p[f], 9).indices.tolist())
        assert all({b - 1, b, b + 1} & loudest for b in top)


# --- runs of the cell ---

@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(root, trace):
    code, out = _run(root, trace=trace)
    assert code == 0 and out["correct"] and out["failed"] == 0
    for k in ("power_rel_p99", "power_rel_max"):
        c = out["checks"][k]
        assert 0 < c["value"] < c["limit"] / 10
    if not trace:
        assert set(out["metrics"]) == {"msamples_per_s", "call_ms_p95", "peak_mem_gib",
                                       "setup_s"}


def test_control_is_not_correct(root):
    code, out = _run(root, control=True)
    assert code == 0 and not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _feeds_swapped(out):
    return out[[1, 0, 2]]


def _one_spectrum_late(out):
    """Each integration's power a thousandth off, as one of n_acc spectra
    of a later integration would move it at the cell's 1024."""
    return out * (1 + 1e-3)


def _nyquist_dropped(out):
    return out[..., :-1]


def _one_bin_over(out):
    out = out.clone()
    out[0, 0, 7] *= 1.01
    return out


@pytest.mark.parametrize("fault", [_feeds_swapped, _one_spectrum_late, _nyquist_dropped,
                                   _one_bin_over])
def test_fault_is_not_correct(root, monkeypatch, fault):
    power = spectrometer.pfb_power
    monkeypatch.setattr(spectrometer, "pfb_power", lambda *a, **k: fault(power(*a, **k)))
    code, out = _run(root)
    assert code == 0 and not out["correct"]
    c = out["checks"]["power_rel_max"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("width", [12, 18])
def test_a_coarser_prototype_is_not_correct(root, monkeypatch, width):
    """The program's window quantized at fewer bits than the configuration's
    24: the reference builds its own taps, so the comparison sees it."""
    design = channelizer.design_prototype
    monkeypatch.setattr(channelizer, "design_prototype",
                        lambda c, taps, **k: design(c, taps, window=k["window"], data_width=width))
    code, out = _run(root)
    assert code == 0 and not out["correct"]


# --- the readers ---

def _summary(trace=True, calls=4):
    work = roofline_pfb.pfb_work(16, 16783360, 2048, 4, 1024)
    work = dict(work, bytes=work["bytes"] * calls, ops=work["ops"] * calls)
    t = {"window_s": 2.0, "busy_s": 0.016, "device_ops": 40, "device_ops_top": [],
         "idle_top": []}
    return {"calls": calls, "work": work, "trace": t if trace else None}


def _row(count, stream_s=0.0, stream_n=0):
    return {"count": count, "host_s": 1e-3 * count, "self_s": 1e-4, "stream_s": stream_s,
            "stream_n": stream_n}


TABLE = {"bhw.pfb": _row(4),
         "bhw.pfb/bhw.pfb.branches": _row(4, 4 * 1.2e-3, 4),
         "bhw.pfb/bhw.pfb.branches/bhw.launch.polyphase_fir": _row(4),
         "bhw.pfb/bhw.pfb.dft": _row(4, 4 * 0.9e-3, 4),
         "bhw.pfb/bhw.pfb.power": _row(4, 4 * 0.4e-3, 4),
         "bhw.pfb/bhw.pfb.power/bhw.launch.welch_power_mean": _row(4)}


def _read(name, s):
    return layout.load_module(layout.ROOT, "metrics", name).read(s)


def test_readers_on_a_span_table(monkeypatch):
    monkeypatch.setattr(spans, "table", lambda: TABLE)
    s = _summary()
    assert _read("pfb_channelize_ms_per_call", s) == pytest.approx(2.1)
    assert _read("pfb_power_ms_per_call", s) == pytest.approx(0.4)
    bound = roofline_pfb.chain_bound(s["work"])
    assert _read("pfb_roofline_pct", s) == pytest.approx(100 * bound / 0.016)


@pytest.mark.parametrize("name", READERS[:2])
@pytest.mark.parametrize("t", [None, {}, {"bhw.sdr": _row(2), "bhw.sdr/bhw.sdr.branches":
                                          _row(2, 1e-3, 2), "bhw.sdr/bhw.sdr.dft":
                                          _row(2, 1e-3, 2)},
                               {"bhw.welch": _row(2), "bhw.welch/bhw.welch.power":
                                _row(2, 1e-3, 2)}],
                         ids=["no program table", "empty", "the SDR chain's spans",
                              "the Welch analyzer's spans"])
def test_span_readers_read_nothing_without_the_spectrometer(monkeypatch, name, t):
    """A program without the spectrometer's spans, as the parent commit is."""
    monkeypatch.setattr(spans, "table", lambda: t)
    assert _read(name, _summary()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_a_trace(monkeypatch, name):
    monkeypatch.setattr(spans, "table", lambda: TABLE)
    assert _read(name, _summary(trace=False)) is None


def test_roofline_reads_nothing_on_another_work_model(monkeypatch):
    s = dict(_summary(), work=roofline.welch_work(8 << 20, 1 << 20, 1 << 19))
    assert _read("pfb_roofline_pct", s) is None


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
    assert table["bhw.pfb"]["count"] == traced[0] > 0
    for stage in ("branches", "dft", "power"):
        assert table[f"bhw.pfb/bhw.pfb.{stage}"]["count"] == traced[0]
    # the CPU has no stream and no device busy time
    assert not set(READERS) & set(out["metrics"])


def test_work_model_at_the_cell():
    w = roofline_pfb.pfb_work(16, (8 * 1024 + 3) * 2048, 2048, 4, 1024)
    frames = 8 * 1024
    assert w["bytes"] == 16 * (8195 * 2048 + 4 * 8 * 1025)
    assert w["ops"] == 16 * frames * (8 * 2048 + 2.5 * 2048 * 11 + 4 * 1025)
    t_bytes, t_ops = w["bytes"] / roofline.HBM_BPS, w["ops"] / roofline.F32_FLOPS
    assert round(t_ops * 1e3, 3) == 0.150 and round(t_bytes * 1e3, 3) == 0.080
    assert roofline_pfb.chain_bound(w) == pytest.approx(t_ops)


def test_the_cell_s_files():
    b = layout.bench()
    cell = layout.load_cell(PFB)
    d = cell.config["deployment"]
    assert (d["channels"], d["taps_per_branch"], d["n_acc"], d["input"]) == (2048, 4, 1024, "int8")
    board = cell.traffic["board"]
    assert board["samples"] == (8 * 1024 + 3) * 2048 and board["feeds"] == 16
    assert spectrometer.integrations(board["samples"], 2048, 4, 1024) == 8
    assert board["sample_rate_hz"] / 2048 == 390625.0
    names = {m["name"] for m in cell.metrics}
    assert set(READERS) <= names and "msamples_per_s" in names
    assert [c["name"] for c in b["configs"]][-1] == "pfb_spec_c2048"
    assert [w["name"] for w in b["workloads"]][-1] == PFB
    assert math.isclose(board["samples"] * board["feeds"] / 2**20, 256.0, rel_tol=1e-3)


# --- on the card ---

@pytest.mark.gpu
def test_the_cell_s_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    dev = torch.device("cuda", 0)
    cell = layout.load_cell(PFB)
    entry = _entry(layout.ROOT).Entry(cell.config, cell.traffic, SEED, dev)
    out = entry.call(0)
    torch.cuda.synchronize()
    assert out.shape == (16, 8, 1025) and out.dtype == torch.float32
    checks = entry.judge([entry.keep(0, out)])
    assert all(v <= lim for v, lim in checks.values()), checks
    ctl = entry.judge(entry.control([entry.keep(0, out)]))
    assert any(v > lim for v, lim in ctl.values()), ctl
