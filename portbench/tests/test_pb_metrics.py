"""Each metric reader on a small synthetic run summary, and the trace
reduction on a synthetic Chrome trace."""

import pytest

from portbench import layout, roofline, tracing

ROOT = layout.ROOT


def _read(name, s):
    return layout.load_module(ROOT, "metrics", name).read(s)


def _summary(trace=None, model="cordic_window"):
    work = (roofline.cordic_window_work(4 << 20, 7, 32) if model == "cordic_window"
            else roofline.welch_work(8 << 20, 1 << 20, 1 << 19))
    work = dict(work, bytes=work["bytes"] * 4, ops=work["ops"] * 4)
    return {"calls": 4, "samples": 16 << 20, "window_s": 2.0, "setup_s": 7.5,
            "call_s": [0.010, 0.011, 0.012, 0.013] * 5, "host_s": [40e-6, 50e-6, 60e-6, 70e-6],
            "window_peak_bytes": 3 << 29, "work": work, "trace": trace}


TRACE = {"window_s": 2.0, "busy_s": 1.5, "device_ops": 12, "device_ops_top": [],
         "idle_top": []}


def test_end_to_end_readers():
    s = _summary()
    assert _read("msamples_per_s", s) == pytest.approx((16 << 20) / 2.0 / 1e6)
    assert _read("call_ms_p95", s) == pytest.approx(13.0)
    assert _read("peak_mem_gib", s) == pytest.approx(1.5)
    assert _read("setup_s", s) == 7.5


@pytest.mark.parametrize("name", ["gen_roofline_pct", "welch_roofline_pct", "device_idle_pct",
                                  "device_ops_per_call", "host_us_per_call"])
def test_per_layer_readers_read_nothing_without_a_trace(name):
    assert _read(name, _summary()) is None


def test_per_layer_readers():
    s = _summary(TRACE)
    assert _read("device_idle_pct", s) == pytest.approx(25.0)
    assert _read("device_ops_per_call", s) == 3.0
    assert _read("host_us_per_call", s) == pytest.approx(55.0)
    least = 4 * (4 << 20) * roofline.cordic_ops(7, 32) / roofline.INT32_OPS
    assert _read("gen_roofline_pct", s) == pytest.approx(100 * least / 1.5)
    assert _read("welch_roofline_pct", s) is None  # another work model
    w = _summary(TRACE, "welch")
    assert _read("gen_roofline_pct", w) is None
    least = roofline.bound(w["work"]["bytes"], w["work"]["ops"], roofline.F32_FLOPS)[0]
    assert _read("welch_roofline_pct", w) == pytest.approx(100 * least / 1.5)


def test_no_device_operation_reads_nothing():
    s = _summary(dict(TRACE, busy_s=0.0, device_ops=0))
    for name in ("device_idle_pct", "device_ops_per_call", "gen_roofline_pct"):
        assert _read(name, s) is None


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_summarize_a_synthetic_trace():
    events = [
        _ev(tracing.WINDOW, "user_annotation", 1000.0, 1000.0),
        _ev("warm-up kernel", "kernel", 500.0, 100.0, tid=7),  # before the window
        _ev(tracing.CALL, "user_annotation", 1000.0, 50.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 1010.0, 20.0),
        _ev("k1", "kernel", 1040.0, 400.0, tid=7),
        _ev("Memset", "gpu_memset", 1100.0, 100.0, tid=8),  # overlaps k1
        _ev(tracing.SYNC, "user_annotation", 1050.0, 450.0),
        _ev(tracing.CALL, "user_annotation", 1500.0, 100.0),
        _ev("aten::empty", "cpu_op", 1510.0, 80.0),
        _ev("k1", "kernel", 1600.0, 300.0, tid=7),
        _ev("k2", "kernel", 1950.0, 100.0, tid=7),  # runs past the window's end
    ]
    s = tracing.summarize(events)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["device_ops"] == 4
    assert s["busy_s"] == pytest.approx((400 + 300 + 50) * 1e-6)
    top = dict(s["device_ops_top"])
    assert top["k1"] == pytest.approx(700e-6) and top["k2"] == pytest.approx(50e-6)
    idle = dict(s["idle_top"])
    # gaps: 1000-1040 (in the launch), 1440-1600 (mid 1520: aten::empty), 1900-1950
    assert idle["cudaLaunchKernel"] == pytest.approx(40e-6)
    assert idle["aten::empty"] == pytest.approx(160e-6)
    assert idle[tracing.WINDOW] == pytest.approx(50e-6)


def test_summarize_needs_the_window_span():
    with pytest.raises(RuntimeError):
        tracing.summarize([_ev("k", "kernel", 0.0, 1.0)])


def test_block_schedule():
    from portbench import traffic

    seeded = traffic.block_schedule({"block": 256}, 5, 1 << 12)
    again = traffic.block_schedule({"block": 256}, 5, 1 << 12)
    offsets = [seeded(i)[0] for i in range(64)]
    assert len(set(offsets)) > 32 and all(0 <= o < 1 << 12 for o in offsets)
    assert all(a != b for a, b in zip(offsets, offsets[1:]))
    assert {seeded(i)[1] for i in range(64)} == {256}
    assert [seeded(i) for i in range(8)] == [again(i) for i in range(8)]
    other = traffic.block_schedule({"block": 256}, 6, 1 << 12)
    assert [seeded(i) for i in range(8)] != [other(i) for i in range(8)]


def test_compared_calls_come_from_the_seed():
    from portbench import traffic

    a = traffic.compared_calls({"compare": 4}, 2**31 + 9, 100)
    assert a == traffic.compared_calls({"compare": 4}, 2**31 + 9, 100)
    assert len(a) == 4 and all(0 <= i < 100 for i in a)
    assert traffic.compared_calls({"compare": 3}, 1, 0) <= {0, 1, 2}


def test_captures_come_from_the_seed():
    import torch

    from portbench import traffic

    p = {"captures": {"count": 2, "samples": 5000, "tones_db": [0, -30], "noise_db": -60,
                      "band": [0.01, 0.49]}}
    a = traffic.captures(p, 2**31 + 3, "cpu")
    b = traffic.captures(p, 2**31 + 3, "cpu")
    c = traffic.captures(p, 2**31 + 4, "cpu")
    assert len(a) == 2 and all(x.shape == (5000,) and x.dtype == torch.float32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert 0.5 < float(a[0].abs().max()) < 1.5  # the 0 dB tone
