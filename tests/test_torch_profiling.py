"""PyTorch port, ``utils/profiling.py``: the twin of
``tests/test_utils.py::TestRooflineAccounting`` against the H100 peaks
(shares at most 1, zero operations giving zero fields), the bounds
``chip_smoke.py`` prints at the main path's shapes equal to the ones
``PERF.md`` lists, the H100 operation models beside the JAX package's TPU
models, ``KernelReport`` and the ``torch.profiler`` trace."""

import json

import pytest
import torch

from blackman_harris_win_tpu.utils import profiling as jprof
from blackman_harris_win_tpu_torch.utils import profiling as prof

N = 1 << 26  # the main path: 2^26 samples, BH-7
#: name -> the bound in ms PERF.md lists for it, at its printed precision
PERF_BOUNDS = {
    "window_block": (2.388, 3), "window_checksum": (9.560, 3), "welch_stage1": (0.482, 3),
    "outer_checksum": (0.0781, 4), "outer_block": (0.0801, 4),
    "outer_checksum_f32": (0.0250, 4), "outer_checksum_comp": (0.0581, 4),
    "taylor_checksum": (0.0321, 4), "materialize": (0.3205, 4),
}


def _main_path_bounds():
    return prof.kernel_bounds(N, 7, 128 << 20, 1 << 20, 1 << 19, 2 * N * 4)


class TestRooflineAccounting:
    def test_ops_frac_is_fma_credited(self):
        peak = prof.INT32_OPS
        f = prof.roofline_fields(1.0, int_ops=int(1.4 * peak))
        assert f["ops_frac"] == round(1.4 / prof.FMA_OPS_PER_INSTR, 3) <= 1.0
        assert f["opmodel_nofma_x"] == 1.4
        # even a kernel at the all-FMA ceiling reads at most 1
        f2 = prof.roofline_fields(1.0, int_ops=int(prof.FMA_OPS_PER_INSTR * peak))
        assert f2["ops_frac"] <= 1.0

    def test_zero_ops_fields(self):
        f = prof.roofline_fields(1.0, bytes_moved=3_350_000_000)
        assert f["ops_frac"] == 0.0 and f["opmodel_nofma_x"] == 0.0
        assert 0.0009 < f["hbm_frac"] < 0.0011
        assert prof.roofline_fields(1.0) == {"ops_frac": 0.0, "opmodel_nofma_x": 0.0,
                                             "hbm_frac": 0.0}

    def test_kernel_report(self):
        r = prof.KernelReport("window_block", N, 8.889e-3, bytes_moved=4 * N,
                              int_ops=prof.cordic_window_int_ops(N, 7, 32))
        assert r.msamples_per_s == pytest.approx(N / 8.889e-3 / 1e6)
        assert 0 < r.hbm_fraction < 1 and 0 < r.ops_fraction <= 1
        line = json.loads(r.json_line())
        assert line["kernel"] == "window_block"
        assert line["ops_frac"] == round(r.ops_fraction, 3)
        # the share of the bound: the operations bound over the time
        b_ms, by = prof.bound(4 * N, r.int_ops)
        assert by == "operations"
        assert r.ops_fraction * prof.FMA_OPS_PER_INSTR == pytest.approx(b_ms / 8.889)


class TestBounds:
    @pytest.mark.parametrize("name", sorted(PERF_BOUNDS))
    def test_main_path_bounds_are_perf_md_s(self, name):
        value, digits = PERF_BOUNDS[name]
        assert round(_main_path_bounds()[name][0], digits) == value

    def test_every_kernel_has_a_bound(self):
        from blackman_harris_win_tpu_torch import _build

        bounds = _main_path_bounds()
        assert set(bounds) == set(_build.launches)
        assert all(by in ("bytes", "operations") and ms > 0 for ms, by in bounds.values())

    def test_bound_is_the_larger_time(self):
        assert prof.bound(prof.HBM_BPS / 1e3) == (1.0, "bytes")
        assert prof.bound(0, prof.INT32_OPS / 1e3) == (1.0, "operations")
        assert prof.bound(0, prof.F32_FLOPS / 500, prof.F32_FLOPS) == (2.0, "operations")

    def test_op_models(self):
        # the H100 models count what the function needs: per harmonic W
        # CORDIC iterations (W - 1 under RTL), 6 outer-product operations
        assert prof.cordic_window_int_ops(10, 7, 32) == 10 * prof.cordic_ops(7, 32)
        assert prof.cordic_window_int_ops(10, 7, 32, "rtl") == 10 * prof.cordic_ops(7, 31)
        assert prof.outer_window_int_ops(10, 7) == 10 * (6 * 6 + 2)

    def test_op_models_are_not_the_tpu_s(self):
        # JAX counts the int32-limb datapath of its TPU kernels
        assert prof.cordic_window_int_ops(N, 7, 32) < jprof.cordic_window_int_ops(N, 7, 32, True)
        assert prof.outer_window_int_ops(N, 7) < jprof.outer_window_int_ops(N, 7)


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(tmp_path / "t") as p:
        torch.ones(256).cumsum(0)
    assert p.key_averages()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
