"""PyTorch port, ``utils/profiling.py``: the bounds ``chip_smoke.py``
prints at the main path's shapes equal to the ones ``PERF.md`` lists, the
H100 operation models beside the JAX package's TPU models, and the
``torch.profiler`` trace (its span table: ``tests/test_torch_trace.py``)."""

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
    "taylor_checksum": (0.0321, 4), "materialize": (0.3205, 4), "ddc_mixer": (0.2404, 4),
    "fm_demod": (0.3205, 4), "fm_demod_half": (0.2865, 4), "cordic_atan2": (0.3205, 4),
    "fm_demod_phase": (0.3205, 4), "fm_demod_int_conj": (0.3205, 4),
    "taylor2_window_block": (0.1844, 4), "taylor_window_rtl": (0.0821, 4),
}


#: bench_all config 5's channelizer output: (frames, channels, AW)
SDR_SHAPE = ((1 << 22) - 7, 16, 20)
#: bench_all config 21's NCO period: fc = 1/8 at PW = 20
DDC_PERIOD = 8


def _main_path_bounds():
    return prof.kernel_bounds(N, 7, 128 << 20, 1 << 20, 1 << 19, 2 * N * 4, SDR_SHAPE,
                              DDC_PERIOD)


class TestBounds:
    @pytest.mark.parametrize("name", sorted(PERF_BOUNDS))
    def test_main_path_bounds_are_perf_md_s(self, name):
        value, digits = PERF_BOUNDS[name]
        assert round(_main_path_bounds()[name][0], digits) == value

    def test_every_kernel_has_a_bound(self):
        from blackman_harris_win_tpu_torch import _build

        bounds = _main_path_bounds()
        # fm_demod's other rows: its entry for a real stream's half spectrum,
        # and the integer discriminator's two modes on config 5's I/Q
        assert set(bounds) == set(_build.launches) | {"fm_demod_half", "fm_demod_phase",
                                                      "fm_demod_int_conj"}
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
        # the atan2: AW - 1 iterations of 6, as the CORDIC window's, 15
        # around them; the discriminator quantizes each sample once; the
        # taylor2 window: the cosine of each harmonic only, along runs that
        # share a ROM entry and a quadrant (what a run needs, once a run)
        assert prof.atan2_ops(20) == 19 * 6 + 15
        assert prof.fm_demod_conj_ops(20) == prof.atan2_ops(20) + 14
        assert prof.fm_demod_phase_ops(20) == (prof.atan2_ops(20), 4)
        assert prof.fm_demod_int_conj_ops(20) == prof.atan2_ops(20) + 10
        assert prof.taylor2_window_ops(7) == 6 * 15 + 2
        # the RTL Taylor window: a generator and 4 operations a term, the
        # tree's adds and 3 more
        assert prof.taylor_window_rtl_ops(3) == 2 * (prof.TAYLOR_OPS + 4) + 2 + 3
        assert prof.taylor_window_rtl_ops(2) == prof.TAYLOR_OPS + 4 + 1 + 3
        assert prof.taylor2_window_ops(7, p_lo=False) == 6 * 12 + 2
        # BH-7 at pw=26, LS=12 (rb = 12): harmonic k meets k 2^14 + 1 runs
        runs = sum(k * (1 << 14) + 1 for k in range(1, 7))
        assert prof.taylor2_window_work(N, 7, 12) == N * (6 * 15 + 2) + 12 * runs
        # the per-sample model it replaces counted 24 a harmonic: 0.2925 ms
        assert round(prof.bound(4 * N, N * (6 * 24 + 2))[0], 4) == 0.2925

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
