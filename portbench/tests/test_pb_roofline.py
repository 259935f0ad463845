"""The frozen work models at the cells' shapes, and the copy of the
program's arithmetic they came from."""

import pytest

from portbench import roofline


def test_gen_bound_at_the_cell():
    w = roofline.cordic_window_work(1 << 26, 7, 32)
    assert roofline.cordic_ops(7, 32) == 1192
    t, kind = roofline.bound(w["bytes"], w["ops"], w["rate"])
    assert kind == "operations" and round(t * 1e3, 3) == 2.388


def test_welch_bound_at_the_cell():
    w = roofline.welch_work(128 << 20, 1 << 20, 1 << 19)
    t, kind = roofline.bound(w["bytes"], w["ops"], w["rate"])
    assert kind == "operations" and round(t * 1e3, 3) == 0.212
    assert w["bytes"] == 4 * ((128 << 20) + (1 << 20) + (1 << 19) + 1)


def test_rtl_counts_one_iteration_less():
    hls = roofline.cordic_window_work(10, 4, 17, "hls")["ops"]
    rtl = roofline.cordic_window_work(10, 4, 17, "rtl")["ops"]
    assert hls - rtl == 10 * 3 * 6


@pytest.mark.parametrize("n_terms,iters", [(4, 17), (7, 32), (2, 8)])
def test_the_copy_agrees_with_the_program(n_terms, iters):
    from blackman_harris_win_tpu_torch.utils import profiling

    assert roofline.cordic_ops(n_terms, iters) == profiling.cordic_ops(n_terms, iters)
    assert (roofline.HBM_BPS, roofline.F32_FLOPS, roofline.INT32_OPS) == (
        profiling.HBM_BPS, profiling.F32_FLOPS, profiling.INT32_OPS)
    b, ops = 4e9, 1e12
    assert roofline.bound(b, ops)[0] * 1e3 == pytest.approx(profiling.bound(b, ops)[0])
