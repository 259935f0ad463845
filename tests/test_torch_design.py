"""PyTorch port, minimax window design: the spectrum model, the LP designs
(any term count, stop-band edge, nulls), the sampled windows and the
quantized hand-off equal to the JAX package's; designed coefficients
through the port's generation path 0 LSB against JAX and the golden model."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu.model import golden
from blackman_harris_win_tpu.windows import design as jd
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels.window import (
    rtl_cordic_coeffs,
    window_block,
    window_samples,
)
from blackman_harris_win_tpu_torch.utils.spectral import window_sidelobe_db
from blackman_harris_win_tpu_torch.windows import design as pd

pytest.importorskip("scipy.optimize")

DESIGNS = [
    (2, None, ()), (3, None, ()), (4, None, ()), (5, None, ()), (7, None, ()),
    (4, 3.2, ()), (4, 6.0, ()), (4, None, (9.5,)), (5, None, (12.0, 20.25)),
]


def _pair(k, stop, nulls):
    return (pd.design_min_sidelobe(k, stop_bin=stop, nulls=nulls),
            jd.design_min_sidelobe(k, stop_bin=stop, nulls=nulls))


@pytest.mark.parametrize("k,stop,nulls", DESIGNS)
def test_design_equal_to_jax(k, stop, nulls):
    got, want = _pair(k, stop, nulls)
    assert got.coeffs == want.coeffs
    assert got.sidelobe_db == want.sidelobe_db and got.stop_bin == want.stop_bin
    assert got.n_terms == want.n_terms == k
    assert got.suggest_shift() == want.suggest_shift()
    for fn in nulls:
        assert abs(pd.cosine_sum_spectrum(got.coeffs, fn)[0]) < 1e-12


@pytest.mark.parametrize("coeffs", [(0.35875, 0.48829, 0.14128, 0.01168), (0.5, 0.5),
                                    (0.25, 0.55, 0.2)])
def test_spectrum_model_equal_to_jax(coeffs):
    f = np.linspace(-12.0, 40.0, 1001)
    np.testing.assert_array_equal(pd.cosine_sum_spectrum(coeffs, f),
                                  jd.cosine_sum_spectrum(coeffs, f))
    assert pd.cosine_sum_spectrum(coeffs, 0.0)[0] == pytest.approx(coeffs[0])


@pytest.mark.parametrize("k,stop,nulls", DESIGNS[:5])
@pytest.mark.parametrize("n", [256, 4096])
def test_sampled_window_equal_to_jax(k, stop, nulls, n):
    got, want = _pair(k, stop, nulls)
    np.testing.assert_array_equal(pd.sampled_window(got, n), jd.sampled_window(want, n))


@pytest.mark.parametrize("k,stop,nulls", DESIGNS)
@pytest.mark.parametrize("width", [16, 17, 24, 32])
@pytest.mark.parametrize("shift", [None, 1, 2])
def test_quantized_coeffs_equal_to_jax(k, stop, nulls, width, shift):
    got, want = _pair(k, stop, nulls)
    q = pd.quantized_coeffs(got, width, shift)
    assert q == jd.quantized_coeffs(want, width, shift)
    assert all(isinstance(c, int) for c in q)


@pytest.mark.parametrize("overflow", ["wrap", "saturate"])
def test_designed_window_through_the_port(overflow):
    """Designed coefficients through the port's generation path: 0 LSB
    against JAX and the golden model, the floor the design promises."""
    r = pd.design_min_sidelobe(4)
    q = pd.quantized_coeffs(r, 18)
    spec = WindowSpec(12, 18, overflow=overflow)
    got = window_block(0, 4096, q, spec, device="cpu").numpy()
    want = np.asarray(jkw.window_samples(jnp.arange(4096), q, jconfig.WindowSpec(**vars(spec))))
    np.testing.assert_array_equal(got, want)
    for i in (0, 1, 1024, 2048, 3072, 4095):
        assert int(got[i]) == golden.win_cosine_sum_hls(i, q, 12, 18)
    assert window_sidelobe_db(got.astype(float), n_terms=4) < -95.0


@pytest.mark.parametrize("rounding", ["hls", "rtl"])
def test_designed_7term_w32(rounding):
    r = pd.design_min_sidelobe(7)
    q = pd.quantized_coeffs(r, 32, shift=1)
    if rounding == "rtl":
        q = rtl_cordic_coeffs(q)
    spec = WindowSpec(11, 32, rounding=rounding, overflow="wrap")
    n = torch.arange(1 << 11)
    got = window_samples(n, q, spec).numpy()
    want = np.asarray(jkw.window_samples(jnp.arange(1 << 11), q,
                                         jconfig.WindowSpec(**vars(spec))))
    np.testing.assert_array_equal(got, want)
    if rounding == "hls":
        assert got.max() == (1 << 31) - 1  # the exact-peak a0 trim


def test_bad_args_as_jax():
    for kwargs in ({"n_terms": 1}, {"n_terms": 4, "stop_bin": 0.5}):
        with pytest.raises(ValueError) as ej:
            jd.design_min_sidelobe(**kwargs)
        with pytest.raises(ValueError) as ep:
            pd.design_min_sidelobe(**kwargs)
        assert str(ep.value) == str(ej.value)
    with pytest.raises(ValueError, match="shift"):
        pd.quantized_coeffs(pd.design_min_sidelobe(4), 17, shift=0)


def test_suggest_shift_rule():
    assert pd.DesignResult((0.25, 0.55, 0.2), -60.0, 3.0).suggest_shift() == 1
    assert pd.DesignResult((1.1, -0.2, 0.1), -20.0, 3.0).suggest_shift() == 2
