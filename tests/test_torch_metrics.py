"""PyTorch port, window figures of merit: closed forms, numeric metrics on
float and quantized windows (the port's generated windows included), the
overlap numbers and the catalog table, equal to the JAX package's."""

import numpy as np
import pytest

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import window as jkw
from blackman_harris_win_tpu.windows import metrics as jm
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels.window import make_window
from blackman_harris_win_tpu_torch.windows import catalog
from blackman_harris_win_tpu_torch.windows import metrics as pm


@pytest.mark.parametrize("name", catalog.names())
def test_closed_forms(name):
    c = catalog.get(name).coeffs
    assert pm.cosine_sum_enbw_bins(c) == jm.cosine_sum_enbw_bins(c)
    assert pm.cosine_sum_coherent_gain(c) == jm.cosine_sum_coherent_gain(c)


@pytest.mark.parametrize("name", catalog.names())
@pytest.mark.parametrize("width", [None, 17])
def test_window_metrics_equal_to_jax(name, width):
    n, d = 1024, catalog.get(name)
    idx = np.arange(n)
    w = (catalog.float_window_value(name, idx, n) if width is None
         else catalog.golden_quantized_window(name, idx, n, width))
    got = pm.window_metrics(w, n_terms=d.n_terms, oversample=32)
    assert vars(got) == vars(jm.window_metrics(w, n_terms=d.n_terms, oversample=32))
    # the closed form and the numeric ENBW of the float window agree
    if width is None:
        assert got.enbw_bins == pytest.approx(pm.cosine_sum_enbw_bins(d.coeffs), rel=1e-9)


@pytest.mark.parametrize("name,w", [("bh4", 17), ("bh7", 32), ("hamming", 16)])
def test_metrics_of_generated_windows(name, w):
    spec = WindowSpec(11, w, overflow="wrap")
    got = make_window(name, spec, device="cpu").numpy()
    want = np.asarray(jkw.make_window(name, jconfig.WindowSpec(11, w, overflow="wrap")))
    np.testing.assert_array_equal(got, want)
    n_terms = catalog.get(name).n_terms
    assert vars(pm.window_metrics(got, n_terms=n_terms)) == \
        vars(jm.window_metrics(want, n_terms=n_terms))


@pytest.mark.parametrize("name", ["hann", "bh4", "bh7", "flattop1"])
@pytest.mark.parametrize("hop", [64, 128, 256])
def test_overlap_numbers(name, hop):
    w = catalog.float_window_value(name, np.arange(512), 512)
    assert pm.overlap_flatness(w, hop) == jm.overlap_flatness(w, hop)
    assert pm.overlap_correlation(w, hop) == jm.overlap_correlation(w, hop)


@pytest.mark.parametrize("width", [None, 17])
def test_catalog_metrics(width):
    got = pm.catalog_metrics(n=512, data_width=width, oversample=16)
    want = jm.catalog_metrics(n=512, data_width=width, oversample=16)
    assert list(got) == list(want) == catalog.names()
    for name in got:
        assert vars(got[name]) == vars(want[name])


def test_errors_as_jax():
    w = catalog.float_window_value("hann", np.arange(512), 512)
    for mod in (pm, jm):
        with pytest.raises(ValueError, match="divide"):
            mod.overlap_flatness(w, 100)
    with pytest.raises(ValueError, match="never crosses"):
        pm._interp_crossing(np.arange(4.0), np.zeros(4), -3.0)
