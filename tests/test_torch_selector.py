"""PyTorch port, ``WinSelector`` (the win_selector parity front-end): every
WIN_TYPE x SIN_TYPE x rounding x overflow 0 LSB against the JAX package's
selector, on the full window (the port's ``window_block`` route) and on the
quadrant-seam indices, and the CORDIC cases against ``model/golden.py``;
the same validation, spec, coefficient ports and ``rtl_a0_correction``."""

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.model import golden
from blackman_harris_win_tpu.windows.selector import WinSelector as JWinSelector
from blackman_harris_win_tpu_torch.kernels.window import make_window
from blackman_harris_win_tpu_torch.utils.spectral import window_sidelobe_db
from blackman_harris_win_tpu_torch.windows import catalog
from blackman_harris_win_tpu_torch.windows.selector import WinSelector

PW = 12
WIDTHS = {"HAMMING": 16, "BH3TERM": 24, "BH4TERM": 17, "BH5TERM": 24, "BH7TERM": 32}
CASES = [(wt, st, r, o)
         for wt in WIDTHS
         for st in (("CORDIC", "TAYLOR") if wt in ("HAMMING", "BH3TERM") else ("CORDIC",))
         for r in ("hls", "rtl")
         for o in ("wrap", "saturate")]


def _seams(pw, seed):
    n = 1 << pw
    pts = [np.random.default_rng(seed).integers(0, n, 64)]
    for base in (0, n // 4, n // 2, 3 * n // 4, n - 1):
        pts.append(np.arange(base - 3, base + 4) % n)
    return np.unique(np.concatenate(pts))


def _kwargs(wt, st, r, o, **extra):
    return dict(win_type=wt, phi_width=PW, dat_width=WIDTHS[wt], sin_type=st, rounding=r,
                overflow=o, **extra)


@pytest.mark.parametrize("wt,st,rounding,overflow", CASES)
def test_full_window_matches_jax(wt, st, rounding, overflow):
    kw = _kwargs(wt, st, rounding, overflow)
    got = WinSelector(**kw)(device="cpu")
    want = np.asarray(JWinSelector(**kw)())
    assert got.dtype == torch.int32 and got.shape == (1 << PW,)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("wt,st,rounding,overflow", CASES)
def test_seam_indices_match_jax_and_golden(wt, st, rounding, overflow):
    kw = _kwargs(wt, st, rounding, overflow)
    sel = WinSelector(**kw)
    n = _seams(PW, len(wt) + 7 * PW)
    got = sel(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JWinSelector(**kw)(n)).astype(np.int64))
    # the full window's values at the same indices
    np.testing.assert_array_equal(got, sel(device="cpu").numpy()[n])
    if st == "CORDIC" and overflow == "wrap":
        gold = golden.win_cosine_sum_hls if rounding == "hls" else golden.win_cosine_sum_rtl
        q, w = sel.coeffs_q, WIDTHS[wt]
        assert got.tolist() == [gold(int(i), q, PW, w) for i in n]


def test_indexed_call_array_like_goes_to_device():
    sel = WinSelector("HAMMING", 10, 16)
    part = sel(np.arange(100, 110), device="cpu")
    assert part.device.type == "cpu" and part.dtype == torch.int64
    np.testing.assert_array_equal(part.numpy(), sel(device="cpu").numpy()[100:110])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device was asked for"):
            sel(np.arange(4))


@pytest.mark.parametrize("wt,st", [("HAMMING", "CORDIC"), ("BH3TERM", "TAYLOR"),
                                   ("BH7TERM", "CORDIC")])
@pytest.mark.parametrize("rounding", ["hls", "rtl"])
@pytest.mark.parametrize("fix", [False, True])
def test_spec_and_ports_equal_jax(wt, st, rounding, fix):
    kw = _kwargs(wt, st, rounding, "wrap", rtl_a0_correction=fix, lut_size=8)
    sel, jsel = WinSelector(**kw), JWinSelector(**kw)
    assert sel.coeffs_q == jsel.coeffs_q
    assert vars(sel.spec) == vars(jsel.spec)


def test_coefficient_ports_are_data():
    aa = catalog.get("nuttall").quantized(17)
    got = WinSelector("BH4TERM", 10, 17, aa=aa)(device="cpu")
    want = np.asarray(JWinSelector("BH4TERM", 10, 17, aa=aa)())
    np.testing.assert_array_equal(got.numpy(), want)
    spec = WinSelector("BH4TERM", 10, 17).spec
    np.testing.assert_array_equal(got.numpy(), make_window("nuttall", spec, device="cpu").numpy())


def test_xseries_has_no_effect():
    a = WinSelector("BH5TERM", 10, 24)(device="cpu")
    b = WinSelector("BH5TERM", 10, 24, xseries="7SERIES")(device="cpu")
    assert torch.equal(a, b)


def test_rtl_a0_correction_restores_floor():
    kw = dict(phi_width=12, dat_width=17, rounding="rtl", overflow="wrap")
    raw = WinSelector("BH4TERM", **kw)(device="cpu").numpy().astype(np.float64)
    fixed_sel = WinSelector("BH4TERM", rtl_a0_correction=True, **kw)
    fixed = fixed_sel(device="cpu").numpy()
    jfixed = np.asarray(JWinSelector("BH4TERM", rtl_a0_correction=True, **kw)())
    np.testing.assert_array_equal(fixed, jfixed)
    assert window_sidelobe_db(raw) > -45.0  # the faithful pedestal
    assert window_sidelobe_db(fixed.astype(np.float64)) <= -92.0  # published floor
    # the correction is ignored outside RTL + CORDIC
    a = WinSelector("BH4TERM", 10, 17)(device="cpu")
    b = WinSelector("BH4TERM", 10, 17, rtl_a0_correction=True)(device="cpu")
    assert torch.equal(a, b)


@pytest.mark.parametrize("args,kwargs", [
    (("KAISER", 10, 16), {}),
    (("BH4TERM", 12, 16), {"sin_type": "TAYLOR"}),
    (("BH3TERM", 10, 16), {"aa": (1, 2)}),
    (("HAMMING", 10, 16), {"sin_type": "taylor"}),
])
def test_validation_as_jax(args, kwargs):
    with pytest.raises(ValueError) as ej:
        JWinSelector(*args, **kwargs)
    with pytest.raises(ValueError) as ep:
        WinSelector(*args, **kwargs)
    assert str(ep.value) == str(ej.value)
