"""The plain reference against the program's CPU path at tiny sizes, and
the reference's independence from the program and from JAX."""

import ast
import math

import pytest
import torch

from portbench import layout
from portbench.reference import welch as ref_welch, window as ref_window

from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels.window import make_window, window_block
from blackman_harris_win_tpu_torch.pipeline.spectral import windowed_power_spectrum
from blackman_harris_win_tpu_torch.windows import catalog

CASES = [("bh7", 12, 32, "wrap"), ("bh7", 13, 32, "saturate"), ("bh4", 10, 17, "saturate"),
         ("bh4", 12, 17, "wrap"), ("bh4", 9, 12, "saturate")]


@pytest.mark.parametrize("name,pw,w,overflow", CASES)
def test_window_bits_equal_the_program(name, pw, w, overflow):
    assert ref_window.quantized(name, w) == catalog.get(name).quantized(w)
    spec = WindowSpec(phase_width=pw, data_width=w, overflow=overflow)
    want = make_window(name, spec, device="cpu")
    got = ref_window.window_range(0, 1 << pw, name, pw, w, overflow, "cpu", block=1000)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pw", [12, 26])
def test_window_seams(pw):
    """The quadrant seams and the ends of the period, at 32 bits."""
    n = 1 << pw
    idx = sorted({(q * n // 4 + d) % n for q in range(4) for d in (-2, -1, 0, 1, 2)})
    spec = WindowSpec(phase_width=pw, data_width=32, overflow="wrap")
    q7 = catalog.get("bh7").quantized(32)
    for i in idx:
        want = window_block(i, 1, q7, spec, "cpu")
        got = ref_window.window_range(i, 1, "bh7", pw, 32, "wrap", "cpu")
        assert torch.equal(got, want), i


@pytest.mark.parametrize("n0", [0, 1, 4096 - 1000, 4095, 3 * 4096 + 17])
def test_block_across_the_period_end(n0):
    """A block from any first index runs on past the period, as the
    generation traffic asks: the window repeats with period 2^PW."""
    spec = WindowSpec(phase_width=12, data_width=32, overflow="wrap")
    q7 = catalog.get("bh7").quantized(32)
    want = window_block(n0, 4096, q7, spec, "cpu")
    got = ref_window.window_range(n0, 4096, "bh7", 12, 32, "wrap", "cpu", block=1000)
    assert torch.equal(got, want)
    assert torch.equal(got, ref_window.window_range(0, 4096, "bh7", 12, 32, "wrap", "cpu")
                       .roll(-(n0 % 4096)))


def test_narrow_state_breaks_the_contract():
    good = ref_window.window_range(0, 4096, "bh7", 12, 32, "wrap", "cpu")
    bad = ref_window.window_range(0, 4096, "bh7", 12, 32, "wrap", "cpu", state_bits=32)
    assert int((good != bad).sum()) > 4000


def test_spectrum_against_the_program():
    nfft, hop = 1 << 10, 1 << 9
    g = torch.Generator().manual_seed(7)
    t = torch.arange(16 * nfft, dtype=torch.float64)
    x = (torch.cos(2 * math.pi * 0.123 * t) + 1e-3 * torch.randn(t.shape, generator=g,
                                                                 dtype=torch.float64)).float()
    spec = WindowSpec(phase_width=10, data_width=17, overflow="saturate")
    got = windowed_power_spectrum(x, "bh4", spec, hop=hop, device="cpu")
    wq = ref_window.window_range(0, nfft, "bh4", 10, 17, "saturate", "cpu")
    win64 = wq.double() * ref_window.scale("bh4", 17)
    want = ref_welch.welch64(x, win64, nfft, hop, block=3)
    gap = (got.double() - want).abs() / want
    assert float(torch.quantile(gap, 0.99)) < 1e-3
    tf32 = ref_welch.welch_tf32(x, win64, nfft, hop)
    gap32 = (tf32.double() - want).abs() / want
    assert float(torch.quantile(gap32, 0.99)) > 10 * float(torch.quantile(gap, 0.99))


def test_tf32_rounding():
    v = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0 - 2**-12, 1e-30])
    r = ref_welch.to_tf32(v)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0, ref_welch.to_tf32(torch.tensor([1e-30]))[0]]
    x = torch.randn(1000)
    rel = ((ref_welch.to_tf32(x) - x).abs() / x.abs()).max()
    assert rel <= 2**-11


@pytest.mark.parametrize("path", sorted((layout.ROOT / "portbench/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_the_program_nor_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] in ("__future__", "torch", "math", "numpy"), n
