"""PyTorch port, the CLI (``python -m blackman_harris_win_tpu_torch``): every
subcommand against the JAX package's ``main`` on the same seeded inputs, the
port with ``--device cpu`` (its plain versions).  ``list``, ``info``,
``metrics`` and ``design`` print the same text; ``suggest`` picks the same
mode; ``gen`` is 0 LSB on every integer mode and within the float/comp
bounds of the mode tests; ``spectrum``, ``ddc`` and ``stft`` within the
derived f32 budgets of the pipeline tests; errors as in JAX; and no silent
CPU run without a card."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.__main__ import main as jmain
from blackman_harris_win_tpu_torch.__main__ import main as pmain
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as pk
from blackman_harris_win_tpu_torch.pipeline import fir
from blackman_harris_win_tpu_torch.windows import catalog

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
_U = 2.0**-24


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _both(argv, capsys, port_extra=()):
    """(JAX, port) (rc, stdout, stderr) of one command line."""
    return _run(jmain, list(argv), capsys), _run(pmain, list(argv) + list(port_extra), capsys)


def _budget(nfft):
    """f32 budget per bin (``tests/test_torch_spectral.py``)."""
    return 32 * _U * np.sqrt(nfft)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _gen_both(tmp_path, args, capsys):
    """``gen`` into a .npy by each package; returns (jax array, port array,
    JAX stderr, port stderr)."""
    fj, fp = tmp_path / "j.npy", tmp_path / "p.npy"
    rj, _, ej = _run(jmain, ["gen", *args, "--out", str(fj)], capsys)
    rp, _, ep = _run(pmain, ["gen", *args, "--out", str(fp), *CPU], capsys)
    assert rj == rp == 0
    return np.load(fj), np.load(fp), ej, ep


class TestCatalogCommands:
    @pytest.mark.parametrize("json_flag", [True, False])
    def test_list(self, capsys, json_flag):
        argv = ["list"] + (["--json"] if json_flag else [])
        (rj, oj, _), (rp, op, _) = _both(argv, capsys)
        assert rj == rp == 0 and op == oj
        if json_flag:
            assert {r["name"] for r in json.loads(op)} == set(catalog.names())

    @pytest.mark.parametrize("name", catalog.names())
    @pytest.mark.parametrize("width", [16, 17, 32])
    def test_info(self, capsys, name, width):
        (rj, oj, _), (rp, op, _) = _both(["info", name, "--data-width", str(width)], capsys)
        assert rj == rp == 0 and op == oj
        assert tuple(json.loads(op)["quantized"]) == catalog.get(name).quantized(width)

    @pytest.mark.parametrize("argv", [
        ["metrics", "--n", "1024"],
        ["metrics", "--n", "1024", "--json"],
        ["metrics", "bh4", "--n", "1024", "--data-width", "17", "--json"],
        ["metrics", "bh7", "--n", "512", "--data-width", "32", "--oversample", "16"],
    ])
    def test_metrics(self, capsys, argv):
        (rj, oj, _), (rp, op, _) = _both(argv, capsys)
        assert rj == rp == 0 and op == oj

    @pytest.mark.parametrize("argv", [
        ["design", "4", "--measure-floor"],
        ["design", "3"],
        ["design", "7", "--phase-width", "10", "--measure-floor"],
        ["design", "4", "--null", "9.5", "--data-width", "17"],
        ["design", "5", "--stop-bin", "4.5", "--data-width", "24"],
    ])
    def test_design(self, capsys, argv):
        (rj, oj, ej), (rp, op, ep) = _both(argv, capsys)
        assert rj == rp == 0 and op == oj and ep == ej

    def test_design_outfile(self, tmp_path, capsys):
        fj, fp = tmp_path / "j.txt", tmp_path / "p.txt"
        argv = ["design", "4", "--null", "9.5", "--data-width", "17", "--out"]
        (rj, oj, _), (rp, op, _) = (_run(jmain, argv + [str(fj)], capsys),
                                    _run(pmain, argv + [str(fp)], capsys))
        assert rj == rp == 0 and op == oj
        assert fp.read_text() == fj.read_text()

    @pytest.mark.parametrize("name", catalog.names())
    def test_suggest_same_mode(self, capsys, name):
        for consumer in ("float", "int"):
            for exactness in ("bit-exact", "floor"):
                argv = ["suggest", name, "--consumer", consumer, "--exactness", exactness]
                (rj, oj, _), (rp, op, _) = _both(argv, capsys)
                assert rj == rp == 0
                j, p = json.loads(oj), json.loads(op)
                assert p["mode"] == j["mode"], argv
                assert set(p) == {"mode", "est_gsamp_s_64M_h100", "rationale"}

    @pytest.mark.parametrize("target", ["-150", "-170"])
    def test_suggest_target(self, capsys, target):
        (rj, oj, _), (rp, op, _) = _both(["suggest", "bh7", "--target-db", target], capsys)
        assert rj == rp == 0 and json.loads(op)["mode"] == json.loads(oj)["mode"]

    def test_suggest_unknown_window(self, capsys):
        (rj, _, ej), (rp, _, ep) = _both(["suggest", "nosuchwin"], capsys)
        assert rj == rp == 2 and ep == ej

    @pytest.mark.parametrize("argv", [["info", "nosuchwin"], ["metrics", "nosuchwin"]])
    def test_unknown_window(self, argv):
        with pytest.raises(KeyError, match="available") as ej:
            jmain(argv)
        with pytest.raises(KeyError, match="available") as ep:
            pmain(argv)
        assert str(ep.value) == str(ej.value)


class TestGen:
    @pytest.mark.parametrize("name,pw,w", [("hamming", 10, 16), ("bh4", 12, 17),
                                           ("bh7", 11, 32), ("hann", 10, 24)])
    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    @pytest.mark.parametrize("overflow", ["wrap", "saturate"])
    def test_exact(self, tmp_path, capsys, name, pw, w, rounding, overflow):
        j, p, _, _ = _gen_both(tmp_path, [name, "--phase-width", str(pw), "--data-width", str(w),
                                          "--rounding", rounding, "--overflow", overflow],
                               capsys)
        assert p.shape == j.shape == (1 << pw,)
        np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64))

    @pytest.mark.parametrize("name,w,ls,overflow", [("blackman", 16, 9, "wrap"),
                                                    ("hamming", 16, 10, "saturate"),
                                                    ("bh3", 32, 8, "wrap")])
    @pytest.mark.parametrize("rounding", ["hls", "rtl"])
    def test_taylor_source(self, tmp_path, capsys, name, w, ls, overflow, rounding):
        j, p, _, _ = _gen_both(tmp_path, [name, "--phase-width", "11", "--data-width", str(w),
                                          "--sin-type", "taylor", "--lut-size", str(ls),
                                          "--overflow", overflow, "--rounding", rounding],
                               capsys)
        np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64))

    @pytest.mark.parametrize("mode", ["outer", "taylor2"])
    @pytest.mark.parametrize("name,w", [("bh7", 32), ("bh4", 17)])
    def test_int_fast_modes(self, tmp_path, capsys, mode, name, w):
        args = [name, "--phase-width", "12", "--data-width", str(w), "--mode", mode,
                "--measure-floor"]
        j, p, ej, ep = _gen_both(tmp_path, args, capsys)
        assert p.shape == j.shape == (4096,)
        np.testing.assert_array_equal(p.astype(np.int64), j.astype(np.int64))
        assert json.loads(ep.splitlines()[-1]) == json.loads(ej.splitlines()[-1])

    @pytest.mark.parametrize("name", ["bh4", "bh7", "hann"])
    def test_float(self, tmp_path, capsys, name):
        j, p, _, _ = _gen_both(tmp_path, [name, "--phase-width", "12", "--mode", "float"],
                               capsys)
        assert p.dtype == j.dtype == np.float32 and p.shape == (4096,)
        assert np.abs(p.astype(np.float64) - j).max() <= pk.f32_pair_bound(name)

    @pytest.mark.parametrize("name", ["bh4", "bh7"])
    def test_comp_pair(self, tmp_path, capsys, name):
        j, p, _, _ = _gen_both(tmp_path, [name, "--phase-width", "13", "--mode", "comp-pair"],
                               capsys)
        assert p.dtype == j.dtype == np.float32 and p.shape == j.shape == (2, 1 << 13)
        pair_p = p[0].astype(np.float64) + p[1]
        pair_j = j[0].astype(np.float64) + j[1]
        assert np.abs(pair_p - pair_j).max() < 5e-9  # test_torch_compwin's pair bound
        np.testing.assert_array_equal(pair_p.astype(np.float32), p[0])  # non-overlapping

    def test_comp_folded(self, tmp_path, capsys):
        j, p, _, _ = _gen_both(tmp_path, ["bh7", "--phase-width", "12", "--mode", "comp"],
                               capsys)
        _, jp, _, _ = _gen_both(tmp_path, ["bh7", "--phase-width", "12", "--mode", "comp-pair"],
                                capsys)
        assert p.dtype == np.float32 and p.shape == j.shape == (4096,)
        # each side is its pair rounded once: the pairs' 5e-9 plus half an ulp
        assert np.abs(p.astype(np.float64) - (jp[0].astype(np.float64) + jp[1])).max() \
            <= 5e-9 + _U

    @pytest.mark.parametrize("args", [
        ["hann", "--phase-width", "4", "--mode", "float", "--head", "4"],
        ["bh4", "--phase-width", "6", "--head", "10"],
        ["hamming", "--phase-width", "5", "--data-width", "16", "--mode", "taylor2"],
        ["blackman", "--phase-width", "6", "--sin-type", "taylor", "--lut-size", "4"],
    ])
    def test_text_output(self, capsys, args):
        (rj, oj, _), (rp, op, _) = _both(["gen", *args], capsys, CPU)
        assert rj == rp == 0
        if "float" in args:
            np.testing.assert_allclose(np.array(op.split(), float), np.array(oj.split(), float),
                                       rtol=0, atol=pk.f32_pair_bound("hann"))
        else:
            assert op == oj

    def test_text_file(self, tmp_path, capsys):
        fj, fp = tmp_path / "j.txt", tmp_path / "p.txt"
        args = ["gen", "bh7", "--phase-width", "8", "--data-width", "32", "--overflow", "wrap",
                "--out"]
        assert _run(jmain, args + [str(fj)], capsys)[0] == 0
        assert _run(pmain, args + [str(fp), *CPU], capsys)[0] == 0
        assert fp.read_text() == fj.read_text()

    def test_unknown_window(self):
        with pytest.raises(KeyError, match="available"):
            jmain(["gen", "nosuchwin"])
        with pytest.raises(KeyError, match="available"):
            pmain(["gen", "nosuchwin", *CPU])


def _save(tmp_path, x, name="x.npy"):
    f = tmp_path / name
    np.save(f, x)
    return str(f)


class TestSpectrum:
    @pytest.mark.parametrize("fft_mode", ["rfft", "packed", "mxu"])
    @pytest.mark.parametrize("win_mode", ["quantized", "float", "comp"])
    def test_npy(self, tmp_path, capsys, fft_mode, win_mode):
        x = np.random.default_rng(9).normal(size=9 * 256).astype(np.float32)
        inp = _save(tmp_path, x)
        fj, fp = tmp_path / "j.npy", tmp_path / "p.npy"
        args = ["spectrum", "bh4", "--phase-width", "9", "--input", inp, "--fft-mode", fft_mode,
                "--win-mode", win_mode, "--out"]
        assert _run(jmain, args + [str(fj)], capsys)[0] == 0
        assert _run(pmain, args + [str(fp), *CPU], capsys)[0] == 0
        p, j = np.load(fp), np.load(fj)
        assert p.shape == j.shape == (257,)
        assert _max_rel(p, j) < _budget(512)

    @pytest.mark.parametrize("fft_mode", ["rfft", "mxu"])
    @pytest.mark.parametrize("fmt,dtype", [("i16", "<i2"), ("i8", "i1"), ("f32", "<f4"),
                                           ("ci16", "<i2")])
    def test_raw(self, tmp_path, capsys, fft_mode, fmt, dtype):
        rng = np.random.default_rng(10)
        raw = tmp_path / f"x.{fmt}"
        if dtype == "<f4":
            rng.normal(size=5000).astype(dtype).tofile(raw)
        else:
            info = np.iinfo(np.dtype(dtype))
            rng.integers(info.min, info.max, size=5000 * (2 if fmt == "ci16" else 1)) \
                .astype(dtype).tofile(raw)
        fj, fp = tmp_path / "j.npy", tmp_path / "p.npy"
        args = ["spectrum", "bh4", "--phase-width", "9", "--data-width", "17", "--input",
                str(raw), "--format", fmt, "--scale", str(2.0**-14), "--offset", "7",
                "--count", "4000", "--fft-mode", fft_mode, "--out"]
        assert _run(jmain, args + [str(fj)], capsys)[0] == 0
        assert _run(pmain, args + [str(fp), *CPU], capsys)[0] == 0
        p, j = np.load(fp), np.load(fj)
        assert p.shape == j.shape == (257,)
        assert _max_rel(p, j) < _budget(512)

    def test_tone_to_stdout(self, tmp_path, capsys):
        x = np.sin(2 * np.pi * 0.25 * np.arange(4096)).astype(np.float32)
        (rj, oj, _), (rp, op, _) = _both(["spectrum", "bh4", "--phase-width", "10",
                                          "--input", _save(tmp_path, x)], capsys, CPU)
        assert rj == rp == 0
        dj, dp = np.array(oj.split(), float), np.array(op.split(), float)
        assert dp.shape == dj.shape == (513,) and int(np.argmax(dp)) == 256
        # per-bin relative budget in power, in dB (the deep bins are noise)
        loud = dj > dj.max() - 100
        assert np.abs(dp - dj)[loud].max() < 10 * np.log10(1 + _budget(1024))

    def test_input_shorter_than_frame(self, tmp_path):
        inp = _save(tmp_path, np.zeros(100, np.float32))
        argv = ["spectrum", "bh4", "--phase-width", "8", "--input", inp]
        with pytest.raises(SystemExit) as ej:
            jmain(argv)
        with pytest.raises(SystemExit) as ep:
            pmain(argv + CPU)
        assert str(ep.value) == str(ej.value) and "nfft=256" in str(ep.value)


def _ddc_bound(x, taps):
    """``tests/test_torch_ddc.py``'s bound: 2 gamma(n) sum|h| max|x|."""
    h32 = np.asarray(fir.design_lowpass(taps, 0.2), np.float32).astype(np.float64)
    g = taps * _U / (1 - taps * _U)
    return 2 * g * np.abs(h32).sum() * max(1.0, float(np.abs(x).max()))


class TestDdc:
    @pytest.mark.parametrize("flavor", ["dds48", "scaled"])
    @pytest.mark.parametrize("t", [8192, 8190])  # 8190: trimmed to a multiple of decim
    def test_vs_jax(self, tmp_path, capsys, flavor, t):
        x = np.random.default_rng(t).normal(size=t).astype(np.float32) * 0.5
        fj, fp = tmp_path / "j.npy", tmp_path / "p.npy"
        args = ["ddc", "--input", _save(tmp_path, x), "--freq", "0.125", "--decim", "4",
                "--flavor", flavor, "--out"]
        assert _run(jmain, args + [str(fj)], capsys)[0] == 0
        assert _run(pmain, args + [str(fp), *CPU], capsys)[0] == 0
        p, j = np.load(fp), np.load(fj)
        assert p.dtype == np.float32 and p.shape == j.shape == (2, t // 4)
        assert np.abs(p - j).max() <= _ddc_bound(x, 64)

    def test_tone_to_stdout(self, tmp_path, capsys):
        fc, df, dec = 1 / 8, 1 / 256, 4
        x = np.cos(2 * np.pi * (fc + df) * np.arange(8192)).astype(np.float32)
        argv = ["ddc", "--input", _save(tmp_path, x), "--freq", str(fc), "--decim", str(dec),
                "--taps", "32", "--window", "hann"]
        (rj, oj, _), (rp, op, _) = _both(argv, capsys, CPU)
        assert rj == rp == 0
        j = np.loadtxt(oj.splitlines())
        p = np.loadtxt(op.splitlines())
        assert p.shape == j.shape == (2048, 2)
        assert np.abs(p - j).max() <= _ddc_bound(x, 32) + 1e-6  # the text's 6 digits

    def test_taps_below_decim_refused(self, tmp_path):
        inp = _save(tmp_path, np.zeros(64, np.float32))
        with pytest.raises(SystemExit, match="decimation larger than its filter"):
            pmain(["ddc", "--input", inp, "--freq", "0.1", "--decim", "8", "--taps", "4", *CPU])


class TestStft:
    @pytest.mark.parametrize("extra", [0, 37])  # 37: trimmed to the frame tiling
    @pytest.mark.parametrize("name,pw", [("bh4", 8), ("hann", 9)])
    def test_vs_jax(self, tmp_path, capsys, extra, name, pw):
        nfft = 1 << pw
        x = np.random.default_rng(pw).normal(size=nfft + 10 * nfft // 2 + extra)
        fj, fp = tmp_path / "j.npy", tmp_path / "p.npy"
        args = ["stft", name, "--phase-width", str(pw), "--data-width", "17", "--input",
                _save(tmp_path, x.astype(np.float32)), "--out"]
        assert _run(jmain, args + [str(fj)], capsys)[0] == 0
        assert _run(pmain, args + [str(fp), *CPU], capsys)[0] == 0
        p, j = np.load(fp), np.load(fj)
        assert p.dtype == np.complex64 and p.shape == j.shape == (11, nfft // 2 + 1)
        assert np.abs(p - j).max() / np.abs(j).max() < _budget(nfft)

    def test_complex_input_takes_real(self, tmp_path, capsys):
        nfft, hop = 256, 128
        n = np.arange(nfft + 4 * hop)
        x = np.exp(2j * np.pi * 16 / nfft * n).astype(np.complex64)
        fj, fp = tmp_path / "j.npy", tmp_path / "p.npy"
        args = ["stft", "bh4", "--phase-width", "8", "--data-width", "17", "--input",
                _save(tmp_path, x), "--out"]
        assert _run(jmain, args + [str(fj)], capsys)[0] == 0
        assert _run(pmain, args + [str(fp), *CPU], capsys)[0] == 0
        p, j = np.load(fp), np.load(fj)
        assert p.shape == j.shape == (5, nfft // 2 + 1)
        assert (np.abs(p).argmax(axis=1) == 16).all()
        assert np.abs(p - j).max() / np.abs(j).max() < _budget(nfft)

    def test_raw_ci16_to_stdout(self, tmp_path, capsys):
        rng = np.random.default_rng(12)
        raw = tmp_path / "x.ci16"
        rng.integers(-(1 << 15), 1 << 15, size=2 * 1500).astype("<i2").tofile(raw)
        argv = ["stft", "bh4", "--phase-width", "8", "--input", str(raw), "--format", "ci16",
                "--scale", str(2.0**-15)]
        (rj, oj, _), (rp, op, _) = _both(argv, capsys, CPU)
        assert rj == rp == 0
        j, p = np.loadtxt(oj.splitlines()), np.loadtxt(op.splitlines())
        assert p.shape == j.shape == (10, 129)
        assert np.abs(p - j).max() <= 0.01  # the text's two decimals

    def test_input_shorter_than_frame(self, tmp_path):
        inp = _save(tmp_path, np.zeros(100, np.float32))
        argv = ["stft", "bh4", "--phase-width", "8", "--data-width", "17", "--input", inp]
        with pytest.raises(SystemExit) as ej:
            jmain(argv)
        with pytest.raises(SystemExit) as ep:
            pmain(argv + CPU)
        assert str(ep.value) == str(ej.value)


class TestDevice:
    @pytest.mark.parametrize("cmd", ["gen", "spectrum", "ddc", "stft"])
    def test_card_by_default(self, tmp_path, cmd):
        if torch.cuda.is_available():
            pytest.skip("this host has a CUDA device")
        inp = _save(tmp_path, np.zeros(8192, np.float32))
        argv = {"gen": ["gen", "bh4"], "spectrum": ["spectrum", "bh4", "--input", inp],
                "ddc": ["ddc", "--input", inp, "--freq", "0.1"],
                "stft": ["stft", "bh4", "--input", inp]}[cmd]
        with pytest.raises(SystemExit, match="a CUDA device was asked for"):
            pmain(argv)

    def test_module_route(self):
        """``python -m``: no card and no --device cpu exits non-zero with the
        resolve_device message; with --device cpu it prints the window."""
        run = lambda *a: subprocess.run(  # noqa: E731
            [sys.executable, "-m", "blackman_harris_win_tpu_torch", "gen", "bh4",
             "--phase-width", "12", *a], cwd=ROOT, capture_output=True, text=True, timeout=120)
        if not torch.cuda.is_available():
            r = run()
            assert r.returncode != 0 and r.stdout == ""
            assert "a CUDA device was asked for" in r.stderr
        r = run("--device", "cpu")
        assert r.returncode == 0, r.stderr
        w = np.array(r.stdout.split(), np.int64)
        from blackman_harris_win_tpu.model import golden

        q = catalog.get("bh4").quantized(17)
        assert len(w) == 4096
        assert [int(w[i]) for i in (0, 1, 1024, 2048, 4095)] == \
            [golden.win_cosine_sum_hls(i, q, 12, 17) for i in (0, 1, 1024, 2048, 4095)]

    def test_bad_device(self):
        with pytest.raises(SystemExit, match="unsupported device"):
            pmain(["gen", "bh4", "--device", "meta"])
