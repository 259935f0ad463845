"""PyTorch port: entry points run on the card unless the caller asks for
the CPU.  A generator called without ``device`` asks for the current CUDA
device: where torch sees none, as here, it raises the ``resolve_device``
error and never falls back to the CPU; with ``device="cpu"`` it runs the
plain version.  Pipeline functions given a tensor run where it lies."""

import importlib
import inspect
import pkgutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import blackman_harris_win_tpu_torch as port
from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.__main__ import main as cli_main
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.kernels import compwin, fastwin_kernel, floatwin, outerwin
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
from blackman_harris_win_tpu_torch.kernels import taylor, taylor_kernel
from blackman_harris_win_tpu_torch.kernels import window, window_kernel
from blackman_harris_win_tpu_torch.pipeline import (channelizer, ddc, demod, fir, sdr, spectral,
                                                    spectrometer, stft)
from blackman_harris_win_tpu_torch.windows import catalog
from blackman_harris_win_tpu_torch.windows.selector import WinSelector

SPEC = WindowSpec(10, 17, overflow="saturate")
Q4 = catalog.get("bh4").quantized(17)
SPEC32 = WindowSpec(12, 32, overflow="wrap")
Q7 = catalog.get("bh7").quantized(32)
TSPEC = WindowSpec(10, 16, sin_type="taylor", lut_size=6)
QH = catalog.get("hamming").quantized(16)
X = np.random.default_rng(0).normal(size=1024).astype(np.float32)
PROTO = channelizer.design_prototype(4, 6)
#: int8 ADC words: 255 frames of 4, 250 valid, 10 integrations of 25
X8 = np.clip(np.round(X[:1020] * 10), -127, 127).astype(np.int8)
S = np.fft.rfft(X[:896].reshape(7, 128), n=256).astype(np.complex64)


def _cli(*argv, **d):
    """One CLI subcommand, ``--device`` from the keyword, its ``--out`` .npy
    loaded back as a tensor.  The CLI exits with ``resolve_device``'s message
    where the device does not exist; that exit is raised here as the
    RuntimeError the entry-point test expects of every entry point."""
    with tempfile.TemporaryDirectory() as tmp:
        x, out = Path(tmp) / "x.npy", Path(tmp) / "out.npy"
        np.save(x, X)
        argv = [a.replace("X.npy", str(x)) for a in argv] + ["--out", str(out)]
        if "device" in d:
            argv += ["--device", d["device"]]
        try:
            cli_main(argv)
        except SystemExit as ex:
            raise RuntimeError(str(ex)) from ex
        return torch.from_numpy(np.load(out))

# entry point -> call taking the device keyword
ENTRY_POINTS = {
    "window.make_window": lambda **d: window.make_window("bh4", SPEC, **d),
    "window.window_block": lambda **d: window.window_block(5, 64, Q4, SPEC, **d),
    "window_kernel.window_block": lambda **d: window_kernel.window_block(Q4, SPEC, 0, 64, **d),
    "window_kernel.window_checksum": lambda **d: window_kernel.window_checksum(Q4, SPEC, 0, 64, **d),
    "window_kernel.window_checksum_plain":
        lambda **d: window_kernel.window_checksum_plain(Q4, SPEC, 0, 64, **d),
    "outerwin.window_block_outer":
        lambda **d: outerwin.window_block_outer(0, 2, Q7, SPEC32, m=5, **d),
    "outerwin_kernel.outer_block_int": lambda **d: ok.outer_block_int(Q7, SPEC32, 5, 0, 2, **d),
    "outerwin_kernel.outer_block_f32": lambda **d: ok.outer_block_f32("bh7", 12, 5, 0, 2, **d),
    "outerwin_kernel.outer_block_comp":
        lambda **d: ok.outer_block_comp("bh7", 12, 5, compwin.GRID_BITS, compwin.DEFAULT_THRESH,
                                        0, 2, **d)[0],
    "outerwin_kernel.make_checksum_fn": lambda **d: ok.make_checksum_fn(Q7, SPEC32, 5, 8, **d)(1),
    "outerwin_kernel.make_checksum_fn_f32":
        lambda **d: ok.make_checksum_fn_f32("bh7", 12, 5, 8, **d)(1),
    "outerwin_kernel.make_checksum_fn_comp":
        lambda **d: ok.make_checksum_fn_comp("bh7", 12, 5, 8, **d)(1),
    "outerwin_kernel.checksum_plain": lambda **d: ok.checksum_plain(Q7, SPEC32, 5, 8, **d),
    "outerwin_kernel.checksum_plain_f32": lambda **d: ok.checksum_plain_f32("bh7", 12, 5, 8, **d),
    "outerwin_kernel.checksum_plain_comp": lambda **d: ok.checksum_plain_comp("bh7", 12, 5, 8, **d),
    "outerwin_kernel.outer_block_int_plain":
        lambda **d: ok.outer_block_int_plain(Q7, SPEC32, 5, 0, 2, **d),
    "outerwin_kernel.outer_block_f32_plain":
        lambda **d: ok.outer_block_f32_plain("bh7", 12, 5, 0, 2, **d),
    "outerwin_kernel.outer_block_comp_plain":
        lambda **d: ok.outer_block_comp_plain("bh7", 12, 5, compwin.GRID_BITS,
                                              compwin.DEFAULT_THRESH, 0, 2, **d)[0],
    "floatwin.float_window": lambda **d: floatwin.float_window("bh4", 10, **d),
    "floatwin.float_window_block": lambda **d: floatwin.float_window_block(0, 2, "bh4", 10, 5, **d),
    "compwin.comp_window_pair": lambda **d: compwin.comp_window_pair("bh7", 10, **d)[0],
    "compwin.comp_window_block": lambda **d: compwin.comp_window_block(0, 2, "bh7", 10, 5, **d)[0],
    "compwin.comp_window": lambda **d: compwin.comp_window("bh7", 10, **d),
    "taylor.taylor_sincos_block": lambda **d: taylor.taylor_sincos_block(0, 64, 10, 16, 6, **d)[0],
    "taylor.taylor_window_block": lambda **d: taylor.taylor_window_block(0, 64, QH, TSPEC, **d),
    "taylor.taylor_window_range": lambda **d: taylor.taylor_window_range(0, 64, QH, TSPEC, **d),
    "taylor_kernel.sincos_block": lambda **d: taylor_kernel.sincos_block(0, 64, 10, 16, 6, **d)[0],
    "taylor_kernel.window_block": lambda **d: taylor_kernel.window_block(QH, TSPEC, 0, 64, **d),
    "taylor_kernel.window_rtl_block":
        lambda **d: taylor_kernel.window_rtl_block(QH, TSPEC.with_(rounding="rtl"), 0, 64, **d),
    "fastwin_kernel.window_block": lambda **d: fastwin_kernel.window_block(
        Q7, SPEC32.with_(sin_type="taylor2", lut_size=10), 0, 64, **d),
    "taylor_kernel.checksum_range": lambda **d: taylor_kernel.checksum_range(0, 64, 10, 16, 6, **d),
    "taylor_kernel.make_checksum_fn_taylor":
        lambda **d: taylor_kernel.make_checksum_fn_taylor(10, 16, 6, 4, **d)(0, 1),
    "taylor_kernel.taylor_checksum_plain":
        lambda **d: taylor_kernel.taylor_checksum_plain(10, 16, 6, **d),
    "fir.decimating_fir": lambda **d: fir.decimating_fir(X, np.ones(8) / 8, 4, **d),
    "ddc.nco_iq": lambda **d: ddc.nco_iq(np.arange(64), 1000, 20, 16, **d)[0],
    "ddc.mix_iq_int": lambda **d: ddc.mix_iq_int(np.ones(64, np.int32), np.arange(64), 1000, 20, 16,
                                                 **d)[0],
    "ddc.ddc": lambda **d: ddc.ddc(X, 0.125, 4, taps=16, **d),
    "demod.fm_demod_phase": lambda **d: demod.fm_demod_phase(np.arange(64), np.arange(64), 16, 20, **d),
    "demod.fm_demod_conj": lambda **d: demod.fm_demod_conj(np.arange(64), np.arange(64), 16, 20, **d),
    "channelizer.polyphase_channelize":
        lambda **d: channelizer.polyphase_channelize(X, PROTO, 4, **d),
    "sdr.sdr_chain": lambda **d: sdr.sdr_chain(X, PROTO, 4, **d),
    "spectrometer.pfb_power": lambda **d: spectrometer.pfb_power(X8, PROTO, 4, 25, **d),
    "stft.stft": lambda **d: stft.stft(X, np.hanning(256), 256, 128, **d),
    "stft.istft": lambda **d: stft.istft(S, np.hanning(256), 128, **d),
    "spectral.welch_power": lambda **d: spectral.welch_power(X, np.hanning(256), 256, 128, **d),
    "spectral.windowed_power_spectrum":
        lambda **d: spectral.windowed_power_spectrum(X, "bh4", WindowSpec(8, 17), **d),
    "spectral.rfft_power_split": lambda **d: spectral.rfft_power_split(X, **d),
    "stft.quantized_stft_pair": lambda **d: stft.quantized_stft_pair("bh4", SPEC, **d)[2],
    "stft.float_stft_pair": lambda **d: stft.float_stft_pair("bh4", 10, **d)[2],
    "stft.comp_stft_pair": lambda **d: stft.comp_stft_pair("bh4", 10, **d)[2][0],
    "selector.WinSelector.__call__": lambda **d: WinSelector("BH4TERM", 10, 17)(**d),
    "cli.gen": lambda **d: _cli("gen", "bh4", "--phase-width", "8", **d),
    "cli.spectrum": lambda **d: _cli("spectrum", "bh4", "--phase-width", "8", "--input", "X.npy",
                                     **d),
    "cli.ddc": lambda **d: _cli("ddc", "--input", "X.npy", "--freq", "0.125", "--taps", "16", **d),
    "cli.stft": lambda **d: _cli("stft", "bh4", "--phase-width", "8", "--input", "X.npy", **d),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    call = ENTRY_POINTS[name]
    out = call(device="cpu")
    assert out.device.type == "cpu"
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device was asked for"):
            call()


def test_resolve_device():
    assert _build.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        _build.resolve_device("meta")
    if not torch.cuda.is_available():
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA device was asked for"):
                _build.resolve_device(dev)


def test_tensor_input_runs_where_it_lies():
    x = torch.from_numpy(X)
    for out in (fir.decimating_fir(x, np.ones(8) / 8, 4), ddc.ddc(x, 0.125, 4, taps=16),
                channelizer.polyphase_channelize(x, PROTO, 4), sdr.sdr_chain(x, PROTO, 4),
                spectrometer.pfb_power(torch.from_numpy(X8), PROTO, 4, 25),
                stft.stft(x, torch.hann_window(256), 256, 128),
                demod.fm_demod_conj(torch.arange(64), torch.arange(64), 16, 20)):
        assert out.device == x.device


def _port_functions():
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{info.name}.{name}", obj
            elif inspect.isclass(obj):  # methods too: WinSelector.__call__
                for mname, fn in vars(obj).items():
                    if inspect.isfunction(fn):
                        yield f"{info.name}.{name}.{mname}", fn


def test_no_function_defaults_to_the_cpu():
    found = 0
    for name, fn in _port_functions():
        p = inspect.signature(fn).parameters.get("device")
        if p is not None and p.default is not inspect.Parameter.empty:
            found += 1
            assert p.default is None, f"{name} defaults to device={p.default!r}"
    # every entry point but the CLI's (its device is the --device option,
    # held by the cli.* entries above) is a function or method found here
    assert found >= len([k for k in ENTRY_POINTS if not k.startswith("cli.")])
