"""PyTorch port, raw-capture ingest (``utils/io.py``): the port builds
``native/stream_io.cpp`` into ``build/native/`` and writes nothing into
``native/``; its ``SampleSource`` gives bit-equal blocks and equal
checksums to the JAX package's for every format; ``write_i32`` round
trips; a missing compiler raises; and a raw capture reaches the analyzer."""

from pathlib import Path

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.utils import io as jio
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.pipeline.spectral import windowed_power_spectrum
from blackman_harris_win_tpu_torch.utils import io as pio

ROOT = Path(__file__).resolve().parents[1]
FORMATS = {"i8": "i1", "i16": "<i2", "f32": "<f4", "ci16": "<i2"}


def _capture(tmp_path, fmt, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    raw = tmp_path / f"x.{fmt}"
    size = n * (2 if fmt == "ci16" else 1)
    if fmt == "f32":
        rng.normal(size=size).astype("<f4").tofile(raw)
    else:
        info = np.iinfo(np.dtype(FORMATS[fmt]))
        rng.integers(info.min, info.max, size=size, endpoint=True).astype(FORMATS[fmt]).tofile(raw)
    return raw


def _snapshot(d: Path):
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in d.iterdir()}


def test_build_writes_only_into_its_build_dir(tmp_path, monkeypatch):
    native = ROOT / "native"
    before = _snapshot(native)
    monkeypatch.setattr(pio, "BUILD_DIR", tmp_path / "native")
    out = pio.build()
    assert out.parent == tmp_path / "native" and out.exists()
    assert pio.build() == out  # built once per source, compiler and flags
    assert _snapshot(native) == before
    assert pio.BUILD_DIR != native and pio.SOURCE.parent == native


def test_default_build_dir_is_ignored():
    assert pio.BUILD_DIR == ROOT / "build" / "native"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(pio, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        pio.build()
    assert not (tmp_path / "native").exists()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("scale", [1.0, 2.0**-15])
def test_blocks_equal_to_jax(tmp_path, fmt, scale):
    raw = _capture(tmp_path, fmt, seed=len(fmt))
    with pio.SampleSource(raw, fmt, scale=scale) as src, \
            jio.SampleSource(raw, fmt, scale=scale) as jsrc:
        assert len(src) == len(jsrc) == 5000
        for off, count in ((0, 5000), (1234, 256), (4990, 256), (7, 1), (20000, 16)):
            got, want = src.read_block(off, count), jsrc.read_block(off, count)
            assert got.dtype == want.dtype == pio.FORMATS[fmt][1]
            assert got.shape == want.shape
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        for args in ((), (0, 100), (100, 100), (3, 999)):
            assert src.checksum(*args) == jsrc.checksum(*args)


def test_checksum_stability(tmp_path):
    p = tmp_path / "x.i16"
    np.arange(1000, dtype="<i2").tofile(p)
    with pio.SampleSource(p, "i16") as a, pio.SampleSource(p, "i16") as b:
        assert a.checksum() == b.checksum() != 0
        assert a.checksum(0, 100) != a.checksum(100, 100)


def test_write_i32_round_trip(tmp_path):
    w = np.random.default_rng(3).integers(-(1 << 31), 1 << 31, size=4096).astype(np.int32)
    p, pj = tmp_path / "p.dat", tmp_path / "j.dat"
    assert pio.write_i32(p, torch.from_numpy(w)) == 4096
    assert jio.write_i32(pj, w) == 4096
    np.testing.assert_array_equal(np.fromfile(p, dtype="<i4"), w)
    assert p.read_bytes() == pj.read_bytes()


def test_errors(tmp_path):
    with pytest.raises(OSError):
        pio.SampleSource(tmp_path / "nope.i16")
    with pytest.raises(ValueError, match="fmt"):
        pio.SampleSource(tmp_path / "x", fmt="u64")
    empty = tmp_path / "empty.i16"
    empty.write_bytes(b"")
    with pytest.raises(OSError, match="empty"):
        pio.SampleSource(empty)


def test_capture_to_analyzer(tmp_path):
    n = np.arange(8192)
    tone = np.round((2**14) * np.cos(2 * np.pi * 16 / 512 * n)).astype("<i2")
    p = tmp_path / "tone.i16"
    tone.tofile(p)
    with pio.SampleSource(p, "i16", scale=2.0**-14) as src:
        x = torch.from_numpy(src.read_block(0, len(src)))
    pxx = windowed_power_spectrum(x, "bh4", WindowSpec(9, 17))
    assert pxx.device.type == "cpu" and int(torch.argmax(pxx)) == 16
