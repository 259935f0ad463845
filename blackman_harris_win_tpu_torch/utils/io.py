"""Host-side sample ingest: raw capture files -> float32 blocks
(counterpart of ``blackman_harris_win_tpu/utils/io.py``; same formats, same
API, same native runtime).

ctypes bridge to the repository's native stream-IO runtime
(``native/stream_io.cpp``): mmap'd zero-copy sources with tight C++
conversion loops, random block access (the resumable streaming contract of
``utils/streaming.py``: state is a block index), and the raw little-endian
formats of the reference's own tool handoffs
(``hls/windows/window_test.cpp:54-56``, ``cpp/cordic_sincos.cpp:131``).

The library is compiled at first use by the host C++ compiler (``$CXX``,
else ``g++``; the flags of ``native/Makefile``) into ``build/native/`` at
the root of the checkout, which ``.gitignore`` lists; nothing is written
into ``native/``.  Without a compiler, :func:`build` raises: there is no
numpy fallback reader.

Formats: ``i8`` / ``i16`` (real), ``f32`` (real), ``ci16`` (interleaved
IQ pairs -> complex64).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "stream_io.cpp"
BUILD_DIR = _ROOT / "build" / "native"
#: native/Makefile's CXXFLAGS and its extra -O3 for libstreamio.so
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", "-O3")
_lib = None

#: format -> (bytes per sample, numpy output dtype)
FORMATS = {
    "i8": (1, np.float32),
    "i16": (2, np.float32),
    "f32": (4, np.float32),
    "ci16": (4, np.complex64),
}


def _cxx() -> list[str]:
    cmd = shlex.split(os.environ.get("CXX") or "g++")
    if not cmd or shutil.which(cmd[0]) is None:
        raise RuntimeError(
            f"C++ compiler {cmd[0] if cmd else '(empty $CXX)'!r} not found: the "
            "stream-IO runtime (native/stream_io.cpp) cannot be built"
        )
    return cmd


def build() -> Path:
    """Compile ``native/stream_io.cpp`` into ``build/native/`` if the library
    for this source, compiler and flags is missing; returns its path."""
    cxx = _cxx()
    h = hashlib.sha256(" ".join((*cxx, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libstreamio_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([*cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx[0]} failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def lib() -> ctypes.CDLL:
    """The bound stream-IO library, built on first use."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(str(build()))
        dll.sio_open.restype = ctypes.c_void_p
        dll.sio_open.argtypes = [ctypes.c_char_p]
        dll.sio_size_bytes.restype = ctypes.c_int64
        dll.sio_size_bytes.argtypes = [ctypes.c_void_p]
        dll.sio_close.argtypes = [ctypes.c_void_p]
        fptr = ctypes.POINTER(ctypes.c_float)
        for name in ("sio_read_i8_f32", "sio_read_i16_f32", "sio_read_f32"):
            fn = getattr(dll, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_float, fptr]
        dll.sio_read_ci16_f32.restype = ctypes.c_int64
        dll.sio_read_ci16_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            fptr, fptr,
        ]
        dll.sio_checksum.restype = ctypes.c_uint64
        dll.sio_checksum.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        dll.sio_write_i32.restype = ctypes.c_int64
        dll.sio_write_i32.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int64]
        _lib = dll
    return _lib


class SampleSource:
    """mmap'd raw sample file with random block access.

    >>> src = SampleSource("capture.i16", fmt="i16", scale=2**-15)
    >>> block = src.read_block(offset_samples, count)   # float32 (count,)
    """

    def __init__(self, path, fmt: str = "i16", scale: float = 1.0):
        if fmt not in FORMATS:
            raise ValueError(f"fmt must be one of {sorted(FORMATS)}")
        self._lib = lib()
        self._h = self._lib.sio_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open (or empty) sample file: {path}")
        self.fmt = fmt
        self.scale = float(scale)
        self.path = str(path)

    def __len__(self) -> int:
        bps, _ = FORMATS[self.fmt]
        return self._lib.sio_size_bytes(self._h) // bps

    def read_block(self, offset: int, count: int) -> np.ndarray:
        """Samples [offset, offset+count) as float32 (complex64 for ci16);
        clamped at end-of-file (returned array may be shorter)."""
        fptr = ctypes.POINTER(ctypes.c_float)
        if self.fmt == "ci16":
            i = np.empty(count, np.float32)
            q = np.empty(count, np.float32)
            n = self._lib.sio_read_ci16_f32(
                self._h, offset, count, self.scale,
                i.ctypes.data_as(fptr), q.ctypes.data_as(fptr),
            )
            return (i[:n] + 1j * q[:n]).astype(np.complex64)
        out = np.empty(count, np.float32)
        fn = {
            "i8": self._lib.sio_read_i8_f32,
            "i16": self._lib.sio_read_i16_f32,
            "f32": self._lib.sio_read_f32,
        }[self.fmt]
        n = fn(self._h, offset, count, self.scale, out.ctypes.data_as(fptr))
        return out[:n]

    def checksum(self, byte_off: int = 0, nbytes: int | None = None) -> int:
        """FNV-1a over raw bytes: resume-integrity fingerprint."""
        if nbytes is None:
            bps, _ = FORMATS[self.fmt]
            nbytes = len(self) * bps - byte_off
        return int(self._lib.sio_checksum(self._h, byte_off, nbytes))

    def close(self):
        if self._h:
            self._lib.sio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_i32(path, data) -> int:
    """Write int32 samples as raw little-endian (the .dat handoff format)."""
    arr = np.ascontiguousarray(np.asarray(data, np.int32))
    n = lib().sio_write_i32(
        str(path).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        arr.size,
    )
    if n != arr.size:
        raise OSError(f"short write to {path}")
    return int(n)
