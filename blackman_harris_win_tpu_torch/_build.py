"""Build the CUDA kernels of ``csrc/`` with nvcc and bind them with ctypes.

The kernels are compiled at first use into one shared library with a plain
C interface (no PyTorch headers, so nvcc takes seconds), under ``build/cuda``
at the root of the checkout, which ``.gitignore`` lists: one nvcc per
source, all started together, then one link.  The library's name carries a
hash of the sources and flags, so an edited source rebuilds.  Nothing here
runs at import time.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``.  Every wrapper calls one through
:func:`launch`, which raises on a non-zero code and counts, in
``launches``, the launches of each kernel in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import _trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: kernel name -> launches made by its wrapper in this process
launches = {
    "window_block": 0, "window_checksum": 0, "welch_stage1": 0,
    "outer_block": 0, "outer_block_f32": 0, "outer_block_comp": 0,
    "outer_checksum": 0, "outer_checksum_f32": 0, "outer_checksum_comp": 0,
    "taylor_sincos_block": 0, "taylor_window_block": 0, "taylor_window_rtl": 0,
    "taylor_checksum": 0,
    "materialize": 0, "ddc_nco_table": 0, "ddc_mixer": 0, "cordic_atan2": 0, "fm_demod": 0,
    "taylor2_window_block": 0,
}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U, _D = ctypes.c_uint, ctypes.c_double
# the table arguments of the outer-product entry points: hi, lo, h0, rows,
# nl, hc, nk, np, a0, shift, w, saturate, a0f, a0lo
_OUTER = (_P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F)
_SIGNATURES = {
    # out, n0, length, coeffs, nterms, lut, nlut, gain, pw, w, p, rtl,
    # saturate, datapath, stream
    "bhw_window_block": (_P, _L, _L, _P, _I, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P),
    # out, n_start, count, (same parameters as above), stream
    "bhw_window_checksum": (_P, _L, _L, _P, _I, _P, _I, _L, _I, _I, _I, _I, _I, _I, _P),
    # x, t, win, roots_r, roots_i, t1r, t1i, out_r, out_i, nfft, npair,
    # mask_last, stream
    "bhw_welch_stage1": (_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # mode, out0, out1, (table arguments), stream (float modes: out0 and out1
    # 16-byte aligned, else cudaErrorInvalidValue)
    "bhw_outer_block": (_I, _P, _P, *_OUTER, _P),
    # mode, out, partials, npartials, bias, (table arguments), stream
    "bhw_outer_checksum": (_I, _P, _P, _L, _I, *_OUTER, _P),
    # c, s, n0, count, rom, pw, w, ls, ramb_pi, stream (c and s 16-byte
    # aligned, else cudaErrorInvalidValue)
    "bhw_taylor_sincos_block": (_P, _P, _L, _L, _P, _I, _I, _I, _I, _P),
    # out (16-byte aligned), n0, count, rom, pw, w, ls, coeffs, nterms,
    # ramb_pi (pw), ramb_pi (pw-1), saturate, stream
    "bhw_taylor_window_block": (_P, _L, _L, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P),
    # out (16-byte aligned), n0, count, rom, pw, w, ls, coeffs, nterms,
    # ramb_pi (pw), ramb_pi (pw-1), stream: the RTL contract
    "bhw_taylor_window_rtl": (_P, _L, _L, _P, _I, _I, _I, _P, _I, _I, _I, _P),
    # out, n0, count, rom, pw, w, ls, ramb_pi, stream
    "bhw_taylor_checksum": (_P, _L, _L, _P, _I, _I, _I, _I, _P),
    # dst, src, nbytes, stream
    "bhw_materialize": (_P, _P, _L, _P),
    # table, len, fw, pw, w, flavor, lut, nlut, gain, zshift, oshift, stream
    "bhw_ddc_nco_table": (_P, _L, _U, _I, _I, _I, _P, _I, _L, _I, _I, _P),
    # out, x, rows, t, n0, period, fw, pw, w, flavor, lut, nlut, gain,
    # zshift, oshift, scale, raw, table (null: the compute path), table_len,
    # stream
    "bhw_ddc_mixer": (_P, _P, _L, _L, _L, _L, _U, _I, _I, _I, _P, _I, _L, _I, _I, _F, _I, _P,
                      _L, _P),
    # out, y, x, n, elem, lut, aw, p, input_width, convention, stream
    "bhw_cordic_atan2": (_P, _P, _P, _L, _I, _P, _I, _I, _I, _I, _P),
    # out, i, q, rows, t, (i strides), (q strides), elem, mode, lut, aw,
    # input_width, drop, shift, walk (0: lanes on t, out (rows, t-1); 1:
    # lanes on rows, out (t-1, rows)), stream
    "bhw_fm_demod": (_P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _P, _I, _I, _I, _I, _I, _P),
    # out, y, batches, nf, c, bins (c, or c // 2 + 1: a half spectrum), elem,
    # iq_scale, lut, aw, drop, shift, stream
    "bhw_fm_demod_iq": (_P, _P, _L, _L, _L, _L, _I, _D, _P, _I, _I, _I, _P),
    # out (16-byte aligned), n0, count, rom, pw, w, ls, coeffs, nterms,
    # p_hi, p_lo, saturate, regime (fastwin_kernel.walk_regime), stream
    "bhw_taylor2_window_block": (_P, _L, _L, _P, _I, _I, _I, _P, _I, _U, _U, _I, _I, _P),
}
#: host-side queries of a kernel's launch geometry: name -> (args, result)
_QUERIES = {
    "bhw_outer_max_harmonics": ((), _I),
    # mode, rows, nl, nk, np (on the current device)
    "bhw_outer_npartials": ((_I, _L, _I, _I, _I), _L),
    "bhw_outer_checksum_depth": ((_I, _L, _I, _I, _I), _L),
}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def build() -> tuple[Path, str, float]:
    """Compile ``csrc/*.cu`` if the library for these sources is missing:
    each source to an object by its own nvcc, all at once, then one link.
    Returns (library path, compiler output, seconds spent compiling)."""
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / f"libbhw_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out, "", 0.0
    objdir = BUILD_DIR / f"obj_{h.hexdigest()[:16]}_{os.getpid()}"
    objdir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", "-o", str(objdir / f"{src.stem}.o"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in srcs]
    logs, failed = [], []
    for src, p in procs:
        logs.append(p.communicate()[0])
        if p.returncode:
            failed.append(f"{src.name} ({p.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{''.join(logs)}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                        *(str(objdir / f"{src.stem}.o") for src in srcs)],
                       capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    shutil.rmtree(objdir, ignore_errors=True)
    if r.returncode:
        raise RuntimeError(f"nvcc link failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out, "".join(logs) + r.stdout + r.stderr, seconds


def lib() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        dll = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        for name, (args, res) in _QUERIES.items():
            fn = getattr(dll, name)
            fn.argtypes = list(args)
            fn.restype = res
        dll.bhw_error_string.argtypes = [ctypes.c_int]
        dll.bhw_error_string.restype = ctypes.c_char_p
        _lib = dll
    return _lib


def launch(counter: str, device: torch.device, *args, entry: str | None = None) -> None:
    """Call the C entry point ``bhw_<entry>`` (``entry`` defaults to
    ``counter``) with ``args`` and the device's current stream, inside the
    device's context, under the span ``bhw.launch.<counter>``; raise if it
    reports a CUDA error, else count the launch under ``counter``."""
    with _trace.span("bhw.launch." + counter):
        with torch.cuda.device(device):
            rc = getattr(lib(), "bhw_" + (entry or counter))(*args, stream_of(device))
        if rc:
            msg = lib().bhw_error_string(rc).decode()
            raise RuntimeError(f"{counter} kernel launch failed: CUDA error {rc} ({msg})")
        launches[counter] += 1


def resolve_device(device=None) -> torch.device:
    """The torch device a wrapper runs on: the CPU (plain version) or a CUDA
    device that must exist (kernel).  ``None`` is the current CUDA device:
    entry points run on the card unless the caller asks for the CPU.  No
    other device is accepted."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was asked for, but torch sees none; the CUDA "
                "kernels cannot run here"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use 'cpu' or 'cuda'")
    return device


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """The input of a pipeline function as a tensor: a tensor stays on its
    own device (cast to ``dtype`` if one is given); anything else (numpy,
    lists) goes to ``device``, resolved as :func:`resolve_device` does."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
