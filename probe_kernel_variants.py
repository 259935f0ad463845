"""Time the port's ``materialize`` copy, its window-kernel datapaths, its
stage-1 kernel, its Taylor checksum, its int/f32/comp outer kernels, its
DDC mixer and its discriminator on one card, each beside what it is
compared with in the same process.

    python3 probe_kernel_variants.py [--rounds N] [--against DIR] [--only SECTION]

1. ``materialize`` (``csrc/barrier_kernel.cu``) on the DDC's (2, 2^26)
   float32 mixer-sized array, against ``torch.clone``: through the port's
   wrapper and through its C entry (no Python between the calls), and, with
   ``--against DIR``, the ``bhw_materialize`` of another revision's
   ``csrc/barrier_kernel.cu`` under DIR (for example the parent commit,
   unpacked with ``git archive``), built here on its own.  Each is timed in
   turns (once per round, the order reversed every other round) three ways:
   one call alone in an event pair (the host's launch latency included, as
   ``chip_smoke.py`` times a kernel), 20 queued calls per event pair (per
   call), and the device time of one call under ``torch.profiler``; and the
   host time per call of the wrapper, of the C entry, of ``torch.clone``
   and of each step of the wrapper alone.  Every output is bit-equal to its
   input.
2. The window kernel (``csrc/window_kernel.cu``) at 2^26 samples: each
   configuration through the datapath ``window_kernel._datapath`` chooses
   and through the int64 datapath (the C entry takes the datapath code; the
   port's wrapper never passes another than its own), outputs bit-equal.

3. ``welch_stage1`` (``csrc/welchfft_kernel.cu``) at the analyzer's size
   (nfft 2^20, 255 frames over 128 * 2^20 samples) through its wrapper and,
   with ``--against DIR``, the ``bhw_welch_stage1`` of DIR's source (given
   the FFT-128 roots as the port's, or the DFT matrix where DIR's kernel is
   the earlier direct DFT-matrix one); outputs within 1e-5 of each other's maximum;
   and the wrapper's host time per call.
4. ``taylor_checksum`` (``csrc/taylor_kernel.cu``) over 2^26 samples at
   pw=26, W=16/LS=10 and W=32/LS=12: through the wrapper, through its C
   entry and, with ``--against DIR``, through DIR's ``bhw_taylor_checksum``;
   per call of 16 queued, all sums equal; and the host time per call of the
   wrapper and of each C entry.
5. The int, f32 and comp outer kernels (``csrc/outerwin_kernel.cu``: the
   write-outs ``outer_block``/``outer_block_f32``/``outer_block_comp`` and
   the checksums ``outer_checksum``/``outer_checksum_f32``/
   ``outer_checksum_comp``) at the main path's shapes (BH-7, pw=26, m=11;
   int W=32 wrap) through their C entries, with ``--against DIR`` beside
   DIR's, and each float write-out beside the PyTorch call that computes the
   same window (``torch.addmm`` for f32, ``torch.baddbmm`` for the comp
   pair, TF32 off; no call computes the int window); outputs compared (int
   samples and sums equal, f32 within twice ``f32_pair_bound`` of each
   other, comp s bit-equal and e within twice ``comp_e_bound``, the float
   checksums within their derived sum bounds), then one call alone and per
   call of 16 queued, in turns.
6. ``ddc_mixer`` (``csrc/ddc_kernel.cu``) on 2^26 float32 samples at W=16
   on each of its paths: bench_all config 21 (fc = 1/8 at pw=20, dds48 and
   scaled: a table of P = 8), the odd word 104857 at pw=20 (a table of P =
   2^20) and an odd word at pw=31 (the NCO computed per sample), through
   the port's wrapper (the table's launch included) and, with ``--against
   DIR``, DIR's C entries (an earlier ``bhw_ddc_mixer`` without a table
   argument computes every sample's NCO); outputs bit-equal, one call alone
   and per call of 16 queued, in turns.
7. The discriminator (``csrc/demod_kernel.cu``) at bench_all config 5 (16
   channels x 8 taps over 16 * 2^22 samples, AW=20): ``fm_demod`` on the
   chain's half spectrum and on the full one, ``cordic_atan2``
   (``atan2_fixed``) on the quantized (Q, I), and the integer entry
   (``fm_demod_phase`` and ``fm_demod_conj``) on that I/Q as the (16, T)
   transpose of its (T, 16) array and as contiguous rows, through the
   port's wrappers, the port's C entries (``fm_demod`` on both spectra,
   ``cordic_atan2``, the integer entry in the walk its wrapper picks and in
   the other) and, with ``--against DIR``, DIR's C entries (an earlier
   ``bhw_fm_demod_iq`` without a bins argument takes the full spectrum; an
   earlier ``bhw_fm_demod`` without a walk argument writes (rows, T-1));
   outputs bit-equal, one call alone and per call of 10 queued, in turns.
8. The taylor2 window (``csrc/fastwin_kernel.cu``) over 2^26 samples: BH-7
   W=32 LS=12 pw=26 (the main path's) and BH-7 W=32 LS=14 pw=32, through
   the port's wrapper, its C entry and, with ``--against DIR``, DIR's
   ``bhw_taylor2_window_block`` (an earlier one without a regime argument
   computes each sample on its own); outputs bit-equal, one call alone and
   per call of 16 queued, in turns.
9. The TAYLOR windows (``csrc/taylor_kernel.cu``) over 2^26 samples at
   pw=26, Hamming W=16 LS=10 and Blackman W=32 LS=12, under the HLS
   contract (``bhw_taylor_window_block``) and the RTL one
   (``bhw_taylor_window_rtl``): through ``make_window``, the port's C entry
   and, with ``--against DIR``, DIR's (a revision without the RTL entry
   gives the HLS one only); outputs bit-equal to ``make_window``'s, one call
   alone and per call of 16 queued, in turns; and the host time per call of
   the RTL Blackman ``make_window``, its wrapper, its C entry and each of
   the wrapper's steps alone.

``--only materialize|window|welch|taylor|outer|ddc|demod|taylor2|taylor_window`` runs one
section.  Prints
one line per measurement with the card's name and power limit, and
as its last line one JSON object with every time (ms, median over the
rounds).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

from chip_smoke import _device_ms, _library_outer


def _build_one(root: Path, source: str, tag: str):
    """The kernel library of one ``csrc`` source under ``root``, built alone
    into this checkout's build directory, its entry points bound with the
    port's signatures."""
    from blackman_harris_win_tpu_torch import _build

    src = root / "blackman_harris_win_tpu_torch" / "csrc" / source
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{Path(source).stem}_{tag}.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-shared", "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    for name, args in _build._SIGNATURES.items():
        if hasattr(dll, name):
            getattr(dll, name).argtypes = list(args)
            getattr(dll, name).restype = ctypes.c_int
    return dll


def _build_other(root: Path):
    """``bhw_materialize`` of the ``csrc/barrier_kernel.cu`` under ``root``."""
    return _build_one(root, "barrier_kernel.cu", "other").bhw_materialize


def _event_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _host_us(fn, calls: int = 50) -> float:
    """Host time per call of ``fn`` in microseconds: ``calls`` calls on
    the host clock, the device work they queue finished outside it."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _in_turns(fns: dict, rounds: int, measure) -> dict:
    """Median of ``measure(fn)`` for each function, taken in turns: every
    round measures each once, the order reversed every other round."""
    for fn in fns.values():
        fn()
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(measure(fns[k]))
    return {k: float(np.median(v)) for k, v in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--only", choices=tuple(SECTIONS), default=None,
                    help="run one section (default: all)")
    ap.add_argument("--against", type=Path, default=None,
                    help="a checkout of another revision whose materialize, welch_stage1, "
                         "taylor_checksum, outer, DDC mixer, discriminator, taylor2 and "
                         "TAYLOR window kernels are timed beside the port's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    from blackman_harris_win_tpu_torch import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    label = f"[{smi.splitlines()[0]}]"
    print(smi.splitlines()[0])
    _build.lib()
    result = {"device": smi.splitlines()[0]}

    stream = _build.stream_of(dev)
    for name, section in SECTIONS.items():
        if args.only in (None, name):
            section(args, dev, label, stream, result)
    print(json.dumps(result))
    return 0


def _probe_materialize(args, dev, label, stream, result) -> None:
    """Section 1: the copy on a (2, 2^26) float32 array."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels.barrier import materialize

    x = torch.randn(2, 1 << 26, device=dev)
    nbytes = x.numel() * x.element_size()
    entries = {"port, C entry": _build.lib().bhw_materialize}
    if args.against is not None:
        entries[f"{args.against.name}, C entry"] = _build_other(args.against)
    outs = {k: torch.empty_like(x) for k in entries}

    def direct(k):
        rc = entries[k](outs[k].data_ptr(), x.data_ptr(), nbytes, stream)
        if rc:
            raise RuntimeError(f"materialize {k}: CUDA error {rc}")

    fns = {"port, wrapper": lambda: materialize(x),
           **{k: (lambda k=k: direct(k)) for k in entries},
           "torch.clone": lambda: torch.clone(x)}
    bits = x.view(torch.int32)
    for k in entries:
        direct(k)
    for k, y in (("port, wrapper", materialize(x)), *outs.items()):
        if not torch.equal(y.view(torch.int32), bits):
            raise RuntimeError(f"materialize {k}: the copy differs from its input")
    bound = 2 * nbytes / 3.35e12 * 1e3
    result["materialize"] = {}
    for how, measure in (("alone", lambda f: _event_ms(f, 1)),
                         ("per call of 20 queued", lambda f: _event_ms(f, 20)),
                         ("device time", _device_ms)):
        t = _in_turns(fns, args.rounds, measure)
        for k, ms in t.items():
            print(f"time {label} materialize (2, 2^26) f32 {how}, {k}: {ms:.4f} ms, "
                  f"{2 * nbytes / ms / 1e9:.3f} TB/s, {bound / ms:.1%} of the {bound:.4f} ms bound")
        result["materialize"][how] = t
    # the host's share of a call alone: each step of the wrapper by itself
    def device_ctx():
        with torch.cuda.device(dev):
            pass

    steps = {"wrapper, whole call": lambda: materialize(x),
             "C entry": lambda: direct("port, C entry"),
             "torch.clone": lambda: torch.clone(x),
             "resolve_device": lambda: _build.resolve_device(x.device),
             "torch.empty_like": lambda: torch.empty_like(x),
             "with torch.cuda.device": device_ctx,
             "stream_of": lambda: _build.stream_of(dev)}
    host = _in_turns(steps, args.rounds, _host_us)
    for k, us in host.items():
        print(f"time {label} materialize host time per call, {k}: {us:.1f} us")
    result["materialize"]["host us"] = host


def _probe_window(args, dev, label, stream, result) -> None:
    """Section 2: the window kernel's datapaths at 2^26 samples."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import window_kernel as wk
    from blackman_harris_win_tpu_torch.kernels.window import rtl_cordic_coeffs
    from blackman_harris_win_tpu_torch.windows import catalog

    lib = _build.lib()
    n = 1 << 26
    q7, q4 = catalog.get("bh7").quantized(32), catalog.get("bh4").quantized(17)
    cfgs = {
        "hls bh7 w32 pw26 wrap": (q7, WindowSpec(26, 32, overflow="wrap")),
        "rtl bh7 w32 p1 pw26": (rtl_cordic_coeffs(q7),
                                WindowSpec(26, 32, rounding="rtl", overflow="wrap")),
        "hls bh4 w17 pw26 saturate": (q4, WindowSpec(26, 17, overflow="saturate")),
    }
    result["window_block"] = {}
    for label_cfg, (q, spec) in cfgs.items():
        own = wk._datapath(spec)
        coeffs, lut, gain = wk._kernel_params(q, spec)
        forced = torch.empty(n, dtype=torch.int32, device=dev)

        def run_i64():
            rc = lib.bhw_window_block(
                forced.data_ptr(), 0, n, coeffs.ctypes.data, len(coeffs), lut.ctypes.data,
                len(lut), gain, spec.phase_width, spec.data_width, spec.precision,
                int(spec.rounding == "rtl"), int(spec.overflow == "saturate"),
                wk._DATAPATHS.index("i64"), stream)
            if rc:
                raise RuntimeError(f"window_block i64: CUDA error {rc}")

        run_i64()
        mine = wk.window_block(q, spec, 0, n, dev)
        torch.cuda.synchronize()
        if not torch.equal(mine, forced):
            raise RuntimeError(f"window {label_cfg}: {own} and i64 datapaths differ")
        tw = _in_turns({own: lambda: wk.window_block(q, spec, 0, n, dev), "i64": run_i64},
                       max(4, args.rounds // 2), lambda f: _event_ms(f, 3))
        for k, ms in tw.items():
            print(f"time {label} window_block {label_cfg} datapath {k}: {ms:.3f} ms")
        result["window_block"][label_cfg] = tw


def _probe_welch(args, dev, label, stream, result) -> None:
    """Section 3: the stage-1 kernel, the port's beside DIR's."""
    import torch

    from blackman_harris_win_tpu_torch.kernels import welchfft_kernel as wf

    nfft, nsamp = 1 << 20, 128 << 20
    x = torch.randn(nsamp, device=dev)
    win = torch.from_numpy(np.hanning(nfft).astype(np.float32)).to(dev)
    ref_r, ref_i, nf = wf.welch_stage1_fused(x, win, nfft)
    fns = {"port, wrapper": lambda: wf.welch_stage1_fused(x, win, nfft)}
    if args.against is not None:
        fn = _build_one(args.against, "welchfft_kernel.cu", "other").bhw_welch_stage1
        # DIR's kernel takes the FFT-128 roots (as the port's) or, before the
        # FFT-128, the direct DFT matrix
        src = (args.against / "blackman_harris_win_tpu_torch" / "csrc"
               / "welchfft_kernel.cu").read_text()
        m0r, m0i, t1r, t1i = (wf._kernel_tables_on(nfft, dev) if "roots_r" in src
                              else wf._tables_on(nfft, 128, dev))
        out_r, out_i = torch.empty_like(ref_r), torch.empty_like(ref_i)

        def other():
            rc = fn(x.data_ptr(), nsamp, win.data_ptr(), m0r.data_ptr(), m0i.data_ptr(),
                    t1r.data_ptr(), t1i.data_ptr(), out_r.data_ptr(), out_i.data_ptr(), nfft,
                    ref_r.shape[0], nf % 2, stream)
            if rc:
                raise RuntimeError(f"welch_stage1 {args.against.name}: CUDA error {rc}")

        other()
        scale = float(torch.maximum(ref_r.abs().max(), ref_i.abs().max()))
        err = float(torch.maximum((out_r - ref_r).abs().max(), (out_i - ref_i).abs().max()))
        if err / scale >= 1e-5:
            raise RuntimeError(f"welch_stage1: port and {args.against.name} differ by {err}")
        fns[f"{args.against.name}, C entry"] = other
    bound = (4 * nsamp + 4 * nfft + 8 * ref_r.numel()) / 3.35e12 * 1e3
    t = _in_turns(fns, args.rounds, lambda f: _event_ms(f, 1))
    for k, ms in t.items():
        print(f"time {label} welch_stage1 nfft 2^20, {nf} frames, {k}: {ms:.4f} ms, "
              f"{bound / ms:.1%} of the {bound:.4f} ms bytes bound")
    host = _in_turns({"port, wrapper": fns["port, wrapper"]}, args.rounds,
                     lambda f: _host_us(f, 20))
    print(f"time {label} welch_stage1 host time per call, port, wrapper: "
          f"{host['port, wrapper']:.1f} us")
    result["welch_stage1"] = {**t, "host us": host}


def _probe_taylor(args, dev, label, stream, result) -> None:
    """Section 4: the Taylor checksum, the port's beside DIR's."""
    import torch

    from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk

    from blackman_harris_win_tpu_torch import _build

    pw, n = 26, 1 << 26
    libs = {"port, C entry": _build.lib()}
    if args.against is not None:
        libs[f"{args.against.name}, C entry"] = _build_one(args.against, "taylor_kernel.cu",
                                                            "other")
    result["taylor_checksum"] = {}
    for w, ls in ((16, 10), (32, 12)):
        rom = tk._rom_on(ls, w, dev)
        want = int(tk.checksum_range(5, n - 9, pw, w, ls, 0, dev))
        outs = {k: torch.zeros((), dtype=torch.int32, device=dev) for k in libs}

        def entry(k, w=w, ls=ls, rom=rom):
            rc = libs[k].bhw_taylor_checksum(outs[k].data_ptr(), 5, n - 9, rom.data_ptr(), pw,
                                             w, ls, tk._ramb(pw, ls), stream)
            if rc:
                raise RuntimeError(f"taylor_checksum {k}: CUDA error {rc}")

        for k in libs:
            entry(k)
            if int(outs[k]) != want:
                raise RuntimeError(f"taylor_checksum {k}: {int(outs[k])} != {want}")
        fns = {"port, wrapper": lambda w=w, ls=ls: tk.checksum_range(5, n - 9, pw, w, ls, 0, dev),
               **{k: (lambda k=k: entry(k)) for k in libs}}
        t = _in_turns(fns, args.rounds, lambda f: _event_ms(f, 16))
        for k, ms in t.items():
            print(f"time {label} taylor_checksum W={w} LS={ls} 2^26, per call of 16 queued, "
                  f"{k}: {ms:.4f} ms")
        host = _in_turns(fns, args.rounds, lambda f: _host_us(f, 16))
        for k, us in host.items():
            print(f"time {label} taylor_checksum W={w} LS={ls} host time per call, {k}: "
                  f"{us:.1f} us")
        result["taylor_checksum"][f"w{w}"] = {**t, "host us": host}


def _probe_outer(args, dev, label, stream, result) -> None:
    """Section 5: the int, f32 and comp outer kernels (write-out and
    checksum) at the main path's shapes (BH-7, pw=26, m=11) through their C
    entries, beside DIR's and beside the PyTorch calls that compute the same
    float windows (``chip_smoke._library_outer``); every output compared
    first."""
    import re

    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
    from blackman_harris_win_tpu_torch.kernels.compwin import DEFAULT_THRESH, GRID_BITS
    from blackman_harris_win_tpu_torch.kernels.floatwin import _resolve_coeffs
    from blackman_harris_win_tpu_torch.windows import catalog

    pw, m = 26, 11
    nh, nl = 1 << (pw - m), 1 << m
    coeffs = _resolve_coeffs("bh7")
    tiles = {"int": ok._int_tiles(catalog.get("bh7").quantized(32),
                                  WindowSpec(pw, 32, overflow="wrap"), m, dev),
             "f32": ok._f32_tiles(coeffs, pw, m, dev),
             "comp": ok._comp_tiles(coeffs, pw, m, GRID_BITS, DEFAULT_THRESH, dev)}
    libs = {"port, C entry": _build.lib()}
    old_query = False
    if args.against is not None:
        src = args.against / "blackman_harris_win_tpu_torch" / "csrc" / "outerwin_kernel.cu"
        other = _build_one(args.against, "outerwin_kernel.cu", "other")
        # the geometry queries took (rows, nl) before the float kernels took
        # their own launch geometry
        sig = re.search(r"bhw_outer_npartials\(([^)]*)\)", src.read_text())
        old_query = sig is not None and sig.group(1).count(",") == 1
        for q in ("bhw_outer_npartials", "bhw_outer_checksum_depth"):
            fn = getattr(other, q)
            fn.argtypes = ([ctypes.c_longlong, ctypes.c_int] if old_query
                           else list(_build._QUERIES[q][0]))
            fn.restype = ctypes.c_longlong
        libs[f"{args.against.name}, C entry"] = other

    def query(lib, q, t):
        if old_query and lib is not libs["port, C entry"]:
            return getattr(lib, q)(nh, nl)
        return getattr(lib, q)(t.mode, nh, nl, t.nk, t.npl)

    lib_f32, lib_comp = _library_outer("bh7", pw, m, dev)
    library = {"f32": ("torch.addmm", lib_f32), "comp": ("torch.baddbmm", lib_comp)}
    result["outer"] = {}
    for mode, t in tiles.items():
        c_args = ok._c_args(t, 0, nh)
        comp, integer = mode == "comp", mode == "int"
        dt = torch.int32 if integer else torch.float32
        outs = {k: torch.empty(2 if comp else 1, nh * nl, dtype=dt, device=dev) for k in libs}
        # the int checksum adds onto *out: zero it for the comparison
        sums = {k: torch.zeros((), dtype=dt, device=dev) for k in libs}
        parts = {k: torch.empty(query(lib, "bhw_outer_npartials", t), device=dev)
                 for k, lib in libs.items()}

        name = "" if integer else f"_{mode}"

        def block(k):
            o = outs[k]
            rc = libs[k].bhw_outer_block(t.mode, o[0].data_ptr(), o[1].data_ptr() if comp else None,
                                         *c_args, stream)
            if rc:
                raise RuntimeError(f"outer_block{name} {k}: CUDA error {rc}")

        def checksum(k):
            rc = libs[k].bhw_outer_checksum(t.mode, sums[k].data_ptr(),
                                            parts[k].data_ptr() if parts[k].numel() else None,
                                            parts[k].numel(), 0, *c_args, stream)
            if rc:
                raise RuntimeError(f"outer_checksum{name} {k}: CUDA error {rc}")

        ref = "port, C entry"
        for k in libs:
            block(k)
            checksum(k)
        blocks = {k: (lambda k=k: block(k)) for k in libs}
        if integer:
            want = int(outs[ref].sum(dtype=torch.int64)) & 0xFFFFFFFF
            want -= (want >> 31) << 32
            for k in libs:
                if not torch.equal(outs[k], outs[ref]) or int(sums[k]) != want:
                    raise RuntimeError(f"outer int {k}: differs from the port's")
            print(f"outer int bh7 pw26 m11: write-outs and checksums of {', '.join(libs)} "
                  "equal")
        else:
            call, lib_fn = library[mode]
            want = lib_fn().view(2 if comp else 1, -1)
            bound = ok.comp_e_bound("bh7") if comp else ok.f32_pair_bound("bh7")
            sum_abs = float(outs[ref].double().abs().sum())
            for k, o in [*outs.items(), (call, want)]:
                if comp and not torch.equal(o[0], outs[ref][0]):
                    raise RuntimeError(f"outer_block_comp {k}: s differs from the port's")
                err = float((o[-1] - outs[ref][-1]).abs().max())
                if err > 2 * bound:  # each within its bound of the plain version
                    raise RuntimeError(f"outer_block_{mode} {k}: {err} from the port's")
            for k in libs:
                depth = query(libs[k], "bhw_outer_checksum_depth", t)
                diff = float((outs[k] - outs[ref]).double().abs().sum())
                tol = 2 * ok.sum_bound(max(depth, query(libs[ref], "bhw_outer_checksum_depth",
                                                        t)), sum_abs) + diff
                if abs(float(sums[k]) - float(sums[ref])) > tol:
                    raise RuntimeError(f"outer_checksum_{mode} {k}: {float(sums[k])} vs "
                                       f"{float(sums[ref])} (> {tol})")
            print(f"outer {mode} bh7 pw26 m11: write-outs and checksums of "
                  f"{', '.join(libs)} and {call} agree")
            blocks[call] = lib_fn
        result["outer"][mode] = {}
        for kind, fns in (("block", blocks),
                          ("checksum", {k: (lambda k=k: checksum(k)) for k in libs})):
            for how, measure in (("alone", lambda f: _event_ms(f, 1)),
                                 ("per call of 16 queued", lambda f: _event_ms(f, 16))):
                tt = _in_turns(fns, args.rounds, measure)
                for k, ms in tt.items():
                    print(f"time {label} outer_{kind}{name} bh7 2^26 {how}, {k}: {ms:.4f} ms")
                result["outer"][mode][f"{kind} {how}"] = tt

def _other_source(args, source: str) -> str:
    return (args.against / "blackman_harris_win_tpu_torch" / "csrc" / source).read_text()


def _probe_ddc(args, dev, label, stream, result) -> None:
    """Section 6: the DDC mixer on each of its paths, the port's beside
    DIR's."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import ddc_kernel as dk

    from chip_smoke import DDC_PATHS

    t, w = 1 << 26, 16
    x = torch.rand(t, device=dev) * 2 - 1
    other = with_table = None
    if args.against is not None:
        other = _build_one(args.against, "ddc_kernel.cu", "other")
        with_table = "bhw_ddc_nco_table" in _other_source(args, "ddc_kernel.cu")
        if not with_table:  # out, x, rows, t, n0, period, (NCO), scale, raw, stream
            other.bhw_ddc_mixer.argtypes = list(_build._SIGNATURES["bhw_ddc_mixer"][:17]) + [
                ctypes.c_void_p]
    result["ddc_mixer"] = {}
    cases = [(what, fw, pw, "dds48") for what, fw, pw in DDC_PATHS]
    cases.insert(1, (DDC_PATHS[0][0] + ", scaled", DDC_PATHS[0][1], DDC_PATHS[0][2], "scaled"))
    for what, fw, pw, flavor in cases:
        fns = {"port, wrapper": lambda fw=fw, pw=pw, flavor=flavor: dk.mixer(x, fw, pw, w,
                                                                             flavor)}
        want = fns["port, wrapper"]()
        if other is not None:
            nco, _lut = dk._check_widths(fw, pw, w, flavor)
            out = torch.empty_like(want)
            p = dk.table_period(fw, pw, t) if with_table else 0
            table = torch.empty((max(p, 1), 2), dtype=torch.int32, device=dev)

            def theirs(nco=nco, out=out, p=p, table=table, _lut=_lut):
                if p:
                    rc = other.bhw_ddc_nco_table(table.data_ptr(), p, *nco, stream)
                    if rc:
                        raise RuntimeError(f"ddc_nco_table {args.against.name}: error {rc}")
                tab = (table.data_ptr() if p else None, p) if with_table else ()
                rc = other.bhw_ddc_mixer(out.data_ptr(), x.data_ptr(), 1, t, 0, 0, *nco,
                                         dk.mixer_scale(w), 0, *tab, stream)
                if rc:
                    raise RuntimeError(f"ddc_mixer {args.against.name}: CUDA error {rc}")

            theirs()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"ddc_mixer {what}: {args.against.name} differs from the port")
            fns[f"{args.against.name}, C entry"] = theirs
        result["ddc_mixer"][what] = {}
        for how, measure in (("alone", lambda f: _event_ms(f, 1)),
                             ("per call of 16 queued", lambda f: _event_ms(f, 16))):
            tt = _in_turns(fns, args.rounds, measure)
            ratio = ""
            if len(tt) == 2:
                a, b = tt.values()
                ratio = f"; {b / a:.3f}x"
            print(f"time {label} ddc_mixer {flavor} {what} (fw {fw}) 2^26 {how}: " + ", ".join(
                f"{k} {ms:.4f} ms" for k, ms in tt.items()) + ratio)
            result["ddc_mixer"][what][how] = tt


def _probe_demod(args, dev, label, stream, result) -> None:
    """Section 7: the discriminator and the elementwise atan2 at config 5,
    the port's beside DIR's."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import demod_kernel as dmk
    from blackman_harris_win_tpu_torch.kernels.cordic import atan2_fixed
    from blackman_harris_win_tpu_torch.pipeline.channelizer import (
        channel_bins,
        design_prototype,
        polyphase_channelize,
    )

    c, aw = 16, 20
    proto = design_prototype(c, 8)
    x = torch.randn(c << 22, device=dev)
    y, yh = polyphase_channelize(x, proto, c), channel_bins(x, proto, c)
    i = torch.round(y.real * 2.0**14).to(torch.int32)
    q = torch.round(y.imag * 2.0**14).to(torch.int32)
    want = dmk.iq_demod(y, aw)
    fns = {"port, half spectrum": lambda: dmk.iq_demod(yh, aw, n_channels=c),
           "port, full spectrum": lambda: dmk.iq_demod(y, aw)}
    if not torch.equal(fns["port, half spectrum"](), want):
        raise RuntimeError("fm_demod: the half- and full-spectrum entries differ")
    ang = atan2_fixed(q, i, 16, aw)
    afns = {"port, wrapper": lambda: atan2_fixed(q, i, 16, aw)}
    # the port's C entries with no Python around them, beside DIR's
    drop, shift = dmk.conj_shifts(dmk.IQ_WIDTH, aw)
    lut = dmk.atan2_lut(aw, 1)
    pout, paout, nf, c_bins = torch.empty_like(want), torch.empty_like(ang), y.shape[0], yh.shape[-1]

    def port_iq(src, bins):
        def call():
            rc = _build.lib().bhw_fm_demod_iq(pout.data_ptr(), src.data_ptr(), 1, nf, c, bins, 8,
                                              2.0**14, lut.ctypes.data, aw, drop, shift, stream)
            if rc:
                raise RuntimeError(f"fm_demod port: CUDA error {rc}")
        return call

    def port_atan2():
        rc = _build.lib().bhw_cordic_atan2(paout.data_ptr(), q.data_ptr(), i.data_ptr(), q.numel(),
                                           4, lut.ctypes.data, aw, 1, 16, 1, stream)
        if rc:
            raise RuntimeError(f"cordic_atan2 port: CUDA error {rc}")

    yhc = yh.contiguous()
    for name, call in (("port, C entry, half spectrum", port_iq(yhc, c_bins)),
                       ("port, C entry, full spectrum", port_iq(y.contiguous(), c))):
        call()
        if not torch.equal(pout, want):
            raise RuntimeError(f"fm_demod {name} differs from the wrapper")
        fns[name] = call
    port_atan2()
    if not torch.equal(paout, ang):
        raise RuntimeError("cordic_atan2 port, C entry differs from the wrapper")
    afns["port, C entry"] = port_atan2
    other = None
    if args.against is not None:
        other = _build_one(args.against, "demod_kernel.cu", "other")
        with_bins = "bins" in _other_source(args, "demod_kernel.cu")
        if not with_bins:  # out, y, batches, nf, c, elem, iq_scale, lut, aw, drop, shift, stream
            sig = list(_build._SIGNATURES["bhw_fm_demod_iq"])
            other.bhw_fm_demod_iq.argtypes = sig[:5] + sig[6:]
        out, aout = torch.empty_like(want), torch.empty_like(ang)

        def theirs():
            bins = (c,) if with_bins else ()
            rc = other.bhw_fm_demod_iq(out.data_ptr(), y.data_ptr(), 1, nf, c, *bins, 8,
                                       2.0**14, lut.ctypes.data, aw, drop, shift, stream)
            if rc:
                raise RuntimeError(f"fm_demod {args.against.name}: CUDA error {rc}")

        def theirs_atan2():
            rc = other.bhw_cordic_atan2(aout.data_ptr(), q.data_ptr(), i.data_ptr(), q.numel(),
                                        4, lut.ctypes.data, aw, 1, 16, 1, stream)
            if rc:
                raise RuntimeError(f"cordic_atan2 {args.against.name}: CUDA error {rc}")

        theirs()
        theirs_atan2()
        if not torch.equal(out, want) or not torch.equal(aout, ang):
            raise RuntimeError(f"demod: {args.against.name} differs from the port")
        fns[f"{args.against.name}, full spectrum"] = theirs
        afns[f"{args.against.name}, C entry"] = theirs_atan2
    result["fm_demod"], result["cordic_atan2"] = {}, {}
    for name, group in (("fm_demod", fns), ("cordic_atan2", afns)):
        tt = _in_turns(group, args.rounds, lambda f: _event_ms(f, 1))
        tq = _in_turns(group, args.rounds, lambda f: _event_ms(f, 10))
        print(f"time {label} {name} config 5 {tuple(y.shape)} one call alone: " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in tt.items()) + "; per call of 10 queued: " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in tq.items()))
        result[name] = {"alone": tt, "queued": tq}
    _probe_demod_int(args, dev, label, stream, result, i, q, aw, other)


def _probe_demod_int(args, dev, label, stream, result, i, q, aw, other) -> None:
    """Section 7, the integer entry: both modes on config 5's (T, 16) int32
    I/Q read as its (16, T) transpose (phase 8's call) and as contiguous
    rows, the port's wrapper beside its C entry in the other walk and DIR's
    C entry (``other``: DIR's library, or None)."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import demod_kernel as dmk

    with_walk = None
    if other is not None:
        with_walk = "int walk" in _other_source(args, "demod_kernel.cu")
        if not with_walk:  # the signature less its walk argument
            sig = list(_build._SIGNATURES["bhw_fm_demod"])
            other.bhw_fm_demod.argtypes = sig[:16] + sig[17:]
    lut = dmk.atan2_lut(aw, 1)
    result["fm_demod int"] = {}
    for layout, (ii, qq) in (("transposed", (i.mT, q.mT)),
                             ("contiguous", (i.mT.contiguous(), q.mT.contiguous()))):
        rows, t = ii.shape
        for mode in ("phase", "conj"):
            fns = {"port, wrapper": lambda ii=ii, qq=qq, mode=mode: dmk.fm_demod(ii, qq, 16, aw,
                                                                                mode)}
            want = fns["port, wrapper"]()
            # the port's C entry in the walk the wrapper does not pick for
            # this layout, its output in that walk's memory order
            drop, shift = dmk.conj_shifts(16, aw) if mode == "conj" else (0, 0)
            other_walk = "t" if dmk.walk_of(rows, ii.stride(), qq.stride()) == "rows" else "rows"
            omem, oout = dmk.demod_output(want.shape, other_walk, dev)

            def port_other(ii=ii, qq=qq, mode=mode, omem=omem, drop=drop, shift=shift,
                           walk=other_walk):
                rc = _build.lib().bhw_fm_demod(
                    omem.data_ptr(), ii.data_ptr(), qq.data_ptr(), rows, t, *ii.stride(),
                    *qq.stride(), 4, dmk.MODES.index(mode), lut.ctypes.data, aw, 16, drop, shift,
                    dmk.WALKS.index(walk), stream)
                if rc:
                    raise RuntimeError(f"fm_demod port, walk {walk}: CUDA error {rc}")

            port_other()
            if not torch.equal(oout, want):
                raise RuntimeError(f"fm_demod {mode} {layout}: the walk {other_walk} differs")
            own_walk = "rows" if other_walk == "t" else "t"
            pmem, pout = dmk.demod_output(want.shape, own_walk, dev)

            def port_own(ii=ii, qq=qq, mode=mode, pmem=pmem, drop=drop, shift=shift,
                         walk=own_walk):
                rc = _build.lib().bhw_fm_demod(
                    pmem.data_ptr(), ii.data_ptr(), qq.data_ptr(), rows, t, *ii.stride(),
                    *qq.stride(), 4, dmk.MODES.index(mode), lut.ctypes.data, aw, 16, drop, shift,
                    dmk.WALKS.index(walk), stream)
                if rc:
                    raise RuntimeError(f"fm_demod port, walk {walk}: CUDA error {rc}")

            port_own()
            if not torch.equal(pout, want):
                raise RuntimeError(f"fm_demod {mode} {layout}: the port's C entry differs")
            fns["port, C entry"] = port_own
            fns[f"port, C entry, walk {other_walk}"] = port_other
            if other is not None:
                walk = dmk.walk_of(rows, ii.stride(), qq.stride()) if with_walk else "t"
                mem, out = dmk.demod_output(want.shape, walk, dev)
                tail = (dmk.WALKS.index(walk),) if with_walk else ()

                def theirs(ii=ii, qq=qq, mode=mode, mem=mem, drop=drop, shift=shift, tail=tail):
                    rc = other.bhw_fm_demod(mem.data_ptr(), ii.data_ptr(), qq.data_ptr(), rows, t,
                                            *ii.stride(), *qq.stride(), 4, dmk.MODES.index(mode),
                                            lut.ctypes.data, aw, 16, drop, shift, *tail, stream)
                    if rc:
                        raise RuntimeError(f"fm_demod {args.against.name}: CUDA error {rc}")

                theirs()
                if not torch.equal(out, want):
                    raise RuntimeError(f"fm_demod {mode} {layout}: {args.against.name} differs")
                fns[f"{args.against.name}, C entry"] = theirs
            tt = _in_turns(fns, args.rounds, lambda f: _event_ms(f, 1))
            tq = _in_turns(fns, args.rounds, lambda f: _event_ms(f, 10))
            ratio = ""
            if other is not None:  # DIR's C entry against the port's, in the same walk
                k = f"{args.against.name}, C entry"
                ratio = (f"; {k} / port, C entry: {tt[k] / tt['port, C entry']:.3f}x alone, "
                         f"{tq[k] / tq['port, C entry']:.3f}x queued")
            print(f"time {label} fm_demod {mode} int32 {layout} {tuple(ii.shape)} one call "
                  "alone: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in tt.items())
                  + "; per call of 10 queued: " + ", ".join(
                      f"{k} {ms:.4f} ms" for k, ms in tq.items()) + ratio)
            result["fm_demod int"][f"{mode} {layout}"] = {"alone": tt, "queued": tq}


def _probe_taylor2(args, dev, label, stream, result) -> None:
    """Section 8: the taylor2 window over 2^26 samples, the port's beside
    DIR's."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import fastwin_kernel as fk
    from blackman_harris_win_tpu_torch.kernels.fastwin import _phase_consts
    from blackman_harris_win_tpu_torch.windows import catalog

    n = 1 << 26
    libs = {"port, C entry": _build.lib()}
    with_regime = {"port, C entry": True}
    if args.against is not None:
        k = f"{args.against.name}, C entry"
        libs[k] = _build_one(args.against, "fastwin_kernel.cu", "other")
        with_regime[k] = "int regime" in _other_source(args, "fastwin_kernel.cu")
        if not with_regime[k]:  # the signature less its regime argument
            sig = list(_build._SIGNATURES["bhw_taylor2_window_block"])
            libs[k].bhw_taylor2_window_block.argtypes = sig[:12] + sig[13:]
    result["taylor2_window_block"] = {}
    q = catalog.get("bh7").quantized(32)
    cbuf = np.asarray(q, np.int32)
    for pw, ls in ((26, 12), (32, 14)):
        spec = WindowSpec(pw, 32, sin_type="taylor2", lut_size=ls, overflow="wrap")
        rom = fk._rom_on(ls, 32, dev)
        _, p_hi, p_lo, _ = _phase_consts(pw, ls)
        regime = fk.REGIMES.index(fk.walk_regime(pw, ls, len(q)))
        want = fk.window_block(q, spec, 0, n, dev)
        outs = {k: torch.empty_like(want) for k in libs}

        def entry(k, rom=rom, pw=pw, ls=ls, p_hi=p_hi, p_lo=p_lo, regime=regime):
            tail = (regime,) if with_regime[k] else ()
            rc = libs[k].bhw_taylor2_window_block(outs[k].data_ptr(), 0, n, rom.data_ptr(), pw,
                                                  32, ls, cbuf.ctypes.data, len(q), p_hi, p_lo,
                                                  0, *tail, stream)
            if rc:
                raise RuntimeError(f"taylor2_window_block {k}: CUDA error {rc}")

        for k in libs:
            entry(k)
            if not torch.equal(outs[k], want):
                raise RuntimeError(f"taylor2_window_block pw={pw} LS={ls}: {k} differs")
        fns = {"port, wrapper": lambda spec=spec: fk.window_block(q, spec, 0, n, dev),
               **{k: (lambda k=k: entry(k)) for k in libs}}
        what = f"bh7 w32 ls{ls} pw{pw} ({fk.REGIMES[regime]})"
        result["taylor2_window_block"][what] = {}
        for how, measure in (("alone", lambda f: _event_ms(f, 1)),
                             ("per call of 16 queued", lambda f: _event_ms(f, 16))):
            tt = _in_turns(fns, args.rounds, measure)
            ratio = ""
            if len(tt) == 3:
                b = list(tt.values())
                ratio = f"; {b[2] / b[1]:.3f}x"
            print(f"time {label} taylor2_window_block {what} 2^26 {how}: " + ", ".join(
                f"{k} {ms:.4f} ms" for k, ms in tt.items()) + ratio)
            result["taylor2_window_block"][what][how] = tt


def _probe_taylor_window(args, dev, label, stream, result) -> None:
    """Section 9: the TAYLOR windows under both contracts, the port's beside
    DIR's."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
    from blackman_harris_win_tpu_torch.kernels.window import make_window
    from blackman_harris_win_tpu_torch.windows import catalog

    pw, n = 26, 1 << 26
    libs = {"port": _build.lib()}
    if args.against is not None:
        libs[args.against.name] = _build_one(args.against, "taylor_kernel.cu", "other")
    result["taylor_window"] = {}
    for name, w, ls in (("hamming", 16, 10), ("blackman", 32, 12)):
        cbuf = np.asarray(catalog.get(name).quantized(w), np.int64)
        rom = tk._rom_on(ls, w, dev)
        for rounding, entry, extra in (("hls", "bhw_taylor_window_block", (0,)),
                                       ("rtl", "bhw_taylor_window_rtl", ())):
            spec = WindowSpec(pw, w, sin_type="taylor", rounding=rounding, lut_size=ls,
                              overflow="wrap")
            want = make_window(name, spec, device=dev)
            fns = {"port, make_window": lambda s=spec, nm=name: make_window(nm, s, device=dev)}
            for k, lib in libs.items():
                if not hasattr(lib, entry):  # a revision before the RTL kernel
                    continue
                out = torch.empty(n, dtype=torch.int32, device=dev)

                def call(lib=lib, out=out, entry=entry, extra=extra, w=w, ls=ls, rom=rom,
                         cbuf=cbuf, k=k):
                    rc = getattr(lib, entry)(out.data_ptr(), 0, n, rom.data_ptr(), pw, w, ls,
                                             cbuf.ctypes.data, len(cbuf), tk._ramb(pw, ls),
                                             tk._ramb(pw - 1, ls), *extra, stream)
                    if rc:
                        raise RuntimeError(f"{entry} {k}: CUDA error {rc}")

                call()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{entry} {k}: differs from make_window")
                fns[f"{k}, C entry"] = call
            what = f"{name} W={w} LS={ls} {rounding}"
            alone = _in_turns(fns, args.rounds, lambda f: _event_ms(f, 1))
            queued = _in_turns(fns, args.rounds, lambda f: _event_ms(f, 16))
            for k in fns:
                print(f"time {label} taylor_window {what} 2^26, {k}: {alone[k]:.4f} ms one "
                      f"call alone, {queued[k]:.4f} ms per call of 16 queued")
            result["taylor_window"][what] = {"alone": alone, "queued": queued}
    _probe_window_host(dev, label, stream, result)


def _probe_window_host(dev, label, stream, result) -> None:
    """Section 9, the host side of one RTL Blackman W=32 call: host time per
    call of ``make_window``, of the wrapper and of its C entry, and of the
    wrapper's steps alone (the coefficients' quantization and the launch
    constants uncached, as a first call takes them), each call's device work
    finished outside the clock."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
    from blackman_harris_win_tpu_torch.kernels.window import make_window
    from blackman_harris_win_tpu_torch.windows import catalog

    pw, w, ls, n = 26, 32, 12, 1 << 26
    spec = WindowSpec(pw, w, sin_type="taylor", rounding="rtl", lut_size=ls, overflow="wrap")
    q = catalog.get("blackman").quantized(w)
    cbuf = np.asarray(q, np.int64)
    rom, out, lib = tk._rom_on(ls, w, dev), torch.empty(n, dtype=torch.int32, device=dev), _build.lib()

    def entry():
        lib.bhw_taylor_window_rtl(out.data_ptr(), 0, n, rom.data_ptr(), pw, w, ls,
                                  cbuf.ctypes.data, len(q), tk._ramb(pw, ls),
                                  tk._ramb(pw - 1, ls), stream)

    def device_and_stream():
        with torch.cuda.device(dev):
            _build.stream_of(dev)

    pieces = {
        "make_window": lambda: make_window("blackman", spec, device=dev),
        "window_rtl_block (the wrapper)": lambda: tk.window_rtl_block(q, spec, 0, n, dev),
        "the C entry through ctypes": entry,
        "quantized coefficients, uncached": lambda: catalog.get("blackman").quantized(w),
        "_window_consts, uncached (validation, int64 buffer, tay1 constants)":
            lambda: tk._window_consts.__wrapped__(tuple(q), spec),
        "torch.empty of the output": lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "torch.cuda.device and the stream": device_and_stream,
        "resolve_device": lambda: _build.resolve_device(dev),
    }
    result["taylor_window_host_us"] = {}
    for k, fn in pieces.items():
        us = _host_us(fn)
        result["taylor_window_host_us"][k] = us
        print(f"host {label} taylor_window blackman W=32 LS=12 rtl, {k}: {us:.1f} us a call")


SECTIONS = {"materialize": _probe_materialize, "window": _probe_window,
            "welch": _probe_welch, "taylor": _probe_taylor, "outer": _probe_outer,
            "ddc": _probe_ddc, "demod": _probe_demod, "taylor2": _probe_taylor2,
            "taylor_window": _probe_taylor_window}


if __name__ == "__main__":
    sys.exit(main())
