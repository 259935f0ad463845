"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from ``blackman_harris_win_tpu_torch/csrc``
(nvcc, sm_90a), then drives the main path once through the entry points a
user calls, at the repository's real sizes:

1. generation at the bench configuration: the 2^26-point BH-7 window at
   W=32 (HLS contract, wrap) written out (kernel 1a), and its int32-wrap
   checksum over four periods (kernel 1b, the window never stored);
2. the same window under the RTL (VHDL) rounding contract (kernel 1a);
3. the Welch analyzer: BH-4 W=17 pw=20 saturate window, nfft = 2^20,
   hop = 2^19, over 128 * 2^20 float32 samples, fft_mode="mxu" (kernel 1a
   for the window, kernel 2 for framing + window + DFT stage 1);
4. the outer-product fast modes at the bench_all size (BH-7, W=32, pw=26,
   wrap, m=11): the int window (outer write-out) and its in-kernel
   checksum, the float32 window and its checksum, the compensated (s, e)
   pair and its checksum;
5. the analyzer with the new window modes at the size of 3: float32 window
   (f32 outer write-out) into fft_mode="mxu" (kernel 2), and the comp pair
   (comp outer write-out) into fft_mode="rfft";
6. the TAYLOR source at the bench_all size of configs 16-18 (pw=26): the raw
   (cos, sin) engine written out at W=16/LS=10 and W=32/LS=12, the in-kernel
   checksum of each (rows=64), the Blackman W=32 LS=12 wrap and Hamming W=16
   LS=10 saturate HLS windows through ``make_window`` (Taylor window
   kernel); and, in torch ops on the card (no kernel exists for them), an
   RTL-contract TAYLOR Hamming window and a taylor2 BH-7 W=32 LS=12 window.

Every kernel's launch counter is zeroed just before that run and read just
after; a kernel the path did not launch fails the run.  Then each output is
checked: generation 0-LSB against the plain PyTorch version on the CPU on
random and quadrant-seam blocks, the exact checksum identities, the float
windows against the float64 golden on every sample, the spectral floors at
pw=16, the analyzers against a float64 reference within the derived f32
budget, and each kernel against its plain version on the card.  Last, each
kernel and its plain version are timed with CUDA events (median of 5 after
a warm-up; a checksum kernel's time is per call of 16 back-to-back calls
with distinct biases).

Exits non-zero, printing no result, if torch sees no CUDA device or any
phase fails.  The last line is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists each kernel's launches, error and times.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _time_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs after one
    warm-up run."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _seam_blocks(n: int, rng) -> list[np.ndarray]:
    """Four random 4096-sample blocks and 64-sample blocks centred on the
    quadrant seams 0, N/4, N/2, 3N/4 (each covers its seam +-1 and more)."""
    blocks = [b + np.arange(4096) for b in rng.integers(0, n - 4096, size=4)]
    blocks += [(s - 32 + np.arange(64)) % n for s in (0, n // 4, n // 2, 3 * n // 4)]
    return blocks


def _gate_blocks(label, win_dev, plain, blocks):
    """0-LSB gate of a written output against ``plain(idx)``, its plain
    version on the CPU at the int64 indices ``idx``."""
    import torch

    for blk in blocks:
        idx = torch.from_numpy(blk)
        got = win_dev[idx.to(win_dev.device)].cpu()
        want = plain(idx)
        bad = blk[(got != want).numpy()]
        _require(bad.size == 0, f"{label}: differs from the plain version at "
                 f"indices {bad[:8].tolist()}")
    print(f"{label}: {len(blocks)} blocks 0-LSB equal to the CPU plain version")


def _gate_outer_blocks(label, win_dev, q, spec, m, blocks):
    """0-LSB gate of an outer-mode int window against the CPU plain version,
    row by row of 2^m samples."""
    import torch

    from blackman_harris_win_tpu_torch.kernels.outerwin_kernel import outer_block_int_plain

    for blk in blocks:
        got = win_dev[torch.from_numpy(blk).to(win_dev.device)].cpu()
        want = torch.cat([outer_block_int_plain(q, spec, m, int(h), 1)
                          for h in np.unique(blk >> m)])
        rows = np.unique(blk >> m)
        pos = np.searchsorted(rows, blk >> m) * (1 << m) + (blk & ((1 << m) - 1))
        bad = blk[(got != want[torch.from_numpy(pos)]).numpy()]
        _require(bad.size == 0, f"{label}: differs from the plain version at "
                 f"indices {bad[:8].tolist()}")
    print(f"{label}: {len(blocks)} blocks 0-LSB equal to the CPU plain version")


def _gate_float_checksum(label, fn, first, bias, plain, win_k, win_p, depth_k, depth_p):
    """Gate an f32/comp checksum kernel, at ``bias`` (``first`` is the main
    path's result) and at 0, against its plain version ``plain(b)`` on the
    same tables.  ``win_k``/``win_p`` are the write-outs of the kernel and of
    the plain version: the checksum kernel computes each sample with the
    write-out's device code, so its terms are ``win_k``'s bits.  Bounds:

    - kernel vs the float64 sum of its terms + b: sum_bound(depth_k, S_k + |b|);
    - kernel vs plain: that bound, plus sum |w_k - w_p| (measured exactly),
      plus the plain sum's own sum_bound(depth_p, S_p + |b|);
    - the float64 reductions here are each off by at most n * 2^-53 * S:
      four such terms are added as slack.

    Repeated calls must return the same bits.  Returns the largest
    |kernel - plain|."""
    import torch

    from blackman_harris_win_tpu_torch.kernels.outerwin_kernel import sum_bound

    n = sum(w.numel() for w in win_k)
    sum_k = sum(float(w.double().sum()) for w in win_k)
    abs_k = sum(float(w.double().abs().sum()) for w in win_k)
    abs_p = sum(float(w.double().abs().sum()) for w in win_p)
    diff = sum(float((a.double() - b.double()).abs().sum()) for a, b in zip(win_k, win_p))
    slack = 4 * n * 2.0**-53 * (abs_k + abs_p)
    worst = 0.0
    for b, got in ((bias, first), (0, fn(0))):
        _require(torch.equal(got, fn(b)), f"{label}: a repeated call returned other bits")
        bound_k = sum_bound(depth_k, abs_k + abs(b)) + slack
        err64 = abs(float(got) - (sum_k + b))
        _require(err64 <= bound_k, f"{label} (bias {b}) vs float64 sum of its terms: "
                 f"{err64:.3e} > {bound_k:.3e}")
        want = float(plain(b))
        tol = bound_k + diff + sum_bound(depth_p, abs_p + abs(b))
        err = abs(float(got) - want)
        _require(err <= tol, f"{label} (bias {b}) {float(got)!r} vs plain {want!r}: "
                 f"{err:.3e} > {tol:.3e}")
        print(f"{label} (bias {b}): {float(got)!r}; vs float64 sum {err64:.3e} "
              f"(<= gamma({depth_k}) x (sum|w| + |b|) = {bound_k:.3e}); vs plain {want!r}: "
              f"{err:.3e} (<= {bound_k:.3e} + sum|w_k - w_p| {diff:.3e} + "
              f"gamma({depth_p}) x (sum|w_p| + |b|) = {tol:.3e}); repeat bit-equal")
        worst = max(worst, err)
    return worst


def _time_batch_ms(fn, calls: int = 16) -> float:
    """Per-call time of ``calls`` back-to-back calls of ``fn(bias)`` with
    distinct biases inside one CUDA event pair (median of 5 after a warm-up)."""
    return _time_ms(lambda: [fn(b) for b in range(calls)]) / calls


def _f64_welch(x, win64, nfft: int, hop: int, chunk: int = 32):
    """Float64 Welch reference: mean |rfft(frame * win)|^2, frames in chunks."""
    import torch

    frames = x.unfold(0, nfft, hop)
    acc = torch.zeros(nfft // 2 + 1, dtype=torch.float64, device=x.device)
    for a in range(0, frames.shape[0], chunk):
        fr = frames[a:a + chunk].double() * win64
        acc += (torch.fft.rfft(fr, dim=-1).abs() ** 2).sum(dim=0)
    return acc / frames.shape[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20260516,
                    help="seed of the random gate blocks and the analyzer input")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
    from blackman_harris_win_tpu_torch.kernels.compwin import (
        DEFAULT_THRESH,
        GRID_BITS,
        comp_window_flops,
        comp_window_pair,
        normalize_pair,
    )
    from blackman_harris_win_tpu_torch.kernels.floatwin import float_window, float_window_flops
    from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
    from blackman_harris_win_tpu_torch.kernels.outerwin import window_block_outer
    from blackman_harris_win_tpu_torch.kernels.taylor import taylor_sincos_block
    from blackman_harris_win_tpu_torch.kernels.welchfft_kernel import (
        welch_stage1_fused,
        welch_stage1_plain,
    )
    from blackman_harris_win_tpu_torch.kernels.window import (
        make_window,
        rtl_cordic_coeffs,
        window_samples,
    )
    from blackman_harris_win_tpu_torch.kernels.window_kernel import (
        window_block,
        window_checksum,
        window_checksum_plain,
        window_values_plain,
    )
    from blackman_harris_win_tpu_torch.pipeline.spectral import (
        window_scale,
        windowed_power_spectrum,
    )
    from blackman_harris_win_tpu_torch.utils.spectral import window_sidelobe_db
    from blackman_harris_win_tpu_torch.windows import catalog

    # --- 1. device and build ---
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {kind}")
    print(smi)
    path, log, secs = _build.build()
    _build.lib()
    print(f"build: {secs:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # --- 2. the main path, counted ---
    pw, w = 26, 32
    n = 1 << pw
    q7 = catalog.get("bh7").quantized(w)
    spec_hls = WindowSpec(pw, w, overflow="wrap")
    q7_rtl = rtl_cordic_coeffs(q7)
    spec_rtl = WindowSpec(pw, w, rounding="rtl", overflow="wrap")
    spec4 = WindowSpec(20, 17, overflow="saturate")
    nfft, hop, nsamp = spec4.n, 1 << 19, 128 << 20
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(nsamp, generator=gen, device=dev, dtype=torch.float32)
    torch.cuda.synchronize()

    _build.reset_launches()
    t0 = time.perf_counter()
    win_hls = make_window("bh7", spec_hls, device=dev)
    chk = window_checksum(q7, spec_hls, 0, 4 * n, bias=0, device=dev)
    win_rtl = make_window("bh7", spec_rtl, coeffs=q7_rtl, device=dev)
    ps_mxu = windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="mxu")
    # outer-product modes, bench_all configs 11/13/15 (BH-7, pw=26, m=11)
    m = 11
    nrows = n >> m
    bias = 123457
    win_outer = window_block_outer(0, nrows, q7, spec_hls, m=m, device=dev)
    chk_outer_fn = ok.make_checksum_fn(q7, spec_hls, m=m, rows=256, device=dev)
    chk_outer = chk_outer_fn(bias)
    win_f32 = float_window("bh7", pw, device=dev)
    chk_f32_fn = ok.make_checksum_fn_f32("bh7", pw, m=m, rows=256, device=dev)
    chk_f32 = chk_f32_fn(bias)
    win_s, win_e = comp_window_pair("bh7", pw, device=dev)
    chk_comp_fn = ok.make_checksum_fn_comp("bh7", pw, m=m, rows=256, device=dev)
    chk_comp = chk_comp_fn(bias)
    ps_float = windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode="float",
                                       fft_mode="mxu")
    ps_comp = windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode="comp",
                                      fft_mode="rfft")
    # the TAYLOR source, bench_all configs 16-18 (pw=26, 2^26 phases)
    tay_cfgs = ((16, 10), (32, 12))  # (W, LS)
    tay_cs = {cfg: taylor_sincos_block(0, n, pw, *cfg, device=dev) for cfg in tay_cfgs}
    tay_fns = {cfg: tk.make_checksum_fn_taylor(pw, *cfg, rows=64, device=dev)
               for cfg in tay_cfgs}
    tay_chk = {cfg: tay_fns[cfg](0, bias) for cfg in tay_cfgs}
    tay_specs = {  # name -> spec: HLS through the kernel, RTL/taylor2 in torch ops
        "blackman": WindowSpec(pw, 32, sin_type="taylor", lut_size=12, overflow="wrap"),
        "hamming": WindowSpec(pw, 16, sin_type="taylor", lut_size=10, overflow="saturate"),
        "hamming rtl": WindowSpec(pw, 16, sin_type="taylor", rounding="rtl", lut_size=10,
                                  overflow="saturate"),
        "bh7 taylor2": WindowSpec(pw, 32, sin_type="taylor2", lut_size=12, overflow="wrap"),
    }
    tay_win = {k: make_window(k.split()[0], sp, device=dev) for k, sp in tay_specs.items()}
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    print(f"main path: {main_s:.3f} s host clock (first call), launches {counts}")
    for name, c in counts.items():
        _require(c > 0, f"kernel {name} was not launched by the main path")

    # --- 3. gates ---
    print(f"gate seed: {args.seed}")
    rng = np.random.default_rng(args.seed)
    _gate_blocks("hls bh7 w32 pw26", win_hls, lambda i: window_values_plain(i, q7, spec_hls),
                 _seam_blocks(n, rng))
    sum32 = int(win_hls.sum(dtype=torch.int64))
    want_chk = ((4 * sum32 + (1 << 31)) % (1 << 32)) - (1 << 31)
    _require(int(chk) == want_chk,
             f"checksum {int(chk)} != 4 x int32-wrap window sum {want_chk}")
    print(f"checksum over 4 periods: {int(chk)} == 4 x window sum (exact)")
    _gate_blocks("rtl bh7 w32 pw26", win_rtl, lambda i: window_values_plain(i, q7_rtl, spec_rtl),
                 _seam_blocks(n, rng))

    d4 = catalog.get("bh4")
    _require(ps_mxu.shape == (nfft // 2 + 1,) and bool(torch.isfinite(ps_mxu).all()),
             "analyzer output is not finite of shape (nfft/2+1,)")
    ps_rfft = windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="rfft")
    rel_sum = abs(float(ps_mxu.double().sum() - ps_rfft.double().sum())) / float(
        ps_rfft.double().sum())
    _require(rel_sum < 1e-5, f"mxu vs rfft summed spectrum rel diff {rel_sum:.3e}")
    wq = window_block(d4.quantized(17), spec4, 0, nfft, dev)
    win64 = wq.double() * window_scale(spec4, d4.shift)
    ref = _f64_welch(x, win64, nfft, hop)
    budget = 32 * 2.0**-24 * np.sqrt(nfft)
    rel_bin = float(((ps_mxu.double() - ref).abs() / ref.abs()).max())
    _require(rel_bin < budget, f"analyzer per-bin rel err {rel_bin:.3e} > {budget:.3e}")
    print(f"analyzer: mxu vs rfft summed rel {rel_sum:.3e} (< 1e-5); per-bin rel "
          f"vs float64 {rel_bin:.3e} (< 32*2^-24*sqrt(nfft) = {budget:.3e})")

    win32 = (wq.to(torch.float32) * window_scale(spec4, d4.shift)).contiguous()
    s1r, s1i, _ = welch_stage1_fused(x, win32, nfft)
    p1r, p1i, _ = welch_stage1_plain(x, win32, nfft)
    err_s1 = float(torch.maximum((s1r - p1r).abs().max(), (s1i - p1i).abs().max()))
    scale_s1 = float(torch.maximum(p1r.abs().max(), p1i.abs().max()))
    _require(err_s1 / scale_s1 < 1e-5,
             f"stage-1 kernel vs plain max rel err {err_s1 / scale_s1:.3e}")
    print(f"stage-1 kernel vs plain: max abs err {err_s1:.3e}, "
          f"relative to max {err_s1 / scale_s1:.3e} (< 1e-5)")
    del s1r, s1i, p1r, p1i

    # the analyzer with the float32 and the compensated window
    win64_4 = torch.from_numpy(catalog.float_window_value("bh4", np.arange(nfft), nfft)).to(dev)
    ref4 = _f64_welch(x, win64_4, nfft, hop)
    for label, ps in (("float/mxu", ps_float), ("comp/rfft", ps_comp)):
        _require(ps.shape == (nfft // 2 + 1,) and bool(torch.isfinite(ps).all()),
                 f"analyzer {label}: output is not finite of shape (nfft/2+1,)")
        rel = float(((ps.double() - ref4).abs() / ref4.abs()).max())
        _require(rel < budget, f"analyzer {label}: per-bin rel err {rel:.3e} > {budget:.3e}")
        print(f"analyzer win_mode {label}: per-bin rel vs float64 {rel:.3e} (< {budget:.3e})")
    del ref4

    # --- outer-product modes: gates ---
    outer_plain = ok.outer_block_int_plain(q7, spec_hls, m, 0, nrows, device=dev)
    err_ob = int((outer_plain.long() - win_outer.long()).abs().max())
    _require(err_ob == 0, f"outer int kernel vs plain on the card: {err_ob} LSB")
    del outer_plain
    print("outer int window vs plain on the card: 0 LSB")
    _gate_outer_blocks("outer int bh7 w32 pw26", win_outer, q7, spec_hls, m,
                       _seam_blocks(n, rng))
    sum_outer = int(win_outer.sum(dtype=torch.int64))
    want_outer = ((sum_outer + bias + (1 << 31)) % (1 << 32)) - (1 << 31)
    chk_outer_plain = ok.checksum_plain(q7, spec_hls, m, 256, bias, device=dev)
    err_oc = abs(int(chk_outer) - int(chk_outer_plain))
    _require(int(chk_outer) == want_outer and err_oc == 0,
             f"outer checksum {int(chk_outer)}: int32-wrap sum + bias {want_outer}, "
             f"plain {int(chk_outer_plain)}")
    print(f"outer checksum: {int(chk_outer)} == int32-wrap window sum + bias == plain (exact)")

    gold7 = catalog.float_window_value("bh7", np.arange(n), n)  # host float64
    f32_plain = ok.outer_block_f32_plain("bh7", pw, m, 0, nrows, device=dev)
    err_fb = float((f32_plain - win_f32).abs().max())
    f32_bound = ok.f32_pair_bound("bh7")
    _require(err_fb <= f32_bound, f"f32 kernel vs plain {err_fb:.3e} > {f32_bound:.3e}")
    err_f64 = float(np.abs(win_f32.cpu().numpy().astype(np.float64) - gold7).max())
    _require(err_f64 < 1.5e-6, f"f32 window vs float64 golden {err_f64:.3e} >= 1.5e-6")
    print(f"f32 window: vs plain {err_fb:.3e} (<= op-count bound {f32_bound:.3e}); "
          f"vs float64 golden {err_f64:.3e} (< 1.5e-6)")
    depth = ok.checksum_depth(nrows, 1 << m)
    err_fc = _gate_float_checksum(
        "f32 checksum", chk_f32_fn, chk_f32, bias,
        lambda b: ok.checksum_plain_f32("bh7", pw, m, 256, b, device=dev),
        (win_f32,), (f32_plain,), depth, ok.checksum_plain_depth(nrows, 1 << m, 256))
    del f32_plain

    s_plain, e_plain = ok.outer_block_comp_plain("bh7", pw, m, GRID_BITS, DEFAULT_THRESH, 0,
                                                 nrows, device=dev)
    _require(torch.equal(s_plain, win_s), "comp s differs from the plain version")
    err_e = float((e_plain - win_e).abs().max())
    e_bound = ok.comp_e_bound("bh7")
    _require(err_e <= e_bound, f"comp e vs plain {err_e:.3e} > {e_bound:.3e}")
    err_ccp = _gate_float_checksum(
        "comp checksum", chk_comp_fn, chk_comp, bias,
        lambda b: ok.checksum_plain_comp("bh7", pw, m, 256, b, device=dev),
        (win_s, win_e), (s_plain, e_plain), depth,
        ok.checksum_plain_depth(nrows, 1 << m, 256, comp=True))
    del s_plain, e_plain
    pair64 = win_s.double() + win_e.double()
    err_pair = float(np.abs(pair64.cpu().numpy() - gold7).max())
    _require(err_pair < 5e-9, f"comp pair vs float64 golden {err_pair:.3e} >= 5e-9")
    del gold7
    seam = slice(n // 4 - 2048, n // 4 + 2048)
    hi, lo = normalize_pair(win_s[seam], win_e[seam])
    p64 = hi.astype(np.float64) + lo.astype(np.float64)
    _require(np.array_equal(p64, pair64[seam].cpu().numpy())
             and np.array_equal(p64.astype(np.float32), hi),
             "normalize_pair across the N/4 seam is not exact and non-overlapping")
    print(f"comp pair: s bit-equal to plain, e vs plain {err_e:.3e} (<= {e_bound:.3e}); "
          f"s + e vs float64 golden {err_pair:.3e} (< 5e-9); normalize_pair exact and "
          "non-overlapping across N/4")
    del pair64

    # --- the TAYLOR source: gates ---
    for cfg in tay_cfgs:
        c_dev, s_dev = tay_cs[cfg]
        for part, out in enumerate((c_dev, s_dev)):
            _gate_blocks(f"taylor {'cs'[part]} w{cfg[0]} ls{cfg[1]} pw26", out,
                         lambda i, c=cfg, p=part: tk.taylor_sincos_plain(i, pw, *c)[p],
                         _seam_blocks(n, rng))
    for k, sp in tay_specs.items():
        q = catalog.get(k.split()[0]).quantized(sp.data_width)
        _gate_blocks(f"taylor window {k} w{sp.data_width} pw26", tay_win[k],
                     lambda i, q=q, sp=sp: window_samples(i, q, sp).to(torch.int32),
                     _seam_blocks(n, rng))
    idx = torch.arange(n, device=dev)
    err_tcs = 0
    err_tck = 0
    for cfg in tay_cfgs:
        pc, ps = tk.taylor_sincos_plain(idx, pw, *cfg)
        c_dev, s_dev = tay_cs[cfg]
        err_tcs = max(err_tcs, int((pc.long() - c_dev.long()).abs().max()),
                      int((ps.long() - s_dev.long()).abs().max()))
        del pc, ps
        # a full period's quadrants cancel (the sum is the bias), so the
        # checksum kernel is also held on a random range that is not one
        r0 = int(rng.integers(n))
        ranges = ((0, n, tay_chk[cfg]),
                  (r0, n // 3, tk.checksum_range(r0, n // 3, pw, *cfg, bias, dev)))
        cs_sum = c_dev.long() + s_dev.long()
        for start, count, got in ranges:
            total = int(cs_sum[torch.arange(start, start + count, device=dev) % n].sum())
            want = ((total + bias + (1 << 31)) % (1 << 32)) - (1 << 31)
            plain = int(tk.taylor_checksum_plain(pw, *cfg, start, bias, device=dev,
                                                 count=count))
            err_tck = max(err_tck, abs(int(got) - plain))
            _require(int(got) == want == plain,
                     f"taylor checksum w{cfg[0]} [{start}, +{count}): {int(got)}, int32-wrap "
                     f"c+s sum + bias {want}, plain {plain}")
            print(f"taylor checksum w{cfg[0]} ls{cfg[1]} over [{start}, +{count}): "
                  f"{int(got)} == int32-wrap sum of the written c+s + bias == plain on the "
                  "card (exact)")
        del cs_sum
    _require(err_tcs == 0, f"taylor sincos kernel vs plain on the card: {err_tcs} LSB")
    err_twin = 0
    for k in ("blackman", "hamming"):
        sp = tay_specs[k]
        plain = tk.taylor_window_plain(idx, catalog.get(k).quantized(sp.data_width), sp)
        err_twin = max(err_twin, int((plain.long() - tay_win[k].long()).abs().max()))
        del plain
    _require(err_twin == 0, f"taylor window kernel vs plain on the card: {err_twin} LSB")
    print("taylor kernels vs plain on the card: 0 LSB (sincos w16/w32, windows blackman "
          "w32 wrap, hamming w16 saturate)")

    # spectral floors at pw=16 from the kernels' output
    spec16 = WindowSpec(16, 32, overflow="wrap")
    floors = {
        "outer bh7 w32": (window_sidelobe_db(
            window_block_outer(0, 32, q7, spec16, device=dev).cpu().numpy(),
            oversample=4, guard_bins=16 * 7), -180.0),
        "float bh7": (window_sidelobe_db(float_window("bh7", 16, device=dev).cpu().numpy()),
                      -160.0),
        "float bh4": (window_sidelobe_db(float_window("bh4", 16, device=dev).cpu().numpy()),
                      -92.0),
        "comp pair bh7": (window_sidelobe_db(
            sum(v.double() for v in comp_window_pair("bh7", 16, device=dev)).cpu().numpy(),
            n_terms=7), -180.0),
        "taylor2 bh7 w32": (window_sidelobe_db(make_window(
            "bh7", tay_specs["bh7 taylor2"].with_(phase_width=16), device=dev).cpu().numpy(),
            oversample=4, guard_bins=16 * 7), -180.0),
    }
    for label, (db, bound) in floors.items():
        _require(db <= bound, f"floor {label}: {db:.2f} dB > {bound} dB")
    print("floors at pw=16: " + ", ".join(f"{k} {v[0]:.2f} dB (<= {v[1]})"
                                          for k, v in floors.items()))

    # --- 4. each kernel against its plain version on the card, timed ---
    plain_hls = window_values_plain(idx, q7, spec_hls)
    err_1a = int((plain_hls.long() - win_hls.long()).abs().max())
    plain_rtl = window_values_plain(idx, q7_rtl, spec_rtl)
    err_1a_rtl = int((plain_rtl.long() - win_rtl.long()).abs().max())
    _require(err_1a == 0 and err_1a_rtl == 0,
             f"window kernel vs plain on the card: {err_1a}, {err_1a_rtl} LSB")
    del plain_hls, plain_rtl
    chk_plain = window_checksum_plain(q7, spec_hls, 0, 4 * n, device=dev)
    err_1b = abs(int(chk) - int(chk_plain))
    _require(err_1b == 0, f"checksum kernel {int(chk)} != plain {int(chk_plain)}")
    print("window kernels vs plain on the card: 0 LSB (hls, rtl, checksum)")

    label = f"[{smi}]"
    t = {
        "window_block": (
            _time_ms(lambda: window_block(q7, spec_hls, 0, n, dev)),
            _time_ms(lambda: window_values_plain(idx, q7, spec_hls)),
        ),
        "window_block_rtl": (
            _time_ms(lambda: window_block(q7_rtl, spec_rtl, 0, n, dev)),
            _time_ms(lambda: window_values_plain(idx, q7_rtl, spec_rtl)),
        ),
        "window_checksum": (
            _time_ms(lambda: window_checksum(q7, spec_hls, 0, 4 * n, device=dev)),
            _time_ms(lambda: window_checksum_plain(q7, spec_hls, 0, 4 * n, device=dev)),
        ),
        "welch_stage1": (
            _time_ms(lambda: welch_stage1_fused(x, win32, nfft)),
            _time_ms(lambda: welch_stage1_plain(x, win32, nfft)),
        ),
        "analyzer mxu vs rfft": (
            _time_ms(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop,
                                                     fft_mode="mxu")),
            _time_ms(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop,
                                                     fft_mode="rfft")),
        ),
        "outer_block": (
            _time_ms(lambda: window_block_outer(0, nrows, q7, spec_hls, m=m, device=dev)),
            _time_ms(lambda: ok.outer_block_int_plain(q7, spec_hls, m, 0, nrows, device=dev)),
        ),
        "outer_checksum": (
            _time_batch_ms(chk_outer_fn),
            _time_ms(lambda: ok.checksum_plain(q7, spec_hls, m, 256, 0, device=dev)),
        ),
        "outer_block_f32": (
            _time_ms(lambda: float_window("bh7", pw, device=dev)),
            _time_ms(lambda: ok.outer_block_f32_plain("bh7", pw, m, 0, nrows, device=dev)),
        ),
        "outer_checksum_f32": (
            _time_batch_ms(chk_f32_fn),
            _time_ms(lambda: ok.checksum_plain_f32("bh7", pw, m, 256, 0, device=dev)),
        ),
        "outer_block_comp": (
            _time_ms(lambda: comp_window_pair("bh7", pw, device=dev)),
            _time_ms(lambda: ok.outer_block_comp_plain("bh7", pw, m, GRID_BITS,
                                                       DEFAULT_THRESH, 0, nrows, device=dev)),
        ),
        "outer_checksum_comp": (
            _time_batch_ms(chk_comp_fn),
            _time_ms(lambda: ok.checksum_plain_comp("bh7", pw, m, 256, 0, device=dev)),
        ),
        **{f"taylor_sincos_block w{c[0]}": (
            _time_ms(lambda c=c: taylor_sincos_block(0, n, pw, *c, device=dev)),
            _time_ms(lambda c=c: tk.taylor_sincos_plain(idx, pw, *c)),
        ) for c in tay_cfgs},
        **{f"taylor_checksum w{c[0]}": (
            _time_batch_ms(lambda b, c=c: tay_fns[c](0, b)),
            _time_ms(lambda c=c: tk.taylor_checksum_plain(pw, *c, 0, 0, device=dev)),
        ) for c in tay_cfgs},
        **{f"taylor_window_block {k}": (
            _time_ms(lambda k=k: make_window(k, tay_specs[k], device=dev)),
            _time_ms(lambda k=k: tk.taylor_window_plain(
                idx, catalog.get(k).quantized(tay_specs[k].data_width), tay_specs[k])),
        ) for k in ("blackman", "hamming")},
        "analyzer float/mxu vs comp/rfft": (
            _time_ms(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop,
                                                     win_mode="float", fft_mode="mxu")),
            _time_ms(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop,
                                                     win_mode="comp", fft_mode="rfft")),
        ),
    }
    for name, (ms, plain_ms) in t.items():
        print(f"time {label} {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms)")
    for k in ("hamming rtl", "bh7 taylor2"):  # torch ops on the card, no kernel
        ms = _time_ms(lambda k=k: make_window(k.split()[0], tay_specs[k], device=dev))
        print(f"time {label} taylor window {k} (torch ops, no kernel): {ms:.3f} ms")
    print(f"rates {label}: window_block {n / t['window_block'][0] / 1e3:.1f} "
          f"Msamples/s, window_checksum {4 * n / t['window_checksum'][0] / 1e3:.1f} "
          f"Msamples/s, analyzer mxu {nsamp / t['analyzer mxu vs rfft'][0] / 1e3:.1f} "
          "Msamples/s in")
    print(f"rates {label}: " + ", ".join(
        f"{k} {n / t[k][0] / 1e3:.1f} Msamples/s (plain {n / t[k][1] / 1e3:.1f})"
        for k in ("outer_block", "outer_checksum", "outer_block_f32", "outer_checksum_f32",
                  "outer_block_comp", "outer_checksum_comp")))
    # the no-fusion f32 op models of the float modes (FMA pairs count 4 ops)
    gflops_f32 = float_window_flops(n, 8) / t["outer_checksum_f32"][0] / 1e6
    gflops_comp = comp_window_flops(n, "bh7") / t["outer_checksum_comp"][0] / 1e6
    print(f"rates {label}: outer_checksum_f32 {gflops_f32:.1f} GFLOP/s, "
          f"outer_checksum_comp {gflops_comp:.1f} GFLOP/s (no-fusion op models)")
    print(f"rates {label}: " + ", ".join(
        f"{k} {n / t[k][0] / 1e3:.1f} Msamples/s" for k in t if k.startswith("taylor")))

    src = "blackman_harris_win_tpu_torch/csrc/"
    tpu_win = "blackman_harris_win_tpu/kernels/pallas/window_kernel.py:378"
    kernels = [
        {"name": "window_block", "route": "cuda", "source": src + "window_kernel.cu",
         "replaces": tpu_win, "launches": counts["window_block"],
         "max_abs_err": err_1a, "ms": t["window_block"][0],
         "plain_ms": t["window_block"][1]},
        {"name": "window_checksum", "route": "cuda", "source": src + "window_kernel.cu",
         "replaces": tpu_win, "launches": counts["window_checksum"],
         "max_abs_err": err_1b, "ms": t["window_checksum"][0],
         "plain_ms": t["window_checksum"][1]},
        {"name": "welch_stage1", "route": "cuda", "source": src + "welchfft_kernel.cu",
         "replaces": "blackman_harris_win_tpu/kernels/pallas/welchfft_kernel.py:77",
         "launches": counts["welch_stage1"], "max_abs_err": err_s1,
         "ms": t["welch_stage1"][0], "plain_ms": t["welch_stage1"][1]},
    ]
    tpu_outer = "blackman_harris_win_tpu/kernels/pallas/outerwin_kernel.py:"
    for name, line, err in (
        ("outer_block", 86, err_ob), ("outer_checksum", 86, err_oc),
        ("outer_block_f32", 276, err_fb), ("outer_checksum_f32", 276, err_fc),
        ("outer_block_comp", 170, err_e), ("outer_checksum_comp", 170, err_ccp),
    ):
        kernels.append({"name": name, "route": "cuda", "source": src + "outerwin_kernel.cu",
                        "replaces": f"{tpu_outer}{line}", "launches": counts[name],
                        "max_abs_err": err, "ms": t[name][0], "plain_ms": t[name][1]})
    tpu_tay = "blackman_harris_win_tpu/kernels/pallas/taylor_kernel.py:71"
    for name, key, err in (
        ("taylor_sincos_block", "taylor_sincos_block w32", err_tcs),
        ("taylor_window_block", "taylor_window_block blackman", err_twin),
        ("taylor_checksum", "taylor_checksum w32", err_tck),
    ):
        kernels.append({"name": name, "route": "cuda", "source": src + "taylor_kernel.cu",
                        "replaces": tpu_tay, "launches": counts[name], "max_abs_err": err,
                        "ms": t[key][0], "plain_ms": t[key][1]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
