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
   for the window, kernel 2 for framing + window + DFT stage 1).

Every kernel's launch counter is zeroed just before that run and read just
after; a kernel the path did not launch fails the run.  Then each output is
checked: generation 0-LSB against the plain PyTorch version on the CPU on
random and quadrant-seam blocks, the exact checksum identity, the analyzer
against the rfft path and a float64 reference within the derived f32
budget, and each kernel against its plain version on the card.  Last, each
kernel and its plain version are timed with CUDA events (median of 5 after
a warm-up).

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


def _gate_blocks(label, win_dev, q, spec, blocks):
    """0-LSB gate of a written window against the CPU plain version."""
    import torch

    from blackman_harris_win_tpu_torch.kernels.window_kernel import window_values_plain

    for blk in blocks:
        idx = torch.from_numpy(blk)
        got = win_dev[idx.to(win_dev.device)].cpu()
        want = window_values_plain(idx, q, spec)
        bad = blk[(got != want).numpy()]
        _require(bad.size == 0, f"{label}: differs from the plain version at "
                 f"indices {bad[:8].tolist()}")
    print(f"{label}: {len(blocks)} blocks 0-LSB equal to the CPU plain version")


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
    from blackman_harris_win_tpu_torch.kernels.welchfft_kernel import (
        welch_stage1_fused,
        welch_stage1_plain,
    )
    from blackman_harris_win_tpu_torch.kernels.window import (
        make_window,
        rtl_cordic_coeffs,
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
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    print(f"main path: {main_s:.3f} s host clock (first call), launches {counts}")
    for name, c in counts.items():
        _require(c > 0, f"kernel {name} was not launched by the main path")

    # --- 3. gates ---
    print(f"gate seed: {args.seed}")
    rng = np.random.default_rng(args.seed)
    _gate_blocks("hls bh7 w32 pw26", win_hls, q7, spec_hls, _seam_blocks(n, rng))
    sum32 = int(win_hls.sum(dtype=torch.int64))
    want_chk = ((4 * sum32 + (1 << 31)) % (1 << 32)) - (1 << 31)
    _require(int(chk) == want_chk,
             f"checksum {int(chk)} != 4 x int32-wrap window sum {want_chk}")
    print(f"checksum over 4 periods: {int(chk)} == 4 x window sum (exact)")
    _gate_blocks("rtl bh7 w32 pw26", win_rtl, q7_rtl, spec_rtl, _seam_blocks(n, rng))

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

    # --- 4. each kernel against its plain version on the card, timed ---
    idx = torch.arange(n, device=dev)
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
    }
    for name, (ms, plain_ms) in t.items():
        print(f"time {label} {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms)")
    print(f"rates {label}: window_block {n / t['window_block'][0] / 1e3:.1f} "
          f"Msamples/s, window_checksum {4 * n / t['window_checksum'][0] / 1e3:.1f} "
          f"Msamples/s, analyzer mxu {nsamp / t['analyzer mxu vs rfft'][0] / 1e3:.1f} "
          "Msamples/s in")

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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
