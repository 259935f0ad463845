"""Command-line front-end: ``python -m blackman_harris_win_tpu_torch <cmd>``
(counterpart of ``blackman_harris_win_tpu/__main__.py``; the same nine
subcommands with the same arguments and defaults).

The reference's user surface is a VHDL entity with generics
(``src/win_selector.vhd:61-81``); this is its interactive equivalent: list
and inspect the coefficient catalog, design and measure windows, generate
quantized windows in any mode, and run the Welch analyzer, the DDC and the
STFT on raw or ``.npy`` captures.

``gen``, ``spectrum``, ``ddc`` and ``stft`` run on the card unless
``--device cpu`` asks for the CPU (the port's plain versions); without a
card and without ``--device cpu`` they exit non-zero.  Each copies its
result to the host once, after the device work, to write it.
"""

from __future__ import annotations

import argparse
import json
import sys


def _spec(args):
    from .core.config import WindowSpec

    return WindowSpec(
        phase_width=args.phase_width,
        data_width=args.data_width,
        sin_type=getattr(args, "sin_type", "cordic"),
        rounding=getattr(args, "rounding", "hls"),
        overflow=getattr(args, "overflow", "saturate"),
        lut_size=getattr(args, "lut_size", 10),
    )


def _device(args):
    """The torch device a device-taking subcommand runs on: ``--device``,
    else the current CUDA device; exits with ``resolve_device``'s message
    where that device does not exist."""
    from . import _build

    try:
        return _build.resolve_device(args.device)
    except (RuntimeError, ValueError) as ex:
        raise SystemExit(f"blackman_harris_win_tpu_torch {args.cmd}: {ex}") from None


def cmd_list(args) -> int:
    from .windows import catalog

    rows = []
    for name in catalog.names():
        d = catalog.get(name)
        rows.append(
            {
                "name": d.name,
                "terms": d.n_terms,
                "sidelobe_db": d.sidelobe_db,
                "shift": d.shift,
                "coeffs": list(d.coeffs),
            }
        )
    if args.json:
        print(json.dumps(rows, indent=None))
    else:
        print(f"{'name':16} {'terms':>5} {'sidelobe':>9}  coefficients")
        for r in rows:
            sl = f"{r['sidelobe_db']:.0f} dB" if r["sidelobe_db"] else "-"
            cs = " ".join(f"{c:.6g}" for c in r["coeffs"])
            print(f"{r['name']:16} {r['terms']:>5} {sl:>9}  {cs}")
    return 0


def cmd_info(args) -> int:
    from .utils.spectral import required_width_for_sidelobe
    from .windows import catalog
    from .windows.metrics import cosine_sum_coherent_gain, cosine_sum_enbw_bins

    d = catalog.get(args.window)
    out = {
        "name": d.name,
        "terms": d.n_terms,
        "sidelobe_db": d.sidelobe_db,
        "shift": d.shift,
        "coeffs": list(d.coeffs),
        "quantized": list(d.quantized(args.data_width)),
        "data_width": args.data_width,
    }
    if d.sidelobe_db is not None:
        out["required_width"] = required_width_for_sidelobe(d.sidelobe_db)
    out["enbw_bins"] = round(cosine_sum_enbw_bins(d.coeffs), 4)
    out["coherent_gain"] = round(cosine_sum_coherent_gain(d.coeffs), 4)
    print(json.dumps(out))
    return 0


def cmd_suggest(args) -> int:
    """Recommend the fastest generation mode for a requirement
    (windows/modes.py), with the mode's rate on the H100."""
    from .windows.modes import recommend_mode

    try:
        r = recommend_mode(args.window, consumer=args.consumer,
                           exactness=args.exactness,
                           target_db=args.target_db)
    except KeyError as ex:
        print(str(ex), file=sys.stderr)
        return 2
    print(json.dumps({
        "mode": r.mode,
        "est_gsamp_s_64M_h100": r.est_gsamp_s,
        "rationale": r.rationale,
    }))
    return 0


def cmd_metrics(args) -> int:
    """harris figure-of-merit table for the catalog (windows/metrics.py):
    float windows by default, the quantized ones with --data-width."""
    from .windows import catalog
    from .windows.metrics import catalog_metrics

    if args.window:
        catalog.get(args.window)  # loud "unknown window ...; available" error
    table = catalog_metrics(
        n=args.n, data_width=args.data_width or None, oversample=args.oversample
    )
    if args.window:
        table = {args.window: table[args.window]}
    if args.json:
        for name, m in table.items():
            print(json.dumps({"name": name, **m.__dict__}))
        return 0
    cols = [
        ("enbw_bins", "ENBW", "{:.4f}"),
        ("coherent_gain", "CG", "{:.4f}"),
        ("scalloping_loss_db", "scallop", "{:+.2f}"),
        ("worst_case_loss_db", "WCL", "{:+.2f}"),
        ("main_lobe_3db_bins", "3dB-BW", "{:.2f}"),
        ("main_lobe_6db_bins", "6dB-BW", "{:.2f}"),
        ("peak_sidelobe_db", "sidelobe", "{:.1f}"),
    ]
    print(f"{'name':16} " + " ".join(f"{h:>8}" for _, h, _ in cols))
    for name, m in table.items():
        row = " ".join(f"{fmt.format(getattr(m, k)):>8}" for k, _, fmt in cols)
        print(f"{name:16} {row}")
    return 0


def _load_real_signal(args, min_len: int, device):
    """Shared spectrum/ddc/stft input path: .npy or raw capture (native mmap
    runtime), complex inputs reduced to .real regardless of format (the
    Welch/STFT analyzers are real-input), a loud error when the signal is
    shorter than one frame, then one float32 copy to ``device``."""
    import numpy as np
    import torch

    if args.format == "npy":
        x = np.load(args.input)
    else:
        from .utils.io import SampleSource

        with SampleSource(args.input, args.format, scale=args.scale) as src:
            x = src.read_block(args.offset, args.count or len(src))
    if np.iscomplexobj(x):
        x = x.real
    if len(x) < min_len:
        raise SystemExit(
            f"input has {len(x)} samples but one frame needs nfft="
            f"{min_len} (2^phase_width); lower --phase-width or supply "
            "more samples"
        )
    return torch.from_numpy(x).to(device=device, dtype=torch.float32)


def cmd_design(args) -> int:
    """Minimax window design (windows/design.py): terms + stop-band edge +
    optional nulls -> coefficients, achieved floor, quantized handoff."""
    from .utils.spectral import required_width_for_sidelobe
    from .windows.design import design_min_sidelobe, quantized_coeffs

    r = design_min_sidelobe(
        args.terms,
        stop_bin=args.stop_bin,
        nulls=tuple(args.null or ()),
    )
    width = args.data_width or required_width_for_sidelobe(r.sidelobe_db)
    q = quantized_coeffs(r, width)
    out = {
        "terms": r.n_terms,
        "stop_bin": r.stop_bin,
        "sidelobe_db": round(r.sidelobe_db, 2),
        "coeffs": list(r.coeffs),
        "data_width": width,
        "shift": r.suggest_shift(),
        "quantized": list(q),
    }
    if args.measure_floor:
        from .windows.design import sampled_window
        from .windows.metrics import window_metrics

        m = window_metrics(
            sampled_window(r, 1 << args.phase_width), n_terms=r.n_terms
        )
        out["measured_sidelobe_db"] = round(m.peak_sidelobe_db, 2)
        out["enbw_bins"] = round(m.enbw_bins, 4)
    print(json.dumps(out))
    if args.out:
        import numpy as np

        np.savetxt(args.out, np.asarray(q, np.int64), fmt="%d")
        print(f"wrote {len(q)} quantized coefficients to {args.out}",
              file=sys.stderr)
    return 0


def _generate(args, spec, coeffs_q, device):
    """The window of ``gen --mode``, as one host numpy array: every mode
    runs on ``device`` and copies to the host once."""
    import numpy as np

    if args.mode == "float":
        from .kernels.floatwin import float_window

        return float_window(args.window, spec.phase_width, device=device).cpu().numpy()
    if args.mode in ("comp", "comp-pair"):
        from .kernels.compwin import comp_window_pair, normalize_pair

        # the raw (s, e) pair to the host once; the fold runs there
        hi, lo = normalize_pair(*comp_window_pair(args.window, spec.phase_width,
                                                  device=device))
        return np.stack([hi, lo]) if args.mode == "comp-pair" else hi  # (2, N)
    if args.mode == "outer":
        from .kernels.outerwin import window_block_outer

        m = min(11, spec.phase_width - 1)
        win = window_block_outer(0, spec.n >> m, coeffs_q, spec, m=m, device=device)
    elif args.mode == "taylor2":
        from .kernels.fastwin_kernel import window_block

        win = window_block(coeffs_q, spec, 0, spec.n, device)
    else:
        from .kernels.window import make_window

        win = make_window(args.window, spec, device=device)
    return win.cpu().numpy()


def cmd_gen(args) -> int:
    import numpy as np

    from .windows import catalog

    device = _device(args)
    spec = _spec(args)
    d = catalog.get(args.window)
    w = _generate(args, spec, d.quantized(spec.data_width), device)
    fmt = "%.9g" if w.dtype.kind == "f" else "%d"
    if args.out:
        if args.out.endswith(".npy"):
            np.save(args.out, w)
        else:
            np.savetxt(args.out, w, fmt=fmt)
        print(f"wrote {spec.n} samples ({w.dtype}) to {args.out}")
    else:
        np.savetxt(sys.stdout, w[: args.head] if args.head else w, fmt=fmt)

    if args.measure_floor:
        from .utils.spectral import window_sidelobe_db

        w64 = w.astype(np.float64)
        if w64.ndim == 2:  # comp-pair: the floor of hi + lo
            w64 = w64[0] + w64[1]
        print(
            json.dumps(
                {
                    "measured_sidelobe_db": round(
                        float(window_sidelobe_db(w64)), 2
                    ),
                    "published_db": d.sidelobe_db,
                }
            ),
            file=sys.stderr,
        )
    return 0


def cmd_spectrum(args) -> int:
    import numpy as np

    from .pipeline.spectral import windowed_power_spectrum

    device = _device(args)
    spec = _spec(args)
    x = _load_real_signal(args, spec.n, device)
    hop = args.hop or spec.n // 2
    p = windowed_power_spectrum(
        x, args.window, spec, hop=hop, win_mode=args.win_mode,
        fft_mode=args.fft_mode,
    ).cpu().numpy()
    if args.out:
        np.save(args.out, p)
        print(f"wrote spectrum {p.shape} to {args.out}")
    else:
        np.savetxt(sys.stdout, 10.0 * np.log10(np.maximum(p, 1e-300)))
    return 0


def cmd_ddc(args) -> int:
    """Digital downconverter: CORDIC NCO + integer I/Q mixer + decimating
    FIR (pipeline/ddc.py): translate a band to baseband and decimate."""
    import numpy as np

    from .pipeline.ddc import ddc

    if args.taps < args.decim:
        raise SystemExit(
            f"--taps {args.taps} < --decim {args.decim}: this port's ddc "
            "refuses a decimation larger than its filter (the JAX package's "
            "ddc returns a misaligned result there instead)"
        )
    device = _device(args)
    x = _load_real_signal(args, args.decim, device)
    t = len(x) - len(x) % args.decim
    bb = ddc(
        x[:t], args.freq, args.decim, taps=args.taps,
        phase_width=args.phase_width, data_width=args.data_width,
        cutoff=args.cutoff, window=args.window, flavor=args.flavor,
    ).cpu().numpy()
    if args.out:
        np.save(args.out, bb)
        print(f"wrote baseband I/Q {bb.shape} to {args.out}")
    else:
        np.savetxt(sys.stdout, bb.T, fmt="%.6g", header="I Q")
    return 0


def cmd_stft(args) -> int:
    """Spectrogram front-end: STFT frames through a quantized catalog
    window (pipeline/stft.py); .npy complex frames with --out, else a
    frames x bins dB-magnitude matrix to stdout."""
    import numpy as np

    from .pipeline.stft import quantized_stft_pair

    device = _device(args)
    spec = _spec(args)
    x = _load_real_signal(args, spec.n, device)
    hop = args.hop or spec.n // 2
    # trim to the exact framing tiling (T - nfft) % hop == 0
    nf = (len(x) - spec.n) // hop
    fwd, _, _ = quantized_stft_pair(args.window, spec, hop, device=device)
    s = fwd(x[: spec.n + nf * hop]).cpu().numpy()
    if args.out:
        np.save(args.out, s)
        print(f"wrote {s.shape[0]} frames x {s.shape[1]} bins to {args.out}")
    else:
        mag = 20.0 * np.log10(np.maximum(np.abs(s), 1e-300))
        np.savetxt(sys.stdout, mag, fmt="%.2f")
    return 0


def _add_spec_args(p: argparse.ArgumentParser, need_window: bool = True):
    if need_window:
        p.add_argument("window", help="catalog name (see `list`)")
    p.add_argument("--phase-width", type=int, default=12,
                   help="log2 window length (reference PHI_WIDTH), default 12")
    p.add_argument("--data-width", type=int, default=17,
                   help="output bit width (reference DAT_WIDTH), default 17")
    p.add_argument("--rounding", choices=("hls", "rtl"), default="hls")
    p.add_argument("--overflow", choices=("saturate", "wrap"), default="saturate")
    p.add_argument("--sin-type", choices=("cordic", "taylor", "taylor2"),
                   default="cordic")
    p.add_argument("--lut-size", type=int, default=10)


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device: the current CUDA card by default, "
                        "cuda:N, or cpu (the plain PyTorch versions)")


def _add_input_args(p: argparse.ArgumentParser):
    p.add_argument("--input", required=True,
                   help="input signal (.npy, or raw with --format)")
    p.add_argument("--format", choices=("npy", "i8", "i16", "f32", "ci16"),
                   default="npy",
                   help="raw formats are mmap'd via the native stream-IO "
                        "runtime (native/stream_io.cpp)")
    p.add_argument("--scale", type=float, default=1.0,
                   help="raw-sample scale factor (e.g. 2**-15 for i16)")
    p.add_argument("--offset", type=int, default=0,
                   help="first raw sample to read")
    p.add_argument("--count", type=int, default=0,
                   help="raw samples to read (default: to end of file)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="blackman_harris_win_tpu_torch",
        description="fixed-point window generation and analysis in PyTorch "
                    "with CUDA kernels",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list the coefficient catalog")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("info", help="one window's coefficients / widths")
    p.add_argument("window")
    p.add_argument("--data-width", type=int, default=17)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser(
        "metrics",
        help="harris figure-of-merit table (ENBW, scalloping, lobe widths)",
    )
    p.add_argument("window", nargs="?", default=None,
                   help="one catalog name (default: whole catalog)")
    p.add_argument("--n", type=int, default=4096, help="window length")
    p.add_argument("--data-width", type=int, default=0,
                   help="measure the QUANTIZED window at this width "
                        "(default: float coefficients)")
    p.add_argument("--oversample", type=int, default=64,
                   help="DTFT grid density (bins resolved to 1/oversample)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per window instead of the table")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "suggest",
        help="recommend the fastest generation mode for a requirement",
    )
    p.add_argument("window")
    p.add_argument("--consumer", choices=("float", "int"), default="float",
                   help="what consumes the window: f32 frames (Welch/STFT)"
                        " or integer samples (reference-style int FFT)")
    p.add_argument("--exactness", choices=("bit-exact", "floor"),
                   default="floor",
                   help="sample-for-sample reference contract vs the "
                        "published floor held spectrally")
    p.add_argument("--target-db", type=float, default=None,
                   help="required floor (default: the published level)")
    p.set_defaults(fn=cmd_suggest)

    p = sub.add_parser(
        "design",
        help="minimax (equal-ripple) cosine-sum window design via LP",
    )
    p.add_argument("terms", type=int, help="number of cosine terms K >= 2")
    p.add_argument("--stop-bin", type=float, default=None,
                   help="stop-band edge in bins (default K; lower = narrower "
                        "main lobe, higher = deeper floor)")
    p.add_argument("--null", type=float, action="append",
                   help="prescribe an exact spectral null at this bin offset "
                        "(repeatable)")
    p.add_argument("--data-width", type=int, default=0,
                   help="quantization width (default: sized from the achieved "
                        "floor by the 6 dB/bit rule)")
    p.add_argument("--phase-width", type=int, default=12,
                   help="log2 window length for --measure-floor")
    p.add_argument("--measure-floor", action="store_true",
                   help="also measure the sampled window's floor and ENBW")
    p.add_argument("--out", help="write quantized coefficients to a text file")
    p.set_defaults(fn=cmd_design)

    p = sub.add_parser("gen", help="generate a quantized window")
    _add_spec_args(p)
    p.add_argument("--mode",
                   choices=("exact", "taylor2", "outer", "float", "comp",
                            "comp-pair"),
                   default="exact",
                   help="exact = bit-exact CORDIC datapath; taylor2/outer = "
                        "int fast modes (spectrally validated); float = "
                        "native float32 generation (kernels/floatwin.py, "
                        "unit amplitude — for float consumers); comp = "
                        "compensated f32 (best f32 window, kernels/"
                        "compwin.py); comp-pair = (hi, lo) rows holding "
                        "the full -180 dB floor")
    p.add_argument("--out", help=".npy or text file (default: stdout)")
    p.add_argument("--head", type=int, default=0,
                   help="print only the first N samples to stdout")
    p.add_argument("--measure-floor", action="store_true",
                   help="report the measured sidelobe floor on stderr")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_gen)

    p = sub.add_parser(
        "spectrum",
        help="windowed Welch power spectrum of a .npy or raw capture file",
    )
    _add_spec_args(p)
    _add_input_args(p)
    p.add_argument("--hop", type=int, default=0, help="frame hop (default nfft/2)")
    p.add_argument("--fft-mode", choices=("rfft", "packed", "mxu"),
                   default="rfft",
                   help="FFT backend: rfft = torch.fft (cuFFT on the card); "
                        "packed = two real frames per complex FFT; mxu = "
                        "the stage-1 kernel (framing, window, first FFT "
                        "stage) then matmul DFT stages")
    p.add_argument("--win-mode", choices=("quantized", "float", "comp"),
                   default="quantized",
                   help="quantized = reference integer window datapath; "
                        "float = native float32 generation "
                        "(kernels/floatwin.py); comp = compensated-f32 "
                        "pair window apply (full -180 dB floor, "
                        "kernels/compwin.py)")
    p.add_argument("--out", help="output spectrum .npy (default: dB to stdout)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_spectrum)

    p = sub.add_parser(
        "ddc",
        help="digital downconverter: NCO mix to baseband + decimate "
             "(the CORDIC in its DDS role, src/cordic_dds48.vhd:9-14)",
    )
    _add_input_args(p)
    p.add_argument("--freq", type=float, required=True,
                   help="NCO frequency in cycles/sample (0..1)")
    p.add_argument("--decim", type=int, default=4)
    p.add_argument("--taps", type=int, default=64,
                   help="lowpass prototype length (at least --decim)")
    p.add_argument("--cutoff", type=float, default=None,
                   help="passband edge as fraction of input Nyquist "
                        "(default 0.8/decim)")
    p.add_argument("--window", default="bh4",
                   help="window weighting the FIR prototype")
    p.add_argument("--phase-width", type=int, default=20,
                   help="NCO phase accumulator bits")
    p.add_argument("--data-width", type=int, default=16,
                   help="NCO amplitude bits (mixer product must fit "
                        "int32 lanes: <= 17)")
    p.add_argument("--flavor", choices=("dds48", "scaled"),
                   default="dds48", help="NCO CORDIC flavor")
    p.add_argument("--out", help="output (2, T/decim) I/Q .npy")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_ddc)

    p = sub.add_parser(
        "stft",
        help="spectrogram (STFT frames) of a .npy or raw capture file",
    )
    _add_spec_args(p)
    _add_input_args(p)
    p.add_argument("--hop", type=int, default=0, help="frame hop (default nfft/2)")
    p.add_argument("--out", help="complex frames .npy (default: dB to stdout)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_stft)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
