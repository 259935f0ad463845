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
   RTL-contract TAYLOR Hamming window and a taylor2 BH-7 W=32 LS=12 window;
7. the DDC at bench_all config 21: 2^26 float32 samples, fc = 1/8, decim 4,
   64 taps (``design_lowpass(64, 0.2)``), dds48 NCO at pw=20 W=16; its
   decimating FIR takes the bulk branch, which runs the materialization
   kernel (kernel 7) before the strided conv;
8. the SDR chain (torch ops: it has no kernel of its own) at the multichip
   dryrun's stage-4 configuration (4 channels, 6 taps per branch, AW=20)
   over a 2^22-sample tone, a latency check, and at bench_all config 5
   (16 channels, 8 taps per branch) over 16 * 2^22 noise samples;
9. STFT/WOLA round trips at the analyzer configuration (BH-4 W=17 pw=20
   saturate, nfft 2^20, hop 2^19, 32 * 2^20 samples) through the quantized
   pair (window kernel), the float pair (f32 outer write-out) and the comp
   pair (comp outer write-out);
10. the front end: the CLI (``blackman_harris_win_tpu_torch.__main__.main``)
   in this process on the inputs above, each output through a ``.npy`` in a
   temporary directory: ``gen`` at BH-7 W=32 pw=26 wrap in the exact,
   outer, float and comp-pair modes and a TAYLOR Hamming W=16 window;
   ``spectrum --fft-mode mxu`` at the analyzer configuration on 3's x as
   ``.npy`` and as a raw i16 capture (through ``SampleSource``); ``ddc`` at
   config 21 on 7's x; ``stft`` on 9's x; ``suggest``.  Then two child
   processes prove the ``python -m`` route (``list --json``, a small
   ``gen`` on the card);
11. the sharded steps (``dist/``) on a mesh of four shards on the card,
   ``make_mesh(blocks=4, devices=[card] * 4)``, and a 2x2 one (and, where
   torch sees several cards, a mesh over distinct cards), at the sizes
   above, each stage gated against the single-device result the earlier
   phases hold: ``sharded_window`` HLS and RTL (1's and 2's windows, 0
   LSB, one ``window_block`` launch a shard), ``sharded_window_range`` at
   pw=31 over 4*2^20 samples around the peak (0 LSB against
   ``window_block`` over the same range), the TAYLOR Blackman window (6's),
   ``sharded_float_window`` and ``sharded_comp_window`` (4's write-outs,
   bit for bit or within the outer kernels' derived bounds); the sharded
   Welch on 3's x as (2, 64*2^20) on the 2x2 mesh (quantized with mxu and
   rfft, float with mxu, comp with rfft), per bin within 32*2^-24*sqrt(nfft)
   of a float64 reference on the circularly extended input; the sharded
   STFT/WOLA on 9's x (the round trip < 2e-5 at every sample, the frames
   against the single-device stft of the circularly extended input); the
   sharded DDC on 7's x (mixer ints 0 LSB against the plain NCO at the
   shard seams, the output within 7's FIR bound of ``ddc()`` and of a
   float64 FIR around the seams, one ``materialize`` a shard); the sharded
   SDR chain at config 5 (0 LSB against ``sdr_chain`` of the circularly
   extended input, or differing only where the two channelizers round the
   int I/Q differently).  Each stage's launches must be exactly one a shard
   of its kernel; its wall time (CUDA events, median of 5 after a warm-up)
   is printed beside the single-device call's;
12. the sharded steps across two processes on the card: two children of
   this script (``--child``, started with ``sys.executable``, each with a
   timeout) come up over gloo on localhost through
   ``dist.multihost.initialize`` and load the kernels the parent built.
   On mesh A, ``pod_mesh(channels=1, local_devices=[card] * 2)`` (process p
   holds blocks 2p and 2p+1), they run phase 11's stages at its sizes:
   ``sharded_window`` HLS BH-7 W=32 pw=26, the quantized Welch (mxu and
   rfft) on 3's x as (1, 128*2^20), the STFT/WOLA round trip on 9's x, the
   DDC on 7's x; on mesh B, ``pod_mesh(channels=2)`` (process p holds
   channel row p), a ``psum`` over 'channels' of 9's x as (2, 16*2^20).
   Each child's local shards must be bit-equal to the same step on a
   one-process mesh of ``[card] * 4`` of the same shape, each stage must
   launch its kernel exactly once a local shard in each child (four times
   in the one-process run), and the one-process outputs are held to phase
   11's references (phase 1's window, the float64 Welch, the round trip,
   ``ddc()`` within the FIR bound); each stage's wall time (host clock,
   median of 5) in each process is printed beside the one-process time.

Every kernel's launch counter is zeroed just before each phase and read
just after; a phase that did not launch a kernel of its path fails the run,
and so does a kernel no phase launched.  Then each output is checked:
generation 0-LSB against the plain PyTorch version on the CPU on random and
quadrant-seam blocks, the exact checksum identities, the float windows
against the float64 golden on every sample, the spectral floors at pw=16,
the analyzers against a float64 reference within the derived f32 budget,
the DDC against a float64 FIR of its exact integer mixer products, the SDR
tone offset and discriminator, the STFT round trips and frames of each
pair's stft against the golden window, every front-end output bit for bit
against the earlier phase's (the two spectra also within the analyzer's
budget), and each kernel against its plain
version on the card; torch.profiler breakdowns of one DDC call and of one
fft_mode="mxu" analyzer call (stage-1 kernel, window kernel, GEMMs,
elementwise and permute passes) must record device time.  Last, each kernel and its plain version are timed
with CUDA events (median of 5 after a warm-up; a checksum kernel's time is
per call of 16 back-to-back calls with distinct biases; the copy kernel,
its plain version and ``torch.clone`` are timed one call alone and, on a
line of their own, per call of 16 queued), beside its bound (the least
time the card could take: bytes over 3.35 TB/s or operations over the
peak rate of their type, the larger; integer operations at the issue
rate, one per lane per cycle) and, where one PyTorch call computes the
same function, that call's time (``torch.clone`` for the copy; for the f32
and comp write-outs ``torch.addmm`` and ``torch.baddbmm`` built from the
port's tables with TF32 off, gated as their kernels are before they are
timed; the port never calls them); the four float outer kernels' device
time under torch.profiler is printed beside their times.  The window kernel is timed on each
datapath it has at the timed size (2^26 samples: HLS and RTL BH-7 W=32 on
``r2s``, the analyzer's BH-4 W=17 saturate window on ``i32``), each beside
its operation bound; the build prints each kernel's ptxas registers and,
where ``cuobjdump`` exists, the SASS instructions of one unrolled CORDIC
iteration per datapath, of the bulk-copy ring's main loop, of the Taylor
kernels' run walk per sample, of the stage-1 kernel's FFT body and of one
row of each f32/comp outer instantiation's walk (its FFMA, LDS and STG),
with their local-memory instructions.  Phase 10's wall time per subcommand
(file I/O included), its host steps alone and the six mode rates of
``windows/modes.py:MODE_GSPS`` are printed with the card's name and power
limit.

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
import tempfile
import time
from pathlib import Path

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
        want = torch.cat([outer_block_int_plain(q, spec, m, int(h), 1, device="cpu")
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


def _counted(launched: dict, label: str, expect, fn, exact: dict | None = None):
    """Run one phase of the main path with every launch counter zeroed just
    before it and read just after; each kernel in ``expect`` must have been
    launched, and where ``exact`` is given the launches must be exactly
    those (kernel -> count, every other kernel none).  The counts add into
    ``launched``."""
    import torch

    from blackman_harris_win_tpu_torch import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_build.launches)
    for k, v in counts.items():
        launched[k] += v
    print(f"phase {label}: {secs:.3f} s host clock (first call), launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    missing = [k for k in expect if not counts[k]]
    _require(not missing, f"phase {label}: kernels {missing} were not launched")
    if exact is not None:
        got = {k: v for k, v in counts.items() if v}
        _require(got == exact, f"phase {label}: launches {got}, want exactly {exact}")
    return out


def _nco_blocks(fw: int, pw: int, rng, block: int = 4096) -> list[np.ndarray]:
    """Index blocks for the NCO gate: four random blocks in [0, 2^31); where
    the tuning word is odd (n -> n*fw mod 2^pw is then a bijection), the
    indices whose phase lies within +-3 of the quadrant seams 0, N/4, N/2,
    3N/4; and n = 0..63, which covers every phase an fc = 1/8 NCO visits."""
    n = 1 << pw
    blocks = [b + np.arange(block) for b in rng.integers(0, (1 << 31) - block, size=4)]
    if fw % 2:
        seams = np.array([(s + d) % n for s in (0, n // 4, n // 2, 3 * n // 4)
                          for d in range(-3, 4)], np.int64)
        blocks.append((seams * pow(fw, -1, n)) % n)
    blocks.append(np.arange(64))
    return blocks


def _ddc_gates(x, bb, h, fc: float, decim: int, pw: int, w: int, rng, dev) -> dict:
    """Gates of the DDC phase: the materialization kernel bit-equal to its
    input and its plain version on the mixer output it copies; the NCO 0 LSB
    against the CPU plain version at fc and at 0.2371; the tone gate of
    bench_all config 21; a random 2^16-output window against a float64 FIR
    of the exact integer mixer products, which TF32 would fail; the cuDNN TF32
    flag as it was before the call."""
    import torch

    from blackman_harris_win_tpu_torch.kernels.barrier import materialize, materialize_plain
    from blackman_harris_win_tpu_torch.pipeline.ddc import (
        MIX_IN_BITS,
        ddc,
        freq_word,
        mix_iq_int,
        nco_iq,
    )

    t = x.shape[-1]
    amp_in = float((1 << MIX_IN_BITS) - 1)
    xq = torch.round(x * amp_in).to(torch.int32)
    mi, mq = mix_iq_int(xq, torch.arange(t, device=dev), freq_word(fc, pw), pw, w)
    del xq
    m_int = torch.stack([mi, mq])
    del mi, mq
    m2 = m_int.to(torch.float32) * float(np.float32(1.0 / (amp_in * (1 << (w - 2)))))
    mat, plain = materialize(m2), materialize_plain(m2)
    bits = m2.view(torch.int32)
    _require(torch.equal(mat.view(torch.int32), bits) and torch.equal(plain.view(torch.int32), bits),
             "materialize: the copy of the mixer output is not bit-equal to it")
    mat_err = float((mat - plain).abs().max())
    print(f"materialize on the (2, {t}) mixer output: bit-equal to its input and to "
          "materialize_plain on the card")
    del mat, plain, m2

    for f in (fc, 0.2371):
        fw = freq_word(f, pw)
        blocks = _nco_blocks(fw, pw, rng)
        for blk in blocks:
            got = nco_iq(torch.from_numpy(blk).to(dev), fw, pw, w)
            want = nco_iq(blk, fw, pw, w, device="cpu")
            _require(all(torch.equal(g.cpu(), v) for g, v in zip(got, want)),
                     f"NCO fc={f}: differs from the CPU plain version")
        print(f"NCO dds48 pw={pw} W={w} fc={f}: {len(blocks)} blocks (random, phase seams) "
              "0-LSB equal to the CPU plain version")

    df, nt = 1 / 256, 16384
    tf32_before = torch.backends.cudnn.allow_tf32
    tone = torch.cos(2 * np.pi * (fc + df) * torch.arange(nt, device=dev, dtype=torch.float64))
    bbt = ddc(tone.to(torch.float32), fc, decim, taps=h).cpu().numpy()
    zt = (bbt[0].astype(np.float64) + 1j * bbt[1])[16:-16]
    f_meas = float(np.mean(np.diff(np.unwrap(np.angle(zt)))) / (2 * np.pi * decim))
    _require(abs(f_meas - df) < 1e-4, f"DDC tone gate: f_meas {f_meas} vs {df}")

    # output j >= head is the body FIR at input offset (j - head) * decim
    n_taps, nout = len(h), 1 << 16
    head = (n_taps - decim) // decim
    j0 = int(rng.integers(head, bb.shape[-1] - nout))
    b0 = (j0 - head) * decim
    m64 = m_int[:, b0:b0 + decim * (nout - 1) + n_taps].double() / (amp_in * (1 << (w - 2)))
    ref = m64.unfold(-1, n_taps, decim) @ torch.from_numpy(np.asarray(h, np.float64)).to(dev)
    err = float((bb[:, j0:j0 + nout].double() - ref).abs().max())
    # each f32 term h32 * m2 carries the taps' rounding, the int->f32
    # conversion, the f32 scale and the rescale product (4 roundings) plus
    # the n_taps roundings of the f32 dot product: gamma(n_taps + 4)
    u = 2.0**-24
    k = n_taps + 4
    sum_h, max_m = float(np.abs(h).sum()), float(m64.abs().max())
    bound = k * u / (1 - k * u) * sum_h * max_m
    _require(err <= bound, f"DDC vs float64 FIR: {err:.3e} > {bound:.3e}")
    _require(torch.backends.cudnn.allow_tf32 == tf32_before,
             "the DDC left cuDNN's TF32 flag changed")
    print(f"DDC: tone at fc+1/256 measured at {f_meas:.7f} (|err| {abs(f_meas - df):.2e} "
          f"< 1e-4); outputs [{j0}, +{nout}) vs float64 FIR of the exact mixer ints: "
          f"{err:.3e} (<= gamma(n_taps+4) x sum|h| x max|m| = {k}u/(1-{k}u) x {sum_h:.4f} x "
          f"{max_m:.4f} = {bound:.3e}), TF32 off inside the call; cuDNN TF32 flag as before it")
    return {"mat_err": mat_err, "fir_err": err, "fir_bound": bound, "f_meas": f_meas}


def _sdr_gates(label, x, out, proto, n_ch: int, aw: int, offset, rng, frames=None) -> None:
    """The chain's output is its own discriminator over the card's
    channelizer output and lies in the angle range; the discriminator on
    the card is 0 LSB against its CPU plain version on the same int I/Q
    (all of it, or a random run of ``frames`` outputs per channel); where
    the input is a tone at channel 1 + ``offset``, that offset comes back
    within 2e-3 (the dryrun's gate)."""
    import torch

    from blackman_harris_win_tpu_torch.pipeline.channelizer import polyphase_channelize
    from blackman_harris_win_tpu_torch.pipeline.demod import fm_demod_conj

    y = polyphase_channelize(x, proto, n_ch)
    i = torch.round(y.real * 2.0**14).to(torch.int32).mT
    q = torch.round(y.imag * 2.0**14).to(torch.int32).mT
    del y
    d_dev = fm_demod_conj(i, q, 16, aw)
    _require(torch.equal(d_dev.mT, out), f"SDR {label}: sdr_chain differs from its own "
             "discriminator")
    half = 1 << (aw - 1)
    _require(int(out.min()) >= -half and int(out.max()) < half,
             f"SDR {label}: output outside [-2^{aw - 1}, 2^{aw - 1})")
    nf = d_dev.shape[-1] if frames is None else min(frames, d_dev.shape[-1])
    a = int(rng.integers(0, d_dev.shape[-1] - nf + 1))
    d_cpu = fm_demod_conj(i[:, a:a + nf + 1].cpu(), q[:, a:a + nf + 1].cpu(), 16, aw)
    _require(torch.equal(d_dev[:, a:a + nf].cpu(), d_cpu),
             f"SDR {label}: fm_demod_conj on the card differs from the CPU")
    msg = (f"SDR {label}: output {tuple(out.shape)} in range; fm_demod_conj on the card 0-LSB "
           f"equal to the CPU plain version on {d_cpu.numel()} discriminator outputs")
    if offset is not None:
        f1 = float(out[:, 1].double().mean()) / (1 << aw)
        _require(abs(f1 - offset * n_ch) < 2e-3,
                 f"SDR {label}: channel-1 offset {f1} vs {offset * n_ch}")
        msg += (f"; channel-1 offset {f1:.6f} (want {offset * n_ch}, |err| "
                f"{abs(f1 - offset * n_ch):.2e} < 2e-3)")
    print(msg)


def _stft_frame_gate(name, fwd, x, dw_kernel: float, w_plain, gold, nfft: int, hop: int,
                     rng) -> None:
    """Three random frames of the pair's ``fwd(x)`` against a float64 rfft
    of the same samples times the golden window ``gold`` (float64).  The
    pair's window lies within dw of gold: ``dw_kernel`` (its generator
    against the plain version ``w_plain``, derived) plus max |w_plain -
    gold|, measured on the plain version (torch ops, no kernel).  Bound per
    bin: sum |x| dw, plus the f32 transform's normwise bound sqrt(nfft)
    (||x gold||_2 + dw ||x||_2) (7 log2(nfft) + 3) u: a radix-2 FFT with
    twiddles accurate to u (eta < 7u, Higham, Thm 24.2) after at most 3
    roundings per windowed sample (the comp pair's two products and their
    sum); any |err_k| <= ||err||_2."""
    import torch

    u = 2.0**-24
    dw = dw_kernel + float((w_plain - gold).abs().max())
    s = fwd(x)
    worst, bound = 0.0, 0.0
    for f in rng.choice(s.shape[-2], size=3, replace=False):
        xf = x[int(f) * hop:int(f) * hop + nfft].double()
        ref = torch.fft.rfft(xf * gold)
        err = float((s[int(f)].to(torch.complex128) - ref).abs().max())
        b = (float(xf.abs().sum()) * dw + np.sqrt(nfft) * (
            float((xf * gold).norm()) + dw * float(xf.norm()))
            * (7 * np.log2(nfft) + 3) * u)
        _require(err <= b, f"STFT {name} pair: frame {int(f)} vs float64 rfft x golden "
                 f"window {err:.3e} > {b:.3e}")
        worst, bound = max(worst, err), max(bound, b)
    print(f"STFT {name} pair: 3 frames vs float64 rfft of x x golden BH-4 window: max "
          f"{worst:.3e} (<= sum|x| dw + sqrt(nfft)(||x w||_2 + dw ||x||_2)(7 log2 nfft + 3)u, "
          f"dw = {dw:.3e}: {bound:.3e})")


def _stft_round_trips(x, spec, hop: int, dev) -> dict:
    """The three STFT pairs at ``spec`` (BH-4): build each (its window from
    the window kernel, the f32 or the comp outer write-out) and run
    istft(stft(x)); returns name -> (fwd, inv, interior max |y - x|)."""
    from blackman_harris_win_tpu_torch.pipeline.stft import (
        comp_stft_pair,
        float_stft_pair,
        quantized_stft_pair,
    )

    edge = spec.n - hop  # the first and last nfft - hop samples see fewer frames
    pairs = {
        "quantized": quantized_stft_pair("bh4", spec, hop, device=dev),
        "float": float_stft_pair("bh4", spec.phase_width, hop, device=dev),
        "comp": comp_stft_pair("bh4", spec.phase_width, hop, device=dev),
    }
    out = {}
    for name, (fwd, inv, _) in pairs.items():
        y = inv(fwd(x))
        out[name] = (fwd, inv, float((y - x)[edge:-edge].abs().max()))
    return out


def _sharded_stage(launched: dict, label: str, name: str, exact: dict, run, single, gate,
                   devices=()):
    """One stage of phase 11: ``run()`` (the sharded step) counted with its
    launches required to be exactly ``exact``, its output gated by
    ``gate(out)`` (which returns what it checked), then the step and the
    single-device call ``single()`` timed on the card (CUDA events, median
    of 5 after a warm-up).  Where the mesh spans other ``devices``, the
    current card's stream waits for theirs before the end event, so the
    time covers every shard.  Returns (sharded ms, single-device ms)."""
    import torch

    def joined():
        run()
        for d in devices:
            ev = torch.cuda.Event()
            with torch.cuda.device(d):
                ev.record()
            torch.cuda.current_stream().wait_event(ev)

    out = _counted(launched, f"11 {name}", tuple(exact), run, exact=exact)
    msg = gate(out)
    del out
    t_sh, t_1 = _time_ms(joined), _time_ms(single)
    print(f"sharded {label} {name}: sharded {t_sh:.3f} ms, single-device {t_1:.3f} ms "
          f"(x{t_sh / t_1:.2f}); launches {exact or 'none'}; {msg}")
    return t_sh, t_1


def _sdr_sharded_gate(out, x, proto, n_ch: int, aw: int, nblocks: int) -> str:
    """The sharded SDR chain against ``sdr_chain`` of the circularly
    extended input: 0 LSB, or else every differing output must read a frame
    whose int I/Q the two sides round differently, with the two channelizer
    outputs within the f32 budget of each other (each branch an f32 dot
    product of tpb terms, then the C-point DFT:
    C B (2 gamma(tpb) + 2 gamma(3 log2 C + 2)), B = sum|h| max|x|)."""
    import torch

    from blackman_harris_win_tpu_torch.pipeline.channelizer import polyphase_channelize
    from blackman_harris_win_tpu_torch.pipeline.sdr import sdr_chain

    t, halo = x.shape[-1], len(proto)
    xe = torch.cat([x[-halo:], x])
    want = sdr_chain(xe, proto, n_ch, angle_width=aw)
    _require(out.shape == want.shape, f"sharded SDR shape {tuple(out.shape)}")
    if torch.equal(out, want):
        return f"{tuple(out.shape)} 0-LSB equal to sdr_chain of the circularly extended input"
    tpb, u = halo // n_ch, 2.0**-24
    gamma = lambda k: k * u / (1 - k * u)  # noqa: E731
    budget = n_ch * float(np.abs(proto).sum()) * float(x.abs().max()) * (
        2 * gamma(tpb) + 2 * gamma(3 * np.log2(n_ch) + 2))
    y1 = polyphase_channelize(xe, proto, n_ch)
    b, fb = t // nblocks, t // nblocks // n_ch
    worst, ties = 0.0, 0
    for i in range(nblocks):
        xh = xe[i * b:i * b + b + halo]  # shard i's halo-extended chunk
        yi, yr = polyphase_channelize(xh, proto, n_ch), y1[i * fb:i * fb + fb + 1]
        worst = max(worst, float((yi - yr).abs().max()))
        agree = ((torch.round(yi.real * 2.0**14) == torch.round(yr.real * 2.0**14))
                 & (torch.round(yi.imag * 2.0**14) == torch.round(yr.imag * 2.0**14))).all(-1)
        ok_rows = agree[1:] & agree[:-1]  # output n reads frames n and n + 1
        ties += int((~ok_rows).sum())
        _require(torch.equal(out[i * fb:(i + 1) * fb][ok_rows], want[i * fb:(i + 1) * fb][ok_rows]),
                 f"sharded SDR shard {i}: differs where both sides' int I/Q agree")
    _require(worst <= budget, f"sharded SDR channelizer vs single-device {worst:.3e} > {budget:.3e}")
    n_diff = int((out != want).any(-1).sum())
    return (f"{tuple(out.shape)} not bit-equal: {n_diff} of {out.shape[0]} output rows differ, all "
            f"at {ties} rows whose int I/Q the two channelizers round differently (channelizer "
            f"outputs within {worst:.3e} <= f32 budget {budget:.3e}); 0 LSB elsewhere")


def _sharded_phase(launched: dict, dev, label: str, r: dict) -> dict:
    """Phase 11: the sharded steps on meshes of four shards on the card,
    ``make_mesh(blocks=4, devices=[dev] * 4)`` and a 2x2 one (and, where
    torch sees several cards, a mesh over distinct cards), at the earlier
    phases' full sizes, each gated against the single-device result those
    phases hold (``r``).  Returns stage -> (sharded ms, single-device ms)."""
    import torch

    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.dist.generate import (
        sharded_comp_window,
        sharded_float_window,
        sharded_window,
        sharded_window_range,
    )
    from blackman_harris_win_tpu_torch.dist.mesh import make_mesh, unshard
    from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
    from blackman_harris_win_tpu_torch.kernels.compwin import comp_window_pair
    from blackman_harris_win_tpu_torch.kernels.floatwin import float_window
    from blackman_harris_win_tpu_torch.kernels.window import make_window
    from blackman_harris_win_tpu_torch.kernels.window_kernel import window_block, window_values_plain
    from blackman_harris_win_tpu_torch.pipeline.ddc import (
        MIX_IN_BITS,
        ddc,
        freq_word,
        make_sharded_ddc,
        mix_iq_int,
        shard_mixer_ints,
    )
    from blackman_harris_win_tpu_torch.pipeline.sdr import make_sharded_sdr_chain, sdr_chain
    from blackman_harris_win_tpu_torch.pipeline.spectral import (
        make_sharded_welch,
        windowed_power_spectrum,
    )
    from blackman_harris_win_tpu_torch.pipeline.stft import (
        make_sharded_istft,
        make_sharded_stft,
        stft,
    )

    t0 = time.perf_counter()
    meshes = {"4 on one card": make_mesh(blocks=4, devices=[dev] * 4),
              "2x2 on one card": make_mesh(blocks=2, channels=2, devices=[dev] * 4)}
    ndev = torch.cuda.device_count()
    if ndev >= 2:
        k = 4 if ndev >= 4 else 2
        meshes[f"{k} cards"] = make_mesh(blocks=k)
    for mname, m in meshes.items():
        _require(all(d.type == "cuda" for row in m.devices for d in row),
                 f"mesh {mname}: holds a device that is not a card")
    print("phase 11 meshes: " + "; ".join(
        f"{k} {m.shape} on {[str(d) for row in m.devices for d in row]}" for k, m in meshes.items()))
    res = {}

    def stage(name, mesh_name, exact, run, single, gate):
        others = {d for row in meshes[mesh_name].devices for d in row} - {dev}
        res[f"{name} [{mesh_name}]"] = _sharded_stage(launched, label, f"{name} [{mesh_name}]",
                                                      exact, run, single, gate, sorted(
                                                          others, key=str))

    def equal_to(want, what):
        def gate(out):
            got = unshard(out)
            _require(torch.equal(got, want), f"sharded {what}: differs from the single-device "
                     "result")
            return f"{tuple(got.shape)} {got.dtype} bit-equal to {what} (0 LSB)"
        return gate

    # --- generation: no communication, one kernel launch per shard ---
    q7, spec_hls, spec_rtl, gpw = r["q7"], r["spec_hls"], r["spec_rtl"], r["pw"]
    gen_meshes = [k for k in meshes if k != "2x2 on one card"]
    for mname in gen_meshes:
        m = meshes[mname]
        nb = m.shape["blocks"]
        stage(f"gen hls bh7 w32 pw{gpw}", mname, {"window_block": nb},
              lambda m=m: sharded_window(q7, spec_hls, m),
              lambda: make_window("bh7", spec_hls, device=dev),
              equal_to(r["win_hls"], "phase 1's window"))
    m4 = meshes["4 on one card"]
    stage(f"gen rtl bh7 w32 pw{gpw}", "4 on one card", {"window_block": 4},
          lambda: sharded_window(r["q7_rtl"], spec_rtl, m4),
          lambda: make_window("bh7", spec_rtl, coeffs=r["q7_rtl"], device=dev),
          equal_to(r["win_rtl"], "phase 2's window"))
    spec31 = WindowSpec(31, 32, overflow="wrap")
    count = r["range_count"]
    n0 = (1 << 30) - count // 2  # around the peak of the 2^31-point window
    single31 = window_block(q7, spec31, n0, count, dev)
    plain31 = window_values_plain(torch.arange(n0, n0 + count, device=dev), q7, spec31)
    _require(torch.equal(single31, plain31), "pw=31 window_block vs plain on the card")
    del plain31
    stage(f"gen pw31 range bh7 w32 {count} around the peak", "4 on one card", {"window_block": 4},
          lambda: sharded_window_range(q7, spec31, m4, n0, count),
          lambda: window_block(q7, spec31, n0, count, dev),
          equal_to(single31, "window_block over the same range (itself 0 LSB against the "
                   "plain version on the card)"))
    del single31
    spec_tb = r["spec_taylor_blackman"]
    q_tb = r["q_taylor_blackman"]
    stage(f"gen taylor blackman w32 ls12 pw{gpw}", "4 on one card", {"taylor_window_block": 4},
          lambda: sharded_window(q_tb, spec_tb, m4),
          lambda: make_window("blackman", spec_tb, device=dev),
          equal_to(r["win_taylor_blackman"], "phase 6's window"))

    def float_gate(out):
        got, want = unshard(out), r["win_f32"]
        err, bound = float((got - want).abs().max()), ok.f32_pair_bound("bh7")
        _require(err <= bound, f"sharded f32 window vs phase 4's: {err:.3e} > {bound:.3e}")
        return (f"bit-equal to phase 4's write-out: {torch.equal(got, want)}; max |diff| "
                f"{err:.3e} (<= f32_pair_bound {bound:.3e})")

    stage(f"gen float bh7 pw{gpw}", "4 on one card", {"outer_block_f32": 4},
          lambda: sharded_float_window("bh7", gpw, m4),
          lambda: float_window("bh7", gpw, device=dev), float_gate)

    def comp_gate(out):
        s, e = (unshard(v) for v in out)
        err, bound = float((e - r["win_e"]).abs().max()), ok.comp_e_bound("bh7")
        _require(torch.equal(s, r["win_s"]) and err <= bound,
                 f"sharded comp pair: s bit-equal {torch.equal(s, r['win_s'])}, e {err:.3e} "
                 f"(bound {bound:.3e})")
        return (f"s bit-equal to phase 4's; e bit-equal {torch.equal(e, r['win_e'])}, max "
                f"|diff| {err:.3e} (<= comp_e_bound {bound:.3e})")

    stage(f"gen comp bh7 pw{gpw}", "4 on one card", {"outer_block_comp": 4},
          lambda: sharded_comp_window("bh7", gpw, m4),
          lambda: comp_window_pair("bh7", gpw, device=dev), comp_gate)

    # --- Welch: circular right halo, per-shard power, pmean over blocks ---
    x, spec4, nfft, hop = r["x"], r["spec4"], r["nfft"], r["hop"]
    x2 = x.view(2, -1)
    halo = nfft - hop
    budget = 32 * 2.0**-24 * np.sqrt(nfft)
    refs = {k: torch.stack([_f64_welch(torch.cat([row, row[:halo]]), w64, nfft, hop)
                            for row in x2]) for k, w64 in (("quantized", r["win64_q"]),
                                                           ("golden", r["win64_f"]))}
    welch_kernel = {"quantized": "window_block", "float": "outer_block_f32",
                    "comp": "outer_block_comp"}
    welch_runs = [("quantized", "mxu", "2x2 on one card"), ("quantized", "rfft", "2x2 on one card"),
                  ("float", "mxu", "2x2 on one card"), ("comp", "rfft", "2x2 on one card")]
    welch_runs += [("quantized", "rfft", k) for k in meshes if k.endswith("cards")]
    for wm, fm, mname in welch_runs:
        m = meshes[mname]
        coeffs = r["q4_17"] if wm == "quantized" else "bh4"
        step = make_sharded_welch(m, spec4, coeffs, r["shift4"], nfft, hop, win_mode=wm,
                                  fft_mode=fm)
        ref = refs["quantized" if wm == "quantized" else "golden"]

        def welch_gate(out, ref=ref, label=f"{wm}/{fm}"):
            got = unshard(out)
            _require(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                     f"sharded welch {label}: output {tuple(got.shape)}")
            rel = float(((got.double() - ref) / ref).abs().max())
            _require(rel < budget, f"sharded welch {label}: per-bin rel {rel:.3e} > {budget:.3e}")
            return (f"{tuple(got.shape)}, per-bin rel vs float64 of the circularly extended "
                    f"input {rel:.3e} (< 32*2^-24*sqrt(nfft) = {budget:.3e})")

        stage(f"welch {wm}/{fm} bh4 w17 nfft {nfft}, x {tuple(x2.shape)}", mname,
              {welch_kernel[wm]: m.shape["blocks"] * m.shape["channels"]},
              lambda step=step: step(x2),
              lambda wm=wm, fm=fm: windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode=wm,
                                                           fft_mode=fm),
              welch_gate)
    del refs

    # --- STFT/WOLA at phase 9's configuration: frames stay on their shard ---
    xs = r["x_stft"]
    fwd = make_sharded_stft(m4, spec4, r["q4_17"], r["shift4"], nfft, hop)
    inv = make_sharded_istft(m4, spec4, r["q4_17"], r["shift4"], nfft, hop)
    fwd1, inv1, win4 = r["stft_pair"]

    def stft_gate(out):
        got = unshard(out)
        want = stft(torch.cat([xs, xs[:halo]]).view(1, -1), win4, nfft, hop)
        err = float((got - want).abs().max())
        tol = budget * float(want.abs().max())
        _require(got.shape == want.shape and err <= tol,
                 f"sharded stft vs single-device: {err:.3e} > {tol:.3e}")
        return (f"{tuple(got.shape)} frames vs single-device stft of the circularly extended "
                f"input: bit-equal {torch.equal(got, want)}, max |diff| {err:.3e} (<= "
                f"{budget:.3e} x max|S| = {tol:.3e})")

    stage(f"stft quantized bh4 nfft {nfft} hop {hop}, {xs.numel()} samples", "4 on one card",
          {"window_block": 4}, lambda: fwd(xs.view(1, -1)), lambda: fwd1(xs), stft_gate)
    frames, frames1 = fwd(xs.view(1, -1)), fwd1(xs)

    def wola_gate(out):
        err = float((unshard(out).view(-1) - xs).abs().max())
        _require(err < 2e-5, f"sharded WOLA round trip {err:.3e} >= 2e-5")
        return f"round trip max |istft(stft(x)) - x| over every sample {err:.3e} (< 2e-5)"

    stage("istft quantized (the round trip)", "4 on one card", {"window_block": 4},
          lambda: inv(frames), lambda: inv1(frames1), wola_gate)
    del frames, frames1

    # --- the DDC, config 21: the halo on the raw input, the mixer per shard ---
    x21, h21 = r["x21"], r["h21"]
    fc, dec, pw, w = r["ddc_cfg"]
    t = x21.shape[-1]
    fw = freq_word(fc, pw)
    amp_in = float((1 << MIX_IN_BITS) - 1)
    xq21 = torch.round(x21 * amp_in).to(torch.int32)
    fir_bound = _ddc_fir_bound(xq21, h21, fw, pw, w)
    n_taps = len(h21)
    ddc_halo = n_taps - dec
    h64 = torch.from_numpy(np.asarray(h21, np.float64)).to(dev)
    for mname in gen_meshes:
        m = meshes[mname]
        nb = m.shape["blocks"]
        b = t // nb

        def ddc_gate(out, nb=nb, b=b):
            got = unshard(out, device=dev)
            bb = r["bb"]
            err_1 = float((got - bb).abs().max())
            _require(got.shape == bb.shape and err_1 <= fir_bound,
                     f"sharded DDC vs ddc(): {err_1:.3e} > {fir_bound:.3e}")
            # the mixer ints of each shard's extended chunk at its seam, 0 LSB
            # against the single-device plain NCO on the CPU
            for i in range(nb):
                first = i * b - ddc_halo - 64
                idx = torch.arange(first, first + 256, device=dev) % t
                si, sq = shard_mixer_ints(x21[idx], first, t, fw, pw, w, "dds48")
                pi, pq = mix_iq_int(xq21[idx].cpu(), idx.cpu(), fw, pw, w, device="cpu")
                _require(torch.equal(si.cpu(), pi) and torch.equal(sq.cpu(), pq),
                         f"sharded DDC shard {i}: mixer ints at its seam differ from the plain NCO")
            # outputs around every seam against the float64 circular FIR of the
            # exact mixer ints: y[j] = sum_t h[t] m[(j*decim - halo + t) mod T]
            nout = t // dec
            j = torch.cat([torch.arange(i * b // dec - 1024, i * b // dec + 1024, device=dev)
                           for i in range(nb)]) % nout
            idx = (j[:, None] * dec - ddc_halo + torch.arange(n_taps, device=dev)) % t
            ii, qq = mix_iq_int(xq21[idx.reshape(-1)], idx.reshape(-1), fw, pw, w)
            m64 = torch.stack([ii, qq]).double().reshape(2, -1, n_taps) / (amp_in * (1 << (w - 2)))
            err_64 = float((got[:, j].double() - m64 @ h64).abs().max())
            _require(err_64 <= fir_bound, f"sharded DDC vs float64 FIR at the seams: "
                     f"{err_64:.3e} > {fir_bound:.3e}")
            return (f"{tuple(got.shape)}; mixer ints at the {nb} seams 0 LSB against the plain "
                    f"NCO on the CPU; vs ddc() {err_1:.3e}, vs float64 circular FIR of the exact "
                    f"mixer ints at {len(j)} outputs around the seams {err_64:.3e} (each <= "
                    f"gamma(n_taps+4) x sum|h| x max|m| = {fir_bound:.3e}); bit-equal to ddc(): "
                    f"{torch.equal(got, bb)}")

        step = make_sharded_ddc(m, pw, w, fc, dec, taps=h21, flavor="dds48")
        stage(f"ddc config 21 ({t} samples, dds48 pw{pw} w{w}, decim {dec}, {n_taps} taps)", mname,
              {"materialize": nb}, lambda step=step: step(x21),
              lambda: ddc(x21, fc, dec, taps=h21, phase_width=pw, data_width=w, flavor="dds48"),
              ddc_gate)
    del xq21

    # --- the SDR chain, config 5: a left halo of one prototype length ---
    x5, proto5, c5, tpb5, aw = r["x_sdr5"], r["proto5"], r["c5"], r["tpb5"], r["aw"]
    sdr4 = make_sharded_sdr_chain(m4, c5, tpb5, angle_width=aw)
    stage(f"sdr config 5 ({c5} ch x {tpb5} taps, {x5.numel()} samples)", "4 on one card", {},
          lambda: sdr4(x5), lambda: sdr_chain(x5, proto5, c5, angle_width=aw),
          lambda out: _sdr_sharded_gate(unshard(out), x5, proto5, c5, aw, 4))
    print(f"phase 11: {time.perf_counter() - t0:.1f} s host clock, gates and timing included")
    return res


def _ddc_fir_bound(xq21, h21, fw: int, pw: int, w: int) -> float:
    """The DDC gates' f32 FIR bound, gamma(n_taps + 4) x sum|h| x max|m|, m
    the scaled mixer output of the quantized input ``xq21``."""
    import torch

    from blackman_harris_win_tpu_torch.pipeline.ddc import MIX_IN_BITS, mix_iq_int

    amp_in = float((1 << MIX_IN_BITS) - 1)
    mi, mq = mix_iq_int(xq21, torch.arange(xq21.shape[-1], device=xq21.device), fw, pw, w)
    max_m = float(torch.maximum(mi.abs().max(), mq.abs().max())) / (amp_in * (1 << (w - 2)))
    k, u = len(h21) + 4, 2.0**-24
    return k * u / (1 - k * u) * float(np.abs(h21).sum()) * max_m


def _seeded_inputs(seed: int, dev):
    """The main path's random inputs, drawn in this order from one generator
    seeded with ``--seed``: the analyzer's x (phase 3), the DDC's x21
    (phase 7), the STFT's x (phase 9) and the SDR chain's (phase 8)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(k, generator=gen, device=dev, dtype=torch.float32)
                 for k in (128 << 20, 1 << 26, 32 << 20, 16 << 22))


def _mp_steps(mesh_a, mesh_b, x, x21, x_stft) -> list:
    """Phase 12's steps, in the order every process runs them: (name, the
    kernel each shard launches once or None, step() -> Sharded).  Phase
    11's stages at its sizes on mesh A, (1, 4); a psum over 'channels' of
    x_stft as (2, 16 * 2^20) on mesh B, (2, 2)."""
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.dist.collectives import psum
    from blackman_harris_win_tpu_torch.dist.generate import sharded_window
    from blackman_harris_win_tpu_torch.dist.mesh import from_rows, shard
    from blackman_harris_win_tpu_torch.pipeline.ddc import make_sharded_ddc
    from blackman_harris_win_tpu_torch.pipeline.fir import design_lowpass
    from blackman_harris_win_tpu_torch.pipeline.spectral import make_sharded_welch
    from blackman_harris_win_tpu_torch.pipeline.stft import make_sharded_istft, make_sharded_stft
    from blackman_harris_win_tpu_torch.windows import catalog

    q7, spec_hls = catalog.get("bh7").quantized(32), WindowSpec(26, 32, overflow="wrap")
    d4, spec4 = catalog.get("bh4"), WindowSpec(20, 17, overflow="saturate")
    nfft, hop = spec4.n, 1 << 19
    welch = {fm: make_sharded_welch(mesh_a, spec4, d4.quantized(17), d4.shift, nfft, hop,
                                    fft_mode=fm) for fm in ("mxu", "rfft")}
    fwd = make_sharded_stft(mesh_a, spec4, d4.quantized(17), d4.shift, nfft, hop)
    inv = make_sharded_istft(mesh_a, spec4, d4.quantized(17), d4.shift, nfft, hop)
    frames = {}

    def stft_step():
        frames["s"] = fwd(x_stft.view(1, -1))
        return frames["s"]

    ddc_step = make_sharded_ddc(mesh_a, 20, 16, 1 / 8, 4, taps=design_lowpass(64, 0.8 / 4),
                                flavor="dds48")

    def psum_step():
        xs = shard(x_stft.view(2, -1), mesh_b, ("channels", "blocks"))
        nc, nb = mesh_b.shape["channels"], mesh_b.shape["blocks"]
        cols = [psum([xs.shards[c][b] for c in range(nc)]) for b in range(nb)]
        return from_rows(mesh_b, (None, "blocks"), [[cols[b][c] for b in range(nb)]
                                                   for c in range(nc)])

    return [
        ("gen hls bh7 w32 pw26", "window_block", lambda: sharded_window(q7, spec_hls, mesh_a)),
        (f"welch quantized/mxu bh4 w17 nfft {nfft}, x (1, {x.numel()})", "window_block",
         lambda: welch["mxu"](x.view(1, -1))),
        (f"welch quantized/rfft bh4 w17 nfft {nfft}, x (1, {x.numel()})", "window_block",
         lambda: welch["rfft"](x.view(1, -1))),
        (f"stft quantized bh4 nfft {nfft} hop {hop}, {x_stft.numel()} samples", "window_block",
         stft_step),
        ("istft quantized (the round trip)", "window_block", lambda: inv(frames["s"])),
        (f"ddc config 21 ({x21.numel()} samples, dds48 pw20 w16, decim 4, 64 taps)",
         "materialize", lambda: ddc_step(x21)),
        (f"psum over channels, x {tuple(x_stft.view(2, -1).shape)} (2x2)", None, psum_step),
    ]


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` in ms, the card synchronized after
    each call, over ``reps`` calls after one warm-up call: a call of a step
    across processes includes its waits on the others."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _mp_child(port: int, rank: int, out_dir: str, seed: int) -> int:
    """One of phase 12's two processes on the card: started over gloo
    through ``multihost.initialize``, it loads the kernels the parent built,
    runs :func:`_mp_steps` on meshes from ``pod_mesh(local_devices=[card] *
    2)`` (each stage's launches counted from zero), times each step, writes
    its local shards to ``out_dir/rank{rank}.pt`` and prints ``MP12 {json}``."""
    from datetime import timedelta

    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.dist import multihost

    dev = torch.device("cuda", 0)
    multihost.initialize(backend="gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                         rank=rank, timeout=timedelta(seconds=120))
    _require(_build.build()[2] == 0.0, "a phase 12 process compiled the kernels")
    meshes = [multihost.pod_mesh(channels=c, local_devices=[dev] * 2) for c in (1, 2)]
    x, x21, x_stft, _ = _seeded_inputs(seed, dev)
    tensors, launches, ms = {}, {}, {}
    for name, _, step in _mp_steps(*meshes, x, x21, x_stft):
        _build.reset_launches()
        out = step()
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in _build.launches.items() if v}
        tensors.update({f"{name}/{c},{b}": t.cpu() for (c, b), t in out.local_shards().items()})
        del out
        ms[name] = _wall_ms(step)
    torch.save(tensors, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print("MP12 " + json.dumps({"rank": rank, "launches": launches, "ms": ms}), flush=True)
    return 0


def _multiprocess_phase(launched: dict, dev, label: str, r: dict, seed: int) -> None:
    """Phase 12: the sharded steps across two processes on the card.  Two
    children of this script (``--child``) come up over gloo on localhost and
    run :func:`_mp_steps` on mesh A, ``pod_mesh(channels=1)`` (process p
    holds blocks 2p and 2p+1), and mesh B, ``pod_mesh(channels=2)`` (process
    p holds channel row p).  Their local shards must be bit-equal to the
    same steps on one-process meshes of ``[card] * 4`` of the same shapes,
    and each stage must launch its kernel exactly once per local shard; the
    one-process outputs are held to phase 11's references.  A child that
    fails or outlives its timeout fails the run."""
    import socket

    import torch

    from blackman_harris_win_tpu_torch.dist.mesh import unshard
    from blackman_harris_win_tpu_torch.dist.multihost import pod_mesh
    from blackman_harris_win_tpu_torch.pipeline.ddc import MIX_IN_BITS, freq_word
    from blackman_harris_win_tpu_torch.pipeline.stft import stft

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child", str(port), str(k), tmp,
             "--seed", str(seed)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k in range(2)]
        outs, deadline = [], time.monotonic() + 300
        try:
            for p in procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for k, (p, (out, err)) in enumerate(zip(procs, outs)):
            _require(p.returncode == 0, f"phase 12 process {k} failed ({p.returncode}):\n"
                     f"{out[-4000:]}\n{err[-4000:]}")
        results = [json.loads(next(s for s in out.splitlines() if s.startswith("MP12 "))[5:])
                   for out, _ in outs]
        shards = [torch.load(Path(tmp) / f"rank{k}.pt", weights_only=True) for k in range(2)]
    print(f"phase 12 processes: came up, ran and exited in {time.perf_counter() - t0:.1f} s")

    mesh_a = pod_mesh(channels=1, local_devices=[dev] * 4)
    mesh_b = pod_mesh(channels=2, local_devices=[dev] * 4)
    x, x21, x_stft = r["x"], r["x21"], r["x_stft"]
    nfft, hop = r["nfft"], r["hop"]
    halo, budget = nfft - hop, 32 * 2.0**-24 * np.sqrt(nfft)
    welch64 = _f64_welch(torch.cat([x, x[:halo]]), r["win64_q"], nfft, hop)
    fc, dec, pw, w = r["ddc_cfg"]
    xq21 = torch.round(x21 * float((1 << MIX_IN_BITS) - 1)).to(torch.int32)
    fir_bound = _ddc_fir_bound(xq21, r["h21"], freq_word(fc, pw), pw, w)
    del xq21

    def gate(name, one):
        """The one-process output against phase 11's references."""
        got = unshard(one)
        if name.startswith("gen"):
            _require(torch.equal(got, r["win_hls"]), "phase 12 generation vs phase 1's window")
            return "bit-equal to phase 1's window"
        if name.startswith("welch"):
            rel = float(((got[0].double() - welch64) / welch64).abs().max())
            _require(rel < budget, f"phase 12 {name}: per-bin rel {rel:.3e} > {budget:.3e}")
            return f"per-bin rel vs float64 {rel:.3e} (< {budget:.3e})"
        if name.startswith("stft"):
            want = stft(torch.cat([x_stft, x_stft[:halo]]).view(1, -1), r["stft_pair"][2], nfft,
                        hop)
            err = float((got - want).abs().max())
            _require(err <= budget * float(want.abs().max()), f"phase 12 stft {err:.3e}")
            return f"vs single-device stft of the circular input {err:.3e}"
        if name.startswith("istft"):
            err = float((got.view(-1) - x_stft).abs().max())
            _require(err < 2e-5, f"phase 12 WOLA round trip {err:.3e}")
            return f"round trip {err:.3e} (< 2e-5)"
        if name.startswith("ddc"):
            err = float((got - r["bb"]).abs().max())
            _require(err <= fir_bound, f"phase 12 ddc vs ddc(): {err:.3e} > {fir_bound:.3e}")
            return f"vs ddc() {err:.3e} (<= {fir_bound:.3e})"
        xb = x_stft.view(2, -1)
        _require(torch.equal(got[0], xb[0] + xb[1]), "phase 12 psum vs the sum of the rows")
        return "bit-equal to the sum of the two channel rows"

    for name, kernel, step in _mp_steps(mesh_a, mesh_b, x, x21, x_stft):
        exact = {kernel: 4} if kernel else {}
        one = _counted(launched, f"12 {name} [one process]", tuple(exact), step, exact=exact)
        per_process = {kernel: 2} if kernel else {}
        for k, res in enumerate(results):
            _require(res["launches"][name] == per_process,
                     f"phase 12 {name}: process {k} launched {res['launches'][name]}, want "
                     f"{per_process}")
            for kern, v in res["launches"][name].items():
                launched[kern] += v
            mine = {key: t for key, t in shards[k].items() if key.startswith(name + "/")}
            _require(len(mine) == 2, f"phase 12 {name}: process {k} holds {len(mine)} shards")
            for key, t in mine.items():
                c, b = (int(v) for v in key.rsplit("/", 1)[1].split(","))
                got, ref = t.to(dev), one.shards[c][b]
                _require(torch.equal(got, ref),
                         f"phase 12 {name}: process {k} shard ({c}, {b}) differs from the "
                         f"one-process mesh's (max |diff| {float((got - ref).abs().max()):.3e})")
        msg = gate(name, one)
        del one
        t_one = _wall_ms(step)
        print(f"multiprocess {label} {name}: process 0 {results[0]['ms'][name]:.3f} ms, process "
              f"1 {results[1]['ms'][name]:.3f} ms, one process {t_one:.3f} ms (host clock, median "
              f"of 5); launches a process {per_process or 'none'}; both processes' shards "
              f"bit-equal to the one-process mesh's; {msg}")
    print(f"phase 12: {time.perf_counter() - t0:.1f} s host clock, gates and timing included")


#: the raw i16 capture of phase 10: x scaled by 2^12 and rounded (|x| < 8)
I16_SCALE = 2.0**-12


def _cli(argv: list) -> tuple[float, str]:
    """One CLI command in this process, its stdout captured: (wall seconds,
    file I/O included; stdout).  The CLI copies its result to the host, so
    the device work has ended when it returns."""
    import contextlib
    import io

    from blackman_harris_win_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    secs = time.perf_counter() - t0
    _require(rc == 0, f"cli {' '.join(map(str, argv))}: exit {rc}")
    return secs, buf.getvalue()


def _front_end_inputs(tmp, x, x21, x_stft) -> dict:
    """Phase 10's input files from the run's own inputs: the analyzer's x as
    .npy and as a raw i16 capture, the DDC's and the STFT's x as .npy."""
    import torch

    xq = torch.clamp(torch.round(x / I16_SCALE), -32768, 32767).to(torch.int16)
    paths = {"x": tmp / "x.npy", "x_i16": tmp / "x.i16", "x21": tmp / "x21.npy",
             "x_stft": tmp / "x_stft.npy"}
    for key, t in (("x", x), ("x21", x21), ("x_stft", x_stft)):
        np.save(paths[key], t.cpu().numpy())
    xq.cpu().numpy().astype("<i2").tofile(paths["x_i16"])
    return paths


def _front_end_phase(tmp, paths: dict) -> dict:
    """Phase 10: the CLI in this process at the run's full sizes, each
    output to a .npy in ``tmp`` and read back; returns label -> (wall
    seconds, output array)."""
    gen7 = ["gen", "bh7", "--phase-width", "26", "--data-width", "32", "--overflow", "wrap"]
    spec4 = ["bh4", "--phase-width", "20", "--data-width", "17"]
    runs = {
        "gen exact": gen7,
        "gen outer": gen7 + ["--mode", "outer"],
        "gen float": gen7 + ["--mode", "float"],
        "gen comp-pair": gen7 + ["--mode", "comp-pair"],
        "gen taylor hamming": ["gen", "hamming", "--sin-type", "taylor", "--phase-width", "26",
                               "--data-width", "16"],
        "spectrum npy": ["spectrum", *spec4, "--fft-mode", "mxu", "--hop", "524288",
                         "--input", paths["x"]],
        "spectrum raw i16": ["spectrum", *spec4, "--fft-mode", "mxu", "--hop", "524288",
                             "--input", paths["x_i16"], "--format", "i16",
                             "--scale", repr(I16_SCALE)],
        "ddc": ["ddc", "--input", paths["x21"], "--freq", "0.125", "--decim", "4", "--taps",
                "64", "--phase-width", "20", "--data-width", "16", "--flavor", "dds48"],
        "stft": ["stft", *spec4, "--input", paths["x_stft"]],
    }
    out = {}
    for label, argv in runs.items():
        f = tmp / "out.npy"
        secs, _ = _cli(argv + ["--out", f])
        out[label] = (secs, np.load(f))
        f.unlink()
    secs, text = _cli(["suggest", "hamming", "--consumer", "int", "--exactness", "bit-exact"])
    out["suggest"] = (secs, json.loads(text))
    return out


def _front_end_gates(fe: dict, want: dict, spectra: dict, budget: float) -> None:
    """Phase 10's outputs against the earlier phases': ``want`` label ->
    array, bit for bit; ``spectra`` label -> (float64 reference, the same
    path's output called directly), within ``budget`` per bin of the
    reference, and bit-equal to the direct call or said not to be."""
    for label, w in want.items():
        got = fe[label][1]
        _require(got.dtype == w.dtype and got.shape == w.shape and np.array_equal(got, w),
                 f"cli {label}: {got.dtype}{got.shape} differs from the earlier phase's "
                 f"{w.dtype}{w.shape}")
        print(f"cli {label}: {got.dtype}{got.shape} bit-equal to the earlier phase's output")
    for label, (ref, direct) in spectra.items():
        got = fe[label][1].astype(np.float64)
        rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
        _require(rel < budget, f"cli {label}: per-bin rel err {rel:.3e} > {budget:.3e}")
        same = np.array_equal(fe[label][1], direct)
        print(f"cli {label}: per-bin rel vs float64 {rel:.3e} (< {budget:.3e}); "
              + ("bit-equal to the direct call" if same else
                 f"not bit-equal to the direct call (max rel "
                 f"{float(np.max(np.abs(got - direct) / np.abs(ref))):.3e}: cuBLAS chose "
                 "another algorithm)"))
    s = fe["suggest"][1]
    _require(s["mode"] == "taylor" and s["est_gsamp_s_64M_h100"] > 0,
             f"cli suggest: {s}")
    print(f"cli suggest hamming int bit-exact: {s}")


def _front_end_pieces(tmp, paths: dict, win, pair) -> dict:
    """Where phase 10's wall time goes: each host step of a CLI call alone
    at its size, host clock; returns label -> seconds."""
    import torch

    from blackman_harris_win_tpu_torch.kernels.compwin import normalize_pair
    from blackman_harris_win_tpu_torch.utils.io import SampleSource

    def clock(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def ingest():
        with SampleSource(paths["x_i16"], "i16", scale=I16_SCALE) as src:
            return src.read_block(0, len(src))

    secs = {}
    secs["np.load of the 512 MB x.npy"], xh = clock(lambda: np.load(paths["x"]))
    secs["host to card, 512 MB f32"], _ = clock(lambda: torch.from_numpy(xh).to(win.device))
    secs["SampleSource i16 read_block, 128*2^20 samples"], _ = clock(ingest)
    secs["card to host, 256 MB int32"], wh = clock(lambda: win.cpu().numpy())
    f = tmp / "w.npy"
    secs["np.save, 256 MB"], _ = clock(lambda: np.save(f, wh))
    f.unlink()
    sh, eh = pair[0].cpu().numpy(), pair[1].cpu().numpy()
    secs["normalize_pair (numpy), 2^26 samples"], _ = clock(lambda: normalize_pair(sh, eh))
    return secs


def _module_route(tmp, dev) -> dict:
    """The ``python -m`` route: ``list --json`` and a small ``gen`` on the
    card in a child process; returns label -> wall seconds."""
    import torch

    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels.window import make_window
    from blackman_harris_win_tpu_torch.windows import catalog

    secs = {}
    f = tmp / "w12.npy"
    for label, args in (("list --json", ["list", "--json"]),
                        ("gen bh4 pw12", ["gen", "bh4", "--phase-width", "12", "--out", str(f)])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "blackman_harris_win_tpu_torch", *args],
                           capture_output=True, text=True, timeout=300,
                           cwd=str(Path(__file__).resolve().parent))
        secs[label] = time.perf_counter() - t0
        _require(r.returncode == 0, f"python -m ... {label}: exit {r.returncode}\n{r.stderr}")
        if label == "list --json":
            names = [row["name"] for row in json.loads(r.stdout)]
            _require(names == catalog.names(), f"list --json names {names}")
    want = make_window("bh4", WindowSpec(12, 17), device=dev).cpu().numpy()
    _require(np.array_equal(np.load(f), want), "python -m gen bh4 pw12 differs from make_window")
    print("python -m blackman_harris_win_tpu_torch: list --json names the catalog; gen bh4 "
          "pw12 on the card bit-equal to make_window (" + torch.cuda.get_device_name(0) + ")")
    return secs


#: the window kernels' instantiations: mangled-name fragment -> datapath
_WINDOW_INSTANCES = {"ILi0ELi0E": "i32", "ILi1ELi1E": "r2s S=1", "ILi1ELi2E": "r2s S=2",
                     "ILi2ELi0E": "i64"}


def _print_sass(lib_path) -> None:
    """From ``cuobjdump -sass``: per window-kernel instantiation (datapath),
    its instruction count and the instructions of one unrolled CORDIC
    iteration of one chain (in the two-chain body, the median distance
    between the first shifts by successive immediates k, 8 <= k < 24,
    halved); for the bulk-copy ring of ``materialize``, its instruction count
    and the length of its main loop, one pass of which moves one stage (the
    widest backward branch).  Needs ``cuobjdump``; prints that it is missing
    otherwise.  The Taylor and stage-1 kernels: see ``_print_block_sass``."""
    import re
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found, instruction counts not measured")
        return
    r = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                       timeout=300)
    funcs = re.split(r"\n\s*Function : ", r.stdout)[1:]
    for body in funcs:
        name = body.split("\n", 1)[0].strip()
        if "materialize_bulk_kernel" in name:
            at = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
            spans = [int(a, 16) - int(m.group(1), 16) for a, text in at
                     if (m := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text))
                     and int(m.group(1), 16) < int(a, 16)]
            loop = f"{max(spans) // 16 + 1} instructions" if spans else "not found"
            print(f"sass materialize_bulk_kernel: {len(at)} instructions; main loop, one "
                  f"stage per pass, {loop}")
            continue
        if "taylor_" in name or "welch_stage1_kernel" in name:
            _print_block_sass(name, body)
            continue
        if "float_kernel" in name:
            _print_float_sass(name, body)
            continue
        if "window_block_kernel" not in name:
            continue
        dp = next((v for k, v in _WINDOW_INSTANCES.items() if k in name), name)
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
        first = {}
        for i, text in enumerate(ins):
            m = re.match(r"@?!?P?\w*\s*SHF\.R\.\S+\s+\w+,\s*\w+,\s*0x([0-9a-f]+),", text)
            if m and int(m.group(1), 16) not in first:
                first[int(m.group(1), 16)] = i
        gaps = [first[k + 1] - first[k] for k in range(8, 24) if k in first and k + 1 in first]
        per = f"{float(np.median(gaps)) / 2:.1f}" if gaps else "not found"
        print(f"sass window_block {dp}: {len(ins)} instructions; one unrolled CORDIC iteration "
              f"of one chain ~ {per} instructions")


#: csrc/taylor_kernel.cu: the Regime template values, and kG, the samples a
#: lane walks per tile in each kernel
_TAYLOR_REGIMES = {"0": "none", "1": "lut", "2": "tay1 W<19", "3": "tay1 W>=19"}
TAYLOR_KG = {"sincos": 8, "window": 8, "checksum": 16}


def _print_block_sass(name: str, body: str) -> None:
    """A Taylor or stage-1 kernel instantiation's SASS: its instruction
    count and its longest branch-free block.  In a Taylor kernel that block
    is a lane's run walk over kG samples, one generator (window: the first
    harmonic's), so its length over kG is the walk's instructions per sample
    and generator; in the stage-1 kernel it is the FFT-128's unrolled body."""
    import re

    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    targets = {int(m.group(1), 16) for _, text in ins
               if (m := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text))}
    longest = run = 0
    for addr, text in ins:
        if int(addr, 16) in targets:
            run = 0
        run += 1
        longest = max(longest, run)
        if re.search(r"\b(BRA|EXIT|RET|BRX|JMP|CALL)\b", text):
            run = 0
    local = sum(1 for _, text in ins if re.search(r"\b(LDL|STL)", text))
    regs = re.findall(r"ILi(\d)E", name)
    if "taylor_" in name:
        kind = next(k for k in ("sincos", "window", "checksum") if f"taylor_{k}" in name)
        inst = "/".join(_TAYLOR_REGIMES.get(r, r) for r in regs)
        kg = TAYLOR_KG[kind]
        print(f"sass taylor_{kind} ({inst}): {len(ins)} instructions; longest branch-free "
              f"block {longest}, {longest / kg:.1f} per sample of a {kg}-sample run walk; "
              f"{local} local-memory instructions")
    else:
        print(f"sass welch_stage1 ({'16-byte' if regs == ['4'] else '4-byte'} copies): "
              f"{len(ins)} instructions; longest branch-free block {longest}; {local} "
              "local-memory instructions")


def _print_float_sass(name: str, body: str) -> None:
    """An f32/comp outer kernel instantiation's SASS: its instruction count,
    its local-memory instructions, and the FFMA, LDS and STG instructions of
    one pass of its row walk (the innermost loop that holds FFMAs: one h row
    at the thread's V lanes, V = 4, or 1 in the runtime-count
    instantiations)."""
    import re

    m = re.search(r"float_kernelILi(\d)ELi(n?\d)ELi(n?\d)ELb([01])E", name)
    if not m:
        print(f"sass float_kernel: unrecognised instantiation {name[:80]}")
        return
    mode, nc, npl, summed = m.groups()
    runtime = nc.startswith("n")  # NC = -1: the runtime-count instantiation
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    addr = [int(a, 16) for a, _ in ins]
    loops = [(int(b.group(1), 16), a) for a, (_, text) in zip(addr, ins)
             if (b := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text)) and int(b.group(1), 16) < a]
    count = {}
    for lo, hi in sorted(loops, key=lambda span: span[1] - span[0]):
        texts = [t for a, (_, t) in zip(addr, ins) if lo <= a <= hi]
        if any(re.search(r"\bFFMA\b", t) for t in texts):
            count = {k: sum(1 for t in texts if re.search(rf"\b{k}", t))
                     for k in ("FFMA", "LDS", "STG")}
            count["instructions"] = len(texts)
            break
    local = sum(1 for _, t in ins if re.search(r"\b(LDL|STL)", t))
    what = ("f32 K-1=" + ("runtime" if runtime else nc) if mode == "1"
            else "comp (C,P)=" + ("runtime" if runtime else f"({nc},{npl})"))
    lanes = 1 if runtime else 4
    walk = (", ".join(f"{v} {k}" for k, v in count.items()) if count else "not found")
    print(f"sass float_kernel {what} {'checksum' if summed == '1' else 'write-out'}: "
          f"{len(ins)} instructions; one row of the walk ({lanes} samples): {walk}; "
          f"{local} local-memory instructions")


def _library_outer(name: str, pw: int, m: int, dev):
    """The PyTorch calls that compute the f32 window and the raw comp pair
    from the port's own tables, each one call (timed beside the write-out
    kernels as their yardstick; the port never calls them), with TF32 off:

    - f32: ``torch.addmm(a0, [ch | -sh], [cl ; sl])``, (nh, nl);
    - comp: ``torch.baddbmm`` over a batch of two with the bias (a0_hi,
      a0_lo): the s batch pairs ch_hi with cl_hi and sh_hi with -sl_hi (the
      other columns zero), the e batch ch_hi with cl_lo, ch_lo with cl_f,
      sh_hi with -sl_lo, sh_lo with -sl_f and each plain (ch, sh) with
      (cl, -sl); s and e are the two halves of one (2, nh, nl) output.

    Returns (f32 fn, comp fn): the window flat as the write-out lays it out,
    and the pair as a (2, n) tensor."""
    import torch

    from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
    from blackman_harris_win_tpu_torch.kernels.compwin import DEFAULT_THRESH, GRID_BITS
    from blackman_harris_win_tpu_torch.kernels.floatwin import _resolve_coeffs
    from blackman_harris_win_tpu_torch.pipeline.spectral import _full_fp32

    coeffs = _resolve_coeffs(name)
    tf = ok._f32_tiles(coeffs, pw, m, dev)
    a_f = torch.cat([tf.hi[:, :tf.nk], -tf.hi[:, tf.nk:]], dim=1).contiguous()
    bias_f = torch.full((1, 1), tf.a0, dtype=torch.float32, device=dev)
    tc = ok._comp_tiles(coeffs, pw, m, GRID_BITS, DEFAULT_THRESH, dev)
    c, lo = tc.nk, tc.lo
    zero = torch.zeros_like(lo[0])
    rows_s, rows_e = [], []
    for j in range(c):
        cl_hi, cl_lo, cl_f, sl_hi, sl_lo, sl_f = lo[6 * j:6 * j + 6]
        rows_s += [cl_hi, zero, -sl_hi, zero]
        rows_e += [cl_lo, cl_f, -sl_lo, -sl_f]
    for j in range(tc.npl):
        rows_s += [zero, zero]
        rows_e += [lo[6 * c + 2 * j], -lo[6 * c + 2 * j + 1]]
    keep = torch.zeros(tc.hi.shape[1], dtype=torch.float32, device=dev)
    keep[0:4 * c:4] = 1.0
    keep[2:4 * c:4] = 1.0
    a_c = torch.stack([tc.hi * keep, tc.hi]).contiguous()
    b_c = torch.stack([torch.stack(rows_s), torch.stack(rows_e)]).contiguous()
    bias_c = torch.tensor([tc.a0, tc.a0lo], dtype=torch.float32, device=dev).view(2, 1, 1)

    def f32():
        with _full_fp32():
            return torch.addmm(bias_f, a_f, tf.lo).view(-1)

    def comp():
        with _full_fp32():
            return torch.baddbmm(bias_c, a_c, b_c).view(2, -1)

    return f32, comp


def _device_ms(fn, calls: int = 5) -> float:
    """Device time per call of ``fn`` under torch.profiler: every CUDA
    kernel and copy it ran, summed, over ``calls`` calls after a warm-up.
    No device time fails the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    _require(us > 0, "torch.profiler recorded no device time")
    return us / 1e3 / calls


#: device-time groups of the two profiled calls, in match order: name ->
#: substrings of a kernel's name (lower case); the rest is the last group
DDC_GROUPS = {"materialize": ("materialize",),
              "FIR (conv, gemm)": ("conv", "cudnn", "gemm", "xmma", "cutlass", "gemv", "dot"),
              "elementwise": ()}
ANALYZER_GROUPS = {"welch_stage1": ("welch_stage1",),
                   "window_block": ("window_block",),
                   "GEMM": ("gemm", "xmma", "cutlass", "gemv", "dot", "cublas", "sm90_"),
                   "elementwise or permute": ()}


def _profile(fn, label: str, groups: dict) -> dict:
    """One call of ``fn`` under torch.profiler: device time by kernel,
    grouped by ``groups``, beside the call's CUDA-event wall time.  A
    profile without device time fails the run.  Returns group -> ms, with
    the wall and busy times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    _require(bool(rows) and sum(r[1] for r in rows) > 0,
             f"{label} profile: torch.profiler recorded no device time")
    out = dict.fromkeys(groups, 0.0)
    rest = list(groups)[-1]
    for key, ms, _ in rows:
        k = key.lower()
        out[next((g for g, subs in groups.items() if any(x in k for x in subs)), rest)] += ms
    busy = sum(out.values())
    print(f"profile {label} (one call): wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{max(0.0, 1 - busy / wall):.1%}; " + "; ".join(f"{k} {v:.3f} ms"
                                                         for k, v in out.items()))
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  profile kernel {ms:9.3f} ms  x{cnt:<3d} {key[:110]}")
    return {**out, "wall": wall, "busy": busy}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20260516,
                    help="seed of the random gate blocks and the analyzer input")
    # one of phase 12's processes: PORT RANK OUT_DIR
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        return _mp_child(int(args.child[0]), int(args.child[1]), args.child[2], args.seed)

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
    from blackman_harris_win_tpu_torch.kernels.barrier import materialize, materialize_plain
    from blackman_harris_win_tpu_torch.kernels.compwin import (
        DEFAULT_THRESH,
        GRID_BITS,
        comp_window_flops,
        comp_window_pair,
        normalize_pair,
    )
    from blackman_harris_win_tpu_torch.kernels.floatwin import float_window, float_window_flops
    from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
    from blackman_harris_win_tpu_torch.kernels.outerwin import DEFAULT_SPLIT, window_block_outer
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
    from blackman_harris_win_tpu_torch.pipeline.channelizer import design_prototype
    from blackman_harris_win_tpu_torch.pipeline.ddc import MIX_IN_BITS, ddc, freq_word, mix_iq_int
    from blackman_harris_win_tpu_torch.pipeline.fir import decimating_fir, design_lowpass
    from blackman_harris_win_tpu_torch.pipeline.sdr import sdr_chain
    from blackman_harris_win_tpu_torch.pipeline.spectral import (
        window_scale,
        windowed_power_spectrum,
    )
    from blackman_harris_win_tpu_torch.utils import profiling
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
    fn = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.strip()
        elif "Used" in line or "spill" in line:
            print(f"  ptxas {fn}: {line.split('info    :')[-1].strip()}")
    _print_sass(path)

    # --- 2. the main path, counted ---
    pw, w = 26, 32
    n = 1 << pw
    q7 = catalog.get("bh7").quantized(w)
    spec_hls = WindowSpec(pw, w, overflow="wrap")
    q7_rtl = rtl_cordic_coeffs(q7)
    spec_rtl = WindowSpec(pw, w, rounding="rtl", overflow="wrap")
    spec4 = WindowSpec(20, 17, overflow="saturate")
    nfft, hop, nsamp = spec4.n, 1 << 19, 128 << 20
    c5, tpb5 = 16, 8  # bench_all config 5: noise through a 16-channel bank
    x, x21, x_stft, x_sdr5 = _seeded_inputs(args.seed, dev)
    torch.cuda.synchronize()

    launched = dict.fromkeys(_build.launches, 0)
    t0 = time.perf_counter()
    win_hls, chk = _counted(launched, "1 generation", ("window_block", "window_checksum"),
                            lambda: (make_window("bh7", spec_hls, device=dev),
                                     window_checksum(q7, spec_hls, 0, 4 * n, bias=0, device=dev)))
    win_rtl = _counted(launched, "2 rtl generation", ("window_block",),
                       lambda: make_window("bh7", spec_rtl, coeffs=q7_rtl, device=dev))
    ps_mxu = _counted(launched, "3 analyzer", ("window_block", "welch_stage1"),
                      lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="mxu"))
    # outer-product modes, bench_all configs 11/13/15 (BH-7, pw=26, m=11)
    m = 11
    nrows = n >> m
    bias = 123457

    def outer_phase():
        fns = (ok.make_checksum_fn(q7, spec_hls, m=m, rows=256, device=dev),
               ok.make_checksum_fn_f32("bh7", pw, m=m, rows=256, device=dev),
               ok.make_checksum_fn_comp("bh7", pw, m=m, rows=256, device=dev))
        return (window_block_outer(0, nrows, q7, spec_hls, m=m, device=dev),
                float_window("bh7", pw, device=dev), comp_window_pair("bh7", pw, device=dev),
                fns, tuple(f(bias) for f in fns))

    (win_outer, win_f32, (win_s, win_e), (chk_outer_fn, chk_f32_fn, chk_comp_fn),
     (chk_outer, chk_f32, chk_comp)) = _counted(
        launched, "4 outer-product modes",
        ("outer_block", "outer_checksum", "outer_block_f32", "outer_checksum_f32",
         "outer_block_comp", "outer_checksum_comp"), outer_phase)
    ps_float, ps_comp = _counted(
        launched, "5 analyzer float/comp", ("outer_block_f32", "welch_stage1", "outer_block_comp"),
        lambda: (windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode="float",
                                         fft_mode="mxu"),
                 windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode="comp",
                                         fft_mode="rfft")))
    # the TAYLOR source, bench_all configs 16-18 (pw=26, 2^26 phases)
    tay_cfgs = ((16, 10), (32, 12))  # (W, LS)
    tay_specs = {  # name -> spec: HLS through the kernel, RTL/taylor2 in torch ops
        "blackman": WindowSpec(pw, 32, sin_type="taylor", lut_size=12, overflow="wrap"),
        "hamming": WindowSpec(pw, 16, sin_type="taylor", lut_size=10, overflow="saturate"),
        "hamming rtl": WindowSpec(pw, 16, sin_type="taylor", rounding="rtl", lut_size=10,
                                  overflow="saturate"),
        "bh7 taylor2": WindowSpec(pw, 32, sin_type="taylor2", lut_size=12, overflow="wrap"),
    }

    def taylor_phase():
        cs = {cfg: taylor_sincos_block(0, n, pw, *cfg, device=dev) for cfg in tay_cfgs}
        fns = {cfg: tk.make_checksum_fn_taylor(pw, *cfg, rows=64, device=dev) for cfg in tay_cfgs}
        return (cs, fns, {cfg: fns[cfg](0, bias) for cfg in tay_cfgs},
                {k: make_window(k.split()[0], sp, device=dev) for k, sp in tay_specs.items()})

    tay_cs, tay_fns, tay_chk, tay_win = _counted(
        launched, "6 taylor", ("taylor_sincos_block", "taylor_checksum", "taylor_window_block"),
        taylor_phase)
    # the DDC, bench_all config 21
    fc21, dec21, pw21, w21 = 1 / 8, 4, 20, 16
    h21 = design_lowpass(64, 0.8 / dec21)
    bb = _counted(launched, "7 ddc", ("materialize",),
                  lambda: ddc(x21, fc21, dec21, taps=h21, phase_width=pw21, data_width=w21,
                              flavor="dds48"))
    # the SDR chain: dryrun stage 4's configuration over 2^22 samples (a
    # latency check with the tone gate) and bench_all config 5
    n_ch, tpb, aw, offset = 4, 6, 20, 0.005
    proto = design_prototype(n_ch, tpb)
    proto5 = design_prototype(c5, tpb5)
    nn = torch.arange(1 << 22, device=dev, dtype=torch.float64)
    x_sdr = torch.cos(2 * np.pi * (1 / n_ch + offset) * nn).to(torch.float32)
    del nn
    sdr_out, sdr5_out = _counted(launched, "8 sdr", (),
                                 lambda: (sdr_chain(x_sdr, proto, n_ch, angle_width=aw),
                                          sdr_chain(x_sdr5, proto5, c5, angle_width=aw)))
    # STFT/WOLA round trips at the analyzer configuration
    stft_res = _counted(launched, "9 stft", ("window_block", "outer_block_f32", "outer_block_comp"),
                        lambda: _stft_round_trips(x_stft, spec4, hop, dev))
    # the front end: the CLI in this process on the inputs above, at full size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = _front_end_inputs(Path(tmp), x, x21, x_stft)
        fe = _counted(launched, "10 front end",
                      ("window_block", "taylor_window_block", "outer_block", "outer_block_f32",
                       "outer_block_comp", "welch_stage1", "materialize"),
                      lambda: _front_end_phase(Path(tmp), paths))
        fe_route = _module_route(Path(tmp), dev)
        fe_pieces = _front_end_pieces(Path(tmp), paths, win_hls, (win_s, win_e))
    main_s = time.perf_counter() - t0
    print(f"main path: {main_s:.3f} s host clock (first call), launches {launched}")
    for name, c in launched.items():
        _require(c > 0, f"kernel {name} was not launched by the main path")
    counts = launched

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
    err_fc = _gate_float_checksum(
        "f32 checksum", chk_f32_fn, chk_f32, bias,
        lambda b: ok.checksum_plain_f32("bh7", pw, m, 256, b, device=dev),
        (win_f32,), (f32_plain,), ok.checksum_depth("bh7", pw, m, device=dev),
        ok.checksum_plain_depth(nrows, 1 << m, 256))
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
        (win_s, win_e), (s_plain, e_plain), ok.checksum_depth("bh7", pw, m, comp=True, device=dev),
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
    # the library yardsticks, gated as their kernels are before they are timed
    lib_f32, lib_comp = _library_outer("bh7", pw, m, dev)
    err_lf = float((lib_f32() - ok.outer_block_f32_plain("bh7", pw, m, 0, nrows,
                                                         device=dev)).abs().max())
    _require(err_lf <= f32_bound, f"torch.addmm f32 window vs plain {err_lf:.3e} > {f32_bound:.3e}")
    pair_lib = lib_comp()
    s_plain, e_plain = ok.outer_block_comp_plain("bh7", pw, m, GRID_BITS, DEFAULT_THRESH, 0,
                                                 nrows, device=dev)
    err_le = float((pair_lib[1] - e_plain).abs().max())
    _require(torch.equal(pair_lib[0], s_plain) and err_le <= e_bound,
             f"torch.baddbmm comp pair: s bit-equal {torch.equal(pair_lib[0], s_plain)}, e vs "
             f"plain {err_le:.3e} (bound {e_bound:.3e})")
    del pair_lib, s_plain, e_plain
    print(f"library calls: torch.addmm f32 window vs plain {err_lf:.3e} (<= {f32_bound:.3e}); "
          f"torch.baddbmm comp pair s bit-equal to plain, e vs plain {err_le:.3e} "
          f"(<= {e_bound:.3e}); TF32 off")

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

    # --- the DDC, the SDR chain and the STFT round trips: gates ---
    _require(bb.shape == (2, (1 << 26) // dec21) and bool(torch.isfinite(bb).all()),
             f"DDC output is not finite of shape (2, 2^26/{dec21})")
    ddc_res = _ddc_gates(x21, bb, h21, fc21, dec21, pw21, w21, rng, dev)
    _require(sdr_out.shape == ((1 << 22) // n_ch - tpb, n_ch), "SDR output shape")
    _sdr_gates("dryrun 4x6", x_sdr, sdr_out, proto, n_ch, aw, offset, rng)
    _require(sdr5_out.shape == ((c5 << 22) // c5 - tpb5, c5), "SDR config 5 output shape")
    _sdr_gates("config 5 16x8", x_sdr5, sdr5_out, proto5, c5, aw, None, rng, frames=1 << 16)
    del sdr5_out
    for name, (_, _, err) in stft_res.items():
        _require(err < 2e-5, f"STFT {name} pair: round trip interior max err {err:.3e} >= 2e-5")
    print("STFT/WOLA round trips, nfft 2^20 hop 2^19, 32*2^20 samples, interior max "
          "|istft(stft(x)) - x|: " + ", ".join(f"{k} {v[2]:.3e}" for k, v in stft_res.items())
          + " (< 2e-5)")
    # each pair's stft against the golden window: the round trip divides by
    # the window, so it alone cannot see a wrong one
    m4 = min(DEFAULT_SPLIT, spec4.phase_width - 1)
    rows4 = nfft >> m4
    gold4 = torch.from_numpy(catalog.float_window_value("bh4", np.arange(nfft), nfft)).to(dev)
    wq_plain = (window_values_plain(torch.arange(nfft, device=dev), d4.quantized(17), spec4)
                .double() * window_scale(spec4, d4.shift))
    s4p, e4p = ok.outer_block_comp_plain("bh4", spec4.phase_width, m4, GRID_BITS,
                                         DEFAULT_THRESH, 0, rows4, device=dev)
    plain4 = {  # name -> (derived |pair window - plain|, plain window in float64)
        # f32(int) * f32(scale): the scale's rounding and the product's
        "quantized": (2 * 2.0**-24 * float(wq_plain.abs().max()), wq_plain),
        "float": (ok.f32_pair_bound("bh4"), ok.outer_block_f32_plain(
            "bh4", spec4.phase_width, m4, 0, rows4, device=dev).double()),
        # s bit-equal to plain, e within its evaluation-order bound
        "comp": (ok.comp_e_bound("bh4"), s4p.double() + e4p.double()),
    }
    del s4p, e4p
    for name, (fwd, _, _) in stft_res.items():
        _stft_frame_gate(name, fwd, x_stft, *plain4[name], gold4, nfft, hop, rng)
    del plain4, wq_plain, gold4

    # --- the front end: gates ---
    xq = torch.clamp(torch.round(x / I16_SCALE), -32768, 32767).to(torch.int16).float() * I16_SCALE
    spectra = {
        "spectrum npy": (ref.cpu().numpy(), ps_mxu.cpu().numpy()),
        "spectrum raw i16": (_f64_welch(xq, win64, nfft, hop).cpu().numpy(),
                             windowed_power_spectrum(xq, "bh4", spec4, hop=hop,
                                                     fft_mode="mxu").cpu().numpy()),
    }
    del xq
    _front_end_gates(fe, {
        "gen exact": win_hls.cpu().numpy(),
        "gen outer": win_outer.cpu().numpy(),
        "gen float": win_f32.cpu().numpy(),
        "gen comp-pair": np.stack(normalize_pair(win_s, win_e)),
        "gen taylor hamming": tay_win["hamming"].cpu().numpy(),
        "ddc": bb.cpu().numpy(),
        "stft": stft_res["quantized"][0](x_stft).cpu().numpy(),
    }, spectra, budget)
    fe_secs = {k: v[0] for k, v in fe.items()}
    del fe, spectra

    # --- 11. the sharded steps on meshes over the card: counted, gated, timed ---
    win4 = wq.to(torch.float32) * float(np.float32(window_scale(spec4, d4.shift)))
    sharded_refs = {
        "q7": q7, "q7_rtl": q7_rtl, "spec_hls": spec_hls, "spec_rtl": spec_rtl,
        "win_hls": win_hls, "win_rtl": win_rtl, "spec_taylor_blackman": tay_specs["blackman"],
        "q_taylor_blackman": catalog.get("blackman").quantized(32),
        "win_taylor_blackman": tay_win["blackman"], "win_f32": win_f32, "win_s": win_s,
        "win_e": win_e, "x": x, "spec4": spec4, "nfft": nfft, "hop": hop, "win64_q": win64,
        "win64_f": win64_4, "q4_17": d4.quantized(17), "shift4": d4.shift, "x_stft": x_stft,
        "stft_pair": (stft_res["quantized"][0], stft_res["quantized"][1], win4), "bb": bb,
        "x21": x21, "h21": h21, "ddc_cfg": (fc21, dec21, pw21, w21), "x_sdr5": x_sdr5,
        "proto5": proto5, "c5": c5, "tpb5": tpb5, "aw": aw, "pw": pw, "range_count": 4 << 20}
    _sharded_phase(launched, dev, f"[{smi}]", sharded_refs)
    print(f"main path with phase 11: launches {launched}")
    # --- 12. the sharded steps across two processes on the card ---
    _multiprocess_phase(launched, dev, f"[{smi}]", sharded_refs, args.seed)
    del win4, sharded_refs
    print(f"main path with phase 12: launches {launched}")

    # --- 4. each kernel against its plain version on the card, timed ---
    plain_hls = window_values_plain(idx, q7, spec_hls)
    err_1a = int((plain_hls.long() - win_hls.long()).abs().max())
    plain_rtl = window_values_plain(idx, q7_rtl, spec_rtl)
    err_1a_rtl = int((plain_rtl.long() - win_rtl.long()).abs().max())
    # the i32 datapath at the timed size: the analyzer's window over 2^26
    q4_17, spec17 = d4.quantized(17), WindowSpec(pw, 17, overflow="saturate")
    win17 = window_block(q4_17, spec17, 0, n, dev)
    err_1a_i32 = int((window_values_plain(idx, q4_17, spec17).long() - win17.long()).abs().max())
    _require(err_1a == 0 and err_1a_rtl == 0 and err_1a_i32 == 0,
             f"window kernel vs plain on the card: {err_1a}, {err_1a_rtl}, {err_1a_i32} LSB")
    err_1a = max(err_1a, err_1a_rtl, err_1a_i32)
    del plain_hls, plain_rtl, win17
    chk_plain = window_checksum_plain(q7, spec_hls, 0, 4 * n, device=dev)
    err_1b = abs(int(chk) - int(chk_plain))
    _require(err_1b == 0, f"checksum kernel {int(chk)} != plain {int(chk_plain)}")
    print("window kernels vs plain on the card: 0 LSB (hls w32 r2s, rtl w32 r2s, hls w17 "
          "saturate i32, checksum)")

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
        "window_block_i32": (
            _time_ms(lambda: window_block(q4_17, spec17, 0, n, dev)),
            _time_ms(lambda: window_values_plain(idx, q4_17, spec17)),
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
    # the analyzer's device time by kernel (phase 3's call), for the matmul tail
    _profile(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="mxu"),
             f"{label} analyzer mxu", ANALYZER_GROUPS)
    # the barrier kernel on the DDC's own mixer output, (2, 2^26) f32
    amp_in = float((1 << MIX_IN_BITS) - 1)
    n21 = torch.arange(1 << 26, device=dev)

    def mixer():  # the DDC's NCO, integer mixer and f32 rescale
        xq = torch.round(x21 * amp_in).to(torch.int32)
        mi, mq = mix_iq_int(xq, n21, freq_word(fc21, pw21), pw21, w21)
        return torch.stack([mi, mq]).to(torch.float32) * float(
            np.float32(1.0 / (amp_in * (1 << (w21 - 2)))))

    m21 = mixer()
    # one call per event pair, as the DDC makes it; the per-call time of 16
    # queued calls, which hides the host's launch latency, is printed beside
    t["materialize"] = (_time_ms(lambda: materialize(m21)),
                        _time_ms(lambda: materialize_plain(m21)))
    lib_ms = {"materialize": _time_ms(lambda: torch.clone(m21)),
              "outer_block_f32": _time_ms(lib_f32), "outer_block_comp": _time_ms(lib_comp)}
    # the four float outer kernels' device time (torch.profiler) beside their
    # one-call-alone time, and the library calls'
    dev_ms = {"outer_block_f32": _device_ms(lambda: float_window("bh7", pw, device=dev)),
              "outer_checksum_f32": _device_ms(lambda: chk_f32_fn(0)),
              "outer_block_comp": _device_ms(lambda: comp_window_pair("bh7", pw, device=dev)),
              "outer_checksum_comp": _device_ms(lambda: chk_comp_fn(0)),
              "torch.addmm": _device_ms(lib_f32), "torch.baddbmm": _device_ms(lib_comp)}
    queued = {k: _time_batch_ms(lambda _, f=f: f(m21)) for k, f in (
        ("kernel", materialize), ("plain", materialize_plain), ("torch.clone", torch.clone))}
    for name, (ms, plain_ms) in t.items():
        print(f"time {label} {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms)")
    print(f"time {label} materialize library call torch.clone: {lib_ms['materialize']:.3f} ms")
    for k, call in (("outer_block_f32", "torch.addmm"), ("outer_block_comp", "torch.baddbmm")):
        print(f"time {label} {k} library call {call}: {lib_ms[k]:.3f} ms one call alone, "
              f"{dev_ms[call]:.4f} ms device time")
    for k in ("outer_block_f32", "outer_checksum_f32", "outer_block_comp", "outer_checksum_comp"):
        print(f"time {label} {k}: {dev_ms[k]:.4f} ms device time (torch.profiler, per call of "
              f"5; a checksum's finalize kernel included), {t[k][0]:.3f} ms "
              f"{'per call of 16 queued' if 'checksum' in k else 'one call alone'}")
    print(f"time {label} materialize per call of 16 queued: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in queued.items()))
    mat_bytes = 2 * m21.numel() * m21.element_size()
    print(f"rates {label}: materialize {mat_bytes / t['materialize'][0] / 1e9:.3f} TB/s alone, "
          f"{mat_bytes / queued['kernel'] / 1e9:.3f} TB/s queued; torch.clone "
          f"{mat_bytes / lib_ms['materialize'] / 1e9:.3f} TB/s alone, "
          f"{mat_bytes / queued['torch.clone'] / 1e9:.3f} TB/s queued")
    for key, dp, q, sp in (("window_block", "r2s", q7, spec_hls),
                           ("window_block_rtl", "r2s", q7_rtl, spec_rtl),
                           ("window_block_i32", "i32", q4_17, spec17)):
        iters = sp.data_width - (sp.rounding == "rtl")
        b_ms, b_by = profiling.bound(4 * n, profiling.cordic_window_int_ops(
            n, len(q), sp.data_width, sp.rounding))
        print(f"bound {label} {key} ({sp.rounding} W={sp.data_width} {len(q)} terms, datapath "
              f"{dp}, {iters} iterations): {b_ms:.4f} ms ({b_by}); measured {t[key][0]:.3f} ms, "
              f"roofline share {b_ms / t[key][0]:.1%}")

    # the DDC's wall time and its pieces (CUDA events), and one call profiled
    def run_ddc():
        return ddc(x21, fc21, dec21, taps=h21, phase_width=pw21, data_width=w21)

    halo21 = len(h21) - dec21
    mat21 = materialize(m21)
    taps21 = torch.from_numpy(h21.astype(np.float32)).to(dev).reshape(1, 1, -1)
    seg21 = torch.cat([m21[..., -halo21:], m21[..., :halo21]], dim=-1)
    t_ddc = {
        "ddc (whole call)": _time_ms(run_ddc),
        "NCO + mixer + rescale (torch ops)": _time_ms(mixer),
        "materialize kernel": t["materialize"][0],
        "conv1d body (cuDNN, fp32)": _time_ms(lambda: torch.nn.functional.conv1d(
            mat21.reshape(-1, 1, 1 << 26), taps21, stride=dec21)),
        "wrap segment FIR": _time_ms(lambda: decimating_fir(seg21, h21, dec21)),
    }
    del mat21
    print(f"time {label} DDC 2^26 samples, decim {dec21}, 64 taps, dds48 pw={pw21} W={w21}: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in t_ddc.items())
          + f"; {(1 << 26) / t_ddc['ddc (whole call)'] / 1e3:.1f} Msamples/s in")
    _profile(run_ddc, f"{label} ddc", DDC_GROUPS)
    t_sdr = _time_ms(lambda: sdr_chain(x_sdr, proto, n_ch, angle_width=aw))
    print(f"time {label} SDR chain latency check, 2^22 samples, 4 channels x 6 taps, AW=20 "
          f"(torch ops, no kernel): {t_sdr:.3f} ms")
    t_sdr5 = _time_ms(lambda: sdr_chain(x_sdr5, proto5, c5, angle_width=aw))
    print(f"time {label} SDR chain bench_all config 5, 16*2^22 samples, 16 channels x 8 taps, "
          f"AW=20 (torch ops, no kernel): {t_sdr5:.3f} ms; "
          f"{(c5 << 22) / t_sdr5 / 1e3:.1f} Msamples/s in")
    for name, (fwd, inv, _) in stft_res.items():
        spec_x = fwd(x_stft)
        t_f, t_i = _time_ms(lambda: fwd(x_stft)), _time_ms(lambda: inv(spec_x))
        print(f"time {label} STFT {name} pair, 32*2^20 samples, nfft 2^20 hop 2^19: "
              f"stft {t_f:.3f} ms, istft {t_i:.3f} ms")
        del spec_x
    for k in ("hamming rtl", "bh7 taylor2"):  # torch ops on the card, no kernel
        ms = _time_ms(lambda k=k: make_window(k.split()[0], tay_specs[k], device=dev))
        print(f"time {label} taylor window {k} (torch ops, no kernel): {ms:.3f} ms")
    for k, secs in fe_secs.items():
        print(f"time {label} cli {k}: {secs:.3f} s wall (phase 10, in process, file I/O "
              "included)")
    for k, secs in fe_route.items():
        print(f"time {label} cli python -m {k}: {secs:.3f} s wall (child process)")
    print(f"time {label} cli pieces (host clock, each alone): " + "; ".join(
        f"{k} {secs:.3f} s" for k, secs in fe_pieces.items()))
    mode_ms = {"exact": t["window_block"][0], "rtl": t["window_block_rtl"][0],
               "taylor": t["taylor_window_block blackman"][0], "outer": t["outer_block"][0],
               "float": t["outer_block_f32"][0], "comp": t["outer_block_comp"][0]}
    print(f"mode rates {label} (MODE_GSPS: 2^26 samples over one call alone, Gsamples/s): "
          + json.dumps({k: round(n / ms / 1e6, 3) for k, ms in mode_ms.items()}))
    print(f"rates {label}: window_block {n / t['window_block'][0] / 1e3:.1f} "
          f"Msamples/s, window_checksum {4 * n / t['window_checksum'][0] / 1e3:.1f} "
          f"Msamples/s, analyzer mxu {nsamp / t['analyzer mxu vs rfft'][0] / 1e3:.1f} "
          "Msamples/s in")
    print(f"rates {label}: " + ", ".join(
        f"{k} {n / t[k][0] / 1e3:.1f} Msamples/s (plain {n / t[k][1] / 1e3:.1f})"
        for k in ("outer_block", "outer_checksum", "outer_block_f32", "outer_checksum_f32",
                  "outer_block_comp", "outer_checksum_comp")))
    # the no-fusion f32 op models of the float modes (FMA pairs count 4 ops)
    gflops_f32 = float_window_flops(n, len(q7)) / t["outer_checksum_f32"][0] / 1e6
    gflops_comp = comp_window_flops(n, "bh7") / t["outer_checksum_comp"][0] / 1e6
    print(f"rates {label}: outer_checksum_f32 {gflops_f32:.1f} GFLOP/s, "
          f"outer_checksum_comp {gflops_comp:.1f} GFLOP/s (no-fusion op models)")
    print(f"rates {label}: " + ", ".join(
        f"{k} {n / t[k][0] / 1e3:.1f} Msamples/s" for k in t if k.startswith("taylor")))

    src = "blackman_harris_win_tpu_torch/csrc/"
    bounds = profiling.kernel_bounds(n, len(q7), nsamp, nfft, hop,
                                     m21.numel() * m21.element_size())
    err_mat = ddc_res["mat_err"]
    tpu = "blackman_harris_win_tpu/kernels/pallas/"
    rows = [  # name, source, replaces, timing key, max abs err
        ("window_block", "window_kernel.cu", "window_kernel.py:378", "window_block", err_1a),
        ("window_checksum", "window_kernel.cu", "window_kernel.py:378", "window_checksum",
         err_1b),
        ("welch_stage1", "welchfft_kernel.cu", "welchfft_kernel.py:77", "welch_stage1", err_s1),
        ("outer_block", "outerwin_kernel.cu", "outerwin_kernel.py:86", "outer_block", err_ob),
        ("outer_checksum", "outerwin_kernel.cu", "outerwin_kernel.py:86", "outer_checksum",
         err_oc),
        ("outer_block_f32", "outerwin_kernel.cu", "outerwin_kernel.py:276", "outer_block_f32",
         err_fb),
        ("outer_checksum_f32", "outerwin_kernel.cu", "outerwin_kernel.py:276",
         "outer_checksum_f32", err_fc),
        ("outer_block_comp", "outerwin_kernel.cu", "outerwin_kernel.py:170", "outer_block_comp",
         err_e),
        ("outer_checksum_comp", "outerwin_kernel.cu", "outerwin_kernel.py:170",
         "outer_checksum_comp", err_ccp),
        ("taylor_sincos_block", "taylor_kernel.cu", "taylor_kernel.py:71",
         "taylor_sincos_block w32", err_tcs),
        ("taylor_window_block", "taylor_kernel.cu", "taylor_kernel.py:71",
         "taylor_window_block blackman", err_twin),
        ("taylor_checksum", "taylor_kernel.cu", "taylor_kernel.py:71", "taylor_checksum w32",
         err_tck),
        ("materialize", "barrier_kernel.cu", "barrier.py:31", "materialize", err_mat),
    ]
    kernels = []
    for name, source, replaces, key, err in rows:
        bound_ms, bound_by = bounds[name]
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": tpu + replaces, "launches": counts[name],
                        "max_abs_err": err, "ms": t[key][0], "plain_ms": t[key][1],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms.get(name)})
        print(f"bound {label} {name}: {bound_ms:.4f} ms ({bound_by}); measured {t[key][0]:.3f} ms,"
              f" roofline share {bound_ms / t[key][0]:.1%}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s host clock in all, build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
