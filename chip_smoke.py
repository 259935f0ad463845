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
   for the window, kernel 2 for framing + window + DFT stage 1) and
   fft_mode="rfft" (kernel 1a, cuFFT, then one launch of the power mean
   kernel ``welch_power_mean``); the phase's launches must be exactly
   these;
4. the outer-product fast modes at the bench_all size (BH-7, W=32, pw=26,
   wrap, m=11): the int window (outer write-out) and its in-kernel
   checksum, the float32 window and its checksum, the compensated (s, e)
   pair and its checksum;
5. the analyzer with the new window modes at the size of 3: float32 window
   (f32 outer write-out) into fft_mode="mxu" (kernel 2), and the comp pair
   (comp outer write-out) into fft_mode="rfft" (``welch_power_mean``);
6. the TAYLOR source at the bench_all size of configs 16-18 (pw=26): the raw
   (cos, sin) engine written out at W=16/LS=10 and W=32/LS=12, the in-kernel
   checksum of each (rows=64), the Blackman W=32 LS=12 wrap and Hamming W=16
   LS=10 saturate HLS windows through ``make_window`` (Taylor window
   kernel), the taylor2 BH-7 W=32 LS=12 wrap window through ``make_window``
   (one launch of the taylor2 kernel ``taylor2_window_block``), and the
   RTL-contract TAYLOR Hamming W=16 LS=10 and Blackman W=32 LS=12 windows
   through ``make_window`` (one launch each of the RTL Taylor kernel
   ``taylor_window_rtl``; the Blackman one's 3-term tree is 34 bits wide);
   the phase's launches must be exactly these;
7. the DDC at bench_all config 21: 2^26 float32 samples, fc = 1/8, decim 4,
   64 taps (``design_lowpass(64, 0.2)``), dds48 NCO at pw=20 W=16; its
   NCO repeats every 8 samples, so one launch of the table kernel
   (``ddc_nco_table``) writes those 8 (cos, -sin) pairs, and its quantizer,
   table read, integer mixer and f32 rescale are one launch of the mixer
   kernel (``ddc_mixer``); its decimating FIR takes the bulk branch, which
   runs the materialization kernel (kernel 7) before the strided conv:
   exactly one launch of each;
8. the SDR chain (one launch of the polyphase branch FIR kernel
   ``polyphase_fir`` and the half-spectrum FFT ``torch.fft.rfft`` of its
   real branches, then one launch of the discriminator kernel ``fm_demod``, which reads the C/2 + 1 bins in
   place, the channels past C/2 as conjugates, quantizes the channel I/Q
   and runs the conjugate-product CORDIC atan2; no DDC, so no mixer
   launch) at the multichip dryrun's stage-4 configuration (4 channels, 6
   taps per branch, AW=20) over a 2^22-sample tone, a latency check, and at
   bench_all config 5 (16 channels, 8 taps per branch) over 16 * 2^22 noise
   samples: exactly one ``polyphase_fir`` and one ``fm_demod`` launch a
   call; at the SDR cell's configuration (a complex64 capture, 128 channels
   of 16 taps) over 2^22 noise samples: exactly one launch of the fused
   channelizer ``polyphase_dft`` (branch FIRs and the DFT across the
   branches) and one ``fm_demod``; the PFB spectrometer
   (``pipeline.spectrometer.pfb_power``) at its cell's shape, one board's
   16 seeded int8 feeds of (8 * 1024 + 3) * 2048 words through a
   2048-channel bank of 4 taps a branch, 8 integrations of 1024 spectra:
   exactly one ``polyphase_fir`` (every feed in one launch) and one
   ``welch_power_mean`` (its slab path) a call; then
   the demod module's other entry points on config 5's quantized channel
   I/Q: ``atan2_fixed`` (one launch of ``cordic_atan2``) and
   ``fm_demod_phase`` on the (16, T) transpose of its (T, 16) I/Q (one of
   ``fm_demod``, the integer front end, whose output keeps the inputs'
   stride order);
9. STFT/WOLA round trips at the analyzer configuration (BH-4 W=17 pw=20
   saturate, nfft 2^20, hop 2^19, 32 * 2^20 samples) through the quantized
   pair (window kernel), the float pair (f32 outer write-out) and the comp
   pair (comp outer write-out);
10. the front end: the CLI (``blackman_harris_win_tpu_torch.__main__.main``)
   in this process on the inputs above, each output through a ``.npy`` in a
   temporary directory: ``gen`` at BH-7 W=32 pw=26 wrap in the exact,
   outer, float, comp-pair and taylor2 (LS=12) modes and a TAYLOR Hamming
   W=16 window, then, counted on its own, ``gen`` of 6's RTL TAYLOR Hamming
   window (exactly one ``taylor_window_rtl`` launch);
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
   ``window_block`` over the same range), the TAYLOR Blackman window, the
   RTL TAYLOR Blackman window (one ``taylor_window_rtl`` a shard) and
   the taylor2 BH-7 window (6's, one ``taylor2_window_block`` a shard),
   ``sharded_float_window`` and ``sharded_comp_window`` (4's write-outs,
   bit for bit or within the outer kernels' derived bounds); the sharded
   Welch on 3's x as (2, 64*2^20) on the 2x2 mesh (quantized with mxu and
   rfft, float with mxu, comp with rfft), per bin within 32*2^-24*sqrt(nfft)
   of a float64 reference on the circularly extended input; the sharded
   STFT/WOLA on 9's x (the round trip < 2e-5 at every sample, the frames
   against the single-device stft of the circularly extended input); the
   sharded DDC on 7's x (mixer ints 0 LSB against the plain NCO at the
   shard seams, the output within 7's FIR bound of ``ddc()`` and of a
   float64 FIR around the seams, one ``ddc_nco_table``, one ``ddc_mixer``
   and one ``materialize`` a shard; the mixer kernel's time at a shard's
   size and the sharded call's device time are printed); the sharded SDR
   chain at config 5
   (one ``polyphase_fir`` and one ``fm_demod`` a shard; 0 LSB against
   ``sdr_chain`` of the circularly
   extended input, or differing only where the two channelizers round the
   int I/Q differently).  Each stage's launches must be exactly one a shard
   of each of its kernels; its wall time (CUDA events, median of 5 after a warm-up)
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
   launch each of its kernels exactly once a local shard in each child
   (four times in the one-process run), and the one-process outputs are held to phase
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
the Welch power mean kernel against its plain version on the card (per
bin within 2e-6, the same bits run again) on the analyzer's half spectrum,
the 2-D one of the sharded analyzer, a small-K one that cuts the frames
into slabs and a complex128 one, the polyphase branch FIR kernel against
its plain version on the card (each output within 2 gamma(tpb + 1) x
sum |h| |x|, one launch, the same bits run again) at config 5 and at the
SDR cell's shape (2^26 complex64 samples, 128 branches of 16 taps), each
timed alone, queued and beside its plain version and byte bound, and at
the cell's shape the fused entry that adds the DFT across the branches
(``polyphase_dft``: one launch, the same bits run again, within its
bound of the branch kernel and cuFFT, timed beside them; its ptxas line),
the PFB spectrometer's two kernels at its cell's shape (the branch FIRs
of the int8 capture the same bits as of its float32 copy and within 2
gamma(tpb + 1) x sum |h| |x| of the plain version; the power mean on the
(16, 8, 1024, 1025) bins within one float32 rounding of their float64
mean and within gamma(n_acc + 3) of its plain version, one launch each,
the same bits run again and the same bits as the phase's call; each
timed beside its plain version and byte bound, and the whole call),
the DDC against a float64 FIR of its exact integer mixer products, the DDC
mixer kernel bit-equal to its plain version on the card over 2^26 samples
on each of its paths (config 21's table of P = 8, the odd word 104857 at
pw=20 whose table holds P = 2^20, and an odd word at pw=31, computed per
sample), its table kernel 0 LSB against the plain NCO, and the mixer 0 LSB
against the CPU plain version on random blocks (n0 up to 2^33) of either
path, around every quadrant seam and on tables that hold the seams, at
dds48 and scaled, pw 20/31/24, the SDR
tone offset and discriminator (the config-5 output 0 LSB against the plain
discriminator in torch ops over ``torch.fft.fft``'s full spectrum on the
card, and against the CPU plain version on random runs; the full-spectrum
entry bit-equal to the half-spectrum one; the atan2 kernel in both conventions on int32 and int64
words and the phase discriminator on random and seam blocks at AW
16/20/24/31 P=1, AW 30 P=2 (32-bit words), AW 31 P=2 and AW 40 (64-bit
words), 0 LSB against the CPU plain versions; ``fm_demod_phase`` and
``fm_demod_conj`` on config 5's transposed I/Q and on its contiguous rows
0 LSB against their plain versions on the card, each in the plain
version's layout), the taylor2 window bit-equal
to ``window_values_fast`` on the card over all 2^26 samples and its blocks
at n0 0, N/4+-1, N/2, 3N/4, N-1 for LS 9/10/12/14, W 16/17/32, wrap and
saturate, 0 LSB against the CPU plain version, the two RTL TAYLOR windows
bit-equal to ``taylor_window_rtl_plain`` on the card over all 2^26 samples
and RTL blocks (W 8..32, 2 and 3 terms, pw 12..31, unaligned starts, across
the period end) 0 LSB against the CPU plain version, the STFT round trips and
frames of each
pair's stft against the golden window, every front-end output bit for bit
against the earlier phase's (the two spectra also within the analyzer's
budget), and each kernel against its plain
version on the card; torch.profiler breakdowns of one DDC call, of one
config-5 SDR call (discriminator kernel, polyphase kernel, FFT, the rest)
and of one fft_mode="mxu" analyzer call (stage-1 kernel, window kernel,
GEMMs, elementwise and permute passes) must record device time.  Last, each kernel and its plain version are timed
with CUDA events (median of 5 after a warm-up; a checksum kernel's time is
per call of 16 back-to-back calls with distinct biases; the copy kernel,
its plain version and ``torch.clone`` are timed one call alone and, on a
line of their own, per call of 16 queued), beside its bound (the least
time the card could take: bytes over 3.35 TB/s or operations over the
peak rate of their type, the larger; integer operations at the issue
rate, one per lane per cycle) and, where one PyTorch call computes the
same function, that call's time (the integer discriminator's two modes on
config 5's I/Q in both layouts too, each beside its byte bound;
``torch.clone`` for the copy; for the f32
and comp write-outs ``torch.addmm`` and ``torch.baddbmm`` built from the
port's tables with TF32 off, gated as their kernels are before they are
timed; the port never calls them); the six outer kernels' device time
under torch.profiler is printed beside their times.  The window kernel is timed on each
datapath it has at the timed size (2^26 samples: HLS and RTL BH-7 W=32 on
``r2s``, the analyzer's BH-4 W=17 saturate window on ``i32``), each beside
its operation bound; the build prints each kernel's ptxas registers and,
where ``cuobjdump`` exists, the SASS instructions of one unrolled CORDIC
iteration per datapath, of the bulk-copy ring's main loop, of the Taylor
kernels' run walk per sample, of the stage-1 kernel's FFT body and of one
row of each outer instantiation's walk (f32/comp: its FFMA, LDS and STG;
int: its IMAD.WIDE, IADD3, LEA.HI, SHF, LDS and STG), with their
local-memory instructions, and of one CORDIC iteration of the DDC mixer
kernel's compute path (its W=17 instantiation less its W=16 one, over the
samples a thread computes), its table pass (the row loop, per sample) and
its table kernel, of the atan2 kernels (one vectoring iteration of the
unrolled chain: the spacing of its sign masks of y), of the taylor2
kernels (the median branch-free block: one harmonic of one sample) and of
the RTL Taylor kernel's accumulate per sample (its branch-free
block of the products a_k * cos_k + 2^(W-2), over the 8 samples of a lane),
each split into the instructions of the integer ALU pipe, the FMA pipe
(IMAD and f32 arithmetic) and the FP64 pipe; an int, a mixer or table, an
atan2/discriminator, a taylor2, an RTL Taylor or the fused polyphase
instantiation whose ptxas line shows a stack frame or spills, or whose SASS holds local-memory
instructions, fails the run.
The mixer kernel's time on each path (beside its bound), its launches a
DDC call, the DDC's device time and the torch-op NCO + mixer time (its
plain version, a comparison row only) are printed for phases 7, 11 and 12,
and phase 8's (none).  The SDR chain's time at config 5 is printed with its
pieces (the channelizer, the discriminator kernel on the half spectrum and
on the full one, and its plain version).  Phase 10's
wall time per subcommand
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
import re
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


def _welch_power_gates(x, win32, nfft: int, hop: int, dev) -> tuple[float, tuple]:
    """The Welch power mean kernel (``welchpower_kernel.frame_power_mean``)
    against its plain version on the card: per bin within 2e-6 relative
    (the plain version rounds ``hypot``, the square and a float32 tree of
    255 terms, about 16 float32 ulps; the kernel sums in float64), one
    launch a call and the same bits when run again, on the analyzer's
    (255, 524289) complex64 half spectrum, ``make_sharded_welch``'s 2-D
    (2, 127, 524289), a (65535, 2049) one at nfft 4096 (the slab path) and a
    complex128 (31, 524289).  Then the analyzer's shape timed: one call
    alone, per call of 16 queued, the plain version, beside the byte bound.
    Returns (the widest relative gap, (ms alone, plain ms))."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import welchpower_kernel as wp
    from blackman_harris_win_tpu_torch.pipeline.spectral import frames_view

    def spec_of(xx, n, h):
        w = win32 if n == nfft else torch.hann_window(n, device=dev)
        return torch.fft.rfft(frames_view(xx, n, h) * w.to(xx.dtype), dim=-1)

    cases = {"analyzer": lambda: spec_of(x, nfft, hop),
             "sharded rows": lambda: spec_of(x.view(2, -1), nfft, hop),
             "slabs, nfft 4096": lambda: spec_of(x, 4096, 2048),
             "complex128": lambda: spec_of(x[:16 << 20].double(), nfft, hop)}
    worst = 0.0
    for label, make in cases.items():
        spec = make()
        _build.reset_launches()
        got = wp.frame_power_mean(spec)
        torch.cuda.synchronize()
        _require(_build.launches["welch_power_mean"] == 1,
                 f"welch_power_mean {label}: {_build.launches['welch_power_mean']} launches")
        _require(torch.equal(got, wp.frame_power_mean(spec)),
                 f"welch_power_mean {label}: another run gave other bits")
        plain = wp.frame_power_mean_plain(spec).double()
        rel = float(((got.double() - plain).abs() / plain).max())
        _require(got.shape == plain.shape and rel <= 2e-6,
                 f"welch_power_mean {label}: per-bin rel vs plain {rel:.3e} > 2e-6")
        nf = spec.shape[-2]
        print(f"welch_power_mean {label} {tuple(spec.shape)} {spec.dtype}: "
              f"{wp.frame_slabs(spec.numel() // nf, nf)} slab(s), per-bin rel vs plain "
              f"{rel:.3e} (<= 2e-6), one launch, the same bits run again")
        worst = max(worst, rel)
        if label == "analyzer":
            nbytes = spec.numel() * spec.element_size() + got.numel() * got.element_size()
            alone = _time_ms(lambda: wp.frame_power_mean(spec))
            queued = _time_ms(lambda: [wp.frame_power_mean(spec) for _ in range(16)]) / 16
            plain_ms = _time_ms(lambda: wp.frame_power_mean_plain(spec))
            bound_ms = nbytes / 3.35e12 * 1e3
            print(f"welch_power_mean {label}: {alone:.4f} ms alone, {queued:.4f} ms per call of "
                  f"16 queued ({nbytes / queued / 1e9:.1f} TB/s), plain {plain_ms:.4f} ms; bound "
                  f"{bound_ms:.4f} ms (bytes), share {bound_ms / alone:.1%} alone, "
                  f"{bound_ms / queued:.1%} queued")
            times = (alone, plain_ms)
        del spec, got, plain
    torch.cuda.empty_cache()
    return worst, times


def _polyphase_gates(x5, proto5, c5: int, tpb5: int, seed: int, dev,
                     fused_ptxas: list) -> tuple[float, dict, tuple]:
    """The polyphase branch FIR kernel (``polyphase_kernel.branch_fir``)
    against its plain version on the card (the grouped ``conv1d``s), at
    config 5 (the real float32 stream of phase 8, 16 branches of 8 taps)
    and at the SDR cell's shape (2^26 seeded complex64 samples, 128
    branches of 16 taps): one launch a call, the same bits run again, and
    each output of each within 2 gamma(tpb + 1) x sum |h| |x| of the
    other's (both sum tpb float32 products; sum |h| |x| by the plain
    version in float64).  Then each timed: one call alone, per call of 16
    queued, its C entry alone and queued (and queued at fixed strips of 256
    frames), the wrapper's host path and the plain version, beside the byte
    bound.  At the SDR cell's shape also the fused entry
    (:func:`_fused_dft_gates`).  Returns (the widest gap over its bound at
    config 5, shape label -> (ms alone, plain ms), the fused entry's (gap
    over its bound against its plain version, (ms alone, plain ms), (samples,
    C, taps a branch)))."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import polyphase_kernel as pk
    from blackman_harris_win_tpu_torch.pipeline.channelizer import design_prototype
    from blackman_harris_win_tpu_torch.utils import profiling

    g = torch.Generator(device=dev).manual_seed(seed + 24)
    cases = {"config 5": (lambda: x5, proto5, c5, tpb5),
             "sdr cell": (lambda: torch.randn(1 << 26, generator=g, device=dev,
                                              dtype=torch.complex64),
                          design_prototype(128, 16), 128, 16)}
    worst, times, dft = 0.0, {}, None
    for label, (make, proto, c, tpb) in cases.items():
        x = make()
        _build.reset_launches()
        got = pk.branch_fir(x, proto, c)
        torch.cuda.synchronize()
        _require(_build.launches["polyphase_fir"] == 1,
                 f"polyphase_fir {label}: {_build.launches['polyphase_fir']} launches")
        _require(torch.equal(got, pk.branch_fir(x, proto, c)),
                 f"polyphase_fir {label}: another run gave other bits")
        plain = pk.branch_fir_plain(x, proto, c)
        ax = (torch.complex(x.real.abs(), x.imag.abs()) if x.is_complex() else x.abs()).to(
            torch.complex128 if x.is_complex() else torch.float64)
        s64 = pk.branch_fir_plain(ax, np.abs(proto.astype(np.float32)), c)
        u = 2.0**-24
        gam = 2 * (tpb + 1) * u / (1 - (tpb + 1) * u)
        d = (got - plain).to(s64.dtype)
        if x.is_complex():
            ratio = max(float((d.real.abs() / (gam * s64.real)).nan_to_num().max()),
                        float((d.imag.abs() / (gam * s64.imag)).nan_to_num().max()))
        else:
            ratio = float((d.abs() / (gam * s64)).nan_to_num().max())
        del ax, s64, d
        _require(got.shape == plain.shape and ratio <= 1.0,
                 f"polyphase_fir {label}: kernel vs plain {ratio:.3f} of the bound")
        print(f"polyphase_fir {label} {tuple(x.shape)} {x.dtype} -> {tuple(got.shape)}: one "
              f"launch, the same bits run again, kernel vs plain {ratio:.4f} of 2 gamma({tpb + 1})"
              f" x sum|h||x|")
        if label == "config 5":
            worst = ratio
        del plain
        lanes = 2 if x.is_complex() else 1
        b_ms, b_by = profiling.polyphase_fir_bound(x.shape[-1], c, tpb, lanes, 4)
        alone = _time_ms(lambda: pk.branch_fir(x, proto, c))
        queued = _time_ms(lambda: [pk.branch_fir(x, proto, c) for _ in range(16)]) / 16
        plain_ms = _time_ms(lambda: pk.branch_fir_plain(x, proto, c))
        nbytes = (x.numel() + got.numel()) * x.element_size()
        # the C entry alone, without the wrapper's host path: at the strips
        # the launch chooses (strip 0) and at fixed strips of 256 frames
        taps = pk.prototype_taps(proto, torch.float32, dev)

        def entry(strip=0):
            _require(_build.lib().bhw_polyphase_fir(
                got.data_ptr(), x.data_ptr(), taps.data_ptr(), 1, x.shape[-1] // c, c, tpb,
                strip, lanes, 4, _build.stream_of(dev)) == 0, "polyphase_fir C entry failed")

        e_alone = _time_ms(entry)
        e_queued = _time_ms(lambda: [entry() for _ in range(16)]) / 16
        f_queued = _time_ms(lambda: [entry(256) for _ in range(16)]) / 16
        t0 = time.perf_counter()
        for _ in range(20):
            pk.branch_fir(x, proto, c)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        print(f"polyphase_fir {label}: {alone:.4f} ms alone, {queued:.4f} ms per call of 16 "
              f"queued ({nbytes / queued / 1e9:.1f} GB/s), plain {plain_ms:.4f} ms; its C entry "
              f"{e_alone:.4f} ms alone, {e_queued:.4f} ms queued; the wrapper's host path "
              f"{host_us:.1f} us a call; bound {b_ms:.4f} ms ({b_by}), share {b_ms / alone:.1%} "
              f"alone, {b_ms / queued:.1%} queued, C entry {b_ms / e_alone:.1%} alone, "
              f"{b_ms / e_queued:.1%} queued; fixed strips of 256 frames {f_queued:.4f} ms "
              f"queued ({b_ms / f_queued:.1%})")
        times[label] = (alone, plain_ms)
        if label == "sdr cell":
            dft = (*_fused_dft_gates(x, proto, c, tpb, got, dev, fused_ptxas),
                   (x.shape[-1], c, tpb))
        del x, got
    torch.cuda.empty_cache()
    return worst, times, dft


def _fused_dft_gates(x, proto, c: int, tpb: int, branches, dev,
                     fused_ptxas: list) -> tuple[float, tuple[float, float]]:
    """The fused entry (``polyphase_kernel.branch_dft``: the branch FIRs and
    the DFT across the 128 branches in one launch) at the SDR cell's shape,
    ``branches`` the branch kernel's output of ``x``: one ``polyphase_dft``
    launch and nothing else, the same bits run again, and each bin within 2
    gamma(tpb + 1 + 4 log2 C) x S of its plain version (``torch.fft.fft`` of
    ``branch_fir_plain``) and of cuFFT on ``branches`` (S: over the
    branches, sum |h| |x| of the real and the imaginary part, added).  Then
    timed beside its plain version and ``polyphase_fir`` + cuFFT: the
    wrappers alone and per call of 16 queued, the C entries likewise,
    against the byte bound; with the kernel's ptxas lines (registers, shared
    memory a block, spills).  Returns (the gap over that bound against the
    plain version, (ms alone, plain ms))."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import polyphase_kernel as pk
    from blackman_harris_win_tpu_torch.utils import profiling

    _build.reset_launches()
    bins = pk.branch_dft(x, proto, c)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launches.items() if v}
    _require(launched == {"polyphase_dft": 1}, f"polyphase_dft sdr cell: launches {launched}")
    _require(torch.equal(bins, pk.branch_dft(x, proto, c)),
             "polyphase_dft sdr cell: another run gave other bits")
    ax = torch.complex(x.real.abs(), x.imag.abs()).to(torch.complex128)
    s64 = pk.branch_fir_plain(ax, np.abs(proto.astype(np.float32)), c)
    scale = (s64.real + s64.imag).sum(-1, keepdim=True)
    del ax, s64
    u, n = 2.0**-24, tpb + 1 + 4 * int(np.log2(c))
    lim = 2 * n * u / (1 - n * u) * scale

    def gap(other):
        d = (bins - other).to(torch.complex128)
        return max(float((d.real.abs() / lim).max()), float((d.imag.abs() / lim).max()))

    ratios = {"plain": gap(torch.fft.fft(pk.branch_fir_plain(x, proto, c), dim=-1)),
              "polyphase_fir + cuFFT": gap(torch.fft.fft(branches, dim=-1))}
    del lim
    for what, ratio in ratios.items():
        _require(ratio <= 1.0, f"polyphase_dft sdr cell: fused vs {what} {ratio:.3f} of the bound")
    print(f"polyphase_dft sdr cell {tuple(x.shape)} -> {tuple(bins.shape)}: one launch, the same "
          f"bits run again; of 2 gamma({n}) x S, fused vs " + ", vs ".join(
              f"{what} {ratio:.4f}" for what, ratio in ratios.items()))
    nf = x.shape[-1] // c
    taps = pk.prototype_taps(proto, torch.float32, dev)
    tw = pk._twiddles_on(dev)
    stream = _build.stream_of(dev)

    def fused_entry():
        _require(_build.lib().bhw_polyphase_dft(bins.data_ptr(), x.data_ptr(), taps.data_ptr(),
                                                tw.data_ptr(), 1, nf, tpb, 0, stream) == 0,
                 "polyphase_dft C entry failed")

    def two_entries():
        _require(_build.lib().bhw_polyphase_fir(branches.data_ptr(), x.data_ptr(),
                                                taps.data_ptr(), 1, nf, c, tpb, 0, 2, 4,
                                                stream) == 0, "polyphase_fir C entry failed")
        return torch.fft.fft(branches, dim=-1)

    b_ms, b_by = profiling.polyphase_dft_bound(x.shape[-1], c, tpb)
    t = {"fused": (_time_ms(lambda: pk.branch_dft(x, proto, c)),
                   _time_ms(lambda: [pk.branch_dft(x, proto, c) for _ in range(16)]) / 16),
         "fused C entry": (_time_ms(fused_entry),
                           _time_ms(lambda: [fused_entry() for _ in range(16)]) / 16),
         "polyphase_fir + cuFFT": (
             _time_ms(lambda: torch.fft.fft(pk.branch_fir(x, proto, c), dim=-1)),
             _time_ms(lambda: [torch.fft.fft(pk.branch_fir(x, proto, c), dim=-1)
                               for _ in range(16)]) / 16),
         "polyphase_fir C entry + cuFFT": (
             _time_ms(two_entries), _time_ms(lambda: [two_entries() for _ in range(16)]) / 16)}
    plain_ms = _time_ms(lambda: torch.fft.fft(pk.branch_fir_plain(x, proto, c), dim=-1))
    for what, (alone, queued) in t.items():
        print(f"polyphase_dft sdr cell, {what}: {alone:.4f} ms alone, {queued:.4f} ms per call "
              f"of 16 queued; bound {b_ms:.4f} ms ({b_by}), share {b_ms / alone:.1%} alone, "
              f"{b_ms / queued:.1%} queued")
    print(f"polyphase_dft sdr cell, plain (branch_fir_plain + torch.fft.fft): {plain_ms:.4f} ms")
    for line in fused_ptxas:
        print(f"polyphase_dft ptxas (polyphase_dft_kernel): {line}")
    del bins
    return ratios["plain"], (t["fused"][0], plain_ms)


def _int8_capture(seed: int, dev, feeds: int, samples: int):
    """Seeded int8 ADC words (feeds, samples) made on the card: Gaussian at
    an rms of 40 LSB, rounded and clipped at +-127 (some 0.15% of the words
    clip)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 27)
    x = torch.empty((feeds, samples), dtype=torch.int8, device=dev)
    for f in range(feeds):
        v = torch.randn(samples, generator=g, device=dev).mul_(40.0)
        x[f] = v.round_().clamp_(-127, 127).to(torch.int8)
    return x


def _spectrometer_gates(x, power, proto, c: int, tpb: int, n_acc: int,
                        dev) -> dict:
    """The PFB spectrometer's kernels at its cell's shape, ``x`` the int8
    capture (feeds, T) and ``power`` the main path's ``pfb_power`` of it.
    ``branch_fir`` of ``x``: one ``polyphase_fir`` launch, the same bits as
    of its float32 copy and run again, each output within 2 gamma(tpb + 1)
    x sum |h| |x| of ``branch_fir_plain`` (both sum tpb float32 products of
    exact words).  ``frame_power_mean`` of its half spectrum viewed as
    (feeds, n_int, n_acc, C//2 + 1): one ``welch_power_mean`` launch (the
    slab path), the same bits run again and as ``power``, each bin within
    2 u of the float64 mean of the same bins (the kernel's squares and sums
    are float64, its one rounding the float32 output's) and within
    gamma(n_acc + 3) of ``frame_power_mean_plain`` (a float32 ``hypot``, a
    square and a sum of n_acc positive terms).  Then each timed alone, per
    call of 16 queued and beside its plain version and byte bound
    (``profiling.kernel_bounds``), the branch FIRs on the float32 words
    and, beside them, on the int8 ones (the widening included), and the
    whole ``pfb_power`` call.  Returns label -> (gap over its bound, (ms
    alone, plain ms)) for ``polyphase_fir pfb cell`` and
    ``welch_power_mean pfb cell``."""
    import torch

    from blackman_harris_win_tpu_torch import _build
    from blackman_harris_win_tpu_torch.kernels import polyphase_kernel as pk
    from blackman_harris_win_tpu_torch.kernels import welchpower_kernel as wp
    from blackman_harris_win_tpu_torch.pipeline.spectrometer import pfb_power
    from blackman_harris_win_tpu_torch.utils import profiling

    feeds, t_len = x.shape
    bounds = profiling.pfb_bounds(feeds, t_len, c, tpb, n_acc)
    u = 2.0**-24
    xf = x.to(torch.float32)
    _build.reset_launches()
    got = pk.branch_fir(x, proto, c)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launches.items() if v}
    _require(launched == {"polyphase_fir": 1}, f"polyphase_fir pfb cell: launches {launched}")
    _require(got.dtype == torch.float32 and torch.equal(got, pk.branch_fir(xf, proto, c))
             and torch.equal(got, pk.branch_fir(x, proto, c)),
             "polyphase_fir pfb cell: int8 words not the bits of their float32 copy's")
    plain = pk.branch_fir_plain(xf, proto, c)
    s64 = pk.branch_fir_plain(xf.abs().double(), np.abs(proto.astype(np.float32)), c)
    gam = 2 * (tpb + 1) * u / (1 - (tpb + 1) * u)
    ratio_fir = float(((got - plain).double().abs() / (gam * s64)).nan_to_num().max())
    _require(got.shape == plain.shape and ratio_fir <= 1.0,
             f"polyphase_fir pfb cell: kernel vs plain {ratio_fir:.3f} of the bound")
    del plain, s64
    print(f"polyphase_fir pfb cell {tuple(x.shape)} {x.dtype} -> {tuple(got.shape)}: one launch, "
          f"the bits of the float32 copy's and of a second run, kernel vs plain "
          f"{ratio_fir:.4f} of 2 gamma({tpb + 1}) x sum|h||x|")

    bins = torch.fft.rfft(got, dim=-1)
    n_int = bins.shape[-2] // n_acc
    spec = bins.view(feeds, n_int, n_acc, bins.shape[-1])
    _build.reset_launches()
    mean = wp.frame_power_mean(spec)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.launches.items() if v}
    _require(launched == {"welch_power_mean": 1},
             f"welch_power_mean pfb cell: launches {launched}")
    _require(torch.equal(mean, wp.frame_power_mean(spec)) and torch.equal(mean, power),
             "welch_power_mean pfb cell: not the bits of a second run and of pfb_power's")
    spec64 = spec.to(torch.complex128)
    p64 = (spec64.real ** 2 + spec64.imag ** 2).mean(dim=-2)
    del spec64
    rel64 = float(((mean.double() - p64).abs() / p64).max())
    plain = wp.frame_power_mean_plain(spec).double()
    lim = (n_acc + 3) * u / (1 - (n_acc + 3) * u)
    rel_plain = float(((mean.double() - plain).abs() / plain).max())
    _require(mean.shape == plain.shape == (feeds, n_int, c // 2 + 1) and rel64 <= 2 * u
             and rel_plain <= lim,
             f"welch_power_mean pfb cell: per-bin rel vs float64 {rel64:.3e} (<= 2u), "
             f"vs plain {rel_plain:.3e} (<= {lim:.3e})")
    del p64, plain
    slabs = wp.frame_slabs(spec.numel() // n_acc, n_acc)
    print(f"welch_power_mean pfb cell {tuple(spec.shape)} {spec.dtype}: {slabs} slab(s), one "
          f"launch, the bits of a second run and of pfb_power's; per-bin rel vs float64 "
          f"{rel64:.3e} (<= 2u = {2 * u:.3e}), vs plain {rel_plain:.3e} (<= gamma({n_acc + 3}) "
          f"= {lim:.3e})")

    taps = pk.prototype_taps(proto, torch.float32, dev)

    def entry():
        _require(_build.lib().bhw_polyphase_fir(
            got.data_ptr(), xf.data_ptr(), taps.data_ptr(), feeds, t_len // c, c, tpb, 0, 1, 4,
            _build.stream_of(dev)) == 0, "polyphase_fir C entry failed")

    t = {"polyphase_fir pfb cell": (lambda: pk.branch_fir(xf, proto, c),
                                    lambda: pk.branch_fir_plain(xf, proto, c)),
         "polyphase_fir pfb cell, int8 (widening included)": (
             lambda: pk.branch_fir(x, proto, c), None),
         "polyphase_fir pfb cell, C entry": (entry, None),
         "welch_power_mean pfb cell": (lambda: wp.frame_power_mean(spec),
                                       lambda: wp.frame_power_mean_plain(spec)),
         "pfb_power pfb cell": (lambda: pfb_power(x, proto, c, n_acc), None)}
    times = {}
    for label, (fn, plain_fn) in t.items():
        alone = _time_ms(fn)
        queued = _time_ms(lambda: [fn() for _ in range(16)]) / 16
        plain_ms = _time_ms(plain_fn) if plain_fn else None
        b = bounds.get(label.split(",")[0])
        share = (f"; bound {b[0]:.4f} ms ({b[1]}), share {b[0] / alone:.1%} alone, "
                 f"{b[0] / queued:.1%} queued" if b else "")
        print(f"{label}: {alone:.4f} ms alone, {queued:.4f} ms per call of 16 queued"
              + (f", plain {plain_ms:.4f} ms" if plain_ms else "") + share)
        times[label] = (alone, plain_ms)
    del got, bins, spec, mean, xf
    torch.cuda.empty_cache()
    return {"polyphase_fir pfb cell": (ratio_fir, times["polyphase_fir pfb cell"]),
            "welch_power_mean pfb cell": (rel64 / (2 * u), times["welch_power_mean pfb cell"])}


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


#: the mixer kernel's paths at 2^26 samples, W=16 dds48: (label, tuning
#: word, PW); config 21 (fc = 1/8) is the main path's
DDC_PATHS = (("config 21, table of P = 8", 1 << 17, 20),
             ("odd word at pw=20 (fc ~ 0.1), table of P = 2^20", 104857, 20),
             ("odd word at pw=31, computed per sample", 509168373, 31))


def _ddc_mixer_gates(x21, pw: int, w: int, rng, dev) -> tuple[float, int]:
    """The DDC mixer kernel against its plain version: on phase 7's input
    (2^26 samples, dds48) at each of DDC_PATHS, its f32 output bit-equal to
    ``mixer_plain`` on the card, and at config 21 its raw ints 0 LSB
    against ``mix_iq_int`` on the card; its table kernel at the two table
    words 0 LSB against ``nco_table_plain`` on the CPU; for dds48 and scaled
    at (pw, W) in {(20, 16), (31, 17), (24, 12)}, four random 4096-sample
    blocks starting anywhere in [0, 2^33) at an odd word (the compute path)
    and at a word of period 2^10 (a table), the tables of period 4 and 8,
    whose entries are the quadrant seams (and octants), and, through tuning
    words +1 and -1, the phases s-3 .. s+3 around each quadrant seam s at
    indices from 0 and from 2^32 - 5 on, 0 LSB against the CPU plain
    version.  Returns the largest |difference| of the mixer and of the
    table."""
    import torch

    from blackman_harris_win_tpu_torch.kernels import ddc_kernel
    from blackman_harris_win_tpu_torch.pipeline.ddc import (
        MIX_IN_BITS,
        freq_word,
        mix_iq_int,
        mixer_plain,
        nco_table_plain,
    )

    t = x21.shape[-1]
    err, err_table = 0.0, 0
    for what, fw, pw_ in DDC_PATHS:
        got = ddc_kernel.mixer(x21, fw, pw_, w, "dds48")
        want = mixer_plain(x21, fw, pw_, w, "dds48")
        err = max(err, float((got - want).abs().max()))
        _require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                 f"ddc_mixer {what}: f32 output differs from mixer_plain on the card ({err:.3e})")
        del got, want
        if ddc_kernel.table_period(fw, pw_, t):
            tab = ddc_kernel.nco_table(fw, pw_, w, "dds48", device=dev).cpu()
            want = nco_table_plain(fw, pw_, w, "dds48", device="cpu")
            err_table = max(err_table, int((tab - want).abs().max()))
            _require(torch.equal(tab, want), f"ddc_nco_table {what}: differs from "
                     "nco_table_plain on the CPU")
    fw = DDC_PATHS[0][1]
    raw = ddc_kernel.mixer(x21, fw, pw, w, "dds48", raw=True)
    xq = torch.round(x21 * float((1 << MIX_IN_BITS) - 1)).to(torch.int32)
    mi, mq = mix_iq_int(xq, torch.arange(t, device=dev), fw, pw, w)
    _require(torch.equal(raw[0], mi) and torch.equal(raw[1], mq),
             "ddc_mixer: raw ints differ from mix_iq_int on the card")
    del raw, xq, mi, mq
    nblocks, ntable = 0, 0
    for flavor in ("dds48", "scaled"):
        for pw_, w_ in ((20, 16), (31, 17), (24, 12)):
            big = 1 << pw_
            f0 = freq_word(0.2371, pw_) | 1
            blocks = [(int(b), 4096, f) for b in rng.integers(0, 1 << 33, size=4)
                      for f in (f0, (f0 << (pw_ - 10)) % big)]
            blocks += [(int(rng.integers(0, 1 << 33)), 4096, f) for f in (big // 4, 3 * big // 8)]
            for base in (0, 2**32 - 5):
                for s in (0, big // 4, big // 2, 3 * big // 4):
                    blocks += [(base + (s - 3 - base) % big, 7, 1),
                               (base + (-(s + 3) - base) % big, 7, big - 1)]
            for b0, n, f in blocks:
                x = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32))
                g = ddc_kernel.mixer(x.to(dev), f, pw_, w_, flavor, n0=b0, raw=True).cpu()
                p = mixer_plain(x, f, pw_, w_, flavor, n0=b0, raw=True)
                _require(torch.equal(g, p), f"ddc_mixer {flavor} pw={pw_} W={w_}: block at "
                         f"{b0} (fw {f}) differs from the CPU plain version")
                nblocks += 1
                ntable += bool(ddc_kernel.table_period(f, pw_, n))
    print(f"ddc_mixer: on the (2, {t}) mixer output bit-equal to mixer_plain on the card on each "
          f"path ({'; '.join(d[0] for d in DDC_PATHS)}), the tables 0 LSB against "
          f"nco_table_plain, raw ints 0 LSB against mix_iq_int at config 21; {nblocks} blocks "
          f"({ntable} through a table; dds48 and scaled, pw 20/31/24, W 16/17/12, random n0 in "
          "[0, 2^33), tables of the seams, every quadrant seam +-3 from n0 0 and 2^32 - 5) 0 "
          "LSB against the CPU plain version")
    return err, err_table


def _sdr_gates(label, x, out, proto, n_ch: int, aw: int, offset, rng, frames=None) -> int:
    """The chain's output (the discriminator kernel on the card's
    channelizer output) is 0 LSB against the plain discriminator in torch
    ops on the card over all of it, equals the discriminator kernel's
    integer front end on the card's int I/Q, and lies in the angle range;
    that front end is 0 LSB against its CPU plain version (all of it, or a
    random run of ``frames`` outputs per channel); where the input is a
    tone at channel 1 + ``offset``, that offset comes back within 2e-3 (the
    dryrun's gate).  Returns the largest |kernel - plain|."""
    import torch

    from blackman_harris_win_tpu_torch.pipeline.channelizer import polyphase_channelize
    from blackman_harris_win_tpu_torch.pipeline.demod import fm_demod_conj
    from blackman_harris_win_tpu_torch.pipeline.sdr import discriminate_plain

    y = polyphase_channelize(x, proto, n_ch)
    want = discriminate_plain(y, aw)
    err = int((out - want).abs().max())
    _require(out.shape == want.shape and torch.equal(out, want),
             f"SDR {label}: sdr_chain differs from the plain discriminator on the card ({err} LSB)")
    del want
    i = torch.round(y.real * 2.0**14).to(torch.int32).mT
    q = torch.round(y.imag * 2.0**14).to(torch.int32).mT
    del y
    d_dev = fm_demod_conj(i, q, 16, aw)
    _require(torch.equal(d_dev.mT, out), f"SDR {label}: sdr_chain differs from fm_demod_conj "
             "on its int I/Q")
    half = 1 << (aw - 1)
    _require(int(out.min()) >= -half and int(out.max()) < half,
             f"SDR {label}: output outside [-2^{aw - 1}, 2^{aw - 1})")
    nf = d_dev.shape[-1] if frames is None else min(frames, d_dev.shape[-1])
    a = int(rng.integers(0, d_dev.shape[-1] - nf + 1))
    d_cpu = fm_demod_conj(i[:, a:a + nf + 1].cpu(), q[:, a:a + nf + 1].cpu(), 16, aw)
    _require(torch.equal(d_dev[:, a:a + nf].cpu(), d_cpu),
             f"SDR {label}: fm_demod_conj on the card differs from the CPU")
    msg = (f"SDR {label}: output {tuple(out.shape)} in range, 0-LSB equal to the plain "
           "discriminator on the card over all of it and to fm_demod_conj on its int I/Q, "
           f"which is 0-LSB equal to the CPU plain version on {d_cpu.numel()} outputs")
    if offset is not None:
        f1 = float(out[:, 1].double().mean()) / (1 << aw)
        _require(abs(f1 - offset * n_ch) < 2e-3,
                 f"SDR {label}: channel-1 offset {f1} vs {offset * n_ch}")
        msg += (f"; channel-1 offset {f1:.6f} (want {offset * n_ch}, |err| "
                f"{abs(f1 - offset * n_ch):.2e} < 2e-3)")
    print(msg)
    return err


#: (AW, P) of the atan2 gates: 32-bit words (AW + P <= 32, P >= 1), then 64-bit ones
ATAN2_GATE_WIDTHS = ((16, 1), (20, 1), (24, 1), (31, 1), (30, 2), (31, 2), (40, 1))


def _demod_gates(dev, rng) -> int:
    """The atan2 kernel in both conventions on int32 and int64 words, and
    the discriminator kernel's phase and conj modes (one stream, four
    contiguous rows and the four-row transpose of an (n, 4) array: both
    walks), each 0 LSB against its CPU plain version, at every
    ATAN2_GATE_WIDTHS width on random and seam words.  Returns the largest
    |difference| seen."""
    import torch

    from blackman_harris_win_tpu_torch.kernels import cordic
    from blackman_harris_win_tpu_torch.kernels import demod_kernel as dmk
    from blackman_harris_win_tpu_torch.pipeline import demod

    plain = {"cordic": cordic.cordic_atan2_plain, "fixed": cordic.atan2_fixed_plain,
             "phase": demod.fm_demod_phase_plain, "conj": demod.fm_demod_conj_plain}
    worst, blocks = 0, 0

    def held(got, want, what):
        nonlocal worst, blocks
        got = got.cpu()
        worst = max(worst, int((got - want).abs().max()) if want.numel() else 0)
        _require(got.shape == want.shape and torch.equal(got, want),
                 f"{what}: differs from the CPU plain version")
        blocks += 1

    for aw, p in ATAN2_GATE_WIDTHS:
        for iw in sorted({aw, 16}):
            y, x = dmk.seam_words(iw, aw, rng, 4096)
            yc, xc = torch.from_numpy(y), torch.from_numpy(x)
            for dtype in (torch.int32, torch.int64) if iw <= 32 else (torch.int64,):
                yd, xd = yc.to(dev, dtype), xc.to(dev, dtype)
                for conv in ("cordic", "fixed"):
                    held(dmk.atan2(yd, xd, iw, aw, p, conv), plain[conv](yc, xc, iw, aw, p),
                         f"atan2 {conv} AW={aw} P={p} iw={iw} {dtype}")
                if p == 1:  # the discriminators' datapath: P = 1
                    n = len(x) // 4 * 4
                    for mode in ("phase", "conj"):
                        for i, q in ((xc, yc), (xc[:n].view(4, -1), yc[:n].view(4, -1)),
                                     (xc[:n].view(-1, 4).mT, yc[:n].view(-1, 4).mT)):
                            held(dmk.fm_demod(i.to(dev, dtype), q.to(dev, dtype), iw, aw, mode),
                                 plain[mode](i, q, iw, aw),
                                 f"fm_demod {mode} AW={aw} iw={iw} {dtype} {tuple(i.shape)}")
    print(f"atan2 / fm_demod kernels: {blocks} blocks (AW/P "
          + ", ".join(f"{a}/{p}" for a, p in ATAN2_GATE_WIDTHS)
          + "; cordic and fixed conventions, int32 and int64 words, random words and every "
          "pair of the seams 0, +-1, +-(2^(AW-1)-1), bit iw-1 set; fm_demod phase and conj "
          "modes on one stream, four rows and a four-row transpose) 0 LSB against the CPU "
          "plain versions")
    return worst


def _int_demod_gates(dph5, i5, q5, aw: int) -> int:
    """The integer discriminator on config 5's (T, 16) int32 I/Q: phase 8's
    ``fm_demod_phase`` of its (16, T) transpose (``dph5``), and both modes
    on that transpose and on contiguous rows, each 0 LSB against its plain
    version on the card and laid out as the plain version is (the
    transpose's output (T-1, 16) in memory).  Returns the largest
    |difference|."""
    import torch

    from blackman_harris_win_tpu_torch.pipeline import demod

    worst = 0
    layouts = {"transposed": (i5.mT, q5.mT), "contiguous rows": (i5.mT.contiguous(),
                                                                  q5.mT.contiguous())}
    for layout, (i, q) in layouts.items():
        for mode in ("phase", "conj"):
            plain = getattr(demod, f"fm_demod_{mode}_plain")(i, q, 16, aw)
            got = (dph5 if (layout, mode) == ("transposed", "phase")
                   else getattr(demod, f"fm_demod_{mode}")(i, q, 16, aw))
            err = int((got - plain).abs().max())
            worst = max(worst, err)
            _require(got.shape == plain.shape and err == 0,
                     f"fm_demod_{mode} on config 5's {layout} I/Q: {err} LSB from its plain "
                     "version on the card")
            _require(got.stride() == plain.stride(), f"fm_demod_{mode} {layout}: strides "
                     f"{got.stride()}, the plain version's {plain.stride()}")
            del plain, got
    print(f"fm_demod_phase and fm_demod_conj on config 5's {tuple(i5.mT.shape)} int32 I/Q, "
          "transposed and as contiguous rows: 0 LSB against their plain versions on the card, "
          "in the plain versions' layouts")
    return worst


def _taylor2_gates(win, q7, spec, dev, rng) -> int:
    """The taylor2 kernel: ``win`` (phase 6's BH-7 window at ``spec``)
    bit-equal to ``window_values_fast`` on the card over every sample; then
    blocks of 4099 samples at n0 in {0, N/4-1, N/4+1, N/2, 3N/4, N-1} and a
    random one, for LS 9/10/12/14 x W 16/17/32 x wrap/saturate at pw 26,
    0 LSB against the CPU plain version.  Returns the largest
    |difference|."""
    import torch

    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import fastwin_kernel as fk
    from blackman_harris_win_tpu_torch.windows import catalog

    n = spec.n
    want = fk.taylor2_window_plain(torch.arange(n, device=dev), q7, spec)
    worst = int((want.long() - win.long()).abs().max())
    _require(torch.equal(want, win), f"taylor2 kernel vs window_values_fast on the card: "
             f"{worst} LSB")
    del want
    starts = [0, n // 4 - 1, n // 4 + 1, n // 2, 3 * n // 4, n - 1, int(rng.integers(n))]
    blocks = 0
    for ls in (9, 10, 12, 14):
        for w in (16, 17, 32):
            q = catalog.get("bh7").quantized(w)
            for overflow in ("wrap", "saturate"):
                sp = WindowSpec(spec.phase_width, w, sin_type="taylor2", lut_size=ls,
                                overflow=overflow)
                for n0 in starts:
                    plain = fk.taylor2_window_plain(torch.arange(n0, n0 + 4099), q, sp)
                    got = fk.window_block(q, sp, n0, 4099, dev).cpu()
                    worst = max(worst, int((got.long() - plain.long()).abs().max()))
                    _require(torch.equal(got, plain), f"taylor2 LS={ls} W={w} {overflow} "
                             f"n0={n0}: differs from the CPU plain version")
                    blocks += 1
    print(f"taylor2 window bh7 w32 ls12 pw26: bit-equal to window_values_fast on the card over "
          f"all {n} samples; {blocks} blocks of 4099 (LS 9/10/12/14, W 16/17/32, wrap and "
          "saturate, n0 0, N/4+-1, N/2, 3N/4, N-1 and random) 0 LSB against the CPU plain "
          "version")
    return worst


def _taylor_rtl_gates(wins: dict, specs: dict, dev, rng) -> int:
    """The RTL Taylor kernel: phase 6's windows (``wins``, name -> window
    at ``specs[name]``, the catalog set of its first word) bit-equal to
    ``taylor_window_rtl_plain`` on the card over every sample; then blocks of
    4099 samples at n0 in {0, N/4-1, N/2+1, N-7 (across the period end)}
    and a random one, for W 8..32 x the Hamming (2-term), Blackman (3-term)
    and a random 3-term |a_k| < 2^31 set (its slices and trees wrap) at
    (pw, LS) (12, 10), (26, 12) and (31, 7) (the LUT regimes and tay1), 0 LSB
    against the CPU plain version.  Returns the largest |difference|."""
    import torch

    from blackman_harris_win_tpu_torch.core.config import WindowSpec
    from blackman_harris_win_tpu_torch.kernels import taylor_kernel as tk
    from blackman_harris_win_tpu_torch.windows import catalog

    worst = 0
    for name, win in wins.items():
        sp = specs[name]
        q = catalog.get(name.split()[0]).quantized(sp.data_width)
        want = tk.taylor_window_rtl_plain(torch.arange(sp.n, device=dev), q, sp)
        worst = max(worst, int((want.long() - win.long()).abs().max()))
        _require(torch.equal(want, win), f"taylor_window_rtl {name}: differs from "
                 "taylor_window_rtl_plain on the card")
        del want
    blocks = 0
    for w in range(8, 33):
        big = tuple(int(a) for a in rng.integers(1 - (1 << 31), 1 << 31, 3))
        for pw, ls in ((12, 10), (26, 12), (31, 7)):
            sp = WindowSpec(pw, w, sin_type="taylor", rounding="rtl", lut_size=ls)
            n = sp.n
            for q in (catalog.get("hamming").quantized(w), catalog.get("blackman").quantized(w),
                      big):
                for n0 in (0, n // 4 - 1, n // 2 + 1, n - 7, int(rng.integers(n))):
                    plain = tk.taylor_window_rtl_plain(torch.arange(n0, n0 + 4099), q, sp)
                    got = tk.window_rtl_block(q, sp, n0, 4099, dev).cpu()
                    worst = max(worst, int((got.long() - plain.long()).abs().max()))
                    _require(torch.equal(got, plain), f"taylor_window_rtl W={w} pw={pw} "
                             f"LS={ls} {q} n0={n0}: differs from the CPU plain version")
                    blocks += 1
    print(f"taylor_window_rtl: {', '.join(f'{k} ({specs[k].n} samples)' for k in wins)} "
          f"bit-equal to taylor_window_rtl_plain on the card over every sample; {blocks} "
          "blocks of 4099 (W 8..32, hamming, blackman "
          "and a random 3-term set, (pw, LS) (12, 10) (26, 12) (31, 7), n0 0, N/4-1, N/2+1, "
          "N-7 and random) 0 LSB against the CPU plain version")
    return worst


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
    from blackman_harris_win_tpu_torch.kernels import ddc_kernel
    from blackman_harris_win_tpu_torch.pipeline.ddc import (
        MIX_IN_BITS,
        ddc,
        freq_word,
        make_sharded_ddc,
        mix_iq_int,
        mixer_plain,
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
        return res[f"{name} [{mesh_name}]"]

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
    spec_tr = r["spec_taylor_rtl"]
    stage(f"gen taylor rtl blackman w32 ls12 pw{gpw}", "4 on one card",
          {"taylor_window_rtl": 4},
          lambda: sharded_window(r["q_taylor_rtl"], spec_tr, m4),
          lambda: make_window("blackman", spec_tr, device=dev),
          equal_to(r["win_taylor_rtl"], "phase 6's RTL window"))
    spec_t2 = r["spec_taylor2"]
    stage(f"gen taylor2 bh7 w32 ls12 pw{gpw}", "4 on one card", {"taylor2_window_block": 4},
          lambda: sharded_window(q7, spec_t2, m4),
          lambda: make_window("bh7", spec_t2, device=dev),
          equal_to(r["win_taylor2"], "phase 6's taylor2 window"))

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

        shards = m.shape["blocks"] * m.shape["channels"]
        stage(f"welch {wm}/{fm} bh4 w17 nfft {nfft}, x {tuple(x2.shape)}", mname,
              {welch_kernel[wm]: shards} | ({"welch_power_mean": shards} if fm == "rfft" else {}),
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
        t_sh, _ = stage(
            f"ddc config 21 ({t} samples, dds48 pw{pw} w{w}, decim {dec}, {n_taps} taps)", mname,
            {"materialize": nb, "ddc_nco_table": nb, "ddc_mixer": nb},
            lambda step=step: step(x21),
            lambda: ddc(x21, fc, dec, taps=h21, phase_width=pw, data_width=w, flavor="dds48"),
            ddc_gate)
        # the mixer kernel at a shard's size (its extended chunk) beside
        # its plain version
        xs = x21[:b + ddc_halo]
        k_ms = _time_ms(lambda: ddc_kernel.mixer(xs, fw, pw, w, "dds48"))
        p_ms = _time_ms(lambda: mixer_plain(xs, fw, pw, w, "dds48"))
        print(f"ddc_mixer {label} phase 11 [{mname}]: {nb} launches a call (one a shard, each "
              "after one of ddc_nco_table); "
              f"kernel {k_ms:.3f} ms a shard of {xs.numel()} samples, torch-op NCO + mixer "
              f"{p_ms:.3f} ms (plain version, comparison only); the sharded DDC {t_sh:.3f} ms "
              "a call (CUDA events, above)")
    del xq21

    # --- the SDR chain, config 5: a left halo of one prototype length ---
    x5, proto5, c5, tpb5, aw = r["x_sdr5"], r["proto5"], r["c5"], r["tpb5"], r["aw"]
    sdr4 = make_sharded_sdr_chain(m4, c5, tpb5, angle_width=aw)
    stage(f"sdr config 5 ({c5} ch x {tpb5} taps, {x5.numel()} samples)", "4 on one card",
          {"polyphase_fir": 4, "fm_demod": 4},
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
    kernels each shard launches once, step() -> Sharded).  Phase
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
        ("gen hls bh7 w32 pw26", ("window_block",), lambda: sharded_window(q7, spec_hls, mesh_a)),
        (f"welch quantized/mxu bh4 w17 nfft {nfft}, x (1, {x.numel()})", ("window_block",),
         lambda: welch["mxu"](x.view(1, -1))),
        (f"welch quantized/rfft bh4 w17 nfft {nfft}, x (1, {x.numel()})",
         ("window_block", "welch_power_mean"), lambda: welch["rfft"](x.view(1, -1))),
        (f"stft quantized bh4 nfft {nfft} hop {hop}, {x_stft.numel()} samples", ("window_block",),
         stft_step),
        ("istft quantized (the round trip)", ("window_block",), lambda: inv(frames["s"])),
        (f"ddc config 21 ({x21.numel()} samples, dds48 pw20 w16, decim 4, 64 taps)",
         ("ddc_nco_table", "ddc_mixer", "materialize"), lambda: ddc_step(x21)),
        (f"psum over channels, x {tuple(x_stft.view(2, -1).shape)} (2x2)", (), psum_step),
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

    for name, kernels, step in _mp_steps(mesh_a, mesh_b, x, x21, x_stft):
        exact = dict.fromkeys(kernels, 4)
        one = _counted(launched, f"12 {name} [one process]", tuple(exact), step, exact=exact)
        per_process = dict.fromkeys(kernels, 2)
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
        if "ddc_mixer" in kernels:
            print(f"ddc_mixer {label} phase 12: 2 launches a call in each process (one a local "
                  f"shard, each after one of ddc_nco_table), 4 in one process")
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


def _cli_npy(tmp, argv: list) -> tuple[float, np.ndarray]:
    """One CLI command writing a .npy in ``tmp``: (wall seconds, the array
    read back)."""
    f = tmp / "out.npy"
    secs, _ = _cli(argv + ["--out", f])
    out = (secs, np.load(f))
    f.unlink()
    return out


#: phase 10's RTL TAYLOR window: phase 6's Hamming W=16 LS=10 through the CLI
TAYLOR_RTL_GEN = ["gen", "hamming", "--sin-type", "taylor", "--rounding", "rtl",
                  "--phase-width", "26", "--data-width", "16", "--lut-size", "10"]


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
        "gen taylor2": gen7 + ["--mode", "taylor2", "--lut-size", "12"],
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
    out = {label: _cli_npy(tmp, argv) for label, argv in runs.items()}
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
#: csrc/ddc_kernel.cu: kPer, the samples a thread of the mixer passes takes
DDC_SAMPLES_A_THREAD = 4
#: SASS opcodes by the pipe that issues them on sm_90: the integer ALU pipe
#: (shifts, logic, adds, compares, selects; 64 lanes a clock an SM), the FMA
#: pipe (IMAD and the f32 arithmetic) and the FP64 pipe (64 lanes each);
#: the rest (loads, stores, conversions, branches) under "other"
SASS_PIPES = {
    "alu": ("IADD3", "LOP3", "SHF", "SEL", "ISETP", "LEA", "PRMT", "IABS", "IMNMX", "FSEL",
            "FSETP", "MOV", "PLOP3", "FLO", "POPC", "BMSK", "SGXT", "VIADD", "IADD"),
    "fma": ("IMAD", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2"),
    "fp64": ("DFMA", "DADD", "DMUL"),
}


def _pipes(ins) -> dict:
    """Instructions of ``ins`` (SASS text without addresses) by pipe."""
    out = dict.fromkeys((*SASS_PIPES, "other"), 0)
    for text in ins:
        op = re.sub(r"^@!?U?P\w+\s+", "", text.strip()).split(None, 1)[0].split(".")[0]
        out[next((k for k, ops in SASS_PIPES.items() if op in ops), "other")] += 1
    return out


def _pipe_str(counts: dict, per: float = 1.0) -> str:
    return ", ".join(f"{k} {v / per:g}" for k, v in counts.items())


def _print_sass(lib_path) -> None:
    """From ``cuobjdump -sass``: per window-kernel instantiation (datapath),
    its instruction count and the instructions of one unrolled CORDIC
    iteration of one chain (in the two-chain body, the median distance
    between the first shifts by successive immediates k, 8 <= k < 24,
    halved); for the bulk-copy ring of ``materialize``, its instruction count
    and the length of its main loop, one pass of which moves one stage (the
    widest backward branch).  Needs ``cuobjdump``; prints that it is missing
    otherwise.  The Taylor and stage-1 kernels: see ``_print_block_sass``."""
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found, instruction counts not measured")
        return
    r = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                       timeout=300)
    funcs = re.split(r"\n\s*Function : ", r.stdout)[1:]
    mixer = {}  # (flavor, W) -> instructions of the compute path, f32 output
    for body in funcs:
        name = body.split("\n", 1)[0].strip()
        if "ddc_" in name:
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)
            local = sum(bool(re.search(r"\b(LDL|STL)\b", i)) for i in ins)
            _require(local == 0, f"{name[:80]}: {local} local-memory instructions")
            m = re.search(r"ddc_mixer_kernelILi([01])ELi(\d+)ELb0E", name)
            if m:
                mixer[(("dds48", "scaled")[int(m.group(1))], int(m.group(2)))] = ins
            elif "ddc_table_mixer_kernelILb0E" in name:
                loop = _loop_body(body)
                print(f"sass ddc_mixer table pass (f32 output): {len(ins)} instructions; the "
                      f"row loop {len(loop)}, per sample ({DDC_SAMPLES_A_THREAD} a thread) "
                      f"{_pipe_str(_pipes(loop), DDC_SAMPLES_A_THREAD)}; 0 local-memory")
            elif (m := re.search(r"ddc_nco_table_kernelILi([01])ELi16E", name)):
                print(f"sass ddc_nco_table {('dds48', 'scaled')[int(m.group(1))]} W=16: "
                      f"{len(ins)} instructions ({_pipe_str(_pipes(ins))}); 0 local-memory")
            continue
        if "materialize_bulk_kernel" in name:
            at = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
            spans = [int(a, 16) - int(m.group(1), 16) for a, text in at
                     if (m := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text))
                     and int(m.group(1), 16) < int(a, 16)]
            loop = f"{max(spans) // 16 + 1} instructions" if spans else "not found"
            print(f"sass materialize_bulk_kernel: {len(at)} instructions; main loop, one "
                  f"stage per pass, {loop}")
            continue
        if "taylor_window_rtl_kernel" in name:
            _print_taylor_rtl_sass(name, body)
            continue
        if "taylor_" in name or "welch_stage1_kernel" in name:
            _print_block_sass(name, body)
            continue
        if "float_kernel" in name:
            _print_float_sass(name, body)
            continue
        if re.search(r"taylor2_window_kernelILi[23]E", name):
            _print_taylor2_walk_sass(name, body)
            continue
        if any(k in name for k in ("atan2_kernel", "demod_int_kernel", "demod_iq_kernel",
                                   "taylor2_window_kernel")):
            _print_unrolled_sass(name, body)
            continue
        if "int_kernel" in name:
            _print_int_sass(name, body)
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
    for flavor in ("dds48", "scaled"):  # W=17 unrolls one iteration more than W=16
        if (flavor, 16) in mixer and (flavor, 17) in mixer:
            i16, i17 = mixer[(flavor, 16)], mixer[(flavor, 17)]
            p16, p17 = _pipes(i16), _pipes(i17)
            k = DDC_SAMPLES_A_THREAD
            print(f"sass ddc_mixer compute path {flavor} (f32 output): W=16 {len(i16)} "
                  f"instructions, W=17 {len(i17)}; one CORDIC iteration of one sample "
                  f"{(len(i17) - len(i16)) / k:g} instructions "
                  f"({_pipe_str({p: p17[p] - p16[p] for p in p16}, k)}); 0 local-memory")


def _loop_body(body: str) -> list:
    """The instructions of the widest loop (backward branch) of a kernel's
    SASS, without addresses; [] where it has none."""
    at = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    spans = [(int(b.group(1), 16), int(a, 16)) for a, text in at
             if (b := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text))
             and int(b.group(1), 16) < int(a, 16)]
    if not spans:
        return []
    lo, hi = max(spans, key=lambda s: s[1] - s[0])
    return [text for a, text in at if lo <= int(a, 16) <= hi]


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


def _sass_blocks(body: str) -> tuple[list, list]:
    """A SASS function's (address, text) instructions, and its basic blocks
    as lists of texts: split before every branch target and after every
    branch, exit or call (what follows the last of them is left out)."""
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    targets = {int(m.group(1), 16) for _, text in ins
               if (m := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text))}
    blocks, run = [], []
    for addr, text in ins:
        if int(addr, 16) in targets and run:
            blocks.append(run)
            run = []
        run.append(text)
        if re.search(r"\b(BRA|EXIT|RET|BRX|JMP|CALL)\b", text):
            blocks.append(run)
            run = []
    return ins, blocks


#: an RTL term's product a_k * cos_k + 2^(W-2): a signed IMAD.WIDE whose
#: 64-bit addend is a uniform register
_RTL_PRODUCT = re.compile(r"\bIMAD\.WIDE\s+R\d+, R\d+, R\d+(\.reuse)?, UR\d+")


def _print_taylor_rtl_sass(name: str, body: str) -> None:
    """An RTL Taylor window instantiation's SASS: its instruction count, its
    local-memory instructions (any fails the run), and its accumulate: the
    branch-free block that holds a lane's 8 x (terms - 1) products a_k *
    cos_k + 2^(W-2), the terms' slices and wraps and the tree, from the
    join after the generators to the store's branch; its length over the
    lane's 8 samples, split by pipe, is the accumulate per sample.  One
    instantiation serves every W of its regime pair, W + s > 32 included."""
    ins, blocks = _sass_blocks(body)
    local = sum(1 for _, text in ins if re.search(r"\b(LDL|STL)", text))
    m = re.search(r"rtl_kernelILi(\d)ELi(\d)E", name)
    regs = "/".join(_TAYLOR_REGIMES[g] for g in m.groups())
    terms = 2 if m.group(2) == "0" else 3
    kg = TAYLOR_KG["window"]
    acc = next((b for b in blocks if sum(bool(_RTL_PRODUCT.search(t)) for t in b)
                >= kg * (terms - 1)), None)
    line = f"sass taylor_window_rtl ({regs}, {terms} terms, every W): {len(ins)} instructions; "
    if acc:
        line += (f"the accumulate {len(acc)} for a lane's {kg} samples, {len(acc) / kg:.2f} a "
                 f"sample ({_pipe_str(_pipes(acc), kg)}); ")
    else:
        line += "no accumulate block found; "
    print(line + f"{local} local-memory instructions")
    _require(local == 0, f"{name[:60]}: {local} local-memory instructions")


#: an atan2 iteration's sign mask of y, (S)ys >> (B - 1): the one shift by 31
_SIGN_MASK = re.compile(r"^SHF\.R\.S32\.HI R\d+, RZ, 0x1f, R\d+")


def _print_unrolled_sass(name: str, body: str) -> None:
    """An atan2/discriminator or taylor2 instantiation's SASS: its
    instruction count, its local-memory instructions (a run with any
    fails), and its repeated unit.  atan2: one vectoring iteration of the
    unrolled chain, the instructions from one sign mask of y to the next
    (the median spacing, split by pipe at a span of that length); taylor2:
    the median branch-free block, one harmonic of one sample."""

    ins, runs = _sass_blocks(body)
    local = sum(1 for _, text in ins if re.search(r"\b(LDL|STL)", text))
    m = re.search(r"(atan2_kernel|demod_int_kernel|demod_iq_kernel|taylor2_window_kernel)I"
                  r"([^E]*E(?:[^E]*E)?)", name)
    what = m.group(1) + "<" + m.group(2) + ">" if m else name[:60]
    if "taylor2" in what:
        blocks = [r for r in runs if len(r) >= 4]
        median = float(np.median([len(r) for r in blocks])) if blocks else 0.0
        block = min(blocks, key=lambda r: abs(len(r) - median)) if blocks else []
        unit = f"median branch-free block {median:.0f} ({_pipe_str(_pipes(block))})"
    else:
        texts = [re.sub(r"^@!?U?P\w+\s+", "", t.strip()) for _, t in ins]
        at = [i for i, t in enumerate(texts) if _SIGN_MASK.match(t)]
        gaps = [b - a for a, b in zip(at, at[1:])]
        if gaps:
            g = int(np.median(gaps))
            k = [i for i, d in enumerate(gaps) if d == g][len([d for d in gaps if d == g]) // 2]
            span = [t for _, t in ins[at[k]:at[k + 1]]]
            unit = (f"one vectoring iteration {g} ({_pipe_str(_pipes(span))}; "
                    f"{len(at)} sign masks)")
        else:
            unit = "no iteration found"
    print(f"sass {what}: {len(ins)} instructions; {unit}; {local} local-memory instructions")
    _require(local == 0, f"{what}: {local} local-memory instructions")


#: the taylor2 run walk's pass: two harmonics over a lane's 16 samples
TAYLOR2_PASS_TERMS = 32


def _print_taylor2_walk_sass(name: str, body: str) -> None:
    """A taylor2 run-walk instantiation's SASS: its instruction count, and
    in its harmonic-pair pass (the innermost loop with a high-word product
    a term) the instructions a sample and harmonic runs where no lane
    leaves its run: the pass less the re-entries (the spans a forward
    branch skips that hold a ROM load), split by pipe per term; the
    re-entries counted, the pass's predicated instructions, and its
    local-memory instructions (any fails the run)."""
    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    addr = [int(a, 16) for a, _ in ins]
    jumps = [(a, int(b.group(1), 16)) for a, (_, t) in zip(addr, ins)
             if (b := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", t))]
    local = sum(1 for _, t in ins if re.search(r"\b(LDL|STL)", t))
    regime = {"2": "walk", "3": "walk_lo"}[re.search(r"ILi(\d)E", name).group(1)]

    def span(lo, hi):
        return [t for a, (_, t) in zip(addr, ins) if lo <= a <= hi]

    npass = next(((lo, hi) for hi, lo in sorted((j for j in jumps if j[1] < j[0]),
                                                key=lambda j: j[0] - j[1])
                  if sum("IMAD.HI" in t for t in span(lo, hi)) >= TAYLOR2_PASS_TERMS), None)
    line = f"sass taylor2_window_kernel<{regime}>: {len(ins)} instructions; "
    if npass:
        lo, hi = npass
        skips = [(a, b) for a, b in jumps if lo <= a < b <= hi
                 and any("LDG" in t for t in span(a, b))]
        path = [t for a, (_, t) in zip(addr, ins)
                if lo <= a <= hi and not any(x < a < y for x, y in skips)]
        line += (f"one pass (two harmonics, 16 samples) {len(path)} outside its {len(skips)} "
                 f"re-entries, {len(path) / TAYLOR2_PASS_TERMS:.1f} a sample and harmonic "
                 f"({_pipe_str(_pipes(path), TAYLOR2_PASS_TERMS)}), "
                 f"{sum(t.lstrip().startswith('@') for t in path)} of them predicated; ")
    else:
        line += "no pass loop found; "
    print(line + f"{local} local-memory instructions")
    _require(local == 0, f"{name[:60]}: {local} local-memory instructions")


def _row_walk(body: str, marker: str, least: int, keys: tuple) -> tuple[int, dict, int]:
    """An outer kernel instantiation's SASS: (instruction count, the counts
    of ``keys`` in one pass of its row walk, local-memory instructions).  The
    row walk is the innermost loop (backward branch) that holds at least
    ``least`` instructions matching ``marker``; ``{}`` where none does."""

    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    addr = [int(a, 16) for a, _ in ins]
    loops = [(int(b.group(1), 16), a) for a, (_, text) in zip(addr, ins)
             if (b := re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text)) and int(b.group(1), 16) < a]
    count = {}
    for lo, hi in sorted(loops, key=lambda span: span[1] - span[0]):
        texts = [t for a, (_, t) in zip(addr, ins) if lo <= a <= hi]
        if sum(1 for t in texts if re.search(marker, t)) >= least:
            count = {k: sum(1 for t in texts if re.search(rf"\b{re.escape(k)}", t))
                     for k in keys}
            count["instructions"] = len(texts)
            break
    local = sum(1 for _, t in ins if re.search(r"\b(LDL|STL)", t))
    return len(ins), count, local


def _print_float_sass(name: str, body: str) -> None:
    """An f32/comp outer kernel instantiation's SASS: its instruction count,
    its local-memory instructions, and the FFMA, LDS and STG instructions of
    one pass of its row walk (the innermost loop that holds FFMAs: one h row
    at the thread's V lanes, V = 4, or 1 in the runtime-count
    instantiations)."""

    m = re.search(r"float_kernelILi(\d)ELi(n?\d)ELi(n?\d)ELb([01])E", name)
    if not m:
        print(f"sass float_kernel: unrecognised instantiation {name[:80]}")
        return
    mode, nc, npl, summed = m.groups()
    runtime = nc.startswith("n")  # NC = -1: the runtime-count instantiation
    n_ins, count, local = _row_walk(body, r"\bFFMA\b", 1, ("FFMA", "LDS", "STG"))
    what = ("f32 K-1=" + ("runtime" if runtime else nc) if mode == "1"
            else "comp (C,P)=" + ("runtime" if runtime else f"({nc},{npl})"))
    lanes = 1 if runtime else 4
    walk = (", ".join(f"{v} {k}" for k, v in count.items()) if count else "not found")
    print(f"sass float_kernel {what} {'checksum' if summed == '1' else 'write-out'}: "
          f"{n_ins} instructions; one row of the walk ({lanes} samples): {walk}; "
          f"{local} local-memory instructions")


def _print_int_sass(name: str, body: str) -> None:
    """An int outer kernel instantiation's SASS: its instruction count, its
    local-memory instructions (a run with any fails), and the IMAD.WIDE,
    IADD3 (with IADD3.X), LEA.HI (the funnel shift and accumulate), SHF,
    LDS and STG instructions of one pass of its row walk (the innermost loop
    with two IMAD.WIDE a harmonic and lane: one h row at the thread's V = 4
    lanes, or one lane and up to 7 harmonics in the runtime-count
    instantiation), with the IMAD.WIDE and all instructions per harmonic
    and sample."""

    m = re.search(r"int_kernelILi(n?\d)ELi(\d+)ELb([01])E", name)
    if not m:
        print(f"sass int_kernel: unrecognised instantiation {name[:80]}")
        return
    nk, shift, summed = m.groups()
    runtime = nk.startswith("n")  # NK = -1: the runtime-count instantiation
    k, lanes = (7, 1) if runtime else (int(nk), 4)
    n_ins, count, local = _row_walk(body, r"\bIMAD\.WIDE\b", 2 * k * lanes,
                                    ("IMAD.WIDE", "IADD3", "LEA.HI", "SHF", "LDS", "STG"))
    what = "K-1=runtime s=runtime" if runtime else f"K-1={nk} s={shift}"
    walk = (", ".join(f"{v} {key}" for key, v in count.items()) if count else "not found")
    if count and not runtime:
        walk += (f"; per harmonic and sample {count['IMAD.WIDE'] / (k * lanes):.2f} IMAD.WIDE, "
                 f"{count['instructions'] / (k * lanes):.2f} instructions")
    print(f"sass int_kernel {what} {'checksum' if summed == '1' else 'write-out'}: "
          f"{n_ins} instructions; one row of the walk ({lanes} samples): {walk}; "
          f"{local} local-memory instructions")
    _require(local == 0, f"int_kernel {what}: {local} local-memory instructions")


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


def _device_rows(prof):
    """(name, ms, count) of each CUDA kernel and copy a profile holds.  The
    port's spans (``bhw.*``) also appear on the device timeline, as
    annotations around the kernels they hold: they are left out, or the
    kernels would count twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key.startswith("bhw."):
            continue
        us = getattr(e, "self_device_time_total", None)
        rows.append((e.key, (e.self_cuda_time_total if us is None else us) / 1e3, e.count))
    return rows


def _device_ms(fn, calls: int = 5) -> float:
    """Device time per call of ``fn`` under torch.profiler: every CUDA
    kernel and copy it ran, summed, over ``calls`` calls after a warm-up.
    The profile records the CPU too: a CUDA-only profile once recorded no
    device time for the ctypes-launched outer kernels (H100, PyTorch
    2.11).  No device time fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms = sum(r[1] for r in _device_rows(prof))
    _require(ms > 0, "torch.profiler recorded no device time")
    return ms / calls


#: device-time groups of the two profiled calls, in match order: name ->
#: substrings of a kernel's name (lower case); the rest is the last group
DDC_GROUPS = {"ddc_mixer": ("ddc_mixer", "ddc_table_mixer"), "ddc_nco_table": ("ddc_nco_table",),
              "materialize": ("materialize",),
              "FIR (conv, gemm)": ("conv", "cudnn", "gemm", "xmma", "cutlass", "gemv", "dot"),
              "elementwise": ()}
SDR_GROUPS = {"fm_demod": ("demod",), "polyphase_fir": ("polyphase",),
              "fft": ("fft",), "elementwise or copy": ()}
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    rows = _device_rows(prof)
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
    from blackman_harris_win_tpu_torch.pipeline.channelizer import (
        channel_bins,
        design_prototype,
        polyphase_channelize,
    )
    from blackman_harris_win_tpu_torch.kernels.cordic import atan2_fixed, atan2_fixed_plain
    from blackman_harris_win_tpu_torch.kernels import ddc_kernel
    from blackman_harris_win_tpu_torch.kernels.ddc_kernel import mixer as ddc_mixer
    from blackman_harris_win_tpu_torch.kernels import demod_kernel as dmk
    from blackman_harris_win_tpu_torch.kernels import fastwin_kernel as fk
    from blackman_harris_win_tpu_torch.pipeline.demod import (
        fm_demod_conj,
        fm_demod_phase,
        fm_demod_phase_plain,
    )
    from blackman_harris_win_tpu_torch.pipeline.ddc import (
        ddc,
        freq_word,
        mixer_plain,
        nco_table_plain,
    )
    from blackman_harris_win_tpu_torch.pipeline.fir import decimating_fir, design_lowpass
    from blackman_harris_win_tpu_torch.pipeline.sdr import discriminate_plain, sdr_chain
    from blackman_harris_win_tpu_torch.pipeline.spectrometer import pfb_power
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
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"maximum SM clock: {clock.strip().splitlines()[0]}")
    path, log, secs = _build.build()
    _build.lib()
    print(f"build: {secs:.1f} s -> {path.name}")
    fn = "?"
    # may not spill ("demod_int_kernel" before "int_kernel": the first match counts)
    fused = "polyphase_dft_kernel"
    in_registers = {"taylor_window_rtl_kernel": 0, "demod_int_kernel": 0, "int_kernel": 0,
                    "ddc_mixer_kernel": 0, "ddc_table_mixer_kernel": 0,
                    "ddc_nco_table_kernel": 0, "atan2_kernel": 0, "demod_iq_kernel": 0,
                    "taylor2_window_kernel": 0, fused: 0}
    fused_ptxas = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.strip()
        elif "Used" in line or "spill" in line:
            print(f"  ptxas {fn}: {line.split('info    :')[-1].strip()}")
            if fused in fn:
                fused_ptxas.append(line.split("info    :")[-1].strip())
            family = next((k for k in in_registers if k in fn), None)
            if family and "spill" in line:
                in_registers[family] += 1
                _require(re.search(r"\b0 bytes stack frame, 0 bytes spill stores, "
                                   r"0 bytes spill loads", line) is not None,
                         f"ptxas {fn}: {line.strip()}")
    if not log:
        print("ptxas: the library was built before this run, no ptxas lines")
    # demod_int_kernel: I/Q type x word x mode x walk (lanes on t or on
    # rows); taylor2_window_kernel: ROM only, per sample, the run walk
    # without and with the P_lo term; taylor_window_rtl_kernel: the regime
    # pairs (10), each one tree for every W (W + s > 32 included)
    want_inst = {"taylor_window_rtl_kernel": 10, "demod_int_kernel": 16, "int_kernel": 30,
                 "ddc_mixer_kernel": 40, "ddc_table_mixer_kernel": 2,
                 "ddc_nco_table_kernel": 20, "atan2_kernel": 4, "demod_iq_kernel": 4,
                 "taylor2_window_kernel": 4, fused: 1}
    _require(not log or in_registers == want_inst,
             f"ptxas reported {in_registers} instantiations, want {want_inst}")
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
    ps_mxu, ps_rfft = _counted(
        launched, "3 analyzer", ("window_block", "welch_stage1", "welch_power_mean"),
        lambda: (windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="mxu"),
                 windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="rfft")),
        exact={"window_block": 2, "welch_stage1": 1, "welch_power_mean": 1})
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
        launched, "5 analyzer float/comp",
        ("outer_block_f32", "welch_stage1", "outer_block_comp", "welch_power_mean"),
        lambda: (windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode="float",
                                         fft_mode="mxu"),
                 windowed_power_spectrum(x, "bh4", spec4, hop=hop, win_mode="comp",
                                         fft_mode="rfft")))
    # the TAYLOR source, bench_all configs 16-18 (pw=26, 2^26 phases)
    tay_cfgs = ((16, 10), (32, 12))  # (W, LS)
    tay_specs = {  # name -> spec: HLS, RTL and taylor2, each through its kernel
        "blackman": WindowSpec(pw, 32, sin_type="taylor", lut_size=12, overflow="wrap"),
        "hamming": WindowSpec(pw, 16, sin_type="taylor", lut_size=10, overflow="saturate"),
        "hamming rtl": WindowSpec(pw, 16, sin_type="taylor", rounding="rtl", lut_size=10,
                                  overflow="saturate"),
        "blackman rtl": WindowSpec(pw, 32, sin_type="taylor", rounding="rtl", lut_size=12,
                                   overflow="wrap"),
        "bh7 taylor2": WindowSpec(pw, 32, sin_type="taylor2", lut_size=12, overflow="wrap"),
    }
    tay_q = {k: catalog.get(k.split()[0]).quantized(sp.data_width)
             for k, sp in tay_specs.items()}

    def taylor_phase():
        cs = {cfg: taylor_sincos_block(0, n, pw, *cfg, device=dev) for cfg in tay_cfgs}
        fns = {cfg: tk.make_checksum_fn_taylor(pw, *cfg, rows=64, device=dev) for cfg in tay_cfgs}
        return (cs, fns, {cfg: fns[cfg](0, bias) for cfg in tay_cfgs},
                {k: make_window(k.split()[0], sp, device=dev) for k, sp in tay_specs.items()})

    tay_cs, tay_fns, tay_chk, tay_win = _counted(
        launched, "6 taylor", ("taylor_sincos_block", "taylor_checksum", "taylor_window_block",
                               "taylor_window_rtl", "taylor2_window_block"), taylor_phase,
        exact={"taylor_sincos_block": 2, "taylor_checksum": 2, "taylor_window_block": 2,
               "taylor_window_rtl": 2, "taylor2_window_block": 1})
    # the DDC, bench_all config 21
    fc21, dec21, pw21, w21 = 1 / 8, 4, 20, 16
    h21 = design_lowpass(64, 0.8 / dec21)
    bb = _counted(launched, "7 ddc", ("ddc_nco_table", "ddc_mixer", "materialize"),
                  lambda: ddc(x21, fc21, dec21, taps=h21, phase_width=pw21, data_width=w21,
                              flavor="dds48"),
                  exact={"ddc_nco_table": 1, "ddc_mixer": 1, "materialize": 1})
    # the SDR chain: dryrun stage 4's configuration over 2^22 samples (a
    # latency check with the tone gate) and bench_all config 5
    n_ch, tpb, aw, offset = 4, 6, 20, 0.005
    proto = design_prototype(n_ch, tpb)
    proto5 = design_prototype(c5, tpb5)
    nn = torch.arange(1 << 22, device=dev, dtype=torch.float64)
    x_sdr = torch.cos(2 * np.pi * (1 / n_ch + offset) * nn).to(torch.float32)
    del nn
    sdr_out, sdr5_out = _counted(launched, "8 sdr", ("polyphase_fir", "fm_demod"),
                                 lambda: (sdr_chain(x_sdr, proto, n_ch, angle_width=aw),
                                          sdr_chain(x_sdr5, proto5, c5, angle_width=aw)),
                                 exact={"polyphase_fir": 2, "fm_demod": 2})
    g_cell = torch.Generator(device=dev).manual_seed(args.seed + 26)
    x_cell = torch.randn(1 << 22, generator=g_cell, device=dev, dtype=torch.complex64)
    proto_cell = design_prototype(128, 16)
    cell_out = _counted(launched, "8 sdr cell", ("polyphase_dft", "fm_demod"),
                        lambda: sdr_chain(x_cell, proto_cell, 128, angle_width=aw),
                        exact={"polyphase_dft": 1, "fm_demod": 1})
    # the PFB spectrometer at its cell's shape: one board's 16 int8 feeds
    # through 2048 channels of 4 taps, 8 integrations of 1024 spectra
    c_pfb, tpb_pfb, acc_pfb = 2048, 4, 1024
    proto_pfb = design_prototype(c_pfb, tpb_pfb)
    x_pfb = _int8_capture(args.seed, dev, 16, (8 * acc_pfb + tpb_pfb - 1) * c_pfb)
    pfb_out = _counted(launched, "8 pfb cell", ("polyphase_fir", "welch_power_mean"),
                       lambda: pfb_power(x_pfb, proto_pfb, c_pfb, acc_pfb),
                       exact={"polyphase_fir": 1, "welch_power_mean": 1})
    # the demod module's other entry points on config 5's quantized channel
    # I/Q: each channel's phase angle, and the phase-difference discriminator
    y5 = polyphase_channelize(x_sdr5, proto5, c5)
    i5 = torch.round(y5.real * 2.0**14).to(torch.int32)
    q5 = torch.round(y5.imag * 2.0**14).to(torch.int32)
    ang5, dph5 = _counted(launched, "8 demod entries", ("cordic_atan2", "fm_demod"),
                          lambda: (atan2_fixed(q5, i5, 16, aw),
                                   fm_demod_phase(i5.mT, q5.mT, 16, aw)),
                          exact={"cordic_atan2": 1, "fm_demod": 1})
    # STFT/WOLA round trips at the analyzer configuration
    stft_res = _counted(launched, "9 stft", ("window_block", "outer_block_f32", "outer_block_comp"),
                        lambda: _stft_round_trips(x_stft, spec4, hop, dev))
    # the front end: the CLI in this process on the inputs above, at full size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        paths = _front_end_inputs(Path(tmp), x, x21, x_stft)
        fe = _counted(launched, "10 front end",
                      ("window_block", "taylor_window_block", "outer_block", "outer_block_f32",
                       "outer_block_comp", "welch_stage1", "materialize", "ddc_nco_table",
                       "ddc_mixer", "taylor2_window_block"),
                      lambda: _front_end_phase(Path(tmp), paths))
        fe["gen taylor rtl hamming"] = _counted(
            launched, "10 gen taylor rtl", ("taylor_window_rtl",),
            lambda: _cli_npy(Path(tmp), TAYLOR_RTL_GEN), exact={"taylor_window_rtl": 1})
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
    rel_sum = abs(float(ps_mxu.double().sum() - ps_rfft.double().sum())) / float(
        ps_rfft.double().sum())
    _require(rel_sum < 1e-5, f"mxu vs rfft summed spectrum rel diff {rel_sum:.3e}")
    wq = window_block(d4.quantized(17), spec4, 0, nfft, dev)
    win64 = wq.double() * window_scale(spec4, d4.shift)
    ref = _f64_welch(x, win64, nfft, hop)
    budget = 32 * 2.0**-24 * np.sqrt(nfft)
    rel_bin = float(((ps_mxu.double() - ref).abs() / ref.abs()).max())
    _require(rel_bin < budget, f"analyzer per-bin rel err {rel_bin:.3e} > {budget:.3e}")
    rel_rfft = float(((ps_rfft.double() - ref).abs() / ref.abs()).max())
    _require(rel_rfft < budget, f"analyzer rfft per-bin rel err {rel_rfft:.3e} > {budget:.3e}")
    print(f"analyzer: mxu vs rfft summed rel {rel_sum:.3e} (< 1e-5); per-bin rel "
          f"vs float64 {rel_bin:.3e}, rfft {rel_rfft:.3e} (< 32*2^-24*sqrt(nfft) = "
          f"{budget:.3e})")

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
    err_wpm, t_wpm = _welch_power_gates(x, win32, nfft, hop, dev)
    err_pf, t_pf, (err_pd, t_pd, dft_shape) = _polyphase_gates(x_sdr5, proto5, c5, tpb5,
                                                                args.seed, dev, fused_ptxas)
    pfb_res = _spectrometer_gates(x_pfb, pfb_out, proto_pfb, c_pfb, tpb_pfb, acc_pfb, dev)
    pfb_shape = (*x_pfb.shape, c_pfb, tpb_pfb, acc_pfb)
    del x_pfb, pfb_out

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
    err_trtl = _taylor_rtl_gates({k: tay_win[k] for k in ("hamming rtl", "blackman rtl")},
                                 tay_specs, dev, rng)

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
    err_mixer, err_table = _ddc_mixer_gates(x21, pw21, w21, rng, dev)
    _require(sdr_out.shape == ((1 << 22) // n_ch - tpb, n_ch), "SDR output shape")
    err_fm = _sdr_gates("dryrun 4x6", x_sdr, sdr_out, proto, n_ch, aw, offset, rng)
    _require(sdr5_out.shape == ((c5 << 22) // c5 - tpb5, c5), "SDR config 5 output shape")
    err_fm = max(err_fm, _sdr_gates("config 5 16x8", x_sdr5, sdr5_out, proto5, c5, aw, None, rng,
                                    frames=1 << 16))
    _require(cell_out.shape == ((1 << 22) // 128 - 16, 128), "SDR cell output shape")
    err_fm = max(err_fm, _sdr_gates("sdr cell 128x16", x_cell, cell_out, proto_cell, 128, aw,
                                    None, rng, frames=1 << 12))
    del cell_out, x_cell
    # the discriminator's two entries on config 5: the chain's half spectrum
    # and the full one (a complex stream's) give the chain's output
    y5h = channel_bins(x_sdr5, proto5, c5)
    _require(torch.equal(dmk.iq_demod(y5h, aw, n_channels=c5), sdr5_out) and
             torch.equal(dmk.iq_demod(y5, aw), sdr5_out),
             "fm_demod on config 5: the half- and full-spectrum entries differ from the chain")
    print(f"fm_demod on config 5: the half-spectrum entry {tuple(y5h.shape)} and the full-"
          f"spectrum entry {tuple(y5.shape)} bit-equal to the chain's output")
    del sdr5_out
    # the demod entries of phase 8 against their plain versions on the card
    err_atan = int((ang5 - atan2_fixed_plain(q5, i5, 16, aw)).abs().max())
    err_ph = _int_demod_gates(dph5, i5, q5, aw)
    _require(err_atan == 0, f"phase 8 atan2_fixed vs plain on the card: {err_atan} LSB")
    print(f"phase 8 demod entries on config 5's I/Q {tuple(i5.shape)}: atan2_fixed and "
          "fm_demod_phase 0-LSB equal to their plain versions on the card")
    del ang5, dph5
    err_d = _demod_gates(dev, rng)
    err_atan, err_fm = max(err_atan, err_d), max(err_fm, err_ph, err_d)
    err_t2 = _taylor2_gates(tay_win["bh7 taylor2"], q7, tay_specs["bh7 taylor2"], dev, rng)
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
        "gen taylor rtl hamming": tay_win["hamming rtl"].cpu().numpy(),
        "gen taylor2": tay_win["bh7 taylor2"].cpu().numpy(),
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
        "win_taylor_blackman": tay_win["blackman"], "spec_taylor2": tay_specs["bh7 taylor2"],
        "spec_taylor_rtl": tay_specs["blackman rtl"],
        "q_taylor_rtl": catalog.get("blackman").quantized(32),
        "win_taylor_rtl": tay_win["blackman rtl"],
        "win_taylor2": tay_win["bh7 taylor2"], "win_f32": win_f32, "win_s": win_s,
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
        "welch_power_mean": t_wpm,
        "polyphase_fir": t_pf["config 5"],
        "polyphase_dft": t_pd,
        **{k: v[1] for k, v in pfb_res.items()},
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
        **{f"taylor_window_rtl {k}": (
            _time_ms(lambda k=k: make_window(k.split()[0], tay_specs[k], device=dev)),
            _time_ms(lambda k=k: tk.taylor_window_rtl_plain(
                idx, catalog.get(k.split()[0]).quantized(tay_specs[k].data_width), tay_specs[k])),
        ) for k in ("hamming rtl", "blackman rtl")},
        # the wrapper on its own: one call alone, and per call of 16 queued
        **{f"taylor_window_rtl {k} wrapper": (
            _time_ms(lambda k=k: tk.window_rtl_block(tay_q[k], tay_specs[k], 0, n, dev)),
            _time_batch_ms(lambda b, k=k: tk.window_rtl_block(tay_q[k], tay_specs[k], 0, n,
                                                              dev)),
        ) for k in ("hamming rtl", "blackman rtl")},
        "analyzer float/mxu vs comp/rfft": (
            _time_ms(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop,
                                                     win_mode="float", fft_mode="mxu")),
            _time_ms(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop,
                                                     win_mode="comp", fft_mode="rfft")),
        ),
    }
    dev_ms = {}
    # the analyzer's device time by kernel (phase 3's call), for the matmul tail
    _profile(lambda: windowed_power_spectrum(x, "bh4", spec4, hop=hop, fft_mode="mxu"),
             f"{label} analyzer mxu", ANALYZER_GROUPS)
    # one config-5 SDR call by kernel group: where the chain's time goes now
    prof_sdr = _profile(lambda: sdr_chain(x_sdr5, proto5, c5, angle_width=aw),
                        f"{label} sdr config 5", SDR_GROUPS)
    # the discriminator on config 5's channelizer output and the elementwise
    # atan2 on its I/Q: each kernel and its plain version in torch ops
    t["fm_demod"] = (_time_ms(lambda: dmk.iq_demod(y5h, aw, n_channels=c5)),
                     _time_ms(lambda: discriminate_plain(y5, aw)))
    t["cordic_atan2"] = (_time_ms(lambda: atan2_fixed(q5, i5, 16, aw)),
                         _time_ms(lambda: atan2_fixed_plain(q5, i5, 16, aw)))
    t_phase5 = (_time_ms(lambda: fm_demod_phase(i5.mT, q5.mT, 16, aw)),
                _time_ms(lambda: fm_demod_phase_plain(i5.mT, q5.mT, 16, aw)))
    # the integer discriminator's other calls on the same I/Q: conj on the
    # transpose, both modes on contiguous rows (the kernel alone)
    i5c, q5c = i5.mT.contiguous(), q5.mT.contiguous()
    t_int5 = {("conj", "transposed"): _time_ms(lambda: fm_demod_conj(i5.mT, q5.mT, 16, aw)),
              ("phase", "contiguous rows"): _time_ms(lambda: fm_demod_phase(i5c, q5c, 16, aw)),
              ("conj", "contiguous rows"): _time_ms(lambda: fm_demod_conj(i5c, q5c, 16, aw))}
    del i5c, q5c
    t_fm_full = _time_ms(lambda: dmk.iq_demod(y5, aw))
    t_chan5 = _time_ms(lambda: channel_bins(x_sdr5, proto5, c5))
    # the taylor2 window: the kernel and its plain version
    spec_t2 = tay_specs["bh7 taylor2"]
    t["taylor2_window_block"] = (_time_ms(lambda: make_window("bh7", spec_t2, device=dev)),
                                 _time_ms(lambda: fk.taylor2_window_plain(idx, q7, spec_t2)))
    # the DDC's quantizer, NCO, integer mixer and f32 rescale: the kernel
    # and its plain version in torch ops (a comparison row only)
    fw21 = freq_word(fc21, pw21)
    _require(DDC_PATHS[0][1:] == (fw21, pw21), "DDC_PATHS[0] is not config 21's word")
    p21 = ddc_kernel.nco_period(fw21, pw21)
    t["ddc_nco_table"] = (
        _time_ms(lambda: ddc_kernel.nco_table(fw21, pw21, w21, "dds48", device=dev)),
        _time_ms(lambda: nco_table_plain(fw21, pw21, w21, "dds48", device=dev)))
    t_paths = {what: (_time_ms(lambda f=f, p=p: ddc_mixer(x21, f, p, w21, "dds48")),
                      _time_ms(lambda f=f, p=p: ddc_kernel.nco_table(f, p, w21, "dds48",
                                                                     device=dev))
                      if ddc_kernel.table_period(f, p, 1 << 26) else None)
               for what, f, p in DDC_PATHS[1:]}
    t["ddc_mixer"] = (_time_ms(lambda: ddc_mixer(x21, fw21, pw21, w21, "dds48")),
                      _time_ms(lambda: mixer_plain(x21, fw21, pw21, w21, "dds48")))
    t_scaled = _time_ms(lambda: ddc_mixer(x21, fw21, pw21, w21, "scaled"))
    q_mixer = _time_batch_ms(lambda _: ddc_mixer(x21, fw21, pw21, w21, "dds48"))
    # the barrier kernel on the DDC's own mixer output, (2, 2^26) f32
    m21 = ddc_mixer(x21, fw21, pw21, w21, "dds48")
    # one call per event pair, as the DDC makes it; the per-call time of 16
    # queued calls, which hides the host's launch latency, is printed beside
    t["materialize"] = (_time_ms(lambda: materialize(m21)),
                        _time_ms(lambda: materialize_plain(m21)))
    lib_ms = {"materialize": _time_ms(lambda: torch.clone(m21)),
              "outer_block_f32": _time_ms(lib_f32), "outer_block_comp": _time_ms(lib_comp)}
    # the six outer kernels' device time (torch.profiler) beside their
    # one-call-alone time, and the library calls'
    dev_ms |= {"outer_block": _device_ms(
                  lambda: window_block_outer(0, nrows, q7, spec_hls, m=m, device=dev)),
              "outer_checksum": _device_ms(lambda: chk_outer_fn(0)),
              "outer_block_f32": _device_ms(lambda: float_window("bh7", pw, device=dev)),
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
    for k in ("outer_block", "outer_checksum", "outer_block_f32", "outer_checksum_f32",
              "outer_block_comp", "outer_checksum_comp"):
        print(f"time {label} {k}: {dev_ms[k]:.4f} ms device time (torch.profiler, per call of "
              f"5; a float checksum's finalize kernel included), {t[k][0]:.3f} ms "
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
        "ddc_mixer kernel": t["ddc_mixer"][0],
        "NCO + mixer + rescale (torch ops, comparison only)": t["ddc_mixer"][1],
        "materialize kernel": t["materialize"][0],
        "conv1d body (cuDNN, fp32)": _time_ms(lambda: torch.nn.functional.conv1d(
            mat21.reshape(-1, 1, 1 << 26), taps21, stride=dec21)),
        "wrap segment FIR": _time_ms(lambda: decimating_fir(seg21, h21, dec21)),
    }
    del mat21
    print(f"time {label} DDC 2^26 samples, decim {dec21}, 64 taps, dds48 pw={pw21} W={w21}: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in t_ddc.items())
          + f"; {(1 << 26) / t_ddc['ddc (whole call)'] / 1e3:.1f} Msamples/s in")
    prof_ddc = _profile(run_ddc, f"{label} ddc", DDC_GROUPS)
    print(f"ddc_mixer {label} phase 7 (DDC config 21, 2^26 samples, dds48 pw={pw21} W={w21}): "
          f"{counts['ddc_mixer']} launch(es) on the counted main path, 1 a DDC call; kernel "
          f"{t['ddc_mixer'][0]:.3f} ms one call alone, {q_mixer:.3f} ms per call of 16 queued "
          f"(scaled flavor {t_scaled:.3f} ms); torch-op NCO + mixer {t['ddc_mixer'][1]:.3f} ms "
          f"(comparison only); the DDC's device time {prof_ddc['busy']:.3f} ms of "
          f"{prof_ddc['wall']:.3f} ms wall")
    for what, f, p in DDC_PATHS:
        per = ddc_kernel.table_period(f, p, 1 << 26)
        b_ms, b_by = profiling.bound(12 << 26, min(per or 1 << 26, 1 << 26) * profiling.nco_ops(
            w21) + (1 << 26) * profiling.DDC_MIX_OPS)
        ms, tab = (t["ddc_mixer"][0], t["ddc_nco_table"][0]) if f == fw21 else t_paths[what]
        how = (f"its table included (the table kernel timed alone {tab:.3f} ms)" if tab
               else "no table")
        print(f"time {label} ddc_mixer {what} (fw {f}, 2^26 samples, dds48 W={w21}): {ms:.3f} "
              f"ms one call alone, {how}; bound {b_ms:.4f} ms ({b_by}), roofline share "
              f"{b_ms / ms:.1%}")
    def table21():
        return ddc_kernel.nco_table(fw21, pw21, w21, "dds48", device=dev)

    print(f"time {label} ddc_nco_table config 21 (P = {p21}): {t['ddc_nco_table'][0]:.3f} ms one "
          f"call alone, {_time_batch_ms(lambda _: table21()):.4f} ms per call of 16 queued, "
          f"{_device_ms(table21):.4f} ms device time: a launch's cost, not the table's")
    t_sdr = _time_ms(lambda: sdr_chain(x_sdr, proto, n_ch, angle_width=aw))
    print(f"time {label} SDR chain latency check, 2^22 samples, 4 channels x 6 taps, AW=20 "
          f"(channelizer + fm_demod kernel): {t_sdr:.3f} ms")
    print(f"ddc_mixer {label} phase 8: 0 launches a call: the SDR chain (channelizer + "
          "discriminator) runs no DDC")
    t_sdr5 = _time_ms(lambda: sdr_chain(x_sdr5, proto5, c5, angle_width=aw))
    print(f"time {label} SDR chain bench_all config 5, 16*2^22 samples, 16 channels x 8 taps, "
          f"AW=20: {t_sdr5:.3f} ms; {(c5 << 22) / t_sdr5 / 1e3:.1f} Msamples/s in; pieces: "
          f"channelizer (polyphase_fir + rfft) {t_chan5:.3f} ms, fm_demod kernel on the half "
          f"spectrum {t['fm_demod'][0]:.3f} ms, on the full spectrum {t_fm_full:.3f} ms (plain "
          f"discriminator in torch ops {t['fm_demod'][1]:.3f} ms, comparison only)")
    n_out5 = (y5.shape[0] - 1) * c5
    print(f"fm_demod {label}: {counts['fm_demod']} launch(es) on the counted main path "
          f"(phases 8 and 11: 1 a chain call or shard, 1 for fm_demod_phase); on config 5's "
          f"{tuple(y5h.shape)} half-spectrum channelizer output {t['fm_demod'][0]:.3f} ms, "
          f"{n_out5 / t['fm_demod'][0] / 1e6:.3f} Goutputs/s (full spectrum {tuple(y5.shape)} "
          f"{t_fm_full:.3f} ms); fm_demod_phase on its I/Q {t_phase5[0]:.3f} ms (plain "
          f"{t_phase5[1]:.3f} ms); cordic_atan2 (atan2_fixed) {t['cordic_atan2'][0]:.3f} ms "
          f"(plain {t['cordic_atan2'][1]:.3f} ms); the SDR call's device time "
          f"{prof_sdr['busy']:.3f} ms of {prof_sdr['wall']:.3f} ms wall")
    print(f"time {label} taylor2_window_block bh7 w32 ls12 pw26 (make_window): "
          f"{t['taylor2_window_block'][0]:.3f} ms, {n / t['taylor2_window_block'][0] / 1e6:.3f} "
          f"Gsamples/s; plain window_values_fast {t['taylor2_window_block'][1]:.3f} ms")
    for name, (fwd, inv, _) in stft_res.items():
        spec_x = fwd(x_stft)
        t_f, t_i = _time_ms(lambda: fwd(x_stft)), _time_ms(lambda: inv(spec_x))
        print(f"time {label} STFT {name} pair, 32*2^20 samples, nfft 2^20 hop 2^19: "
              f"stft {t_f:.3f} ms, istft {t_i:.3f} ms")
        del spec_x
    for k, terms in (("hamming rtl", 2), ("blackman rtl", 3)):
        sp, name = tay_specs[k], k.split()[0]
        ms, plain_ms = t[f"taylor_window_rtl {k}"]
        alone, queued = t[f"taylor_window_rtl {k} wrapper"]
        b_ms, b_by = profiling.bound(4 * n, n * profiling.taylor_window_rtl_ops(terms))
        print(f"time {label} taylor_window_rtl {name} W={sp.data_width} LS={sp.lut_size} pw26 "
              f"({terms} terms, make_window, {counts['taylor_window_rtl']} launches on the "
              f"counted main path): {ms:.3f} ms, {n / ms / 1e6:.3f} Gsamples/s; the wrapper "
              f"window_rtl_block {alone:.4f} ms alone, {queued:.4f} ms per call of 16 queued "
              f"({b_ms / queued:.1%} of the bound); plain taylor_window_rtl_plain "
              f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}), roofline share {b_ms / ms:.1%}; "
              f"its HLS twin taylor_window_block {t[f'taylor_window_block {name}'][0]:.3f} ms")
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
                                     m21.numel() * m21.element_size(), ddc_width=w21,
                                     sdr_shape=(y5.shape[0], c5, aw), ddc_period=p21,
                                     sdr_taps=tpb5, dft_shape=dft_shape, pfb_shape=pfb_shape)
    err_mat = ddc_res["mat_err"]
    tpu = "blackman_harris_win_tpu/kernels/pallas/"
    rows = [  # name, source, replaces (under tpu unless a full path), timing key, max abs err
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
        # no pallas_call: the jnp of _window_rtl with the TAYLOR cosine
        ("taylor_window_rtl", "taylor_kernel.cu", "blackman_harris_win_tpu/kernels/window.py:208",
         "taylor_window_rtl blackman rtl", err_trtl),
        ("materialize", "barrier_kernel.cu", "barrier.py:31", "materialize", err_mat),
        # no pallas_call: the jnp of nco_iq / mix_iq_int and ddc()'s front half
        ("ddc_nco_table", "ddc_kernel.cu", "blackman_harris_win_tpu/pipeline/ddc.py:49",
         "ddc_nco_table", err_table),
        ("ddc_mixer", "ddc_kernel.cu", "blackman_harris_win_tpu/pipeline/ddc.py:49", "ddc_mixer",
         err_mixer),
        # no pallas_call: the jnp of the vectoring atan2 and the discriminators
        ("fm_demod", "demod_kernel.cu", "blackman_harris_win_tpu/pipeline/demod.py:38",
         "fm_demod", err_fm),
        ("cordic_atan2", "demod_kernel.cu", "blackman_harris_win_tpu/kernels/cordic.py:275",
         "cordic_atan2", err_atan),
        # no pallas_call: the jnp of cos_sin_taylor2 / window_values_fast
        ("taylor2_window_block", "fastwin_kernel.cu",
         "blackman_harris_win_tpu/kernels/fastwin.py:123", "taylor2_window_block", err_t2),
        # no pallas_call: the jnp of frame_mean_power's rfft branch (a relative gap)
        ("welch_power_mean", "welchpower_kernel.cu",
         "blackman_harris_win_tpu/pipeline/spectral.py:172", "welch_power_mean", err_wpm),
        # no pallas_call: the jnp of polyphase_channelize's branch FIRs (the
        # gap over its bound)
        ("polyphase_fir", "polyphase_kernel.cu",
         "blackman_harris_win_tpu/pipeline/channelizer.py:43", "polyphase_fir", err_pf),
        # no pallas_call: the jnp of polyphase_channelize's branch FIRs and
        # its DFT across the branches, at the SDR cell's shape (the gap over
        # its bound against the plain version)
        ("polyphase_dft", "polyphase_kernel.cu",
         "blackman_harris_win_tpu/pipeline/channelizer.py:43", "polyphase_dft", err_pd),
        # the PFB spectrometer's cell: 16 feeds in one launch of the branch
        # FIRs (the gap over its bound), and the power mean's slab path (its
        # gap to the float64 mean over 2u); no JAX counterpart
        ("polyphase_fir", "polyphase_kernel.cu",
         "blackman_harris_win_tpu/pipeline/channelizer.py:43", "polyphase_fir pfb cell",
         pfb_res["polyphase_fir pfb cell"][0]),
        ("welch_power_mean", "welchpower_kernel.cu",
         "blackman_harris_win_tpu/pipeline/spectral.py:172", "welch_power_mean pfb cell",
         pfb_res["welch_power_mean pfb cell"][0]),
    ]
    kernels = []
    b_full = bounds["fm_demod"]
    print(f"bound {label} fm_demod full-spectrum entry: {b_full[0]:.4f} ms ({b_full[1]}); "
          f"measured {t_fm_full:.3f} ms, roofline share {b_full[0] / t_fm_full:.1%}")
    bounds["fm_demod"] = bounds["fm_demod_half"]  # the main path's entry
    # the integer front end on config 5's int32 I/Q: phase 8's call, then
    # the other mode and layout
    for (mode, layout), ms in {("phase", "transposed"): t_phase5[0], **t_int5}.items():
        b_ms, b_by = bounds["fm_demod_phase" if mode == "phase" else "fm_demod_int_conj"]
        print(f"bound {label} fm_demod {mode} int32 {layout} (16, {i5.shape[0]}): {b_ms:.4f} ms "
              f"({b_by}); measured {ms:.3f} ms, roofline share {b_ms / ms:.1%}")
    for name, source, replaces, key, err in rows:
        bound_ms, bound_by = bounds[key if key in bounds else name]
        kernels.append({"name": name, "at": key, "route": "cuda", "source": src + source,
                        "replaces": replaces if replaces.startswith("blackman") else tpu + replaces,
                        "launches": counts[name],
                        "max_abs_err": err, "ms": t[key][0], "plain_ms": t[key][1],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms.get(name)})
        print(f"bound {label} {key}: {bound_ms:.4f} ms ({bound_by}); measured {t[key][0]:.3f} ms,"
              f" roofline share {bound_ms / t[key][0]:.1%}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s host clock in all, build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
