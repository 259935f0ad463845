"""The multi-shard smoke run (counterpart of
``__graft_entry__.py:dryrun_multichip``): builds an n-shard (channels x
blocks) mesh and runs every sharded step on small shapes, each held by a
value check, in eight stages:

1. 2^20-point BH-7 window generation (no communication), bit for bit equal
   to the single-device ``window_samples``;
2. the halo + pmean Welch analyzer with the quantized, the native float32
   and the compensated-f32 window, each against its own exact host float64
   reference within the derived f32 budget ``32 * 2^-24 * sqrt(nfft)``;
3. the sharded comp (hi, lo) pair within 5e-9 of the float64 golden;
4. the exactly invertible sharded WOLA pair (round trip < 2e-5);
5. the sharded SDR chain recovering a known tone offset (< 2e-3);
6. a TAYLOR-source sharded window, bit for bit equal to single-device;
7. a pw=31 sub-range around the peak, bit for bit equal to single-device;
8. the sharded DDC (dds48 NCO) recovering a tone's offset (< 2e-4).

The stages, sizes and budgets are the JAX package's.  Run it on the cards
with ``python -m blackman_harris_win_tpu_torch.dist.dryrun N``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.config import WindowSpec
from ..kernels.window import window_samples
from ..windows import catalog
from .generate import sharded_comp_window, sharded_window, sharded_window_range
from .mesh import make_mesh, shard, unshard


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {msg}")


def _host_welch_ref(x_np, win_np, nfft: int, hop: int):
    """Exact float64 host reference of the sharded Welch step: the circular
    right halo makes the union of the shards' frames the frames of the
    circularly extended signal, so the sharded pmean equals this mean."""
    halo = nfft - hop
    xe = np.concatenate([x_np, x_np[:, :halo]], axis=1).astype(np.float64)
    nf = x_np.shape[1] // hop
    frames = np.stack([xe[:, m * hop:m * hop + nfft] for m in range(nf)], axis=1)
    sp = np.fft.rfft(frames * np.asarray(win_np, np.float64), axis=-1)
    return (np.abs(sp) ** 2).mean(axis=1)


def _rel(got, ref) -> float:
    return float(np.max(np.abs(got - ref) / (np.abs(ref) + 1e-300)))


def dryrun_multichip(n_shards: int, devices=None) -> None:
    """Run the eight stages on a mesh of ``n_shards`` shards: (2, n/2) for
    an even n > 1, else (1, n).  ``devices``: the mesh's devices (default
    every visible CUDA card; a list may repeat a device).  Raises
    ``AssertionError`` at the first stage that fails."""
    from ..pipeline.ddc import make_sharded_ddc
    from ..pipeline.sdr import make_sharded_sdr_chain
    from ..pipeline.spectral import make_sharded_welch, window_scale
    from ..pipeline.stft import make_sharded_istft, make_sharded_stft

    t0 = time.time()

    def stamp(msg):
        print(f"[dryrun {time.time() - t0:6.1f}s] {msg}", flush=True)

    channels = 2 if n_shards % 2 == 0 and n_shards > 1 else 1
    blocks = n_shards // channels
    mesh = make_mesh(blocks=blocks, channels=channels, devices=devices)
    dev = mesh.devices[0][0]

    stamp("stage 1: sharded gen 2^20")
    gen_spec = WindowSpec(phase_width=20, data_width=17)
    q7 = catalog.get("bh7").quantized(17)
    w = unshard(sharded_window(q7, gen_spec, mesh))
    _check(w.shape == (gen_spec.n,), f"sharded window shape {tuple(w.shape)}")
    w_single = window_samples(torch.arange(gen_spec.n, device=dev), q7, gen_spec)
    _check(torch.equal(w.long(), w_single), "sharded generation != single-device (bitwise)")

    stamp("stage 2: sharded welch (quantized)")
    spec = WindowSpec(phase_width=7, data_width=17)  # nfft = 128
    nfft, hop = 128, 64
    bh4 = catalog.get("bh4")
    q17 = bh4.quantized(17)
    c_total, block = 2 * channels, 2 * nfft
    x_np = np.random.default_rng(1).normal(size=(c_total, blocks * block)).astype(np.float32)
    x = shard(x_np, mesh, ("channels", "blocks"))
    out = unshard(make_sharded_welch(mesh, spec, q17, bh4.shift, nfft, hop)(x))
    out = out.cpu().numpy().astype(np.float64)
    _check(out.shape == (c_total, nfft // 2 + 1), f"welch shape {out.shape}")
    # f32 arithmetic: ~nfft f32 operations a bin, eps 2^-24, coherence
    # sqrt(nfft), x32 for the FFT's constant factors and the window's f32
    # rounding; a mis-tabled harmonic (>= 1e-2) fails loudly
    f32_budget = 32 * 2.0**-24 * float(np.sqrt(nfft))
    wq_host = window_samples(torch.arange(nfft), q17, spec).numpy().astype(
        np.float64) * window_scale(spec, bh4.shift)
    ref_q = _host_welch_ref(x_np, wq_host, nfft, hop)
    rel_q = _rel(out, ref_q)
    _check(rel_q < f32_budget, f"quantized welch vs exact f64 ref: {rel_q}")

    stamp("stage 2b: welch float mode")
    out_f = unshard(make_sharded_welch(mesh, spec, "bh4", bh4.shift, nfft, hop,
                                       win_mode="float")(x)).cpu().numpy().astype(np.float64)
    _check(out_f.shape == out.shape, f"float welch shape {out_f.shape}")
    ref_f = _host_welch_ref(x_np, catalog.float_window_value("bh4", np.arange(nfft), nfft),
                            nfft, hop)
    rel_f = _rel(out_f, ref_f)
    _check(rel_f < f32_budget, f"float welch vs exact f64 ref: {rel_f}")
    # the float-vs-quantized spread is the window quantization's effect
    # (seen in the two references), within twice the f32 budget
    rel_fq, rel_ref = _rel(out_f, out), _rel(ref_f, ref_q)
    _check(rel_fq < rel_ref + 2 * f32_budget, f"float vs quantized {rel_fq}, refs {rel_ref}")

    stamp("stage 2c: welch comp mode")
    hi_p, lo_p = (unshard(p).double().cpu().numpy() for p in sharded_comp_window("bh7", 14, mesh))
    gold = catalog.float_window_value("bh7", np.arange(1 << 14), 1 << 14)
    _check(np.max(np.abs(hi_p + lo_p - gold)) < 5e-9, "sharded comp pair accuracy")
    out_c = unshard(make_sharded_welch(mesh, spec, "bh4", bh4.shift, nfft, hop,
                                       win_mode="comp")(x)).cpu().numpy().astype(np.float64)
    rel_c = _rel(out_c, ref_f)
    _check(rel_c < f32_budget, f"comp welch vs exact f64 ref: {rel_c}")

    stamp("stage 3: sharded WOLA")
    fwd = make_sharded_stft(mesh, spec, q17, bh4.shift, nfft, hop)
    inv = make_sharded_istft(mesh, spec, q17, bh4.shift, nfft, hop)
    y = unshard(inv(fwd(x))).cpu()
    _check(tuple(y.shape) == x_np.shape, f"WOLA shape {tuple(y.shape)}")
    err = float((y - torch.from_numpy(x_np)).abs().max())
    _check(err < 2e-5, f"sharded WOLA round trip {err}")

    stamp("stage 4: sharded SDR")
    n_ch, tpb = 4, 6
    t_len = n_ch * 256  # 256 frames whatever the mesh (the tone mean's tolerance)
    offset = 0.005  # cycles/sample inside channel 1
    xs = np.cos(2 * np.pi * (1 / n_ch + offset) * np.arange(t_len)).astype(np.float32)
    demod = unshard(make_sharded_sdr_chain(mesh, n_ch, tpb, angle_width=20)(
        shard(xs, mesh, ("blocks",))))
    _check(tuple(demod.shape) == (t_len // n_ch, n_ch), f"SDR shape {tuple(demod.shape)}")
    f1 = float(demod[:, 1].double().mean()) / (1 << 20)
    _check(abs(f1 - offset * n_ch) < 2e-3, f"SDR channel-1 offset {f1}")

    stamp("stage 5: TAYLOR sharded gen")
    tay_spec = WindowSpec(phase_width=13, data_width=16, sin_type="taylor", lut_size=10,
                          rounding="hls", overflow="wrap")
    q_tay = catalog.get("blackman").quantized(16)
    w_tay = unshard(sharded_window(q_tay, tay_spec, mesh))
    w_tay_single = window_samples(torch.arange(tay_spec.n, device=dev), q_tay, tay_spec)
    _check(torch.equal(w_tay.long(), w_tay_single),
           "TAYLOR sharded generation != single-device (bitwise)")

    stamp("stage 6: pw=31 sharded range")
    big_spec = WindowSpec(phase_width=31, data_width=17)
    count = blocks * 2048
    n0 = (1 << 30) - count // 2  # spans the window's peak
    w_big = unshard(sharded_window_range(q7, big_spec, mesh, n0, count))
    w_big_single = window_samples(torch.arange(n0, n0 + count, device=dev), q7, big_spec)
    _check(torch.equal(w_big.long(), w_big_single),
           "pw=31 sharded range != single-device (bitwise)")

    stamp("stage 7: sharded DDC")
    dec, t2 = 4, blocks * 2048
    fc, df = 1 / 8, 0.003  # NCO at fs/8; the tone offset to recover
    xt = np.cos(2 * np.pi * (fc + df) * np.arange(t2)).astype(np.float32)
    ddc = make_sharded_ddc(mesh, phase_width=20, data_width=16, freq=fc, decim=dec, taps=64,
                           flavor="dds48")
    bb = unshard(ddc(shard(xt, mesh, ("blocks",)))).cpu().numpy().astype(np.float64)
    _check(bb.shape == (2, t2 // dec), f"DDC shape {bb.shape}")
    ph = np.unwrap(np.arctan2(bb[1], bb[0]))[8:-8]
    f_meas = float(np.mean(np.diff(ph)) / (2 * np.pi * dec))
    _check(abs(f_meas - df) < 2e-4, f"DDC tone offset {f_meas}")

    print(f"dryrun_multichip OK on {n_shards} shards (mesh {channels}x{blocks} over "
          f"{sorted({str(d) for row in mesh.devices for d in row})}; 8 verified stages: 2^20 "
          "sharded gen == single-device bitwise, halo'd Welch step (quantized + native-f32 + "
          "compensated-f32 modes each vs exact host f64 references at the derived f32 "
          "budget), sharded comp (hi,lo) pair < 5e-9 of the f64 golden, exact sharded WOLA "
          "round trip, sharded SDR chain tone recovery, TAYLOR blocked sharded gen bitwise, "
          "pw=31 (2G) sharded range bitwise, sharded DDC (dds48) tone shift)", flush=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count())
