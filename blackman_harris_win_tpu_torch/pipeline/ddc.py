"""Digital downconverter (DDC): fixed-point CORDIC NCO + integer I/Q mixer
+ decimating lowpass FIR, single device (counterpart of
``blackman_harris_win_tpu/pipeline/ddc.py``).

- The NCO phase is closed-form ``(n * freq_word) mod 2^PW``.  The JAX
  package computes it in wrapping int32; here ``n`` is masked to its low 32
  bits first, so the int64 product gives the same phase for any ``n0``.
- The NCO is the dds48 rotation engine (or the scaled one), whose second
  output carries -sin: the reference's axis quirk is the downconversion
  mixer phase, used as-is.
- The mixer is integer: 15-bit input times 2^(W-2)-amplitude NCO products,
  exact in int32 at the legal data widths.
- The decimating lowpass is ``pipeline/fir.py``; its bulk branch runs the
  materialization kernel (kernel 7) before the strided conv.

The NCO and the mixer run in int64/int32 torch ops on the tensor's device;
there is no NCO kernel (the JAX package has none either).
:func:`make_sharded_ddc` runs the DDC over a device mesh (``dist/``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.config import CordicSpec
from ..dist.halo import left_halo
from ..dist.mesh import Mesh, from_rows, local_map, shard
from ..kernels.cordic import cordic_sincos
from .fir import decimating_fir, design_lowpass

#: input quantization of the integer mixer (ADC-like front end)
MIX_IN_BITS = 15


def freq_word(freq: float, phase_width: int) -> int:
    """NCO tuning word: round(freq * 2^PW) phase steps/sample (freq in
    cycles/sample)."""
    return int(round(freq * (1 << phase_width))) & ((1 << phase_width) - 1)


def nco_iq(n, fw: int, phase_width: int, data_width: int,
           flavor: str = "dds48", device=None):
    """(cos, -sin) of the NCO at sample indices ``n`` as int32, amplitude
    2^(W-2): the pre-rotated engines' native output pair (DT_COS, DT_SIN).

    ``flavor``: "dds48" (src/cordic_dds48.vhd) or "scaled"
    (src/cordic_dds_scaled.vhd, the same pre-rotation and -sin axis).  ``n``
    is taken mod 2^32, as the JAX package's int32 lanes take it."""
    if flavor not in ("dds48", "scaled"):
        raise ValueError("NCO flavor must be 'dds48' or 'scaled'")
    n = _build.as_tensor(n, torch.int64, device)
    ph = ((n & 0xFFFFFFFF) * int(fw)) & ((1 << phase_width) - 1)
    c, ns = cordic_sincos(ph, CordicSpec(phase_width, data_width, flavor))
    return c.to(torch.int32), ns.to(torch.int32)


def mix_iq_int(xq, n, fw: int, phase_width: int, data_width: int,
               flavor: str = "dds48", device=None):
    """Integer I/Q mixer: ``xq`` int32 samples with |xq| < 2^MIX_IN_BITS at
    global indices ``n``.  Returns the raw int32 (i, q) products (scale
    2^(W-2) x input scale); the product needs MIX_IN_BITS + (W-2) + 1 bits
    and must fit an int32 lane, so data_width <= 17."""
    if MIX_IN_BITS + (data_width - 2) + 1 > 31:
        raise ValueError(
            f"mixer product needs {MIX_IN_BITS + data_width - 1} bits; "
            f"use data_width <= {31 - MIX_IN_BITS + 1} for int32 lanes"
        )
    xq = _build.as_tensor(xq, torch.int32, device)
    c, ns = nco_iq(n, fw, phase_width, data_width, flavor, xq.device)
    return xq * c, xq * ns


def ddc(x, freq: float, decim: int, taps=64, phase_width: int = 20,
        data_width: int = 16, cutoff: float | None = None,
        window: str = "bh4", n0: int = 0, flavor: str = "dds48", device=None):
    """Single-device DDC: float stream (..., T) -> complex baseband as a
    stacked (2, ..., T//decim) float32 tensor (I, Q), decimated by ``decim``.

    A tensor ``x`` runs on its device; array-like input goes to ``device``
    (default the card).  The input is quantized to MIX_IN_BITS, mixed with
    the integer NCO, rescaled once to float32, and lowpass-decimated
    (prototype: windowed sinc at ``cutoff`` fraction of Nyquist, default
    0.8/decim).  ``n0``: global index of x[..., 0] (streaming blocks).
    Output m is the tap window ending at input sample m*decim + decim - 1,
    circularly: the first (taps - decim) // decim outputs wrap to the end
    of the block.  With taps == decim there is no wrap (the body alone).
    """
    x = _build.as_tensor(x, torch.float32, device)
    t = x.shape[-1]
    if t % decim:
        raise ValueError(f"T = {t} must be a multiple of decim = {decim}")
    fw = freq_word(freq, phase_width)
    h = taps if hasattr(taps, "__len__") else design_lowpass(
        int(taps), (cutoff if cutoff is not None else 0.8 / decim), window=window)
    halo = len(h) - decim
    if halo < 0:
        raise ValueError("decimation larger than filter not supported")

    amp_in = float((1 << MIX_IN_BITS) - 1)
    xq = torch.round(x * amp_in).to(torch.int32)
    n = n0 + torch.arange(t, dtype=torch.int64, device=x.device)
    mi, mq = mix_iq_int(xq, n, fw, phase_width, data_width, flavor)
    scale = float(np.float32(1.0 / (amp_in * (1 << (data_width - 2)))))
    m2 = torch.stack([mi, mq]).to(torch.float32) * scale  # (2, ..., T)
    # the main FIR runs on the unpadded stream; the halo//decim wrapped
    # outputs come from a short separate segment, as in the JAX package
    body = decimating_fir(m2, h, decim)
    if halo == 0:
        return body
    seg = torch.cat([m2[..., t - halo:], m2[..., :halo]], dim=-1)
    return torch.cat([decimating_fir(seg, h, decim), body], dim=-1)


def shard_mixer_ints(x_ext, n_first: int, t_total: int, fw: int, phase_width: int,
                     data_width: int, flavor: str = "dds48"):
    """The integer mixer of one shard of the sharded DDC: ``x_ext`` (float)
    holds the global samples from index ``n_first`` on (below 0 for shard
    0's circular halo), which wrap circularly (n < 0 -> n + T).  Quantizes
    as :func:`ddc` does and returns the raw int32 (i, q) products.  The
    indices are int64 (``i*B - halo`` may pass 2^31) and the NCO takes them
    mod 2^32, as the JAX package's int32 lanes do."""
    amp_in = float((1 << MIX_IN_BITS) - 1)
    xq = torch.round(x_ext.to(torch.float32) * amp_in).to(torch.int32)
    n = torch.arange(n_first, n_first + x_ext.shape[-1], dtype=torch.int64, device=xq.device)
    n = torch.where(n < 0, n + t_total, n)
    return mix_iq_int(xq, n, fw, phase_width, data_width, flavor)


def make_sharded_ddc(mesh: Mesh, phase_width: int, data_width: int, freq: float, decim: int,
                     taps=64, cutoff: float | None = None, window: str = "bh4",
                     flavor: str = "dds48"):
    """Sharded DDC over the mesh's 'blocks' axis (JAX: ``make_sharded_ddc``).

    The step takes a global (T,) float stream split ('blocks',) and returns
    the (2, T//decim) baseband I/Q as a ``Sharded`` split (None, 'blocks').
    The halo is taken on the raw input (one ppermute of taps - decim
    samples), before mixing: the NCO phase is closed-form per global index,
    so each shard mixes its extended chunk at the circularly wrapped
    indices, which is :func:`ddc`'s circular alignment.  The mixer integers
    are those of the single-device NCO at the same indices; the output
    agrees with :func:`ddc` to f32 accuracy.

    ``flavor`` defaults to "dds48", as :func:`ddc` does.  (The JAX maker
    defaults to "scaled" because XLA:CPU ran the dds48 graph slowly inside
    ``shard_map``; the port has no such limit.)
    """
    fw = freq_word(freq, phase_width)
    h = taps if hasattr(taps, "__len__") else design_lowpass(
        int(taps), (cutoff if cutoff is not None else 0.8 / decim), window=window)
    h = np.asarray(h)
    halo = len(h) - decim
    if halo < 0:
        raise ValueError("decimation larger than filter not supported")
    scale = float(np.float32(1.0 / (((1 << MIX_IN_BITS) - 1) * (1 << (data_width - 2)))))
    nblocks = mesh.shape["blocks"]

    def shard_out(i, x, tail):
        b = x.shape[-1]
        mi, mq = shard_mixer_ints(torch.cat([tail, x], dim=-1), i * b - halo,
                                  b * nblocks, fw, phase_width, data_width, flavor)
        return decimating_fir(torch.stack([mi, mq]).to(torch.float32) * scale, h, decim)

    def step(x):
        xs = shard(x, mesh, ("blocks",))
        if xs.piece().shape[-1] % decim:
            raise ValueError("shard block must be a multiple of decim")
        rows = []
        for row in xs.shards:
            # the small halos first, then one shard's mixer at a time
            row = local_map(lambda x: x.to(torch.float32), row)
            tails = (left_halo(row, halo, circular=True) if halo
                     else local_map(lambda x: x[..., :0], row))
            rows.append(local_map(shard_out, range(nblocks), row, tails))
        return from_rows(mesh, (None, "blocks"), rows)

    return step
