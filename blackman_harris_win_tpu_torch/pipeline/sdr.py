"""The SDR chain: channelizer -> FM discriminator per channel (counterpart
of ``blackman_harris_win_tpu/pipeline/sdr.py``).

The sharded chain splits the wideband stream over the mesh's 'blocks'
(time) axis; each shard pulls a left halo of one prototype length and
channelizes its own frames (a frame belongs to the shard its last sample
lies in); the per-channel discriminator is frame-local, so nothing else is
communicated and the outputs stay split over 'blocks'.
"""

from __future__ import annotations

import torch

from .. import _trace
from ..dist.halo import left_halo
from ..dist.mesh import Mesh, from_rows, local_map, shard
from .channelizer import channel_bins, design_prototype, full_spectrum
from ..kernels.demod_kernel import IQ_WIDTH, iq_demod
from .demod import fm_demod_conj_plain


def sdr_chain(x, prototype, n_channels: int, angle_width: int = 20,
              iq_scale: float = 2.0**14, device=None):
    """Channelize, then discriminate each channel.  x: (T,) real int/float
    (a tensor runs on its device; array-like input goes to ``device``,
    default the card) -> (n_frames-1, n_channels) int64 angle LSBs (the
    instantaneous frequency per channel).

    ``iq_scale`` is a fixed quantization gain; size it so channel envelopes
    stay within +-2^15.  A real stream's channelizer output is its half
    spectrum (``channelizer.channel_bins``); on a card the quantizer and the
    discriminator are one launch of the demod kernel
    (``demod_kernel.iq_demod``), which reads the channels past C/2 as the
    conjugates of their bins, and on the CPU the plain discriminator takes
    the conjugate fill (``channelizer.full_spectrum``): both are the chain
    over ``polyphase_channelize``'s full spectrum, bit for bit.

    Under a profiler session the call is the span ``bhw.sdr``, with the
    channelizer's stages ``bhw.sdr.branches`` and ``bhw.sdr.dft``
    (``channel_bins``; on a complex64 capture at C = 128 the card runs both
    as one launch, in ``bhw.sdr.branches``) and the discriminator's
    ``bhw.sdr.demod`` (``_trace``).
    """
    with _trace.span("bhw.sdr"):
        y = channel_bins(x, prototype, n_channels, device)  # (nf, C//2 + 1) or (nf, C)
        with _trace.span("bhw.sdr.demod", y.device):
            if y.device.type == "cuda":
                return iq_demod(y, angle_width, iq_scale, n_channels)
            return discriminate_plain(full_spectrum(y, n_channels), angle_width, iq_scale)


def discriminate_plain(y, angle_width: int = 20, iq_scale: float = 2.0**14):
    """Plain version of the chain's discriminator in torch ops, on ``y``'s
    device: the channelizer output (..., nf, C) quantized to int32 I/Q,
    then ``fm_demod_conj`` over each channel's frames -> (..., nf-1, C)."""
    i = torch.round(y.real * iq_scale).to(torch.int32)
    q = torch.round(y.imag * iq_scale).to(torch.int32)
    return fm_demod_conj_plain(i.mT, q.mT, IQ_WIDTH, angle_width).mT  # (nf-1, C)


def make_sharded_sdr_chain(mesh: Mesh, n_channels: int, taps_per_branch: int,
                           window: str = "bh4", angle_width: int = 20,
                           iq_scale: float = 2.0**14):
    """Build the sharded chain (JAX: ``make_sharded_sdr_chain``): the step
    takes a global (T,) input split ('blocks',), T a multiple of
    n_channels * n_blocks, and returns the (T // n_channels, n_channels)
    discriminator output as a ``Sharded`` split ('blocks',): the circular
    stream's chain, each shard keeping the last B // n_channels frames of
    its halo-extended chunk."""
    proto = design_prototype(n_channels, taps_per_branch, window=window)
    halo = n_channels * taps_per_branch  # one prototype length

    def shard_out(x, tail):
        out = sdr_chain(torch.cat([tail, x], dim=-1), proto, n_channels, angle_width, iq_scale)
        return out[-(x.shape[-1] // n_channels):]

    def step(x):
        xs = shard(x, mesh, ("blocks",))
        rows = [local_map(shard_out, row, left_halo(row, halo, circular=True))
                for row in xs.shards]
        return from_rows(mesh, ("blocks",), rows)

    return step
