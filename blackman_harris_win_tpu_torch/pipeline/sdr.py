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

from ..dist.halo import left_halo
from ..dist.mesh import Mesh, from_rows, local_map, shard
from .channelizer import design_prototype, polyphase_channelize
from .demod import fm_demod_conj


def sdr_chain(x, prototype, n_channels: int, angle_width: int = 20,
              iq_scale: float = 2.0**14, device=None):
    """Channelize, then discriminate each channel.  x: (T,) real int/float
    (a tensor runs on its device; array-like input goes to ``device``,
    default the card) -> (n_frames-1, n_channels) int64 angle LSBs (the
    instantaneous frequency per channel).

    ``iq_scale`` is a fixed quantization gain; size it so channel envelopes
    stay within +-2^15.
    """
    y = polyphase_channelize(x, prototype, n_channels, device)  # (nf, C)
    i = torch.round(y.real * iq_scale).to(torch.int32)
    q = torch.round(y.imag * iq_scale).to(torch.int32)
    return fm_demod_conj(i.mT, q.mT, 16, angle_width).mT  # (nf-1, C)


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
