"""The SDR chain, single device: channelizer -> FM discriminator per
channel (counterpart of ``sdr_chain`` in
``blackman_harris_win_tpu/pipeline/sdr.py``; the sharded chain waits for
the port's ``dist/``)."""

from __future__ import annotations

import torch

from .channelizer import polyphase_channelize
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
