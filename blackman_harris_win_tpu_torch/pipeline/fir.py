"""Windowed-sinc FIR design + decimating FIR, single device (counterpart of
``blackman_harris_win_tpu/pipeline/fir.py``).

- prototype lowpass taps are designed on the host with the port's own
  quantized window generator (``window_samples`` on the CPU, float64 math),
  bit-equal to the JAX package's design;
- the decimating FIR keeps the JAX package's three branches: overlapped
  frames times taps (a full-fp32 contraction) at small sizes, and a strided
  ``conv1d`` otherwise, behind the materialization barrier (kernel 7,
  ``kernels/barrier.py``) at bulk sizes.  cuDNN runs fp32 convolutions in
  TF32 by default, so TF32 is turned off while these run (and restored after).

The sharded variant waits for the port's ``dist/``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..core.config import WindowSpec
from ..kernels.barrier import materialize
from ..kernels.window import window_samples
from ..windows import catalog
from .spectral import _full_fp32, frames_view

#: the frames path's size cap: m_total * n_taps <= 2^25 (a 128 MB f32 temp)
FRAMES_MAX = 1 << 25


def design_lowpass(
    num_taps: int,
    cutoff: float,
    window: str = "bh4",
    data_width: int = 24,
) -> np.ndarray:
    """Windowed-sinc lowpass prototype (float64 taps, unity DC gain).

    ``cutoff`` in (0, 1) as a fraction of Nyquist.  The window weights come
    from the fixed-point generator at ``data_width`` on a
    2^ceil(log2(num_taps)) grid, sampled at the tap positions.
    """
    if not 0 < cutoff < 1:
        raise ValueError("cutoff must be in (0, 1) (fraction of Nyquist)")
    pw = max(4, int(np.ceil(np.log2(max(num_taps, 2)))))
    spec = WindowSpec(pw, data_width, overflow="saturate")
    d = catalog.get(window)
    n_grid = 1 << pw
    # sample the periodic window at tap positions (symmetric windowing)
    pos = (np.arange(num_taps) * n_grid) // num_taps
    wq = window_samples(torch.from_numpy(pos), d.quantized(data_width), spec)
    w = wq.numpy().astype(np.float64) / (2.0 ** (data_width - d.shift) - 1.0)

    m = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * m) * cutoff * w
    return h / h.sum()


@_full_fp32()
def decimating_fir(x, taps, decim: int, device=None):
    """y[m] = sum_t h[t] * x[m*decim + t] (valid region only).

    x: (..., T) float, a tensor (runs on its device) or array-like (goes to
    ``device``, default the card); taps: (n_taps,).  Output length
    (T - n_taps) // decim + 1.

    When n_taps and T are multiples of ``decim``: overlapped frames times
    taps in full fp32 while the frames temp stays under 2^25 elements, else
    the materialization barrier and a strided conv.  Otherwise the strided
    conv alone.  ``conv1d`` correlates, which is exactly the formula above,
    so the taps go in unflipped.
    """
    x = _build.as_tensor(x, device=device)
    taps = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    lead = x.shape[:-1]
    t = x.shape[-1]
    n_taps = taps.shape[0]
    if n_taps % decim == 0 and t % decim == 0 and t >= n_taps:
        m_total = (t - n_taps) // decim + 1
        if m_total * n_taps <= FRAMES_MAX:
            return frames_view(x, n_taps, decim) @ taps
        x = materialize(x)
    y = torch.nn.functional.conv1d(x.reshape(-1, 1, t), taps.reshape(1, 1, -1), stride=decim)
    return y.reshape(lead + (y.shape[-1],))
