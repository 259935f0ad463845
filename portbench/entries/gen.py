"""Window generation through ``kernels.window.window_block``.

A call writes one block of the quantized window as int32 on the card,
through the router that ``make_window`` calls, from a first index the
traffic draws from the seed for each call: successive calls return
different samples, so no output kept from an earlier call can stand in for
computing.  The harness also holds every call's output against the one
before, so an output that shares the earlier one's storage counts as
stale.  A kept output is copied to the host after its call, so that the
window's peak memory is the program's.  The comparison is 0 LSB against
the plain reference over every kept output.
"""

from __future__ import annotations

import torch

from portbench import roofline, traffic as gen_traffic
from portbench.reference import window as ref


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from blackman_harris_win_tpu_torch.core.config import WindowSpec
        from blackman_harris_win_tpu_torch.kernels import window as kw
        from blackman_harris_win_tpu_torch.windows import catalog

        c = config
        self.name, self.device = c["window"], device
        self.spec = WindowSpec(phase_width=c["phase_width"], data_width=c["data_width"],
                               sin_type=c["sin_type"], rounding=c["rounding"],
                               overflow=c["overflow"])
        self.blocks = gen_traffic.block_schedule(traffic, seed, self.spec.n)
        self._window_block = kw.window_block
        self._coeffs = catalog.get(self.name).quantized(self.spec.data_width)
        self.limits = c["limits"]

    def warm_calls(self) -> list[int]:
        return [0, 1]

    def samples(self, i: int) -> int:
        return self.blocks(i)[1]

    def work(self, i: int) -> dict:
        return roofline.cordic_window_work(self.samples(i), len(self._coeffs),
                                           self.spec.data_width, self.spec.rounding)

    def call(self, i: int) -> torch.Tensor:
        n0, length = self.blocks(i)
        return self._window_block(n0, length, self._coeffs, self.spec, self.device)

    def keep(self, i: int, out: torch.Tensor):
        return (self.blocks(i), out.cpu())

    def release(self) -> None:
        pass

    def control(self, kept: list) -> list:
        """The reference in the program's place, its CORDIC state 32 bits
        wide where the contract states W+2."""
        s = self.spec
        return [(blk, ref.window_range(*blk, self.name, s.phase_width, s.data_width,
                                       s.overflow, self.device, state_bits=32))
                for blk, _ in kept]

    def judge(self, kept: list) -> dict:
        """samples_off: kept samples that differ from the reference."""
        s, off, refs = self.spec, 0, {}
        for blk, out in kept:
            if blk not in refs:
                refs[blk] = ref.window_range(*blk, self.name, s.phase_width, s.data_width,
                                             s.overflow, self.device)
            want = refs[blk]
            off += want.numel() if out.shape != want.shape else \
                int((out.to(want.device) != want).sum())
        return {"samples_off": (off, self.limits["samples_off"])}
