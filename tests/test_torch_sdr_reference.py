"""PyTorch port, the SDR chain against its plain reference
(``tests/torch_reference/sdr_fm.py``; the benchmark's copy is
``portbench/reference/sdr.py``), on the CPU at a small size: 8 channels
of 4 taps, a few seeded FM stations over 2^12 complex samples.

- ``sdr_chain``'s output is the reference's wherever their quantized I/Q
  agree, and within the reference's angle budget everywhere;
- the reference's discriminator and atan2 are 0 LSB against the port's
  plain versions on seeded ints and ``demod_kernel.seam_words``;
- the reference's channelizer against a float64 NumPy evaluation of the
  channelizer's formula;
- the angle budget holds every move of the I/Q by 1 LSB, and a TF32
  channelizer leaves it;
- the two copies of the reference are one text and give one output.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu_torch.kernels import cordic, demod_kernel
from blackman_harris_win_tpu_torch.pipeline import channelizer, demod, sdr

HERE = Path(__file__).resolve().parent
REF_PATH = HERE / "torch_reference" / "sdr_fm.py"
BENCH_REF_PATH = HERE.parent / "portbench" / "reference" / "sdr.py"
C, TPB, T, AW, SCALE = 8, 4, 1 << 12, 20, 2.0**14
SEEDS = [3, 17, 2**31 + 5, 987654321012]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(REF_PATH, "_sdr_fm_reference")


def _fm_capture(seed: int, stations: int = 3) -> torch.Tensor:
    """``stations`` FM carriers on distinct channels of C (the strongest
    at amplitude 1, the others down to -40 dB, offsets within 1% of a
    channel, peak deviations 0.2-0.375 of a channel, two audio tones
    each), over complex noise at -80 dB: complex64 (T,)."""
    rng = np.random.default_rng(seed)
    n = np.arange(T, dtype=np.float64)
    level = rng.uniform(-40.0, 0.0, stations)
    x = (rng.normal(size=T) + 1j * rng.normal(size=T)) * 1e-4 / math.sqrt(2.0)
    for k, db in zip(rng.choice(C, stations, replace=False), level - level.max()):
        f0 = ((k if k < C // 2 else k - C) + rng.uniform(-0.01, 0.01)) / C
        dev = rng.uniform(0.2, 0.375) / C
        fa, amp, ph = (rng.uniform(2.5e-4, 0.075, 2) / C, rng.uniform(0.1, 1.0, 2),
                       rng.uniform(0.0, 2 * math.pi, 2))
        cyc = np.mod(f0 * n, 1.0) + sum(dev * a / amp.sum() / f * np.sin(2 * math.pi * f * n + p)
                                         / (2 * math.pi) for f, a, p in zip(fa, amp, ph))
        x = x + 10.0 ** (db / 20.0) * np.exp(2j * math.pi * np.mod(cyc, 1.0))
    return torch.from_numpy(x.astype(np.complex64))


def _proto():
    return channelizer.design_prototype(C, TPB)


def _over_budget(out: torch.Tensor, i, q) -> tuple[int, torch.Tensor]:
    """(outputs over their budget, the wrapped gaps) of ``out`` against the
    reference's discriminator of int I/Q (i, q)."""
    d = REF.wrap(out - REF.discriminate(i, q, AW), AW).abs()
    m, k = torch.nonzero(d, as_tuple=True)
    if not m.numel():
        return 0, d
    return int((d[m, k] > REF.angle_budget(i, q, AW, m, k)).sum()), d


@pytest.mark.parametrize("seed", SEEDS)
def test_chain_within_the_reference_budget(seed):
    x, proto = _fm_capture(seed), _proto()
    out = sdr.sdr_chain(x, proto, C, angle_width=AW, iq_scale=SCALE, device="cpu")
    i, q = REF.quantize(REF.channelize(x, proto, C), SCALE)
    assert out.shape == (T // C - TPB, C) and out.dtype == torch.int64
    over, gap = _over_budget(out, i, q)
    assert over == 0
    # where both frames of an output quantize alike, the output is the same
    y = channelizer.polyphase_channelize(x, proto, C, device="cpu")
    same = (torch.round(y.real * SCALE) == i) & (torch.round(y.imag * SCALE) == q)
    both = same[1:] & same[:-1]
    assert float(same.double().mean()) > 0.98
    assert int(gap[both].max()) == 0


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_the_budget_catches_swapped_channels(seed):
    x, proto = _fm_capture(seed, stations=C), _proto()
    out = sdr.sdr_chain(x, proto, C, angle_width=AW, iq_scale=SCALE, device="cpu")
    i, q = REF.quantize(REF.channelize(x, proto, C), SCALE)
    assert _over_budget(out[:, [1, 0, *range(2, C)]], i, q)[0] > 0


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_a_tf32_channelizer_leaves_the_budget(seed):
    x, proto = _fm_capture(seed, stations=C), _proto()
    i, q = REF.quantize(REF.channelize(x, proto, C), SCALE)
    control = REF.discriminate(*REF.quantize(REF.channelize_tf32(x, proto, C), SCALE), AW)
    assert _over_budget(control, i, q)[0] > 0


def _words(aw: int, seed: int):
    """Seeded 16-bit I/Q words (frames, 6) and the atan2 seam words as one
    more column pair."""
    rng = np.random.default_rng(seed)
    i = rng.integers(-(1 << 15), 1 << 15, (700, 6))
    q = rng.integers(-(1 << 15), 1 << 15, (700, 6))
    sy, sx = demod_kernel.seam_words(16, aw, rng, 500)
    return (torch.from_numpy(np.concatenate([i.ravel(), sy])).reshape(-1, 1),
            torch.from_numpy(np.concatenate([q.ravel(), sx])).reshape(-1, 1),
            torch.from_numpy(i), torch.from_numpy(q))


@pytest.mark.parametrize("aw", [16, 20, 24])
def test_discriminator_zero_lsb_against_the_port(aw):
    for i, q in zip(*[iter(_words(aw, aw))] * 2):
        want = demod.fm_demod_conj_plain(i.mT, q.mT, demod_kernel.IQ_WIDTH, aw).mT
        got = REF.discriminate(i.to(torch.int32), q.to(torch.int32), aw, block=97)
        assert torch.equal(got, want)


@pytest.mark.parametrize("aw", [12, 20, 24])
def test_atan2_zero_lsb_against_the_port(aw):
    y, x = demod_kernel.seam_words(aw, aw, np.random.default_rng(aw), 4000)
    y, x = torch.from_numpy(y), torch.from_numpy(x)
    assert torch.equal(REF.atan2(y, x, aw), cordic.atan2_fixed_plain(y, x, aw, aw))


def test_channelizer_against_the_formula_in_numpy():
    x, h = _fm_capture(SEEDS[0]).numpy().astype(np.complex128), _proto()
    frames = T // C
    want = np.zeros((frames - TPB + 1, C), np.complex128)
    for row, m in enumerate(range(TPB - 1, frames)):
        branch = np.array([sum(h[t * C + p] * x[(m - t) * C + p] for t in range(TPB))
                           for p in range(C)])
        want[row] = [sum(np.exp(-2j * np.pi * p * k / C) * branch[p] for p in range(C))
                     for k in range(C)]
    got = REF.channelize(torch.from_numpy(x), h, C, block=100)
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_the_budget_holds_every_one_lsb_move():
    """Every output reachable by moving each of the four I/Q words of an
    output by -1, 0 or +1 lies within the budget of the unmoved ints, at
    envelopes from 2^2 to 2^15."""
    rng = np.random.default_rng(11)
    n = 3000
    env = 2.0 ** rng.uniform(2, 15, (2, n))
    ph = rng.uniform(0, 2 * math.pi, (2, n))
    i = torch.from_numpy(np.round(env * np.cos(ph)).astype(np.int32))
    q = torch.from_numpy(np.round(env * np.sin(ph)).astype(np.int32))
    base = REF.discriminate(i, q, AW)
    budget = REF.angle_budget(i, q, AW, torch.zeros(n, dtype=torch.int64),
                              torch.arange(n))
    reach = torch.zeros(n, dtype=torch.int64)
    for moves in range(81):
        d = [(moves // 3**j) % 3 - 1 for j in range(4)]
        di = torch.tensor([[d[0]], [d[2]]], dtype=torch.int32)
        dq = torch.tensor([[d[1]], [d[3]]], dtype=torch.int32)
        moved = REF.discriminate(i + di, q + dq, AW)
        reach = torch.maximum(reach, REF.wrap(moved - base, AW).abs()[0])
    # the 16 re-quantized quadruples are all the moves reach: the budget is
    # the widest move plus the CORDIC's LSB, exactly
    assert torch.equal(budget, reach + 1)


def test_the_two_copies_are_one():
    assert REF_PATH.read_text() == BENCH_REF_PATH.read_text()
    bench = _load(BENCH_REF_PATH, "_sdr_fm_bench_reference")
    x, proto = _fm_capture(SEEDS[1]), _proto()
    a, b = REF.sdr_chain(x, proto, C), bench.sdr_chain(x, proto, C)
    assert torch.equal(a, b)
    i, q = REF.quantize(REF.channelize(x, proto, C), SCALE)
    m, k = torch.arange(20), torch.arange(20) % C
    assert torch.equal(REF.angle_budget(i, q, AW, m, k), bench.angle_budget(i, q, AW, m, k))
