"""PyTorch port, the atan2 / FM-discriminator kernel (``csrc/demod_kernel.cu``)
on the CPU.

The kernel runs only on a card; here a numpy emulation of its datapath,
lane by lane, is held 0 LSB against the JAX package (``kernels/cordic.py:
cordic_atan2`` / ``atan2_fixed``, ``pipeline/demod.py:fm_demod_conj`` /
``fm_demod_phase``, run on the CPU with x64) and the exact-int model
``model/golden.py:cordic_atan2``, on seeded numpy inputs:

- the state at the top of a 32-bit word while AW+P <= 32 and P >= 1, else
  of a 64-bit one, so that every add wraps at AW+P bits by itself; in
  32-bit words the shifted operand is the shift pair (X >> (i + sh)) << sh
  with its left shift folded into the steering product (d << sh = m *
  2^(sh+1) + 2^sh, m the sign mask of y), the iterations run as the
  kernel's unrolled chain entered at position sh + 2 (iteration i at
  position j = i + sh + 2 shifts by j - 2, the P - 1 positions past the
  last take z steps of 0) and z is zbase + sum m_j * zpos[j]; in 64-bit
  words the shifted operand's fraction bits are cleared and the steering is
  a xor-and-subtract negation; z unwrapped (its bound asserted);
- the conjugate products in wrapping uint32 arithmetic on the inputs
  re-quantized by >> drop; the phase differences wrapped in uint64;
- the integer front end's two walks (``TestIntWalk``), each value (angle or
  re-quantized sample) computed once and carried: the strip walk with lanes
  on rows (the transposed (T, C) layout, its output (T-1, rows) in memory)
  and the warp walk with lanes on samples (each predecessor from the next
  lane down, lane 0's from lane 31 of the step before, a chunk's first from
  sample t0 - 1), over T = 2, 3, a strip or step +-1 and their multiples,
  row counts no multiple of a warp, int32 and int64, every output written
  once;
- the I/Q front end's f32 quantizer, rint(f32(re) * f32(iq_scale)), once a
  sample, walked in strips of consecutive frames of one channel (the
  quantized sample carried to the next output, across strip and batch
  boundaries, the last strip ending at nf - 1), over the full spectrum or
  a real stream's half spectrum (channel k > C/2 the conjugate of bin
  C - k, quantized as rint(-im * iq_scale)).

The seam inputs are x or y in {0, +-1}, inputs whose masked abs is
2^(AW-1)-1, and inputs with bit input_width-1 set, at AW 16/20/24/31 with
P=1 and AW 30 with P=2 (32-bit words), AW 31 with P=2 and AW 40 (64-bit
words), in both conventions.  One case proves that the AW+P bit wrap fires:
the emulation with the state at the bottom of a 64-bit word (no wrap)
differs from JAX there.  The kernel against its plain version on the card
is ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.kernels import cordic as jcordic
from blackman_harris_win_tpu.model import golden
from blackman_harris_win_tpu.pipeline import demod as jdm
from blackman_harris_win_tpu_torch.kernels import cordic
from blackman_harris_win_tpu_torch.kernels import demod_kernel as dk
from blackman_harris_win_tpu_torch.pipeline import channelizer, demod, sdr

#: (AW, P) of the elementwise cases: 32-bit words, then 64-bit words
WIDTHS = [(16, 1), (20, 1), (24, 1), (31, 1), (30, 2), (31, 2), (40, 1), (40, 3)]
CONVENTIONS = ["cordic", "fixed"]


def _words(aw, p, top=True):
    """(bits, unsigned dtype, signed dtype, shift to the top) of the
    kernel's word; ``top=False`` keeps the state at the bottom of a 64-bit
    word, where no AW+P bit wrap happens."""
    if not top:
        return 64, np.uint64, np.int64, 0
    bits = 32 if aw + p <= 32 and p >= 1 else 64  # words32
    u, s = (np.uint32, np.int32) if bits == 32 else (np.uint64, np.int64)
    return bits, u, s, bits - (aw + p)


def _atan2_emulation(y, x, input_width, aw, p, convention, top=True, trace=None):
    """``csrc/demod_kernel.cu:atan2_word`` on int64 arrays (the inputs as
    the kernel widens them)."""
    y, x = np.asarray(y, np.int64), np.asarray(x, np.int64)
    bits, u, s, sh = _words(aw, p, top)
    in_sign = min(input_width, 64) - 1
    sx, sy = (x >> in_sign) & 1, (y >> in_sign) & 1
    quadrant = (sx << 1) | sy
    mask_lo = (1 << (aw - 1)) - 1
    keep = u(((1 << bits) - 1) ^ ((1 << sh) - 1))
    xs = ((x ^ -sx) & mask_lo).astype(u) << u(sh)
    ys = ((y ^ -sy) & mask_lo).astype(u) << u(sh)
    lut = dk.atan2_lut(aw, p)
    # 32-bit words: z starts at zbase = -sum lut[i] and takes m * zpos[j] at
    # chain position j (the jump into the unrolled chain: iteration i at
    # position i + entry, its shift j - 2); 64-bit words: the iteration loop
    z = np.full(xs.shape, u((-int(lut.sum())) % (1 << bits)) if bits == 32 else u(0), u)
    p2 = u(1 << sh)
    zmax = 0
    if bits == 32:
        entry, zpos = _chain(aw, p)
        steps = [(j - entry, j - 2, u(int(zpos[j]))) for j in range(entry, CHAIN)]
    else:
        steps = [(i, i, None) for i in range(aw - 1)]
    for i, k, zstep in steps:
        m = (ys.view(s) >> s(bits - 1)).view(u)
        if bits == 32:
            dsh = m * (p2 << u(1)) + p2  # d << sh
            xa = (xs.view(s) >> s(k)).view(u)
            ya = (ys.view(s) >> s(k)).view(u)
            xs, ys = xs + dsh * ya, ys - dsh * xa
            z = z + m * zstep
            zt = (z.view(s).astype(np.int64)
                  + sum(int(lut[j]) for j in range(i + 1, aw - 1)))  # z of the reference
        else:
            lk = u(int(lut[i]) & ((1 << bits) - 1))
            xi = (xs.view(s) >> s(i)).view(u) & keep
            yi = (ys.view(s) >> s(i)).view(u) & keep
            xs, ys, z = xs + ((yi ^ m) - m), ys - ((xi ^ m) - m), z - ((lk ^ m) - m)
            zt = z.view(s).astype(np.int64)
        zmax = max(zmax, int(np.abs(zt).max(initial=0)))
        if trace is not None:
            trace.append(max(int(np.abs(xs.view(s).astype(np.int64)).max(initial=0)),
                             int(np.abs(ys.view(s).astype(np.int64)).max(initial=0))))
    # the kernel's note: z needs no wrap
    assert zmax < 0.56 * 2.0 ** (aw + p - 1)
    phi = (z.view(s) >> s(p)).astype(np.int64)
    pi_half, pi_u = 1 << (aw - 2), 1 << (aw - 1)
    if convention == "cordic":
        out = np.where(quadrant == 0, phi, np.where(quadrant == 1, phi + pi_half,
                                                    np.where(quadrant == 2, -phi, phi - pi_half)))
    else:
        out = np.where(quadrant == 0, -phi, np.where(quadrant == 1, phi,
                                                     np.where(quadrant == 2, pi_u + phi,
                                                              -phi - pi_u)))
    return _wrap(out, aw)


#: ``demod_kernel.cu:kChain``: the 32-bit chain's positions 2..31
CHAIN = 32


def _chain(aw, p):
    """``fill``'s chain for 32-bit words (AW + P <= 32, P >= 1): the entry position
    sh + 2 and the z step -2 lut[i] of each position j = i + entry (mod
    2^32), 0 at positions of no iteration."""
    lut = dk.atan2_lut(aw, p)
    entry = 34 - aw - p
    zpos = np.zeros(CHAIN, np.int64)
    for i in range(aw - 1):
        zpos[i + entry] = (-2 * int(lut[i])) % (1 << 32)
    return entry, zpos


def _wrap(v, bits):
    v = np.asarray(v, np.int64).astype(np.uint64) & np.uint64((1 << bits) - 1)
    return np.where(v >> np.uint64(bits - 1), v.astype(np.int64) - (1 << bits), v.astype(np.int64))


def _conj_emulation(i, q, input_width, aw, top=True):
    """``conj_word`` over (..., T) int arrays -> (..., T-1)."""
    a, b = _requant(i, q, input_width, aw)
    return _conj_pair(a[..., :-1], b[..., :-1], a[..., 1:], b[..., 1:], aw, input_width, top)


def _requant(i, q, input_width, aw):
    """``requant``: I and Q >> drop as the 32-bit words of the products."""
    drop, _ = dk.conj_shifts(input_width, aw)
    return ((np.asarray(i, np.int64) >> drop).astype(np.uint32),
            (np.asarray(q, np.int64) >> drop).astype(np.uint32))


def _conj_pair(a0, b0, a1, b1, aw, input_width=16, top=True):
    """The discriminator of re-quantized samples (a0, b0) -> (a1, b1)."""
    _, shift = dk.conj_shifts(input_width, aw)
    re = (a1 * a0 + b1 * b0).view(np.int32) >> np.int32(shift)
    im = (b1 * a0 - a1 * b0).view(np.int32) >> np.int32(shift)
    return _atan2_emulation(im, re, aw, aw, 1, "fixed", top)


def _strip_len(outputs, nf, sms=132):
    """``launch_iq``'s strip: at least one full load of the card (2048
    threads an SM) within 4 to 64 frames, at most the nf - 1 outputs."""
    target = sms * 2048
    return min(max(outputs // target, 4), 64, nf - 1)


def _iq_strip_emulation(y, c, strip, aw=20, scale=2.0**14):
    """``demod_iq_kernel`` on (batches, nf, bins) complex64 -> (batches,
    nf-1, c): item g = (batch, strip, channel), the channel fastest, walks
    its strip of frames, quantizing each sample once and carrying it to
    the next output; a channel k >= bins reads the conjugate of bin c - k.
    Asserts that every output is written once."""
    y = np.asarray(y)
    batches, nf, bins = y.shape
    nstrips = -(-(nf - 1) // strip)
    g = np.arange(batches * nstrips * c)
    k, sb = g % c, g // c
    st, b = sb % nstrips, sb // nstrips
    f0 = st * strip
    f1 = np.minimum(f0 + strip, nf - 1)
    cj = k >= bins
    col = np.where(cj, c - k, k)

    def sample(f):
        v = y[b, f, col]
        return _requant(_quantize(v.real, scale),
                        _quantize(np.where(cj, -v.imag, v.imag), scale), 16, aw)

    out = np.zeros((batches, nf - 1, c), np.int64)
    written = np.zeros(out.shape, np.int64)
    prev = sample(f0)
    for j in range(strip):
        f = f0 + j
        live = f < f1
        cur = sample(np.minimum(f + 1, nf - 1))
        d = _conj_pair(*prev, *cur, aw)
        out[b[live], f[live], k[live]] = d[live]
        written[b[live], f[live], k[live]] += 1
        prev = cur
    assert np.all(written == 1)
    return out


def _phase_emulation(i, q, input_width, aw):
    """``demod_int_kernel``'s phase mode: angles, then wrapped differences."""
    phi = _atan2_emulation(q, i, input_width, aw, 1, "fixed")
    d = (phi[..., 1:] - phi[..., :-1]).astype(np.uint64)
    half, full = 1 << (aw - 1), 1 << aw
    return ((d + np.uint64(half)) & np.uint64(full - 1)).astype(np.int64) - half


def _quantize(v, scale):
    """``__float2int_rn(__fmul_rn(v, scale))``."""
    return np.rint(np.asarray(v, np.float32) * np.float32(scale)).astype(np.int32)


def _seam_inputs(input_width, aw, count, seed):
    return dk.seam_words(input_width, aw, np.random.default_rng(seed), count)


def _jax_atan2(y, x, iw, aw, p, convention):
    fn = jcordic.cordic_atan2 if convention == "cordic" else jcordic.atan2_fixed
    return np.asarray(fn(y, x, iw, aw, p), np.int64)


class TestAtan2Emulation:
    @pytest.mark.parametrize("convention", CONVENTIONS)
    @pytest.mark.parametrize("aw,p", WIDTHS)
    def test_vs_jax_and_plain(self, aw, p, convention):
        for iw in sorted({aw, min(aw + 3, 62), 12}):
            y, x = _seam_inputs(iw, aw, 2000, seed=aw * 7 + p + iw)
            want = _jax_atan2(y, x, iw, aw, p, convention)
            np.testing.assert_array_equal(_atan2_emulation(y, x, iw, aw, p, convention), want)
            plain = cordic.cordic_atan2 if convention == "cordic" else cordic.atan2_fixed
            got = plain(torch.from_numpy(y), torch.from_numpy(x), iw, aw, p)
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("aw,p", WIDTHS)
    def test_vs_golden(self, aw, p):
        y, x = _seam_inputs(aw, aw, 60, seed=aw + 100 * p)
        want = np.array([golden.cordic_atan2(int(b), int(a), aw, aw, p) for b, a in zip(y, x)])
        np.testing.assert_array_equal(_atan2_emulation(y, x, aw, aw, p, "cordic"), want)

    @pytest.mark.parametrize("aw", [2, 3, 8])
    def test_narrow_angles(self, aw):
        y, x = _seam_inputs(10, aw, 300, seed=aw)
        for conv in CONVENTIONS:
            np.testing.assert_array_equal(_atan2_emulation(y, x, 10, aw, 1, conv),
                                          _jax_atan2(y, x, 10, aw, 1, conv))

    @pytest.mark.parametrize("aw,p", [(20, 1), (31, 1), (40, 1)])
    def test_the_state_wrap_fires(self, aw, p):
        # |x| == |y| at the top of the range: the state grows past 2^(iw-1)
        # (1.16 * 2^(iw-1) at P=1: the gain 1.647 times sqrt 2), so the
        # reference's per-add wrap changes the result; the emulation that
        # keeps the state unwrapped differs from JAX there
        top = (1 << (aw - 1)) - 1
        y = np.array([top, top, -top - 1, top - 3], np.int64)
        x = np.array([top, -top - 1, top, top - 1], np.int64)
        want = _jax_atan2(y, x, aw, aw, p, "fixed")
        trace = []
        np.testing.assert_array_equal(_atan2_emulation(y, x, aw, aw, p, "fixed", trace=trace),
                                      want)
        unwrapped = []
        got = _atan2_emulation(y, x, aw, aw, p, "fixed", top=False, trace=unwrapped)
        assert max(unwrapped) >= 1 << (aw + p - 1)
        assert not np.array_equal(got, want)


class TestDemodEmulation:
    @pytest.mark.parametrize("iw,aw", [(16, 20), (17, 20), (20, 24), (15, 16), (16, 31),
                                       (16, 40), (24, 48)])
    def test_conj_vs_jax(self, iw, aw):
        y, x = _seam_inputs(iw, aw, 3000, seed=iw * aw)
        i, q = x.reshape(-1), y.reshape(-1)
        want = np.asarray(jdm.fm_demod_conj(i, q, iw, aw), np.int64)
        np.testing.assert_array_equal(_conj_emulation(i, q, iw, aw), want)
        np.testing.assert_array_equal(demod.fm_demod_conj(i, q, iw, aw, device="cpu").numpy(),
                                      want)

    @pytest.mark.parametrize("iw,aw", [(16, 20), (17, 20), (20, 24), (15, 16), (16, 31),
                                       (30, 40)])
    def test_phase_vs_jax(self, iw, aw):
        y, x = _seam_inputs(iw, aw, 3000, seed=iw + aw)
        i, q = x.reshape(-1), y.reshape(-1)
        want = np.asarray(jdm.fm_demod_phase(i, q, iw, aw), np.int64)
        np.testing.assert_array_equal(_phase_emulation(i, q, iw, aw), want)
        np.testing.assert_array_equal(demod.fm_demod_phase(i, q, iw, aw, device="cpu").numpy(),
                                      want)

    @pytest.mark.parametrize("fn", ["conj", "phase"])
    def test_int32_input_and_rows(self, fn):
        # the kernel reads int32 I/Q in place, (rows, T) at any strides: the
        # transposed (C, nf) view of an (nf, C) array, as sdr_chain's plain
        # path passes it
        rng = np.random.default_rng(5)
        iq = rng.integers(-(1 << 15), 1 << 15, size=(2, 300, 4)).astype(np.int32)
        i, q = iq[0].T, iq[1].T
        emu = _conj_emulation if fn == "conj" else _phase_emulation
        want = np.asarray(getattr(jdm, f"fm_demod_{fn}")(i, q, 16, 20), np.int64)
        np.testing.assert_array_equal(emu(i, q, 16, 20), want)
        got = getattr(demod, f"fm_demod_{fn}")(torch.from_numpy(i), torch.from_numpy(q), 16, 20)
        np.testing.assert_array_equal(got.numpy(), want)


def _int_geometry(rows, t, walk, sms=132):
    """``launch_demod``'s (span, per_row, tasks): a thread's outputs (the
    strip walk) or a warp's 32-sample steps (the warp walk), at least one
    full load of the card (2048 threads an SM) within 4 to 64."""
    span = min(max(rows * (t - 1) // (sms * 2048), 4), 64)
    if walk == "rows":
        span = min(span, t - 1)
        per_row = -(-(t - 1) // span)
    else:
        span = min(span, -(-t // 32))
        per_row = -(-t // (32 * span))
    return span, per_row, rows * per_row


def _int_walk_emulation(i, q, iw, aw, mode, walk, sms=132):
    """``demod_int_kernel`` on (rows, T) int arrays in ``walk``: each value
    computed once, carried as the kernel carries it; returns the logical
    (rows, T-1) output and asserts every output written once."""
    i, q = np.asarray(i, np.int64), np.asarray(q, np.int64)
    rows, t = i.shape
    if mode == "phase":
        vals = (_atan2_emulation(q, i, iw, aw, 1, "fixed"),)
    else:
        vals = _requant(i, q, iw, aw)

    def at(r, tt):
        return tuple(v[r, tt] for v in vals)

    def output(prev, cur):
        if mode == "phase":
            d = (cur[0] - prev[0]).astype(np.uint64)
            half, full = 1 << (aw - 1), 1 << aw
            return ((d + np.uint64(half)) & np.uint64(full - 1)).astype(np.int64) - half
        return _conj_pair(*prev, *cur, aw, iw)

    span, per_row, tasks = _int_geometry(rows, t, walk, sms)
    mem = np.zeros((t - 1) * rows, np.int64)
    written = np.zeros(mem.shape, np.int64)
    if walk == "rows":  # a thread a strip, rows fastest; mem is (T-1, rows)
        g = np.arange(tasks)
        r, t0 = g % rows, g // rows * span
        t1 = np.minimum(t0 + span, t - 1)
        prev = at(r, t0)
        for j in range(span):
            tt = t0 + j
            live = tt < t1
            cur = at(r, np.minimum(tt + 1, t - 1))
            idx = tt[live] * rows + r[live]
            mem[idx] = output(prev, cur)[live]
            written[idx] += 1
            prev = cur
        out = mem.reshape(t - 1, rows).T
    else:  # a warp a chunk of 32 * span samples; mem is (rows, T-1)
        w = np.arange(tasks)[:, None]
        lane = np.arange(32)[None, :]
        r, t0 = w // per_row, w % per_row * 32 * span
        tend = np.minimum(t0 + 32 * span, t)
        rr = np.broadcast_to(r, (tasks, 32))
        carry = at(r, np.maximum(t0 - 1, 0))  # used only where t0 > 0
        for step in range(span):
            tb = t0 + 32 * step
            tt = tb + lane
            cur = at(rr, np.minimum(tt, tend - 1))
            # the predecessor: the lane below; lane 0's the carry, lane 31's
            # value of the step before
            prev = tuple(np.concatenate([c[:, :1], v[:, :-1]], axis=1)
                         for c, v in zip(carry, cur))
            carry = tuple(np.broadcast_to(v[:, 31:], v.shape) for v in cur)
            live = (tt < tend) & (tt > 0) & (tb < tend)
            idx = (rr * (t - 1) + tt - 1)[live]
            mem[idx] = output(prev, cur)[live]
            written[idx] += 1
        out = mem.reshape(rows, t - 1)
    assert np.all(written == 1)
    return out


def _same_layout(a, b):
    """Equal strides in every dimension longer than 1."""
    return all(sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape) if n > 1)


class TestIntWalk:
    @pytest.mark.parametrize("walk", ["rows", "t"])
    @pytest.mark.parametrize("mode", ["phase", "conj"])
    @pytest.mark.parametrize("t", [2, 3, 5, 8, 31, 33, 129, 256])
    def test_lengths_vs_jax(self, t, mode, walk):
        # T = 2, 3; a strip of 4 +-1 and a multiple; a warp step of 32 +-1;
        # a chunk of 128 + 1 and a multiple (the geometry at these sizes);
        # 3 and 16 rows
        for rows in (3, 16):
            y, x = _seam_inputs(16, 20, rows * t, seed=t * rows)
            i, q = x[:rows * t].reshape(rows, t), y[:rows * t].reshape(rows, t)
            want = np.asarray(getattr(jdm, f"fm_demod_{mode}")(i, q, 16, 20), np.int64)
            np.testing.assert_array_equal(_int_walk_emulation(i, q, 16, 20, mode, walk), want)

    @pytest.mark.parametrize("walk", ["rows", "t"])
    @pytest.mark.parametrize("mode", ["phase", "conj"])
    @pytest.mark.parametrize("iw,aw", [(16, 20), (15, 16), (16, 31), (30, 40), (24, 48)])
    def test_seam_words_and_widths(self, iw, aw, mode, walk):
        # the atan2 seam words in 33 rows (no multiple of a warp), 32-bit
        # and 64-bit words, against JAX and the port's plain version on
        # int32 and int64 I/Q
        y, x = _seam_inputs(iw, aw, 33 * 61, seed=iw * aw)
        i, q = x[-33 * 61:].reshape(33, 61), y[-33 * 61:].reshape(33, 61)
        want = np.asarray(getattr(jdm, f"fm_demod_{mode}")(i, q, iw, aw), np.int64)
        np.testing.assert_array_equal(_int_walk_emulation(i, q, iw, aw, mode, walk), want)
        plain = getattr(demod, f"fm_demod_{mode}_plain")
        dtypes = (np.int32, np.int64) if iw <= 32 else (np.int64,)
        for dt in dtypes:
            got = plain(torch.from_numpy(i.astype(dt)), torch.from_numpy(q.astype(dt)), iw, aw)
            np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("walk", ["rows", "t"])
    def test_config5_geometry(self, walk):
        # config 5's 16 rows of 2^22 - 7 samples: 64-output strips and
        # 64-step chunks on 132 SMs, the grid at least one full load; a
        # slice of the same geometry (sms=1 scales it down) emulated whole
        rows, t = 16, (1 << 22) - 7
        span, per_row, tasks = _int_geometry(rows, t, walk)
        assert span == 64 and tasks * (1 if walk == "rows" else 32) >= 132 * 2048
        rng = np.random.default_rng(7)
        i, q = rng.integers(-(1 << 15), 1 << 15, size=(2, 16, 2 * 2048 * 4 + 5))
        assert _int_geometry(16, i.shape[1], walk, sms=1)[0] > 4
        for mode in ("phase", "conj"):
            want = np.asarray(getattr(jdm, f"fm_demod_{mode}")(i, q, 16, 20), np.int64)
            np.testing.assert_array_equal(
                _int_walk_emulation(i, q, 16, 20, mode, walk, sms=1), want)

    def test_walk_of_layouts(self):
        # the transposed (T, C) channel bank walks its rows, contiguous rows
        # their samples, broadcast I/Q by whichever side is not broadcast
        bank = torch.zeros((300, 16), dtype=torch.int32)
        assert dk.walk_of(16, bank.mT.stride(), bank.mT.stride()) == "rows"
        assert dk.walk_of(300, bank.stride(), bank.stride()) == "t"
        assert dk.walk_of(1, (1, 1), (1, 1)) == "t"
        row = torch.zeros((1, 50)).expand(4, 50)
        assert dk.walk_of(4, row.stride(), bank.mT.stride()) == "rows"
        assert dk.walk_of(4, row.stride(), (50, 1)) == "t"
        assert dk.walk_of(4, torch.zeros((4, 1)).expand(4, 50).stride(), (1, 4)) == "t"
        assert dk.WALKS.index("t") == 0 and dk.WALKS.index("rows") == 1

    @pytest.mark.parametrize("mode", ["phase", "conj"])
    def test_output_layout_is_the_plain_versions(self, mode):
        # torch's elementwise ops lay the plain version's output out in the
        # inputs' stride order: the transpose of a contiguous (T-1, rows) for
        # the transposed bank, contiguous rows otherwise; the kernel's
        # wrapper allocates the same (strides of size-1 dimensions aside)
        plain = getattr(demod, f"fm_demod_{mode}_plain")
        rng = np.random.default_rng(1)
        for t, rows in ((300, 16), (2, 3), (33, 1), (129, 33)):
            bank = torch.from_numpy(rng.integers(-999, 999, (2, t, rows)))
            for i, q in ((bank[0].mT, bank[1].mT),
                         (bank[0].mT.contiguous(), bank[1].mT.contiguous())):
                want = plain(i, q, 16, 20)
                i2, q2 = dk._rows(i), dk._rows(q)
                walk = dk.walk_of(rows, i2.stride(), q2.stride())
                mem, out = dk.demod_output(want.shape, walk, "cpu")
                assert out.shape == want.shape and mem.is_contiguous()
                assert _same_layout(out, want), (t, rows, out.stride(), want.stride())
                assert out.data_ptr() == mem.data_ptr()
        out = plain(bank[0].mT, bank[1].mT, 16, 20)
        assert out.stride() == (1, 33) == torch.empty((128, 33)).t().stride()
        # batched: (B, C, T) transposed from (B, T, C) reshapes to rows in place
        b = torch.zeros((2, 3, 40, 4), dtype=torch.int64).mT
        want = plain(b, b, 16, 20)
        assert dk.walk_of(24, dk._rows(b).stride(), dk._rows(b).stride()) == "t"
        assert _same_layout(dk.demod_output(want.shape, "t", "cpu")[1], want.contiguous())


class TestIqFrontEnd:
    def _chain(self, seed=11):
        c, tpb = 4, 6
        proto = channelizer.design_prototype(c, tpb)
        t = c * 1024
        n = np.arange(t)
        rng = np.random.default_rng(seed)
        x = (np.cos(2 * np.pi * (1 / c + 0.005) * n) + 0.3 * rng.normal(size=t)).astype(np.float32)
        return x, proto, c

    def test_fused_front_end_equals_the_plain_chain(self):
        x, proto, c = self._chain()
        y = channelizer.polyphase_channelize(x, proto, c, device="cpu").numpy()
        want = sdr.sdr_chain(x, proto, c, device="cpu").numpy()
        i, q = _quantize(y.real, 2.0**14), _quantize(y.imag, 2.0**14)
        got = _conj_emulation(i.T, q.T, sdr.IQ_WIDTH, 20).T
        assert got.shape == want.shape == (y.shape[0] - 1, c)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jdm.fm_demod_conj(i.T, q.T, 16, 20)).T)
        np.testing.assert_array_equal(
            sdr.discriminate_plain(torch.from_numpy(y)).numpy(), want)

    @pytest.mark.parametrize("scale", [2.0**14, 1000.0, 3.0e4])
    def test_quantizer_rounds_half_to_even(self, scale):
        # channel values whose f32 product with the scale is exactly k + 1/2:
        # torch.round then .to(int32) and rintf (the kernel) take the even one
        k = np.arange(-30000, 30000, 37, dtype=np.float64)
        cand = np.float32((k + 0.5) / scale)
        cand = np.concatenate([np.nextafter(cand, np.float32(-2)), cand,
                               np.nextafter(cand, np.float32(2))])
        prod = cand * np.float32(scale)
        v = cand[prod == np.floor(prod) + 0.5]
        assert len(v) > 100
        want = torch.round(torch.from_numpy(v) * scale).to(torch.int32).numpy()
        np.testing.assert_array_equal(_quantize(v, scale), want)
        assert np.all(want % 2 == 0)

    def test_exact_halves_through_the_discriminator(self):
        # a channel output on exact halves of the 2^-14 grid: the plain
        # chain's discriminator and the emulation's fused quantizer agree
        rng = np.random.default_rng(3)
        k = rng.integers(-20000, 20000, size=(64, 3)) + 0.5
        m = rng.integers(-20000, 20000, size=(64, 3))
        y = (k / 2.0**14 + 1j * m / 2.0**14).astype(np.complex64)
        want = sdr.discriminate_plain(torch.from_numpy(y)).numpy()
        i, q = _quantize(y.real, 2.0**14), _quantize(y.imag, 2.0**14)
        np.testing.assert_array_equal(_conj_emulation(i.T, q.T, 16, 20).T, want)


def _spectrum_input(c, tpb=6, frames=83, seed=0):
    """A real stream for a c-channel bank: a tone in channel 1 over noise."""
    n = np.arange(c * (frames + tpb - 1))
    rng = np.random.default_rng(seed + c)
    x = np.cos(2 * np.pi * (1 / c + 0.004) * n) + 0.4 * rng.normal(size=n.size)
    return x.astype(np.float32), channelizer.design_prototype(c, tpb)


class TestStripWalk:
    @pytest.mark.parametrize("strip", [1, 4, 7, 64])
    @pytest.mark.parametrize("nf", [2, 3, 50, 130])
    def test_carry_across_strips_and_batches(self, nf, strip):
        # three batches of (nf, 5) channels walked in strips, the last strip
        # of each ending at nf - 1 wherever nf - 1 is no multiple of the
        # strip: the carried samples against the chain's plain discriminator
        # and JAX's over the same int I/Q
        rng = np.random.default_rng(nf * 10 + strip)
        y = (rng.normal(size=(3, nf, 5)) + 1j * rng.normal(size=(3, nf, 5))).astype(np.complex64)
        got = _iq_strip_emulation(y, 5, min(strip, nf - 1))
        want = sdr.discriminate_plain(torch.from_numpy(y)).numpy()
        np.testing.assert_array_equal(got, want)
        i, q = _quantize(y.real, 2.0**14), _quantize(y.imag, 2.0**14)
        for bi in range(3):
            np.testing.assert_array_equal(
                got[bi], np.asarray(jdm.fm_demod_conj(i[bi].T, q[bi].T, 16, 20)).T)

    def test_strip_length_fills_the_card(self):
        # config 5 (16 channels over 2^22 - 7 frames) and the dryrun's 4 x 6
        # (2^20 - 5 frames): each grid holds at least one full load of 132
        # SMs; tiny inputs walk 4 frames or all of them
        for nf, c in (((1 << 22) - 7, 16), ((1 << 20) - 5, 4)):
            strip = _strip_len((nf - 1) * c, nf)
            assert -(-(nf - 1) // strip) * c >= 132 * 2048
        assert _strip_len(16 * ((1 << 22) - 8), (1 << 22) - 7) == 64
        assert _strip_len(4 * ((1 << 20) - 6), (1 << 20) - 5) == 15
        assert _strip_len(40, 11) == 4 and _strip_len(6, 3) == 2


class TestHalfSpectrum:
    @pytest.mark.parametrize("c", [4, 5, 16, 2])
    def test_rfft_conjugates_are_fft_s_fill(self, c):
        # the CPU's torch.fft.fft of a real input: bins <= C/2 are rfft's,
        # bins k > C/2 the conjugates of rfft's bins C - k, bit for bit; so
        # full_spectrum of the chain's half spectrum is polyphase_channelize
        x, proto = _spectrum_input(c)
        rng = np.random.default_rng(c)
        r = torch.from_numpy(rng.normal(size=(3, 40, c)).astype(np.float32))
        full, half = torch.fft.fft(r, dim=-1), torch.fft.rfft(r, dim=-1)
        h = c // 2 + 1
        assert half.shape[-1] == h
        assert torch.equal(torch.view_as_real(full[..., :h]), torch.view_as_real(half))
        fill = half[..., 1:(c - 1) // 2 + 1].flip(-1).conj().resolve_conj()
        assert torch.equal(torch.view_as_real(full[..., h:]), torch.view_as_real(fill))
        y_half = channelizer.channel_bins(x, proto, c, device="cpu")
        y_full = channelizer.polyphase_channelize(x, proto, c, device="cpu")
        assert y_half.shape[-1] == h
        assert torch.equal(torch.view_as_real(channelizer.full_spectrum(y_half, c)),
                           torch.view_as_real(y_full))

    @pytest.mark.parametrize("strip", [4, 9])
    @pytest.mark.parametrize("c", [4, 5, 16])
    def test_front_end_vs_the_full_spectrum(self, c, strip):
        # the kernel's reading of the half spectrum (bins 0 and C/2 as they
        # are, channel k > C/2 as rint(-im * scale) of bin C - k) against the
        # plain discriminator over torch.fft.fft's full spectrum and JAX's
        x, proto = _spectrum_input(c, seed=strip)
        y_half = channelizer.channel_bins(x, proto, c, device="cpu").numpy()
        y_full = channelizer.polyphase_channelize(x, proto, c, device="cpu")
        want = sdr.discriminate_plain(y_full).numpy()
        got = _iq_strip_emulation(y_half[None], c, strip)[0]
        assert got.shape == want.shape == (y_half.shape[0] - 1, c)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_iq_strip_emulation(y_full.numpy()[None], c, strip)[0],
                                      want)
        yf = y_full.numpy()
        i, q = _quantize(yf.real, 2.0**14), _quantize(yf.imag, 2.0**14)
        np.testing.assert_array_equal(got, np.asarray(jdm.fm_demod_conj(i.T, q.T, 16, 20)).T)
        np.testing.assert_array_equal(sdr.sdr_chain(x, proto, c, device="cpu").numpy(), want)

    def test_conjugate_quantizes_as_the_fill(self):
        # rint(-im * scale), one rounding, is the negated rint(im * scale),
        # exact halves included
        k = np.arange(-30000, 30000, 37, dtype=np.float64)
        v = np.concatenate([np.float32((k + 0.5) / 2.0**14), np.float32(k / 3.0e3)])
        np.testing.assert_array_equal(_quantize(-v, 2.0**14), -_quantize(v, 2.0**14))
        want = torch.round(torch.from_numpy(-v) * 2.0**14).to(torch.int32).numpy()
        np.testing.assert_array_equal(_quantize(-v, 2.0**14), want)

    def test_wrapper_takes_either_width(self):
        # the bins a frame must be the channels or their half spectrum
        y = torch.zeros((3, 9), dtype=torch.complex64)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.iq_demod(y, n_channels=16)


class TestIterationIdentities:
    @pytest.mark.parametrize("sh", [0, 1, 11, 16, 30])
    def test_folded_shift_pair_is_the_masked_shift(self, sh):
        # d * ((X >> i) with its low sh bits cleared) == (d << sh) * (X >> (i + sh))
        # mod 2^32, d << sh = m * 2^(sh+1) + 2^sh, for X with its low sh bits 0
        rng = np.random.default_rng(sh)
        x = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
             >> np.uint32(sh)) << np.uint32(sh)
        m = np.where(rng.integers(0, 2, 4096) == 1, np.uint32(0xFFFFFFFF), np.uint32(0))
        d = m | np.uint32(1)
        keep = np.uint32((0xFFFFFFFF << sh) & 0xFFFFFFFF)
        p2 = np.uint32(1 << sh)
        for i in range(0, 31 - sh):
            masked = d * ((x.view(np.int32) >> np.int32(i)).view(np.uint32) & keep)
            folded = (m * (p2 << np.uint32(1)) + p2) * (
                x.view(np.int32) >> np.int32(i + sh)).view(np.uint32)
            np.testing.assert_array_equal(masked, folded)

    @pytest.mark.parametrize("aw,p", [(16, 1), (20, 1), (24, 1), (31, 1), (30, 2)])
    def test_z_as_steps_of_the_sign_mask(self, aw, p):
        # z = sum -d_i lut[i] = zbase + sum m_i (-2 lut[i]) mod 2^32
        lut = dk.atan2_lut(aw, p)
        rng = np.random.default_rng(aw)
        d = rng.choice([-1, 1], size=(512, aw - 1))
        m = (d - 1) // 2
        want = (-d * lut).sum(axis=1)
        got = (-int(lut.sum()) + (m * (-2 * lut)).sum(axis=1)) % (1 << 32)
        np.testing.assert_array_equal(np.where(got >= 1 << 31, got - (1 << 32), got), want)


    def test_chain_positions_are_the_iterations(self):
        # every AW + P <= 32, P >= 1: iterations 0..AW-2 at positions
        # entry..32-P of the 2..31 chain, each shift j - 2 the reference's
        # i + sh, a z step at each and 0 at the P - 1 positions past the last
        for aw in range(2, 32):
            for p in range(1, 33 - aw):
                entry, zpos = _chain(aw, p)
                sh = 32 - aw - p
                assert 2 <= entry and entry + aw - 2 == 32 - p
                for i in range(aw - 1):
                    assert 0 <= (i + entry) - 2 == i + sh <= 30
                run = range(entry, CHAIN)
                assert len(run) == aw - 1 + p - 1
                lut = dk.atan2_lut(aw, p)
                want = [(-2 * int(lut[j - entry])) % (1 << 32) if j - entry < aw - 1 else 0
                        for j in run]
                np.testing.assert_array_equal(zpos[entry:], want)
                assert not zpos[:entry].any()

    @pytest.mark.parametrize("aw,p", [(20, 2), (24, 3), (16, 5), (12, 0), (28, 4), (31, 0)])
    def test_positions_past_the_last_leave_the_angle(self, aw, p):
        # P >= 2 runs P - 1 positions past the last iteration with a z step
        # of 0: x and y move, nothing reads them, the angle is JAX's; P = 0
        # takes the 64-bit word
        y, x = _seam_inputs(aw, aw, 1500, seed=aw * 11 + p)
        for conv in CONVENTIONS:
            np.testing.assert_array_equal(_atan2_emulation(y, x, aw, aw, p, conv),
                                          _jax_atan2(y, x, aw, aw, p, conv))

    @pytest.mark.parametrize("n", [1, 255, 256, 257, 132 * 2048 - 1, 132 * 2048,
                                   132 * 2048 + 1, 5 * 132 * 2048 + 17])
    def test_grid_stride_takes_each_output_once(self, n):
        # stride_blocks: at most one full load of the card (132 SMs x 2048
        # threads), the grid-stride loop of atan2_kernel over it
        threads = 256
        want = -(-n // threads)
        blocks = min(want, 132 * (2048 // threads))
        seen = np.zeros(n, np.int64)
        for e0 in range(blocks * threads):
            seen[e0::blocks * threads] += 1
        assert (seen == 1).all()


class TestDispatch:
    def test_cpu_tensors_take_the_plain_versions(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("a kernel wrapper was called for a CPU tensor")

        for name in ("atan2", "fm_demod", "iq_demod"):
            monkeypatch.setattr(dk, name, refuse)
        y, x = _seam_inputs(16, 20, 50, seed=1)
        yt, xt = torch.from_numpy(y), torch.from_numpy(x)
        np.testing.assert_array_equal(cordic.atan2_fixed(yt, xt, 16, 20).numpy(),
                                      cordic.atan2_fixed_plain(yt, xt, 16, 20).numpy())
        np.testing.assert_array_equal(cordic.cordic_atan2(yt, xt, 16, 20).numpy(),
                                      cordic.cordic_atan2_plain(yt, xt, 16, 20).numpy())
        assert demod.fm_demod_conj(xt, yt, 16, 20).shape == (len(x) - 1,)
        assert demod.fm_demod_phase(xt, yt, 16, 20).shape == (len(x) - 1,)
        x_sig, proto, c = self._chain_input()
        assert sdr.sdr_chain(torch.from_numpy(x_sig), proto, c).shape == (256 - 6, 4)

    @staticmethod
    def _chain_input():
        c = 4
        x = np.random.default_rng(0).normal(size=c * 256).astype(np.float32)
        return x, channelizer.design_prototype(c, 6), c

    def test_wrappers_refuse_cpu_tensors(self):
        z = torch.zeros(8, dtype=torch.int64)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.atan2(z, z, 16, 20)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.fm_demod(z, z, 16, 20)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.iq_demod(torch.zeros((4, 2), dtype=torch.complex64))
        with pytest.raises(ValueError, match="CUDA tensors"):
            dk.atan2(np.zeros(8), z, 16, 20)

    def test_array_input_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA device"):
            demod.fm_demod_conj(np.arange(8), np.arange(8), 16, 20)

    def test_lut_and_shifts(self):
        # the z steps the kernel takes are the plain version's, and fit the
        # word the host picks
        for aw, p in WIDTHS + [(2, 0), (48, 1), (49, 0)]:
            lut = dk.atan2_lut(aw, p)
            assert len(lut) == aw - 1
            want = [jcordic.LUT_ATAN_PI[i] >> (49 - aw - p) for i in range(aw - 1)]
            np.testing.assert_array_equal(lut, np.asarray(want, np.int64))
            if aw + p <= 32:
                assert int(lut.max(initial=0)) < 1 << 31
        assert dk.conj_shifts(16, 20) == (1, 11)
        assert dk.conj_shifts(12, 24) == (0, 1)
        assert dk.conj_shifts(17, 31) == (2, 0)
