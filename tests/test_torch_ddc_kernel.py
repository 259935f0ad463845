"""PyTorch port, the DDC mixer kernel (``csrc/ddc_kernel.cu``) on the CPU.

The kernel runs only on a card; here its arithmetic is held two ways
against the JAX package (``pipeline/ddc.py:mix_iq_int`` and the start of
``ddc``, run on the CPU with x64 as ``tests/test_ddc.py`` runs them), on
seeded numpy inputs:

- the plain version the CPU path takes (``pipeline/ddc.py:mixer`` on a CPU
  tensor: ``mixer_plain`` over ``nco_iq`` / ``mix_iq_int``);
- a numpy emulation of the kernel's own datapaths, lane by lane: the
  32-bit phase product, the pre-rotation, the steering iterations (int32
  words for the scaled flavor; for dds48 doubles, the floor of each shift
  taken as the kernel's round-down add of 1.5 * 2^52), rint of the f32
  input product, the int32 mixer products and one f32 rescale product; and
  the period table: the NCO at (j * fw) mod 2^PW for j < P, read at
  nl & (P - 1).  The emulation asserts that the state stays inside the
  ranges the kernel's exactness argument needs (no wrap of the reference
  ever fires, every double is an integer below 2^47) and that the dds48
  doubles equal the int64 state they stand for.

Raw (I, Q) 0 LSB for dds48 and scaled at pw 16, 20, 24, 31 and W 12, 16,
17, with n0 at 0 and across 2^32, at the quadrant-seam phases; the f32
mixer output bit-equal to JAX's quantize-mix-rescale; exact halves of the
input product; batch dims and ragged rows; the sharded halo's period; every
phase at pw=16 for W 8..17.  The table: tuning words with 0, 1, 3, 17 and
PW trailing zeros (fw = 0: P = 1), n0 up to 2^33, negative n under a
sharded period that is not a multiple of P, the seam phases, and both sides
of the switch-over rule (``ddc_kernel.table_period``, which the kernel's
wrapper uses to choose the path).  The kernel against these on the card is
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.pipeline import ddc as jddc
from blackman_harris_win_tpu_torch.core.luts import scaled_internal_width
from blackman_harris_win_tpu_torch.kernels import ddc_kernel as dk
from blackman_harris_win_tpu_torch.pipeline import ddc

FLAVORS = ["dds48", "scaled"]
AMP = float((1 << ddc.MIX_IN_BITS) - 1)
N0S = [0, 2**32 - 5, 2**32 + 3]


#: the kernel's floor constant: fma_rd(v, 2^-k, M) - M = floor(v * 2^-k)
FLOOR_MAGIC = 1.5 * 2.0**52


def _floor_shift(v, k):
    """``csrc/ddc_kernel.cu:floor_shift``: the round-down sum M + v * 2^-k
    lies in [2^52, 2^53), where the doubles are the integers, so it is
    M + floor(v * 2^-k), and subtracting M is exact."""
    s = v * 2.0**-k  # exact: a power of two
    assert np.all((FLOOR_MAGIC + s >= 2.0**52) & (FLOOR_MAGIC + s < 2.0**53))
    return (FLOOR_MAGIC + np.floor(s)) - FLOOR_MAGIC


def _exact(*vs):
    """Every double an integer below 2^47: no operation of the kernel's
    FP64 datapath rounds."""
    for v in vs:
        assert np.all(np.floor(v) == v) and np.abs(v).max(initial=0) < 2.0**47


def _nco_emulation(n, fw, pw, w, flavor, period=0):
    """(cos, -sin) as ``csrc/ddc_kernel.cu:nco`` computes them at int64
    indices ``n`` (n < 0 takes n + period): the scaled flavor in int32
    words, dds48 in doubles beside the int64 state they hold."""
    lut, gain, zshift, oshift = dk.mixer_constants(pw, w, flavor)
    if flavor == "dds48":
        s_bits = z_bits = 48
    else:
        s_bits = scaled_internal_width(w)
        z_bits = max(s_bits, pw)
        assert s_bits <= 31 and z_bits <= 31  # one 32-bit word a register
    n = np.asarray(n, np.int64)
    n = np.where(n < 0, n + period, n)
    nl = (n & 0xFFFFFFFF).astype(np.uint32)
    ph = (nl * np.uint32(fw % (1 << pw))) & np.uint32((1 << pw) - 1)  # wraps mod 2^32
    ph = ph.astype(np.int64)
    q = ph >> (pw - 2)
    low = ph & ((1 << (pw - 2)) - 1)
    sphi = np.where(ph >> (pw - 1) != 0, ph - (1 << pw), ph)
    q03 = (q == 0) | (q == 3)
    init_t = np.where(q03, sphi, np.where(q == 1, low, low - (1 << (pw - 2))))
    x = np.where(q03, gain, 0)
    y = np.where(q == 1, -gain, np.where(q == 2, gain, 0))
    z = init_t << zshift
    assert np.abs(z).max() <= 1 << (z_bits - 2)
    xd, yd, zd = x.astype(np.float64), y.astype(np.float64), init_t * 2.0**zshift
    for k in range(w):
        d = np.where(z < 0, -1, 1)
        x, y = x + d * (y >> k), y - d * (x >> k)
        if flavor == "dds48":  # the kernel's doubles
            assert not np.any((zd == 0) & np.signbit(zd))  # copysign(1, z) is the steering
            dd = np.copysign(1.0, zd)
            ys, xs = (yd, xd) if k == 0 else (_floor_shift(yd, k), _floor_shift(xd, k))
            xd, yd = xd + dd * ys, yd - dd * xs
            if k < w - 1:
                zd = zd - dd * float(lut[k])
            _exact(xd, yd, zd)
        if k < w - 1:
            z = z - d * int(lut[k])
        # the bounds of the kernel's note: the reference's wraps never fire
        assert max(np.abs(x).max(), np.abs(y).max()) < (1 << (s_bits - 2)) + 64
        assert np.abs(z).max() <= 1 << (z_bits - 2)
    if flavor == "dds48":
        np.testing.assert_array_equal(xd, x.astype(np.float64))
        np.testing.assert_array_equal(yd, y.astype(np.float64))
        c, ns = (np.floor(v * 2.0**-oshift).astype(np.int64) for v in (xd, yd))
    else:
        c, ns = x >> oshift, y >> oshift
    np.testing.assert_array_equal(c, x >> oshift)
    assert max(np.abs(c).max(), np.abs(ns).max()) <= (1 << (w - 2)) + 1
    return c, ns


def _wrap32(v):
    return ((np.asarray(v, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def _mixer_emulation(x, n0, fw, pw, w, flavor, period=0, raw=True, table=False):
    """The kernel's output for x (..., T): index n0 + (e mod T) for flat
    element e, the int32 mixer products, and with ``raw=False`` the f32
    rescale (the int->f32 conversion, then one product).  ``table``: the
    pairs come from the period table, entry nl & (P - 1) of the NCO at
    (j * fw) mod 2^PW (entries computed where they are read)."""
    x = np.asarray(x, np.float32)
    t = x.shape[-1]
    xq = np.rint(x * np.float32(AMP)).astype(np.int64)  # __float2int_rn(__fmul_rn(x, amp))
    n = n0 + np.arange(t, dtype=np.int64)
    if table:
        p = dk.nco_period(fw, pw)
        nl = np.where(n < 0, n + period, n) & 0xFFFFFFFF
        c, ns = _nco_emulation(nl & (p - 1), fw, pw, w, flavor)
    else:
        c, ns = _nco_emulation(n, fw, pw, w, flavor, period)
    m = np.stack([_wrap32(xq * c), _wrap32(xq * ns)])
    if raw:
        return m
    return m.astype(np.float32) * np.float32(dk.mixer_scale(w))


def _jax_ints(x, n, fw, pw, w, flavor):
    """JAX's quantizer and mixer at indices ``n`` (int32 lanes: n mod 2^32)."""
    xq = jnp.round(jnp.asarray(x, jnp.float32) * AMP).astype(jnp.int32)
    nj = jnp.asarray(_wrap32(n))
    mi, mq = jddc.mix_iq_int(xq, nj, fw, pw, w, flavor)
    return np.stack([np.asarray(mi), np.asarray(mq)])


def _jax_mixer_f32(x, n, fw, pw, w, flavor):
    """JAX ``ddc``'s front half: quantize, mix, one f32 rescale."""
    m = jnp.asarray(_jax_ints(x, n, fw, pw, w, flavor))
    scale = jnp.float32(1.0 / (AMP * (1 << (w - 2))))
    return np.asarray(m.astype(jnp.float32) * scale)


def _blocks(n0, pw, fw):
    """(n0, T, fw) blocks of one case: a run of 1024 at the case's n0 and
    tuning word; and, through fw = 1 and fw = -1 (mod 2^PW), whose
    consecutive indices step the phase by +-1, the phases s-3 .. s+3 around
    each seam s in {0, N/4, N/2, 3N/4}, at indices at or just past n0."""
    big = 1 << pw
    out = [(n0, 1024, fw)]
    for s in (0, big // 4, big // 2, 3 * big // 4):
        out.append((n0 + (s - 3 - n0) % big, 7, 1))
        out.append((n0 + (-(s + 3) - n0) % big, 7, big - 1))
    return out


def _x(rng, shape):
    return rng.uniform(-1, 1, size=shape).astype(np.float32)


class TestRawProducts:
    @pytest.mark.parametrize("n0", N0S)
    @pytest.mark.parametrize("w", [12, 16, 17])
    @pytest.mark.parametrize("pw", [16, 20, 24, 31])
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_ints_vs_jax(self, flavor, pw, w, n0):
        rng = np.random.default_rng(pw * 100 + w + n0 % 7)
        fw = ddc.freq_word(0.2371, pw) | 1
        for b0, t, f in _blocks(n0, pw, fw):
            x = _x(rng, t)
            n = b0 + np.arange(t, dtype=np.int64)
            want = _jax_ints(x, n, f, pw, w, flavor)
            got = ddc.mixer(torch.from_numpy(x), f, pw, w, flavor, n0=b0, raw=True)
            assert got.dtype == torch.int32 and got.shape == (2, t)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(_mixer_emulation(x, b0, f, pw, w, flavor), want)

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_seam_phases_are_visited(self, flavor):
        # the seam blocks of _blocks do hit s-3 .. s+3 at every seam
        pw = 20
        big = 1 << pw
        for n0 in N0S:
            for b0, t, f in _blocks(n0, pw, 1)[1:]:
                ph = ((b0 + np.arange(t)) % (1 << 32) * f) % big
                assert any(np.array_equal(np.sort(ph), np.sort((s + np.arange(-3, 4)) % big))
                           for s in (0, big // 4, big // 2, 3 * big // 4))


class TestF32Output:
    @pytest.mark.parametrize("n0", [0, 2**32 - 5])
    @pytest.mark.parametrize("pw,w", [(20, 16), (31, 17), (16, 12), (24, 17)])
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_bit_equal_to_jax(self, flavor, pw, w, n0):
        rng = np.random.default_rng(pw + w)
        fw = ddc.freq_word(1 / 8, pw)
        x = _x(rng, 4096)
        want = _jax_mixer_f32(x, n0 + np.arange(4096, dtype=np.int64), fw, pw, w, flavor)
        got = ddc.mixer(torch.from_numpy(x), fw, pw, w, flavor, n0=n0)
        emu = _mixer_emulation(x, n0, fw, pw, w, flavor, raw=False)
        assert got.dtype == torch.float32 and got.shape == (2, 4096)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(emu.view(np.int32), want.view(np.int32))

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_exact_halves_round_to_even(self, flavor):
        # inputs whose f32 product with 2^15 - 1 is exactly k + 1/2: torch.round
        # and rintf (the kernel) and jnp.round all take the even neighbour
        k = np.arange(-32000, 32000, 37, dtype=np.float64)
        cand = np.float32((k + 0.5) / AMP)
        cand = np.concatenate([np.nextafter(cand, np.float32(-2)), cand,
                               np.nextafter(cand, np.float32(2))])
        prod = cand * np.float32(AMP)
        x = cand[prod == np.floor(prod) + 0.5]
        assert len(x) > 100
        xq = torch.round(torch.from_numpy(x) * AMP).to(torch.int32).numpy()
        np.testing.assert_array_equal(xq, np.rint(x * np.float32(AMP)).astype(np.int32))
        np.testing.assert_array_equal(xq % 2, 0)
        pw, w, fw = 20, 16, ddc.freq_word(0.2371, 20)
        n = np.arange(len(x), dtype=np.int64)
        want = _jax_ints(x, n, fw, pw, w, flavor)
        np.testing.assert_array_equal(
            ddc.mixer(torch.from_numpy(x), fw, pw, w, flavor, raw=True).numpy(), want)
        np.testing.assert_array_equal(_mixer_emulation(x, 0, fw, pw, w, flavor), want)


class TestShapes:
    @pytest.mark.parametrize("shape", [(3, 5, 1000), (2, 257), (1, 1), (4, 256)])
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_batch_dims_vs_jax(self, flavor, shape):
        # every row starts at n0: the NCO depends on the index in the row
        rng = np.random.default_rng(len(shape) + shape[-1])
        pw, w, n0 = 24, 17, 2**32 - 5
        fw = ddc.freq_word(0.3333, pw)
        x = _x(rng, shape)
        t = shape[-1]
        n = np.broadcast_to(n0 + np.arange(t, dtype=np.int64), shape)
        want = _jax_ints(x.reshape(-1), n.reshape(-1), fw, pw, w, flavor).reshape(2, *shape)
        got = ddc.mixer(torch.from_numpy(x), fw, pw, w, flavor, n0=n0, raw=True)
        assert got.shape == (2, *shape)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(_mixer_emulation(x, n0, fw, pw, w, flavor), want)

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_sharded_halo_period(self, flavor):
        # shard 0's extended chunk starts below index 0: those indices wrap
        # by the stream length, as shard_mixer_ints and the kernel take them
        pw, w, t_total, first = 20, 16, 4096, -60
        fw = ddc.freq_word(1 / 8, pw)
        x = _x(np.random.default_rng(3), 160)
        n = np.arange(first, first + 160, dtype=np.int64) % t_total
        want = _jax_ints(x, n, fw, pw, w, flavor)
        mi, mq = ddc.shard_mixer_ints(torch.from_numpy(x), first, t_total, fw, pw, w, flavor)
        np.testing.assert_array_equal(np.stack([mi.numpy(), mq.numpy()]), want)
        np.testing.assert_array_equal(
            _mixer_emulation(x, first, fw, pw, w, flavor, period=t_total), want)


class TestDatapath:
    @pytest.mark.parametrize("w", range(8, 18))
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_every_phase_at_pw16(self, flavor, w):
        # the emulation over all 2^16 phases, its range assertions included,
        # against the plain NCO (which wraps as the reference does)
        pw = 16
        n = np.arange(1 << pw, dtype=np.int64)
        c, ns = ddc.nco_iq(n, 1, pw, w, flavor, device="cpu")
        ec, ens = _nco_emulation(n, 1, pw, w, flavor)
        np.testing.assert_array_equal(ec, c.numpy())
        np.testing.assert_array_equal(ens, ns.numpy())

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_constants_widths(self, flavor):
        # what the kernel's words must hold at the widths it takes
        for pw in range(4, dk.MAX_PHASE_WIDTH + 1):
            for w in range(8, 18):
                lut, gain, zshift, oshift = dk.mixer_constants(pw, w, flavor)
                assert len(lut) == w - 1 and zshift >= 0 and oshift > 0
                if flavor == "scaled":
                    assert max(int(lut.max()), gain) < 1 << 31
                    assert zshift + pw <= 31
                else:
                    assert zshift + pw == 48 and oshift == 48 - w


def _word(pw, tz, odd=0x2D4B3):
    """A tuning word mod 2^PW with ``tz`` trailing zeros (0 for tz >= PW)."""
    return ((odd | 1) << tz) % (1 << pw)


TZ = [0, 1, 3, 17, 99]  # 99: tz >= PW, the word 0 (P = 1)


class TestPeriodTable:
    @pytest.mark.parametrize("tz", TZ)
    @pytest.mark.parametrize("pw", [4, 16, 20, 24, 31])
    def test_nco_period(self, pw, tz):
        # P = 2^(PW - tz): the phase of n is that of n mod P, and of no
        # shorter period
        fw = _word(pw, tz)
        p = dk.nco_period(fw, pw)
        assert p == (1 << (pw - tz) if tz < pw else 1)
        rng = np.random.default_rng(pw + tz)
        n = rng.integers(0, 1 << 40, 64, dtype=np.int64)

        def phase(m):
            return ((np.asarray(m) & 0xFFFFFFFF) * fw) % (1 << pw)

        np.testing.assert_array_equal(phase(n), phase(n & (p - 1)))
        np.testing.assert_array_equal(phase(n), phase(n + p))
        if p > 1:
            assert phase(p // 2) != 0
        assert (1 << 32) % p == 0 and p <= 1 << pw

    @pytest.mark.parametrize("n0", [0, 2**32 - 5, 2**33 + 3])
    @pytest.mark.parametrize("tz", TZ)
    @pytest.mark.parametrize("pw", [16, 20, 24, 31])
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_table_vs_jax(self, flavor, pw, tz, n0):
        rng = np.random.default_rng(pw * 7 + tz + n0 % 11)
        fw, w, t = _word(pw, tz), 16, 1024
        x = _x(rng, t)
        want = _jax_ints(x, n0 + np.arange(t, dtype=np.int64), fw, pw, w, flavor)
        np.testing.assert_array_equal(_mixer_emulation(x, n0, fw, pw, w, flavor, table=True),
                                      want)
        np.testing.assert_array_equal(
            ddc.mixer(torch.from_numpy(x), fw, pw, w, flavor, n0=n0, raw=True).numpy(), want)

    @pytest.mark.parametrize("tz", [3, 6, 10])
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_table_under_a_sharded_period(self, flavor, tz):
        # shard 0's chunk starts below 0; the stream's length 1000 is no
        # multiple of P = 2^(20 - tz): an index below 0 takes + 1000 first,
        # then its table entry
        pw, w, t_total, first = 20, 16, 1000, -60
        fw = _word(pw, tz)
        assert t_total % dk.nco_period(fw, pw)
        x = _x(np.random.default_rng(tz), 160)
        want = _jax_ints(x, np.arange(first, first + 160, dtype=np.int64) % t_total, fw, pw, w,
                         flavor)
        np.testing.assert_array_equal(
            _mixer_emulation(x, first, fw, pw, w, flavor, period=t_total, table=True), want)
        mi, mq = ddc.shard_mixer_ints(torch.from_numpy(x), first, t_total, fw, pw, w, flavor)
        np.testing.assert_array_equal(np.stack([mi.numpy(), mq.numpy()]), want)

    @pytest.mark.parametrize("pw", [16, 20, 31])
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_table_at_the_seams(self, flavor, pw):
        # words whose tables hold the quadrant seams: P = 4 is exactly the
        # four seam phases, P = 8 adds the octants, P = 2^10 the seams among
        # 2^10 phases; each table against JAX's NCO at the same phases
        big = 1 << pw
        for fw in (big // 4, 3 * big // 8, 5 * (big >> 10)):
            p = dk.nco_period(fw, pw)
            ph = np.arange(p, dtype=np.int64) * fw % big
            assert {0, big // 4, big // 2, 3 * big // 4} <= set(ph.tolist())
            for w in (12, 16, 17):
                tab = np.stack(_nco_emulation(np.arange(p), fw, pw, w, flavor), axis=-1)
                want = jddc.nco_iq(jnp.asarray(np.arange(p, dtype=np.int32)), fw, pw, w, flavor)
                np.testing.assert_array_equal(tab, np.stack([np.asarray(v) for v in want], -1))
                np.testing.assert_array_equal(
                    tab, ddc.nco_table_plain(fw, pw, w, flavor, device="cpu").numpy())

    @pytest.mark.parametrize("t", [3, 4, 1 << 12, (1 << 22) - 1, 1 << 22, 1 << 26])
    @pytest.mark.parametrize("p_log2", [0, 3, 10, 20, 21, 31])
    def test_switch_over_rule(self, p_log2, t):
        # a table where P <= 2^20 and P <= T/4: both sides of each bound
        pw = 31 if p_log2 > 20 else 20
        fw = _word(pw, pw - p_log2)
        p = dk.nco_period(fw, pw)
        assert p == 1 << p_log2
        want = p if p <= dk.MAX_TABLE and 4 * p <= t else 0
        assert dk.table_period(fw, pw, t) == want
        assert dk.MAX_TABLE == 1 << 20 and dk.TABLE_REUSE == 4

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_both_paths_agree(self, flavor):
        # the table's side of the rule and the compute path's give the same
        # ints at a word, rows and an n0 where both apply
        pw, w, n0 = 24, 17, 2**33 - 7
        fw = _word(pw, 14)
        x = _x(np.random.default_rng(1), (3, 4096))
        assert dk.table_period(fw, pw, 4096) == 1 << 10
        np.testing.assert_array_equal(
            _mixer_emulation(x, n0, fw, pw, w, flavor, table=True),
            _mixer_emulation(x, n0, fw, pw, w, flavor))


class TestDds48Doubles:
    @pytest.mark.parametrize("w", [8, 12, 16, 17])
    def test_every_phase_at_pw20(self, w):
        # the FP64 datapath (its exactness asserted in the emulation) over
        # all 2^20 phases, against the plain NCO
        pw = 20
        n = np.arange(1 << pw, dtype=np.int64)
        c, ns = ddc.nco_iq(n, 1, pw, w, "dds48", device="cpu")
        ec, ens = _nco_emulation(n, 1, pw, w, "dds48")
        np.testing.assert_array_equal(ec, c.numpy())
        np.testing.assert_array_equal(ens, ns.numpy())

    def test_floor_magic(self):
        # the kernel's floor of a shift, at the extremes of the state
        v = np.array([0, 1, -1, 2**46 + 63, -(2**46) - 63, 2**47 - 1, -(2**47) + 1, 12345,
                      -12345], np.float64)
        for k in range(1, 17):
            np.testing.assert_array_equal(_floor_shift(v, k),
                                          (v.astype(np.int64) >> k).astype(np.float64))


class TestDispatch:
    def test_cpu_tensor_takes_the_plain_version(self, monkeypatch):
        def refuse(*a, **k):
            raise AssertionError("the kernel wrapper was called for a CPU tensor")

        monkeypatch.setattr(dk, "mixer", refuse)
        x = _x(np.random.default_rng(1), (2, 64))
        got = ddc.mixer(torch.from_numpy(x), 1000, 20, 16)
        assert torch.equal(got, ddc.mixer_plain(torch.from_numpy(x), 1000, 20, 16))
        bb = ddc.ddc(np.zeros(256, np.float32), 0.1, 4, device="cpu")
        assert bb.shape == (2, 64)

    def test_kernel_wrapper_refuses_a_cpu_tensor(self):
        with pytest.raises(ValueError, match="CUDA tensor"):
            dk.mixer(torch.zeros(8), 1, 20, 16)

    def test_array_input_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is valid")
        with pytest.raises(RuntimeError, match="CUDA device"):
            ddc.mixer(np.zeros(8, np.float32), 1, 20, 16)

    @pytest.mark.parametrize("w", [18, 24])
    def test_width_guard(self, w):
        with pytest.raises(ValueError, match="int32 lanes"):
            ddc.mixer(torch.zeros(8), 1, 20, w)
