"""PyTorch port, the DDC mixer kernel (``csrc/ddc_kernel.cu``) on the CPU.

The kernel runs only on a card; here its arithmetic is held two ways
against the JAX package (``pipeline/ddc.py:mix_iq_int`` and the start of
``ddc``, run on the CPU with x64 as ``tests/test_ddc.py`` runs them), on
seeded numpy inputs:

- the plain version the CPU path takes (``pipeline/ddc.py:mixer`` on a CPU
  tensor: ``mixer_plain`` over ``nco_iq`` / ``mix_iq_int``);
- a numpy emulation of the kernel's own datapath, lane by lane: the 32-bit
  phase product, the pre-rotation, the unwrapped steering iterations
  (int32 words for the scaled flavor, int64 for dds48), rint of the f32
  input product, the int32 mixer products and one f32 rescale product.
  The emulation asserts that the state stays inside the ranges the
  kernel's exactness argument needs (no wrap of the reference ever fires).

Raw (I, Q) 0 LSB for dds48 and scaled at pw 16, 20, 24, 31 and W 12, 16,
17, with n0 at 0 and across 2^32, at the quadrant-seam phases; the f32
mixer output bit-equal to JAX's quantize-mix-rescale; exact halves of the
input product; batch dims and ragged rows; the sharded halo's period; every
phase at pw=16 for W 8..17.  The kernel against these on the card is
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


def _nco_emulation(n, fw, pw, w, flavor, period=0):
    """(cos, -sin) as ``csrc/ddc_kernel.cu:nco`` computes them at int64
    indices ``n`` (n < 0 takes n + period)."""
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
    for k in range(w):
        d = np.where(z < 0, -1, 1)
        x, y = x + d * (y >> k), y - d * (x >> k)
        if k < w - 1:
            z = z - d * int(lut[k])
        # the bounds of the kernel's note: the reference's wraps never fire
        assert max(np.abs(x).max(), np.abs(y).max()) < (1 << (s_bits - 2)) + 64
        assert np.abs(z).max() <= 1 << (z_bits - 2)
    c, ns = x >> oshift, y >> oshift
    assert max(np.abs(c).max(), np.abs(ns).max()) <= (1 << (w - 2)) + 1
    return c, ns


def _wrap32(v):
    return ((np.asarray(v, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def _mixer_emulation(x, n0, fw, pw, w, flavor, period=0, raw=True):
    """The kernel's output for x (..., T): index n0 + (e mod T) for flat
    element e, the int32 mixer products, and with ``raw=False`` the f32
    rescale (the int->f32 conversion, then one product)."""
    x = np.asarray(x, np.float32)
    t = x.shape[-1]
    xq = np.rint(x * np.float32(AMP)).astype(np.int64)  # __float2int_rn(__fmul_rn(x, amp))
    c, ns = _nco_emulation(n0 + np.arange(t, dtype=np.int64), fw, pw, w, flavor, period)
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
