"""PyTorch port, the DDC: tuning word, NCO and integer mixer 0-LSB against
the JAX package (both NCO flavors, large indices and offsets), the mixer
width guard, and ``ddc`` against JAX at a size where the decimating FIR
takes its bulk branch (the materialization barrier) within a derived f32
bound; plus the taps == decim case, which the port defines."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.model import golden
from blackman_harris_win_tpu.pipeline import ddc as jddc
from blackman_harris_win_tpu.pipeline import fir as jfir
from blackman_harris_win_tpu_torch.pipeline import ddc, fir

_U = 2.0**-24
FLAVORS = ["dds48", "scaled"]
GOLDEN = {"dds48": golden.cordic_dds48, "scaled": golden.cordic_scaled}


def _gamma(k):
    return k * _U / (1 - k * _U)


def _tone(f, t):
    return np.cos(2 * np.pi * f * np.arange(t)).astype(np.float32)


class TestNco:
    @pytest.mark.parametrize("freq", [1 / 8, 0.2371, 0.0, -1 / 8, 0.5, 3 / 16, -0.4999])
    @pytest.mark.parametrize("pw", [12, 20, 31])
    def test_freq_word(self, freq, pw):
        assert ddc.freq_word(freq, pw) == jddc.freq_word(freq, pw)

    @pytest.mark.parametrize("flavor", FLAVORS)
    @pytest.mark.parametrize("freq,pw,w", [(0.2371, 20, 16), (1 / 8, 20, 16), (3 / 16, 12, 12),
                                           (0.3333, 31, 17)])
    def test_nco_vs_jax(self, flavor, freq, pw, w):
        fw = ddc.freq_word(freq, pw)
        rng = np.random.default_rng(pw + w)
        n = np.concatenate([np.arange(4096), rng.integers(0, 1 << 31, 2048),
                            [2**30 - 5, 2**31 - 2, 2**31 - 1]]).astype(np.int64)
        c, ns = ddc.nco_iq(n, fw, pw, w, flavor, device="cpu")
        jc, jns = jddc.nco_iq(n.astype(np.int32), fw, pw, w, flavor)
        assert c.dtype == ns.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_nco_vs_golden(self, flavor):
        pw, w = 12, 16
        fw = ddc.freq_word(3 / 16, pw)
        n = np.arange(64)
        c, ns = ddc.nco_iq(n, fw, pw, w, flavor, device="cpu")
        for i in range(64):
            gc, gns = GOLDEN[flavor]((int(n[i]) * fw) % (1 << pw), pw, w)
            assert int(c[i]) == gc and int(ns[i]) == gns, i

    def test_index_taken_mod_2_32(self):
        # the JAX package's int32 lanes wrap n; the port masks it, so any
        # int64 index (negative, past 2^31) gives the same phase
        pw, fw = 20, ddc.freq_word(0.2371, 20)
        n = np.array([0, 5, 2**31 - 1, 2**31, 2**32 + 7, -3], np.int64)
        a = ddc.nco_iq(n, fw, pw, 16, device="cpu")
        b = ddc.nco_iq(n & 0xFFFFFFFF, fw, pw, 16, device="cpu")
        c = jddc.nco_iq(n.astype(np.int32), fw, pw, 16)
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y)
            np.testing.assert_array_equal(x.numpy(), np.asarray(z))

    def test_flavor_guard(self):
        with pytest.raises(ValueError, match="flavor"):
            ddc.nco_iq(np.arange(4), 1, 12, 16, "hls", device="cpu")


class TestMixer:
    @pytest.mark.parametrize("w", [16, 17, 18, 24])
    def test_guard_raises_where_jax_raises(self, w):
        args = (np.zeros(4, np.int32), np.arange(4), 0, 12, w)
        jax_raises = ddc.MIX_IN_BITS + (w - 2) + 1 > 31
        try:
            jddc.mix_iq_int(*args)
        except ValueError:
            assert jax_raises
        else:
            assert not jax_raises
        if jax_raises:
            with pytest.raises(ValueError, match="int32 lanes"):
                ddc.mix_iq_int(*args, device="cpu")
            with pytest.raises(ValueError, match="int32 lanes"):
                ddc.ddc(np.zeros(64, np.float32), 0.1, 4, data_width=w, device="cpu")
        else:
            ddc.mix_iq_int(*args, device="cpu")

    @pytest.mark.parametrize("flavor", FLAVORS)
    @pytest.mark.parametrize("n0", [0, 123457, 2**31 - 100])
    def test_products_vs_jax(self, flavor, n0):
        pw, w = 20, 16
        fw = ddc.freq_word(0.2371, pw)
        rng = np.random.default_rng(n0 % 1000)
        lim = 1 << ddc.MIX_IN_BITS
        xq = rng.integers(-lim + 1, lim, size=4096).astype(np.int32)
        n = (n0 + np.arange(4096)).astype(np.int64)
        mi, mq = ddc.mix_iq_int(xq, n, fw, pw, w, flavor, device="cpu")
        jmi, jmq = jddc.mix_iq_int(jnp.asarray(xq), n.astype(np.int32), fw, pw, w, flavor)
        np.testing.assert_array_equal(mi.numpy(), np.asarray(jmi))
        np.testing.assert_array_equal(mq.numpy(), np.asarray(jmq))


def _ddc_bound(x, h, data_width):
    """Both sides mix to the same ints and rescale them to the same f32
    values (held 0 LSB above), then run an n-tap f32 FIR: they differ by at
    most 2 gamma(n) sum|h| max|m| with |m| <= max|x| (|cos| <= 2^(W-2))."""
    h32 = np.asarray(h, np.float32).astype(np.float64)
    return 2 * _gamma(len(h)) * np.abs(h32).sum() * max(1.0, float(np.abs(x).max()))


class TestDdc:
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_bulk_vs_jax(self, monkeypatch, flavor):
        # T = 2^22, 64 taps, decim 4: (2^20 - 15) * 64 > 2^25, so the body
        # FIR takes the bulk branch behind the barrier
        calls = []
        monkeypatch.setattr(fir, "materialize", lambda v: calls.append(tuple(v.shape)) or v.clone())
        t = 1 << 22
        x = np.random.default_rng(21).normal(size=t).astype(np.float32)
        h = fir.design_lowpass(64, 0.2)
        got = ddc.ddc(x, 1 / 8, 4, taps=h, flavor=flavor, device="cpu")
        want = np.asarray(jddc.ddc(x, 1 / 8, 4, taps=jfir.design_lowpass(64, 0.2), flavor=flavor))
        assert calls == [(2, t)]
        assert got.dtype == torch.float32 and got.shape == want.shape == (2, t // 4)
        assert np.abs(got.numpy() - want).max() <= _ddc_bound(x, h, 16)

    @pytest.mark.parametrize("flavor", FLAVORS)
    @pytest.mark.parametrize("n0,freq", [(0, 1 / 8), (98765, 0.2371), (2**31 - 64, 0.1)])
    def test_small_vs_jax(self, flavor, n0, freq):
        t = 4096
        x = np.random.default_rng(n0 % 997).normal(size=t).astype(np.float32) * 0.5
        got = ddc.ddc(x, freq, 4, n0=n0, flavor=flavor, device="cpu")
        want = np.asarray(jddc.ddc(x, freq, 4, n0=n0, flavor=flavor))
        h = fir.design_lowpass(64, 0.2)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= _ddc_bound(x, h, 16)

    def test_batched_vs_jax(self):
        x = np.random.default_rng(5).normal(size=(3, 2048)).astype(np.float32) * 0.3
        got = ddc.ddc(x, 0.15, 8, taps=32, device="cpu")
        want = np.asarray(jddc.ddc(x, 0.15, 8, taps=32))
        assert got.shape == want.shape == (2, 3, 256)
        assert np.abs(got.numpy() - want).max() <= _ddc_bound(x, fir.design_lowpass(32, 0.1), 16)

    def test_tone_shift(self):
        fc, df, decim, t = 1 / 8, 1 / 256, 4, 16384
        bb = ddc.ddc(_tone(fc + df, t), fc, decim, taps=fir.design_lowpass(64, 0.2),
                     device="cpu").numpy()
        z = (bb[0].astype(np.float64) + 1j * bb[1])[16:-16]
        f_meas = np.mean(np.diff(np.unwrap(np.angle(z)))) / (2 * np.pi * decim)
        assert abs(f_meas - df) < 1e-4
        assert abs(np.mean(np.abs(z)) - 0.5) < 0.02

    def test_taps_equal_decim_returns_the_body(self):
        # halo 0: no wrapped head; the JAX ddc fails here, the port returns
        # the body FIR of the mixer output
        t, decim = 1024, 4
        x = _tone(0.13, t)
        h = np.array([0.1, 0.2, 0.3, 0.4])
        got = ddc.ddc(x, 0.125, decim, taps=h, device="cpu")
        assert got.shape == (2, t // decim)
        xq = torch.round(torch.from_numpy(x) * float((1 << ddc.MIX_IN_BITS) - 1)).to(torch.int32)
        mi, mq = ddc.mix_iq_int(xq, torch.arange(t), ddc.freq_word(0.125, 20), 20, 16)
        scale = float(np.float32(1.0 / (((1 << ddc.MIX_IN_BITS) - 1) * (1 << 14))))
        m2 = torch.stack([mi, mq]).to(torch.float32) * scale
        assert torch.equal(got, fir.decimating_fir(m2, h, decim))

    def test_decim_larger_than_filter_raises(self):
        with pytest.raises(ValueError, match="decimation larger"):
            ddc.ddc(np.zeros(64, np.float32), 0.1, 8, taps=np.ones(4), device="cpu")

    def test_length_must_be_multiple_of_decim(self):
        with pytest.raises(ValueError, match="multiple of decim"):
            ddc.ddc(np.zeros(66, np.float32), 0.1, 4, device="cpu")
