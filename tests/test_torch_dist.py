"""PyTorch port, the distribution layer: the mesh, ``shard``/``unshard``,
the collectives and the halos against the JAX package's inside
``shard_map`` on the conftest's 8-device virtual CPU mesh, and sharded
window generation 0 LSB against JAX's sharded generators and the port's
single-device ``window_samples`` (CORDIC HLS and RTL, TAYLOR on both sides
of ``_taylor_fast_ok``, taylor2, the pw=31 range at the quadrant seams and
shard boundaries); the float32 window within ``f32_pair_bound`` of JAX and
bit-equal to the port's single-device window, the compensated pair's s
bit-equal and e within ``comp_e_bound``.  The port's mesh is
``make_mesh(..., devices=["cpu"] * n)``."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.dist import generate as jgen
from blackman_harris_win_tpu.dist import halo as jhalo
from blackman_harris_win_tpu.dist import mesh as jmesh
from blackman_harris_win_tpu.kernels import floatwin as jfloat
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.dist import collectives as coll
from blackman_harris_win_tpu_torch.dist import generate, halo
from blackman_harris_win_tpu_torch.dist.mesh import (
    Mesh,
    Sharded,
    block_sharding,
    make_mesh,
    shard,
    unshard,
)
from blackman_harris_win_tpu_torch.kernels import compwin, floatwin
from blackman_harris_win_tpu_torch.kernels import outerwin_kernel as ok
from blackman_harris_win_tpu_torch.kernels.window import rtl_cordic_coeffs, window_samples
from blackman_harris_win_tpu_torch.windows import catalog

MESHES = [(1, 8), (2, 4), (4, 2)]  # (channels, blocks)


def _pmesh(channels, blocks):
    return make_mesh(blocks=blocks, channels=channels, devices=["cpu"] * (channels * blocks))


def _jspec(spec: WindowSpec):
    return jconfig.WindowSpec(spec.phase_width, spec.data_width, sin_type=spec.sin_type,
                              rounding=spec.rounding, overflow=spec.overflow,
                              precision=spec.precision, lut_size=spec.lut_size)


# --- the mesh ------------------------------------------------------------


class TestMesh:
    @pytest.mark.parametrize("channels,blocks", MESHES + [(1, 1), (2, 1)])
    def test_shape_and_axes_match_jax(self, channels, blocks):
        m = _pmesh(channels, blocks)
        jm = jmesh.make_mesh(blocks=blocks, channels=channels)
        assert m.axis_names == tuple(jm.axis_names)
        assert m.shape == dict(jm.shape)
        assert all(d == torch.device("cpu") for row in m.devices for d in row)

    def test_too_few_devices_raise_as_jax_does(self):
        with pytest.raises(ValueError, match="need 8 devices, have 4"):
            make_mesh(blocks=4, channels=2, devices=["cpu"] * 4)
        with pytest.raises(ValueError, match="need 16 devices, have 8"):
            jmesh.make_mesh(blocks=16)

    def test_default_is_the_cards_never_the_cpu(self):
        if torch.cuda.is_available():
            m = make_mesh(blocks=1)
            assert m.devices[0][0].type == "cuda"
        else:
            with pytest.raises(ValueError, match="need 1 devices, have 0"):
                make_mesh()
            with pytest.raises(RuntimeError, match="CUDA device was asked for"):
                make_mesh(blocks=2, devices=["cuda"] * 2)

    def test_takes_the_first_devices_and_rejects_others(self):
        m = make_mesh(blocks=2, devices=["cpu"] * 5)
        assert m.shape == {"channels": 1, "blocks": 2}
        with pytest.raises(ValueError, match="unsupported device"):
            make_mesh(devices=["meta"])
        with pytest.raises(ValueError, match="rectangular"):
            Mesh([["cpu"], ["cpu", "cpu"]])

    def test_block_sharding(self):
        assert block_sharding(_pmesh(2, 4)) == ("blocks",)


class TestShard:
    @pytest.mark.parametrize("channels,blocks", MESHES)
    @pytest.mark.parametrize("spec", [("channels", "blocks"), ("blocks",), (None, "blocks"),
                                      ("channels", None), ("channels", "blocks", None)])
    def test_round_trip_and_pieces_match_jax(self, channels, blocks, spec):
        x = np.random.default_rng(channels * 10 + blocks).normal(size=(8, 16, 3)).astype(
            np.float32)
        s = shard(x, _pmesh(channels, blocks), spec)
        np.testing.assert_array_equal(unshard(s).numpy(), x)
        jm = jmesh.make_mesh(blocks=blocks, channels=channels)
        jx = jax.device_put(jnp.asarray(x), NamedSharding(jm, P(*spec)))
        for piece in jx.addressable_shards:
            c, b = (int(v) for v in np.argwhere(jm.devices == piece.device)[0])
            np.testing.assert_array_equal(s.shards[c][b].numpy(), np.asarray(piece.data))

    def test_uneven_split_and_bad_specs_raise(self):
        m = _pmesh(2, 4)
        with pytest.raises(ValueError, match="does not split evenly"):
            shard(np.zeros((2, 6)), m, ("channels", "blocks"))
        with pytest.raises(ValueError, match="names a mesh axis twice"):
            shard(np.zeros((4, 4)), m, ("blocks", "blocks"))
        with pytest.raises(ValueError, match="at most 1 entries"):
            shard(np.zeros(8), m, (None, "blocks"))

    def test_resharding(self):
        m = _pmesh(2, 4)
        x = torch.arange(64.0).reshape(4, 16)
        s = shard(x, m, ("channels", "blocks"))
        assert shard(s, m, ("channels", "blocks")) is s
        r = shard(s, m, (None, "blocks"))
        assert r.spec == (None, "blocks") and torch.equal(unshard(r), x)
        assert torch.equal(r.shards[1][2], x[:, 8:12])  # replicated over channels


# --- the collectives, against lax inside shard_map -------------------------


def _jax_per_shard(n, fn, x):
    """fn inside shard_map over an n-device 'blocks' mesh on x (n, ...)
    split over its first axis; returns the n per-shard results."""
    m = jmesh.make_mesh(blocks=n)
    out = jax.jit(shard_map(fn, mesh=m, in_specs=P("blocks"), out_specs=P("blocks")))(
        jax.device_put(jnp.asarray(x), NamedSharding(m, P("blocks"))))
    return np.split(np.asarray(out), n)


PERMS = {
    "shift": lambda n: [(i, (i + 1) % n) for i in range(n)],
    "open": lambda n: [(i, i + 1) for i in range(n - 1)],
    "reverse": lambda n: [(i, n - 1 - i) for i in range(n)],
    "one": lambda n: [(n - 1, 0)],
}


class TestCollectives:
    @pytest.mark.parametrize("n", [1, 2, 8])
    @pytest.mark.parametrize("perm", sorted(PERMS))
    def test_ppermute_matches_jax(self, n, perm):
        pm = PERMS[perm](n)
        x = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
        want = _jax_per_shard(n, lambda v: lax.ppermute(v, "blocks", pm), x)
        got = coll.ppermute([torch.from_numpy(r[None]) for r in x], pm)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)

    def test_ppermute_one_shard_circular_is_its_own(self):
        x = torch.arange(6.0)
        (got,) = coll.ppermute([x], [(0, 0)])
        assert torch.equal(got, x)

    def test_ppermute_rejects_bad_perms(self):
        xs = [torch.zeros(2)] * 3
        with pytest.raises(ValueError, match="at most once"):
            coll.ppermute(xs, [(0, 1), (0, 2)])
        with pytest.raises(ValueError, match="out of range"):
            coll.ppermute(xs, [(0, 3)])

    @pytest.mark.parametrize("n", [1, 2, 8])
    @pytest.mark.parametrize("op", ["psum", "pmean"])
    def test_reductions_match_jax(self, n, op):
        x = np.random.default_rng(n + 1).normal(size=(n, 7)).astype(np.float32)
        want = _jax_per_shard(n, lambda v: getattr(lax, op)(v, "blocks"), x)
        got = getattr(coll, op)([torch.from_numpy(r[None]) for r in x])
        # the port sums in axis order; XLA's order may differ: n - 1 f32
        # additions over terms of at most max|x|, plus the division's rounding
        bound = (n - 1 + 1) * 2.0**-24 * np.abs(x).sum(axis=0).max()
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - w).max() <= bound

    def test_pmean_sums_in_axis_order(self):
        xs = [torch.tensor([1.0]), torch.tensor([1e8]), torch.tensor([-1e8])]
        # (1 + 1e8) - 1e8 in f32 is 0: shard 0 first, then the others in turn
        assert all(float(v) == 0.0 for v in coll.pmean(xs))
        assert coll.axis_size(xs) == 3 and list(coll.axis_index(xs)) == [0, 1, 2]


# --- the halos ----------------------------------------------------------------


@lru_cache(maxsize=None)
def _jax_halos(n, circular, width):
    """The four halo functions of the JAX package inside shard_map over an
    n-device 'blocks' mesh, on a (3, n*8) input split over its last axis."""
    x = np.random.default_rng(n * 7 + width).normal(size=(3, n * 8)).astype(np.float32)
    m = jmesh.make_mesh(blocks=n)

    def fn(v):
        return (jhalo.left_halo(v, width, "blocks", circular),
                jhalo.right_halo(v, width, "blocks", circular),
                jhalo.with_left_halo(v, width, "blocks", circular),
                jhalo.with_right_halo(v, width, "blocks", circular))

    spec = P(None, "blocks")
    outs = jax.jit(shard_map(fn, mesh=m, in_specs=spec, out_specs=(spec,) * 4))(
        jax.device_put(jnp.asarray(x), NamedSharding(m, spec)))
    return x, [np.split(np.asarray(o), n, axis=-1) for o in outs]


HALO_FNS = ["left_halo", "right_halo", "with_left_halo", "with_right_halo"]


class TestHalo:
    @pytest.mark.parametrize("n", [1, 2, 8])
    @pytest.mark.parametrize("circular", [False, True])
    @pytest.mark.parametrize("fn", HALO_FNS)
    @pytest.mark.parametrize("width", [3, 8])
    def test_matches_jax_inside_shard_map(self, n, circular, fn, width):
        x, outs = _jax_halos(n, circular, width)
        row = shard(x, make_mesh(blocks=n, devices=["cpu"] * n), (None, "blocks")).row()
        got = getattr(halo, fn)(row, width, circular)
        for g, w in zip(got, outs[HALO_FNS.index(fn)]):
            np.testing.assert_array_equal(g.numpy(), w)

    @pytest.mark.parametrize("fn", ["with_left_halo", "with_right_halo"])
    def test_zero_halo_is_the_identity(self, fn):
        row = [torch.arange(4.0) + i for i in range(3)]
        got = getattr(halo, fn)(row, 0, True)
        assert all(g is r for g, r in zip(got, row))

    def test_defaults_match_jax(self):
        import inspect

        for fn in HALO_FNS:
            want = inspect.signature(getattr(jhalo, fn)).parameters["circular"].default
            assert inspect.signature(getattr(halo, fn)).parameters["circular"].default == want


# --- sharded generation ----------------------------------------------------------

GEN_CASES = {  # name -> (window, spec, rtl coefficients)
    "cordic hls bh7 w17": ("bh7", WindowSpec(12, 17), False),
    "cordic hls bh7 w32 wrap": ("bh7", WindowSpec(12, 32, overflow="wrap"), False),
    "cordic hls bh4 w24 saturate": ("bh4", WindowSpec(11, 24, overflow="saturate"), False),
    "cordic rtl bh7 w32": ("bh7", WindowSpec(12, 32, rounding="rtl", overflow="wrap"), True),
    "cordic rtl hamming w16": ("hamming", WindowSpec(10, 16, rounding="rtl"), True),
    "taylor hls blackman fast": ("blackman", WindowSpec(13, 16, sin_type="taylor", lut_size=10,
                                                        overflow="wrap"), False),
    "taylor hls hamming w32 fast": ("hamming", WindowSpec(12, 32, sin_type="taylor",
                                                          lut_size=6, overflow="saturate"), False),
    "taylor rtl hamming slow": ("hamming", WindowSpec(12, 16, sin_type="taylor", lut_size=8,
                                                      rounding="rtl"), False),
    "taylor2 bh7 w32": ("bh7", WindowSpec(12, 32, sin_type="taylor2", lut_size=9,
                                          overflow="wrap"), False),
}


def _coeffs(name, spec, rtl):
    q = catalog.get(name).quantized(spec.data_width)
    return rtl_cordic_coeffs(q) if rtl else q


@lru_cache(maxsize=None)
def _jax_window(case):
    """JAX's sharded window of a GEN_CASES case on the 8-device mesh (its
    values do not depend on the mesh: the JAX package's own tests)."""
    name, spec, rtl = GEN_CASES[case]
    return np.asarray(jgen.sharded_window(_coeffs(name, spec, rtl), _jspec(spec),
                                          jmesh.make_mesh(blocks=8)))


class TestShardedWindow:
    @pytest.mark.parametrize("case", sorted(GEN_CASES))
    @pytest.mark.parametrize("channels,blocks", [(1, 8), (2, 4)])
    def test_bit_equal_to_jax_and_single_device(self, case, channels, blocks):
        name, spec, rtl = GEN_CASES[case]
        q = _coeffs(name, spec, rtl)
        s = generate.sharded_window(q, spec, _pmesh(channels, blocks))
        assert s.spec == ("blocks",)
        got = unshard(s).numpy()
        assert got.dtype == np.int32 and got.shape == (spec.n,)
        np.testing.assert_array_equal(got, _jax_window(case))
        np.testing.assert_array_equal(got, window_samples(torch.arange(spec.n), q, spec).numpy())
        # every channel's replica is the same window
        for c in range(channels):
            np.testing.assert_array_equal(torch.cat(s.row(c)).numpy(), got)

    @pytest.mark.parametrize("case", sorted(GEN_CASES))
    @pytest.mark.parametrize("blocks", [1, 8, 64])
    def test_taylor_fast_ok_matches_jax(self, case, blocks):
        name, spec, rtl = GEN_CASES[case]
        q = _coeffs(name, spec, rtl)
        block = spec.n // blocks
        assert generate._taylor_fast_ok(q, spec, block) == jgen._taylor_fast_ok(
            q, _jspec(spec), block)

    def test_both_taylor_routes_are_taken(self):
        fast = GEN_CASES["taylor hls blackman fast"]
        slow = GEN_CASES["taylor rtl hamming slow"]
        assert generate._taylor_fast_ok(_coeffs(*fast), fast[1], fast[1].n // 8)
        assert not generate._taylor_fast_ok(_coeffs(*slow), slow[1], slow[1].n // 8)

    @pytest.mark.parametrize("axis", ["blocks", "channels"])
    def test_shards_hold_their_own_blocks(self, axis):
        spec = WindowSpec(10, 17)
        q = catalog.get("bh4").quantized(17)
        s = generate.sharded_window(q, spec, _pmesh(2, 4), axis=axis)
        whole = window_samples(torch.arange(spec.n), q, spec)
        nb = 4 if axis == "blocks" else 2
        for c in range(2):
            for b in range(4):
                i = b if axis == "blocks" else c
                block = spec.n // nb
                assert torch.equal(s.shards[c][b].long(), whole[i * block:(i + 1) * block])

    def test_window_shard_fn(self):
        spec = WindowSpec(10, 17)
        q = catalog.get("bh7").quantized(17)
        gen = generate.window_shard_fn(q, spec, 256)
        got = torch.cat([gen(i, torch.device("cpu")) for i in range(4)])
        assert torch.equal(got.long(), window_samples(torch.arange(spec.n), q, spec))

    def test_indivisible_raises(self):
        spec = WindowSpec(10, 17)
        q = catalog.get("bh4").quantized(17)
        m = make_mesh(blocks=3, devices=["cpu"] * 3)
        with pytest.raises(ValueError, match="not divisible by 3 shards"):
            generate.sharded_window(q, spec, m)
        with pytest.raises(ValueError, match="count 100 not divisible by 3 shards"):
            generate.sharded_window_range(q, spec, m, 0, 100)
        with pytest.raises(ValueError, match="not divisible by 3 shards"):
            generate.sharded_float_window("bh4", 10, m)
        with pytest.raises(KeyError, match="time"):
            generate.sharded_window(q, spec, _pmesh(1, 2), axis="time")


RANGE_CASES = {
    "cordic hls bh7 w17 pw31": ("bh7", WindowSpec(31, 17), False),
    "cordic hls bh7 w32 pw31": ("bh7", WindowSpec(31, 32, overflow="wrap"), False),
    "cordic rtl bh4 w17 pw31": ("bh4", WindowSpec(31, 17, rounding="rtl"), True),
    "taylor hls hamming w16 pw31": ("hamming", WindowSpec(31, 16, sin_type="taylor",
                                                          lut_size=10, overflow="wrap"), False),
}


class TestShardedWindowRange:
    @pytest.mark.parametrize("case", sorted(RANGE_CASES))
    @pytest.mark.parametrize("where", ["0", "N/4", "N/2", "3N/4"])
    @pytest.mark.parametrize("delta", [-1, 0, 1])
    def test_seams_at_shard_boundaries(self, case, where, delta):
        """The seam phase (plus delta) sits exactly on a shard boundary:
        shard 4 of 8 starts there."""
        name, spec, rtl = RANGE_CASES[case]
        q = _coeffs(name, spec, rtl)
        n = spec.n
        seam = {"0": n, "N/4": n // 4, "N/2": n // 2, "3N/4": 3 * n // 4}[where] + delta
        blocks, block = 8, 64
        n0 = seam - 4 * block
        got = unshard(generate.sharded_window_range(
            q, spec, make_mesh(blocks=blocks, devices=["cpu"] * blocks), n0, blocks * block))
        want_port = window_samples(torch.arange(n0, n0 + blocks * block), q, spec)
        np.testing.assert_array_equal(got.numpy(), want_port.numpy())
        if (where, delta) in (("0", -1), ("N/2", 0)):  # JAX compiles anew for each n0
            want = np.asarray(jgen.sharded_window_range(q, _jspec(spec),
                                                        jmesh.make_mesh(blocks=blocks), n0,
                                                        blocks * block))
            np.testing.assert_array_equal(got.numpy(), want)

    def test_dryrun_stage_6_range_around_the_peak(self):
        spec = WindowSpec(31, 17)
        q = catalog.get("bh7").quantized(17)
        count = 4 * 2048
        n0 = (1 << 30) - count // 2
        got = unshard(generate.sharded_window_range(q, spec, _pmesh(2, 4), n0, count))
        np.testing.assert_array_equal(
            got.numpy(), window_samples(torch.arange(n0, n0 + count), q, spec).numpy())

    @pytest.mark.parametrize("n0", [1 << 12, (1 << 12) + 3])
    def test_taylor_range_both_routes(self, n0):
        """An aligned start takes the Taylor block kernel, an unaligned one
        (n0 not a multiple of R_1 = 16) window_samples; both equal JAX."""
        spec = WindowSpec(16, 16, sin_type="taylor", lut_size=10, overflow="wrap")
        q = catalog.get("hamming").quantized(16)
        count = 8 * 1024
        assert generate._taylor_fast_ok(q, spec, count // 8)
        got = unshard(generate.sharded_window_range(q, spec, _pmesh(1, 8), n0, count))
        np.testing.assert_array_equal(
            got.numpy(), window_samples(torch.arange(n0, n0 + count), q, spec).numpy())
        want = np.asarray(jgen.sharded_window_range(q, _jspec(spec), jmesh.make_mesh(blocks=8),
                                                    n0, count))
        np.testing.assert_array_equal(got.numpy(), want)


class TestShardedFloatWindows:
    @pytest.mark.parametrize("name", ["bh4", "bh7", "hann"])
    @pytest.mark.parametrize("pw,blocks", [(14, 8), (12, 4), (16, 2)])
    def test_float_window(self, name, pw, blocks):
        s = generate.sharded_float_window(name, pw, make_mesh(blocks=blocks,
                                                              devices=["cpu"] * blocks))
        got = unshard(s).numpy()
        _, m, _ = generate._float_split(pw, blocks)
        np.testing.assert_array_equal(got, floatwin.float_window(name, pw, m=m,
                                                                 device="cpu").numpy())
        want = np.asarray(jgen.sharded_float_window(name, pw, jmesh.make_mesh(blocks=blocks)))
        assert np.abs(got - want).max() <= ok.f32_pair_bound(name)

    @pytest.mark.parametrize("name", ["bh4", "bh7"])
    @pytest.mark.parametrize("pw,blocks", [(14, 8), (12, 4)])
    def test_comp_window(self, name, pw, blocks):
        s, e = generate.sharded_comp_window(name, pw, make_mesh(blocks=blocks,
                                                                devices=["cpu"] * blocks))
        s, e = unshard(s).numpy(), unshard(e).numpy()
        _, m, _ = generate._float_split(pw, blocks)
        ps, pe = compwin.comp_window_pair(name, pw, m=m, device="cpu")
        np.testing.assert_array_equal(s, ps.numpy())
        np.testing.assert_array_equal(e, pe.numpy())
        js, je = (np.asarray(v) for v in jgen.sharded_comp_window(
            name, pw, jmesh.make_mesh(blocks=blocks)))
        np.testing.assert_array_equal(s, js)
        assert np.abs(e - je).max() <= ok.comp_e_bound(name)
        gold = catalog.float_window_value(name, np.arange(1 << pw), 1 << pw)
        assert np.abs(s.astype(np.float64) + e - gold).max() < 5e-9

    def test_small_shards_shrink_the_split(self):
        # 2^12 over 8 shards: 512-sample blocks, m = 9 (JAX's rule)
        assert generate._float_split(12, 8) == (512, 9, 1)
        assert generate._float_split(26, 4) == (1 << 24, 11, 1 << 13)
        s = generate.sharded_float_window("bh7", 12, make_mesh(blocks=8, devices=["cpu"] * 8))
        jw = np.asarray(jfloat.float_window("bh7", 12, m=9))
        assert np.abs(unshard(s).numpy() - jw).max() <= ok.f32_pair_bound("bh7")
        assert isinstance(s, Sharded)
