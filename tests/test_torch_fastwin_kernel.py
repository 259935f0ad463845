"""PyTorch port, the taylor2 window kernel (``csrc/fastwin_kernel.cu``) on
the CPU.

The kernel runs only on a card; here a numpy emulation of its datapath is
held 0 LSB against the JAX package's ``window_values_fast`` (run on the CPU
with x64) on seeded numpy indices: the uint32 phase product (k*n) mod 2^PW,
the ROM read, the second-order correction computing only the quadrant's
cosine (two exact uint64 floors, each below 2^62, asserted), the uint32
alternating accumulate with the low 32 bits of (a_k * cos) >> (W-2), then
the W-bit wrap or the clamp.  Cases: LS 9/10/12/14 with PW from LS+1 (the
ROM-only regime, rb <= 0) to 31, both sides of the rb+12 <= 31 condition on
P_lo, W 16/17/24/32, wrap and saturate, every catalog window, the quadrant
seams, and PW 32 against the port's plain version.  The run walk
(``TestRunWalk``) is emulated as the kernel runs it, warp by warp and lane
by lane: a run's ROM entry and quadrant read once, d's two parts stepped
from the lane's first sample by the gap to the next, the check of acnt *
P_hi against 2^rb * P_hi at every sample (the residual count held to the
reference's on the way) and the entry of a new run past it, the high-word
products, two harmonics a pass; every uint32 bound the source's note
claims is asserted.  Then the routing:
``window_block``, the sharded generator's ``_range_fn`` and the CLI's
``gen --mode taylor2`` call the kernel's wrapper with the device they were
given, which takes the plain version on the CPU and asks for the card
otherwise (never the CPU).  The kernel against its plain version on the
card is ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from blackman_harris_win_tpu.core import config as jconfig
from blackman_harris_win_tpu.kernels import fastwin as jf
from blackman_harris_win_tpu_torch import _build
from blackman_harris_win_tpu_torch.core.config import WindowSpec
from blackman_harris_win_tpu_torch.dist import generate
from blackman_harris_win_tpu_torch.kernels import fastwin as pf
from blackman_harris_win_tpu_torch.kernels import fastwin_kernel as fk
from blackman_harris_win_tpu_torch.kernels import window as kw
from blackman_harris_win_tpu_torch.windows import catalog


def _jspec(spec):
    return jconfig.WindowSpec(**vars(spec))


def _emulation(n, coeffs, spec):
    """``csrc/fastwin_kernel.cu:sample`` at int64 indices ``n``, as int32."""
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    coeffs = fk.taylor2_params(coeffs, spec)
    n = (np.asarray(n, np.int64) & 0xFFFFFFFF).astype(np.uint32)
    rom = pf._rom_q(ls, w).astype(np.int64)
    s, p_hi, p_lo, rb = pf._phase_consts(pw, ls)
    pmask = np.uint32((1 << pw) - 1)
    acc = np.full(n.shape, coeffs[0] & 0xFFFFFFFF, np.uint32)
    for k in range(1, len(coeffs)):
        ph = (np.uint32(k) * n) & pmask  # wraps mod 2^32
        q = ph >> np.uint32(pw - 2)
        low = (ph & np.uint32((1 << (pw - 2)) - 1)).astype(np.int64)
        odd = (q & 1) == 1
        if rb <= 0:
            ent = rom[low << -rb]
            val = np.where(odd, ent[:, 1], ent[:, 0]).astype(np.uint32)
        else:
            ent = rom[low >> rb]
            acnt = low & ((1 << rb) - 1)
            d = acnt * p_hi
            assert d.max(initial=0) < 1 << 32
            if p_lo and rb + 12 <= 31:
                lo = acnt * p_lo
                assert lo.max(initial=0) < 1 << 32
                d = d + (lo >> 12)
            assert d.max(initial=0) < 1 << 32  # one uint32 word
            e = (d >> 15) ** 2
            a = np.where(odd, ent[:, 1], ent[:, 0])
            b = np.where(odd, ent[:, 0], ent[:, 1])
            assert a.min(initial=0) >= 0 and b.min(initial=0) >= 0
            p1 = d.astype(np.uint64) * b.astype(np.uint64)
            p2 = e.astype(np.uint64) * a.astype(np.uint64)
            assert max(int(p1.max(initial=0)), int(p2.max(initial=0))) < 1 << 62
            t1 = (p1 >> np.uint64(s)).astype(np.uint32)
            t2 = (p2 >> np.uint64(2 * s - 29)).astype(np.uint32)
            a32 = a.astype(np.uint32)
            val = np.where(odd, a32 + t1 - t2, a32 - t1 - t2)
        c = np.where(((q + np.uint32(1)) & np.uint32(2)) != 0, np.uint32(0) - val, val)
        m = ((np.int64(coeffs[k]) * c.view(np.int32).astype(np.int64)) >> (w - 2))
        m = (m & 0xFFFFFFFF).astype(np.uint32)
        acc = acc - m if k % 2 else acc + m
    v = acc.view(np.int32).astype(np.int64)
    if spec.overflow == "saturate" and w < 32:
        return np.clip(v, -(1 << (w - 1)), (1 << (w - 1)) - 1).astype(np.int32)
    v = v & ((1 << w) - 1)
    return np.where(v >= 1 << (w - 1), v - (1 << w), v).astype(np.int32)


def _walk_emulation(n0, count, coeffs, spec, crossings=None):
    """``csrc/fastwin_kernel.cu:taylor2_window_kernel`` in its run walk over
    [n0, n0 + count), as int32.  ``crossings``, a dict, gathers per harmonic
    the runs entered past the lane's first sample: "entry" within a quadrant,
    "quadrant" across a quadrant seam."""
    pw, w, ls = spec.phase_width, spec.data_width, spec.lut_size
    coeffs = fk.taylor2_params(coeffs, spec)
    regime = fk.walk_regime(pw, ls, len(coeffs))
    assert regime in ("walk", "walk_lo")
    use_lo = regime == "walk_lo"
    s, p_hi, p_lo, rb = pf._phase_consts(pw, ls)
    assert s >= 32
    rom = pf._rom_q(ls, w).astype(np.int64)
    M = 0xFFFFFFFF
    offsets = fk.WALK_OFFSETS
    warps = -(-count // 512)
    base = (np.arange(warps)[:, None] * 512 + 4 * np.arange(32)[None, :]).ravel()
    nl = (int(n0) + base) & M  # the lane's first sample, mod 2^32
    acc = np.full((len(base), len(offsets)), coeffs[0] & M, np.int64)

    thr = p_hi << rb
    assert thr < 1 << 32

    def enter(k, o, run, sel):
        n = (nl[sel] + o) & M
        ph = (k * n) & ((1 << pw) - 1)
        q, low = ph >> (pw - 2), ph & ((1 << (pw - 2)) - 1)
        ent, acnt = rom[low >> rb], low & ((1 << rb) - 1)
        odd = (q & 1) == 1
        run["a"][sel] = np.where(odd, ent[:, 1], ent[:, 0])
        run["b"][sel] = np.where(odd, ent[:, 0], ent[:, 1])
        run["s1"][sel] = np.where(odd, 1, M)
        run["ak"][sel] = np.where(((q + 1) & 2) != 0, -coeffs[k], coeffs[k])
        run["dhi"][sel] = acnt * p_hi
        run["lo"][sel] = acnt * p_lo if use_lo else 0
        run["acnt"][sel], run["o"][sel], run["q"][sel] = acnt, o, q

    def term(k, o, gap, run):
        acnt = run["acnt"] + k * (o - run["o"])  # the true residual count
        if gap:
            # d's parts step by the gap to the lane's previous sample, mod 2^32
            run["dhi"] = (run["dhi"] + gap * k * p_hi) & M
            if use_lo:
                run["lo"] = (run["lo"] + gap * k * p_lo) & M
            np.testing.assert_array_equal(run["dhi"], acnt * p_hi)  # below 2^32: no wrap
            cross = run["dhi"] >= thr
            np.testing.assert_array_equal(cross, acnt >= 1 << rb)
            if cross.any():
                q_before = run["q"][cross].copy()
                enter(k, o, run, cross)
                if crossings is not None:
                    seam = int((run["q"][cross] != q_before).sum())
                    crossings.setdefault(k, {"entry": 0, "quadrant": 0})
                    crossings[k]["quadrant"] += seam
                    crossings[k]["entry"] += int(cross.sum()) - seam
                acnt = run["acnt"] + k * (o - run["o"])
        # the reference's residual count of this sample
        ph = (k * ((nl + o) & M)) & ((1 << pw) - 1)
        np.testing.assert_array_equal(acnt, ph & ((1 << rb) - 1))
        d = run["dhi"]
        if use_lo:
            np.testing.assert_array_equal(run["lo"], acnt * p_lo)
            d = d + (run["lo"] >> 12)
        assert d.max(initial=0) < 1 << 32
        dh = d >> 15
        e = dh * dh
        a, b = run["a"].astype(np.uint64), run["b"].astype(np.uint64)
        # the high words of the 32 x 32 products, shifted: the floors of >> S
        t1 = (((d.astype(np.uint64) * b) >> np.uint64(32)) >> np.uint64(s - 32)).astype(np.int64)
        t2 = (((e.astype(np.uint64) * a) >> np.uint64(32)) >> np.uint64(2 * s - 61)).astype(
            np.int64)
        np.testing.assert_array_equal(t1, (d * run["b"]) >> s)
        val = (run["a"] - t2 + run["s1"] * t1) & M
        val = np.where(val >= 1 << 31, val - (1 << 32), val)
        assert np.abs(val).max(initial=0) < (1 << (w - 2)) + (1 << 28)  # the note's bound
        return ((run["ak"] * val) >> (w - 2)) & M

    def fresh(k):
        run = {f: np.zeros(len(base), np.int64) for f in ("a", "b", "s1", "ak", "dhi", "lo",
                                                          "acnt", "o", "q")}
        enter(k, 0, run, np.ones(len(base), bool))
        return run

    gaps = np.diff(offsets, prepend=0)
    k = 1
    while k + 1 < len(coeffs):  # two harmonics a pass
        r0, r1 = fresh(k), fresh(k + 1)
        for i, (o, gap) in enumerate(zip(offsets, gaps)):
            acc[:, i] = (acc[:, i] + term(k + 1, o, gap, r1) - term(k, o, gap, r0)) & M
        k += 2
    if k < len(coeffs):
        r0 = fresh(k)
        for i, (o, gap) in enumerate(zip(offsets, gaps)):
            acc[:, i] = (acc[:, i] - term(k, o, gap, r0)) & M
    v = np.where(acc >= 1 << 31, acc - (1 << 32), acc)
    if spec.overflow == "saturate" and w < 32:
        v = np.clip(v, -(1 << (w - 1)), (1 << (w - 1)) - 1)
    else:
        v = v & ((1 << w) - 1)
        v = np.where(v >= 1 << (w - 1), v - (1 << w), v)
    out = np.full(count, -1, np.int64)
    written = np.zeros(count, np.int64)
    at = base[:, None] + np.asarray(offsets)[None, :]
    keep = at < count
    out[at[keep]] = v[keep]
    np.add.at(written, at[keep], 1)
    assert np.all(written == 1)
    return out.astype(np.int32)


def _kernel_emulation(n0, count, coeffs, spec, crossings=None):
    """The kernel over [n0, n0 + count) in the form ``walk_regime`` picks."""
    q = fk.taylor2_params(coeffs, spec)
    if fk.walk_regime(spec.phase_width, spec.lut_size, len(q)) in ("walk", "walk_lo"):
        return _walk_emulation(n0, count, q, spec, crossings)
    return _emulation(np.arange(n0, n0 + count), q, spec)


def _indices(pw, count, seed):
    """Random indices of the period, the quadrant seams +-3 and, for
    harmonic k, the indices whose phase k*n sits at a seam of its own."""
    rng = np.random.default_rng(seed)
    big = 1 << pw
    seams = np.array([(b + d) % big for b in (0, big // 4, big // 2, 3 * big // 4)
                      for d in range(-3, 4)], np.int64)
    harm = np.concatenate([(seams + j * big) // k for k in (2, 3, 4, 6) for j in range(k)])
    return np.concatenate([rng.integers(0, min(big, 1 << 31), count), seams, harm % big])


def _check(name, spec, count=1500, seed=0):
    q = catalog.get(name).quantized(spec.data_width)
    n = _indices(spec.phase_width, count, seed)
    want = np.asarray(jf.window_values_fast(n, q, _jspec(spec)), np.int64)
    np.testing.assert_array_equal(_emulation(n, q, spec).astype(np.int64), want)
    got = pf.window_values_fast(torch.from_numpy(n), q, spec).numpy()
    np.testing.assert_array_equal(got, want)


class TestEmulation:
    @pytest.mark.parametrize("ls", [9, 10, 12, 14])
    @pytest.mark.parametrize("pw_rb", [-1, 0, 1, 5, 12, None])
    def test_phase_widths_vs_jax(self, ls, pw_rb):
        # PW = LS + 2 + rb: rb < 0 and rb == 0 are the ROM-only regime;
        # None is PW = 31
        pw = 31 if pw_rb is None else ls + 2 + pw_rb
        for w, overflow in ((32, "wrap"), (17, "saturate")):
            _check("bh7" if w == 32 else "bh4",
                   WindowSpec(pw, w, sin_type="taylor2", lut_size=ls, overflow=overflow),
                   seed=pw * ls + w)

    @pytest.mark.parametrize("pw,ls", [(30, 9), (31, 9), (31, 10)])
    def test_both_sides_of_the_p_lo_condition(self, pw, ls):
        # rb = 19 takes the P_lo term (rb + 12 <= 31), rb = 20 does not
        s, p_hi, p_lo, rb = pf._phase_consts(pw, ls)
        assert p_lo != 0 and rb in (19, 20)
        _check("bh7", WindowSpec(pw, 32, sin_type="taylor2", lut_size=ls, overflow="wrap"))

    @pytest.mark.parametrize("overflow", ["wrap", "saturate"])
    @pytest.mark.parametrize("w", [16, 17, 24, 32])
    def test_widths_vs_jax(self, w, overflow):
        for name in ("bh7", "bh4", "bh3"):
            _check(name, WindowSpec(26, w, sin_type="taylor2", lut_size=12, overflow=overflow),
                   seed=w)

    @pytest.mark.parametrize("name", catalog.names())
    def test_every_catalog_window(self, name):
        # the 2/3-term windows' a_0 reaches 2^30 at W = 32: both sides refuse
        for w in (16, 32):
            spec = WindowSpec(20, w, sin_type="taylor2", lut_size=10, overflow="wrap")
            q = catalog.get(name).quantized(w)
            if max(abs(c) for c in q) < 1 << 30:
                _check(name, spec, count=500)
                continue
            with pytest.raises(ValueError, match="2\\^30"):
                jf.window_values_fast(np.arange(4), q, _jspec(spec))
            with pytest.raises(ValueError, match="2\\^30"):
                fk.window_block(q, spec, 0, 4, device="cpu")

    def test_wrap_and_saturate_differ_below_w32(self):
        # coefficients that overflow W bits: saturate clamps, wrap wraps, both
        # as JAX does; at W = 32 the int32 accumulator is the output
        q = ((1 << 14) - 1,) * 3
        n = np.arange(1 << 12, dtype=np.int64)
        for w in (16, 32):
            outs = {}
            for overflow in ("wrap", "saturate"):
                spec = WindowSpec(12, w, sin_type="taylor2", lut_size=10, overflow=overflow)
                qq = q if w == 16 else ((1 << 30) - 1,) * 3
                want = np.asarray(jf.window_values_fast(n, qq, _jspec(spec)), np.int64)
                outs[overflow] = _emulation(n, qq, spec).astype(np.int64)
                np.testing.assert_array_equal(outs[overflow], want)
            same = np.array_equal(outs["wrap"], outs["saturate"])
            assert same == (w == 32)

    @pytest.mark.parametrize("ls", [9, 12])
    def test_pw32_vs_plain(self, ls):
        # the kernel takes PW = 32 (its phase product is 32-bit), where the
        # JAX function's int32 indices stop: held to the port's plain version
        spec = WindowSpec(32, 32, sin_type="taylor2", lut_size=ls, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        rng = np.random.default_rng(ls)
        n = np.concatenate([rng.integers(0, 1 << 32, 2000), [0, 1, 2**30 - 1, 2**30, 2**31,
                                                             2**32 - 1, 3 * 2**30 + 1]])
        got = fk.taylor2_window_plain(torch.from_numpy(n), q, spec).numpy()
        np.testing.assert_array_equal(_emulation(n, q, spec), got)

    def test_indices_past_2_32(self):
        # only n mod 2^32 reaches a phase (2^PW divides 2^32)
        spec = WindowSpec(24, 32, sin_type="taylor2", lut_size=12, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        n = np.arange(2**33 - 50, 2**33 + 50, dtype=np.int64)
        got = fk.taylor2_window_plain(torch.from_numpy(n), q, spec).numpy()
        np.testing.assert_array_equal(_emulation(n, q, spec), got)


def _walk_check(win, spec, n0, count, crossings=None):
    """The kernel's emulation over [n0, n0 + count) 0 LSB against the port's
    plain version and, where PW <= 31, JAX's ``window_values_fast`` at n mod
    2^PW (its indices are int32; the window's period is 2^PW)."""
    q = catalog.get(win).quantized(spec.data_width) if isinstance(win, str) else win
    got = _kernel_emulation(n0, count, q, spec, crossings)
    n = np.arange(n0, n0 + count, dtype=np.int64)
    plain = fk.taylor2_window_plain(torch.from_numpy(n), q, spec).numpy()
    np.testing.assert_array_equal(got, plain)
    if spec.phase_width <= 31:
        want = np.asarray(jf.window_values_fast(n % (1 << spec.phase_width), q, _jspec(spec)))
        np.testing.assert_array_equal(got, want)


class TestRunWalk:
    @pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
    def test_crossings_of_every_harmonic(self, k):
        # BH-7 W=32 LS=12 pw=26, the main path's window: blocks around the
        # samples where harmonic k's phase meets each quadrant seam and the
        # period end, where lanes enter a new ROM entry and quadrant mid-walk
        spec = WindowSpec(26, 32, sin_type="taylor2", lut_size=12, overflow="wrap")
        assert fk.walk_regime(26, 12, 7) == "walk_lo"
        seen = {}
        quarter = 1 << 24
        for j in range(1, 4 * k + 1):
            n0 = (j * quarter) // k - 700 + j  # not a multiple of 4, 16 or 512
            _walk_check("bh7", spec, n0, 1501, seen)
        _walk_check("bh7", spec, int(np.random.default_rng(k).integers(1 << 26)), 2048, seen)
        assert seen[k]["entry"] > 0 and seen[k]["quadrant"] > 0, seen

    @pytest.mark.parametrize("overflow", ["wrap", "saturate"])
    @pytest.mark.parametrize("w", [16, 17, 24, 32])
    def test_widths(self, w, overflow):
        spec = WindowSpec(26, w, sin_type="taylor2", lut_size=12, overflow=overflow)
        rng = np.random.default_rng(w)
        for win in ("bh7", "bh4", "bh3", "hann"):  # 6, 3, 2 and 1 harmonics: pairs and a single
            q = catalog.get(win).quantized(w)
            if max(abs(c) for c in q) >= 1 << 30:
                continue
            _walk_check(win, spec, int(rng.integers(1 << 26)), 1000 + w)

    @pytest.mark.parametrize("win,pw,ls,regime", [
        ("bh7", 30, 9, "walk_lo"), ("bh7", 31, 9, "walk"), ("bh7", 32, 10, "walk"),
        ("bh7", 24, 12, "walk_lo"), ("bh7", 26, 14, "walk_lo"), ("bh7", 26, 3, "walk"),
        ("bh7", 31, 14, "walk_lo"), ("hann", 21, 12, "walk_lo")])
    def test_both_sides_of_the_p_lo_condition_and_short_runs(self, win, pw, ls, regime):
        # rb = 19 takes the P_lo term, rb >= 20 does not; rb = 10 (BH-7) and
        # rb = 7 (Hann, one harmonic) leave several runs a lane; LS = 3 is
        # S = 32, a high word shifted by 0
        q = catalog.get(win).quantized(32 if win == "bh7" else 16)
        assert fk.walk_regime(pw, ls, len(q)) == regime
        spec = WindowSpec(pw, 32 if win == "bh7" else 16, sin_type="taylor2", lut_size=ls,
                          overflow="wrap")
        rng = np.random.default_rng(pw * ls)
        seen = {}
        for n0 in (0, int(rng.integers(1 << pw)), (1 << (pw - 2)) // 5 - 300):
            _walk_check(win, spec, n0, 1700, seen)
        if pw - 2 - ls <= 10:
            assert all(seen[k]["entry"] > 0 for k in range(1, len(q)))

    @pytest.mark.parametrize("ls", [9, 12, 14])
    def test_pw32_and_indices_past_2_32(self, ls):
        # PW = 32 against the plain version; n0 just below 2^32 (the lane's
        # n wraps mod 2^32 inside a warp) and past 2^33
        spec = WindowSpec(32, 32, sin_type="taylor2", lut_size=ls, overflow="wrap")
        for n0 in (2**32 - 700, 2**33 + 5, 3 * 2**30 - 255):
            _walk_check("bh7", spec, n0, 1400)
        spec = WindowSpec(26, 32, sin_type="taylor2", lut_size=ls, overflow="wrap")
        _walk_check("bh7", spec, 2**32 - 300, 700)
        _walk_check("bh7", spec, 2**33 + 2**25 - 3, 600)

    @pytest.mark.parametrize("count", [1, 3, 4, 5, 511, 512, 513, 4097])
    def test_ragged_counts(self, count):
        spec = WindowSpec(26, 32, sin_type="taylor2", lut_size=12, overflow="wrap")
        _walk_check("bh7", spec, 1 << 24, count)

    def test_regimes(self):
        # rb <= 0: ROM only; S < 32 (LS < 3), runs shorter than a lane's
        # widest gap or a run check past 2^32: each sample on its own; the
        # main path walks with the P_lo term
        assert fk.walk_regime(12, 12, 7) == fk.walk_regime(14, 12, 7) == "rom_only"
        assert fk.walk_regime(26, 2, 7) == "per_sample"
        assert fk.walk_regime(16, 12, 7) == fk.walk_regime(23, 12, 7) == "per_sample"
        assert fk.walk_regime(24, 12, 7) == "walk_lo"  # 2^10 >= 125 * 6
        assert fk.walk_regime(24, 12, 16) == "per_sample"
        assert fk.walk_regime(26, 12, 7) == "walk_lo"
        for pw in range(14, 33):
            for ls in (3, 9, 12, 14):
                for nt in (2, 7, 16):
                    _, p_hi, p_lo, rb = pf._phase_consts(pw, ls)
                    form = fk.walk_regime(pw, ls, nt)
                    if form.startswith("walk"):
                        assert (1 << rb) >= fk.MAX_GAP * (nt - 1) and ls >= 3
                        assert (form == "walk_lo") == (p_lo != 0 and rb + 12 <= 31)
                        reach = (1 << rb) - 1 + fk.MAX_GAP * (nt - 1)
                        assert reach * p_hi < 1 << 32 and (p_hi << rb) < 1 << 32
        assert fk.MAX_GAP == 125 and len(fk.WALK_OFFSETS) == 16

    def test_rom_only_and_per_sample_forms(self):
        # the forms the walk leaves to each sample: rb <= 0 and short runs
        for pw, ls in ((12, 12), (14, 12), (16, 12), (18, 12)):
            spec = WindowSpec(pw, 24, sin_type="taylor2", lut_size=ls, overflow="wrap")
            assert not fk.walk_regime(pw, ls, 4).startswith("walk")
            _walk_check("bh4", spec, 37, 900)


class TestWrapper:
    def test_cpu_block_is_the_plain_version(self, monkeypatch):
        def refuse():
            raise AssertionError("the kernel library was asked for on the CPU")

        monkeypatch.setattr(_build, "lib", refuse)
        spec = WindowSpec(14, 32, sin_type="taylor2", lut_size=12, overflow="wrap")
        q = catalog.get("bh7").quantized(32)
        n0 = (1 << 14) - 100  # across the period end
        got = fk.window_block(q, spec, n0, 300, device="cpu")
        assert got.dtype == torch.int32 and got.shape == (300,)
        n = np.arange(n0, n0 + 300, dtype=np.int64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf.window_values_fast(
            n, q, _jspec(spec))))
        assert fk.window_block(q, spec, 5, 0, device="cpu").shape == (0,)

    def test_card_is_asked_for_never_the_cpu(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        spec = WindowSpec(12, 32, sin_type="taylor2", lut_size=12, overflow="wrap")
        with pytest.raises(RuntimeError, match="CUDA device was asked for"):
            fk.window_block(catalog.get("bh7").quantized(32), spec, 0, 64)

    def test_guards(self):
        q = catalog.get("bh4").quantized(24)
        with pytest.raises(NotImplementedError):
            fk.window_block(q, WindowSpec(12, 24, sin_type="taylor2", rounding="rtl"), 0, 4,
                            device="cpu")
        with pytest.raises(ValueError, match="2\\^30"):
            fk.window_block((1 << 30, 1), WindowSpec(12, 32, sin_type="taylor2"), 0, 4,
                            device="cpu")
        with pytest.raises(ValueError, match="at most 16 terms"):
            fk.window_block((1,) * 17, WindowSpec(12, 24, sin_type="taylor2"), 0, 4,
                            device="cpu")
        with pytest.raises(ValueError, match="phase_width 2..32"):
            fk.window_block(q, WindowSpec(33, 24, sin_type="taylor2"), 0, 4, device="cpu")


class TestRouting:
    """Every taylor2 route calls ``fastwin_kernel.window_block`` with the
    device it was given: the kernel for a card, the plain version on the
    CPU (that wrapper's own dispatch, tested above)."""

    SPEC = WindowSpec(12, 32, sin_type="taylor2", lut_size=10, overflow="wrap")

    @pytest.fixture
    def calls(self, monkeypatch):
        seen = []

        def spy(coeffs_q, spec, n0, count, device=None):
            seen.append((int(n0), int(count), None if device is None else str(device)))
            return fk.taylor2_window_plain(torch.arange(n0, n0 + count), coeffs_q, spec)

        monkeypatch.setattr(fk, "window_block", spy)
        return seen

    def test_window_block_and_make_window(self, calls):
        q = catalog.get("bh7").quantized(32)
        a = kw.window_block(10, 100, q, self.SPEC, device="cuda")
        b = kw.make_window("bh7", self.SPEC, device="cpu")
        assert calls == [(10, 100, "cuda"), (0, 1 << 12, "cpu")]
        np.testing.assert_array_equal(a.numpy(), b.numpy()[10:110])

    def test_sharded_range_fn(self, calls):
        q = catalog.get("bh7").quantized(32)
        gen = generate._range_fn(q, self.SPEC, 7, 256)
        blocks = [gen(i, "cuda") for i in range(3)]
        assert calls == [(7 + 256 * i, 256, "cuda") for i in range(3)]
        whole = kw.window_block(7, 768, q, self.SPEC, device="cpu")
        np.testing.assert_array_equal(torch.cat(blocks).numpy(), whole.numpy())

    def test_cli_gen(self, calls, monkeypatch, tmp_path):
        from blackman_harris_win_tpu_torch.__main__ import main

        args = ["gen", "bh7", "--phase-width", "12", "--data-width", "32", "--mode", "taylor2",
                "--lut-size", "10", "--overflow", "wrap"]
        assert main(args + ["--out", str(tmp_path / "cpu.npy"), "--device", "cpu"]) == 0
        monkeypatch.setattr(_build, "resolve_device", lambda d=None: torch.device("cuda", 0))
        assert main(args + ["--out", str(tmp_path / "card.npy")]) == 0
        assert calls == [(0, 1 << 12, "cpu"), (0, 1 << 12, "cuda:0")]
        np.testing.assert_array_equal(np.load(tmp_path / "card.npy"),
                                      np.load(tmp_path / "cpu.npy"))
