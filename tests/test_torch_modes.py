"""PyTorch port, the generation-mode advisor: ``recommend_mode`` picks the
JAX package's mode for every window, consumer, exactness and target, with
the same errors; ``MODE_GSPS`` has the JAX table's keys (its values are the
card's own, not asserted here) and no rationale states a TPU figure."""

import pytest

from blackman_harris_win_tpu.windows import modes as jmodes
from blackman_harris_win_tpu_torch.windows import catalog, modes

CONSUMERS = ("float", "int")
EXACTNESS = ("bit-exact", "floor")


def test_mode_table_keys():
    assert set(modes.MODE_GSPS) == set(jmodes.MODE_GSPS)
    assert all(v > 0 for v in modes.MODE_GSPS.values())


@pytest.mark.parametrize("name", catalog.names())
@pytest.mark.parametrize("target", [None, -40.0, -100.0, -160.0, -170.0])
def test_same_mode_as_jax(name, target):
    for consumer in CONSUMERS:
        for exactness in EXACTNESS:
            got = modes.recommend_mode(name, consumer, exactness, target)
            want = jmodes.recommend_mode(name, consumer, exactness, target)
            assert got.mode == want.mode, (name, consumer, exactness, target)
            assert got.est_gsamp_s == modes.MODE_GSPS[got.mode]
            assert "TPU" not in got.rationale and "v5e" not in got.rationale


@pytest.mark.parametrize("coeffs", [(0.5, 0.5), (0.4, 0.5, 0.1), (0.3, 0.4, 0.2, 0.1),
                                    (0.3, 0.3, 0.2, 0.1, 0.05, 0.04, 0.01)])
def test_coefficient_tuples(coeffs):
    for consumer in CONSUMERS:
        for exactness in EXACTNESS:
            assert (modes.recommend_mode(coeffs, consumer, exactness).mode
                    == jmodes.recommend_mode(coeffs, consumer, exactness).mode)


def test_taylor_rationale_states_the_card_ratio():
    r = modes.recommend_mode("hamming", consumer="int", exactness="bit-exact")
    ratio = modes.MODE_GSPS["taylor"] / modes.MODE_GSPS["exact"]
    assert r.mode == "taylor" and f"{ratio:.0f}x" in r.rationale and "H100" in r.rationale


@pytest.mark.parametrize("kwargs", [{"consumer": "complex"}, {"exactness": "close"}])
def test_bad_args(kwargs):
    with pytest.raises(ValueError) as ej:
        jmodes.recommend_mode("bh4", **kwargs)
    with pytest.raises(ValueError) as ep:
        modes.recommend_mode("bh4", **kwargs)
    assert str(ep.value) == str(ej.value)


def test_unknown_window():
    with pytest.raises(KeyError, match="available"):
        modes.recommend_mode("nosuchwin")
