"""PyTorch port, ``dist.dryrun.dryrun_multichip``: the eight stages of the
JAX package's ``__graft_entry__.dryrun_multichip`` (the same sizes and
budgets) on 1, 2 and 4 CPU shards, and no silent CPU run without a card."""

import pytest
import torch

from blackman_harris_win_tpu_torch.dist.dryrun import dryrun_multichip


@pytest.mark.parametrize("n", [1, 2, 4])
def test_eight_stages_pass(n, capsys):
    dryrun_multichip(n, devices=["cpu"] * n)
    out = capsys.readouterr().out
    assert f"dryrun_multichip OK on {n} shards" in out
    assert out.count("stage ") == 9  # 1, 2, 2b, 2c, 3, 4, 5, 6, 7


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is built on it")
    with pytest.raises(ValueError, match="need 2 devices, have 0"):
        dryrun_multichip(2)
