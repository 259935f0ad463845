"""The run's guards: no JAX, the card or nothing, the program from the
checkout or nothing."""

import json
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness, layout
from portbench.tests import tiny


@pytest.mark.parametrize("names,found", [
    (["torch", "numpy.linalg", "blackman_harris_win_tpu_torch.kernels"], []),
    (["jax"], ["jax"]), (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]), (["jaxtyping", "flaxish", "jax_utils"], []),
    (["blackman_harris_win_tpu.core.config"], ["blackman_harris_win_tpu"]),
    (["blackman_harris_win_tpu_torch", "blackman_harris_win_tpu"], ["blackman_harris_win_tpu"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert harness.forbidden_modules(names) == found


def test_the_port_and_the_harness_load_no_jax():
    code = ("import sys; from portbench import harness, layout, tracing, traffic, roofline; "
            "import portbench.reference.window, portbench.reference.welch; "
            "import blackman_harris_win_tpu_torch.kernels.window, "
            "blackman_harris_win_tpu_torch.pipeline.spectral; "
            "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=layout.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_exits_without_a_card_and_prints_nothing():
    """This machine's torch sees no CUDA device."""
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", tiny.GEN,
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=layout.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_exits_where_only_the_benchmark_is(tmp_path):
    """A folder with BENCHMARK.json and the benchmark's files alone: the
    program is not there, and one found elsewhere is refused."""
    root = tmp_path / "bare"
    shutil.copytree(layout.ROOT / "portbench", root / "portbench")
    shutil.copy(layout.ROOT / "BENCHMARK.json", root)
    code, out = harness.run(["--workload", tiny.GEN, "--seed", "1", "--seconds", "0.1"],
                            time.perf_counter(), root=root, device="cpu")
    assert code != 0 and out is None


def test_unknown_workload():
    code, out = harness.run(["--workload", "nope.none", "--seed", "1", "--seconds", "1"],
                            time.perf_counter(), device="cpu")
    assert code == 2 and out is None


def test_result_line_keys(tmp_path):
    root = tiny.make_root(tmp_path)
    code, out = tiny.run(root, tiny.GEN)
    assert code == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"}
    json.dumps(out)
    code, out = tiny.run(root, tiny.GEN, trace=1)
    assert list(out)[-1] == "checks" and "breakdown" in out
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
