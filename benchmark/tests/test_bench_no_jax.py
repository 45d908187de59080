"""No run loads jax, jaxlib, flax or the JAX package deepvcp_tpu, compared
by whole top-level names (the port's name starts with the JAX package's)."""

import subprocess
import sys

from benchmark import manifest, run


def test_whole_top_level_names():
    assert run.forbidden_modules({"deepvcp_tpu_torch": 0, "deepvcp_tpu_torch.ops": 0,
                                  "jaxtyping": 0, "flaxen.x": 0}) == []
    assert run.forbidden_modules({"deepvcp_tpu.ops.knn": 0, "jaxlib.xla_client": 0,
                                  "jax": 0, "flax.linen": 0}) == ["deepvcp_tpu", "flax", "jax",
                                                                  "jaxlib"]


def test_harness_and_port_import_no_jax():
    """Every module of the benchmark and the port's modules that a run
    imports, in a fresh interpreter: none of the forbidden names loads."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark import check, drive, generate, manifest, record, system, trace, work\n"
        "from benchmark.reference import deepvcp\n"
        "import deepvcp_tpu_torch.registration, deepvcp_tpu_torch.models\n"
        "print(benchmark.run.forbidden_modules())\n" % str(manifest.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    """main() checks sys.modules itself before it prints a result."""
    monkeypatch.setitem(sys.modules, "deepvcp_tpu.fake", object())
    assert "deepvcp_tpu" in run.forbidden_modules()
