"""The import check: JAX and the JAX package are caught by whole top-level
name, the program is not mistaken for the JAX package, and the reference
imports neither them nor the program."""

import subprocess
import sys

from benchmark import imports


def test_whole_top_level_names():
    assert imports.forbidden(["airpose_tpu_torch", "airpose_tpu_torch.ops"]) == []
    assert imports.forbidden(["airpose_tpu", "airpose_tpu.models"]) == [
        "airpose_tpu", "airpose_tpu.models"]
    assert imports.forbidden(["jax.numpy", "jaxlib", "flax.linen", "optax", "jaxtyping"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "optax"]


def test_reference_imports_nothing_forbidden():
    names = imports.reference_imports()
    assert "torch" in names
    assert imports.reference_forbidden() == []


def test_reference_check_catches_the_program(tmp_path):
    (tmp_path / "bad.py").write_text("import airpose_tpu_torch.perception\nfrom jax import numpy\n")
    names = imports.reference_imports(tmp_path)
    assert imports.forbidden(names, also=(imports.PROGRAM,)) == [
        "airpose_tpu_torch.perception", "jax"]


def test_a_run_loads_no_jax():
    """Importing every driver and what it imports of the program loads no
    JAX, in a fresh interpreter."""
    code = ("import benchmark.drivers.perceive, benchmark.drivers.train, benchmark.harness\n"
            "import airpose_tpu_torch.perception, airpose_tpu_torch.train.loop\n"
            "from benchmark import imports\n"
            "print(imports.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(imports.REFERENCE_DIR.parents[1]), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_cuda_no_result():
    """Without the CUDA devices a cell asks for, the run exits non-zero and
    prints no result line."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "perceive_int8_b64", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True,
                         cwd=str(imports.REFERENCE_DIR.parents[1]), timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
