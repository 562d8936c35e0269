"""The port stands alone and runs on the GPU only when asked: it imports no
JAX and nothing of airpose_tpu, and its entry points raise without CUDA
instead of falling back to the CPU."""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import airpose_tpu_torch
from airpose_tpu_torch import resolve_device
from airpose_tpu_torch.config import TrainConfig
from airpose_tpu_torch.data import batch_slice
from airpose_tpu_torch.entry import entry
from airpose_tpu_torch.eval import compile_results, figures
from airpose_tpu_torch.ops import _build
from airpose_tpu_torch.perception import bench_inputs, build_perception
from airpose_tpu_torch.models import family_init_args, mean_init_state
from airpose_tpu_torch.train import (make_real_singleview_step_fns, make_real_twoview_step_fns,
                                     make_singleview_step_fns, make_twoview_step_fns)

bundle_adjust = importlib.import_module("airpose_tpu_torch.optim.bundle_adjust")
ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "airpose_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')"
        " or m == 'airpose_tpu' or m.startswith('airpose_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_data_and_trainer_import_neither_jax_nor_cv2():
    """The readers import OpenCV only to decode images (and the DJI reader
    to read its calib yml) and h5py only to read H36M's cameras, so the
    trainer starts where neither is installed."""
    code = (
        "import sys\n"
        "import airpose_tpu_torch.data, airpose_tpu_torch.train.trainer\n"
        "import airpose_tpu_torch.data.real, airpose_tpu_torch.data.aircap\n"
        "import airpose_tpu_torch.data.fake_real, airpose_tpu_torch.bodymodel.vposer\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',"
        " 'h5py', 'airpose_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "airpose_tpu"), f"{path}: {n}"


def test_tf32_is_off():
    assert airpose_tpu_torch is not None
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for fn in (resolve_device, build_perception, entry, lambda: bench_inputs(2),
               lambda: resolve_device("cuda"), lambda: batch_slice({}, 0, 1),
               lambda: make_twoview_step_fns(None, None, TrainConfig(), None),
               lambda: make_singleview_step_fns(None, None, TrainConfig(), None, "hmr"),
               lambda: make_real_twoview_step_fns(None, None, None, TrainConfig(), None),
               lambda: make_real_singleview_step_fns(None, None, None, TrainConfig(), None),
               lambda: family_init_args("hmr"), mean_init_state,
               lambda: compile_results.compile_twoview(None, None, None, [], TrainConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    assert resolve_device("cpu") == torch.device("cpu")


def test_eval_and_airpose_plus_clis_raise_without_cuda(tmp_path):
    """The eval CLI, AirPose+ and the figures take the card unless given
    --platform cpu: without CUDA each raises before it reads any input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    missing = str(tmp_path / "missing")
    for main, argv in (
            (compile_results.main, ["--datapath", "synthetic://2", "--out", missing]),
            (bundle_adjust.main, ["--datapath", f"real://{missing}", "--airpose-pkl", missing,
                                  "--out", missing]),
            (figures.main, ["--results", f"a={missing}", "--out", missing])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not (tmp_path / "missing").exists()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
