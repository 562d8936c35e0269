"""The port stands alone and runs on the GPU only when asked: it imports no
JAX and nothing of airpose_tpu, and its entry points raise without CUDA
instead of falling back to the CPU."""

import ast
import importlib
import re
import subprocess
import sys
import threading
import types
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
from airpose_tpu_torch.ops import int8_trunk
from airpose_tpu_torch.serve import benchtest, lagone, server, viz
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


def test_serve_imports_neither_jax_nor_cv2():
    """The serving package imports OpenCV only where viz writes a PNG and
    the native ROI replay reads a frame."""
    code = (
        "import sys\n"
        "import airpose_tpu_torch.serve, airpose_tpu_torch.serve.server\n"
        "import airpose_tpu_torch.serve.benchtest, airpose_tpu_torch.serve.lagone\n"
        "import airpose_tpu_torch.serve.viz\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',"
        " 'matplotlib', 'airpose_tpu')]\n"
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


def test_serving_clis_raise_without_cuda(tmp_path):
    """The server, the benchtest, lagone and viz take the card unless given
    --platform cpu: without CUDA each raises before it reads any input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    missing = str(tmp_path / "missing")
    for main, argv in (
            (server.main, ["--port", "1", "--robot-id", "1", "--random-init"]),
            (benchtest.main, ["--datapath", f"real://{missing}", "--random-init"]),
            (lagone.main, ["--datapath", f"real://{missing}", "--random-init"]),
            (viz.main, ["--wire", missing, "--out", missing])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not (tmp_path / "missing").exists()


def test_tools_import_neither_jax_cv2_nor_h5py():
    """The tools and the profiling utilities import OpenCV, h5py and
    matplotlib only inside the functions that use them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import airpose_tpu_torch.tools, airpose_tpu_torch.utils.profiling\n"
        "for m in pkgutil.iter_modules(airpose_tpu_torch.tools.__path__):\n"
        "    importlib.import_module('airpose_tpu_torch.tools.' + m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2',"
        " 'h5py', 'matplotlib', 'airpose_tpu')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_tool_clis_raise_without_cuda(tmp_path):
    """create_aerialpeople, the dress rehearsal, train_roofline,
    qat_posture and to_hdf5 take the card unless given --platform cpu
    (device="cpu"): without CUDA each raises before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from airpose_tpu_torch.tools import (create_aerialpeople, dress_rehearsal, qat_posture,
                                         to_hdf5, train_roofline)

    missing = str(tmp_path / "missing")
    for main, argv in (
            (create_aerialpeople.main, ["--out", missing]),
            (dress_rehearsal.main, ["--workdir", missing]),
            (train_roofline.main, ["--batch", "1", "--img", "32"]),
            (qat_posture.main, []),
            (to_hdf5.main, ["--datapath", missing, "--out", missing])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert not (tmp_path / "missing").exists()


FAKE_NVCC = """#!/bin/sh
# records its output path, takes a moment, writes a stand-in library
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "$out" >> "{log}"
sleep 0.3
echo lib > "$out"
"""


def test_kernel_build_from_two_threads_runs_once(monkeypatch, tmp_path):
    """Two threads (two in-process servers' executor threads) reach the
    kernels' first use together: one nvcc per source, each writing a
    temporary file named by process and thread, and both threads get the
    same typed function."""
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(nvcc.parent))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getitem__(self, name):
            return types.SimpleNamespace(name=name)

    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    barrier = threading.Barrier(2)
    got, errors = [None, None], []

    def first_use(i):
        try:
            barrier.wait(timeout=10)
            got[i] = _build.function("lbs_skinning", "airpose_lbs_skinning", 4, 3)
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=first_use, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got[0] is got[1] and got[0].name == "airpose_lbs_skinning"
    outs = log.read_text().split()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert len(outs) == len(sources)  # one build of each source
    for out in outs:
        assert re.search(r"-[0-9a-f]{16}\.\d+\.\d+\.tmp$", out), out
    assert sorted(p.name.split("-")[0] for p in (tmp_path / "kernels").iterdir()) == sources
    assert sorted(_build._libs) == sources


def test_launch_counters_lose_no_update():
    """Counted calls from many threads at once, switching often, all count:
    int8_trunk.quantize_calls, incremented under the kernels' counter lock."""
    x = torch.ones(1, 2, 2, 1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        int8_trunk.quantize_calls = 0

        def work():
            for _ in range(200):
                int8_trunk._quantize_act(x)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert int8_trunk.quantize_calls == 16 * 200
    finally:
        sys.setswitchinterval(interval)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_multi_device_cluster_parity_and_stem_modules_import_no_jax():
    """The modules that completed the port (parallel/, utils/cluster.py,
    tools/parity_run.py, ops/int8_stem.py) import neither JAX nor
    airpose_tpu."""
    code = (
        "import sys\n"
        "import airpose_tpu_torch.parallel, airpose_tpu_torch.parallel.launch\n"
        "import airpose_tpu_torch.utils.cluster, airpose_tpu_torch.tools.parity_run\n"
        "import airpose_tpu_torch.ops.int8_stem, airpose_tpu_torch.entry\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')"
        " or m == 'airpose_tpu' or m.startswith('airpose_tpu.')]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_parity_run_and_multichip_dryrun_raise_without_cuda(tmp_path):
    """parity_run and dryrun_multichip take the card unless asked for the
    CPU: without CUDA each raises before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from airpose_tpu_torch.entry import dryrun_multichip
    from airpose_tpu_torch.tools import parity_run

    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="CUDA"):
        parity_run.main(["--torch-ckpt", missing, "--precalc", missing, "--datapath", missing,
                         "--workdir", missing])
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1)
    assert not (tmp_path / "missing").exists()
