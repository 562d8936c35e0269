"""Builds the CUDA kernels from ``airpose_tpu_torch/csrc/*.cu`` and loads them.

Each source is compiled by its own ``nvcc`` process (all started together)
into a shared library with a plain C interface, for ``sm_90a``, and loaded
with ``ctypes``. No source includes PyTorch's headers, so a build takes
seconds. Every C entry point takes its pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception.

Libraries go to ``build/kernels/`` at the repository root, named by a hash
of the source and the flags, and are built at first use, never when a
module is imported. Threads of one process build and load under one lock,
and each names its temporary file by process and thread, so two servers'
executor threads that launch their first kernels at once run one build.

Every launch of a hand-written kernel goes through ``launch``, which holds
the contract in one place:

- The kernel runs on the current stream of its tensors' device. Served
  rounds are captured as CUDA graphs on a stream of their own, and a launch
  on any other stream would escape the capture.
- The stream is the raw handle from ``torch._C._cuda_getCurrentRawStream``,
  and the device guard is entered only when that device is not already
  current: the int8 trunk makes 52 launches a call while its later layers
  wait on the host, and a ``Stream`` object and a guard cost host time on
  each.
- A non-zero CUDA error code raises.
- Each launch adds one to ``counts`` under the C library's name
  (``lbs_skinning``, ``fused_stage1``, ``int8_conv``, ``int8_stem``,
  ``add_layernorm``). The count is taken on the host, at eager calls and at
  graph capture, never at a replay. ``counts`` also holds ``int8_block``
  (block calls that launched) and ``quantize_act`` (the int8 trunk's
  quantizations in torch); callers read ``counts[name]`` and reset with
  ``counts.clear()``.

``check_tensor`` is the wrappers' one test of a kernel's tensor operands,
made before a wrapper allocates its outputs or launches.
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs = {}       # source stem -> loaded ctypes.CDLL
_functions = {}  # (source stem, C name) -> typed ctypes function
build_log = {}   # source stem -> nvcc's stderr (ptxas registers / shared memory)
_lock = threading.RLock()  # build_all and function's first use
counts = collections.Counter()  # launches (and counted calls) by name since the last clear
_count_lock = threading.Lock()  # a read, add and write from two threads could lose a count


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with "
            "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def build_all() -> float:
    """Compile and load every ``csrc/*.cu`` not loaded yet; returns seconds."""
    with _lock:
        return _build_all()


def _build_all() -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {}
    for src in sorted(CSRC.glob("*.cu")):
        if src.stem in _libs:
            continue
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        targets[src.stem] = (src, BUILD_DIR / f"{src.stem}-{digest}.so")

    procs = {}
    for name, (src, so) in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{out}{err}")
        else:
            os.replace(tmp, targets[name][1])
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, (_, so) in targets.items():
        _libs[name] = ctypes.CDLL(str(so))
    return time.perf_counter() - t0


def function(lib: str, name: str, n_ptr: int, n_int: int, n_float: int = 0,
             stream: bool = True):
    """The C function ``name`` of ``csrc/<lib>.cu``, typed as ``n_ptr``
    pointers, then ``n_int`` ints, then ``n_float`` floats, then the stream
    (unless ``stream`` is false); returns a CUDA error code. Typed once and
    cached: the wrappers call this on every launch."""
    key = (lib, name)
    fn = _functions.get(key)
    if fn is None:
        with _lock:
            fn = _functions.get(key)
            if fn is None:
                if lib not in _libs:
                    build_all()
                fn = _libs[lib][name]
                fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                               + [ctypes.c_float] * n_float
                               + ([ctypes.c_void_p] if stream else []))
                fn.restype = ctypes.c_int
                _functions[key] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def count(what: str) -> None:
    """Add one to ``counts[what]``."""
    with _count_lock:
        counts[what] += 1


def launch(fn, args, device: torch.device, what: str) -> None:
    """``fn(*args, stream)`` on ``device``'s current stream, then ``check``
    its error code and count one launch under ``what``."""
    dev = device.index
    if dev == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    check(err, what)
    count(what)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_tensor(who: str, name: str, t: torch.Tensor, device: torch.device,
                 dtype: torch.dtype, shape, align: int = 0) -> None:
    """Raise ``ValueError``, naming ``who`` and the operand ``name``, unless
    ``t`` is on ``device``, of ``dtype`` and ``shape`` (a tuple), contiguous
    and, with ``align``, starts at a multiple of ``align`` bytes."""
    if t.device != device:
        raise ValueError(f"{who}: {name} is on {t.device}, all inputs must be on one CUDA "
                         f"device ({device})")
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{who}: {name} is {_dtype_name(t.dtype)} {tuple(t.shape)}, "
                         f"expected {_dtype_name(dtype)} {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} is not contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{who}: {name} is not {align}-byte aligned")
