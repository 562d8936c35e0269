"""Where the skinning kernel's time goes, on one CUDA device.

  python -m airpose_tpu_torch.profile_skinning

Builds ``csrc/lbs_skinning.cu`` five times, with the source's LBS_ABLATE
bits switching phases off (0: the kernel as the package builds it; 1: no
shared loads in the inner loop, its operands made from the loop counter;
2: no staging after each block's first chunk; 4: no p copies and no output
stores; 7: all three, the bare FFMA loop with its bookkeeping), and times
each build at the main path's B = 128 bodies and the training batch B = 60
(V = 10475, J = 55) with CUDA events. Only build 0 computes skinning; the
others show what each phase costs. Prints one JSON line with each build's
registers and milliseconds, the f32 FMA bound, the card's name and power
limit, and for each instantiation of the kernel as built the share of its
FFMAs whose two source registers outside the operand reuse cache share a
register bank (register number mod 2, read from ``cuobjdump -sass``), which
delays the FFMA's operand reads.
"""

import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from .bodymodel import cuda_lbs, synthetic_smplx_params
from .ops import _build

ABLATIONS = {0: "kernel", 1: "no inner-loop shared loads", 2: "no staging after the first chunk",
             4: "no p copies or output stores", 7: "bare FFMA loop"}
F32_FLOP_PER_S = 67e12  # H100 SXM CUDA cores at 700 W (NVIDIA data sheet)
V, J = 10475, 55


def build(bits):
    """Start nvcc on the source with LBS_ABLATE = bits; returns (process, .so)."""
    src = _build.CSRC / "lbs_skinning.cu"
    so = _build.BUILD_DIR / f"lbs_skinning-ablate{bits}.so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-DLBS_ABLATE={bits}",
                             "-o", str(so), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, so


def bank_conflicts():
    """{kernel instantiation: "n/m"}: FFMAs with a register-bank conflict
    among the m FFMAs of the kernel's SASS."""
    cubin = _build.BUILD_DIR / "lbs_skinning-profile.cubin"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-cubin", "-o", str(cubin), str(_build.CSRC / "lbs_skinning.cu")],
                   check=True, capture_output=True)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"skinning_kernelILi(\d+)E", part.split("\n", 1)[0])
        ffmas = re.findall(r"FFMA R\d+, (R\d+\S*), (R\d+\S*), (R\d+\S*) ;", part)
        n = 0
        for ops in ffmas:
            banks = [int(o[1:].split(".")[0]) % 2 for o in ops if not o.endswith(".reuse")]
            n += len(banks) != len(set(banks))
        if name:
            out[f"KJ={name.group(1)}"] = f"{n}/{len(ffmas)}"
    return out


def time_ms(fn, iters=100, warmup=10):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_skinning: no CUDA device")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {bits: build(bits) for bits in ABLATIONS}
    fns, regs = {}, {}
    for bits, (proc, so) in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed with LBS_ABLATE={bits}:\n{out}{err}")
        regs[bits] = [int(r) for r in re.findall(r"Used (\d+) registers", out + err)]
        fn = ctypes.CDLL(str(so)).airpose_lbs_skinning
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[bits] = fn

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    w = synthetic_smplx_params().lbs_weights.to(dev)
    rel = rng.normal(size=(128, J, 4, 4)).astype(np.float32) * 0.3
    rel[:, :, 3] = [0, 0, 0, 1]
    a = torch.from_numpy(rel).to(dev)
    p = torch.from_numpy(rng.normal(size=(128, V, 3)).astype(np.float32)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for B in (128, 60):
        ab, pb = a[:B], p[:B]
        out = torch.empty_like(pb)

        def run(fn):
            _build.check(fn(w.data_ptr(), ab.data_ptr(), pb.data_ptr(), out.data_ptr(),
                            B, V, J, stream), "lbs_skinning ablation")

        run(fns[0])
        torch.cuda.synchronize()
        err = (out - cuda_lbs.skinning_reference(w, ab, pb)).abs().max().item()
        flops = B * V * (J * 12 * 2 + 18)
        # builds in turns, twice, so that a drift of the clock shows
        ms = {bits: [] for bits in fns}
        for _ in range(2):
            for bits, fn in fns.items():
                ms[bits].append(time_ms(lambda: run(fn)))
        result[f"B={B}"] = {"max_abs_err_of_kernel": err,
                            "bound_ms": flops / F32_FLOP_PER_S * 1e3,
                            "ms": {ABLATIONS[b]: v for b, v in ms.items()}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    print(json.dumps({"device": smi[:1], "V": V, "J": J,
                      "registers": {ABLATIONS[b]: r for b, r in regs.items()},
                      "ffma_bank_conflicts": bank_conflicts(), **result}))


if __name__ == "__main__":
    main()
