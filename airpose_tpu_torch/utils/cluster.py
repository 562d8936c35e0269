"""Cluster job submission with checkpoint-requeue fault tolerance (port of
airpose_tpu/utils/cluster.py).

Replaces the reference's HTCondor `is_cluster_mixedmap.mixedmap` (ref
copenet/src/copenet/is_cluster_mixedmap.py:44-201): pickle a function +
args to a job dir, generate a submit script, submit, and requeue jobs that
exit with the checkpoint code 3 (the contract `train/elastic.py` and the
trainer's --time_to_run implement on the worker side; ref
is_cluster_mixedmap.py:56-59 `on_exit_hold = (ExitCode =?= 3)` +
periodic_release).

Backends: "local" (subprocess, for tests/dev), "slurm" and "condor"
(script generation + sbatch/condor_submit). The job payload re-execs
`python -m airpose_tpu_torch.utils.cluster --run <jobdir>`; the local
backend puts this package's parent directory on the subprocess's
PYTHONPATH, so the job finds the package from any working directory.
"""

import argparse
import os
import pickle
import subprocess
import sys
import textwrap
from typing import Any, Callable, Dict, Optional, Sequence

CHECKPOINT_EXIT_CODE = 3  # the code train/elastic.py's DeadlineGuard exits with
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write_job(jobdir: str, func: Callable, args: Sequence[Any],
              kwargs: Optional[Dict] = None):
    os.makedirs(jobdir, exist_ok=True)
    # Record the submitter's sys.path so the worker can unpickle functions
    # from modules that are importable only via it (the reference marshals
    # func.__code__ instead — same need, ref is_cluster_mixedmap.py:117-140).
    with open(os.path.join(jobdir, "payload.pkl"), "wb") as f:
        pickle.dump({"sys_path": list(sys.path)}, f)
        pickle.dump({"func": func, "args": list(args), "kwargs": kwargs or {}}, f)


def run_job(jobdir: str) -> int:
    with open(os.path.join(jobdir, "payload.pkl"), "rb") as f:
        env = pickle.load(f)
        for p in env.get("sys_path", []):
            if p not in sys.path:
                sys.path.append(p)
        payload = pickle.load(f)
    result = payload["func"](*payload["args"], **payload["kwargs"])
    with open(os.path.join(jobdir, "result.pkl"), "wb") as f:
        pickle.dump(result, f)
    return 0


def slurm_script(jobdir: str, gpus: int = 0, mem_gb: int = 16,
                 time_limit: str = "24:00:00", python: str = sys.executable) -> str:
    """sbatch script with self-requeue on exit code 3."""
    return textwrap.dedent(f"""\
        #!/bin/bash
        #SBATCH --job-name=airpose
        #SBATCH --mem={mem_gb}G
        #SBATCH --time={time_limit}
        #SBATCH --requeue
        {f'#SBATCH --gres=gpu:{gpus}' if gpus else ''}
        {python} -m airpose_tpu_torch.utils.cluster --run {jobdir}
        code=$?
        if [ $code -eq {CHECKPOINT_EXIT_CODE} ]; then
          scontrol requeue $SLURM_JOB_ID
        fi
        exit $code
        """)


def condor_submit_file(jobdir: str, mem_mb: int = 15000, gpus: int = 1,
                       python: str = sys.executable) -> str:
    """HTCondor submit file with the reference's hold/release requeue cycle
    (ref is_cluster_mixedmap.py:44-61)."""
    return textwrap.dedent(f"""\
        executable = {python}
        arguments = -m airpose_tpu_torch.utils.cluster --run {jobdir}
        request_memory = {mem_mb}
        request_gpus = {gpus}
        on_exit_hold = (ExitCode =?= {CHECKPOINT_EXIT_CODE})
        on_exit_hold_reason = "checkpointed, to be resumed"
        periodic_release = ( (JobStatus =?= 5) && (HoldReasonCode =?= 3) )
        log = {jobdir}/condor.log
        output = {jobdir}/condor.out
        error = {jobdir}/condor.err
        queue
        """)


def submit_local(jobdir: str, max_requeues: int = 10) -> int:
    """Run the job as a subprocess, re-running it while it exits with the
    checkpoint code — the local emulation of the condor cycle."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    for _ in range(max_requeues + 1):
        proc = subprocess.run(
            [sys.executable, "-m", "airpose_tpu_torch.utils.cluster", "--run", jobdir],
            env=env)
        if proc.returncode != CHECKPOINT_EXIT_CODE:
            return proc.returncode
    return CHECKPOINT_EXIT_CODE


def mixedmap(func: Callable, seq: Sequence[Sequence[Any]], jobroot: str,
             backend: str = "local", **backend_kwargs):
    """Map `func` over `seq` as one job per element (the reference's
    mixedmap shape). Returns job dirs; local backend blocks and returns
    results."""
    jobdirs = []
    for i, args in enumerate(seq):
        jobdir = os.path.abspath(os.path.join(jobroot, f"job{i:04d}"))
        write_job(jobdir, func, args)
        jobdirs.append(jobdir)

    if backend == "local":
        results = []
        for jobdir in jobdirs:
            code = submit_local(jobdir, **backend_kwargs)
            if code != 0:
                raise RuntimeError(f"{jobdir} failed with exit code {code}")
            with open(os.path.join(jobdir, "result.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    if backend == "slurm":
        for jobdir in jobdirs:
            script = os.path.join(jobdir, "submit.sh")
            with open(script, "w") as f:
                f.write(slurm_script(jobdir, **backend_kwargs))
            subprocess.run(["sbatch", script], check=True)
        return jobdirs
    if backend == "condor":
        for jobdir in jobdirs:
            sub = os.path.join(jobdir, "submit.sub")
            with open(sub, "w") as f:
                f.write(condor_submit_file(jobdir, **backend_kwargs))
            subprocess.run(["condor_submit", sub], check=True)
        return jobdirs
    raise ValueError(f"unknown backend {backend}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", required=True, help="job dir to execute")
    args = p.parse_args(argv)
    sys.exit(run_job(args.run))


if __name__ == "__main__":
    main()
