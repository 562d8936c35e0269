"""The port's cluster job submission (airpose_tpu_torch/utils/cluster.py):
the ports of tests/test_tools.py's cluster tests, and the local backend's
requeue on the checkpoint exit code. Imports no JAX: the job subprocesses
import this module to unpickle its functions."""

import os
import sys

from airpose_tpu_torch.utils import cluster


# module-level so the cluster subprocess can unpickle them
def _square(x):
    return x * x


def _square_after_requeue(x, runs_file):
    """Exits with the checkpoint code on its first run, returns x² on the next."""
    with open(runs_file, "a") as f:
        f.write("run\n")
    with open(runs_file) as f:
        if len(f.readlines()) == 1:
            sys.exit(cluster.CHECKPOINT_EXIT_CODE)
    return x * x


def test_cluster_local_mixedmap(tmp_path):
    results = cluster.mixedmap(_square, [(2,), (3,), (4,)], str(tmp_path))
    assert results == [4, 9, 16]


def test_cluster_local_requeues_on_exit_3(tmp_path):
    runs = str(tmp_path / "runs.txt")
    assert cluster.mixedmap(_square_after_requeue, [(5, runs)], str(tmp_path / "jobs")) == [25]
    with open(runs) as f:
        assert len(f.readlines()) == 2  # one exit 3, one requeued run
    # the job runs from any working directory: the package is put on its path
    job = str(tmp_path / "jobs2")
    cluster.write_job(job, _square, (6,))
    cwd = os.getcwd()
    try:
        os.chdir(tmp_path)
        assert cluster.submit_local(job) == 0
    finally:
        os.chdir(cwd)


def test_cluster_scripts_contain_requeue(tmp_path):
    s = cluster.slurm_script(str(tmp_path))
    assert "requeue" in s and " 3 ]" in s
    assert "-m airpose_tpu_torch.utils.cluster --run" in s
    c = cluster.condor_submit_file(str(tmp_path))
    assert "on_exit_hold = (ExitCode =?= 3)" in c
    assert "periodic_release" in c
    assert "-m airpose_tpu_torch.utils.cluster --run" in c
    assert cluster.CHECKPOINT_EXIT_CODE == 3
