"""The port's trainer CLI on the on-disk sources (``--platform cpu``, tiny
shapes): an AerialPeople path, h36m://, totalcap:// and mixed:// on the JAX
tests' fixture writers, and the empty-val-split rejection. The metrics
writer and the clean-up are tests/test_torch_trainer.py's."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import (_write_fake_aerialpeople, _write_fake_h36m,  # noqa: E402
                       _write_fake_totalcap)
from test_torch_trainer import cli, few_threads, global_step, jsonl_writer, losses_printed  # noqa: E402,F401

from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic_smplx_params  # noqa: E402
from airpose_tpu_torch.train import trainer  # noqa: E402


@pytest.fixture(scope="module")
def h36m_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("h36m"))
    _write_fake_h36m(root, n=3)
    return root


@pytest.fixture(scope="module")
def totalcap_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("totalcap"))
    _write_fake_totalcap(root, n=5)
    return root


def test_h36m_joints_source(tmp_path, h36m_root, capsys):
    trainer.main(cli(tmp_path, datapath=f"h36m://{h36m_root}"))
    out = capsys.readouterr().out
    assert "h36m(3 train/3 val, joints loss)" in out
    assert global_step(tmp_path) == 2 and np.isfinite(losses_printed(out)).all()
    with pytest.raises(SystemExit, match="no joints-GT path"):
        trainer.main(cli(tmp_path, model="hmr", datapath=f"h36m://{h36m_root}", name="h"))


def test_totalcap_source(tmp_path, totalcap_root, capsys):
    trainer.main(cli(tmp_path, "--val_batch_size", "1",
                     datapath=f"totalcap://{totalcap_root}"))
    out = capsys.readouterr().out
    assert "totalcap(4 train/1 val, smpl loss)" in out and global_step(tmp_path) == 2


def test_mixed_source_reports_each_source(tmp_path, h36m_root, totalcap_root, capsys):
    trainer.main(cli(tmp_path, "--val_batch_size", "1",
                     datapath=f"mixed://h36m={h36m_root},totalcap={totalcap_root}", steps=4))
    out = capsys.readouterr().out
    val = [line for line in out.splitlines() if "val_loss" in line]
    assert len(val) == 1 and "(h36m " in val[0] and "totalcap " in val[0]
    assert global_step(tmp_path) == 4


def test_aerialpeople_source(tmp_path, capsys):
    root = str(tmp_path / "aerial")
    _write_fake_aerialpeople(root, jsynthetic_smplx_params(num_vertices=99, seed=4), n=3)
    trainer.main(cli(tmp_path / "logs", datapath=root))
    out = capsys.readouterr().out
    assert "aerialpeople(3 train/3 val, smpl loss)" in out
    assert "summary render skipped" not in out
    assert global_step(tmp_path / "logs") == 2


def test_rejects_empty_val_split(tmp_path):
    t = str(tmp_path / "tc1")
    _write_fake_totalcap(t, n=1)
    with pytest.raises(SystemExit, match="at least 2"):
        trainer.main(cli(tmp_path, datapath=f"totalcap://{t}", steps=1))


