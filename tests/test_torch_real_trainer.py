"""The port's trainer CLI on real:// (``--platform cpu``, 64 px, B = 2, the
bf16 trunk the CLI builds) on a synthetic DJI capture: checkpoints and the
rendered summary grid, the frame ranges and the VPoser snapshot taking
effect, the README's synthetic → real chain (``--pretrained_checkpoint``
with ``--train_reg_only``), ``--model hmr`` alternating the view from step
to step, and the refusals. The step functions themselves are held to the
JAX package in tests/test_torch_real.py.

The metrics writer is the JSON-lines one, which also keeps the images it is
handed; each test's log directory is removed after it (a checkpoint is
~430 MB)."""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from airpose_tpu_torch.bodymodel import init_vposer_params, load_vposer_ckpt
from airpose_tpu_torch.bodymodel.vposer import _TORCH_KEYMAP
from airpose_tpu_torch.data.fake_real import write_fake_real_capture
from airpose_tpu_torch.data.validate import DbSchemaError
from airpose_tpu_torch.train import loop, trainer

IMAGES = []


class _ImageKeepingWriter(trainer._JsonlWriter):
    def add_image(self, tag, img, step):
        IMAGES.append((tag, img.shape, step))


@pytest.fixture(autouse=True)
def jsonl_writer(monkeypatch, tmp_path):
    monkeypatch.setattr(trainer, "_make_writer", _ImageKeepingWriter)
    IMAGES.clear()
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (six pytest workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("capture"))
    write_fake_real_capture(root, n=8, scale=0.5)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def cli(logs, capture, *extra, model="copenet_twoview", name="run", steps=2):
    return ["--name", name, "--version", "0", "--model", model,
            "--datapath", f"real://{capture}", "--train_frames", "0", "5",
            "--test_frames", "5", "8", "--log_dir", str(logs), "--batch_size", "2",
            "--val_batch_size", "2", "--max_steps", str(steps), "--val_every", str(steps),
            "--img_res", "64", "--data_workers", "2", "--platform", "cpu", *extra]


def ckpt(logs, name="run", which="last"):
    return torch.load(os.path.join(str(logs), name, "version_0", "checkpoints",
                                   f"{which}.ckpt"), weights_only=True)


def test_real_run_writes_checkpoints_and_renders_the_grid(tmp_path, capture, capsys,
                                                          monkeypatch):
    # a snapshot in the released key layout, holding seed 5's prior (not seed 0's)
    npz = str(tmp_path / "vposer.npz")
    keymap = {field: key for key, field in _TORCH_KEYMAP.items()}
    blob = {}
    for field, layer in init_vposer_params(5)._asdict().items():
        if "bn" in field:
            blob.update({f"{keymap[field]}.weight": layer.scale.numpy(),
                         f"{keymap[field]}.bias": layer.bias.numpy(),
                         f"{keymap[field]}.running_mean": layer.mean.numpy(),
                         f"{keymap[field]}.running_var": layer.var.numpy()})
        else:
            blob.update({f"{keymap[field]}.weight": layer.w.numpy().T,
                         f"{keymap[field]}.bias": layer.b.numpy()})
    np.savez(npz, **blob)
    seen = []
    make = loop.make_real_twoview_step_fns

    def spy(model, smplx_params, vposer_params, *a, **kw):
        seen.append(vposer_params)
        return make(model, smplx_params, vposer_params, *a, **kw)

    monkeypatch.setattr(loop, "make_real_twoview_step_fns", spy)
    trainer.main(cli(tmp_path / "logs", capture, "--vposer_ckpt", npz))
    out = capsys.readouterr().out
    assert "loaded 5 train / 3 test frames" in out
    assert f"loaded VPoser prior from {npz}" in out and "RANDOM VPoser" not in out
    for got, want in zip(seen[0], init_vposer_params(5)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    losses = [float(ln.split()[3]) for ln in out.splitlines() if " loss " in ln]
    assert len(losses) == 1 and np.isfinite(losses).all() and "training done" in out
    assert "val_loss" in out and "summary render skipped" not in out
    # one grid per val pass: 2 views × [input | overlay] of 64² crops
    assert IMAGES == [("val_pred_shape_cam", (3, 128, 128), 1)]
    d = os.path.join(str(tmp_path / "logs"), "run", "version_0", "checkpoints")
    assert sorted(os.listdir(d)) == ["best.ckpt", "best_val.json", "last.ckpt"]
    assert ckpt(tmp_path / "logs")["global_step"] == 2
    assert load_vposer_ckpt(npz).enc_fc1.w.equal(init_vposer_params(5).enc_fc1.w)


def test_pretrained_reg_only_chain_keeps_the_trunk(tmp_path, capture, capsys):
    """The README's chain: a synthetic pretrain, then the real fine-tune from
    its last.ckpt with --train_reg_only; the trunk stays bit-equal to the
    pretrained one while the heads move."""
    logs = tmp_path / "logs"
    trainer.main(["--name", "pre", "--version", "0", "--model", "copenet_twoview",
                  "--datapath", "synthetic://8", "--log_dir", str(logs), "--batch_size", "2",
                  "--val_batch_size", "2", "--max_steps", "2", "--val_every", "2",
                  "--img_res", "64", "--platform", "cpu"])
    pre = os.path.join(str(logs), "pre", "version_0", "checkpoints", "last.ckpt")
    trainer.main(cli(logs, capture, "--pretrained_checkpoint", pre, "--train_reg_only",
                     name="ft"))
    out = capsys.readouterr().out
    assert f"warm-started from {pre} (torch_ckpt)" in out and "RANDOM VPoser" in out
    a, b = ckpt(logs, "pre")["state_dict"], ckpt(logs, "ft")["state_dict"]
    trunk = [k for k in a if k.startswith(("model.conv1", "model.bn1", "model.layer"))
             and "running" not in k and "num_batches" not in k]
    assert len(trunk) == 159  # 53 convolutions, 53 BatchNorms' scale and bias
    for k in trunk:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["model.fc1.weight"], b["model.fc1.weight"])
    assert not torch.equal(a["model.decpose.weight"], b["model.decpose.weight"])


def test_hmr_alternates_the_view(tmp_path, capture, capsys, monkeypatch):
    views = []
    make = loop.make_real_singleview_step_fns

    def spy(*a, **kw):
        assert a[5] == "hmr_camswap_difffl"
        train_step, eval_step = make(*a, **kw)

        def step(state, batch, gen, view=0):
            views.append(view)
            return train_step(state, batch, gen, view)
        return step, eval_step

    monkeypatch.setattr(loop, "make_real_singleview_step_fns", spy)
    trainer.main(cli(tmp_path / "logs", capture, model="hmr", steps=3))
    assert views == [0, 1, 0]
    out = capsys.readouterr().out
    assert np.isfinite([float(ln.split()[3]) for ln in out.splitlines() if " loss " in ln]).all()
    assert ckpt(tmp_path / "logs")["global_step"] == 3 and IMAGES == []


@pytest.mark.parametrize("case", ["muhmr", "copenet_singleview", "body_only_verts"])
def test_real_refusals(tmp_path, capture, case):
    if case == "body_only_verts":
        assets = tmp_path / "assets"
        assets.mkdir()
        with open(assets / "MANO_SMPLX_vertex_ids.pkl", "wb") as f:
            pickle.dump({"left_hand": np.arange(0, 20), "right_hand": np.arange(20, 40)}, f)
        args, match = cli(tmp_path, capture, "--body_only_verts", str(assets)), "no vertex term"
    else:
        args, match = cli(tmp_path, capture, model=case), "has no real:// fine-tune path"
    with pytest.raises(SystemExit, match=match):
        trainer.main(args)


def test_real_path_without_a_capture_is_a_schema_error(tmp_path, capture):
    with pytest.raises(DbSchemaError, match="is not a directory"):
        trainer.main(cli(tmp_path, str(tmp_path / "none")))
