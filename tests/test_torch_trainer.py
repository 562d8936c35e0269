"""The port's trainer CLI on the CPU (``--platform cpu``, tiny shapes, the
bf16 trunk the CLI builds) on synthetic://: checkpoints, resume and the
exit-3 deadline; every family; the warm starts and the options; and the
rejections (wrong family, a malformed mixed://, no CUDA). The on-disk sources are in
tests/test_torch_trainer_sources.py, real:// in tests/test_torch_real_trainer.py.

The metrics writer is the JSON-lines one (``_JsonlWriter``): importing
TensorBoard here loads TensorFlow (~14 s a process), which no check needs.
Each test's log directory is removed after it (a checkpoint is ~430 MB)."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from airpose_tpu_torch.models import MODEL_REGISTRY  # noqa: E402
from airpose_tpu_torch.models.resnet import ResNet50  # noqa: E402
from airpose_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from airpose_tpu_torch.train import trainer  # noqa: E402


@pytest.fixture(autouse=True)
def jsonl_writer(monkeypatch, tmp_path):
    monkeypatch.setattr(trainer, "_make_writer", trainer._JsonlWriter)
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the tier runs six
    pytest workers on the machine's cores, and a worker whose torch uses
    every core oversubscribes them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cli(logs, *extra, model="copenet_twoview", datapath="synthetic://8", name="run",
        steps=2, bs=2, platform="cpu"):
    args = ["--name", name, "--version", "0", "--model", model, "--datapath", datapath,
            "--log_dir", str(logs), "--batch_size", str(bs), "--val_batch_size", str(bs),
            "--max_steps", str(steps), "--val_every", str(steps), "--img_res", "64",
            "--data_workers", "2"]
    if platform:
        args += ["--platform", platform]
    return args + list(extra)


def ckpt_dir(logs, name="run"):
    return os.path.join(str(logs), name, "version_0", "checkpoints")


def global_step(logs, which="last", name="run"):
    path = os.path.join(ckpt_dir(logs, name), f"{which}.ckpt")
    return torch.load(path, weights_only=True)["global_step"]


def losses_printed(out):
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step ") and " loss " in line]


def test_synthetic_run_writes_checkpoints_and_metrics(tmp_path, capsys):
    trainer.main(cli(tmp_path, steps=3, bs=3))
    d = ckpt_dir(tmp_path)
    assert sorted(os.listdir(d)) == ["best.ckpt", "best_val.json", "last.ckpt"]
    assert global_step(tmp_path) == 3 and global_step(tmp_path, "best") == 3
    with open(os.path.join(d, "best_val.json")) as f:
        best = json.load(f)["best_val"]
    with open(os.path.join(str(tmp_path), "run", "version_0", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    val = [r for r in rows if r["tag"] == "loss/val"]
    assert len(val) == 1 and val[0]["value"] == best and val[0]["step"] == 2
    assert {r["tag"] for r in rows} >= {"loss/train", "loss/val", "loss_keypoints_3d/train"}
    out = capsys.readouterr().out
    assert np.isfinite(losses_printed(out)).all() and "training done" in out
    # the checkpoint is the reference layout: the port and the JAX package
    # both load it (tests/test_torch_checkpoint.py compares the forwards)
    model, _ = tckpt.load_model_variables("copenet_twoview",
                                          torch_ckpt=os.path.join(d, "last.ckpt"), device="cpu")
    assert not model.trunk.conv1.weight.equal(MODEL_REGISTRY["copenet_twoview"](
        seed=123).trunk.conv1.weight)


def test_resume_continues_from_the_saved_state(tmp_path, capsys, monkeypatch):
    trainer.main(cli(tmp_path, steps=2))
    saved = torch.load(os.path.join(ckpt_dir(tmp_path), "last.ckpt"), weights_only=True)
    capsys.readouterr()
    resumed = {}
    restore = tckpt.CheckpointManager.auto_resume

    def spy(self, state):
        state = restore(self, state)
        resumed.update(step=state.step, sd=tckpt.reference_state_dict(
            {**state.params, **state.batch_stats}, self.model_name),
            mu={k: v.clone() for k, v in state.opt_state["mu"].items()})
        return state

    monkeypatch.setattr(tckpt.CheckpointManager, "auto_resume", spy)
    trainer.main(cli(tmp_path, steps=4))
    assert resumed["step"] == 2
    for k, v in saved["state_dict"].items():
        assert torch.equal(resumed["sd"][k], v), k
    for k, v in saved["optimizer"]["mu"].items():
        assert torch.equal(resumed["mu"][k], v), k
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("step 3 loss")
    assert global_step(tmp_path) == 4


def test_time_to_run_exits_3_after_saving_last(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        trainer.main(cli(tmp_path, "--time_to_run", "0", steps=5))
    assert e.value.code == 3
    assert global_step(tmp_path) == 1
    assert "time_to_run exceeded" in capsys.readouterr().out


@pytest.mark.parametrize("family", ["hmr", "copenet_singleview", "muhmr",
                                    "copenet_twoview_sep"])
def test_every_family_trains(family, tmp_path, capsys):
    trainer.main(cli(tmp_path, model=family, steps=1))
    assert global_step(tmp_path) == 1
    assert np.isfinite(losses_printed(capsys.readouterr().out)).all()


def test_pretrained_checkpoint_warm_start_and_family_check(tmp_path, capsys):
    """--pretrained_checkpoint takes params and BN statistics across
    optimizer variants: with --train_reg_only the trunk stays bit-equal to
    the pretrained one while the heads move; another family's checkpoint,
    or an orbax directory, is refused."""
    trainer.main(cli(tmp_path, name="pre"))
    pre = os.path.join(ckpt_dir(tmp_path, "pre"), "last.ckpt")
    trainer.main(cli(tmp_path, "--pretrained_checkpoint", pre, "--train_reg_only",
                     name="ft"))
    assert f"warm-started from {pre} (torch_ckpt)" in capsys.readouterr().out
    a = torch.load(pre, weights_only=True)["state_dict"]
    b = torch.load(os.path.join(ckpt_dir(tmp_path, "ft"), "last.ckpt"),
                   weights_only=True)["state_dict"]
    for k in a:
        if k.startswith("model.conv1") or k.startswith("model.layer"):
            if "running" not in k:
                assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["model.fc1.weight"], b["model.fc1.weight"])

    trainer.main(cli(tmp_path, model="muhmr", name="mu", steps=1))
    with pytest.raises(SystemExit, match="different param tree"):
        trainer.main(cli(tmp_path, "--pretrained_checkpoint",
                         os.path.join(ckpt_dir(tmp_path, "mu"), "last.ckpt"), name="bad"))
    with pytest.raises(ValueError, match="export_reference_checkpoint"):
        trainer.main(cli(tmp_path, "--pretrained_checkpoint", str(tmp_path), name="bad2"))


def test_imagenet_warm_start(tmp_path, capsys, monkeypatch):
    trunk = ResNet50(generator=torch.Generator().manual_seed(3))
    sd = dict(trunk.state_dict())
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    seen = {}
    warm = tckpt.warm_start_trunks

    def spy(params, batch_stats, trunk, model_name):
        out = warm(params, batch_stats, trunk, model_name)
        seen["conv1"] = params["trunk0.conv1.weight"].clone()
        return out

    monkeypatch.setattr(tckpt, "warm_start_trunks", spy)
    trainer.main(cli(tmp_path / "logs", "--imagenet_ckpt", path, model="copenet_twoview_sep",
                     steps=1))
    assert f"warm-started trunk(s) from {path}" in capsys.readouterr().out
    assert torch.equal(seen["conv1"], sd["conv1.weight"])


def test_qat_act_frozen_calibrates_each_trunk(tmp_path, capsys):
    trainer.main(cli(tmp_path, "--qat", "--qat_act", "--qat_act_frozen",
                     model="copenet_twoview_sep", steps=1))
    out = capsys.readouterr().out
    assert "frozen activation-QAT: 104 per-site scales calibrated on 4 crops" in out
    assert np.isfinite(losses_printed(out)).all()
    with pytest.raises(SystemExit, match="pass --qat too"):
        trainer.main(cli(tmp_path, "--qat_act", name="b"))
    with pytest.raises(SystemExit, match="requires --qat_act"):
        trainer.main(cli(tmp_path, "--qat", "--qat_act_frozen", name="c"))


def test_body_only_verts_and_debug_nans(tmp_path, capsys):
    assets = tmp_path / "assets"
    assets.mkdir()
    with open(assets / "MANO_SMPLX_vertex_ids.pkl", "wb") as f:
        pickle.dump({"left_hand": np.arange(0, 20), "right_hand": np.arange(20, 40)}, f)
    trainer.main(cli(tmp_path / "logs", "--body_only_verts", str(assets), "--debug_nans",
                     steps=1))
    out = capsys.readouterr().out
    assert "body-only vertex loss: 40 hand/face vertices masked of 300" in out


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="exactly two kind=path"):
        trainer.main(cli(tmp_path, datapath="mixed://h36m=/x"))
    with pytest.raises(SystemExit):
        trainer.main(cli(tmp_path, platform="tpu"))  # not a choice
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer.main(cli(tmp_path, platform=None))


def test_flags_and_defaults_match_jax():
    from airpose_tpu.train.trainer import build_parser as jbuild_parser

    def options(parser):
        return {a.dest: (a.default, a.choices, a.nargs, a.type, a.required)
                for a in parser._actions if a.dest != "help"}

    want, got = options(jbuild_parser()), options(trainer.build_parser())
    assert set(got) == set(want)
    for dest in want:
        if dest == "platform":
            assert got[dest][1] == ("cpu", "cuda") and got[dest][0] is None
        else:
            assert got[dest] == want[dest], dest
