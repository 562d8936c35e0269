"""Multi-device over torch.distributed (airpose_tpu_torch/parallel/), on the
CPU with gloo: the data-parallel and dp×tp train steps, the sharding rules
and the launcher, each run in 2 and 4 processes against one process at the
bounds of the JAX package's own sharded-vs-single tests
(tests/test_train.py:239-326). Dropout is off on both sides (each rank draws
its own masks from its own generator). Imports no JAX: the ranks import this
module to find their functions."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from airpose_tpu_torch import parallel
from airpose_tpu_torch.parallel import mesh as pm

LR = 1e-4
B = 4


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads in this process while the module runs (the tier
    runs six workers; each spawned rank takes two of its own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _no_dropout():
    from airpose_tpu_torch.models import regressor

    keep = regressor.dropout
    regressor.dropout = lambda h, rate, generator: h
    try:
        yield
    finally:
        regressor.dropout = keep


def _problem(real=False):
    from airpose_tpu_torch.bodymodel import synthetic_smplx_params
    from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset

    smplx = synthetic_smplx_params(num_vertices=128, seed=0)
    batch = batch_slice(make_synthetic_dataset(smplx, B, seed=1, img_size=64, blob_sigma=3.0),
                        0, B, "cpu")
    if real:
        rng = np.random.default_rng(5)
        kp = np.concatenate([rng.uniform(10, 54, (B, 2, 24, 2)),
                             rng.uniform(0.2, 1.0, (B, 2, 24, 1))], -1).astype(np.float32)
        batch = {"images": batch["images"], "bb": batch["bb"], "intr": batch["intr"],
                 "gt_j2d_conf": torch.from_numpy(kp),
                 "focal": torch.tensor([[1475.0, 1475.0], [1500.0, 1500.0]]),
                 # unequal row weights over the shards: a local mean of each
                 # shard's rows would not average to the global one
                 "row_weight": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    return smplx, batch


def _step_rank(rank, world, n_model=1, real=False):
    """One train step of a seeded copenet_twoview on this rank's rows (the
    real two-view step with row weights where ``real``); → rank 0's loss,
    whole parameters and BN statistics as numpy, and every rank's
    parameter checksum."""
    from airpose_tpu_torch.config import RealLossWeights, TrainConfig
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.train import create_train_state, make_twoview_step_fns
    from airpose_tpu_torch.train.loop import make_real_twoview_step_fns

    torch.manual_seed(0)
    smplx, batch = _problem(real)
    mesh = (parallel.make_mesh_2d(world // n_model, n_model) if n_model > 1
            else parallel.make_mesh(world) if world > 1 else None)
    model = AirPoseTwoView(seed=0)
    sharded = parallel.shard_params_tp(model, mesh) if n_model > 1 else []
    state, tx = create_train_state(model, LR)
    cfg = TrainConfig(lr=LR, batch_size=B)
    if real:
        from airpose_tpu_torch.bodymodel import init_vposer_params

        # the VPoser term's latent sample is each rank's own draw: weight 0
        cfg = dataclasses.replace(cfg, real_loss=RealLossWeights(vposer=0.0))
        train_step, _ = make_real_twoview_step_fns(model, smplx, init_vposer_params(0), cfg,
                                                   tx, device="cpu", mesh=mesh)
    else:
        train_step, _ = make_twoview_step_fns(model, smplx, cfg, tx, device="cpu", mesh=mesh)
    local = parallel.shard_batch(batch, mesh)
    with _no_dropout():
        state, metrics = train_step(state, local, torch.Generator().manual_seed(7 + rank))
    params = (parallel.gather_params_tp(state.params, sharded, mesh) if sharded
              else state.params)
    checksum = float(sum(p.detach().double().abs().sum() for p in params.values()))
    if rank:
        return {"checksum": checksum}
    return {"checksum": checksum, "loss": float(metrics["loss"]),
            "params": {k: v.detach().numpy().copy() for k, v in params.items()},
            "stats": {k: v.numpy().copy() for k, v in state.batch_stats.items()
                      if not k.endswith("num_batches_tracked")},
            "sharded": sharded}


@pytest.fixture(scope="module")
def single():
    return {real: _step_rank(0, 1, real=real) for real in (False, True)}


def _assert_close(got, want, loss_rel, stats=True):
    assert got["loss"] == pytest.approx(want["loss"], rel=loss_rel)
    assert set(got["params"]) == set(want["params"])
    for k, a in want["params"].items():
        np.testing.assert_allclose(got["params"][k], a, rtol=1e-3, atol=3 * LR, err_msg=k)
    if stats:
        for k, a in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k], a, rtol=5e-3, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_one_process(single, world):
    """test_train.py:239-282's bounds: loss rel 1e-3; params rtol 1e-3,
    atol 3·lr (AMSGrad's normalised step flips by ±lr on near-zero
    gradients); BN running statistics rtol 5e-3, atol 1e-3 (a local-batch
    BN would be off by O(0.1)). Every rank ends with the same parameters."""
    out = parallel.spawn(_step_rank, world, timeout=150)
    assert len({o["checksum"] for o in out}) == 1
    _assert_close(out[0], single[False], 1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_with_unequal_row_weights(single, world):
    """The real two-view step with (B,) row weights 1, 1, 1, 0: the shards
    hold different weight sums (2 and 1 over 2 ranks; 1, 1, 1, 0 over 4), so
    a ``_row_mean`` that averaged the shards' own weighted means would be
    off; the same bounds."""
    out = parallel.spawn(_step_rank, world, args=(1, True), timeout=150)
    assert len({o["checksum"] for o in out}) == 1
    _assert_close(out[0], single[True], 1e-3)


@pytest.mark.parametrize("world,n_model", [(2, 2), (4, 2)])
def test_dp_x_tp_step_matches_one_process(single, world, n_model):
    """(data, model) = (1, 2) and (2, 2): the wide Linear and conv weights
    column-parallel over the model group, the batch over the data group.
    test_train.py:283-326's bounds: loss rel 3e-3, params rtol 1e-3,
    atol 3·lr."""
    out = parallel.spawn(_step_rank, world, args=(n_model,), timeout=150)
    assert len({o["checksum"] for o in out}) == 1
    assert "core.fc1.weight" in out[0]["sharded"] and "core.fc2.weight" in out[0]["sharded"]
    assert "trunk.layer4.0.conv3.weight" in out[0]["sharded"]
    _assert_close(out[0], single[False], 3e-3, stats=False)


def test_param_spec_and_shard_batch_rules():
    """The TP rule in torch's layouts, and shard_batch's: batch-shaped
    leaves take this rank's rows, per-view leaves and batches whose rows do
    not divide the group stay whole."""
    assert pm.param_spec(torch.zeros(1024, 2205), 2) == 0        # fc1 (out, in)
    assert pm.param_spec(torch.zeros(1024), 2) is None            # its bias
    assert pm.param_spec(torch.zeros(132, 1024), 2) is None       # a small head
    assert pm.param_spec(torch.zeros(512, 128, 1, 1), 2) == 0     # a wide conv, OIHW
    assert pm.param_spec(torch.zeros(256, 64, 3, 3), 2) is None
    mesh = pm.Mesh({"data": 2}, group=object(), data_rank=1)
    batch = {"images": torch.arange(4.0)[:, None], "focal": torch.tensor([1.0, 2.0]),
             "tag": "x"}
    got = pm.shard_batch(batch, mesh)
    assert got["images"].tolist() == [[2.0], [3.0]]
    assert got["focal"].tolist() == [1.0, 2.0] and got["tag"] == "x"
    tail = {"images": torch.arange(3.0), "focal": torch.tensor([1.0, 2.0])}
    assert pm.shard_batch(tail, mesh)["images"].tolist() == [0.0, 1.0, 2.0]
    two = {"images": torch.arange(2.0), "focal": torch.ones(2, 2)}  # 2 rows, 2 views
    got = pm.shard_batch(two, mesh)
    assert got["images"].tolist() == [1.0] and got["focal"].shape == (2, 2)
    assert pm.shard_batch(batch, None)["images"].shape == (4, 1)


def test_make_mesh_refuses_more_ranks_than_the_group():
    assert parallel.make_mesh().n_data == 1
    with pytest.raises(ValueError, match="process group has 1"):
        parallel.make_mesh(2)


def _failing_rank(rank, world):
    if rank == 1:
        raise RuntimeError("rank one fails")
    return rank


def test_spawn_reports_a_failing_rank():
    assert parallel.spawn(_failing_rank, 1) == [0]
    with pytest.raises(RuntimeError, match="rank one fails"):
        parallel.spawn(_failing_rank, 2, timeout=60)


# ---- AirPose+ over ranks ------------------------------------------------------------------

def _ba_problem():
    """tests/test_bundle_adjust.py's problem at N = 12 with a perturbed
    init, built with the port's functions, and the same two non-robust
    frames, 3 and 8: over 4 ranks each drops a pair that straddles a rank
    boundary, over 2 ranks the boundary pair (5, 6) is live."""
    from scipy.spatial.transform import Rotation

    from airpose_tpu_torch.bodymodel import (init_vposer_params, synthetic_smplx_params,
                                             vposer_decode)
    from airpose_tpu_torch.optim.bundle_adjust import BAState, joints_only_forward

    smplx, vp = synthetic_smplx_params(num_vertices=150, seed=7), init_vposer_params(0)
    rng = np.random.default_rng(0)
    N = 12
    z_true = rng.normal(size=(N, 32)).astype(np.float32) * 0.3
    with torch.no_grad():
        theta = vposer_decode(vp, torch.from_numpy(z_true))["pose_body_matrot"]
        joints = joints_only_forward(smplx, torch.zeros(N, 10), theta)[:, :24].numpy()
    phi_rm = np.stack([np.stack([Rotation.from_euler("y", 0.1 * v + 0.02 * n).as_matrix()
                                 for v in (0, 1)]) for n in range(N)]).astype(np.float32)
    tau = np.tile(np.asarray([[0.0, 0.0, 6.0]], np.float32), (N, 2, 1))
    tau[:, 1, 0] = 0.5
    intr = np.asarray([[[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]]] * 2, np.float32)
    cam_j = np.einsum("nvij,nkj->nvki", phi_rm, joints) + tau[:, :, None]
    uv = cam_j[..., :2] / cam_j[..., 2:] * 1475.0 + intr[0, :2, 2]
    kp = np.concatenate([uv, np.ones((N, 2, 24, 1))], axis=-1).astype(np.float32)
    kp[[3, 8], :, :, 2] *= 0.2
    init = BAState(torch.from_numpy(z_true + 0.3 * rng.normal(size=z_true.shape)
                                    .astype(np.float32)),
                   torch.from_numpy(phi_rm[..., :2].reshape(N, 2, 6)
                                    + 0.05 * rng.normal(size=(N, 2, 6)).astype(np.float32)),
                   torch.from_numpy(tau + 0.2 * rng.normal(size=tau.shape).astype(np.float32)),
                   torch.zeros(10))
    kp = torch.from_numpy(kp)
    return smplx, vp, init, kp, torch.from_numpy(intr)


def _ba_rank(rank, world, sharded=True):
    from airpose_tpu_torch.optim.bundle_adjust import (BAConfig, bundle_adjust,
                                                       bundle_adjust_sharded)

    smplx, vp, init, kp, intr = _ba_problem()
    fn = bundle_adjust_sharded if sharded else bundle_adjust
    state, info = fn(smplx, vp, init, kp, kp, intr,
                     BAConfig(iters_stage1=5, iters_stage2=10, w_beta=1.0))
    return {"state": [t.numpy() for t in state], "trace": info["trace"],
            "loss_2d": info["loss_2d"]}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bundle_adjust_matches_one_process(world):
    """test_bundle_adjust.py:146-186's bounds: the loss trace rtol 2e-4,
    atol 1e-5; z, φ, τ, β rtol 1e-3, atol 2e-4. The sharded function alone
    in one process equals bundle_adjust at the same bounds."""
    want = _ba_rank(0, 1, sharded=False)
    for got in [_ba_rank(0, 1)] + parallel.spawn(_ba_rank, world, timeout=120):
        np.testing.assert_allclose(got["trace"], want["trace"], rtol=2e-4, atol=1e-5)
        assert got["loss_2d"] == pytest.approx(want["loss_2d"], rel=2e-4, abs=1e-5)
        for name, a, b in zip("z phi tau beta".split(), got["state"], want["state"]):
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-4, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip(n, capsys):
    """entry.dryrun_multichip on the CPU: world size 1 in this process, 2
    (dp) and 4 (dp 2 × tp 2) gloo processes; each prints JAX's two lines."""
    from airpose_tpu_torch.entry import dryrun_multichip

    kind, loss, ba_loss = dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    assert kind == ("dp2xtp2" if n == 4 else "dp")
    assert np.isfinite(loss) and np.isfinite(ba_loss)
    assert f"dryrun_multichip({n}): OK [{kind}]" in out
    assert f"dryrun_multichip({n}): BA sharded OK" in out


# ---- compile_results --mesh ---------------------------------------------------------------

def _compile_argv(out, *extra):
    return ["--model", "copenet_twoview", "--datapath", "synthetic://20", "--out", str(out),
            "--batch_size", "8", "--img_res", "64", "--save-full", "--platform", "cpu", *extra]


def _compile_rank(rank, world, out):
    from airpose_tpu_torch.eval import compile_results

    compile_results.main(_compile_argv(out, "--mesh", str(world)))


@pytest.mark.parametrize("world", [2, 4])
def test_compile_results_mesh_matches_one_process(tmp_path, world, capsys):
    """--mesh N over N gloo processes against one process
    (test_compile_results.py:394-420): 20 frames in batches of 8, the tail
    padded from 4 rows; rank 0's pkl has the same rows in the same order,
    every field and metric within rtol 1e-4, atol 1e-5 (each rank's convs
    run on fewer rows, in other orders of summation)."""
    import json
    import pickle

    from airpose_tpu_torch.eval import compile_results

    one, many = tmp_path / "one.pkl", tmp_path / "mesh.pkl"
    compile_results.main(_compile_argv(one))
    parallel.spawn(_compile_rank, world, args=(str(many),), timeout=150)
    capsys.readouterr()
    with open(one, "rb") as f:
        want = pickle.load(f)
    with open(many, "rb") as f:
        got = pickle.load(f)
    assert [len(s) for s in got] == [len(s) for s in want] == [3]
    for gb, wb in zip(got[0], want[0]):
        assert gb["output"].keys() == wb["output"].keys()
        for k, w in wb["output"].items():
            assert gb["output"][k].shape == w.shape, k
            np.testing.assert_allclose(gb["output"][k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    for path in (one, many):
        with open(str(path) + ".metrics.json") as f:
            metrics = json.load(f)["test"]
        if path == one:
            want_m = metrics
    for k, v in want_m.items():
        assert metrics[k] == pytest.approx(v, rel=1e-4, abs=1e-5), k
    for p in tmp_path.iterdir():
        p.unlink()


# ---- the trainer under a process group ----------------------------------------------------

def _trainer_rank(rank, world, log_dir, batch_size):
    """Two trainer runs in one run directory: 2 steps with a val pass, then
    a resume to step 3 with --time_to_run 0 (exit 3 after the step); →
    each run's exit code."""
    import sys

    from airpose_tpu_torch.train import trainer

    # TensorBoard's writer then takes its stub for TensorFlow (importing
    # TensorFlow here costs ~14 s a process)
    sys.modules["tensorflow"] = None

    codes = []
    for extra in (["--max_steps", "2"], ["--max_steps", "3", "--time_to_run", "0"]):
        try:
            trainer.main(["--name", "dp", "--version", "0", "--model", "copenet_twoview",
                          "--datapath", "synthetic://12", "--log_dir", log_dir,
                          "--batch_size", str(batch_size), "--val_batch_size", "2",
                          "--val_every", "2", "--img_res", "64", "--platform", "cpu", *extra])
            codes.append(0)
        except SystemExit as e:
            codes.append(e.code if isinstance(e.code, int) else str(e.code))
    return codes


def test_trainer_data_parallel(tmp_path, capsys):
    """The trainer CLI over 2 gloo ranks: each takes half of every batch;
    rank 0 alone logs and writes the checkpoints; both ranks resume from
    them and leave with code 3 together when --time_to_run expires; a world
    size that does not divide the batch is refused."""
    from airpose_tpu_torch.models import AirPoseTwoView
    from airpose_tpu_torch.train import create_train_state
    from airpose_tpu_torch.train.checkpoint import CheckpointManager

    log_dir = str(tmp_path / "logs")
    assert parallel.spawn(_trainer_rank, 2, args=(log_dir, 2), timeout=150) == [[0, 3]] * 2
    ckpts = tmp_path / "logs" / "dp" / "version_0" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["best.ckpt", "best_val.json",
                                                       "last.ckpt"]
    state, _ = create_train_state(AirPoseTwoView(dtype=torch.bfloat16), 5e-5)
    assert CheckpointManager(str(ckpts)).auto_resume(state).step == 3
    refused = parallel.spawn(_trainer_rank, 2, args=(str(tmp_path / "r"), 3), timeout=120)
    assert all("2 ranks do not divide --batch_size 3" in c[0] for c in refused)
    import shutil

    shutil.rmtree(tmp_path / "logs")
