"""Port parity of AirPose+ (airpose_tpu_torch.optim.bundle_adjust vs
airpose_tpu.optim.bundle_adjust on the same numpy problem, on the CPU, f32):
the joints-only forward, the init, every loss term and gradient, Adam, the
two-stage optimisation, the debug report and the export; then the port's
sequence runner across chunk boundaries and the CLI chain compile_results →
bundle_adjust → figures.

The problem is tests/test_bundle_adjust.py's (its _make_problem): a body
decoded from the random VPoser prior of seed 0 on a 150-vertex synthetic
body, seen by two cameras, its keypoints the exact projections with
confidence 1; the init perturbed, two frames made non-robust.

Tolerances, each with its reason:
  - the joints-only forward atol 1e-5, tests/test_bundle_adjust.py's bound
    against the full forward;
  - the loss terms rtol 1e-5 and their gradients within 1e-4 of each
    gradient's largest entry, tests/test_torch_real.py's bounds for the
    same VPoser and SMPL-X arithmetic in f32;
  - 10 + 20 Adam iterations: the trace rtol 2e-4 / atol 1e-5 and the final
    state rtol 1e-3 / atol 2e-4, the bounds tests/test_bundle_adjust.py
    holds the sharded optimisation to against the single-device one (f32
    sums in other orders, amplified by Adam's normalised steps);
  - the export's vertices and transforms atol 1e-5 (f32 through VPoser's
    decoder and SMPL-X).
"""

import importlib
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_data import _write_fake_real  # noqa: E402

from airpose_tpu import optim as jba  # noqa: E402
from airpose_tpu.bodymodel import init_vposer_params as j_init_vposer  # noqa: E402
from airpose_tpu.bodymodel import synthetic_smplx_params as jsynthetic  # noqa: E402
from airpose_tpu_torch.bodymodel import (smplx_forward, synthetic_smplx_params,  # noqa: E402
                                         vposer_params_from_numpy)
from airpose_tpu_torch.eval import compile_results as tcr  # noqa: E402
from airpose_tpu_torch.eval import figures as tfig  # noqa: E402
from airpose_tpu_torch.geometry import batch_rodrigues  # noqa: E402
from airpose_tpu_torch.optim import (BAConfig, BAState, ba_debug_report,  # noqa: E402
                                     bundle_adjust, export_results, init_from_predictions,
                                     joints_only_forward, print_debug_report)

jba_mod = importlib.import_module("airpose_tpu.optim.bundle_adjust")
tba = importlib.import_module("airpose_tpu_torch.optim.bundle_adjust")
FIELDS = BAState._fields
CFG = BAConfig(iters_stage1=10, iters_stage2=20, w_beta=1.0)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs (six pytest workers share
    the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jsmplx, jvp = jsynthetic(num_vertices=150, seed=7), j_init_vposer(0)
    return (jsmplx, jvp), (synthetic_smplx_params(num_vertices=150, seed=7),
                           vposer_params_from_numpy(jvp))


@pytest.fixture(scope="module")
def problem(models):
    """tests/test_bundle_adjust.py's problem (_make_problem, built here with
    the port's functions) at N = 12 with a perturbed init and two non-robust
    frames (AlphaPose confidences below the gate), as numpy: init (z, phi,
    tau, beta), keypoints (N, 2, 24, 3), intr (2, 3, 3)."""
    from scipy.spatial.transform import Rotation

    from airpose_tpu_torch.bodymodel import vposer_decode

    _, (tsmplx, tvp) = models
    rng = np.random.default_rng(0)
    N = 12
    z_true = rng.normal(size=(N, 32)).astype(np.float32) * 0.3
    with torch.no_grad():
        theta = vposer_decode(tvp, torch.from_numpy(z_true))["pose_body_matrot"]
        joints = joints_only_forward(tsmplx, torch.zeros(N, 10), theta)[:, :24].numpy()
    phi_rm = np.stack([np.stack([Rotation.from_euler("y", 0.1 * v + 0.02 * n).as_matrix()
                                 for v in (0, 1)]) for n in range(N)]).astype(np.float32)
    tau = np.tile(np.asarray([[0.0, 0.0, 6.0]], np.float32), (N, 2, 1))
    tau[:, 1, 0] = 0.5
    intr = np.asarray([[[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]]] * 2, np.float32)
    cam_j = np.einsum("nvij,nkj->nvki", phi_rm, joints) + tau[:, :, None]
    uv = cam_j[..., :2] / cam_j[..., 2:] * 1475.0 + intr[0, :2, 2]
    kp = np.concatenate([uv, np.ones((N, 2, 24, 1))], axis=-1).astype(np.float32)
    kp[[3, 8], :, :, 2] *= 0.2
    phi = phi_rm[..., :2].reshape(N, 2, 6)
    init = (z_true + 0.3 * rng.normal(size=z_true.shape).astype(np.float32),
            phi + 0.05 * rng.normal(size=(N, 2, 6)).astype(np.float32),
            tau + 0.2 * rng.normal(size=tau.shape).astype(np.float32),
            np.zeros(10, np.float32))
    return init, kp, intr


def _jstate(init):
    return jba.BAState(*(jnp.asarray(a) for a in init))


def _tstate(init):
    return BAState(*(torch.from_numpy(np.ascontiguousarray(a)) for a in init))


def _close_to_largest(got, want, rtol, what):
    """|got − want| ≤ rtol · max |want|, entrywise."""
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def test_joints_only_forward_matches_jax_and_the_full_forward(models):
    (jsmplx, _), (tsmplx, _) = models
    rng = np.random.default_rng(1)
    aa = (rng.normal(size=(3, 21, 3)) * 0.3).astype(np.float32)
    betas = (rng.normal(size=(3, 10)) * 0.3).astype(np.float32)
    body = batch_rodrigues(torch.from_numpy(aa))
    got = joints_only_forward(tsmplx, torch.from_numpy(betas), body).numpy()
    assert got.shape == (3, 55, 3)
    want = jba.joints_only_forward(jsmplx, jnp.asarray(betas), jnp.asarray(body.numpy()))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    full = smplx_forward(tsmplx, torch.from_numpy(betas), body_pose=body,
                         global_orient=torch.eye(3).expand(3, 1, 3, 3), use_kernels=False)
    np.testing.assert_allclose(got, full.joints[:, :55].numpy(), atol=1e-5)


def test_init_from_predictions_matches_jax(models):
    (_, jvp), (_, tvp) = models
    rng = np.random.default_rng(2)
    aa = (rng.normal(size=(5, 2, 22, 3)) * 0.4).astype(np.float32)
    trans = rng.normal(size=(5, 2, 3)).astype(np.float32)
    got = init_from_predictions(tvp, torch.from_numpy(aa), torch.from_numpy(trans))
    want = jba.init_from_predictions(jvp, jnp.asarray(aa), jnp.asarray(trans))
    for name, g, w in zip(FIELDS, got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _loss_fns(models, problem, cfg):
    (jsmplx, jvp), (tsmplx, tvp) = models
    _, kp, intr = problem
    jkp, jrobust = (jnp.stack([k.at[:, :, (1, 2), 2].mul(0.5) for k in (jnp.asarray(kp),) * 2],
                              axis=1),
                    jnp.asarray(kp)[..., 2].sum(axis=(1, 2)) > cfg.robust_conf_threshold)
    tkp, trobust = tba._observations(torch.from_numpy(kp), torch.from_numpy(kp), cfg)
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(trobust.numpy(), np.asarray(jrobust))
    return (jba_mod.make_loss_fn(jsmplx, jvp, jkp, jnp.asarray(intr), jrobust, cfg),
            tba.make_loss_fn(tsmplx, tvp, tkp, torch.from_numpy(intr), trobust, cfg))


def test_loss_terms_and_gradients_match_jax(models, problem):
    """Every term at the init, and every term's gradient with respect to
    every variable."""
    jloss, tloss = _loss_fns(models, problem, BAConfig())
    init = problem[0]
    leaves = [t.requires_grad_(True) for t in _tstate(init)]
    _, terms = tloss(BAState(*leaves))
    jterms, jgrads = jax.jit(lambda s: (jloss(s)[1], {
        t: jax.grad(lambda st, t=t: jloss(st)[1][t])(s) for t in terms}))(_jstate(init))
    assert set(terms) == set(jterms)
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), float(jterms[name]), rtol=1e-5, err_msg=name)
        grads = torch.autograd.grad(value, leaves, retain_graph=True, allow_unused=True)
        for field, g, jg in zip(FIELDS, grads, jgrads[name]):
            g = np.zeros(jg.shape, np.float32) if g is None else g.numpy()
            _close_to_largest(g, jg, 1e-4, f"d {name} / d {field}")


def test_adam_matches_optax():
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 32), (4, 2, 6), (10,))]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    adam = tba.Adam(0.01)
    state = adam.init(tparams)
    tx = optax.adam(0.01)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    for step in range(6):
        grads = [rng.normal(size=p.shape).astype(np.float32) * 0.5 ** step for p in params]
        adam.update([torch.from_numpy(g) for g in grads], state, tparams)
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


def test_bundle_adjust_matches_jax(models, problem):
    """10 + 20 iterations: the loss trace (the loss after each update), the
    final state and the final terms against JAX's."""
    (jsmplx, jvp), (tsmplx, tvp) = models
    init, kp, intr = problem
    state, info = bundle_adjust(tsmplx, tvp, _tstate(init), torch.from_numpy(kp),
                                torch.from_numpy(kp), torch.from_numpy(intr), CFG)
    jstate, jinfo = jba.bundle_adjust(jsmplx, jvp, _jstate(init), jnp.asarray(kp),
                                      jnp.asarray(kp), jnp.asarray(intr), CFG)
    assert info["trace"].shape == (30,) and np.isfinite(info["trace"]).all()
    np.testing.assert_allclose(info["trace"], jinfo["trace"], rtol=2e-4, atol=1e-5)
    assert info["trace"][-1] < info["trace"][0]
    for name in FIELDS:
        np.testing.assert_allclose(getattr(state, name).numpy(),
                                   np.asarray(getattr(jstate, name)), rtol=1e-3, atol=2e-4,
                                   err_msg=name)
    assert set(info) == set(jinfo)
    for k in jinfo:
        if k != "trace":
            np.testing.assert_allclose(info[k], jinfo[k], rtol=2e-4, atol=1e-5, err_msg=k)
    # stage 1 keeps z frozen: with no stage 2 it comes back as it went in
    frozen, _ = bundle_adjust(tsmplx, tvp, _tstate(init), torch.from_numpy(kp),
                              torch.from_numpy(kp), torch.from_numpy(intr),
                              BAConfig(iters_stage1=3, iters_stage2=0))
    assert torch.equal(frozen.z, _tstate(init).z) and not torch.equal(frozen.tau,
                                                                       _tstate(init).tau)


def _assert_reports_agree(rep, jrep):
    assert list(rep) == list(jrep)
    for term in jrep:
        v, jv = rep[term]["value"], jrep[term]["value"]
        assert np.isfinite(v) == np.isfinite(jv), term
        if np.isfinite(jv):
            np.testing.assert_allclose(v, jv, rtol=1e-5, err_msg=term)
        for field in FIELDS:
            g, jg = rep[term]["grads"][field], jrep[term]["grads"][field]
            assert g["finite"] == jg["finite"], (term, field)
            if jg["finite"]:
                np.testing.assert_allclose(g["norm"], jg["norm"], rtol=1e-4, atol=1e-7,
                                           err_msg=(term, field))


def test_ba_debug_report_matches_jax(models, problem, capsys):
    """Clean data: all finite; a poisoned OpenPose confidence: the data term
    and the total go non-finite, the regularisers' rows stay finite and
    equal to the clean ones; the poisoned report as JAX's, its finite
    entries within the bounds above."""
    (jsmplx, jvp), (tsmplx, tvp) = models
    init, kp, intr = problem
    bad = kp.copy()
    bad[0, 0, 0, 2] = np.inf
    clean = ba_debug_report(tsmplx, tvp, _tstate(init), torch.from_numpy(kp),
                            torch.from_numpy(kp), torch.from_numpy(intr))
    assert print_debug_report(clean) is True
    assert all(np.isfinite(r["value"]) and all(g["finite"] for g in r["grads"].values())
               for r in clean.values())
    rep = ba_debug_report(tsmplx, tvp, _tstate(init), torch.from_numpy(bad),
                          torch.from_numpy(kp), torch.from_numpy(intr))
    _assert_reports_agree(rep, jba.ba_debug_report(jsmplx, jvp, _jstate(init), jnp.asarray(bad),
                                                   jnp.asarray(kp), jnp.asarray(intr)))
    assert print_debug_report(rep) is False
    # the finite rows of the poisoned report are the clean report's
    for term in ("loss_vposer", "loss_beta"):
        assert rep[term] == clean[term], term
    assert not np.isfinite(rep["loss_2d"]["value"])
    assert not rep["loss_2d"]["grads"]["tau"]["finite"]
    assert rep["loss_beta"]["grads"]["beta"]["finite"]
    assert rep["loss_vposer"]["grads"]["z"]["finite"] and np.isfinite(rep["loss_vposer"]["value"])
    # a variable a term does not use: a zero, finite gradient
    assert rep["loss_beta"]["grads"]["z"] == {"norm": 0.0, "finite": True}
    assert "NON-FINITE" in capsys.readouterr().out


def test_export_results_matches_jax(models, problem):
    (jsmplx, jvp), (tsmplx, tvp) = models
    init = problem[0]
    got = export_results(tsmplx, tvp, _tstate(init))
    want = jba.export_results(jsmplx, jvp, _jstate(init))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["cam1_wrt_cam0"][:, 3], np.tile([0, 0, 0, 1.0], (12, 1)))
    plain = export_results(tsmplx, tvp, _tstate(init), use_kernels=False)
    for k in got:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)  # the CPU runs the plain one


def _outputs_from(init, tvp):
    """An outputs pkl (two batches) whose predictions give ``init``'s φ and τ:
    the roots as axis-angle, the body pose decoded from z."""
    from airpose_tpu_torch.bodymodel import vposer_decode
    from airpose_tpu_torch.geometry import rot6d_to_rotmat, rotmat_to_aa

    st = _tstate(init)
    with torch.no_grad():
        body = vposer_decode(tvp, st.z)["pose_body"]
        roots = rotmat_to_aa(rot6d_to_rotmat(st.phi))
    angles = torch.cat([roots[:, :, None], body[:, None].expand(-1, 2, -1, -1)], dim=2).numpy()
    rows = {f"pred_angles{v}": angles[:, v] for v in (0, 1)}
    rows.update({f"pred_smpltrans{v}": init[2][:, v] for v in (0, 1)})
    return [{"output": {k: a[s:e] for k, a in rows.items()}} for s, e in ((0, 7), (7, 12))]


class _Capture:
    """The reader's fields run_sequence reads: both keypoint sets per
    camera (2, N, 24, 3) and the intrinsics."""

    def __init__(self, kp, intr):
        self.opose = self.apose = kp.transpose(1, 0, 2, 3).copy()
        self.intr = intr

    def __len__(self):
        return self.opose.shape[1]


def test_run_sequence_across_chunk_boundaries(models, problem, capsys):
    """Chunks of 5 over 12 frames: each chunk's state equals bundle_adjust
    on that chunk alone, one β a chunk, the trace the chunks' traces, the
    export of the optimised states; --sharded's one span equals bundle_adjust
    over all frames."""
    _, (tsmplx, tvp) = models
    init, kp, intr = problem
    ds = _Capture(kp, intr)
    outputs = _outputs_from(init, tvp)
    start = tcr.outputs_to_ba_init(outputs, tvp)
    cfg = BAConfig(iters_stage1=2, iters_stage2=3)
    for sharded, spans in ((False, ((0, 5), (5, 10), (10, 12))), (True, ((0, 12),))):
        res = tba.run_sequence(tsmplx, tvp, ds, outputs, cfg, chunk_size=5, save_verts=True,
                               sharded=sharded)
        assert res["beta_per_chunk"].shape == (len(spans), 10)
        assert res["trace"].shape == (5 * len(spans),)
        assert res["verts0"].shape == (12, 150, 3) and res["cam1_wrt_cam0"].shape == (12, 4, 4)
        for i, (b, e) in enumerate(spans):
            want, info = bundle_adjust(
                tsmplx, tvp, BAState(start.z[b:e], start.phi[b:e], start.tau[b:e], start.beta),
                torch.from_numpy(kp[b:e]), torch.from_numpy(kp[b:e]), torch.from_numpy(intr),
                cfg)
            for name in ("z", "phi", "tau"):
                np.testing.assert_array_equal(res[name][b:e], getattr(want, name).numpy())
            np.testing.assert_array_equal(res["beta_per_chunk"][i], want.beta.numpy())
            np.testing.assert_array_equal(res["trace"][5 * i:5 * i + 5], info["trace"])
            exp = export_results(tsmplx, tvp, want)
            np.testing.assert_array_equal(res["cam1_wrt_cam0"][b:e], exp["cam1_wrt_cam0"])
            np.testing.assert_array_equal(res["verts1"][b:e], exp["verts1"])
    assert capsys.readouterr().out.count("final loss") == 4


def test_outputs_to_ba_init_matches_jax(models, problem):
    (_, jvp), (_, tvp) = models
    outputs = _outputs_from(problem[0], tvp)
    got = tcr.outputs_to_ba_init(outputs, tvp)
    from airpose_tpu.eval.compile_results import outputs_to_ba_init as j_outputs_to_ba_init

    want = j_outputs_to_ba_init(outputs, jvp)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, err_msg=name)


def test_cli_chain_compile_bundle_adjust_figures(tmp_path, capsys):
    """compile_results on real:// → bundle_adjust over chunks of 3 (the
    boundary crossed) and --sharded → figures over the pkls, each entry
    point as a user calls it (--platform cpu)."""
    from airpose_tpu_torch.eval.compile_results import main as compile_main

    ds = str(tmp_path / "real")
    os.makedirs(ds)
    _write_fake_real(ds, n=6)
    ap = str(tmp_path / "airpose.pkl")
    compile_main(["--model", "copenet_twoview", "--datapath", f"real://{ds}", "--split", "test",
                  "--test_frames", "0", "6", "--out", ap, "--batch_size", "4", "--img_res", "64",
                  "--synthetic_verts", "80", "--platform", "cpu"])
    common = ["--datapath", f"real://{ds}", "--airpose-pkl", ap, "--split", "test",
              "--test_frames", "0", "6", "--synthetic_verts", "80", "--platform", "cpu"]
    results = {}
    for tag, extra in (("chunked", ["--chunk-size", "3", "--iters1", "5", "--iters2", "10"]),
                       ("sharded", ["--sharded", "--iters1", "3", "--iters2", "5"])):
        out = str(tmp_path / tag)
        tba.main(common + ["--out", out, *extra])
        with open(os.path.join(out, "airpose_plus_test.pkl"), "rb") as f:
            results[tag] = pickle.load(f)
        assert os.path.getsize(os.path.join(out, "cam_trajectory_test.png")) > 1000
    chunked, sharded = results["chunked"], results["sharded"]
    assert chunked["z"].shape == (6, 32) and chunked["beta_per_chunk"].shape == (2, 10)
    assert chunked["cam1_wrt_cam0"].shape == (6, 4, 4) and chunked["trace"].shape == (30,)
    assert sharded["beta_per_chunk"].shape == (1, 10) and sharded["trace"].shape == (8,)
    for r in results.values():
        assert all(np.isfinite(v).all() for v in r.values())
    figs = str(tmp_path / "figs")
    tfig.main(["--results", f"AirPose={ap}", "--out", figs, "--platform", "cpu"])
    table = open(os.path.join(figs, "metrics.md")).read()
    assert "AirPose/test" in table and "crossview_consistency" in table
    assert os.path.getsize(os.path.join(figs, "cam_trajectory.png")) > 1000
    capsys.readouterr()
