"""``correct`` comes out false when the timed path is broken underneath a
run, and when the control (the next lower precision) stands in for it.
Each test skips the harness's look for a chip and drives the rest of a run
on the CPU at a small size."""

import pytest
import torch

from benchmark import harness

PERCEIVE = "perceive_int8_b64"


def _run(ctx):
    return harness.run(ctx, 0.3, False, 0.0)


# ---- perception ------------------------------------------------------------------

def test_perceive_altered_answer(monkeypatch, small_ctx):
    """One body's vertices moved by half a metre where they are produced."""
    import airpose_tpu_torch.perception as P

    real = P.perceive

    def altered(*a, **k):
        verts, j2d = real(*a, **k)
        verts = verts.clone()
        verts[0, 1] += 0.5
        return verts, j2d

    monkeypatch.setattr(P, "perceive", altered)
    assert not _run(small_ctx(PERCEIVE))["correct"]


def test_perceive_stale_features(monkeypatch, small_ctx):
    """The trunk hands back its first call's features for every later call:
    a step that returns its state unchanged."""
    import airpose_tpu_torch.perception as P

    real = P.chain_ops

    def stale_chain(*a, **k):
        f = real(*a, **k)
        first = {}

        def features(x, use_kernels=True):
            if "f" not in first:
                first["f"] = f(x, use_kernels=use_kernels)
            return first["f"]
        return features

    monkeypatch.setattr(P, "chain_ops", stale_chain)
    assert not _run(small_ctx(PERCEIVE))["correct"]


def test_perceive_half_the_batch(monkeypatch, small_ctx):
    """The trunk runs the first half of the crops and repeats them."""
    import airpose_tpu_torch.perception as P

    real = P.chain_ops

    def half_chain(*a, **k):
        f = real(*a, **k)

        def features(x, use_kernels=True):
            h = f(x[: x.shape[0] // 2], use_kernels=use_kernels)
            return torch.cat([h, h])
        return features

    monkeypatch.setattr(P, "chain_ops", half_chain)
    assert not _run(small_ctx(PERCEIVE))["correct"]


def test_perceive_int4_control(small_ctx):
    assert not _run(small_ctx(PERCEIVE, control="int4"))["correct"]


# ---- training ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["train_hmr_b30", "train_twoview_b30"])
def test_train_state_unchanged(monkeypatch, small_ctx, name):
    """AMSGrad's update does nothing: the step returns its state unchanged."""
    from airpose_tpu_torch.train.state import AMSGrad

    monkeypatch.setattr(AMSGrad, "update", lambda self, grads, state, params: None)
    r = _run(small_ctx(name))
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["train_hmr_b30", "train_twoview_b30"])
def test_train_state_unchanged_after_warmup(monkeypatch, small_ctx, name):
    """AMSGrad's update does nothing once the three steps of set-up are
    done: a fault that only the window's path has."""
    from airpose_tpu_torch.train.state import AMSGrad

    real = AMSGrad.update
    calls = []

    def update(self, grads, state, params):
        calls.append(1)
        if len(calls) <= 3:
            real(self, grads, state, params)

    monkeypatch.setattr(AMSGrad, "update", update)
    r = _run(small_ctx(name))
    assert not r["correct"]
    assert r["checks"]["change_norm_gap"]["value"] < r["checks"]["change_norm_gap"]["limit"]
    assert r["checks"]["last_change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["train_hmr_b30", "train_twoview_b30"])
def test_train_loss_not_finite_in_the_window(monkeypatch, small_ctx, name):
    """One step of the window returns a loss that is not finite."""
    from benchmark.drivers import train

    real = train.one_step
    calls = []

    def one_step(st):
        calls.append(1)
        loss = real(st)
        return loss * float("nan") if len(calls) == 4 else loss

    monkeypatch.setattr(train, "one_step", one_step)
    r = _run(small_ctx(name))
    assert not r["correct"]
    assert r["checks"]["nonfinite_losses"]["value"] == 1


@pytest.mark.parametrize("name", ["train_hmr_b30", "train_twoview_b30"])
def test_train_half_the_batch(small_ctx, name):
    """The step sees the first half of each batch, its mean over the rest."""
    r = _run(small_ctx(name, fault="half_batch"))
    assert not r["correct"]


@pytest.mark.parametrize("name", ["train_hmr_b30", "train_twoview_b30"])
def test_train_altered_loss(monkeypatch, small_ctx, name):
    """The loss is altered where it is produced."""
    import airpose_tpu_torch.train.losses as L

    fn = "hmr_loss" if name == "train_hmr_b30" else "twoview_loss"
    real = getattr(L, fn)

    def altered(*a, **k):
        total, metrics = real(*a, **k)
        return total * 1.01, dict(metrics, loss=metrics["loss"] * 1.01)

    monkeypatch.setattr(L, fn, altered)
    assert not _run(small_ctx(name))["correct"]


@pytest.mark.parametrize("name", ["train_hmr_b30", "train_twoview_b30"])
def test_train_int8_control(small_ctx, name):
    """The program's own int8 path (quantization-aware training) in place of
    the bf16 step: the next lower precision."""
    assert not _run(small_ctx(name, control="int8"))["correct"]


# ---- the served drone pair -------------------------------------------------------------

SERVE_SMALL = dict(crop=64, pool_frames=8, warmup_frames=3, trace_units=3, rate=5.0)


def _serve_ctx(small_ctx, **kw):
    ctx = small_ctx("serve_pair_int8", **kw)
    ctx.sizes.update(SERVE_SMALL)
    return ctx


def test_serve_altered_answer(monkeypatch, small_ctx):
    """Round 3's betas moved where the server produces them."""
    from airpose_tpu_torch.serve import staged

    real = staged.StagedRegressor.step23

    def altered(self, state, *a, **k):
        out = real(self, state, *a, **k)
        return out._replace(shape=out.shape + 1.0)

    monkeypatch.setattr(staged.StagedRegressor, "step23", altered)
    assert not harness.run(_serve_ctx(small_ctx), 1.0, False, 0.0)["correct"]


def test_serve_one_call_altered(monkeypatch, small_ctx):
    """One round of one drone in the window, of the 20 there, hands back
    a wrong shape: a fault that hits a few frames under load."""
    from airpose_tpu_torch.serve import staged

    real = staged.StagedRegressor.step23
    calls = []

    def altered(self, state, *a, **k):
        out = real(self, state, *a, **k)
        calls.append(1)
        return out._replace(shape=out.shape + 1.0) if len(calls) == 17 else out

    monkeypatch.setattr(staged.StagedRegressor, "step23", altered)
    r = harness.run(_serve_ctx(small_ctx), 1.0, False, 0.0)
    assert len(calls) > 17 and not r["correct"], r["checks"]


def test_serve_state_unchanged(monkeypatch, small_ctx):
    """Rounds 2 and 3 hand back the state they were given."""
    from airpose_tpu_torch.serve import staged

    monkeypatch.setattr(staged.StagedRegressor, "step23", lambda self, state, *a, **k: state)
    assert not harness.run(_serve_ctx(small_ctx), 1.0, False, 0.0)["correct"]


def test_serve_int4_control(small_ctx):
    assert not harness.run(_serve_ctx(small_ctx, control="int4"), 1.0, False, 0.0)["correct"]


def test_serve_agrees_with_the_reference(small_ctx):
    r = harness.run(_serve_ctx(small_ctx), 1.0, False, 0.0)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 5
