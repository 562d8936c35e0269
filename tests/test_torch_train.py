"""Port parity: the two-view training step (airpose_tpu_torch.train vs
airpose_tpu.train on the same numpy inputs and weights, on the CPU, f32).

Tolerances, each with its reason:
  - AMSGrad: rtol 1e-6 over 5 steps, both f32 with the same f32 bias
    corrections (a few roundings apart);
  - one train-mode Bottleneck: output and gradients rtol 1e-4 of each
    tensor's largest entry (f32 convolutions summed in other orders),
    running statistics rtol 1e-5 (the batch moments of those outputs);
  - gradients of twoview_loss through the IEF and SMPL-X: rtol 1e-4 of each
    gradient's largest entry (f32 sums in other orders through 3 IEF steps
    and the SMPL-X forward);
  - the f32 trunk in train mode: the port within rel-L2 2e-4 of an f64
    forward, JAX's within 2e-3 (measured 8.9e-5 and 1.1e-3 at 64 px: flax
    takes the batch variance as E[x²] − E[x]² in f32, which loses digits
    where a channel's mean is large against its spread, and layer4 sees
    16 samples a channel here);
  - one whole train step (f32 trunk at 64 px), bounded by that JAX error:
    the loss terms within rtol 2e-3 (measured ≤ 7.7e-4), each running
    statistic within rel-L2 2e-3 of JAX's (measured ≤ 7.6e-4), and the
    parameter update equal (rtol 1e-3) on ≥ 99.9% of the entries whose
    gradient is above 0.1 of its tensor's largest (an Adam step is
    ≈ lr·sign(g); measured 4.7e-5 of them flip, where JAX's gradient is
    1e-3 off);
  - eval_step's predictions before the step: atol 1e-4, the bound of
    tests/test_torch_models.py for the same forward.
Dropout is off on both sides where the packages are compared (its masks
cannot match across frameworks), through test-local replacements: of the
port's ``dropout`` in airpose_tpu_torch.models.regressor, and of flax's
Dropout as airpose_tpu.models.regressor sees it."""

import copy
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import airpose_tpu.models.regressor as jregressor
import airpose_tpu_torch.models.regressor as tregressor
from airpose_tpu.bodymodel import synthetic_smplx_params as j_synthetic
from airpose_tpu.config import TrainConfig as JTrainConfig
from airpose_tpu.data import make_synthetic_dataset
from airpose_tpu.models import AirPoseTwoView as JAirPoseTwoView
from airpose_tpu.models.resnet import Bottleneck as JBottleneck
from airpose_tpu.train import make_twoview_step_fns as j_step_fns
from airpose_tpu.train import losses as JL
from airpose_tpu.train.checkpoint import convert_reference_checkpoint
from airpose_tpu.train.state import TrainState as JTrainState
from airpose_tpu.train.state import make_optimizer as j_make_optimizer
from airpose_tpu_torch.bodymodel import synthetic_smplx_params
from airpose_tpu_torch.config import LossWeights, TrainConfig
from airpose_tpu_torch.data import batch_slice
from airpose_tpu_torch.models import AirPoseTwoView
from airpose_tpu_torch.models.resnet import Bottleneck
from airpose_tpu_torch.train import (AMSGrad, create_train_state, make_optimizer,
                                     make_twoview_step_fns, twoview_loss)

B, V, IMG = 2, 222, 64


def _rel_close(got, want, rtol, what=""):
    """Every entry within rtol of the tensor's largest |entry|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(),
                               err_msg=what)


@pytest.fixture(scope="module")
def smplx_pair():
    return j_synthetic(num_vertices=V, seed=3), synthetic_smplx_params(num_vertices=V, seed=3)


@pytest.fixture(scope="module")
def data(smplx_pair):
    return make_synthetic_dataset(smplx_pair[0], num_samples=B, seed=5, img_size=IMG,
                                  blob_sigma=3.0)


def _reference_sd(model):
    return {"model." + (k.split(".", 1)[1] if k.startswith(("trunk.", "core.")) else k): v
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def twoview_pair():
    """A seeded port model and the flax variables carrying its weights."""
    model = AirPoseTwoView(seed=0)
    return model, convert_reference_checkpoint(_reference_sd(model))


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(tregressor, "dropout", lambda h, rate, generator: h)

    class NoDropout(fnn.Dropout):
        def __call__(self, inputs, deterministic=None, rng=None):
            return inputs

    monkeypatch.setattr(jregressor, "nn", types.SimpleNamespace(
        **{k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("_") and k != "Dropout"},
        Dropout=NoDropout))


# ---- optimizer ---------------------------------------------------------------

def _shrinking_grads(rng, shape, steps=5):
    """Gradients of fixed sign per entry whose size halves at every step:
    the regime where the AMSGrad maximum holds an early moment."""
    base = rng.normal(size=shape).astype(np.float32)
    return [(base * 0.5 ** t).astype(np.float32) for t in range(steps)]


def test_amsgrad_matches_optax(rng):
    gs = _shrinking_grads(rng, (64,))
    p = {"w": torch.zeros(64)}
    tx = AMSGrad(5e-5)
    st = tx.init(p)
    jp, jtx = jnp.zeros(64), optax.amsgrad(5e-5, b1=0.9, b2=0.999, eps=1e-8)
    js = jtx.init(jp)
    for g in gs:
        before = p["w"].clone()
        tx.update({"w": torch.from_numpy(g)}, st, p)
        u, js = jtx.update(jnp.asarray(g), js, jp)
        jp = jp + u
        np.testing.assert_allclose((p["w"] - before).numpy(), np.asarray(u), rtol=1e-6)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp), rtol=1e-6)
    assert st["count"] == 5


def test_torch_adam_amsgrad_is_not_optax_amsgrad(rng):
    """torch's AMSGrad keeps the max of the raw second moment: on shrinking
    gradients it moves the parameters far from optax's (and the port's)."""
    gs = _shrinking_grads(rng, (64,))
    w = torch.zeros(64, requires_grad=True)
    opt = torch.optim.Adam([w], lr=5e-5, betas=(0.9, 0.999), eps=1e-8, amsgrad=True)
    p = {"w": torch.zeros(64)}
    tx = AMSGrad(5e-5)
    st = tx.init(p)
    for g in gs:
        w.grad = torch.from_numpy(g)
        opt.step()
        tx.update({"w": torch.from_numpy(g)}, st, p)
    rel = (w.detach() - p["w"]).abs() / p["w"].abs()
    assert rel.min().item() > 0.05  # measured 0.2-0.35 on every entry


def test_train_reg_only_freezes_the_trunk(smplx_pair, data):
    _, smplx_params = smplx_pair
    model = AirPoseTwoView(seed=2)
    state, tx = create_train_state(model, 1e-3, train_reg_only=True)
    assert set(state.opt_state["mu"]) == {n for n in state.params if n.startswith("core.")}
    before = {n: t.clone() for n, t in {**state.params, **state.batch_stats}.items()}
    train_step, _ = make_twoview_step_fns(model, smplx_params, TrainConfig(batch_size=B), tx,
                                          device="cpu")
    state, metrics = train_step(state, batch_slice(data, 0, B, "cpu"),
                                torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(metrics["loss"].item())
    for n, t in state.params.items():
        if n.startswith("trunk."):
            assert torch.equal(t, before[n]), n
    assert all(not torch.equal(state.params[n], before[n]) for n in state.opt_state["mu"])
    # the forward is in train mode: BatchNorm's running statistics move
    assert not torch.equal(state.batch_stats["trunk.bn1.running_mean"],
                           before["trunk.bn1.running_mean"])
    assert make_optimizer(1e-3).trainable("trunk.conv1.weight")


# ---- train-mode trunk ----------------------------------------------------------

def test_bottleneck_train_mode_matches_flax(rng):
    """A stride-2 projection block in train mode: output, the updated
    running statistics (flax's biased batch variance, momentum 0.9) and the
    gradients of the input and every parameter."""
    N, H, cin, planes = 3, 8, 16, 8
    jblk = JBottleneck(planes=planes, stride=2, project=True)
    x = rng.normal(size=(N, H, H, cin)).astype(np.float32)
    variables = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    for name in stats:  # move BatchNorm off its init
        params[name]["scale"] = rng.uniform(0.5, 1.5, params[name]["scale"].shape).astype(np.float32)
        params[name]["bias"] = rng.normal(0, 0.1, params[name]["bias"].shape).astype(np.float32)
        stats[name]["mean"] = rng.normal(0, 0.1, stats[name]["mean"].shape).astype(np.float32)
        stats[name]["var"] = rng.uniform(0.5, 1.5, stats[name]["var"].shape).astype(np.float32)

    blk = Bottleneck(cin, planes, stride=2, project=True)
    names = {"conv1": "conv1", "conv2": "conv2", "conv3": "conv3",
             "downsample_conv": "downsample.0"}
    bns = {"bn1": "bn1", "bn2": "bn2", "bn3": "bn3", "downsample_bn": "downsample.1"}
    sd = {f"{t}.weight": torch.from_numpy(params[j]["kernel"].transpose(3, 2, 0, 1).copy())
          for j, t in names.items()}
    for j, t in bns.items():
        sd.update({f"{t}.weight": torch.from_numpy(params[j]["scale"]),
                   f"{t}.bias": torch.from_numpy(params[j]["bias"]),
                   f"{t}.running_mean": torch.from_numpy(stats[j]["mean"].copy()),
                   f"{t}.running_var": torch.from_numpy(stats[j]["var"].copy()),
                   f"{t}.num_batches_tracked": torch.zeros((), dtype=torch.long)})
    blk.load_state_dict(sd)

    r = rng.normal(size=(N, H // 2, H // 2, planes * 4)).astype(np.float32)

    def jloss(p, x):
        y, mut = jblk.apply({"params": p, "batch_stats": stats}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (jg, jgx), (jy, jstats) = jax.jit(jax.grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = blk(xt, train=True)
    tparams = dict(blk.named_parameters())
    grads = torch.autograd.grad((y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum(),
                                [xt] + list(tparams.values()))
    g = dict(zip(tparams, grads[1:]))

    _rel_close(y.detach().permute(0, 2, 3, 1).numpy(), jy, 1e-4, "output")
    _rel_close(grads[0].permute(0, 2, 3, 1).numpy(), jgx, 1e-4, "d input")
    for j, t in names.items():
        _rel_close(g[f"{t}.weight"].permute(2, 3, 1, 0).numpy(), jg[j]["kernel"], 1e-4, j)
    for j, t in bns.items():
        _rel_close(g[f"{t}.weight"].numpy(), jg[j]["scale"], 1e-4, j + " scale")
        _rel_close(g[f"{t}.bias"].numpy(), jg[j]["bias"], 1e-4, j + " bias")
        bn = blk.get_submodule(t)
        np.testing.assert_allclose(bn.running_mean.numpy(), jstats[j]["mean"], rtol=1e-5,
                                   atol=1e-7, err_msg=j)
        np.testing.assert_allclose(bn.running_var.numpy(), jstats[j]["var"], rtol=1e-5,
                                   err_msg=j)
    # torch's own BatchNorm keeps the unbiased variance, n/(n−1) larger: at
    # bn3's n = 3·4·4 = 48 samples a channel that misses flax's rule
    plain = torch.nn.BatchNorm2d(planes * 4, momentum=0.1)
    plain.running_var.copy_(torch.from_numpy(stats["bn3"]["var"]))
    plain(torch.randn(N, planes * 4, 4, 4))
    z = torch.randn(N, planes * 4, 4, 4)
    ours = copy.deepcopy(blk.bn3)
    ours.running_var.copy_(plain.running_var)
    ref = copy.deepcopy(plain)
    ours(z, train=True)
    ref(z)
    biased = z.var(dim=(0, 2, 3), unbiased=False)
    kept = 0.9 * plain.running_var
    torch.testing.assert_close(ours.running_var, kept + 0.1 * biased, rtol=1e-6, atol=0)
    assert not torch.allclose(ref.running_var, kept + 0.1 * biased, rtol=1e-4, atol=0)


def test_trunk_bf16_train_mode_keeps_f32_statistics():
    """A bf16 trunk in train mode: bf16 activations, f32 running statistics
    (torch takes the bf16 input with f32 affine parameters, as cuDNN does)."""
    model = AirPoseTwoView(dtype=torch.bfloat16, seed=0)
    x = torch.randn(2, 2, 32, 32, 3)
    out = model(x, torch.zeros(2, 2, 3), torch.full((2, 2, 3), 0.5), train=True,
                generator=torch.Generator().manual_seed(0))
    assert out.pose.dtype == torch.float32 and torch.isfinite(out.pose).all()
    bn = model.trunk.layer4[2].bn3
    assert bn.running_var.dtype == torch.float32
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_trunk_train_mode_against_f64(smplx_pair, data, twoview_pair):
    """Train-mode features of the f32 trunk in both packages against the
    port's trunk run in f64 on the same weights and crops."""
    from airpose_tpu.models.resnet import ResNet50 as JResNet50

    model, variables = twoview_pair
    x = np.array(data["images"].reshape(B * 2, IMG, IMG, 3))
    jf, _ = jax.jit(lambda v, x: JResNet50().apply(v, x, train=True, mutable=["batch_stats"]))(
        {"params": variables["params"]["trunk"],
         "batch_stats": variables["batch_stats"]["trunk"]}, jnp.asarray(x))
    trunk = copy.deepcopy(model.trunk)
    tf = trunk(torch.from_numpy(x), train=True).detach()
    trunk64 = copy.deepcopy(model.trunk).double()
    trunk64.dtype = torch.float64
    f64 = trunk64(torch.from_numpy(x).double(), train=True).detach()
    port = ((tf.double() - f64).norm() / f64.norm()).item()
    flax = ((torch.from_numpy(np.array(jf)).double() - f64).norm() / f64.norm()).item()
    assert port <= 2e-4 and flax <= 2e-3, (port, flax)


# ---- dropout -------------------------------------------------------------------

def test_dropout_is_flax_dropout_from_the_generator():
    """Keep with probability 0.5 and scale by 2, masks from the generator
    passed in (the same seed, the same masks), never without one."""
    model = AirPoseTwoView(seed=0)
    xc = torch.ones(4000, 2332)
    h = model.core.fc1(xc)
    outs = [model.core(xc, train=True, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(outs[0][0], outs[1][0]) and not torch.equal(outs[0][0], outs[2][0])
    from airpose_tpu_torch.models.regressor import dropout
    d = dropout(h, 0.5, torch.Generator().manual_seed(3))
    kept = d != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    torch.testing.assert_close(d[kept], 2 * h[kept], rtol=0, atol=0)
    with pytest.raises(ValueError, match="Generator"):
        model.core(xc, train=True)
    ev = model.core(xc)  # eval: no dropout, no generator needed
    torch.testing.assert_close(ev[0], model.core(xc, train=False)[0])


# ---- gradients through IEF + SMPL-X ----------------------------------------------

def test_twoview_loss_gradients_through_from_features_match_jax(smplx_pair, data,
                                                                twoview_pair):
    """d twoview_loss / d (regressor weights, trunk features) through the
    3-step IEF (eval mode: no dropout on either side) and the SMPL-X forward."""
    jsmplx, tsmplx = smplx_pair
    model, variables = twoview_pair
    rng = np.random.default_rng(4)
    xf = rng.normal(size=(B, 2, 2048)).astype(np.float32)
    pos = np.asarray([[[0.05, -0.1, 0.5], [0.0, 0.1, 0.55]]] * B, np.float32)
    jmodel = JAirPoseTwoView()

    def jloss(core, xf):
        out = jmodel.apply({"params": {**variables["params"], "core": core},
                            "batch_stats": variables["batch_stats"]},
                           xf, jnp.asarray(data["bb"]), jnp.asarray(pos),
                           method=JAirPoseTwoView.from_features)
        return JL.twoview_loss(out.pose, out.betas, {k: jnp.asarray(v) for k, v in data.items()},
                               jsmplx, JL.LossWeights())[0]

    jval, (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        variables["params"]["core"], jnp.asarray(xf))

    core = dict(model.core.named_parameters())
    xt = torch.from_numpy(xf).requires_grad_(True)
    out = model.from_features(xt, torch.from_numpy(np.array(data["bb"])), torch.from_numpy(pos))
    loss, _ = twoview_loss(out.pose, out.betas, batch_slice(data, 0, B, "cpu"), tsmplx,
                           LossWeights())
    grads = torch.autograd.grad(loss, [xt] + list(core.values()))
    np.testing.assert_allclose(loss.item(), float(jval), rtol=1e-5)
    _rel_close(grads[0].numpy(), jgx, 1e-4, "d xf")
    for (name, _), gt in zip(core.items(), grads[1:]):
        layer, kind = name.split(".")
        want = jg[layer]["kernel"].T if kind == "weight" else jg[layer]["bias"]
        _rel_close(gt.numpy(), want, 1e-4, name)


# ---- the whole step ---------------------------------------------------------------

def test_train_and_eval_step_match_jax(smplx_pair, data, twoview_pair, no_dropout):
    """One make_twoview_step_fns step on both packages from the same weights
    (carried by convert_reference_checkpoint / state_dict_from_flax) and the
    same batch, dropout off; eval_step before it, on both, and after it."""
    from airpose_tpu_torch.train import state_dict_from_flax

    jsmplx, tsmplx = smplx_pair
    _, variables = twoview_pair
    model = AirPoseTwoView(seed=7)
    from airpose_tpu_torch.train import load_reference_state_dict
    load_reference_state_dict(model, state_dict_from_flax(variables))
    cfg, jcfg = TrainConfig(batch_size=B), JTrainConfig(batch_size=B)
    batch = batch_slice(data, 0, B, "cpu")

    # the port's gradients, for the entries where one Adam step shows them
    probe = copy.deepcopy(model)
    in_trans = torch.tensor([0.0, 0.0, 10.0 * cfg.trans_scale]).expand(B, 2, 3)
    out = probe(batch["images"], batch["bb"], in_trans, train=True,
                generator=torch.Generator().manual_seed(0))
    grads = dict(zip(dict(probe.named_parameters()), torch.autograd.grad(
        twoview_loss(out.pose, out.betas, batch, tsmplx, cfg.loss)[0],
        list(probe.parameters()))))

    state, tx = create_train_state(model, cfg.lr)
    train_step, eval_step = make_twoview_step_fns(model, tsmplx, cfg, tx, device="cpu")
    jtx = j_make_optimizer(jcfg.lr)
    jstate = JTrainState(step=0, params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=jtx.init(variables["params"]))
    j_train, j_eval = j_step_fns(JAirPoseTwoView(), jsmplx, jcfg, jtx)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}

    jm, jp = j_eval(jstate, jbatch)
    tm, tp = eval_step(state, batch)
    for k in ("pred_trans", "pred_rotmat", "pred_betas"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = train_step(state, batch, torch.Generator().manual_seed(0))
    jstate, jmetrics = j_train(jstate, jbatch, jax.random.PRNGKey(0))
    assert state.step == 1 and int(jstate.step) == 1
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-3, err_msg=k)

    jsd = state_dict_from_flax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    shown = same = n_stats = 0
    for key, want in jsd.items():
        name = key[len("model."):]
        name = name if name.startswith("init_") else (
            ("core." if name.split(".")[0] in ("fc1", "fc2", "decpose", "decshape") else "trunk.")
            + name)
        if name in state.batch_stats and "num_batches" not in name:
            got = state.batch_stats[name]
            assert ((got - want).norm() / want.norm()).item() <= 2e-3, name
            n_stats += 1
        elif name in state.params:
            g = grads[name].abs()
            mask = g > 0.1 * g.max()
            d_port = (state.params[name] - before[name])[mask]
            d_jax = (want - before[name])[mask]
            shown += int(mask.sum())
            same += int(((d_port - d_jax).abs() <= 1e-3 * d_jax.abs()).sum())
    assert n_stats == 106 and shown > 1_000_000
    assert same >= 0.999 * shown, (same, shown)
    _, preds = eval_step(state, batch)
    assert preds["pred_rotmat"].shape == (B, 2, 22, 3, 3)
    assert torch.isfinite(preds["pred_rotmat"]).all()
