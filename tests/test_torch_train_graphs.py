"""The train step as a CUDA graph (train/loop.py ``_TrainStep``): on a card a
step's forward, loss and gradients run eagerly at the first call of a key,
are captured at a second call in a row and replayed from then on; AMSGrad
stays eager. Imports neither JAX nor airpose_tpu, so that on a machine with
a card the tests run with

  python -m pytest tests/test_torch_train_graphs.py --noconftest -q

The tests marked ``cuda`` hold six replayed steps of the two-view and HMR
steps at B = 30 with the bf16 trunk bit for bit to six eager steps from the
same weights, batches and generator seed (losses, parameters, AMSGrad's
moments, BatchNorm's running statistics), and check a reseeded generator,
fresh metric tensors, a batch of another shape, a rebound parameter, the
counters and skinning's launch count; they skip where no CUDA device is
present. On the CPU every step runs eagerly, and a graph can only be
captured if no op of the step makes a tensor from host data or reads a
value back: that is checked here for every family's step on the CPU, as is
the skinning chain's cached index tables against the list-indexed form."""

import copy

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from airpose_tpu_torch import device_constant
from airpose_tpu_torch.bodymodel import init_vposer_params, lbs, synthetic_smplx_params
from airpose_tpu_torch.bodymodel.smpl import SMPL_PARENTS
from airpose_tpu_torch.config import TrainConfig
from airpose_tpu_torch.data import batch_slice, make_synthetic_dataset
from airpose_tpu_torch.models import MODEL_REGISTRY
from airpose_tpu_torch.ops import _build
from airpose_tpu_torch.parallel.mesh import Mesh
from airpose_tpu_torch.train import (create_train_state, losses, make_real_singleview_step_fns,
                                     make_real_twoview_step_fns, make_singleview_step_fns,
                                     make_twoview_step_fns)

# ops that read a device value back to the host (a capture cannot wait on one)
HOST_READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select", "aten.equal",
              "aten.is_nonzero", "aten._unique", "aten.unique", "aten.bincount",
              "aten.repeat_interleave.Tensor")


class HostTraffic(TorchDispatchMode):
    """Records the ops that make a tensor from host data (``lift_fresh``:
    ``torch.tensor``, ``as_tensor`` of numbers, a list used as an index) or
    read a device value back (``HOST_READS``, a boolean-mask index)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops += 1
        masks = [i for i in (args[1] if name.startswith(("aten.index.", "aten.index_put"))
                             else ()) if torch.is_tensor(i) and i.dtype == torch.bool]
        if "lift_fresh" in name or name.startswith(HOST_READS) or masks:
            self.found.append(name)
        return func(*args, **(kwargs or {}))


# ---- the CPU: what a capture needs of every family's step -----------------------------

B, IMG = 2, 64


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the tier runs six
    pytest workers on the machine's cores, and a worker whose torch uses
    every core oversubscribes them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def body():
    return synthetic_smplx_params(num_vertices=222, seed=3)


@pytest.fixture(scope="module")
def batch(body):
    torch.manual_seed(0)
    return batch_slice(make_synthetic_dataset(body, B, seed=0, img_size=IMG), 0, B, "cpu")


def real_batch(batch):
    """A real-data batch (no 3D GT) on the synthetic batch's crops."""
    rng = np.random.default_rng(9)
    n = batch["images"].shape[0]
    intr = np.tile(np.asarray([[1537.0, 0, 1018.0], [0, 1517.0, 577.0], [0, 0, 1]]), (n, 2, 1, 1))
    uv = np.stack([rng.uniform(850, 1150, (n, 2, 22)), rng.uniform(400, 750, (n, 2, 22))], -1)
    crop = rng.normal(size=(n, 2, 24, 2)) * 20.0
    arrays = {"intr": intr,
              "gt_j2d_conf": np.concatenate([uv, rng.uniform(0, 1, (n, 2, 22, 1))], -1),
              "gt_j2d_crop_conf": np.concatenate([crop, rng.uniform(0, 1, (n, 2, 24, 1))], -1),
              "focal": np.asarray([[1537.0, 1517.0], [1530.0, 1510.0]])}
    return {"images": batch["images"], "bb": batch["bb"],
            **{k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}}


def frozen_scales(model):
    """A per-conv activation step for every fake-quant site of the trunk."""
    return {f"{m.site}/{conv}": 0.05 for m in model.modules() if hasattr(m, "site")
            for conv in ("conv1", "conv2", "conv3", "proj")}


def cpu_step(variant, body, batch):
    """(train_step, state, batch, call args) of one variant on the CPU."""
    family = {"hmr": "hmr", "copenet_singleview": "copenet_singleview", "muhmr": "muhmr",
              "twoview_sep": "copenet_twoview_sep", "real_hmr_camswap_difffl": "hmr",
              "real_spin": "hmr"}.get(variant, "copenet_twoview")
    kw = {"dtype": torch.bfloat16} if family in ("copenet_twoview", "hmr") else {}
    if variant == "twoview_qat_dynamic":
        kw["act_fq"] = 127.0
    model = MODEL_REGISTRY[family](seed=0, **kw)
    if variant == "twoview_qat_frozen":
        model = MODEL_REGISTRY[family](seed=0, act_fq=(127.0, frozen_scales(model)))
    cfg = TrainConfig(batch_size=B, model=family, img_res=IMG,
                      qat=variant.startswith("twoview_qat"),
                      smpltrans_noise_sigma=0.1 if variant == "twoview_noise" else None)
    state, tx = create_train_state(model, cfg.lr)
    args = ()
    if variant.startswith("real_"):
        vposer = init_vposer_params(0)
        batch = real_batch(batch)
        if variant == "real_twoview":
            step, _ = make_real_twoview_step_fns(model, body, vposer, cfg, tx, device="cpu")
        else:
            step, _ = make_real_singleview_step_fns(model, body, vposer, cfg, tx,
                                                    variant[len("real_"):], device="cpu")
            args = (1,) if variant == "real_hmr_camswap_difffl" else ()
    elif family in ("copenet_twoview", "copenet_twoview_sep"):
        loss = None
        if variant == "twoview_joints":  # cam-frame H36M joints, no SMPL-X GT
            loss, g = losses.joints_loss, torch.Generator().manual_seed(2)
            joints = torch.randn(B, 2, 17, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, 8.0])
            batch = {**batch, "gt_joints": joints,
                     "gt_j2d": joints[..., :2] / joints[..., 2:] * 1475.0 + 512.0}
        step, _ = make_twoview_step_fns(model, body, cfg, tx, loss=loss, device="cpu")
    else:
        step, _ = make_singleview_step_fns(model, body, cfg, tx, family, device="cpu")
    return step, state, batch, args


VARIANTS = ("twoview", "twoview_sep", "twoview_joints", "twoview_noise", "twoview_qat_dynamic",
            "twoview_qat_frozen", "hmr", "copenet_singleview", "muhmr", "real_twoview",
            "real_hmr_camswap_difffl", "real_spin")


@pytest.mark.parametrize("variant", VARIANTS)
def test_step_takes_nothing_from_the_host(body, batch, variant):
    """After its first call, no op of a train step makes a tensor from host
    data or reads a device value back, so the step can be captured."""
    step, state, batch, args = cpu_step(variant, body, batch)
    gen = torch.Generator().manual_seed(0)
    step(state, batch, gen, *args)
    traffic = HostTraffic()
    with traffic:
        step(state, batch, gen, *args)
    assert traffic.ops > 500, traffic.ops
    assert traffic.found == [], sorted(set(traffic.found))


@pytest.mark.parametrize("mesh", [None, Mesh({"data": 1}), Mesh({"data": 2})],
                         ids=["no_mesh", "mesh1", "mesh2"])
def test_cpu_steps_never_capture(body, batch, mesh):
    """A CPU step, under a mesh or not, runs eagerly every time, and returns
    fresh metric tensors each step."""
    model = MODEL_REGISTRY["copenet_twoview"](seed=0)
    cfg = TrainConfig(batch_size=B, img_res=IMG)
    state, tx = create_train_state(model, cfg.lr)
    step, _ = make_twoview_step_fns(model, body, cfg, tx, device="cpu", mesh=mesh)
    gen = torch.Generator().manual_seed(0)
    losses_seen = [step(state, batch, gen)[1]["loss"] for _ in range(3)]
    assert (step.eager_steps, step.graph_replays, state.step) == (3, 0, 3)
    assert len({t.data_ptr() for t in losses_seen}) == 3


def _rigid_transform_by_lists(rotmats, joints, parents):
    """batch_rigid_transform's chain with Python lists as indices (its form
    before the index tables were cached on the device)."""
    B, J = joints.shape[:2]
    parents = tuple(int(p) for p in parents)
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, list(parents[1:])]], dim=1)
    top = torch.cat([rotmats, rel[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype).expand(B, J, 1, 4)
    local = torch.cat([top, bottom], dim=-2)
    world = local.clone()
    for js, ps in lbs._tree_levels(parents):
        world[:, list(js)] = torch.matmul(world[:, list(ps)], local[:, list(js)])
    correction = torch.einsum("bjJK,bjK->bjJ", world[..., :3, :3], joints)
    rel_tf = world.clone()
    rel_tf[..., :3, 3] -= correction
    return world[..., :3, 3], rel_tf


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("parents", [synthetic_smplx_params(num_vertices=60).parents,
                                     SMPL_PARENTS], ids=["smplx", "smpl"])
def test_rigid_transform_index_tables_bit_equal(parents, dtype):
    """The cached device index tables give the list-indexed chain's joints,
    transforms and gradients bit for bit."""
    g = torch.Generator().manual_seed(1)
    J = len(parents)
    rot = lbs.batch_rodrigues(torch.randn(3 * J, 3, generator=g, dtype=dtype)).reshape(3, J, 3, 3)
    joints = torch.randn(3, J, 3, generator=g, dtype=dtype)
    weights = [torch.randn(3, J, 3, generator=g, dtype=dtype),
               torch.randn(3, J, 4, 4, generator=g, dtype=dtype)]
    results = []
    for fn in (lbs.batch_rigid_transform, _rigid_transform_by_lists):
        r, j = rot.clone().requires_grad_(True), joints.clone().requires_grad_(True)
        outs = fn(r, j, parents)
        total = sum((o * w).sum() for o, w in zip(outs, weights))
        results.append((*outs, *torch.autograd.grad(total, (r, j))))
    for got, want in zip(*results):
        assert torch.equal(got, want)


def test_host_constants_are_made_once():
    """device_constant shares one tensor per (values, dtype, device), equal
    to torch.tensor's; the limb weights and focal lengths equal their
    fresh forms."""
    a = device_constant((0.0, 0.0, 10.0), torch.float32, "cpu")
    assert a is device_constant((0.0, 0.0, 10.0), torch.float32, torch.device("cpu"))
    assert a is not device_constant((0.0, 0.0, 10.0), torch.float64, "cpu")
    assert torch.equal(a, torch.tensor([0.0, 0.0, 10.0]))
    like = torch.zeros(1)
    for n, l1, l2, w in ((22, (4, 5, 18, 19), (7, 8, 20, 21), 1.7),
                         (21, (3, 4, 17, 18), (6, 7, 19, 20), 0.3)):
        fresh = torch.ones(n)
        fresh[list(l1)] = w
        fresh[list(l2)] = w ** 2
        assert torch.equal(losses._limb_weights(n, l1, l2, w, like), fresh)
    assert torch.equal(losses._focal((1475.0, 1475.0), like), torch.tensor([1475.0, 1475.0]))
    per_view = torch.tensor([[1537.0, 1517.0], [1530.0, 1510.0]])
    assert losses._focal(per_view, like) is per_view


# ---- the card: replays against eager steps ---------------------------------------------

CARD_B, STEPS = 30, 7  # 7 calls: the eager first, the capture, 5 replays


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card(cuda):
    """The SMPL-X body and STEPS + 2 distinct B = 30 batches of 224² on the card."""
    body = synthetic_smplx_params().to(cuda)
    data = make_synthetic_dataset(body, CARD_B * (STEPS + 2), seed=0)
    return body, [batch_slice(data, i * CARD_B, CARD_B, cuda) for i in range(STEPS + 2)]


def card_pair(card, family, mesh=None):
    """Two bf16 models of ``family`` on the same seed-0 weights, each with
    its TrainState: → (graphed step, its state, a factory of fresh steps
    over the twin, the twin's state). A fresh step object's first call
    always runs eagerly."""
    body, _ = card
    model = MODEL_REGISTRY[family](seed=0, dtype=torch.bfloat16).to("cuda")
    twin = copy.deepcopy(model)
    cfg = TrainConfig(batch_size=CARD_B, model=family)

    def steps(m):
        state, tx = create_train_state(m, cfg.lr)
        if family == "hmr":
            return lambda: make_singleview_step_fns(m, body, cfg, tx, "hmr", mesh=mesh)[0], state
        return lambda: make_twoview_step_fns(m, body, cfg, tx, mesh=mesh)[0], state

    make, state = steps(model)
    make_twin, twin_state = steps(twin)
    return make(), state, make_twin, twin_state


def assert_states_equal(a, b):
    for part in ("params", "batch_stats"):
        for n, t in getattr(a, part).items():
            assert torch.equal(t, getattr(b, part)[n]), (part, n)
    for k in ("mu", "nu", "nu_max"):
        for n, t in a.opt_state[k].items():
            assert torch.equal(t, b.opt_state[k][n]), (k, n)
    assert a.opt_state["count"] == b.opt_state["count"]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["copenet_twoview", "hmr"])
def test_replays_equal_eager_steps(card, family):
    """Seven calls of one step (eager, capture, five replays) against seven
    fresh, eager steps: every loss term bit for bit, each metric a tensor
    of its own; then both generators reseeded and one more step each; the
    parameters, AMSGrad's moments and BatchNorm's statistics bit for bit;
    skinning launched at the eager call and the capture only."""
    _, batches = card
    step, state, make_twin, twin_state = card_pair(card, family)
    gen = torch.Generator(device="cuda").manual_seed(5)
    twin_gen = torch.Generator(device="cuda").manual_seed(5)
    got, want, launches = [], [], []
    for i in range(STEPS):
        _build.counts.clear()
        got.append(step(state, batches[i], gen)[1])
        launches.append(_build.counts["lbs_skinning"])
        want.append(make_twin()(twin_state, batches[i], twin_gen)[1])
    assert (step.eager_steps, step.graph_replays) == (1, STEPS - 1)
    assert launches == [1, 1] + [0] * (STEPS - 2)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]), k
    assert len({m["loss"].data_ptr() for m in got}) == STEPS
    gen.manual_seed(11)
    twin_gen.manual_seed(11)
    last = step(state, batches[STEPS], gen)[1]["loss"]
    assert torch.equal(last, make_twin()(twin_state, batches[STEPS], twin_gen)[1]["loss"])
    assert step.graph_replays == STEPS
    assert_states_equal(state, twin_state)


@pytest.mark.cuda
def test_other_shape_runs_eagerly_and_graph_survives(card):
    """A short batch between replays runs eagerly; the next full batch
    replays the graph captured before it."""
    _, batches = card
    step, state, make_twin, twin_state = card_pair(card, "copenet_twoview")
    gen = torch.Generator(device="cuda").manual_seed(5)
    twin_gen = torch.Generator(device="cuda").manual_seed(5)
    short = {k: v[:20] for k, v in batches[3].items()}
    for b in (batches[0], batches[1], batches[2], short, batches[4]):
        loss = step(state, b, gen)[1]["loss"]
        assert torch.equal(loss, make_twin()(twin_state, b, twin_gen)[1]["loss"])
    assert (step.eager_steps, step.graph_replays) == (2, 3)
    assert_states_equal(state, twin_state)


@pytest.mark.cuda
def test_rebound_parameter_recaptures(card):
    """A parameter given new storage changes the key: the next call runs
    eagerly, the one after captures anew, and the steps stay equal."""
    _, batches = card
    step, state, make_twin, twin_state = card_pair(card, "copenet_twoview")
    gen = torch.Generator(device="cuda").manual_seed(5)
    twin_gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(6):
        if i == 3:
            p = next(iter(state.params.values()))
            p.data = p.data.clone()
        loss = step(state, batches[i], gen)[1]["loss"]
        assert torch.equal(loss, make_twin()(twin_state, batches[i], twin_gen)[1]["loss"])
    assert (step.eager_steps, step.graph_replays) == (2, 4)
    assert_states_equal(state, twin_state)


@pytest.mark.cuda
@pytest.mark.parametrize("n_data,replays", [(1, 2), (2, 0)])
def test_mesh_steps_capture_only_at_world_size_one(card, n_data, replays):
    """Under a mesh of one rank the step captures as without one; under a
    mesh of two it stays eager (here with no process group, so each of its
    collectives is the identity and the steps equal the eager ones)."""
    _, batches = card
    step, state, make_twin, twin_state = card_pair(card, "copenet_twoview",
                                                   mesh=Mesh({"data": n_data}))
    gen = torch.Generator(device="cuda").manual_seed(5)
    twin_gen = torch.Generator(device="cuda").manual_seed(5)
    for i in range(3):
        loss = step(state, batches[i], gen)[1]["loss"]
        assert torch.equal(loss, make_twin()(twin_state, batches[i], twin_gen)[1]["loss"])
    assert (step.eager_steps, step.graph_replays) == (3 - replays, replays)
