"""Port parity of the train steps of the other model families: one
make_singleview_step_fns step of hmr, copenet_singleview and muhmr, and one
make_twoview_step_fns step of the per-drone copenet_twoview_sep, on both
packages from the same weights (carried by convert_reference_checkpoint /
state_dict_from_flax) and the same batch, on the CPU, f32 trunk at 64 px,
dropout off on both sides (its masks cannot match across frameworks).

The bounds are those of tests/test_torch_train.py's whole-step test, set by
flax's own f32 train-mode BatchNorm error (E[x²] − E[x]²): eval_step's
outputs before the step atol 1e-4 and its loss rtol 1e-4; after the step
each loss term rtol 2e-3, each running statistic rel-L2 2e-3, and the
parameter update equal (rtol 1e-3) on ≥ 99.9% of the entries whose
gradient is above 0.1 of its tensor's largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.config import TrainConfig as JTrainConfig
from airpose_tpu.models import MODEL_REGISTRY as JREGISTRY
from airpose_tpu.train import make_singleview_step_fns as j_singleview_step_fns
from airpose_tpu.train import make_twoview_step_fns as j_twoview_step_fns
from airpose_tpu.train.checkpoint import convert_reference_checkpoint
from airpose_tpu.train.state import TrainState as JTrainState
from airpose_tpu.train.state import make_optimizer as j_make_optimizer
from airpose_tpu_torch.config import TrainConfig
from airpose_tpu_torch.data import batch_slice
from airpose_tpu_torch.models import MODEL_REGISTRY
from airpose_tpu_torch.train import (AMSGrad, create_train_state, load_reference_state_dict,
                                     make_singleview_step_fns, make_twoview_step_fns,
                                     state_dict_from_flax)
from test_torch_families import reference_sd
from test_torch_train import B, data, no_dropout, smplx_pair  # noqa: F401  (fixtures)

SEP = "copenet_twoview_sep"


class RecordingAMSGrad(AMSGrad):
    """AMSGrad that keeps the gradients of its last update."""

    def update(self, grads, state, params):
        self.grads = {n: g.clone() for n, g in grads.items()}
        super().update(grads, state, params)


def _port_state(family, variables):
    """A port model of ``family`` on flax ``variables``, as a train-state
    dict by name (parameters and BatchNorm statistics)."""
    model = MODEL_REGISTRY[family](seed=77)
    load_reference_state_dict(model, state_dict_from_flax(jax.tree.map(np.asarray, variables),
                                                          family), family)
    return model


@pytest.mark.parametrize("family", ["hmr", "copenet_singleview", "muhmr", SEP])
def test_family_step_matches_jax(smplx_pair, data, no_dropout, family):
    jsmplx, tsmplx = smplx_pair
    cfg, jcfg = TrainConfig(batch_size=B, model=family), JTrainConfig(batch_size=B, model=family)
    model = MODEL_REGISTRY[family](seed=4)
    # copies: the converter's arrays are views of the port model's tensors, which
    # the port's step updates in place
    variables = jax.tree.map(np.array, convert_reference_checkpoint(reference_sd(model, family),
                                                                    family))
    batch = batch_slice(data, 0, B, "cpu")

    state, _ = create_train_state(model, cfg.lr)
    tx = RecordingAMSGrad(cfg.lr)
    jtx = j_make_optimizer(jcfg.lr)
    jstate = JTrainState(step=0, params=variables["params"],
                         batch_stats=variables["batch_stats"],
                         opt_state=jtx.init(variables["params"]))
    jmodel = JREGISTRY[family]()
    if family == SEP:
        train_step, eval_step = make_twoview_step_fns(model, tsmplx, cfg, tx, device="cpu")
        j_train, j_eval = j_twoview_step_fns(jmodel, jsmplx, jcfg, jtx)
    else:
        train_step, eval_step = make_singleview_step_fns(model, tsmplx, cfg, tx, family,
                                                         device="cpu")
        j_train, j_eval = j_singleview_step_fns(jmodel, jsmplx, jcfg, jtx, family)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}

    jm, jp = j_eval(jstate, jbatch)
    tm, tp = eval_step(state, batch)
    want = jp.items() if family == SEP else zip(jp._fields, jp)
    got = tp if family == SEP else dict(zip(tp._fields, tp))
    for k, w in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)

    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = train_step(state, batch, torch.Generator().manual_seed(0))
    jstate, jmetrics = j_train(jstate, jbatch, jax.random.PRNGKey(0))
    assert state.step == 1 and int(jstate.step) == 1
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-3, err_msg=k)

    after = _port_state(family, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    jtensors = dict(after.named_parameters()) | dict(after.named_buffers())
    n_stats = shown = same = 0
    for name, got_t in state.batch_stats.items():
        if "num_batches" not in name:
            want_t = jtensors[name]
            assert ((got_t - want_t).norm() / want_t.norm()).item() <= 2e-3, name
            n_stats += 1
    for name, p in state.params.items():
        g = tx.grads[name].abs()
        mask = g > 0.1 * g.max()
        d_port = (p - before[name])[mask]
        d_jax = (jtensors[name].detach() - before[name])[mask]
        shown += int(mask.sum())
        same += int(((d_port - d_jax).abs() <= 1e-3 * d_jax.abs()).sum())
    assert n_stats == 106 * (2 if family == SEP else 1) and shown > 1_000_000
    assert same >= 0.999 * shown, (same, shown)
