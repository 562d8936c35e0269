"""Port parity of VPoser (airpose_tpu_torch.bodymodel.vposer vs
airpose_tpu.bodymodel.vposer on the same numpy inputs and weights, on the
CPU, f32): the seeded random prior equal to JAX's, entry for entry; encode
and decode at rtol 1e-5 (f32 dense layers of width 512 summed in other
orders; atol 1e-6 where an output crosses zero); the released-snapshot
converter and the ``.ckpt``/``.npz`` loaders equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airpose_tpu.bodymodel import vposer as jv
from airpose_tpu_torch.bodymodel import vposer as tv

RTOL, ATOL = 1e-5, 1e-6


def _fake_v2_state_dict(seed=0):
    """A torch VPoser v2 state dict in the released layout, as
    tests/test_bodymodel.py builds one (BN statistics away from 0/1)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def lin(prefix, i, o):
        sd[prefix + ".weight"] = torch.randn(o, i, generator=g) * 0.03
        sd[prefix + ".bias"] = torch.randn(o, generator=g) * 0.03

    def bn(prefix, n):
        sd[prefix + ".weight"] = torch.rand(n, generator=g) + 0.5
        sd[prefix + ".bias"] = torch.randn(n, generator=g)
        sd[prefix + ".running_mean"] = torch.randn(n, generator=g)
        sd[prefix + ".running_var"] = torch.rand(n, generator=g) + 0.5

    bn("encoder_net.1", 63)
    lin("encoder_net.2", 63, 512)
    bn("encoder_net.4", 512)
    lin("encoder_net.6", 512, 512)
    lin("encoder_net.7", 512, 512)
    lin("encoder_net.8.mu", 512, 32)
    lin("encoder_net.8.logvar", 512, 32)
    lin("decoder_net.0", 32, 512)
    lin("decoder_net.3", 512, 512)
    lin("decoder_net.5", 512, 126)
    return sd


def _assert_params_equal(got: tv.VPoserParams, want: jv.VPoserParams):
    assert got._fields == want._fields
    for name, g_layer, w_layer in zip(got._fields, got, want):
        assert g_layer._fields == w_layer._fields, name
        for f, g, w in zip(g_layer._fields, g_layer, w_layer):
            assert g.dtype == torch.float32, (name, f)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name}.{f}")


def test_init_matches_jax():
    _assert_params_equal(tv.init_vposer_params(0), jv.init_vposer_params(0))
    _assert_params_equal(tv.init_vposer_params(7), jv.init_vposer_params(7))
    _assert_params_equal(tv.vposer_params_from_numpy(jv.init_vposer_params(3)),
                         jv.init_vposer_params(3))
    assert tuple(tv.init_vposer_params(0).enc_fc1.w.shape) == (63, 512)
    assert tuple(tv.init_vposer_params(0).dec_out.w.shape) == (512, 126)


@pytest.mark.parametrize("weights", ["init", "released_layout"])
def test_encode_decode_match_jax(rng, weights):
    if weights == "init":
        jparams = jv.init_vposer_params(0)
    else:
        jparams = jv.convert_torch_state_dict(_fake_v2_state_dict())
    tparams = tv.vposer_params_from_numpy(jparams)
    pose = rng.normal(size=(6, 63)).astype(np.float32) * 0.4
    mu, sigma = tv.vposer_encode(tparams, torch.from_numpy(pose))
    jmu, jsigma = jv.vposer_encode(jparams, jnp.asarray(pose))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=RTOL, atol=ATOL)
    assert (sigma > 0).all()

    z = rng.normal(size=(6, 32)).astype(np.float32)
    got = tv.vposer_decode(tparams, torch.from_numpy(z))
    want = jv.vposer_decode(jparams, jnp.asarray(z))
    for k in ("pose_body", "pose_body_matrot"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    R = got["pose_body_matrot"].reshape(-1, 3, 3)
    torch.testing.assert_close(R @ R.transpose(1, 2), torch.eye(3).expand_as(R), rtol=0,
                               atol=1e-5)


def test_rsample_draws_from_the_generator():
    mu, sigma = torch.zeros(4, 32), torch.full((4, 32), 2.0)
    a = tv.vposer_rsample(mu, sigma, torch.Generator().manual_seed(0))
    b = tv.vposer_rsample(mu, sigma, torch.Generator().manual_seed(0))
    c = tv.vposer_rsample(mu, sigma, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    torch.testing.assert_close(a, 2.0 * torch.randn(4, 32, generator=torch.Generator()
                                                    .manual_seed(0)))


def test_convert_torch_state_dict_matches_jax(rng):
    sd = _fake_v2_state_dict()
    params = tv.convert_torch_state_dict(sd)
    _assert_params_equal(params, jv.convert_torch_state_dict(sd))
    _assert_params_equal(tv.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}),
                         jv.convert_torch_state_dict(sd))

    # an independent numpy forward of the encoder's mean
    def np_bn(v, p):
        return ((v - sd[p + ".running_mean"].numpy())
                / np.sqrt(sd[p + ".running_var"].numpy() + 1e-5)
                * sd[p + ".weight"].numpy() + sd[p + ".bias"].numpy())

    def np_lin(v, p):
        return v @ sd[p + ".weight"].numpy().T + sd[p + ".bias"].numpy()

    x = rng.normal(size=(3, 63)).astype(np.float32)
    h = np_bn(x, "encoder_net.1")
    h = np_lin(h, "encoder_net.2")
    h = np.where(h > 0, h, 0.01 * h)
    h = np_lin(np_lin(np_bn(h, "encoder_net.4"), "encoder_net.6"), "encoder_net.7")
    mu, _ = tv.vposer_encode(params, torch.from_numpy(x))
    np.testing.assert_allclose(mu.numpy(), np_lin(h, "encoder_net.8.mu"), rtol=1e-3, atol=1e-4)


def test_load_vposer_ckpt_round_trips(tmp_path):
    sd = _fake_v2_state_dict(seed=2)
    ckpt = str(tmp_path / "V02_05.ckpt")
    torch.save({"state_dict": {"vp_model." + k: v for k, v in sd.items()}, "epoch": 3}, ckpt)
    npz = str(tmp_path / "vposer.npz")
    np.savez(npz, **{k: v.numpy() for k, v in sd.items()})
    want = tv.convert_torch_state_dict(sd)
    for path in (ckpt, npz):
        got = tv.load_vposer_ckpt(path)
        for g_layer, w_layer in zip(got, want):
            for g, w in zip(g_layer, w_layer):
                assert torch.equal(g, w), path
        _assert_params_equal(got, jv.load_vposer_ckpt(path))
