"""VPoser v2, the 32-d latent VAE over the 21-joint body pose (port of
airpose_tpu/bodymodel/vposer.py).

The real-data fine-tune uses it as a pose prior: the predicted body pose
is encoded and the squared latent sample is the prior's loss term.

Architecture (VPoser v2, published widths):
  encode:  BN(63) → Linear(63,512) → LeakyReLU → BN(512) → Dropout(0.1)
           → Linear(512,512) → Linear(512,512) → {mu: Linear(512,32),
                                                  sigma: softplus(Linear(512,32))}
  decode:  Linear(32,512) → LeakyReLU → Dropout(0.1) → Linear(512,512)
           → LeakyReLU → Linear(512,126) → 6D→rotmat → axis-angle

Parameters are a NamedTuple of tensors and the functions are pure, with
inference semantics as in the JAX package: BatchNorm reads its running
statistics, ``(x − mean)·rsqrt(var + 1e-5)·scale + bias``, and there is no
dropout. Dense weights are (in, out), as in the JAX package;
``convert_torch_state_dict`` transposes the released torch Linears.
"""

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.rotations import rot6d_to_rotmat, rotmat_to_aa

LATENT_DIM = 32
NUM_NEURONS = 512
NUM_FEATURES = 63  # 21 joints × 3 (axis-angle)


class Dense(NamedTuple):
    w: torch.Tensor  # (in, out)
    b: torch.Tensor  # (out,)


class BatchNorm(NamedTuple):
    scale: torch.Tensor
    bias: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor


class VPoserParams(NamedTuple):
    enc_bn0: BatchNorm
    enc_fc1: Dense
    enc_bn1: BatchNorm
    enc_fc2: Dense
    enc_fc3: Dense
    enc_mu: Dense
    enc_sigma: Dense
    dec_fc1: Dense
    dec_fc2: Dense
    dec_out: Dense

    def to(self, device) -> "VPoserParams":
        return VPoserParams(*(type(layer)(*(t.to(device) for t in layer)) for layer in self))


def _dense(x: torch.Tensor, p: Dense) -> torch.Tensor:
    return x @ p.w + p.b


def _bn(x: torch.Tensor, p: BatchNorm, eps: float = 1e-5) -> torch.Tensor:
    return (x - p.mean) * torch.rsqrt(p.var + eps) * p.scale + p.bias


def vposer_encode(params: VPoserParams,
                  pose_body_aa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 63) axis-angle body pose → Normal(mu, sigma) over the 32-d latent."""
    x = pose_body_aa.reshape(pose_body_aa.shape[0], NUM_FEATURES)
    x = _bn(x, params.enc_bn0)
    x = F.leaky_relu(_dense(x, params.enc_fc1), 0.01)
    x = _bn(x, params.enc_bn1)
    x = _dense(x, params.enc_fc2)
    x = _dense(x, params.enc_fc3)
    mu = _dense(x, params.enc_mu)
    sigma = F.softplus(_dense(x, params.enc_sigma))
    return mu, sigma


def vposer_rsample(mu: torch.Tensor, sigma: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Reparameterized sample from the encoder distribution; ``generator``
    (on the tensors' device) draws the noise."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + sigma * eps


def vposer_decode(params: VPoserParams, z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(B, 32) latent → {'pose_body': (B, 21, 3) axis-angle,
    'pose_body_matrot': (B, 21, 3, 3)}."""
    x = F.leaky_relu(_dense(z, params.dec_fc1), 0.01)
    x = F.leaky_relu(_dense(x, params.dec_fc2), 0.01)
    six = _dense(x, params.dec_out).reshape(z.shape[0], 21, 6)
    rotmats = rot6d_to_rotmat(six)
    return {"pose_body": rotmat_to_aa(rotmats), "pose_body_matrot": rotmats}


def init_vposer_params(seed: int = 0, dtype=torch.float32) -> VPoserParams:
    """Random VPoser on the CPU with torch-Linear-like scaling, drawn from
    numpy in the JAX package's order, so both packages make the same
    weights from one seed (for tests and runs without the released prior)."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        k = 1.0 / np.sqrt(i)
        w = rng.uniform(-k, k, size=(i, o))
        b = rng.uniform(-k, k, size=(o,))
        return Dense(w=torch.as_tensor(w, dtype=dtype), b=torch.as_tensor(b, dtype=dtype))

    def bn(n):
        return BatchNorm(scale=torch.ones(n, dtype=dtype), bias=torch.zeros(n, dtype=dtype),
                         mean=torch.zeros(n, dtype=dtype), var=torch.ones(n, dtype=dtype))

    return VPoserParams(
        enc_bn0=bn(NUM_FEATURES),
        enc_fc1=dense(NUM_FEATURES, NUM_NEURONS),
        enc_bn1=bn(NUM_NEURONS),
        enc_fc2=dense(NUM_NEURONS, NUM_NEURONS),
        enc_fc3=dense(NUM_NEURONS, NUM_NEURONS),
        enc_mu=dense(NUM_NEURONS, LATENT_DIM),
        enc_sigma=dense(NUM_NEURONS, LATENT_DIM),
        dec_fc1=dense(LATENT_DIM, NUM_NEURONS),
        dec_fc2=dense(NUM_NEURONS, NUM_NEURONS),
        dec_out=dense(NUM_NEURONS, 21 * 6),
    )


def _layer_type(field: str):
    return BatchNorm if "bn" in field else Dense


def vposer_params_from_numpy(params, dtype=torch.float32) -> VPoserParams:
    """VPoserParams on the CPU from a structure with the same fields holding
    arrays (e.g. the JAX package's VPoserParams)."""
    def layer(field, theirs):
        kind = _layer_type(field)
        return kind(*(torch.as_tensor(np.array(getattr(theirs, f)), dtype=dtype)
                      for f in kind._fields))
    return VPoserParams(*(layer(f, p) for f, p in zip(VPoserParams._fields, params)))


# torch state-dict key → field, for the released VPoser v2 snapshot
# (human_body_prior naming). encoder_net.0 is a parameter-less
# BatchFlatten, so the first parameterized layer is encoder_net.1.
_TORCH_KEYMAP = {
    "encoder_net.1": "enc_bn0",
    "encoder_net.2": "enc_fc1",
    "encoder_net.4": "enc_bn1",
    "encoder_net.6": "enc_fc2",
    "encoder_net.7": "enc_fc3",
    "encoder_net.8.mu": "enc_mu",
    "encoder_net.8.logvar": "enc_sigma",
    "decoder_net.0": "dec_fc1",
    "decoder_net.3": "dec_fc2",
    "decoder_net.5": "dec_out",
}


def load_vposer_ckpt(path: str, dtype=torch.float32) -> VPoserParams:
    """Released VPoser v2 weights from a torch snapshot (the V02_05
    ``.ckpt``, whose keys carry a ``vp_model.`` prefix, stripped here) or
    from an ``.npz`` with the same keys; on the CPU."""
    if path.endswith(".npz"):
        blob = dict(np.load(path))
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        blob = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return convert_torch_state_dict({k.replace("vp_model.", ""): v for k, v in blob.items()},
                                    dtype)


def convert_torch_state_dict(state_dict, dtype=torch.float32) -> VPoserParams:
    """A torch VPoser v2 state dict (tensors or arrays) → VPoserParams on
    the CPU; Linear weights transposed to (in, out)."""

    def arr(key):
        v = state_dict[key]
        return torch.as_tensor(v.detach().cpu() if torch.is_tensor(v) else np.array(v),
                               dtype=dtype)

    def dense(prefix):
        return Dense(w=arr(prefix + ".weight").T.contiguous(), b=arr(prefix + ".bias"))

    def bn(prefix):
        return BatchNorm(scale=arr(prefix + ".weight"), bias=arr(prefix + ".bias"),
                         mean=arr(prefix + ".running_mean"), var=arr(prefix + ".running_var"))

    return VPoserParams(**{field: bn(key) if _layer_type(field) is BatchNorm else dense(key)
                           for key, field in _TORCH_KEYMAP.items()})
