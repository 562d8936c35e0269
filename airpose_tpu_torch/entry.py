"""Single-device entry point, the port's counterpart of the root
``__graft_entry__.entry``: the flagship AirPoseTwoView (two views, three IEF
iterations, bf16 trunk) at B = 8."""

import torch

from . import resolve_device
from .models.airpose import AirPoseTwoView


def entry(device=None):
    """Returns (fn, example_args) for one eval forward on ``device``
    (``None`` → CUDA; raises without it)."""
    dev = resolve_device(device)
    B = 8
    model = AirPoseTwoView(dtype=torch.bfloat16).to(dev)
    x = torch.zeros((B, 2, 224, 224, 3), device=dev)
    bb = torch.zeros((B, 2, 3), device=dev)
    pos = torch.full((B, 2, 3), 0.5, device=dev)

    @torch.no_grad()
    def fn(model, images, bb, pos):
        out = model(images, bb, pos)
        return out.pose, out.betas

    return fn, (model, x, bb, pos)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
