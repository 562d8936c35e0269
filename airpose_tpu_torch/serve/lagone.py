"""Lag-one regime analysis: what peer-message staleness costs (port of
airpose_tpu/serve/lagone.py).

In flight, a slow or disconnected peer degrades the 3-round protocol to
the LAG-ONE regime — the server falls back to the peer's freshest earlier
message (serve/server.py `_wait_peer`), so frame f's rounds 2/3 condition
on the peer's state from frame f-1. On a static subject this is exactly
the synchronized computation; on a moving subject it diverges from the
fused same-frame forward. The reference ships this semantic without
quantifying it; this module measures it:

    python -m airpose_tpu_torch.serve.lagone --datapath real:///capture \
        [--ckpt last.ckpt | --random-init] [--frames 0 64] [--platform cpu]

prints, per the capture's actual frame-to-frame motion, the mean |Δ| of
the final wire pose between (a) the synchronized staged protocol and
(b) the lag-one staged protocol, both against the fused forward.
"""

import argparse
from typing import Dict, List

import numpy as np

from .. import resolve_device
from .staged import StagedRegressor, ViewState, state_to_wire, wire_to_peer


def _exchange(states: List[ViewState], bbs, regs) -> List[ViewState]:
    """One synchronized round: both views consume the OTHER view's
    current-state wire message."""
    wires = [state_to_wire(s) for s in states]
    out = []
    for v in (0, 1):
        art, shape = wire_to_peer(wires[1 - v])
        out.append(regs[v].step23(states[v], bbs[v][None],
                                  art[None], shape[None]))
    return out


def run_protocol(regs, imgs, bbs, init_trans, lag_one: bool):
    """Run the 3-round protocol over a frame sequence.

    ``lag_one=False``: peer messages are same-frame (the synchronized
    demo regime — identical to the fused forward, held in
    tests/test_torch_serve.py). ``lag_one=True``: frame f's rounds 2/3 use the
    peer's step1/step2 messages from frame f-1 (the `_wait_peer` timeout
    fallback). Returns (n, 2, 145) final wire results."""
    n = len(imgs)
    results = np.zeros((n, 2, 145), np.float32)
    prev_wires = {1: None, 2: None}  # step -> per-view wires of frame f-1
    for f in range(n):
        states = [regs[v].step1(imgs[f][v][None], bbs[f][v][None],
                                init_trans[None]) for v in (0, 1)]
        s1_wires = [state_to_wire(s) for s in states]
        if lag_one:
            peer1 = prev_wires[1] if prev_wires[1] is not None else s1_wires
            states = [
                regs[v].step23(states[v], bbs[f][v][None],
                               *(a[None] for a in wire_to_peer(peer1[1 - v])))
                for v in (0, 1)
            ]
            s2_wires = [state_to_wire(s) for s in states]
            peer2 = prev_wires[2] if prev_wires[2] is not None else s2_wires
            states = [
                regs[v].step23(states[v], bbs[f][v][None],
                               *(a[None] for a in wire_to_peer(peer2[1 - v])))
                for v in (0, 1)
            ]
            prev_wires = {1: s1_wires, 2: s2_wires}
        else:
            states = _exchange(states, bbs[f], regs)
            states = _exchange(states, bbs[f], regs)
        for v in (0, 1):
            results[f, v] = state_to_wire(states[v])
    return results


def lag_one_report(model, imgs, bbs, init_trans, device=None) -> Dict[str, float]:
    """Divergence of the lag-one regime vs the synchronized protocol over
    a frame sequence (uint8 or normalized crops, (n, 2, S, S, 3)-style
    lists) served by ``model`` (an AirPoseTwoView, or an AirPoseTwoViewSep
    whose view v serves its own weight copy) on ``device`` (CUDA by
    default). Returns mean-abs deltas of the wire pose/β plus the motion
    scale (mean |Δpose| between consecutive synchronized frames) so the
    degradation can be read relative to how fast the subject moves."""
    if hasattr(model, "trunk0"):
        regs = [StagedRegressor(model, sep_view=v, device=device) for v in (0, 1)]
    else:
        regs = [StagedRegressor(model, device=device)] * 2
    sync = run_protocol(regs, imgs, bbs, init_trans, lag_one=False)
    lag = run_protocol(regs, imgs, bbs, init_trans, lag_one=True)
    d = np.abs(lag[1:] - sync[1:])  # frame 0 has no previous message
    motion = np.abs(np.diff(sync, axis=0))
    return {
        "pose_absdiff": float(d[..., 13:].mean()),
        "beta_absdiff": float(d[..., :10].mean()),
        "trans_absdiff": float(d[..., 10:13].mean()),
        "frame_motion_pose": float(motion[..., 13:].mean()),
        "frames": float(d.shape[0]),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--datapath", required=True, help="real://<dir> or <dir>")
    p.add_argument("--frames", type=int, nargs=2, default=(0, 32))
    p.add_argument("--model", default="copenet_twoview",
                   choices=("copenet_twoview", "copenet_twoview_sep"))
    p.add_argument("--ckpt", default=None,
                   help="this package's trainer .ckpt file (a directory is refused)")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference Lightning .ckpt, loaded strict")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--img_res", type=int, default=224)
    p.add_argument("--platform", default=None, choices=("cpu", "cuda"),
                   help="the device (default: the CUDA device; raises without one)")
    args = p.parse_args(argv)
    dev = resolve_device(args.platform)

    from ..data import CopenetRealDataset
    from ..eval.compile_results import real_batches
    from .server import load_served_model

    path = (args.datapath[len("real://"):]
            if args.datapath.startswith("real://") else args.datapath)
    model = load_served_model(p, args, dev)
    ds = CopenetRealDataset(path, frame_range=range(*args.frames))

    imgs, bbs = [], []
    for b in real_batches(ds, min(8, len(ds)), out_size=args.img_res, device=dev):
        img = b["images"].cpu().numpy()
        bb = b["bb"].cpu().numpy()
        for i in range(int(b.get("_valid", img.shape[0]))):
            imgs.append(img[i])
            bbs.append(bb[i])
    rep = lag_one_report(model, imgs, bbs, np.asarray([0, 0, 10.0], np.float32), device=dev)
    for k, v in rep.items():
        print(f"lagone_{k}: {v:.6f}")


if __name__ == "__main__":
    main()
