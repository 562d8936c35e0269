"""Entry points, the port's counterparts of the root ``__graft_entry__``:
``entry``, the flagship AirPoseTwoView (two views, three IEF iterations,
bf16 trunk) at B = 8 on one device, and ``dryrun_multichip``, one full
two-view train step and the frame-sharded AirPose+ over a process group."""

import numpy as np
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


def _dryrun_rank(rank: int, world: int, device: str = "cpu"):
    """One rank of ``dryrun_multichip``: → (kind, train loss, BA loss)."""
    from . import parallel
    from .bodymodel import init_vposer_params, synthetic_smplx_params
    from .config import TrainConfig
    from .data import batch_slice, make_synthetic_dataset
    from .models.airpose import AirPoseTwoView
    from .optim.bundle_adjust import BAConfig, BAState, bundle_adjust_sharded
    from .train import create_train_state, make_twoview_step_fns

    dev = torch.device(device)
    # dp × tp where it divides (4 ranks → data 2 × model 2), pure dp otherwise
    n_model = 2 if (world % 2 == 0 and world >= 4) else 1
    mesh = (parallel.make_mesh_2d(world // n_model, n_model) if n_model > 1
            else parallel.make_mesh(world))
    smplx = synthetic_smplx_params(num_vertices=128, seed=0).to(dev)
    data = make_synthetic_dataset(smplx, num_samples=world, seed=1, img_size=64,
                                  blob_sigma=3.0)
    batch = batch_slice(data, 0, world, dev)
    cfg = TrainConfig(batch_size=world)
    model = AirPoseTwoView(iters=cfg.reg_iters).to(dev)
    parallel.shard_params_tp(model, mesh)
    state, tx = create_train_state(model, cfg.lr)
    train_step, _ = make_twoview_step_fns(model, smplx, cfg, tx, device=dev, mesh=mesh)
    state, metrics = train_step(state, parallel.shard_batch(batch, mesh),
                                torch.Generator(device=dev).manual_seed(mesh.data_rank))
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"dryrun_multichip: loss {loss}, step {state.step}")
    kind = f"dp{mesh.n_data}xtp{n_model}" if n_model > 1 else "dp"

    # the frame-sharded AirPose+ over the same ranks, with padded frames
    ba_mesh = parallel.make_mesh(world)
    N = world + max(world // 2, 1)
    rng = np.random.default_rng(0)
    kp = torch.from_numpy(np.concatenate([rng.uniform(200, 800, (N, 2, 24, 2)),
                                          np.ones((N, 2, 24, 1))], -1).astype(np.float32)).to(dev)
    intr = torch.tensor([[[1475.0, 0, 960], [0, 1475.0, 540], [0, 0, 1]]] * 2, device=dev)
    init = BAState(z=torch.zeros(N, 32, device=dev),
                   phi=torch.tensor([1.0, 0, 0, 1, 0, 0], device=dev).repeat(N, 2, 1),
                   tau=torch.tensor([0.0, 0, 6], device=dev).repeat(N, 2, 1),
                   beta=torch.zeros(10, device=dev))
    ba_state, info = bundle_adjust_sharded(
        synthetic_smplx_params(num_vertices=96, seed=3).to(dev), init_vposer_params(0).to(dev),
        init, kp, kp, intr, BAConfig(iters_stage1=2, iters_stage2=3), mesh=ba_mesh)
    if not np.isfinite(info["trace"]).all() or ba_state.z.shape != (N, 32):
        raise RuntimeError(f"dryrun_multichip: BA trace {info['trace']}, z {ba_state.z.shape}")
    return kind, loss, info["loss"]


def dryrun_multichip(n_devices: int, device=None):
    """One full two-view train step on tiny shapes over ``n_devices`` ranks
    (dp, and dp × tp from 4 ranks on, as the JAX dry run), then the
    frame-sharded AirPose+ for 2 + 3 iterations; prints each result as the
    JAX dry run does. Inside a torchrun group of ``n_devices`` ranks it runs
    there; otherwise on the CPU it spawns ``n_devices`` gloo processes, and
    on the card (``device=None``) it runs world size 1 in this process over
    NCCL (one card takes one rank)."""
    import torch.distributed as dist

    from .parallel import launch

    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                             f"{dist.get_world_size()} ranks")
        results = [_dryrun_rank(dist.get_rank(), n_devices, str(launch.init_from_env(dev)))]
    elif n_devices == 1:
        launch.init_in_process(dev)
        try:
            results = [_dryrun_rank(0, 1, str(dev))]
        finally:
            dist.destroy_process_group()
    elif dev.type == "cpu":
        results = launch.spawn(_dryrun_rank, n_devices, timeout=300)
    else:
        raise ValueError(f"dryrun_multichip({n_devices}) on CUDA needs a torchrun group of "
                         f"{n_devices} ranks, one card each")
    kind, loss, ba_loss = results[0]
    print(f"dryrun_multichip({n_devices}): OK [{kind}], loss={loss:.3f}")
    print(f"dryrun_multichip({n_devices}): BA sharded OK, loss={ba_loss:.3f}")
    return results[0]


if __name__ == "__main__":
    import sys

    mode = sys.argv[1] if len(sys.argv) > 1 else "entry"
    if mode == "entry":
        fn, args = entry()
        out = fn(*args)
        print("entry ok:", [tuple(o.shape) for o in out])
    else:
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 1,
                         sys.argv[3] if len(sys.argv) > 3 else None)
