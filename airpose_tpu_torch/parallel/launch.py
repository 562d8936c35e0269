"""Starting the ranks of a process group.

* Under ``torchrun --nproc-per-node N`` (which sets RANK, WORLD_SIZE,
  LOCAL_RANK, MASTER_ADDR and MASTER_PORT), ``init_from_env`` joins the
  group: NCCL with one card a rank (``cuda:LOCAL_RANK``), gloo on the CPU.
* ``spawn(fn, n)`` starts n fresh processes on this host (the tests' and
  ``entry.dryrun_multichip``'s launcher), each joining a gloo group through
  a file in a temporary directory (no port to pick, so none another process
  can take first), runs ``fn(rank, n, *args)`` in each and returns the
  ranks' results in rank order; it raises with a rank's traceback if one
  fails, and kills every rank at ``timeout``.
* ``init_in_process(device)`` makes the calling process a group of one (the
  card's NCCL at world size 1).
* ``is_main_rank()``: rank 0 of the group, or a process without one — the
  rank that writes a CLI's outputs.
"""

import datetime
import os
import queue as queue_mod
import shutil
import socket
import tempfile
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_main_rank() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def init_from_env(device: torch.device) -> Optional[torch.device]:
    """Join the torchrun group described by the environment, if there is one
    with more than one rank or it is already joined; → the rank's device
    (``cuda:LOCAL_RANK`` where ``device`` is CUDA), or None outside torchrun."""
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return None
        device = torch.device(device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device))
        return device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def init_in_process(device: torch.device) -> None:
    """A process group of this process alone (world size 1), on ``device``'s
    backend; a no-op where a group exists."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(device), init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)


def _rank_main(rank, world, store, threads, timeout, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(threads)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except (Exception, SystemExit):  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), timeout: float = 120.0,
          threads: int = 2) -> List:
    """Run ``fn(rank, n, *args)`` in ``n`` new processes joined by a gloo
    group on this host (``fn`` must be importable by name: a module-level
    function); → the results in rank order. Each rank gets ``threads``
    intra-op threads."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="airpose_spawn_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, os.path.join(store_dir, "store"), threads, timeout, fn,
                               tuple(args), results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors = [None] * n, []
    deadline = time.monotonic() + timeout
    try:
        for _ in range(n):
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.1))
            except queue_mod.Empty:
                raise TimeoutError(f"spawn: ranks still running after {timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("spawn: a rank failed\n" + "\n".join(errors))
    return out
