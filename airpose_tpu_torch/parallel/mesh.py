"""Process groups and sharding rules over ``torch.distributed`` (port of
airpose_tpu/parallel/mesh.py).

The JAX package scales by data-parallel GSPMD over a 1-D ``("data",)``
device mesh, with an optional 2-D ``("data", "model")`` mesh that adds
tensor parallelism for the wide parameters. Here a mesh is a set of
processes, one per device:

* ``make_mesh(n)`` is the default process group, every rank a data shard;
  ``make_mesh_2d(n_data, n_model)`` splits it into data groups and model
  groups (rank r is data index r // n_model, model index r % n_model, the
  row-major layout of JAX's device grid).
* ``shard_batch`` gives each rank its rows of a batch; a leaf that is not
  batch-shaped (per-view ``focal``) or a batch whose rows do not divide the
  data group (an undersized tail) is kept whole, as JAX replicates a leaf
  whose leading dim does not divide the mesh.
* Under ``data_parallel(mesh)`` the train-mode BatchNorm layers
  (models/resnet.py) normalize with the global batch's statistics, as GSPMD
  gives every BN layer (a reduction over a sharded axis is a cross-replica
  one), and the row-weighted batch mean of the losses (train/losses.py's
  ``_row_mean``) divides by the global row-weight sum. Each rank's loss is
  then its rows' share of the global batch's loss times the group's size,
  so the gradients' mean over the group (``all_reduce_mean``) is the global
  loss's gradient, and AMSGrad runs unchanged on every rank.
* ``shard_params_tp`` makes the wide layers column-parallel over the model
  group: a rank keeps its slice of the output channels, and a differentiable
  all-gather rebuilds the activation before anything that needs all the
  channels.

The view axis is not a mesh axis: both views of a sample live on one rank.
A process without a group runs every function here as the identity.
"""

import contextlib
import dataclasses
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass
class Mesh:
    """``shape`` maps the axis names to sizes; ``group`` is the data-parallel
    group (the ranks that hold the same parameter shards) and
    ``model_group`` the tensor-parallel one (None without a model axis or
    without a process group)."""

    shape: Dict[str, int]
    group: Optional[object] = None
    model_group: Optional[object] = None
    data_rank: int = 0
    model_rank: int = 0

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape.get("model", 1)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """1-D data-parallel mesh over the default process group. ``n_devices``
    (default: the group's size) must equal the group's size: every rank of a
    ``torchrun`` takes part. Without a process group only 1 is possible."""
    world = _world()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"a mesh of {n} ranks, but the process group has {world} "
                         "(start the program under torchrun --nproc-per-node N)")
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of {world}: "
                         "every rank of the group takes part")
    if axis != "data":
        raise ValueError(f"the 1-D mesh's axis is 'data', not {axis!r}")
    if not dist.is_initialized():
        return Mesh({"data": 1})
    return Mesh({"data": n}, group=dist.group.WORLD, data_rank=dist.get_rank())


def make_mesh_2d(n_data: int, n_model: int) -> Mesh:
    """2-D ("data", "model") mesh: dp × tp over a process group of
    ``n_data · n_model`` ranks. Every rank creates every subgroup, in the
    same order, as ``new_group`` requires."""
    world = _world()
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}×{n_model} mesh needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    if not dist.is_initialized():
        return Mesh({"data": 1, "model": 1})
    rank = dist.get_rank()
    data_groups = [dist.new_group([i * n_model + j for i in range(n_data)])
                   for j in range(n_model)]
    model_groups = [dist.new_group([i * n_model + j for j in range(n_model)])
                    for i in range(n_data)]
    return Mesh({"data": n_data, "model": n_model}, group=data_groups[rank % n_model],
                model_group=model_groups[rank // n_model], data_rank=rank // n_model,
                model_rank=rank % n_model)


# ---- the active data-parallel mesh -----------------------------------------------------

_local = threading.local()  # this thread's stack of data_parallel meshes


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Within this block (in this thread), train-mode BatchNorm and
    ``_row_mean`` reduce over ``mesh``'s data group (nothing changes for
    None or a group of one)."""
    stack = _local.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def active_group():
    """The data group of the innermost ``data_parallel`` block, where it has
    more than one rank, else None."""
    stack = getattr(_local, "stack", None)
    mesh = stack[-1] if stack else None
    return mesh.group if mesh is not None and mesh.n_data > 1 else None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group`` (not differentiated: row weights, counts)."""
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Each tensor's mean over ``mesh``'s data group, in one all-reduce per
    dtype and device (the identity without a group or with a group of one,
    so that a step at world size 1 holds no collective a CUDA graph would
    capture)."""
    tensors = list(tensors)
    if mesh is None or mesh.group is None or mesh.n_data == 1:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets: Dict = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.n_data
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def batch_rows(n_rows: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of an ``n_rows`` batch that shards: a contiguous
    block, in rank order (JAX's P("data") layout)."""
    if mesh is None or mesh.n_data == 1:
        return slice(0, n_rows)
    per = n_rows // mesh.n_data
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shards(n_rows: int, mesh: Optional[Mesh]) -> bool:
    """Whether an ``n_rows`` batch splits over the data group."""
    return mesh is not None and mesh.n_data > 1 and n_rows % mesh.n_data == 0


PER_VIEW_KEYS = frozenset({"focal"})  # (2, ...) per-view constants of a batch


def shard_batch(batch: Mapping, mesh: Optional[Mesh], rows: Optional[int] = None) -> Dict:
    """This rank's part of a batch dict: each leaf whose leading dim is the
    batch's row count (``rows``, by default that of ``images``) takes this
    rank's rows; the per-view constants (``PER_VIEW_KEYS``, also at 2 rows)
    and other leaves (tags) stay whole, and so does every leaf of a batch
    whose rows do not divide the data group. JAX keeps each leaf one global
    array whatever its placement, so a per-view ``focal`` sharded there is
    still whole to the step; here only batch-shaped leaves are cut."""
    if rows is None:
        rows = batch["images"].shape[0]
    if not shards(rows, mesh):
        return dict(batch)
    sl = batch_rows(rows, mesh)
    return {k: (v[sl] if k not in PER_VIEW_KEYS and hasattr(v, "shape") and len(v.shape) >= 1
                 and v.shape[0] == rows else v) for k, v in batch.items()}


def gather_rows(tree, mesh: Optional[Mesh], rows: int):
    """The inverse of ``shard_batch`` for outputs (a dict or a NamedTuple of
    tensors): every rank's rows of each batch-shaped tensor, concatenated in
    rank order, on every rank."""
    if not shards(rows, mesh):
        return tree
    per = rows // mesh.n_data

    def gather(v):
        if not (torch.is_tensor(v) and v.ndim >= 1 and v.shape[0] == per):
            return v
        parts = [torch.empty_like(v) for _ in range(mesh.n_data)]
        dist.all_gather(parts, v.contiguous(), group=mesh.group)
        return torch.cat(parts)

    if hasattr(tree, "_fields"):
        return type(tree)(*(gather(v) for v in tree))
    return {k: gather(v) for k, v in tree.items()}


# ---- BatchNorm with the global batch's statistics ----------------------------------------

def _global_stats(xf: torch.Tensor, group):
    """(count, mean, biased var) per channel of NCHW f32 ``xf`` over every
    rank's rows: count, sum and sum of squares summed over ``group`` in f64."""
    dims = (0, 2, 3)
    c = xf.shape[1]
    n = torch.tensor([xf.numel() / c], dtype=torch.float64, device=xf.device)
    stats = torch.cat([n, xf.sum(dims, dtype=torch.float64), (xf.double() ** 2).sum(dims)])
    dist.all_reduce(stats, group=group)
    mean = stats[1:1 + c] / stats[0]
    return stats[0], mean, (stats[1 + c:] / stats[0] - mean ** 2).clamp_min(0.0)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over NCHW ``x`` with the statistics of every
    rank's rows (the biased variance, as flax); → (y, mean, var). The
    backward sums Σg and Σg·x̂ over the group the same way, so each rank's
    input gradient is the gradient of the summed per-rank losses; the affine
    parameters' gradients are this rank's own parts (the step's all-reduce
    adds the rest)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = x.float()
        count, mean, var = _global_stats(xf, group)
        mean, var = mean.float(), var.float()
        rstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * rstd[:, None, None]
        y = xhat * weight[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(xhat, rstd, weight)
        ctx.group, ctx.count, ctx.in_dtype = group, count, x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, g, _gmean, _gvar):
        xhat, rstd, weight = ctx.saved_tensors
        gf = g.float()
        dims = (0, 2, 3)
        local = torch.cat([gf.sum(dims, dtype=torch.float64),
                           (gf * xhat).sum(dims, dtype=torch.float64)])
        c = xhat.shape[1]
        dbias, dweight = local[:c].float(), local[c:].float()
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        mg = (total[:c] / ctx.count).float()
        mgx = (total[c:] / ctx.count).float()
        dx = (gf - mg[:, None, None] - xhat * mgx[:, None, None]) * (
            rstd * weight)[:, None, None]
        return dx.to(ctx.in_dtype), dweight, dbias, None, None


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      running_mean: torch.Tensor, running_var: torch.Tensor,
                      momentum: float, eps: float, group) -> torch.Tensor:
    """Train-mode BatchNorm with the global batch's statistics over
    ``group``; moves the running statistics by ``(1 − momentum)·running +
    momentum·batch`` with the global mean and biased variance (flax's rule,
    so no unbiasing to undo)."""
    y, mean, var = _GlobalBatchNorm.apply(x, weight, bias, eps, group)
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
    return y


# ---- tensor parallelism ----------------------------------------------------------------

def param_spec(a, n_model: int, min_dim: int = 512) -> Optional[int]:
    """The tensor-parallel rule for one parameter-shaped tensor, in torch's
    layouts: the dim to shard over "model", or None to replicate. A wide
    ``Linear.weight`` (out, in) with out ≥ ``min_dim`` and a wide conv weight
    (O, I, kh, kw) with O ≥ ``min_dim`` shard their output channels (dim 0;
    JAX's (in, out) and HWIO shard their last dim); biases, BatchNorm and
    small heads are replicated. AMSGrad's moments follow their parameters."""
    shape = tuple(a.shape)
    if len(shape) in (2, 4) and shape[0] >= min_dim and shape[0] % n_model == 0:
        return 0
    return None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the model
    group (each rank's column slice gives only its part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the ranks' channel slices along ``dim``; the backward
    keeps this rank's slice of the gradient (every rank of the model group
    computes the same from the gathered activation)."""

    @staticmethod
    def forward(ctx, y, dim, group, rank, n):
        ctx.dim, ctx.rank, ctx.width = dim, rank, y.shape[dim]
        parts = [torch.empty_like(y, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None, None, None


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear`` holding this rank's rows of the weight (its output
    channels) and the whole bias."""

    def forward(self, x):
        tp = self.tp
        y = F.linear(_CopyToModel.apply(x, tp.model_group), self.weight)
        return _GatherFromModel.apply(y, -1, tp.model_group, tp.model_rank,
                                      tp.n_model) + self.bias


def _column_conv(base):
    """A subclass of the conv class ``base`` (run in its input's dtype, as
    models/resnet.Conv2d) holding this rank's output channels."""

    class ColumnParallelConv2d(base):
        def forward(self, x):
            tp = self.tp
            x = _CopyToModel.apply(x, tp.model_group)
            y = self._conv_forward(x, self.weight.to(x.dtype), None)
            y = _GatherFromModel.apply(y, 1, tp.model_group, tp.model_rank, tp.n_model)
            return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]

    ColumnParallelConv2d.__name__ = f"ColumnParallel{base.__name__}"
    return ColumnParallelConv2d


_conv_classes: Dict[type, type] = {}


def shard_params_tp(model: nn.Module, mesh: Mesh, min_dim: int = 512) -> List[str]:
    """Make ``model``'s wide Linear and Conv2d layers column-parallel over
    ``mesh``'s model group (``param_spec``): each keeps this rank's slice of
    its weight. Returns the names of the sliced weights. Build the
    TrainState after this: its params and AMSGrad moments then hold the
    slices."""
    n, r = mesh.n_model, mesh.model_rank
    names = []
    if n == 1:
        return names
    for mname, mod in model.named_modules():
        if not isinstance(mod, (nn.Linear, nn.Conv2d)) or getattr(mod, "tp", None) is not None:
            continue
        if param_spec(mod.weight, n, min_dim) is None:
            continue
        width = mod.weight.shape[0] // n
        mod.weight = nn.Parameter(mod.weight.detach()[r * width:(r + 1) * width].clone())
        mod.tp = mesh
        if isinstance(mod, nn.Linear):
            mod.__class__ = ColumnParallelLinear
        else:
            cls = type(mod)
            mod.__class__ = _conv_classes.setdefault(cls, _column_conv(cls))
        names.append(f"{mname}.weight" if mname else "weight")
    return names


def gather_params_tp(params: Mapping[str, torch.Tensor], names: Iterable[str],
                     mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Whole tensors of ``params`` where ``names`` were sliced by
    ``shard_params_tp`` (for checkpoints and comparisons)."""
    out = dict(params)
    for name in names:
        t = params[name].detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
        dist.all_gather(parts, t, group=mesh.model_group)
        out[name] = torch.cat(parts)
    return out
