"""Process meshes and the data-parallel reducer — port of
`imagecaptioning_tpu/parallel/mesh.py` (`create_mesh`, `mesh_for_batch`).

The JAX package shards one jit over a device mesh and GSPMD inserts the
collectives. Here each rank is a process (`python -m
torch.distributed.run --nproc_per_node=N -m
imagecaptioning_tpu_torch.<trainer>`) and the collectives are written
out, all of them in this module:

- `init_distributed` joins the process group that torchrun's environment
  names (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`): NCCL on the card
  `cuda:LOCAL_RANK`, gloo on the CPU. It raises where the backend or the
  card cannot be had; it never carries on as one process.
- `create_mesh` / `mesh_for_batch` lay the ranks out over the config's
  `mesh_shape` and `mesh_axis_names` (`-1` absorbs the rest, numpy-reshape
  style) with `torch.distributed.device_mesh.init_device_mesh`;
  `mesh_for_batch` caps the ranks at the largest count that divides the
  batch, as JAX caps its devices, and ranks beyond it join no step.
- `DataParallel` is the step's view of the data axis: the rows of the
  global batch this rank owns (`P("data")` on the leading axis), the
  loss denominators summed over the data ranks, the gradients summed
  once an applied update, BatchNorm's statistics over the global batch,
  and random draws made in the global batch's shape and sliced, so that
  a step on n ranks computes what the step on one process computes on
  the whole batch, up to reduction order. The model and the losses reach
  it through `current()`, which a train step sets with `active(dp)`; it
  is `IDENTITY` everywhere else.

Parameters are replicated. A `'model'` axis is taken as the JAX drivers
take it (they pass no parameter shardings): ranks that share a data index
compute the same rows, and every sum runs over the data axis only. The
tensor split (`PARTITION_RULES`) is not ported.

At world 1 without a process group every collective is skipped and
every helper is the plain expression it replaces, bit for bit. Under gloo
a CUDA tensor is reduced through a host copy (gloo's own CUDA paths are
not used).
"""

from __future__ import annotations

import datetime
import os
from contextlib import contextmanager
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the host-side groups' (gloo) patience: rank 0 alone runs evals and
# writes checkpoints while the others wait at a barrier
CONTROL_TIMEOUT = datetime.timedelta(hours=6)
# this process's rank device and its end-of-run group (a process is one
# rank, as torch.distributed's own group state is per process)
_STATE: Dict[str, object] = {}


def launched() -> bool:
    """Whether torchrun's environment names a process group."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> torch.device:
    """Join the process group of torchrun's environment → this rank's
    device. `device` None is `cuda:LOCAL_RANK`; `"cpu"` runs on the CPU.
    The backend is NCCL on a card and gloo on the CPU unless `backend`
    says otherwise (gloo on one shared card). Raises where the card or the
    backend cannot be had."""
    if not launched():
        raise RuntimeError("init_distributed needs RANK and WORLD_SIZE "
                           "(python -m torch.distributed.run ...)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(f"cuda:{local_rank()}" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: {dev} requested but CUDA is "
                               "not available; pass --device cpu")
        index = dev.index if dev.index is not None else local_rank()
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: no card cuda:{index} "
                f"({torch.cuda.device_count()} visible)")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    available = {"nccl": dist.is_nccl_available(),
                 "gloo": dist.is_gloo_available()}
    if not available.get(backend, False):
        raise RuntimeError(f"rank {rank}: backend {backend} is not available")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world)
    _STATE["device"] = dev
    return dev


def shutdown() -> None:
    """Meet every rank at the end (the idle ones wait here), then leave
    the process group. Nothing without one."""
    if not dist.is_initialized():
        return
    end = _STATE.get("end_group")
    if end is not None:
        dist.barrier(group=end)
    dist.destroy_process_group()
    _STATE.clear()


@contextmanager
def process_group(device=None):
    """An entry point's run: inside a torchrun launch, joined to its
    process group (`init_distributed`) and left at the end (`shutdown`,
    the idle ranks waiting there); otherwise nothing happens."""
    if not launched():
        yield
        return
    init_distributed(device)
    try:
        yield
    finally:
        shutdown()


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ----------------------------------------------------------- mesh shapes

def resolve_shape(shape: Sequence[int], n: int) -> Tuple[int, ...]:
    """`shape` over n ranks, a -1 taking what the others leave
    (`create_mesh`'s reshape)."""
    shape = list(shape)
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = n // (known or 1)
    total = 1
    for s in shape:
        total *= s
    if total != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not lay out "
                         f"{n} ranks")
    return tuple(shape)


def ranks_for_batch(batch_size: int, world: int) -> int:
    """The ranks `mesh_for_batch` keeps: the largest count up to `world`
    that divides `batch_size` (JAX's device cap)."""
    n = world
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


def shape_for_batch(batch_size: int, world: int,
                    shape: Sequence[int] = (-1,)) -> Tuple[int, ...]:
    """The mesh shape `mesh_for_batch` builds over `world` ranks."""
    return resolve_shape(shape, ranks_for_batch(batch_size, world))


# ------------------------------------------------------ the data reducer

class DataParallel:
    """The data axis as a step sees it: this rank's `index` among `size`
    data ranks and the group that sums over them (module docstring).
    `IDENTITY` (size 1) is every helper's plain expression."""

    def __init__(self, index: int = 0, size: int = 1, group=None,
                 stage_on_host: bool = False):
        self.index, self.size = index, size
        self.group = group
        self.stage_on_host = stage_on_host

    def __repr__(self) -> str:
        return f"DataParallel(index={self.index}, size={self.size})"

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows of a global batch of `batch`."""
        return rows(batch, self.index, self.size)

    # -- collectives -----------------------------------------------------
    def _all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        if self.stage_on_host and t.device.type != "cpu":
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the data ranks, outside autograd (a new
        tensor; `t` itself at size 1)."""
        if self.size == 1:
            return t
        return self._all_reduce_(t.detach().clone())

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the data ranks, differentiable: the
        backward sums the gradient over them too. `t` at size 1."""
        if self.size == 1:
            return t
        return _SumOverRanks.apply(t, self)

    def count(self, n: int) -> int:
        """A static per-rank size over the global batch."""
        return n * self.size

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of `x` over the global batch, where x holds this rank's
        equal share of it: this rank's part of that mean (the parts sum to
        it over the ranks). `x.mean()` at size 1."""
        if self.size == 1:
            return x.mean()
        return x.sum() / (x.numel() * self.size)

    @torch.no_grad()
    def reduce_grads(self, grads: Iterable[torch.Tensor]) -> None:
        """Sum gradients over the data ranks in place, one flat buffer
        per dtype and device. Nothing at size 1."""
        grads = [g for g in grads if g is not None]
        if self.size == 1 or not grads:
            return
        buckets: Dict[tuple, List[torch.Tensor]] = {}
        for g in grads:
            buckets.setdefault((g.device, g.dtype), []).append(g)
        for bucket in buckets.values():
            flat = torch.cat([g.reshape(-1) for g in bucket])
            self._all_reduce_(flat)
            offset = 0
            for g in bucket:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    # -- random draws in the global batch's shape --------------------------
    def _global(self, shape, axis: int) -> List[int]:
        shape = list(shape)
        shape[axis] *= self.size
        return shape

    def _mine(self, full: torch.Tensor, axis: int, n: int) -> torch.Tensor:
        return full.narrow(axis, self.index * n, n)

    def rand(self, shape, generator: Optional[torch.Generator] = None,
             device=None, batch_axis: int = 0) -> torch.Tensor:
        """`torch.rand(shape)` of this rank's rows (`batch_axis` the batch
        axis of `shape`): drawn in the global shape, then sliced."""
        if self.size == 1:
            return torch.rand(shape, generator=generator, device=device)
        full = torch.rand(self._global(shape, batch_axis),
                          generator=generator, device=device)
        return self._mine(full, batch_axis, shape[batch_axis])

    def bernoulli(self, like: torch.Tensor, keep: float,
                  generator: Optional[torch.Generator] = None,
                  batch_axis: int = 0) -> torch.Tensor:
        """A keep-`keep` 0/1 mask shaped and typed like `like`, this rank's
        rows of the global batch's mask."""
        if self.size == 1:
            return torch.bernoulli(torch.full_like(like, keep),
                                   generator=generator)
        full = torch.bernoulli(
            torch.full(self._global(like.shape, batch_axis), keep,
                       dtype=like.dtype, device=like.device),
            generator=generator)
        return self._mine(full, batch_axis, like.shape[batch_axis])


class _SumOverRanks(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: the
    gradient of the ranks' summed loss with respect to each rank's part."""

    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return dp._all_reduce_(t.detach().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.dp._all_reduce_(grad.contiguous().clone()), None


IDENTITY = DataParallel()
_ACTIVE = [IDENTITY]


def current() -> DataParallel:
    """The data axis of the step being run (`IDENTITY` outside one)."""
    return _ACTIVE[-1]


@contextmanager
def active(dp: Optional[DataParallel]):
    """Run a step's forward, backward and update over `dp`."""
    _ACTIVE.append(dp or IDENTITY)
    try:
        yield
    finally:
        _ACTIVE.pop()


def rows(batch: int, rank: int, n: int) -> slice:
    """The contiguous slice of a global batch of `batch` that data rank
    `rank` of `n` owns (`P("data")` on the leading axis)."""
    if batch % n:
        raise ValueError(f"batch {batch} does not split over {n} ranks")
    per = batch // n
    return slice(rank * per, (rank + 1) * per)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, dp: DataParallel):
    """BatchNorm over the global batch (NCHW x, this rank's rows) →
    (output in x's dtype, mean, biased variance): the statistics are two
    differentiable sums over the data ranks (the mean, then the squared
    deviations from it), in fp32 (fp64 for fp64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    dims = (0, 2, 3)
    count = dp.count(xf.numel() // xf.shape[1])
    mean = dp.sum(xf.sum(dims)) / count
    centred = xf - mean[None, :, None, None]
    var = dp.sum(centred.square().sum(dims)) / count
    scale = torch.rsqrt(var + eps) * weight.to(acc)
    out = centred * scale[None, :, None, None] + bias.to(acc)[None, :, None,
                                                               None]
    return out.to(x.dtype), mean.detach(), var.detach()


# ------------------------------------------------------------- the mesh

class Mesh(NamedTuple):
    """Ranks laid out over named axes. `shape` maps axis names to sizes,
    as JAX's `Mesh.shape`; `coordinate` is this rank's place (None for a
    rank beyond `mesh_for_batch`'s cap, which joins no step); `data` is
    the reducer over the `'data'` axis; `control` a host (gloo) group of
    the mesh's ranks for barriers and flags."""
    shape: Dict[str, int]
    coordinate: Optional[Tuple[int, ...]]
    data: DataParallel
    device_mesh: object = None
    control: object = None

    @property
    def idle(self) -> bool:
        return self.coordinate is None

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def barrier(self) -> None:
        """Every rank of the mesh meets here (rank 0's evals and writes)."""
        if self.control is not None and self.size > 1:
            dist.barrier(group=self.control)

    def any(self, flag: bool) -> bool:
        """Whether any rank of the mesh raised `flag` (a preemption
        signal seen by one rank stops them all at the same step)."""
        if self.control is None or self.size == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.control)
        return bool(t.item())


def single(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of one process without a process group."""
    names = tuple(axis_names)
    return Mesh({n: 1 for n in names}, (0,) * len(names), IDENTITY)


def create_mesh(shape: Sequence[int] = (-1,),
                axis_names: Sequence[str] = ("data",),
                device=None, ranks: Optional[int] = None) -> Mesh:
    """A mesh over the first `ranks` ranks (default: all) of the process
    group, `-1` absorbing the rest. Every rank of the group calls it (the
    groups are made collectively). Without a process group: `single`."""
    names = tuple(axis_names)
    if not dist.is_initialized():
        resolve_shape(shape, 1)
        return single(names)
    if "data" not in names:
        raise ValueError(f"mesh axes {names} have no 'data' axis")
    world = dist.get_world_size()
    n = world if ranks is None else ranks
    concrete = resolve_shape(shape, n)
    dev = torch.device(device or _STATE.get("device") or "cpu")
    from torch.distributed.device_mesh import init_device_mesh
    device_mesh = init_device_mesh(dev.type, concrete, mesh_dim_names=names)
    control = dist.new_group(ranks=list(range(n)), backend="gloo",
                             timeout=CONTROL_TIMEOUT)
    if "end_group" not in _STATE:
        _STATE["end_group"] = dist.new_group(backend="gloo",
                                             timeout=CONTROL_TIMEOUT)
    coord = device_mesh.get_coordinate()
    axes = dict(zip(names, concrete))
    if coord is None:
        return Mesh(axes, None, IDENTITY, device_mesh, control)
    coord = tuple(int(c) for c in coord)
    d = names.index("data")
    stage = dist.get_backend() == "gloo" and dev.type == "cuda"
    data = DataParallel(coord[d], concrete[d],
                        device_mesh.get_group("data"), stage_on_host=stage)
    return Mesh(axes, coord, data, device_mesh, control)


def mesh_for_batch(batch_size: int, shape: Sequence[int] = (-1,),
                   axis_names: Sequence[str] = ("data",),
                   device=None) -> Mesh:
    """`create_mesh` over the largest count of ranks that divides
    `batch_size` (JAX's `mesh_for_batch`); the ranks beyond it are idle."""
    n = ranks_for_batch(batch_size, dist.get_world_size()
                        if dist.is_initialized() else 1)
    return create_mesh(shape, axis_names, device, ranks=n)


def announce_idle(mesh: Mesh, batch_size: int) -> None:
    """The idle rank's one line."""
    print(f"rank {dist.get_rank()} of {dist.get_world_size()} joins no "
          f"step: batch {batch_size} keeps {mesh.size} ranks on mesh "
          f"{mesh.shape}; it waits for the run's end", flush=True)
