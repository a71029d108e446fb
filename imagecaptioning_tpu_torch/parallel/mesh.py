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
  loss denominators summed over the data ranks, each micro-step's
  gradients summed (`reduce_grads`, called by the train steps after the
  backward), BatchNorm's statistics over the global batch,
  and random draws made in the global batch's shape and sliced, so that
  a step on n ranks computes what the step on one process computes on
  the whole batch, up to reduction order. The model and the losses reach
  it through `current()`, which a train step sets with `active(dp)`; it
  is `IDENTITY` everywhere else.

The tensor split over a `'model'` axis (`ModelAxis`) is the JAX
package's `PARTITION_RULES` / `infer_param_shardings` / `shard_params`
on the port's parameter names, in torch's (out, in) layout:
`shard_params` turns each split parameter into a `DTensor` holding this
rank's shard on the axis's 1-D device mesh (column-split projections
`Shard(0)`, row-split ones `Shard(1)`, embeddings `Shard(1)`) and gives
its module a forward over the shard, Megatron's pairs: a column split
takes a replicated input (its gradient summed over `'model'`) and keeps
its output columns; a row split sums its partial products over
`'model'`; an embedding or a vocabulary head gathers its columns. The
collectives are this module's own (not DTensor's), so that on one card
under gloo they go through the host as the data reducer's do. Where a
rule's dimension does not divide by the axis, or an attention's heads do
not, the parameter stays replicated, as JAX falls back. A step's sums
run over the data axis; ranks of one data index compute the same rows,
the same dropout masks and the same update. The trainers take a
`'model'` axis without a split, as the JAX drivers do (they pass no
parameter shardings); `dryrun_multichip` and the tests split.

At world 1 without a process group every collective is skipped and
every helper is the plain expression it replaces, bit for bit. Under gloo
a CUDA tensor is reduced through a host copy (gloo's own CUDA paths are
not used), and each axis counts its collectives (`calls`).
"""

from __future__ import annotations

import collections
import datetime
import os
import re
import sys
import types
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

class Axis:
    """One axis of the mesh as a rank sees it: its `index` among `size`
    ranks and the group over them. With `stage_on_host` (gloo on a card)
    a CUDA tensor goes through a host copy. `calls` counts the
    collectives run, by name (`"all_reduce"`, `"all_gather"`), a staged
    one with `"(host)"` after it."""

    def __init__(self, index: int = 0, size: int = 1, group=None,
                 stage_on_host: bool = False):
        self.index, self.size = index, size
        self.group = group
        self.stage_on_host = stage_on_host
        self.calls: collections.Counter = collections.Counter()

    def __repr__(self) -> str:
        return f"{type(self).__name__}(index={self.index}, size={self.size})"

    def _staged(self, t: torch.Tensor) -> bool:
        return self.stage_on_host and t.device.type != "cpu"

    def _all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        if self._staged(t):
            self.calls["all_reduce(host)"] += 1
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            t.copy_(host)
        else:
            self.calls["all_reduce"] += 1
            dist.all_reduce(t, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the axis's ranks, outside autograd (a new
        tensor; `t` itself at size 1)."""
        if self.size == 1:
            return t
        return self._all_reduce_(t.detach().clone())

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' `t` joined along `dim` in rank order (a new tensor),
        outside autograd."""
        staged = self._staged(t)
        self.calls["all_gather(host)" if staged else "all_gather"] += 1
        src = (t.cpu() if staged else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim).to(t.device)


class DataParallel(Axis):
    """The data axis as a step sees it: this rank's `index` among `size`
    data ranks and the group that sums over them (module docstring).
    `IDENTITY` (size 1) is every helper's plain expression."""

    def rows(self, batch: int) -> slice:
        """This rank's contiguous rows of a global batch of `batch`."""
        return rows(batch, self.index, self.size)

    # -- collectives -----------------------------------------------------

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
        per dtype and device; a split gradient's shard (the data ranks of
        one model index hold the same shard). Nothing at size 1."""
        grads = [local(g) for g in grads if g is not None]
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


# ------------------------------------------------------- the tensor split

def _dtensor_type():
    """torch's DTensor class, or None where nothing has imported it (then
    no tensor is one; its import takes a second, so it is not made here)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def is_split(t) -> bool:
    """Whether `t` (a parameter or gradient) is a `shard_params` DTensor."""
    cls = _dtensor_type()
    return cls is not None and isinstance(t, cls)


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a split tensor, in place (the DTensor's own
    storage, outside autograd); any other tensor itself."""
    return t._local_tensor if is_split(t) else t


def local_view(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a split parameter as a differentiable view
    (its gradient lands on the DTensor); any other tensor itself."""
    return t.to_local() if is_split(t) else t


class _CopyIn(torch.autograd.Function):
    """Identity; the backward sums the gradient over `'model'` (a column
    split's replicated input: each rank's columns give part of it)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis._all_reduce_(grad.contiguous().clone()), None


class _ReduceOut(torch.autograd.Function):
    """The sum over `'model'` of the ranks' partial products (a row
    split's output); the backward passes the replicated gradient on."""

    @staticmethod
    def forward(ctx, y, axis):
        return axis._all_reduce_(y.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherOut(torch.autograd.Function):
    """The ranks' column blocks joined along `dim`; the backward keeps
    this rank's block of the replicated gradient."""

    @staticmethod
    def forward(ctx, y, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, y.shape[dim]
        return axis.all_gather(y, dim)

    @staticmethod
    def backward(ctx, grad):
        a = ctx.axis
        return grad.narrow(ctx.dim, a.index * ctx.width,
                           ctx.width).contiguous(), None, None


class ModelAxis(Axis):
    """The `'model'` axis of a mesh: this rank's `index` among `size`
    ranks of one data index, their group and their 1-D `device_mesh`
    (the split parameters' DTensor mesh)."""

    def __init__(self, index: int = 0, size: int = 1, group=None,
                 stage_on_host: bool = False, device_mesh=None):
        super().__init__(index, size, group, stage_on_host)
        self.device_mesh = device_mesh

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(y, self)

    def gather_out(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherOut.apply(y, self, dim % y.dim())

    @torch.no_grad()
    def full(self, t: torch.Tensor) -> torch.Tensor:
        """The whole of a split tensor (a collective: every rank of the
        axis calls it); any other tensor itself."""
        if not is_split(t):
            return t
        (placement,) = t.placements
        if placement.is_shard():
            return self.all_gather(t._local_tensor, placement.dim)
        return t._local_tensor


# The JAX package's PARTITION_RULES (its `parallel/mesh.py`) on the port's
# parameter names: (pattern, the split dimension of torch's (out, in)
# weight, the module's style). JAX's column split P(None, 'model') of a
# Dense kernel (in, out) is Shard(0) here, its row split P('model', None)
# Shard(1), an embedding's P(None, 'model') Shard(1), a bias's P('model')
# Shard(0). "column" keeps its output columns for the "row" split after
# it; "gathered" (an embedding or a vocabulary head alone) joins them.
# A row split's bias stays replicated: it is added once, after the sum
# (JAX gives `attention/fc_out/bias` P('model') by its generic bias rule;
# the function is the same). JAX's rules name `deep_output` too, but its
# attention head keeps `deep_output_kernel` and `deep_output_bias` as
# leaves of its own, which no rule matches: that head stays whole there,
# and here.
PARTITION_RULES: Tuple[Tuple[str, int, str], ...] = (
    (r".*\battention\.(queries|keys|values)\.weight$", 0, "column"),
    (r".*\battention\.fc_out\.weight$", 1, "row"),
    (r".*\b(feed_forward\.0|mlp\.0)\.(weight|bias)$", 0, "column"),
    (r".*\b(feed_forward\.2|mlp\.3)\.weight$", 1, "row"),
    (r"(.*\.)?(word_embedding|lookup_table|embedding)\.weight$", 1,
     "gathered"),
    (r".*\b(decoder\.fc_out|rnn\.linear)\.(weight|bias)$", 0, "gathered"),
)


def _rule_for(name: str, rules) -> Optional[Tuple[str, int, str]]:
    for rule in rules:
        if re.match(rule[0], name):
            return rule
    return None


def _split_plan(model: torch.nn.Module, size: int,
                rules) -> Dict[str, Tuple[int, str]]:
    """{parameter name: (split dimension, its module's style)} of the
    parameters that split over `size` ranks (`infer_param_shardings`)."""
    plan: Dict[str, Tuple[int, str]] = {}
    if size <= 1:
        return plan
    pairs: Dict[str, List[str]] = collections.defaultdict(list)
    for name, p in model.named_parameters():
        rule = _rule_for(name, rules)
        if rule is None:
            continue
        if rule[1] < p.dim() and p.shape[rule[1]] % size == 0:
            plan[name] = rule[1:]
        if rule[2] in ("column", "row"):
            pairs[name.rsplit(".", 2)[0]].append(name)
    # a column/row pair (one attention, one MLP) splits whole or not at
    # all, and an attention only along whole heads
    modules = dict(model.named_modules())
    for parent, names in pairs.items():
        heads = getattr(modules.get(parent), "heads", None)
        if any(n not in plan for n in names) or (heads and heads % size):
            for n in names:
                plan.pop(n, None)
    return plan


def _placements(model: torch.nn.Module, plan) -> Dict[str, object]:
    from torch.distributed.tensor import Replicate, Shard
    return {n: Shard(plan[n][0]) if n in plan else Replicate()
            for n, _ in model.named_parameters()}


def infer_param_shardings(model: torch.nn.Module, mesh,
                          rules=PARTITION_RULES) -> Dict[str, object]:
    """{parameter name: `Shard(d)` or `Replicate()`} of `model` over
    `mesh` (a `Mesh`, or anything with a `shape` dict), JAX's
    `infer_param_shardings`: a rule's dimension that does not divide by
    the `'model'` size falls back to replication, and so does everything
    where the mesh has no `'model'` axis or it is 1."""
    return _placements(model, _split_plan(model, mesh.shape.get("model", 1),
                                          rules))


def _linear_column(self, x):
    w, b = self.weight.to_local(), self.bias
    x = self.tensor_split.copy_in(x)
    return torch.nn.functional.linear(
        x, w.to(x.dtype), None if b is None else local_view(b).to(x.dtype))


def _linear_gathered(self, x):
    return self.tensor_split.gather_out(_linear_column(self, x))


def _linear_row(self, x):
    y = torch.nn.functional.linear(x, self.weight.to_local().to(x.dtype))
    y = self.tensor_split.reduce_out(y)
    return y if self.bias is None else y + self.bias.to(x.dtype)


def _embedding_gathered(self, tokens):
    y = torch.nn.functional.embedding(
        tokens, self.weight.to_local(), self.padding_idx, self.max_norm,
        self.norm_type, self.scale_grad_by_freq, self.sparse)
    return self.tensor_split.gather_out(y)


_SPLIT_FORWARD = {("linear", "column"): _linear_column,
                  ("linear", "row"): _linear_row,
                  ("linear", "gathered"): _linear_gathered,
                  ("embedding", "gathered"): _embedding_gathered}


def shard_params(model: torch.nn.Module, mesh,
                 rules=PARTITION_RULES) -> Dict[str, object]:
    """Split `model`'s parameters over the mesh's `'model'` axis in place
    (JAX's `shard_params`) → the placements (`infer_param_shardings`).
    Each split parameter becomes a DTensor of this rank's shard (every
    rank starts from the same whole weights, so nothing is sent), and its
    module computes on the shard (module docstring). Build the optimizer
    and the train step after it: they hold the parameters. Nothing
    changes where the axis is absent or 1."""
    axis = mesh.model
    plan = _split_plan(model, axis.size if axis is not None else 1, rules)
    placements = _placements(model, plan)
    if not plan:
        return placements
    from torch.distributed.tensor import DTensor
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        style = None
        for pname, p in list(m.named_parameters(recurse=False)):
            if prefix + pname not in plan:
                continue
            if not isinstance(m, (torch.nn.Embedding, torch.nn.Linear)):
                raise TypeError(f"{mname}: a split needs a Linear or an "
                                f"Embedding, not {type(m).__name__}")
            dim, style = plan[prefix + pname]
            shard = p.detach().chunk(axis.size, dim)[axis.index].clone()
            param = torch.nn.Parameter(
                DTensor.from_local(shard, axis.device_mesh,
                                   [placements[prefix + pname]],
                                   run_check=False),
                requires_grad=p.requires_grad)
            param.tensor_split = axis
            setattr(m, pname, param)
        if style is None:
            continue
        kind = "embedding" if isinstance(m, torch.nn.Embedding) else "linear"
        m.tensor_split = axis
        m.forward = types.MethodType(_SPLIT_FORWARD[(kind, style)], m)
    return placements


def split_axis(obj) -> Optional[ModelAxis]:
    """The `'model'` axis a module's weights, or a parameter, were split
    over by `shard_params`, or None."""
    return getattr(obj, "tensor_split", None)


# ------------------------------------------------------------- the mesh

class Mesh(NamedTuple):
    """Ranks laid out over named axes. `shape` maps axis names to sizes,
    as JAX's `Mesh.shape`; `coordinate` is this rank's place (None for a
    rank beyond `mesh_for_batch`'s cap, which joins no step); `data` is
    the reducer over the `'data'` axis; `control` a host (gloo) group of
    the mesh's ranks for barriers and flags; `model` the `'model'` axis
    that `shard_params` splits over (None where the mesh has none)."""
    shape: Dict[str, int]
    coordinate: Optional[Tuple[int, ...]]
    data: DataParallel
    device_mesh: object = None
    control: object = None
    model: Optional[ModelAxis] = None

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
    model = None
    if "model" in names:
        m = names.index("model")
        model = ModelAxis(coord[m], concrete[m], device_mesh.get_group("model"),
                          stage, device_mesh["model"])
    return Mesh(axes, coord, data, device_mesh, control, model)


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
