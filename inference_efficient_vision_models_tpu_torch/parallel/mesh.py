"""The mesh layer on ``torch.distributed``, the port of the JAX package's
``parallel/mesh.py``.

One process per device (NCCL between GPUs, gloo between CPU processes),
arranged as a 2-D ``DeviceMesh`` with dims ``("data", "model")``:

* **data axis (DP)**: each rank takes its rows of every global batch
  (``shard_batch``); a step's sums that JAX's global view takes over the
  whole batch are all-reduced over this axis: the loss's mask count, the
  training BatchNorm statistics (SyncBatchNorm semantics), the gradients,
  and the similarity-preserving KD loss's Gram matrix (features gathered);
* **model axis (TP)**: optionally the classifier head is split over it
  (``param_shardings(tp_head=True)``: the (in, out) fc's output dim), and
  its logits are gathered before the loss.

So a step over a mesh gives what one process gives on the whole batch, in
fp32 within rounding: ``GlobalView`` holds those collectives for the train
and eval steps (``train/steps.py``). Placements are ``torch.distributed``'s
``Shard`` / ``Replicate``; tensors stay plain local tensors.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(*, device: DeviceLike = None, **kwargs) -> None:
    """Join the process group. A no-op unless ``kwargs`` (for
    ``torch.distributed.init_process_group``: ``store``, ``rank``,
    ``world_size``, ``init_method``, ``backend``) or a launcher's
    coordinates (``WORLD_SIZE`` and ``MASTER_ADDR``, as ``torchrun`` sets
    them) are given, or when a group exists already: single-process runs
    never touch ``torch.distributed``. The backend is NCCL for ``device``
    (the GPU unless ``"cpu"``; the rank's GPU is ``LOCAL_RANK``), gloo on
    the CPU."""
    if dist.is_initialized():
        return
    if not (kwargs or (os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR"))):
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(devices: Optional[Sequence[int]] = None, *, model_parallel: int = 1):
    """The ranks ``devices`` (every rank of the group when None) as a
    ``DeviceMesh`` of shape (n / model_parallel, model_parallel), dims
    ``("data", "model")``; rank r sits at (r // model_parallel, r %
    model_parallel). Needs a process group (``initialize_distributed``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    n = len(ranks)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.tensor(ranks).reshape(n // model_parallel, model_parallel),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh):
    """Leading (batch) dim split over the data axis; replicated over model."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh):
    from torch.distributed.tensor.placement_types import Replicate

    return (Replicate(), Replicate())


def param_shardings(mesh, params, *, tp_head: bool = True):
    """Placements for a params tree: DP replicates everything; with
    ``tp_head`` the classifier head is split over the model axis: the fc
    kernel (in, out) on dim 1, its bias (out,) on dim 0."""
    from torch.distributed.tensor.placement_types import Replicate, Shard

    def rule(tree, in_fc):
        if isinstance(tree, dict):
            return {k: rule(v, in_fc or k == "fc") for k, v in tree.items()}
        if tp_head and in_fc:
            return (Replicate(), Shard(1 if tree.dim() == 2 else 0))
        return replicated(mesh)

    return rule(params, False)


def _local_slice(t: torch.Tensor, dim: int, index: int, parts: int) -> torch.Tensor:
    if t.shape[dim] % parts:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split into {parts} shards")
    step = t.shape[dim] // parts
    return t.narrow(dim, index * step, step).contiguous()


def shard_params(mesh, params, shardings):
    """This rank's local pieces of ``params`` on its device, by ``shardings``
    (``param_shardings``): a ``Shard(d)`` on mesh dim i keeps this rank's
    slice along tensor dim d."""
    dev = mesh_device(mesh)
    coord = mesh.get_coordinate()

    def place(t, pl):
        if isinstance(t, dict):
            return {k: place(v, pl[k]) for k, v in t.items()}
        t = t.detach().to(dev)
        for i, p in enumerate(pl):
            if p.is_shard():
                t = _local_slice(t, p.dim, coord[i], mesh.size(i))
        return t

    return place(params, shardings)


def replicate(mesh, tree):
    """A full copy of ``tree`` (tensors or numpy arrays) on this rank's device:
    every process holds the complete value, so no data moves between ranks."""
    dev = mesh_device(mesh)

    def place(t):
        if isinstance(t, dict):
            return {k: place(v) for k, v in t.items()}
        if isinstance(t, np.ndarray):
            return torch.from_numpy(t).to(dev)
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    return place(tree)


def shard_batch(mesh, batch):
    """This rank's rows of a global batch (a tensor, numpy array, or a tuple
    or list of them) on its device: the leading dim split over the data axis."""
    dev = mesh_device(mesh)
    d, n = mesh.get_coordinate()[0], mesh.size(0)

    def place(a):
        t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        return _local_slice(t, 0, d, n).to(dev)

    if isinstance(batch, (tuple, list)):
        return type(batch)(place(a) for a in batch)
    return place(batch)


# --------------------------------------------------------------------------
# global-view collectives of a step
# --------------------------------------------------------------------------

# the data axis's group while a step runs under ``GlobalView``: BatchNorm reads it
_bn_group: contextvars.ContextVar = contextvars.ContextVar("ievm_bn_group", default=None)


def bn_group():
    """The process group training BatchNorm sums its statistics over, or
    None (one process, or a data axis of one)."""
    return _bn_group.get()


class _GatherOwnGrad(torch.autograd.Function):
    """All-gather along dim ``dim``; the backward keeps this rank's slice of
    the incoming gradient. Every rank of the group computes the same loss
    from the gathered tensor, so that slice is the gradient of the one
    global loss (a sum over the ranks would count it once per rank)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _SumAll(torch.autograd.Function):
    """All-reduce (sum) whose backward all-reduces the gradient: the sum's
    every input feeds every rank's loss."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group`` (SyncBatchNorm's statistics)."""
    return _SumAll.apply(t, group)


class GlobalView:
    """The collectives that make a step over ``mesh`` compute what one
    process computes on the whole batch; every method is the identity when
    ``mesh`` is None. ``tp`` is true when the head ``params["fc"]`` holds this
    rank's slice of the classes (``param_shardings(tp_head=True)``)."""

    def __init__(self, mesh, spec=None, params=None):
        self.mesh = mesh
        self.tp = False
        if mesh is None:
            return
        self.data = mesh.get_group(DATA_AXIS)
        self.model = mesh.get_group(MODEL_AXIS)
        self.dp, self.mp = mesh.size(0), mesh.size(1)
        fc = params.get("fc") if isinstance(params, dict) else None
        self.tp = (self.mp > 1 and fc is not None
                   and fc["w"].shape[-1] * self.mp == spec.num_classes)

    @contextlib.contextmanager
    def active(self):
        """Training BatchNorm sums its statistics over the data axis inside."""
        token = _bn_group.set(self.data if self.mesh is not None and self.dp > 1 else None)
        try:
            yield
        finally:
            _bn_group.reset(token)

    def batch(self, batch):
        return batch if self.mesh is None else shard_batch(self.mesh, batch)

    def logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The full classes of this rank's rows (gathered over the model axis
        when the head is split)."""
        return _GatherOwnGrad.apply(logits, self.model, -1) if self.tp else logits

    def features(self, feats: torch.Tensor) -> torch.Tensor:
        """The whole batch's rows, gathered over the data axis."""
        if self.mesh is None or self.dp == 1:
            return feats
        return _GatherOwnGrad.apply(feats, self.data, 0)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A detached sum over the data axis (counts, metrics)."""
        if self.mesh is None:
            return t.detach()
        t = t.detach().clone()
        dist.all_reduce(t, group=self.data)
        return t

    @property
    def replica_share(self) -> float:
        """The weight of a term every rank computes whole from gathered data:
        with a split head the model axis's ranks each add it to the gradient."""
        return 1.0 / self.mp if self.tp else 1.0

    def grads(self, params, grads):
        """Each rank's gradient (of its rows' share of the global loss) summed
        into the global one: over the data axis, and over the model axis too
        for leaves every model rank shares when the head is split (each saw
        the trunk through its own slice of the logits)."""
        if self.mesh is None:
            return grads
        from ..train.optim import tree_leaves

        head = {id(t) for t in tree_leaves(params["fc"])} if self.tp else set()
        split = [id(p) in head for p in tree_leaves(params)]
        out = list(grads)
        for sharded in (True, False):
            idx = [i for i, s in enumerate(split) if s == sharded]
            if not idx:
                continue
            flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
            dist.all_reduce(flat, group=self.data)
            if self.tp and not sharded:
                dist.all_reduce(flat, group=self.model)
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = piece.view(grads[i].shape).to(grads[i].dtype)
        return out
