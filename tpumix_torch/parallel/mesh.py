"""Process meshes and the data-parallel helpers over ``torch.distributed``
(tpumix/parallel/mesh.py).

The JAX package scales the TPU way: a ``jax.sharding.Mesh`` with named axes,
and GSPMD inserts the gradient ``psum`` and the global batch-norm reductions.
Here every rank is a process (one per card, or several gloo ranks on one
card or on the CPU), a :class:`Mesh` names axes over the ranks of the process
group, and the reductions are explicit collectives:

* a batch is split on its leading axis into contiguous blocks, one per rank
  of the ``dp`` axis, in rank order (``P("dp")``): :func:`batch_sharding`,
  :func:`shard_batch`;
* the train steps built with a mesh (tpumix_torch/train/state.py) average
  the gradients, normalise BatchNorm over the global batch
  (tpumix_torch/models/blocks.py) and reduce their metrics, so an N-rank step
  is the one-process step on the global batch;
* :func:`data_parallel` is ``data_parallel_jit``'s counterpart: it feeds such
  a step the global batch;
* a train step built with a second, ``sp`` axis splits the frame axis of
  the trunk over it (tpumix_torch/parallel/frames.py): :meth:`Mesh.axes`
  names the ``dp x sp`` group its BatchNorm and gradients reduce over, and
  :meth:`MeshAxis.sum_identity_grad` / :meth:`MeshAxis.grad_sum` carry the
  partial head dots and the frame-split losses between the ranks.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpumix_torch.parallel.distributed import _tree_map, process_count, process_index


class _AllReduceSum(torch.autograd.Function):
    """``y = sum over ranks of x``; the gradient of every rank's ``x`` is the
    sum over ranks of the gradients of ``y``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


class _SumIdentityGrad(torch.autograd.Function):
    """``y = sum over ranks of x``, whose backward is the identity: for a
    ``y`` that every rank then uses alike, each rank's ``x`` gets the
    gradient of ``y`` once (a sum over ranks would count it once per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradSum(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the ranks: the
    gradient of a value that each rank uses for its own part of a sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One named axis as this rank sees it: its size, this rank's coordinate
    along it, and the process group of the ranks that share every other
    coordinate (None: the default group, or no group at all on one rank)."""

    name: str
    size: int
    index: int
    group: Optional[object] = None

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the axis in place (no autograd) and return it."""
        if self.size > 1:
            dist.all_reduce(x, group=self.group)
        return x

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the axis's ranks, as data (no autograd):
        the global mean of a per-rank mean over equal shards."""
        if self.size == 1:
            return x
        return self.all_reduce(x.detach().clone()) / self.size

    def sum_with_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis's ranks, differentiable: its
        backward sums the gradients over the ranks (the function of
        ``torch.distributed.nn.functional.all_reduce``, which newer torch
        deprecates)."""
        if self.size == 1:
            return x
        return _AllReduceSum.apply(x, self.group)

    def sum_identity_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the axis's ranks; its backward passes the
        gradient through unchanged (the partial dots of a split head)."""
        if self.size == 1:
            return x
        return _SumIdentityGrad.apply(x, self.group)

    def grad_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its backward sums the gradient over the axis's ranks
        (a replicated value each rank uses for its own part of a loss)."""
        if self.size == 1:
            return x
        return _GradSum.apply(x, self.group)

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous block of a leading axis of ``n_global``."""
        if n_global % self.size:
            raise ValueError(f"batch of {n_global} does not split over {self.size} ranks "
                             f"of axis {self.name!r}")
        n = n_global // self.size
        return slice(self.index * n, (self.index + 1) * n)


class Mesh:
    """Named axes over the ranks of the process group (JAX ``Mesh``):
    ``devices`` is the grid of ranks, ``axis_names`` its axes and ``shape``
    the ordered ``{axis: size}``.  Build it with :func:`make_mesh` on every
    rank, in the same order: it creates the axes' process groups."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...]):
        if ranks.ndim != len(axis_names):
            raise ValueError(f"mesh of {ranks.ndim} dims needs {ranks.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        me = tuple(int(i[0]) for i in np.nonzero(ranks == process_index()))
        world = process_count()
        self._axes: Dict[str, MeshAxis] = {}
        for d, name in enumerate(self.axis_names):
            group = None
            if 1 < ranks.shape[d] < world:
                # every rank creates every group of this axis, in one order
                for other in itertools.product(*(range(s) for i, s in enumerate(ranks.shape)
                                                  if i != d)):
                    members = [int(ranks[other[:d] + (j,) + other[d:]])
                               for j in range(ranks.shape[d])]
                    g = dist.new_group(members)
                    if other == me[:d] + me[d + 1:]:
                        group = g
            self._axes[name] = MeshAxis(name, int(ranks.shape[d]), me[d], group)

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict((n, a.size) for n, a in self._axes.items())

    def axis(self, name: str) -> MeshAxis:
        if name not in self._axes:
            raise ValueError(f"mesh has no axis {name!r}; have {self.axis_names}")
        return self._axes[name]

    def axes(self, *names: str) -> MeshAxis:
        """The axes ``names`` as one: one name is :meth:`axis`; several must
        be every axis of the mesh whose size exceeds 1 (the group of all
        ranks), as ``("dp", "sp")`` is on a ``dp x sp`` mesh."""
        names = tuple(n for n in names if n is not None)
        for n in names:
            self.axis(n)
        if len(names) == 1:
            return self.axis(names[0])
        wide = {n for n, a in self._axes.items() if a.size > 1}
        if not wide <= set(names):
            raise ValueError(f"axes {names} leave out {sorted(wide - set(names))}: only one "
                             "axis or every axis of the mesh can act as one")
        index = int(np.ravel_multi_index(tuple(self._axes[n].index for n in self.axis_names),
                                         self.devices.shape))
        return MeshAxis("*".join(names), int(self.devices.size), index)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, rank {process_index()})"


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp",)) -> Mesh:
    """A mesh over every rank of the process group (one process: a mesh of
    one).  Default: all ranks on one ``dp`` axis.  ``shape`` must multiply to
    the process count: a rank left out of every axis would deadlock the
    collectives the others run."""
    world = process_count()
    if shape is None:
        shape = (world,)
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} processes, have {world}")
    return Mesh(np.arange(n).reshape(shape), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies over a mesh: its leading axis split over ``axis``
    (``P(axis)``), or whole on every rank (``axis=None``, ``P()``)."""

    mesh: Mesh
    axis: Optional[str] = None

    def local(self, x):
        """This rank's part of the global ``x``."""
        if self.axis is None or np.ndim(x) == 0:
            return x
        return x[self.mesh.axis(self.axis).rows(len(x))]


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: str = "dp") -> Sharding:
    """Shard the leading (batch) axis over ``batch_axis``, replicate the rest."""
    return Sharding(mesh, batch_axis if ndim > 0 else None)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch, mesh: Mesh, batch_axis: str = "dp", device=None):
    """This rank's rows of every array of a global batch (a tuple, list or
    dict), as tensors on ``device`` (None: where they lie, host arrays on the
    CPU)."""

    def put(x):
        t = torch.as_tensor(batch_sharding(mesh, np.ndim(x), batch_axis).local(x))
        return t if device is None else t.to(device)

    return _tree_map(put, batch)


def broadcast_module(module: torch.nn.Module) -> None:
    """Make every rank's parameters and buffers rank 0's, in place (a mesh of
    one rank in a group still runs the collectives: they bring up its
    backend)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in itertools.chain(module.parameters(), module.buffers()):
            dist.broadcast(t.data, src=0)


def average_gradients(params, axis: MeshAxis, divisor: Optional[int] = None) -> None:
    """Replace each gradient by its sum over the axis's ranks divided by
    ``divisor`` (default: the axis's size, the mean): one collective over a
    flat buffer of every gradient.  A ``dp x sp`` step sums over both axes
    and divides by the ``dp`` size."""
    grads = [p.grad for p in params if p.grad is not None]
    if axis.size == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    axis.all_reduce(flat)
    flat /= axis.size if divisor is None else divisor
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def data_parallel(step: Callable, mesh: Mesh, batch_axis: str = "dp") -> Callable:
    """``data_parallel_jit``'s counterpart for a step built with ``mesh``:
    the wrapped step takes the GLOBAL batch and runs the step on this rank's
    rows of each batch argument (tensors and arrays; a generator or other
    argument passes through).  The step's collectives make every rank's
    result that of a one-process step on the global batch."""

    def wrapped(*args, **kwargs):
        args = [shard_batch(a, mesh, batch_axis) if isinstance(a, (np.ndarray, torch.Tensor))
                else a for a in args]
        return step(*args, **kwargs)

    return wrapped
