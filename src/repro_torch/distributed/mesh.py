"""Process groups, device meshes, one rank's view of each mesh axis, and the
autograd-aware collectives of tensor-parallel and FSDP training.

Nothing here picks a backend or a device on its own: :func:`init` takes
both as arguments (``"nccl"`` is the default for a CUDA device, ``"gloo"``
for the CPU), nothing catches a refusal to try another, and no collective
moves its tensors to the host on its own.  Several ranks
may share one device (two ranks on one card under gloo): :func:`init`
sets the device it is given before any mesh is built, so a ``DeviceMesh``
never maps rank ``r`` to ``cuda:r``.

:class:`Axis` is one rank's view of one mesh axis (``pod``, ``data``,
``model`` or ``pipe``): its index, the axis size, the process group, and
the collectives issued over it (all-reduce SUM and MAX, all-gather,
reduce-scatter, and the pipeline's ring shift), on the tensors where they
lie.  ``collective_s`` sums the host time spent in them,
``calls`` counts them by kind, and ``events`` counts each
:class:`CollectiveEvent` (the reference's HLO kind, the result's bytes,
the group size) that ``repro_torch.launch.hlo_stats.collective_stats``
tallies into wire bytes.  :class:`TensorParallel` is the model
axis's view, with ``shard_kv`` (the KV heads split over the axis).
:class:`MeshView` holds every axis of a mesh, reduces over several in
turn, and gathers over several into the order their blocks take (a serving
engine's slots over ``pod`` × ``data``).

The autograd-aware forms (each a ``torch.autograd.Function``; the identity
without an axis or at one rank):

* :func:`copy_to` — identity forward, all-reduce backward: the input of a
  column-parallel projection (each rank's columns give a partial gradient
  of the replicated input), and a parameter that each rank applies to its
  own heads (``q_norm``);
* :func:`reduce_from` — all-reduce forward, identity backward: the output
  of a row-parallel projection and the vocab-sharded embedding lookup;
* :func:`gather_from` — all-gather forward, reduce-scatter backward: FSDP's
  gather-on-use of a parameter shard, whose gathered copy each data rank
  uses on its own rows (the gradient summed in its own dtype, as GSPMD's
  reduce-scatter of the reference's gradient);
* :func:`gather_replicated` — all-gather forward, the rank's slice
  backward: the vocab-sharded logits, which feed a loss that every model
  rank computes whole (a reduce-scatter would count each rank's identical
  gradient ``size`` times).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import time
import warnings
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class CollectiveEvent(NamedTuple):
    """One collective on one rank: its HLO ``kind`` (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all`` or
    ``collective-permute``), the ``bytes`` of its result (an all-gather's
    gathered tensor, a reduce-scatter's shard, an all-reduce's tensor) and
    the ``group`` of ranks it spans."""

    kind: str
    bytes: int
    group: int


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(*, rank: int, world_size: int, init_method: str, device, backend: Optional[str] = None,
         timeout_s: Optional[float] = None) -> None:
    """Join the default process group as ``rank`` of ``world_size`` on
    ``backend`` (default :func:`default_backend` of ``device``), with
    ``device`` (a CUDA device is made current first).  ``init_method`` names
    the rendezvous, e.g. ``"tcp://localhost:29500"``; ``timeout_s`` bounds
    how long a collective waits for a rank that does not come."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend or default_backend(device), init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)


def device_mesh(device, shape: tuple, names: tuple):
    """A ``DeviceMesh`` of ``shape`` over the default group's ranks (row-major)
    with axis ``names``, on ``device``'s type.  The group's size must be the
    mesh's."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh {names} needs a world of {n} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=tuple(names))


@dataclasses.dataclass
class Axis:
    """One rank of one mesh axis: ``rank`` of ``size`` in ``group``."""

    size: int
    rank: int
    group: Optional[object] = None
    name: str = ""
    collective_s: float = 0.0
    calls: dict = dataclasses.field(default_factory=dict)
    events: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    @classmethod
    def from_mesh(cls, mesh, axis: str, **kw):
        return cls(size=mesh.size(mesh.mesh_dim_names.index(axis)),
                   rank=mesh.get_local_rank(axis), group=mesh.get_group(axis), name=axis, **kw)

    def _run(self, name: str, kind: str, nbytes: int, t: torch.Tensor, fn) -> torch.Tensor:
        t0 = time.perf_counter()
        self.calls[name] = self.calls.get(name, 0) + 1
        self.events[CollectiveEvent(kind, nbytes, self.size)] += 1
        out = fn(t)
        self.collective_s += time.perf_counter() - t0
        return out

    def reset_counts(self) -> None:
        self.collective_s, self.calls, self.events = 0.0, {}, collections.Counter()

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of ``t``, on every rank (``t`` itself is
        reduced in place when it is contiguous)."""

        def fn(x):
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
            return x

        return self._run("sum_" + str(t.dtype).removeprefix("torch."), "all-reduce",
                         _nbytes(t), t, fn)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the axis, on every rank."""

        def fn(x):
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
            return x

        return self._run("max", "all-reduce", _nbytes(t), t, fn)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        return torch.cat(self.all_gather_list(t), dim=dim)

    def all_gather_list(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (all of one shape), in rank order."""

        def fn(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return parts

        return self._run("gather", "all-gather", self.size * _nbytes(t), t, fn)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The sum over the axis of ``t``, cut in ``size`` equal parts along
        ``dim``: this rank's part."""

        def fn(x):
            x = x.movedim(dim, 0).contiguous()
            out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
            with warnings.catch_warnings():  # renamed in later torch releases
                warnings.simplefilter("ignore", FutureWarning)
                dist.reduce_scatter_tensor(out, x, group=self.group)
            return out.movedim(0, dim)

        return self._run("reduce_scatter", "reduce-scatter", _nbytes(t) // self.size, t, fn)

    def shift(self, t: torch.Tensor, offset: int = 1) -> torch.Tensor:
        """The ring shift: the tensor of the rank ``offset`` upstream, on every
        rank.  Written as an all-gather and a take, not as send / recv: gloo's
        send / recv fails on CUDA tensors (torch 2.11), where its all-gather
        takes them."""
        return self.all_gather_list(t)[(self.rank - offset) % self.size]


@dataclasses.dataclass
class TensorParallel(Axis):
    """One rank of the model axis, with ``shard_kv`` (the KV heads split over
    the axis, from ``attn_dims``)."""

    shard_kv: bool = True

    @classmethod
    def from_mesh(cls, mesh, *, shard_kv: bool = True, axis: str = "model"
                  ) -> "TensorParallel":
        return super().from_mesh(mesh, axis, shard_kv=shard_kv)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tp_size(tp: Optional[Axis]) -> int:
    """An axis's size: 1 without one."""
    return 1 if tp is None else tp.size


@dataclasses.dataclass
class MeshView:
    """One rank's view of every axis of a mesh: ``axes`` by name, in the
    mesh's order; an absent axis is of size 1."""

    axes: dict

    @classmethod
    def from_mesh(cls, mesh, *, shard_kv: bool = True) -> "MeshView":
        """The views of a ``DeviceMesh``'s axes; its ``model`` axis is a
        :class:`TensorParallel` with ``shard_kv``."""
        axes = {}
        for name in mesh.mesh_dim_names:
            if name == "model":
                axes[name] = TensorParallel.from_mesh(mesh, shard_kv=shard_kv)
            else:
                axes[name] = Axis.from_mesh(mesh, name)
        return cls(axes)

    def size(self, name: str) -> int:
        return self.axes[name].size if name in self.axes else 1

    def coord(self, name: str) -> int:
        return self.axes[name].rank if name in self.axes else 0

    @property
    def sizes(self) -> dict:
        """Axis name → size; the canonical ``pod`` / ``data`` / ``model`` axes
        the mesh does not have are of size 1."""
        return {"pod": 1, "data": 1, "model": 1} | {k: a.size for k, a in self.axes.items()}

    @property
    def coords(self) -> dict:
        return {"pod": 0, "data": 0, "model": 0} | {k: a.rank for k, a in self.axes.items()}

    def axis(self, name: str) -> Optional[Axis]:
        """The view of ``name``, or None when the mesh has no such axis or it
        is of size 1."""
        a = self.axes.get(name)
        return a if a is not None and a.size > 1 else None

    def all_reduce_sum(self, t: torch.Tensor, names=None) -> torch.Tensor:
        """The sum over the axes ``names`` (default every axis), one axis after
        another."""
        for name in self.axes if names is None else names:
            if self.axis(name) is not None:
                t = self.axes[name].all_reduce_sum(t)
        return t

    def all_reduce_max(self, t: torch.Tensor, names=None) -> torch.Tensor:
        for name in self.axes if names is None else names:
            if self.axis(name) is not None:
                t = self.axes[name].all_reduce_max(t)
        return t

    def all_gather(self, t: torch.Tensor, names, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` over the axes ``names`` (a partition entry's
        order: the first the outermost, pod-major), concatenated along
        ``dim`` in the order of the ranks' blocks (:meth:`block`): the
        innermost axis gathered first, so that a rank's rows land where the
        entry's batch sharding puts them (slot order)."""
        for name in reversed(tuple(names)):
            if self.axis(name) is not None:
                t = self.axes[name].all_gather(t, dim)
        return t

    def block(self, names) -> tuple:
        """(ways, index) of this rank's block of a dim sharded over the axes
        ``names``, the first the outermost: the product of their sizes, and
        the rank's place in it."""
        ways, index = 1, 0
        for name in names:
            ways, index = ways * self.size(name), index * self.size(name) + self.coord(name)
        return ways, index

    @property
    def collective_s(self) -> float:
        return sum(a.collective_s for a in self.axes.values())

    @property
    def calls(self) -> dict:
        """Calls by kind over every axis."""
        out: dict = {}
        for a in self.axes.values():
            for k, v in a.calls.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def events(self) -> collections.Counter:
        """Collective events over every axis."""
        out: collections.Counter = collections.Counter()
        for a in self.axes.values():
            out.update(a.events)
        return out

    def reset_counts(self) -> None:
        for a in self.axes.values():
            a.reset_counts()


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------


def _active(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_sum(g.clone(memory_format=torch.contiguous_format)), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_sum(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, scatter):
        ctx.axis, ctx.dim, ctx.scatter = axis, dim, scatter
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.scatter:
            return ctx.axis.reduce_scatter(g, ctx.dim), None, None, None
        n = g.shape[ctx.dim] // ctx.axis.size
        return g.narrow(ctx.dim, ctx.axis.rank * n, n), None, None, None


def copy_to(axis: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce (sum) of the gradient over ``axis``
    backward; ``x`` itself when no gradient flows to it (serving)."""
    if not (_active(axis) and isinstance(x, torch.Tensor) and x.requires_grad
            and torch.is_grad_enabled()):
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(axis: Optional[Axis], x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) over ``axis`` forward, identity backward."""
    if not _active(axis):
        return x
    return _ReduceFrom.apply(x, axis)


def gather_from(axis: Optional[Axis], x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``axis`` forward, reduce-scatter of the
    gradient backward."""
    if not _active(axis):
        return x
    return _GatherFrom.apply(x, axis, dim % x.ndim, True)


def gather_replicated(axis: Optional[Axis], x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` over ``axis`` forward, the rank's slice of the
    (replicated) gradient backward."""
    if not _active(axis):
        return x
    return _GatherFrom.apply(x, axis, dim % x.ndim, False)
