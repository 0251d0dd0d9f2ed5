"""Process groups, device meshes and the model axis's collectives.

Nothing here picks a backend or a device on its own: :func:`init` takes
both as arguments (``"nccl"`` is the default for a CUDA device, ``"gloo"``
for the CPU), nothing catches a refusal to try another, and no collective
moves its tensors to the host on its own.  Several ranks
may share one device (two ranks on one card under gloo): :func:`init`
sets the device it is given before any mesh is built, so a ``DeviceMesh``
never maps rank ``r`` to ``cuda:r``.

:class:`TensorParallel` is one rank's view of the mesh's model axis: its
index, the axis size, the process group, and the collectives the
tensor-parallel layer code issues (all-reduce SUM and MAX, all-gather),
on the tensors where they lie (gloo takes CUDA tensors for all four).
``collective_s`` sums the host time spent in them and ``calls`` counts
them by kind.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Optional

import torch
import torch.distributed as dist

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
class TensorParallel:
    """One rank of the model axis: ``rank`` of ``size`` in ``group``, with
    ``shard_kv`` (the KV heads split over the axis, from ``attn_dims``)."""

    size: int
    rank: int
    group: Optional[object] = None
    shard_kv: bool = True
    collective_s: float = 0.0
    calls: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_mesh(cls, mesh, *, shard_kv: bool = True, axis: str = "model"
                  ) -> "TensorParallel":
        return cls(size=mesh.size(mesh.mesh_dim_names.index(axis)),
                   rank=mesh.get_local_rank(axis), group=mesh.get_group(axis),
                   shard_kv=shard_kv)

    def _run(self, name: str, t: torch.Tensor, fn) -> torch.Tensor:
        t0 = time.perf_counter()
        self.calls[name] = self.calls.get(name, 0) + 1
        out = fn(t)
        self.collective_s += time.perf_counter() - t0
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of ``t`` (int32 or float32), on every rank."""
        if t.dtype not in (torch.int32, torch.float32):
            raise TypeError(f"all_reduce_sum: int32 or float32, not {t.dtype}")
        name = "sum_int32" if t.dtype == torch.int32 else "sum_float32"

        def fn(x):
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
            return x

        return self._run(name, t, fn)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over the axis, on every rank."""

        def fn(x):
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
            return x

        return self._run("max", t, fn)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""

        def fn(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.cat(parts, dim=dim)

        return self._run("gather", t, fn)


def tp_size(tp: Optional[TensorParallel]) -> int:
    """The model axis's size: 1 without a :class:`TensorParallel`."""
    return 1 if tp is None else tp.size
