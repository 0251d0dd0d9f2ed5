"""Host → device transfer plans — the paper's §V, on one host's ranks.

Counterpart of :mod:`repro.core.transfer`.  The paper's finding: a
default allocator that ignores which channel a rank hangs off funnels
transfers through one channel; placing each rank's data over its own
channel fixes both the rate and its variance.  The tensor-parallel
analogue is the weight placement:

* :func:`plan_balanced`: every rank copies only its own shard of the host
  array (the slice its partition entries give) to its device; no rank
  moves another's bytes.
* :func:`plan_naive`: rank 0 copies the whole array to its device and
  broadcasts it, every rank keeps the whole array: the funnel the paper
  beats.

:func:`measure` times a plan (the wall time up to a device synchronize)
and counts what each rank moved; :func:`balanced_feed_order` visits
devices round-robin over hosts; :func:`streamed_weight_bytes` is the bytes
a GEMV-MV pass must stream.  The serving engine places its weights at
``tp > 1`` through :func:`place_shard`, the per-leaf step of
:func:`plan_balanced`.
"""

from __future__ import annotations

import dataclasses
import time
import numpy as np
import torch

from repro_torch.sharding import partitioning as P


@dataclasses.dataclass(frozen=True)
class TransferStats:
    bytes_moved: int
    seconds: float
    per_host_bytes: dict

    @property
    def gbps(self) -> float:
        return self.bytes_moved / max(self.seconds, 1e-9) / 1e9


def _bytes(x) -> int:
    return int(np.prod(x.shape)) * (x.element_size() if isinstance(x, torch.Tensor)
                                    else x.dtype.itemsize)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def place_shard(x, index: tuple, device) -> torch.Tensor:
    """The shard of host array ``x`` at ``index`` (a :func:`~repro_torch.
    sharding.partitioning.shard_index`), copied on its own to ``device``."""
    return P.take_index(_as_tensor(x), index).to(device, copy=True).contiguous()


def plan_balanced(x, mesh, spec, *, device) -> torch.Tensor:
    """This rank's shard of ``x`` under partition entries ``spec`` (a
    :func:`~repro_torch.sharding.partitioning.spec_for` result) on the
    ``DeviceMesh`` ``mesh``, copied from the host to ``device``: every rank
    moves exactly its own bytes."""
    index = P.shard_index(x.shape, spec, P.mesh_sizes(mesh), P.mesh_coords(mesh))
    return place_shard(x, index, device)


def plan_naive(x, mesh, *, device, group=None) -> torch.Tensor:
    """The whole of ``x`` on every rank, copied to the device by rank 0 only
    and broadcast from there (one rank's channel carries every byte).
    ``mesh`` is unused: the naive plan ignores the layout."""
    import torch.distributed as dist

    del mesh
    if dist.get_rank() == 0:
        out = _as_tensor(x).to(device, copy=True).contiguous()
    else:
        out = torch.empty(tuple(x.shape), dtype=_as_tensor(x).dtype, device=device)
    dist.broadcast(out, src=0, group=group)
    return out


def measure(fn, x, *args, repeats: int = 3, **kwargs) -> TransferStats:
    """Wall-time a plan ``fn(x, *args, **kwargs)`` (after one warm-up call),
    each call ended by a device synchronize.  ``per_host_bytes`` is this
    rank's: the bytes it copied from the host (its shard's, or the whole
    array's under the naive plan on rank 0, none on the other ranks)."""
    import torch.distributed as dist

    def sync(out):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        return out

    out = sync(fn(x, *args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = sync(fn(x, *args, **kwargs))
    dt = (time.perf_counter() - t0) / repeats
    rank = dist.get_rank() if dist.is_initialized() else 0
    moved = _bytes(out) if fn is not plan_naive or rank == 0 else 0
    return TransferStats(bytes_moved=_bytes(x), seconds=dt, per_host_bytes={rank: moved})


def balanced_feed_order(mesh) -> list[int]:
    """Device visit order round-robin over hosts ('channels') — the paper's
    ``equal_channel_distribution()`` (Fig. 10).  ``mesh.devices`` holds
    objects with ``id`` and ``process_index``."""
    by_host: dict[int, list] = {}
    for d in np.asarray(mesh.devices).flat:
        by_host.setdefault(d.process_index, []).append(d)
    order: list[int] = []
    while any(by_host.values()):
        for h in sorted(by_host):
            if by_host[h]:
                order.append(by_host[h].pop(0).id)
    return order


def streamed_weight_bytes(param_tree) -> int:
    """Total bytes the GEMV-MV scenario must move per invocation (a
    residency state's payload and scales)."""
    from repro_torch import tree as tree_lib
    from repro_torch.core import residency

    return sum(_bytes(x.data) + _bytes(x.scale) if isinstance(x, residency.QuantLinearState)
               else _bytes(x) for x in tree_lib.leaves(param_tree))
