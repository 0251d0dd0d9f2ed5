"""Collective wire bytes and the card's roofline: the H100's peak rates and
the three-term step bound.

Counterpart of :mod:`repro.launch.hlo_stats`, whose name it keeps so that
a reader finds it; it holds no HLO parser.  The reference parses XLA's
optimized HLO text for collective wire bytes and op tallies; the port has
no HLO.  Its kernel launch counts (:mod:`repro_torch.kernels._build`) do
the dispatch tally's job.  The collectives come as
:class:`~repro_torch.distributed.mesh.CollectiveEvent` records instead of
HLO lines: each collective that :class:`repro_torch.distributed.mesh.Axis`
issues records one, and
the dry run's analytic count of a step is a list of them too.
:func:`collective_stats` tallies them per kind with the reference's ring
formulas, per device:

    op kind               wire bytes per device (ring schedule)
    -------------------   -------------------------------------
    all-reduce            2 · size · (n-1)/n
    all-gather            out_size · (n-1)/n
    reduce-scatter        out_size · (n-1)
    all-to-all            size · (n-1)/n
    collective-permute    size

where ``size`` is the event's bytes (an all-gather's gathered output, a
reduce-scatter's scattered shard, as the reference reads them from the
result shapes) and ``n`` its group size.  :data:`HW` holds one H100 SXM's
figures from NVIDIA's data sheet, and :func:`roofline_terms` turns a
step's operations, HBM bytes and wire bytes into seconds.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.distributed.mesh import CollectiveEvent

#: the reference's HLO names of the collective kinds
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float  # per-device bytes over the bottleneck link model
    by_kind: dict
    count: int


def wire_bytes(kind: str, size: float, n: int) -> float:
    """One collective's wire bytes per device (the ring formulas above)."""
    if kind == "collective-permute":
        return float(size)
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return float(size) * (n - 1) / n
    if kind == "reduce-scatter":
        return float(size) * (n - 1)
    return float(size)


def collective_stats(events: Iterable[CollectiveEvent]) -> CollectiveStats:
    """Per-kind ``count``, wire ``bytes`` and ``raw_bytes`` of ``events``,
    and their total wire bytes, as the reference's ``collective_stats``
    tallies an HLO program's collectives."""
    wire = 0.0
    by_kind: dict = {}
    for ev in events:
        if ev.kind not in KINDS:
            raise ValueError(f"unknown collective kind {ev.kind!r}")
        b = wire_bytes(ev.kind, ev.bytes, ev.group)
        wire += b
        entry = by_kind.setdefault(ev.kind, {"count": 0, "bytes": 0.0, "raw_bytes": 0})
        entry["count"] += 1
        entry["bytes"] += b
        entry["raw_bytes"] += int(ev.bytes)
    return CollectiveStats(wire_bytes=wire, by_kind=by_kind,
                           count=sum(v["count"] for v in by_kind.values()))


def counts(stats: CollectiveStats) -> dict:
    """``{kind: (count, raw_bytes)}`` of a :class:`CollectiveStats`: what a
    rank's recorded collectives and the dry run's count are held equal on."""
    return {k: (v["count"], v["raw_bytes"]) for k, v in sorted(stats.by_kind.items())}

#: one H100 SXM (NVIDIA H100 Tensor Core GPU data sheet): dense (not 2:4
#: sparse) tensor-core rates, HBM3 bandwidth and capacity, and NVLink 4's
#: 900 GB/s total as bytes per second in each direction
HW = {
    "bf16_flops": 989.4e12,
    "int8_ops": 1978.9e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,
}


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    wire_bytes: float,
    *,
    int8_fraction: float = 0.0,
) -> dict:
    """Seconds of the three terms of one step on one card: compute (the
    ``int8_fraction`` of ``flops`` at the int8 tensor rate, the rest at
    bf16's), memory (``hbm_bytes`` over HBM's rate) and collective
    (``wire_bytes`` over one NVLink direction); the largest names
    ``dominant`` and is ``step_lower_bound``."""
    t_compute = (flops * (1 - int8_fraction) / HW["bf16_flops"]
                 + flops * int8_fraction / HW["int8_ops"])
    t_memory = hbm_bytes / HW["hbm_bw"]
    t_coll = wire_bytes / HW["nvlink_bw"]
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_collective": t_coll,
        "dominant": dominant,
        "step_lower_bound": max(t_compute, t_memory, t_coll),
    }
