"""The card's roofline: the H100's peak rates and the three-term step bound.

Counterpart of :mod:`repro.launch.hlo_stats`, whose name it keeps so that
a reader finds it; it holds no HLO parser.  The reference parses XLA's
optimized HLO text for collective wire bytes and op tallies; the port has
no HLO.  Its kernel launch counts (:mod:`repro_torch.kernels._build`) do
the dispatch tally's job, and the collectives' bytes come with a sharded
step.  What is left is the roofline: :data:`HW` holds one H100 SXM's
figures from NVIDIA's data sheet, and :func:`roofline_terms` turns a
step's operations, HBM bytes and wire bytes into seconds.
"""

from __future__ import annotations

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
