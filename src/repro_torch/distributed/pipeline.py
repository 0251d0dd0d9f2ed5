"""Pipeline parallelism: a GPipe microbatch pipeline over a mesh axis.

Counterpart of :mod:`repro.distributed.pipeline`, with the reference's tick
schedule::

    for t in 0 .. M + P - 2:          # M microbatches, P stages
        h = stage_fn(h) if active     # every stage computes each tick
        h = shift(h, s -> s + 1)      # hand activations downstream

Stage 0 takes microbatch t while any remain (then its own shifted-in
buffer), the last stage writes microbatch ``t - (P - 1)`` once that is
non-negative, and at the end the last stage's outputs are summed over the
axis, so every stage returns them.  The bubble is (P - 1) / (M + P - 1).

Where the reference runs the stages under ``shard_map`` with ``ppermute``,
each rank of the axis here runs its own stage and the ring shift is the
axis's :meth:`~repro_torch.distributed.mesh.Axis.shift` (an all-gather and
a take: gloo's send / recv fails on CUDA tensors).  Forward only: it runs
under ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tree_lib


def pipeline_apply(stage_fn: Callable, stage_params, x_mb: torch.Tensor, mesh, *,
                   axis: str = "pipe") -> torch.Tensor:
    """Run M microbatches through P pipeline stages.

    Args:
      stage_fn: ``(params_stage, h) -> h``, one stage's computation.
      stage_params: a tree whose leaves lead with the stage count P; this
        rank runs stage ``mesh``'s coordinate on ``axis`` (its slice ``[s]``).
      x_mb: ``[M, mb, ...]`` microbatches, the same on every rank of the axis.
      mesh: a :class:`~repro_torch.distributed.mesh.MeshView`.

    Returns ``[M, mb, ...]`` outputs, on every rank of the axis.
    """
    with torch.no_grad():
        return _run(stage_fn, stage_params, x_mb, mesh.axes[axis])


def _run(stage_fn, stage_params, x_mb, view):
    p, stage = view.size, view.rank
    params_stage = tree_lib.map_leaves(lambda a: a[stage], stage_params)
    m = x_mb.shape[0]
    buf = torch.zeros_like(x_mb[0])
    outs = torch.zeros_like(x_mb)
    for t in range(m + p - 1):
        h = x_mb[min(t, m - 1)] if stage == 0 and t < m else buf
        h = stage_fn(params_stage, h)
        out_idx = t - (p - 1)
        if stage == p - 1 and out_idx >= 0:
            outs[out_idx] = h
        buf = view.shift(h, 1)
    return view.all_reduce_sum(outs if stage == p - 1 else torch.zeros_like(outs))


def split_stages(stacked_params, n_stages: int):
    """``[L, ...]`` stacked leaves → ``[P, L / P, ...]`` per-stage groups."""

    def split(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} stages")
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])

    return tree_lib.map_leaves(split, stacked_params)
