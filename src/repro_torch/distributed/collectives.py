"""Quantized cross-pod collectives: the paper's byte-shrinking on slow links.

Counterpart of :mod:`repro.distributed.collectives`.  Between pods the
gradient all-reduce crosses the slow inter-pod network, so the payload goes
as int8 chunks with one float32 scale each (256 + 4 bytes for 256 float32
values: ``compression_ratio``), and is dequantized and averaged on
arrival.  Exactness is not claimed: the error is at most half a chunk's
scale a hop.

:func:`compressed_psum` quantizes the rank's tensor (``quant.quantize_chunked``,
or ``quant.quantize_stochastic`` over the same chunks with a
``torch.Generator``), all-gathers the codes and the scales over the axis,
and returns the mean of the dequantized copies, as the reference's
``shard_map`` body does (the same sum over ranks, then the division).
:func:`compressed_psum_tree` applies it leaf by leaf over the ``pod`` axis
of a :class:`~repro_torch.distributed.mesh.MeshView`, to leaves every rank
of the pod holds whole (the reference's ``in_specs=P()``), after the exact
in-pod reduction: so on the train step's global gradient, replicated over
``pod``, it returns the dequantized quantization of that gradient (the
reference's sharded step gives the same, confirmed on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import quant


def _compress(x: torch.Tensor, chunk: int, generator: Optional[torch.Generator]):
    if generator is None:
        return quant.quantize_chunked(x, chunk=chunk)
    flat = x.reshape(-1)
    n = flat.shape[0]
    chunks = torch.nn.functional.pad(flat, (0, (-n) % chunk)).reshape(-1, chunk)
    qt = quant.quantize_stochastic(chunks, generator, bits=8, axis=-1)
    return qt.data, qt.scale, n


def compressed_psum(x: torch.Tensor, axis, *, chunk: int = 256,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """int8-compressed all-reduce (mean) of ``x`` over ``axis`` (an
    :class:`~repro_torch.distributed.mesh.Axis`): quantize, all-gather the
    codes ``[W, chunks, chunk]`` and scales ``[W, chunks, 1]``, dequantize and
    take the mean, in ``x``'s shape and dtype."""
    q, s, n = _compress(x, chunk, generator)
    qg = torch.stack(axis.all_gather_list(q))
    sg = torch.stack(axis.all_gather_list(s))
    acc = quant.true_div(torch.sum(qg.to(torch.float32) * sg, dim=0), qg.shape[0])
    return acc.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def compressed_psum_tree(grads, mesh, axis: str = "pod", *, chunk: int = 256,
                         generator: Optional[torch.Generator] = None):
    """:func:`compressed_psum` leaf by leaf over the axis ``axis`` of ``mesh``
    (a :class:`~repro_torch.distributed.mesh.MeshView`).  The leaves are
    taken as every rank of the axis holds them whole; one generator, if
    given, draws the leaves' noise in turn (every rank must seed it alike)."""
    view = mesh.axes[axis]
    return tree_lib.map_leaves(
        lambda x: compressed_psum(x, view, chunk=chunk, generator=generator), grads)


def exact_psum_mean(x: torch.Tensor, axis) -> torch.Tensor:
    """The mean of ``x`` over ``axis``, exact (float32 sum, then divide)."""
    return quant.true_div(axis.all_reduce_sum(x.clone()), axis.size)


def compression_ratio(shape, dtype=torch.float32, chunk: int = 256) -> float:
    """Wire-byte ratio of a float32 all-reduce to the compressed payload."""
    n = 1
    for d in shape:
        n *= d
    f32_bytes = n * 4
    chunks = -(-n // chunk)
    comp_bytes = chunks * chunk * 1 + chunks * 4
    return f32_bytes / comp_bytes
