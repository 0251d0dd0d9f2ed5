"""AdamW with selectable moment precision (f32 / bf16 / int8-quantized).

Counterpart of :mod:`repro.optim.adamw`, with the same update arithmetic
in float32 and the same functional shape::

    opt = adamw(cosine_schedule(3e-4, 20, 1000), moment_dtype="int8")
    state = opt.init(params)            # or opt.init_abstract(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``params`` and ``grads`` are nested dicts whose leaves are tensors or
:class:`repro_torch.convert.Stacked` groups: the port's model parameters go
in through :func:`repro_torch.convert.reference_layout`, so the optimizer
walks the reference's leaves in the reference's order.  A moment is
``Moment(payload, scale)``: for f32 / bf16 the payload has the leaf's
structure (a tensor, or a ``Stacked`` of per-layer tensors) and the
scale is a dummy scalar; for int8 the leaf's elements, a stacked leaf's
concatenated layer by layer (the reference's flattened ``[n, ...]`` leaf),
are cut into 256-element chunks with one scale each
(:func:`repro_torch.core.quant.quantize_chunked`), so a chunk of a small
leaf (a norm scale) spans layers exactly as in the reference.

The reference's train step is jitted with its parameters and optimizer
state donated; here the state is updated in place (the moments' buffers
are reused) and :func:`apply_updates` adds into the parameters in place.

Over a mesh each rank updates its own shards: ``init`` / ``update`` take
``shards``, a tree of :class:`LeafShard` (one a leaf of the reference's
layout: where the rank's pieces lie in the global leaf, and whether the
rank counts the leaf in the global norm), and ``mesh``, the rank's
:class:`~repro_torch.distributed.mesh.MeshView`.  :func:`global_norm`
sums the squares of each leaf on the ranks that count it, then all-reduces
the sum over the mesh.  The int8 moments keep the reference's chunk grid
over the global stacked leaf: a rank holds the codes of its own elements
(shaped as its pieces) and the scales of every chunk of the leaf; a
chunk's new scale is the max-abs of its elements on every rank holding
some of them (one MAX all-reduce a leaf), so a chunk that straddles two
shards gets the scale a single device gives it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch import tree as tree_lib
from repro_torch.convert import Stacked
from repro_torch.core import quant
from repro_torch.sharding.partitioning import flat_index

Schedule = Callable[[torch.Tensor], torch.Tensor]

_CHUNK = 256
MOMENT_DTYPES = ("f32", "bf16", "int8")


class Moment(NamedTuple):
    payload: Any  # f32/bf16: a tensor, or a Stacked for a stacked leaf; int8: [chunks, 256]
    scale: torch.Tensor  # [chunks, 1] f32 for int8; a dummy 0-dim zero otherwise


class LeafShard(NamedTuple):
    """A rank's part of one leaf of the reference's layout: ``numel`` elements
    in the global (stacked) leaf; piece ``i`` of the rank's leaf (a layer's
    shard) at ``offsets[i]`` + its shard ``indices[i]`` of a global
    per-layer tensor of ``shapes[i]``; ``counted``: the rank counts the
    leaf in the global norm (it is the first of the ranks holding the same
    elements)."""

    numel: int
    shapes: tuple
    indices: tuple
    offsets: tuple
    counted: bool

    def flat(self, i: int, device=None) -> torch.Tensor:
        """Piece ``i``'s elements' positions in the global leaf's row-major
        flattening (int64, in the piece's own order)."""
        return self.offsets[i] + flat_index(self.shapes[i], self.indices[i], device)


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-dim int32
    mu: Any  # tree of Moment
    nu: Any  # tree of Moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable
    init_abstract: Callable


def _pieces(leaf) -> tuple:
    return tuple(leaf) if isinstance(leaf, Stacked) else (leaf,)


def _flat(pieces) -> torch.Tensor:
    """A (stacked) leaf's elements as one float32 vector, layer by layer."""
    return torch.cat([p.reshape(-1).to(torch.float32) for p in pieces])


def _zeros_moment(leaf, dtype: str, shard: Optional[LeafShard] = None) -> Moment:
    pieces = _pieces(leaf)
    device = pieces[0].device
    if dtype == "int8" and shard is not None:  # the rank's codes, every chunk's scale
        codes = tuple(torch.zeros(p.shape, dtype=torch.int8, device=device) for p in pieces)
        chunks = -(-shard.numel // _CHUNK)
        scale = quant.scale_from_amax(torch.zeros((chunks, 1), device=device), bits=8)
        return Moment(Stacked(codes) if isinstance(leaf, Stacked) else codes[0], scale)
    if dtype == "int8":
        q, s, _ = quant.quantize_chunked(
            torch.zeros(math.prod(leaf.shape), dtype=torch.float32, device=device), chunk=_CHUNK)
        return Moment(q, s)
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    payload = tuple(torch.zeros(p.shape, dtype=dt, device=device) for p in pieces)
    return Moment(Stacked(payload) if isinstance(leaf, Stacked) else payload[0],
                  torch.zeros((), dtype=torch.float32, device=device))


def _abstract_moment(shape, dtype: str) -> Moment:
    meta = torch.device("meta")
    if dtype == "int8":
        chunks = -(-math.prod(shape) // _CHUNK)
        return Moment(torch.empty((chunks, _CHUNK), dtype=torch.int8, device=meta),
                      torch.empty((chunks, 1), dtype=torch.float32, device=meta))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    return Moment(torch.empty(tuple(shape), dtype=dt, device=meta),
                  torch.empty((), dtype=torch.float32, device=meta))


def cosine_schedule(peak_lr: float, warmup: int = 1000, total: int = 100_000,
                    floor: float = 0.1) -> Schedule:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor · peak_lr``
    at ``total``; float32 arithmetic on the step tensor, as the reference's."""

    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        decay = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return peak_lr * torch.where(step < warmup, warm, decay)

    return fn


def global_norm(tree, shards=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32; a stacked leaf's
    sum is its pieces' sums added in layer order.  Over a mesh (``shards``,
    ``mesh``), each rank sums the leaves it counts and the sums are
    all-reduced over every axis."""
    leaves = tree_lib.leaves(tree)
    counted = ([True] * len(leaves) if shards is None
               else [sh.counted for sh in tree_lib.leaves(shards)])
    total = torch.zeros((), dtype=torch.float32, device=_pieces(leaves[0])[0].device)
    for leaf, mine in zip(leaves, counted):
        if mine:
            total = total + sum(torch.sum(torch.square(p.to(torch.float32)))
                                for p in _pieces(leaf))
    if mesh is not None:
        total = mesh.all_reduce_sum(total)
    return torch.sqrt(total)


def adamw(lr: Union[float, Schedule], *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, wd: float = 0.1, moment_dtype: str = "f32",
          clip_norm: Optional[float] = 1.0) -> Optimizer:
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {moment_dtype!r}: one of {MOMENT_DTYPES}")

    def lr_fn(step):
        if callable(lr):
            return lr(step)
        return torch.tensor(lr, dtype=torch.float32, device=step.device)

    def init(params, shards=None):
        device = _pieces(tree_lib.leaves(params)[0])[0].device

        def zeros():  # distinct buffers for mu and nu
            if shards is None:
                return tree_lib.map_leaves(lambda p: _zeros_moment(p, moment_dtype), params)
            return tree_lib.map_leaves(lambda p, sh: _zeros_moment(p, moment_dtype, sh),
                                       params, shards)

        return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    def init_abstract(params):
        """The state's meta tensors, in the reference's shapes and dtypes (a
        stacked leaf's f32 / bf16 moment ``[n, ...]``)."""
        mom = tree_lib.map_leaves(lambda p: _abstract_moment(p.shape, moment_dtype), params)
        return AdamState(torch.empty((), dtype=torch.int32, device="meta"), mom, mom)

    def update(grads, state: AdamState, params, shards=None, mesh=None):
        """→ (updates in each parameter's dtype, the state: its moments
        updated in place, its step advanced).  Over a mesh, ``shards`` and
        ``mesh`` as for :func:`global_norm`."""
        step = state.step + 1
        lr_t = lr_fn(step)
        stepf = step.to(torch.float32)
        b1c = 1 - b1 ** stepf
        b2c = 1 - b2 ** stepf
        if clip_norm is not None:
            gn = global_norm(grads, shards, mesh)
            gscale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
        else:
            gscale = 1.0

        def adam(g32, m32, v32, p):
            """The moments in place; returns the update."""
            m32.mul_(b1).add_((1 - b1) * g32)
            v32.mul_(b2).add_((1 - b2) * torch.square(g32))
            upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + eps)
            upd = upd + wd * p.to(torch.float32)
            return (-lr_t * upd).to(p.dtype)

        def one(g, p, m: Moment, v: Moment, sh: Optional[LeafShard] = None):
            gs, ps = _pieces(g), _pieces(p)
            if moment_dtype == "int8" and sh is not None:
                outs = _int8_sharded(gs, ps, m, v, sh)
                return Stacked(outs) if isinstance(p, Stacked) else outs[0]
            if moment_dtype == "int8":
                n = math.prod(p.shape)
                m32 = quant.dequantize_chunked(m.payload, m.scale, n, (n,))
                v32 = quant.dequantize_chunked(v.payload, v.scale, n, (n,))
                flat_p = _flat(ps)
                upd = adam(_flat(gs) * gscale, m32, v32, flat_p).to(ps[0].dtype)
                for mom, x in ((m, m32), (v, v32)):
                    q, s, _ = quant.quantize_chunked(x, chunk=_CHUNK)
                    mom.payload.copy_(q)
                    mom.scale.copy_(s)
                outs, at = [], 0
                for piece in ps:
                    outs.append(upd[at:at + piece.numel()].reshape(piece.shape))
                    at += piece.numel()
                return Stacked(outs) if isinstance(p, Stacked) else outs[0]
            ms, vs = _pieces(m.payload), _pieces(v.payload)
            outs = []
            for gi, pi, mi, vi in zip(gs, ps, ms, vs):
                g32 = gi.to(torch.float32) * gscale
                if moment_dtype == "f32":
                    outs.append(adam(g32, mi, vi, pi))
                else:
                    m32, v32 = mi.to(torch.float32), vi.to(torch.float32)
                    outs.append(adam(g32, m32, v32, pi))
                    mi.copy_(m32)
                    vi.copy_(v32)
            return Stacked(outs) if isinstance(p, Stacked) else outs[0]

        def _int8_sharded(gs, ps, m: Moment, v: Moment, sh: LeafShard) -> list:
            """The rank's pieces against the global chunk grid: dequantize by
            each element's chunk scale, update, then every chunk's max-abs
            over the mesh and the codes against it → the pieces' updates."""
            chunks = m.scale.shape[0]
            amax = torch.zeros((2, chunks), dtype=torch.float32, device=m.scale.device)
            ids, moments, outs = [], [], []
            for i, (gi, pi, mi, vi) in enumerate(zip(gs, ps, _pieces(m.payload),
                                                     _pieces(v.payload))):
                c = sh.flat(i, pi.device) // _CHUNK
                m32 = mi.reshape(-1).to(torch.float32) * m.scale[c, 0]
                v32 = vi.reshape(-1).to(torch.float32) * v.scale[c, 0]
                outs.append(adam(gi.reshape(-1).to(torch.float32) * gscale, m32, v32,
                                 pi.reshape(-1)).reshape(pi.shape))
                for row, x in enumerate((m32, v32)):
                    amax[row].scatter_reduce_(0, c, x.abs(), "amax")
                ids.append(c)
                moments.append((m32, v32))
            if mesh is not None:
                amax = mesh.all_reduce_max(amax)
            for mom, row in ((m, 0), (v, 1)):
                mom.scale.copy_(quant.scale_from_amax(amax[row][:, None], bits=8))
            for c, (m32, v32), mi, vi in zip(ids, moments, _pieces(m.payload),
                                             _pieces(v.payload)):
                for mom, x, q in ((m, m32, mi), (v, v32, vi)):
                    code = torch.round(x / mom.scale[c, 0])
                    q.copy_(torch.clamp(code, -128, 127).to(torch.int8).reshape(q.shape))
            return outs

        if shards is None:
            updates = tree_lib.map_leaves(one, grads, params, state.mu, state.nu)
        else:
            updates = tree_lib.map_leaves(one, grads, params, state.mu, state.nu, shards)
        return updates, AdamState(step, state.mu, state.nu)

    return Optimizer(init=init, update=update, init_abstract=init_abstract)


def apply_updates(params, updates):
    """``p + u`` in float32, cast back to ``p``'s dtype, written into ``p``
    (in place, as the reference's donated step reuses the buffers); returns
    ``params``."""
    for p, u in zip(tree_lib.leaves(params), tree_lib.leaves(updates)):
        for pi, ui in zip(_pieces(p), _pieces(u)):
            pi.copy_((pi.to(torch.float32) + ui.to(torch.float32)).to(pi.dtype))
    return params
