"""Mixture-of-Experts with sort-based (dropping, capacity-bounded) dispatch.

Counterpart of :mod:`repro.models.moe`.  Routing: softmax over all experts
in float32 → top-k → renormalize (the Mixtral/DeepSeek convention), with
the load-balancing auxiliary loss.  Each batch row's ``S·k`` (token, choice)
slots are sorted by expert id, stably, so that within an expert they keep
token order (GShard's FIFO); an expert takes at most ``cap = max(1,
int(S·k·cf/E + 0.999))`` of a row's slots and drops the rest (they
contribute zero).  Pad tokens are routed like any other and take capacity
in their turn, as in the reference.  The kept slots are packed into an
``[E, B·cap, D]`` buffer and the expert FFN runs on it, empty slots
included: each stacked projection is one launch over every expert
(:func:`repro_torch.models.layers.dense_stacked`).

The combine gathers each token's ``k`` expert outputs back and sums them in
expert-id order, in ``x.dtype`` — the order of the reference's scatter-add
over the sorted slots — with no scatter-add: a CUDA ``index_add_`` on
floats names no order and is not repeatable, this sum is.

Tensor parallelism (``tp``, a :class:`~repro_torch.distributed.mesh.
TensorParallel`) follows the reference's rule table: where the experts
divide the model axis (``shard_experts``) a rank holds ``E/tp`` of them and
its ``E/tp`` router columns; otherwise every rank holds every expert and
its share of their hidden width (``moe_mlp``).  Either way the routing is
the whole layer's on every rank: the ranks' router logits are gathered
(:func:`_router_logits`) before the softmax over all ``E`` experts, so
capacity and drops come out the same on every rank.  With the experts
sharded, a rank runs its own experts' slice of the ``[E, B·cap, D]``
buffer and writes the per-slot outputs of its experts, zero elsewhere;
these are all-reduced (each slot is non-zero on exactly one rank, so the
sum is exact) and then combined in expert-id order as on one device, so
``w8a8`` serves bit for bit as one device does.  With the hidden width sharded, ``w_in`` is column-parallel
and ``w_out`` row-parallel (:func:`repro_torch.models.layers.
row_parallel_stacked`).  The shared experts are a dense FFN, column- then
row-parallel (:func:`repro_torch.models.layers.mlp_apply`), added once.

The same code trains.  The sums are ``reduce_from`` (the router's logits,
the per-slot outputs), whose forward is the all-reduce above, and the
tensors every rank holds whole but feeds only its share of the work go
through ``copy_to``, their gradients summed over the model axis: the
experts' input (the rank's experts, or its share of their hidden width),
with the experts sharded the router's input too (the rank's router
columns), and the gates (the rank's slots).

The load-balancing loss is the batch's: ``me`` (the mean router
probability an expert) and ``ce`` (the share of tokens whose first choice
it is) over all of the batch's rows.  Over a batch split across ranks
(``global_counts``) the top-1 counts are the global batch's (or the
microbatch's), and each rank returns its share of the loss, ``E ·
Σ_e ce_e · (its rows' probabilities summed) / N``: the shares sum to the
global loss, and each share's gradient is the global loss's gradient
with respect to the rank's rows.  Capacity is per row, as in the
reference: a split batch changes no drop.

:func:`moe_apply_einsum` is the GShard one-hot dispatch, and :func:`moe_ref`
the dense reference (every expert on every token, gate-masked) that the
tests hold the dispatch to; neither takes ``tp``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import residency
from repro_torch.distributed.mesh import copy_to, reduce_from
from repro_torch.models import layers
from repro_torch.models.layers import activation, dense, dense_stacked


def capacity(cfg, s: int, capacity_factor: Optional[float] = None) -> int:
    """Slots an expert takes from one batch row of ``s`` tokens."""
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(s * cfg.experts_per_tok * cf / cfg.n_experts + 0.999))


def _router_logits(params, x, cfg, tp=None):
    """The router's float32 logits over all ``E`` experts ``[B, S, E]`` on
    every rank.  A rank that holds ``E/tp`` router columns computes its
    logits in place among ``E`` (the other ranks' columns zero) and the
    ranks' logits are summed, which gathers them exactly: each logit is
    non-zero on one rank only.  At the whole width each logit is the
    one-device product bit for bit, where a product ``E/tp`` wide may sum
    in another order (the CPU and cuBLAS pick their kernels by shape)."""
    w = params["router"]
    held, e = w.shape[-1], cfg.n_experts
    if held != e:
        w = torch.nn.functional.pad(w, (tp.rank * held, e - (tp.rank + 1) * held))
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), w)
    return logits if held == e else reduce_from(tp, logits)


def _route(params, x, cfg, tp=None, global_counts=None):
    """Top-k routing.  x: [B, S, D] → (idx [B,S,k] int64, gate [B,S,k] in
    x.dtype, aux loss), the same on every rank.  ``global_counts(local)``,
    over a split batch, gives the top-1 counts ``[E]`` of the whole
    (micro)batch from this rank's and the ways the batch is split; the aux
    loss is then the rank's share (module docstring)."""
    probs = torch.softmax(_router_logits(params, x, cfg, tp), dim=-1)
    gate, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    top1 = torch.nn.functional.one_hot(idx[..., 0], e).to(torch.float32)
    if global_counts is None:
        me = probs.mean(dim=(0, 1))  # mean router probability per expert
        aux = e * torch.sum(me * top1.mean(dim=(0, 1)))
    else:
        counts, ways = global_counts(top1.sum(dim=(0, 1)))
        n = probs.shape[0] * probs.shape[1] * ways
        aux = e * torch.sum(probs.sum(dim=(0, 1)) / n * (counts / n))
    return idx, gate.to(x.dtype), aux


def _n_experts_held(w) -> int:
    """The experts a stacked weight (float or residency state) holds."""
    return (w.data if isinstance(w, residency.QuantLinearState) else w).shape[0]


def _expert_ffn(params, h, cfg, impl=None, tp=None):
    """h: [E, C, D] → [E, C, D] through each expert's SwiGLU/GELU.  Under
    ``tp`` with the hidden width sharded, ``w_out`` is row-parallel."""
    z = activation(dense_stacked(params["w_in"], h, impl=impl), cfg)
    if tp is not None and tp.size > 1 and _n_experts_held(params["w_in"]) == cfg.n_experts:
        return layers.row_parallel_stacked(params["w_out"], z, tp, impl=impl)
    return dense_stacked(params["w_out"], z, impl=impl)


def _shared(params, x, cfg, impl=None, tp=None):
    """The shared experts: one dense FFN (column- then row-parallel under
    ``tp``), its whole output on every rank."""
    return layers.mlp_apply({"w_in": params["shared_w_in"], "w_out": params["shared_w_out"]},
                            x, cfg, impl=impl, tp=tp)


def _dispatch(idx, gate, s: int, cap: int, e: int):
    """Sort each row's ``S·k`` slots by expert id (stable: FIFO) → (order,
    expert, token and gate of each sorted slot, keep, destination row of
    the ``[B, E·cap]`` buffer; ``E·cap`` for a dropped slot)."""
    b, _, k = idx.shape
    eid = idx.reshape(b, s * k)
    order = torch.argsort(eid, dim=1, stable=True)  # [B, S*k]
    eid_s = torch.gather(eid, 1, order)
    tok_s = torch.div(order, k, rounding_mode="floor")  # token of each sorted slot
    gts_s = torch.gather(gate.reshape(b, s * k), 1, order)
    # position within its expert = rank − the expert's first rank
    counts = torch.zeros((b, e), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, eid_s, torch.ones_like(eid_s))  # integer: exact in any order
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(s * k, device=idx.device)[None, :]
    pos = rank - torch.gather(starts, 1, eid_s)
    keep = pos < cap
    dest = torch.where(keep, eid_s * cap + pos, e * cap)  # e·cap: the dropped slot
    return order, eid_s, tok_s, gts_s, keep, dest


def _slot_outputs(params, x, cfg, routed, cap: int, *, first: int = 0, impl=None, tp=None):
    """The gated outputs ``[B, S·k, D]`` (sorted slots) of the experts this
    rank holds, ``first ..`` (all of them on one device); a slot of another
    rank's expert, or a dropped slot, is zero."""
    b, _, d = x.shape
    _, eid_s, tok_s, gts_s, keep, dest = routed
    held = _n_experts_held(params["w_in"])
    mine = keep & (eid_s >= first) & (eid_s < first + held)
    local = torch.where(mine, dest - first * cap, held * cap)
    # pack the rank's kept slots into [B, held·cap, D] (each destination once)
    buf = torch.zeros((b, held * cap, d), dtype=x.dtype, device=x.device)
    kb, ks = mine.nonzero(as_tuple=True)
    buf[kb, local[kb, ks]] = x[kb, tok_s[kb, ks]]
    h = buf.reshape(b, held, cap, d).transpose(0, 1).reshape(held, b * cap, d)
    h = _expert_ffn(params, h, cfg, impl=impl, tp=tp)
    h = h.reshape(held, b, cap, d).transpose(0, 1).reshape(b, held * cap, d)
    # back to the slots, gated; the rank's other slots read zeros
    h = torch.nn.functional.pad(h, (0, 0, 0, 1))
    out_s = torch.gather(h, 1, local[..., None].expand(*local.shape, d))
    return out_s * (gts_s * mine)[..., None].to(out_s.dtype)


def _combine(out_s, order, k: int, tp=None, sharded: bool = False):
    """Each token's ``k`` slot outputs summed in sorted order (= expert-id
    order), left to right in ``out_s.dtype``.  With the experts ``sharded``
    the ranks' per-slot outputs are all-reduced first: each slot is
    non-zero on one rank only, so the sum is exact and the combine is one
    device's."""
    if sharded:
        out_s = reduce_from(tp, out_s)
    b, sk, d = out_s.shape
    inv = torch.argsort(order, dim=1)  # sorted position of slot (token, choice)
    at = torch.sort(inv.reshape(b, sk // k, k), dim=-1).values.reshape(b, sk)
    parts = torch.gather(out_s, 1, at[..., None].expand(b, sk, d)).reshape(b, sk // k, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]
    return y


def moe_apply(params: dict, x: torch.Tensor, cfg, *,
              capacity_factor: Optional[float] = None, impl=None, tp=None,
              global_counts=None):
    """x: [B, S, D] → ([B, S, D], aux_loss).  Sort-based capacity dispatch;
    under ``tp`` the rank's experts or hidden share, over a split batch
    (``global_counts``, :func:`_route`) the rank's share of the aux loss
    (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    cap = capacity(cfg, s, capacity_factor)
    held = _n_experts_held(params["w_in"])
    sharded = held != e
    xt = copy_to(tp, x)  # the experts' input: the rank's experts or hidden share
    idx, gate, aux = _route(params, xt if sharded else x, cfg, tp, global_counts)  # [B, S, k]
    if sharded:  # a rank's slots give a partial gradient of the gates
        gate = copy_to(tp, gate)
    routed = _dispatch(idx, gate, s, cap, e)
    first = tp.rank * held if sharded else 0
    out_s = _slot_outputs(params, xt, cfg, routed, cap, first=first, impl=impl, tp=tp)
    y = _combine(out_s, routed[0], k, tp, sharded=sharded)
    if cfg.n_shared_experts:
        y = y + _shared(params, x, cfg, impl=impl, tp=tp)
    return y, aux


def moe_apply_einsum(params: dict, x: torch.Tensor, cfg, *,
                     capacity_factor: Optional[float] = None, impl=None, global_counts=None):
    """GShard-style one-hot dispatch: the same result as :func:`moe_apply`
    up to the order of drops (identical when capacity is ample)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    cap = capacity(cfg, s, capacity_factor)
    idx, gate, aux = _route(params, x, cfg, global_counts=global_counts)
    F = torch.nn.functional

    # slot-sequential position assignment: iterate the k choices,
    # accumulating each expert's fill so duplicates never collide
    fill = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    dispatch = torch.zeros((b, s, e, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros_like(dispatch)
    for slot in range(k):
        eid = idx[..., slot]
        onehot_e = F.one_hot(eid, e)  # [B, S, E]
        prefix = torch.cumsum(onehot_e, dim=1) - onehot_e
        pos = torch.gather(prefix + fill[:, None, :], 2, eid[..., None])[..., 0]
        fill = fill + onehot_e.sum(dim=1)
        keep = pos < cap
        onehot_c = F.one_hot(pos.clamp(0, cap - 1), cap).to(x.dtype) * keep[..., None]
        d_slot = onehot_e.to(x.dtype)[..., None] * onehot_c[:, :, None, :]
        dispatch = dispatch + d_slot
        combine = combine + d_slot * gate[..., slot][..., None, None]

    h = torch.einsum("bsec,bsd->ebcd", dispatch, x).reshape(e, b * cap, d)
    h = _expert_ffn(params, h, cfg, impl=impl).reshape(e, b, cap, d)
    y = torch.einsum("bsec,ebcd->bsd", combine, h)
    if cfg.n_shared_experts:
        y = y + _shared(params, x, cfg, impl=impl)
    return y, aux


def moe_ref(params, x, cfg):
    """Dense O(T·E) reference: every expert on every token, gate-masked.
    Float expert weights only."""
    b, s, _ = x.shape
    idx, gate, aux = _route(params, x, cfg)
    z = activation(torch.einsum("bsd,edf->bsef", x, params["w_in"].to(x.dtype)), cfg)
    all_out = torch.einsum("bsef,efd->bsed", z, params["w_out"].to(x.dtype))
    gates_full = torch.zeros((b, s, cfg.n_experts), dtype=x.dtype, device=x.device)
    gates_full.scatter_add_(2, idx, gate)  # distinct experts a token: one add each
    y = torch.einsum("bsed,bse->bsd", all_out, gates_full)
    if cfg.n_shared_experts:
        y = y + _shared(params, x, cfg)
    return y, aux
