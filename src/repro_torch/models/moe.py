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

:func:`moe_apply_einsum` is the GShard one-hot dispatch, and :func:`moe_ref`
the dense reference (every expert on every token, gate-masked) that the
tests hold the dispatch to.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import activation, dense, dense_stacked


def capacity(cfg, s: int, capacity_factor: Optional[float] = None) -> int:
    """Slots an expert takes from one batch row of ``s`` tokens."""
    cf = capacity_factor or cfg.capacity_factor
    return max(1, int(s * cfg.experts_per_tok * cf / cfg.n_experts + 0.999))


def _route(params, x, cfg):
    """Top-k routing.  x: [B, S, D] → (idx [B,S,k] int64, gate [B,S,k] in
    x.dtype, aux loss)."""
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.experts_per_tok, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    me = probs.mean(dim=(0, 1))  # mean router probability per expert
    ce = torch.nn.functional.one_hot(idx[..., 0], e).to(torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce)
    return idx, gate.to(x.dtype), aux


def _expert_ffn(params, h, cfg, impl=None):
    """h: [E, C, D] → [E, C, D] through each expert's SwiGLU/GELU."""
    z = activation(dense_stacked(params["w_in"], h, impl=impl), cfg)
    return dense_stacked(params["w_out"], z, impl=impl)


def _shared(params, x, cfg, impl=None):
    z = activation(dense(params["shared_w_in"], x, impl=impl), cfg)
    return dense(params["shared_w_out"], z, impl=impl)


def moe_apply(params: dict, x: torch.Tensor, cfg, *,
              capacity_factor: Optional[float] = None, impl=None):
    """x: [B, S, D] → ([B, S, D], aux_loss).  Sort-based capacity dispatch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    cap = capacity(cfg, s, capacity_factor)
    idx, gate, aux = _route(params, x, cfg)  # [B, S, k]

    # each token appears k times; sort the slots by expert id (stable: FIFO)
    eid = idx.reshape(b, s * k)
    order = torch.argsort(eid, dim=1, stable=True)  # [B, S*k]
    eid_s = torch.gather(eid, 1, order)
    tok_s = torch.div(order, k, rounding_mode="floor")  # token of each sorted slot
    gts_s = torch.gather(gate.reshape(b, s * k), 1, order)

    # position within its expert = rank − the expert's first rank
    counts = torch.zeros((b, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, eid_s, torch.ones_like(eid_s))  # integer: exact in any order
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(s * k, device=x.device)[None, :]
    pos = rank - torch.gather(starts, 1, eid_s)
    keep = pos < cap
    dest = torch.where(keep, eid_s * cap + pos, e * cap)  # e·cap: the dropped slot

    # pack the kept slots into [B, E·cap, D] (each destination written once)
    buf = torch.zeros((b, e * cap, d), dtype=x.dtype, device=x.device)
    kb, ks = keep.nonzero(as_tuple=True)
    buf[kb, dest[kb, ks]] = x[kb, tok_s[kb, ks]]
    h = buf.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    h = _expert_ffn(params, h, cfg, impl=impl)
    h = h.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)

    # back to the slots, gated; dropped slots read zeros
    h = torch.nn.functional.pad(h, (0, 0, 0, 1))
    out_s = torch.gather(h, 1, dest[..., None].expand(b, s * k, d))
    out_s = out_s * (gts_s * keep)[..., None].to(out_s.dtype)
    # combine: each token's k slots in sorted order (= expert-id order),
    # summed left to right in x.dtype
    inv = torch.argsort(order, dim=1)  # sorted position of slot (token, choice)
    at = torch.sort(inv.reshape(b, s, k), dim=-1).values.reshape(b, s * k)
    parts = torch.gather(out_s, 1, at[..., None].expand(b, s * k, d)).reshape(b, s, k, d)
    y = parts[:, :, 0]
    for j in range(1, k):
        y = y + parts[:, :, j]

    if cfg.n_shared_experts:
        y = y + _shared(params, x, cfg, impl=impl)
    return y, aux


def moe_apply_einsum(params: dict, x: torch.Tensor, cfg, *,
                     capacity_factor: Optional[float] = None, impl=None):
    """GShard-style one-hot dispatch: the same result as :func:`moe_apply`
    up to the order of drops (identical when capacity is ample)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_tok
    cap = capacity(cfg, s, capacity_factor)
    idx, gate, aux = _route(params, x, cfg)
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
