"""GQA attention: prefill, ring-cache decode, chunked online softmax.

Counterpart of the GQA part of :mod:`repro.models.attention` (MLA and
cross-attention come with their architectures).  Decode caches are
position-indexed ring buffers: slot = position mod L; ``pos_ids`` holds the
absolute position per slot (-1 = empty).  Cache residency — how a slot is
stored and read back — belongs to the cache format
(:mod:`repro_torch.core.kvcache`).  Negative positions are pads: rope and
the masks ignore them and the ring write skips them.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.core import kvcache
from repro_torch.models import layers
from repro_torch.models.layers import dense

NEG_INF = -1e30
#: prefill query / key chunk lengths of the flash recurrence (as the reference)
CHUNK_Q, CHUNK_KV = 512, 1024


def _project_qkv(params, x, cfg, positions, impl=None):
    dh = cfg.d_head
    b, s, _ = x.shape
    q = dense(params["wq"], x, impl=impl)
    k = dense(params["wk"], x, impl=impl)
    v = dense(params["wv"], x, impl=impl)
    if cfg.qkv_bias:  # in the projection's dtype, after its cast
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, cfg.n_heads, dh)
    k = k.reshape(b, s, cfg.n_kv_heads, dh)
    v = v.reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(params, x, cfg, *, cache_len, positions=None, impl=None):
    """Prefill: returns (output, cache)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, cfg, positions, impl=impl)
    out = chunked_attention(q, k, v, q_pos=positions, kv_pos=positions)
    out = dense(params["wo"], out.reshape(b, s, -1), impl=impl)
    cache = init_kv_cache(cfg, b, cache_len, dtype=k.dtype, device=x.device)
    _ring_write(cache, k, v, positions, kvcache.format_for(cfg))
    return out, cache


def _decode_positions(pos, b: int, s: int, device) -> torch.Tensor:
    """Normalize decode positions to [B, S]: scalar / [B] broadcast, [B, S]
    passed through (negative = pad)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim == 0:
        pos = pos.expand(b)
    if pos.ndim == 1:
        pos = pos[:, None]
    return pos.expand(b, s)


def gqa_decode(params, x, cache, cfg, *, pos, impl=None):
    """Decode ``x [B, S, D]`` against the ring cache (S > 1 appends a chunk
    and attends causally).  Updates ``cache`` in place and returns it."""
    b, s, _ = x.shape
    positions = _decode_positions(pos, b, s, x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, impl=impl)
    fmt = kvcache.format_for(cfg)
    _ring_write(cache, k, v, positions, fmt)
    out = _decode_attention(q, cache, cur=positions, fmt=fmt, impl=impl)
    out = dense(params["wo"], out.reshape(b, s, -1), impl=impl)
    return out, cache


def init_kv_cache(cfg, batch: int, cache_len: int, *, dtype=None, device=None) -> dict:
    """Allocate the GQA ring cache through ``cfg``'s cache format on
    ``device`` (default ``"cuda"``; raises without a GPU unless the caller
    asks for ``"cpu"``)."""
    device = resolve_device(device)
    fmt = kvcache.format_for(cfg)
    cache = {}
    for prefix in ("k", "v"):
        store = fmt.init(batch, cache_len, (cfg.n_kv_heads,), cfg.d_head,
                         dtype=dtype or cfg.dtype, device=device)
        cache.update(fmt.channel_entries(prefix, store))
    cache["pos_ids"] = torch.full((batch, cache_len), -1, dtype=torch.int32,
                                  device=device)
    return cache


def _ring_write(cache, k, v, positions, fmt) -> None:
    """In place: write S new (k, v) at slots = position mod L; pads
    (positions < 0) are masked out of the write.  A write of more than L
    tokens a row (a prompt longer than the ring) keeps each row's last L
    positions: a row's positions are distinct, so every slot is indexed at
    most once and the result does not depend on the order in which the
    device applies the writes (CUDA's ``index_put_`` names no winner among
    repeated indices)."""
    ln = cache["pos_ids"].shape[1]
    keep = positions >= 0
    if positions.shape[1] > ln:  # only then can two tokens of a row share a slot
        keep &= positions > positions.amax(1, keepdim=True) - ln
    b_idx, s_idx = keep.nonzero(as_tuple=True)
    pos = positions[b_idx, s_idx]
    ring = torch.remainder(pos, ln).to(torch.int64)
    for prefix, x in (("k", k), ("v", v)):
        fmt.append(fmt.channel(cache, prefix), x, b_idx, s_idx, ring)
    cache["pos_ids"][b_idx, ring] = pos.to(torch.int32)


def _decode_attention(q, cache, *, cur, fmt, impl=None):
    """q: [B, S, H, D] against the whole ring cache, masked by the stored
    positions (``pos_ids <= the token's own position``)."""
    b, s, hq, dh = q.shape
    hkv = cache["k"].shape[2]
    g = hq // hkv
    ln = cache["pos_ids"].shape[1]
    qg = q.reshape(b, s, hkv, g, dh).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(b, hkv, s * g, dh).to(torch.float32)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= cur[..., None])
    if fmt.supports_fused_decode:
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)  # [B, S, L]
        bias = bias[:, None, :, None, :].expand(b, hkv, s, g, ln).reshape(b, hkv, s * g, ln)
        out = fmt.decode_attention(
            qg, fmt.channel(cache, "k"), fmt.channel(cache, "v"), bias,
            sm_scale=1.0 / math.sqrt(dh), feat=dh, impl=impl)
    else:
        scores = fmt.qk(qg, fmt.channel(cache, "k")) / math.sqrt(dh)
        scores = scores.reshape(b, hkv, s, g, ln)
        scores = torch.where(valid[:, None, :, None, :], scores, NEG_INF)
        w = torch.softmax(scores, dim=-1).reshape(b, hkv, s * g, ln)
        out = fmt.av(w, fmt.channel(cache, "v"), dh)
    out = out.reshape(b, hkv, s, g, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(b, s, hq, dh).to(q.dtype)


def chunked_attention(q, k, v, *, q_pos, kv_pos) -> torch.Tensor:
    """Causal attention by the flash recurrence over KV chunks with a
    running (max, sum, acc) carry, so no S×S score matrix is held for long
    prompts.  q [B, Sq, H, D]; k, v [B, Skv, Hkv, D]; negative positions
    are pads."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    cq, ckv = min(CHUNK_Q, sq), min(CHUNK_KV, skv)
    scale = 1.0 / math.sqrt(dh)
    qf = q.reshape(b, sq, hkv, g, dh).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = []
    for q0 in range(0, sq, cq):
        qi, qpi = qf[:, q0:q0 + cq], q_pos[:, q0:q0 + cq]
        nq = qi.shape[1]
        m = torch.full((b, hkv, g, nq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hkv, g, nq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, nq, dh), dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, ckv):
            kj, vj, kpj = kf[:, k0:k0 + ckv], vf[:, k0:k0 + ckv], kv_pos[:, k0:k0 + ckv]
            s = torch.einsum("bqhgd,bshd->bhgqs", qi, kj) * scale
            mask = (kpj[:, None, None, None, :] >= 0) & (
                qpi[:, None, None, :, None] >= kpj[:, None, None, None, :])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqs,bshd->bhgqd", p, vj)
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))  # [B, nq, Hkv, G, D]
    return torch.cat(outs, dim=1).reshape(b, sq, hq, dh).to(q.dtype)
