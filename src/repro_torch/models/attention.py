"""Attention mixers: GQA and MLA — prefill, ring-cache decode, chunked
online softmax.

Counterpart of :mod:`repro.models.attention`: GQA, MLA and
cross-attention.  Decode caches are
position-indexed ring buffers: slot = position mod L; ``pos_ids`` holds the
absolute position per slot (-1 = empty).  Cache residency — how a slot is
stored and read back — belongs to the cache format
(:mod:`repro_torch.core.kvcache`).  Negative positions are pads: rope and
the masks ignore them and the ring write skips them.  A sliding window
(``cfg.sliding_window``) keeps a key only if ``q_pos - k_pos < window``,
in the prefill mask and in the decode mask, and the ring is then at most
the window long (:func:`cache_len_for`).  As in the reference, a decode
call writes its tokens to the ring before it attends, so a chunk of S
tokens into a window-long ring overwrites up to S - 1 keys that its
earlier tokens would still see.

MLA (DeepSeek-V2 / MiniCPM3) caches only the latent — ``c_kv`` through the
cache format, the small rope key ``k_rope`` in float — and decodes in the
absorbed form: the query is absorbed through ``w_uk`` and the context read
back through ``w_uv``, both dequantized to float on every step.

Cross-attention (llama-3.2-vision's image layers, seamless-m4t's decoder)
attends over a context the decoder did not write: :func:`cross_kv`
projects the context's K and V once, at prefill, and they stay per-slot
float state ``{"ck", "cv"}`` ``[B, ctx, Hkv, dh]`` in the config's dtype,
through no cache format; :func:`cross_apply` attends to them with no rope
and no mask (queries and keys all at position 0), under a tanh ``gate``
where the config is not an encoder-decoder.
"""

from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.core import kvcache, residency
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
    out = chunked_attention(q, k, v, q_pos=positions, kv_pos=positions,
                            window=cfg.sliding_window)
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
    out = _decode_attention(q, cache, cur=positions, window=cfg.sliding_window, fmt=fmt,
                            impl=impl)
    out = dense(params["wo"], out.reshape(b, s, -1), impl=impl)
    return out, cache


def cache_len_for(cfg, max_len: int) -> int:
    """The ring length: the window for a sliding-window config (when shorter
    than ``max_len``), ``max_len`` otherwise."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


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


def _ring_slots(positions, ln: int):
    """The tokens a ring write of ``positions [B, S]`` keeps and their slots
    → ``(b_idx, s_idx, pos, ring)``.  Pads (positions < 0) are left out.  A
    write of more than L tokens a row (a prompt longer than the ring) keeps
    each row's last L positions: a row's positions are distinct, so every
    slot is indexed at most once and the result does not depend on the
    order in which the device applies the writes (CUDA's ``index_put_``
    names no winner among repeated indices)."""
    keep = positions >= 0
    if positions.shape[1] > ln:  # only then can two tokens of a row share a slot
        keep &= positions > positions.amax(1, keepdim=True) - ln
    b_idx, s_idx = keep.nonzero(as_tuple=True)
    pos = positions[b_idx, s_idx]
    return b_idx, s_idx, pos, torch.remainder(pos, ln).to(torch.int64)


def _ring_write(cache, k, v, positions, fmt) -> None:
    """In place: write S new (k, v) at slots = position mod L
    (:func:`_ring_slots`)."""
    b_idx, s_idx, pos, ring = _ring_slots(positions, cache["pos_ids"].shape[1])
    for prefix, x in (("k", k), ("v", v)):
        fmt.append(fmt.channel(cache, prefix), x, b_idx, s_idx, ring)
    cache["pos_ids"][b_idx, ring] = pos.to(torch.int32)


def _decode_attention(q, cache, *, cur, fmt, window=None, impl=None):
    """q: [B, S, H, D] against the whole ring cache, masked by the stored
    positions (``pos_ids <= the token's own position``, and ``> position -
    window`` with a window)."""
    b, s, hq, dh = q.shape
    hkv = cache["k"].shape[2]
    g = hq // hkv
    ln = cache["pos_ids"].shape[1]
    qg = q.reshape(b, s, hkv, g, dh).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(b, hkv, s * g, dh).to(torch.float32)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= cur[..., None])
    if window is not None:
        valid &= pos_ids[:, None, :] > cur[..., None] - window
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


def chunked_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None) -> torch.Tensor:
    """Attention by the flash recurrence over KV chunks with a running
    (max, sum, acc) carry, so no S×S score matrix is held for long prompts.
    q [B, Sq, H, D]; k, v [B, Skv, Hkv, D]; negative key positions are
    pads; ``causal`` keeps a key only if ``k_pos <= q_pos``, and with
    ``window`` only if ``q_pos - k_pos < window``."""
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
            mask = kpj[:, None, None, None, :] >= 0
            if causal:
                mask = mask & (qpi[:, None, None, :, None] >= kpj[:, None, None, None, :])
            if window is not None:
                mask = mask & ((qpi[:, None, None, :, None] - kpj[:, None, None, None, :])
                               < window)
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


# ---------------------------------------------------------------------------
# Cross-attention (vision / encoder-decoder memory)
# ---------------------------------------------------------------------------


def cross_specs(cfg) -> dict:
    """The cross-attention projections, and llama-vision's tanh ``gate``
    (a float32 scalar, zero at init: the branch starts closed)."""
    from repro_torch.models.model import ParamSpec

    d, dh = cfg.d_model, cfg.d_head
    return {
        "wq": ParamSpec((d, cfg.n_heads * dh), cfg.dtype),
        "wk": ParamSpec((d, cfg.n_kv_heads * dh), cfg.dtype),
        "wv": ParamSpec((d, cfg.n_kv_heads * dh), cfg.dtype),
        "wo": ParamSpec((cfg.n_heads * dh, d), cfg.dtype),
        "gate": ParamSpec((), torch.float32, "zeros"),
    }


def cross_kv(params, ctx, cfg, impl=None) -> dict:
    """Project the context ``[B, ctx, D]`` once → ``{"ck", "cv"}`` ``[B,
    ctx, Hkv, dh]``, reused by every decode step."""
    b, s, _ = ctx.shape
    k = dense(params["wk"], ctx, impl=impl).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = dense(params["wv"], ctx, impl=impl).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return {"ck": k, "cv": v}


def cross_apply(params, x, kv, cfg, *, gated=True, impl=None) -> torch.Tensor:
    """``x [B, S, D]`` attends over the projected context ``kv`` with no
    rope and no mask; ``gated`` scales the output by ``tanh(gate)``."""
    b, s, _ = x.shape
    q = dense(params["wq"], x, impl=impl).reshape(b, s, cfg.n_heads, cfg.d_head)
    k, v = kv["ck"], kv["cv"]
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = chunked_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos, causal=False)
    out = dense(params["wo"], out.reshape(b, s, -1), impl=impl)
    if gated:
        out = torch.tanh(params["gate"]).to(out.dtype) * out
    return out


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(params, x, cfg, positions, impl=None):
    """Queries, split into the no-rope part and the roped part ``[B, S, H, *]``:
    through the low-rank ``w_dq`` → RMSNorm → ``w_uq`` (q_lora_rank) or the
    full-rank ``wq``."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = layers.rms_norm(dense(params["w_dq"], x, impl=impl), params["q_norm"])
        q = dense(params["w_uq"], cq, impl=impl)
    else:
        q = dense(params["wq"], x, impl=impl)
    q = q.reshape(b, s, cfg.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params, x, cfg, positions, impl=None):
    """The latent ``c_kv [B, S, r]`` (RMSNormed) and the roped key
    ``k_rope [B, S, dr]`` shared by every head."""
    b, s, _ = x.shape
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    ckv = dense(params["w_dkv"], x, impl=impl)
    c_kv = layers.rms_norm(ckv[..., :r], params["kv_norm"])
    k_rope = ckv[..., r:].reshape(b, s, 1, dr)
    k_rope = layers.apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_prefill(params, x, cfg, *, cache_len, positions=None, impl=None):
    """Prefill MLA (the reference's ``mla_apply`` with a cache): the latent
    expanded through ``w_uk`` / ``w_uv`` to per-head keys and values, then
    :func:`chunked_attention` with v padded to the q head width.  Returns
    (output, cache)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q_nope, q_rope = _mla_q(params, x, cfg, positions, impl=impl)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions, impl=impl)
    k_nope = dense(params["w_uk"], c_kv, impl=impl).reshape(b, s, h, dn)
    v = dense(params["w_uv"], c_kv, impl=impl).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    out = chunked_attention(q, k, torch.nn.functional.pad(v, (0, dn + dr - dv)),
                            q_pos=positions, kv_pos=positions)[..., :dv]
    out = dense(params["wo"], out.reshape(b, s, h * dv), impl=impl)
    cache = init_mla_cache(cfg, b, cache_len, dtype=c_kv.dtype, device=x.device)
    _mla_write(cache, c_kv, k_rope, positions, kvcache.format_for(cfg))
    return out, cache


def init_mla_cache(cfg, batch: int, cache_len: int, *, dtype=None, device=None) -> dict:
    """The MLA latent cache on ``device`` (default ``"cuda"``): the ``c_kv``
    channel (lead ``()``, feature = the lora rank) through ``cfg``'s cache
    format; the rope key ``k_rope [B, L, dr]`` stays float, and ``pos_ids``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    fmt = kvcache.format_for(cfg)
    cache = dict(fmt.channel_entries(
        "c_kv", fmt.init(batch, cache_len, (), cfg.kv_lora_rank, dtype=dtype, device=device)))
    cache["k_rope"] = torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)
    cache["pos_ids"] = torch.full((batch, cache_len), -1, dtype=torch.int32, device=device)
    return cache


def _mla_write(cache, c_kv, k_rope, positions, fmt) -> None:
    """In place: the latent and rope key of S new tokens at slots = position
    mod L (:func:`_ring_slots`: pads left out, deterministic)."""
    b_idx, s_idx, pos, ring = _ring_slots(positions, cache["pos_ids"].shape[1])
    fmt.append(fmt.channel(cache, "c_kv"), c_kv, b_idx, s_idx, ring)
    cache["k_rope"][b_idx, ring] = k_rope[b_idx, s_idx].to(cache["k_rope"].dtype)
    cache["pos_ids"][b_idx, ring] = pos.to(torch.int32)


def mla_decode(params, x, cache, cfg, *, pos, impl=None):
    """Absorbed-form MLA decode of ``x [B, S, D]`` against the latent ring
    (S > 1 appends a chunk and attends causally).  The latent reads go
    through the cache format's ``qk`` / ``av`` with lead ``()``, the (S,
    heads) axes folded into the group axis, so the int8 and bit-plane reads
    apply to the latent as to K/V.  Updates ``cache`` in place and returns
    it."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    positions = _decode_positions(pos, b, s, x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, positions, impl=impl)
    c_kv_new, k_rope_new = _mla_latent(params, x, cfg, positions, impl=impl)
    fmt = kvcache.format_for(cfg)
    _mla_write(cache, c_kv_new, k_rope_new, positions, fmt)
    ln = cache["pos_ids"].shape[1]
    # absorption needs the float matrices: the projections above run in their
    # residency formats, the latent-space products below in float32
    w_uk = _as_float(params["w_uk"], (r, h, dn), x.dtype).to(torch.float32)
    w_uv = _as_float(params["w_uv"], (r, h, dv), x.dtype).to(torch.float32)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.to(torch.float32), w_uk)
    store = fmt.channel(cache, "c_kv")
    s_nope = fmt.qk(q_abs.reshape(b, s * h, r), store).reshape(b, s, h, ln)
    krope = cache["k_rope"].to(torch.float32)
    scores = (s_nope + torch.einsum("bqhd,bld->bqhl", q_rope.to(torch.float32), krope)
              ) / math.sqrt(dn + dr)
    pos_ids = cache["pos_ids"]
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= positions[..., None])
    scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = fmt.av(w.reshape(b, s * h, ln), store, r).reshape(b, s, h, r)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    out = dense(params["wo"], out.reshape(b, s, h * dv).to(x.dtype), impl=impl)
    return out, cache


def _as_float(w, shape3, dtype):
    """An up-projection (float, or any residency format that declares
    ``supports_absorbed_decode``) as a ``[r, H, d]`` tensor of ``dtype``."""
    if isinstance(w, residency.QuantLinearState):
        fmt = residency.get_format(w.mode)
        if not fmt.supports_absorbed_decode:
            raise NotImplementedError(
                f"residency format {w.mode!r} does not support absorbed MLA decode; "
                "keep the latent up-projections in a dequantizable format")
        return fmt.to_float(w).reshape(shape3).to(dtype)
    return w.reshape(shape3).to(dtype)
