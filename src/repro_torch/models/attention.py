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
back through ``w_uv``, both dequantized to float on every step.  Under
``tp`` a rank holds its heads (padded to a multiple of ``tp``,
:func:`mla_dims`) of the query projection, ``w_uk`` and ``w_uv``, and
``wo``'s matching rows (row-parallel); the down-projections ``w_dq`` /
``w_dkv`` are not sharded (``kv_lora``), so every rank computes the whole
latent and holds the whole latent ring (in training the latent's gradient
is summed over the model axis).

Sequence-parallel decode (:class:`SeqParallel`; the reference's ``plan``
for a long-context decode whose batch is smaller than the data ways, whose
rules name those axes under ``kv_seq``): each rank's ring (GQA's K/V, MLA's
latent and rope key) holds its contiguous ``L / ways`` block of the ring's
slots, ``pos_ids`` and the stores of every contiguous format alike
(:func:`partitioning.shard_caches` cuts a whole cache so).  The ring write
keeps the global slot ``position mod L``, which only its owning rank
writes; each rank attends over its block and :func:`combine_blocks` joins
the blocks as flash decoding does: each block's row max ``m_r``, sum
``s_r`` and normalised output ``o_r`` (the plain formats through their
``qk`` / ``av``, the fused one through the kernel's statistics; MLA's
latent context ``[B, S, H, r]`` before ``w_uv``), ``M = max_r m_r`` (an
all-reduce MAX), then one all-reduce SUM of ``[e^(m_r - M)·s_r·o_r,
e^(m_r - M)·s_r]`` and their quotient.  A block whose every slot is masked
(bias ``NEG_INF``) has ``m_r = NEG_INF`` and weighs ``e^(NEG_INF - M) =
0`` beside a live block; a row masked on every rank gets the uniform
weights of the whole ring, as on one device.  A paged format's rank holds
the block ``[r·P/w, (r+1)·P/w)`` of the pool's pages and the whole block
tables, ``pos_ids`` and MLA's ``k_rope`` (a rank's pages may hold any ring
slot): it maps the tables to its own pages, writes the new tokens whose
page it holds, and attends over the ring slots whose pages it holds
(:func:`_rank_pages`), the rest masked.  A cross layer's context K/V is
whole on every rank and needs no combine; a Mamba layer has no ring and
runs whole on every rank.

Cross-attention (llama-3.2-vision's image layers, seamless-m4t's decoder)
attends over a context the decoder did not write: :func:`cross_kv`
projects the context's K and V once, at prefill, and they stay per-slot
float state ``{"ck", "cv"}`` ``[B, ctx, Hkv, dh]`` in the config's dtype,
through no cache format; :func:`cross_apply` attends to them with no rope
and no mask (queries and keys all at position 0), under a tanh ``gate``
where the config is not an encoder-decoder.  Under ``tp`` a cross layer is
split as self-attention is: a rank projects its KV heads of the context
(:func:`attn_dims`' padded heads, or all of them where they stay whole),
attends with its query heads, each paired with its own KV head as
:func:`_kv_window` pairs self-attention's, and ``wo`` is row-parallel; the
gate scales the summed output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import kvcache, paging, residency
from repro_torch.distributed.mesh import MeshView, copy_to, tp_size
from repro_torch.models import layers
from repro_torch.models.layers import dense, row_parallel

NEG_INF = -1e30
#: prefill query / key chunk lengths of the flash recurrence (as the reference)
CHUNK_Q, CHUNK_KV = 512, 1024


def attn_dims(cfg, tp: int = 1) -> tuple[int, int, bool]:
    """(padded_heads, padded_kv_heads, shard_kv) for a model axis of ``tp``
    ways, the reference's: heads pad to a multiple of ``tp``; KV heads shard
    only if padding keeps the GQA group structure (Hp/Hkvp == H/Hkv),
    otherwise they stay whole on every rank."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    hp = -(-h // tp) * tp
    if kv % tp == 0:
        return hp, kv, True
    kvp = -(-kv // tp) * tp
    if kv and hp % kvp == 0 and hp // kvp == h // kv:
        return hp, kvp, True
    return hp, kv, False


def mla_dims(cfg, tp: int = 1) -> int:
    """MLA's heads padded to a multiple of ``tp``."""
    return -(-cfg.n_heads // tp) * tp


def kv_heads_held(cfg, tp: int = 1) -> int:
    """The KV heads one rank's cache holds: its ``1/tp`` of the padded KV
    heads when :func:`attn_dims` shards them, all of them otherwise."""
    _, kvp, shard_kv = attn_dims(cfg, tp)
    return kvp // tp if shard_kv else kvp


@dataclasses.dataclass
class SeqParallel:
    """One rank's block of the KV sequence: the ring's slots cut over the
    mesh axes ``names`` (the rules' ``kv_seq`` entry, the first the
    outermost) of ``view``, ``ways`` blocks of which this rank holds number
    ``index``."""

    view: MeshView
    names: tuple

    @property
    def ways(self) -> int:
        return self.view.block(self.names)[0]

    @property
    def index(self) -> int:
        return self.view.block(self.names)[1]

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.view.all_reduce_max(t, self.names)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.view.all_reduce_sum(t, self.names)


def seq_parallel(mesh: Optional[MeshView], rules) -> Optional[SeqParallel]:
    """The :class:`SeqParallel` of ``rules`` whose ``kv_seq`` names axes of
    ``mesh`` (a ``MeshView``) above one way; None otherwise (one device, or
    no sequence sharding)."""
    entry = None if rules is None or mesh is None else rules.get("kv_seq")
    names = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
    if mesh is None or mesh.block(names)[0] == 1:
        return None
    return SeqParallel(mesh, names)


def combine_blocks(out: torch.Tensor, m: torch.Tensor, total: torch.Tensor,
                   seq: SeqParallel) -> torch.Tensor:
    """The flash-decoding combine of every rank's block: ``out [..., F]``
    the block's normalised attention output, ``m`` / ``total`` ``[...]`` its
    row max and sum over the block → the output over the whole ring, the
    same on every rank: ``M = max_r m_r``, then one all-reduce SUM of
    ``[e^(m_r - M)·s_r·o_r, e^(m_r - M)·s_r]``, then the quotient.  A
    wholly masked block (``m_r = NEG_INF``) adds zero beside a live one."""
    big = seq.all_reduce_max(m.to(torch.float32).clone())
    w = torch.exp(m - big) * total
    packed = seq.all_reduce_sum(torch.cat([out * w[..., None], w[..., None]], dim=-1))
    return packed[..., :-1] / packed[..., -1:]


def _block_softmax(scores: torch.Tensor) -> tuple:
    """A sequence-parallel rank's softmax over its block of the ring (the
    last axis): the normalised weights, and the row max and sum
    :func:`combine_blocks` takes (keepdim)."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    total = p.sum(dim=-1, keepdim=True)
    return p / total, m, total


def _paged_seq(fmt, seq) -> bool:
    return seq is not None and isinstance(fmt, paging.PagedCacheFormat)


def _rank_pages(cache: dict, seq: SeqParallel) -> tuple:
    """A paged cache under ``seq``, whose pool leaves hold this rank's
    contiguous block ``[index·P, (index+1)·P)`` of the pool's pages and
    whose block tables are whole → (each table mapped to the rank's own
    page ids, 0 where another rank holds the page, by name; ``owned [B,
    L]``, True at the ring slots whose page the rank holds).  A layer takes
    them once and hands them to its write and its read."""
    tables, owned = {}, None
    for name, table in cache.items():
        if name in paging.TABLE_KEYS:
            pool = cache[name[:-len("_pages")]]
            lo = seq.index * pool.shape[0]
            mine = (table >= lo) & (table < lo + pool.shape[0])
            tables[name] = torch.where(mine, table - lo, 0).to(table.dtype)
            owned = mine.repeat_interleave(pool.shape[1], dim=1)
    return tables, owned


#: cache leaves with a KV-head axis (dim 2, contiguous ring or page pool)
_HEAD_KEYS = frozenset({"k", "v", "k_scale", "v_scale"})


def _kv_window(cfg, tp):
    """Under ``tp`` with the KV heads whole on every rank (``shard_kv``
    False): the KV heads ``[k0, k1)`` the rank's query heads read, the
    group size, and the rank's first query head's place in the query block
    of those KV heads.  None when the KV heads are sharded (the rank's
    query heads then read exactly its own KV heads) or without ``tp``."""
    if tp is None or tp.size == 1 or tp.shard_kv:
        return None
    hp, kvp, _ = attn_dims(cfg, tp.size)
    g, per = hp // kvp, hp // tp.size
    h0 = tp.rank * per
    k0, k1 = h0 // g, -(-(h0 + per) // g)
    return k0, k1, g, h0 - k0 * g


def _over_window(q, window, attend):
    """``attend(q_block)`` for the rank's query heads ``q [B, S, Hq, D]``
    placed, zero-padded, in the query block of the KV window, then the
    rank's heads taken back out (heads are independent: the pad queries
    change nothing else)."""
    k0, k1, g, off = window
    b, s, hq, dh = q.shape
    block = q.new_zeros((b, s, (k1 - k0) * g, dh))
    block[:, :, off:off + hq] = q
    return attend(block)[:, :, off:off + hq]


def _rank_attention(q, k, v, kv_window, **kw):
    """:func:`chunked_attention` of the rank's query heads ``q`` against the
    KV heads ``k``, ``v`` it holds: all of them, or under a
    :func:`_kv_window` the window's, the queries placed in its block."""
    if kv_window is None:
        return chunked_attention(q, k, v, **kw)
    k0, k1 = kv_window[:2]
    return _over_window(q, kv_window, lambda qq: chunked_attention(
        qq, k[:, :, k0:k1], v[:, :, k0:k1], **kw))


def _project_qkv(params, x, cfg, positions, impl=None, tp=None):
    """q, k, v ``[B, S, heads, dh]`` of this rank's heads.  Under ``tp`` in
    training, the leaves every rank holds whole but applies to its own
    heads (the q / k norms; the KV projections where the KV heads are not
    sharded) sum their gradients over the model axis (``copy_to``)."""
    dh = cfg.d_head
    b, s, _ = x.shape
    x = copy_to(tp, x)
    whole_kv = tp is not None and not tp.shard_kv
    params = {k: copy_to(tp, w) if k in ("q_norm", "k_norm") or (
        whole_kv and k in ("wk", "wv", "bk", "bv")) else w for k, w in params.items()}
    q = dense(params["wq"], x, impl=impl)
    k = dense(params["wk"], x, impl=impl)
    v = dense(params["wv"], x, impl=impl)
    if cfg.qkv_bias:  # in the projection's dtype, after its cast
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, -1, dh)  # the heads this rank holds (all of them on one device)
    k = k.reshape(b, s, -1, dh)
    v = v.reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"])
        k = layers.rms_norm(k, params["k_norm"])
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _gqa(params, x, cfg, positions, impl=None, tp=None, causal: bool = True):
    """Full-sequence causal (windowed with ``cfg.sliding_window``) GQA, or
    with ``causal=False`` the encoder's attention (every position sees
    every other, no window) → (output, k, v).  Under ``tp`` on the rank's
    heads, ``wo`` row-parallel."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions, impl=impl, tp=tp)
    out = _rank_attention(q, k, v, _kv_window(cfg, tp), q_pos=positions, kv_pos=positions,
                          causal=causal, window=cfg.sliding_window if causal else None)
    return row_parallel(params["wo"], out.reshape(b, s, -1), tp, impl=impl), k, v


def _arange_positions(x) -> torch.Tensor:
    b, s = x.shape[:2]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def gqa_apply(params, x, cfg, *, positions=None, impl=None, tp=None):
    """Full-sequence causal attention with no cache (the train path)."""
    positions = _arange_positions(x) if positions is None else positions
    return _gqa(params, x, cfg, positions, impl=impl, tp=tp)[0]


def gqa_prefill(params, x, cfg, *, cache_len, positions=None, impl=None, tp=None):
    """Prefill: returns (output, cache); under ``tp`` the rank's cache."""
    b = x.shape[0]
    positions = _arange_positions(x) if positions is None else positions
    out, k, v = _gqa(params, x, cfg, positions, impl=impl, tp=tp)
    cache = init_kv_cache(cfg, b, cache_len, tp=tp_size(tp), dtype=k.dtype, device=x.device)
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


def gqa_decode(params, x, cache, cfg, *, pos, impl=None, tp=None, seq=None):
    """Decode ``x [B, S, D]`` against the ring cache (S > 1 appends a chunk
    and attends causally).  Updates ``cache`` in place and returns it.
    Under ``tp`` the rank's heads against its cache, ``wo`` row-parallel;
    under ``seq`` (:class:`SeqParallel`) the rank's block of the ring,
    joined by :func:`combine_blocks`."""
    b, s, _ = x.shape
    positions = _decode_positions(pos, b, s, x.device)
    q, k, v = _project_qkv(params, x, cfg, positions, impl=impl)
    fmt = kvcache.format_for(cfg)
    pages = _rank_pages(cache, seq) if _paged_seq(fmt, seq) else None
    _ring_write(cache, k, v, positions, fmt, seq=seq, pages=pages)
    window = _kv_window(cfg, tp)

    def attend(qq, sub):
        return _decode_attention(qq, sub, cur=positions, window=cfg.sliding_window, fmt=fmt,
                                 impl=impl, seq=seq, pages=pages)

    if window is None:
        out = attend(q, cache)
    else:
        k0, k1 = window[:2]
        sub = {n: t[:, :, k0:k1] if n in _HEAD_KEYS else t for n, t in cache.items()}
        out = _over_window(q, window, lambda qq: attend(qq, sub))
    out = row_parallel(params["wo"], out.reshape(b, s, -1), tp, impl=impl)
    return out, cache


def cache_len_for(cfg, max_len: int) -> int:
    """The ring length: the window for a sliding-window config (when shorter
    than ``max_len``), ``max_len`` otherwise."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_kv_cache(cfg, batch: int, cache_len: int, *, tp: int = 1, local: bool = True,
                  dtype=None, device=None) -> dict:
    """Allocate the GQA ring cache through ``cfg``'s cache format on
    ``device`` (default ``"cuda"``; raises without a GPU unless the caller
    asks for ``"cpu"``).  The ring is ``fmt.slot_capacity(cache_len)``
    long: ``cache_len`` for a contiguous format, rounded up to whole pages
    for a paged one, so the gathered pages and ``pos_ids`` cover the same
    slots.  At ``tp`` ways it holds one rank's KV heads
    (:func:`kv_heads_held`), or with ``local=False`` all the padded KV
    heads (the global cache the sharding rules cut)."""
    device = resolve_device(device)
    fmt = kvcache.format_for(cfg)
    cache_len = fmt.slot_capacity(cache_len)
    heads = kv_heads_held(cfg, tp) if local else attn_dims(cfg, tp)[1]
    cache = {}
    for prefix in ("k", "v"):
        store = fmt.init(batch, cache_len, (heads,), cfg.d_head,
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


def _seq_write(cache, channels, positions, fmt, seq, pages=None) -> tuple:
    """In place: each channel ``(prefix, x)`` of S new tokens at slots =
    position mod L (:func:`_ring_slots`) → the written tokens' ``(b_idx,
    s_idx, pos, ring)``, whose per-slot leaves (``pos_ids``, MLA's
    ``k_rope``) the caller writes.  Under ``seq`` every token is encoded as
    on one device and only the rank's are written: on a contiguous format
    the cache is the rank's block of a ring ``ways`` times as long, the
    global slot kept and the tokens of the block written there; on a paged
    one (:func:`_rank_pages`, or its ``pages``) the tokens whose page the
    rank holds, its per-slot leaves whole (every token returned)."""
    ln = cache["pos_ids"].shape[1]
    whole = seq is None or _paged_seq(fmt, seq)
    b_idx, s_idx, pos, ring = _ring_slots(positions, ln if whole else ln * seq.ways)
    keep, store = None, cache
    if not whole:  # the rank's block of the ring
        ring = ring - seq.index * ln
        keep = (ring >= 0) & (ring < ln)
    elif seq is not None:  # the rank's pages
        tables, owned = pages or _rank_pages(cache, seq)
        store = {**cache, **tables}
        keep = owned[b_idx, ring]
    for prefix, x in channels:
        fmt.append(fmt.channel(store, prefix), x, b_idx, s_idx, ring, keep=keep)
    if not whole:
        b_idx, s_idx, pos, ring = b_idx[keep], s_idx[keep], pos[keep], ring[keep]
    return b_idx, s_idx, pos, ring


def _ring_write(cache, k, v, positions, fmt, seq=None, pages=None) -> None:
    """In place: write S new (k, v) at slots = position mod L, under
    ``seq`` the rank's (:func:`_seq_write`)."""
    b_idx, _, pos, ring = _seq_write(cache, (("k", k), ("v", v)), positions, fmt, seq,
                                     pages)
    cache["pos_ids"][b_idx, ring] = pos.to(torch.int32)


def _decode_attention(q, cache, *, cur, fmt, window=None, impl=None, seq=None, pages=None):
    """q: [B, S, H, D] against the whole ring cache, masked by the stored
    positions (``pos_ids <= the token's own position``, and ``> position -
    window`` with a window).  Under ``seq`` the cache is the rank's block of
    the ring (on a paged format, the slots whose pages it holds:
    :func:`_rank_pages`, or its ``pages``): the block's output and
    statistics are joined by :func:`combine_blocks`."""
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
    if _paged_seq(fmt, seq):
        tables, owned = pages or _rank_pages(cache, seq)
        cache = {**cache, **tables}
        valid &= owned[:, None, :]
    if fmt.supports_fused_decode:
        bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)  # [B, S, L]
        bias = bias[:, None, :, None, :].expand(b, hkv, s, g, ln).reshape(b, hkv, s * g, ln)
        out = fmt.decode_attention(
            qg, fmt.channel(cache, "k"), fmt.channel(cache, "v"), bias,
            sm_scale=1.0 / math.sqrt(dh), feat=dh, impl=impl, stats=seq is not None)
        if seq is not None:
            out, st = out
            out = combine_blocks(out, st[..., 0], st[..., 1], seq)
    else:
        scores = fmt.qk(qg, fmt.channel(cache, "k")) / math.sqrt(dh)
        scores = scores.reshape(b, hkv, s, g, ln)
        scores = torch.where(valid[:, None, :, None, :], scores, NEG_INF)
        if seq is None:
            w = torch.softmax(scores, dim=-1).reshape(b, hkv, s * g, ln)
            out = fmt.av(w, fmt.channel(cache, "v"), dh)
        else:  # the block's normalised output and its statistics
            w, m, total = _block_softmax(scores)
            out = fmt.av(w.reshape(b, hkv, s * g, ln), fmt.channel(cache, "v"), dh)
            out = combine_blocks(out, m.reshape(b, hkv, s * g), total.reshape(b, hkv, s * g),
                                 seq)
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


def cross_specs(cfg, tp: int = 1) -> dict:
    """The cross-attention projections (heads padded by :func:`attn_dims`),
    and llama-vision's tanh ``gate`` (a float32 scalar, zero at init: the
    branch starts closed)."""
    from repro_torch.models.model import ParamSpec

    d, dh = cfg.d_model, cfg.d_head
    hp, kvp, _ = attn_dims(cfg, tp)
    return {
        "wq": ParamSpec((d, hp * dh), cfg.dtype, axes=("embed", "heads")),
        "wk": ParamSpec((d, kvp * dh), cfg.dtype, axes=("embed", "kv_heads")),
        "wv": ParamSpec((d, kvp * dh), cfg.dtype, axes=("embed", "kv_heads")),
        "wo": ParamSpec((hp * dh, d), cfg.dtype, axes=("heads", "embed"),
                        valid_dim0=cfg.n_heads * dh if hp > cfg.n_heads else None),
        "gate": ParamSpec((), torch.float32, "zeros", ()),
    }


def init_cross_cache(cfg, batch: int, *, tp: int = 1, local: bool = True,
                     device=None) -> dict:
    """Zero context K/V ``{"ck", "cv"}`` ``[B, encoder_tokens, Hkv, dh]`` in
    the config's dtype on ``device`` (default ``"cuda"``): what
    :func:`cross_kv` leaves in a cross layer's cache at prefill.  At ``tp``
    ways ``Hkv`` is the KV heads one rank holds (:func:`kv_heads_held`), or
    with ``local=False`` all the padded ones."""
    device = resolve_device(device)
    heads = kv_heads_held(cfg, tp) if local else attn_dims(cfg, tp)[1]
    shape = (batch, cfg.encoder_tokens, heads, cfg.d_head)
    return {name: torch.zeros(shape, dtype=cfg.dtype, device=device) for name in ("ck", "cv")}


def cross_kv(params, ctx, cfg, impl=None, tp=None) -> dict:
    """Project the context ``[B, ctx, D]`` once → ``{"ck", "cv"}`` ``[B,
    ctx, Hkv, dh]`` (under ``tp`` the rank's KV heads), reused by every
    decode step."""
    b, s, _ = ctx.shape
    ctx = copy_to(tp, ctx)
    k = dense(params["wk"], ctx, impl=impl).reshape(b, s, -1, cfg.d_head)
    v = dense(params["wv"], ctx, impl=impl).reshape(b, s, -1, cfg.d_head)
    return {"ck": k, "cv": v}


def cross_apply(params, x, kv, cfg, *, gated=True, impl=None, tp=None) -> torch.Tensor:
    """``x [B, S, D]`` attends over the projected context ``kv`` with no
    rope and no mask; ``gated`` scales the output by ``tanh(gate)``.  Under
    ``tp`` the rank's query heads against its KV heads, ``wo``
    row-parallel, the gate applied after the sum."""
    b, s, _ = x.shape
    q = dense(params["wq"], copy_to(tp, x), impl=impl).reshape(b, s, -1, cfg.d_head)
    k, v = kv["ck"], kv["cv"]
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=x.device)
    kv_pos = torch.zeros((b, k.shape[1]), dtype=torch.int32, device=x.device)
    out = _rank_attention(q, k, v, _kv_window(cfg, tp), q_pos=q_pos, kv_pos=kv_pos,
                          causal=False)
    out = row_parallel(params["wo"], out.reshape(b, s, -1), tp, impl=impl)
    if gated:
        out = torch.tanh(params["gate"]).to(out.dtype) * out
    return out


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def _mla_q(params, x, cfg, positions, impl=None, tp=None):
    """Queries, split into the no-rope part and the roped part ``[B, S, H, *]``
    (H: the heads the rank holds): through the low-rank ``w_dq`` → RMSNorm →
    ``w_uq`` (q_lora_rank) or the full-rank ``wq``.  Under ``tp`` the input
    of the column-parallel projection (the whole low-rank ``cq``, or ``x``)
    goes through ``copy_to``."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = layers.rms_norm(dense(params["w_dq"], x, impl=impl), params["q_norm"])
        q = dense(params["w_uq"], copy_to(tp, cq), impl=impl)
    else:
        q = dense(params["wq"], copy_to(tp, x), impl=impl)
    q = q.reshape(b, s, -1, dn + dr)
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


def _mla(params, x, cfg, positions, impl=None, tp=None):
    """Full-sequence MLA: the latent expanded through ``w_uk`` / ``w_uv`` to
    per-head keys and values, then :func:`chunked_attention` with v padded
    to the q head width → (output, c_kv, k_rope).  Under ``tp`` on the
    rank's heads, ``wo`` row-parallel; the rank's heads read the whole
    latent, so in training the gradients of ``c_kv``, ``k_rope`` and the
    low-rank ``cq`` (and with them those of ``w_dkv``, ``kv_norm``,
    ``w_dq`` and ``q_norm``, which every rank holds whole) are summed over
    the model axis (``copy_to``)."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(params, x, cfg, positions, impl=impl, tp=tp)
    h = q_nope.shape[2]
    c_kv, k_rope = _mla_latent(params, x, cfg, positions, impl=impl)
    c_kv, k_rope = copy_to(tp, c_kv), copy_to(tp, k_rope)
    k_nope = dense(params["w_uk"], c_kv, impl=impl).reshape(b, s, h, dn)
    v = dense(params["w_uv"], c_kv, impl=impl).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    out = chunked_attention(q, k, torch.nn.functional.pad(v, (0, dn + dr - dv)),
                            q_pos=positions, kv_pos=positions)[..., :dv]
    return row_parallel(params["wo"], out.reshape(b, s, h * dv), tp, impl=impl), c_kv, k_rope


def mla_apply(params, x, cfg, *, positions=None, impl=None, tp=None):
    """Full-sequence MLA with no cache (the train path: the reference's
    ``mla_apply`` without ``cache_len``); under ``tp`` the rank's heads."""
    positions = _arange_positions(x) if positions is None else positions
    return _mla(params, x, cfg, positions, impl=impl, tp=tp)[0]


def mla_prefill(params, x, cfg, *, cache_len, positions=None, impl=None, tp=None):
    """Prefill MLA (the reference's ``mla_apply`` with a cache).  Returns
    (output, cache); under ``tp`` the rank's heads, and the whole latent
    cache."""
    b = x.shape[0]
    positions = _arange_positions(x) if positions is None else positions
    out, c_kv, k_rope = _mla(params, x, cfg, positions, impl=impl, tp=tp)
    cache = init_mla_cache(cfg, b, cache_len, dtype=c_kv.dtype, device=x.device)
    _mla_write(cache, c_kv, k_rope, positions, kvcache.format_for(cfg))
    return out, cache


def init_mla_cache(cfg, batch: int, cache_len: int, *, dtype=None, device=None) -> dict:
    """The MLA latent cache on ``device`` (default ``"cuda"``): the ``c_kv``
    channel (lead ``()``, feature = the lora rank) through ``cfg``'s cache
    format (paged under a paged format); the rope key ``k_rope [B, L, dr]``
    stays float a slot, and ``pos_ids``.  L is ``fmt.slot_capacity(cache_len)``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    fmt = kvcache.format_for(cfg)
    cache_len = fmt.slot_capacity(cache_len)
    cache = dict(fmt.channel_entries(
        "c_kv", fmt.init(batch, cache_len, (), cfg.kv_lora_rank, dtype=dtype, device=device)))
    cache["k_rope"] = torch.zeros((batch, cache_len, cfg.qk_rope_dim), dtype=dtype,
                                  device=device)
    cache["pos_ids"] = torch.full((batch, cache_len), -1, dtype=torch.int32, device=device)
    return cache


def _mla_write(cache, c_kv, k_rope, positions, fmt, seq=None, pages=None) -> None:
    """In place: the latent and rope key of S new tokens at slots = position
    mod L (:func:`_ring_slots`: pads left out, deterministic); under ``seq``
    the rank's (:func:`_seq_write`)."""
    b_idx, s_idx, pos, ring = _seq_write(cache, (("c_kv", c_kv),), positions, fmt, seq,
                                         pages)
    cache["k_rope"][b_idx, ring] = k_rope[b_idx, s_idx].to(cache["k_rope"].dtype)
    cache["pos_ids"][b_idx, ring] = pos.to(torch.int32)


def mla_decode(params, x, cache, cfg, *, pos, impl=None, tp=None, seq=None):
    """Absorbed-form MLA decode of ``x [B, S, D]`` against the latent ring
    (S > 1 appends a chunk and attends causally).  The latent reads go
    through the cache format's ``qk`` / ``av`` with lead ``()``, the (S,
    heads) axes folded into the group axis, so the int8 and bit-plane reads
    apply to the latent as to K/V.  Updates ``cache`` in place and returns
    it.  Under ``tp`` the rank's heads read the whole latent ring and
    ``wo`` is row-parallel; under ``seq`` (:class:`SeqParallel`) the rank's
    block of the ring, its latent context joined by :func:`combine_blocks`
    before ``w_uv``."""
    b, s, _ = x.shape
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    positions = _decode_positions(pos, b, s, x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, positions, impl=impl)
    h = q_nope.shape[2]
    c_kv_new, k_rope_new = _mla_latent(params, x, cfg, positions, impl=impl)
    fmt = kvcache.format_for(cfg)
    pages = _rank_pages(cache, seq) if _paged_seq(fmt, seq) else None
    _mla_write(cache, c_kv_new, k_rope_new, positions, fmt, seq=seq, pages=pages)
    ln = cache["pos_ids"].shape[1]
    pos_ids = cache["pos_ids"]
    valid = (pos_ids[:, None, :] >= 0) & (pos_ids[:, None, :] <= positions[..., None])
    read = cache
    if pages is not None:
        tables, owned = pages
        read = {**cache, **tables}
        valid &= owned[:, None, :]
    # absorption needs the float matrices: the projections above run in their
    # residency formats, the latent-space products below in float32
    w_uk = _as_float(params["w_uk"], (r, h, dn), x.dtype).to(torch.float32)
    w_uv = _as_float(params["w_uv"], (r, h, dv), x.dtype).to(torch.float32)
    q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope.to(torch.float32), w_uk)
    store = fmt.channel(read, "c_kv")
    s_nope = fmt.qk(q_abs.reshape(b, s * h, r), store).reshape(b, s, h, ln)
    krope = cache["k_rope"].to(torch.float32)
    scores = (s_nope + torch.einsum("bqhd,bld->bqhl", q_rope.to(torch.float32), krope)
              ) / math.sqrt(dn + dr)
    scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
    if seq is None:
        w = torch.softmax(scores, dim=-1)
    else:  # the block's normalised weights and statistics
        w, m, total = _block_softmax(scores)
    ctx = fmt.av(w.reshape(b, s * h, ln), store, r).reshape(b, s, h, r)
    if seq is not None:
        ctx = combine_blocks(ctx, m[..., 0], total[..., 0], seq)
    out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
    out = row_parallel(params["wo"], out.reshape(b, s, h * dv).to(x.dtype), tp, impl=impl)
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
