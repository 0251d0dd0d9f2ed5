"""The layer stack: one mixer + FFN layer, looped over depth.

Counterpart of :mod:`repro.models.stack`.  The reference stacks every leaf
``[n_superblocks, ...]`` and runs the depth with ``lax.scan`` over
periodic superblocks (with deepseek's leading dense layers as an
unscanned prefix); the port keeps one parameter dict and one cache dict
per layer and runs a Python loop, each layer picking its mixer by
``cfg.mixer_kind(i)`` and its FFN by ``cfg.ffn_kind(i)`` (dense, MoE, or
none).  Mixers: ``attn`` (GQA or MLA by ``cfg.attn_type``), ``mamba``,
``cross`` (cross-attention over the context in place of self-attention,
llama-vision's image layers) and ``attn_cross`` (self-attention, then
``ln_x`` and cross-attention under the ``cross`` key, in one layer: an
encoder-decoder's decoder).  Modes: ``train`` (full sequence, no caches;
each layer optionally rematerialised in the backward pass), ``prefill``
(full sequence, builds the caches; the cross mixers project the context
``ctx`` in both), ``decode`` (tokens against the caches) and ``encode``
(the encoder's non-causal full-sequence layers, no cache).  Every mode
returns the sum of the MoE layers' load-balancing losses beside ``x``.
An attention layer's cache is its ring (updated in place); a Mamba
layer's is ``{"conv", "ssm"}``, batch first, replaced each call; a ``cross`` layer's is the projected context
``{"ck", "cv"}``, an ``attn_cross`` layer's ``{"self": ring, "cross":
{"ck", "cv"}}``.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint

from repro_torch.models import attention, layers, mamba, moe


def _bidir_attn(params, h, cfg, impl=None, tp=None):
    """Non-causal self-attention (encoder stacks): rope at ``arange(S)``,
    every position sees every other; under ``tp`` on the rank's heads,
    ``wo`` row-parallel."""
    positions = attention._arange_positions(h)
    return attention._gqa(params, h, cfg, positions, impl=impl, tp=tp, causal=False)[0]


MODES = ("train", "prefill", "decode", "encode")


def _mixer(params, h, cfg, *, kind, mode, cache, pos, cache_len, impl, tp=None, seq=None):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    mla = cfg.attn_type == "mla"
    if mode == "train":  # full sequence, no cache
        if kind == "mamba":
            return mamba.mamba_apply(params, h, cfg, impl=impl, tp=tp), None
        if mla:
            return attention.mla_apply(params, h, cfg, impl=impl, tp=tp), None
        return attention.gqa_apply(params, h, cfg, impl=impl, tp=tp), None
    if kind == "mamba":
        if mode == "prefill":
            return mamba.mamba_apply(params, h, cfg, return_state=True, impl=impl, tp=tp)
        return mamba.mamba_decode(params, h, cache, cfg, impl=impl, tp=tp)
    if mode == "encode":  # the encoder's GQA layers: non-causal, no cache
        return _bidir_attn(params, h, cfg, impl=impl, tp=tp), None
    if mode == "prefill":
        if mla:
            return attention.mla_prefill(params, h, cfg, cache_len=cache_len, positions=pos,
                                         impl=impl, tp=tp)
        return attention.gqa_prefill(params, h, cfg, cache_len=cache_len, positions=pos,
                                     impl=impl, tp=tp)
    if mla:
        return attention.mla_decode(params, h, cache, cfg, pos=pos, impl=impl, tp=tp, seq=seq)
    return attention.gqa_decode(params, h, cache, cfg, pos=pos, impl=impl, tp=tp, seq=seq)


def _cross(params, h, cfg, *, mode, cache, ctx, impl, tp=None):
    """Cross-attention of ``h`` over the context: K/V projected from ``ctx``
    at prefill, read from ``cache`` at decode.  Returns (output, K/V); under
    ``tp`` the rank's heads."""
    kv = cache if mode == "decode" else attention.cross_kv(params, ctx, cfg, impl=impl, tp=tp)
    return attention.cross_apply(params, h, kv, cfg, gated=not cfg.is_enc_dec, impl=impl,
                                 tp=tp), kv


def layer_apply(params: dict, x, cfg, *, mode: str, mixer: str = "attn", ffn: str = "dense",
                cache=None, pos=None, cache_len: int = 0, ctx=None, impl=None, tp=None,
                seq=None, global_counts=None):
    """One layer with mixer kind ``mixer`` (``attn``, ``mamba``, ``cross`` or
    ``attn_cross``) and FFN kind ``ffn`` (``dense``, ``moe`` or ``none``).
    Returns (x, cache, the MoE layer's load-balancing loss or 0).  ``tp``
    runs the rank's shards (the model checks what it serves and trains);
    ``seq`` (decode) the rank's block of an attention ring, GQA's or MLA's
    (:class:`~repro_torch.models.attention.SeqParallel`; a cross layer's
    context is whole on every rank);
    ``global_counts`` a MoE layer's top-1 counts over a split batch
    (:func:`repro_torch.models.moe.moe_apply`)."""
    h = layers.norm_apply(params["ln1"], x, cfg)
    if mixer == "cross":
        a, cache = _cross(params["mixer"], h, cfg, mode=mode, cache=cache, ctx=ctx, impl=impl,
                          tp=tp)
        x = x + a.to(x.dtype)
    else:
        both = mixer == "attn_cross"
        own = cache["self"] if both and mode == "decode" else cache
        a, own = _mixer(params["mixer"], h, cfg, kind="attn" if both else mixer, mode=mode,
                        cache=own, pos=pos, cache_len=cache_len, impl=impl, tp=tp, seq=seq)
        x = x + a.to(x.dtype)
        if both:
            hx = layers.norm_apply(params["ln_x"], x, cfg)
            cx, kv = _cross(params["cross"], hx, cfg, mode=mode,
                            cache=cache["cross"] if mode == "decode" else None, ctx=ctx,
                            impl=impl, tp=tp)
            x = x + cx.to(x.dtype)
            own = {"self": own, "cross": kv}
        cache = own
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "none":
        return x, cache, aux
    h2 = layers.norm_apply(params["ln2"], x, cfg)
    if ffn == "moe":
        if cfg.moe_impl == "einsum":
            y, aux = moe.moe_apply_einsum(params["ffn"], h2, cfg, impl=impl,
                                          global_counts=global_counts)
        else:
            y, aux = moe.moe_apply(params["ffn"], h2, cfg, impl=impl, tp=tp,
                                   global_counts=global_counts)
    else:
        y = layers.mlp_apply(params["ffn"], h2, cfg, impl=impl, tp=tp)
    return x + y.to(x.dtype), cache, aux


def init_layer_cache(cfg, mixer: str, batch: int, cache_len: int, *, device=None,
                     tp: int = 1, local: bool = True):
    """One layer's zero decode cache, as prefill leaves it, on ``device``
    (default ``"cuda"``): the ring of an ``attn`` layer (GQA or MLA,
    ``cache_len`` positions before the format's page rounding), a Mamba
    layer's state, a ``cross`` layer's context K/V, an ``attn_cross``
    layer's ``{"self": ring, "cross": K/V}``; at ``tp`` ways a rank's heads
    and channels, or with ``local=False`` the global cache."""
    if mixer == "mamba":
        return mamba.init_mamba_state(cfg, batch, device=device, tp=tp, local=local)
    if mixer == "cross":
        return attention.init_cross_cache(cfg, batch, tp=tp, local=local, device=device)
    if cfg.attn_type == "mla":
        ring = attention.init_mla_cache(cfg, batch, cache_len, device=device)
    else:
        ring = attention.init_kv_cache(cfg, batch, cache_len, tp=tp, local=local,
                                       device=device)
    if mixer == "attn_cross":
        return {"self": ring, "cross": attention.init_cross_cache(cfg, batch, tp=tp, local=local,
                                                                  device=device)}
    return ring


def stack_apply(layer_params: list, x, cfg, *, mode: str, caches=None, pos=None,
                cache_len: int = 0, ctx=None, impl=None, remat: bool = False, tp=None,
                gather=None, seq=None, global_counts=None):
    """Run every layer in order (``ctx``: the context the cross mixers
    project).  Returns (x, per-layer caches, the summed MoE aux loss).
    ``remat`` (train mode) keeps no activation of a layer for the backward
    pass but its input, recomputing the layer there
    (``torch.utils.checkpoint``; the reference remats a superblock).
    ``gather(i, p)`` (train mode) gives layer ``i``'s parameters from the
    rank's shards ``p`` (FSDP's gather on use); it runs inside the
    recomputed function, so remat gathers again in the backward pass, in the
    same order on every rank.  ``seq`` as for :func:`layer_apply`;
    ``global_counts(i, local)`` (train mode, a batch split over ranks) gives
    MoE layer ``i`` the top-1 counts of the whole (micro)batch from the
    rank's ``local`` ones, and the ways the batch is split."""
    new_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layer_params):
        kind = dict(mixer=cfg.mixer_kind(i), ffn=cfg.ffn_kind(i))
        if mode == "train":
            def run(x, p=p, i=i, kind=kind):
                if gather is not None:
                    p = gather(i, p)
                counts = None if global_counts is None else functools.partial(global_counts, i)
                y, _, aux = layer_apply(p, x, cfg, mode=mode, ctx=ctx, impl=impl, tp=tp,
                                        global_counts=counts, **kind)
                return y, aux

            if remat:
                x, aux = checkpoint.checkpoint(run, x, use_reentrant=False,
                                               preserve_rng_state=False)
            else:
                x, aux = run(x)
            c = None
        else:
            x, c, aux = layer_apply(p, x, cfg, mode=mode, cache=None if caches is None
                                    else caches[i], pos=pos, cache_len=cache_len, ctx=ctx,
                                    impl=impl, tp=tp, seq=seq, **kind)
        new_caches.append(c)
        aux_total = aux_total + aux
    return x, None if mode == "train" else new_caches, aux_total
