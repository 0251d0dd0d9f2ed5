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
encoder-decoder's decoder).  Modes: ``prefill`` (full sequence, builds
the caches; the cross mixers project the context ``ctx`` there),
``decode`` (tokens against the caches) and ``encode`` (the encoder's
non-causal full-sequence layers, no cache).  An attention layer's cache is
its ring (updated in place); a Mamba layer's is ``{"conv", "ssm"}``, batch
first, replaced each call; a ``cross`` layer's is the projected context
``{"ck", "cv"}``, an ``attn_cross`` layer's ``{"self": ring, "cross":
{"ck", "cv"}}``.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, mamba, moe
from repro_torch.models.layers import dense


def _bidir_attn(params, h, cfg, impl=None):
    """Non-causal self-attention (encoder stacks): rope at ``arange(S)``,
    every position sees every other."""
    b, s, _ = h.shape
    positions = torch.arange(s, dtype=torch.int32, device=h.device).expand(b, s)
    q, k, v = attention._project_qkv(params, h, cfg, positions, impl=impl)
    out = attention.chunked_attention(q, k, v, q_pos=positions, kv_pos=positions,
                                      causal=False)
    return dense(params["wo"], out.reshape(b, s, -1), impl=impl)


def _mixer(params, h, cfg, *, kind, mode, cache, pos, cache_len, impl):
    if mode not in ("prefill", "decode", "encode"):
        raise ValueError(f"unknown mode {mode!r}")
    if kind == "mamba":
        if mode == "prefill":
            return mamba.mamba_apply(params, h, cfg, return_state=True, impl=impl)
        return mamba.mamba_decode(params, h, cache, cfg, impl=impl)
    if mode == "encode":  # the encoder's GQA layers: non-causal, no cache
        return _bidir_attn(params, h, cfg, impl=impl), None
    mla = cfg.attn_type == "mla"
    if mode == "prefill":
        fn = attention.mla_prefill if mla else attention.gqa_prefill
        return fn(params, h, cfg, cache_len=cache_len, positions=pos, impl=impl)
    fn = attention.mla_decode if mla else attention.gqa_decode
    return fn(params, h, cache, cfg, pos=pos, impl=impl)


def _cross(params, h, cfg, *, mode, cache, ctx, impl):
    """Cross-attention of ``h`` over the context: K/V projected from ``ctx``
    at prefill, read from ``cache`` at decode.  Returns (output, K/V)."""
    kv = cache if mode == "decode" else attention.cross_kv(params, ctx, cfg, impl=impl)
    return attention.cross_apply(params, h, kv, cfg, gated=not cfg.is_enc_dec, impl=impl), kv


def layer_apply(params: dict, x, cfg, *, mode: str, mixer: str = "attn", ffn: str = "dense",
                cache=None, pos=None, cache_len: int = 0, ctx=None, impl=None):
    """One layer with mixer kind ``mixer`` (``attn``, ``mamba``, ``cross`` or
    ``attn_cross``) and FFN kind ``ffn`` (``dense``, ``moe`` or ``none``).
    Returns (x, cache)."""
    h = layers.norm_apply(params["ln1"], x, cfg)
    if mixer == "cross":
        a, cache = _cross(params["mixer"], h, cfg, mode=mode, cache=cache, ctx=ctx, impl=impl)
        x = x + a.to(x.dtype)
    else:
        both = mixer == "attn_cross"
        own = cache["self"] if both and mode == "decode" else cache
        a, own = _mixer(params["mixer"], h, cfg, kind="attn" if both else mixer, mode=mode,
                        cache=own, pos=pos, cache_len=cache_len, impl=impl)
        x = x + a.to(x.dtype)
        if both:
            hx = layers.norm_apply(params["ln_x"], x, cfg)
            cx, kv = _cross(params["cross"], hx, cfg, mode=mode,
                            cache=cache["cross"] if mode == "decode" else None, ctx=ctx,
                            impl=impl)
            x = x + cx.to(x.dtype)
            own = {"self": own, "cross": kv}
        cache = own
    if ffn == "none":
        return x, cache
    h2 = layers.norm_apply(params["ln2"], x, cfg)
    if ffn == "moe":
        moe_fn = moe.moe_apply_einsum if cfg.moe_impl == "einsum" else moe.moe_apply
        y, _ = moe_fn(params["ffn"], h2, cfg, impl=impl)
    else:
        y = layers.mlp_apply(params["ffn"], h2, cfg, impl=impl)
    return x + y.to(x.dtype), cache


def stack_apply(layer_params: list, x, cfg, *, mode: str, caches=None, pos=None,
                cache_len: int = 0, ctx=None, impl=None):
    """Run every layer in order (``ctx``: the context the cross mixers
    project at prefill).  Returns (x, per-layer caches)."""
    new_caches = []
    for i, p in enumerate(layer_params):
        x, c = layer_apply(p, x, cfg, mode=mode, mixer=cfg.mixer_kind(i), ffn=cfg.ffn_kind(i),
                           cache=None if caches is None else caches[i],
                           pos=pos, cache_len=cache_len, ctx=ctx, impl=impl)
        new_caches.append(c)
    return x, new_caches
