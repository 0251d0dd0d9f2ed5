"""The layer stack: one mixer + FFN layer, looped over depth.

Counterpart of :mod:`repro.models.stack`.  The reference stacks every leaf
``[n_superblocks, ...]`` and runs the depth with ``lax.scan`` over
periodic superblocks (with deepseek's leading dense layers as an
unscanned prefix); the port keeps one parameter dict and one cache dict
per layer and runs a Python loop, each layer picking its mixer by
``cfg.mixer_kind(i)`` (attention, GQA or MLA by ``cfg.attn_type``; or
Mamba) and its FFN by ``cfg.ffn_kind(i)`` (dense, MoE, or none).  Modes:
``prefill`` (full sequence, builds the caches) and ``decode`` (tokens
against the caches).  An attention layer's cache is its ring (updated in
place); a Mamba layer's is ``{"conv", "ssm"}``, batch first, replaced each
call.
"""

from __future__ import annotations

from repro_torch.models import attention, layers, mamba, moe


def _mixer(params, h, cfg, *, kind, mode, cache, pos, cache_len, impl):
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if kind == "mamba":
        if mode == "prefill":
            return mamba.mamba_apply(params, h, cfg, return_state=True, impl=impl)
        return mamba.mamba_decode(params, h, cache, cfg, impl=impl)
    mla = cfg.attn_type == "mla"
    if mode == "prefill":
        fn = attention.mla_prefill if mla else attention.gqa_prefill
        return fn(params, h, cfg, cache_len=cache_len, positions=pos, impl=impl)
    fn = attention.mla_decode if mla else attention.gqa_decode
    return fn(params, h, cache, cfg, pos=pos, impl=impl)


def layer_apply(params: dict, x, cfg, *, mode: str, mixer: str = "attn", ffn: str = "dense",
                cache=None, pos=None, cache_len: int = 0, impl=None):
    """One layer with mixer kind ``mixer`` (``attn`` or ``mamba``) and FFN
    kind ``ffn`` (``dense``, ``moe`` or ``none``).  Returns (x, cache)."""
    h = layers.norm_apply(params["ln1"], x, cfg)
    a, cache = _mixer(params["mixer"], h, cfg, kind=mixer, mode=mode, cache=cache, pos=pos,
                      cache_len=cache_len, impl=impl)
    x = x + a.to(x.dtype)
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
                cache_len: int = 0, impl=None):
    """Run every layer in order.  Returns (x, per-layer caches)."""
    new_caches = []
    for i, p in enumerate(layer_params):
        x, c = layer_apply(p, x, cfg, mode=mode, mixer=cfg.mixer_kind(i), ffn=cfg.ffn_kind(i),
                           cache=None if caches is None else caches[i],
                           pos=pos, cache_len=cache_len, impl=impl)
        new_caches.append(c)
    return x, new_caches
