"""The causal LM, the VLM and the encoder-decoder: parameter specs,
initialisation, encoder, the train path (``forward``, ``loss_fn``), prefill
and decode.

Counterpart of :mod:`repro.models.model` for the dense,
MoE, SSM, hybrid, VLM and audio (encoder-decoder) families, with GQA or MLA
attention, Mamba-1 mixers and cross-attention.  Parameters are a plain
dict::

    {"embed": {"embedding", "head" (untied models)},
     "final_norm": {"scale", "bias" (layernorm)},
     "layers": [{"ln1", "mixer": {...}, "ln_x", "cross": {...} (attn_cross),
                 "ln2", "ffn": {...}}, ...],
     "encoder": {"layers": [{"ln1", "mixer", "ln2", "ffn"}, ...],
                 "final_norm"}  (encoder-decoder only)}

one dict per layer where the reference stacks ``[n_superblocks, ...]``
leaves (and keeps deepseek's leading dense layers apart, under
``prefix``).  The mixer, by ``cfg.mixer_kind(i)``, is GQA ``{wq, wk, wv,
wo, bq, bk, bv (qkv_bias), q_norm, k_norm (qk_norm)}``, MLA ``{w_dkv,
kv_norm, w_uk, w_uv, wo, and w_dq, q_norm, w_uq (q_lora_rank) or wq}``,
Mamba ``{in_proj, conv_w, conv_b, x_proj, dt_w, dt_b, A_log, D, out_proj}``
(:mod:`repro_torch.models.mamba`) or cross-attention ``{wq, wk, wv, wo,
gate}`` (``cross``: llama-vision's image layers, in place of
self-attention); an ``attn_cross`` layer (an encoder-decoder's decoder)
holds GQA under ``mixer`` and cross-attention under ``cross`` with its
norm ``ln_x``.  The encoder's ``n_enc_layers`` layers are GQA + dense FFN,
run without a mask.  A layer whose ``cfg.ffn_kind(i)`` is ``"none"`` (the
SSM family) has no ``ln2`` and no ``ffn``; the FFN dense ``{w_in, w_out}``
(``w_in`` ``[d, 2·d_ff]``, SwiGLU's fused gate and up, or ``[d, d_ff]``,
GELU) or MoE ``{router [d, E] float32, w_in [E, d, 2·moe_d_ff], w_out [E,
moe_d_ff, d], shared_w_in, shared_w_out (shared experts)}`` by
``cfg.ffn_kind(i)``.  :func:`materialize` follows the reference's
ParamSpec init rules (``repro/sharding/partitioning.py``) with a
``torch.Generator``: fan-in is a leaf's first axis, which for the stacked
expert weights is the expert axis, as in the reference, whose scan stacking
puts the expert axis where it reads the fan-in.  The numbers differ from
``jax.random``'s, so parity tests bring the reference's own parameters
across with :mod:`repro_torch.convert`.  On one device the vocab is not padded (the
reference pads it to a multiple of its tensor-parallel width and masks the
pad logits), so there is nothing to mask.

The context the cross layers attend to comes with the prompt: a VLM's
``batch["ctx_embeds"]`` (patch embeddings, cast to ``cfg.dtype``), or an
encoder-decoder's ``batch["enc_embeds"]`` (frame embeddings) run through
:func:`encode`.  :func:`prefill` projects it once a cross layer and keeps
the K/V in that layer's cache; :func:`decode_step` reads them there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import attention, layers, mamba, stack

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape, dtype and initializer of one parameter."""

    shape: tuple
    dtype: Any = torch.bfloat16
    #: normal (fan-in scaled) | embedding (unit) | ones | zeros | ssm_a
    #: (Mamba's A_log: log(1..d_state) over channels) | ssm_dt (Mamba's dt
    #: bias: the softplus-inverse of U[1e-3, 1e-1])
    init: str = "normal"


def _norm_specs(cfg) -> dict:
    specs = {"scale": ParamSpec((cfg.d_model,), torch.float32, "ones")}
    if cfg.norm == "layernorm":
        specs["bias"] = ParamSpec((cfg.d_model,), torch.float32, "zeros")
    return specs


def _gqa_specs(cfg) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    mixer = {
        "wq": ParamSpec((d, cfg.n_heads * dh), cfg.dtype),
        "wk": ParamSpec((d, cfg.n_kv_heads * dh), cfg.dtype),
        "wv": ParamSpec((d, cfg.n_kv_heads * dh), cfg.dtype),
        "wo": ParamSpec((cfg.n_heads * dh, d), cfg.dtype),
    }
    if cfg.qkv_bias:
        mixer["bq"] = ParamSpec((cfg.n_heads * dh,), torch.float32, "zeros")
        mixer["bk"] = ParamSpec((cfg.n_kv_heads * dh,), torch.float32, "zeros")
        mixer["bv"] = ParamSpec((cfg.n_kv_heads * dh,), torch.float32, "zeros")
    if cfg.qk_norm:
        mixer["q_norm"] = ParamSpec((dh,), torch.float32, "ones")
        mixer["k_norm"] = ParamSpec((dh,), torch.float32, "ones")
    return mixer


def _mla_specs(cfg) -> dict:
    h, d = cfg.n_heads, cfg.d_model
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    mixer = {
        "w_dkv": ParamSpec((d, r + dr), cfg.dtype),
        "kv_norm": ParamSpec((r,), torch.float32, "ones"),
        "w_uk": ParamSpec((r, h * dn), cfg.dtype),
        "w_uv": ParamSpec((r, h * dv), cfg.dtype),
        "wo": ParamSpec((h * dv, d), cfg.dtype),
    }
    if cfg.q_lora_rank:
        mixer["w_dq"] = ParamSpec((d, cfg.q_lora_rank), cfg.dtype)
        mixer["q_norm"] = ParamSpec((cfg.q_lora_rank,), torch.float32, "ones")
        mixer["w_uq"] = ParamSpec((cfg.q_lora_rank, h * (dn + dr)), cfg.dtype)
    else:
        mixer["wq"] = ParamSpec((d, h * (dn + dr)), cfg.dtype)
    return mixer


def _d_in(cfg, d_ff: int) -> int:
    return d_ff if cfg.act == "gelu" else 2 * d_ff  # SwiGLU: fused [gate; up]


def _moe_specs(cfg) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    ffn = {
        "router": ParamSpec((d, e), torch.float32),
        "w_in": ParamSpec((e, d, _d_in(cfg, f)), cfg.dtype),
        "w_out": ParamSpec((e, f, d), cfg.dtype),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        ffn["shared_w_in"] = ParamSpec((d, _d_in(cfg, fs)), cfg.dtype)
        ffn["shared_w_out"] = ParamSpec((fs, d), cfg.dtype)
    return ffn


def _layer_specs(cfg, mixer_kind: str, ffn_kind: str) -> dict:
    d = cfg.d_model
    if mixer_kind == "mamba":
        mixer = mamba.mamba_specs(cfg)
    elif mixer_kind == "cross":
        mixer = attention.cross_specs(cfg)
    else:
        mixer = _mla_specs(cfg) if cfg.attn_type == "mla" else _gqa_specs(cfg)
    layer = {"ln1": _norm_specs(cfg), "mixer": mixer}
    if mixer_kind == "attn_cross":
        layer.update(ln_x=_norm_specs(cfg), cross=attention.cross_specs(cfg))
    if ffn_kind == "none":
        return layer
    if ffn_kind == "moe":
        ffn = _moe_specs(cfg)
    else:
        ffn = {"w_in": ParamSpec((d, _d_in(cfg, cfg.d_ff)), cfg.dtype),
               "w_out": ParamSpec((cfg.d_ff, d), cfg.dtype)}
    return {**layer, "ln2": _norm_specs(cfg), "ffn": ffn}


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def specs(cfg) -> dict:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the port serves the families {FAMILIES}, "
                                  f"not {cfg.family!r}")
    embed = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), torch.float32,
                                    "embedding")}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), cfg.dtype)
    tree = {
        "embed": embed,
        "final_norm": _norm_specs(cfg),
        "layers": [_layer_specs(cfg, cfg.mixer_kind(i), cfg.ffn_kind(i))
                   for i in range(cfg.n_layers)],
    }
    if cfg.is_enc_dec:
        tree["encoder"] = {
            "layers": [_layer_specs(cfg, "attn", "dense") for _ in range(cfg.n_enc_layers)],
            "final_norm": _norm_specs(cfg),
        }
    return tree


def _init(spec: ParamSpec, gen: torch.Generator, device) -> torch.Tensor:
    if spec.init in ("ones", "zeros"):
        fill = torch.ones if spec.init == "ones" else torch.zeros
        return fill(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ssm_a":  # log(1..n) over the channels, rounded once; draws nothing
        a = torch.arange(1, spec.shape[-1] + 1, dtype=torch.float64, device=device)
        return torch.log(a).to(spec.dtype).expand(spec.shape).contiguous()
    if spec.init == "ssm_dt":
        u = torch.rand(spec.shape, generator=gen, dtype=torch.float32, device=device)
        u = u * (1e-1 - 1e-3) + 1e-3
        return torch.log(torch.expm1(u)).to(spec.dtype)
    w = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    if spec.init == "normal":
        w.div_(math.sqrt(spec.shape[0]))  # fan-in: the first axis (see the module doc)
    return w.to(spec.dtype)


def draw(cfg, seed: int = 0, device=None,
         leaf: Optional[Callable[[tuple, torch.Tensor], Any]] = None) -> dict:
    """Random parameters from ``seed`` on ``device`` (default ``"cuda"``),
    drawn leaf by leaf from one generator in the order of :func:`specs`;
    each leaf goes through ``leaf(path, tensor)`` (``path`` the tuple of
    keys, e.g. ``("layers", "3", "ffn", "w_in")``) before the next is drawn,
    so that only what ``leaf`` returns is kept."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def walk(tree, path):
        if isinstance(tree, ParamSpec):
            w = _init(tree, gen, device)
            return w if leaf is None else leaf(path, w)
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]

    return walk(specs(cfg), ())


def materialize(cfg, seed: int = 0, device=None) -> dict:
    """Random parameters from ``seed`` on ``device`` (default ``"cuda"``)."""
    return draw(cfg, seed, device)


def encode(params, enc_embeds: torch.Tensor, cfg, *, impl=None) -> torch.Tensor:
    """The encoder (encoder-decoder only): ``enc_embeds [B, S, D]`` (the
    stub frontend's frames, cast to ``cfg.dtype``) through the
    ``n_enc_layers`` non-causal layers and the encoder's final norm."""
    x = enc_embeds.to(cfg.dtype)
    for p in params["encoder"]["layers"]:
        x, _, _ = stack.layer_apply(p, x, cfg, mode="encode", impl=impl)
    return layers.norm_apply(params["encoder"]["final_norm"], x, cfg)


def _context(params, batch: dict, cfg, impl=None):
    """The context the cross layers attend to: the encoder's output, a VLM's
    patch embeddings, or None."""
    if cfg.is_enc_dec:
        return encode(params, batch["enc_embeds"], cfg, impl=impl)
    if cfg.family == "vlm":
        return batch["ctx_embeds"].to(cfg.dtype)
    return None


def forward(params, batch: dict, cfg, *, remat: bool = False, impl=None):
    """The train path's forward: ``batch["tokens"] [B, S]`` (with the
    context, ``ctx_embeds`` or ``enc_embeds``) through every layer with no
    cache → (logits [B, S, V] in ``cfg.dtype``, the summed MoE aux loss).
    ``remat`` recomputes each layer in the backward pass."""
    ctx = _context(params, batch, cfg, impl=impl)
    x = layers.embed_apply(params["embed"], batch["tokens"], cfg)
    x, _, aux = stack.stack_apply(params["layers"], x, cfg, mode="train", ctx=ctx, impl=impl,
                                  remat=remat)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    return layers.logits_apply(params["embed"], x, cfg, impl=impl), aux


def loss_fn(params, batch: dict, cfg, *, remat: bool = False, aux_weight: float = 0.01,
            z_weight: float = 1e-4, impl=None):
    """Next-token cross entropy over the positions whose ``batch["labels"]``
    are >= 0, plus ``aux_weight`` · the MoE aux loss and ``z_weight`` · the
    z-loss (the mean squared log-partition) → (loss, {"ce", "aux", "z",
    "tokens"}).  With no vocab padding on one device there is no pad logit
    to mask."""
    logits, aux = forward(params, batch, cfg, remat=remat, impl=impl)
    logits = logits.to(torch.float32)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).to(torch.int64)[..., None])[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = ((lse - ll) * mask).sum() / denom
    z = (torch.square(lse) * mask).sum() / denom
    total = ce + aux_weight * aux + z_weight * z
    return total, {"ce": ce, "aux": aux, "z": z, "tokens": mask.sum()}


def prefill(params, batch: dict, cfg, *, max_len: int, impl=None):
    """Run the prompt, build the decode caches → (last logits [B,1,V] f32,
    per-layer caches: an attention layer's ring is ``min(sliding_window,
    max_len)`` long, a Mamba layer's state O(1), a cross layer's the
    projected context).  ``batch["positions"]`` (optional [B,S]) marks
    left-pad tokens with negative positions, which attention ignores and a
    Mamba layer cannot (the engine never pads an SSM config's prompts);
    ``batch["ctx_embeds"]`` (VLM) or ``batch["enc_embeds"]``
    (encoder-decoder) carries the context."""
    ctx = _context(params, batch, cfg, impl=impl)
    x = layers.embed_apply(params["embed"], batch["tokens"], cfg)
    x, caches, _ = stack.stack_apply(params["layers"], x, cfg, mode="prefill",
                                     pos=batch.get("positions"),
                                     cache_len=attention.cache_len_for(cfg, max_len), ctx=ctx,
                                     impl=impl)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logits = layers.logits_apply(params["embed"], x[:, -1:], cfg, impl=impl)
    return logits.to(torch.float32), caches


def init_cache(cfg, batch: int, max_len: int, *, device=None) -> list:
    """The decode caches of ``batch`` slots, one per layer in the layout
    :func:`prefill` returns (a ring of ``attention.cache_len_for(cfg,
    max_len)`` positions, rounded to whole pages by a paged format; a
    Mamba state; a cross layer's context K/V), zero, on ``device`` (default
    ``"cuda"``).  ``device="meta"`` gives the abstract cache the dry run
    counts; its bytes equal the reference's stacked ``init_cache``."""
    cache_len = attention.cache_len_for(cfg, max_len)
    return [stack.init_layer_cache(cfg, cfg.mixer_kind(i), batch, cache_len, device=device)
            for i in range(cfg.n_layers)]


def decode_step(params, token: torch.Tensor, caches, pos, cfg, *, impl=None):
    """One decode step: ``token [B,S]`` against the caches (updated in
    place) at scalar, per-slot ``[B]`` or per-token ``[B,S]`` positions.
    Cross-attention reads its context from the caches."""
    pos = attention._decode_positions(pos, token.shape[0], token.shape[1], token.device)
    x = layers.embed_apply(params["embed"], token, cfg)
    x, caches, _ = stack.stack_apply(params["layers"], x, cfg, mode="decode",
                                     caches=caches, pos=pos, impl=impl)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logits = layers.logits_apply(params["embed"], x, cfg, impl=impl)
    return logits.to(torch.float32), caches
