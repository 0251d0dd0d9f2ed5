"""The causal LM: parameter specs, initialisation, prefill and decode.

Counterpart of the serving half of :mod:`repro.models.model` for the dense,
MoE, SSM and hybrid families, with GQA or MLA attention and Mamba-1 mixers.
Parameters are a plain dict::

    {"embed": {"embedding", "head" (untied models)},
     "final_norm": {"scale", "bias" (layernorm)},
     "layers": [{"ln1", "mixer": {...}, "ln2", "ffn": {...}}, ...]}

one dict per layer where the reference stacks ``[n_superblocks, ...]``
leaves (and keeps deepseek's leading dense layers apart, under
``prefix``).  The mixer, by ``cfg.mixer_kind(i)``, is GQA ``{wq, wk, wv,
wo, bq, bk, bv (qkv_bias), q_norm, k_norm (qk_norm)}``, MLA ``{w_dkv,
kv_norm, w_uk, w_uv, wo, and w_dq, q_norm, w_uq (q_lora_rank) or wq}`` or
Mamba ``{in_proj, conv_w, conv_b, x_proj, dt_w, dt_b, A_log, D, out_proj}``
(:mod:`repro_torch.models.mamba`); a layer whose ``cfg.ffn_kind(i)`` is
``"none"`` (the SSM family) has no ``ln2`` and no ``ffn``; the FFN dense ``{w_in, w_out}``
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


def _layer_specs(cfg, i: int) -> dict:
    d = cfg.d_model
    if cfg.mixer_kind(i) == "mamba":
        mixer = mamba.mamba_specs(cfg)
    else:
        mixer = _mla_specs(cfg) if cfg.attn_type == "mla" else _gqa_specs(cfg)
    layer = {"ln1": _norm_specs(cfg), "mixer": mixer}
    kind = cfg.ffn_kind(i)
    if kind == "none":
        return layer
    if kind == "moe":
        ffn = _moe_specs(cfg)
    else:
        ffn = {"w_in": ParamSpec((d, _d_in(cfg, cfg.d_ff)), cfg.dtype),
               "w_out": ParamSpec((cfg.d_ff, d), cfg.dtype)}
    return {**layer, "ln2": _norm_specs(cfg), "ffn": ffn}


def specs(cfg) -> dict:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: the port serves the dense, moe, ssm and "
                                  f"hybrid families, not {cfg.family!r}")
    embed = {"embedding": ParamSpec((cfg.vocab_size, cfg.d_model), torch.float32,
                                    "embedding")}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, cfg.vocab_size), cfg.dtype)
    return {
        "embed": embed,
        "final_norm": _norm_specs(cfg),
        "layers": [_layer_specs(cfg, i) for i in range(cfg.n_layers)],
    }


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


def prefill(params, batch: dict, cfg, *, max_len: int, impl=None):
    """Run the prompt, build the decode caches → (last logits [B,1,V] f32,
    per-layer caches: an attention layer's ring is ``min(sliding_window,
    max_len)`` long, a Mamba layer's state O(1)).  ``batch["positions"]``
    (optional [B,S]) marks left-pad tokens with negative positions, which
    attention ignores and a Mamba layer cannot (the engine never pads an
    SSM config's prompts)."""
    x = layers.embed_apply(params["embed"], batch["tokens"], cfg)
    x, caches = stack.stack_apply(params["layers"], x, cfg, mode="prefill",
                                  pos=batch.get("positions"),
                                  cache_len=attention.cache_len_for(cfg, max_len), impl=impl)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logits = layers.logits_apply(params["embed"], x[:, -1:], cfg, impl=impl)
    return logits.to(torch.float32), caches


def decode_step(params, token: torch.Tensor, caches, pos, cfg, *, impl=None):
    """One decode step: ``token [B,S]`` against the caches (updated in
    place) at scalar, per-slot ``[B]`` or per-token ``[B,S]`` positions."""
    pos = attention._decode_positions(pos, token.shape[0], token.shape[1], token.device)
    x = layers.embed_apply(params["embed"], token, cfg)
    x, caches = stack.stack_apply(params["layers"], x, cfg, mode="decode",
                                  caches=caches, pos=pos, impl=impl)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logits = layers.logits_apply(params["embed"], x, cfg, impl=impl)
    return logits.to(torch.float32), caches
