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
across with :mod:`repro_torch.convert`.

Tensor parallelism (``tp``, a :class:`~repro_torch.distributed.mesh.
TensorParallel` on :func:`prefill` / :func:`decode_step` / :func:`forward`
/ :func:`loss_fn`; an int on the shape functions :func:`specs` /
:func:`init_cache`) covers every layer kind, GQA, MLA, MoE, Mamba and
cross-attention (and the encoder), in serving and in training:
``specs(cfg, tp)`` pads the heads (``attention.attn_dims``) and the
vocab (:func:`padded_vocab`) as the reference does, zero rows drawn for the
pad heads' ``wo`` rows and the pad vocab rows (``valid_dim0``), and every
rank runs its shards (:mod:`repro_torch.models.layers` writes the
collectives, autograd-aware, so the same code trains).  The pad logits are
masked to ``NEG_INF``.  A Mamba layer whose ``d_inner`` the model axis does
not divide raises a ``ValueError``, and the einsum MoE dispatch has no
tensor-parallel form (:func:`check_tp`).  The train path takes a mesh too
(:func:`forward`, :func:`loss_fn`): FSDP shards gathered on use, and the
loss's means, a MoE layer's load-balancing loss included, over the global
batch.

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
from repro_torch.sharding import partitioning as P
from repro_torch.sharding.partitioning import pad_dim

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape, dtype, initializer and logical axes of one parameter."""

    shape: tuple
    dtype: Any = torch.bfloat16
    #: normal (fan-in scaled) | embedding (unit) | ones | zeros | ssm_a
    #: (Mamba's A_log: log(1..d_state) over channels) | ssm_dt (Mamba's dt
    #: bias: the softplus-inverse of U[1e-3, 1e-1])
    init: str = "normal"
    #: one logical axis name (or None) a dim, the reference's; the rules of
    #: :mod:`repro_torch.sharding.partitioning` map them to mesh axes
    axes: Optional[tuple] = None
    #: rows (dim 0) at or past this index are drawn as zeros: the pad heads
    #: of ``wo`` and the pad vocab rows of the embedding
    valid_dim0: Optional[int] = None
    #: the last axis holds this many equal fused blocks (SwiGLU's [gate;
    #: up], Mamba's [x; z]): a tensor-parallel shard takes its share of each
    fused: int = 1

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def padded_vocab(cfg, tp: int = 1) -> int:
    """The vocab padded to a multiple of ``tp`` (when it does not divide)."""
    return pad_dim(cfg.vocab_size, tp) if cfg.vocab_size % tp else cfg.vocab_size


def _norm_specs(cfg) -> dict:
    specs = {"scale": ParamSpec((cfg.d_model,), torch.float32, "ones", ("norm",))}
    if cfg.norm == "layernorm":
        specs["bias"] = ParamSpec((cfg.d_model,), torch.float32, "zeros", ("norm",))
    return specs


def _pad_rows(padded: int, real: int) -> Optional[int]:
    return real if padded > real else None


def _gqa_specs(cfg, tp: int = 1) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    hp, kvp, _ = attention.attn_dims(cfg, tp)
    mixer = {
        "wq": ParamSpec((d, hp * dh), cfg.dtype, axes=("embed", "heads")),
        "wk": ParamSpec((d, kvp * dh), cfg.dtype, axes=("embed", "kv_heads")),
        "wv": ParamSpec((d, kvp * dh), cfg.dtype, axes=("embed", "kv_heads")),
        "wo": ParamSpec((hp * dh, d), cfg.dtype, axes=("heads", "embed"),
                        valid_dim0=_pad_rows(hp * dh, cfg.n_heads * dh)),
    }
    if cfg.qkv_bias:
        mixer["bq"] = ParamSpec((hp * dh,), torch.float32, "zeros", ("heads",))
        mixer["bk"] = ParamSpec((kvp * dh,), torch.float32, "zeros", ("kv_heads",))
        mixer["bv"] = ParamSpec((kvp * dh,), torch.float32, "zeros", ("kv_heads",))
    if cfg.qk_norm:
        mixer["q_norm"] = ParamSpec((dh,), torch.float32, "ones", ("head_dim",))
        mixer["k_norm"] = ParamSpec((dh,), torch.float32, "ones", ("head_dim",))
    return mixer


def _mla_specs(cfg, tp: int = 1) -> dict:
    h, d = attention.mla_dims(cfg, tp), cfg.d_model
    dn, dr, dv, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    mixer = {
        "w_dkv": ParamSpec((d, r + dr), cfg.dtype, axes=("embed", "kv_lora")),
        "kv_norm": ParamSpec((r,), torch.float32, "ones", ("norm",)),
        "w_uk": ParamSpec((r, h * dn), cfg.dtype, axes=("kv_lora", "heads")),
        "w_uv": ParamSpec((r, h * dv), cfg.dtype, axes=("kv_lora", "heads")),
        "wo": ParamSpec((h * dv, d), cfg.dtype, axes=("heads", "embed"),
                        valid_dim0=_pad_rows(h * dv, cfg.n_heads * dv)),
    }
    if cfg.q_lora_rank:
        mixer["w_dq"] = ParamSpec((d, cfg.q_lora_rank), cfg.dtype, axes=("embed", "kv_lora"))
        mixer["q_norm"] = ParamSpec((cfg.q_lora_rank,), torch.float32, "ones", ("norm",))
        mixer["w_uq"] = ParamSpec((cfg.q_lora_rank, h * (dn + dr)), cfg.dtype,
                                  axes=("kv_lora", "heads"))
    else:
        mixer["wq"] = ParamSpec((d, h * (dn + dr)), cfg.dtype, axes=("embed", "heads"))
    return mixer


def _d_in(cfg, d_ff: int) -> int:
    return d_ff if cfg.act == "gelu" else 2 * d_ff  # SwiGLU: fused [gate; up]


def _n_fused(cfg) -> int:
    return 1 if cfg.act == "gelu" else 2


def _moe_specs(cfg) -> dict:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    ffn = {
        "router": ParamSpec((d, e), torch.float32, axes=("embed", "expert")),
        "w_in": ParamSpec((e, d, _d_in(cfg, f)), cfg.dtype,
                          axes=("expert", "embed", "moe_mlp"), fused=_n_fused(cfg)),
        "w_out": ParamSpec((e, f, d), cfg.dtype, axes=("expert", "moe_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        ffn["shared_w_in"] = ParamSpec((d, _d_in(cfg, fs)), cfg.dtype, axes=("embed", "mlp"),
                                       fused=_n_fused(cfg))
        ffn["shared_w_out"] = ParamSpec((fs, d), cfg.dtype, axes=("mlp", "embed"))
    return ffn


def _layer_specs(cfg, mixer_kind: str, ffn_kind: str, tp: int = 1) -> dict:
    d = cfg.d_model
    if mixer_kind == "mamba":
        mixer = mamba.mamba_specs(cfg)
    elif mixer_kind == "cross":
        mixer = attention.cross_specs(cfg, tp)
    else:
        mixer = _mla_specs(cfg, tp) if cfg.attn_type == "mla" else _gqa_specs(cfg, tp)
    layer = {"ln1": _norm_specs(cfg), "mixer": mixer}
    if mixer_kind == "attn_cross":
        layer.update(ln_x=_norm_specs(cfg), cross=attention.cross_specs(cfg, tp))
    if ffn_kind == "none":
        return layer
    if ffn_kind == "moe":
        ffn = _moe_specs(cfg)
    else:
        ffn = {"w_in": ParamSpec((d, _d_in(cfg, cfg.d_ff)), cfg.dtype, axes=("embed", "mlp"),
                                 fused=_n_fused(cfg)),
               "w_out": ParamSpec((cfg.d_ff, d), cfg.dtype, axes=("mlp", "embed"))}
    return {**layer, "ln2": _norm_specs(cfg), "ffn": ffn}


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def specs(cfg, tp: int = 1) -> dict:
    """The parameter tree of ``cfg`` at tensor-parallel width ``tp``: heads
    padded as :func:`~repro_torch.models.attention.attn_dims` says and the
    vocab as :func:`padded_vocab`, global shapes (each rank holds the shard
    :mod:`repro_torch.sharding.partitioning` cuts by the leaves' axes)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: the port serves the families {FAMILIES}, "
                                  f"not {cfg.family!r}")
    pv = padded_vocab(cfg, tp)
    embed = {"embedding": ParamSpec((pv, cfg.d_model), torch.float32, "embedding",
                                    ("vocab", "embed"),
                                    valid_dim0=_pad_rows(pv, cfg.vocab_size))}
    if not cfg.tie_embeddings:
        embed["head"] = ParamSpec((cfg.d_model, pv), cfg.dtype, axes=("embed", "vocab"))
    tree = {
        "embed": embed,
        "final_norm": _norm_specs(cfg),
        "layers": [_layer_specs(cfg, cfg.mixer_kind(i), cfg.ffn_kind(i), tp)
                   for i in range(cfg.n_layers)],
    }
    if cfg.is_enc_dec:
        tree["encoder"] = {
            "layers": [_layer_specs(cfg, "attn", "dense", tp)
                       for _ in range(cfg.n_enc_layers)],
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
    if spec.valid_dim0 is not None:
        w[spec.valid_dim0:] = 0.0
    return w.to(spec.dtype)


def draw(cfg, seed: int = 0, device=None,
         leaf: Optional[Callable[[tuple, torch.Tensor], Any]] = None, tp: int = 1) -> dict:
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

    return walk(specs(cfg, tp), ())


def materialize(cfg, seed: int = 0, device=None, tp: int = 1) -> dict:
    """Random parameters of ``specs(cfg, tp)`` from ``seed`` on ``device``
    (default ``"cuda"``)."""
    return draw(cfg, seed, device, tp=tp)


def encode(params, enc_embeds: torch.Tensor, cfg, *, impl=None, tp=None) -> torch.Tensor:
    """The encoder (encoder-decoder only): ``enc_embeds [B, S, D]`` (the
    stub frontend's frames, cast to ``cfg.dtype``) through the
    ``n_enc_layers`` non-causal layers and the encoder's final norm; under
    ``tp`` each layer on the rank's heads and FFN columns, its output whole
    on every rank."""
    x = enc_embeds.to(cfg.dtype)
    for p in params["encoder"]["layers"]:
        x, _, _ = stack.layer_apply(p, x, cfg, mode="encode", impl=impl, tp=tp)
    return layers.norm_apply(params["encoder"]["final_norm"], x, cfg)


def _context(params, batch: dict, cfg, impl=None, tp=None):
    """The context the cross layers attend to: the encoder's output, a VLM's
    patch embeddings, or None."""
    if cfg.is_enc_dec:
        return encode(params, batch["enc_embeds"], cfg, impl=impl, tp=tp)
    if cfg.family == "vlm":
        return batch["ctx_embeds"].to(cfg.dtype)
    return None


def batch_axes(rules) -> tuple:
    """The mesh axes a batch's rows are split over, by ``rules["batch"]``."""
    entry = rules["batch"] if rules is not None else None
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def route_counts(mesh, rules, table=None):
    """The hook through which a MoE layer's load-balancing loss reads the
    top-1 counts of the global batch when ``rules`` split its rows over
    ``mesh``'s batch axes (None otherwise: the rank's rows are the batch):
    ``hook(i, local) -> (counts [E], ways)`` for layer ``i``, the counts
    all-reduced over the batch axes, or with ``table`` (a microbatch's
    global counts a layer, ``[n_layers, E]``, that the train step counted
    beforehand) read from it."""
    axes = batch_axes(rules) if mesh is not None else ()
    ways = math.prod(mesh.size(a) for a in axes) if axes else 1
    if ways == 1:
        return None
    if table is not None:
        return lambda i, local: (table[i], ways)
    return lambda i, local: (mesh.all_reduce_sum(local, axes), ways)


def forward(params, batch: dict, cfg, *, tp=None, rules=None, remat: bool = False, impl=None,
            mesh=None, global_counts=None):
    """The train path's forward: ``batch["tokens"] [B, S]`` (with the
    context, ``ctx_embeds`` or ``enc_embeds``) through every layer with no
    cache → (logits [B, S, V] in ``cfg.dtype``, the summed MoE aux loss).
    ``remat`` recomputes each layer in the backward pass.  Under ``mesh``
    (a :class:`~repro_torch.distributed.mesh.MeshView`) with ``rules``,
    ``params`` are the rank's shards: each layer's are gathered over every
    axis but the model axis when the layer runs (FSDP's gather on use, again
    in remat's recompute), the rest once; under ``tp`` each rank runs its
    model shards and every rank gets the whole logits.  ``global_counts``
    (:func:`route_counts`) makes the aux loss the rank's share of the
    global batch's."""
    check_tp(cfg, tp)
    gather = None
    if mesh is not None and rules is not None:
        spec = specs(cfg, 1 if tp is None else tp.size)
        top = [k for k in params if k != "layers"]
        params = dict(params, **P.gather_on_use({k: params[k] for k in top},
                                                {k: spec[k] for k in top}, mesh, rules))

        def gather(i, p):
            return P.gather_on_use(p, spec["layers"][i], mesh, rules)

    ctx = _context(params, batch, cfg, impl=impl, tp=tp)
    x = layers.embed_apply(params["embed"], batch["tokens"], cfg, tp=tp)
    x, _, aux = stack.stack_apply(params["layers"], x, cfg, mode="train", ctx=ctx, impl=impl,
                                  remat=remat, tp=tp, gather=gather,
                                  global_counts=global_counts)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    return layers.logits_apply(params["embed"], x, cfg, impl=impl, tp=tp), aux


def loss_fn(params, batch: dict, cfg, *, tp=None, rules=None, remat: bool = False,
            aux_weight: float = 0.01, z_weight: float = 1e-4, impl=None, mesh=None,
            denom=None, counts=None):
    """Next-token cross entropy over the positions whose ``batch["labels"]``
    are >= 0, plus ``aux_weight`` · the MoE aux loss and ``z_weight`` · the
    z-loss (the mean squared log-partition) → (loss, {"ce", "aux", "z",
    "tokens"}).  The pad logits (vocab padding at ``tp``) are masked.

    The means are the global batch's, ``sum(nll · mask) / max(sum(mask),
    1)``: under ``mesh`` with ``rules`` the rank holds its rows, divides its
    sums by the token count all-reduced over the batch axes (or by
    ``denom``, a microbatch's global count), and returns its share of ``ce``,
    ``aux``, ``z`` and the loss, whose sum over the batch axes is the global
    value (so the gradients are summed over them, not averaged); the MoE
    layers' top-1 counts are the global batch's, all-reduced, or a
    microbatch's from ``counts`` (:func:`route_counts`); ``tokens`` is the
    global count."""
    logits, aux = forward(params, batch, cfg, tp=tp, rules=rules, remat=remat, impl=impl,
                          mesh=mesh, global_counts=route_counts(mesh, rules, counts))
    logits = mask_pad_vocab(logits.to(torch.float32), cfg)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).to(torch.int64)[..., None])[..., 0]
    tokens = mask.sum()
    if denom is None:
        denom = tokens if mesh is None else mesh.all_reduce_sum(tokens.detach().clone(),
                                                                batch_axes(rules))
    tokens = denom
    denom = torch.clamp_min(denom, 1.0)
    ce = ((lse - ll) * mask).sum() / denom
    z = (torch.square(lse) * mask).sum() / denom
    total = ce + aux_weight * aux + z_weight * z
    return total, {"ce": ce, "aux": aux, "z": z, "tokens": tokens}


NEG_INF = attention.NEG_INF


def mask_pad_vocab(logits: torch.Tensor, cfg) -> torch.Tensor:
    """``NEG_INF`` at the pad logits past ``cfg.vocab_size``, so padding is
    numerically invisible to a softmax or an argmax."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    iota = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(iota < cfg.vocab_size, logits, NEG_INF)


def check_tp(cfg, tp) -> None:
    """Raise unless ``cfg`` serves and trains at ``tp``'s width: GQA, MLA,
    Mamba (its ``d_inner`` divided by the model axis, else a
    ``ValueError``) and cross-attention layers with a dense FFN, a
    sort-dispatch MoE one or none; or one device."""
    if tp is None or tp.size == 1:
        return
    kinds = {cfg.mixer_kind(i) for i in range(cfg.n_layers)}
    moe_layers = any(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))
    if "mamba" in kinds:
        mamba.inner_per_rank(cfg, tp.size)
    if moe_layers and cfg.moe_impl == "einsum":
        raise NotImplementedError(f"{cfg.name}: the einsum MoE dispatch has no tensor-parallel "
                                  "form; serve it with moe_impl='sort'")


def prefill(params, batch: dict, cfg, *, max_len: int, impl=None, tp=None):
    """Run the prompt, build the decode caches → (last logits [B,1,V] f32,
    per-layer caches: an attention layer's ring is ``min(sliding_window,
    max_len)`` long, a Mamba layer's state O(1), a cross layer's the
    projected context).  ``batch["positions"]`` (optional [B,S]) marks
    left-pad tokens with negative positions, which attention ignores and a
    Mamba layer cannot (the engine never pads an SSM config's prompts);
    ``batch["ctx_embeds"]`` (VLM) or ``batch["enc_embeds"]``
    (encoder-decoder) carries the context.  Under ``tp`` each rank runs its
    shards (the encoder's too) and every rank gets the whole logits."""
    check_tp(cfg, tp)
    ctx = _context(params, batch, cfg, impl=impl, tp=tp)
    x = layers.embed_apply(params["embed"], batch["tokens"], cfg, tp=tp)
    x, caches, _ = stack.stack_apply(params["layers"], x, cfg, mode="prefill",
                                     pos=batch.get("positions"),
                                     cache_len=attention.cache_len_for(cfg, max_len), ctx=ctx,
                                     impl=impl, tp=tp)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logits = layers.logits_apply(params["embed"], x[:, -1:], cfg, impl=impl, tp=tp)
    return mask_pad_vocab(logits.to(torch.float32), cfg), caches


def init_cache(cfg, batch: int, max_len: int, *, device=None, tp: int = 1,
               local: bool = True) -> list:
    """The decode caches of ``batch`` slots, one per layer in the layout
    :func:`prefill` returns (a ring of ``attention.cache_len_for(cfg,
    max_len)`` positions, rounded to whole pages by a paged format; a
    Mamba state; a cross layer's context K/V), zero, on ``device`` (default
    ``"cuda"``).  ``device="meta"`` gives the abstract cache the dry run
    counts; its bytes equal the reference's stacked ``init_cache``.  At
    ``tp`` ways an attention ring and a context's K/V hold one rank's KV
    heads and a Mamba state its channels, or with ``local=False`` all of
    them (the global cache)."""
    cache_len = attention.cache_len_for(cfg, max_len)
    return [stack.init_layer_cache(cfg, cfg.mixer_kind(i), batch, cache_len, device=device,
                                   tp=tp, local=local)
            for i in range(cfg.n_layers)]


def decode_step(params, token: torch.Tensor, caches, pos, cfg, *, impl=None, tp=None,
                mesh=None, rules=None):
    """One decode step: ``token [B,S]`` against the caches (updated in
    place) at scalar, per-slot ``[B]`` or per-token ``[B,S]`` positions.
    Cross-attention reads its context from the caches.  ``tp`` as for
    :func:`prefill`.  Under ``rules`` whose ``kv_seq`` names axes of
    ``mesh`` (a :class:`~repro_torch.distributed.mesh.MeshView`) above one
    way (the reference's ``plan`` for a long-context decode), each
    attention ring of ``caches`` (GQA's or MLA's; a paged format's block of
    the pool's pages) is this rank's block of the ring
    (:func:`repro_torch.sharding.partitioning.shard_caches`), a cross
    layer's context is whole, the batch is every rank's, and the blocks are
    combined over those axes
    (:func:`repro_torch.models.attention.combine_blocks`)."""
    check_tp(cfg, tp)
    seq = attention.seq_parallel(mesh, rules)
    pos = attention._decode_positions(pos, token.shape[0], token.shape[1], token.device)
    x = layers.embed_apply(params["embed"], token, cfg, tp=tp)
    x, caches, _ = stack.stack_apply(params["layers"], x, cfg, mode="decode",
                                     caches=caches, pos=pos, impl=impl, tp=tp, seq=seq)
    x = layers.norm_apply(params["final_norm"], x, cfg)
    logits = layers.logits_apply(params["embed"], x, cfg, impl=impl, tp=tp)
    return mask_pad_vocab(logits.to(torch.float32), cfg), caches
