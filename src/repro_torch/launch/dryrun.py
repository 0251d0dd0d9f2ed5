"""Dry run: what a cell needs on a card of a mesh, from shapes alone.

Counterpart of :mod:`repro.launch.dryrun`.  For every (arch × shape) cell
it builds the cell's weights, caches and batch as ``meta`` tensors (shapes
and dtypes, no storage) through the same code the serving and training
paths run (each residency format's ``abstract_state``,
``model.init_cache``, ``model.specs(cfg, tp)`` with its padded heads and
vocab), and reckons from them:

* the resident bytes of a residency policy (:func:`analytic_weight_bytes`)
  and of a decode cache (:func:`analytic_cache_bytes`), byte for byte what
  ``ServeEngine.resident_bytes()`` counts on one card;
* parameter counts and model FLOPs (:func:`param_counts`,
  :func:`model_flops`), the minimum HBM traffic of a step
  (:func:`analytic_traffic`) and the H100 roofline over them
  (:func:`repro_torch.launch.hlo_stats.roofline_terms`);
* the serving model: the registered schedulers replayed over a synthetic
  mixed-length trace at the traffic's costs (:func:`analytic_serving`);
* a rank's resident bytes under a plan's rules (:func:`rank_bytes`): the
  weights of a serve cell and its decode cache, a train cell's parameters,
  gradients and moments, the batch;
* the collectives a step issues on one rank (:func:`call_collectives` for a
  serving model call, :func:`train_step_collectives` for a train step),
  written from the code paths that issue them, as
  :class:`~repro_torch.distributed.mesh.CollectiveEvent` records that
  ``hlo_stats.collective_stats`` turns into per-kind counts and wire bytes.

Every function takes the reference's ``tp`` (and, where the reference
does, ``mesh_axes`` and ``rules``); their defaults are one card.
:func:`lower_cell` puts it together for one cell on a stand-in mesh of the
reference's shapes (16 × 16, 2 × 16 × 16, or ``mesh_shape``): no process
group and no device, since :func:`repro_torch.launch.mesh.plan` reads only
the axis names and shape.  :func:`analyze_cell` adds the reference's probe
correction and the roofline.

It runs no kernel and never executes the model: the ring write and MoE
dispatch select by data (``nonzero``), which the meta device cannot do.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun_torch
    python -m repro_torch.launch.dryrun --arch jamba-1.5-large-398b --shape decode_32k \\
        --mesh-shape 1 4
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core import kvcache, residency
from repro_torch.distributed.mesh import CollectiveEvent, TensorParallel
from repro_torch.launch import hlo_stats
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_lib
from repro_torch.optim import adamw as optim_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve.engine import QUANTIZABLE_KEYS
from repro_torch.sharding import partitioning as P

DECODE_HORIZON = 64  # decode cells: cache covers seq_len + a small horizon
#: the train cell's optimizer moments (the reference's train cell's)
TRAIN_MOMENTS = "bf16"
_META = torch.device("meta")


@functools.lru_cache(maxsize=128)
def _specs(cfg: ModelConfig, tp: int) -> dict:
    """``model.specs(cfg, tp)``, built once a (config, width); read only."""
    return model_lib.specs(cfg, tp)


def _meta(spec: model_lib.ParamSpec) -> torch.Tensor:
    return torch.empty(tuple(spec.shape), dtype=spec.dtype, device=_META)


def _nbytes(leaf) -> int:
    """Bytes of a meta or real tensor, or of a residency state."""
    if isinstance(leaf, residency.QuantLinearState):
        return residency.resident_bytes(leaf)
    return residency._nbytes(leaf)


def _tree_bytes(tree) -> int:
    return sum(_nbytes(leaf) for leaf in tree_lib.leaves(tree))


@functools.lru_cache(maxsize=None)
def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype, device=_META).element_size()


def _walk(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (``path`` the
    tuple of keys, a list item's its index as a string), keeping its
    structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _sizes(mesh_axes) -> dict:
    """The canonical axes' sizes of ``mesh_axes`` (absent ones 1)."""
    return P.shard_info(mesh_axes or {})


def _data_ways(mesh_axes) -> int:
    sizes = _sizes(mesh_axes)
    return sizes["pod"] * sizes["data"]


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The cell's batch as meta tensors: ``tokens`` (``labels`` too for a
    train cell) and the context a VLM or an encoder-decoder takes."""
    b, s = cell.global_batch, cell.seq_len
    out = {"tokens": torch.empty((b, s), dtype=torch.int32, device=_META)}
    if cell.kind == "train":
        out["labels"] = torch.empty((b, s), dtype=torch.int32, device=_META)
    ctx = (b, cfg.encoder_tokens, cfg.d_model)
    if cfg.is_enc_dec:
        out["enc_embeds"] = torch.empty(ctx, dtype=torch.float32, device=_META)
    if cfg.family == "vlm":
        out["ctx_embeds"] = torch.empty(ctx, dtype=torch.float32, device=_META)
    return out


# ---------------------------------------------------------------------------
# Quantized-residency abstraction (serve cells, --qmode)
# ---------------------------------------------------------------------------


def _quantizable(path: tuple, spec) -> bool:
    return bool(path) and path[-1] in QUANTIZABLE_KEYS and len(spec.shape) >= 2


def abstract_quant(spec_tree, spec, *, min_dim: int = 64):
    """Residency-convert a ParamSpec tree without materializing a weight.

    ``spec`` is any :meth:`ResidencySpec.parse` form.  Mirrors
    ``serve.engine.convert_params`` leaf for leaf: the same dot-joined
    paths (``layers.3.ffn.w_in``) are policy-matched, the same ``min_dim``
    floor leaves small projections float, and each selected format's
    ``abstract_state`` supplies the payload's shapes and dtypes (a stacked
    expert weight ``[E, K, N]`` one state with ``data [E, ...]``, ``scale
    [E, 1, N]``, as ``residency.from_float`` builds it).  Leaves that stay
    float stay ParamSpecs.
    """
    spec = residency.ResidencySpec.parse(spec)

    def leaf(path, s):
        if _quantizable(path, s):
            return _quant_leaf(s, spec.mode_for(".".join(path)), min_dim)
        return s

    return _walk(spec_tree, leaf)


def _quant_leaf(spec, mode: str, min_dim: int):
    fmt = residency.get_format(mode)
    if fmt.keeps_float_params:  # convert_params leaves these as plain floats
        return spec
    if min(spec.shape[-2:]) < min_dim:  # convert_params min_dim floor
        return spec
    *lead, k, n = spec.shape
    st = fmt.abstract_state(k, n)
    if not lead:
        return st
    lead = tuple(lead)
    return residency.QuantLinearState(
        data=torch.empty(lead + tuple(st.data.shape), dtype=st.data.dtype, device=_META),
        scale=torch.empty(lead + tuple(st.scale.shape), dtype=st.scale.dtype, device=_META),
        mode=mode, k=k, n=n)


def serve_params_meta(cfg: ModelConfig, spec, *, min_dim: int = 64, tp: int = 1,
                      rules=None):
    """The converted parameter tree of residency policy ``spec`` at
    ``specs(cfg, tp)``'s global shapes, every leaf a meta tensor or a meta
    residency state: what :mod:`repro_torch.sharding.partitioning` cuts
    into each rank's shards.  With ``rules`` (the reference's
    ``_serve_params`` takes them too) it returns the pair (meta tree, each
    leaf's partition entries, :func:`P.leaf_entries`)."""
    tree = _serve_meta(cfg, residency.ResidencySpec.parse(spec).describe(), min_dim, tp)
    if rules is None:
        return tree
    return tree, P.map_specs(tree, _specs(cfg, tp),
                             lambda leaf, s: P.leaf_entries(leaf, s, rules))


@functools.lru_cache(maxsize=128)
def _serve_meta(cfg: ModelConfig, spec: str, min_dim: int, tp: int):
    """:func:`serve_params_meta`'s tree, built once a (config, policy,
    floor, width); read only."""
    qtree = abstract_quant(_specs(cfg, tp), spec, min_dim=min_dim)
    return _walk(qtree, lambda path, s: _meta(s) if isinstance(s, model_lib.ParamSpec) else s)


# ---------------------------------------------------------------------------
# Analytic parameter / model-flops accounting
# ---------------------------------------------------------------------------


def param_counts(cfg: ModelConfig, tp: int = 1) -> dict:
    """(total, active, embedding) parameter counts from ``specs(cfg, tp)``
    (padded heads and vocab); a leaf on the ``"expert"`` axis (a MoE
    layer's ``router``, ``w_in`` and ``w_out``, not its shared expert)
    counts ``experts_per_tok / n_experts`` of its elements active."""
    return _counts(cfg, tp, None, None)


def _counts(cfg: ModelConfig, tp: int, rules, sizes, encoder: bool = True) -> dict:
    """:func:`param_counts`, each leaf's elements a rank's shard of it
    under ``rules`` over ``sizes`` when given; without the encoder's
    leaves unless ``encoder``."""
    total = active = embed = 0
    k_over_e = cfg.experts_per_tok / cfg.n_experts if cfg.n_experts else 1.0
    for path, s in tree_lib.flatten(_specs(cfg, tp)):
        if not encoder and path[0] == "encoder":
            continue
        shape = s.shape if rules is None else _local_shape(s.shape, P.spec_for(s.axes, rules),
                                                            sizes)[0]
        n = math.prod(shape)
        total += n
        if "embedding" in path:
            embed += n
        elif "expert" in s.axes:
            active += n * k_over_e
        else:
            active += n
    return {"total": total, "active": active, "embedding": embed}


def model_flops(cfg: ModelConfig, cell: ShapeCell, tp: int = 1) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (serve),
    N_active over ``specs(cfg, tp)``."""
    pc = param_counts(cfg, tp)
    n = pc["active"] - pc["embedding"]
    if cell.kind == "decode":
        return 2.0 * n * cell.global_batch  # one token per sequence
    return (6.0 if cell.kind == "train" else 2.0) * n * cell.global_batch * cell.seq_len


def residency_qbytes(cfg: ModelConfig, spec, *, tp: int = 1, min_dim: int = 64) -> float:
    """Resident weight bytes per quantizable parameter element of
    ``specs(cfg, tp)``, from the format registry: byte-counts the tree
    :func:`abstract_quant` produces (quantized leaves their payload without
    scales, leaves that stay float their spec dtype) over the quantizable
    leaves' elements."""
    spec_tree = _specs(cfg, tp)
    converted = dict(tree_lib.flatten(abstract_quant(spec_tree, spec, min_dim=min_dim)))
    elems = qbytes_sum = 0.0
    for path, s in tree_lib.flatten(spec_tree):
        if not _quantizable(path, s):
            continue
        elems += math.prod(s.shape)
        conv = converted[path]
        qbytes_sum += _nbytes(conv.data if isinstance(conv, residency.QuantLinearState)
                              else _meta(conv))
    return qbytes_sum / max(elems, 1.0)


def analytic_traffic(cfg: ModelConfig, cell: ShapeCell, qmode, min_dim: int = 64, *,
                     tp: int = 1, mesh_axes: Optional[dict] = None, mb: int = 1,
                     weight_bytes: Optional[float] = None, encoder: bool = True) -> dict:
    """Minimum HBM traffic of one step on one device of a ``tp``-way model
    axis in a mesh of ``mesh_axes`` (fusion-ideal; ``mb`` is the
    reference's argument and changes nothing).  ``weight_bytes`` replaces
    the device's resident weight bytes (the reference's parameter count ×
    bytes a parameter ÷ ``tp``), and ``encoder=False`` leaves the encoder's
    layers out of the activations, as :func:`lower_cell` counts a rank.

    Weights stream from HBM once per use (the device's ``1/tp`` of them),
    activations make one round trip per layer boundary (``act_round`` of
    them) for the device's share of the tokens (the cell's over the
    ``pod`` × ``data`` ways), caches are read once per decode step
    (:func:`_cache_bytes_local`).  A train step reads bf16 weights three
    times (forward, remat, backward), writes and reads f32 gradients and
    reads and writes the moments, FSDP-sharded over the data ways; a serve
    cell's weights are the policy's resident bytes a parameter
    (:func:`residency_qbytes`).  Real steps sit above this.
    """
    del mb
    dways = _data_ways(mesh_axes)
    w = weight_bytes  # resident weight bytes a forward pass must read
    if w is None:
        wq = 2.0 if cell.kind == "train" else residency_qbytes(cfg, qmode, tp=tp,
                                                               min_dim=min_dim)
        w = param_counts(cfg, tp)["total"] * wq / tp
    act_round = 8  # residual/norm/proj round-trips per layer boundary
    d = cfg.d_model
    n_layers = cfg.n_layers + ((cfg.n_enc_layers or 0) if encoder else 0)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len / dways
        weight_traffic = 3 * w + 2 * (2 * w) + 4 * w / max(dways, 1)
        act_traffic = tokens * d * 2 * n_layers * act_round * 3  # fwd+bwd+remat
        kv_traffic = 0.0
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len / dways
        weight_traffic = w
        act_traffic = tokens * d * 2 * n_layers * act_round
        kv_traffic = tokens * d * 2  # cache write
    else:  # decode: weights dominate
        tokens = max(cell.global_batch / dways, 1.0)
        weight_traffic = w  # every resident weight read once per step
        act_traffic = tokens * d * 2 * n_layers * act_round
        kv_traffic = _cache_bytes_local(cfg, cell, tp=tp, mesh_axes=mesh_axes)
    return {
        "weight_traffic": weight_traffic,
        "act_traffic": act_traffic,
        "cache_traffic": kv_traffic,
        "total": weight_traffic + act_traffic + kv_traffic,
    }


#: synthetic mixed-length arrival trace for the analytic serving model:
#: (arrival_s, prompt_tokens_frac_of_seq_len, max_new) — one long prompt
#: co-arriving with short interactive traffic
_SERVE_TRACE = (
    (0.0, 1.00, 16), (0.0, 0.06, 16), (0.0, 0.08, 16), (0.0, 0.04, 16),
    (0.0, 0.05, 16), (0.0, 0.07, 16), (0.0, 0.06, 16), (0.0, 0.05, 16),
)


def analytic_serving(cfg: ModelConfig, cell: ShapeCell, qmode, *, tp: int = 1,
                     mesh_axes: Optional[dict] = None, min_dim: int = 64, slots: int = 4,
                     scheduler: Optional[str] = None) -> dict:
    """Scheduler-aware analytic serving model for a decode cell on one
    device of the mesh.

    Replays :data:`_SERVE_TRACE` through the registered schedulers
    (:func:`repro_torch.serve.scheduler.simulate`) under a two-term cost
    model from the traffic terms: every model call reads the device's
    resident weights and cache once (``t_call``), and each position adds
    its activation traffic (``t_token``), both at the card's HBM rate.
    """
    traffic = analytic_traffic(cfg, cell, qmode, min_dim=min_dim, tp=tp, mesh_axes=mesh_axes)
    bw = hlo_stats.HW["hbm_bw"]
    t_call = (traffic["weight_traffic"] + traffic["cache_traffic"]) / bw
    tokens = max(cell.global_batch / _data_ways(mesh_axes), 1.0)
    t_token = traffic["act_traffic"] / bw / tokens
    trace = [(a, max(int(f * cell.seq_len), 1), m) for a, f, m in _SERVE_TRACE]
    names = [scheduler] if scheduler else list(sched_lib.schedulers())
    out = {}
    for name in names:
        st = sched_lib.simulate(name, trace, slots=slots, t_call=t_call, t_token=t_token,
                                max_len=cell.seq_len + DECODE_HORIZON)
        out[st.scheduler] = st.summary()
    return dict(t_call_s=t_call, t_token_s=t_token, slots=slots,
                trace=[list(t) for t in trace], schedulers=out)


# ---------------------------------------------------------------------------
# Resident bytes: weights and decode caches
# ---------------------------------------------------------------------------


def _channel_bytes(fmt, eff_len: int, lead, feat, dtype=None) -> int:
    """One cache channel's bytes over ``eff_len`` resident positions of one
    slot: ``resident_bytes(abstract_state(1, eff_len, ...))``, the ring for
    a contiguous format, whole pages (per-page scales included) plus the
    int32 block table for a paged one, as the engine's pool allocates."""
    kw = {} if dtype is None else {"dtype": dtype}
    return fmt.resident_bytes(fmt.abstract_state(1, eff_len, lead, feat, **kw))


def analytic_cache_bytes(cfg, batch: int, cache_len: int, *, tp: int = 1) -> int:
    """Decode-cache bytes of a ``batch``-slot serving engine whose rings
    hold ``cache_len`` positions, over the KV heads padded for a ``tp``-way
    model axis (the global cache: every rank's together): each format
    channel through :func:`_channel_bytes`, ``pos_ids`` and MLA's float
    rope ring at the format's ``slot_capacity``.  Byte for byte
    ``ServeEngine.resident_bytes()["cache"]`` of an attention config on
    one card.  It counts attention layers only (an ``attn_cross`` layer's
    self-attention ring, not its context K/V) and raises on any other; the
    ring length is the caller's (a sliding window's ring is ``min(window,
    max_len)``).
    """
    fmt = kvcache.format_for(cfg)
    ring = fmt.slot_capacity(cache_len)
    itemsize = _itemsize(cfg.dtype)
    total = 0
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) not in ("attn", "attn_cross"):
            raise NotImplementedError(
                f"analytic_cache_bytes covers attention layers only; layer "
                f"{i} is {cfg.mixer_kind(i)!r}")
        if cfg.attn_type == "mla":
            total += _channel_bytes(fmt, cache_len, (), cfg.kv_lora_rank, cfg.dtype) * batch
            total += batch * ring * cfg.qk_rope_dim * itemsize  # float rope ring
        else:
            _, kvp, _ = attention.attn_dims(cfg, tp)
            total += _channel_bytes(fmt, cache_len, (kvp,), cfg.d_head, cfg.dtype) * 2 * batch
        total += batch * ring * 4  # pos_ids, int32
    return total


def analytic_weight_bytes(cfg, spec, *, tp: int = 1, min_dim: int = 64, rules=None) -> int:
    """Resident weight bytes of one residency policy at ``specs(cfg, tp)``'s
    global shapes, with no weights: the bytes of :func:`serve_params_meta`'s
    meta tree, byte for byte ``ServeEngine.resident_bytes()["weights"]``
    for the same ``(cfg, spec, min_dim)`` on one card.  ``rules`` (the
    reference's argument) change no byte: a rank's share is
    :func:`rank_bytes`'."""
    del rules
    return _tree_bytes(serve_params_meta(cfg, spec, min_dim=min_dim, tp=tp))


def _cache_bytes_local(cfg, cell, *, tp: int = 1, mesh_axes: Optional[dict] = None) -> float:
    """Decode-cache bytes a step reads on one device, from the cache-format
    registry: each attention channel's :func:`_channel_bytes` over the
    cell's ``seq_len`` (a sliding window's at most), split over the KV
    heads where they shard; MLA's latent and bf16 rope key whole; a Mamba
    layer's float32 state split ``tp`` ways; the slots over the data ways.
    Paged formats charge whole pages and tables."""
    dways = _data_ways(mesh_axes)
    s = cell.seq_len
    b = cell.global_batch
    fmt = kvcache.format_for(cfg)
    per_layer = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.mixer_kind(i)
        if kind in ("attn", "attn_cross"):
            if cfg.attn_type == "mla":
                per_layer += (_channel_bytes(fmt, s, (), cfg.kv_lora_rank)
                              + s * cfg.qk_rope_dim * 2)  # rope key stays bf16
            else:
                _, kvp, shard_kv = attention.attn_dims(cfg, tp)
                eff = min(s, cfg.sliding_window or s)
                width = _channel_bytes(fmt, eff, (kvp,), cfg.d_head) * 2
                per_layer += width / (tp if shard_kv else 1)
        elif kind == "mamba":
            per_layer += cfg.d_inner * cfg.d_state * 4 / tp
    return b * per_layer / min(b if b else 1, dways) if b else per_layer


def _moment_leaves(cfg, tp: int):
    """The reference's layout of ``specs(cfg, tp)``: (ParamSpec pieces, the
    leaf's global element count) a leaf, in the optimizer's order."""
    out = []
    for leaf in tree_lib.leaves(convert.reference_layout(_specs(cfg, tp), cfg)):
        pieces = tuple(leaf) if isinstance(leaf, convert.Stacked) else (leaf,)
        out.append((pieces, sum(math.prod(p.shape) for p in pieces)))
    return out


def train_state_bytes(cfg, *, tp: int = 1, rules=None, sizes: Optional[dict] = None,
                      moments: str = TRAIN_MOMENTS) -> dict:
    """Bytes of a train step's state on one device: the float parameters,
    their float32 gradients and AdamW's two ``moments`` moments over the
    reference's layout (the optimizer's leaves: a stacked leaf's pieces
    under one moment, as ``init_abstract`` of the reference's tree),
    with its step counter.  With ``rules`` and ``sizes`` each leaf is the
    largest rank's shard of ``specs(cfg, tp)`` (an int8 moment keeps every
    chunk's scale of its leaf, as the port's sharded update does)."""
    total_p = n_local = 0
    for _, s in tree_lib.flatten(_specs(cfg, tp)):
        shape = _shard_shape(s, rules, sizes)
        total_p += math.prod(shape) * _itemsize(s.dtype)
        n_local += math.prod(shape)
    mom = 0
    for pieces, numel in _moment_leaves(cfg, tp):
        local = sum(math.prod(_shard_shape(p, rules, sizes)) for p in pieces)
        if moments == "int8":
            mom += local + -(-numel // optim_lib._CHUNK) * 4  # codes, every chunk's scale
        else:
            mom += local * (4 if moments == "f32" else 2) + 4  # payload, the dummy scale
    return {"params": total_p, "grads": 4 * n_local, "moments": 2 * mom + 4}


# ---------------------------------------------------------------------------
# A rank's bytes
# ---------------------------------------------------------------------------


def _parts(entry, sizes: dict) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(sizes.get(n, 1) for n in names)


def _local_shape(shape, entries, sizes: dict) -> tuple[tuple, bool]:
    """(the largest rank's shard shape, whether every rank's is that one)."""
    out, even = [], True
    for n, entry in zip(shape, entries):
        p = _parts(entry, sizes)
        out.append(-(-n // p))
        even = even and n % p == 0
    return tuple(out), even


def _shard_shape(spec, rules, sizes) -> tuple:
    if rules is None or sizes is None:
        return tuple(spec.shape)
    return _local_shape(spec.shape, P.spec_for(spec.axes, rules), sizes)[0]


def _leaf_local_bytes(leaf, entries: dict, sizes: dict) -> tuple[int, bool]:
    """A rank's bytes of one meta leaf (a tensor or a residency state) cut by
    its :func:`P.leaf_entries`."""
    parts = ((leaf.data, entries["data"]), (leaf.scale, entries["scale"])) \
        if isinstance(leaf, residency.QuantLinearState) else ((leaf, entries[""]),)
    total, even = 0, True
    for t, entry in parts:
        shape, ok = _local_shape(t.shape, entry, sizes)
        total += math.prod(shape) * t.element_size()
        even = even and ok
    return total, even


def _cache_local_bytes(caches, entries, sizes: dict) -> tuple[int, bool]:
    if isinstance(caches, dict):
        parts = [_cache_local_bytes(v, entries[k], sizes) for k, v in caches.items()]
    elif isinstance(caches, list):
        parts = [_cache_local_bytes(v, e, sizes) for v, e in zip(caches, entries)]
    else:
        shape, even = _local_shape(caches.shape, entries or (None,) * caches.ndim, sizes)
        return math.prod(shape) * caches.element_size(), even
    return sum(p[0] for p in parts), all(p[1] for p in parts)


def serve_rules(cfg, mesh_axes: Optional[dict] = None) -> dict:
    """The serving engine's default rules at a mesh of ``mesh_axes``: the
    heads, FFN and vocab over ``model``, the KV heads where
    ``attn_dims`` shards them, the experts where they divide the model axis
    (else their hidden width), the slots over the data axes."""
    sizes = _sizes(mesh_axes)
    tp = sizes["model"]
    return P.base_rules(data_axes=tuple(a for a in ("pod", "data") if a in (mesh_axes or {}))
                        or ("data",),
                        shard_kv_heads=attention.attn_dims(cfg, tp)[2],
                        shard_experts=bool(cfg.n_experts) and cfg.n_experts % tp == 0)


def train_rules(mesh_axes: Optional[dict] = None) -> dict:
    """A train step's default rules at a mesh of ``mesh_axes``, as
    ``trainstep.train_mesh`` takes them: ``base_rules(fsdp=True)`` over the
    mesh's batch axes."""
    return P.base_rules(fsdp=True, data_axes=tuple(a for a in ("pod", "data")
                                                   if a in (mesh_axes or {})))


def rank_bytes(cfg, kind: str, *, mesh_axes: Optional[dict] = None, rules=None,
               qmode="bf16", min_dim: int = 64, batch: int = 1, seq_len: int = 1,
               cache_len: Optional[int] = None, moments: str = TRAIN_MOMENTS) -> dict:
    """A rank's resident bytes of a ``kind`` cell (``"decode"``, ``"prefill"``
    or ``"train"``) over a mesh of ``mesh_axes`` (its model axis the
    tensor-parallel width) under ``rules`` (default :func:`serve_rules`, or
    :func:`train_rules` for a train cell),
    from the meta trees cut by the rules' partition entries:

    * ``weights``: a serve cell's converted weights under ``qmode``
      (:func:`serve_params_meta` at ``specs(cfg, tp)``, each leaf's data
      and scale by its format's axes);
    * ``cache``: a decode cell's cache of ``batch`` slots and ``cache_len``
      positions (``model.init_cache(..., local=False)``, each leaf by
      ``P.cache_pspecs``; every mixer kind);
    * ``params``, ``grads``, ``moments``: a train cell's state
      (:func:`train_state_bytes` at the rank's shards);
    * ``batch``: the rank's rows of :func:`batch_specs` (``batch`` rows of
      ``seq_len`` tokens over the rules' batch axes).

    Where shards are uneven it counts the largest rank, and ``even`` says
    so; ``total`` sums the rest."""
    sizes = _sizes(mesh_axes)
    tp = sizes["model"]
    if rules is None:
        rules = train_rules(mesh_axes) if kind == "train" else serve_rules(cfg, mesh_axes)
    out: dict = {}
    even = True
    if kind == "train":
        out.update(train_state_bytes(cfg, tp=tp, rules=rules, sizes=sizes, moments=moments))
        for _, s in tree_lib.flatten(_specs(cfg, tp)):
            even = even and _local_shape(s.shape, P.spec_for(s.axes, rules), sizes)[1]
    else:
        weights = _weight_shards(cfg, qmode, min_dim, tp, rules, sizes)
        out["weights"] = sum(w for w, _ in weights)
        even = all(ok for _, ok in weights)
    if kind == "decode":
        caches = model_lib.init_cache(cfg, batch, cache_len or seq_len + DECODE_HORIZON,
                                      device=_META, tp=tp, local=False)
        cache_entries = P.cache_pspecs(caches, rules, attention.attn_dims(cfg, tp)[2], cfg)
        out["cache"], ok = _cache_local_bytes(caches, cache_entries, sizes)
        even = even and ok
    rows_entry = P.spec_for(("batch",), rules)
    rows, ok = _local_shape((batch,), rows_entry, sizes)
    cell = ShapeCell(kind, seq_len, rows[0], kind)
    out["batch"] = _tree_bytes(batch_specs(cfg, cell))
    out["total"] = sum(out.values())
    out["even"] = even and ok
    return out


def _weight_shards(cfg, qmode, min_dim: int, tp: int, rules, sizes: dict,
                   encoder: bool = True) -> list:
    """(a rank's bytes, evenly cut) of every converted weight leaf (but the
    encoder's, unless ``encoder``)."""
    out: list = []
    tree, entries = serve_params_meta(cfg, qmode, min_dim=min_dim, tp=tp, rules=rules)
    if not encoder:
        tree, entries = ({k: v for k, v in t.items() if k != "encoder"} for t in (tree, entries))
    P.map_specs(tree, entries, lambda leaf, e: out.append(_leaf_local_bytes(leaf, e, sizes)))
    return out


# ---------------------------------------------------------------------------
# The collectives a step issues
# ---------------------------------------------------------------------------


def _act_bits(fmt) -> Optional[int]:
    """The activation bits a format's row-parallel apply quantizes to: the
    row's max-abs is MAX-reduced over the model axis first
    (``residency.row_parallel_acts``); None for float activations."""
    if isinstance(fmt, residency.PackedInt4Format):
        return 8
    return getattr(fmt, "act_bits", None)


def _row_parallel(leaf, spec, rules, sizes, m: int, n: int, act: int, e: int = 0) -> list:
    """The collectives of ``layers.row_parallel`` (``e`` 0) or
    ``row_parallel_stacked`` (``e`` experts) on ``m`` rows a projection of
    the rank's ``K / tp`` features to ``n``: a residency state whose
    payload keeps every K on every rank (bit-plane) all-gathers its input
    (``act`` bytes an element); ``w8a16`` and a float weight all-reduce the
    float32 product; ``w8a8`` / ``w4a8`` MAX-reduce each row's max-abs and
    all-reduce the int32 product."""
    tp = sizes["model"]
    lead = max(e, 1)
    entries = P.spec_for(spec.axes, rules)
    k = spec.shape[-2]
    k_local = k // _parts(entries[-2], sizes)
    if isinstance(leaf, residency.QuantLinearState):
        fmt = residency.get_format(leaf.mode)
        data_entries = P.leaf_entries(leaf, spec, rules)["data"]
        lead_dims = len(spec.shape) - 2
        held_k = (k // _parts(data_entries[lead_dims], sizes) if fmt.data_n_axis == 1 else k)
        if held_k != k_local:
            return [CollectiveEvent("all-gather", lead * m * k_local * tp * act, tp)]
        bits = _act_bits(fmt)
        if bits is not None:
            return [CollectiveEvent("all-reduce", lead * m * 4, tp),
                    CollectiveEvent("all-reduce", lead * m * n * 4, tp)]
    return [CollectiveEvent("all-reduce", lead * m * n * 4, tp)]


def _tp_check(cfg, tp: int, *, train: bool = False) -> None:
    model_lib.check_tp(cfg, TensorParallel(size=tp, rank=0), train=train)


def call_collectives(cfg, qmode, kind: str, *, batch: int, seq: int, tp: int,
                     rules=None, min_dim: int = 64) -> list:
    """The collectives one rank of a ``tp``-way model axis issues in one
    serving model call (``kind`` ``"prefill"``: ``model.prefill`` of
    ``[batch, seq]`` tokens; ``"decode"``: ``model.decode_step`` of ``[batch,
    seq]``), with the weights of residency policy ``qmode`` (the meta tree
    of :func:`serve_params_meta` says which leaves are which format) under
    ``rules`` (default :func:`serve_rules`).  Written from the code paths
    that issue them (:mod:`repro_torch.models.layers`, ``attention``,
    ``moe``):

    * the vocab-sharded embedding: an all-reduce of its float32 rows;
    * each attention layer's ``wo`` (GQA or MLA: the rank's heads) and a
      dense FFN's ``w_out``: :func:`_row_parallel`;
    * a MoE layer with its experts sharded: the router's float32 logits
      all-reduced, and the per-slot outputs ``[batch, seq·k, d]`` in the
      activations' dtype; with their hidden width sharded: the stacked
      ``w_out`` row-parallel on the ``[E, batch·cap, F/tp]`` buffer; the
      shared experts as a dense FFN;
    * the logits: an all-gather of the vocab shards (the last position of
      a prefill, every position of a decode call).

    One device issues none.  Raises where ``model.check_tp`` does."""
    if tp == 1:
        return []
    _tp_check(cfg, tp)
    sizes = {"pod": 1, "data": 1, "model": tp}
    rules = serve_rules(cfg, {"data": 1, "model": tp}) if rules is None else rules
    tree = serve_params_meta(cfg, qmode, min_dim=min_dim, tp=tp)
    spec = _specs(cfg, tp)
    act = _itemsize(cfg.dtype)
    d, tokens = cfg.d_model, batch * seq
    ev = [CollectiveEvent("all-reduce", tokens * d * 4, tp)]  # the embedding
    for i in range(cfg.n_layers):
        p, s = tree["layers"][i], spec["layers"][i]
        ev += _row_parallel(p["mixer"]["wo"], s["mixer"]["wo"], rules, sizes, tokens, d, act)
        if cfg.ffn_kind(i) == "dense":
            ev += _row_parallel(p["ffn"]["w_out"], s["ffn"]["w_out"], rules, sizes, tokens, d,
                                act)
            continue
        e = cfg.n_experts
        held = e // _parts(P.spec_for(s["ffn"]["w_in"].axes, rules)[0], sizes)
        if held != e:  # the experts sharded
            ev.append(CollectiveEvent("all-reduce", tokens * e * 4, tp))  # router logits
            ev.append(CollectiveEvent("all-reduce",
                                      tokens * cfg.experts_per_tok * d * act, tp))  # slots
        else:  # their hidden width sharded
            cap = moe_lib.capacity(cfg, seq)
            ev += _row_parallel(p["ffn"]["w_out"], s["ffn"]["w_out"], rules, sizes,
                                batch * cap, d, act, e=e)
        if cfg.n_shared_experts:
            ev += _row_parallel(p["ffn"]["shared_w_out"], s["ffn"]["shared_w_out"], rules,
                                sizes, tokens, d, act)
    rows = batch * (1 if kind == "prefill" else seq)
    vocab = model_lib.padded_vocab(cfg, tp)
    ev.append(CollectiveEvent("all-gather", rows * vocab * act, tp))  # the logits
    return ev


def agree_collectives(tokens: int, tp: int) -> list:
    """``ServeEngine.check_ranks_agree`` at the end of a ``tp``-way run: the
    all-gather of every rank's ``tokens`` int32 request ids, lengths and
    token ids."""
    return [] if tp == 1 else [CollectiveEvent("all-gather", tp * tokens * 4, tp)]


class ModelCallLog:
    """Within the block, each ``model.prefill`` and ``model.decode_step``
    call's ``(kind, batch rows, tokens a row)`` in ``calls``, in order: the
    model calls a serve made, whose collectives :func:`serve_collectives`
    counts.  The two functions of :mod:`repro_torch.models.model` are
    wrapped for the block's length."""

    def __enter__(self):
        self.calls = []
        self._fns = prefill, decode_step = model_lib.prefill, model_lib.decode_step

        def rec_prefill(params, batch, cfg, **kw):
            self.calls.append(("prefill",) + tuple(batch["tokens"].shape))
            return prefill(params, batch, cfg, **kw)

        def rec_decode(params, token, caches, pos, cfg, **kw):
            self.calls.append(("decode",) + tuple(token.shape))
            return decode_step(params, token, caches, pos, cfg, **kw)

        model_lib.prefill, model_lib.decode_step = rec_prefill, rec_decode
        return self

    def __exit__(self, *exc):
        model_lib.prefill, model_lib.decode_step = self._fns
        return False


def serve_collectives(eng, calls, *, min_dim: int = 64, agree: bool = True) -> list:
    """The collectives one rank of a tensor-parallel ``ServeEngine`` issues
    in the model calls ``calls`` (``(kind, batch, seq)``, as
    :class:`ModelCallLog` records them; :func:`call_collectives` each, at
    the engine's mode and rules and the ``min_dim`` it converted with), and
    with ``agree`` the closing ``check_ranks_agree`` of a ``run()``
    (:func:`agree_collectives` of the engine's requests)."""
    tp = eng._tp.size
    events = [e for kind, b, s in calls
              for e in call_collectives(eng.cfg, eng.mode, kind, batch=b, seq=s, tp=tp,
                                        rules=eng.rules, min_dim=min_dim)]
    if agree:
        events += agree_collectives(sum(2 + len(r.out) for r in eng.requests), tp)
    return events


def held_collectives(recorded, counted) -> list:
    """[the events ``recorded`` holds (an ``Axis`` or a ``MeshView``), the
    dry run's count ``counted``], each as sorted ``(kind, [count, raw
    bytes])`` pairs: what a serve or a step is held equal on."""

    def by_kind(events):
        return sorted((k, list(v)) for k, v in
                      hlo_stats.counts(hlo_stats.collective_stats(events)).items())

    return [by_kind(recorded.events.elements()), by_kind(counted)]


def _gathers(spec, rules, sizes, *, skip=("model",)) -> list:
    """(all-gather, reduce-scatter) event pairs of gathering a leaf's shard
    over each mesh axis above size 1 that shards it but ``skip``, in
    ``partitioning.gather_on_use``'s order: each gather's result one axis
    whole, the reduce-scatter of its gradient back to its input."""
    entries = P.spec_for(spec.axes, rules)
    shape = list(_local_shape(spec.shape, entries, sizes)[0])
    size = _itemsize(spec.dtype)
    out = []
    for d, name in P.sharded_dims(spec, rules, sizes):
        if name in skip:
            continue
        before = math.prod(shape) * size
        shape[d] *= sizes[name]
        out.append((CollectiveEvent("all-gather", math.prod(shape) * size, sizes[name]),
                    CollectiveEvent("reduce-scatter", before, sizes[name])))
    return out


def train_step_collectives(cfg, *, mesh_axes: dict, rules=None, rows: int, seq: int,
                           microbatches: int = 1, remat: bool = True,
                           compress_pod_grads: bool = False, moments: str = "f32",
                           clip: bool = True) -> list:
    """The collectives one rank issues in one ``make_train_step`` step over
    a mesh of ``mesh_axes`` (``pod`` / ``data`` / ``model``; the model axis
    tensor parallelism of dense GQA) under ``rules`` (default
    ``base_rules(fsdp=True)`` over the mesh's batch axes), the rank holding
    ``rows`` rows of ``seq`` tokens cut in ``microbatches``.  Written from
    ``train/trainstep.py``, ``models/*.py``, ``sharding/partitioning.py``
    and ``optim/adamw.py``:

    * a microbatch's forward: every FSDP-sharded leaf gathered over each
      batch axis that shards it (an all-gather, its gradient
      reduce-scattered back), the top-level leaves once and a layer's
      again in remat's recompute; at ``tp`` the embedding's and each
      ``wo`` and ``w_out``'s float32 all-reduce (``reduce_from``), the
      logits' all-gather; backward the all-reduce of the gradient of every
      column-parallel input (``copy_to``: each layer's attention and FFN
      input, the final norm's output, the q / k norms, and the K / V
      projections where the KV heads are whole); remat's recompute
      reissues ``wo``'s all-reduce and stops before ``w_out``'s, the
      layer's last op that saves a tensor (``torch.utils.checkpoint``
      stops recomputing there); the loss's token count over each batch
      axis (one microbatch);
    * the step: the microbatches' token counts and the global count
      (several microbatches), the gradients no batch axis shards summed in
      one bucket an axis, the int8 pod hop (``compress_pod_grads``: every
      leaf gathered whole, then its int8 codes and scales gathered over
      ``pod``), the loss shares over the batch axes, the global norm over
      every axis twice (clipping, then the metric), and an int8 moment's
      chunk max-abs over every axis a leaf.

    Raises where ``model.check_tp`` and ``check_mesh`` do."""
    sizes = _sizes(mesh_axes)
    names = [a for a in mesh_axes if mesh_axes[a] > 1]  # the axes that issue collectives
    tp = sizes["model"]
    rules = train_rules(mesh_axes) if rules is None else rules
    _tp_check(cfg, tp, train=True)
    bax = [a for a in model_lib.batch_axes(rules) if sizes.get(a, 1) > 1]
    if bax and any(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers)):
        raise NotImplementedError(f"{cfg.name}: a MoE layer over a split batch (check_mesh)")
    spec = _specs(cfg, tp)
    model_only = {"pod": 1, "data": 1, "model": tp}  # a leaf gathered over the batch axes
    act, d = _itemsize(cfg.dtype), cfg.d_model
    m = microbatches
    tokens = rows // m * seq
    ev: list = []

    def gathered(s, forward: int = 1):
        for ag, rs in _gathers(s, rules, sizes):
            ev.extend([ag] * forward + [rs])

    def all_reduce(nbytes, axes):
        ev.extend(CollectiveEvent("all-reduce", nbytes, sizes[a]) for a in axes)

    top = [s for k in spec if k != "layers" for s in tree_lib.leaves(spec[k])]
    # one microbatch (every microbatch issues the same)
    for s in top:
        gathered(s)
    if tp > 1:
        ev.append(CollectiveEvent("all-reduce", tokens * d * 4, tp))  # embedding
    for layer in spec["layers"]:
        for s in tree_lib.leaves(layer):
            gathered(s, 2 if remat else 1)
        if tp == 1:
            continue
        mixer = layer["mixer"]
        whole_kv = not attention.attn_dims(cfg, tp)[2]
        ev.append(CollectiveEvent("all-reduce", tokens * d * act, tp))  # copy_to x
        for key in ("q_norm", "k_norm") + (("wk", "wv", "bk", "bv") if whole_kv else ()):
            if key in mixer:
                s = mixer[key]
                ev.append(CollectiveEvent("all-reduce", math.prod(_local_shape(
                    s.shape, P.spec_for(s.axes, rules), model_only)[0])
                    * _itemsize(s.dtype), tp))
        ev.extend([CollectiveEvent("all-reduce", tokens * d * 4, tp)]
                  * (2 if remat else 1))  # wo's reduce_from, again in the recompute
        ev.append(CollectiveEvent("all-reduce", tokens * d * act, tp))  # FFN copy_to
        ev.append(CollectiveEvent("all-reduce", tokens * d * 4, tp))  # w_out
    if tp > 1:
        vocab = model_lib.padded_vocab(cfg, tp)
        ev.append(CollectiveEvent("all-reduce", tokens * d * act, tp))  # logits copy_to
        ev.append(CollectiveEvent("all-gather", tokens * vocab * act, tp))
    if m == 1:
        all_reduce(4, bax)  # the loss's token count
    ev *= m
    if m > 1:
        ways = math.prod(sizes[a] for a in model_lib.batch_axes(rules))
        all_reduce(4 * ways * m, bax)  # the microbatches' token counts
        all_reduce(4, bax)  # the step's token count
    for name in bax:  # sync_grads: the leaves no shard of which lies on `name`
        numel = sum(math.prod(_local_shape(s.shape, P.spec_for(s.axes, rules), sizes)[0])
                    for s in tree_lib.leaves(spec)
                    if name not in {a for _, a in P.sharded_dims(s, rules, sizes)})
        if numel:
            all_reduce(4 * numel, [name])
    if compress_pod_grads and "pod" in mesh_axes:
        for s in tree_lib.leaves(spec):  # gather_tree of the float32 gradients
            held = 4 * math.prod(_local_shape(s.shape, P.spec_for(s.axes, rules), sizes)[0])
            for _, name in P.sharded_dims(s, rules, sizes):
                held *= sizes[name]
                ev.append(CollectiveEvent("all-gather", held, sizes[name]))
        for _, numel in _moment_leaves(cfg, tp):  # compressed_psum over pod
            chunks = -(-numel // 256)
            ev.append(CollectiveEvent("all-gather", sizes["pod"] * chunks * 256, sizes["pod"]))
            ev.append(CollectiveEvent("all-gather", sizes["pod"] * chunks * 4, sizes["pod"]))
    all_reduce(12, bax)  # the loss, ce and z shares
    if clip:
        all_reduce(4, names)
    if moments == "int8":
        for _, numel in _moment_leaves(cfg, tp):
            all_reduce(2 * -(-numel // optim_lib._CHUNK) * 4, names)
    all_reduce(4, names)  # the reported gradient norm
    return ev


# ---------------------------------------------------------------------------
# One cell at a mesh
# ---------------------------------------------------------------------------


def _probe_cfg(cfg: ModelConfig, d_dec: int, d_enc: int) -> ModelConfig:
    kw = dict(n_layers=cfg.first_k_dense + d_dec * cfg.block_period)
    if cfg.is_enc_dec:
        kw["n_enc_layers"] = d_enc
    return dataclasses.replace(cfg, **kw)


def n_superblocks(cfg: ModelConfig) -> int:
    """The reference's stacked superblocks: the layers past the leading
    dense ones over the block period."""
    body = cfg.n_layers - cfg.first_k_dense
    if body % cfg.block_period:
        raise ValueError(f"{cfg.name}: {body} layers not divisible by period "
                         f"{cfg.block_period}")
    return body // cfg.block_period


def unsupported(cfg: ModelConfig, cell: ShapeCell, pl: mesh_lib.Plan, sizes: dict):
    """Why the port runs no collective count for this cell at this plan:
    the message of the check that raises (``check_tp`` for Mamba and cross
    layers, and for MLA or MoE training; ``check_mesh`` for a MoE layer
    over a split batch), or the sequence-parallel decode of ``plan`` that
    the engine does not serve; None where it runs."""
    train = cell.kind == "train"
    try:
        _tp_check(cfg, pl.tp, train=train)
    except NotImplementedError as e:
        return f"check_tp: {e}"
    if train and any(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers)):
        ways = math.prod(sizes.get(a, 1) for a in model_lib.batch_axes(pl.rules))
        if ways > 1:
            return (f"check_mesh: {cfg.name}: a MoE layer over a batch split {ways} ways (its "
                    "aux loss over the global batch) waits for ROADMAP Queue 1, item 8(c)")
    if pl.rules.get("kv_seq") is not None:
        return ("plan: sequence-parallel KV decode (a batch of "
                f"{cell.global_batch} under {sizes['pod'] * sizes['data']} data ways): the "
                "engine serves no sequence-parallel decode (ROADMAP Queue 1, item 8(c))")
    return None


#: keys of the reference's ``_collect`` record whose value came from XLA's
#: compiled program, and what the port puts there instead
XLA_KEYS = {
    "flops_per_device": "6 (train) or 2 x the rank's active matmul parameters (its shards "
                        "over the model axis; a tied embedding counted once, for the logits) "
                        "x its tokens",
    "hbm_bytes_per_device": "the analytic traffic of analytic_traffic's model, its weights "
                            "summed leaf by leaf over the rank's shards (linear in depth)",
    "collective_wire_bytes": "hlo_stats.collective_stats of call_collectives / "
                             "train_step_collectives",
    "memory.argument_size_in_bytes": "rank_bytes' total; the other memory_analysis keys "
                                     "have no counterpart and are None",
}


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False, qmode="bf16",
               microbatches: Optional[int] = None, probe: Optional[tuple] = None,
               mesh_shape: Optional[tuple] = None, cache_format: Optional[str] = None,
               min_dim: int = 64) -> dict:
    """One cell on one rank of a stand-in mesh of the reference's shapes
    (16 × 16 ``(data, model)``, 2 × 16 × 16 with ``multi_pod``, or a
    ``(data, model)`` ``mesh_shape``; ``(1, 1)`` is one card), under
    :func:`repro_torch.launch.mesh.plan`'s rules and tensor-parallel width.
    ``probe=(d_dec, d_enc)`` cuts the config to that many superblocks (and
    encoder layers) as the reference's probes do; a train cell's probe
    keeps the cell's batch and microbatches, so the probes' differences
    are whole steps' per-layer terms.

    Returns the reference's ``_collect`` keys: ``devices``, ``mesh_shape``,
    ``flops_per_device``, ``hbm_bytes_per_device``,
    ``collective_wire_bytes``, ``collectives`` (per kind: count, wire
    ``bytes``, ``raw_bytes``) and ``memory``, beside the cell's
    description.  The reference read four of them from XLA's compiled
    program; :data:`XLA_KEYS` says what the port puts there instead.  Where
    the port raises at this plan, ``collectives`` and
    ``collective_wire_bytes`` are None and ``unsupported`` names the check
    (:func:`unsupported`)."""
    cfg = get_config(arch)
    if cache_format is not None:
        cfg = dataclasses.replace(cfg, cache_format=cache_format)
    cell = SHAPES[shape]
    mesh = mesh_lib.stand_in_mesh(multi_pod=multi_pod, mesh_shape=mesh_shape)
    pl = mesh_lib.plan(cfg, cell, mesh)
    rules, tp = pl.rules, pl.tp
    mb = microbatches if microbatches is not None else pl.microbatches
    mb = mb if cell.kind == "train" else 1
    if probe is not None:
        cfg = _probe_cfg(cfg, *probe)
    axes = P.mesh_sizes(mesh)
    sizes = _sizes(axes)
    t0 = time.perf_counter()
    dways = sizes["pod"] * sizes["data"]
    rows = max(cell.global_batch // dways, 1)
    tokens = rows if cell.kind == "decode" else rows * cell.seq_len
    # a decode step runs no encoder
    pc = _counts(cfg, tp, rules, {"model": tp}, encoder=cell.kind != "decode")
    matmul = pc["active"] + (pc["embedding"] if cfg.tie_embeddings else 0)  # the tied logits
    flops = (6.0 if cell.kind == "train" else 2.0) * matmul * tokens
    reason = unsupported(cfg, cell, pl, sizes)
    events = None
    if reason is None:
        if cell.kind == "train":
            events = train_step_collectives(cfg, mesh_axes=axes, rules=rules, rows=rows,
                                            seq=cell.seq_len, microbatches=mb,
                                            moments=TRAIN_MOMENTS)
        else:
            events = call_collectives(cfg, qmode, cell.kind, batch=rows,
                                      seq=1 if cell.kind == "decode" else cell.seq_len,
                                      tp=tp, rules=rules, min_dim=min_dim)
    stats = None if events is None else hlo_stats.collective_stats(events)
    mine = rank_bytes(cfg, cell.kind, mesh_axes=axes, rules=rules, qmode=qmode,
                      min_dim=min_dim, batch=cell.global_batch, seq_len=cell.seq_len)
    return dict(
        arch=arch, shape=shape, multi_pod=multi_pod, qmode=qmode,
        cache_format=kvcache.format_for(cfg).name, plan_notes=pl.notes, microbatches=mb,
        lower_seconds=time.perf_counter() - t0, kind=cell.kind, probe=probe,
        devices=mesh.devices.size, mesh_shape=axes,
        flops_per_device=flops,
        hbm_bytes_per_device=analytic_traffic(
            cfg, cell, qmode, min_dim, tp=tp, mesh_axes=axes, encoder=cell.kind != "decode",
            weight_bytes=_rank_weight_bytes(cfg, cell, qmode, min_dim, tp, rules))["total"],
        collective_wire_bytes=None if stats is None else stats.wire_bytes,
        collectives=None if stats is None else stats.by_kind,
        unsupported=reason,
        rank=dict(mine, hbm_bytes=hlo_stats.HW["hbm_bytes"],
                  fits=mine["total"] <= hlo_stats.HW["hbm_bytes"]),
        memory={"argument_size_in_bytes": mine["total"], "output_size_in_bytes": None,
                "temp_size_in_bytes": None, "generated_code_size_in_bytes": None,
                "alias_size_in_bytes": None},
    )


def _rank_weight_bytes(cfg, cell, qmode, min_dim, tp, rules) -> float:
    """The weights a rank's forward pass reads, summed leaf by leaf over its
    model-axis shards: a serve cell's converted (no encoder in a decode
    step), a train cell's at bf16's two bytes a parameter."""
    model_only = {"pod": 1, "data": 1, "model": tp}
    if cell.kind == "train":
        return 2.0 * _counts(cfg, tp, rules, model_only)["total"]
    return float(sum(b for b, _ in _weight_shards(cfg, qmode, min_dim, tp, rules, model_only,
                                                  encoder=cell.kind != "decode")))


_COST_KEYS = ("flops_per_device", "hbm_bytes_per_device", "collective_wire_bytes")


MESHES = ("card", "pod", "multipod")


def analyze_cell(arch: str, shape: str, *, mesh: str = "card", multi_pod: bool = False,
                 qmode="bf16", cache_format: Optional[str] = None,
                 microbatches: Optional[int] = None, skip_probes: bool = False,
                 mesh_shape: Optional[tuple] = None, min_dim: int = 64,
                 scheduler: Optional[str] = None) -> dict:
    """The record of one (arch × shape) cell: :func:`lower_cell`'s, with
    the reference's ``corrected`` and ``probe`` blocks (unless
    ``skip_probes``: probes at depth 1 and 2, and at encoder depth 2 for
    an encoder-decoder's serve cells, differenced into a fixed and a
    per-superblock term), ``param_counts``, ``model_flops``, the
    ``roofline`` (``roofline_terms`` of the corrected FLOPs, the analytic
    traffic and the corrected wire bytes at NVLink's rate), the
    ``serving_model`` of a decode cell.  ``mesh`` is one of
    :data:`MESHES`: one card (the default), the 16 × 16 pod or the
    2 × 16 × 16 multi-pod mesh (also ``multi_pod=True``, the reference's
    argument); a ``(data, model)`` ``mesh_shape`` overrides it.  On one
    card the record also holds the ``one_card`` block: the
    weight bytes under ``qmode``, a decode cell's cache, a train cell's
    state, the batch, and whether they fit ``HW["hbm_bytes"]`` together
    (activations are not counted).  A cell that does not fit is recorded
    so; it is not a failure.  The port counts every layer, so the
    corrected totals equal the direct full-depth counts."""
    cfg = get_config(arch)
    if cache_format is not None:
        cfg = dataclasses.replace(cfg, cache_format=cache_format)
    cell = SHAPES[shape]
    qmode = residency.ResidencySpec.parse(qmode).describe()
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r}: one of {MESHES}")
    multi_pod = multi_pod or mesh == "multipod"
    if mesh_shape is None and not multi_pod and mesh == "card":
        mesh_shape = (1, 1)
    kw = dict(multi_pod=multi_pod, qmode=qmode, microbatches=microbatches,
              mesh_shape=mesh_shape, cache_format=cache_format, min_dim=min_dim)
    rec = lower_cell(arch, shape, **kw)
    rec["status"] = "ok"
    tp, axes = rec["mesh_shape"].get("model", 1), rec["mesh_shape"]
    cost = {k: rec[k] for k in _COST_KEYS}
    if not skip_probes:
        p1 = lower_cell(arch, shape, probe=(1, 1), **kw)
        p2 = lower_cell(arch, shape, probe=(2, 1), **kw)
        pe = None
        if cfg.is_enc_dec and cell.kind != "decode":
            pe = lower_cell(arch, shape, probe=(1, 2), **kw)
        n_sb, n_enc = n_superblocks(cfg), cfg.n_enc_layers
        corrected = {}
        for key in _COST_KEYS:
            if p1[key] is None:
                corrected[key] = None
                continue
            body = max(p2[key] - p1[key], 0.0)
            enc_body = max(pe[key] - p1[key], 0.0) if pe else 0.0
            fixed = max(p1[key] - body - enc_body, 0.0)
            corrected[key] = fixed + n_sb * body + n_enc * enc_body
        rec["corrected"] = corrected
        rec["probe"] = {
            "p1": {k: p1[k] for k in _COST_KEYS}, "p2": {k: p2[k] for k in _COST_KEYS},
            "pe": {k: pe[k] for k in _COST_KEYS} if pe else None,
            "n_superblocks": n_sb, "microbatches": rec["microbatches"], "n_enc": n_enc,
        }
        cost = corrected
    mf = model_flops(cfg, cell, tp)
    n_dev = rec["devices"]
    traffic = analytic_traffic(cfg, cell, qmode, min_dim=min_dim, tp=tp, mesh_axes=axes,
                               mb=rec["microbatches"])
    terms = hlo_stats.roofline_terms(cost["flops_per_device"], traffic["total"],
                                     cost["collective_wire_bytes"] or 0.0)
    model_s = mf / n_dev / hlo_stats.HW["bf16_flops"]
    rec.update(param_counts=param_counts(cfg, tp), model_flops=mf)
    rec["roofline"] = dict(
        terms,
        hbm_bytes_analytic=traffic["total"],
        hbm_bytes_leafwise=cost["hbm_bytes_per_device"],
        traffic_breakdown=traffic,
        model_flops_total=mf,
        model_flops_per_device=mf / n_dev,
        useful_flops_ratio=(mf / n_dev) / max(cost["flops_per_device"], 1.0),
        model_step_seconds=model_s,
        roofline_fraction=min(1.0, model_s / max(terms["step_lower_bound"], 1e-12)),
    )
    if cell.kind == "decode":
        rec["serving_model"] = analytic_serving(cfg, cell, qmode, tp=tp, mesh_axes=axes,
                                                min_dim=min_dim, scheduler=scheduler)
    if n_dev == 1:
        rec["one_card"] = _one_card(cfg, cell, qmode, min_dim)
    return rec


def _one_card(cfg, cell, qmode, min_dim) -> dict:
    one = {}
    if cell.kind == "train":
        one["train_state_bytes"] = state = train_state_bytes(cfg)
        total = sum(state.values())
    else:
        one["weight_bytes"] = total = analytic_weight_bytes(cfg, qmode, min_dim=min_dim)
    if cell.kind == "decode":
        caches = model_lib.init_cache(cfg, cell.global_batch, cell.seq_len + DECODE_HORIZON,
                                      device=_META)
        one["cache_bytes"] = kvcache.cache_resident_bytes(caches)
        total += one["cache_bytes"]
    one["batch_bytes"] = _tree_bytes(batch_specs(cfg, cell))
    total += one["batch_bytes"]
    one.update(total_bytes=total, hbm_bytes=hlo_stats.HW["hbm_bytes"],
               fits=total <= hlo_stats.HW["hbm_bytes"])
    return one


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _registry_arg(parse):
    """argparse ``type=`` wrapper: a registry's ValueError (which lists the
    registered names) becomes an ArgumentTypeError, so a typo fails at
    parse time with the list."""

    def convert_text(text):
        try:
            return parse(text)
        except (ValueError, KeyError, TypeError) as e:
            raise argparse.ArgumentTypeError(str(e) or repr(e)) from e

    return convert_text


def _line(tag: str, rec: dict) -> str:
    roof, mine = rec["roofline"], rec["rank"]
    wire = ("collectives null: " + rec["unsupported"] if rec["collectives"] is None
            else f"wire {rec['collective_wire_bytes']:.6g} B")
    return (f"[OK] {tag}: rank {mine['total']} B, fits {mine['fits']}, {wire}, "
            f"dominant={roof['dominant']} bound={roof['step_lower_bound'] * 1e3:.6g} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, type=_registry_arg(lambda s: (get_config(s), s)[1]))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default=None,
                    help="the reference's production meshes: the 16 x 16 pod, 2 x 16 x 16 "
                         "multi-pod, or both (default: one card)")
    ap.add_argument("--mesh-shape", type=int, nargs=2, default=None, metavar=("DATA", "MODEL"),
                    help="a (data, model) mesh of this shape")
    ap.add_argument("--qmode", default="bf16",
                    type=_registry_arg(lambda s: residency.ResidencySpec.parse(s).describe()),
                    help="registered residency format name (one of "
                         f"{', '.join(residency.formats())}) or a per-layer policy "
                         "like 'ffn=bsdp_fused,mixer=w8a16'")
    ap.add_argument("--cache-format", default=None,
                    type=_registry_arg(lambda s: kvcache.get_cache_format(s).name),
                    help="decode-cache residency format (one of "
                         f"{', '.join(kvcache.formats())})")
    ap.add_argument("--scheduler", default=None,
                    type=_registry_arg(lambda s: (sched_lib.make_scheduler(s), s)[1]),
                    help="restrict the decode-cell serving model to one registered "
                         f"scheduler (one of {', '.join(sched_lib.schedulers())}; default: all)")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--min-dim", type=int, default=64,
                    help="residency-conversion floor: quantizable leaves with min(K, N) "
                         "below it stay float, as in the serving engine")
    ap.add_argument("--all", action="store_true", help="every arch × applicable shape")
    ap.add_argument("--skip-probes", action="store_true",
                    help="count the full depth only (the multi-pod mesh always does)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    cells = [(arch, shape) for arch in archs
             for shape in (applicable_shapes(get_config(arch)) if args.shape is None
                           else [args.shape])]
    meshes = {None: [None], "pod": ["pod"], "multipod": ["multipod"],
              "both": ["pod", "multipod"]}[args.mesh]
    if args.mesh_shape is not None:
        meshes = [m for m in meshes if m is not None] + ["shape"]
    os.makedirs(args.out, exist_ok=True)
    ok = fail = 0
    for arch, shape in cells:
        for mesh in meshes:
            tag = f"{arch}__{shape}"
            kw = {}
            if mesh == "shape":
                kw["mesh_shape"] = tuple(args.mesh_shape)
                tag += f"__d{args.mesh_shape[0]}m{args.mesh_shape[1]}"
            elif mesh is not None:
                kw["mesh"] = mesh
                tag += f"__{mesh}"
            tag += f"__{args.qmode}"
            if args.cache_format:
                tag += f"__kv_{args.cache_format}"
            try:
                rec = analyze_cell(arch, shape, qmode=args.qmode, cache_format=args.cache_format,
                                   microbatches=args.microbatches, min_dim=args.min_dim,
                                   scheduler=args.scheduler,
                                   skip_probes=args.skip_probes or mesh == "multipod", **kw)
                ok += 1
                print(_line(tag, rec), flush=True)
            except Exception as e:  # noqa: BLE001 — recorded, the run continues
                rec = {"arch": arch, "shape": shape, "mesh": mesh, "qmode": args.qmode,
                       "status": "fail", "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                fail += 1
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1, default=str)
    print(f"\ndry-run complete: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
