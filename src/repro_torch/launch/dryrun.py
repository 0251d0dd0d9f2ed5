"""Single-card dry-run: what a cell needs on one H100, from shapes alone.

Counterpart of the analytic half of :mod:`repro.launch.dryrun`.  For every
(arch × shape) cell it builds the cell's weights, caches and batch as
``meta`` tensors (shapes and dtypes, no storage) through the same code
the serving path runs (each residency format's ``abstract_state``,
``model.init_cache``), and reckons from them:

* the resident bytes of a residency policy (:func:`analytic_weight_bytes`)
  and of a decode cache (:func:`analytic_cache_bytes`), byte for byte what
  ``ServeEngine.resident_bytes()`` counts on the card;
* parameter counts and model FLOPs (:func:`param_counts`,
  :func:`model_flops`), the minimum HBM traffic of a step
  (:func:`analytic_traffic`) and the H100 roofline over them
  (:func:`repro_torch.launch.hlo_stats.roofline_terms`);
* the serving model: the registered schedulers replayed over a synthetic
  mixed-length trace at the traffic's costs (:func:`analytic_serving`);
* whether the cell's weights, decode cache or train state fit one card.

It runs no kernel and never executes the model: the ring write and MoE
dispatch select by data (``nonzero``), which the meta device cannot do.
On one card the tensor-parallel width is 1 and the mesh has no axes, so
the reference's ``tp`` and ``mesh_axes`` arguments are gone.  The
lowering half (``lower_cell``, the probe-corrected HLO costs) reads a
compiled program over a mesh and comes with sharding.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback
from typing import Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core import kvcache, residency
from repro_torch.launch import hlo_stats
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw as optim_lib
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve.engine import QUANTIZABLE_KEYS

DECODE_HORIZON = 64  # decode cells: cache covers seq_len + a small horizon
#: the train cell's optimizer moments (the reference's train cell's)
TRAIN_MOMENTS = "bf16"
_META = torch.device("meta")


def _meta(spec: model_lib.ParamSpec) -> torch.Tensor:
    return torch.empty(tuple(spec.shape), dtype=spec.dtype, device=_META)


def _nbytes(leaf) -> int:
    """Bytes of a meta or real tensor, or of a residency state."""
    if isinstance(leaf, residency.QuantLinearState):
        return residency.resident_bytes(leaf)
    return residency._nbytes(leaf)


def _tree_bytes(tree) -> int:
    return sum(_nbytes(leaf) for leaf in tree_lib.leaves(tree))


def _walk(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (``path`` the
    tuple of keys, a list item's its index as a string), keeping its
    structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


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


def _serve_params(spec_tree, qmode, *, min_dim: int = 64):
    """The served weights as meta tensors and meta residency states."""
    qtree = abstract_quant(spec_tree, qmode, min_dim=min_dim)
    return _walk(qtree, lambda path, s: _meta(s) if isinstance(s, model_lib.ParamSpec) else s)


# ---------------------------------------------------------------------------
# Analytic parameter / model-flops accounting
# ---------------------------------------------------------------------------


def serve_params_meta(cfg: ModelConfig, spec, *, min_dim: int = 64, tp: int = 1):
    """The converted parameter tree of residency policy ``spec`` at
    ``specs(cfg, tp)``'s global shapes, every leaf a meta tensor or a meta
    residency state: what :mod:`repro_torch.sharding.partitioning` cuts
    into each rank's shards (``local_bytes``)."""
    return _serve_params(model_lib.specs(cfg, tp), spec, min_dim=min_dim)


def param_counts(cfg: ModelConfig) -> dict:
    """(total, active, embedding) parameter counts from the spec tree; a
    leaf on the ``"expert"`` axis (a MoE layer's ``router``, ``w_in`` and
    ``w_out``, not its shared expert) counts ``experts_per_tok /
    n_experts`` of its elements active."""
    total = active = embed = 0
    k_over_e = cfg.experts_per_tok / cfg.n_experts if cfg.n_experts else 1.0
    for path, s in tree_lib.flatten(model_lib.specs(cfg)):
        n = 1
        for d in s.shape:
            n *= d
        total += n
        if "embedding" in path:
            embed += n
        elif "expert" in s.axes:
            active += n * k_over_e
        else:
            active += n
    return {"total": total, "active": active, "embedding": embed}


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (serve)."""
    pc = param_counts(cfg)
    n = pc["active"] - pc["embedding"]
    if cell.kind == "train":
        return 6.0 * n * (cell.global_batch * cell.seq_len)
    if cell.kind == "prefill":
        return 2.0 * n * (cell.global_batch * cell.seq_len)
    return 2.0 * n * cell.global_batch  # one token per sequence


def residency_qbytes(cfg: ModelConfig, spec, *, min_dim: int = 64) -> float:
    """Resident weight bytes per quantizable parameter element, from the
    format registry: byte-counts the tree :func:`abstract_quant` produces
    (quantized leaves their payload without scales, leaves that stay float
    their spec dtype) over the quantizable leaves' elements."""
    spec_tree = model_lib.specs(cfg)
    converted = dict(tree_lib.flatten(abstract_quant(spec_tree, spec, min_dim=min_dim)))
    elems = qbytes_sum = 0.0
    for path, s in tree_lib.flatten(spec_tree):
        if not _quantizable(path, s):
            continue
        n_el = 1
        for d in s.shape:
            n_el *= d
        elems += n_el
        conv = converted[path]
        qbytes_sum += _nbytes(conv.data if isinstance(conv, residency.QuantLinearState)
                              else _meta(conv))
    return qbytes_sum / max(elems, 1.0)


def analytic_traffic(cfg: ModelConfig, cell: ShapeCell, qmode, min_dim: int = 64) -> dict:
    """Minimum HBM traffic of one step on one card (fusion-ideal).

    Weights stream from HBM once per use, activations make one round trip
    per layer boundary (``act_round`` of them), caches are read once per
    decode step.  A train step reads bf16 weights three times (forward,
    remat, backward), writes and reads f32 gradients and reads and writes
    the moments; a serve cell's weights are the policy's resident bytes
    a parameter (:func:`residency_qbytes`).  Real steps sit above this.
    """
    pc = param_counts(cfg)
    wq = 2.0 if cell.kind == "train" else residency_qbytes(cfg, qmode, min_dim=min_dim)
    w = pc["total"] * wq  # resident weight bytes a forward pass must read
    act_round = 8  # residual/norm/proj round-trips per layer boundary
    d = cfg.d_model
    n_layers = cfg.n_layers + (cfg.n_enc_layers or 0)
    if cell.kind == "train":
        tokens = float(cell.global_batch * cell.seq_len)
        weight_traffic = 3 * w + 2 * (2 * w) + 4 * w
        act_traffic = tokens * d * 2 * n_layers * act_round * 3  # fwd+bwd+remat
        kv_traffic = 0.0
    elif cell.kind == "prefill":
        tokens = float(cell.global_batch * cell.seq_len)
        weight_traffic = w
        act_traffic = tokens * d * 2 * n_layers * act_round
        kv_traffic = tokens * d * 2  # cache write
    else:  # decode: weights dominate
        tokens = max(float(cell.global_batch), 1.0)
        weight_traffic = w  # every resident weight read once per step
        act_traffic = tokens * d * 2 * n_layers * act_round
        kv_traffic = _cache_bytes_local(cfg, cell)
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


def analytic_serving(cfg: ModelConfig, cell: ShapeCell, qmode, *, min_dim: int = 64,
                     slots: int = 4, scheduler: Optional[str] = None) -> dict:
    """Scheduler-aware analytic serving model for a decode cell.

    Replays :data:`_SERVE_TRACE` through the registered schedulers
    (:func:`repro_torch.serve.scheduler.simulate`) under a two-term cost
    model from the traffic terms: every model call reads the resident
    weights and cache once (``t_call``), and each position adds its
    activation traffic (``t_token``), both at the card's HBM rate.
    """
    traffic = analytic_traffic(cfg, cell, qmode, min_dim=min_dim)
    bw = hlo_stats.HW["hbm_bw"]
    t_call = (traffic["weight_traffic"] + traffic["cache_traffic"]) / bw
    t_token = traffic["act_traffic"] / bw / max(float(cell.global_batch), 1.0)
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


def analytic_cache_bytes(cfg, batch: int, cache_len: int) -> int:
    """Decode-cache bytes of a ``batch``-slot serving engine whose rings
    hold ``cache_len`` positions: each format channel through
    :func:`_channel_bytes`, ``pos_ids`` and MLA's float rope ring at the
    format's ``slot_capacity``.  Byte for byte
    ``ServeEngine.resident_bytes()["cache"]`` of an attention config.  It
    counts attention layers only (an ``attn_cross`` layer's self-attention
    ring, not its context K/V) and raises on any other; the ring length is
    the caller's (a sliding window's ring is ``min(window, max_len)``).
    """
    fmt = kvcache.format_for(cfg)
    ring = fmt.slot_capacity(cache_len)
    itemsize = torch.empty((), dtype=cfg.dtype, device=_META).element_size()
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
            total += _channel_bytes(fmt, cache_len, (cfg.n_kv_heads,), cfg.d_head,
                                    cfg.dtype) * 2 * batch
        total += batch * ring * 4  # pos_ids, int32
    return total


def analytic_weight_bytes(cfg, spec, *, min_dim: int = 64) -> int:
    """Resident weight bytes of one residency policy, with no weights: the
    bytes of :func:`_serve_params`' meta tree, byte for byte
    ``ServeEngine.resident_bytes()["weights"]`` for the same ``(cfg, spec,
    min_dim)``."""
    return _tree_bytes(_serve_params(model_lib.specs(cfg), spec, min_dim=min_dim))


def _cache_bytes_local(cfg, cell) -> float:
    """Decode-cache bytes a step reads, from the cache-format registry:
    each attention channel's :func:`_channel_bytes` over the cell's
    ``seq_len`` (a sliding window's at most), MLA's bf16 rope key, a Mamba
    layer's float32 state; paged formats charge whole pages and tables."""
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
                eff = min(s, cfg.sliding_window or s)
                per_layer += _channel_bytes(fmt, eff, (cfg.n_kv_heads,), cfg.d_head) * 2
        elif kind == "mamba":
            per_layer += cfg.d_inner * cfg.d_state * 4
    return b * per_layer if b else per_layer


def train_state_bytes(cfg) -> dict:
    """Bytes of a train step's state on one card: the float parameters,
    their float32 gradients and AdamW's two :data:`TRAIN_MOMENTS` moments
    (``adamw(...).init_abstract``, meta tensors)."""
    params = _walk(model_lib.specs(cfg), lambda path, s: _meta(s))
    n_params = sum(p.numel() for p in tree_lib.leaves(params))
    opt = optim_lib.adamw(3e-4, moment_dtype=TRAIN_MOMENTS).init_abstract(params)
    moments = sum(_nbytes(m.payload) + _nbytes(m.scale)
                  for tree in (opt.mu, opt.nu) for m in tree_lib.leaves(tree))
    return {"params": _tree_bytes(params), "grads": 4 * n_params,
            "moments": moments + _nbytes(opt.step)}


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------


def analyze_cell(arch: str, shape: str, *, qmode="bf16", cache_format: Optional[str] = None,
                 min_dim: int = 64, scheduler: Optional[str] = None) -> dict:
    """The analytic record of one (arch × shape) cell on one card:
    ``param_counts``, ``model_flops``, the ``roofline`` block
    (``roofline_terms`` of the model FLOPs and :func:`analytic_traffic`),
    ``serving_model`` on a decode cell, and ``one_card``: the weight bytes
    (a serve cell's under ``qmode``), a decode cell's cache bytes
    (``model.init_cache`` on the meta device, every mixer kind), a train
    cell's state (:func:`train_state_bytes`), the batch's
    (:func:`batch_specs`), and whether they fit ``HW["hbm_bytes"]``
    together (activations are not counted).  A cell that does not fit is recorded so;
    it is not a failure."""
    cfg = get_config(arch)
    if cache_format is not None:
        cfg = dataclasses.replace(cfg, cache_format=cache_format)
    cell = SHAPES[shape]
    qmode = residency.ResidencySpec.parse(qmode).describe()
    mf = model_flops(cfg, cell)
    traffic = analytic_traffic(cfg, cell, qmode, min_dim=min_dim)
    terms = hlo_stats.roofline_terms(mf, traffic["total"], 0.0)
    model_s = mf / hlo_stats.HW["bf16_flops"]
    rec = dict(
        arch=arch, shape=shape, kind=cell.kind, qmode=qmode,
        cache_format=kvcache.format_for(cfg).name, min_dim=min_dim, devices=1,
        status="ok", param_counts=param_counts(cfg), model_flops=mf,
        roofline=dict(
            terms,
            hbm_bytes_analytic=traffic["total"],
            traffic_breakdown=traffic,
            model_flops_total=mf,
            model_flops_per_device=mf,
            model_step_seconds=model_s,
            roofline_fraction=min(1.0, model_s / max(terms["step_lower_bound"], 1e-12)),
        ),
    )
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
        rec["serving_model"] = analytic_serving(cfg, cell, qmode, min_dim=min_dim,
                                                scheduler=scheduler)
    one["batch_bytes"] = _tree_bytes(batch_specs(cfg, cell))
    total += one["batch_bytes"]
    one.update(total_bytes=total, hbm_bytes=hlo_stats.HW["hbm_bytes"],
               fits=total <= hlo_stats.HW["hbm_bytes"])
    rec["one_card"] = one
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _registry_arg(parse):
    """argparse ``type=`` wrapper: a registry's ValueError (which lists the
    registered names) becomes an ArgumentTypeError, so a typo fails at
    parse time with the list."""

    def convert(text):
        try:
            return parse(text)
        except (ValueError, KeyError, TypeError) as e:
            raise argparse.ArgumentTypeError(str(e) or repr(e)) from e

    return convert


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, type=_registry_arg(lambda s: (get_config(s), s)[1]))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
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
    ap.add_argument("--min-dim", type=int, default=64,
                    help="residency-conversion floor: quantizable leaves with min(K, N) "
                         "below it stay float, as in the serving engine")
    ap.add_argument("--all", action="store_true", help="every arch × applicable shape")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    cells = [(arch, shape) for arch in archs
             for shape in (applicable_shapes(get_config(arch)) if args.shape is None
                           else [args.shape])]
    os.makedirs(args.out, exist_ok=True)
    ok = fail = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{args.qmode}"
        if args.cache_format:
            tag += f"__kv_{args.cache_format}"
        try:
            rec = analyze_cell(arch, shape, qmode=args.qmode, cache_format=args.cache_format,
                               min_dim=args.min_dim, scheduler=args.scheduler)
            ok += 1
            one, roof = rec["one_card"], rec["roofline"]
            print(f"[OK] {tag}: fits one card {one['fits']} ({one['total_bytes']} B), "
                  f"dominant={roof['dominant']} bound={roof['step_lower_bound'] * 1e3:.6g} ms",
                  flush=True)
        except Exception as e:  # noqa: BLE001 — recorded, the run continues
            rec = {"arch": arch, "shape": shape, "qmode": args.qmode, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            fail += 1
            print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(f"\ndry-run complete: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
