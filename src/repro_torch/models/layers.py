"""Shared model layers: dense dispatch, norms, embeddings, RoPE, MLPs.

Counterpart of :mod:`repro.models.layers` (RMSNorm or LayerNorm, SwiGLU or
GELU, tied or untied head), as plain functions on tensors.  ``dense`` is the
single projection entry point (``dense_stacked`` its counterpart for a MoE
layer's stacked expert weights): a weight converted to a
:class:`~repro_torch.core.residency.QuantLinearState` goes through its
residency format — the kernel path by default, the plain PyTorch path with
``impl="plain"`` — and a float weight is a plain matmul.

Tensor parallelism (``tp``, a :class:`~repro_torch.distributed.mesh.
TensorParallel`; None on one device) is written out here where the
reference leaves it to GSPMD.  A column-parallel projection (N on the
model axis: ``wq``, ``wk``, ``wv``, ``w_in``, the head) is ``dense`` on the
rank's columns and needs no collective.  A row-parallel one (K on the
model axis: ``wo``, ``w_out``) is :func:`row_parallel`: each rank's partial
product, then an all-reduce sum (see the formats'
``apply_row_parallel``; :func:`row_parallel_stacked` for a MoE layer's
stacked ``w_out``), except a bit-plane weight, whose payload keeps every
K on every rank: its input is all-gathered first.  The embedding's
vocab rows are sharded: each rank looks up its own id range, writes zeros
elsewhere and the ranks' rows are summed; the logits come out
vocab-sharded and are all-gathered, so every rank sees every logit.

The float collectives are the autograd-aware forms of
:mod:`repro_torch.distributed.mesh`, so the same code trains: a
column-parallel projection's input goes through ``copy_to`` (its gradient
summed over the model axis), a row-parallel output (a MoE layer's stacked
``w_out`` too) and the embedding through ``reduce_from``, the logits
through ``gather_replicated``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import residency
from repro_torch.distributed.mesh import copy_to, gather_replicated, reduce_from


def dense(w, x: torch.Tensor, impl=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` — float path or quantized-residency path.
    The kernel result is cast to ``x.dtype`` as in the reference."""
    if isinstance(w, residency.QuantLinearState):
        if impl == "plain":
            return residency.get_format(w.mode).apply_plain(w, x)
        return residency.apply(w, x).to(x.dtype)
    return x @ w.to(x.dtype)


def dense_stacked(w, x: torch.Tensor, impl=None) -> torch.Tensor:
    """``x [E, M, K] @ w [E, K, N]`` per expert: a stacked state through its
    format (one grouped kernel launch for the formats that have one), a
    float stack as one batched matmul in ``x.dtype``."""
    if isinstance(w, residency.QuantLinearState):
        if impl == "plain":
            return residency.get_format(w.mode).apply_stacked_plain(w, x)
        return residency.apply_stacked(w, x).to(x.dtype)
    return torch.einsum("emk,ekn->emn", x, w.to(x.dtype))


def row_parallel(w, x: torch.Tensor, tp=None, impl=None, bias=None) -> torch.Tensor:
    """``x [..., K/tp] @ w [K, N]`` (+ ``bias``) with K split over the model
    axis (the rank holds its K rows of ``w`` and of ``x``'s features) → the
    whole product on every rank, in ``x.dtype``.  A bias is added once,
    after the all-reduce.  Without ``tp``, :func:`dense`."""
    if tp is None or tp.size == 1:
        out = dense(w, x, impl=impl)
    elif isinstance(w, residency.QuantLinearState):
        if w.k != x.shape[-1]:  # the payload holds every K: gather the features
            out = dense(w, tp.all_gather(x), impl=impl)
        else:
            fmt = residency.get_format(w.mode)
            out = fmt.apply_row_parallel(w, x, tp, impl=impl).to(x.dtype)
    else:
        partial = x.to(torch.float32) @ w.to(torch.float32)
        out = reduce_from(tp, partial).to(x.dtype)
    return out if bias is None else out + bias.to(out.dtype)


def row_parallel_stacked(w, x: torch.Tensor, tp, impl=None) -> torch.Tensor:
    """``x [E, M, F/tp] @ w [E, F, N]`` per expert with F split over the
    model axis (a MoE layer's ``w_out`` with its hidden width sharded) →
    the whole products ``[E, M, N]`` on every rank, in ``x.dtype``: the
    ranks' partials all-reduced (the formats' ``apply_stacked_row_parallel``),
    except a bit-plane weight, whose payload keeps every F on every rank:
    its input is all-gathered first."""
    if isinstance(w, residency.QuantLinearState):
        if w.k != x.shape[-1]:
            return dense_stacked(w, tp.all_gather(x), impl=impl)
        fmt = residency.get_format(w.mode)
        return fmt.apply_stacked_row_parallel(w, x, tp, impl=impl).to(x.dtype)
    partial = torch.einsum("emk,ekn->emn", x.to(torch.float32), w.to(torch.float32))
    return reduce_from(tp, partial).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    y = x * torch.rsqrt(torch.square(x).mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(dtype)


def norm_apply(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """``cfg.norm`` in float32: RMSNorm, or LayerNorm (eps 1e-5) then
    ``* scale + bias``."""
    if cfg.norm != "layernorm":
        return rms_norm(x, params["scale"])
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + 1e-5)
    return (y * params["scale"] + params["bias"]).to(dtype)


def embed_apply(params: dict, tokens: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """Gather, then cast: the same values as casting the table first.  The
    gather is ``F.embedding``, whose backward (a sorted segment sum on the
    card) adds a repeated token's gradients in a fixed order.  Under ``tp``
    the table holds the rank's vocab rows: ids outside them give zero rows,
    and the float32 sum over the ranks leaves each id its one real row."""
    table = params["embedding"]
    if tp is None or tp.size == 1:
        return F.embedding(tokens, table).to(cfg.dtype)
    rows = table.shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(mine, local, 0), table).to(torch.float32)
    x = torch.where(mine[..., None], x, 0.0)
    return reduce_from(tp, x).to(cfg.dtype)


def logits_apply(params: dict, x: torch.Tensor, cfg, impl=None, tp=None) -> torch.Tensor:
    """Tied logits, where 1/sqrt(d) keeps them in the regime of a
    fan-in-scaled head; an untied model's ``head`` goes through ``dense``.
    Under ``tp`` each rank computes its vocab columns and the ranks'
    columns are gathered in order."""
    x = copy_to(tp, x)
    if cfg.tie_embeddings and "head" not in params:
        logits = (x @ params["embedding"].to(x.dtype).T) * (cfg.d_model ** -0.5)
    else:
        logits = dense(params["head"], x, impl=impl)
    return gather_replicated(tp, logits)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, H, D] (D even); positions: [B, S] int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gelu(h: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(h, approximate="tanh")


def activation(h: torch.Tensor, cfg) -> torch.Tensor:
    """GELU, or SwiGLU over the fused ``[gate; up]`` halves of ``h``."""
    if cfg.act == "gelu":
        return gelu(h)
    gate, up = torch.chunk(h, 2, dim=-1)
    return F.silu(gate) * up


def mlp_apply(params: dict, x: torch.Tensor, cfg, impl=None, tp=None) -> torch.Tensor:
    """GELU over ``w_in [d, d_ff]``, or SwiGLU with the fused ``[gate; up]``
    input projection ``[d, 2·d_ff]``.  Under ``tp`` the rank holds its share
    of the gate and of the up columns (column-parallel) and ``w_out``'s
    matching rows (row-parallel)."""
    h = activation(dense(params["w_in"], copy_to(tp, x), impl=impl), cfg)
    return row_parallel(params["w_out"], h, tp, impl=impl)
