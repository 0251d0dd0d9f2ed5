"""Shared model layers: dense dispatch, norms, embeddings, RoPE, MLPs.

Counterpart of :mod:`repro.models.layers` (RMSNorm or LayerNorm, SwiGLU or
GELU, tied or untied head), as plain functions on tensors.  ``dense`` is the
single projection entry point (``dense_stacked`` its counterpart for a MoE
layer's stacked expert weights): a weight converted to a
:class:`~repro_torch.core.residency.QuantLinearState` goes through its
residency format — the kernel path by default, the plain PyTorch path with
``impl="plain"`` — and a float weight is a plain matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import residency


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


def embed_apply(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Gather, then cast: the same values as casting the table first.  The
    gather is ``F.embedding``, whose backward (a sorted segment sum on the
    card) adds a repeated token's gradients in a fixed order."""
    return F.embedding(tokens, params["embedding"]).to(cfg.dtype)


def logits_apply(params: dict, x: torch.Tensor, cfg, impl=None) -> torch.Tensor:
    """Tied logits, where 1/sqrt(d) keeps them in the regime of a
    fan-in-scaled head; an untied model's ``head`` goes through ``dense``."""
    if cfg.tie_embeddings and "head" not in params:
        return (x @ params["embedding"].to(x.dtype).T) * (cfg.d_model ** -0.5)
    return dense(params["head"], x, impl=impl)


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


def mlp_apply(params: dict, x: torch.Tensor, cfg, impl=None) -> torch.Tensor:
    """GELU over ``w_in [d, d_ff]``, or SwiGLU with the fused ``[gate; up]``
    input projection ``[d, 2·d_ff]``."""
    h = activation(dense(params["w_in"], x, impl=impl), cfg)
    return dense(params["w_out"], h, impl=impl)
