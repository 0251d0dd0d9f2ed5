"""ModelConfig for the PyTorch port, with torch dtypes.

The port keeps its own copy of ``repro.configs.base.ModelConfig`` (it never
imports the JAX package), holding the fields its serving path reads, with
the reference's defaults: the dense family (GQA attention or MLA, a dense
FFN a layer) and the MoE family (sort-dispatch experts, shared experts and
leading dense layers).  The SSM, cross-attention and sliding-window fields
arrive with the architectures that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    attn_type: str = "gqa"  # gqa | mla
    qkv_bias: bool = False  # float32 biases added after the q, k, v projections
    qk_norm: bool = False  # per-head RMSNorm on q and k
    rope_theta: float = 10000.0

    # --- MLA (minicpm3 / deepseek-v2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0  # 0 => full-rank q projection
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_period: int = 1  # layer i is MoE iff i % moe_period == moe_offset
    moe_offset: int = 0
    first_k_dense: int = 0  # leading dense-FFN layers (deepseek)
    capacity_factor: float = 1.25
    moe_impl: str = "sort"  # sort (compute-optimal) | einsum (SPMD-friendly)

    # --- misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # Decode-cache residency format: a name registered in
    # repro_torch.core.kvcache.FORMATS; None means "bf16".
    cache_format: Optional[str] = None

    @property
    def q_head_dim(self) -> int:
        """Per-head q/k dimension (MLA concatenates nope+rope parts)."""
        if self.attn_type == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.d_head

    def mixer_kind(self, layer_idx: int) -> str:
        """The mixer of a layer: every layer the port serves is self-attention
        (GQA or MLA by ``attn_type``)."""
        del layer_idx
        return "attn"

    def ffn_kind(self, layer_idx: int) -> str:
        """'dense' | 'moe' for global layer index."""
        if self.n_experts and layer_idx >= self.first_k_dense:
            if layer_idx % self.moe_period == self.moe_offset:
                return "moe"
        return "dense"

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **overrides)
