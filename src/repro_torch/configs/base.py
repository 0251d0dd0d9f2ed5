"""ModelConfig for the PyTorch port, with torch dtypes.

The port keeps its own copy of ``repro.configs.base.ModelConfig`` (it never
imports the JAX package), holding the fields its serving path reads, with
the reference's defaults: the dense family (GQA attention or MLA, a dense
FFN a layer), the MoE family (sort-dispatch experts, shared experts and
leading dense layers, a sliding window), the SSM family (Mamba-1 mixers
and no FFN), the hybrid family (Mamba and attention interleaved in a
periodic superblock), the VLM family (cross-attention layers over a
context of patch embeddings in place of self-attention) and the audio
family (an encoder-decoder whose every decoder layer cross-attends to the
encoder's output).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
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
    sliding_window: Optional[int] = None  # keep a key iff q_pos - k_pos < window
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

    # --- mamba / hybrid ---
    attn_period: int = 0  # 0 = every layer attn; >0: attn iff i % p == offset
    attn_offset: int = 0
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # --- cross-attention (vlm / enc-dec decoder) ---
    cross_attn_period: int = 0  # >0: layer i has cross-attn iff i % p == offset
    cross_attn_offset: int = 0
    encoder_tokens: int = 0  # stub frontend sequence length (patches/frames)

    # --- encoder-decoder ---
    is_enc_dec: bool = False
    n_enc_layers: int = 0

    # --- misc ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # Decode-cache residency format: a name registered in
    # repro_torch.core.kvcache.FORMATS; None means "bf16".
    cache_format: Optional[str] = None

    # --- layout ---
    block_period: int = 1  # layers per superblock of the reference's stacking

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def q_head_dim(self) -> int:
        """Per-head q/k dimension (MLA concatenates nope+rope parts)."""
        if self.attn_type == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.d_head

    def mixer_kind(self, layer_idx: int) -> str:
        """'attn' (GQA or MLA by ``attn_type``) | 'mamba' | 'cross' |
        'attn_cross' for global layer index.

        'cross' (vlm): the layer's mixer IS cross-attention (replaces self).
        'attn_cross' (enc-dec decoder): self-attention followed by
        cross-attention within the same layer.
        """
        if self.family == "ssm":
            return "mamba"
        if self.attn_period > 0 and layer_idx % self.attn_period != self.attn_offset:
            return "mamba"
        if (self.cross_attn_period > 0
                and layer_idx % self.cross_attn_period == self.cross_attn_offset):
            return "attn_cross" if self.is_enc_dec else "cross"
        return "attn"

    def ffn_kind(self, layer_idx: int) -> str:
        """'dense' | 'moe' | 'none' for global layer index."""
        if self.family == "ssm":
            return "none"  # the Mamba block subsumes the FFN
        if self.n_experts and layer_idx >= self.first_k_dense:
            if layer_idx % self.moe_period == self.moe_offset:
                return "moe"
        return "dense"

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **overrides)
