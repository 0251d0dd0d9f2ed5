"""ModelConfig for the PyTorch port, with torch dtypes.

The port keeps its own copy of ``repro.configs.base.ModelConfig`` (it never
imports the JAX package), holding the fields the dense GQA serving path
reads, with the reference's defaults.  The MoE, MLA, SSM,
cross-attention and sliding-window fields arrive with the architectures
that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family the port serves so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False  # float32 biases added after the q, k, v projections
    qk_norm: bool = False  # per-head RMSNorm on q and k
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # Decode-cache residency format: a name registered in
    # repro_torch.core.kvcache.FORMATS; None means "bf16".
    cache_format: Optional[str] = None

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family/topology, tiny dims)."""
        return dataclasses.replace(self, **overrides)
