"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.

GQA with 2 KV heads, RoPE, LayerNorm + GELU, untied head.  [arXiv:2402.19173]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    rope_theta=1e5,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_head=12, d_ff=96,
    vocab_size=256,
)
