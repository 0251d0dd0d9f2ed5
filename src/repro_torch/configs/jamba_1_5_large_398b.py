"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.  [arXiv:2403.19887]
Superblock of 8 layers: attention at slot 4, Mamba elsewhere; MoE FFN on odd
slots, dense FFN on even.  A copy of the reference's config; at full size
its weights (~398 B parameters) do not fit one card.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_tok=2,
    moe_d_ff=24576,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    d_state=16,
    d_conv=4,
    expand=2,
    block_period=8,
    rope_theta=1e6,
)

SMOKE = CONFIG.scaled(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=512, n_experts=4, experts_per_tok=2, moe_d_ff=128, d_state=4,
    capacity_factor=8.0,
)
