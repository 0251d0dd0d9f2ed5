"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336.

Cross-attention image layers every 5th layer (8 of 40), vocab 128256.
[hf:meta-llama/Llama-3.2-11B-Vision]  The vision tower is a stub: the
caller supplies precomputed patch embeddings [batch, 1601, d_model]
(``batch["ctx_embeds"]``) and the decoder cross-attends to them.  A copy
of the reference's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_period=5,
    cross_attn_offset=3,
    encoder_tokens=1601,
    block_period=5,
    rope_theta=5e5,
)

SMOKE = CONFIG.scaled(
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
    vocab_size=512, encoder_tokens=17, block_period=5,
)
