"""minicpm3-4b [dense]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA.

Multi-head Latent Attention with low-rank q and kv projections.
[hf:openbmb/MiniCPM3-4B]  A copy of the reference's config; the reference
pads vocab 73448 to 73472 for its 16-way TP axis, one card does not pad.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab_size=73448,
    attn_type="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128,
    vocab_size=512, kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16,
    qk_rope_dim=8, v_head_dim=16,
)
