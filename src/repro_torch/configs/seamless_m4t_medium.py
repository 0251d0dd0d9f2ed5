"""seamless-m4t-medium [audio]: enc-dec, 12+12L d_model=1024 16H d_ff=4096.

vocab 256206.  [arXiv:2308.11596]  The speech frontend is a stub: the
caller supplies precomputed frame embeddings [batch, 1536, d_model]
(``batch["enc_embeds"]``); the encoder runs them through its non-causal
stack and the text decoder cross-attends to its output.  A copy of the
reference's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=4096,
    vocab_size=256206,
    is_enc_dec=True,
    n_enc_layers=12,
    cross_attn_period=1,  # every decoder layer cross-attends
    cross_attn_offset=0,
    encoder_tokens=1536,
    norm="layernorm",
    act="gelu",
)

SMOKE = CONFIG.scaled(
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_head=16, d_ff=128, vocab_size=512, encoder_tokens=24,
)
