"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba-1.

ssm_state=16, d_inner=8192, vocab 65024, tied embeddings.
[arXiv:2410.05355]  The decode state is O(1) in the sequence length.  A
copy of the reference's config.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=65024,
    d_state=16,
    d_conv=4,
    expand=2,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, d_state=4, vocab_size=512)
