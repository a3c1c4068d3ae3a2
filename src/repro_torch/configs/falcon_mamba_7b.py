"""falcon-mamba-7b [ssm]: 64L d_model=4096 attn-free vocab=65024,
ssm_state=16 — mamba1 selective-scan arch [arXiv:2410.05355]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_head=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, d_inner=8192, conv_width=4, dt_rank=256,
)
