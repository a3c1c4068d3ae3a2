"""zamba2-1.2b [hybrid]: 38L mamba2 d_model=2048 + ONE shared attention
block (32H kv=32, d_ff=8192) applied every 6 ssm layers, ssm_state=64
[arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=32000, act="gelu_plain",
    ssm_state=64, d_inner=4096, conv_width=4, ssm_head_dim=64, ssm_chunk=128,
    attn_every=6, rope_theta=10000.0,
)
