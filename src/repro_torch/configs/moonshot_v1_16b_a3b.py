"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) expert
d_ff=1408 vocab=163840, MoE 64e top-6 + 2 shared experts (moonlight /
deepseek-v3 style) [hf:moonshotai/Moonlight-16B-A3B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=163840, act="silu",
    n_experts=64, top_k=6, moe_every=1, n_shared_experts=2,
    rope_theta=50000.0,
)
