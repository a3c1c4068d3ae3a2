"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1 + 1 shared expert, interleaved
(every other layer MoE) — early fusion [hf:meta-llama/Llama-4]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=202048, act="silu",
    n_experts=128, top_k=1, moe_every=2, n_shared_experts=1,
    rope_theta=500000.0,
)
