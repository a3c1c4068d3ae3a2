"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion VQ image tokens (image tokens live in the vocab;
the VQ tokenizer is the assignment's stub), qk-norm [arXiv:2405.09818]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="dense",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab_size=65536, act="silu", qk_norm=True,
    rope_theta=10000.0,
)
