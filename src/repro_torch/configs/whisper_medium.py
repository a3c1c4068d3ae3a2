"""whisper-medium [audio]: 24+24L enc-dec d_model=1024 16H d_ff=4096
vocab=51865 — conv frontend is a STUB (input_specs provides precomputed
frame embeddings) [arXiv:2212.04356]. Plain (non-gated) GELU MLPs."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_head=64, d_ff=4096, vocab_size=51865, act="gelu_plain",
    frontend="stub_audio", rope_theta=10000.0,
)
