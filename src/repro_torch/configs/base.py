"""Config system: model architectures, input shapes, quantization, run opts.

Every assigned architecture is one ``ModelConfig`` in this package (exact
numbers from the assignment table) plus a ``smoke()`` reduction of the same
family used by CPU tests. Shapes are the four assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.quantizers import QuantSpec

__all__ = ["ModelConfig", "ShapeConfig", "RunConfig", "SHAPES", "smoke"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    act: str = "silu"            # silu | gelu (gated MLPs) | relu2 (squared ReLU)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # every k-th layer is MoE (1 = all layers)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    d_inner: int = 0
    conv_width: int = 4
    dt_rank: int = 0
    ssm_head_dim: int = 64       # mamba2 head dim
    ssm_chunk: int = 128         # mamba2 SSD chunk length
    # hybrid (zamba2): one shared attention block applied every k ssm layers
    attn_every: int = 0
    # enc-dec (whisper)
    n_enc_layers: int = 0
    frontend: str = "none"       # none | stub_audio | stub_vision
    # misc
    qk_norm: bool = False
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def attn_dims_ok_message(self) -> str:
        return ""

    def param_count(self) -> int:
        """Analytic total parameter count (for 6ND model-flops)."""
        d, L, V = self.d_model, self.n_layers, self.padded_vocab
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d
        if self.family in ("dense", "moe", "encdec"):
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                + self.n_heads * self.d_head * d
            if self.act in ("silu", "gelu"):
                mlp_dense = 3 * d * self.d_ff
            else:
                mlp_dense = 2 * d * self.d_ff
            if self.family == "moe":
                n_moe = L // self.moe_every
                n_dense = L - n_moe
                mlp = n_dense * mlp_dense + n_moe * (
                    self.n_experts * mlp_dense + d * self.n_experts
                    + self.n_shared_experts * mlp_dense)
                n += L * attn + mlp
            else:
                layers = L + self.n_enc_layers
                n += layers * (attn + mlp_dense)
                if self.family == "encdec":
                    n += L * attn  # decoder cross-attention
            n += L * 2 * d
        elif self.family in ("ssm", "hybrid"):
            di, ds = self.d_inner, self.ssm_state
            mamba = 2 * d * di + di * self.conv_width + di * (self.dt_rank + 2 * ds) \
                + self.dt_rank * di + di * ds + di + di * d
            n += L * mamba + L * d
            if self.family == "hybrid" and self.attn_every:
                attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head \
                    + self.n_heads * self.d_head * d + 3 * d * self.d_ff
                n += attn  # ONE shared block (zamba2)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        if self.act in ("silu", "gelu"):
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        n_moe = L // self.moe_every
        inactive = n_moe * (self.n_experts - self.top_k - self.n_shared_experts) * mlp_dense
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything the launcher needs besides the model itself."""
    quant: QuantSpec = QuantSpec(kind="bf16")      # serving weight format
    weight_dtype: str = "bf16"                      # training param compute dtype
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    microbatch: int = 0                             # 0 = no grad accumulation
    remat: str = "block"                            # none | block
    kv_cache_dtype: str = "bf16"                    # bf16 | int8
    opt_state_quant: str = "none"                   # none | posit8 (beyond-paper)
    grad_compression: str = "none"                  # none | posit8 (cross-pod)
    zero_shard: bool = True                         # shard opt state over data
    sequence_parallel: bool = False                 # Megatron-SP residuals
    serve_bf16_compute: bool = False                # bf16 q/p in decode attn
    #   (TPU-native mixed dot; CPU runtime can't execute bf16xbf16 thunks,
    #    so smoke tests keep f32 and the dry-run opts in)
    activation_dtype: str = "bf16"
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    seed: int = 0


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2 if cfg.family != "hybrid" else 3),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        d_inner=256 if cfg.d_inner else 0,
        dt_rank=8 if cfg.dt_rank else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        vocab_pad_multiple=64,
        rope_theta=10000.0,
    )
