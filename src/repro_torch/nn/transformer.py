"""Dense decoder block and the embedding lookup.

Port of the dense parts of ``repro/nn/transformer.py``: RMSNorm -> GQA
attention -> RMSNorm -> gated MLP, one call per layer (the reference's
``lax.scan`` over layer-stacked leaves becomes a loop over per-layer
parameter dicts).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizers import QuantizedTensor, dequantize
from repro_torch.kernels.ops import KernelSet
from .attention import attn_forward
from .layers import Param, mlp_forward, rmsnorm


def dense_block_forward(p: dict, x: torch.Tensor, cfg, rcfg, *,
                        positions, cache=None, cache_pos=None,
                        kernels: Optional[KernelSet] = None, kv_spec=None,
                        kv_scales=None):
    h, new_kv = attn_forward(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg,
                             rcfg, positions=positions, cache=cache,
                             cache_pos=cache_pos, kernels=kernels,
                             kv_spec=kv_spec, kv_scales=kv_scales)
    x = x + h
    x = x + mlp_forward(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.act,
                        kernels=kernels)
    return x, new_kv


def embed_tokens(emb: Param, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding lookup. A quantized table is gathered as codes first and
    only the gathered rows are dequantized: dequantize is elementwise, so
    this is bit-identical to dequantizing the whole table and gathering
    (which at full width would make a ~1 GB f32 temporary every step)."""
    if isinstance(emb, QuantizedTensor):
        rows = QuantizedTensor(emb.codes[tokens], emb.scale, emb.spec)
        return dequantize(rows, dtype)
    return emb[tokens].to(dtype)
