"""Decoder blocks (dense, MoE, mamba and encdec) and the embedding lookup.

Port of the serving parts of ``repro/nn/transformer.py``, one call per
layer (the reference's ``lax.scan`` over layer-stacked leaves becomes a
loop over per-layer parameter dicts):

  dense — RMSNorm -> GQA attention -> RMSNorm -> MLP
  moe   — RMSNorm -> GQA attention -> RMSNorm -> MoE FFN
  mamba — RMSNorm -> mamba1 or mamba2 mixer ({"ln", "mix"})
  encdec — the encoder block is the dense block run with causal=False;
           the decoder block adds RMSNorm -> cross-attention ("ln_x",
           "xattn") between the self-attention and the MLP

``block_forward`` calls the block that a layer's parameters name (an
"moe" entry makes it an MoE block). ``*_block_logical`` give a layer's
logical axes (``LM.logical``, read by ``nn.sharding``); ``tp`` (an
``nn.sharding.TPContext``, the model axis) reaches the attention, MLP and
MoE all-reduces, each taken where the model axis cuts that leaf
(``nn.sharding.placed``). A mamba block serves replicated under tensor
parallelism, as the reference's does (serving's rules name no mamba axis);
on a training grid its channels are cut over model (``ssm``). ``sp`` (the
model axis under sequence parallelism, training only) makes x the rank's
block along seq: each norm on the residual runs on that block, its weight
read through ``copy_in`` (the rank's tokens give a partial gradient), and
each sublayer gathers the whole sequence and hands back the rank's block.
Serving on a grid passes ``kv_seq`` (the model axis, which cuts the decode
caches' sequence) to the attention blocks (``block_forward``'s ``**kw``,
``decoder_xblock_forward``'s self- and cross-attention), and the model
axis as ``tp`` to the mamba blocks, whose recurrent states are the rank's
channels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantizers import QuantizedTensor, dequantize
from repro_torch.kernels.ops import KernelSet
from .attention import attn_forward, attn_logical
from .layers import Param, mlp_forward, mlp_logical, rmsnorm
from .moe import moe_forward, moe_logical
from .sharding import placed
from . import ssm


def dense_block_logical(cfg) -> dict:
    return {"ln1": ("p_unsharded",), "attn": attn_logical(cfg),
            "ln2": ("p_unsharded",), "mlp": mlp_logical(cfg.act)}


def moe_block_logical(cfg) -> dict:
    return {"ln1": ("p_unsharded",), "attn": attn_logical(cfg),
            "ln2": ("p_unsharded",), "moe": moe_logical(cfg)}


def encdec_block_logical(cfg, cross: bool = False) -> dict:
    p = dense_block_logical(cfg)
    if cross:
        p["ln_x"] = ("p_unsharded",)
        p["xattn"] = attn_logical(cfg)
    return p


def mamba_block_logical(cfg) -> dict:
    """A mamba layer's axes (the reference's mamba{1,2}_logical): serving's
    tensor-parallel rules name none of its channel dims, so the mixer
    replicates there; the training rules cut d_inner, d_inner2, d_inner_r
    and heads_r over model."""
    if cfg.family == "ssm":
        mix = {"in_proj": ("p_embed", "d_inner"), "conv_w": ("conv", "d_inner"),
               "conv_b": ("d_inner",), "x_proj": ("d_inner_r", "p_unsharded"),
               "dt_proj": ("p_unsharded", "d_inner"), "dt_bias": ("d_inner",),
               "A_log": ("d_inner", "state"), "D": ("d_inner",),
               "out_proj": ("d_inner_r", "p_embed")}
    else:
        mix = {"in_proj": ("p_embed", "d_inner2"), "conv_w": ("conv", "d_inner2"),
               "conv_b": ("d_inner2",), "A_log": ("heads_r",), "dt_bias": ("heads_r",),
               "D": ("heads_r",), "norm_w": ("d_inner",),
               "out_proj": ("d_inner_r", "p_embed")}
    return {"ln": ("p_unsharded",), "mix": mix}


def _norm(x: torch.Tensor, w, cfg, sp) -> torch.Tensor:
    """RMSNorm of the residual; under sequence parallelism (``sp``) x is the
    rank's block along seq, so the weight's gradient is partial and is read
    through ``copy_in``."""
    return rmsnorm(x, w if sp is None else sp.copy_in(w), cfg.norm_eps)


def _attn_residual(p, x, cfg, rcfg, sp=None, **attn_kw):
    h, new_kv = attn_forward(p["attn"], _norm(x, p["ln1"], cfg, sp), cfg,
                             rcfg, sp=sp, **attn_kw)
    return x + h, new_kv


def dense_block_forward(p: dict, x: torch.Tensor, cfg, rcfg, *,
                        kernels: Optional[KernelSet] = None, tp=None, sp=None, **attn_kw):
    """``attn_kw`` goes to ``attn_forward`` (positions, the dense or paged
    cache, paged prefill, KV format and scales)."""
    x, new_kv = _attn_residual(p, x, cfg, rcfg, sp, kernels=kernels, tp=tp, **attn_kw)
    return x + _mlp(p, x, cfg, kernels, tp, sp), new_kv


def _mlp(p: dict, x: torch.Tensor, cfg, kernels, tp, sp) -> torch.Tensor:
    """The block's MLP on RMSNorm(x), with the model axis where it cuts d_ff."""
    tp = placed(tp, p["mlp"]["wo"].shape[0], cfg.d_ff)
    return mlp_forward(p["mlp"], _norm(x, p["ln2"], cfg, sp), cfg.act,
                       kernels=kernels, tp=tp, sp=sp)


def moe_block_forward(p: dict, x: torch.Tensor, cfg, rcfg, *,
                      kernels: Optional[KernelSet] = None, tp=None, batch=None, sp=None,
                      **attn_kw):
    """Attention as in ``dense_block_forward``, then the MoE FFN (``batch``:
    ``moe_forward``'s)."""
    x, new_kv = _attn_residual(p, x, cfg, rcfg, sp, kernels=kernels, tp=tp, **attn_kw)
    x = x + moe_forward(p["moe"], _norm(x, p["ln2"], cfg, sp), cfg,
                        kernels=kernels, tp=tp, batch=batch, sp=sp)
    return x, new_kv


def block_forward(p: dict, x: torch.Tensor, cfg, rcfg, batch=None, **kw):
    """The block that ``p`` names: MoE if it holds "moe" (given ``batch``),
    else dense."""
    if "moe" in p:
        return moe_block_forward(p, x, cfg, rcfg, batch=batch, **kw)
    return dense_block_forward(p, x, cfg, rcfg, **kw)


def decoder_xblock_forward(p: dict, x: torch.Tensor, cfg, rcfg, *, positions,
                           xa: Optional[torch.Tensor] = None, cache=None,
                           cache_pos=None, kernels: Optional[KernelSet] = None, tp=None,
                           sp=None, xsp=None, kv_seq=None):
    """Whisper decoder block: self-attention (with its cache), then
    cross-attention after ``ln_x``, then the MLP. Prefill passes the
    encoder states ``xa``; decode passes ``cache`` = the layer's {"k", "v"}
    and its static cross cache "xk", "xv" (B, G, Se, Dh) with its length
    "xlen". ``tp``: the model axis of a training grid; ``sp`` and ``xsp``:
    that axis where sequence parallelism cuts x and xa along seq; ``kv_seq``
    (serving on a grid) that axis where it cuts both caches' sequence.
    Returns (x, the self-attention's new_kv)."""
    self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    x, new_kv = _attn_residual(p, x, cfg, rcfg, sp, positions=positions,
                               cache=self_cache, cache_pos=cache_pos,
                               kernels=kernels, tp=tp, kv_seq=kv_seq)
    xcache = None
    if cache is not None and "xk" in cache:
        xcache = {"k_static": cache["xk"], "v_static": cache["xv"],
                  "len": cache["xlen"]}
    h, _ = attn_forward(p["xattn"], _norm(x, p["ln_x"], cfg, sp), cfg,
                        rcfg, positions=positions, xa=xa, cache=xcache,
                        kernels=kernels, tp=tp, sp=sp, xsp=xsp, kv_seq=kv_seq)
    x = x + h
    return x + _mlp(p, x, cfg, kernels, tp, sp), new_kv


def mamba_block_forward(p: dict, x: torch.Tensor, cfg, *, cache=None,
                        kernels: Optional[KernelSet] = None, variant: str = "mamba1",
                        tp=None, sp=None):
    """x + mixer(RMSNorm(x)); ``cache`` {"conv", "ssm"} carries the layer's
    recurrent state; ``tp``: the model axis of a training grid, ``sp`` that
    axis where sequence parallelism cuts x along seq. Returns (x, the new
    state or None)."""
    fwd = ssm.mamba1_forward if variant == "mamba1" else ssm.mamba2_forward
    h, new_cache = fwd(p["mix"], _norm(x, p["ln"], cfg, sp), cfg,
                       cache=cache, kernels=kernels, tp=tp, sp=sp)
    return x + h, new_cache


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
