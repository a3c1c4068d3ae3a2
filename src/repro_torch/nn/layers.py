"""Primitive layers: quantization-aware matmul, RMSNorm, rotary, MLPs.

Port of ``repro/nn/layers.py``. Weights are plain tensors or
``QuantizedTensor``; ``matmul_param`` sends quantized weights through
``kernels.ops.quant_matmul``. ``kernels`` is None (dequantize + matmul) or a
``KernelSet`` (the hand-written kernels, or their plain versions).
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.quantizers import QuantizedTensor, dequantize
from repro_torch.kernels.ops import KernelSet, out_channel_scale, quant_matmul
from .sharding import seq_in, seq_out

Param = Union[torch.Tensor, QuantizedTensor]


def param_value(w: Param, dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize (or cast) a parameter for direct elementwise use."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w, dtype)
    return w.to(dtype)


def matmul_param(x: torch.Tensor, w: Param, *, out_shape=None,
                 kernels: Optional[KernelSet] = None) -> torch.Tensor:
    """x (..., k) @ w (k, ...) with quantized-weight dispatch; ``w`` may have
    several output dims (e.g. (d_model, H, Dh)). A quantized weight whose
    scale varies along the contraction axis raises."""
    if isinstance(w, QuantizedTensor):
        k = w.codes.shape[0]
        w2 = QuantizedTensor(w.codes.reshape(k, -1),
                             out_channel_scale(w.scale, w.codes.shape), w.spec)
        y = quant_matmul(x, w2, kernels=kernels)
        tail = w.codes.shape[1:]
    else:
        k = w.shape[0]
        y = torch.matmul(x, w.reshape(k, -1).to(x.dtype))
        tail = w.shape[1:]
    return y.reshape(*x.shape[:-1], *(out_shape or tail))


def rmsnorm(x: torch.Tensor, w: Param, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * param_value(w, torch.float32)).to(dt)


def rotary_cos_sin(positions: torch.Tensor, d_head: int, theta: float):
    """cos/sin tables for the given positions: (..., d_head//2)."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B, S, Dh//2) -> broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name in ("gelu", "gelu_plain"):
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def is_gated(act: str) -> bool:
    return act in ("silu", "gelu")


def mlp_forward(p: dict, x: torch.Tensor, act: str,
                kernels: Optional[KernelSet] = None, tp=None, sp=None) -> torch.Tensor:
    """Gated (silu/gelu: wg, wu, wo) or plain (relu2/gelu_plain: wi, wo) MLP.
    Under tensor parallelism (``tp``, an ``nn.sharding.TPContext``: the
    caller passes it where the model axis cuts the hidden dim, None where
    the MLP is whole on every rank) the up-projections are column-sharded
    and the down-projection row-sharded over the rank's d_ff: its partial
    products are all-reduced, the block's one MLP collective
    (``reduce_out``; in training x comes in through ``copy_in``, whose
    backward sums the ranks' partial gradients). Under sequence parallelism
    (``sp``) x is the rank's block along seq: the MLP reads it through
    ``seq_in`` and returns through ``seq_out``."""
    fn = activation(act)
    x = seq_in(x, sp, tp)
    if is_gated(act):
        h = fn(matmul_param(x, p["wg"], kernels=kernels)) \
            * matmul_param(x, p["wu"], kernels=kernels)
    else:
        h = fn(matmul_param(x, p["wi"], kernels=kernels))
    return seq_out(matmul_param(h, p["wo"], kernels=kernels), sp, tp)


def mlp_logical(act: str) -> dict:
    """Logical axes of the MLP weights (``nn.sharding``'s rules)."""
    if is_gated(act):
        return {"wg": ("p_embed", "mlp"), "wu": ("p_embed", "mlp"),
                "wo": ("mlp", "p_embed")}
    return {"wi": ("p_embed", "mlp"), "wo": ("mlp", "p_embed")}


def mlp_shapes(d_model: int, d_ff: int, act: str) -> dict:
    """{name: (in_dim, out_dims)} of the MLP weights."""
    if is_gated(act):
        return {"wg": (d_model, (d_ff,)), "wu": (d_model, (d_ff,)),
                "wo": (d_ff, (d_model,))}
    return {"wi": (d_model, (d_ff,)), "wo": (d_ff, (d_model,))}
