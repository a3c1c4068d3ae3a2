"""FxP(M, F) — two's-complement linear fixed-point quantization.

Port of ``repro/core/fxp.py``: M total bits, F fraction bits, value =
code/2^F, codes clamped to [-2^(M-1), 2^(M-1)-1], round half to even
(``torch.round`` rounds half to even, like ``jnp.round``).
"""
from __future__ import annotations

import torch

__all__ = ["fxp_quantize", "fxp_dequantize", "compute_scale"]


def fxp_quantize(x: torch.Tensor, M: int, F: int) -> torch.Tensor:
    lo = -(1 << (M - 1))
    hi = (1 << (M - 1)) - 1
    scaled = torch.round(x.to(torch.float32) * float(1 << F))
    return scaled.clamp(lo, hi).to(torch.int32)


def fxp_dequantize(codes: torch.Tensor, F: int,
                   dtype=torch.float32) -> torch.Tensor:
    return codes.to(dtype) * (1.0 / (1 << F))


def compute_scale(w: torch.Tensor, mode: str = "tensor_pow2",
                  axis: int | None = None, eps: float = 1e-12) -> torch.Tensor:
    """Normalizer scale so that w/scale is within [-1, 1].

    mode: "none" | "tensor" | "tensor_pow2" | "channel" | "channel_pow2";
    ``axis`` is the output-channel axis kept for channel modes. The pow2
    modes round up to ``exp2(ceil(log2 s))``; torch's log2 and exp2 are
    exact at powers of two (ROADMAP Queue C records where the reference's
    CPU log2/exp2 are not).
    """
    if mode == "none":
        return torch.ones((1,) * w.ndim, dtype=torch.float32, device=w.device)
    a = w.abs()
    if mode.startswith("tensor"):
        s = a.max().clamp_min(eps).reshape((1,) * a.ndim)
    elif mode.startswith("channel"):
        if axis is None:
            raise ValueError("channel scale mode requires axis")
        red = tuple(i for i in range(a.ndim) if i != axis % a.ndim)
        s = torch.amax(a, dim=red, keepdim=True).clamp_min(eps)
    else:
        raise ValueError(f"unknown scale mode {mode!r}")
    if mode.endswith("pow2"):
        s = torch.exp2(torch.ceil(torch.log2(s)))
    return s.to(torch.float32)
