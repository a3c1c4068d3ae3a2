"""Quantized-matmul dispatch — what the model layers call.

Port of ``repro/kernels/ops.py``. ``quant_matmul`` picks the datapath for
activations and a QuantizedTensor weight:

  pofx   + kernels  -> fused PoFx decode + matmul (Move & Store)
  fxp    + kernels  -> per-tensor int8 activations, int8 MAC (fxp_matmul)
  otherwise         -> dequantize + torch.matmul (decode at load)

``kernels`` is a ``KernelSet``: ``KERNELS`` holds the wrappers (which
launch on CUDA tensors and compute the plain version on CPU tensors),
``PLAIN`` holds the plain versions themselves, for reference runs of the
same datapath on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.quantizers import QuantizedTensor, dequantize, fxp_view
from .fxp_matmul import fxp_matmul, fxp_matmul_ref
from .kv_flash_decode import kv_flash_decode, kv_flash_decode_ref
from .kv_flash_paged_decode import (kv_flash_paged_decode,
                                    kv_flash_paged_decode_ref)
from .pofx_decode import pofx_decode
from .pofx_matmul import pofx_matmul, pofx_matmul_ref

__all__ = ["KernelSet", "KERNELS", "PLAIN", "quant_matmul",
           "out_channel_scale", "pofx_decode", "pofx_matmul", "fxp_matmul"]


@dataclasses.dataclass(frozen=True)
class KernelSet:
    pofx_matmul: Callable
    fxp_matmul: Callable
    kv_flash_decode: Callable
    kv_flash_paged_decode: Callable


KERNELS = KernelSet(pofx_matmul, fxp_matmul, kv_flash_decode,
                    kv_flash_paged_decode)
PLAIN = KernelSet(pofx_matmul_ref, fxp_matmul_ref, kv_flash_decode_ref,
                  kv_flash_paged_decode_ref)


def out_channel_scale(scale: torch.Tensor, codes_shape) -> torch.Tensor:
    """Validate a QuantizedTensor scale layout and collapse it to (1, n).

    The normalizer is applied after the contraction, which is sound only
    when the scale is constant along the contraction axis (codes axis 0):
    per-output-channel, per-tensor, or any broadcast shape that never
    covers axis 0. Anything else raises.
    """
    sshape = tuple(scale.shape)
    codes_shape = tuple(codes_shape)
    if len(sshape) > len(codes_shape):
        raise ValueError(
            f"scale rank {len(sshape)} exceeds codes rank {len(codes_shape)} "
            f"(scale {sshape} vs codes {codes_shape})")
    if len(sshape) == len(codes_shape) and sshape[0] != 1:
        raise ValueError(
            f"unsupported scale layout {sshape} for codes "
            f"{codes_shape}: the scale varies along the contraction "
            "axis (codes axis 0); quantized matmuls apply the normalizer "
            "after the contraction, so only per-output-channel or "
            "per-tensor scales are representable")
    try:
        out = torch.broadcast_to(scale, (1, *codes_shape[1:]))
    except RuntimeError as e:
        raise ValueError(
            f"scale shape {sshape} does not broadcast against the output "
            f"dims of codes {codes_shape}: {e}") from None
    return out.reshape(1, -1)


def quant_matmul(x: torch.Tensor, w: QuantizedTensor, *,
                 kernels: Optional[KernelSet] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x (..., k) @ dequant(w), w codes (k, n)."""
    out_dtype = out_dtype or x.dtype
    spec = w.spec
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if spec.kind == "pofx" and kernels is not None:
        scale = out_channel_scale(w.scale, w.codes.shape).reshape(-1)
        y = kernels.pofx_matmul(x2, w.codes, scale, spec.N, spec.ES, spec.M)
        return y.reshape(*lead, -1).to(out_dtype)
    if spec.kind == "fxp" and kernels is not None:
        codes, rescale = fxp_view(w)
        rescale = out_channel_scale(rescale, w.codes.shape)
        # int8 activations: per-tensor symmetric quantization of x
        xmax = x2.abs().max().clamp_min(1e-6)
        xq = torch.round(x2 / xmax * 127.0).clamp(-127, 127).to(torch.int8)
        acc = kernels.fxp_matmul(xq, codes)
        y = acc.to(torch.float32) * (xmax / 127.0) * rescale
        return y.reshape(*lead, -1).to(out_dtype)
    wv = dequantize(w, torch.bfloat16 if out_dtype == torch.bfloat16
                    else torch.float32)
    y = torch.matmul(x2.to(wv.dtype), wv)
    return y.reshape(*lead, -1).to(out_dtype)
