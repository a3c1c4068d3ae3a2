"""Quantizer registry — ExPAN(N)D storage/compute formats.

Port of ``repro/core/quantizers.py``. A ``QuantSpec`` names one point of
the paper's design space (fp32 | bf16 | fxp | posit | pofx); a
``QuantizedTensor`` is a plain dataclass of two tensors (codes, scale) and
its spec. The KV-cache helpers quantize K/V elementwise against a STATIC
per-head-dim-channel scale, so re-quantizing the same float always gives
the same code (the evict -> re-prefill resume contract).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import fxp as _fxp
from . import normalized_posit as _np_
from . import posit as _posit
from .pofx import pofx_norm_lut

__all__ = ["QuantSpec", "QuantizedTensor", "quantize", "dequantize",
           "fxp_view", "storage_bits", "validate_kv_spec", "kv_code_dtype",
           "kv_quantize", "kv_dequantize"]

_KINDS = ("fp32", "bf16", "fxp", "posit", "pofx")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    kind: str = "bf16"
    N: int = 8            # posit total bit length (stored bits = N-1 for pofx)
    ES: int = 2
    M: int = 8            # FxP total bits
    F: int = 7            # FxP fraction bits (pofx forces F = M-1)
    path: str = "via_fxp"  # pofx quantization path
    scale_mode: str = "channel_pow2"
    rounding: str = "trunc"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown quant kind {self.kind!r}")

    @property
    def stored_bits(self) -> int:
        """Bits per stored weight (the paper's storage accounting)."""
        return {"fp32": 32, "bf16": 16, "fxp": self.M,
                "posit": self.N}.get(self.kind, self.N - 1)

    def code_dtype(self) -> torch.dtype:
        b = self.stored_bits
        if b <= 8:
            return torch.uint8
        if b <= 15:
            return torch.int16
        return torch.int32


@dataclasses.dataclass
class QuantizedTensor:
    codes: torch.Tensor       # per-weight codes (or raw floats for fp32/bf16)
    scale: torch.Tensor       # normalizer, broadcastable against codes
    spec: QuantSpec

    @property
    def shape(self):
        return self.codes.shape


@functools.lru_cache(maxsize=None)
def _lut_on(N: int, ES: int, M: int, rounding: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pofx_norm_lut(N, ES, M, rounding), dtype=torch.int32,
                           device=device)


def _lut(spec: QuantSpec, device) -> torch.Tensor:
    """The pofx decode table on ``device``, copied there once: a copy from
    the host in every call would make every decode wait for the card."""
    return _lut_on(spec.N, spec.ES, spec.M, spec.rounding, torch.device(device))


# elements a pass when a large leaf is quantized in slices of rows
QUANT_CHUNK = 1 << 26


def _code_dtype(spec: QuantSpec) -> torch.dtype:
    if spec.kind == "fxp":
        return torch.int8 if spec.M <= 8 else torch.int32
    return spec.code_dtype()


def _encode(wn: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Normalized f32 values -> codes (elementwise)."""
    if spec.kind == "fxp":
        return _fxp.fxp_quantize(wn, spec.M, spec.F).to(_code_dtype(spec))
    if spec.kind == "posit":
        return _posit.posit_encode(wn, spec.N, spec.ES).to(_code_dtype(spec))
    if spec.path == "via_fxp":
        wn = _fxp.fxp_dequantize(_fxp.fxp_quantize(wn, spec.M, spec.M - 1),
                                 spec.M - 1)
    return _np_.norm_encode(wn, spec.N, spec.ES).to(_code_dtype(spec))


def _quantize_rows(w: torch.Tensor, spec: QuantSpec,
                   axis: Optional[int]) -> QuantizedTensor:
    """``quantize`` in slices of at most ``QUANT_CHUNK`` elements along
    axis 0, so that a large leaf's encode temporaries (int64 a weight) fit
    beside it: the scale from the slices' largest magnitudes, then each
    slice encoded. Every step is elementwise or a max, so the codes and
    scale are the whole leaf's; a small leaf is one slice."""
    rows = max(1, QUANT_CHUNK // max(1, w.numel() // max(1, w.shape[0])))
    red = tuple(i for i in range(w.ndim) if axis is None or i != axis % w.ndim)
    amax = None
    for i in range(0, w.shape[0], rows):
        a = w[i:i + rows].to(torch.float32).abs().amax(dim=red, keepdim=True)
        amax = a if amax is None else torch.maximum(amax, a)
    scale = _fxp.compute_scale(amax, spec.scale_mode, axis)
    codes = torch.empty(w.shape, dtype=_code_dtype(spec), device=w.device)
    for i in range(0, w.shape[0], rows):
        codes[i:i + rows] = _encode(w[i:i + rows].to(torch.float32) / scale, spec)
    return QuantizedTensor(codes, scale, spec)


def quantize(w: torch.Tensor, spec: QuantSpec,
             axis: Optional[int] = None) -> QuantizedTensor:
    """Quantize a float tensor into the storage format named by ``spec``.
    A leaf of two or more axes whose scale does not vary along axis 0 is
    quantized in slices of rows (``_quantize_rows``)."""
    if spec.kind in ("fp32", "bf16"):
        w = w.to(torch.float32)
        dt = torch.float32 if spec.kind == "fp32" else torch.bfloat16
        one = torch.ones((1,) * max(w.ndim, 1), dtype=torch.float32,
                         device=w.device)
        return QuantizedTensor(w.to(dt), one, spec)
    if axis is None and spec.scale_mode.startswith("channel"):
        axis = -1  # convention: last axis is the output-channel axis
    if (w.ndim >= 2 and spec.scale_mode != "none"
            and (axis is None or axis % w.ndim != 0)):
        return _quantize_rows(w, spec, axis)
    w = w.to(torch.float32)
    scale = _fxp.compute_scale(w, spec.scale_mode, axis)
    return QuantizedTensor(_encode(w / scale, spec), scale, spec)


def _codes_to_values(codes: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Integer codes -> unscaled float32 values through the FxP datapath:
    fxp is a two's-complement shift; pofx goes stored posit -> bit-level
    LUT -> FxP(M, M-1) -> value. The weight path, the KV path and every
    kernel's plain version share this one decode."""
    if spec.kind == "fxp":
        return _fxp.fxp_dequantize(codes, spec.F)
    if spec.kind == "pofx":
        fxp_codes = _lut(spec, codes.device)[codes.long()]
        return _fxp.fxp_dequantize(fxp_codes, spec.M - 1)
    raise ValueError(f"no FxP decode path for kind {spec.kind!r}")


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Recover float values as the hardware datapath sees them."""
    spec = qt.spec
    if spec.kind in ("fp32", "bf16"):
        return qt.codes.to(dtype)
    if spec.kind == "posit":
        v = _posit.posit_decode(qt.codes, spec.N, spec.ES)
    else:
        v = _codes_to_values(qt.codes, spec)
    return (v * qt.scale).to(dtype)


def fxp_view(qt: QuantizedTensor):
    """(int8 codes, float rescale) pair for the int8 MAC path."""
    spec = qt.spec
    if spec.kind == "fxp":
        return qt.codes.to(torch.int8), qt.scale * (1.0 / (1 << spec.F))
    if spec.kind == "pofx":
        codes = _lut(spec, qt.codes.device)[qt.codes.long()].to(torch.int8)
        return codes, qt.scale * (1.0 / (1 << (spec.M - 1)))
    raise ValueError(f"no FxP view for kind {spec.kind!r}")


def validate_kv_spec(spec: Optional[QuantSpec]) -> Optional[QuantSpec]:
    """Check a spec is usable as a KV-cache format; returns it (or None).

    bf16/fp32 mean "unquantized cache" and normalize to None; quantized
    caches need byte-wide codes of a kind the flash-decode kernel decodes.
    """
    if spec is None or spec.kind in ("bf16", "fp32"):
        return None
    if spec.kind not in ("fxp", "pofx"):
        raise ValueError(
            f"kv cache format must be fxp or pofx (got {spec.kind!r}): the "
            "flash-decode kernel dequantizes through the FxP datapath")
    if spec.stored_bits > 8:
        raise ValueError(
            f"kv cache codes must be byte-wide (stored_bits <= 8, got "
            f"{spec.stored_bits}): the cache streams uint8/int8 code tiles")
    if spec.kind == "pofx" and spec.rounding != "trunc":
        raise ValueError(
            f"kv cache pofx specs must use trunc rounding (got "
            f"{spec.rounding!r}): the flash-decode kernel's LUT decode "
            "truncates, and the plain path must match it code-for-code")
    return spec


def kv_code_dtype(spec: QuantSpec) -> torch.dtype:
    """Cache code dtype: int8 two's-complement for fxp, uint8 posit codes."""
    return torch.int8 if spec.kind == "fxp" else torch.uint8


def kv_quantize(x: torch.Tensor, spec: QuantSpec,
                scale: torch.Tensor) -> torch.Tensor:
    """Quantize K/V values into cache codes, elementwise; ``scale`` is the
    static per-head-dim-channel normalizer broadcastable against ``x``."""
    wn = x.to(torch.float32) / scale
    if spec.kind == "fxp":
        return _fxp.fxp_quantize(wn, spec.M, spec.F).to(torch.int8)
    if spec.kind != "pofx":
        raise ValueError(f"no kv code path for kind {spec.kind!r}")
    if spec.path == "via_fxp":
        wn = _fxp.fxp_dequantize(_fxp.fxp_quantize(wn, spec.M, spec.M - 1),
                                 spec.M - 1)
    return _np_.norm_encode(wn, spec.N, spec.ES).to(torch.uint8)


def kv_dequantize(codes: torch.Tensor, spec: QuantSpec, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """Recover K/V values from cache codes: codes -> FxP -> value * scale."""
    return (_codes_to_values(codes, spec) * scale).to(dtype)


def storage_bits(qt: QuantizedTensor) -> int:
    """Total stored parameter bits (codes bit-packed + fp32 scales)."""
    n = qt.codes.numel()
    if qt.spec.kind in ("fp32", "bf16"):
        return n * qt.spec.stored_bits
    return n * qt.spec.stored_bits + qt.scale.numel() * 32
