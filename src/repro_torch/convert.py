"""Carry reference parameters across: nested numpy dicts -> port parameters.

The reference package initializes with ``jax.random``, which torch cannot
reproduce, so equal weights cross as numpy arrays. ``params_from_numpy``
takes the reference's parameter tree as nested dicts of numpy arrays, with
each quantized leaf given as ``{"codes", "scale", "spec": "<format_spec
string>"}``, and returns the port's tree: the layer-stacked ``blocks``
leaves (codes AND per-layer scales, whose leading layer axis the reference
keeps mapped) are unstacked into one dict per layer. bfloat16 arrays
(numpy dtype name "bfloat16") are accepted as raw 16-bit patterns.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.policy import parse_spec
from repro_torch.core.quantizers import QuantizedTensor

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and set(node) == {"codes", "scale", "spec"}


def _convert(node, device, layer=None):
    """Convert one subtree; ``layer`` selects one slice of stacked leaves."""
    pick = (lambda a: np.asarray(a)) if layer is None else \
        (lambda a: np.asarray(a)[layer])
    if _is_qleaf(node):
        spec = parse_spec(node["spec"])
        return QuantizedTensor(tensor_from_numpy(pick(node["codes"]), device),
                               tensor_from_numpy(pick(node["scale"]), device),
                               spec)
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    return tensor_from_numpy(pick(node), device)


def _n_layers(node) -> int:
    if _is_qleaf(node):
        return np.asarray(node["codes"]).shape[0]
    if isinstance(node, dict):
        return _n_layers(next(iter(node.values())))
    return np.asarray(node).shape[0]


def params_from_numpy(tree: Dict[str, Any], *, device) -> Dict[str, Any]:
    """The reference's parameter tree (numpy) -> the port's parameters."""
    out = {}
    for key, node in tree.items():
        if key == "blocks":
            out[key] = [_convert(node, device, i)
                        for i in range(_n_layers(node))]
        else:
            out[key] = _convert(node, device)
    return out
