"""Carry reference parameters across: nested numpy dicts -> port parameters.

The reference package initializes with ``jax.random``, which torch cannot
reproduce, so equal weights cross as numpy arrays. ``params_from_numpy``
takes the reference's parameter tree as nested dicts of numpy arrays, with
each quantized leaf given as ``{"codes", "scale", "spec": "<format_spec
string>"}``, and returns the port's tree: the layer-stacked ``blocks``
leaves (codes AND per-layer scales, whose leading layer axes the reference
keeps mapped) are unstacked into one dict per layer, in execution order.
The moe family's ``blocks`` = {"moe": (n_groups, ...), "dense": (n_groups,
moe_every - 1, ...)} becomes, group by group, the group's dense layers and
then its MoE layer. The ssm and hybrid families' mamba layers ({"ln",
"mix"}) unstack like dense layers; hybrid's one shared block (``shared``)
is not stacked and converts as it is. The encdec family's ``enc_blocks``
(the encoder's dense layers) unstack like ``blocks``, whose decoder layers
carry their "ln_x" and "xattn" leaves along; ``enc_ln`` converts as it
is. An (E, in, out) expert leaf stays whole, its codes and its scale
shared by the experts as they are. bfloat16 arrays (numpy dtype name
"bfloat16") are accepted as raw 16-bit patterns.
"""
from __future__ import annotations

from typing import Any, Dict, List

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


def _convert(node, device, layer=()):
    """Convert one subtree; ``layer`` indexes the leading (stacked) axes."""
    def pick(a):
        return np.asarray(a)[layer]
    if _is_qleaf(node):
        spec = parse_spec(node["spec"])
        return QuantizedTensor(tensor_from_numpy(pick(node["codes"]), device),
                               tensor_from_numpy(pick(node["scale"]), device),
                               spec)
    if isinstance(node, dict):
        return {k: _convert(v, device, layer) for k, v in node.items()}
    return tensor_from_numpy(pick(node), device)


def _stack_shape(node, depth: int = 1):
    """The leading ``depth`` (stacked) axes of a subtree's leaves."""
    if _is_qleaf(node):
        return np.asarray(node["codes"]).shape[:depth]
    if isinstance(node, dict):
        return _stack_shape(next(iter(node.values())), depth)
    return np.asarray(node).shape[:depth]


def _blocks(node, device) -> List[Dict[str, Any]]:
    """Stacked ``blocks`` -> one dict per layer, in execution order."""
    if "moe" not in node:                     # dense: (L, ...)
        return [_convert(node, device, (i,)) for i in range(_stack_shape(node)[0])]
    layers = []
    for g in range(_stack_shape(node["moe"])[0]):
        if "dense" in node:                   # (n_groups, moe_every - 1, ...)
            n_dense = _stack_shape(node["dense"], 2)[1]
            layers += [_convert(node["dense"], device, (g, i)) for i in range(n_dense)]
        layers.append(_convert(node["moe"], device, (g,)))
    return layers


def params_from_numpy(tree: Dict[str, Any], *, device) -> Dict[str, Any]:
    """The reference's parameter tree (numpy) -> the port's parameters."""
    return {key: _blocks(node, device) if key in ("blocks", "enc_blocks")
            else _convert(node, device)
            for key, node in tree.items()}
