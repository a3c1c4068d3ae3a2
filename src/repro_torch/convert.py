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
"bfloat16", or 2-byte void arrays holding the bits) are accepted as raw
16-bit patterns.

The way back, ``params_to_numpy``, re-stacks every ``blocks`` and
``enc_blocks`` list (and the moe family's {"moe", "dense"} groups) into
the reference's layout, on the host. It takes a parameter tree or a whole
train state {"params", "opt": {"m", "v", "count"}}: the moments under
"opt" are stacked with ONE scale for each stacked leaf, since the
reference quantizes each stacked moment leaf whole (the port's optimizer
gives every layer of such a leaf the same scale). ``params_from_numpy``
unstacks such a scale's size-1 layer axes back onto each layer, and
``train_state_from_numpy`` takes the reference's train state (posit8
moments as {"codes", "scale", "spec"} leaves) into the port's. bfloat16
tensors leave as 2-byte void arrays holding their bits (the form the
reference's ``np.save`` round-trips them through).

``rank_params_from_numpy`` is the tensor-parallel form: the same tree cut
to one rank's shard (``nn.sharding.shard_policy_params`` over the rank
model's ``logical()``), so the tp = N port serves the reference's tp = 1
weights. On a training grid, ``rank_train_state_from_numpy`` cuts the
reference's train state to one rank's shard (``launch.train.
state_shardings``: moments like their parameter, a posit8 scale whole),
and ``gather_train_state`` puts every rank's shards back together into the
reference's numpy layout (``gather_reference_layout``: the same before the
quantized leaves become {"codes", "scale", "spec"} dicts, the form that
``runtime.checkpoint`` writes); ``host_tree`` is a rank's state on the
host, as those take it.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core.policy import format_spec, parse_spec
from repro_torch.core.quantizers import QuantSpec, QuantizedTensor

__all__ = ["gather_reference_layout", "gather_train_state", "host_tree", "params_from_numpy",
           "params_to_numpy",
           "rank_params_from_numpy", "rank_train_state_from_numpy", "reference_layout",
           "reference_structure", "tensor_from_numpy", "tensor_to_numpy",
           "train_state_from_numpy"]

_STACKED = ("blocks", "enc_blocks")


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2)


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if _is_bf16(a):
        bits = np.array(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _is_qleaf(node) -> bool:
    return isinstance(node, dict) and set(node) == {"codes", "scale", "spec"}


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 as a 2-byte void array of its bits."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return np.array(t.view(torch.int16).cpu().numpy()).view("V2")
    return np.array(t.cpu().numpy())


def _convert(node, device, layer=()):
    """Convert one subtree; ``layer`` indexes the leading (stacked) axes (a
    size-1 stacked axis, a moment's one scale, is shared by every layer)."""
    def pick(a):
        a = np.asarray(a)
        return a[tuple(0 if a.shape[j] == 1 else i for j, i in enumerate(layer))]
    if _is_qleaf(node):
        spec = node["spec"]
        spec = spec if isinstance(spec, QuantSpec) else parse_spec(spec)
        return QuantizedTensor(tensor_from_numpy(pick(node["codes"]), device),
                               tensor_from_numpy(pick(node["scale"]), device),
                               spec)
    if isinstance(node, dict):
        return {k: _blocks(v, device) if k in _STACKED and not layer
                else _convert(v, device, layer) for k, v in node.items()}
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
    """The reference's parameter tree (numpy) -> the port's parameters;
    ``blocks``/``enc_blocks`` at any depth (a train state's moments too)
    are unstacked."""
    return _convert(tree, device)


def rank_params_from_numpy(tree: Dict[str, Any], model) -> Dict[str, Any]:
    """The reference's parameter tree (numpy) -> the shard that ``model``
    (one rank's LM: its ``tp`` context and device) serves: the whole tree
    converted, then every leaf cut to the rank's slice of codes and
    scale. On a grid (``model.grid``) each leaf is cut by its spec
    (``LM.specs``), a quantized leaf's codes alone: its scale stays
    whole, as ``LM.init`` places it."""
    from repro_torch.nn.sharding import shard_policy_params
    if model.grid is None:
        full = params_from_numpy(tree, device=model.device)
        return shard_policy_params(full, model.logical(), model.tp)
    grid, dev = model.grid, model.device

    def one(spec, leaf):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(grid.shard(leaf.codes, spec).to(dev), leaf.scale.to(dev),
                                   leaf.spec)
        return grid.shard(leaf, spec).to(dev)

    return _zip_map(one, model.specs(), params_from_numpy(tree, device="cpu"))


def train_state_from_numpy(tree: Dict[str, Any], *, device) -> Dict[str, Any]:
    """The reference's train state {"params", "opt": {"m", "v", "count"}}
    (numpy; posit8 moments as {"codes", "scale", "spec"} leaves) -> the
    port's, on ``device``."""
    if set(tree) - {"params", "opt", "ef"} or set(tree["opt"]) != {"m", "v", "count"}:
        raise ValueError(f"not a train state: keys {sorted(tree)}, "
                         f"opt {sorted(tree.get('opt', {}))}")
    return params_from_numpy(tree, device=device)


def _zip_map(fn, spec, *trees):
    """``fn(spec leaf, *tree leaves)`` over trees of one structure (dicts and
    the ``blocks`` lists; a spec leaf is a tuple or a QuantizedTensor)."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, spec[k], *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_zip_map(fn, sp, *ts) for sp, *ts in zip(spec, *trees)]
    return fn(spec, *trees)


def rank_train_state_from_numpy(tree: Dict[str, Any], model) -> Dict[str, Any]:
    """The reference's train state (numpy) -> the shard that ``model`` (one
    rank's LM on a training grid) holds, on its device."""
    from repro_torch.launch.train import state_shardings
    grid, dev = model.grid, model.device

    def one(spec, leaf):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(grid.shard(leaf.codes, spec.codes).to(dev),
                                   leaf.scale.to(dev), leaf.spec)
        return grid.shard(leaf, spec).to(dev)

    return _zip_map(one, state_shardings(model), train_state_from_numpy(tree, device="cpu"))


def host_tree(tree):
    """A tree of the port's layout with its tensors on the host as numpy
    arrays (a QuantizedTensor of numpy codes and scale)."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tree(v) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(_host(tree.codes), _host(tree.scale), tree.spec)
    return _host(tree)


def gather_train_state(states: List[Dict[str, Any]], model) -> Dict[str, Any]:
    """Every rank's train state (``states[r]`` rank r's; tensors, or numpy
    arrays in the same structure) -> the whole state in the reference's
    numpy layout (``params_to_numpy``). A posit8 moment's scale must be the
    same on every rank."""
    return _as_qleaves(gather_reference_layout(states, model))


def gather_reference_layout(states: List[Dict[str, Any]], model) -> Dict[str, Any]:
    """``gather_train_state`` in ``reference_layout``'s form (a quantized
    leaf a QuantizedTensor of numpy arrays)."""
    from repro_torch.launch.train import state_shardings
    grid = model.grid

    def one(spec, *leaves):
        if isinstance(leaves[0], QuantizedTensor):
            scales = [_host(q.scale) for q in leaves]
            if any(not np.array_equal(sc, scales[0]) for sc in scales):
                raise ValueError("a posit8 moment's scale differs between ranks")
            return QuantizedTensor(grid.unshard([_host(q.codes) for q in leaves], spec.codes),
                                   scales[0], leaves[0].spec)
        return grid.unshard([_host(t) for t in leaves], spec)

    return reference_layout(_zip_map(one, state_shardings(model), *states[:grid.size]))


# -- the way back: the reference's stacked layout -------------------------


def _moe_groups(layers):
    """A per-layer list in execution order -> [(dense layers, MoE layer)]
    per reference group, or None when no layer is an MoE layer."""
    if not any("moe" in lp for lp in layers):
        return None
    groups, dense = [], []
    for lp in layers:
        if "moe" in lp:
            groups.append((dense, lp))
            dense = []
        else:
            dense.append(lp)
    if dense:
        raise ValueError("an moe blocks list must end with an MoE layer")
    return groups


def _host(x) -> np.ndarray:
    return tensor_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _stack(trees: List[Any], shared: bool):
    """Stack same-structured subtrees on a new leading axis; with ``shared``
    a QuantizedTensor keeps its one scale (it must be every layer's)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], shared) for k in first}
    if isinstance(first, QuantizedTensor):
        scales = [_host(t.scale) for t in trees]
        if shared:
            if any(not np.array_equal(sc, scales[0]) for sc in scales):
                raise ValueError("moment layers of one stacked leaf must share their scale")
            scale = scales[0][None]
        else:
            scale = np.stack(scales)
        return QuantizedTensor(np.stack([_host(t.codes) for t in trees]), scale,
                               first.spec)
    return np.stack([_host(t) for t in trees])


def _stack_layers(layers: List[Any], shared: bool):
    groups = _moe_groups(layers)
    if groups is None:
        return _stack(layers, shared)
    out = {"moe": _stack([moe for _, moe in groups], shared)}
    if groups[0][0]:
        out["dense"] = _stack([_stack(dense, shared) for dense, _ in groups], shared)
    return out


def reference_layout(tree, _path=()):
    """The port's tree in the reference's stacked layout on the host:
    numpy leaves, and QuantizedTensors holding numpy codes and scales."""
    if isinstance(tree, dict):
        return {k: reference_layout(v, _path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack_layers(tree, shared=_path[:2] in (("opt", "m"), ("opt", "v")))
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(_host(tree.codes), _host(tree.scale), tree.spec)
    return _host(tree)


def _as_qleaves(tree):
    if isinstance(tree, dict):
        return {k: _as_qleaves(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return {"codes": tree.codes, "scale": tree.scale, "spec": format_spec(tree.spec)}
    return tree


def params_to_numpy(tree) -> Dict[str, Any]:
    """The inverse of ``params_from_numpy``: the port's parameters (or train
    state) as the reference's nested numpy dicts, blocks re-stacked and a
    QuantizedTensor as {"codes", "scale", "spec": format_spec string}."""
    return _as_qleaves(reference_layout(tree))


def reference_structure(tree) -> Any:
    """The reference layout's structure without its data: nested dicts
    whose leaves are the port's first leaf of each stacked leaf (so a
    QuantizedTensor stays recognizable)."""
    if isinstance(tree, dict):
        return {k: reference_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        groups = _moe_groups(tree)
        if groups is None:
            return reference_structure(tree[0])
        out = {"moe": reference_structure(groups[0][1])}
        if groups[0][0]:
            out["dense"] = reference_structure(groups[0][0][0])
        return out
    return tree
