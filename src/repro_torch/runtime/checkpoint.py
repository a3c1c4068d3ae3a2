"""Checkpointing: atomic, async, keep-k, posit-compressed.

Port of ``repro/runtime/checkpoint.py``, writing the reference's layout
(one directory per step, atomically renamed into place):

    <dir>/step_00000420/
        manifest.json      step, leaf count, shapes/dtypes, compression info
        leaf_00000.npy ... one file per leaf (raw or posit-packed)
        scale_00000.npy    the scale of a packed leaf

The state is written as the reference's tree: ``blocks`` lists re-stacked
on the host (``convert.reference_layout``; moments with one scale per
stacked leaf), leaves in the reference's flatten order (sorted dict keys,
a QuantizedTensor as one leaf). For the same state, ``manifest.json`` and
every ``leaf_*.npy`` and ``scale_*.npy`` equal the reference's byte for
byte; bfloat16 leaves are written as the reference's ``np.save`` writes
them ('<V2' with the dtype name "bfloat16" in the manifest).

The reference also writes ``treedef.pkl``, a jax pickle of the tree's
structure. The port neither writes nor reads it: ``restore`` takes the
structure from a template state (such as ``launch.train.make_train_state``
's), so the port restores a checkpoint the reference wrote, but the
reference cannot restore the port's (it finds no ``treedef.pkl``).

Fault-tolerance contract, as the reference's:
  * atomicity — writes land in ``<dir>/.tmp_<step>`` and are renamed only
    after the manifest is fsynced; a crash mid-save never corrupts the
    latest complete checkpoint (restore scans for complete manifests).
  * async — ``save`` snapshots to host memory synchronously (the caller
    may then update the state in place) and writes on a background
    thread; ``wait()`` joins it.
  * keep-k GC — older step directories are deleted after a save.
  * posit compression — with ``param_compress`` (a QuantSpec), float
    leaves of >= 2 dims under the top-level ``params`` key are stored as
    bit-packed normalized Posit(N-1, ES) codes and a power-of-two scale
    per last-axis channel, reduced over every other axis (the stacked
    layer axes included). bfloat16 leaves are not compressed: numpy does
    not count ml_dtypes' bfloat16 as floating, in the reference either.
  * quantized tensors — ``QuantizedTensor`` leaves are bit-packed at their
    stored width, their spec recorded as its grammar string; ``save(...,
    policy=...)`` records the QuantPolicy string (``read_manifest``).
  * training grids — ``save(..., model=)`` and ``restore(..., model=)``
    with one rank's LM on a grid: every rank calls both. The save gathers
    the ranks' shards to the grid's rank 0 (``convert.
    gather_reference_layout``), which alone writes, so the files are the
    tp = 1 state's, byte for byte; the restore reads the files on every
    rank and keeps the rank's shard (``convert.
    rank_train_state_from_numpy``), so any checkpoint of the state, the
    reference's included, restores onto any grid.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Union

import numpy as np

from repro_torch.convert import (gather_reference_layout, host_tree, params_from_numpy,
                                 rank_train_state_from_numpy, reference_layout,
                                 reference_structure)
from repro_torch.core.normalized_posit import (norm_decode_np, norm_encode_np,
                                               pack_bits, unpack_bits)
from repro_torch.core.policy import QuantPolicy, format_spec, parse_spec
from repro_torch.core.quantizers import QuantSpec, QuantizedTensor

__all__ = ["CheckpointManager"]


def _flatten(tree, path=()):
    """(path, leaf) pairs in the reference's flatten order: sorted keys, a
    QuantizedTensor as one leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    else:
        yield path, tree


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 \
        else str(arr.dtype)


def _save(path: str, arr: np.ndarray) -> None:
    """``np.save``; a bfloat16 leaf (2-byte void) with the '<V2' header
    that ``np.save`` gives an ml_dtypes bfloat16 array."""
    if _dtype_name(arr) != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(arr.tobytes())


def _is_float(arr: np.ndarray) -> bool:
    return np.issubdtype(arr.dtype, np.floating)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: Any,
             param_compress: Optional[QuantSpec] = None,
             policy: Optional[Union[QuantPolicy, str]] = None, *, model=None) -> None:
        """Snapshot ``state`` to the host and write it (in the background
        when ``async_save``). ``model``: one rank's LM on a training grid,
        whose ranks all call this; rank 0 writes the gathered state (a
        grid's ``restore`` waits for it)."""
        self.wait()
        grid = getattr(model, "grid", None)
        if grid is not None and grid.size > 1:
            states = grid.axis(*grid.axis_names).host().gather_objects(host_tree(state))
            if states is None:
                return
            tree = gather_reference_layout(states, model)
        else:
            tree = reference_layout(state)
        host_leaves: List[Any] = []
        for path, leaf in _flatten(tree):
            if isinstance(leaf, QuantizedTensor):
                host_leaves.append(leaf)
                continue
            compress = (param_compress is not None and path[0] == "params"
                        and _is_float(leaf) and leaf.ndim >= 2)
            host_leaves.append((leaf, compress))
        policy_s = (policy.to_string() if isinstance(policy, QuantPolicy)
                    else policy)
        payload = (step, host_leaves, param_compress, policy_s)
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=payload)
            self._thread.start()
        else:
            self._write(*payload)

    def _write(self, step, host_leaves, spec, policy_s=None) -> None:
        tmp = os.path.join(self.dir, f".tmp_{step:08d}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        if policy_s is not None:
            manifest["quant_policy"] = policy_s
        for i, item in enumerate(host_leaves):
            name = f"leaf_{i:05d}.npy"
            if isinstance(item, QuantizedTensor):
                manifest["leaves"].append(self._write_quantized(tmp, name, i, item))
                continue
            arr, compress = item
            entry = {"file": name, "shape": list(arr.shape),
                     "dtype": _dtype_name(arr), "compressed": bool(compress)}
            if compress:
                N, ES = spec.N, spec.ES
                scale = np.maximum(np.abs(arr).max(axis=tuple(range(arr.ndim - 1)),
                                                   keepdims=True), 1e-12)
                scale = np.exp2(np.ceil(np.log2(scale))).astype(np.float32)
                codes = norm_encode_np((arr / scale).astype(np.float64), N, ES)
                np.save(os.path.join(tmp, name), pack_bits(codes, N - 1))
                np.save(os.path.join(tmp, f"scale_{i:05d}.npy"), scale)
                entry.update(N=N, ES=ES, count=int(arr.size),
                             scale_file=f"scale_{i:05d}.npy")
            else:
                _save(os.path.join(tmp, name), arr)
            manifest["leaves"].append(entry)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    @staticmethod
    def _write_quantized(tmp: str, name: str, i: int,
                         qt: QuantizedTensor) -> Dict[str, Any]:
        """One QuantizedTensor leaf: bit-packed codes + scale + spec string."""
        spec = qt.spec
        codes = qt.codes
        entry: Dict[str, Any] = {
            "file": name, "shape": list(codes.shape),
            "dtype": _dtype_name(codes), "qspec": format_spec(spec),
            "count": int(codes.size),
            "scale_file": f"scale_{i:05d}.npy",
        }
        if spec.rounding != "trunc":  # not expressible in the grammar
            entry["rounding"] = spec.rounding
        k = spec.stored_bits
        if spec.kind in ("fp32", "bf16") or k > 16:
            entry["packed"] = False
            _save(os.path.join(tmp, name), codes)
        else:
            # fxp codes are signed two's complement: mask to k bits before
            # packing and sign-extend on restore.
            entry["packed"] = True
            masked = codes.view(f"u{codes.dtype.itemsize}") & ((1 << k) - 1)
            np.save(os.path.join(tmp, name), pack_bits(masked, k))
        np.save(os.path.join(tmp, entry["scale_file"]), qt.scale)
        return entry

    @staticmethod
    def _read_quantized(root: str, entry: Dict[str, Any]) -> Dict[str, Any]:
        spec = parse_spec(entry["qspec"])
        if "rounding" in entry:
            spec = dataclasses.replace(spec, rounding=entry["rounding"])
        raw = np.load(os.path.join(root, entry["file"]))
        if entry.get("packed"):
            k = spec.stored_bits
            codes = unpack_bits(raw, k, entry["count"])
            if spec.kind == "fxp":  # sign-extend k-bit two's complement
                codes = codes - ((codes >> (k - 1)) << k)
            codes = codes.astype(np.dtype(entry["dtype"])).reshape(entry["shape"])
        else:
            codes = raw.reshape(entry["shape"])
        scale = np.load(os.path.join(root, entry["scale_file"]))
        return {"codes": codes, "scale": scale, "spec": spec}

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ----------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _root(self, step: Optional[int]) -> str:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        return os.path.join(self.dir, f"step_{step:08d}")

    def read_manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """Checkpoint metadata (incl. "quant_policy" when saved with one)."""
        with open(os.path.join(self._root(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, template: Any, step: Optional[int] = None, *,
                device=None, model=None) -> Any:
        """Load a checkpoint (the latest by default) into the structure of
        ``template``, a state of the port's layout (its values are not
        read); tensors go to ``device``, by default the template's. With
        ``model`` (one rank's LM on a training grid) the rank's shard of
        the train state, on the model's device; every rank calls it, and it
        reads once rank 0's write of the grid's save has ended."""
        grid = getattr(model, "grid", None)
        if grid is not None and grid.size > 1:
            self.wait()
            grid.axis(*grid.axis_names).host().check_equal("the checkpoint step", step)
        root = self._root(step)
        with open(os.path.join(root, "manifest.json")) as f:
            manifest = json.load(f)
        paths = list(_flatten(reference_structure(template)))
        if len(paths) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint {root} holds {len(manifest['leaves'])} "
                             f"leaves, the template {len(paths)}")
        tree: Dict[str, Any] = {}
        for (path, like), entry in zip(paths, manifest["leaves"]):
            if isinstance(like, QuantizedTensor) != ("qspec" in entry):
                raise ValueError(f"leaf {'/'.join(path)}: the template and "
                                 f"checkpoint {root} disagree on quantization")
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self._read_leaf(root, entry)
            if device is None:
                device = (like.codes if isinstance(like, QuantizedTensor) else like).device
        if grid is not None:
            return rank_train_state_from_numpy(tree, model)
        return params_from_numpy(tree, device=device)

    @classmethod
    def _read_leaf(cls, root: str, entry: Dict[str, Any]):
        if "qspec" in entry:
            return cls._read_quantized(root, entry)
        raw = np.load(os.path.join(root, entry["file"]))
        if not entry.get("compressed"):
            return raw
        N, ES = entry["N"], entry["ES"]
        codes = unpack_bits(raw, N - 1, entry["count"])
        scale = np.load(os.path.join(root, entry["scale_file"]))
        return (norm_decode_np(codes, N, ES).reshape(entry["shape"])
                * scale).astype(np.dtype(entry["dtype"]))
