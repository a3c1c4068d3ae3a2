"""What one step costs a device: flops, HBM bytes, bytes on the wire and the
high-water mark of live tensor bytes, counted as the step runs.

Counterpart of ``repro/launch/hlo_parser.py``. The reference walks the
post-SPMD HLO of a compiled step and multiplies each loop body by its trip
count; PyTorch runs its steps eagerly, so every loop trip dispatches its
own ops and is counted as it runs: there is no trip count to read, and
``StepCost`` has no ``loops`` field. ``count_step(fn, *args)`` runs
``fn(*args)`` once under a ``TorchDispatchMode`` that sees every aten op
after autograd (the backward's and the remat recompute's included), on real
tensors or on the fake ones of ``torch._subclasses.fake_tensor`` (the dry
run, ``launch.dryrun``):

* flops: matrix products, convolutions and attention, by the formulas of
  ``torch.utils.flop_counter`` (2 * m * n * k for a product);
* bytes, the HBM view of the reference's ``_op_traffic``: an op costs its
  tensor operands plus its result; views and metadata ops (and allocations:
  ``empty``, ``arange``) cost nothing (the reference's ``_NO_TRAFFIC``); a
  write into a slice (``copy_``, ``index_put_``, ...) costs twice the update;
  a gather (``index_select``, ``embedding``, ...) twice its result; a fill
  (``zeros``, ``fill_``) its result once; a collective twice its result;
* bytes on the wire: each collective of ``nn.sharding.TPContext``
  (``psum``, ``all_reduce``, ``all_gather``, ``reduce_scatter``, through
  which every collective of the port runs), by the ring rule of
  ``hlo_analysis.wire_bytes`` over its group's size; the bytes of groups
  that lie in one node (``hlo_analysis.in_node``) are also summed apart;
* ``peak_bytes``: the most bytes that live tensor storages held at once
  during the step, the arguments' included (a storage counts from the op
  that made it until its last tensor is gone; on CUDA rounded up to the
  caching allocator's 512-byte blocks).

A tensor on the "meta" device stands for the host's (the dry run's global
batch, of which a rank copies its rows to the device): it holds no device
memory, an op whose results lie there is the host's and costs nothing,
and a copy from it onto the device costs no HBM bytes. A copy between
other devices counts as before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import hlo_analysis
from repro_torch.nn import sharding

__all__ = ["StepCost", "count_step"]

aten = torch.ops.aten

# the caching allocator's block: a CUDA storage takes a multiple of it
_CUDA_BLOCK = 512

# ops that read or write no tensor data (besides views, ``OpOverload.is_view``)
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten.arange, aten.lift_fresh, aten.detach,
         aten._unsafe_view, aten.alias, aten.set_, aten.resize_, aten.scalar_tensor,
         aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten.is_same_size, aten._has_compatible_shallow_copy_type}
# a write into a slice: twice the update (the last tensor operand)
_SLICE_WRITE = {aten.copy_, aten.index_put_, aten.index_copy_, aten.masked_scatter_,
                aten.slice_scatter, aten.select_scatter, aten.scatter_}
# a gather: twice the result
_GATHER = {aten.gather, aten.index_select, aten.index, aten.embedding}
# a fill: the result, written once
_FILL = {aten.zeros, aten.ones, aten.full, aten.zeros_like, aten.ones_like,
         aten.full_like, aten.fill_, aten.zero_, aten.new_zeros, aten.new_ones,
         aten.new_full}

# META: no tensor data at all (``prim.device``, profiler ranges); FREE: no
# traffic, but an output storage to track (an allocation, a view, a
# collective's buffer); COPY: a ``_to_copy``, free where it copies from
# "meta" (the host's batch: the reference's step takes its arguments on the
# device), plain otherwise
(_KIND_META, _KIND_FREE, _KIND_FLOPS, _KIND_SLICE, _KIND_GATHER, _KIND_FILL, _KIND_PLAIN,
 _KIND_COPY) = range(8)


@dataclasses.dataclass
class StepCost:
    """One device's cost of one step (``hlo_parser.HloCost``'s fields, less
    ``loops``, plus ``wire_bytes_in_node``, the memory readings and the
    count of ops that read or wrote tensor data)."""
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    wire_bytes_per_device: float = 0.0
    wire_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    wire_bytes_in_node: float = 0.0
    peak_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    n_ops: int = 0

    def summary(self) -> str:
        rows = [f"  flops/device      {self.flops_per_device / 1e12:10.3f} T",
                f"  bytes/device      {self.bytes_per_device / 2**30:10.2f} GiB",
                f"  wire bytes/device {self.wire_bytes_per_device / 2**30:10.3f} GiB "
                f"({self.wire_bytes_in_node / 2**30:.3f} in node)"]
        for k, v in sorted(self.wire_by_kind.items()):
            rows.append(f"    {k:18s} {v / 2**30:10.3f} GiB")
        rows.append(f"  peak live bytes   {self.peak_bytes / 2**30:10.2f} GiB "
                    f"({self.n_ops} ops, {self.n_collectives} collectives)")
        return "\n".join(rows)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(args) -> int:
    n = 0
    for a in args:
        if isinstance(a, torch.Tensor):
            n += a.numel() * a.element_size()
        elif isinstance(a, (list, tuple)):
            n += _tensor_bytes(a)
    return n


def _last_tensor(args) -> Optional[torch.Tensor]:
    for a in reversed(args):
        if isinstance(a, torch.Tensor):
            return a
    return None


def _classify(func) -> int:
    packet = func.overloadpacket
    if packet in flop_registry:
        return _KIND_FLOPS
    if packet is aten._to_copy:
        return _KIND_COPY
    if func.namespace in ("prim", "profiler"):
        return _KIND_META
    if func.namespace == "c10d" or packet in _FREE or func.is_view:
        return _KIND_FREE
    if packet in _SLICE_WRITE:
        return _KIND_SLICE
    if packet in _GATHER:
        return _KIND_GATHER
    if packet in _FILL:
        return _KIND_FILL
    return _KIND_PLAIN


class _Counter(TorchDispatchMode):
    """The dispatch mode of ``count_step``: every op's flops and bytes, and
    the live storages' bytes."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._kinds: Dict[Any, int] = {}
        self._live: Dict[int, weakref.ref] = {}
        self._bytes_live = 0
        self._in_node: Dict[int, bool] = {}
        self._in_collective = False

    # -- live storages --------------------------------------------------------

    def track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        if t.device.type == "cuda":
            n = -(-n // _CUDA_BLOCK) * _CUDA_BLOCK
        if not n:
            return
        self._live[key] = weakref.ref(st, lambda _, key=key, n=n: self._free(key, n))
        self._bytes_live += n
        if self._bytes_live > self.cost.peak_bytes:
            self.cost.peak_bytes = self._bytes_live

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self._bytes_live -= n

    def _track_out(self, out) -> None:
        if isinstance(out, torch.Tensor):
            self.track(out)
        elif isinstance(out, (list, tuple)):
            for o in out:
                if isinstance(o, torch.Tensor):
                    self.track(o)

    # -- ops ------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_collective:
            return out
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _classify(func)
        if kind == _KIND_META:
            return out
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if all(o.device.type == "meta" for o in outs if isinstance(o, torch.Tensor)):
            return out                                  # the host's
        if kind == _KIND_COPY:
            kind = _KIND_FREE if args[0].device.type == "meta" else _KIND_PLAIN
        self._track_out(out)
        if kind == _KIND_FREE:
            return out
        cost = self.cost
        cost.n_ops += 1
        if kind == _KIND_SLICE:
            upd = _last_tensor(args)
            cost.bytes_per_device += 2 * (_nbytes(upd) if upd is not None else 0)
        elif kind == _KIND_GATHER:
            cost.bytes_per_device += 2 * _tensor_bytes(outs)
        elif kind == _KIND_FILL:
            cost.bytes_per_device += _tensor_bytes(outs)
        else:
            if kind == _KIND_FLOPS:
                cost.flops_per_device += flop_registry[func.overloadpacket](
                    *args, **kwargs, out_val=out)
            cost.bytes_per_device += _tensor_bytes(args) + _tensor_bytes(outs)
        return out

    # -- collectives (``nn.sharding.set_collective_hook``) ----------------------

    @contextlib.contextmanager
    def collective(self, kind: str, result: torch.Tensor, tp):
        """Count one collective; the ops dispatched inside it are the
        backend's own and are not counted (its result's storage was made,
        and tracked, by an op before it)."""
        self._count_collective(kind, result, tp)
        self._in_collective = True
        try:
            yield
        finally:
            self._in_collective = False

    def _count_collective(self, kind: str, result: torch.Tensor, tp) -> None:
        nbytes = _nbytes(result)
        wire = hlo_analysis.wire_bytes(kind, nbytes, tp.size)
        cost = self.cost
        cost.n_collectives += 1
        cost.wire_bytes_per_device += wire
        cost.wire_by_kind[kind] = cost.wire_by_kind.get(kind, 0.0) + wire
        cost.bytes_per_device += 2 * nbytes
        if self._group_in_node(tp):
            cost.wire_bytes_in_node += wire

    def _group_in_node(self, tp) -> bool:
        key = id(tp.group)
        if key not in self._in_node:
            ranks = torch.distributed.get_process_group_ranks(tp.group)
            self._in_node[key] = hlo_analysis.in_node(ranks)
        return self._in_node[key]


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses (a
    QuantizedTensor's codes and scale)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _storage_bytes(tree) -> Dict[int, int]:
    """{id: bytes} of the distinct storages of a tree's tensors (on CUDA in
    whole allocator blocks; none on "meta")."""
    out = {}
    for t in _tensors(tree):
        if t.device.type == "meta":
            continue
        st = t.untyped_storage()
        n = st.nbytes()
        out[id(st)] = -(-n // _CUDA_BLOCK) * _CUDA_BLOCK if t.device.type == "cuda" else n
    return out


def count_step(fn, *args, **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once and return what it cost this device
    (``StepCost``): its ops' flops and bytes, its collectives' bytes on the
    wire and the peak of its live tensor bytes, the arguments' storages
    counted from the start. ``argument_bytes``, ``output_bytes`` and
    ``alias_bytes`` (outputs whose storage is an argument's: the state a
    step updates in place) are the distinct storages' bytes."""
    counter = _Counter()
    args_st = _storage_bytes((args, kwargs))
    for t in _tensors((args, kwargs)):
        counter.track(t)
    prev = sharding.set_collective_hook(counter.collective)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        sharding.set_collective_hook(prev)
    cost = counter.cost
    out_st = _storage_bytes(out)
    cost.argument_bytes = sum(args_st.values())
    cost.output_bytes = sum(out_st.values())
    cost.alias_bytes = sum(n for k, n in out_st.items() if k in args_st)
    return cost
