"""Process groups for tensor-parallel serving and for training grids: one
OS process per rank.

Port of ``repro/launch/mesh.py`` (``make_tp_mesh``, DESIGN.md §9;
``make_host_mesh`` and ``make_production_mesh``). The
reference serves tensor-parallel inside one process over a 1-D ("tp",)
device mesh; here each rank is a process of its own, joined through
``torch.distributed``:

* ``make_tp_mesh`` joins the calling process to the group as one rank and
  returns its ``nn.sharding.TPContext``. The backend (``pick_backend``) is
  gloo on the CPU; on CUDA it is NCCL when every rank has a card of its
  own, and gloo when ranks share a card (NCCL refuses two ranks on one
  device; gloo's all_reduce takes CUDA tensors). A failing backend is
  never retried on the other one. The group has a timeout, so ranks that
  stop agreeing fail instead of hanging.
* ``RankPool`` spawns the ranks (``multiprocessing.get_context("spawn")``;
  rank r on ``cuda:(r % device_count)``, or on the CPU) and runs one
  function in all of them per ``run`` call, feeding the call through a
  queue per rank and collecting each rank's result; every process is
  joined with a timeout when the pool closes. The serving CLI's ``--tp``
  runs one call; the tests keep one pool for a module.
* ``make_host_mesh(data, model, pod)`` joins the process to a training
  grid of ``pod * data * model`` ranks and returns its
  ``nn.sharding.GridContext``: the reference's axis names and shape
  ((data, model), with "pod" in front when there is more than one pod), the
  rank's coordinates (row-major) and a group for every set of axes that
  the training step reads (``grid_groups``). ``make_production_mesh`` reports the reference's
  production shape ((16, 16), or (2, 16, 16) multi-pod) and joins it only
  in a world of that many ranks. ``RankPool(..., grids=[(pod, data,
  model), ...])`` builds each grid over its first ranks, and ``run(fn,
  grid=...)`` calls ``fn(grid_context, device, ...)`` in them.

Each of them runs on the card (``device="cuda"``) unless the caller asks
for the CPU.
"""
from __future__ import annotations

import datetime
import itertools
import math
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.nn.sharding import GRID_AXES, GridContext, TPContext

__all__ = ["make_tp_mesh", "make_host_mesh", "make_production_mesh", "grid_layout",
           "grid_groups", "GRID_SETS", "pick_backend", "rank_device", "RankPool"]

# seconds a collective waits for the other ranks before it fails (the ranks
# draw their models side by side, so they reach the first one together)
GROUP_TIMEOUT_S = 300.0

# backends whose groups serve as their own host groups: gloo takes CPU
# tensors, and the dry run's "fake" world has no peers for a gloo twin to
# wait for (its collectives return at once and its host checks are off,
# ``TPContext.host_checks``)
SELF_HOSTED = ("gloo", "fake")


def pick_backend(tp: int, device: str) -> str:
    """gloo on the CPU; on CUDA, NCCL when each of the ``tp`` ranks has a
    card of its own, else gloo (ranks sharing a card)."""
    if torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= tp else "gloo"


def rank_device(rank: int, device: str) -> str:
    """Rank ``rank``'s device: ``cuda:(rank % device_count)`` on the card,
    the CPU under ``device="cpu"``."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return f"cuda:{rank % max(torch.cuda.device_count(), 1)}"


def make_tp_mesh(tp: int, *, rank: int = 0, init_method: Optional[str] = None,
                 device: str = "cuda", timeout_s: float = GROUP_TIMEOUT_S) -> TPContext:
    """Join this process to the ``tp``-rank group as ``rank`` and return its
    TPContext (tp = 1: the plain context, no group). ``init_method`` is the
    rendezvous address (``tcp://127.0.0.1:<port>``)."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return TPContext()
    import torch.distributed as dist
    backend = pick_backend(tp, device)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=tp, timeout=timeout)
    group = dist.group.WORLD
    host = group if backend in SELF_HOSTED else dist.new_group(backend="gloo",
                                                               timeout=timeout)
    return TPContext(rank=rank, size=tp, group=group, host_group=host,
                     backend=backend)


def grid_layout(pod: int = 1, data: int = 1, model: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The reference's mesh shape and axis names for a (pod, data, model)
    grid: (data, model), with "pod" in front when pod > 1."""
    if min(pod, data, model) < 1:
        raise ValueError(f"grid sizes must be >= 1, got pod={pod} data={data} model={model}")
    if pod > 1:
        return (pod, data, model), GRID_AXES
    return (data, model), ("data", "model")


# the sets of axes the training step takes a group over: model (Megatron's
# all-reduces, the logits), data (FSDP), pod (the compressed mean), (pod,
# data) (the loss and gradient means, an MoE layer's routed batch), (data,
# model) (a leaf sharded over both: its norms and posit8 maxima) and the
# whole grid (a checkpoint's gather)
GRID_SETS = (("model",), ("data",), ("pod",), ("pod", "data"), ("data", "model"),
             ("pod", "data", "model"))


def grid_groups(shape, names, rank: int, backend: str, timeout_s: float = GROUP_TIMEOUT_S
                ) -> Dict[Tuple[str, ...], TPContext]:
    """A TPContext for every set of GRID_SETS, less its axes of one rank
    (keyed by what is left, empty sets dropped): the ranks that share this
    rank's coordinates on the other axes. Under NCCL each group has a gloo
    twin for host-side checks (``TPContext.host``); a gloo or "fake" group
    is its own (SELF_HOSTED), and a fake group's host checks are off. Every
    process of the world takes part in making every group, in one order
    (ranks past the grid's size too); a rank outside the grid gets {}."""
    import torch.distributed as dist
    timeout = datetime.timedelta(seconds=timeout_s)
    sizes = dict(zip(names, shape))
    keys = []
    for s in GRID_SETS:
        key = tuple(a for a in GRID_AXES if a in s and sizes.get(a, 1) > 1)
        if key and key not in keys:
            keys.append(key)
    n = math.prod(shape)
    out: Dict[Tuple[str, ...], TPContext] = {}
    for sub in keys:
        others = [a for a in names if a not in sub]
        for fixed in itertools.product(*(range(sizes[a]) for a in others)):
            ranks = []
            for vary in itertools.product(*(range(sizes[a]) for a in sub)):
                c = {**dict(zip(others, fixed)), **dict(zip(sub, vary))}
                r = 0
                for a in names:
                    r = r * sizes[a] + c[a]
                ranks.append(r)
            group = dist.new_group(ranks, backend=backend, timeout=timeout)
            host = group if backend in SELF_HOSTED else dist.new_group(
                ranks, backend="gloo", timeout=timeout)
            if rank < n and rank in ranks:
                out[sub] = TPContext(rank=ranks.index(rank), size=len(ranks), group=group,
                                     host_group=host, backend=backend,
                                     host_checks=backend != "fake")
    return out


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, *, rank: int = 0,
                   init_method: Optional[str] = None, device: str = "cuda",
                   timeout_s: float = GROUP_TIMEOUT_S) -> GridContext:
    """Join this process to a training grid of ``pod * data * model`` ranks
    as ``rank`` and return its GridContext (one rank: the layout, no group).
    ``init_method`` is the rendezvous address (``tcp://127.0.0.1:<port>``);
    the backend is ``pick_backend``'s."""
    shape, names = grid_layout(pod, data, model)
    world = math.prod(shape)
    if world == 1:
        return GridContext(shape, names)
    import torch.distributed as dist
    backend = pick_backend(world, device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return GridContext(shape, names, rank, grid_groups(shape, names, rank, backend, timeout_s),
                       backend)


def make_production_mesh(*, multi_pod: bool = False) -> GridContext:
    """The reference's production mesh: (16, 16) as ("data", "model"), or
    (2, 16, 16) with "pod" in front. In a world of exactly that many ranks
    (``torch.distributed`` initialized) the grid is joined; otherwise its
    layout alone is returned (rank 0's coordinates, no group), for the
    shape and the specs."""
    shape, names = grid_layout(2 if multi_pod else 1, 16, 16)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} "
                             f"ranks, the world has {world}")
        rank, backend = dist.get_rank(), dist.get_backend()
        return GridContext(shape, names, rank, grid_groups(shape, names, rank, backend),
                           backend)
    return GridContext(shape, names)


def _norm_grid(grid) -> Tuple[int, int, int]:
    pod, data, model = grid
    return int(pod), int(data), int(model)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_loop(rank: int, tp: int, init_method: str, device: str, threads: int,
               timeout_s: float, sizes: Sequence[int], grids, inbox, outbox) -> None:
    """A rank's process: join the group and make the subgroups and grids,
    then run each (fn, key, args) from ``inbox`` with the context of the
    first ``key`` ranks (an int) or of the grid ``key`` (a (pod, data,
    model) tuple) and put (rank, ok, result or traceback) on ``outbox``;
    None ends it."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(rank, device)
        if dev.startswith("cuda"):
            torch.cuda.set_device(torch.device(dev))
        ctx = make_tp_mesh(tp, rank=rank, init_method=init_method, device=device,
                           timeout_s=timeout_s)
        ctxs = {tp: ctx}
        backend = ctx.backend
        import torch.distributed as dist
        timeout = datetime.timedelta(seconds=timeout_s)
        for size in sorted(set(sizes) - {tp}):
            # every rank of the world takes part in making every subgroup
            ranks = list(range(size))
            group = dist.new_group(ranks, backend=backend, timeout=timeout)
            host = group if backend == "gloo" else dist.new_group(
                ranks, backend="gloo", timeout=timeout)
            if rank < size:
                ctxs[size] = TPContext(rank=rank, size=size, group=group,
                                       host_group=host, backend=backend)
        for grid in grids:
            shape, names = grid_layout(*grid)
            groups = grid_groups(shape, names, rank, backend, timeout_s)
            if rank < math.prod(shape):
                ctxs[grid] = GridContext(shape, names, rank, groups, backend)
        outbox.put((rank, True, "ready"))
    except Exception:
        outbox.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            job = inbox.get()
            if job is None:
                break
            fn, key, args, kwargs = job
            try:
                res = fn(ctxs[key], dev, *args, **kwargs)
                outbox.put((rank, True, res))
            except Exception:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _drain(q) -> None:
    try:
        while True:
            q.get_nowait()
    except (queue_mod.Empty, OSError, ValueError):
        pass


class RankPool:
    """``tp`` spawned rank processes in one group (and, for each of
    ``sizes``, a subgroup of its first ranks; for each (pod, data, model)
    of ``grids``, that training grid over its first ranks). ``run(fn,
    *args, size=)`` calls ``fn(ctx, device, *args)`` in ranks 0..size-1 and
    returns their results in rank order; ``run(fn, *args, grid=(pod, data,
    model))`` calls ``fn(grid_context, device, *args)`` in the grid's
    ranks. A rank that raises makes ``run`` raise with its traceback.
    ``fn`` and its arguments must pickle (a module-level function). Use as
    a context manager, or call ``close``."""

    def __init__(self, tp: int, device: str = "cuda", *, threads: int = 0,
                 sizes: Sequence[int] = (), grids: Sequence[Tuple[int, int, int]] = (),
                 timeout_s: float = GROUP_TIMEOUT_S):
        import multiprocessing as mp
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        grids = tuple(_norm_grid(g) for g in grids)
        for g in grids:
            if math.prod(g) > tp:
                raise ValueError(f"grid {g} needs {math.prod(g)} ranks, the pool has {tp}")
        self.tp, self.device, self.timeout_s = tp, device, timeout_s
        self.backend = pick_backend(tp, device)
        ctx = mp.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(tp)]
        init = f"tcp://127.0.0.1:{_free_port()}"
        self._procs = [ctx.Process(target=_rank_loop, daemon=True,
                                   args=(r, tp, init, device, threads, timeout_s,
                                         tuple(sizes), grids, self._inboxes[r], self._outbox))
                       for r in range(tp)]
        for p in self._procs:
            p.start()
        try:
            self._collect(range(tp), "start")
        except BaseException:
            self.close()
            raise

    def _collect(self, ranks, what: str) -> List[Any]:
        """Each of ``ranks``' next message, in rank order. Raises with the
        failing ranks' tracebacks once the others have answered, or once the
        group's timeout has passed since the first failure (the others may
        wait in a collective for the failed rank), or when a rank's process
        dies."""
        want = set(ranks)
        got: Dict[int, Any] = {}
        errors: Dict[int, str] = {}
        deadline = None
        while want - set(got) - set(errors):
            if errors and deadline is None:
                deadline = time.monotonic() + self.timeout_s + 10
            try:
                rank, ok, res = self._outbox.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r in want - set(got) - set(errors)
                        if not self._procs[r].is_alive()]
                errors.update({r: f"rank {r} exited with code {self._procs[r].exitcode}"
                               for r in dead})
                if deadline is not None and time.monotonic() > deadline:
                    break
                continue
            (got if ok else errors)[rank] = res
        if errors:
            raise RuntimeError(
                f"tensor-parallel {what} failed on rank(s) {sorted(errors)}:\n"
                + "\n".join(f"--- rank {r} ---\n{t}" for r, t in sorted(errors.items())))
        return [got[r] for r in sorted(want)]

    def run(self, fn: Callable, *args, size: Optional[int] = None,
            grid: Optional[Tuple[int, int, int]] = None, **kwargs) -> List[Any]:
        key = size or self.tp
        if grid is not None:
            key = _norm_grid(grid)
            size = math.prod(key)
        else:
            size = key
        for r in range(size):
            self._inboxes[r].put((fn, key, args, kwargs))
        return self._collect(range(size), getattr(fn, "__name__", "call"))

    def close(self) -> None:
        """End every rank: ask each to stop, join it while draining what it
        still writes (a writer blocked on a full pipe never exits), and
        kill one that has not ended after 30 s."""
        for q, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                q.put(None)
        deadline = time.monotonic() + 30
        for p in self._procs:
            while p.is_alive() and time.monotonic() < deadline:
                _drain(self._outbox)
                p.join(timeout=0.1)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for q in (self._outbox, *self._inboxes):
            _drain(q)
            q.close()
            q.cancel_join_thread()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
