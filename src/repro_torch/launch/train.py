"""The training step and its command-line loop.

Port of ``repro/launch/train.py``. ``make_train_step(model, mesh)``
assembles the step:

  microbatch gradient accumulation (f32 accumulators)
  -> optional posit8-compressed cross-pod gradient mean
  -> global-norm clip + AdamW (optionally posit8-compressed moments)

and updates the state IN PLACE (the reference jits its step with the
state donated). On one device it runs the reference's plain branch. On a
training grid (a model built with ``grid=``, a ``launch.mesh.
make_host_mesh`` context; every family) each rank holds its shard of the
state (``state_shardings``: moments like their parameter, a posit8 scale
and the count replicated, ``ef`` like the parameters) and takes its rows
of the batch (``rank_microbatches``): every rank is given the whole batch,
which is cut where it lies (on the host) as the reference's step cuts it,
into microbatches of the global batch (under the compressed pod mean, of
the pod's rows), each microbatch's rows over the batch ranks, so that an
MoE layer routes the rows the reference routes together; only the rank's
rows reach the device, as the reference's ``batch_shardings`` place them.
Plain branch: the rank's gradients (FSDP's reduce-scatter sums a
data-sharded leaf's over the data ranks in the backward), then the sum
over the batch group of what is not summed yet, over the batch ranks.
Pod branch (``grad_compression`` "posit8" or "posit8_ef" and a mesh with
a "pod" axis): the mean over the pod's data
ranks, then ``runtime.compression.compressed_grad_transform`` over the pod
group (error feedback in ``state["ef"]`` under "posit8_ef"), then the
update. The loss is the mean over the batch ranks. ``make_train_state``
on a grid draws the tp = 1 state leaf by leaf and keeps the rank's shard.
The CLI has no mesh flag, as the reference's has none; the tests and
``chip_smoke.py`` drive grids through ``launch.mesh.RankPool``.

The CLI runs the reference's loop: data pipeline -> train step ->
async checkpoints (auto-resume) -> straggler monitor, with the
reference's flags and line formats, on ``--device`` (cuda by default;
no fallback to the CPU), for every arch the reference takes. Like the
reference's, its batches carry no encoder frames, so ``--arch
whisper-medium`` stops at the first step's forward with the reference's
assertion (the encdec family trains through ``make_train_step`` on
batches with "frames"). ``--smoke`` shrinks the arch so the loop runs on
a CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
        --device cpu --steps 50 --ckpt-dir /tmp/ckpt

After the loop it prints one ``train:`` line of JSON: every step's loss,
grad norm and seconds, the tokens a step, the state's init seconds and,
on the card, the peak device memory. ``--profile`` splits the last step into its forward,
backward and optimizer with CUDA events at their boundaries (the
stream's time between them; the host clock on the CPU) and traces it
with torch.profiler for the step's device busy time and heaviest
kernels.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs import ARCHS, RunConfig, smoke as smoke_cfg, truncate
from repro_torch.core.policy import named_leaves
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.nn.models import LM, build_model
from repro_torch.nn.sharding import GRID_AXES, TPContext, map_with_logical
from repro_torch.optim import (OptConfig, apply_updates, init_opt_state,
                               tree_leaves, tree_map)
from repro_torch.optim.adamw import _POSIT8
from repro_torch.runtime.compression import compressed_grad_transform

__all__ = ["make_train_state", "abstract_train_state", "make_train_step",
           "opt_config_from_run", "state_shardings", "batch_shardings", "rank_microbatches", "spec_leaves", "leaf_groups",
           "value_and_grad"]

# elements a bucket of one gradient all-reduce (f32: 256 MiB)
BUCKET = 1 << 26

PHASES = ("forward", "backward", "optimizer")


def opt_config_from_run(rcfg: RunConfig) -> OptConfig:
    return OptConfig(
        learning_rate=rcfg.learning_rate,
        warmup_steps=rcfg.warmup_steps,
        total_steps=rcfg.total_steps,
        weight_decay=rcfg.weight_decay,
        grad_clip=rcfg.grad_clip,
        quant="posit8" if rcfg.opt_state_quant == "posit8" else "none",
    )


def make_train_state(model: LM, seed: int = 0) -> Dict[str, Any]:
    """{"params": model.init(seed), "opt": the zero AdamW state}, plus the
    reference's zero error-feedback tree under ``posit8_ef``."""
    params = model.init(seed)
    state = {"params": params,
             "opt": init_opt_state(params, opt_config_from_run(model.rcfg).quant)}
    if model.rcfg.grad_compression == "posit8_ef":
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
    return state


def abstract_train_state(model: LM, fake_mode=None) -> Dict[str, Any]:
    """``make_train_state(model)`` as fake tensors: every leaf's shape, dtype
    and device (on a grid, the rank's shard), nothing allocated. The leaves
    belong to ``fake_mode`` (a ``FakeTensorMode``; a new one if None), under
    which the step that takes them must run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_mode or FakeTensorMode():
        return make_train_state(model, model.rcfg.seed)


def state_shardings(model: LM) -> Dict[str, Any]:
    """The spec of every leaf of the train state on the model's grid (each
    dim's mesh axis or None): params as ``model.specs()``; the moments like
    their parameter, a posit8 moment's codes so and its scale replicated; the
    count replicated; ``ef`` like the parameters."""
    p = model.specs()
    rcfg = model.rcfg

    def like_params(quant):
        if quant != "posit8":
            return p
        return map_with_logical(lambda name, s, ax: QuantizedTensor(s, (None,) * len(s), _POSIT8),
                                p, model.logical())

    quant = opt_config_from_run(rcfg).quant
    out = {"params": p, "opt": {"m": like_params(quant), "v": like_params(quant),
                                "count": ()}}
    if rcfg.grad_compression == "posit8_ef":
        out["ef"] = p
    return out


def batch_shardings(model: LM, batch) -> Dict[str, Tuple]:
    """Each batch leaf's spec: its rows over ("pod", "data"), the rest
    whole (rows that the batch ranks do not divide replicate)."""
    grid = model.grid
    return {k: grid.spec(("batch",) + (None,) * (len(v.shape) - 1), tuple(v.shape))
            for k, v in batch.items()}


def _rows(model: LM, batch, axes) -> Dict[str, torch.Tensor]:
    """Each leaf's block of rows at this rank's coordinates on ``axes`` (the
    batch rule's lenient spec: rows that those ranks do not divide stay
    whole), as views of ``batch`` where it lies: the step moves only these
    rows to the device."""
    grid = model.grid
    axes = tuple(a for a in GRID_AXES if a in axes and a in grid.sizes)
    n = math.prod(grid.sizes[a] for a in axes)
    out = {}
    for k, v in batch.items():
        rows = None if not axes or v.shape[0] % n else (axes if len(axes) > 1 else axes[0])
        out[k] = grid.shard(v, (rows,) + (None,) * (v.ndim - 1), copy=False)
    return out


def rank_microbatches(model: LM, batch, n_micro: int) -> List[Dict[str, torch.Tensor]]:
    """The rows of ``batch`` (every key along its first dim, tensors) that
    this rank runs, as ``n_micro`` microbatches in the reference's order:
    the global batch (under the compressed pod mean, the pod's rows) split
    into microbatches, and each microbatch's rows cut over
    ``model.batch_axes`` (off a grid, the microbatches themselves): views
    of ``batch``, wherever it lies."""
    grid = model.grid
    if grid is not None and "pod" not in model.batch_axes:
        batch = _rows(model, batch, ("pod",))
    B = batch["tokens"].shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    b = B // n_micro
    mbs = [{k: v[i * b:(i + 1) * b] for k, v in batch.items()} for i in range(n_micro)]
    return mbs if grid is None else [_rows(model, mb, model.batch_axes) for mb in mbs]


def spec_leaves(model: LM) -> List[Tuple]:
    """Each parameter leaf's spec, in ``tree_leaves`` order."""
    out: List[Tuple] = []
    map_with_logical(lambda name, spec, ax: out.append(spec), model.specs(), model.logical())
    return out


def leaf_groups(model: LM) -> List[TPContext]:
    """For each parameter leaf (``tree_leaves`` order), the group of ranks
    its shards lie on (TPContext() where it is whole)."""
    grid = model.grid
    return [grid.axis(*grid.shard_axes(s)) for s in spec_leaves(model)]


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _nomark(name: str) -> None:
    pass


def value_and_grad(model: LM, params, batch, mark=_nomark) -> Tuple[torch.Tensor, list]:
    """(loss, gradients in ``tree_leaves`` order) of ``model.loss`` on
    ``batch`` (numpy or tensors). The parameters are read through detached
    aliases, so ``params`` itself never requires grad. ``mark(name)`` is
    called where the forward and the backward begin."""
    batch = _on_device(batch, model.device)
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    mark("forward")
    with torch.profiler.record_function("forward"):
        loss, _ = model.loss(tree_map(lambda _: next(it), params), batch)
    mark("backward")
    with torch.profiler.record_function("backward"):
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), list(grads)


def _batch_mean(model: LM, grads, over: Tuple[str, ...]) -> list:
    """Each gradient leaf summed over the ``over`` axes, over their rank
    count; a data-sharded leaf's sum over data came with its reduce-scatter.
    The leaves that need one group are all-reduced together, in buckets of
    up to BUCKET elements."""
    grid = model.grid
    n = 1
    for a in over:
        n *= grid.sizes.get(a, 1)
    buckets: Dict[Tuple[str, ...], List[int]] = {}
    for i, spec in enumerate(spec_leaves(model)):
        axes = tuple(a for a in over if a != "data" or "data" not in spec)
        buckets.setdefault(axes, []).append(i)
    out = list(grads)
    for axes, idx in buckets.items():
        ctx = grid.axis(*axes)
        start = 0
        while start < len(idx) and ctx.size > 1:
            part, size = [], 0
            while start < len(idx) and (not part or size + out[idx[start]].numel() <= BUCKET):
                part.append(idx[start])
                size += out[idx[start]].numel()
                start += 1
            flat = ctx.all_reduce(torch.cat([out[i].reshape(-1) for i in part]))
            for i, piece in zip(part, flat.split([out[i].numel() for i in part])):
                out[i] = piece.view_as(out[i])
    return [g / n for g in out] if n > 1 else out


def make_train_step(model: LM, mesh=None):
    """Returns train_step(state, batch, mark=None, probe=None) -> (state,
    metrics). The state is updated in place and returned; ``batch`` holds
    "tokens" and "labels" (numpy or tensors), and for the encdec family
    "frames" (B, Se, d_model); microbatches split every key of it along
    the batch, cut where it lies, and only the rank's rows of each reach
    the device; ``mark(name)``, if given, is called where each phase
    ("forward", "backward", "optimizer") begins and at the "end". On a
    grid ``mesh`` is the model's GridContext (the reference's signature;
    its "pod" axis selects the compressed branch under ``grad_compression``
    "posit8*"), ``batch`` is the whole batch, and ``probe``, a dict, gets
    CPU copies of the pod branch's gradients before ("pod_grads") and after
    ("mean_grads") the compressed mean."""
    rcfg = model.rcfg
    ocfg = opt_config_from_run(rcfg)
    n_micro = max(rcfg.microbatch, 1)
    grid = model.grid
    if mesh is not None and (grid is None or tuple(mesh.shape) != tuple(grid.shape)
                             or tuple(mesh.axis_names) != tuple(grid.axis_names)):
        raise ValueError("make_train_step: the mesh must be the model's grid")
    compression = rcfg.grad_compression
    # each pod runs its own rows under the compressed pod mean (LM.batch_axes)
    pod_branch = grid is not None and "pod" not in model.batch_axes
    shards = leaf_groups(model) if grid is not None else None

    def grads_plain(params, batch, mark):
        mbs = rank_microbatches(model, batch, n_micro)
        if n_micro == 1:
            return value_and_grad(model, params, mbs[0], mark)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        losses = []
        for mb in mbs:
            loss, g = value_and_grad(model, params, mb, mark)
            for a, gg in zip(acc, g):
                a.add_(gg.to(torch.float32) / n_micro)
            del g
            losses.append(loss)
        return torch.stack(losses).mean(), acc

    def grid_grads(state, loss, grads, probe):
        """The batch mean of the rank's gradients and loss (and the pod
        branch's compressed mean)."""
        loss = grid.axis("pod", "data").all_reduce(loss) / (
            grid.sizes.get("pod", 1) * grid.sizes.get("data", 1))
        if not pod_branch:
            return loss, _batch_mean(model, grads, ("pod", "data"))
        grads = _batch_mean(model, grads, ("data",))
        if probe is not None:
            probe["pod_grads"] = [g.detach().cpu() for g in grads]
        ef = tree_leaves(state["ef"]) if compression == "posit8_ef" else None
        names = [name for name, _ in named_leaves(state["params"])]
        grads, new_ef = compressed_grad_transform(grads, grid.axis("pod"), N=8, ES=2,
                                                  residuals=ef, shards=shards, names=names)
        if ef is not None:
            for r, n in zip(ef, new_ef):
                r.copy_(n)
        if probe is not None:
            probe["mean_grads"] = [g.detach().cpu() for g in grads]
        return loss, grads

    def train_step(state, batch, mark=None, probe=None):
        mark = mark or _nomark
        # cut where the batch lies (the host's); each microbatch of the
        # rank's rows goes to the device as it runs (value_and_grad)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss, grads = grads_plain(state["params"], batch, mark)
        if grid is not None:
            loss, grads = grid_grads(state, loss, grads, probe)
        mark("optimizer")
        with torch.profiler.record_function("optimizer"):
            _, _, metrics = apply_updates(state["params"], grads, state["opt"], ocfg,
                                          shards=shards)
        mark("end")
        metrics["loss"] = loss
        return state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Command-line loop
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_step(step_fn, state, batch, device):
    """One step split into its phases and traced: {"forward", "backward",
    "optimizer": ms between the marks at their boundaries (CUDA events: the
    stream's time, on the card; the host clock on the CPU), "device_busy_ms"
    (the kernels' own time, torch.profiler), "wall_ms", "top": the heaviest
    kernels [name, ms]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    marks = []

    def mark(name):
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        else:
            marks.append((name, time.perf_counter()))

    # on the card its kernels alone: the host's ops are not read, and
    # recording them made a full-depth step's trace take minutes
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, mark)
        _sync(device)
        wall = time.perf_counter() - t0
    out = dict.fromkeys(PHASES, 0.0)
    for (name, a), (_, b) in zip(marks, marks[1:]):
        out[name] += a.elapsed_time(b) if cuda else (b - a) * 1e3
    # the card's kernels (the device-side spans of the phases' ranges left out)
    kernels = {e.key: (getattr(e, "self_device_time_total", 0) or 0) / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in PHASES}
    out["device_busy_ms"] = sum(kernels.values())
    out["wall_ms"] = wall * 1e3
    out["top"] = sorted(([k, v] for k, v in kernels.items() if v > 0),
                        key=lambda kv: -kv[1])[:8]
    out["trace_s"] = time.perf_counter() - t0      # the step and the trace's processing
    return state, metrics, out


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-9b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="train the arch's first N layers at full width "
                         "(0 = every layer)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--opt-quant", default="none", choices=["none", "posit8"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="trace the last step with torch.profiler "
                         "(forward, backward, optimizer device ms)")
    args = ap.parse_args(argv)

    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.runtime import CheckpointManager, StepTimeMonitor

    cfg = truncate(ARCHS[args.arch], args.layers)
    if args.smoke:
        cfg = smoke_cfg(cfg)
    rcfg = RunConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     microbatch=args.microbatch, opt_state_quant=args.opt_quant,
                     remat="block")
    model = build_model(cfg, rcfg, device=args.device)
    dev = model.device
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)

    t0 = time.perf_counter()
    state = make_train_state(model, rcfg.seed)
    _sync(dev)
    init_s = time.perf_counter() - t0
    start = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=3)
        latest = manager.latest_step()
        if latest is not None:
            print(f"resuming from step {latest}")
            state = manager.restore(state, latest)
            start = latest + 1

    step_fn = make_train_step(model)
    mon = StepTimeMonitor()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    run: Dict[str, Any] = {"arch": cfg.name, "steps": [], "loss": [], "grad_norm": [],
                           "step_s": [], "tokens_per_step": args.batch * args.seq,
                           "init_s": init_s}
    for step in range(start, args.steps):
        batch = synthetic_batch(dc, step)
        if args.profile and step == args.steps - 1:
            state, metrics, run["profile"] = profile_step(step_fn, state, batch, dev)
            ev, dur = None, run["profile"]["wall_ms"] / 1e3
        else:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            float(metrics["loss"])          # waits for the step
            dur = time.perf_counter() - t0
            ev = mon.record(step, dur)
        if ev:
            print(f"[straggler] step={ev.step} dur={ev.duration:.3f}s z={ev.zscore:.1f}")
        run["steps"].append(step)
        run["loss"].append(float(metrics["loss"]))
        run["grad_norm"].append(float(metrics["grad_norm"]))
        run["step_s"].append(dur)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}")
        if manager and (step % args.ckpt_every == 0 or step == args.steps - 1):
            manager.save(step, state)
    if manager:
        manager.wait()
    print(mon.report())
    if dev.type == "cuda":
        run["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    if "profile" in run:
        p = run["profile"]
        clock = "card" if dev.type == "cuda" else "host"
        print(f"profile: step {args.steps - 1} ({clock} ms): forward {p['forward']:.1f}, "
              f"backward {p['backward']:.1f}, optimizer {p['optimizer']:.1f}; device busy "
              f"{p['device_busy_ms']:.1f} of {p['wall_ms']:.1f} ms wall (traced in "
              f"{p['trace_s']:.1f} s)")
        for name, ms in p["top"]:
            print(f"  {ms:10.2f} ms  {name[:100]}")
    print("train: " + json.dumps(run))
    return run


if __name__ == "__main__":
    main()
