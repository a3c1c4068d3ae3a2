"""The dry run: each (arch x shape) cell's step traced as one rank of the
production grid on fake tensors, with what it costs that rank and its
roofline at an H100's data-sheet rates.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell on 512 fake XLA devices and reads the compiled artifact; PyTorch has
no compiled artifact, so a cell runs its step itself, once, as one rank:

  1. the process joins a fake world of 256 (``single``, the (16, 16)
     ("data", "model") mesh) or 512 (``multi``, (2, 16, 16) with "pod")
     ranks as rank 0 (or ``--rank r``) through ``torch.distributed``'s
     "fake" backend, whose collectives return at once;
  2. it builds the model on ``launch.mesh.make_production_mesh`` and its
     train state as fake tensors (``launch.train.abstract_train_state``,
     under ``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes
     and devices, nothing allocated);
  3. it runs one whole ``make_train_step(model, mesh)`` on the cell's global
     batch, which lies on the "meta" device in the host's place (the step
     copies the rank's rows of each microbatch to the device, and the
     rank's arguments are its state and those rows), under
     ``launch.op_cost.count_step``: forward, remat's recompute,
     backward, the batch mean, the pod mean and AdamW with the knob's
     moments, counting flops, HBM bytes, bytes on the wire and the live
     bytes' high-water mark;
  4. it prices the counts with ``launch.hlo_analysis.roofline_terms`` and
     writes a JSON record under OUT_DIR (git-ignored).

A serving cell (prefill_32k, decode_32k, and long_500k for the
long-context archs) runs the same way through the serving entry points
(``dry_serve_step``): the rank's params under the ``--quant`` policy (codes
cut like the parameter, the scale whole), ``init_cache``'s block (its
rows over (pod, data), its sequence over model) and the whole batch's
tokens, then one ``prefill`` or ``decode_step`` under ``count_step``, on
the plain path (the reference's dry run keeps the kernels out), with
``serve_bf16_compute``. Its model flops are 2 N D; its argument bytes are
the rank's arguments as the reference places them (``serve_arguments``:
the batch's rows of the rank), and the trace's own (the whole batch's
tokens, which every rank is given) are kept beside them.

Usage (no card needed with ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --device cpu [--jobs 4] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --summary

``--all`` (``--shape`` a comma-separated list of the shapes to sweep, every
shape by default) runs each cell in a fresh subprocess (each cell joins its own
fake world, and a crash in one cell cannot end the sweep), ``--jobs`` at a
time, and skips cells whose JSON already exists unless ``--force``; it ends
with ``--summary``'s tables of the train and serve cells.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Tuple

import torch

__all__ = ["run_cell", "dry_train_step", "dry_serve_step", "serve_arguments", "spec_bytes",
           "memory_record",
           "fake_world", "abstract_mode", "prepare_host_tables", "analytic_model_flops",
           "train_run_config", "summary", "TRAIN_KNOBS", "main"]

SRC = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT_DIR = os.path.join(SRC, "..", "experiments", "dryrun_torch")

# Per-arch training knobs, the reference's (chosen by napkin math over a
# 16 GB chip): microbatches bound the per-layer activation checkpoints; SP
# shards the residual stream over the model axis; posit8 moments (the
# paper's codec on optimizer state) halve the Adam footprint for the 100B+
# models.
TRAIN_KNOBS: Dict[str, Dict[str, Any]] = {
    "llama3-405b":              dict(microbatch=8, sequence_parallel=True, opt="posit8"),
    "nemotron-4-340b":          dict(microbatch=8, sequence_parallel=True, opt="posit8"),
    "deepseek-67b":             dict(microbatch=4, sequence_parallel=True, opt="none"),
    "chameleon-34b":            dict(microbatch=2, sequence_parallel=True, opt="none"),
    "yi-9b":                    dict(microbatch=1, sequence_parallel=True, opt="none"),
    "llama4-maverick-400b-a17b": dict(microbatch=2, sequence_parallel=True, opt="posit8"),
    "moonshot-v1-16b-a3b":      dict(microbatch=1, sequence_parallel=True, opt="none"),
    "chameleon-7b":             dict(microbatch=1, sequence_parallel=True, opt="none"),
    "falcon-mamba-7b":          dict(microbatch=1, sequence_parallel=False, opt="none"),
    "whisper-medium":           dict(microbatch=1, sequence_parallel=True, opt="none"),
    "zamba2-1.2b":              dict(microbatch=1, sequence_parallel=False, opt="none"),
}

def _cell_path(out_dir: str, arch: str, shape: str, mesh_kind: str,
               quant: str) -> str:
    safe = re.sub(r"[^A-Za-z0-9._-]+", "-", quant)  # policy strings have */=,
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}__{safe}.json")


def analytic_model_flops(cfg, shape) -> float:
    """The spec's MODEL_FLOPS convention: 6*N*D train, 2*N*D forward-only."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult) * n * tokens


def train_run_config(arch: str):
    """The reference's run configuration of ``arch``'s train cells."""
    from repro_torch.configs import RunConfig
    knobs = TRAIN_KNOBS.get(arch, {})
    return RunConfig(remat="block", microbatch=knobs.get("microbatch", 1),
                     sequence_parallel=knobs.get("sequence_parallel", False),
                     opt_state_quant=knobs.get("opt", "none"))


@contextlib.contextmanager
def fake_world(rank: int, world_size: int):
    """This process as ``rank`` of a world of ``world_size`` ranks over the
    "fake" backend: groups are made at once, collectives return at once
    and move nothing. The world is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already belongs to a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def prepare_host_tables(policy=None) -> None:
    """Put the caches a step reads in the state a first step finds them in,
    whether its tensors are real or fake: the host tables that the step
    turns into numpy made (a fake tensor has no numpy): posit8's values
    (for posit8 moments) and the pofx decode table of each pofx format of
    ``policy`` (a QuantPolicy; its KV rule too); and the device tables
    made from them dropped (the optimizer's posit8 values, the pofx decode
    tables), so that the step makes them and no tensor of another mode is
    reused."""
    from repro_torch.core import quantizers
    from repro_torch.core.pofx import pofx_norm_lut
    from repro_torch.core.posit import posit_value_table
    from repro_torch.optim import adamw
    posit_value_table(adamw._POSIT8.N, adamw._POSIT8.ES)
    for _, spec in (policy.rules if policy is not None else ()):
        if spec is not None and spec.kind == "pofx":
            pofx_norm_lut(spec.N, spec.ES, spec.M, spec.rounding)
    adamw._posit8_values.cache_clear()
    quantizers._lut_on.cache_clear()


@contextlib.contextmanager
def abstract_mode(policy=None):
    """A ``FakeTensorMode`` for one dry step, the caches prepared on entry
    (``prepare_host_tables(policy)``) and the device tables dropped on
    exit, so that no fake tensor outlives the mode in a cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import quantizers
    from repro_torch.optim import adamw
    prepare_host_tables(policy)
    try:
        yield FakeTensorMode()
    finally:
        adamw._posit8_values.cache_clear()
        quantizers._lut_on.cache_clear()


def dry_train_step(model, batch_specs, mesh=None):
    """One ``make_train_step(model, mesh)`` on fake tensors: the fake train
    state (``abstract_train_state``) and a fake global batch of
    ``batch_specs`` (``nn.models.input_specs``) on the "meta" device, the
    host's, under ``op_cost.count_step``: the step copies the rank's rows
    of each microbatch to the model's device, and the rank's arguments are
    its state and its rows (``argument_bytes``), as the reference's
    ``batch_shardings`` place them. Returns (StepCost, seconds)."""
    from repro_torch.launch.op_cost import count_step
    from repro_torch.launch.train import (abstract_train_state, make_train_step,
                                          rank_microbatches)
    t0 = time.perf_counter()
    with abstract_mode() as mode:
        state = abstract_train_state(model, mode)
        with mode:
            batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                     for k, s in batch_specs.items()}
            cost = count_step(make_train_step(model, mesh), state, batch)
            mbs = rank_microbatches(model, batch, max(model.rcfg.microbatch, 1))
    cost.argument_bytes += sum(t.numel() * t.element_size() for mb in mbs for t in mb.values())
    return cost, time.perf_counter() - t0


def serve_run_config():
    """The reference's run configuration of the serving cells."""
    from repro_torch.configs import RunConfig
    return RunConfig(remat="none", sequence_parallel=False, serve_bf16_compute=True)


def dry_serve_step(model, shape, policy):
    """One ``prefill`` (prefill cells) or ``decode_step`` (decode cells) of
    ``model`` (one rank's, on a grid) on fake tensors under
    ``op_cost.count_step``: the params drawn under ``policy`` (``LM.init``:
    the rank's codes, whole scales), ``init_cache`` of the cell's global
    batch and length, and the whole batch's tokens (and frames, encdec),
    which the rank cuts to its rows. Returns (StepCost, seconds)."""
    from repro_torch.launch.op_cost import count_step
    B, S = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    with abstract_mode(policy) as mode:
        with mode:
            params = model.init(model.rcfg.seed, policy=policy)
            cache = model.init_cache(B, S)
            dev = model.device
            if shape.kind == "prefill":
                tokens = torch.zeros((B, S), dtype=torch.int32, device=dev)
                frames = (torch.zeros((B, S, model.cfg.d_model), dtype=torch.bfloat16,
                                      device=dev) if model.cfg.family == "encdec" else None)
                cost = count_step(lambda p, c, t, f: model.prefill(p, t, cache=c, frames=f),
                                  params, cache, tokens, frames)
            else:
                tokens = torch.zeros((B, 1), dtype=torch.int32, device=dev)
                cost = count_step(model.decode_step, params, cache, tokens)
    return cost, time.perf_counter() - t0


def memory_record(cost) -> Dict[str, int]:
    """The reference's ``memory_analysis`` keys from a StepCost: the
    arguments, the outputs, the outputs that are arguments updated in place
    (alias), the peak of live bytes, and the temporaries above the
    arguments and outputs at that peak."""
    base = cost.argument_bytes + cost.output_bytes - cost.alias_bytes
    temp = max(cost.peak_bytes - base, 0)
    return {"argument_size_in_bytes": cost.argument_bytes,
            "output_size_in_bytes": cost.output_bytes,
            "alias_size_in_bytes": cost.alias_bytes,
            "temp_size_in_bytes": temp,
            "peak_memory_in_bytes": cost.peak_bytes,
            "live_bytes_per_device": base + temp}


# -- serving cells: the rank's arguments from the grid's specs ----------------


def _quantized_layout(name: str, ndim: int, policy):
    """What ``policy`` makes of a leaf ``name`` of ``ndim`` dims: None (kept
    as it is), a dtype (cast), or (codes dtype, scale dtype, the dims the
    scale keeps, QuantSpec), read from a small real probe leaf whose dims
    are distinct primes."""
    from repro_torch.core.quantizers import QuantizedTensor
    from repro_torch.nn.models import _apply_rule
    primes = (2, 3, 5, 7, 11)[:ndim]
    probe = torch.randn(primes, generator=torch.Generator().manual_seed(0))
    out = _apply_rule(name, probe, policy)
    if out is probe:
        return None
    if not isinstance(out, QuantizedTensor):
        return out.dtype
    keep = tuple(i for i, d in enumerate(out.scale.shape) if d != 1)
    return out.codes.dtype, out.scale.dtype, keep, out.spec


def serve_arguments(model, shape, quant: str, grid) -> Dict[str, Any]:
    """A serve cell's arguments on ``grid``'s rank as trees of
    ``nn.models.TensorSpec``: {"params": every leaf under the ``quant``
    policy (a QuantizedTensor of TensorSpecs: its codes cut like the
    parameter, its scale whole, as the reference places them), "cache":
    ``init_cache``'s leaves cut by ``cache_logical`` (the sequence over
    model), "batch": the rank's rows}. ``model`` is the tp = 1 model (its
    ``kv_spec`` the policy's); nothing is allocated."""
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quantizers import QuantizedTensor
    from repro_torch.nn.models import TensorSpec, input_specs
    from repro_torch.nn.sharding import map_with_logical, train_rules
    rules = train_rules(grid.axis_names)
    policy = QuantPolicy.from_string(quant) if quant not in ("bf16", "fp32") else None
    with abstract_mode() as mode, mode:
        params = model.init(model.rcfg.seed)
        cache = model.init_cache(shape.global_batch, shape.seq_len)

    def local(logical, full) -> Tuple[int, ...]:
        return grid.local_shape(grid.spec(logical, full, rules), full)

    layouts: Dict[Tuple[str, int], Any] = {}

    def param(name, t, logical):
        full = tuple(t.shape)
        lay = None
        if policy is not None:
            if (name, t.ndim) not in layouts:
                layouts[name, t.ndim] = _quantized_layout(name, t.ndim, policy)
            lay = layouts[name, t.ndim]
        if lay is None or isinstance(lay, torch.dtype):
            return TensorSpec(local(logical, full), lay or t.dtype)
        codes_dt, scale_dt, keep, qspec = lay
        scale = tuple(d if i in keep else 1 for i, d in enumerate(full))
        return QuantizedTensor(TensorSpec(local(logical, full), codes_dt),
                               TensorSpec(scale, scale_dt), qspec)

    return {"params": map_with_logical(param, params, model.logical()),
            "cache": map_with_logical(lambda n, t, ax: TensorSpec(local(ax, tuple(t.shape)),
                                                                  t.dtype),
                                      cache, model.cache_logical()),
            "batch": {k: TensorSpec(local(("batch",), s.shape), s.dtype)
                      for k, s in input_specs(model.cfg, shape).items()}}


def spec_bytes(tree) -> int:
    """Bytes of a tree of TensorSpecs (QuantizedTensor nodes included)."""
    from repro_torch.core.quantizers import QuantizedTensor
    if isinstance(tree, dict):
        return sum(spec_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(spec_bytes(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return spec_bytes(tree.codes) + spec_bytes(tree.scale)
    return math.prod(tree.shape) * tree.dtype.itemsize


# -- one cell ------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_kind: str = "single", quant: str = "auto",
             out_dir: str = OUT_DIR, verbose: bool = True, device: str = "cuda",
             rank: int = 0) -> Dict[str, Any]:
    """Trace one cell as ``rank`` of its production grid on ``device``
    (fake tensors: nothing is allocated there) and return its record."""
    from repro_torch.configs import ARCHS, LONG_CONTEXT_ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.nn.models import build_model, input_specs

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "quant": quant, "kind": shape.kind, "rank": rank,
                           "device": str(device)}
    if quant == "auto":
        quant = "bf16" if shape.kind == "train" else "pofx8"
        rec["quant"] = quant
    if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        rec.update(ok=False, skipped=True,
                   reason="full-attention arch: long_500k needs sub-quadratic mixing")
        return rec
    multi = mesh_kind == "multi"
    n_dev = 512 if multi else 256

    serve = shape.kind != "train"
    if serve:
        rcfg = serve_run_config()
        kv_spec, policy = None, None
        if quant not in ("bf16", "fp32"):
            policy = QuantPolicy.from_string(quant)
            if cfg.family != "encdec":
                kv_spec = policy.kv_spec
                rec["kv_quant"] = bool(kv_spec)
        whole = build_model(cfg, rcfg, device=device, kv_spec=kv_spec)
        with fake_world(rank, n_dev):
            mesh = make_production_mesh(multi_pod=multi)
            args = serve_arguments(whole, shape, quant, mesh)
            model = build_model(cfg, rcfg, device=device, kv_spec=kv_spec, grid=mesh)
            cost, trace_s = dry_serve_step(model, shape, policy)
    else:
        rcfg = train_run_config(arch)
        with fake_world(rank, n_dev):
            mesh = make_production_mesh(multi_pod=multi)
            model = build_model(cfg, rcfg, device=device, grid=mesh)
            cost, trace_s = dry_train_step(model, input_specs(cfg, shape), mesh)
    rec["trace_s"] = trace_s
    mem = memory_record(cost)
    if serve:
        mem["traced_argument_bytes"] = mem["argument_size_in_bytes"]
        mem["argument_size_in_bytes"] = spec_bytes(args)
        mem["arguments_by_part"] = {k: spec_bytes(v) for k, v in args.items()}
    rec["memory"] = mem
    rec["fits"] = mem["peak_memory_in_bytes"] <= hlo_analysis.HBM_BYTES
    rec["cost"] = {"flops_per_device": cost.flops_per_device,
                   "bytes_per_device": cost.bytes_per_device, "n_ops": cost.n_ops}
    rec["collectives"] = {"wire_bytes_per_device": cost.wire_bytes_per_device,
                          "wire_bytes_in_node": cost.wire_bytes_in_node,
                          "by_kind": cost.wire_by_kind, "n_ops": cost.n_collectives}
    mf = analytic_model_flops(cfg, shape)
    rec["model_flops"] = mf
    rec["params"] = cfg.param_count()
    rec["active_params"] = cfg.active_param_count()
    rec["n_devices"] = n_dev
    rec["roofline"] = hlo_analysis.roofline_terms(
        cost.flops_per_device, cost.bytes_per_device, cost.wire_bytes_per_device, mf, n_dev,
        wire_bytes_in_node=cost.wire_bytes_in_node)
    rec["run_config"] = ({"remat": rcfg.remat, "serve_bf16_compute": rcfg.serve_bf16_compute,
                          "use_kernel": False} if serve else
                         {"microbatch": rcfg.microbatch,
                          "sequence_parallel": rcfg.sequence_parallel,
                          "opt_state_quant": rcfg.opt_state_quant, "remat": rcfg.remat})
    rec["ok"] = True
    if verbose:
        _print_cost(rec, cost, trace_s)
    return rec


def _print_cost(rec, cost, trace_s) -> None:
    """A cell's memory, op cost and roofline lines."""
    from repro_torch.launch import hlo_analysis
    mem, gib = rec["memory"], 2 ** 30
    print(f"[memory/device] args={mem['argument_size_in_bytes'] / gib:.2f}GiB "
          f"out={mem['output_size_in_bytes'] / gib:.2f}GiB "
          f"temp={mem['temp_size_in_bytes'] / gib:.2f}GiB "
          f"peak={mem['peak_memory_in_bytes'] / gib:.2f}GiB "
          f"live={mem['live_bytes_per_device'] / gib:.2f}GiB "
          f"(of {hlo_analysis.HBM_BYTES / gib:.0f} GiB)")
    print("[op cost/device]")
    print(cost.summary())
    r = rec["roofline"]
    print(f"[roofline] compute={r['compute_s'] * 1e3:.2f}ms "
          f"memory={r['memory_s'] * 1e3:.2f}ms "
          f"collective={r['collective_s'] * 1e3:.2f}ms "
          f"bound={r['bound']} mfu_bound={r['mfu_bound']:.3f} "
          f"useful_flops_ratio={r['useful_flops_ratio']:.3f} (traced in {trace_s:.1f}s)")


def _save(rec: Dict[str, Any], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = _cell_path(out_dir, rec["arch"], rec["shape"], rec["mesh"], rec["quant"])
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def summary(out_dir: str = OUT_DIR) -> str:
    """Two tables of the records in ``out_dir``, the train cells' and the
    serve cells': per-rank argument and peak GiB, whether the peak fits,
    the roofline's three terms and bound (the train cells' mfu_bound and
    useful_flops_ratio too) and trace seconds; a skipped or failed cell
    says why."""
    recs = []
    for name in sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []:
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                recs.append(json.load(f))
    gib = 2 ** 30
    train = ["| arch | mesh | args GiB | peak GiB | fits 80 GiB | compute ms | memory ms | "
             "collective ms | bound | bound ms | mfu_bound | useful_flops_ratio | trace_s |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    serve = ["| arch | shape | mesh | args GiB | peak GiB | fits 80 GiB | compute ms | "
             "memory ms | collective ms | bound | bound ms | trace_s |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for rec in recs:
        is_train = rec.get("kind") == "train"
        head = (f"| {rec['arch']} | {rec['mesh']} |" if is_train
                else f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} |")
        rows = train if is_train else serve
        if not rec.get("ok"):
            why = rec.get("reason") if rec.get("skipped") else f"FAILED: {rec.get('error', '')}"
            rows.append(f"{head} {str(why)[:80]} |")
            continue
        m, r = rec["memory"], rec["roofline"]
        line = (f"{head} {m['argument_size_in_bytes'] / gib:.2f} | "
                f"{m['peak_memory_in_bytes'] / gib:.2f} | {'yes' if rec['fits'] else 'no'} | "
                f"{r['compute_s'] * 1e3:.1f} | {r['memory_s'] * 1e3:.1f} | "
                f"{r['collective_s'] * 1e3:.1f} | {r['bound']} | "
                f"{r['step_lower_bound_s'] * 1e3:.1f} |")
        if is_train:
            line += f" {r['mfu_bound']:.3f} | {r['useful_flops_ratio']:.3f} |"
        rows.append(line + f" {rec['trace_s']:.1f} |")
    return "\n".join(train) + "\n\nServe cells:\n\n" + "\n".join(serve)


def _sweep(args) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    todo = []
    for arch in ARCHS:
        for shape in (args.shape.split(",") if args.shape else SHAPES):
            for mk in meshes:
                quant = args.quant
                if quant == "auto":
                    quant = "bf16" if SHAPES[shape].kind == "train" else "pofx8"
                if os.path.exists(_cell_path(args.out, arch, shape, mk, quant)) and not args.force:
                    continue
                todo.append(((arch, shape, mk), [
                    sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                    "--shape", shape, "--mesh", mk, "--quant", args.quant, "--out", args.out,
                    "--device", args.device, "--rank", str(args.rank)]))
    t0 = time.perf_counter()
    failures, running = [], []

    def reap(block: bool) -> None:
        for item in list(running):
            cell, proc = item
            if block or proc.poll() is not None:
                out, err = proc.communicate()
                running.remove(item)
                print(f"=== {' x '.join(cell)} ({args.quant}): exit {proc.returncode}",
                      flush=True)
                if proc.returncode != 0:
                    failures.append(cell)
                    print(out[-2000:])
                    print(err[-2000:])
                if not block:
                    return

    for cell, cmd in todo:
        while len(running) >= max(args.jobs, 1):
            reap(False)
            time.sleep(0.2)
        running.append((cell, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)))
    while running:
        reap(True)
    print(f"sweep done in {time.perf_counter() - t0:.1f}s; {len(failures)} failures: "
          f"{failures}")
    print(summary(args.out))
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch")
    ap.add_argument("--shape", help="a shape; under --all, the shapes (comma-separated) "
                    "to sweep (default: every shape)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    from repro_torch.core.policy import add_policy_arg
    add_policy_arg(ap, default="auto", extra_help="'auto' = bf16 train / pofx8 serve")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the device the fake tensors claim (cuda needs a card)")
    ap.add_argument("--rank", type=int, default=0, help="the rank of the grid to trace")
    ap.add_argument("--jobs", type=int, default=1, help="cells at a time under --all")
    ap.add_argument("--summary", action="store_true",
                    help="print the tables of the cells under --out and exit")
    args = ap.parse_args(argv)

    if args.summary:
        print(summary(args.out))
        return 0
    if args.all:
        return _sweep(args)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    from repro_torch.configs.base import SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    status = 0
    for mk in meshes:
        try:
            rec = run_cell(args.arch, args.shape, mk, args.quant, args.out,
                           device=args.device, rank=args.rank)
        except Exception as e:
            kind = SHAPES[args.shape].kind
            quant = args.quant if args.quant != "auto" else (
                "bf16" if kind == "train" else "pofx8")
            rec = {"arch": args.arch, "shape": args.shape, "mesh": mk, "quant": quant,
                   "kind": kind, "ok": False, "error": str(e),
                   "traceback": traceback.format_exc()}
            status = 1
        path = _save(rec, args.out)
        print(f"{'OK ' if rec.get('ok') else ('SKIP' if rec.get('skipped') else 'FAIL')} -> {path}")
        if not rec.get("ok") and not rec.get("skipped"):
            print(rec.get("traceback", rec.get("error", "")))
    return status


if __name__ == "__main__":
    sys.exit(main())
