"""The training step and its command-line loop.

Port of ``repro/launch/train.py`` for one device. ``make_train_step``
assembles the step:

  microbatch gradient accumulation (f32 accumulators)
  -> global-norm clip + AdamW (optionally posit8-compressed moments)

and updates the state IN PLACE (the reference jits its step with the
state donated). The reference's posit8-compressed cross-pod gradient
mean needs a mesh with a "pod" axis, as do its sharding trees: they wait
for tensor parallelism. Without a mesh the reference runs the plain
branch, which is the one ported.

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
import time
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ARCHS, RunConfig, smoke as smoke_cfg
from repro_torch.nn.models import LM, build_model
from repro_torch.optim import (OptConfig, apply_updates, init_opt_state,
                               tree_leaves, tree_map)

__all__ = ["make_train_state", "make_train_step", "opt_config_from_run",
           "value_and_grad"]

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


def make_train_step(model: LM):
    """Returns train_step(state, batch, mark=None) -> (state, metrics). The
    state is updated in place and returned; ``batch`` holds "tokens" and
    "labels" (numpy or tensors), and for the encdec family "frames" (B,
    Se, d_model); microbatches split every key of it along the batch;
    ``mark(name)``, if given, is called where
    each phase ("forward", "backward", "optimizer") begins and at the
    "end"."""
    rcfg = model.rcfg
    ocfg = opt_config_from_run(rcfg)
    n_micro = max(rcfg.microbatch, 1)

    def grads_plain(params, batch, mark):
        if n_micro == 1:
            return value_and_grad(model, params, batch, mark)
        B = batch["tokens"].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        b = B // n_micro
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        losses = []
        for i in range(n_micro):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            loss, g = value_and_grad(model, params, mb, mark)
            for a, gg in zip(acc, g):
                a.add_(gg.to(torch.float32) / n_micro)
            del g
            losses.append(loss)
        return torch.stack(losses).mean(), acc

    def train_step(state, batch, mark=None):
        mark = mark or _nomark
        batch = _on_device(batch, model.device)
        loss, grads = grads_plain(state["params"], batch, mark)
        mark("optimizer")
        with torch.profiler.record_function("optimizer"):
            _, _, metrics = apply_updates(state["params"], grads, state["opt"], ocfg)
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

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
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

    cfg = ARCHS[args.arch]
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
