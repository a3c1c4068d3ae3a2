"""End-to-end example: train a small LM (~100M parameters with ``--big``),
then deploy it with posit-compressed weights and measure the quality cost.

Port of ``examples/train_lm.py``. The pipeline:

  synthetic data stream -> train step (block remat, AdamW with posit8
  moments) -> checkpoints every 50 steps (auto-resume) -> post-training
  quantization (normalized posit / PoFx, FxP, a mixed policy) ->
  perplexity against fp32 -> a quantized ``paper-table6`` checkpoint and
  its storage report.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu --steps 20

The flags are the reference's (defaults: ``--steps 120 --small``, the
yi-9b smoke config; ``--big``: 12 layers, d_model 512, vocab 32000) plus
``--device`` (the card unless ``cpu`` is given). ``--ckpt-dir`` defaults to
``repro_torch_train_lm`` in the temporary directory (``TMPDIR``); the
quantized checkpoint goes to the same path plus ``_quant``. A second run
with the same directory resumes from its last checkpoint. The evaluation
runs the model's own datapath, dequantizing each quantized weight, as the
reference's does. ``main`` returns a ``TrainLMRun``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import QuantPolicy, storage_report
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.launch.train import make_train_state, make_train_step
from repro_torch.nn.models import LM, apply_policy, build_model, ce_loss
from repro_torch.optim import tree_leaves
from repro_torch.runtime import CheckpointManager, StepTimeMonitor

__all__ = ["POLICIES", "TrainLMRun", "model_config", "eval_batches", "mean_nll",
           "perplexity", "deploy", "main"]

POLICIES = ("pofx8es2", "pofx6es2", "fxp8f7", "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16")
SAVED_POLICY = "paper-table6"
EVAL_STEP = 10_000           # the eval batches: synthetic_batch(dc, EVAL_STEP + i)
N_EVAL = 4
CKPT_EVERY = 50
LOG_EVERY = 20


@dataclasses.dataclass
class TrainLMRun:
    """What ``main`` did: the model and its trained parameters, the
    parameter count, the step it resumed from (0 for a fresh run), every
    trained step's (step, loss), the training's host seconds and the
    straggler monitor's report, each policy's perplexity ("fp32" the
    trained parameters'), the saved checkpoint's policy as its manifest
    reads it, and its storage report."""
    model: LM
    params: dict
    n_params: int
    start: int
    losses: List[Tuple[int, float]]
    train_s: float
    monitor: str
    ppl: Dict[str, float]
    saved_policy: str
    storage: str


def model_config(small: bool) -> ModelConfig:
    """yi-9b at the smoke size, or (``small`` False) ~100M parameters: 12
    layers, d_model 512, d_ff 2048, 8 heads of 64 (4 kv heads), vocab
    32000."""
    base = smoke(ARCHS["yi-9b"])
    if small:
        return base
    return dataclasses.replace(base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                               d_head=64, d_ff=2048, vocab_size=32000)


def eval_batches(dc: DataConfig) -> List[dict]:
    return [synthetic_batch(dc, EVAL_STEP + i) for i in range(N_EVAL)]


def mean_nll(model: LM, params, batches) -> float:
    """The mean over ``batches`` of each one's mean cross-entropy."""
    tot = 0.0
    with torch.no_grad():
        for b in batches:
            logits = model.forward(params, torch.as_tensor(b["tokens"]))
            tot += float(ce_loss(logits, torch.as_tensor(b["labels"]).to(model.device)))
    return tot / len(batches)


def perplexity(model: LM, params, batches) -> float:
    """exp of ``mean_nll`` (inf where it overflows f64, as the reference's
    ``np.exp``)."""
    return float(np.exp(mean_nll(model, params, batches)))


def deploy(model: LM, params, dc: DataConfig, ckpt_dir: str, step: int,
           out: Callable[[str], None] = print) -> Tuple[Dict[str, float], str, str]:
    """The reference's deployment of trained ``params``: the perplexity of
    the eval batches under fp32 and each of ``POLICIES`` (``apply_policy``),
    then the ``paper-table6`` quantized checkpoint saved at ``step`` under
    ``ckpt_dir + "_quant"``, read back: (perplexities, the manifest's
    policy, the restored parameters' storage report)."""
    batches = eval_batches(dc)
    base = perplexity(model, params, batches)
    ppl = {"fp32": base}
    out(f"\n{'policy':<28} {'perplexity':>11} {'vs fp32':>9}")
    out(f"{'fp32':<28} {base:11.3f} {'-':>9}")
    for pol_s in POLICIES:
        p = perplexity(model, apply_policy(params, pol_s), batches)
        ppl[pol_s] = p
        out(f"{pol_s:<28} {p:11.3f} {p / base:8.3f}x")

    # quantized checkpoint round trip: codes + policy metadata at rest
    policy = QuantPolicy.from_string(SAVED_POLICY)
    qp = apply_policy(params, policy)
    qm = CheckpointManager(ckpt_dir + "_quant", keep=1, async_save=False)
    qm.save(step, {"params": qp}, policy=policy)
    saved = qm.read_manifest()["quant_policy"]
    report = storage_report(qm.restore({"params": qp})["params"], policy)
    out(f"\nsaved quantized checkpoint (policy={saved}):")
    out(report)
    return ppl, saved, report


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> TrainLMRun:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--small", action="store_true", default=True)
    ap.add_argument("--big", dest="small", action="store_false",
                    help="~100M params (slower on CPU)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = model_config(args.small)
    rcfg = RunConfig(learning_rate=1e-3, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     remat="block", opt_state_quant="posit8")
    model = build_model(cfg, rcfg, device=args.device)
    state = make_train_state(model, 0)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"-> {n_params / 1e6:.1f}M params")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    manager = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    latest = manager.latest_step()
    if latest is not None:
        state = manager.restore(state, latest)
        start = latest + 1
        print(f"resumed from step {latest}")
    step_fn = make_train_step(model)
    mon = StepTimeMonitor()
    losses: List[Tuple[int, float]] = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = synthetic_batch(dc, step)
        mon.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])            # waits for the step
        mon.stop()
        losses.append((step, loss))
        if step % LOG_EVERY == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f} lr {float(metrics['lr']):.2e}")
        if step % CKPT_EVERY == CKPT_EVERY - 1:
            manager.save(step, state)
    manager.save(args.steps - 1, state)
    manager.wait()
    _sync(model.device)
    train_s = time.perf_counter() - t0
    report = mon.report()
    print(f"trained in {train_s:.1f}s | {report}")

    # ---- deployment: post-training posit quantization ----------------------
    params = state["params"]
    ppl, saved, storage = deploy(model, params, dc, args.ckpt_dir, args.steps - 1)
    return TrainLMRun(model, params, n_params, start, losses, train_s, report, ppl, saved,
                      storage)


if __name__ == "__main__":
    main()
