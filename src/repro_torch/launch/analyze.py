"""Behavioral-analysis CLI: the paper's Fig. 8 design-space exploration.

Port of ``examples/behavioral_analysis.py``. Trains a small LM on the
synthetic stream (``data/pipeline.py``), runs the three-level
quantization-error pipeline (``core.analysis.sweep_configs``) over the
full (FxP | Posit | PoFx) config grid, prunes infeasible configs level by
level, prints the survivors with their storage cost and the best config
per stored-bit budget, then derives a per-group policy from the (error,
storage) Pareto fronts (``core.policy.policy_from_pareto``), prints its
storage report and the eval NLL under it:

    PYTHONPATH=src python -m repro_torch.launch.analyze --smoke --device cpu

The defaults are the example's: yi-9b at smoke size (``--smoke`` is
accepted and changes nothing: the example runs the smoke size alone), 60
steps at lr 1e-3 (warmup a tenth of them), no remat, 8 x 128-token
batches. Level (a) reads layer 0's wq (as d_model x -1), wo and
wg and the unembed; level (b) is ``x @ w`` on wq and wg for a seeded 64 x
d_model input; level (c) is the eval NLL of ``synthetic_batch(dc,
9999)`` under ``quantize_params(params, spec)``. ``--use-kernel`` sends
level (c)'s quantized matmuls through the PoFx/FxP kernels (on the CPU
their plain versions). ``main`` returns an ``AnalysisRun``;
``run_analysis`` does everything after training, on given parameters.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCHS, RunConfig, smoke as smoke_cfg
from repro_torch.core import prng
from repro_torch.core.analysis import (BehavioralReport, default_spec_grid, spec_name,
                                       sweep_configs)
from repro_torch.core.policy import QuantPolicy, policy_from_pareto, storage_report
from repro_torch.core.quantizers import QuantSpec
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ops import KernelSet
from repro_torch.nn.models import LM, apply_policy, build_model, ce_loss, quantize_params

__all__ = ["AnalysisRun", "eval_nll", "run_analysis", "main"]

ARCH = "yi-9b"
EVAL_STEP = 9_999
LEVEL_B = ("wq", "wg")
LEVEL_B_ROWS = 64
PRUNE_WEIGHT_ERR = 0.25
PRUNE_ACT_ERR = 0.25
MAX_AVG_REL = 0.05
FALLBACK = "pofx8es2"


@dataclasses.dataclass
class AnalysisRun:
    """What the analysis found: the report, the best config per stored-bit
    budget ({bits: (config, metric)}), the derived policy, its storage
    report and eval NLL, host seconds by part ("a", "b", "c" for the
    sweep's levels, "policy" for the Pareto search, "policy_eval",
    "analysis" for all of ``run_analysis``; ``main`` adds "train"), and
    each survivor's kernel launches in its level-(c) forward (counted on
    CUDA only). Level (b) is the span of each pair of its apply-fn calls
    (the layer on the weight, the quantization, the layer on the
    quantized weight), level (c) that of each ``end_to_end`` call, and
    level (a) the rest of the sweep."""
    report: BehavioralReport
    best: Dict[int, Tuple[str, float]]
    policy: QuantPolicy
    storage: str
    policy_nll: float
    seconds: Dict[str, float]
    launches: Dict[str, Dict[str, int]]
    train_loss: Optional[float] = None


def eval_nll(model: LM, params, batch) -> float:
    """Mean cross-entropy of the model's logits on ``batch``."""
    with torch.no_grad():
        logits = model.forward(params, torch.as_tensor(batch["tokens"]))
        return float(ce_loss(logits, torch.as_tensor(batch["labels"]).to(model.device)))


def _best_per_budget(report: BehavioralReport) -> Dict[int, Tuple[str, float]]:
    best: Dict[int, Tuple[str, float]] = {}
    for name, rec in report.per_config.items():
        if rec.get("pruned") or "metric" not in rec:
            continue
        b = round(rec["bits_per_weight"])
        if b not in best or rec["metric"] > best[b][1]:
            best[b] = (name, rec["metric"])
    return best


def run_analysis(model: LM, params, *, dc: DataConfig,
                 specs: Optional[Sequence[QuantSpec]] = None,
                 kernels: Optional[KernelSet] = None,
                 x: Optional[torch.Tensor] = None,
                 out: Callable[[str], None] = print) -> AnalysisRun:
    """The example's analysis of trained ``params``: the sweep over
    ``specs`` (default: ``default_spec_grid(include_paths=True)``), its
    report, the best config per stored-bit budget, the Pareto-derived
    policy, its storage report and its eval NLL, printed through ``out``.
    ``kernels`` (a ``KernelSet``) runs level (c) and the policy's eval
    through it; None keeps the model's own datapath. ``x`` is level (b)'s
    input (default: ``normal(PRNGKey(1), (64, d_model))``)."""
    t_start = time.perf_counter()
    if kernels is not None:
        model = dataclasses.replace(model, use_kernel=True, kernel_set=kernels)
    specs = default_spec_grid(include_paths=True) if specs is None else list(specs)
    # level (a) inputs: the attention and MLP weight matrices of layer 0
    layer = params["blocks"][0]
    weights = {"wq": layer["attn"]["wq"].reshape(model.cfg.d_model, -1),
               "wo": layer["attn"]["wo"],
               "wg": layer["mlp"]["wg"],
               "unembed": params["unembed"]}
    if x is None:
        x = prng.normal(prng.PRNGKey(1, model.device), (LEVEL_B_ROWS, model.cfg.d_model))
    x = torch.as_tensor(x).to(model.device)
    eval_batch = synthetic_batch(dc, EVAL_STEP)
    launches: Dict[str, Dict[str, int]] = {}
    seconds = {"b": 0.0, "c": 0.0}
    calls = {"n": 0, "t0": 0.0}

    def layer(w, x):
        # activation_error applies the layer to the weight and then to the
        # quantized weight: level (b) runs from the first call to the second
        # call's result on the device
        if calls["n"] % 2 == 0:
            calls["t0"] = time.perf_counter()
        y = x @ w
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            if y.is_cuda:
                torch.cuda.synchronize(y.device)
            seconds["b"] += time.perf_counter() - calls["t0"]
        return y

    def end_to_end(spec):
        t0 = time.perf_counter()
        before = dict(LAUNCHES)
        nll = eval_nll(model, quantize_params(params, spec), eval_batch)
        launches[spec_name(spec)] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                                     if LAUNCHES[k] != before[k]}
        seconds["c"] += time.perf_counter() - t0
        return -nll

    t0 = time.perf_counter()
    report = sweep_configs(weights, specs, layer_apply={k: (layer, x) for k in LEVEL_B},
                           end_to_end=end_to_end, prune_weight_err=PRUNE_WEIGHT_ERR,
                           prune_act_err=PRUNE_ACT_ERR)
    seconds["a"] = time.perf_counter() - t0 - seconds["b"] - seconds["c"]
    out(f"\npruned at level a (weight err): {report.pruned_at_a}")
    out(f"pruned at level b (activation err): {report.pruned_at_b}")
    out(f"survivors: {len(report.survivors)}")
    out("\n" + report.table())

    best = _best_per_budget(report)
    out("\nbest config per stored-bit budget:")
    for b in sorted(best):
        out(f"  {b:2d} bits/weight -> {best[b][0]:<22} eval_nll={-best[b][1]:.4f}")

    # format search -> QuantPolicy: per layer group, the cheapest
    # Pareto-front format meeting the error budget (Table 6 methodology)
    t0 = time.perf_counter()
    groups = {"attn/*": [weights["wq"], weights["wo"]],
              "mlp/*": [weights["wg"]],
              "*embed*": [weights["unembed"]]}
    policy = policy_from_pareto(groups, max_avg_rel=MAX_AVG_REL, fallback=FALLBACK)
    seconds["policy"] = time.perf_counter() - t0
    out(f"\npareto-derived policy: {policy.to_string()}")
    t0 = time.perf_counter()
    qp = apply_policy(params, policy)
    storage = storage_report(qp, policy)
    out(storage)
    nll = eval_nll(model, qp, eval_batch)
    seconds["policy_eval"] = time.perf_counter() - t0
    out(f"eval_nll under pareto policy: {nll:.4f}")
    seconds["analysis"] = time.perf_counter() - t_start
    return AnalysisRun(report, best, policy, storage, nll, seconds, launches)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for the other CLIs' sake: the analysis runs the smoke "
                         "size alone, as the example does")
    ap.add_argument("--steps", type=int, default=60, help="training steps before the sweep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route level (c)'s quantized matmuls through the PoFx/FxP kernels")
    return ap


def main(argv: Optional[List[str]] = None) -> AnalysisRun:
    """Train, then ``run_analysis``, per the CLI's flags."""
    from repro_torch.launch.train import make_train_state, make_train_step
    args = _parser().parse_args(argv)
    cfg = smoke_cfg(ARCHS[ARCH])
    rcfg = RunConfig(learning_rate=1e-3, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1), remat="none")
    model = build_model(cfg, rcfg, device=args.device, use_kernel=args.use_kernel)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    t0 = time.perf_counter()
    state = make_train_state(model, 0)
    step_fn = make_train_step(model)
    loss = float("nan")
    for step in range(args.steps):
        state, metrics = step_fn(state, synthetic_batch(dc, step))
        loss = float(metrics["loss"])
    train_s = time.perf_counter() - t0
    print(f"trained {args.steps} steps; loss={loss:.3f}")
    run = run_analysis(model, state["params"], dc=dc)
    run.seconds["train"] = train_s
    run.train_loss = loss
    return run


if __name__ == "__main__":
    main()
