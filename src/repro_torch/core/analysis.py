"""Behavioral analysis — the paper's Fig. 8 multi-level error pipeline.

Port of ``repro/core/analysis.py``:

Level (a): per-layer weight quantization error  -> prune bad configs early
Level (b): per-layer output-activation error with quantized weights
Level (c): end-to-end task metric of the quantized network

plus the joint Pareto analysis over (error, storage) that produces Tables
3/4 (``core.pareto``, ``core.policy.policy_from_pareto``). Model-agnostic:
works on any dict of weights (tensors or numpy arrays) and any apply-fn;
``launch/analyze.py`` drives it end to end. The error statistics are f32
and stay on the weight's device until the reference's ``float(...)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .quantizers import QuantSpec, dequantize, quantize, storage_bits

__all__ = [
    "weight_error",
    "activation_error",
    "sweep_configs",
    "BehavioralReport",
    "default_spec_grid",
    "spec_name",
]


def _f32(w) -> torch.Tensor:
    return torch.as_tensor(w).to(torch.float32)


def weight_error(w, spec: QuantSpec, axis: Optional[int] = None) -> Dict[str, float]:
    """Quantization-induced error stats of one weight tensor (paper Fig. 16).

    avg_rel: average absolute relative error (paper's headline metric),
    max_abs: maximum absolute error; mse for completeness.
    """
    w = _f32(w)
    qt = quantize(w, spec, axis=axis)
    wq = dequantize(qt, torch.float32)
    err = (wq - w).abs()
    denom = w.abs().clamp_min(1e-8)
    return {
        "avg_rel": float((err / denom).mean()),
        "avg_abs": float(err.mean()),
        "max_abs": float(err.max()),
        "mse": float((err ** 2).mean()),
        "bits": storage_bits(qt),
    }


def activation_error(apply_fn: Callable, w, spec: QuantSpec, x,
                     axis: Optional[int] = None) -> Dict[str, float]:
    """Error in a layer's outputs when its weights are quantized (level b)."""
    y_ref = apply_fn(_f32(w), x)
    wq = dequantize(quantize(_f32(w), spec, axis=axis), torch.float32)
    y_q = apply_fn(wq, x)
    err = (y_q - y_ref).abs()
    denom = y_ref.abs().clamp_min(1e-6)
    return {
        "avg_rel": float((err / denom).mean()),
        "avg_abs": float(err.mean()),
        "max_abs": float(err.max()),
    }


@dataclasses.dataclass
class BehavioralReport:
    per_config: Dict[str, Dict]            # spec name -> level a/b/c results
    pruned_at_a: List[str]
    pruned_at_b: List[str]
    survivors: List[str]

    def table(self) -> str:
        rows = ["config,avg_rel_weight_err,act_err,metric,bits_per_weight,pruned"]
        for name, r in sorted(self.per_config.items()):
            rows.append(
                f"{name},{r.get('weight_avg_rel', float('nan')):.5f},"
                f"{r.get('act_avg_rel', float('nan')):.5f},"
                f"{r.get('metric', float('nan')):.4f},"
                f"{r.get('bits_per_weight', float('nan')):.2f},"
                f"{r.get('pruned', '')}"
            )
        return "\n".join(rows)


def spec_name(spec: QuantSpec) -> str:
    if spec.kind in ("fp32", "bf16"):
        return spec.kind
    if spec.kind == "fxp":
        return f"fxp{spec.M}"
    if spec.kind == "posit":
        return f"posit({spec.N},{spec.ES})"
    return f"pofx({spec.N - 1},{spec.ES},{spec.path})"


def default_spec_grid(include_paths: bool = True) -> List[QuantSpec]:
    """The paper's sweep: FxP{7,8,16}, Posit(N in 5..8, ES in 0..3), PoFx."""
    specs: List[QuantSpec] = [QuantSpec(kind="fxp", M=7, F=6),
                              QuantSpec(kind="fxp", M=8, F=7),
                              QuantSpec(kind="fxp", M=16, F=15)]
    for N in (5, 6, 7, 8):
        for ES in (0, 1, 2, 3):
            specs.append(QuantSpec(kind="posit", N=N, ES=ES))
    for N in (6, 7, 8):
        for ES in (1, 2, 3):
            specs.append(QuantSpec(kind="pofx", N=N, ES=ES, path="via_fxp"))
            if include_paths:
                specs.append(QuantSpec(kind="pofx", N=N, ES=ES, path="direct"))
    return specs


def sweep_configs(
    weights: Dict[str, torch.Tensor],
    specs: Sequence[QuantSpec],
    *,
    layer_apply: Optional[Dict[str, Tuple[Callable, torch.Tensor]]] = None,
    end_to_end: Optional[Callable[[QuantSpec], float]] = None,
    prune_weight_err: float = 0.5,
    prune_act_err: float = 0.5,
) -> BehavioralReport:
    """Run the three-level Fig. 8 pipeline over a spec grid.

    weights: named weight tensors (level a averages over them).
    layer_apply: name -> (apply_fn, sample_input) for level b.
    end_to_end: spec -> task metric (higher is better) for level c; only
    called for configs surviving levels a and b (the paper's early pruning).
    """
    per_config: Dict[str, Dict] = {}
    pruned_a, pruned_b, survivors = [], [], []
    for spec in specs:
        name = spec_name(spec)
        rec: Dict = {}
        errs = [weight_error(w, spec, axis=-1) for w in weights.values()]
        rec["weight_avg_rel"] = float(np.mean([e["avg_rel"] for e in errs]))
        rec["weight_max_abs"] = float(np.max([e["max_abs"] for e in errs]))
        total_bits = sum(e["bits"] for e in errs)
        total_n = sum(int(np.prod(w.shape)) for w in weights.values())
        rec["bits_per_weight"] = total_bits / max(total_n, 1)
        if rec["weight_avg_rel"] > prune_weight_err:
            rec["pruned"] = "level_a"
            pruned_a.append(name)
            per_config[name] = rec
            continue
        if layer_apply:
            act = [activation_error(fn, weights[k], spec, x)
                   for k, (fn, x) in layer_apply.items() if k in weights]
            rec["act_avg_rel"] = float(np.mean([a["avg_rel"] for a in act])) if act else 0.0
            if rec["act_avg_rel"] > prune_act_err:
                rec["pruned"] = "level_b"
                pruned_b.append(name)
                per_config[name] = rec
                continue
        if end_to_end is not None:
            rec["metric"] = float(end_to_end(spec))
        survivors.append(name)
        per_config[name] = rec
    return BehavioralReport(per_config, pruned_a, pruned_b, survivors)
