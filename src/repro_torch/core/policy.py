"""QuantPolicy — per-layer mixed-precision quantization with one spec grammar.

Port of ``repro/core/policy.py`` (grammar, rules, presets, the ``kv=``
rule, the storage report, the analysis-driven ``policy_from_pareto`` and
the shared CLI arguments). Spec grammar:

    fp32 | bf16                       passthrough baselines
    fxp{M}[f{F}]                      FxP(M, F); F defaults to M-1
    posit{N}[es{ES}]                  Posit(N, ES); ES defaults to 2
    pofx{N}[es{ES}][m{M}][-direct]    normalized Posit(N-1, ES) storage,
                                      FxP(M, M-1) compute
    keep                              leave the tensor untouched
    optional scale suffix: @channel (default) | @tensor | @none

Policy grammar: one spec (uniform), comma-separated ``glob=spec`` rules
matched first-wins against "/"-joined parameter paths (a pattern is
anchored at a path-segment boundary), an optional ``kv=<spec>`` rule naming
the decode KV-cache format, or a preset name.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .quantizers import (QuantSpec, QuantizedTensor, storage_bits,
                         validate_kv_spec)

__all__ = ["parse_spec", "format_spec", "QuantPolicy", "PRESETS", "KV_RULE",
           "parse_kv_spec", "storage_report", "named_leaves", "layer_prefixes",
           "add_policy_arg", "add_kv_quant_arg", "resolve_kv_spec",
           "validate_scale_sharding", "policy_from_pareto"]

# Reserved rule name: "kv=<spec>" configures the decode KV-cache format and
# never participates in parameter path matching.
KV_RULE = "kv"

_SCALE_TOKENS = {"channel": "channel_pow2", "tensor": "tensor_pow2",
                 "none": "none"}
_SCALE_NAMES = {v: k for k, v in _SCALE_TOKENS.items()}

_FXP_RE = re.compile(r"^fxp(\d+)(?:f(\d+))?$")
_POSIT_RE = re.compile(r"^posit(\d+)(?:es(\d+))?$")
_POFX_RE = re.compile(r"^pofx(\d+)(?:es(\d+))?(?:m(\d+))?(?:-(direct|viafxp))?$")

GRAMMAR_HELP = (
    "spec grammar: fp32 | bf16 | fxp{M}[f{F}] | posit{N}[es{ES}] | "
    "pofx{N}[es{ES}][m{M}][-direct] | keep, each with optional "
    "@channel|@tensor|@none scale suffix; policy grammar: one spec "
    "(uniform) or comma-separated glob=spec rules matched first-wins "
    "against parameter paths (e.g. 'attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16'), "
    "plus an optional 'kv=<spec>' rule naming the decode KV-cache format "
    "(fxp/pofx, byte-wide codes), or a preset name (%s)"
)


def parse_kv_spec(s: str) -> Optional[QuantSpec]:
    """Parse + validate one KV-cache spec string ("keep"/bf16/fp32 -> None)."""
    return validate_kv_spec(parse_spec(s))


def parse_spec(s: str) -> Optional[QuantSpec]:
    """Parse one spec string; returns None for the "keep" sentinel."""
    tok = s.strip().lower()
    if tok in ("keep", "skip"):
        return None
    scale_mode = None
    if "@" in tok:
        tok, _, sm = tok.partition("@")
        if sm not in _SCALE_TOKENS:
            raise ValueError(
                f"unknown scale mode {sm!r} in spec {s!r} "
                f"(expected one of {sorted(_SCALE_TOKENS)})")
        scale_mode = _SCALE_TOKENS[sm]
    if tok in ("fp32", "f32", "float32"):
        return QuantSpec(kind="fp32")
    if tok in ("bf16", "bfloat16"):
        return QuantSpec(kind="bf16")
    kw = {} if scale_mode is None else {"scale_mode": scale_mode}
    m = _FXP_RE.match(tok)
    if m:
        M = int(m.group(1))
        F = int(m.group(2)) if m.group(2) else M - 1
        return QuantSpec(kind="fxp", M=M, F=F, **kw)
    m = _POSIT_RE.match(tok)
    if m:
        N = int(m.group(1))
        ES = int(m.group(2)) if m.group(2) else 2
        return QuantSpec(kind="posit", N=N, ES=ES, **kw)
    m = _POFX_RE.match(tok)
    if m:
        N = int(m.group(1))
        ES = int(m.group(2)) if m.group(2) else 2
        M = int(m.group(3)) if m.group(3) else 8
        path = "direct" if m.group(4) == "direct" else "via_fxp"
        return QuantSpec(kind="pofx", N=N, ES=ES, M=M, path=path, **kw)
    raise ValueError(f"cannot parse quant spec {s!r} ({GRAMMAR_HELP % '...'})")


def format_spec(spec: Optional[QuantSpec]) -> str:
    """Canonical spec string; ``parse_spec(format_spec(s)) == s``."""
    if spec is None:
        return "keep"
    if spec.kind in ("fp32", "bf16"):
        return spec.kind
    if spec.kind == "fxp":
        out = f"fxp{spec.M}" + (f"f{spec.F}" if spec.F != spec.M - 1 else "")
    elif spec.kind == "posit":
        out = f"posit{spec.N}es{spec.ES}"
    else:
        out = f"pofx{spec.N}es{spec.ES}"
        if spec.M != 8:
            out += f"m{spec.M}"
        if spec.path == "direct":
            out += "-direct"
    if spec.scale_mode != "channel_pow2":
        out += "@" + _SCALE_NAMES.get(spec.scale_mode, spec.scale_mode)
    return out


def _match_one(pattern: str, name: str) -> bool:
    return (fnmatch.fnmatchcase(name, pattern)
            or fnmatch.fnmatchcase(name, "*/" + pattern))


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered (path-glob -> QuantSpec) rules; first match wins. A spec of
    None ("keep") and unmatched paths leave tensors untouched; the ``kv``
    rule names the KV-cache format and never matches a path."""
    rules: Tuple[Tuple[str, Optional[QuantSpec]], ...]

    @classmethod
    def uniform(cls, spec) -> "QuantPolicy":
        if isinstance(spec, str):
            spec = parse_spec(spec)
        return cls(rules=(("*", spec),))

    @classmethod
    def from_string(cls, s: str) -> "QuantPolicy":
        text = s.strip()
        if text in PRESETS:
            text = PRESETS[text]
        rules: List[Tuple[str, Optional[QuantSpec]]] = []
        seen_kv = False
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                pat, _, spec_s = part.partition("=")
                pat = pat.strip()
                if pat == KV_RULE:
                    if seen_kv:
                        raise ValueError(f"duplicate kv= rule in policy {s!r}")
                    seen_kv = True
                    rules.append((KV_RULE, validate_kv_spec(parse_spec(spec_s))))
                else:
                    rules.append((pat, parse_spec(spec_s)))
            else:
                rules.append(("*", parse_spec(part)))
        if not rules:
            raise ValueError(f"empty quant policy {s!r}")
        return cls(rules=tuple(rules))

    def to_string(self) -> str:
        if len(self.rules) == 1 and self.rules[0][0] == "*":
            return format_spec(self.rules[0][1])
        return ",".join(f"{pat}={format_spec(spec)}" for pat, spec in self.rules)

    @property
    def kv_spec(self) -> Optional[QuantSpec]:
        """The decode KV-cache format from a ``kv=<spec>`` rule (or None)."""
        for pat, spec in self.rules:
            if pat == KV_RULE:
                return spec
        return None

    def match_rule(self, name: str) -> Optional[Tuple[str, Optional[QuantSpec]]]:
        for pat, spec in self.rules:
            if pat != KV_RULE and _match_one(pat, name):
                return (pat, spec)
        return None

    def match(self, name: str) -> Optional[QuantSpec]:
        rule = self.match_rule(name)
        return rule[1] if rule else None


PRESETS: Dict[str, str] = {
    "uniform-pofx8": "*=pofx8es2",
    "uniform-fxp8": "*=fxp8f7",
    "uniform-posit8": "*=posit8es2",
    "paper-table6": "embed=bf16,unembed=bf16,*=pofx8es2",
    "paper-table6-kv8": "embed=bf16,unembed=bf16,kv=fxp8,*=pofx8es2",
}


# ---------------------------------------------------------------------------
# Policy-aware storage report
# ---------------------------------------------------------------------------


def layer_prefixes(blocks, prefix: str = "blocks/"):
    """The reference's tree path of each layer of a per-layer ``blocks``
    list. The dense, ssm and hybrid families stack every layer under
    "blocks/" (a mamba layer's leaves are "blocks/ln", "blocks/mix/...";
    hybrid's shared block is "shared/...", outside the list); the moe
    family stacks its MoE layers (those holding "moe") under "blocks/moe/"
    and the dense layers between them under "blocks/dense/"."""
    if not any("moe" in b for b in blocks):
        return [prefix] * len(blocks)
    return [prefix + ("moe/" if "moe" in b else "dense/") for b in blocks]


def named_leaves(params, prefix: str = ""):
    """(path, leaf) pairs of a parameter tree, dict keys in sorted order and
    a QuantizedTensor as one leaf. A list (the per-layer ``blocks``) yields
    every layer's leaves under its stacked path (``layer_prefixes``) without
    a layer index, so rule matching and the report see the reference's
    names."""
    if isinstance(params, dict):
        for key in sorted(params):
            yield from named_leaves(params[key], f"{prefix}{key}/")
    elif isinstance(params, (list, tuple)):
        for item, path in zip(params, layer_prefixes(params, prefix)):
            yield from named_leaves(item, path)
    else:
        yield prefix.rstrip("/"), params


def _leaf_stats(leaf) -> Tuple[int, int, str]:
    """(param count, stored bits, format label) for one leaf."""
    if isinstance(leaf, QuantizedTensor):
        return leaf.codes.numel(), storage_bits(leaf), format_spec(leaf.spec)
    n = leaf.numel()
    return n, n * leaf.element_size() * 8, str(leaf.dtype).replace("torch.", "")


def storage_report(params, policy: Optional[QuantPolicy] = None) -> str:
    """Per-rule parameter-storage breakdown plus the total footprint."""
    groups: Dict[str, List[int]] = {}
    fmt_by_group: Dict[str, set] = {}
    total_bits = 0
    total_n = 0
    for name, leaf in named_leaves(params):
        n, bits, fmt = _leaf_stats(leaf)
        if policy is not None:
            rule = policy.match_rule(name)
            key = f"{rule[0]}={format_spec(rule[1])}" if rule else "(unmatched)"
        else:
            key = fmt
        acc = groups.setdefault(key, [0, 0])
        acc[0] += n
        acc[1] += bits
        fmt_by_group.setdefault(key, set()).add(fmt)
        total_bits += bits
        total_n += n
    lines = []
    for key, (n, bits) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        stored = ",".join(sorted(fmt_by_group[key]))
        lines.append(f"  {key:<28} {n/1e6:9.2f}M params  "
                     f"{bits/8/2**20:9.2f}MiB  {bits/max(n,1):5.2f} b/w  "
                     f"[{stored}]")
    bpw = total_bits / max(total_n, 1)
    lines.append(f"  {'TOTAL':<28} {total_n/1e6:9.2f}M params  "
                 f"{total_bits/8/2**20:9.2f}MiB  {bpw:5.2f} b/w  "
                 f"(vs fp32 {32/bpw:.1f}x, vs bf16 {16/bpw:.1f}x smaller)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Tensor-parallel sharding validity (DESIGN.md §9)
# ---------------------------------------------------------------------------


def validate_scale_sharding(name: str, codes_shape, scale_shape, codes_spec):
    """How the scale of a QuantizedTensor whose codes shard as
    ``codes_spec`` (one mesh-axis name or None per codes dim, trailing Nones
    optional) shards: a tuple with, for each scale dim, the axis it splits
    along with its codes, or None where it replicates.

    A quantized leaf may shard along an axis only if its scale is congruent
    there: broadcast (size 1) or exactly per-channel along the sharded axis
    (the codes dim's size). A scale that varies along the sharded axis at
    another granularity cannot split with its codes and raises. Scales align
    against codes like NumPy broadcasting (trailing dims), so a lower-rank
    scale replicates over the missing leading dims.
    """
    spec = tuple(codes_spec) + (None,) * (len(codes_shape) - len(codes_spec))
    if len(scale_shape) > len(codes_shape):
        raise ValueError(
            f"cannot shard quantized leaf {name!r}: scale rank "
            f"{len(scale_shape)} exceeds codes rank {len(codes_shape)}")
    off = len(codes_shape) - len(scale_shape)
    out = []
    for j, sdim in enumerate(scale_shape):
        i = j + off
        axis = spec[i]
        if axis is None or sdim == 1:
            out.append(None)
        elif sdim == codes_shape[i]:
            out.append(axis)            # per-channel scale shards with codes
        else:
            raise ValueError(
                f"cannot shard quantized leaf {name!r} along dim {i}: the "
                f"per-channel scale has size {sdim} there but the codes "
                f"have {codes_shape[i]} — the scale axis must match the "
                f"sharded axis exactly (or broadcast with size 1)")
    return tuple(out)


# ---------------------------------------------------------------------------
# Analysis-driven policy search (Fig. 8 / Tables 3-4 machinery -> a policy)
# ---------------------------------------------------------------------------


def policy_from_pareto(
    group_weights: Mapping[str, Sequence],
    candidates: Optional[Sequence[QuantSpec]] = None,
    *,
    max_avg_rel: float = 0.05,
    fallback: str = "bf16",
) -> QuantPolicy:
    """Pick one format per layer group from its (error, storage) Pareto front.

    group_weights: ordered {path-glob: [weight tensors or arrays]} — e.g.
        {"attn/*": [...], "mlp/*": [...]} sampled from the model.
    candidates: QuantSpecs to sweep (default: core.analysis grid, via_fxp
        paths only — the deployable ones per Table 5).
    For each group, candidates are reduced to their Pareto front over
    (avg relative weight error, stored bits/weight); the chosen spec is the
    cheapest front member with error <= max_avg_rel, else the most accurate
    front member. A trailing "*"=fallback rule completes the policy.
    """
    from .analysis import default_spec_grid, weight_error
    from .pareto import pareto_mask

    if candidates is None:
        candidates = [s for s in default_spec_grid(include_paths=False)
                      if s.kind != "posit" or s.N >= 6]
    rules: List[Tuple[str, Optional[QuantSpec]]] = []
    for pattern, weights in group_weights.items():
        pts = []
        for spec in candidates:
            errs, bits, count = [], 0, 0
            for w in weights:
                e = weight_error(w, spec, axis=-1)
                errs.append(e["avg_rel"])
                bits += e["bits"]
                count += int(np.prod(np.shape(w)))
            pts.append((float(np.mean(errs)), bits / max(count, 1)))
        pts_arr = np.asarray(pts)
        front_idx = np.nonzero(pareto_mask(pts_arr))[0]
        ok = [i for i in front_idx if pts_arr[i, 0] <= max_avg_rel]
        if ok:
            pick = min(ok, key=lambda i: (pts_arr[i, 1], pts_arr[i, 0]))
        else:
            pick = min(front_idx, key=lambda i: (pts_arr[i, 0], pts_arr[i, 1]))
        rules.append((pattern, candidates[pick]))
    rules.append(("*", parse_spec(fallback)))
    return QuantPolicy(rules=tuple(rules))


# ---------------------------------------------------------------------------
# Shared CLI path
# ---------------------------------------------------------------------------


def add_policy_arg(parser, default: str = "pofx8es2", flag: str = "--quant",
                   extra_help: str = "") -> None:
    """Register the shared quantization-policy CLI argument."""
    help_text = GRAMMAR_HELP % ", ".join(sorted(PRESETS))
    if extra_help:
        help_text = f"{extra_help}; {help_text}"
    parser.add_argument(flag, default=default, help=help_text)


def add_kv_quant_arg(parser, default: str = "auto",
                     flag: str = "--kv-quant") -> None:
    """Register the shared decode-KV-cache format argument."""
    parser.add_argument(
        flag, default=default,
        help="decode KV-cache format: auto (use the policy's kv= rule), "
             "none/bf16 (unquantized), or one byte-wide fxp/pofx spec "
             "(e.g. fxp8, pofx8es2)")


def resolve_kv_spec(kv_arg: str, policy: QuantPolicy) -> Optional[QuantSpec]:
    """Combine a --kv-quant value with a policy's kv= rule (flag wins)."""
    tok = (kv_arg or "auto").strip().lower()
    if tok == "auto":
        return policy.kv_spec
    if tok in ("none", "off"):
        return None
    return parse_kv_spec(tok)
