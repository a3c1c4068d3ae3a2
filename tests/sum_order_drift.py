"""How far the reference's own training step parts from itself when only the
order of its f32 sums changes, against the gates that hold a grid's run to
tp = 1's.

A grid sums a step's gradients in another order than one device does, so
its parameters part from tp = 1's by rounding; ``chip_smoke.py``'s
``grid_compare`` / ``grid_gate`` and ``torch_bridge.assert_steps_match``
bound that parting. This script measures the same parting inside the
reference alone: its three-step trajectory (``grid_bridge.reference``: its
``grads_plain`` and ``apply_updates``, jitted) with one microbatch against
the same with 2 microbatches of the same batch, whose mean gradient is the
same in exact arithmetic and differs only by the order of the f32 sums.
For each arch (the families whose microbatches route alike: no MoE, whose
capacity follows the microbatch) and moment format it prints, after the
third step:

* the losses' and grad norms' largest relative difference over the steps;
* the parameters' largest difference (in lr, and of its leaf's largest
  entry), the largest share of a leaf's entries more than 0.03 lr apart,
  and the largest difference of an entry whose m and v codes are equal
  after every step (posit8 moments) and how many such entries lie past
  ``grid_gate``'s bound (1e-4 of the leaf's largest entry and 0.03 lr),
  with the same of the leaves the initializer sets to a constant (biases,
  norms, D);
* posit8 moments: the codes that differ, those more than one code step
  apart, and of these those whose two codes both lie within two codes of
  zero.

Then one JSON line. Not a tier-1 test (a few minutes of CPU):

    PYTHONPATH=src:tests python tests/sum_order_drift.py [--archs yi-9b,...]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

ARCHS = ("yi-9b", "falcon-mamba-7b", "zamba2-1.2b", "whisper-medium")


def compare(arch: str, quant: str) -> dict:
    from grid_bridge import reference
    from torch_bridge import walk
    frames = arch == "whisper-medium"
    one = reference(arch, "none", quant, 0, (), frames)
    two = reference(arch, "none", quant, 2, (), frames)
    rel = lambda a, b: abs(a - b) / abs(b)      # noqa: E731
    out = {"arch": arch, "quant": quant,
           "loss_rel": max(rel(a["loss"], b["loss"]) for a, b in zip(two["jmet"], one["jmet"])),
           "grad_norm_rel": max(rel(a["grad_norm"], b["grad_norm"])
                                for a, b in zip(two["jmet"], one["jmet"]))}
    lr = one["jmet"][-1]["lr"]
    init = {p: a for p, a, _ in walk(one["init"]["params"], one["init"]["params"])}
    codes, parted = {}, {}
    if quant == "posit8":
        # the codes after the last step, and where they parted after any step
        last = len(one["opt_steps"]) - 1
        for s, (o1, o2) in enumerate(zip(one["opt_steps"], two["opt_steps"])):
            for k in ("m", "v"):
                for path, a, b in walk(o1[k], o2[k]):
                    leaf = path.rsplit("/", 1)[0]
                    if path.endswith("/codes"):
                        a, b = a.view(np.int8).astype(int), b.view(np.int8).astype(int)
                        parted[leaf] = parted.get(leaf, False) | (a != b)
                        if s == last:
                            codes[(k, leaf)] = (a, b)
                    elif path.endswith("/scale") and not np.array_equal(a, b):
                        out.setdefault("scales_differ", []).append(f"step {s} {k}{path}")
    out.update(param_max_lr=0.0, param_max_rel=0.0, off_share=0.0, alike_max_lr=0.0,
               const_init_max_lr=0.0, const_init_alike_max_lr=0.0, codes=0, codes_differ=0,
               codes_over_one_step=0, over_one_step_across_zero=0, alike_past_gate=0)
    for path, a, b in walk(one["want"]["params"], two["want"]["params"]):
        d = np.abs(a - b)
        out["param_max_lr"] = max(out["param_max_lr"], d.max() / lr)
        out["param_max_rel"] = max(out["param_max_rel"], d.max() / max(np.abs(a).max(), 1e-30))
        out["off_share"] = max(out["off_share"], float((d > 0.03 * lr).mean()))
        w0 = init[path]
        const = bool((w0 == w0.reshape(-1)[0]).all())
        if const:
            out["const_init_max_lr"] = max(out["const_init_max_lr"], d.max() / lr)
        if quant != "posit8":
            continue
        alike = ~parted[path]
        for k in ("m", "v"):
            ca, cb = codes[(k, path)]
            diff = ca != cb
            far = np.abs(ca - cb) > 1
            out["codes"] += diff.size
            out["codes_differ"] += int(diff.sum())
            out["codes_over_one_step"] += int(far.sum())
            out["over_one_step_across_zero"] += int(
                (far & (np.abs(ca) <= 2) & (np.abs(cb) <= 2)).sum())
        top = max(np.abs(a).max(), 1e-30)
        out["alike_past_gate"] += int((alike & (d > 1e-4 * top) & (d > 0.03 * lr)).sum())
        if alike.any():
            out["alike_max_lr"] = max(out["alike_max_lr"], d[alike].max() / lr)
            if const:
                out["const_init_alike_max_lr"] = max(out["const_init_alike_max_lr"],
                                                     d[alike].max() / lr)
    return {k: float(v) if isinstance(v, (np.floating, float)) else v for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    rows = []
    for arch in args.archs.split(","):
        for quant in ("none", "posit8"):
            row = compare(arch, quant)
            rows.append(row)
            print(f"{arch} {quant}: loss {row['loss_rel']:.3g}, grad norm "
                  f"{row['grad_norm_rel']:.3g} relative; params up to "
                  f"{row['param_max_lr']:.4g} lr ({row['param_max_rel']:.3g} of the leaf's "
                  f"largest), at most {100 * row['off_share']:.4f} % of a leaf past 0.03 lr; "
                  f"constant-initialized leaves up to {row['const_init_max_lr']:.4g} lr; "
                  f"coded alike up to {row['alike_max_lr']:.4g} lr (constant-initialized "
                  f"{row['const_init_alike_max_lr']:.4g}), {row['alike_past_gate']} of them past "
                  f"1e-4 of the leaf's largest and 0.03 lr; codes {row['codes_differ']} of "
                  f"{row['codes']} differ, {row['codes_over_one_step']} by more than one "
                  f"step ({row['over_one_step_across_zero']} within two codes of zero)",
                  flush=True)
    out = {"rows": rows, "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
