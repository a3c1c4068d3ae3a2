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

``--loss-order`` measures the loss's own sum order instead: a grid whose
model axis cuts the vocab takes the reference's cross-entropy as each
vocab block's partials combined (``nn.sharding.vocab_parallel_ce``), so for
the grid tests' cases of ``loss_cases`` it holds the reference's three
steps with ``ce_loss`` on the whole logits against the same in the
partitioned order (``grid_bridge.partitioned_ce``) and runs each test's
own gate on the reference alone.

``--ef-flips`` runs the port's moonshot (pod 2, model 2) grid under
posit8_ef (the four step cases of ``tests/test_torch_train_grid_moe.py``,
four CPU ranks) and lists each pod's residual entries past the test's
2e-3 of the leaf's largest, against the reference on whole logits and
against the reference summed as the grid's two vocab blocks, with both
sides' values.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

ARCHS = ("yi-9b", "falcon-mamba-7b", "zamba2-1.2b", "whisper-medium")


def compare(arch: str, quant: str) -> dict:
    from grid_bridge import reference
    frames = arch == "whisper-medium"
    one = reference(arch, "none", quant, 0, (), frames)
    two = reference(arch, "none", quant, 2, (), frames)
    return {"arch": arch, "quant": quant, **drift(one, two, quant)}


def drift(one: dict, two: dict, quant: str) -> dict:
    """The metrics above of trajectory ``two`` against ``one`` (each
    ``grid_bridge.reference``'s)."""
    from torch_bridge import walk
    rel = lambda a, b: abs(a - b) / abs(b)      # noqa: E731
    out = {"loss_rel": max(rel(a["loss"], b["loss"]) for a, b in zip(two["jmet"], one["jmet"])),
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


def loss_cases():
    """The grid tests' cases whose gates the vocab-parallel loss once moved
    past (with a backward of exp(logit - lse), not the reference's form),
    each on a grid whose model axis cuts the vocab into ``blocks``: (label,
    arch, over, comp, quant, micro, blocks, the test's bounds)."""
    import test_torch_train_grid_hybrid as hyb
    import test_torch_train_grid_moe as moe
    return (
        ("moonshot (pod 2, model 2) posit8_ef posit8 mb0", moe.ARCH, (), "posit8_ef",
         "posit8", 0, 2, {"ef_flips": moe.EF_FLIPS}),
        ("llama4 (model 2) f32 mb0", moe.LLAMA4, (), "none", "none", 0, 2,
         {"noise": moe.LLAMA4_NOISE, "zero_leaves": moe.LLAMA4_ZERO}),
        ("zamba2 (model 4) f32", hyb.ARCH, (), "none", "none", 0, 4, {"noise": hyb.NOISE}),
        ("zamba2 (model 4) posit8", hyb.ARCH, (), "none", "posit8", 0, 4,
         {"flips": hyb.FLIPS}),
        ("zamba2 d_inner 192 (model 4) f32", hyb.ARCH, hyb.MIXED, "none", "none", 0, 4,
         {"noise": hyb.MIXED_NOISE}),
    )


def gate(one: dict, two: dict, comp: str, quant: str, bounds: dict) -> str:
    """Whether trajectory ``two`` holds to ``one`` by the grid tests' gates
    (``assert_steps_match``; with pods ``check_pod_case``'s: the posit8
    moments' bounds and the residuals'): "holds", or the first failure."""
    from torch_bridge import assert_steps_match, walk
    bounds = dict(bounds)
    ef_flips = bounds.pop("ef_flips", {})

    def exact_scales(tree, key=""):
        # the port's posit8 moment scales are exact powers of two, the
        # reference's a few ulps off (ROADMAP Queue C): the gate holds a
        # scale to the power of two nearest the reference's
        if isinstance(tree, dict):
            return {k: exact_scales(v, k) for k, v in tree.items()}
        return np.exp2(np.round(np.log2(tree))) if key == "scale" else tree

    got = exact_scales(two["want"])
    try:
        if comp == "none":
            assert_steps_match(quant, one["jmet"], two["jmet"], one["m1"], one["before"],
                               one["want"], got, first=one["init"]["params"], **bounds)
        else:
            assert_steps_match("posit8", one["jmet"], two["jmet"], None, one["before"],
                               one["want"], got, **bounds)
        for p in range(2 if comp == "posit8_ef" else 0):
            for path, a, b in walk(one["ef"][p], two["ef"][p]):
                d, top = np.abs(a - b), np.abs(a).max()
                off = int((d > 2e-3 * top).sum())
                assert off <= 1e-3 * d.size + ef_flips.get(path, 0), ("ef", p, path, off)
    except AssertionError as e:
        return f"fails: {e}"
    return "holds"


def loss_order() -> list:
    """For each of ``loss_cases``: the reference's three steps with its
    ``ce_loss`` on the whole logits against the same with the loss summed
    as the vocab blocks of the grid (``grid_bridge.partitioned_ce``, what
    GSPMD makes of ``ce_loss`` on vocab-sharded logits), the metrics above
    and the test's gate on the reference alone."""
    from grid_bridge import reference
    rows = []
    for label, arch, over, comp, quant, micro, blocks, bounds in loss_cases():
        whole = reference(arch, comp, quant, micro, over)
        parts = reference(arch, comp, quant, micro, over, blocks=blocks)
        row = {"case": label, "blocks": blocks, **drift(whole, parts, quant),
               "gate": gate(whole, parts, comp, quant, bounds),
               "ef_parted": ef_parted(whole, parts) if comp == "posit8_ef" else []}
        rows.append(row)
        print(f"{label}, {blocks} vocab blocks: loss {row['loss_rel']:.3g}, grad norm "
              f"{row['grad_norm_rel']:.3g} relative; params up to {row['param_max_lr']:.4g} lr "
              f"({row['param_max_rel']:.3g} of the leaf's largest); codes "
              f"{row['codes_differ']} of {row['codes']} differ; the test's gate on the "
              f"reference alone: {row['gate']}", flush=True)
        for p, path, size, n in row["ef_parted"]:
            print(f"  pod {p} residual {path}: {n} of {size} entries past 2e-3 of its largest "
                  f"(the gate admits {1e-3 * size:.3g})", flush=True)
    return rows


def ef_parted(one: dict, two: dict) -> list:
    """Each pod's residual leaves (posit8_ef) holding entries more than
    2e-3 of the leaf's largest residual apart between the two trajectories
    (a gradient a transport code step apart): (pod, leaf, entries, how
    many)."""
    from torch_bridge import walk
    out = []
    for p in range(2):
        for path, a, b in walk(one["ef"][p], two["ef"][p]):
            n = int((np.abs(a - b) > 2e-3 * np.abs(a).max()).sum())
            if n:
                out.append((p, path, int(a.size), n))
    return out


def ef_flips() -> list:
    """The port's moonshot (pod 2, model 2) posit8_ef grid against both
    references (``blocks`` 1 and 2): (case, blocks, pod, leaf, the
    gate's allowance, the entries past 2e-3 of the leaf's largest residual
    with the reference's and the grid's values)."""
    from grid_bridge import layout_model, pod_ranks, reference, run_grid
    from repro_torch.convert import gather_train_state
    from repro_torch.launch.mesh import RankPool
    from torch_bridge import STEP_CASES, step_kw, walk
    arch, grid = "moonshot-v1-16b-a3b", (2, 1, 2)
    rows = []
    with RankPool(4, "cpu", threads=1, grids=[grid], timeout_s=300) as pool:
        for quant, micro in STEP_CASES:
            refs = {b: reference(arch, "posit8_ef", quant, micro, (), blocks=b) for b in (1, 2)}
            kw = step_kw(quant, micro, grad_compression="posit8_ef")
            _, _, res = run_grid(pool, arch, grid, kw, refs[1])
            model = layout_model(arch, grid, (), **kw)
            for p in range(2):
                ef = gather_train_state([r["state"] for r in pod_ranks(res, p, len(res) // 2)],
                                        model)["ef"]
                for blocks, ref in refs.items():
                    for path, a, b in walk(ref["ef"][p], ef):
                        off = np.flatnonzero(np.abs(a - b).ravel() > 2e-3 * np.abs(a).max())
                        if len(off):
                            row = (f"{quant}-mb{micro}", blocks, p, path, 1e-3 * a.size,
                                   [(int(i), float(a.ravel()[i]), float(b.ravel()[i]))
                                    for i in off[:8]], len(off))
                            rows.append(row)
                            print(f"{row[0]}, {blocks} vocab block(s), pod {p} {path}: {len(off)} "
                                  f"past (the gate admits {row[4]:.3g}); (entry, reference, "
                                  f"grid) {row[5][:3]}", flush=True)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--loss-order", action="store_true",
                    help="measure the loss's sum order instead (``loss_order``)")
    ap.add_argument("--ef-flips", action="store_true",
                    help="list the port's posit8_ef residual flips (``ef_flips``)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.ef_flips:
        out = {"ef_flips": ef_flips(), "seconds": time.perf_counter() - t0}
        print(json.dumps(out))
        return out
    if args.loss_order:
        out = {"loss_order": loss_order(), "seconds": time.perf_counter() - t0}
        print(json.dumps(out))
        return out
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
