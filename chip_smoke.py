#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero without the final line:

1. device and build: the card's name and power limit (nvidia-smi), the
   nvcc build of every kernel in src/repro_torch/csrc for sm_90a;
2. each kernel against its plain PyTorch version on the card at yi-9b
   shapes, with its time, the plain version's, a library yardstick's and
   the least time the card could take (bound);
3. the main path: the serving CLI (``repro_torch.launch.serve.main``) with
   ``--arch yi-9b --quant pofx8 --kv-quant fxp8 --use-kernel`` and its
   defaults, i.e. the ServeEngine serving yi-9b at full width and depth
   (48 layers, 4 slots, 8 requests of 64 prompt tokens, 32 generated
   tokens, greedy), with the kernels' launch counts and the first-token
   logits against the plain path;
4. token identity at yi-9b width, 4 layers, f32 activations: kernels vs
   their plain versions on the card;
5. the mixed policy attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16 with an fxp8 KV
   cache at yi-9b width, 2 layers, f32 activations: fxp_matmul launches;
   its streams against the all-plain path's are reported, and the ways in
   which they may part are checked (``phase_mixed``): with the plain run's
   int8 activation codes the kernels give the plain streams, and on the
   plain run's inputs the kernels' activation codes are within one
   rounding step of the plain run's.

TF32 is off for matmuls and convolutions, so every f32 product (the plain
versions included) is a true f32 product. Details go to
chiprun_out/chip_smoke.json. The last line is {"ok": true, "device": ...}.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and peak rates by type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

SHAPES_POFX = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000)]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, kind: str):
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median device time of single launches, L2 flushed before each (the
    serving path streams far more than the 50 MB L2 between two calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 15) -> float:
        torch = self.torch
        for _ in range(2):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def phase_kernels(torch, timer, rows):
    """Each CUDA kernel against its plain version at yi-9b shapes."""
    from repro_torch.core.pofx import pofx_norm_lut
    from repro_torch.core.policy import parse_spec
    from repro_torch.core.quantizers import kv_dequantize, kv_quantize
    from repro_torch.kernels.fxp_matmul import fxp_matmul, fxp_matmul_ref
    from repro_torch.kernels.kv_flash_decode import kv_flash_decode, kv_flash_decode_ref
    from repro_torch.kernels.pofx_matmul import pofx_matmul, pofx_matmul_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    # exhaustive decode: identity rows select every code's value exactly
    for N in (6, 7, 8):
        for ES in (1, 2, 3):
            L = 1 << (N - 1)
            codes = torch.arange(L, device=dev, dtype=torch.uint8)[None].expand(L, L).contiguous()
            got = pofx_matmul(torch.eye(L, device=dev), codes, torch.ones(L, device=dev), N, ES, 8)
            want = torch.as_tensor(pofx_norm_lut(N, ES, 8), device=dev).float() / 128
            if not torch.equal(got, want[None].expand(L, L)):
                raise AssertionError(f"pofx_matmul decode differs at N={N} ES={ES}")
    log("  pofx_matmul decode: all codes of pofx(N=6..8, ES=1..3) exact")

    for m in (4, 64):
        for k, n in SHAPES_POFX:
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            codes = torch.randint(0, 128, (k, n), generator=g, device=dev).to(torch.uint8)
            scale = torch.exp2(torch.randint(-4, 0, (n,), generator=g, device=dev).float())
            got = pofx_matmul(x, codes, scale, 8, 2, 8)
            want = pofx_matmul_ref(x, codes, scale, 8, 2, 8)
            err = (got - want).abs().max().item()
            # f32 sums of k products in another order than the plain
            # version's; allow 1e-4 of the largest output
            tol = 1e-4 * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"pofx_matmul m={m} k={k} n={n}: err {err} > {tol}")
            w = (torch.as_tensor(pofx_norm_lut(8, 2, 8), device=dev)[codes.long()].float()
                 / 128 * scale).to(torch.bfloat16)
            b, kind = bound_ms(m * k * 2 + k * n + n * 4 + m * n * 4, 2 * m * k * n, "bf16")
            row = {"name": "pofx_matmul", "shape": f"m={m} k={k} n={n} x=bf16",
                   "max_abs_err": err, "tol": tol,
                   "ms": timer.ms(lambda: pofx_matmul(x, codes, scale, 8, 2, 8)),
                   "plain_ms": timer.ms(lambda: pofx_matmul_ref(x, codes, scale, 8, 2, 8)),
                   "library_ms": timer.ms(lambda: torch.matmul(x, w)),
                   "library": "torch.matmul bf16 on decoded weights",
                   "bound_ms": b, "bound_by": kind}
            rows.append(row)
            log(f"  {row}")
            del x, codes, scale, w, got, want

    for m in (4, 64):
        for k, n in ((4096, 11008), (11008, 4096)):
            a = torch.randint(-127, 128, (m, k), generator=g, device=dev).to(torch.int8)
            bm = torch.randint(-128, 128, (k, n), generator=g, device=dev).to(torch.int8)
            got = fxp_matmul(a, bm)
            want = fxp_matmul_ref(a, bm)
            if not torch.equal(got, want):
                raise AssertionError(f"fxp_matmul m={m} k={k} n={n} not exact")
            b, kind = bound_ms(m * k + k * n + m * n * 4, 2 * m * k * n, "int8")
            lib = None
            if m > 16:   # torch._int_mm needs m > 16
                lib = timer.ms(lambda: torch._int_mm(a, bm))
            row = {"name": "fxp_matmul", "shape": f"m={m} k={k} n={n}",
                   "max_abs_err": 0.0, "tol": 0.0,
                   "ms": timer.ms(lambda: fxp_matmul(a, bm)),
                   "plain_ms": timer.ms(lambda: fxp_matmul_ref(a, bm)),
                   "library_ms": lib, "library": "torch._int_mm" if lib else None,
                   "bound_ms": b, "bound_by": kind}
            rows.append(row)
            log(f"  {row}")

    B, G, R, Dh = 4, 4, 8, 128
    for spec_s in ("fxp8", "pofx8es2"):
        spec = parse_spec(spec_s)
        for S, pos_list in ((96, [65, 80, 90, 96]), (1000, [1, 333, 999, 1000])):
            q = torch.randn(B, G, R, Dh, generator=g, device=dev)
            ks = torch.exp2(torch.randint(0, 2, (B, G, 1, Dh), generator=g, device=dev).float())
            vs = torch.exp2(torch.randint(0, 2, (B, G, 1, Dh), generator=g, device=dev).float())
            kc = kv_quantize(torch.randn(B, G, S, Dh, generator=g, device=dev), spec, ks)
            vc = kv_quantize(torch.randn(B, G, S, Dh, generator=g, device=dev), spec, vs)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            args = (q, kc, ks, vc, vs, pos, spec)
            got = kv_flash_decode(*args)
            want = kv_flash_decode_ref(*args)
            err = (got - want).abs().max().item()
            # f32 online softmax vs a one-pass softmax: a few ulps of |v|
            tol = 1e-5 + 1e-4 * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"kv_flash_decode {spec_s} S={S}: err {err} > {tol}")
            kf = kv_dequantize(kc, spec, ks)
            vf = kv_dequantize(vc, spec, vs)
            mask = (torch.arange(S, device=dev)[None, :] < pos[:, None].long())[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            valid = sum(min(p, S) for p in pos_list)
            nbytes = 2 * G * valid * Dh + 2 * B * G * R * Dh * 4 + 2 * B * G * Dh * 4 + B * 4
            b, kind = bound_ms(nbytes, 4 * G * R * valid * Dh, "f32")
            row = {"name": "kv_flash_decode", "shape": f"{spec_s} B={B} G={G} R={R} S={S} Dh={Dh} pos={pos_list}",
                   "max_abs_err": err, "tol": tol,
                   "ms": timer.ms(lambda: kv_flash_decode(*args)),
                   "plain_ms": timer.ms(lambda: kv_flash_decode_ref(*args)),
                   "library_ms": timer.ms(lambda: sdpa(q, kf, vf, attn_mask=mask)),
                   "library": "scaled_dot_product_attention on dequantized K/V",
                   "bound_ms": b, "bound_by": kind}
            rows.append(row)
            log(f"  {row}")


def serve(torch, model, params, *, n_req=8, prompt_len=64, gen=32, slots=4, chunk=8,
          watch=None):
    """The engine over ``model`` serving the CLI's default workload (the
    requests ``serve.main`` makes); ``watch(engine)`` sees the engine
    before it runs."""
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import make_requests
    eng = ServeEngine(model, params, n_slots=slots, max_len=prompt_len + gen, chunk=chunk)
    if watch is not None:
        watch(eng)
    reqs = make_requests(model.cfg.vocab_size, n_req, prompt_len, gen)
    done = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, done, reqs


def first_logits(torch, model, params, prompt):
    cache = model.init_cache(1, len(prompt) + 1)
    _, logits = model.prefill(params, torch.as_tensor(prompt[None], device="cuda"), cache=cache)
    return logits.float()


MAIN_ARGV = ["--arch", "yi-9b", "--quant", "pofx8", "--kv-quant", "fxp8", "--use-kernel"]


def phase_main_path(torch, result):
    """``python -m repro_torch.launch.serve`` with MAIN_ARGV and the CLI's
    defaults (4 slots, 8 requests, 64-token prompts, 32 new tokens), in
    this process so that the launch counts can be read."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch import serve as serve_cli
    torch.cuda.reset_peak_memory_stats()
    log(f"  repro_torch.launch.serve {' '.join(MAIN_ARGV)}")
    reset_launches()
    run = serve_cli.main(MAIN_ARGV)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    model, params, eng, done = run.model, run.params, run.engine, run.done
    cfg = model.cfg
    st = eng.stats()
    n_prompt = sum(len(s.context) for s in done)
    prefill_tps = n_prompt / eng.prefill_time
    decode_tps = st["decode_tokens"] / eng.decode_time
    log(f"  served {len(done)} requests: prefill {n_prompt} tokens in {eng.prefill_time:.3f}s "
        f"({prefill_tps:.1f} tok/s), decode {st['decode_tokens']} tokens in "
        f"{eng.decode_time:.3f}s over {st['decode_steps']} steps ({decode_tps:.1f} tok/s), "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (init included)")
    log(f"  launches on the main path: {counts}")
    per_fwd = 7 * cfg.n_layers + 1
    want_pofx = per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"])
    want_kv = cfg.n_layers * st["decode_steps"]
    if counts["pofx_matmul"] <= 0 or counts["kv_flash_decode"] <= 0:
        raise AssertionError(f"main path did not launch its kernels: {counts}")
    if counts["pofx_matmul"] != want_pofx or counts["kv_flash_decode"] != want_kv:
        raise AssertionError(f"launch counts {counts} != expected pofx {want_pofx}, kv {want_kv}")
    if cfg.n_layers != 48 or cfg.d_model != 4096 or len(done) != 8:
        raise AssertionError(f"main path ran {cfg.n_layers} layers, d={cfg.d_model}, "
                             f"{len(done)} requests")
    for s in done:
        if len(s.out) != 32 or not all(0 <= t < cfg.vocab_size for t in s.out):
            raise AssertionError(f"rid {s.req.rid}: bad output {s.out}")
    prompt = run.requests[0].prompt
    lk = first_logits(torch, model, params, prompt)
    lp = first_logits(torch, dataclasses.replace(model, kernel_set=PLAIN), params, prompt)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite first-token logits")
    diff = (lk - lp).abs().max().item()
    log(f"  first-token logits, kernels vs plain path: max |diff| {diff:.4g} "
        f"(|logits| <= {lp.abs().max().item():.4g}, bf16 activations), "
        f"argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    result["decode_profile"] = profile_decode(torch, model, params)
    result["main_path"] = {
        "argv": MAIN_ARGV, "arch": "yi-9b", "n_layers": cfg.n_layers,
        "requests": len(done), "prompt_len": 64, "gen": 32, "slots": eng.n_slots,
        "prefill_tok_s": prefill_tps, "decode_tok_s": decode_tps,
        "prefill_s": eng.prefill_time, "decode_s": eng.decode_time,
        "decode_steps": st["decode_steps"], "launches": counts,
        "first_logit_max_abs_diff": diff,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del run, model, params, eng
    torch.cuda.empty_cache()
    return counts


def compare(done_k, done_p, what):
    """Number of identical streams; logs the first divergence of the rest."""
    same = 0
    for a, b in zip(done_k, done_p):
        if a.out == b.out:
            same += 1
            continue
        step = next(i for i, (x, y) in enumerate(zip(a.out, b.out)) if x != y)
        log(f"  rid {a.req.rid}: kernels and {what} part at token {step}:\n"
            f"    kernels {a.out}\n    {what} {b.out}")
    return same


def profile_decode(torch, model, params, steps: int = 4):
    """Device time by kernel over ``steps`` decode steps at 4 slots and a
    64-token context (torch.profiler, CUDA activity), against the host
    wall time of the same steps: where a decode step's time goes."""
    try:
        from torch.profiler import ProfilerActivity, profile
        cache = model.init_cache(4, 96)
        cache["pos"] = torch.full((4,), 64, dtype=torch.int32, device="cuda")
        tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
        cache, _ = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                cache, _ = model.decode_step(params, cache, tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name = {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", 0) or 0
            if dev_us > 0:
                by_name[evt.key] = dev_us / 1e3 / steps
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        log(f"  decode step profile: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
            f"({100 * (1 - busy / wall_ms):.1f}% idle)")
        for name, ms in top:
            log(f"    {ms:8.3f} ms/step  {name[:90]}")
        return {"wall_ms": wall_ms, "device_busy_ms": busy,
                "top": [[n, ms] for n, ms in top]}
    except Exception:  # the profile is an aside: record why it is missing
        log(f"  decode step profile: not measured\n{traceback.format_exc()}")
        return None


def small_model(n_layers, policy_s, kv_s):
    """yi-9b width at ``n_layers`` layers, f32 activations, kernels on."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import QuantPolicy, parse_spec
    from repro_torch.nn.models import build_model
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=n_layers)
    rcfg = RunConfig(remat="none", activation_dtype="f32")
    model = build_model(cfg, rcfg, use_kernel=True, kv_spec=parse_spec(kv_s))
    return model, model.init(1, policy=QuantPolicy.from_string(policy_s))


def identity(torch, result):
    """Phase 4: greedy streams with the kernels equal those with every
    kernel's plain version, at 4 layers."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    model, params = small_model(4, "pofx8", "fxp8")
    reset_launches()
    _, done_k, _ = serve(torch, model, params)
    counts = dict(LAUNCHES)
    _, done_p, _ = serve(torch, dataclasses.replace(model, kernel_set=PLAIN), params)
    same, n = compare(done_k, done_p, "plain"), len(done_k)
    log(f"  identity_4l: {n} streams x {len(done_k[0].out)} tokens, {same}/{n} identical "
        f"to the plain path; launches {counts}")
    result["identity_4l"] = {"n_layers": 4, "policy": "pofx8", "kv": "fxp8",
                             "identical_streams": same, "streams": n, "launches": counts}
    if same != n:
        raise AssertionError("identity_4l: kernel streams differ from the plain path")


MIXED = "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16"


def recorded_serve(torch, model, params, kset, *, replay=None, force=None):
    """Serve with kernel set ``kset``, recording every forward call (each
    prefill and decode step): its logits, the int8 activation codes of its
    fxp matmuls, and the (request, token index) of each logits row (token
    None: a slot that finished inside the chunk). ``replay`` (an earlier
    record) gives fxp_matmul that run's activation codes in place of this
    run's; ``force`` (an earlier record) hands the engine that run's logits,
    so the tokens, and with them every forward's inputs, are that run's
    (teacher forcing) while this run's own logits are recorded."""
    rec = {"codes": [], "calls": []}
    box, emitted = {}, {}

    def fxp(a, b):
        if replay is not None:
            a = replay["codes"][len(rec["codes"])]
        rec["codes"].append(a.clone())
        return kset.fxp_matmul(a, b)

    def rows(kind):
        eng = box["eng"]
        if kind == "prefill":   # the request being admitted: off the queue, in no slot yet
            rid = next(r for r, st in eng._states.items()
                       if st.slot < 0 and not st.done and r not in eng._pending)
            emitted[rid] = len(eng._states[rid].out) + 1
            return [(rid, emitted[rid] - 1)]
        out = []
        for rid in eng._slot_rid.tolist():
            t = emitted.get(rid)
            if t is not None:
                emitted[rid] = t + 1
                if t >= eng._states[rid].req.max_new:
                    t = None
            out.append((rid, t))
        return out

    def wrap(fn, kind):
        def call(*args, **kw):
            start = len(rec["codes"])
            cache, logits = fn(*args, **kw)
            i = len(rec["calls"])
            rec["calls"].append({"logits": logits.float().clone(),
                                 "codes": (start, len(rec["codes"])), "rows": rows(kind)})
            if force is not None:
                logits = force["calls"][i]["logits"].to(logits.dtype)
            return cache, logits
        return call

    m = dataclasses.replace(model, kernel_set=dataclasses.replace(kset, fxp_matmul=fxp))
    m.prefill = wrap(m.prefill, "prefill")
    m.decode_step = wrap(m.decode_step, "decode")
    _, rec["done"], _ = serve(torch, m, params, watch=lambda e: box.__setitem__("eng", e))
    return rec


def phase_mixed(torch, result):
    """Phase 5: the mixed policy MIXED with an fxp8 KV cache at yi-9b width,
    2 layers, f32 activations. The fxp rules quantize activations per
    tensor to int8 before fxp_matmul, so an f32 summation-order difference
    of the float kernels that moves an activation across a rounding
    boundary becomes a whole int8 step, and a stream may then part from
    the all-plain path's at a near-tie of the logits. Four runs:

    free    kernels on, as served; fxp_matmul must launch. Its streams
            against the all-plain path's are reported.
    plain   every kernel's plain version (the reference).
    forced  kernels on, teacher-forced to the plain run's tokens, so every
            forward has the plain run's token inputs. Every row whose
            greedy token would part from the plain run's must have seen an
            int8 activation code of its request differ from the plain
            run's. Reports how many codes differ and by how much (in all,
            and in each prefill's first fxp matmul, the first place where
            float differences meet an activation rounding), and at each
            such row the plain top-2 margin against the logit change.
    replay  kernels on, fxp_matmul given the plain run's activation codes:
            its streams must equal the plain run's. Its largest logit change
            against the plain run is what the float kernels do on their own.
    """
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import KERNELS, PLAIN
    model, params = small_model(2, MIXED, "fxp8")
    reset_launches()
    _, done_k, _ = serve(torch, model, params)
    counts = dict(LAUNCHES)
    if counts["fxp_matmul"] <= 0:
        raise AssertionError(f"mixed policy did not launch fxp_matmul: {counts}")
    plain = recorded_serve(torch, model, params, PLAIN)
    same = compare(done_k, plain["done"], "all-plain")
    forced = recorded_serve(torch, model, params, KERNELS, force=plain)
    replay = recorded_serve(torch, model, params, KERNELS, replay=plain)
    streams = lambda rec: [s.out for s in rec["done"]]     # noqa: E731
    if streams(forced) != streams(plain):
        raise AssertionError("teacher forcing did not reproduce the plain streams")
    if (len(forced["calls"]) != len(plain["calls"])
            or len(forced["codes"]) != len(plain["codes"])):
        raise AssertionError("forced and plain runs made different calls")

    step = [(f.int() - p.int()).abs() for f, p in zip(forced["codes"], plain["codes"])]
    n_codes = sum(d.numel() for d in step)
    by_step = {k: sum(int(((d > 0) & (d.clamp(max=3) == k)).sum()) for d in step)
               for k in (1, 2, 3)}
    n_flip = sum(by_step.values())
    first = [step[cp["codes"][0]] for cp in plain["calls"] if len(cp["rows"]) == 1]
    first_diff = sum(int((d > 0).sum()) for d in first)
    first_max = max(int(d.max()) for d in first)

    def max_dlogit(rec, r, cp):
        return (rec["calls"][cp]["logits"][r] - plain["calls"][cp]["logits"][r]).abs().max().item()

    seen, events, gaps, loud, base = {}, [], [], 0.0, 0.0
    for c, (cf, cp) in enumerate(zip(forced["calls"], plain["calls"])):
        lo, hi = cp["codes"]
        # an fxp matmul's codes are (rows, k): one row per logits row in
        # decode, all prompt positions of the one request in prefill
        per_row = sum((step[j] > 0).sum(dim=1) for j in range(lo, hi))
        rows_flip = ([int(per_row.sum())] if len(cp["rows"]) == 1 else per_row.tolist())
        for r, (rid, t) in enumerate(cp["rows"]):
            if rid < 0:
                continue
            seen[rid] = seen.get(rid, 0) + rows_flip[r]
            if t is None:
                continue
            lk, lp = cf["logits"][r], cp["logits"][r]
            dl = max_dlogit(forced, r, c)
            loud = max(loud, dl)
            base = max(base, max_dlogit(replay, r, c))
            top2 = lp.topk(2).values
            gaps.append((top2[0] - top2[1]).item())
            pa, ka = int(lp.argmax()), int(lk.argmax())
            if pa != ka:
                events.append({"rid": rid, "token": t, "plain": pa, "kernels": ka,
                               "plain_margin": (lp[pa] - lp[ka]).item(),
                               "kernel_margin": (lk[ka] - lk[pa]).item(),
                               "max_abs_dlogit": dl, "differing_codes_in_request": seen[rid],
                               "differing_codes_in_forward": int(sum(rows_flip))})
    rep_same = compare(replay["done"], plain["done"], "all-plain (replay)")
    gaps.sort()
    n = len(done_k)
    entry = {"n_layers": 2, "policy": MIXED, "kv": "fxp8", "launches": counts,
             "streams": n, "identical_streams_all_plain": same,
             "replay_identical_streams": rep_same,
             "act_codes": n_codes, "act_codes_differing": n_flip,
             "act_codes_differing_by_1_2_3plus_steps": [by_step[1], by_step[2], by_step[3]],
             "prefill_first_fxp_codes": sum(d.numel() for d in first),
             "prefill_first_fxp_codes_differing": first_diff,
             "prefill_first_fxp_max_step": first_max,
             "max_abs_dlogit_forced": loud, "max_abs_dlogit_replay": base,
             "plain_top2_gap_median": gaps[len(gaps) // 2], "plain_top2_gap_min": gaps[0],
             "rows": len(gaps), "would_part": events}
    result["mixed_2l"] = entry
    log(f"  mixed_2l: {n} streams x {len(done_k[0].out)} tokens; free run {same}/{n} "
        f"identical to the all-plain path; launches {counts}")
    log(f"  forced: {n_flip} of {n_codes} int8 activation codes differ from the plain "
        f"run's (by 1, 2, >=3 steps: {by_step[1]}, {by_step[2]}, {by_step[3]}); in the "
        f"prefills' first fxp matmul {first_diff} of {entry['prefill_first_fxp_codes']} "
        f"(largest {first_max} step); max |dlogit| {loud:.3g}; plain top-2 gap median "
        f"{entry['plain_top2_gap_median']:.3g}, min {gaps[0]:.3g} over {len(gaps)} rows")
    for e in events:
        log(f"  forced: rid {e['rid']} token {e['token']} would part ({e['plain']} -> "
            f"{e['kernels']}): plain margin {e['plain_margin']:.3g}, kernel margin "
            f"{e['kernel_margin']:.3g}, max |dlogit| {e['max_abs_dlogit']:.3g}, "
            f"{e['differing_codes_in_request']} differing codes in the request so far")
    log(f"  replay (plain activation codes): {rep_same}/{n} streams identical to the "
        f"all-plain path; max |dlogit| {base:.3g}")
    if any(e["differing_codes_in_request"] == 0 for e in events):
        raise AssertionError("a stream would part with no differing int8 activation "
                             "code in its request")
    if rep_same != n:
        raise AssertionError("kernels with the plain activation codes part from the plain path")
    return counts


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="drive the port on one card")
    ap.add_argument("--phases", default="2,3,4,5",
                    help="comma-separated phases after the build (default: all)")
    want = {int(p) for p in ap.parse_args(argv).phases.split(",")}
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {ROOT / 'src'}: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = nvidia_smi()
    log(card)
    log(f"phase 1: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, TF32 off")
    info = build.build_all()
    log(f"phase 1: built {', '.join(build.KERNELS)} for sm_90a in {info['seconds']:.1f}s")
    for name, text in info["log"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    result = {"card": card, "build_s": info["seconds"]}
    failed = []
    rows = []
    phases = [
        ("phase 2: kernels vs plain versions at yi-9b shapes",
         lambda: phase_kernels(torch, Timer(torch), rows)),
        ("phase 3: main path, yi-9b full width and depth",
         lambda: result.__setitem__("main_counts", phase_main_path(torch, result))),
        ("phase 4: token identity, 4 layers, f32",
         lambda: identity(torch, result)),
        ("phase 5: mixed policy, 2 layers, f32",
         lambda: result.__setitem__("mixed_counts", phase_mixed(torch, result))),
    ]
    for label, fn in phases:
        if int(label.split()[1].rstrip(":")) not in want:
            continue
        t0 = time.perf_counter()
        log(f"{label} ...")
        try:
            fn()
            log(f"{label}: ok ({time.perf_counter() - t0:.1f}s)")
        except Exception:
            failed.append(label)
            log(f"{label}: FAILED\n{traceback.format_exc()}")
    mixed = result.get("mixed_counts", {})
    if mixed and mixed.get("fxp_matmul", 0) <= 0:
        failed.append("phase 5: fxp_matmul was not launched")
    result["rows"] = rows
    result["failed"] = failed
    result["seconds"] = time.perf_counter() - t_start
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(result, indent=1))
    if failed:
        log(f"FAILED: {failed}")
        return 1
    if want != {2, 3, 4, 5}:
        log(f"ran phases {sorted(want)} only: no result line")
        return 1
    main_counts = result["main_counts"]
    pick = {"pofx_matmul": ("m=4 k=4096 n=11008 x=bf16", main_counts["pofx_matmul"]),
            "kv_flash_decode": ("fxp8 B=4 G=4 R=8 S=96 Dh=128 pos=[65, 80, 90, 96]",
                                main_counts["kv_flash_decode"]),
            "fxp_matmul": ("m=4 k=4096 n=11008", mixed["fxp_matmul"])}
    src = {"pofx_matmul": ("src/repro_torch/csrc/pofx_matmul.cu", "src/repro/kernels/pofx_matmul.py:89"),
           "kv_flash_decode": ("src/repro_torch/csrc/kv_flash_decode.cu",
                               "src/repro/kernels/kv_flash_decode.py:139"),
           "fxp_matmul": ("src/repro_torch/csrc/fxp_matmul.cu", "src/repro/kernels/fxp_matmul.py:51")}
    kernels = []
    for name, (shape, launches) in pick.items():
        row = next(r for r in rows if r["name"] == name and r["shape"] == shape)
        kernels.append({"name": name, "route": "cuda", "source": src[name][0],
                        "replaces": src[name][1], "launches": launches,
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": shape})
    log(f"total {result['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
