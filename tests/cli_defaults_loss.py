"""Both packages' loss at the train CLI's defaults, at an intermediate width.

Answers ROADMAP Queue C item 3 (does the full-width loss rise at lr 1e-3
belong to the reference?). A yi-9b-shaped model at d_model 1024, 4 layers,
8 heads, 2 kv heads, d_ff 2816 and yi-9b's vocabulary runs 5 steps of the
CLI's loop (lr 1e-3, warmup ``steps // 10`` (at least 1), bf16 weights and
activations, block remat, batches of 8 x 128 tokens from the reference's
synthetic stream) in the reference (its jitted step) and in the port (its
``make_train_step`` on the CPU, from the reference's initial state carried
across), with f32 and with posit8 moments. Prints each loss trajectory and
one JSON line. Not a tier-1 test (a few minutes of CPU):

    PYTHONPATH=src:tests python tests/cli_defaults_loss.py [--steps 5]

``--example`` runs ``examples/train_lm.py --big``'s configuration instead
(12 layers, d_model 512, 8 heads of 64, 4 kv heads, d_ff 2048, vocab 32000;
lr 1e-3 with the schedule of a 300-step run, warmup 30; posit8 moments
only), the first ``--steps`` steps of it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax


def run(quant: str, steps: int, threads: int, example: bool = False):
    import torch
    from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig
    from repro.data import DataConfig, synthetic_batch
    from repro.launch.train import make_train_state as j_state, make_train_step as j_step
    from repro.nn.models import build_model as j_build
    from repro_torch.configs import ARCHS as T_ARCHS, RunConfig as TRunConfig
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch.train import make_train_step
    from repro_torch.nn.models import build_model as t_build
    from torch_bridge import to_numpy_tree
    torch.set_num_threads(threads)
    shape = dict(d_model=1024, n_layers=4, n_heads=8, n_kv_heads=2, d_head=128, d_ff=2816)
    jcfg, tcfg, total = J_ARCHS["yi-9b"], T_ARCHS["yi-9b"], steps
    if example:
        from repro.configs import smoke as j_smoke
        from repro_torch.configs import smoke as t_smoke
        shape = dict(n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, d_head=64, d_ff=2048,
                     vocab_size=32000)
        jcfg, tcfg, total = j_smoke(jcfg), t_smoke(tcfg), 300
    kw = dict(learning_rate=1e-3, total_steps=total, warmup_steps=max(total // 10, 1),
              microbatch=0, opt_state_quant=quant, remat="block")
    jm = j_build(dataclasses.replace(jcfg, **shape), JRunConfig(**kw))
    tm = t_build(dataclasses.replace(tcfg, **shape), TRunConfig(**kw), device="cpu")
    jstate = jax.jit(lambda k: j_state(jm, k))(jax.random.PRNGKey(0))
    tstate = train_state_from_numpy(to_numpy_tree(jstate), device="cpu")
    jstep, tstep = jax.jit(j_step(jm), donate_argnums=(0,)), make_train_step(tm)
    dc = DataConfig(vocab_size=jm.cfg.vocab_size, seq_len=128, global_batch=8)
    out = {"reference": [], "port": [], "reference_gnorm": [], "port_gnorm": []}
    t0 = time.perf_counter()
    for s in range(steps):
        b = synthetic_batch(dc, s)
        jstate, jmet = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
        tstate, tmet = tstep(tstate, b)
        out["reference"].append(float(jmet["loss"]))
        out["port"].append(float(tmet["loss"]))
        out["reference_gnorm"].append(float(jmet["grad_norm"]))
        out["port_gnorm"].append(float(tmet["grad_norm"]))
        print(f"{quant} step {s}: loss reference {out['reference'][-1]:.4f} port "
              f"{out['port'][-1]:.4f}; gnorm {out['reference_gnorm'][-1]:.3f} / "
              f"{out['port_gnorm'][-1]:.3f}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--example", action="store_true",
                    help="examples/train_lm.py --big's configuration, posit8 moments")
    args = ap.parse_args(argv)
    quants = ("posit8",) if args.example else ("none", "posit8")
    res = {q: run(q, args.steps, args.threads, args.example) for q in quants}
    print("cli_defaults_loss: " + json.dumps(res))
    return res


if __name__ == "__main__":
    main()
