#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one line each, any failure exits non-zero without the final line:

1. device and build: the card's name and power limit (nvidia-smi), the
   nvcc build of every kernel in src/repro_torch/csrc for sm_90a;
2. the kernel benchmark (``python -m repro_torch.bench.kernels``, the
   entry point that runs pofx_decode): each kernel against its plain
   PyTorch version on the card, pofx_decode exact on every code of every
   pofx spec, on every byte at every (N, ES, M) it accepts and on ragged
   shapes, fxp_matmul exact, at the reference bench's shapes and at
   yi-9b shapes, with its time, the plain version's, a library
   yardstick's and the least time the card could take (bound);
3. the main path: the serving CLI (``repro_torch.launch.serve.main``) with
   ``--arch yi-9b --quant pofx8 --kv-quant fxp8 --use-kernel`` and its
   defaults, i.e. the ServeEngine serving yi-9b at full width and depth
   (48 layers, 4 slots, 8 requests of 64 prompt tokens, 32 generated
   tokens, greedy), with the kernels' launch counts and the first-token
   logits against the plain path;
4. token identity at yi-9b width, 4 layers, f32 activations: kernels vs
   their plain versions on the card, greedy and sampled (temperature 0.8,
   top-k 40), and a sampled request evicted and resumed continues its
   uninterrupted stream;
5. the mixed policy attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16 with an fxp8 KV
   cache at yi-9b width, 2 layers, f32 activations: fxp_matmul launches;
   its streams against the all-plain path's are reported, and the ways in
   which they may part are checked (``phase_mixed``): with the plain run's
   int8 activation codes the kernels give the plain streams, and on the
   plain run's inputs the kernels' activation codes are within one
   rounding step of the plain run's;
6. the paged main path: the serving CLI with MAIN_ARGV + ``--paged
   --page-size 16`` and its defaults (yi-9b, 48 layers, bf16), i.e. the
   paged ServeEngine over a page pool with block tables and prefix
   sharing; kv_flash_paged_decode launches once per layer and decode step
   and kv_flash_decode never, the block manager's refcounts are clean, and
   the 8 streams equal phase 3's dense streams;
7. the paging machinery at yi-9b width, 4 layers, f32, kernels on, driving
   ``ServeEngine(paged=True)`` directly: shared prefixes (whole pages, one
   ending inside a page, so copy-on-write runs), one identical prompt, and
   one request evicted and resumed (its pages re-attached); prefix hits,
   copies and frees as the requests imply, and streams identical to the
   dense engine and to the all-plain paged engine;
8. sampled serving: the serving CLI with MAIN_ARGV + ``--layers 12
   --temperature 0.8 --top-k 40`` (yi-9b, its first 12 layers, bf16),
   dense twice (the same seed gives the same streams) and with ``--paged
   --page-size 16`` (the dense streams); launch counts, tok/s beside phase
   3's, and the time the draw adds to a decode step;
9. MoE serving: the serving CLI with ``--arch moonshot-v1-16b-a3b --quant
   pofx8 --kv-quant fxp8 --use-kernel --layers 12`` and its defaults (12
   of 48 layers, d_model 2048, 64 experts top-6 + 2 shared, greedy), with
   launch counts
   (7 pofx_matmul a layer: q/k/v/o and the shared experts' gate/up/down,
   plus the unembed; one kv_flash_decode a layer and decode step), the
   first-token logits against the plain path and a decode-step profile
   that splits out the MoE FFN; then, on the same weights, the paged
   engine (the dense streams, kv_flash_paged_decode a layer and step),
   kernels against plain versions at f32 and 2 layers (identical streams)
   and a sampled run against its repeat (identical streams);
10. SSM serving: the serving CLI with ``--arch falcon-mamba-7b`` and
   MAIN_ARGV's other flags and ``--layers 16`` (16 of 64 mamba1 layers,
   d_model 4096, no attention) and its defaults: launch counts (in_proj
   and out_proj a layer plus the unembed, 33 pofx_matmul a forward; no
   kv_flash_decode), first-token
   logits against the plain path, a decode-step profile with the plain
   mixer (conv, x/dt products, recurrence: ``ssm.mamba1_mix``) in a
   ``record_function`` range; ``--paged`` refused; kernels against plain
   versions at f32 on the first 2 layers (identical streams) and a sampled
   run against its repeat on the first 8 (identical streams);
11. hybrid serving: the same with ``--arch zamba2-1.2b --layers 14`` (14
   of 38 mamba2 layers, d_model 2048, one shared attention + MLP block
   before each run of 6 layers, 3 a forward, the last run of 2): 47
   pofx_matmul a forward (14 x 2, 3 x 6 for the shared block, the
   unembed) and 3 kv_flash_decode a decode step; the profile's range is ``ssm.mamba2_mix``; the sampled repeat on
   the first 7 layers (two applications of the shared block);
12. encdec serving: the serving CLI with ``--arch whisper-medium`` and
   MAIN_ARGV's other flags (24 encoder + 24 decoder layers, d_model 1024;
   the CLI drops the fxp8 KV cache and runs the one-shot loop: 4 sequences
   of 64 tokens and 64 encoder frames drawn as the reference draws them,
   one batched prefill, 31 greedy decode steps) and its defaults: exactly
   385 pofx_matmul in the prefill (24 x 6 encoder, 24 x 10 decoder, the
   unembed) and 193 a decode step (24 x 8 + 1), 6368 in all, none of the
   other kernels; 4 x 32 in-vocab tokens, finite logits; first-token
   logits against the plain path (same argmax); kernels against plain
   versions at f32 on the first 2 encoder and 2 decoder layers (identical
   streams); the loop repeated at full depth (identical tokens); a
   decode-step profile with the cross-attention (``attention._cross_attn``)
   in a ``record_function`` range; a decode step with
   ``serve_bf16_compute`` (every ``decode_attention`` call taking it) and
   that path on layer 0's cross cache against its formula
   (``bf16_compute_check``);
13. training, yi-9b full width: the training CLI (``python -m
   repro_torch.launch.train --arch yi-9b --opt-quant posit8 --layers 12``,
   batch 8 x 128 tokens, bf16 weights, block remat) in a process of its
   own: finite losses and grad norms, step ms, tokens/s, the model-FLOP
   share of the bf16 peak, peak device memory and a profiled step split
   into forward, backward and optimizer; f32 moments at 2 layers (three
   steps on one batch: the loss falls; microbatch 2 against 1); at 2
   layers and f32, ``LM.loss`` gradients through the flash backward
   against autograd through a materialized softmax, and the flash forward
   and backward at bf16 against ``scaled_dot_product_attention``; at 2
   layers with posit8 moments an async checkpoint at step 1 restored into
   a fresh state (equal leaf for leaf) and the resumed step 2's loss equal
   to the uninterrupted run's bit for bit, after two uninterrupted runs
   show whether the card's step is deterministic. The in-process parts
   launch none of the port's kernels (the reference runs no Pallas kernel
   in training);
14. training the other families at full width, with posit8 moments and
   the CLI's run configuration (batch 8 x 128, lr 1e-3, bf16, block
   remat): (a) ``python -m repro_torch.launch.train --arch falcon-mamba-7b
   --opt-quant posit8 --steps 4 --profile --layers 16`` in a process of
   its own (16 of 64 mamba1 layers; the fields of phase 13 and its
   profiled split); (b) the same with ``--arch zamba2-1.2b --steps 3
   --layers 14``; (c) moonshot-v1-16b-a3b on its first 2 layers and (d)
   whisper-medium on 6 + 6 layers (batches with frames drawn as the
   serving CLI draws them) through ``make_train_step`` in this process:
   finite losses, step ms, tokens/s, model-FLOP share, peak memory; (e) for
   those four, at 2 layers and f32, ``LM.loss`` gradients on the card
   against the same model's on the CPU (every leaf within 1e-4 of its
   largest entry) and a falling loss on one batch at lr 1e-5; no kernel of
   the port launched;
15. nemotron-4-340b serving at full width (d_model 18432, 8 groups of 12
   query rows, d_head 192, squared-ReLU MLP) on its first 2 layers, pofx8
   weights, fxp8 KV cache, kernels on, greedy: the CLI's workload through
   the dense engine, then the paged engine (16-token pages) on the same
   weights; 13 pofx_matmul a forward, one kv_flash_decode (dense) or
   kv_flash_paged_decode (paged) a layer and decode step, the paged
   streams equal to the dense ones, and first-token logits of kernels
   against the plain path at f32 within 1e-3 of the largest logit.
16. tensor-parallel serving at tp = 2 (``phase_tp``): (a) the serving CLI
   with MAIN_ARGV + ``--layers 12 --tp 2`` (yi-9b, 12 layers, bf16; two
   rank processes, on one card over gloo, with a card a rank over NCCL):
   each rank launches exactly the tp = 1 counts (85 pofx_matmul a forward,
   12 kv_flash_decode a decode step); the backend, tok/s, weight GiB a
   rank and the all-reduce's share of a decode step (a profile in each
   rank); (b) at yi-9b width, 2 layers, f32,
   kernels on, fxp8 KV: tp = 2 greedy, sampled, paged and evict -> resume
   streams equal tp = 1's; (c) moonshot on 2 layers and zamba2 on its
   first 7 (two applications of the shared block) at f32, tp = 2 against
   tp = 1, then moonshot at bf16 on 2 layers with the CLI's workload and
   its launch counts a rank; (d) (b) again over NCCL where there is a card
   a rank, else one line saying NCCL was not run.
17. training the dense family across ranks (``phase_grid_train``): (a)
   yi-9b at full width on 1 layer, f32 weights and activations, posit8
   moments, lr 1e-5, the CLI's 8 x 128 tokens, block remat: three steps
   at tp = 1 in this process (its state freed after), then the same from
   the same seed on the (data 2, model 2) grid, four rank processes
   (``RankPool(grids=)``, over gloo when they share the card, NCCL with a
   card each): every step's loss and grad norm within 1e-4 of tp = 1's;
   every parameter within 1e-4 of its leaf's largest entry (or 0.03 lr)
   wherever its m and v codes equalled tp = 1's after every step, and
   99.9 % of each leaf within 0.03 lr; the moment scales equal, each moment code parting
   from tp = 1's by one step (or within two codes of zero), at most 0.1 % of
   them apart after the last step; then the (data 2, model 2) grid again
   with ``sequence_parallel`` (``grid_sp_run``: every rank's residual cut
   along seq, the same gates, its first loss beside the grid's without
   it); then (pod 2, model 2) with
   ``grad_compression="posit8_ef"``: finite losses and the first step's
   compressed gradient mean equal, bit for bit, to the port's
   ``posit_compressed_mean`` on the CPU over the pods' gradients (every
   leaf's first 2^18 elements, the scale from the whole leaf); step ms
   (bare steps), tokens/s, peak GiB a rank and the collectives' share of
   step 1 (host time in the ``TPContext`` collectives, the card
   synchronized around each, in that step alone); (b) where there are
   four cards, full-depth yi-9b on (data 2, model 2) over NCCL with the
   train CLI's workload (bf16, posit8 moments, 5 steps), else one line
   saying (b) was not run.
18. the paper's behavioral analysis (``phase_analysis``): yi-9b at full
   width (d_model 4096, d_ff 11008, vocab 64000) on 2 layers, f32
   activations, 20 steps of the analysis CLI's training (lr 1e-3, 8 x 128
   tokens of the synthetic stream), then ``launch.analyze.run_analysis``
   over the 33 specs of ``default_spec_grid(include_paths=True)`` once
   with the kernels and once with their plain versions: level (a) on layer
   0's wq, wo, wg and the unembed, level (b) on wq and wg, level (c) the
   eval NLL of 8 x 128 tokens (m = 1024 rows in every weight matmul); the
   same pruned and surviving configs and derived policy in both runs, each
   survivor's NLL within 2e-5, 15 pofx_matmul (pofx) or fxp_matmul (fxp)
   launches in each survivor's forward, fxp7 and fxp8 among the
   survivors; then every pofx and fxp config of the grid, pruned or not,
   through the same eval with kernels and plain (NLL within 2e-5, 15
   launches each: pofx_matmul at every (N, ES, path)); fxp16's NLL (its
   codes wrap to int8 as in the reference) printed beside its NLL without
   kernels; each level's seconds, the survivors with their bits per
   weight, the derived policy and its NLL.
19. training the moe, ssm, hybrid and encdec families across ranks
   (``phase_grid_families``): moonshot-v1-16b-a3b on 1 layer (one MoE
   layer, 64 experts), falcon-mamba-7b on 1, zamba2-1.2b on 1 (after one
   application of the shared block) and whisper-medium on 1 + 1, each at
   full width as phase 17 runs yi-9b (f32, posit8 moments, lr 1e-5, 8 x
   128 tokens, block remat): two steps at tp = 1 in this process, then two
   on the (data 2, model 2) grid in one pool of four rank processes, held
   to tp = 1's by phase 17's gates (``grid_gate``); moonshot's first step
   must drop assignments at capacity (the grid's count over its data ranks
   printed beside tp = 1's); whisper's grid state saved by every rank
   (rank 0 writes) and restored, each rank's shards equal bit for bit,
   with the seconds of both; moonshot and whisper (the families the
   reference's production knobs run sequence-parallel) again on the grid
   with ``sequence_parallel``, as phase 17's, moonshot's drops equal to
   tp = 1's; step ms (the first step), tokens/s, peak GiB a rank and the
   collectives' share of step 1 a run. Like the other training phases it
   launches none of the port's kernels.
20. the dry run against the card (``phase_dryrun``, in a process of its
   own, since a process joins one world): (a) yi-9b width on 4 layers,
   8 x 128 tokens, bf16, block remat, posit8 moments, one rank: the dry
   run's step on fake CUDA tensors (``launch.dryrun.dry_train_step``),
   then three real steps after ``make_train_state``, with the peak
   statistics reset before the state is made and read after the first
   step; ``torch.cuda.max_memory_allocated`` must lie within
   DRYRUN_PEAK_RTOL of the predicted
   ``peak_memory_in_bytes``; the counted flops beside 8 N T and the
   roofline's bound beside the measured step are printed; (b) the
   production cell, ``python -m repro_torch.launch.dryrun --arch yi-9b
   --shape train_4k --mesh single --device cuda``'s ``main`` (rank 0 of a
   fake world of 256 on (16, 16)): its per-rank GiB and bound printed.

21. serving on a (pod, data, model) grid (``phase_grid_serve``): yi-9b at
   full width on 1 layer, pofx8 weights, fxp8 KV cache, kernels on, f32
   activations, 8 slots: ragged prompts of 100-140 tokens in a 256-position
   cache (128 positions a model rank; three prompts end past the boundary,
   two cross it while decoding) and short prompts in a 4096-position cache
   (model rank 1's block empty), each prefilled and decoded 16 greedy steps
   at tp = 1 in this process and on (data 2, model 2) in four rank
   processes (gloo on one card, NCCL with a card each): every rank's
   streams equal tp = 1's, with the kernels and with their plain versions;
   first-token logits within 1e-3 of the largest; each rank's KV codes its
   block of tp = 1's (at most 0.1 % one step apart); per rank exactly 8
   pofx_matmul a forward and one kv_flash_decode (with its lse output) a
   decode step; decode ms a step, the combine's share of a step
   (``combine_partials`` in a ``record_function`` range, profiled) and peak
   GiB a rank. The lse output itself is held against its plain form in
   phase 2 at a rank's shapes, local lengths of 0 included
   (``bench.kernels.GRID_KV_SHAPES``), where kv_flash_paged_decode (whose
   shared body passes no lse) stays bit-equal to the dense kernel.
22. the reference's examples (``phase_examples``): ``python -m
   repro_torch.examples.train_lm --big --steps 60`` (EXAMPLE_STEPS, for
   the phase's 60-s budget; 12 layers, d_model 512, vocab 32000, 8 x 128
   tokens a step, bf16, block remat, posit8 moments, checkpoints every 50
   steps) in a directory under ``build/``, then again on it (it resumes
   from its last checkpoint, trains no step, holds the same parameters bit
   for bit); the loss curve, the example's perplexity table (fp32,
   pofx8es2, pofx6es2, fxp8f7, the mixed policy, ratio to fp32) and its
   ``paper-table6`` storage report; the trained parameters under each
   policy evaluated again at f32 with the kernels (``pofx_matmul``,
   ``fxp_matmul``: launch counts > 0), with their plain versions and with
   an f64 witness: every policy's logits through the kernels within 1e-3
   of the plain versions' largest logit (the mixed policy's on the
   kernels given the plain run's fxp activation codes, whose flips its
   free run shows beside the witness's), the perplexity gaps printed;
   ``quickstart`` and ``serve_quantized --use-kernel`` on the card.

Phases 17, 19 and 21 share one pool of four rank processes
(``GRID_POOL_GRIDS``), which ``main`` starts before the first of them and
closes at the end; each empties its ranks' CUDA caches when it ends.

Before torch is imported, the CUDA driver is asked to start in a process of
its own (``wait_for_card``): a freshly booted host may refuse for a while
(CUDA_ERROR_SYSTEM_NOT_READY until its fabric manager is up), and a start
that failed stays failed in the process that saw it, so the script retries
there for up to CARD_WAIT_S seconds. No CUDA driver, or one that finds no
device, ends the script at once with exit code 2.

TF32 is off for matmuls and convolutions, so every f32 product (the plain
versions included) is a true f32 product. Details go to
chiprun_out/chip_smoke.json. The last line is {"ok": true, "device": ...}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

CARD_WAIT_S = 300
CUDA_SUCCESS, CUDA_ERROR_NO_DEVICE = 0, 100
CUDA_PROBE = """
import ctypes, sys
try:
    lib = ctypes.CDLL("libcuda.so.1")
except OSError:
    sys.exit(3)
n = ctypes.c_int(0)
rc = lib.cuInit(0)
if rc == 0:
    rc = lib.cuDeviceGetCount(ctypes.byref(n))
print(rc, n.value)
"""


def cuda_driver_state():
    """(cuInit's result, device count), asked of the driver in a fresh
    process; None when there is no CUDA driver library."""
    try:
        res = subprocess.run([sys.executable, "-c", CUDA_PROBE], capture_output=True,
                             text=True, timeout=120)
    except subprocess.TimeoutExpired:
        return (-1, 0)
    if res.returncode == 3:
        return None
    try:
        rc, n = (int(v) for v in res.stdout.split())
    except ValueError:
        return (-1, 0)
    return (rc, n)


def wait_for_card(limit_s: float = CARD_WAIT_S):
    """Retry the driver's start every 10 s until it succeeds, reports no
    device, or ``limit_s`` has passed; returns the last state."""
    t0 = time.monotonic()
    while True:
        state = cuda_driver_state()
        if state is None or state[0] in (CUDA_SUCCESS, CUDA_ERROR_NO_DEVICE):
            return state
        if time.monotonic() - t0 >= limit_s:
            return state
        print(f"chip_smoke: cuInit returned {state[0]}; retrying in 10 s", file=sys.stderr,
              flush=True)
        time.sleep(10)


def log(msg: str) -> None:
    print(msg, flush=True)


def serve(torch, model, params, *, n_req=8, prompt_len=64, gen=32, slots=4, chunk=8,
          watch=None, sampling=None, paged=False):
    """The engine over ``model`` serving the CLI's default workload (the
    requests ``serve.main`` makes, greedy unless ``sampling`` is given;
    ``paged``: 16-token pages); ``watch(engine)`` sees the engine before it
    runs."""
    from repro_torch.launch.engine import SamplingParams, ServeEngine
    from repro_torch.launch.serve import make_requests
    eng = ServeEngine(model, params, n_slots=slots, max_len=prompt_len + gen, chunk=chunk,
                      paged=paged, page_size=16)
    if watch is not None:
        watch(eng)
    reqs = make_requests(model.cfg.vocab_size, n_req, prompt_len, gen,
                         sampling=sampling or SamplingParams())
    done = eng.run(reqs)
    torch.cuda.synchronize()
    return eng, done, reqs


def first_logits(torch, model, params, prompt):
    cache = model.init_cache(1, len(prompt) + 1)
    _, logits = model.prefill(params, torch.as_tensor(prompt[None], device="cuda"), cache=cache)
    return logits.float()


MAIN_ARGV = ["--arch", "yi-9b", "--quant", "pofx8", "--kv-quant", "fxp8", "--use-kernel"]
# the depth of every serving and training CLI run after the main path:
# phase 3, and phase 6 whose streams equal it, serve all 48 of yi-9b's
# layers; the later runs take an arch's first N layers at full width
# (``--layers N``), so that the script keeps to half its time limit
CUT_LAYERS = {"yi-9b": 12, "moonshot-v1-16b-a3b": 12, "falcon-mamba-7b": 16,
              "zamba2-1.2b": 14}


def cut(arch):
    """``--layers`` for ``arch``'s depth in CUT_LAYERS."""
    return ["--layers", str(CUT_LAYERS[arch])]


def serve_cli_run(torch, argv, what="main path"):
    """``python -m repro_torch.launch.serve`` with ``argv`` and the CLI's
    defaults, in this process so that the launch counts can be read (every
    count set to 0 just before, read just after). Returns (the ServeRun,
    the counts, a summary of the run)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as serve_cli
    torch.cuda.reset_peak_memory_stats()
    log(f"  repro_torch.launch.serve {' '.join(argv)}")
    reset_launches()
    run = serve_cli.main(argv)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    eng, done = run.engine, run.done
    st = eng.stats()
    n_prompt = sum(len(s.context) for s in done)
    summary = {"argv": argv, "arch": run.model.cfg.name, "n_layers": run.model.cfg.n_layers,
               "requests": len(done), "prompt_len": 64, "gen": 32, "slots": eng.n_slots,
               "prefill_tok_s": n_prompt / eng.prefill_time,
               "decode_tok_s": st["decode_tokens"] / eng.decode_time,
               "prefill_s": eng.prefill_time, "decode_s": eng.decode_time,
               "decode_steps": st["decode_steps"], "launches": counts,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"  served {len(done)} requests: prefill {n_prompt} tokens in {eng.prefill_time:.3f}s "
        f"({summary['prefill_tok_s']:.1f} tok/s), decode {st['decode_tokens']} tokens in "
        f"{eng.decode_time:.3f}s over {st['decode_steps']} steps "
        f"({summary['decode_tok_s']:.1f} tok/s), peak {summary['peak_gib']:.2f} GiB "
        f"(init included)")
    log(f"  launches on the {what}: {counts}")
    return run, counts, summary


def phase_main_path(torch, result):
    """``python -m repro_torch.launch.serve`` with MAIN_ARGV and the CLI's
    defaults (4 slots, 8 requests, 64-token prompts, 32 new tokens)."""
    from repro_torch.kernels.ops import PLAIN
    run, counts, summary = serve_cli_run(torch, MAIN_ARGV)
    model, params, eng, done = run.model, run.params, run.engine, run.done
    cfg = model.cfg
    st = eng.stats()
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
    result["main_path"] = dict(summary, first_logit_max_abs_diff=diff)
    result["main_streams"] = [s.out for s in done]
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


def profile_decode(torch, model, params, steps: int = 4, paged: bool = False,
                   sample: bool = False, regions=None, cache=None):
    """Device time by kernel over ``steps`` decode steps at 4 slots and a
    64-token context (torch.profiler, CUDA activity), against the host
    wall time of the same steps: where a decode step's time goes. ``paged``
    profiles the paged cache (16-token pages, 6 per slot); ``sample`` adds
    the engine's draw to each step (slot keys folded with the positions,
    temperature 0.8, top-k 40), its token fed back as the engine does.
    ``regions`` {label: (module, function name)} wraps those functions in
    ``record_function`` ranges while profiling and reports the device time
    of the kernels launched inside each, a step. ``cache`` (4 slots, room
    for 9 more positions) replaces the zero cache at position 64, e.g. one
    that a prefill filled."""
    restore = []
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core import prng
        from repro_torch.launch.engine import sample_tokens
        if cache is None:
            if paged:
                cache = model.init_paged_cache(4, 96, n_pages=25, page_size=16)
                cache["pages"] = torch.arange(1, 25, dtype=torch.int32,
                                              device="cuda").reshape(4, 6)
            else:
                cache = model.init_cache(4, 96)
            cache["pos"] = torch.full((4,), 64, dtype=torch.int32, device="cuda")
        tok = torch.zeros((4, 1), dtype=torch.long, device="cuda")
        keys = prng.fold_in(prng.PRNGKey(0, "cuda").expand(4, 2),
                            torch.arange(4, device="cuda"))
        temps = torch.full((4,), 0.8, device="cuda")
        topks = torch.full((4,), 40, dtype=torch.int64, device="cuda")

        def step(cache, tok):
            pos = cache["pos"]
            cache, logits = model.decode_step(params, cache, tok)
            if sample:
                tok = sample_tokens(logits, prng.fold_in(keys, pos), temps, topks)[:, None]
            return cache, tok

        cache, tok = step(cache, tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            cache, tok = step(cache, tok)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - t0) * 1e3 / steps
        for label, (module, name) in (regions or {}).items():
            restore.append((module, name, getattr(module, name)))
            setattr(module, name, annotated(torch, label, getattr(module, name)))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                cache, tok = step(cache, tok)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        by_name, host, syncs = {}, {}, {}
        for evt in prof.key_averages():
            # work on the card: kernels, copies and sets (an aten op's own
            # device time is its kernels', and a region's is its span)
            dev_us = getattr(evt, "self_device_time_total", 0) or 0
            # ("nccl:*" are NCCL's own ranges over its kernels, counted once)
            if evt.device_type == DeviceType.CUDA and evt.key not in (regions or {}) \
                    and not evt.key.startswith("nccl:") and dev_us > 0:
                by_name[evt.key] = dev_us / 1e3 / steps
            host[evt.key] = evt.self_cpu_time_total / 1e3 / steps
            # host calls that wait for the card (the last one, after the
            # loop, is the timing's own synchronize)
            if ("Synchronize" in evt.key or evt.key in ("cudaMemcpy", "aten::item",
                                                        "aten::_local_scalar_dense")):
                syncs[evt.key] = evt.count / steps
        busy = sum(by_name.values())
        # the flash-decode kernels (csrc/kv_flash_common.cuh's decode_kernel)
        attn = sum(ms for name, ms in by_name.items() if "kv_flash" in name)
        pofx = sum(ms for name, ms in by_name.items() if "pofx_matmul" in name)
        # kernels launched by PyTorch ops inside each region: the host-side
        # range's own and its children's (the device-side range of the same
        # name is its span; the ctypes launches of the port's kernels are
        # counted by name above, not in a region)
        region_ms = {label: sum(e.device_time_total for e in prof.events()
                                if e.name == label and e.device_type == DeviceType.CPU)
                     / 1e3 / steps
                     for label in regions or {}}
        # and the host's span of each region, a step (a collective waits there)
        region_host_ms = {label: sum(e.cpu_time_total for e in prof.events()
                                     if e.name == label and e.device_type == DeviceType.CPU)
                          / 1e3 / steps
                          for label in regions or {}}
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        top_host = sorted(host.items(), key=lambda kv: -kv[1])[:6]
        log(f"  decode step profile: wall {wall_ms:.2f} ms ({bare_ms:.2f} ms without the "
            f"profiler), device busy {busy:.2f} ms ({100 * (1 - busy / wall_ms):.1f}% idle), "
            f"attention {attn:.3f} ms, pofx_matmul {pofx:.3f} ms; host waits per step {syncs}")
        if region_ms:
            log(f"  device ms a step inside {', '.join(f'{k} {v:.3f}' for k, v in region_ms.items())}"
                f"; host ms a step inside "
                f"{', '.join(f'{k} {v:.3f}' for k, v in region_host_ms.items())}")
        for name, ms in top:
            log(f"    {ms:8.3f} ms/step  {name[:90]}")
        for name, ms in top_host:
            log(f"    {ms:8.3f} ms/step host  {name[:84]}")
        return {"wall_ms": wall_ms, "bare_wall_ms": bare_ms, "device_busy_ms": busy,
                "attention_ms": attn, "pofx_matmul_ms": pofx, "region_ms": region_ms,
                "region_host_ms": region_host_ms,
                "host_waits_per_step": syncs, "top": [[n, ms] for n, ms in top],
                "top_host": [[n, ms] for n, ms in top_host]}
    except Exception:  # the profile is an aside: record why it is missing
        log(f"  decode step profile: not measured\n{traceback.format_exc()}")
        return None
    finally:
        for module, name, fn in restore:
            setattr(module, name, fn)


def annotated(torch, label, fn):
    """``fn`` inside a ``torch.profiler.record_function(label)`` range."""
    def call(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return call


def small_model(n_layers, policy_s, kv_s):
    """yi-9b width at ``n_layers`` layers, f32 activations, kernels on."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import QuantPolicy, parse_spec
    from repro_torch.nn.models import build_model
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=n_layers)
    rcfg = RunConfig(remat="none", activation_dtype="f32")
    model = build_model(cfg, rcfg, use_kernel=True, kv_spec=parse_spec(kv_s))
    return model, model.init(1, policy=QuantPolicy.from_string(policy_s))


SAMPLING = {"temperature": 0.8, "top_k": 40}


def identity(torch, result):
    """Phase 4: greedy and sampled streams with the kernels equal those with
    every kernel's plain version, at 4 layers; a sampled request evicted
    after its first chunk and resumed continues its uninterrupted stream."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch.engine import SamplingParams, ServeEngine
    from repro_torch.launch.serve import make_requests
    model, params = small_model(4, "pofx8", "fxp8")
    plain = dataclasses.replace(model, kernel_set=PLAIN)
    reset_launches()
    _, done_k, _ = serve(torch, model, params)
    counts = dict(LAUNCHES)
    _, done_p, _ = serve(torch, plain, params)
    same, n = compare(done_k, done_p, "plain"), len(done_k)
    log(f"  identity_4l: {n} streams x {len(done_k[0].out)} tokens, {same}/{n} identical "
        f"to the plain path; launches {counts}")
    sp = SamplingParams(**SAMPLING)
    _, sk, _ = serve(torch, model, params, sampling=sp)
    _, sp_plain, _ = serve(torch, plain, params, sampling=sp)
    same_s = compare(sk, sp_plain, "plain (sampled)")
    eng = ServeEngine(model, params, n_slots=4, max_len=96, chunk=8)
    resumed, ctx = drive_paging(eng, make_requests(model.cfg.vocab_size, 8, 64, 32,
                                                   sampling=sp), evict_rid=0)
    torch.cuda.synchronize()
    same_r = sum(resumed[s.req.rid] == s.out for s in sk)
    greedy_tokens = sum(a == b for s, g in zip(sk, done_k) for a, b in zip(s.out, g.out))
    log(f"  sampled (temperature 0.8, top-k 40): {same_s}/{n} streams identical to the "
        f"plain path; with rid 0 evicted after its first chunk (context {ctx}) and "
        f"resumed, {same_r}/{n} identical to the uninterrupted run; "
        f"{greedy_tokens}/{n * 32} tokens equal to the greedy run's")
    result["identity_4l"] = {"n_layers": 4, "policy": "pofx8", "kv": "fxp8",
                             "identical_streams": same, "streams": n, "launches": counts,
                             "sampling": SAMPLING, "sampled_identical_streams": same_s,
                             "sampled_resume_identical_streams": same_r,
                             "sampled_tokens_equal_to_greedy": greedy_tokens}
    if same != n:
        raise AssertionError("identity_4l: kernel streams differ from the plain path")
    if same_s != n:
        raise AssertionError("identity_4l: sampled kernel streams differ from the plain path")
    if eng._states[0].n_evictions != 1 or same_r != n:
        raise AssertionError("identity_4l: the evicted sampled request did not resume "
                             "its uninterrupted stream")


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
             "rows": len(gaps), "would_part": events,
             "free_streams": [s.out for s in done_k], "plain_streams": streams(plain)}
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


PAGED_ARGV = MAIN_ARGV + ["--paged", "--page-size", "16"]


def phase_paged_main(torch, result):
    """Phase 6: ``python -m repro_torch.launch.serve`` with PAGED_ARGV and
    the CLI's defaults; its streams against phase 3's dense streams."""
    dense = result.get("main_streams")
    if dense is None:
        raise AssertionError("phase 6 compares with phase 3's streams: run phase 3 too")
    run, counts, summary = serve_cli_run(torch, PAGED_ARGV, "paged main path")
    model, eng, done = run.model, run.engine, run.done
    cfg = model.cfg
    st = eng.stats()
    log(f"  pages: {st['resident_pages']}/{eng.n_pages - 1} resident at the end, "
        f"{st['pages_reclaimed']} reclaimed, {st['pages_freed']} freed, prefix hits "
        f"{st['prefix_hits']}/{st['prefix_queries']}, {st['cow_copies']} CoW copies")
    eng._pager.check()
    per_fwd = 7 * cfg.n_layers + 1
    want = {"pofx_matmul": per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"]),
            "kv_flash_paged_decode": cfg.n_layers * st["decode_steps"],
            "kv_flash_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    if counts["kv_flash_paged_decode"] <= 0 or counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    if cfg.n_layers != 48 or cfg.d_model != 4096 or len(done) != 8 or not eng.paged:
        raise AssertionError(f"paged path ran {cfg.n_layers} layers, d={cfg.d_model}, "
                             f"{len(done)} requests, paged={eng.paged}")
    streams = [s.out for s in done]
    same = sum(a == b for a, b in zip(streams, dense))
    log(f"  streams: {same}/{len(dense)} identical to phase 3's dense streams")
    result["paged_decode_profile"] = profile_decode(torch, model, run.params, paged=True)
    result["paged_main_path"] = dict(
        summary, page_size=eng.page_size, n_pages=eng.n_pages, identical_to_dense=same,
        paging={k: st[k] for k in ("resident_pages", "free_pages", "prefix_queries",
                                   "prefix_hits", "prefix_hit_tokens", "pages_freed",
                                   "pages_reclaimed", "cow_copies", "index_holdings")})
    if same != len(dense):
        raise AssertionError("paged streams differ from the dense main path's")
    del run, model, eng
    torch.cuda.empty_cache()
    return counts


def paging_requests(vocab: int):
    """Phase 7's workload, 16 new tokens each, all arriving at once on 4
    slots. rids 0-5 share a 48-token prefix (three full 16-token pages) and
    rid 5 repeats rid 4's whole prompt; rid 6's 40-token prompt is rid 7's
    prefix, which ends inside a page. Returns the requests and the prefix
    hit each admission implies (the hit is capped at the context length
    minus one, so that one token prefills)."""
    import numpy as np
    from repro_torch.launch.engine import Request
    rng = np.random.default_rng(7)
    pre_a, pre_b = rng.integers(0, vocab, 48), rng.integers(0, vocab, 40)
    prompts = []
    for i in range(5):
        suffix = rng.integers(0, vocab, 16)
        suffix[0] = i      # distinct first suffix tokens: the shared run is exactly 48
        prompts.append(np.concatenate([pre_a, suffix]))
    prompts.append(prompts[4].copy())
    prompts.append(pre_b)
    prompts.append(np.concatenate([pre_b, rng.integers(0, vocab, 24)]))
    hits = [0, 48, 48, 48, 48, 63, 0, 40]
    return [Request(rid=i, prompt=p, max_new=16) for i, p in enumerate(prompts)], hits


def drive_paging(eng, requests, evict_rid=None):
    """``eng.run`` with ``evict_rid`` evicted after the first decode chunk;
    returns ({rid: tokens}, the evicted request's context length)."""
    for r in requests:
        eng.submit(r)
    resumed_ctx = None
    while eng.pending_rids or eng.active_rids:
        eng.admit_ready()
        eng.step()
        if resumed_ctx is None and evict_rid in eng.active_rids:
            eng.evict(evict_rid)
            resumed_ctx = len(eng._states[evict_rid].context)
    return {rid: st.out for rid, st in eng._states.items()}, resumed_ctx


def phase_paging(torch, result):
    """Phase 7: the paging machinery at yi-9b width, 4 layers, f32, kernels
    on: prefix hits, copy-on-write, frees and an evict -> resume that
    re-attaches its pages, with streams identical to the dense engine
    (uninterrupted) and to the all-plain paged engine."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch.engine import ServeEngine
    model, params = small_model(4, "pofx8", "fxp8")
    requests, hits = paging_requests(model.cfg.vocab_size)
    kw = dict(n_slots=4, max_len=80, chunk=8)
    reset_launches()
    eng = ServeEngine(model, params, paged=True, page_size=16, **kw)
    got, ctx = drive_paging(eng, requests, evict_rid=0)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    st = eng.stats()
    eng._pager.check()
    want_hits = sum(hits) + ctx - 1    # the resume re-attaches all but one token
    plain_eng = ServeEngine(dataclasses.replace(model, kernel_set=PLAIN), params,
                            paged=True, page_size=16, **kw)
    plain, _ = drive_paging(plain_eng, requests, evict_rid=0)
    dense_eng = ServeEngine(model, params, **kw)
    dense = {s.req.rid: s.out for s in dense_eng.run(requests)}
    same_dense = sum(got[r] == dense[r] for r in dense)
    same_plain = sum(got[r] == plain[r] for r in plain)
    paging = {k: st[k] for k in ("prefix_queries", "prefix_hits", "prefix_hit_tokens",
                                 "cow_copies", "pages_freed", "pages_reclaimed",
                                 "resident_pages", "index_holdings")}
    log(f"  paging: {paging}; expected prefix_hit_tokens {want_hits} "
        f"(resumed context {ctx} tokens)")
    log(f"  launches {counts}; streams: {same_dense}/8 identical to the dense engine "
        f"(uninterrupted), {same_plain}/8 to the all-plain paged engine")
    result["paging_4l"] = {"n_layers": 4, "policy": "pofx8", "kv": "fxp8", "page_size": 16,
                           "paging": paging, "expected_prefix_hit_tokens": want_hits,
                           "launches": counts, "identical_to_dense": same_dense,
                           "identical_to_plain_paged": same_plain}
    if st["prefix_hit_tokens"] != want_hits or st["prefix_hits"] != 7:
        raise AssertionError(f"prefix hits {st['prefix_hits']} / {st['prefix_hit_tokens']} "
                             f"tokens, expected 7 / {want_hits}")
    if st["cow_copies"] < 1 or st["pages_freed"] <= 0:
        raise AssertionError(f"no copy-on-write or no page freed: {paging}")
    if counts["kv_flash_paged_decode"] <= 0 or counts["kv_flash_decode"] != 0:
        raise AssertionError(f"paged engine launches {counts}")
    if eng._states[0].n_evictions != 1:
        raise AssertionError("rid 0 was not evicted and resumed")
    for r in requests:
        if len(got[r.rid]) != r.max_new:
            raise AssertionError(f"rid {r.rid}: {len(got[r.rid])} tokens")
    if same_dense != 8 or same_plain != 8:
        raise AssertionError("paged streams differ from the dense or the all-plain engine")


SAMPLED_ARGV = MAIN_ARGV + cut("yi-9b") + ["--temperature", "0.8", "--top-k", "40"]


def phase_sampled(torch, result):
    """Phase 8: the serving CLI with SAMPLED_ARGV (yi-9b, 12 layers, bf16),
    dense, dense again with the same seed (the same streams), and with
    ``--paged --page-size 16`` (the dense streams); the kernels' launch
    counts as on the greedy paths; tok/s beside phase 3's; the decode-step
    profile with the draw against the same model's greedy one; the draw
    alone timed on the card."""
    from repro_torch.bench.common import Timer
    from repro_torch.core import prng
    from repro_torch.launch.engine import SamplingParams, sample_tokens
    greedy = result.get("main_path")
    if greedy is None:
        raise AssertionError("phase 8 compares with phase 3: run phase 3 too")
    runs, streams = {}, {}
    for name, argv in (("dense", SAMPLED_ARGV), ("repeat", SAMPLED_ARGV),
                       ("paged", SAMPLED_ARGV + ["--paged", "--page-size", "16"])):
        run, counts, summary = serve_cli_run(torch, argv, f"sampled path ({name})")
        model, eng, done = run.model, run.engine, run.done
        cfg = model.cfg
        st = eng.stats()
        per_fwd = 7 * cfg.n_layers + 1
        attn = "kv_flash_paged_decode" if eng.paged else "kv_flash_decode"
        want = {"pofx_matmul": per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"]),
                "kv_flash_decode": 0, "kv_flash_paged_decode": 0, "fxp_matmul": 0,
                "pofx_decode": 0}
        want[attn] = cfg.n_layers * st["decode_steps"]
        if counts != want:
            raise AssertionError(f"sampled {name}: launch counts {counts} != expected {want}")
        if cfg.n_layers != CUT_LAYERS["yi-9b"] or cfg.d_model != 4096 or len(done) != 8:
            raise AssertionError(f"sampled {name} ran {cfg.n_layers} layers, "
                                 f"d={cfg.d_model}, {len(done)} requests")
        for s in done:
            if (s.req.sampling != SamplingParams(**SAMPLING) or len(s.out) != 32
                    or not all(0 <= t < cfg.vocab_size for t in s.out)):
                raise AssertionError(f"sampled {name} rid {s.req.rid}: {s.req.sampling}, "
                                     f"output {s.out}")
        if eng.paged:
            eng._pager.check()
        streams[name] = [s.out for s in done]
        runs[name] = summary
        if name == "dense":
            result["sampled_decode_profile"] = profile_decode(torch, model, run.params,
                                                              sample=True)
            greedy_prof = profile_decode(torch, model, run.params)
        del run, model, eng, done
        torch.cuda.empty_cache()
    same_repeat = sum(a == b for a, b in zip(streams["dense"], streams["repeat"]))
    same_paged = sum(a == b for a, b in zip(streams["dense"], streams["paged"]))
    # the draw alone: fold_in + sample_tokens on (4, 64000) bf16 logits
    dev = torch.device("cuda")
    logits = torch.randn(4, 64000, device=dev).to(torch.bfloat16)
    keys = prng.fold_in(prng.PRNGKey(0, dev).expand(4, 2), torch.arange(4, device=dev))
    pos = torch.full((4,), 70, dtype=torch.int32, device=dev)
    temps = torch.full((4,), SAMPLING["temperature"], device=dev)
    topks = torch.full((4,), SAMPLING["top_k"], dtype=torch.int64, device=dev)
    timer = Timer(dev)
    draw_ms = timer.ms(lambda: sample_tokens(logits, prng.fold_in(keys, pos), temps, topks))
    argmax_ms = timer.ms(lambda: torch.argmax(logits, dim=-1))
    prof, base = result.get("sampled_decode_profile"), greedy_prof
    added = None
    if prof and base:
        added = {"bare_wall_ms": prof["bare_wall_ms"] - base["bare_wall_ms"],
                 "wall_ms": prof["wall_ms"] - base["wall_ms"],
                 "device_busy_ms": prof["device_busy_ms"] - base["device_busy_ms"]}
    for name, r in runs.items():
        log(f"  sampled {name}: decode {r['decode_tok_s']:.1f} tok/s, prefill "
            f"{r['prefill_tok_s']:.1f} tok/s (phase 3 greedy at 48 layers, same call: "
            f"{greedy['decode_tok_s']:.1f}, {greedy['prefill_tok_s']:.1f})")
    log(f"  streams: repeat {same_repeat}/8 and paged {same_paged}/8 identical to the dense "
        f"sampled streams")
    log(f"  the draw alone (fold_in + sample_tokens, 4 x 64000 bf16, top-k 40): "
        f"{draw_ms:.4f} ms on the card (argmax {argmax_ms:.4f} ms); added to a decode "
        f"step against the same model's greedy profile: {added}")
    result["sampled"] = {"argv": SAMPLED_ARGV, "runs": runs,
                         "identical_repeat": same_repeat, "identical_paged": same_paged,
                         "draw_ms": draw_ms,
                         "argmax_ms": argmax_ms, "added_per_decode_step": added}
    if same_repeat != 8 or same_paged != 8:
        raise AssertionError("sampled streams differ between runs with the same seed "
                             "or between the dense and paged paths")


MOE_ARGV = ["--arch", "moonshot-v1-16b-a3b", "--quant", "pofx8", "--kv-quant", "fxp8",
            "--use-kernel"] + cut("moonshot-v1-16b-a3b")
# phase 9's depths: the CLI and the paged engine serve the first 12 layers; the
# f32 kernels-vs-plain check takes the first 2, the sampled repeat the first 4
MOE_IDENTITY_LAYERS, MOE_SAMPLED_LAYERS = 2, 2


def truncated(model, params, n_layers, enc_layers=None, **rcfg):
    """The model on its first ``n_layers`` layers' weights (and, encdec,
    the first ``enc_layers`` encoder layers'; embed, unembed and the norms
    as they are), run config fields replaced by ``rcfg``."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    sub_params = dict(params, blocks=params["blocks"][:n_layers])
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, n_enc_layers=enc_layers)
        sub_params["enc_blocks"] = params["enc_blocks"][:enc_layers]
    sub = dataclasses.replace(model, cfg=cfg, rcfg=dataclasses.replace(model.rcfg, **rcfg))
    return sub, sub_params


def phase_moe(torch, result):
    """Phase 9: MoE serving of moonshot-v1-16b-a3b at full width. The CLI
    on its first 12 layers with its defaults (launch counts, 32 in-vocab tokens a
    request, first-token logits against the plain path, a decode-step
    profile with the MoE FFN split out); then, on the same weights, the
    paged engine (page size 16: the dense streams), kernels against plain
    versions at f32 on the first 2 layers (identical greedy streams) and a
    sampled run and its repeat on the first 2 (identical streams)."""
    import repro_torch.nn.moe as moe_mod
    import repro_torch.nn.transformer as T
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch.engine import SamplingParams, ServeEngine
    from repro_torch.launch.serve import make_requests
    run, counts, summary = serve_cli_run(torch, MOE_ARGV, "MoE path")
    model, params, eng, done = run.model, run.params, run.engine, run.done
    cfg = model.cfg
    st = eng.stats()
    per_fwd = 7 * cfg.n_layers + 1
    want = {"pofx_matmul": per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"]),
            "kv_flash_decode": cfg.n_layers * st["decode_steps"],
            "kv_flash_paged_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    if counts != want or counts["kv_flash_decode"] <= 0:
        raise AssertionError(f"MoE launch counts {counts} != expected {want}")
    if (cfg.name != "moonshot-v1-16b-a3b" or cfg.n_layers != CUT_LAYERS[cfg.name]
            or cfg.d_model != 2048
            or len(done) != 8):
        raise AssertionError(f"MoE path ran {cfg.name}, {cfg.n_layers} layers, "
                             f"d={cfg.d_model}, {len(done)} requests")
    for s in done:
        if len(s.out) != 32 or not all(0 <= t < cfg.vocab_size for t in s.out):
            raise AssertionError(f"MoE rid {s.req.rid}: bad output {s.out}")
    prompt = run.requests[0].prompt
    lk = first_logits(torch, model, params, prompt)
    lp = first_logits(torch, dataclasses.replace(model, kernel_set=PLAIN), params, prompt)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite MoE first-token logits")
    diff = (lk - lp).abs().max().item()
    log(f"  first-token logits, kernels vs plain path: max |diff| {diff:.4g} "
        f"(|logits| <= {lp.abs().max().item():.4g}, bf16 activations), "
        f"argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    # the MoE FFN (router, dispatch, expert products, combine, shared
    # experts) and, inside it, the shared experts' MLP (pofx_matmul)
    prof = profile_decode(torch, model, params, regions={
        "moe_ffn": (T, "moe_forward"), "moe_shared": (moe_mod, "mlp_forward")})
    if prof:
        prof["expert_path_ms"] = prof["region_ms"]["moe_ffn"] - prof["region_ms"]["moe_shared"]
        log(f"  expert path (MoE FFN less its shared experts): "
            f"{prof['expert_path_ms']:.3f} ms a step")
    streams = [s.out for s in done]
    entry = dict(summary, first_logit_max_abs_diff=diff, decode_profile=prof)

    # 2. the paged engine on the same model and weights
    reset_launches()
    peng = ServeEngine(model, params, n_slots=4, max_len=96, chunk=8, paged=True,
                       page_size=16)
    pdone = peng.run(make_requests(cfg.vocab_size, 8, 64, 32))
    torch.cuda.synchronize()
    pcounts, pst = dict(LAUNCHES), peng.stats()
    peng._pager.check()
    pwant = {"pofx_matmul": per_fwd * (pst["prefill_sampled_tokens"] + pst["decode_steps"]),
             "kv_flash_paged_decode": cfg.n_layers * pst["decode_steps"],
             "kv_flash_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    same_paged = sum(a.out == b for a, b in zip(pdone, streams))
    log(f"  paged (page 16): {same_paged}/8 streams identical to the dense CLI run's; "
        f"launches {pcounts}; decode {pst['decode_tok_per_s']:.2f} tok/s; prefix hits "
        f"{pst['prefix_hits']}/{pst['prefix_queries']}")
    entry["paged"] = {"identical_to_dense": same_paged, "launches": pcounts,
                      "decode_tok_s": pst["decode_tok_per_s"], "decode_s": peng.decode_time,
                      "prefill_s": peng.prefill_time, "decode_steps": pst["decode_steps"]}
    del peng
    if pcounts != pwant:
        raise AssertionError(f"MoE paged launch counts {pcounts} != expected {pwant}")
    if same_paged != 8:
        raise AssertionError("MoE paged streams differ from the dense ones")

    # 3. kernels vs plain versions at f32, the first layers
    small, sparams = truncated(model, params, MOE_IDENTITY_LAYERS,
                               activation_dtype="f32")
    reset_launches()
    _, done_k, _ = serve(torch, small, sparams)
    kcounts = dict(LAUNCHES)
    _, done_p, _ = serve(torch, dataclasses.replace(small, kernel_set=PLAIN), sparams)
    same = compare(done_k, done_p, "plain")
    log(f"  identity ({MOE_IDENTITY_LAYERS} layers, f32): {same}/8 streams identical to "
        f"the plain path; launches {kcounts}")
    entry["identity"] = {"n_layers": MOE_IDENTITY_LAYERS, "identical_streams": same,
                         "launches": kcounts}
    if same != 8 or kcounts["pofx_matmul"] <= 0 or kcounts["kv_flash_decode"] <= 0:
        raise AssertionError("MoE kernel streams differ from the plain path's")

    # 4. a sampled run and its repeat
    sub, subp = truncated(model, params, MOE_SAMPLED_LAYERS)
    sp = SamplingParams(**SAMPLING)
    t0 = time.perf_counter()
    _, first, _ = serve(torch, sub, subp, sampling=sp)
    _, again, _ = serve(torch, sub, subp, sampling=sp)
    same_s = sum(a.out == b.out for a, b in zip(first, again))
    log(f"  sampled ({MOE_SAMPLED_LAYERS} layers, temperature 0.8, top-k 40): repeat "
        f"{same_s}/8 streams identical ({time.perf_counter() - t0:.1f}s for both)")
    entry["sampled"] = {"n_layers": MOE_SAMPLED_LAYERS, "identical_repeat": same_s,
                        "streams": [s.out for s in first]}
    result["moe"] = entry
    if same_s != 8 or any(len(s.out) != 32 for s in first):
        raise AssertionError("MoE sampled streams differ between runs with the same seed")
    del run, model, params, eng, small, sparams, sub, subp
    torch.cuda.empty_cache()
    return counts


# (arch, layers, d_model, pofx_matmul launches a forward, kv_flash_decode
# launches a decode step)
SSM_ARCHS = {10: ("falcon-mamba-7b", 16, 4096, 16 * 2 + 1, 0),
             11: ("zamba2-1.2b", 14, 2048, 14 * 2 + 3 * 6 + 1, 3)}
# the f32 kernels-vs-plain check's depth; the CLI serves every layer, the
# sampled run and its repeat the first SSM_SAMPLED_LAYERS (zamba2's 7: two
# applications of the shared block; every layer until the time limit
# needed the room for the sequence-parallel runs of phases 17 and 19)
SSM_IDENTITY_LAYERS = 2
SSM_SAMPLED_LAYERS = {"falcon-mamba-7b": 8, "zamba2-1.2b": 7}


def phase_ssm(torch, result, arch, n_layers, d_model, want_pofx, want_kv):
    """Phases 10 and 11: ssm (falcon-mamba-7b) and hybrid (zamba2-1.2b)
    serving at full width on ``n_layers`` layers through the serving CLI
    with MAIN_ARGV's flags and its defaults. Launch counts (in_proj and out_proj
    a mamba layer, q/k/v/o, wi and wo a shared-block application, the
    unembed; one kv_flash_decode a shared-block application and decode
    step), 32 in-vocab tokens a request, first-token logits against the
    plain path, a decode-step profile with the plain mixer in a
    ``record_function`` range, the ``--paged`` refusal; then, on the same
    weights, kernels against plain versions at f32 on the first layers
    (identical greedy streams) and a sampled run against its repeat on the
    first SSM_SAMPLED_LAYERS (identical streams)."""
    import repro_torch.nn.ssm as ssm_mod
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.engine import SamplingParams
    argv = ["--arch", arch] + MAIN_ARGV[2:] + cut(arch)
    run, counts, summary = serve_cli_run(torch, argv, f"{arch} path")
    model, params, eng, done = run.model, run.params, run.engine, run.done
    cfg = model.cfg
    st = eng.stats()
    n_attn = len(model._hybrid_chunks()) if cfg.family == "hybrid" else 0
    per_fwd = 2 * cfg.n_layers + 6 * n_attn + 1
    want = {"pofx_matmul": per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"]),
            "kv_flash_decode": n_attn * st["decode_steps"],
            "kv_flash_paged_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    log(f"  {per_fwd} pofx_matmul a forward, {n_attn} kv_flash_decode a decode step")
    if counts != want or counts["pofx_matmul"] <= 0:
        raise AssertionError(f"{arch} launch counts {counts} != expected {want}")
    if per_fwd != want_pofx or n_attn != want_kv:
        raise AssertionError(f"{arch}: {per_fwd} pofx_matmul a forward, {n_attn} "
                             "shared-block applications")
    if (cfg.name != arch or cfg.n_layers != n_layers or cfg.d_model != d_model
            or len(done) != 8):
        raise AssertionError(f"{arch} path ran {cfg.name}, {cfg.n_layers} layers, "
                             f"d={cfg.d_model}, {len(done)} requests")
    for s in done:
        if len(s.out) != 32 or not all(0 <= t < cfg.vocab_size for t in s.out):
            raise AssertionError(f"{arch} rid {s.req.rid}: bad output {s.out}")
    prompt = run.requests[0].prompt
    lk = first_logits(torch, model, params, prompt)
    lp = first_logits(torch, dataclasses.replace(model, kernel_set=PLAIN), params, prompt)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"non-finite {arch} first-token logits")
    diff = (lk - lp).abs().max().item()
    log(f"  first-token logits, kernels vs plain path: max |diff| {diff:.4g} "
        f"(|logits| <= {lp.abs().max().item():.4g}, bf16 activations), "
        f"argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    mixer = "mamba1_mix" if cfg.family == "ssm" else "mamba2_mix"
    prof = profile_decode(torch, model, params, regions={"mixer": (ssm_mod, mixer)})
    entry = dict(summary, first_logit_max_abs_diff=diff, decode_profile=prof,
                 pofx_per_forward=per_fwd, kv_flash_per_step=n_attn)
    try:
        serve_cli.main(argv + ["--paged"])
        refused = False
    except SystemExit as e:
        refused = e.code not in (0, None)
    log(f"  --paged refused: {refused}")
    entry["paged_refused"] = refused
    if not refused:
        raise AssertionError(f"{arch}: --paged was not refused")

    # kernels vs plain versions at f32, the first layers
    small, sparams = truncated(model, params, SSM_IDENTITY_LAYERS, activation_dtype="f32")
    reset_launches()
    _, done_k, _ = serve(torch, small, sparams)
    kcounts = dict(LAUNCHES)
    _, done_p, _ = serve(torch, dataclasses.replace(small, kernel_set=PLAIN), sparams)
    same = compare(done_k, done_p, "plain")
    log(f"  identity ({SSM_IDENTITY_LAYERS} layers, f32): {same}/8 streams identical to "
        f"the plain path; launches {kcounts}")
    entry["identity"] = {"n_layers": SSM_IDENTITY_LAYERS, "identical_streams": same,
                         "launches": kcounts}
    if same != 8 or kcounts["pofx_matmul"] <= 0 or (
            n_attn and kcounts["kv_flash_decode"] <= 0):
        raise AssertionError(f"{arch} kernel streams differ from the plain path's")

    # a sampled run and its repeat on the first layers
    n_s = SSM_SAMPLED_LAYERS[arch]
    sub, subp = truncated(model, params, n_s)
    sp = SamplingParams(**SAMPLING)
    t0 = time.perf_counter()
    _, first, _ = serve(torch, sub, subp, sampling=sp)
    _, again, _ = serve(torch, sub, subp, sampling=sp)
    same_s = sum(a.out == b.out for a, b in zip(first, again))
    log(f"  sampled ({n_s} layers, temperature 0.8, top-k 40): repeat "
        f"{same_s}/8 streams identical ({time.perf_counter() - t0:.1f}s for both)")
    entry["sampled"] = {"n_layers": n_s, "identical_repeat": same_s,
                        "streams": [s.out for s in first]}
    result[arch] = entry
    if same_s != 8 or any(len(s.out) != 32 for s in first):
        raise AssertionError(f"{arch} sampled streams differ between runs with the same seed")
    del run, model, params, eng, small, sparams, sub, subp
    torch.cuda.empty_cache()
    return counts


ENCDEC_ARGV = ["--arch", "whisper-medium"] + MAIN_ARGV[2:]
# the f32 kernels-vs-plain check's depth (encoder and decoder layers); the
# CLI and the repeat run every layer
ENCDEC_IDENTITY_LAYERS = 2


def phase_encdec(torch, result):
    """Phase 12: whisper-medium through the serving CLI with ENCDEC_ARGV
    and its defaults, i.e. the reference's one-shot loop at full width and
    depth. Exact launch counts (385 pofx_matmul in the prefill: q/k/v/o and
    wi/wo a encoder layer; self q/k/v/o, cross q/k/v/o and wi/wo a decoder
    layer; the unembed. 193 a decode step: the cross K/V come from the
    static cache. The cross cache's own two products a layer take the plain
    path, as in the reference, and launch nothing), 4 x 32 in-vocab tokens,
    finite logits; first-token logits against the plain path; kernels
    against plain versions at f32 on the first layers (identical tokens);
    the loop again on the same weights and inputs (identical tokens); a
    decode-step profile with the cross-attention in a ``record_function``
    range."""
    import repro_torch.nn.attention as attn_mod
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch import serve as serve_cli
    torch.cuda.reset_peak_memory_stats()
    log(f"  repro_torch.launch.serve {' '.join(ENCDEC_ARGV)}")
    reset_launches()
    run = serve_cli.main(ENCDEC_ARGV)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, params, leg = run.model, run.params, run.legacy
    cfg = model.cfg
    B, P = leg.prompts.shape
    gen = leg.tokens.shape[1]
    per_prefill = 6 * cfg.n_enc_layers + 10 * cfg.n_layers + 1
    per_step = 8 * cfg.n_layers + 1
    want = {"pofx_matmul": per_prefill + (gen - 1) * per_step, "kv_flash_decode": 0,
            "kv_flash_paged_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    log(f"  launches: {counts}; expected {per_prefill} in the prefill + {gen - 1} x "
        f"{per_step} = {want['pofx_matmul']}")
    if (cfg.name, cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.padded_vocab) != ("whisper-medium", 24, 24, 1024, 16, 4096, 51968):
        raise AssertionError(f"encdec path ran {cfg}")
    if (B, P, gen) != (4, 64, 32) or want["pofx_matmul"] != 6368 or counts != want:
        raise AssertionError(f"encdec launch counts {counts} != expected {want} "
                             f"(B={B}, P={P}, gen={gen})")
    toks = leg.tokens
    if run.engine is not None or model.kv_spec is not None or leg.frames is None:
        raise AssertionError("whisper was not served by the one-shot loop with a bf16 cache")
    if not (((0 <= toks) & (toks < cfg.vocab_size)).all() and torch.isfinite(leg.logits).all()):
        raise AssertionError(f"bad encdec output: {toks.tolist()}")
    summary = {"argv": ENCDEC_ARGV, "arch": cfg.name, "n_layers": cfg.n_layers,
               "n_enc_layers": cfg.n_enc_layers, "batch": B, "prompt_len": P, "gen": gen,
               "prefill_s": leg.prefill_s, "decode_s": leg.decode_s,
               "prefill_tok_s": B * P / leg.prefill_s,
               "decode_tok_s": (gen - 1) * B / leg.decode_s, "launches": counts,
               "pofx_per_prefill": per_prefill, "pofx_per_decode_step": per_step,
               "peak_gib": peak}
    log(f"  one-shot loop: prefill {B}x{P} tokens in {leg.prefill_s:.3f}s "
        f"({summary['prefill_tok_s']:.1f} tok/s), decode {gen - 1} steps x {B} in "
        f"{leg.decode_s:.3f}s ({summary['decode_tok_s']:.1f} tok/s), peak {peak:.2f} GiB "
        f"(init included)")
    prompts, frames = leg.prompts.cuda(), leg.frames.cuda()

    def first(m, p):
        cache = m.init_cache(B, P + 1, enc_len=P)
        return m.prefill(p, prompts, cache=cache, frames=frames)[1].float()

    lk, lp = first(model, params), first(dataclasses.replace(model, kernel_set=PLAIN), params)
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        raise AssertionError("non-finite encdec first-token logits")
    diff = (lk - lp).abs().max().item()
    same_argmax = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    log(f"  first-token logits, kernels vs plain path: max |diff| {diff:.4g} "
        f"(|logits| <= {lp.abs().max().item():.4g}, bf16 activations), argmax "
        f"{lk.argmax(-1).tolist()} vs {lp.argmax(-1).tolist()}; the CLI's first tokens "
        f"{toks[:, 0].tolist()}")
    cache = model.init_cache(B, P + gen, enc_len=P)
    cache, _ = model.prefill(params, prompts, cache=cache, frames=frames)
    prof = profile_decode(torch, model, params, cache=cache,
                          regions={"cross_attn": (attn_mod, "_cross_attn")})
    bf16_check = bf16_compute_check(torch, model, params, cache)
    del cache
    entry = dict(summary, first_logit_max_abs_diff=diff, first_argmax_agree=same_argmax,
                 decode_profile=prof, tokens=toks.tolist(), bf16_compute=bf16_check)
    if same_argmax != B or toks[:, 0].tolist() != lk.argmax(-1).tolist():
        raise AssertionError("encdec first tokens differ between kernels, plain and the CLI")

    # kernels vs plain versions at f32, the first encoder and decoder layers
    n = ENCDEC_IDENTITY_LAYERS
    small, sparams = truncated(model, params, n, enc_layers=n, activation_dtype="f32")
    reset_launches()
    got_k = serve_cli.legacy_loop(small, sparams, prompts, frames, gen)[0]
    kcounts = dict(LAUNCHES)
    got_p = serve_cli.legacy_loop(dataclasses.replace(small, kernel_set=PLAIN), sparams,
                                  prompts, frames, gen)[0]
    same = int((got_k == got_p).all(axis=1).sum())
    log(f"  identity ({n} + {n} layers, f32): {same}/{B} streams identical to the plain "
        f"path; launches {kcounts}")
    entry["identity"] = {"n_layers": n, "n_enc_layers": n, "identical_streams": same,
                         "launches": kcounts}
    if same != B or kcounts["pofx_matmul"] != 6 * n + 10 * n + 1 + (gen - 1) * (8 * n + 1):
        raise AssertionError("encdec kernel streams differ from the plain path's")

    # the loop again at full depth on the same weights and inputs
    t0 = time.perf_counter()
    again = serve_cli.legacy_loop(model, params, prompts, frames, gen)[0]
    same_r = int((again == toks).all(axis=1).sum())
    log(f"  repeat ({cfg.n_layers} + {cfg.n_enc_layers} layers): {same_r}/{B} streams "
        f"identical ({time.perf_counter() - t0:.1f}s)")
    entry["identical_repeat"] = same_r
    result["whisper-medium"] = entry
    if same_r != B:
        raise AssertionError("the encdec repeat differs from the CLI run")
    del run, model, params, leg, small, sparams, prompts, frames
    torch.cuda.empty_cache()
    return counts


def bf16_compute_check(torch, model, params, cache):
    """Phase 12's check of ``RunConfig.serve_bf16_compute`` on the card: one
    decode step of the full model from its prefilled bf16 caches with the
    flag set, in which every ``decode_attention`` call (each decoder
    layer's self-attention, then its static cross cache) must take it, and
    the same step without it; then ``decode_attention(..., bf16_compute=
    True)`` on layer 0's cross cache and a seeded q against the reference's
    formula computed in float64 on the card: q and the probabilities
    rounded to bf16, products summed exactly. The output must lie within
    2^-8 of the largest |v| of the formula (a probability whose f32 value
    sits at a bf16 rounding boundary may round the other way in the two
    computations, and the probabilities sum to 1) and nearer to it than to
    the formula without the rounding. Returns the readings."""
    import repro_torch.nn.attention as attn_mod
    calls = []
    orig = attn_mod.decode_attention

    def spy(*args, bf16_compute=False, **kw):
        calls.append(bool(bf16_compute))
        return orig(*args, bf16_compute=bf16_compute, **kw)

    B = cache["kv"]["k"].shape[1]
    dev = cache["kv"]["k"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tokens = torch.zeros((B, 1), dtype=torch.long, device=dev)
    flagged = dataclasses.replace(model, rcfg=dataclasses.replace(model.rcfg,
                                                                  serve_bf16_compute=True))
    attn_mod.decode_attention = spy
    try:
        sync()
        t0 = time.perf_counter()
        lb = flagged.decode_step(params, cache, tokens)[1].float()
        sync()
        step_s = time.perf_counter() - t0
    finally:
        attn_mod.decode_attention = orig
    lf = model.decode_step(params, cache, tokens)[1].float()
    k, v, n = cache["cross"]["k"][0], cache["cross"]["v"][0], cache["xlen"]
    G, Dh = k.shape[1], k.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, 1, G, 1, Dh), generator=gen, device=dev)
    got = orig(q, k, v, n, bf16_compute=True).double()

    def formula(rounded):
        rnd = (lambda t: t.to(torch.bfloat16).double()) if rounded else (lambda t: t.double())
        s = torch.einsum("bqgrd,bgsd->bgrqs", rnd(q), k.double()) * Dh ** -0.5
        valid = torch.arange(k.shape[2], device=dev) < n
        p = torch.softmax(torch.where(valid, s, torch.full_like(s, -1e30)), dim=-1)
        return torch.einsum("bgrqs,bgsd->bqgrd", rnd(p.float()), v.double())

    err, err_f32 = ((got - formula(r)).abs().max().item() for r in (True, False))
    bound = 2.0 ** -8 * v.double().abs().max().item()
    out = {"calls": len(calls), "calls_flagged": sum(calls), "step_s": step_s,
           "logit_max_abs_diff_flag_on_off": (lb - lf).abs().max().item(),
           "formula_max_abs_err": err, "bound": bound, "unrounded_max_abs_err": err_f32}
    log(f"  serve_bf16_compute: a decode step with the flag ({step_s * 1e3:.1f} ms) made "
        f"{len(calls)} decode_attention calls, {sum(calls)} with bf16 q and p; logits moved "
        f"by at most {out['logit_max_abs_diff_flag_on_off']:.4g} against the flag off; layer "
        f"0's cross cache: within {err:.3g} of the bf16 formula (bound {bound:.3g}), "
        f"{err_f32:.3g} of the f32 one")
    want_calls = [True, True] * model.cfg.n_layers
    if calls != want_calls or not torch.isfinite(lb).all():
        raise AssertionError(f"serve_bf16_compute: decode_attention took {calls}, "
                             f"expected {want_calls}")
    if not (err <= bound and err < err_f32):
        raise AssertionError(f"serve_bf16_compute: the card's bf16 path is {err} off its "
                             f"formula (bound {bound}; the unrounded formula {err_f32} off)")
    return out


# phase 13: the CLI at full width on 12 layers (its last step profiled, so
# steps 1-3 are timed bare), f32 moments at 2 layers, oracles and the
# checkpoint round trip at 2
TRAIN_ARGV = ["--arch", "yi-9b", "--opt-quant", "posit8", "--steps", "5",
              "--log-every", "1", "--profile"] + cut("yi-9b")
TRAIN_F32_LAYERS, TRAIN_SMALL_LAYERS = 2, 2
BF16_PEAK = 989e12        # dense bf16 FLOP/s of one H100 SXM (data sheet)
GRAD_RTOL = 1e-4          # LM.loss gradients, flash vs materialized softmax, f32
SDPA_RTOL = 2e-2          # flash vs SDPA at bf16, of each output's largest value
MICRO_ATOL = 5e-3         # microbatch 2 vs 1 loss (the reference's test's bound)


def naive_attention(torch, q, k, v, *, causal, q_chunk, kv_chunk, bias_offset=0):
    """Attention through a materialized softmax (autograd's own backward):
    the oracle for the flash Function."""
    Dh, Sq, Skv = q.shape[-1], q.shape[1], k.shape[1]
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float()) * Dh ** -0.5
    if causal:
        keep = (torch.arange(Skv, device=q.device)[None, :]
                <= bias_offset + torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v.float()).to(q.dtype)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def train_cli(torch, argv):
    """The training CLI with ``argv`` in a process of its own (its own CUDA
    context; this process's caches emptied first): finite losses and grad
    norms, the median step of steps 1 on (the profiled last step left
    out), tokens/s, the model-FLOP share (8 N T a step: forward, remat's
    forward, backward; N the active parameters), peak memory and the
    profile's split. Returns them."""
    from statistics import median
    from repro_torch.configs import ARCHS, truncate
    arch, steps = argv[argv.index("--arch") + 1], int(argv[argv.index("--steps") + 1])
    layers = int(argv[argv.index("--layers") + 1]) if "--layers" in argv else 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; "
        f"python -m repro_torch.launch.train {' '.join(argv)}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if not line.startswith("train: "):
            log(f"    {line}")
    if proc.returncode:
        raise AssertionError(f"the training CLI exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    run = json.loads(next(l for l in proc.stdout.splitlines() if l.startswith("train: "))[7:])
    cfg = truncate(ARCHS[arch], layers)
    n_params = cfg.active_param_count()
    losses, gnorms = run["loss"], run["grad_norm"]
    if run["steps"] != list(range(steps)) or not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"training CLI: steps {run['steps']}, losses {losses}, "
                             f"grad norms {gnorms}")
    step_s = median(run["step_s"][1:steps - 1 if "--profile" in argv else steps])
    flops = 8 * n_params * run["tokens_per_step"]       # forward, remat's forward, backward
    entry = {"argv": argv, "n_layers": cfg.n_layers, "params": n_params,
             "loss": losses, "grad_norm": gnorms, "step_s": run["step_s"],
             "median_step_ms": step_s * 1e3, "tokens_per_s": run["tokens_per_step"] / step_s,
             "model_flop_share": flops / step_s / BF16_PEAK,
             "peak_gib": run["peak_bytes"] / 2**30, "profile": run.get("profile"),
             "init_s": run["init_s"], "process_s": wall}
    log(f"  {arch} {cfg.n_layers} layers, {n_params / 1e9:.3f} B params, posit8 moments: "
        f"step {entry['median_step_ms']:.1f} ms (median of steps 1 on), "
        f"{entry['tokens_per_s']:.1f} tokens/s, model-FLOP share "
        f"{100 * entry['model_flop_share']:.2f} % of {BF16_PEAK / 1e12:.0f} TFLOP/s, peak "
        f"{entry['peak_gib']:.2f} GiB; losses {[round(x, 4) for x in losses]}; init "
        f"{run['init_s']:.1f} s, the process {wall:.1f} s")
    return entry


def phase_train(torch, result):
    """Phase 13: training. Part 1 is the CLI in its own process; parts 2-4
    run here and must launch none of the port's kernels."""
    import repro_torch.nn.attention as attn_mod
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import named_leaves
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.train import make_train_state, make_train_step, value_and_grad
    from repro_torch.nn.models import build_model
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime import CheckpointManager

    entry = result["train_cli"] = train_cli(torch, TRAIN_ARGV)
    before = dict(LAUNCHES)
    base = ARCHS["yi-9b"]
    dc = DataConfig(vocab_size=base.vocab_size, seq_len=128, global_batch=8)
    batch0 = synthetic_batch(dc, 0)
    # lr 1e-5: the reference's test takes 1e-3 at d_model 128. Adam's first
    # steps move every weight by ~lr whatever its gradient; at d_model 4096
    # (init scale 4096^-0.5 = 0.016) 1e-3 makes the loss rise and 1e-4
    # overshoots within three steps on one batch
    run_kw = dict(learning_rate=1e-5, total_steps=10, warmup_steps=1, remat="block")

    # 2. f32 moments at 2 layers: three steps on one batch, microbatch 2 vs 1
    cfg = dataclasses.replace(base, n_layers=TRAIN_F32_LAYERS)
    model = build_model(cfg, RunConfig(**run_kw), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model, 0)
    step = make_train_step(model)
    metrics = [step(state, batch0)[1] for _ in range(3)]
    losses = [float(m["loss"]) for m in metrics]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    torch.cuda.empty_cache()
    micro = dataclasses.replace(model, rcfg=RunConfig(microbatch=2, **run_kw))
    m2 = make_train_step(micro)(make_train_state(micro, 0), batch0)[1]
    loss2, gn1, gn2 = float(m2["loss"]), float(metrics[0]["grad_norm"]), float(m2["grad_norm"])
    torch.cuda.empty_cache()
    log(f"  f32 moments, {cfg.n_layers} layers ({cfg.param_count() / 1e9:.2f} B params): "
        f"losses {losses} on one batch, peak {peak:.2f} GiB; microbatch 2: loss {loss2:.5f} "
        f"vs {losses[0]:.5f}, grad norm {gn2:.4f} vs {gn1:.4f}")
    entry["f32_moments"] = {"n_layers": cfg.n_layers, "losses": losses, "peak_gib": peak,
                            "microbatch2_loss": loss2, "grad_norm": [gn1, gn2]}
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"f32-moment losses do not fall: {losses}")
    if abs(loss2 - losses[0]) > MICRO_ATOL:
        raise AssertionError(f"microbatch 2 loss {loss2} vs {losses[0]}")
    del model, micro, metrics, m2

    # 3. gradients against oracles: LM.loss at f32 (2 layers), flash vs SDPA at bf16
    cfg = dataclasses.replace(base, n_layers=TRAIN_SMALL_LAYERS)
    model = build_model(cfg, RunConfig(weight_dtype="f32", activation_dtype="f32", **run_kw),
                        device="cuda")
    params = model.init(0)
    names = [n for n, _ in named_leaves(params)]
    loss_f, g_flash = value_and_grad(model, params, batch0)
    flash = attn_mod.flash_attention
    attn_mod.flash_attention = lambda *a, **kw: naive_attention(torch, *a, **kw)
    try:
        loss_n, g_naive = value_and_grad(model, params, batch0)
    finally:
        attn_mod.flash_attention = flash
    errs = {}
    for name, a, b in zip(names, g_flash, g_naive):
        errs[name] = max(errs.get(name, 0.0), rel_err(a, b))
    worst = max(errs.values())
    log(f"  LM.loss gradients, flash Function vs materialized softmax ({cfg.n_layers} layers, "
        f"f32): loss {float(loss_f):.6f} vs {float(loss_n):.6f}, max relative error "
        f"{worst:.3g} (bound {GRAD_RTOL}) over {len(errs)} leaves")
    entry["grad_oracle"] = {"max_rel_err": worst, "per_leaf": errs}
    if not worst <= GRAD_RTOL:
        raise AssertionError(f"flash gradients off the oracle: {errs}")
    del params, g_flash, g_naive, model
    sdpa = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S in ((8, 128), (1, 2048)):
        G, R, Dh = base.n_kv_heads, base.n_heads // base.n_kv_heads, base.d_head
        mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v, do = mk(B, S, G, R, Dh), mk(B, S, G, Dh), mk(B, S, G, Dh), mk(B, S, G, R, Dh)
        outs = []
        for fn in ("flash", "sdpa"):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            if fn == "flash":
                o = attn_mod.flash_attention(qq, kk, vv, causal=True, q_chunk=1024,
                                             kv_chunk=1024)
            else:
                o = F.scaled_dot_product_attention(
                    qq.reshape(B, S, G * R, Dh).transpose(1, 2),
                    kk.repeat_interleave(R, dim=2).transpose(1, 2),
                    vv.repeat_interleave(R, dim=2).transpose(1, 2),
                    is_causal=True).transpose(1, 2).reshape(B, S, G, R, Dh)
            o.backward(do)
            outs.append((o.detach(), qq.grad, kk.grad, vv.grad))
        errs = {n: rel_err(a, b) for n, a, b in zip(("out", "dq", "dk", "dv"), *outs)}
        sdpa[f"B={B} S={S}"] = errs
        log(f"  flash vs SDPA at bf16 (B={B}, S={S}, G={G}, R={R}, causal): "
            f"{', '.join(f'{n} {e:.3g}' for n, e in errs.items())} (bound {SDPA_RTOL})")
        if max(errs.values()) > SDPA_RTOL:
            raise AssertionError(f"flash off SDPA at B={B} S={S}: {errs}")
    entry["flash_vs_sdpa"] = sdpa

    # 4. checkpoint resume at 2 layers, posit8 moments (bf16 weights)
    model = build_model(cfg, RunConfig(opt_state_quant="posit8", **run_kw), device="cuda")
    step = make_train_step(model)
    ckpt = ROOT / "build" / "phase13_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt), keep=2, async_save=True)

    def run(save=False):
        state, losses, snap = make_train_state(model, 0), [], None
        for i in range(3):
            state, m = step(state, synthetic_batch(dc, i))
            losses.append(m["loss"])
            if save and i == 1:
                mgr.save(i, state)
                snap = [t.clone() for t in state_tensors(state)]
        return losses, snap

    def state_tensors(state):
        out = []
        for leaf in tree_leaves(state["params"]) + tree_leaves(state["opt"]["m"]) \
                + tree_leaves(state["opt"]["v"]) + [state["opt"]["count"]]:
            out += [leaf.codes, leaf.scale] if hasattr(leaf, "codes") else [leaf]
        return out

    try:
        losses_a, snap = run(save=True)
        losses_c, _ = run()
        deterministic = all(torch.equal(a, c) for a, c in zip(losses_a, losses_c))
        restored = mgr.restore(make_train_state(model, 1), 1)
        same_leaves = sum(torch.equal(a, b) for a, b in zip(state_tensors(restored), snap))
        _, m = step(restored, synthetic_batch(dc, 2))
        resumed_equal = torch.equal(m["loss"], losses_a[2])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log(f"  checkpoint ({cfg.n_layers} layers, posit8 moments): two uninterrupted runs "
        f"{'agree bit for bit' if deterministic else 'DIFFER'} "
        f"({[float(x) for x in losses_a]} vs {[float(x) for x in losses_c]}); restored "
        f"{same_leaves}/{len(snap)} tensors equal to the saved state; resumed step 2 loss "
        f"{float(m['loss']):.6f} vs {float(losses_a[2]):.6f} (bit-equal: {resumed_equal})")
    entry["checkpoint"] = {"deterministic": deterministic, "equal_tensors": same_leaves,
                           "tensors": len(snap), "resumed_bit_equal": resumed_equal}
    if not deterministic:
        raise AssertionError("two uninterrupted training runs differ on the card")
    if same_leaves != len(snap) or not resumed_equal:
        raise AssertionError("the checkpoint round trip is not exact")

    # 5. no kernel of the port on the training path
    after = dict(LAUNCHES)
    log(f"  launches in the in-process parts: {({k: after[k] - before[k] for k in after})}")
    if after != before:
        raise AssertionError(f"training launched the port's kernels: {before} -> {after}")
    del model, restored
    torch.cuda.empty_cache()


# phase 14: the other families' training at full width. (a) and (b) the
# CLI in processes of their own (falcon-mamba-7b's last step profiled);
# (c) moonshot on its first MOE_TRAIN_LAYERS layers and (d) whisper on
# WHISPER_TRAIN_LAYERS encoder and decoder layers in-process (both cut to
# keep the script within its time limit); (e) card against CPU gradients at
# ORACLE_LAYERS layers
FALCON_TRAIN_ARGV = ["--arch", "falcon-mamba-7b", "--opt-quant", "posit8", "--steps", "4",
                     "--log-every", "1", "--profile"] + cut("falcon-mamba-7b")
ZAMBA_TRAIN_ARGV = ["--arch", "zamba2-1.2b", "--opt-quant", "posit8", "--steps", "3",
                    "--log-every", "1"] + cut("zamba2-1.2b")
MOE_TRAIN_LAYERS, WHISPER_TRAIN_LAYERS, FAMILY_TRAIN_STEPS, ORACLE_LAYERS = 2, 6, 3, 2
ORACLE_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b", "moonshot-v1-16b-a3b", "whisper-medium")
CPU_GRAD_RTOL = 1e-4      # card vs CPU gradients, f32, of each leaf's largest entry


def family_batch(torch, cfg, batch, seq, step):
    """The CLI's synthetic batch of ``step``; encdec adds (B, seq, d_model)
    frames drawn as the serving CLI draws them (``normal(PRNGKey(2))``)."""
    from repro_torch.core import prng
    from repro_torch.data import DataConfig, synthetic_batch
    b = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                   global_batch=batch), step)
    if cfg.family == "encdec":
        b["frames"] = prng.normal(prng.PRNGKey(2), (batch, seq, cfg.d_model))
    return b


def train_in_process(torch, model, label, steps=FAMILY_TRAIN_STEPS, batch=8, seq=128):
    """``make_train_state`` and ``steps`` of ``make_train_step`` on the
    CLI's batches (8 x 128 tokens) with posit8 moments: finite losses, the
    median step of steps 1 on, tokens/s, the model-FLOP share, peak
    memory."""
    from statistics import median
    from repro_torch.launch.train import make_train_state, make_train_step
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(model, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(model)
    losses, gnorms, step_s = [], [], []
    for i in range(steps):
        b = family_batch(torch, cfg, batch, seq, i)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))          # waits for the step
        step_s.append(time.perf_counter() - t0)
        gnorms.append(float(m["grad_norm"]))
    n_params = cfg.active_param_count()
    med = median(step_s[1:])
    entry = {"n_layers": cfg.n_layers, "params": n_params, "loss": losses,
             "grad_norm": gnorms, "step_s": step_s, "median_step_ms": med * 1e3,
             "tokens_per_s": batch * seq / med,
             "model_flop_share": 8 * n_params * batch * seq / med / BF16_PEAK,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "init_s": init_s}
    log(f"  {label}: {cfg.n_layers} layers, {n_params / 1e9:.3f} B active params, posit8 "
        f"moments: step {entry['median_step_ms']:.1f} ms (median of steps 1 on), "
        f"{entry['tokens_per_s']:.1f} tokens/s, model-FLOP share "
        f"{100 * entry['model_flop_share']:.2f} %, peak {entry['peak_gib']:.2f} GiB, init "
        f"{init_s:.1f} s; losses {[round(x, 4) for x in losses]}")
    del state
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"{label}: non-finite losses {losses} or grad norms {gnorms}")
    return entry


def family_oracle(torch, arch):
    """At ORACLE_LAYERS layers (encoder too), full width, f32: ``LM.loss``
    gradients on the card against the same model's on the CPU from the
    same parameters (B = 2, 64 tokens), every leaf within CPU_GRAD_RTOL of
    its largest entry; then three steps on one batch (8 x 128) at lr 1e-5
    with f32 moments, whose loss must fall."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import named_leaves
    from repro_torch.launch.train import make_train_state, make_train_step, value_and_grad
    from repro_torch.nn.models import build_model
    from repro_torch.optim import tree_map
    base = ARCHS[arch]
    cfg = dataclasses.replace(base, n_layers=ORACLE_LAYERS,
                              n_enc_layers=ORACLE_LAYERS if base.n_enc_layers else 0)
    rcfg = RunConfig(weight_dtype="f32", activation_dtype="f32", learning_rate=1e-5,
                     total_steps=10, warmup_steps=1, remat="block")
    model = build_model(cfg, rcfg, device="cuda")
    params = model.init(0)
    names = [n for n, _ in named_leaves(params)]
    batch = family_batch(torch, cfg, 2, 64, 0)
    t0 = time.perf_counter()
    loss_c, g_c = value_and_grad(model, params, batch)
    g_c = [g.cpu() for g in g_c]
    cpu = dataclasses.replace(model, device="cpu")
    loss_h, g_h = value_and_grad(cpu, tree_map(lambda t: t.cpu(), params), batch)
    errs = {}
    for name, a, b in zip(names, g_c, g_h):
        errs[name] = max(errs.get(name, 0.0), rel_err(a, b))
    worst_leaf = max(errs, key=errs.get)
    worst = errs[worst_leaf]
    grad_s = time.perf_counter() - t0
    del params, g_c, g_h
    step = make_train_step(model)
    state = make_train_state(model, 0)
    one = family_batch(torch, cfg, 8, 128, 0)
    losses = [float(step(state, one)[1]["loss"]) for _ in range(3)]
    del state
    torch.cuda.empty_cache()
    log(f"  {arch} at {ORACLE_LAYERS} layers, f32: card vs CPU loss {float(loss_c):.6f} vs "
        f"{float(loss_h):.6f}, gradients' max relative error {worst:.3g} ({worst_leaf}) "
        f"over {len(errs)} leaves (bound {CPU_GRAD_RTOL}; {grad_s:.1f} s); one batch at "
        f"lr 1e-5: losses {[round(x, 5) for x in losses]}")
    entry = {"n_layers": ORACLE_LAYERS, "loss_card": float(loss_c), "loss_cpu": float(loss_h),
             "max_rel_err": worst, "worst_leaf": worst_leaf, "per_leaf": errs,
             "one_batch_losses": losses}
    if not worst <= CPU_GRAD_RTOL:
        raise AssertionError(f"{arch}: card gradients off the CPU's: {errs}")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}: the loss on one batch does not fall: {losses}")
    return entry


def phase_train_families(torch, result):
    """Phase 14: training the moe, ssm, hybrid and encdec families at full
    width (a-d), and their gradients on the card against the CPU's (e).
    The in-process parts launch none of the port's kernels."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.nn.models import build_model
    entry = result["train_families"] = {}
    # (a) falcon-mamba-7b, full width, the last step profiled; (b) zamba2-1.2b;
    # each on its first CUT_LAYERS layers
    entry["falcon-mamba-7b"] = train_cli(torch, FALCON_TRAIN_ARGV)
    entry["zamba2-1.2b"] = train_cli(torch, ZAMBA_TRAIN_ARGV)
    if any(entry[a]["n_layers"] != CUT_LAYERS[a] for a in ("falcon-mamba-7b", "zamba2-1.2b")):
        raise AssertionError("the CLI runs did not train the layers asked for")
    before = dict(LAUNCHES)
    # the CLI's run configuration: lr 1e-3, posit8 moments, bf16, block remat
    rcfg = RunConfig(learning_rate=1e-3, total_steps=FAMILY_TRAIN_STEPS, warmup_steps=1,
                     opt_state_quant="posit8", remat="block")
    # (c) moonshot-v1-16b-a3b at full width on its first 2 layers
    cfg = dataclasses.replace(ARCHS["moonshot-v1-16b-a3b"], n_layers=MOE_TRAIN_LAYERS)
    entry["moonshot-v1-16b-a3b"] = train_in_process(
        torch, build_model(cfg, rcfg, device="cuda"), "moonshot-v1-16b-a3b")
    # (d) whisper-medium at full width, batches with frames
    cfg = dataclasses.replace(ARCHS["whisper-medium"], n_layers=WHISPER_TRAIN_LAYERS,
                              n_enc_layers=WHISPER_TRAIN_LAYERS)
    entry["whisper-medium"] = train_in_process(
        torch, build_model(cfg, rcfg, device="cuda"), "whisper-medium")
    # (e) card against CPU, and a falling loss, at 2 layers
    entry["oracles"] = {arch: family_oracle(torch, arch) for arch in ORACLE_ARCHS}
    after = dict(LAUNCHES)
    log(f"  launches in the in-process parts: {({k: after[k] - before[k] for k in after})}")
    if after != before:
        raise AssertionError(f"training launched the port's kernels: {before} -> {after}")


# phase 15: nemotron-4-340b (d_head 192) serving at full width on 2 layers
NEMOTRON_LAYERS = 2
NEMOTRON_LOGIT_RTOL = 1e-3     # kernels vs plain first-token logits at f32, of max |logit|


def phase_nemotron(torch, result):
    """Phase 15: nemotron-4-340b at full width (d_model 18432, 96 query
    heads in 8 groups of 12, d_head 192, squared-ReLU MLP of 73728) on its
    first 2 layers, pofx8 weights, an fxp8 KV cache, kernels on, greedy:
    the CLI's workload (8 requests of 64 tokens, 32 new, 4 slots) through
    the dense engine and then the paged one (16-token pages) on the same
    weights. Launch counts (6 pofx_matmul a layer and the unembed a
    forward; one flash-decode kernel a layer and decode step, at Dh =
    192), identical streams, and first-token logits of kernels against
    the plain path at f32 activations."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import QuantPolicy, parse_spec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.launch.engine import ServeEngine
    from repro_torch.launch.serve import make_requests
    from repro_torch.nn.models import build_model
    cfg = dataclasses.replace(ARCHS["nemotron-4-340b"], n_layers=NEMOTRON_LAYERS)
    model = build_model(cfg, RunConfig(), use_kernel=True, kv_spec=parse_spec("fxp8"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, policy=QuantPolicy.from_string("pofx8"))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    resident = torch.cuda.memory_allocated() / 2**30
    log(f"  {cfg.name}, {cfg.n_layers} layers at d_model {cfg.d_model}, d_head {cfg.d_head}, "
        f"G = {cfg.n_kv_heads}, R = {cfg.n_heads // cfg.n_kv_heads}: pofx8 weights "
        f"{resident:.2f} GiB, init {init_s:.1f} s, init peak {init_peak:.2f} GiB")
    per_fwd = 6 * cfg.n_layers + 1
    reset_launches()
    eng, done, reqs = serve(torch, model, params)
    counts, st = dict(LAUNCHES), eng.stats()
    want = {"pofx_matmul": per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"]),
            "kv_flash_decode": cfg.n_layers * st["decode_steps"],
            "kv_flash_paged_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    n_prompt = sum(len(s.context) for s in done)
    entry = {"n_layers": cfg.n_layers, "d_head": cfg.d_head, "weights_gib": resident,
             "init_s": init_s, "init_peak_gib": init_peak, "launches": counts,
             "decode_steps": st["decode_steps"],
             "prefill_tok_s": n_prompt / eng.prefill_time,
             "decode_tok_s": st["decode_tokens"] / eng.decode_time,
             "streams": [s.out for s in done]}
    log(f"  dense: prefill {entry['prefill_tok_s']:.1f} tok/s, decode "
        f"{entry['decode_tok_s']:.1f} tok/s over {st['decode_steps']} steps; launches {counts}")
    result["nemotron"] = entry
    if counts != want or counts["kv_flash_decode"] <= 0:
        raise AssertionError(f"nemotron launch counts {counts} != expected {want}")
    for s in done:
        if len(s.out) != 32 or not all(0 <= t < cfg.vocab_size for t in s.out):
            raise AssertionError(f"nemotron rid {s.req.rid}: bad output {s.out}")
    del eng
    reset_launches()
    peng = ServeEngine(model, params, n_slots=4, max_len=96, chunk=8, paged=True,
                       page_size=16)
    pdone = peng.run(make_requests(cfg.vocab_size, 8, 64, 32))
    torch.cuda.synchronize()
    pcounts, pst = dict(LAUNCHES), peng.stats()
    peng._pager.check()
    pwant = {"pofx_matmul": per_fwd * (pst["prefill_sampled_tokens"] + pst["decode_steps"]),
             "kv_flash_paged_decode": cfg.n_layers * pst["decode_steps"],
             "kv_flash_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
    same_paged = sum(a.out == b.out for a, b in zip(pdone, done))
    log(f"  paged (page 16): {same_paged}/8 streams identical to the dense ones; launches "
        f"{pcounts}; decode {pst['decode_tok_per_s']:.2f} tok/s")
    entry["paged"] = {"identical_to_dense": same_paged, "launches": pcounts,
                      "decode_tok_s": pst["decode_tok_per_s"]}
    del peng
    if pcounts != pwant:
        raise AssertionError(f"nemotron paged launch counts {pcounts} != expected {pwant}")
    if same_paged != 8:
        raise AssertionError("nemotron paged streams differ from the dense ones")
    # first-token logits, kernels against the plain path, f32 activations
    f32 = dataclasses.replace(model, rcfg=dataclasses.replace(model.rcfg,
                                                              activation_dtype="f32"))
    prompt = reqs[0].prompt
    lk = first_logits(torch, f32, params, prompt)
    lp = first_logits(torch, dataclasses.replace(f32, kernel_set=PLAIN), params, prompt)
    rel = rel_err(lk, lp)
    log(f"  first-token logits at f32, kernels vs plain path: max |diff| / max |logit| "
        f"{rel:.3g} (bound {NEMOTRON_LOGIT_RTOL}), argmax {int(lk.argmax())} vs "
        f"{int(lp.argmax())}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    entry["first_logit_rel_err"] = rel
    entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, params, f32
    torch.cuda.empty_cache()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()) or rel > NEMOTRON_LOGIT_RTOL:
        raise AssertionError(f"nemotron kernel logits off the plain path's: {rel}")
    return counts


# phase 16: tensor-parallel serving, tp = 2. On a one-card machine both ranks
# share cuda:0 over gloo (NCCL refuses two ranks on one device), so no speed-up
# is claimed; (d) reruns (b) over NCCL where each rank has a card of its own.
TP_ARGV = MAIN_ARGV + cut("yi-9b") + ["--tp", "2"]
TP_IDENTITY_LAYERS = 2          # (b), yi-9b width, f32
TP_MOE_LAYERS = 2               # (c), moonshot at f32
TP_ZAMBA_LAYERS = 7             # (c), zamba2: two applications of the shared block
TP_MOE_BF16_LAYERS = 2          # (c), moonshot at bf16, the CLI's workload


def tp_weight_gib(params) -> float:
    """GiB of a rank's parameters: codes and scales, or plain tensors."""
    from repro_torch.core.policy import named_leaves
    from repro_torch.core.quantizers import QuantizedTensor
    n = 0
    for _, leaf in named_leaves(params):
        for t in ((leaf.codes, leaf.scale) if isinstance(leaf, QuantizedTensor) else (leaf,)):
            n += t.numel() * t.element_size()
    return n / 2**30


def tp_cli_hook(run, ctx):
    """Phase 16 (a)'s rank hook, in each rank after the CLI served: the
    rank's weight GiB and a decode-step profile with the all-reduce
    (``TPContext.psum``) in a ``record_function`` range. Every rank
    profiles the same steps (the all-reduces pair up); rank 0 prints."""
    import contextlib
    import torch
    from repro_torch.nn.sharding import TPContext
    gib = tp_weight_gib(run.params)
    out = open(os.devnull, "w") if ctx.rank else contextlib.nullcontext()
    with out as sink, contextlib.redirect_stdout(sink or sys.stdout):
        prof = profile_decode(torch, run.model, run.params,
                              regions={"tp_all_reduce": (TPContext, "psum")})
    return {"rank": ctx.rank, "weight_gib": gib, "profile": prof,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def tp_rank_serve(ctx, device, spec):
    """Phase 16's rank side (in a rank process; at tp = 1 in this one): the
    model of ``spec`` (arch, layers, activation dtype; pofx8 weights from
    seed 1, cut to the rank's shard as they are drawn; an fxp8 KV cache;
    kernels on) served through the engine with the CLI's workload for each
    of ``spec["runs"]``: greedy, sampled (temperature 0.8, top-k 40), paged
    (16-token pages), evict (sampled, rid 0 evicted after its first chunk
    and resumed). Returns {run: {"streams", "launches", stats}}."""
    import torch
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import QuantPolicy, parse_spec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.engine import SamplingParams, ServeEngine
    from repro_torch.launch.serve import make_requests
    from repro_torch.nn.models import build_model
    cfg = dataclasses.replace(ARCHS[spec["arch"]], n_layers=spec["layers"])
    model = build_model(cfg, RunConfig(remat="none", activation_dtype=spec["act"]),
                        device=device, use_kernel=True, kv_spec=parse_spec("fxp8"), tp=ctx)
    params = model.init(1, policy=QuantPolicy.from_string("pofx8"))
    sp = SamplingParams(**SAMPLING)
    out = {"weight_gib": tp_weight_gib(params)}
    for what in spec["runs"]:
        reset_launches()
        if what == "evict":
            eng = ServeEngine(model, params, n_slots=4, max_len=96, chunk=8)
            streams, _ = drive_paging(eng, make_requests(cfg.vocab_size, 8, 64, 32,
                                                         sampling=sp), evict_rid=0)
            streams = [streams[r] for r in sorted(streams)]
            if eng._states[0].n_evictions != 1:
                raise AssertionError("rid 0 was not evicted")
        else:
            eng, done, _ = serve(torch, model, params,
                                 sampling=sp if what == "sampled" else None,
                                 **({"paged": True} if what == "paged" else {}))
            streams = [s.out for s in done]
        torch.cuda.synchronize()
        st = eng.stats()
        out[what] = {"streams": streams, "launches": dict(LAUNCHES),
                     "decode_tok_s": st["decode_tok_per_s"], "decode_steps": st["decode_steps"],
                     "prefill_sampled": st["prefill_sampled_tokens"]}
        del eng
    return out


def tp_compare(torch, spec, label, pool, want=None):
    """``spec`` at tp = 1 in this process (unless ``want`` holds its runs)
    and at tp = 2 in ``pool``: every rank's streams equal rank 0's, and
    each run's streams equal tp = 1's; returns (tp = 1, rank results)."""
    from repro_torch.nn.sharding import TPContext
    one = want or tp_rank_serve(TPContext(), "cuda", spec)
    torch.cuda.empty_cache()
    ranks = pool.run(tp_rank_serve, spec)
    same = {}
    for what in spec["runs"]:
        for r, res in enumerate(ranks):
            if res[what]["streams"] != ranks[0][what]["streams"]:
                raise AssertionError(f"{label} {what}: rank {r} parts from rank 0")
        same[what] = sum(a == b for a, b in zip(ranks[0][what]["streams"], one[what]["streams"]))
    log(f"  {label}: tp=2 streams identical to tp=1: "
        + ", ".join(f"{w} {n}/{len(one[w]['streams'])}" for w, n in same.items())
        + f"; launches a rank {[ranks[0][w]['launches'] for w in spec['runs']]}; "
        f"weights {ranks[0]['weight_gib']:.3f} GiB a rank vs {one['weight_gib']:.3f} at tp=1")
    for what, n in same.items():
        if n != len(one[what]["streams"]):
            raise AssertionError(f"{label} {what}: tp=2 streams differ from tp=1's")
    return one, ranks


def phase_tp(torch, result):
    """Phase 16: tensor-parallel serving at tp = 2. (a) the serving CLI with
    MAIN_ARGV + ``--layers 12 --tp 2`` (yi-9b, full width, bf16): each rank
    launches exactly the tp = 1 counts (85 pofx_matmul a forward, 12
    kv_flash_decode a decode step), prints the backend, tok/s, weight GiB a
    rank and the all-reduce's share of a decode step. (b) at 2 layers, f32, kernels on, fxp8 KV: tp = 2 greedy, sampled,
    paged and evict -> resume streams equal tp = 1's. (c) moonshot on 2
    layers and zamba2 on its first 7 at f32, tp = 2 against tp = 1; then
    moonshot at bf16 on 2 layers with the CLI's workload, its launch
    counts a rank. (d) (b) again over NCCL where there is a card a rank."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.mesh import RankPool, pick_backend
    entry = {}
    # (a) the CLI
    log(f"  repro_torch.launch.serve {' '.join(TP_ARGV)}")
    t0 = time.perf_counter()
    run = serve_cli.main(TP_ARGV, rank_hook=tp_cli_hook)
    wall = time.perf_counter() - t0
    st = run.stats
    n_layers = CUT_LAYERS["yi-9b"]
    per_fwd = 7 * n_layers + 1
    want = {"pofx_matmul": per_fwd * (st["prefill_sampled_tokens"] + st["decode_steps"]),
            "kv_flash_decode": n_layers * st["decode_steps"], "kv_flash_paged_decode": 0,
            "fxp_matmul": 0, "pofx_decode": 0}
    n_prompt = sum(len(s.context) for s in run.done)
    prof = run.rank_hooks[0]["profile"] or {}
    ar_ms = prof.get("region_host_ms", {}).get("tp_all_reduce")
    share = ar_ms / prof["wall_ms"] if ar_ms is not None and prof.get("wall_ms") else None
    a = {"argv": TP_ARGV, "backend": run.backend, "tp": run.tp, "wall_s": wall,
         "launches": run.rank_launches, "prefill_tok_s": n_prompt / st["prefill_time_s"],
         "decode_tok_s": st["decode_tok_per_s"], "decode_steps": st["decode_steps"],
         "weight_gib": [h["weight_gib"] for h in run.rank_hooks],
         "peak_gib": [h["peak_gib"] for h in run.rank_hooks],
         "decode_profile": prof or None, "all_reduce_ms_a_step": ar_ms,
         "all_reduce_share": share,
         "streams": [s.out for s in run.done]}
    log(f"  tp=2 over {run.backend}: prefill {a['prefill_tok_s']:.1f} tok/s, decode "
        f"{a['decode_tok_s']:.1f} tok/s, weights "
        f"{', '.join(f'{g:.2f}' for g in a['weight_gib'])} GiB a rank, peak "
        f"{', '.join(f'{g:.2f}' for g in a['peak_gib'])} GiB a rank; all-reduce "
        + (f"{ar_ms:.2f} ms of a {prof['wall_ms']:.2f} ms decode step ({100 * share:.1f}%)"
           if share is not None else "not measured"))
    log(f"  launches a rank: {run.rank_launches}")
    entry["cli"] = a
    result["tp"] = entry
    for r, counts in enumerate(run.rank_launches):
        if counts != want:
            raise AssertionError(f"tp rank {r} launch counts {counts} != expected {want}")
    if len(run.done) != 8 or any(len(s.out) != 32 for s in run.done):
        raise AssertionError("tp=2 CLI: bad outputs")
    if run.backend != pick_backend(2, "cuda"):
        raise AssertionError(f"tp=2 CLI ran over {run.backend}")
    del run
    # (b), (c): one pool of two ranks for every comparison
    ident = {"arch": "yi-9b", "layers": TP_IDENTITY_LAYERS, "act": "f32",
             "runs": ["greedy", "sampled", "paged", "evict"]}
    with RankPool(2, "cuda") as pool:
        log(f"  ranks over {pool.backend}")
        one, _ = tp_compare(torch, ident, f"yi-9b {TP_IDENTITY_LAYERS} layers f32", pool)
        entry["identity_4l"] = {"backend": pool.backend, "tp1": one}
        tp_compare(torch, {"arch": "moonshot-v1-16b-a3b", "layers": TP_MOE_LAYERS,
                           "act": "f32", "runs": ["greedy"]},
                   f"moonshot {TP_MOE_LAYERS} layers f32", pool)
        tp_compare(torch, {"arch": "zamba2-1.2b", "layers": TP_ZAMBA_LAYERS,
                           "act": "f32", "runs": ["greedy"]},
                   f"zamba2 {TP_ZAMBA_LAYERS} layers f32", pool)
        moe = pool.run(tp_rank_serve, {"arch": "moonshot-v1-16b-a3b",
                                       "layers": TP_MOE_BF16_LAYERS, "act": "bf16",
                                       "runs": ["greedy"]})
        g = [res["greedy"] for res in moe]
        mwant = {"pofx_matmul": (7 * TP_MOE_BF16_LAYERS + 1)
                 * (g[0]["prefill_sampled"] + g[0]["decode_steps"]),
                 "kv_flash_decode": TP_MOE_BF16_LAYERS * g[0]["decode_steps"],
                 "kv_flash_paged_decode": 0, "fxp_matmul": 0, "pofx_decode": 0}
        log(f"  moonshot {TP_MOE_BF16_LAYERS} layers bf16: decode "
            f"{g[0]['decode_tok_s']:.2f} tok/s; launches a rank {[x['launches'] for x in g]}; "
            f"weights {moe[0]['weight_gib']:.2f} GiB a rank")
        entry["moe_bf16"] = {"layers": TP_MOE_BF16_LAYERS, "decode_tok_s": g[0]["decode_tok_s"],
                             "launches": [x["launches"] for x in g],
                             "weight_gib": moe[0]["weight_gib"]}
        if any(x["launches"] != mwant for x in g) or g[0]["streams"] != g[1]["streams"]:
            raise AssertionError(f"moonshot bf16 tp=2: launches {[x['launches'] for x in g]} "
                                 f"!= {mwant}, or the ranks' streams differ")
    # (d) NCCL, one card a rank
    if torch.cuda.device_count() >= 2:
        with RankPool(2, "cuda") as pool:
            if pool.backend != "nccl":
                raise AssertionError(f"two cards, but the ranks took {pool.backend}")
            tp_compare(torch, ident, f"NCCL: yi-9b {TP_IDENTITY_LAYERS} layers f32", pool,
                       want=one)
        entry["nccl"] = "ran"
    else:
        log(f"  NCCL not run: {torch.cuda.device_count()} card(s), it needs one a rank")
        entry["nccl"] = "not run"
    torch.cuda.empty_cache()


# phase 17: training the dense family across ranks. (a) on the card that the
# run has: yi-9b at full width on GRID_LAYERS layers (1: at 2, with phase 19
# beside it, the whole script came too near its time limit), f32, three steps at tp = 1 in this process,
# then on the (data 2, model 2) grid and on the (pod 2, model 2) grid with
# posit8_ef, four rank processes over gloo; (b) where there are four cards,
# full-depth yi-9b on (data 2, model 2) over NCCL with the train CLI's
# workload.
# phases 17, 19 and 21 run their ranks in one pool of four, which ``main``
# starts before the first of them: one start of four rank processes in
# place of three
GRID_POOL_PHASES = (17, 19, 21)
GRID_POOL_GRIDS = [(1, 2, 2), (2, 1, 2)]


def release_rank(ctx, device):
    """A rank's CUDA cache emptied (at the end of each grid phase, so that
    the phases in between find the card free)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


GRID_LAYERS = 1
GRID_STEPS = 3
GRID_TIMED_STEP = 1             # the step whose collectives are timed (its wall time is not kept)
GRID_RTOL = 1e-4                # losses and grad norms (relative), params (of the leaf's largest)
GRID_CODE_SHARE = 1e-3          # the share of moment codes that may differ from tp = 1's
GRID_RUN = dict(weight_dtype="f32", activation_dtype="f32", learning_rate=1e-5,
                total_steps=GRID_STEPS, warmup_steps=1, remat="block", opt_state_quant="posit8")
GRID_NCCL_RUN = dict(learning_rate=1e-3, total_steps=5, warmup_steps=1, remat="block",
                     opt_state_quant="posit8")
GRID_CHECK_ELEMS = 1 << 18      # (pod) the first elements of each leaf checked on the CPU


def timed_collectives():
    """Host seconds inside the TPContext collectives of this process, by
    kind, while ``acc["on"]`` (into ``acc["s"]``): the card is synchronized
    before and after each, so a collective's time is its own, but the step
    loses its overlap of launches, so only GRID_TIMED_STEP runs so and no
    step time is taken from it. A measurement harness: it patches the class
    in this process only. Returns the accumulator."""
    import torch
    from repro_torch.nn.sharding import TPContext
    acc = {"on": False, "s": {}}
    for name in ("all_reduce", "all_gather", "reduce_scatter", "psum"):
        orig = getattr(TPContext, name)

        def wrap(self, *a, _orig=orig, _name=name, **k):
            if self.size == 1 or not acc["on"]:
                return _orig(self, *a, **k)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _orig(self, *a, **k)
            if out.is_cuda:
                torch.cuda.synchronize()
            acc["s"][_name] = acc["s"].get(_name, 0.0) + time.perf_counter() - t0
            return out
        setattr(TPContext, name, wrap)
    return acc


def grid_pod_check(torch, model, grid, probe, names):
    """(pod branch, step 1) The port's ``posit_compressed_mean`` on the CPU
    over the pods' gradients gathered through the host groups: for every
    leaf (``names``: its reference leaf), its first GRID_CHECK_ELEMS
    elements, scaled by the largest magnitude of the whole reference leaf
    (its layers and its shards, taken on the CPU), equal the card's
    compressed mean bit for bit. Returns the elements checked."""
    from repro_torch.launch.train import leaf_groups
    from repro_torch.runtime.compression import posit_compressed_mean
    shards = dict(zip(names, (s.host() for s in leaf_groups(model))))
    pod = grid.axis("pod").host()
    grads, means = probe["pod_grads"], probe["mean_grads"]
    amax = {}
    for g, n in zip(grads, names):
        a = g.float().abs().amax()
        amax[n] = a if n not in amax else torch.maximum(amax[n], a)
    amax = {n: shards[n].all_reduce(a, "max") for n, a in amax.items()}
    checked = 0
    for i, (g, m, n) in enumerate(zip(grads, means, names)):
        k = min(g.numel(), GRID_CHECK_ELEMS)
        got, _ = posit_compressed_mean(g.reshape(-1)[:k], pod, residual=torch.zeros(k),
                                       amax=amax[n])
        if not torch.equal(got, m.reshape(-1)[:k]):
            bad = (got != m.reshape(-1)[:k]).sum().item()
            raise AssertionError(f"rank {grid.rank}: leaf {i} ({n}): {bad} of {k} entries of "
                                 "the card's compressed mean differ from the CPU's")
        checked += k
    return checked


def grid_train_rank(grid, device, spec):
    """Phases 17 and 19's rank side (``grid`` None: tp = 1 in this
    process): ``spec["arch"]`` (yi-9b by default) on ``spec["layers"]``
    layers (and ``spec["enc_layers"]`` encoder layers) with ``spec["run"]``,
    the state drawn from seed 0 (each rank its shard), ``spec["steps"]``
    steps on the train CLI's batches (8 x 128 tokens; ``family_batch``'s
    frames for encdec), each timed; with ``spec["check_pod"]`` the first
    step's compressed mean checked on the CPU (``grid_pod_check``); an MoE
    model counts the assignments its first step's forward drops at
    capacity; with ``spec["ckpt_dir"]`` (a grid) the state after the last
    step is saved there by every rank and restored (``CheckpointManager``
    with ``model=``), the rank's restored shards held to its own bit for
    bit. Returns the metrics, step seconds, the collectives' seconds a kind
    in step GRID_TIMED_STEP (``timed_collectives``), peak GiB, state GiB,
    whether the residual ran sequence-parallel (``LM.seq_ctx`` of the
    batch's 128 positions) and (``spec["state"]``) the parameters after the
    last step and the posit8 moment codes after every step, as numpy arrays
    (a rank's as files in its ``state_dir``)."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.convert import tensor_to_numpy
    from repro_torch.core.policy import named_leaves
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.nn import moe
    from repro_torch.nn.models import build_model
    from repro_torch.optim import tree_leaves
    cfg = dataclasses.replace(ARCHS[spec.get("arch", "yi-9b")], n_layers=spec["layers"],
                              **spec.get("over", {}))
    if spec.get("enc_layers"):
        cfg = dataclasses.replace(cfg, n_enc_layers=spec["enc_layers"])
    model = build_model(cfg, RunConfig(**spec["run"]), device=device, grid=grid)
    seq_parallel = grid is not None and model.seq_ctx(128) is not None
    acc = timed_collectives() if grid is not None else None
    cuda = model.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(model, 0)
    sync()
    params0 = ([p.detach().clone() for p in tree_leaves(state["params"])]
               if spec.get("state") == "initial" else None)
    out = {"init_s": time.perf_counter() - t0, "loss": [], "grad_norm": [], "step_s": [],
           "collective_s": {}, "seq_parallel": seq_parallel, "state_gib": sum(
               t.numel() * t.element_size() for leaf in tree_leaves(state["params"])
               + tree_leaves(state["opt"]["m"]) + tree_leaves(state["opt"]["v"])
               for t in ((leaf.codes, leaf.scale) if hasattr(leaf, "codes") else (leaf,))) / 2**30}
    # the parameters after the last step and the moment codes after every
    # step: tp = 1's as copies on its device, a rank's gigabytes through
    # files (the page cache), not the pool's queue
    out["arrays"], out["scales"] = {}, []
    state_dir = Path(spec.get("state_dir", ".")) / f"r{grid.rank if grid else 0}"

    def keep(tag, trees):
        for k, ts in trees.items():
            if grid is None:
                out["arrays"][k + tag] = [t.detach().clone() for t in ts]
                continue
            state_dir.mkdir(parents=True, exist_ok=True)
            for i, t in enumerate(ts):
                np.save(state_dir / f"{k}{tag}_{i}.npy", tensor_to_numpy(t))

    step = make_train_step(model, grid)
    for s in range(spec["steps"]):
        probe = {} if spec.get("check_pod") and s == 0 else None
        timed = acc is not None and s == GRID_TIMED_STEP
        if timed:
            acc["on"] = True
        batch = family_batch(torch, cfg, 8, 128, s)
        moe.DROPPED = [] if cfg.family == "moe" and s == 0 else None
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch, probe=probe)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        sync()
        out["step_s"].append(time.perf_counter() - t0)
        if moe.DROPPED is not None:
            # the backward's remat recompute repeats each call of the forward
            calls = 2 if model.rcfg.remat == "block" else 1
            out["dropped"] = sum(int(n) for n, _ in moe.DROPPED) // calls
            out["routed"] = sum(n for _, n in moe.DROPPED) // calls
            moe.DROPPED = None
        if timed:
            acc["on"] = False
            out["collective_s"] = dict(acc["s"])
        if spec.get("state"):
            keep(f"s{s}", {k: [q.codes for q in tree_leaves(state["opt"][k])] for k in "mv"})
            out["scales"].append([[float(q.scale.reshape(-1)[0]) for q in
                                   tree_leaves(state["opt"][k])] for k in "mv"])
        if probe is not None:
            t1 = time.perf_counter()
            names = [n for n, _ in named_leaves(state["params"])]
            out["pod_checked"] = grid_pod_check(torch, model, grid, probe, names)
            out["pod_check_s"] = time.perf_counter() - t1
            del probe
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    if grid is not None and spec.get("ckpt_dir"):
        from repro_torch.runtime import CheckpointManager
        manager = CheckpointManager(spec["ckpt_dir"], async_save=False)
        sync()
        t0 = time.perf_counter()
        manager.save(spec["steps"], state, model=model)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = manager.restore(state, spec["steps"], model=model)
        sync()
        out["restore_s"] = time.perf_counter() - t0
        pairs = list(zip(tree_leaves(state), tree_leaves(restored)))
        out["restored_equal"] = all(
            torch.equal(*(t.codes if hasattr(t, "codes") else t for t in pair))
            and (not hasattr(pair[0], "codes") or torch.equal(pair[0].scale, pair[1].scale))
            for pair in pairs)
        out["restored_leaves"] = len(pairs)
        del restored
    if spec.get("state"):
        keep("", {"p": tree_leaves(state["params"])})
        if grid is None:
            out["arrays"]["p0"] = params0
        else:
            out["state_dir"] = str(state_dir)
    del state
    if cuda:
        torch.cuda.empty_cache()
    return out


def grid_compare(torch, one, ranks, lay, device, lr):
    """The grid's parameters after the last step and its posit8 moment
    codes after every step (each rank's in the files of its ``state_dir``)
    against tp = 1's, on ``device``; every rank's moment scales must be
    tp = 1's after every step. Returns counts over every leaf:

    * "param_max_rel_err", "param_max_lr": the largest difference, over its
      leaf's largest entry and in lr; "param_off_share": the largest share
      of a leaf's entries more than 0.03 lr apart;
    * "params_off": entries more than GRID_RTOL of their leaf's largest
      entry apart and more than 0.03 lr (a leaf that only the updates have
      moved from zero, a bias, holds entries of a few lr, and rounding
      moves Adam's step m / sqrt(v) by a share of lr where the moments
      cancel); "params_off_coded_alike" those of them whose m and v
      codes equal tp = 1's after every step (AdamW's step reads the
      moments, so with moments coded alike the two runs differ only by
      their gradients' rounding); "off_max_lr" and "off_coded_alike_max_lr"
      the largest of each in lr;
    * "flips": moment codes that part from tp = 1's at a step after being
      equal at every step before (at a rounding boundary of the code grid),
      "flips_over_one_step" those more than one step apart (in the int8
      order of posit codes, which is their values' order) and of these
      "flips_across_zero" the pairs within two codes of zero (0, +-1, +-2:
      at most 2^-20 of the leaf's scale): a moment that cancels to
      rounding noise takes the noise's value, its sign or an exact zero;
    * after the last step: "codes", "codes_differing", "codes_over_one_step"
      (an entry parted at an earlier step drifts further in code space as
      the moment's average carries the difference into smaller values,
      where a code step is finer); "code_max_diff_of_scale": the largest
      difference of two differing codes' values in units of their scale;
    * "examples": the first few entries of each kind (with the leaf's
      name, the codes and, for a flip more than one step apart that is
      within two codes of zero, the values in units of the leaf's scale)."""
    import numpy as np
    from repro_torch.core.posit import posit_decode
    from repro_torch.launch.train import spec_leaves
    from repro_torch.nn.sharding import map_with_logical
    names = []
    map_with_logical(lambda name, spec, ax: names.append(name), lay.specs(), lay.logical())

    def dev(a):
        return (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).to(device)

    def gathered(key, i, sp):
        return lay.grid.unshard([dev(np.load(Path(r["state_dir"]) / f"{key}_{i}.npy"))
                                 for r in ranks], sp)

    out = dict(param_max_rel_err=0.0, param_max_lr=0.0, param_off_share=0.0, params_off=0,
               params_off_coded_alike=0, off_max_lr=0.0, off_coded_alike_max_lr=0.0, flips=0,
               flips_over_one_step=0, flips_across_zero=0, codes=0, codes_differing=0, codes_over_one_step=0,
               code_max_diff_of_scale=0.0,
               examples={"off_coded_alike": [], "flips_over_one_step": [], "over_one_step": [],
                         "flips_over_one_step_not_across_zero": []})
    mine = one["arrays"]
    steps = len(one["scales"])
    last = steps - 1

    def example(kind, i, mask, **cols):
        ex = out["examples"][kind]
        idx = torch.nonzero(mask.reshape(-1)).reshape(-1)
        for j in idx.tolist()[:3 - len(ex)]:
            ex.append({"leaf": i, "name": names[i], "index": j,
                       **{k: v.reshape(-1)[j].item() for k, v in cols.items()}})

    for i, sp in enumerate(spec_leaves(lay)):
        apart = None
        for k, key in enumerate(("m", "v")):
            parted = prev = None
            for s in range(steps):
                if any(r["scales"][s][k][i] != one["scales"][s][k][i] for r in ranks):
                    raise AssertionError(f"leaf {i}: a rank's {key} scale after step {s} is "
                                         "not tp=1's")
                gc, wc = gathered(f"{key}s{s}", i, sp), dev(mine[f"{key}s{s}"][i])
                a, b = gc.view(torch.int8).int(), wc.view(torch.int8).int()
                diff = a != b
                fresh = diff if parted is None else diff & ~parted
                over = fresh & ((a - b).abs() > 1)
                out["flips"] += int(fresh.sum())
                out["flips_over_one_step"] += int(over.sum())
                out["flips_across_zero"] += int((over & (a.abs() <= 2) & (b.abs() <= 2)).sum())
                if over.any():
                    before = a if prev is None else prev
                    example("flips_over_one_step", i, over, step=torch.full_like(a, s),
                            grid=a, tp1=b, before=before)
                    wide = over & ((a.abs() > 2) | (b.abs() > 2))
                    if wide.any():
                        value = lambda c: posit_decode(c.to(torch.uint8), 8, 2)  # noqa: E731
                        example("flips_over_one_step_not_across_zero", i, wide,
                                step=torch.full_like(a, s), grid=a, tp1=b, before=before,
                                grid_value=value(a), tp1_value=value(b),
                                before_value=value(before))
                parted = diff if parted is None else parted | diff
                prev = b
                if s == last:
                    out["codes_differing"] += int(diff.sum())
                    out["codes"] += diff.numel()
                    far = (a - b).abs() > 1
                    out["codes_over_one_step"] += int(far.sum())
                    if far.any():
                        example("over_one_step", i, far, grid=a, tp1=b)
                    if diff.any():
                        out["code_max_diff_of_scale"] = max(out["code_max_diff_of_scale"], (
                            posit_decode(gc[diff], 8, 2)
                            - posit_decode(wc[diff], 8, 2)).abs().max().item())
            apart = parted if apart is None else apart | parted
        got, want, p0 = gathered("p", i, sp), dev(mine["p"][i]), dev(mine["p0"][i])
        d = (got - want).abs()
        top = want.abs().max().clamp_min(1e-30)
        out["param_max_rel_err"] = max(out["param_max_rel_err"], (d.max() / top).item())
        out["param_max_lr"] = max(out["param_max_lr"], d.max().item() / lr)
        out["param_off_share"] = max(out["param_off_share"], (d > 0.03 * lr).float().mean().item())
        off = (d > GRID_RTOL * top) & (d > 0.03 * lr)
        alike = off & ~apart
        out["params_off"] += int(off.sum())
        out["params_off_coded_alike"] += int(alike.sum())
        if off.any():
            out["off_max_lr"] = max(out["off_max_lr"], d[off].max().item() / lr)
        if alike.any():
            out["off_coded_alike_max_lr"] = max(out["off_coded_alike_max_lr"],
                                                d[alike].max().item() / lr)
            example("off_coded_alike", i, alike, want=want, got=got, p0=p0)
    return out


def grid_gate(torch, label, one, ranks, lay, device):
    """A grid's run against tp = 1's (phases 17 and 19): every step's loss
    and grad norm within GRID_RTOL of tp = 1's, and ``grid_compare``'s
    counts within their bounds: the parameters after the last step within
    0.03 lr of tp = 1's on all but 0.1 % of each leaf's entries, and within
    GRID_RTOL of the leaf's largest entry (or 0.03 lr) wherever the entry's
    m and v codes equalled tp = 1's after every step (a moment coded a step apart
    changes Adam's step m / sqrt(v), by a factor of 4 at the bottom of the
    posit8 range, where a code step is a factor of 16); the moment scales
    equal and the codes after the last step apart on at most
    GRID_CODE_SHARE of the entries, by more than one code step only within
    two codes of zero (a moment that cancels to rounding noise takes the
    noise's value: its sign, or an exact zero). Logs them; returns (the
    counts, the failed checks)."""
    failed = []
    for what in ("loss", "grad_norm"):
        for s, (x, y) in enumerate(zip(ranks[0][what], one[what])):
            if not abs(x - y) <= GRID_RTOL * abs(y):
                failed.append(f"{label} step {s} {what} {x} vs tp=1 {y}")
    t0 = time.perf_counter()
    cmp = grid_compare(torch, one, ranks, lay, device, lay.rcfg.learning_rate)
    log(f"  {label} vs tp=1 (compared in {time.perf_counter() - t0:.0f} s): losses and "
        f"grad norms within {GRID_RTOL}: {not failed}; params: the largest difference "
        f"{cmp['param_max_rel_err']:.3g} of its leaf's largest entry "
        f"({cmp['param_max_lr']:.2f} lr), at most {100 * cmp['param_off_share']:.4f} % of a "
        f"leaf's entries past 0.03 lr; {cmp['params_off']} entries past {GRID_RTOL} of their "
        f"leaf's largest (up to {cmp['off_max_lr']:.2f} lr), {cmp['params_off_coded_alike']} "
        f"of them with m and v coded as tp=1's after every step (up to "
        f"{cmp['off_coded_alike_max_lr']:.2f} lr); moment codes: {cmp['flips']} flips, "
        f"{cmp['flips_over_one_step']} of them more than one step ("
        f"{cmp['flips_across_zero']} of these within two codes of zero); after the last step "
        f"{cmp['codes_differing']} of {cmp['codes']} differ, {cmp['codes_over_one_step']} "
        f"by more than one step, the values by at most "
        f"{cmp['code_max_diff_of_scale']:.3g} of their scale")
    for kind, rows in cmp["examples"].items():
        for row in rows:
            log(f"    {kind}: {row}")
    if cmp["param_off_share"] > 1e-3:
        failed.append(f"{label}: more than 0.1 % of a leaf's parameters more than 0.03 lr "
                      "off tp=1's")
    if cmp["params_off_coded_alike"]:
        failed.append(f"{label}: {cmp['params_off_coded_alike']} parameters past "
                      f"{GRID_RTOL} of their leaf's largest entry off tp=1's with every "
                      "moment code equal to tp=1's")
    if cmp["codes_differing"] > GRID_CODE_SHARE * cmp["codes"]:
        failed.append(f"{label}: the moment codes part from tp=1's on more than "
                      f"{100 * GRID_CODE_SHARE} % of entries")
    if cmp["flips_over_one_step"] != cmp["flips_across_zero"]:
        failed.append(f"{label}: {cmp['flips_over_one_step'] - cmp['flips_across_zero']} "
                      "moment codes parted from tp=1's by more than one step, away from zero")
    if cmp["code_max_diff_of_scale"] > 2.0 ** -4:
        failed.append(f"{label}: a moment's value parted from tp=1's by more than one code "
                      "step at the top of the range")
    return cmp, failed


def grid_summary(label, ranks, n_params, tokens):
    """One line (and a dict) of a grid run from its ranks' results: the
    median of the steps after the first but GRID_TIMED_STEP (with none, the
    first step's), tokens/s, the
    model-FLOP share of the ranks' cards and peak GiB a rank from it; the
    collectives' share of step GRID_TIMED_STEP, whose collectives ran with
    the card synchronized around each."""
    from statistics import median
    r0 = ranks[0]
    kept = ([s for s in range(len(r0["step_s"])) if s not in (0, GRID_TIMED_STEP)]
            or [s for s in range(len(r0["step_s"])) if s != GRID_TIMED_STEP])
    step_s = median(r0["step_s"][s] for s in kept)
    timed_s = r0["step_s"][GRID_TIMED_STEP]
    share = sum(r0["collective_s"].values()) / timed_s
    flops = 8 * n_params * tokens
    entry = {"median_step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
             "model_flop_share": flops / step_s / (BF16_PEAK * len(ranks)),
             "peak_gib": [r["peak_gib"] for r in ranks],
             "state_gib": [r["state_gib"] for r in ranks],
             "timed_step_ms": timed_s * 1e3, "collective_share": share,
             "collective_ms": {k: v * 1e3 for k, v in r0["collective_s"].items()},
             "loss": r0["loss"], "grad_norm": r0["grad_norm"], "step_s": r0["step_s"],
             "init_s": r0["init_s"]}
    log(f"  {label}: step {entry['median_step_ms']:.1f} ms (median of steps {kept}), "
        f"{entry['tokens_per_s']:.1f} tokens/s, model-FLOP share "
        f"{100 * entry['model_flop_share']:.3f} % of {len(ranks)} x {BF16_PEAK / 1e12:.0f} "
        f"TFLOP/s, peak {max(entry['peak_gib']):.2f} GiB a rank (state "
        f"{max(entry['state_gib']):.2f}); collectives {100 * share:.1f} % of step "
        f"{GRID_TIMED_STEP} ({entry['timed_step_ms']:.1f} ms with the card synchronized "
        f"around each: "
        f"{', '.join(f'{k} {v:.1f} ms' for k, v in sorted(entry['collective_ms'].items()))}); "
        f"losses {[round(x, 5) for x in r0['loss']]}")
    return entry


def grid_sp_run(torch, pool, spec, one, base, cfg, label, n_params, device):
    """Phases 17 and 19's sequence-parallel run: ``spec``'s run again on
    (data 2, model 2) with ``sequence_parallel`` on, in the same pool,
    held by ``grid_gate`` to tp = 1's run ``one``, its state files removed
    after. Every rank must report the residual cut along seq (never the
    path without it), and its first loss is recorded beside the grid's
    without it (``base``, rank 0's result): the forward computes every
    product on the same inputs and model 2 sums two partials either way.
    Returns (the run's summary, the failed checks, the ranks' results)."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import grid_layout
    from repro_torch.nn.models import build_model
    from repro_torch.nn.sharding import GridContext
    run = dict(spec["run"], sequence_parallel=True)
    sp_spec = {k: v for k, v in dict(spec, run=run).items() if k != "ckpt_dir"}
    t0 = time.perf_counter()
    ranks = pool.run(grid_train_rank, sp_spec, grid=(1, 2, 2))
    label = f"{label} sequence parallel"
    log(f"  {label} ran ({time.perf_counter() - t0:.0f} s)")
    e = grid_summary(label, ranks, n_params, 8 * 128)
    failed = []
    if not all(r["seq_parallel"] for r in ranks):
        failed.append(f"{label}: a rank ran without sequence parallelism")
    first, without = ranks[0]["loss"][0], base["loss"][0]
    e.update(first_loss=first, first_loss_without=without, first_loss_equal=first == without)
    apart = "bit for bit" if first == without else f"{abs(first - without) / abs(without):.3g} apart"
    log(f"  {label}: first loss {first!r}, without {without!r} ({apart})")
    lay = build_model(cfg, RunConfig(**run), device="cpu",
                      grid=GridContext(*grid_layout(1, 2, 2)))
    try:
        cmp, bad = grid_gate(torch, label, one, ranks, lay, device)
    finally:
        shutil.rmtree(spec["state_dir"], ignore_errors=True)
    e.update(cmp)
    return e, failed + bad, ranks


def phase_grid_train(torch, result, pool, device="cuda", over=None):
    """Phase 17: training the dense family across ranks. (a) yi-9b at full
    width on GRID_LAYERS layers, f32 weights and activations, posit8 moments,
    lr 1e-5, 8 x 128 tokens, block remat: GRID_STEPS steps at tp = 1 in this
    process (its state freed after), then the same from the same seed on the
    (data 2, model 2) grid, four rank processes (over gloo on one card, NCCL
    with a card each), held to tp = 1's by ``grid_gate``, and again with
    sequence parallelism (``grid_sp_run``); then (pod 2, model 2) with
    posit8_ef: finite losses and the first step's compressed mean equal to
    the port's on the CPU (``grid_pod_check``).
    (b) with four cards: full-depth yi-9b on (data 2, model 2) over NCCL
    with the train CLI's workload (bf16, posit8 moments, 5 steps). Every
    part runs before a failed check fails the phase. ``pool``: a
    ``RankPool(4, device, grids=GRID_POOL_GRIDS)``."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.launch.mesh import RankPool, grid_layout, pick_backend
    from repro_torch.nn.models import build_model
    from repro_torch.nn.sharding import GridContext
    entry = {}
    result["grid"] = entry
    over = over or {}
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=GRID_LAYERS, **over)
    n_params, tokens = cfg.param_count(), 8 * 128
    state_dir = ROOT / "build" / "phase17_state"
    spec = {"layers": GRID_LAYERS, "run": GRID_RUN, "steps": GRID_STEPS, "state": True,
            "over": over, "state_dir": str(state_dir)}
    t_phase = time.perf_counter()
    one = grid_train_rank(None, device, dict(spec, state="initial"))
    log(f"  tp=1 ({time.perf_counter() - t_phase:.0f} s): {n_params / 1e9:.3f} B params, steps "
        f"{[round(t * 1e3, 1) for t in one['step_s']]} ms, peak {one['peak_gib']:.2f} GiB; "
        f"losses {[round(x, 5) for x in one['loss']]}")
    entry["tp1"] = {k: one[k] for k in ("loss", "grad_norm", "step_s", "peak_gib", "state_gib")}
    if device == "cuda":
        torch.cuda.empty_cache()
    try:
        if pool.backend != pick_backend(4, device):
            raise AssertionError(f"the grid took {pool.backend}")
        log(f"  4 ranks over {pool.backend} on {torch.cuda.device_count()} card(s) "
            f"({time.perf_counter() - t_phase:.0f} s)")
        ranks = pool.run(grid_train_rank, spec, grid=(1, 2, 2))
        log(f"  (data 2, model 2) ran ({time.perf_counter() - t_phase:.0f} s)")
        a = grid_summary("(data 2, model 2)", ranks, n_params, tokens)
        a["backend"] = pool.backend
        entry["data2_model2"] = a
        lay = build_model(cfg, RunConfig(**GRID_RUN), device="cpu",
                          grid=GridContext(*grid_layout(1, 2, 2)))
        try:
            cmp, failed = grid_gate(torch, "(data 2, model 2)", one, ranks, lay, device)
        finally:
            shutil.rmtree(state_dir, ignore_errors=True)
        a.update(cmp)
        if device == "cuda":
            torch.cuda.empty_cache()
        # the same with sequence parallelism
        c, bad, _ = grid_sp_run(torch, pool, spec, one, ranks[0], cfg, "(data 2, model 2)",
                                n_params, device)
        c["backend"] = pool.backend
        entry["data2_model2_sp"] = c
        failed += bad
        del ranks, one
        if device == "cuda":
            torch.cuda.empty_cache()            # the ranks' pod run needs the card
        pod_spec = dict(spec, run=dict(GRID_RUN, grad_compression="posit8_ef"), state=False,
                        check_pod=True)
        ranks = pool.run(grid_train_rank, pod_spec, grid=(2, 1, 2))
        log(f"  (pod 2, model 2) ran ({time.perf_counter() - t_phase:.0f} s)")
        b = grid_summary("(pod 2, model 2) posit8_ef", ranks, n_params, tokens)
        b["pod_checked"] = [r["pod_checked"] for r in ranks]
        b["pod_check_s"] = max(r["pod_check_s"] for r in ranks)
        entry["pod2_model2"] = b
        if not all(map(math.isfinite, ranks[0]["loss"] + ranks[0]["grad_norm"])):
            failed.append(f"(pod 2, model 2): losses {ranks[0]['loss']}")
        log(f"  (pod 2, model 2): the first step's compressed mean equals the CPU's on "
            f"{sum(b['pod_checked'])} entries over the 4 ranks (checked in "
            f"{b['pod_check_s']:.1f} s)")
    finally:
        pool.run(release_rank)
    # (b) four cards, NCCL, full depth
    if device == "cuda" and torch.cuda.device_count() >= 4:
        full = ARCHS["yi-9b"]
        nccl_spec = {"layers": full.n_layers, "run": GRID_NCCL_RUN, "steps": 5}
        with RankPool(4, "cuda", grids=[(1, 2, 2)]) as pool:
            if pool.backend != "nccl":
                raise AssertionError(f"four cards, but the ranks took {pool.backend}")
            ranks = pool.run(grid_train_rank, nccl_spec, grid=(1, 2, 2))
        c = grid_summary(f"NCCL (data 2, model 2), yi-9b {full.n_layers} layers, bf16",
                         ranks, full.param_count(), tokens)
        if not all(map(math.isfinite, ranks[0]["loss"] + ranks[0]["grad_norm"])):
            failed.append(f"NCCL grid: losses {ranks[0]['loss']}")
        entry["nccl_full_depth"] = c
    else:
        log(f"  (b) not run: {torch.cuda.device_count()} card(s); full depth over NCCL "
            "needs four")
        entry["nccl_full_depth"] = "not run"
    if failed:
        raise AssertionError("; ".join(failed))


# phase 19: training the moe, ssm, hybrid and encdec families across ranks,
# each at full width on one layer (arch, decoder layers, encoder layers; more
# took the script past its time budget): one MoE layer of 64 experts; one
# mamba1 layer; one mamba2 layer after one application of the shared block;
# one encoder and one decoder layer of whisper
GRID_FAMILIES = (("moonshot-v1-16b-a3b", 1, 0), ("falcon-mamba-7b", 1, 0),
                 ("zamba2-1.2b", 1, 0), ("whisper-medium", 1, 1))
GRID_FAMILY_STEPS = 2
# the families run again with sequence parallelism: those the reference's
# production knobs turn it on for (src/repro/launch/dryrun.py:46-56)
GRID_SP_FAMILIES = ("moonshot-v1-16b-a3b", "whisper-medium")


def phase_grid_families(torch, result, pool, device="cuda", over=None):
    """Phase 19: training the moe, ssm, hybrid and encdec families across
    ranks. Each of GRID_FAMILIES at full width, as phase 17 runs yi-9b: f32
    weights and activations, posit8 moments, lr 1e-5, 8 x 128 tokens (the
    encdec frames drawn as phase 14 draws them), block remat;
    GRID_FAMILY_STEPS steps at tp = 1 in this process (its state freed
    after), then the same from the same seed on the (data 2, model 2) grid,
    four rank processes (one pool for the four; gloo when they share the
    card, NCCL with a card each), held to tp = 1's by ``grid_gate``;
    GRID_SP_FAMILIES again with sequence parallelism (``grid_sp_run``). The
    MoE model's first step must drop assignments at capacity (the count on
    the grid, summed over the data ranks, printed beside tp = 1's; with
    sequence parallelism the same count). whisper
    adds a checkpoint round trip on the grid (every rank saves, rank 0
    writes; every rank restores its shard, which must equal its state bit
    for bit). Step ms (the first step: the second's collectives run with
    the card synchronized), tokens/s, peak GiB a rank and the collectives'
    share of step 1 a family. ``over`` replaces config fields (a CPU run at
    a tiny width); ``pool`` a ``RankPool(4, device, grids=GRID_POOL_GRIDS)``.
    Every family runs before a failed check fails the phase."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.launch.mesh import grid_layout, pick_backend
    from repro_torch.nn.models import build_model
    from repro_torch.nn.sharding import GridContext
    entry = result["grid_families"] = {}
    over = over or {}
    state_dir = ROOT / "build" / "phase19_state"
    ckpt_dir = ROOT / "build" / "phase19_ckpt"
    run = dict(GRID_RUN, total_steps=GRID_FAMILY_STEPS)
    failed = []
    t_phase = time.perf_counter()
    try:
        if pool.backend != pick_backend(4, device):
            raise AssertionError(f"the grid took {pool.backend}")
        log(f"  4 ranks over {pool.backend} on {torch.cuda.device_count()} card(s): "
            f"{result.get('card', 'no card')} ({time.perf_counter() - t_phase:.0f} s)")
        for arch, layers, enc in GRID_FAMILIES:
            cfg = dataclasses.replace(ARCHS[arch], n_layers=layers, **over)
            if enc:
                cfg = dataclasses.replace(cfg, n_enc_layers=enc)
            spec = {"arch": arch, "layers": layers, "enc_layers": enc, "run": run,
                    "steps": GRID_FAMILY_STEPS, "state": True, "over": over,
                    "state_dir": str(state_dir)}
            if cfg.family == "encdec":
                spec["ckpt_dir"] = str(ckpt_dir)
            t0 = time.perf_counter()
            one = grid_train_rank(None, device, dict(spec, state="initial"))
            if device == "cuda":
                torch.cuda.empty_cache()
            ranks = pool.run(grid_train_rank, spec, grid=(1, 2, 2))
            label = f"{arch} (data 2, model 2)"
            log(f"  {arch}, {layers}{f' + {enc}' if enc else ''} layer(s): tp=1 steps "
                f"{[round(t * 1e3, 1) for t in one['step_s']]} ms, peak {one['peak_gib']:.2f} "
                f"GiB; the grid ran ({time.perf_counter() - t0:.0f} s)")
            e = grid_summary(label, ranks, cfg.active_param_count(), 8 * 128)
            e.update(backend=pool.backend, tp1={k: one[k] for k in (
                "loss", "grad_norm", "step_s", "peak_gib", "state_gib")})
            lay = build_model(cfg, RunConfig(**run), device="cpu",
                              grid=GridContext(*grid_layout(1, 2, 2)))
            try:
                cmp, bad = grid_gate(torch, label, one, ranks, lay, device)
            finally:
                shutil.rmtree(state_dir, ignore_errors=True)
            e.update(cmp)
            failed += bad
            if cfg.family == "moe":
                # each data rank's drops, at model rank 0 (ranks 0 and 2)
                e["dropped"] = sum(r["dropped"] for r in ranks[::2])
                e["dropped_tp1"], e["routed"] = one["dropped"], one["routed"]
                log(f"  {arch}: the first step's forward drops {e['dropped']} of "
                    f"{e['routed']} assignments at capacity on the grid (over its data "
                    f"ranks), {one['dropped']} at tp=1")
                if not e["dropped"] > 0:
                    failed.append(f"{arch}: the batch dropped no assignment at capacity")
            if "ckpt_dir" in spec:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
                e["save_s"] = max(r["save_s"] for r in ranks)
                e["restore_s"] = max(r["restore_s"] for r in ranks)
                ok = all(r["restored_equal"] for r in ranks)
                log(f"  {arch}: checkpoint on the grid saved in {e['save_s']:.1f} s (gathered "
                    f"to rank 0, which wrote it), restored in {e['restore_s']:.1f} s; every "
                    f"rank's {ranks[0]['restored_leaves']} leaves equal its state bit for "
                    f"bit: {ok}")
                if not ok:
                    failed.append(f"{arch}: a rank's restored shards differ from its state")
            entry[arch] = e
            if arch in GRID_SP_FAMILIES:
                if device == "cuda":
                    torch.cuda.empty_cache()
                sp, bad, sp_ranks = grid_sp_run(torch, pool, spec, one, ranks[0], cfg, label,
                                                cfg.active_param_count(), device)
                failed += bad
                if cfg.family == "moe":
                    sp["dropped"] = sum(r["dropped"] for r in sp_ranks[::2])
                    log(f"  {arch} sequence parallel: the first step drops {sp['dropped']} "
                        f"assignments at capacity, {one['dropped']} at tp=1")
                    if sp["dropped"] != one["dropped"]:
                        failed.append(f"{arch} sequence parallel: dropped {sp['dropped']} "
                                      f"assignments, tp=1 {one['dropped']}")
                e["sequence_parallel"] = sp
                del sp_ranks
            del ranks, one
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        pool.run(release_rank)
    if failed:
        raise AssertionError("; ".join(failed))


# phase 18: the paper's behavioral analysis (Fig. 8) at yi-9b width
ANALYSIS_LAYERS = 2
ANALYSIS_STEPS = 20
ANALYSIS_RUN = dict(learning_rate=1e-3, total_steps=ANALYSIS_STEPS,
                    warmup_steps=ANALYSIS_STEPS // 10, remat="none", activation_dtype="f32")
# kernels vs plain level-(c) NLL, relative. Both take exact f32 products
# (no TF32) and differ in the sum order alone: an output of a k-term f32 sum
# moves by ~sqrt(k) eps of its terms' size (6e-6 at k = 11008), and the NLL
# is a mean over the batch's 1024 positions
ANALYSIS_NLL_RTOL = 2e-5
# kernels vs plain logits, max |diff| over max |logit| (the CPU tests' f32
# bound for a 2-layer model's logits in two frameworks)
ANALYSIS_LOGIT_RTOL = 1e-4


def phase_analysis(torch, result, device="cuda", over=None):
    """Phase 18: the example's behavioral analysis (``launch.analyze``) at
    yi-9b width on 2 layers, f32 activations: ANALYSIS_STEPS steps of the
    example's training on the synthetic stream (8 x 128 tokens), then
    ``run_analysis`` over all 33 specs of ``default_spec_grid(
    include_paths=True)`` with the kernels and with their plain versions.
    Same pruned and surviving configs, same derived policy, each
    survivor's NLL within ANALYSIS_NLL_RTOL, and the launches of each
    survivor's forward: 7 a layer and the unembed through pofx_matmul
    (pofx) or fxp_matmul (fxp), none for posit. Then every pofx and fxp
    config of the grid, pruned or not, through level (c)'s eval with the
    kernels and with their plain versions (the same launches and bound):
    pruning leaves few pofx configs to level (c), and this runs
    pofx_matmul's f32 path at m = 1024 at every (N, ES, path). fxp16's NLL
    with kernels (its codes wrap to int8 in ``fxp_view``, as the
    reference's) is printed beside its NLL without, not gated. ``over``
    replaces config fields (a tiny width on the CPU)."""
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.analysis import default_spec_grid, spec_name
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import KERNELS, PLAIN
    from repro_torch.launch.analyze import EVAL_STEP, eval_nll, run_analysis
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.nn.models import build_model, ce_loss, quantize_params
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=ANALYSIS_LAYERS, **(over or {}))
    model = build_model(cfg, RunConfig(**ANALYSIS_RUN), device=device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, global_batch=8)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = make_train_state(model, 0)
    step = make_train_step(model)
    losses = []
    for i in range(ANALYSIS_STEPS):
        state, m = step(state, synthetic_batch(dc, i))
        losses.append(float(m["loss"]))            # waits for the step
    params = state["params"]
    del state, step
    sync()
    train_s = time.perf_counter() - t0
    log(f"  yi-9b width (d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{cfg.n_layers} layers, {cfg.param_count() / 1e9:.3f} B params: {ANALYSIS_STEPS} "
        f"steps in {train_s:.1f} s, losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    entry = {"n_layers": cfg.n_layers, "train_s": train_s, "losses": losses}
    result["analysis"] = entry
    failed = []
    if not all(map(math.isfinite, losses)):
        failed.append(f"non-finite training losses {losses}")
    runs, per_fwd = {}, 7 * cfg.n_layers + 1
    for label, kset in (("kernels", KERNELS), ("plain", PLAIN)):
        lines = []
        reset_launches()
        t0 = time.perf_counter()
        run = run_analysis(model, params, dc=dc, kernels=kset, out=lines.append)
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        runs[label] = run
        sec = run.seconds
        log(f"  {label}: level (a) {sec['a']:.1f} s, (b) {sec['b']:.1f} s, (c) {sec['c']:.1f} s "
            f"over {len(run.report.survivors)} survivors, Pareto policy {sec['policy']:.1f} s, "
            f"its eval {sec['policy_eval']:.1f} s; {wall:.1f} s in all; launches {counts}")
        entry[label] = {"seconds": sec, "wall_s": wall, "launches": counts,
                        "per_config_launches": run.launches,
                        "per_config": run.report.per_config,
                        "pruned_at_a": run.report.pruned_at_a,
                        "pruned_at_b": run.report.pruned_at_b,
                        "survivors": run.report.survivors,
                        "policy": run.policy.to_string(), "policy_nll": run.policy_nll,
                        "best": {str(b): v for b, v in run.best.items()}}
        if label == "kernels":
            for line in lines:
                log("  | " + line.replace("\n", "\n  | "))
            entry["report_lines"] = lines
    k, p = runs["kernels"], runs["plain"]
    kr, pr = k.report, p.report
    for what in ("pruned_at_a", "pruned_at_b", "survivors"):
        if getattr(kr, what) != getattr(pr, what):
            failed.append(f"{what}: kernels {getattr(kr, what)} != plain {getattr(pr, what)}")
    if k.policy.to_string() != p.policy.to_string():
        failed.append(f"derived policy: {k.policy.to_string()} != {p.policy.to_string()}")
    specs = {spec_name(s): s for s in default_spec_grid(include_paths=True)}
    margins = sorted((abs(r[key] - 0.25), name, key) for name, r in kr.per_config.items()
                     for key in ("weight_avg_rel", "act_avg_rel") if key in r)
    log("  nearest to a 0.25 threshold: " + ", ".join(
        f"{name} {key} {kr.per_config[name][key]:.6f}" for _, name, key in margins[:3]))
    nll_rel = {}
    for name in kr.survivors:
        if name not in pr.per_config or "metric" not in pr.per_config[name]:
            continue
        mk, mp = kr.per_config[name]["metric"], pr.per_config[name]["metric"]
        nll_rel[name] = abs(mk - mp) / max(abs(mp), 1e-30)
        kernel = {"pofx": "pofx_matmul", "fxp": "fxp_matmul"}.get(specs[name].kind)
        got = k.launches.get(name, {})
        want = {kernel: per_fwd} if kernel and cuda else {}
        if got != want:
            failed.append(f"{name}: launches {got} != {want}")
        if p.launches.get(name):
            failed.append(f"{name}: the plain run launched {p.launches[name]}")
        if nll_rel[name] > ANALYSIS_NLL_RTOL:
            failed.append(f"{name}: NLL kernels {-mk:.7f} vs plain {-mp:.7f} "
                          f"(rel {nll_rel[name]:.3g} > {ANALYSIS_NLL_RTOL})")
    entry["nll_rel"] = nll_rel
    log(f"  level (c) launches at m = {dc.global_batch * dc.seq_len} per survivor: " + ", ".join(
        f"{n} {k.launches.get(n, {})}" for n in kr.survivors))
    # every pofx and fxp config of the grid, pruned or not: its level-(c)
    # eval with the kernels against their plain versions, so pofx_matmul
    # runs at m = 1024 at every (N, ES, path) of the sweep
    batch = synthetic_batch(dc, EVAL_STEP)
    tokens = torch.as_tensor(batch["tokens"]).to(model.device)
    labels = torch.as_tensor(batch["labels"]).to(model.device)
    with_k = dataclasses.replace(model, use_kernel=True, kernel_set=KERNELS)
    with_p = dataclasses.replace(model, use_kernel=True, kernel_set=PLAIN)
    grid = {}
    t0 = time.perf_counter()
    for name, spec in specs.items():
        kernel = {"pofx": "pofx_matmul", "fxp": "fxp_matmul"}.get(spec.kind)
        if kernel is None:
            continue
        qp = quantize_params(params, spec)
        reset_launches()
        with torch.no_grad():
            lk = with_k.forward(qp, tokens)
            got = {n: c for n, c in LAUNCHES.items() if c}
            lp = with_p.forward(qp, tokens)
        nk, np_ = float(ce_loss(lk, labels)), float(ce_loss(lp, labels))
        logit_rel = rel_err(lk, lp)
        del qp, lk, lp
        rel = abs(nk - np_) / max(abs(np_), 1e-30)
        grid[name] = {"nll_kernels": nk, "nll_plain": np_, "rel": rel, "logit_rel": logit_rel,
                      "launches": got}
        want = {kernel: per_fwd} if cuda else {}
        if got != want:
            failed.append(f"{name} (grid check): launches {got} != {want}")
        if not (math.isfinite(nk) and rel <= ANALYSIS_NLL_RTOL
                and logit_rel <= ANALYSIS_LOGIT_RTOL):
            failed.append(f"{name} (grid check): NLL kernels {nk:.7f} vs plain {np_:.7f} "
                          f"(rel {rel:.3g}, bound {ANALYSIS_NLL_RTOL}), logits rel "
                          f"{logit_rel:.3g} (bound {ANALYSIS_LOGIT_RTOL})")
    sync()
    entry["grid_check"] = grid
    entry["grid_check_s"] = time.perf_counter() - t0
    log(f"  every pofx and fxp config, kernels vs plain at m = {dc.global_batch * dc.seq_len} "
        f"({entry['grid_check_s']:.1f} s): largest NLL rel "
        f"{max(g['rel'] for g in grid.values()):.3g} (bound {ANALYSIS_NLL_RTOL}), logits rel "
        f"{max(g['logit_rel'] for g in grid.values()):.3g} (bound {ANALYSIS_LOGIT_RTOL}); "
        f"pofx_matmul "
        f"launches per (N, ES, path): " + ", ".join(
            f"({specs[n].N},{specs[n].ES},{specs[n].path}) {g['launches'].get('pofx_matmul', 0)}"
            for n, g in grid.items() if specs[n].kind == "pofx"))
    for name in ("fxp7", "fxp8"):
        if name not in kr.survivors:
            failed.append(f"{name} did not survive to level (c): no fxp_matmul launch there")
    log("  survivors (bits/weight, NLL kernels / plain, rel): " + "; ".join(
        f"{n} {kr.per_config[n]['bits_per_weight']:.2f} b/w {-kr.per_config[n]['metric']:.5f}"
        f" / {-pr.per_config[n]['metric']:.5f} ({nll_rel.get(n, float('nan')):.2g})"
        for n in kr.survivors))
    if "fxp16" in kr.survivors:
        fxp16 = specs["fxp16"]
        true_nll = eval_nll(dataclasses.replace(model, use_kernel=False),
                            quantize_params(params, fxp16), synthetic_batch(dc, EVAL_STEP))
        entry["fxp16_nll"] = {"kernels": -kr.per_config["fxp16"]["metric"],
                              "plain": -pr.per_config["fxp16"]["metric"], "no_kernels": true_nll}
        log(f"  fxp16 NLL (codes wrapped to int8 by fxp_view, as in the reference): kernels "
            f"{entry['fxp16_nll']['kernels']:.5f}, plain {entry['fxp16_nll']['plain']:.5f}; "
            f"without kernels (the fxp16 network's) {true_nll:.5f}")
    log(f"  derived policy {k.policy.to_string()}: NLL kernels {k.policy_nll:.5f}, plain "
        f"{p.policy_nll:.5f}")
    entry["phase_s"] = time.perf_counter() - t_phase
    if cuda:
        entry["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  phase {entry['phase_s']:.1f} s" + (f", peak {entry['peak_gib']:.2f} GiB" if cuda
                                                 else ""))
    del model, params, runs, k, p
    if cuda:
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))


DRYRUN_PEAK_RTOL = 0.10
DRYRUN_LAYERS = 4


def dryrun_child(out_path: str) -> int:
    """Phase 20's process: (a) the dry run's prediction of a step of yi-9b
    width on DRYRUN_LAYERS layers at one rank, and three real steps (the
    peak read after the first, the others timed), (b) the yi-9b train_4k
    cell through the dry run's CLI entry point. Writes the readings to
    ``out_path`` as JSON."""
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.nn.models import TensorSpec, build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=DRYRUN_LAYERS)
    model = build_model(cfg, RunConfig(remat="block", opt_state_quant="posit8"), device="cuda")
    B, S = 8, 128
    specs = {"tokens": TensorSpec((B, S), torch.int32), "labels": TensorSpec((B, S), torch.int32)}
    cost, trace_s = dryrun.dry_train_step(model, specs)
    pred = dryrun.memory_record(cost)
    n_active = cfg.active_param_count()
    roof = hlo_analysis.roofline_terms(cost.flops_per_device, cost.bytes_per_device,
                                       cost.wire_bytes_per_device, 6.0 * n_active * B * S, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = make_train_state(model, 0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                              dtype=torch.int32) for k in specs}
    step = make_train_step(model)
    steps_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            peak = torch.cuda.max_memory_allocated() - base
    if not math.isfinite(loss):
        raise AssertionError(f"phase 20 (a): the real step's loss is {loss}")
    a = {"layers": DRYRUN_LAYERS, "tokens": B * S, "predicted_peak_bytes": pred["peak_memory_in_bytes"],
         "predicted": pred, "measured_peak_bytes": peak, "flops": cost.flops_per_device,
         "flops_8NT": 8.0 * n_active * B * S, "bytes": cost.bytes_per_device,
         "roofline": roof, "steps_ms": steps_ms, "trace_s": trace_s, "n_ops": cost.n_ops}
    out_dir = ROOT / "build" / "phase20"
    t0 = time.perf_counter()
    rc = dryrun.main(["--arch", "yi-9b", "--shape", "train_4k", "--mesh", "single",
                      "--device", "cuda", "--out", str(out_dir)])
    b = json.loads((out_dir / "yi-9b__train_4k__single__bf16.json").read_text())
    b["main_rc"], b["wall_s"] = rc, time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    Path(out_path).write_text(json.dumps({"a": a, "b": b}))
    return 0


def phase_dryrun(torch, result):
    """Phase 20: ``dryrun_child`` in a process of its own (this process's
    caches emptied first); gates the predicted peak within DRYRUN_PEAK_RTOL
    of the measured one and the production cell's record."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "phase20.json"
    out.parent.mkdir(exist_ok=True)
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child",
                           str(out)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    if proc.returncode:
        raise AssertionError(f"phase 20's process exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    got = json.loads(out.read_text())
    out.unlink()
    result["dryrun"] = got
    a, b = got["a"], got["b"]
    gib = 2 ** 30
    rel = a["measured_peak_bytes"] / a["predicted_peak_bytes"] - 1
    r = a["roofline"]
    step_ms = min(a["steps_ms"][1:])
    log(f"  (a) yi-9b width, {a['layers']} layers, {a['tokens']} tokens, posit8 moments: peak "
        f"{a['measured_peak_bytes'] / gib:.3f} GiB measured (max_memory_allocated) vs "
        f"{a['predicted_peak_bytes'] / gib:.3f} GiB predicted ({100 * rel:+.2f} %); flops "
        f"{a['flops'] / 1e12:.3f} T counted vs 8NT {a['flops_8NT'] / 1e12:.3f} T; bound "
        f"{r['step_lower_bound_s'] * 1e3:.2f} ms ({r['bound']}) vs step {step_ms:.2f} ms "
        f"(steps {[round(x, 2) for x in a['steps_ms']]} ms); traced in {a['trace_s']:.1f} s")
    m, rb = b["memory"], b["roofline"]
    log(f"  (b) yi-9b train_4k, rank 0 of 256 on (16, 16): args "
        f"{m['argument_size_in_bytes'] / gib:.2f} GiB, peak {m['peak_memory_in_bytes'] / gib:.2f} "
        f"GiB a rank (fits 80 GiB: {b['fits']}); compute {rb['compute_s'] * 1e3:.1f} ms, memory "
        f"{rb['memory_s'] * 1e3:.1f} ms, collective {rb['collective_s'] * 1e3:.1f} ms; bound "
        f"{rb['bound']} {rb['step_lower_bound_s'] * 1e3:.1f} ms, mfu_bound "
        f"{rb['mfu_bound']:.3f}; traced in {b['trace_s']:.1f} s ({b['wall_s']:.1f} s in main)")
    bad = []
    if abs(rel) > DRYRUN_PEAK_RTOL:
        bad.append(f"(a) the measured peak is {100 * rel:+.2f} % off the predicted one "
                   f"(gate {100 * DRYRUN_PEAK_RTOL:.0f} %)")
    if b["main_rc"] != 0 or not b.get("ok") or b.get("device") != "cuda":
        bad.append(f"(b) the cell's record: rc {b['main_rc']}, ok {b.get('ok')}, "
                   f"device {b.get('device')}")
    if bad:
        raise AssertionError("; ".join(bad))


# phase 21: serving on a (pod, data, model) grid: yi-9b at full width on
# GRID_LAYERS layers (phase 17's), 8 slots on (data 2, model 2), greedy
GRID_SERVE_SLOTS = 8
GRID_SERVE_STEPS = 16
GRID_SERVE_CALLS = {
    # max_len 256, 128 positions a model rank: ragged prompts, the last three
    # past the block boundary, two more crossing it while they decode
    "ragged": (256, (100, 106, 112, 118, 124, 129, 135, 140)),
    # max_len 4096, short prompts: model rank 1's block (2048-4095) holds
    # no valid position
    "long": (4096, (8, 11, 14, 17, 20, 23, 26, 29)),
}
GRID_SERVE_LOGIT_RTOL = 1e-3    # grid vs tp = 1 first-token logits, of the largest logit
GRID_SERVE_CODE_SHARE = 1e-3    # KV codes one step apart from tp = 1's, at most
GRID_SERVE_PROFILE_STEPS = 4


def grid_serve_inputs(torch, vocab: int, prompts, device):
    """The 8 prompts (lengths ``prompts``, tokens from seed 3) right-padded
    into one (8, max) batch, and their lengths."""
    g = torch.Generator().manual_seed(3)
    tokens = torch.zeros((len(prompts), max(prompts)), dtype=torch.long)
    for i, n in enumerate(prompts):
        tokens[i, :n] = torch.randint(0, vocab, (n,), generator=g)
    return tokens.to(device), torch.tensor(prompts, dtype=torch.int32, device=device)


def sync(torch, device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def grid_serve_call(torch, model, params, tokens, length, max_len):
    """``prefill`` and GRID_SERVE_STEPS greedy ``decode_step``s; returns
    (streams (8, steps), first-token logits, the cache, decode ms a step)."""
    cache = model.init_cache(tokens.shape[0], max_len)
    cache, logits = model.prefill(params, tokens, cache=cache, length=length)
    first = logits.float().cpu()
    out = []
    sync(torch, model.device)
    t0 = time.perf_counter()
    for _ in range(GRID_SERVE_STEPS):
        nxt = logits.argmax(-1)[:, None]
        out.append(nxt)
        cache, logits = model.decode_step(params, cache, nxt)
    sync(torch, model.device)
    step_ms = (time.perf_counter() - t0) * 1e3 / GRID_SERVE_STEPS
    return torch.cat(out, 1).cpu(), first, cache, step_ms


def grid_serve_rank(grid, device, spec):
    """Phase 21's rank side (in a rank process; at tp = 1 in this one, with
    ``grid`` None): yi-9b at full width on GRID_LAYERS layers, f32
    activations, pofx8 weights from seed 1 (a rank draws each whole leaf
    and keeps its codes' block), an fxp8 KV cache, kernels on. For each call
    of GRID_SERVE_CALLS: ``prefill`` of the 8 right-padded prompts
    (``length``) and GRID_SERVE_STEPS greedy decode steps with the launches
    counted from 0, then again with every kernel's plain version (PLAIN).
    Returns each call's streams, first-token logits, the rank's KV codes,
    launches, decode ms a step and peak GiB; on the grid also decode steps
    profiled with ``combine_partials`` in a ``record_function`` range."""
    import torch
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.core.policy import QuantPolicy, parse_spec
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import PLAIN
    from repro_torch.nn import attention
    from repro_torch.nn.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=GRID_LAYERS, **spec.get("over", {}))
    model = build_model(cfg, RunConfig(remat="none", activation_dtype="f32"), device=device,
                        use_kernel=True, kv_spec=parse_spec("fxp8"), grid=grid)
    params = model.init(1, policy=QuantPolicy.from_string("pofx8"))
    plain = dataclasses.replace(model, kernel_set=PLAIN)
    out = {"rank": 0 if grid is None else grid.rank}
    card = torch.device(device).type == "cuda"
    for name, (max_len, prompts) in GRID_SERVE_CALLS.items():
        tokens, length = grid_serve_inputs(torch, cfg.vocab_size, prompts, device)
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        reset_launches()
        streams, first, cache, step_ms = grid_serve_call(torch, model, params, tokens, length,
                                                         max_len)
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if card else 0.0
        kv = {k: cache["kv"][k].cpu().numpy() for k in ("k", "v")}
        del cache
        plain_streams = grid_serve_call(torch, plain, params, tokens, length, max_len)[0]
        out[name] = {"streams": streams.tolist(), "plain_streams": plain_streams.tolist(),
                     "first": first.numpy() if out["rank"] == 0 else None, "kv": kv,
                     "launches": launches, "step_ms": step_ms, "peak_gib": peak}
    if grid is not None:
        out["profile"] = grid_serve_profile(torch, model, params, cfg.vocab_size, device,
                                            attention)
    return out


def grid_serve_profile(torch, model, params, vocab, device, attention):
    """GRID_SERVE_PROFILE_STEPS decode steps of the "ragged" call under
    torch.profiler with ``combine_partials`` in a ``record_function``
    range: a step's wall ms and the combine's host and device ms a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    max_len, prompts = GRID_SERVE_CALLS["ragged"]
    tokens, length = grid_serve_inputs(torch, vocab, prompts, device)
    cache, logits = model.prefill(params, tokens, cache=model.init_cache(len(prompts), max_len),
                                  length=length)
    nxt = logits.argmax(-1)[:, None]
    cache, logits = model.decode_step(params, cache, nxt)
    saved = attention.combine_partials
    attention.combine_partials = annotated(torch, "combine_partials", saved)
    card = torch.device(device).type == "cuda"
    try:
        sync(torch, device)
        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if card else [])) as prof:
            t0 = time.perf_counter()
            for _ in range(GRID_SERVE_PROFILE_STEPS):
                cache, logits = model.decode_step(params, cache, logits.argmax(-1)[:, None])
            sync(torch, device)
            wall = (time.perf_counter() - t0) * 1e3 / GRID_SERVE_PROFILE_STEPS
    finally:
        attention.combine_partials = saved
    spans = [e for e in prof.events()
             if e.name == "combine_partials" and e.device_type == DeviceType.CPU]
    return {"wall_ms": wall,
            "combine_host_ms": sum(e.cpu_time_total for e in spans) / 1e3
            / GRID_SERVE_PROFILE_STEPS,
            "combine_device_ms": sum(e.device_time_total for e in spans) / 1e3
            / GRID_SERVE_PROFILE_STEPS}


def grid_serve_check(torch, one, ranks, layout, name, failed, card=True):
    """Phase 21's checks of one call: every rank's streams (kernels and
    plain) equal tp = 1's, first-token logits within GRID_SERVE_LOGIT_RTOL
    of the largest, each rank's KV codes its block of tp = 1's (at most
    GRID_SERVE_CODE_SHARE one step apart), and on the ``card`` the expected
    launches a rank (on the CPU the wrappers launch nothing). Returns the
    call's record."""
    import numpy as np
    want_s = one[name]["streams"]
    for r, res in enumerate(ranks):
        got = res[name]
        if got["streams"] != want_s:
            failed.append(f"{name}: rank {r}'s streams differ from tp = 1's")
        if got["plain_streams"] != got["streams"]:
            failed.append(f"{name}: rank {r}'s plain streams differ from its kernels'")
    a, b = ranks[0][name]["first"], one[name]["first"]
    logit_err = float(np.abs(a - b).max() / np.abs(b).max())
    if logit_err > GRID_SERVE_LOGIT_RTOL:
        failed.append(f"{name}: first-token logits {logit_err:.2e} of the largest apart")
    flips, worst = 0.0, 0
    for r, res in enumerate(ranks):
        r0, nb = layout[r]["rows"]
        m, M = layout[r]["model"]
        for k, leaf in res[name]["kv"].items():
            whole = one[name]["kv"][k]
            S_l = whole.shape[3] // M
            want = whole[:, r0:r0 + nb, :, m * S_l:(m + 1) * S_l].astype(np.int32)
            d = np.abs(leaf.astype(np.int32) - want)
            flips = max(flips, float((d != 0).mean()))
            worst = max(worst, int(d.max()))
    if flips > GRID_SERVE_CODE_SHARE or worst > 1:
        failed.append(f"{name}: KV codes {flips:.2e} apart from tp = 1's (largest {worst})")
    per_fwd = 7 * GRID_LAYERS + 1
    want = {"pofx_matmul": per_fwd * (1 + GRID_SERVE_STEPS),
            "kv_flash_decode": GRID_LAYERS * GRID_SERVE_STEPS, "kv_flash_paged_decode": 0,
            "fxp_matmul": 0, "pofx_decode": 0}
    for r, res in enumerate(ranks):
        if card and res[name]["launches"] != want:
            failed.append(f"{name}: rank {r} launched {res[name]['launches']}, not {want}")
    rec = {"step_ms": [res[name]["step_ms"] for res in ranks],
           "tp1_step_ms": one[name]["step_ms"],
           "peak_gib": [res[name]["peak_gib"] for res in ranks],
           "tp1_peak_gib": one[name]["peak_gib"], "launches": ranks[0][name]["launches"],
           "first_logit_err": logit_err, "kv_code_share_apart": flips,
           "streams_equal": all(res[name]["streams"] == want_s for res in ranks)}
    log(f"  {name} (max_len {GRID_SERVE_CALLS[name][0]}): decode "
        f"{', '.join(f'{x:.2f}' for x in rec['step_ms'])} ms a step a rank (tp=1 "
        f"{rec['tp1_step_ms']:.2f}); peak {', '.join(f'{x:.2f}' for x in rec['peak_gib'])} "
        f"GiB a rank (tp=1 {rec['tp1_peak_gib']:.2f}); streams = tp=1: "
        f"{rec['streams_equal']}; first logits {logit_err:.2e} of the largest apart; KV "
        f"codes {flips:.2e} apart; launches a rank {rec['launches']}")
    return rec


def phase_grid_serve(torch, result, pool, device="cuda", over=None):
    """Phase 21: serving on a (data 2, model 2) grid. yi-9b at full width on
    GRID_LAYERS layers, pofx8 weights, an fxp8 KV cache, kernels on, f32
    activations: GRID_SERVE_CALLS (8 ragged prompts of 100-140 tokens in a
    256-position cache, 128 a model rank, and short prompts in a 4096-
    position cache, model rank 1's block empty), each prefilled and decoded
    GRID_SERVE_STEPS greedy steps at tp = 1 in this process and on the grid
    (four rank processes, ``RankPool(grids=)``: gloo when they share the
    card, NCCL with a card each); held by ``grid_serve_check``. Reports
    decode ms a step, the combine's share of a step (``combine_partials``
    in a ``record_function`` range), peak GiB a rank. Every check runs
    before a failure is raised. ``pool``: a ``RankPool(4, device,
    grids=GRID_POOL_GRIDS)``."""
    from repro_torch.launch.mesh import grid_layout, pick_backend
    from repro_torch.nn.sharding import GridContext
    spec = {"over": over or {}}
    t0 = time.perf_counter()
    one = grid_serve_rank(None, device, spec)
    if device == "cuda":
        torch.cuda.empty_cache()
    try:
        if pool.backend != pick_backend(4, device):
            raise AssertionError(f"the grid took {pool.backend}")
        log(f"  tp=1 and 4 ranks over {pool.backend} ({time.perf_counter() - t0:.0f} s)")
        ranks = pool.run(grid_serve_rank, spec, grid=(1, 2, 2))
    finally:
        pool.run(release_rank)
    shape, names = grid_layout(1, 2, 2)
    layout = []
    for r in range(4):
        lay = GridContext(shape, names, rank=r)
        layout.append({"rows": lay.rows(GRID_SERVE_SLOTS), "model": (lay.coords["model"], 2)})
    failed = []
    entry = {"backend": pool.backend, "layers": GRID_LAYERS}
    for name in GRID_SERVE_CALLS:
        entry[name] = grid_serve_check(torch, one, ranks, layout, name, failed,
                                       card=torch.device(device).type == "cuda")
    prof = ranks[0]["profile"]
    prof["combine_share"] = prof["combine_host_ms"] / prof["wall_ms"]
    entry["profile"] = prof
    log(f"  combine_partials: {prof['combine_host_ms']:.3f} ms of a {prof['wall_ms']:.2f} ms "
        f"decode step on the host ({100 * prof['combine_share']:.1f}%), "
        f"{prof['combine_device_ms']:.3f} ms on the device (rank 0, profiled)")
    result["grid_serve"] = entry
    if failed:
        raise AssertionError("; ".join(failed))


# phase 22: the reference's examples on the port. 60 steps, not 300: 300
# took 121.0 s of training alone on the card and 100 took 21.7-55.0 s (a
# step 218-550 ms across calls), past the phase's 60-s budget
EXAMPLE_STEPS = 60
# each policy's logits through the kernels against the plain versions', max
# |diff| over max |logit|: the issue's 1e-3 on the perplexity, taken where
# it is well conditioned. The example's model diverges at the reference's
# defaults (losses in the hundreds), and the perplexity's log, the mean
# NLL, then moves by (relative logit error) x (logits' size): pofx8es2's
# perplexity gap read 3.8e-6 in one call and 1.17e-2 in another
EXAMPLE_LOGIT_RTOL = 1e-3


def pofx_matmul_f64(x, codes, scale, N, ES, M=8):
    """``pofx_matmul``'s plain version with its products and sums in f64,
    rounded to f32 once: a second rounding of the same function, phase 22's
    witness of how far two correct roundings of the pofx path part."""
    import torch
    from repro_torch.kernels.ref import pofx_decode_ref
    w = pofx_decode_ref(codes, N, ES, M).to(torch.float64) / 2 ** (M - 1)
    y = torch.matmul(x.to(torch.float64), w) * scale.reshape(1, -1).to(torch.float64)
    return y.to(torch.float32)


def with_fxp(model, wrap):
    """``model`` with its kernel set's ``fxp_matmul`` replaced by
    ``wrap(fxp_matmul)``."""
    kset = model.kernel_set
    return dataclasses.replace(model, kernel_set=dataclasses.replace(
        kset, fxp_matmul=wrap(kset.fxp_matmul)))


def example_gaps(torch, models, params, batches):
    """The eval batches through ``models`` ({"kernels", "plain", "f64"}: one
    model under three kernel sets). Each run's mean NLL (``ce_loss`` a
    batch, averaged); the kernels' and the f64 witness's logits against the
    plain versions', max |diff| over the plain logits' max |logit|, over
    every batch; where the policy has fxp rules, the int8 activation codes
    that each fxp_matmul of the kernels' run was given against the plain
    run's (how many differ, the largest step, and the same for each
    forward's first fxp_matmul, where f32 rounding first meets an
    activation rounding; how many of the witness's differ), and "replay":
    the kernels' run with every fxp_matmul given the plain run's codes, as
    phase 5's replay. The launches are the kernels' run's alone."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.nn.models import ce_loss
    runs = ("kernels", "plain", "f64", "replay")
    nll = dict.fromkeys(runs, 0.0)
    diff = dict.fromkeys(("kernels", "f64", "replay"), 0.0)
    codes = {"n": 0, "differ": 0, "max_step": 0, "first_differ": 0, "first_max_step": 0,
             "f64_differ": 0}
    top, launches = 0.0, {}

    def recording(box):
        return lambda fxp: lambda a, b: box.append(a) or fxp(a, b)

    with torch.no_grad():
        for b in batches:
            labels = torch.as_tensor(b["labels"]).to(models["plain"].device)
            tokens = torch.as_tensor(b["tokens"])
            seen = {"kernels": [], "plain": [], "f64": []}
            lg = {k: with_fxp(models[k], recording(seen[k])).forward(params, tokens).float()
                  for k in ("plain", "f64")}
            before = dict(LAUNCHES)
            lg["kernels"] = with_fxp(models["kernels"], recording(seen["kernels"])).forward(
                params, tokens).float()
            for k, v in LAUNCHES.items():
                launches[k] = launches.get(k, 0) + v - before.get(k, 0)
            if seen["plain"]:
                it = iter(seen["plain"])
                lg["replay"] = with_fxp(models["kernels"], lambda fxp: lambda a, b: fxp(
                    next(it), b)).forward(params, tokens).float()
                steps = [(k.int() - p.int()).abs() for k, p in zip(seen["kernels"],
                                                                   seen["plain"])]
                codes["n"] += sum(d.numel() for d in steps)
                codes["differ"] += sum(int((d > 0).sum()) for d in steps)
                codes["max_step"] = max(codes["max_step"], max(int(d.max()) for d in steps))
                codes["first_differ"] += int((steps[0] > 0).sum())
                codes["first_max_step"] = max(codes["first_max_step"], int(steps[0].max()))
                codes["f64_differ"] += sum(int((w != p).sum()) for w, p in zip(seen["f64"],
                                                                               seen["plain"]))
            else:
                lg["replay"] = lg["kernels"]
            for k in runs:
                nll[k] += float(ce_loss(lg[k], labels)) / len(batches)
            top = max(top, float(lg["plain"].abs().max()))
            for k in diff:
                diff[k] = max(diff[k], float((lg[k] - lg["plain"]).abs().max()))
            del lg, seen
    return (nll, {k: v / top for k, v in diff.items()}, top,
            codes if codes["n"] else None, {k: v for k, v in launches.items() if v})


def phase_examples(torch, result, device="cuda", steps=EXAMPLE_STEPS):
    """Phase 22: the reference's examples. (a) ``python -m
    repro_torch.examples.train_lm --big --steps steps`` (12 layers,
    d_model 512, vocab 32000, 8 x 128 tokens a step, the reference's
    RunConfig: bf16, block remat, posit8 moments; its own loss lines,
    perplexity table and storage report) in a directory under ``build/``,
    then again on the same directory: it resumes from its last checkpoint,
    trains no step and holds the same parameters, bit for bit; (b) the
    trained parameters under each of the example's policies evaluated at
    f32 activations with the kernels (``kernels.ops.KERNELS``:
    ``pofx_matmul`` under the pofx rules, ``fxp_matmul`` under the fxp
    ones; the launches counted over those runs alone), with their plain
    versions (``ops.PLAIN``) and with the plain versions but
    ``pofx_matmul_f64`` (the witness), by ``example_gaps``: every
    policy's logits through the kernels within EXAMPLE_LOGIT_RTOL of the
    plain versions' largest (under the mixed policy the replay's: both
    kernels, fxp_matmul given the plain run's activation codes, since a
    float kernel's rounding moves some of them a whole int8 step), and
    each forward's first fxp_matmul codes at most one step from the plain
    run's; printed beside them the free runs' logit gaps, the perplexity's
    relative difference (expm1 of the mean NLLs' difference), the
    witness's gaps and code flips, and the example's own (bf16,
    dequantize-path) perplexity with its ratio to fp32; (c) ``quickstart`` and
    ``serve_quantized --use-kernel`` on the card. Every part runs before a
    failed check fails the phase."""
    from repro_torch.data import DataConfig
    from repro_torch.examples import quickstart, serve_quantized, train_lm
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.ops import KERNELS, PLAIN
    from repro_torch.nn.models import apply_policy
    from repro_torch.optim import tree_leaves
    entry = result["examples"] = {"card": result.get("card"), "steps": steps}
    failed = []
    ckpt = ROOT / "build" / "phase22_ckpt"
    argv = ["--big", "--steps", str(steps), "--device", device, "--ckpt-dir", str(ckpt)]
    for d in (ckpt, Path(f"{ckpt}_quant")):
        shutil.rmtree(d, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        run = train_lm.main(argv)
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = train_lm.main(argv)
        resume_s = time.perf_counter() - t0
    finally:
        for d in (ckpt, Path(f"{ckpt}_quant")):
            shutil.rmtree(d, ignore_errors=True)
    losses = [v for _, v in run.losses]
    entry["train"] = {"n_params": run.n_params, "steps": len(losses),
                      "loss_every_20": [round(v, 4) for v in losses[::20]] + [losses[-1]],
                      "train_s": run.train_s, "ms_a_step": 1e3 * run.train_s / len(losses),
                      "monitor": run.monitor, "ppl": run.ppl, "storage": run.storage,
                      "saved_policy": run.saved_policy, "main_s": train_s,
                      "resume_main_s": resume_s}
    log(f"  {result.get('card')}: train_lm --big, {run.n_params / 1e6:.1f}M params, "
        f"{len(losses)} steps in {run.train_s:.1f} s ({1e3 * run.train_s / len(losses):.1f} ms "
        f"a step; {run.monitor}); loss every 20 steps {entry['train']['loss_every_20']}")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(run.params),
                                                   tree_leaves(again.params)))
    entry["resume"] = {"start": again.start, "steps": len(again.losses), "params_equal": same}
    log(f"  resumed: from step {again.start - 1}, trained {len(again.losses)} steps, params "
        f"equal bit for bit: {same} ({resume_s:.1f} s)")
    if not (again.start == steps and not again.losses and same):
        failed.append(f"resume: start {again.start}, {len(again.losses)} steps, equal {same}")
    if not all(map(math.isfinite, losses)):
        failed.append(f"train_lm: losses {losses[0]} -> {losses[-1]}")

    # (b) the policies through the kernels, their plain versions and the witness
    cfg, model = run.model.cfg, run.model
    batches = train_lm.eval_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                               global_batch=8))
    f32 = dataclasses.replace(model.rcfg, activation_dtype="f32")
    models = {k: dataclasses.replace(model, rcfg=f32, use_kernel=True, kernel_set=kset)
              for k, kset in (("kernels", KERNELS), ("plain", PLAIN), ("f64", dataclasses.replace(
                  PLAIN, pofx_matmul=pofx_matmul_f64)))}
    base = run.ppl["fp32"]
    entry["kernels"] = {}
    log(f"  {'policy':<36} {'perplexity':>11} {'vs fp32':>8} {'NLL f32':>10} {'logits':>9} "
        f"{'ppl':>9} {'f64 logits':>10} {'f64 ppl':>9} {'replay':>9}  launches")
    log(f"  {'fp32':<36} {base:11.5g} {'-':>8}")
    launched = {"pofx_matmul": 0, "fxp_matmul": 0}
    for pol in train_lm.POLICIES:
        qp = apply_policy(run.params, pol)
        nll, gap, top, codes, counts = example_gaps(torch, models, qp, batches)
        for k in launched:
            launched[k] += counts.get(k, 0)
        ppl_rel = {k: math.expm1(abs(nll[k] - nll["plain"])) for k in ("kernels", "f64", "replay")}
        mixed = counts.get("pofx_matmul") and counts.get("fxp_matmul")
        gated = "replay" if mixed else "kernels"
        entry["kernels"][pol] = {
            "perplexity": run.ppl[pol], "vs_fp32": run.ppl[pol] / base, "nll_f32": nll,
            "max_abs_logit": top, "logit_rel": gap, "ppl_rel": ppl_rel, "codes": codes,
            "gated": gated, "launches": counts}
        log(f"  {pol:<36} {run.ppl[pol]:11.5g} {run.ppl[pol] / base:7.3f}x "
            f"{nll['plain']:10.4f} {gap['kernels']:9.2e} {ppl_rel['kernels']:9.2e} "
            f"{gap['f64']:10.2e} {ppl_rel['f64']:9.2e} {gap['replay']:9.2e}  {counts}")
        if codes:
            log(f"    fxp activation codes of the kernels' run against the plain run's: "
                f"{codes['differ']} of {codes['n']} differ, by up to {codes['max_step']} "
                f"step(s); in each forward's first fxp_matmul {codes['first_differ']}, by up "
                f"to {codes['first_max_step']}; the f64 witness's {codes['f64_differ']}")
            if codes["first_max_step"] > 1:
                failed.append(f"{pol}: a first fxp_matmul's activation code "
                              f"{codes['first_max_step']} steps from the plain run's")
        if not gap[gated] <= EXAMPLE_LOGIT_RTOL:
            failed.append(f"{pol}: logits through the kernels ({gated}) {gap[gated]:.3e} of "
                          f"the largest ({top:.4g}) from the plain versions'")
    log(f"  (logits: max |kernels - plain| / max |plain|, gate {EXAMPLE_LOGIT_RTOL:g}, under "
        "the mixed policy on the replay (the kernels with the plain run's fxp activation "
        "codes); ppl: expm1 |NLL_kernels - NLL_plain|; f64: the same of the plain versions "
        "with pofx_matmul in f64)")
    log("  storage report of the saved paper-table6 checkpoint "
        f"(policy={run.saved_policy}):")
    for line in run.storage.splitlines():
        log(f"    {line}")
    entry["launched"] = launched
    if not (launched["pofx_matmul"] > 0 and launched["fxp_matmul"] > 0):
        failed.append(f"the policies' evaluation launched {launched}")

    # (c) quickstart and serve_quantized on the card
    rows = quickstart.main(["--device", device])
    entry["quickstart"] = rows
    if not all(math.isfinite(r["rel_err"]) and r["rel_err"] < 0.2 for r in rows.values()):
        failed.append(f"quickstart: {rows}")
    reset_launches()
    served = serve_quantized.main(["--use-kernel", "--device", device])
    counts = {k: v for k, v in LAUNCHES.items() if v}
    done = sum(r.finish_reason is not None for r in served.done)
    entry["serve_quantized"] = {"done": done, "requests": len(served.requests),
                                "launches": counts}
    log(f"  serve_quantized --use-kernel: {done} of {len(served.requests)} requests done; "
        f"launches {counts}")
    if done != len(served.requests) or counts.get("pofx_matmul", 0) <= 0:
        failed.append(f"serve_quantized: {done} done, launches {counts}")
    if failed:
        raise AssertionError("; ".join(failed))


def main(argv) -> int:
    if argv[:1] == ["--dryrun-child"]:
        return dryrun_child(argv[1])
    import argparse
    ap = argparse.ArgumentParser(description="drive the port on one card")
    ap.add_argument("--phases", default=",".join(str(p) for p in range(2, 23)),
                    help="comma-separated phases after the build (default: all)")
    ap.add_argument("--example-steps", type=int, default=EXAMPLE_STEPS,
                    help="phase 22's training steps")
    args = ap.parse_args(argv)
    want = {int(p) for p in args.phases.split(",")}
    state = wait_for_card()
    import torch
    if not torch.cuda.is_available():
        driver = ("no CUDA driver library" if state is None
                  else f"cuInit returned {state[0]}, {state[1]} device(s)")
        print(f"chip_smoke: torch.cuda.is_available() is False ({driver}); needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
        from repro_torch.bench import kernels as bench_kernels
        from repro_torch.bench.common import nvidia_smi
        from repro_torch.kernels import LAUNCHES, build, reset_launches
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
    phase_s = {}
    result = {"card": card, "build_s": info["seconds"], "phase_s": phase_s}
    failed = []
    rows = []

    def phase_bench():
        """The kernel benchmark's entry point on the card; the counts are
        set to 0 just before and read just after."""
        reset_launches()
        rows.extend(bench_kernels.main(["--device", "cuda", "--out", str(OUT / "bench")]))
        result["bench_counts"] = dict(LAUNCHES)
        log(f"  launches in the kernel benchmark: {result['bench_counts']}")

    phases = [
        ("phase 2: kernel benchmark (repro_torch.bench.kernels) on the card",
         phase_bench),
        ("phase 3: main path, yi-9b full width and depth",
         lambda: result.__setitem__("main_counts", phase_main_path(torch, result))),
        ("phase 4: token identity, 4 layers, f32",
         lambda: identity(torch, result)),
        ("phase 5: mixed policy, 2 layers, f32",
         lambda: result.__setitem__("mixed_counts", phase_mixed(torch, result))),
        ("phase 6: paged main path, yi-9b full width and depth",
         lambda: result.__setitem__("paged_counts", phase_paged_main(torch, result))),
        ("phase 7: paging machinery, 4 layers, f32",
         lambda: phase_paging(torch, result)),
        ("phase 8: sampled serving, yi-9b full width, 12 layers",
         lambda: phase_sampled(torch, result)),
        ("phase 9: MoE serving, moonshot-v1-16b-a3b full width, 12 layers",
         lambda: result.__setitem__("moe_counts", phase_moe(torch, result))),
        ("phase 10: SSM serving, falcon-mamba-7b full width, 16 layers",
         lambda: phase_ssm(torch, result, *SSM_ARCHS[10])),
        ("phase 11: hybrid serving, zamba2-1.2b full width, 14 layers",
         lambda: phase_ssm(torch, result, *SSM_ARCHS[11])),
        ("phase 12: encdec serving, whisper-medium full width and depth",
         lambda: result.__setitem__("encdec_counts", phase_encdec(torch, result))),
        ("phase 13: training, yi-9b full width, 12 layers",
         lambda: phase_train(torch, result)),
        ("phase 14: training the moe, ssm, hybrid and encdec families, full width",
         lambda: phase_train_families(torch, result)),
        ("phase 15: nemotron-4-340b serving (d_head 192), full width, 2 layers",
         lambda: result.__setitem__("nemotron_counts", phase_nemotron(torch, result))),
        ("phase 16: tensor-parallel serving, tp=2",
         lambda: phase_tp(torch, result)),
        ("phase 17: training the dense family on (pod, data, model) grids",
         lambda: phase_grid_train(torch, result, pool)),
        ("phase 18: behavioral analysis (Fig. 8 sweep, Pareto policy), yi-9b width",
         lambda: phase_analysis(torch, result)),
        ("phase 19: training the moe, ssm, hybrid and encdec families on a (data 2, "
         "model 2) grid", lambda: phase_grid_families(torch, result, pool)),
        ("phase 20: the dry run against the card (yi-9b width 4 layers; yi-9b train_4k "
         "on (16, 16))", lambda: phase_dryrun(torch, result)),
        ("phase 21: serving on a (data 2, model 2) grid, yi-9b width",
         lambda: phase_grid_serve(torch, result, pool)),
        ("phase 22: the examples (train_lm --big, its policies through the kernels, "
         "quickstart, serve_quantized)",
         lambda: phase_examples(torch, result, steps=args.example_steps)),
    ]
    pool = None
    with contextlib.ExitStack() as stack:
        for label, fn in phases:
            n = int(label.split()[1].rstrip(":"))
            if n not in want:
                continue
            t0 = time.perf_counter()
            log(f"{label} ...")
            try:
                if n in GRID_POOL_PHASES and pool is None:
                    from repro_torch.launch.mesh import RankPool
                    pool = stack.enter_context(RankPool(4, "cuda", grids=GRID_POOL_GRIDS))
                    result["grid_pool_start_s"] = time.perf_counter() - t0
                    log(f"  started the grid phases' 4 ranks over {pool.backend} in "
                        f"{result['grid_pool_start_s']:.1f} s")
                fn()
                log(f"{label}: ok ({time.perf_counter() - t0:.1f}s)")
            except Exception:
                failed.append(label)
                log(f"{label}: FAILED\n{traceback.format_exc()}")
            phase_s[label.split(":")[0]] = time.perf_counter() - t0
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
    if want != set(range(2, 23)):
        log(f"ran phases {sorted(want)} only: no result line")
        return 1
    main_counts = result["main_counts"]
    pick = {"pofx_matmul": ("m=4 k=4096 n=11008 x=bf16", main_counts["pofx_matmul"]),
            "kv_flash_decode": ("fxp8 B=4 G=4 R=8 S=96 Dh=128 pos=[65, 80, 90, 96]",
                                main_counts["kv_flash_decode"]),
            "fxp_matmul": ("m=4 k=4096 n=11008", mixed["fxp_matmul"]),
            "kv_flash_paged_decode": (
                "fxp8 B=4 G=4 R=8 ps=16 pages=6 S=96 Dh=128 pos=[65, 80, 90, 96]",
                result["paged_counts"]["kv_flash_paged_decode"]),
            "pofx_decode": ("4096x11008 (8,2)", result["bench_counts"]["pofx_decode"])}
    src = {"pofx_matmul": ("src/repro_torch/csrc/pofx_matmul.cu", "src/repro/kernels/pofx_matmul.py:89"),
           "kv_flash_decode": ("src/repro_torch/csrc/kv_flash_decode.cu",
                               "src/repro/kernels/kv_flash_decode.py:139"),
           "fxp_matmul": ("src/repro_torch/csrc/fxp_matmul.cu", "src/repro/kernels/fxp_matmul.py:51"),
           "kv_flash_paged_decode": ("src/repro_torch/csrc/kv_flash_paged_decode.cu",
                                     "src/repro/kernels/kv_flash_paged_decode.py:142"),
           "pofx_decode": ("src/repro_torch/csrc/pofx_decode.cu",
                           "src/repro/kernels/pofx_decode.py:45")}
    # phase 21's path: kv_flash_decode with its lse output over each grid
    # rank's block (rank 0's launches over both calls), its row at a rank's
    # shapes beside the main path's
    grid_serve = result["grid_serve"]
    lse_shape = "lse fxp8 B=4 G=4 R=8 S=128 Dh=128 pos=[0, 37, 100, 128]"
    lse_row = next(r for r in rows if r["name"] == "kv_flash_decode" and r["shape"] == lse_shape)
    grid_launches = sum(grid_serve[c]["launches"]["kv_flash_decode"] for c in GRID_SERVE_CALLS)
    if grid_launches <= 0:
        log("FAILED: kv_flash_decode was not launched on the grid's path")
        return 1
    kernels = []
    for name, (shape, launches) in pick.items():
        if launches <= 0:
            log(f"FAILED: {name} was not launched on the path that runs it")
            return 1
        row = next(r for r in rows if r["name"] == name and r["shape"] == shape)
        kernels.append({"name": name, "route": "cuda", "source": src[name][0],
                        "replaces": src[name][1], "launches": launches,
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                        "shape": shape})
        if name == "kv_flash_decode":
            kernels[-1]["grid_lse"] = {
                "launches": grid_launches, "shape": lse_shape,
                **{k: lse_row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}}
    log(f"total {result['seconds']:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
