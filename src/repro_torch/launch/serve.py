"""Serving CLI: continuous-batching quantized serving on the card.

Port of ``repro/launch/serve.py`` (engine path, dense or paged cache, and
the one-shot ``--legacy`` loop; every family; tensor parallelism).
Weights are post-training-quantized per a QuantPolicy as they are drawn,
served by the continuous-batching engine; ``--use-kernel`` routes every quantized
matmul through the hand-written PoFx/FxP kernels and, with ``--kv-quant``,
decode attention through the flash-decode kernel (``--paged``: the paged
flash-decode kernel over a page pool with prefix sharing):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --quant pofx8 --kv-quant fxp8 --use-kernel [--paged --page-size 16]

``--arch moonshot-v1-16b-a3b`` serves the MoE family the same way (its
expert products are plain PyTorch on dequantized weights, as in the
reference; attention, the shared experts and the unembed take the kernels).
``--arch falcon-mamba-7b`` (ssm: mamba1 layers) and ``--arch zamba2-1.2b``
(hybrid: mamba2 layers and one shared attention block) serve their
recurrent state in the dense engine: in_proj, out_proj, the shared block
and the unembed take the kernels, the mixers are plain PyTorch, and
``--paged`` and ``--prompt-bucket`` > 1 are refused as in the reference.

``--legacy`` (automatic for encdec, ``--arch whisper-medium``, whose
encoder needs per-batch frames) runs the reference's one-shot fixed-batch
greedy loop instead: ``--batch`` sequences of ``--prompt-len`` tokens and,
for encdec, as many encoder frames, drawn as the reference draws them
(``jax.random.randint(PRNGKey(1), ...)``, ``jax.random.normal(PRNGKey(2),
...)``, ``core.prng``), one batched prefill and ``--gen`` - 1 greedy
decode steps at one position for the whole batch. encdec serves with a
bf16 KV cache (a quantized one is dropped with a message, as in the
reference) and refuses ``--paged``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --quant pofx8 --kv-quant fxp8 --use-kernel

``--smoke`` serves the reduced config; ``--device cpu`` runs on the CPU
(the kernels' plain versions). ``--temperature``/``--top-k`` sample every
request (greedy by default) and draw the reference's streams. ``--gen`` counts tokens generated per
request: the first from the prefill logits, ``gen-1`` from decode steps.
``--tp N`` serves tensor-parallel (DESIGN.md §9): N rank processes
(``launch.mesh.RankPool``; rank r on ``cuda:(r % device_count)``, or on the
CPU under ``--device cpu``), each holding its shard of the attention heads,
the MLP hidden, the experts and the KV cache's heads, with one all-reduce
after each row-sharded projection over gloo (the CPU, or ranks sharing a
card) or NCCL (a card a rank). Each rank runs the engine with the same
requests; rank 0 prints, its header gains ``tp=N`` and the backend.
``--tp`` with ``--legacy`` or encdec is refused, as in the reference:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --tp 2

``main`` returns what it served (a ``ServeRun``: the engine and its
requests, or the one-shot loop's ``LegacyRun``), so a calling script can
read the engine's stats or the loop's tokens and reuse the model. Under
``--tp`` it returns rank 0's requests, streams and stats (no model or
engine: they live in the rank processes), every rank's kernel launch counts
and, given ``rank_hook(run, ctx)``, what the hook returned in each rank.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, RunConfig, smoke as smoke_cfg, truncate
from repro_torch.core import prng
from repro_torch.core.policy import (QuantPolicy, add_kv_quant_arg,
                                     add_policy_arg, format_spec,
                                     resolve_kv_spec, storage_report)
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.launch.engine import (Request, RequestState, SamplingParams,
                                      ServeEngine)
from repro_torch.launch.mesh import RankPool
from repro_torch.nn.models import build_model, kv_decode_bytes_per_token
from repro_torch.nn.sharding import TPContext


@dataclasses.dataclass
class LegacyRun:
    """What the one-shot loop served: the (B, P) prompts, the (B, P,
    d_model) f32 frames (encdec, else None), the (B, gen) greedy tokens,
    the last step's logits and the wall seconds of the prefill and of the
    gen - 1 decode steps."""
    prompts: torch.Tensor
    frames: Optional[torch.Tensor]
    tokens: np.ndarray
    logits: torch.Tensor
    prefill_s: float
    decode_s: float


@dataclasses.dataclass
class ServeRun:
    """What ``main`` served. Under ``--tp`` (``tp`` > 1) it is rank 0's:
    ``model``, ``params`` and ``engine`` are None, ``stats`` is the engine's,
    ``rank_launches`` holds each rank's kernel launch counts and
    ``rank_hooks`` what ``rank_hook`` returned in each rank."""
    model: Any
    params: Any
    engine: Optional[ServeEngine]
    requests: List[Request]
    done: List[RequestState]
    legacy: Optional[LegacyRun] = None
    stats: Optional[dict] = None
    tp: int = 1
    backend: Optional[str] = None
    rank_launches: Optional[List[dict]] = None
    rank_hooks: Optional[list] = None


def make_requests(vocab: int, n: int, prompt_len: int, gen: int,
                  arrival_gap: float = 0.0, seed: int = 1,
                  sampling: SamplingParams = SamplingParams()) -> List[Request]:
    """``n`` requests of seeded random prompts, one every ``arrival_gap``
    decode steps, all with ``sampling``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, prompt_len),
                    max_new=gen, sampling=sampling, arrival=i * arrival_gap)
            for i in range(n)]


def legacy_inputs(cfg, batch: int, prompt_len: int):
    """The reference CLI's one-shot inputs, drawn on the CPU: (B, P) int64
    prompts from ``randint(PRNGKey(1), (B, P), 0, vocab)`` and, for
    encdec, (B, P, d_model) f32 frames from ``normal(PRNGKey(2), ...)``
    (else None)."""
    prompts = prng.randint(prng.PRNGKey(1), (batch, prompt_len), 0, cfg.vocab_size)
    frames = None
    if cfg.family == "encdec":
        frames = prng.normal(prng.PRNGKey(2), (batch, prompt_len, cfg.d_model))
    return prompts.long(), frames


def _wait(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def legacy_loop(model, params, prompts: torch.Tensor, frames, gen: int):
    """One-shot fixed-batch greedy serving (the encdec path): one batched
    prefill into a cache of ``P + gen`` positions (the cross cache sized
    P), then ``gen - 1`` greedy decode steps at one scalar position.
    Returns (tokens (B, gen) on the host, the last logits, prefill
    seconds, decode seconds)."""
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen, enc_len=P)
    prompts = prompts.to(model.device)
    if frames is not None:
        frames = frames.to(model.device)
    t0 = time.perf_counter()
    cache, logits = model.prefill(params, prompts, cache=cache, frames=frames)
    _wait(logits)
    t_prefill = time.perf_counter() - t0
    tok = torch.argmax(logits, dim=-1)[:, None]
    outs = [tok]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        cache, logits = model.decode_step(params, cache, tok)
        tok = torch.argmax(logits, dim=-1)[:, None]
        outs.append(tok)
    _wait(tok)
    t_decode = time.perf_counter() - t0
    return torch.cat(outs, dim=1).cpu().numpy(), logits, t_prefill, t_decode


def _legacy_main(args, cfg, model, params) -> LegacyRun:
    """The reference's ``_legacy_main``: generates exactly ``args.gen``
    tokens a sequence (1 from the prefill logits + ``gen - 1`` decode
    steps), and the rates divide by the matching counts."""
    B, P = args.batch, args.prompt_len
    prompts, frames = legacy_inputs(cfg, B, P)
    gen, logits, t_prefill, t_decode = legacy_loop(model, params, prompts, frames,
                                                   args.gen)
    n_steps = args.gen - 1
    if torch.isnan(logits).any():      # must survive `python -O`
        raise RuntimeError("NaN logits")
    print(f"prefill: {B}x{P} tokens in {t_prefill:.3f}s "
          f"({B*P/t_prefill:.0f} tok/s, +1 sampled token/seq)")
    if n_steps:
        print(f"decode:  {n_steps} steps x {B} seqs in {t_decode:.3f}s "
              f"({n_steps*B/t_decode:.1f} tok/s)")
    print(f"total:   {args.gen} tokens/seq x {B} seqs")
    print(f"sample ({gen.shape[1]} tokens):", gen[0, :16].tolist(),
          "..." if gen.shape[1] > 16 else "")
    return LegacyRun(prompts, frames, gen, logits, t_prefill, t_decode)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-9b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve the arch's first N layers at full width "
                         "(0 = every layer)")
    ap.add_argument("--device", default="cuda")
    add_policy_arg(ap, default="pofx8")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route quantized matmuls through the PoFx/FxP "
                         "kernels and quantized-KV decode through the "
                         "flash-decode kernel")
    add_kv_quant_arg(ap)
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slots (legacy: fixed batch size)")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests to serve (default: 2x slots)")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32,
                    help="tokens generated per request")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0, help="0 = off")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="stop token id (<0 = none)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per engine chunk")
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="virtual decode steps between request arrivals")
    ap.add_argument("--prompt-bucket", type=int, default=1,
                    help="round prompt lengths up to this multiple")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: fixed-size token pages + per-slot "
                         "block tables + radix prefix sharing; token "
                         "streams identical to the dense engine (dense "
                         "and moe families)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="page pool size (--paged; 0 = dense-equivalent "
                         "capacity + headroom)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel devices (1-D 'tp' mesh): shards "
                         "attention heads / MLP hidden / experts and the KV "
                         "cache's head axis over N devices; greedy outputs "
                         "are token-identical to --tp 1 (DESIGN.md §9; CPU: "
                         "set XLA_FLAGS=--xla_force_host_platform_"
                         "device_count=N)")
    ap.add_argument("--legacy", action="store_true",
                    help="one-shot fixed-batch greedy loop (no engine)")
    return ap


def main(argv=None, rank_hook=None) -> ServeRun:
    """Serve per the CLI's flags (``argv``, default ``sys.argv[1:]``).
    ``rank_hook(run, ctx)``, a module-level function, runs in every rank
    after a ``--tp`` run (its ``ServeRun`` with the model, engine and the
    rank's ``TPContext``) and its picklable result comes back in
    ``rank_hooks``."""
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    cfg = _config(args)
    legacy = args.legacy or cfg.family == "encdec"
    if args.tp > 1 and legacy:
        ap.error("--tp needs the engine path (not --legacy / encdec)")
    if args.paged and legacy:
        ap.error("--paged needs the engine path (not --legacy / encdec)")
    if args.paged and cfg.family not in ("dense", "moe"):
        ap.error(f"--paged supports dense/moe families, not {cfg.family}")
    P, G = args.prompt_len, args.gen
    if not legacy and ((args.requests or 2 * args.batch) < 1 or G < 1 or P < 1):
        ap.error("--requests/--gen/--prompt-len must be >= 1")
    if args.tp > 1:
        return _main_tp(argv, args, rank_hook)
    return _serve(args, cfg, legacy)


def _config(args):
    cfg = truncate(ARCHS[args.arch], args.layers)
    return smoke_cfg(cfg) if args.smoke else cfg


def _serve_rank(ctx: TPContext, device: str, argv, rank_hook):
    """One rank of a ``--tp`` run: serve on ``device`` with the rank's
    shard (rank 0 prints); returns (rank 0's ServeRun without the model,
    params and engine, or None; the rank's launch counts; the hook's
    result)."""
    args = _parser().parse_args(argv)
    cfg = _config(args)
    args.device = device
    reset_launches()
    if ctx.rank:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            run = _serve(args, cfg, False, tp=ctx)
    else:
        run = _serve(args, cfg, False, tp=ctx)
    launches = dict(LAUNCHES)
    hooked = rank_hook(run, ctx) if rank_hook is not None else None
    if ctx.rank:
        return None, launches, hooked
    return dataclasses.replace(run, model=None, params=None, engine=None), launches, hooked


def _main_tp(argv, args, rank_hook) -> ServeRun:
    """``--tp N``: the ranks in processes of their own; rank 0's run back."""
    threads = max(1, (os.cpu_count() or 1) // args.tp) if args.device == "cpu" else 0
    with RankPool(args.tp, args.device, threads=threads) as pool:
        res = pool.run(_serve_rank, argv, rank_hook)
    run = res[0][0]
    return dataclasses.replace(run, rank_launches=[r[1] for r in res],
                               rank_hooks=[r[2] for r in res])


def _serve(args, cfg, legacy: bool, tp: Optional[TPContext] = None) -> ServeRun:
    """The CLI's serving body, on one device (one rank's, given ``tp``)."""
    rcfg = RunConfig(remat="none")
    policy = QuantPolicy.from_string(args.quant)
    kv_spec = resolve_kv_spec(args.kv_quant, policy)
    if kv_spec is not None and cfg.family == "encdec":
        print("(encdec: quantized KV cache unsupported on the legacy "
              "one-shot path; serving with a bf16 cache)")
        kv_spec = None
    model = build_model(cfg, rcfg, device=args.device,
                        use_kernel=args.use_kernel, kv_spec=kv_spec, tp=tp)
    params = model.init(0, policy=policy)
    tp_size = model.tp.size
    print(f"[{args.arch} quant={policy.to_string()} "
          f"kv={format_spec(kv_spec) if kv_spec else 'bf16'} "
          f"kernel={'cuda' if args.use_kernel else 'torch-lut'} "
          f"device={model.device}"
          f"{f' tp={tp_size} backend={model.tp.backend}' if tp_size > 1 else ''}]")
    if tp_size > 1:
        print(f"  (rank 0's shard of {tp_size}: heads, MLP hidden, experts and "
              f"KV heads split; embed, unembed, norms, router, mixers replicated)")
    print(storage_report(params, policy))
    ctx_len = args.prompt_len + args.gen
    kv_q = kv_decode_bytes_per_token(cfg, ctx_len, kv_spec)
    kv_b = kv_decode_bytes_per_token(cfg, ctx_len, None)
    if kv_spec is not None and kv_q["code_bytes"]:
        print(f"  kv cache @ {ctx_len} ctx: "
              f"{kv_q['code_bytes'] / 2**10:.1f} KiB/token streamed "
              f"(+{kv_q['scale_bytes'] / 2**10:.1f} KiB static scales) vs "
              f"bf16 {kv_b['code_bytes'] / 2**10:.1f} KiB "
              f"({kv_b['code_bytes'] / kv_q['code_bytes']:.1f}x less decode "
              f"memory traffic)")

    if legacy:
        if not args.legacy:
            print("(encdec: engine unsupported, using one-shot path)")
        ignored = [f for f, on in (
            ("--temperature", args.temperature != 0.0),
            ("--top-k", args.top_k != 0),
            ("--requests", args.requests != 0),
            ("--arrival-gap", args.arrival_gap != 0.0),
            ("--prompt-bucket", args.prompt_bucket > 1),
            ("--eos-id", args.eos_id >= 0),
            ("--chunk", args.chunk != 8)) if on]
        if ignored:
            print(f"(legacy path is greedy fixed-batch; ignoring "
                  f"{', '.join(ignored)})")
        return ServeRun(model, params, None, [], [],
                        legacy=_legacy_main(args, cfg, model, params))

    P, G = args.prompt_len, args.gen
    n_req = args.requests or 2 * args.batch
    engine = ServeEngine(
        model, params, n_slots=args.batch, max_len=P + G,
        eos_id=args.eos_id if args.eos_id >= 0 else None,
        chunk=args.chunk, prompt_bucket=args.prompt_bucket, seed=0,
        paged=args.paged, page_size=args.page_size,
        n_pages=args.n_pages or None)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k)
    requests = make_requests(cfg.vocab_size, n_req, P, G, args.arrival_gap,
                             sampling=sampling)
    done = engine.run(requests)

    stats = engine.stats()
    n_prefill_tok = sum(len(s.context) for s in done)
    n_gen = stats["generated_tokens"]
    n_dec = stats["decode_tokens"]
    print(f"served {len(done)} requests on {args.batch} slots "
          f"(chunk={args.chunk}, arrival gap={args.arrival_gap} steps)")
    print(f"prefill: {n_prefill_tok} prompt tokens in "
          f"{engine.prefill_time:.3f}s ({n_prefill_tok/engine.prefill_time:.0f}"
          f" tok/s, +{stats['prefill_sampled_tokens']} sampled tokens)")
    print(f"decode:  {engine.decode_steps} steps, {n_dec} tokens in "
          f"{engine.decode_time:.3f}s ({n_dec/max(engine.decode_time,1e-9):.1f}"
          f" tok/s)")
    print(f"total:   {n_gen} generated tokens in {engine.total_time:.3f}s "
          f"({n_gen/engine.total_time:.1f} tok/s end-to-end)")
    if args.paged:
        print(f"paging:  page={engine.page_size} tok, "
              f"{stats['resident_pages']}/{engine.n_pages - 1} pages "
              f"resident, prefix hits {stats['prefix_hits']}/"
              f"{stats['prefix_queries']} "
              f"(rate {stats['prefix_hit_rate']:.2f}, "
              f"{stats['prefix_hit_tokens']} prefill tokens skipped), "
              f"{stats['pages_freed']} pages freed on evict/finish, "
              f"{stats['cow_copies']} CoW copies")
    if any(len(s.out) > G for s in done):
        raise RuntimeError("engine generated more than --gen tokens")
    s0 = done[0]
    print(f"sample rid=0 ({len(s0.out)} tokens, {s0.finish_reason}):",
          s0.out[:16], "..." if len(s0.out) > 16 else "")
    return ServeRun(model, params, engine, requests, done, stats=stats,
                    tp=tp_size, backend=model.tp.backend if tp_size > 1 else None)


if __name__ == "__main__":
    main()
