"""Serving CLI: continuous-batching quantized serving on the card.

Port of ``repro/launch/serve.py`` (engine path, dense or paged cache, the
dense, moe, ssm and hybrid families; tensor parallelism and the legacy
one-shot loop, which serves encdec, are later slices). Weights are post-training-quantized per a QuantPolicy
as they are drawn, served by
the continuous-batching engine; ``--use-kernel`` routes every quantized
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

``--smoke`` serves the reduced config; ``--device cpu`` runs on the CPU
(the kernels' plain versions). ``--temperature``/``--top-k`` sample every
request (greedy by default) and draw the reference's streams. ``--gen`` counts tokens generated per
request: the first from the prefill logits, ``gen-1`` from decode steps.
``main`` returns what it served (a ``ServeRun``), so a driver script can
read the engine's stats and reuse the model.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, List

import numpy as np

from repro_torch.configs import ARCHS, RunConfig, smoke as smoke_cfg
from repro_torch.core.policy import (QuantPolicy, add_kv_quant_arg,
                                     add_policy_arg, format_spec,
                                     resolve_kv_spec, storage_report)
from repro_torch.launch.engine import (Request, RequestState, SamplingParams,
                                      ServeEngine)
from repro_torch.nn.models import build_model, kv_decode_bytes_per_token


@dataclasses.dataclass
class ServeRun:
    model: Any
    params: Any
    engine: ServeEngine
    requests: List[Request]
    done: List[RequestState]


def make_requests(vocab: int, n: int, prompt_len: int, gen: int,
                  arrival_gap: float = 0.0, seed: int = 1,
                  sampling: SamplingParams = SamplingParams()) -> List[Request]:
    """``n`` requests of seeded random prompts, one every ``arrival_gap``
    decode steps, all with ``sampling``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, prompt_len),
                    max_new=gen, sampling=sampling, arrival=i * arrival_gap)
            for i in range(n)]


def main(argv=None) -> ServeRun:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="yi-9b", choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    add_policy_arg(ap, default="pofx8")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route quantized matmuls through the PoFx/FxP "
                         "kernels and quantized-KV decode through the "
                         "flash-decode kernel")
    add_kv_quant_arg(ap)
    ap.add_argument("--batch", type=int, default=4, help="engine slots")
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
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_cfg(cfg)
    if args.paged and cfg.family not in ("dense", "moe"):
        ap.error(f"--paged supports dense/moe families, not {cfg.family}")
    rcfg = RunConfig(remat="none")
    policy = QuantPolicy.from_string(args.quant)
    kv_spec = resolve_kv_spec(args.kv_quant, policy)
    model = build_model(cfg, rcfg, device=args.device,
                        use_kernel=args.use_kernel, kv_spec=kv_spec)
    params = model.init(0, policy=policy)
    print(f"[{args.arch} quant={policy.to_string()} "
          f"kv={format_spec(kv_spec) if kv_spec else 'bf16'} "
          f"kernel={'cuda' if args.use_kernel else 'torch-lut'} "
          f"device={model.device}]")
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

    P, G = args.prompt_len, args.gen
    n_req = args.requests or 2 * args.batch
    if n_req < 1 or G < 1 or P < 1:
        ap.error("--requests/--gen/--prompt-len must be >= 1")
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
    return ServeRun(model, params, engine, requests, done)


if __name__ == "__main__":
    main()
