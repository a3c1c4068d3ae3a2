"""Serving example: continuous-batching generation with PoFx-stored weights.

Port of ``examples/serve_quantized.py``. Wraps ``repro_torch.launch.serve``:
initializes a model at the smoke size, quantizes the weights to the
paper's normalized-posit format, and serves a staggered stream of requests
through the slot-based engine (admission, chunked decode, per-slot
stopping), reporting storage and throughput. ``--use-kernel`` routes the
quantized matmuls through the PoFx/FxP kernels (on the CPU their plain
versions).

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_quantized --use-kernel \\
        --temperature 0.8

``main`` returns the CLI's ``ServeRun``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.launch.serve import ServeRun, main as serve_main

__all__ = ["main"]


def main(argv: Optional[List[str]] = None) -> ServeRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--quant", default="pofx8")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cli = ["--arch", args.arch, "--smoke", "--quant", args.quant,
           "--batch", "4", "--prompt-len", "48", "--gen", "16",
           "--arrival-gap", "4", "--temperature", str(args.temperature),
           "--device", args.device]
    if args.use_kernel:
        cli.append("--use-kernel")
    return serve_main(cli)


if __name__ == "__main__":
    main()
