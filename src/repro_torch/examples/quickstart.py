"""Quickstart: the paper's pipeline in a few lines.

Port of ``examples/quickstart.py``:

1. take float weights,
2. store them as (N-1)-bit normalized posit codes (ExPAN(N)D's format),
3. run a matmul through the PoFx datapath (decode -> FxP -> matmul),
4. compare against fp32 and against FxP8 storage.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

``main`` returns each format's row: bits per weight, storage bytes and
the matmul's relative error against fp32.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.policy import parse_spec
from repro_torch.core.quantizers import quantize, storage_bits
from repro_torch.kernels.ops import quant_matmul
from repro_torch.nn.models import resolve_device

__all__ = ["FORMATS", "main"]

FORMATS = ("fxp8", "posit8es2", "pofx8es2", "pofx6es2")     # pofx8es2: the paper's


def main(argv: Optional[List[str]] = None) -> Dict[str, Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.05, (512, 256)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(0, 1.0, (8, 512)).astype(np.float32)).to(dev)
    y_ref = x @ w

    rows: Dict[str, Dict[str, float]] = {}
    print(f"{'format':<14} {'bits/w':>7} {'storage':>10} {'matmul rel err':>15}")
    for name in FORMATS:
        qt = quantize(w, parse_spec(name), axis=-1)
        y = quant_matmul(x, qt, out_dtype=torch.float32)
        rel = float(torch.linalg.norm(y - y_ref) / torch.linalg.norm(y_ref))
        bits = storage_bits(qt)
        rows[name] = {"bits_per_weight": bits / w.numel(), "storage_bits": bits,
                      "rel_err": rel}
        print(f"{name:<14} {bits / w.numel():7.2f} {bits / 8 / 1024:8.1f}KiB {rel:15.5f}")
    qt = quantize(w, parse_spec("pofx8es2"), axis=-1)
    print("matmul ok:", tuple(quant_matmul(x, qt).shape), "codes dtype:", qt.codes.dtype)
    return rows


if __name__ == "__main__":
    main()
