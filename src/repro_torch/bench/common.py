"""Shared pieces of the port's benchmarks: the card's published rates, the
least time a piece of work can take, the kernel timer and CSV output."""
from __future__ import annotations

import csv
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["HBM_BPS", "PEAK", "bound_ms", "Timer", "nvidia_smi", "out_dir",
           "write_csv"]

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s and peak rates by type
HBM_BPS = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}

# src/repro_torch/bench -> the checkout root
ROOT = Path(__file__).resolve().parents[3]


def bound_ms(nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of ``kind``; returns
    (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / PEAK[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Median time of single calls. On the card: CUDA events around each
    launch, L2 flushed before each (the serving path streams far more than
    the 50 MB L2 between two calls), 15 launches after 2 warm-up calls. After
    the flush the card sleeps for ``HOLD_CYCLES`` clock cycles before the
    first event, so that the host has queued the call by the time the events
    start: the time is the card's, not the wrapper's Python. The flush
    writes, so up to the L2's 50 MB of dirty lines are written back while the
    timed call runs; ``clean=True`` reads a 96 MB buffer after it, so that
    the call finds the L2 cold but clean, as the serving path leaves it
    (weights are only read). On the CPU: the host clock over 3 calls, a CPU
    time and nothing else."""

    HOLD_CYCLES = 200_000    # ~0.1 ms at the H100's clocks

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        card = self.device.type == "cuda"
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=self.device) if card else None
        self.sweep = torch.zeros(96 << 20, dtype=torch.uint8, device=self.device) if card else None

    def ms(self, fn, iters: int = 15, clean: bool = False) -> float:
        if self.flush is None:
            return self._host_ms(fn, min(iters, 3))
        for _ in range(2):
            fn()
        times = []
        for _ in range(iters):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            self.flush.zero_()
            if clean:
                self.sweep.max()
            torch.cuda._sleep(self.HOLD_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]

    @staticmethod
    def _host_ms(fn, iters: int) -> float:
        fn()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        return times[len(times) // 2]


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def out_dir(out: Optional[str] = None) -> Path:
    """Where a benchmark writes: ``out``, else ``$REPRO_BENCH_OUT``, else
    ``chiprun_out/bench/`` at the checkout root."""
    return Path(out or os.environ.get("REPRO_BENCH_OUT") or ROOT / "chiprun_out" / "bench")


def write_csv(name: str, rows: List[Dict], out: Optional[str] = None) -> Path:
    """``rows`` (dicts; the header is the union of their keys in first-seen
    order) to ``<out_dir>/<name>.csv``; returns the path."""
    d = out_dir(out)
    d.mkdir(parents=True, exist_ok=True)
    keys: List[str] = []
    for r in rows:
        keys += [k for k in r if k not in keys]
    path = d / f"{name}.csv"
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)
    return path
