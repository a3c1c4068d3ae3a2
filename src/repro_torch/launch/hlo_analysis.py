"""Roofline terms and collective bytes on the wire, at an H100's rates.

Port of ``repro/launch/hlo_analysis.py``. The reference prices a compiled
step with TPU v5e constants; here the same formula takes the H100 SXM
data sheet's:

    989 TFLOP/s bf16 (dense) | 3.35 TB/s HBM3
    450 GB/s NVLink 4 per direction per GPU, within a node of NODE_GPUS
    50 GB/s (one 400 Gb/s NIC per GPU) between nodes

The v5e's one ICI rate becomes two links: a collective whose group lies in
one node of NODE_GPUS consecutive ranks runs over NVLink, any other over
the network. ``roofline_terms`` takes those in-node bytes apart
(``wire_bytes_in_node``); with none it is the reference's formula with the
constant swapped.

``wire_bytes`` is the reference's ring rule for one collective (bytes on
the wire per device, from its result's bytes and its group's size):

    all-gather          out_bytes * (g-1)/g
    all-reduce          2 * bytes * (g-1)/g     (reduce-scatter + all-gather)
    reduce-scatter      out_bytes * (g-1)        (input = out * g)
    all-to-all          tuple_bytes * (g-1)/g
    collective-permute  bytes                    (one send/recv)

The reference's ``parse_collectives`` (and ``hlo_parser.analyze_hlo``) read
that from post-SPMD HLO text, which PyTorch does not have: their
counterpart is ``launch.op_cost.count_step``, which counts the collectives
as the step calls them.
"""
from __future__ import annotations

from typing import Dict, Iterable

__all__ = ["roofline_terms", "wire_bytes", "in_node", "KINDS", "PEAK_FLOPS_BF16",
           "HBM_BW", "NVLINK_BW", "NET_BW", "NODE_GPUS", "HBM_BYTES"]

PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
NET_BW = 50e9
NODE_GPUS = 8
# an H100's device memory, against which a rank's peak is held
HBM_BYTES = 80 * 2**30

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Bytes on the wire per device of one collective of ``kind`` whose
    result is ``nbytes``, over a group of ``group`` ranks (the ring rule)."""
    g = group
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes
    raise ValueError(f"unknown collective {kind!r} (one of {KINDS})")


def in_node(ranks: Iterable[int]) -> bool:
    """Whether the global ``ranks`` all lie in one node of NODE_GPUS
    consecutive ranks (their collectives run over NVLink)."""
    return len({r // NODE_GPUS for r in ranks}) <= 1


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float, model_flops_global: float,
                   n_devices: int, wire_bytes_in_node: float = 0.0) -> Dict[str, float]:
    """The three roofline terms, in seconds, plus derived ratios: the
    reference's keys and formula. ``wire_bytes_in_node`` of the wire bytes
    run over NVLink, the rest over the network."""
    t_compute = flops_per_device / PEAK_FLOPS_BF16
    t_memory = bytes_per_device / HBM_BW
    t_collective = (wire_bytes_in_node / NVLINK_BW
                    + (wire_bytes_per_device - wire_bytes_in_node) / NET_BW)
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_collective}
    bound = max(terms, key=terms.get)
    t_bound = terms[bound]
    model_t = model_flops_global / (n_devices * PEAK_FLOPS_BF16)
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
        "bound": bound,
        "step_lower_bound_s": t_bound,
        # fraction of peak compute achievable at the roofline bound
        "mfu_bound": (model_t / t_bound) if t_bound > 0 else float("nan"),
        "useful_flops_ratio": (model_flops_global
                               / (flops_per_device * n_devices)
                               if flops_per_device else float("nan")),
    }
