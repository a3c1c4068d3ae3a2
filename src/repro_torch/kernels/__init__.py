"""repro_torch.kernels — hand-written Hopper kernels for the PoFx hot path.

pofx_decode:     Algorithm 1 on every code (posit codes -> FxP int8),
                 csrc/pofx_decode.cu (the device function is
                 csrc/pofx_common.cuh)
pofx_matmul:     fused PoFx decode + matmul (Move&Store), csrc/pofx_matmul.cu
kv_flash_decode: flash-decode over a byte-wide quantized KV cache,
                 csrc/kv_flash_decode.cu
fxp_matmul:      int8 x int8 -> int32 MAC, csrc/fxp_matmul.cu
kv_flash_paged_decode: flash-decode through a block table over a page pool,
                 csrc/kv_flash_paged_decode.cu (shares the body
                 csrc/kv_flash_common.cuh with kv_flash_decode)
ref:             the plain PyTorch versions every kernel is held against.

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it computes the plain version. ``LAUNCHES`` counts kernel launches
per kernel, so a run can show that its path went through them.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"pofx_matmul": 0, "kv_flash_decode": 0,
                            "fxp_matmul": 0, "kv_flash_paged_decode": 0,
                            "pofx_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def require_cuda(what: str, *tensors) -> None:
    """Raise unless every tensor lies on one CUDA device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what}: kernel inputs must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
