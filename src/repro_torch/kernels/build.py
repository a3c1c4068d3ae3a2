"""Build the hand-written CUDA kernels in ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded through ctypes; every C
entry returns ``cudaGetLastError()`` and the wrappers raise on a non-zero
value. The build runs at first use, all sources in parallel, into
``build/repro_torch/<hash of the sources>/`` at the root of the checkout
(listed in ``.gitignore``), so an edited source rebuilds and an unchanged one
loads from there. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "build_dir", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNELS = ("pofx_matmul", "kv_flash_decode", "fxp_matmul")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    # src/repro_torch/kernels -> the checkout root
    return (Path(__file__).resolve().parents[3] / "build" / "repro_torch"
            / _sources_hash())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels are built from source on the machine with the card")
    return str(path)


@functools.lru_cache(maxsize=1)
def build_all() -> Dict[str, object]:
    """Compile every kernel library that is not built yet, in parallel.

    Returns {"seconds": wall time, "dir": build dir, "log": nvcc's -v
    output (registers, shared memory, spills) per kernel}.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in KERNELS:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    log = {}
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        text, _ = proc.communicate()
        log[name] = text
        (out / f"{name}.nvcc.log").write_text(text)
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(log[n] for n in failed))
    return {"seconds": time.perf_counter() - t0, "dir": str(out), "log": log}


_SIGNATURES = {
    "pofx_matmul": {
        name: [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        for name in ("pofx_matmul_f32", "pofx_matmul_bf16")},
    "kv_flash_decode": {
        "kv_flash_decode": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p]},
    "fxp_matmul": {
        "fxp_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]},
}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use), with
    argtypes/restype declared for every entry."""
    build_all()
    lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
