"""The port's pofx_decode against the reference's Pallas kernel (interpret
mode on the CPU, as tests/test_kernels.py runs it): bit for bit.

On CPU tensors the wrapper computes its plain version, ``pofx_decode_ref``;
both are held exactly to ``repro.kernels.pofx_decode.pofx_decode`` on
random codes at aligned and ragged shapes and on every code of every pofx
spec of ``default_spec_grid``. The CUDA kernel is held to the same plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.analysis import default_spec_grid
from repro.kernels.pofx_decode import pofx_decode as j_pofx_decode
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.ops import pofx_decode as ops_pofx_decode
from repro_torch.kernels.pofx_decode import pofx_decode, pofx_decode_ref
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

POFX_SPECS = sorted({(s.N, s.ES, s.M) for s in default_spec_grid() if s.kind == "pofx"})


def _reference(codes, N, ES, M=8):
    out = j_pofx_decode(jnp.asarray(codes), N, ES, M, block=(64, 128), interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("shape", [(128, 256), (257, 130), (1, 17), (33, 1)])
@pytest.mark.parametrize("N,ES", [(8, 2), (6, 1), (7, 3)])
def test_pofx_decode_matches_pallas_kernel(shape, N, ES):
    codes = np.random.default_rng(N * 10 + ES).integers(0, 1 << (N - 1), shape).astype(np.uint8)
    want = _reference(codes, N, ES)
    before = dict(LAUNCHES)
    got = pofx_decode(torch.from_numpy(codes), N, ES)
    assert LAUNCHES == before                        # CPU tensors: plain version
    assert got.dtype == torch.int8 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pofx_decode_ref(torch.from_numpy(codes), N, ES).numpy(), want)


@pytest.mark.parametrize("N,ES,M", POFX_SPECS)
def test_every_code_of_every_pofx_spec(N, ES, M):
    """An (L, L) tile of arange(L): every code in every row and column."""
    L = 1 << (N - 1)
    tile = np.tile(np.arange(L, dtype=np.uint8), (L, 1))
    want = _reference(tile, N, ES, M)
    got = pofx_decode(torch.from_numpy(tile), N, ES, M)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.tile(want[0], (L, 1)))


def test_high_bits_above_the_code_are_ignored_like_the_reference():
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for N, ES in ((6, 1), (8, 2)):
        want = _reference(codes, N, ES)
        assert np.array_equal(pofx_decode(torch.from_numpy(codes), N, ES).numpy(), want)


def test_ops_exports_the_wrapper():
    assert ops_pofx_decode is pofx_decode


@pytest.mark.parametrize("bad,match", [
    (dict(N=10), "byte-wide"), (dict(N=2), "byte-wide"), (dict(ES=5), "ES"),
    (dict(M=9), "int8"), (dict(M=0), "int8")])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad, match):
    args = {"N": 8, "ES": 2, "M": 8} | bad
    with pytest.raises(ValueError, match=match):
        pofx_decode(torch.zeros(4, 4, dtype=torch.uint8), **args)


def test_wrapper_rejects_other_ranks():
    with pytest.raises(ValueError, match="2-D"):
        pofx_decode(torch.zeros(16, dtype=torch.uint8), 8, 2)
