"""The split-k plan of the fxp_matmul kernel, and its int32 arithmetic.

``kernels/fxp_matmul.py::plan`` cuts k into slices from the block at m and
(k, n); the CUDA kernel (``csrc/fxp_matmul.cu``) sums each slice's products
in int32 and the last block of each output tile adds the slices' partials.
The kernel runs only on the card, so here a plain-torch emulation of that
split and combine, at the plan's slices, is held against the plain version
and against the reference's Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fxp_matmul import fxp_matmul as j_fxp_matmul
from repro_torch.kernels.fxp_matmul import fxp_matmul_ref, plan, tile
from repro_torch.kernels.pofx_matmul import BK, BN, MAX_SLICES, SMS, Plan
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

# yi-9b's mlp projections (the fxp rules of mixed policies) and the other
# weight shapes, then ragged k and n
SERVING = [(4096, 11008), (11008, 4096), (4096, 4096), (4096, 512), (4096, 64000)]
RAGGED = [(1, 5), (33, 70), (63, 777), (64, 16), (65, 130), (129, 300), (1000, 777),
          (4097, 11008), (11007, 4096)]
MS = [1, 4, 8, 16, 17, 32, 33, 64, 65, 130]


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", SERVING + RAGGED)
def test_plan_slices_cover_k_once(m, k, n):
    p = plan(m, k, n)
    assert isinstance(p, Plan) and p.slice_len % BK == 0 and p.slice_len >= BK
    # slices [s * L, (s + 1) * L) cover [0, k) once: the last one starts below k
    assert (p.slices - 1) * p.slice_len < k <= p.slices * p.slice_len
    # each slice holds two BK tiles or more unless k has fewer
    assert p.slice_len >= min(2 * BK, -(-k // BK) * BK)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", SERVING + RAGGED)
def test_plan_slices_and_blocks_are_bounded(m, k, n):
    rows, wg, per_sm = tile(m)
    p = plan(m, k, n)
    assert 1 <= p.slices <= (MAX_SLICES if wg == 1 else MAX_SLICES // 2)
    col_blocks, m_tiles = -(-n // (BN * wg)), -(-m // rows)
    # blocks near the target (per_sm blocks a SM), never above it unless one
    # slice a block already exceeds it
    assert col_blocks * p.slices * m_tiles <= max(per_sm * SMS, col_blocks * m_tiles)


def test_plan_at_the_serving_shapes():
    # decode (m = 4): 86 column blocks x 3 slices and 32 x 8, ~2 blocks a SM
    assert plan(4, 4096, 11008) == Plan(1408, 3)
    assert plan(4, 11008, 4096) == Plan(1408, 8)
    # prefill (m = 64): blocks of 256 columns, ~1 a SM
    assert plan(64, 4096, 11008) == Plan(1408, 3)
    assert plan(64, 11008, 4096) == Plan(1408, 8)
    # more m tiles share the target: three 64-row tiles need no split here
    assert plan(130, 4096, 11008).slices == 1
    assert tile(4) == (8, 1, 2) and tile(64) == (64, 2, 1) and tile(65) == (64, 2, 1)


def split_emulation(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: each slice's int32 products,
    then the slices' partials added in int32."""
    k = a.shape[1]
    a32, b32 = a.to(torch.int32), b.to(torch.int32)
    parts = [a32[:, s0:s0 + p.slice_len] @ b32[s0:s0 + p.slice_len]
             for s0 in range(0, k, p.slice_len)]
    assert len(parts) == p.slices
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32)
    for part in parts:
        out += part
    return out


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8))


@pytest.mark.parametrize("m,k,n", [(4, 1000, 70), (17, 333, 130), (3, 4097, 40),
                                   (65, 640, 257), (1, 300, 5)])
def test_split_emulation_matches_plain_and_reference_kernel(m, k, n):
    a, b = _operands(m, k, n, seed=m * k + n)
    p = plan(m, k, n)
    assert p.slices > 1
    got = split_emulation(torch.from_numpy(a), torch.from_numpy(b), p)
    want = fxp_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == want.dtype == torch.int32 and torch.equal(got, want)
    ref = np.asarray(j_fxp_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("slice_len", [BK, 2 * BK, 5 * BK])
def test_split_emulation_is_exact_at_any_split_and_at_the_extremes(slice_len):
    """All-extreme operands (|sum| = 2^14 k) and random ones: the same bits
    whatever the split, since int32 sums are exact in any order."""
    k = 1000
    slices = -(-k // slice_len)
    extreme_a = torch.full((3, k), -128, dtype=torch.int8)
    extreme_b = torch.full((k, 9), -128, dtype=torch.int8)
    got = split_emulation(extreme_a, extreme_b, Plan(slice_len, slices))
    assert (got == 128 * 128 * k).all()
    a, b = (torch.from_numpy(x) for x in _operands(5, k, 33, seed=slice_len))
    assert torch.equal(split_emulation(a, b, Plan(slice_len, slices)), fxp_matmul_ref(a, b))
