"""Serving the dense and moe families on a (pod, data, model) grid, on the
CPU over gloo, against the reference's ``prefill``/``decode_step`` at
``mesh=None`` on the same weights (``serve_grid_bridge``).

The cache's batch is over (pod, data) and its sequence over model: with a
20-position cache on (data 2, model 2) each model rank holds 10, so the
9-token prompt and its 8 greedy decode steps cross from rank 0's block
into rank 1's; on (model 4) each rank holds 5, rank 3's block holds no
valid position until the seventh step (it weighs 0 in the combine), and
the smoke
yi-9b's 2 kv heads do not divide the model axis, so wk/wv are whole on
every rank. Every rank's prefill logits are held to the reference's at
f32 (RTOL/ATOL 1e-4), its decode logits, from its own cache, to
DECODE_TOL (1e-3, as ``tests/test_torch_encdec.py``: a one-step code
flip, ``serve_grid_bridge``), they are the same on every rank, its
greedy tokens are the reference's, each rank's cache is its block of the
port's tp = 1 cache,
and its greedy stream is the port's tp = 1 stream. The combine itself is
held against the whole-cache attention on the CPU, with blocks wholly
past the valid length.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke
from repro_torch.core.policy import parse_spec
from repro_torch.kernels.ref import kv_flash_decode_ref
from repro_torch.nn.attention import decode_attention
from repro_torch.nn.sharding import merge_partials
from serve_grid_bridge import check_grid
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

GRIDS = {"data2-model2": (1, 2, 2), "pod2-model2": (2, 1, 2), "model4": (1, 1, 4)}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=list(GRIDS.values()), timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


MIXED = "attn/*=pofx8es2,mlp/*=fxp8f7,*=bf16"
# (arch, grid, policy, kv cache, ragged prompts, kernels' datapath)
CASES = [
    ("yi-9b", "data2-model2", "pofx8", "fxp8", False, True),
    ("yi-9b", "pod2-model2", "pofx8", "fxp8", True, True),
    ("yi-9b", "model4", "pofx8", "fxp8", False, True),
    ("yi-9b", "data2-model2", MIXED, None, False, False),
    ("chameleon-34b", "data2-model2", "pofx8", "fxp8", False, True),
    ("moonshot-v1-16b-a3b", "data2-model2", "pofx8", "fxp8", False, True),
    ("moonshot-v1-16b-a3b", "pod2-model2", "pofx8", "fxp8", True, True),
    ("llama4-maverick-400b-a17b", "data2-model2", "pofx8", "fxp8", False, True),
]


@pytest.mark.parametrize("arch,grid,policy,kv,ragged,use_kernel", CASES,
                         ids=[f"{c[0]}-{c[1]}-{'mixed' if c[2] == MIXED else c[2]}-"
                              f"{c[3] or 'bf16'}" + ("-ragged" if c[4] else "")
                              for c in CASES])
def test_grid_serving_matches_reference(pool, arch, grid, policy, kv, ragged, use_kernel):
    check_grid(pool, GRIDS[grid], arch, policy, kv, ragged=ragged, use_kernel=use_kernel)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("kv", ["fxp8", "pofx8es2"])
def test_combined_blocks_equal_the_whole_cache(blocks, kv):
    """A cache of 64 positions cut in blocks, each attended with its lse
    (``kv_flash_decode_ref``) and merged (``merge_partials``), against the
    whole cache; rows whose valid length leaves later blocks wholly masked
    (lengths 1, 5, 17), and one that fills the cache."""
    spec = parse_spec(kv)
    g = torch.Generator().manual_seed(0)
    Bq, G, R, S, Dh = 4, 2, 3, 64, 32
    q = torch.randn(Bq, G, R, Dh, generator=g)
    lo, hi = (-127, 128) if spec.kind == "fxp" else (0, 1 << (spec.N - 1))
    dt = torch.int8 if spec.kind == "fxp" else torch.uint8
    kc = torch.randint(lo, hi, (Bq, G, S, Dh), generator=g).to(dt)
    vc = torch.randint(lo, hi, (Bq, G, S, Dh), generator=g).to(dt)
    ks = torch.rand(Bq, G, 1, Dh, generator=g) * 0.05 + 0.01
    vs = torch.rand(Bq, G, 1, Dh, generator=g) * 0.05 + 0.01
    pos = torch.tensor([1, 5, 17, 64])
    want = kv_flash_decode_ref(q, kc, ks, vc, vs, pos, spec)
    n = S // blocks
    parts = [kv_flash_decode_ref(q, kc[:, :, r * n:(r + 1) * n], ks, vc[:, :, r * n:(r + 1) * n],
                                 vs, (pos - r * n).clamp(0, n), spec, with_lse=True)
             for r in range(blocks)]
    outs, lses = torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    # a block past a row's length reads nothing: out 0, lse -inf
    assert (lses[-1, 0] == float("-inf")).all() and (outs[-1, 0] == 0).all()
    assert torch.isfinite(lses[:, -1]).all()
    got = merge_partials(outs, lses)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_decode_attention_lse_is_the_kernels_plain_form():
    """``decode_attention``'s lse form (the bf16-cache path) against
    ``kv_flash_decode_ref``'s on dequantized values, with a row wholly
    masked (length 0: out 0, lse -inf)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, 1, 2, 2, 16, generator=g)
    k, v = torch.randn(3, 2, 8, 16, generator=g), torch.randn(3, 2, 8, 16, generator=g)
    pos = torch.tensor([0, 3, 8])
    o, lse = decode_attention(q, k, v, pos, with_lse=True)
    spec = parse_spec("fxp8")
    ones = torch.ones(3, 2, 1, 16)
    # fxp8 codes of the values' 1/128 steps: the plain form on the same numbers
    kq, vq = torch.round(k * 32).clamp(-127, 127), torch.round(v * 32).clamp(-127, 127)
    o2, lse2 = decode_attention(q, kq / 32, vq / 32, pos, with_lse=True)
    o3, lse3 = kv_flash_decode_ref(q[:, 0], kq.to(torch.int8), ones / 32 * 2 ** spec.F,
                                   vq.to(torch.int8), ones / 32 * 2 ** spec.F, pos, spec,
                                   with_lse=True)
    torch.testing.assert_close(o2[:, 0], o3, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse2[:, 0], lse3, rtol=1e-6, atol=1e-5)
    assert lse.shape == (3, 1, 2, 2) and o.dtype == torch.float32
    assert (lse[0] == float("-inf")).all() and (o[0] == 0).all() and torch.isfinite(o).all()
