"""The split-S plan of the flash-decode kernels, and its arithmetic.

``kernels/kv_flash_decode.py::plan`` cuts S into chunks from the shapes
alone; the CUDA body (``csrc/kv_flash_common.cuh``) runs the online softmax
per chunk and combines the chunks' partials (m, l, acc) in split order. The
kernel runs only on the card, so here a plain-torch emulation of that split
and combine, at the plan's chunks, is held against the plain version and
against the reference's Pallas kernel in interpret mode.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizers import QuantSpec as JSpec
from repro.core.quantizers import kv_quantize as j_kv_quantize
from repro.kernels.kv_flash_decode import kv_flash_decode as j_kv_flash_decode
from repro_torch.core.quantizers import kv_dequantize
from repro_torch.kernels.kv_flash_decode import (SMS, TILE, Plan, kv_flash_decode_ref,
                                                 plan)
from torch_bridge import tspec
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

SPECS = {"fxp8": JSpec(kind="fxp", M=8, F=7), "pofx8es2": JSpec(kind="pofx", N=8, ES=2),
         "pofx6es1": JSpec(kind="pofx", N=6, ES=1)}
# (B, G) pairs: the benchmark's 4 slots x G = 4, yi-9b at one slot, wide batches
BG = [(4, 4), (1, 4), (1, 1), (8, 2), (64, 8)]
LENGTHS = [1, 31, 32, 33, 45, 96, 100, 257, 1000, 1008, 4096, 4128, 65536]


def _target(B, G):
    t = max(1, 2 * SMS // (B * G))
    return 1 << (t.bit_length() - 1)


@pytest.mark.parametrize("B,G", BG)
def test_plan_chunks_are_tiles_and_cover_s(B, G):
    for S in LENGTHS:
        p = plan(B, G, S)
        assert isinstance(p, Plan) and p.chunk % TILE == 0 and p.chunk >= TILE
        # chunks [c * L, (c + 1) * L) cover [0, S) and the last one starts below S
        assert (p.splits - 1) * p.chunk < S <= p.splits * p.chunk


@pytest.mark.parametrize("B,G", BG)
def test_plan_splits_are_bounded(B, G):
    for S in LENGTHS:
        p = plan(B, G, S)
        assert 1 <= p.splits <= 2 * _target(B, G)
        # blocks stay near two a SM: never more than four, or two a (b, g)
        # where B * G alone fills the card
        assert B * G * p.splits <= max(4 * SMS, 2 * B * G)


def test_plan_depends_on_shapes_only():
    assert list(inspect.signature(plan).parameters) == ["B", "G", "S"]
    assert plan(4, 4, 1000) == plan(4, 4, 1000) == Plan(64, 16)
    # the benchmark's rows: ~2 blocks a SM at 4 slots and G = 4
    assert plan(4, 4, 96) == Plan(32, 3)
    assert plan(4, 4, 4096) == Plan(256, 16)


@pytest.mark.parametrize("ps", [4, 16, 48])
@pytest.mark.parametrize("max_len", [45, 96, 100, 1000, 4096])
def test_plan_dense_and_paged_lengths_share_the_chunk(ps, max_len):
    """A dense cache of max_len and a paged one of ceil(max_len/ps)*ps:
    the same chunk, so the kernels sum in the same order."""
    paged = -(-max_len // ps) * ps
    for B, G in BG:
        assert plan(B, G, max_len).chunk == plan(B, G, paged).chunk


def split_emulation(q, kc, ks, vc, vs, pos, spec, p: Plan):
    """The kernel's arithmetic in plain torch (f32): per chunk of the plan
    (m, l, acc), a chunk at or past s_end neutral (-inf, 0, 0), combined in
    split order. Returns (out, number of neutral chunks)."""
    B, G, R, Dh = q.shape
    S = kc.shape[2]
    k = kv_dequantize(kc, spec, ks, torch.float32)
    v = kv_dequantize(vc, spec, vs, torch.float32)
    s = torch.einsum("bgrd,bgsd->bgrs", q, k) * Dh ** -0.5
    pos = pos.reshape(-1).expand(B)
    s = torch.where(torch.arange(S)[None, None, None] < pos[:, None, None, None], s,
                    torch.full_like(s, -1e30))
    out = torch.empty_like(q)
    neutral = 0
    for b in range(B):
        pb = int(pos[b])
        s_end = S if pb <= 0 or pb > S else pb
        parts = []
        for c in range(p.splits):
            c0, c1 = c * p.chunk, min((c + 1) * p.chunk, s_end)
            if c0 >= s_end:
                neutral += 1
                parts.append((torch.full((G, R), -torch.inf), torch.zeros(G, R),
                              torch.zeros(G, R, Dh)))
                continue
            sc = s[b, :, :, c0:c1]
            m = sc.max(-1).values
            e = torch.exp(sc - m[..., None])
            parts.append((m, e.sum(-1), torch.einsum("grs,gsd->grd", e, v[b, :, c0:c1])))
        M = torch.stack([m for m, _, _ in parts]).max(0).values
        l, acc = torch.zeros(G, R), torch.zeros(G, R, Dh)
        for m, lc, ac in parts:
            w = torch.exp(m - M)
            l = l + lc * w
            acc = acc + ac * w[..., None]
        out[b] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out, neutral


def _inputs(spec, B, G, R, S, Dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, G, R, Dh)).astype(np.float32)
    kf = rng.normal(0, 0.5, (B, G, S, Dh)).astype(np.float32)
    vf = rng.normal(0, 0.5, (B, G, S, Dh)).astype(np.float32)
    ks = np.exp2(rng.integers(-1, 2, (B, G, 1, Dh))).astype(np.float32)
    vs = np.exp2(rng.integers(-1, 2, (B, G, 1, Dh))).astype(np.float32)
    kc = np.array(j_kv_quantize(jnp.asarray(kf), spec, jnp.asarray(ks)))
    vc = np.array(j_kv_quantize(jnp.asarray(vf), spec, jnp.asarray(vs)))
    return q, kc, ks, vc, vs


@pytest.mark.parametrize("spec_s", list(SPECS))
@pytest.mark.parametrize("S,block_s", [(96, 16), (1000, 40)])
def test_split_emulation_matches_plain_and_reference_kernel(spec_s, S, block_s):
    """pos at 0, 1, L-1, L, L+1, S-1, S and S+5 (one slot each): chunk
    boundaries, neutral chunks, the all-masked and the past-S cases."""
    spec = SPECS[spec_s]
    B, G, R, Dh = 8, 2, 4, 32
    p = plan(B, G, S)
    L = p.chunk
    assert p.splits > 2
    pos = np.array([0, 1, L - 1, L, L + 1, S - 1, S, S + 5], np.int32)
    arrays = _inputs(spec, B, G, R, S, Dh, seed=S)
    q, kc, ks, vc, vs = (torch.from_numpy(a) for a in arrays)
    got, neutral = split_emulation(q, kc, ks, vc, vs, torch.from_numpy(pos), tspec(spec), p)
    assert neutral > 0
    want = kv_flash_decode_ref(q, kc, ks, vc, vs, torch.from_numpy(pos), tspec(spec))
    # chunked vs one-pass f32 softmax: a few ulps of the largest |v|
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    ref = np.asarray(j_kv_flash_decode(*map(jnp.asarray, arrays), jnp.asarray(pos), spec,
                                       block_s=block_s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec_s,S,block_s", [("fxp8", 96, 16), ("pofx8es2", 96, 32),
                                              ("fxp8", 1000, 40)])
def test_split_emulation_at_nemotron_geometry(spec_s, S, block_s):
    """nemotron-4-340b's attention: G = 8 groups of R = 12 query rows (two
    row groups of 8 in the kernel), Dh = 192; pos at 1, L, S - 1 and S."""
    spec = SPECS[spec_s]
    B, G, R, Dh = 4, 8, 12, 192
    p = plan(B, G, S)
    assert p.splits > 2
    pos = np.array([1, p.chunk, S - 1, S], np.int32)
    arrays = _inputs(spec, B, G, R, S, Dh, seed=S + 192)
    q, kc, ks, vc, vs = (torch.from_numpy(a) for a in arrays)
    got, neutral = split_emulation(q, kc, ks, vc, vs, torch.from_numpy(pos), tspec(spec), p)
    assert neutral > 0
    want = kv_flash_decode_ref(q, kc, ks, vc, vs, torch.from_numpy(pos), tspec(spec))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    ref = np.asarray(j_kv_flash_decode(*map(jnp.asarray, arrays), jnp.asarray(pos), spec,
                                       block_s=block_s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
