"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports torch and the port only (no jax), so it runs on the machine with
the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.pofx import pofx_norm_lut
from repro_torch.core.policy import parse_spec
from repro_torch.core.quantizers import kv_quantize
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fxp_matmul import fxp_matmul, fxp_matmul_ref
from repro_torch.kernels.kv_flash_decode import kv_flash_decode, kv_flash_decode_ref
from repro_torch.kernels.kv_flash_decode import plan as kv_plan
from repro_torch.kernels.kv_flash_paged_decode import (kv_flash_paged_decode,
                                                       kv_flash_paged_decode_ref)
from repro_torch.core import prng
from repro_torch.kernels.ref import gather_pages
from repro_torch.kernels.pofx_decode import pofx_decode, pofx_decode_ref
from repro_torch.kernels.pofx_matmul import pofx_matmul, pofx_matmul_ref
from repro_torch.launch.engine import sample_tokens

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(4, 4096, 512), (64, 1000, 777), (1, 33, 5)])
def test_pofx_matmul_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda)
    codes = torch.randint(0, 128, (k, n), generator=g, device=cuda).to(torch.uint8)
    scale = torch.exp2(torch.randint(-3, 2, (n,), generator=g, device=cuda).float())
    before = LAUNCHES["pofx_matmul"]
    for xt in (x, x.to(torch.bfloat16)):
        got = pofx_matmul(xt, codes, scale, 8, 2)
        want = pofx_matmul_ref(xt, codes, scale, 8, 2)
        # f32 sums of k products in another order: 1e-4 of the largest output
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-4 * want.abs().max().item())
    assert LAUNCHES["pofx_matmul"] == before + 2


def _pofx_inputs(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev)
    codes = torch.randint(0, 128, (k, n), generator=g, device=dev).to(torch.uint8)
    scale = torch.exp2(torch.randint(-3, 2, (n,), generator=g, device=dev).float())
    return x, codes, scale


def _assert_pofx_close(got, want):
    # f32 sums of k products in another order: 1e-4 of the largest output
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("k,n", [(4096, 512), (4096, 11008)])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 64, 65, 130])
def test_pofx_matmul_serving_shapes_match_plain(cuda, m, k, n):
    """Every m-tile width of the bf16 path (8, 16, 32, 64, and more than one
    tile), the f32 path, with k split into slices: one count per call."""
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=m)
    for xt in (x.to(torch.bfloat16), x):
        before = LAUNCHES["pofx_matmul"]
        got = pofx_matmul(xt, codes, scale, 8, 2)
        assert LAUNCHES["pofx_matmul"] == before + 1
        _assert_pofx_close(got, pofx_matmul_ref(xt, codes, scale, 8, 2))


# falcon-mamba-7b's in_proj, out_proj and unembed; zamba2-1.2b's in_proj,
# whose 8384 columns leave the last 128-column tile half filled, and unembed
@pytest.mark.parametrize("k,n", [(4096, 16384), (8192, 4096), (4096, 65024),
                                 (2048, 8384), (2048, 32000)])
@pytest.mark.parametrize("m", [1, 4, 64])
def test_pofx_matmul_ssm_serving_shapes_match_plain(cuda, m, k, n):
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=m + n)
    for xt in (x.to(torch.bfloat16), x):
        before = LAUNCHES["pofx_matmul"]
        got = pofx_matmul(xt, codes, scale, 8, 2)
        assert LAUNCHES["pofx_matmul"] == before + 1 and got.shape == (m, n)
        want = pofx_matmul_ref(xt, codes, scale, 8, 2)
        _assert_pofx_close(got, want)
        # the last, partial tile on its own
        tail = n - n % 128 if n % 128 else n - 128
        _assert_pofx_close(got[:, tail:], want[:, tail:])


# whisper-medium's q/k/v/o, wi, wo and unembed at the one-shot prefill's m
# = 256 (4 sequences x 64 positions: four 64-row m tiles on the grid's z
# axis, each reading every code tile) and at decode's m = 4
@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 51968)])
@pytest.mark.parametrize("m", [4, 256])
def test_pofx_matmul_whisper_shapes_match_plain(cuda, m, k, n):
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=m + k + n)
    for xt in (x.to(torch.bfloat16), x):
        before = LAUNCHES["pofx_matmul"]
        got = pofx_matmul(xt, codes, scale, 8, 2)
        assert LAUNCHES["pofx_matmul"] == before + 1 and got.shape == (m, n)
        want = pofx_matmul_ref(xt, codes, scale, 8, 2)
        _assert_pofx_close(got, want)
        # each 64-row m tile on its own
        for r in range(0, m, 64):
            _assert_pofx_close(got[r:r + 64], want[r:r + 64])


@pytest.mark.parametrize("k,n", [(1000, 777), (33, 5), (257, 66)])
@pytest.mark.parametrize("m", [1, 4, 70])
def test_pofx_matmul_ragged_shapes_match_plain(cuda, m, k, n):
    """n not a multiple of 16 and k not of 8: the byte-wise load paths."""
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=k + n)
    for xt in (x.to(torch.bfloat16), x):
        _assert_pofx_close(pofx_matmul(xt, codes, scale, 8, 2),
                           pofx_matmul_ref(xt, codes, scale, 8, 2))


def test_pofx_matmul_misaligned_bases_match_plain(cuda):
    """Contiguous x and codes whose first element is not 16-byte aligned,
    at a shape whose strides are: the kernel's byte-wise paths."""
    m, k, n = 4, 4096, 512
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=9)
    cbuf = torch.empty(k * n + 1, dtype=torch.uint8, device=cuda)
    cbuf[1:] = codes.flatten()
    codes_off = cbuf[1:].view(k, n)
    assert codes_off.data_ptr() % 16 != 0
    for xt in (x.to(torch.bfloat16), x):
        xbuf = torch.empty(m * k + 1, dtype=xt.dtype, device=cuda)
        xbuf[1:] = xt.flatten()
        x_off = xbuf[1:].view(m, k)
        assert x_off.is_contiguous() and x_off.data_ptr() % 16 != 0
        want = pofx_matmul_ref(xt, codes, scale, 8, 2)
        for a, c in ((x_off, codes), (xt, codes_off), (x_off, codes_off)):
            _assert_pofx_close(pofx_matmul(a, c, scale, 8, 2), want)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 11008), (64, 4096, 512), (4, 11008, 4096)])
def test_pofx_matmul_two_launches_bit_identical(cuda, m, k, n):
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=10)
    for xt in (x.to(torch.bfloat16), x):
        first = pofx_matmul(xt, codes, scale, 8, 2)
        assert torch.equal(pofx_matmul(xt, codes, scale, 8, 2), first)


@pytest.mark.parametrize("k,n", [(4096, 512), (4096, 11008), (11008, 4096)])
def test_pofx_matmul_f32_rows_do_not_depend_on_m(cuda, k, n):
    """A row computed in a 4-row decode batch equals the same row inside a
    70-row prefill bit for bit (evict -> resume relies on it)."""
    x, codes, scale = _pofx_inputs(cuda, 70, k, n, seed=11)
    whole = pofx_matmul(x, codes, scale, 8, 2)
    for lo in (0, 33, 66):
        assert torch.equal(pofx_matmul(x[lo:lo + 4], codes, scale, 8, 2), whole[lo:lo + 4])
    assert torch.equal(pofx_matmul(x[5:6], codes, scale, 8, 2), whole[5:6])


@pytest.mark.parametrize("N,ES", [(8, 2), (7, 1), (6, 3)])
def test_pofx_matmul_decodes_every_code_exactly(cuda, N, ES):
    L = 1 << (N - 1)
    codes = torch.arange(L, device=cuda, dtype=torch.uint8)[None].expand(L, L).contiguous()
    got = pofx_matmul(torch.eye(L, device=cuda), codes, torch.ones(L, device=cuda), N, ES)
    lut = torch.as_tensor(pofx_norm_lut(N, ES, 8), device=cuda).float() / 128
    assert torch.equal(got, lut[None].expand(L, L))


def _fxp_inputs(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randint(-128, 128, (m, k), generator=g, device=dev).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, device=dev).to(torch.int8)
    return a, b


# every wgmma width (N = 8, 16, 32, 64, and more than one 64-row tile) at the
# serving shapes, k split into slices; then k not a multiple of 16 (a's byte
# path, a k tail), n not a multiple of 16 (b's byte path), and both
FXP_CASES = ([(m, k, n) for m in (1, 4, 8, 16, 17, 64, 65, 130)
              for k, n in ((4096, 11008), (11008, 4096))] + [(3, 37, 70)]
             + [(m, k, n) for m in (1, 4, 20, 70)
                for k, n in ((1000, 777), (33, 5), (257, 66), (4100, 4096), (4096, 4104),
                             (70, 16))])


@pytest.mark.parametrize("m,k,n", FXP_CASES)
def test_fxp_matmul_exact(cuda, m, k, n):
    a, b = _fxp_inputs(cuda, m, k, n, seed=m + k + n)
    before = LAUNCHES["fxp_matmul"]
    got = fxp_matmul(a, b)
    assert LAUNCHES["fxp_matmul"] == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, fxp_matmul_ref(a, b))


def test_fxp_matmul_misaligned_views_exact(cuda):
    """Contiguous operands whose first byte is not 16-byte aligned, and
    strided views (copied by the wrapper)."""
    m, k, n = 4, 4096, 11008
    a, b = _fxp_inputs(cuda, m, k, n, seed=9)
    want = fxp_matmul_ref(a, b)
    bbuf = torch.empty(k * n + 1, dtype=torch.int8, device=cuda)
    bbuf[1:] = b.flatten()
    b_off = bbuf[1:].view(k, n)
    abuf = torch.empty(m * k + 3, dtype=torch.int8, device=cuda)
    abuf[3:] = a.flatten()
    a_off = abuf[3:].view(m, k)
    assert b_off.data_ptr() % 16 != 0 and a_off.data_ptr() % 16 != 0
    for x, y in ((a_off, b), (a, b_off), (a_off, b_off)):
        assert torch.equal(fxp_matmul(x, y), want)
    wide = torch.zeros((k, n + 5), dtype=torch.int8, device=cuda)
    wide[:, 2:n + 2] = b
    assert torch.equal(fxp_matmul(a, wide[:, 2:n + 2]), want)
    assert torch.equal(fxp_matmul(a.t().contiguous().t(), b.t().contiguous().t()), want)


@pytest.mark.parametrize("m,k,n", [(4, 4096, 11008), (64, 11008, 4096), (130, 4096, 512)])
def test_fxp_matmul_two_launches_bit_identical(cuda, m, k, n):
    a, b = _fxp_inputs(cuda, m, k, n, seed=10)
    first = fxp_matmul(a, b)
    assert torch.equal(fxp_matmul(a, b), first)


def test_fxp_matmul_accumulator_headroom_exact_on_the_card(cuda):
    """All-extreme operands at the largest k the int32 sum holds (128^2 k <
    2^31): every split's partials and their sum stay exact."""
    for m, k in ((4, 131000), (64, 16384)):
        a = torch.full((m, k), -128, dtype=torch.int8, device=cuda)
        b = torch.full((k, 48), -128, dtype=torch.int8, device=cuda)
        assert (fxp_matmul(a, b) == 128 * 128 * k).all()


@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2", "pofx6es1"])
@pytest.mark.parametrize("Dh,S", [(128, 1000), (32, 45), (64, 96)])
def test_kv_flash_decode_matches_plain(cuda, spec_s, Dh, S):
    spec = parse_spec(spec_s)
    g = torch.Generator(device=cuda).manual_seed(2)
    B, G, R = 4, 4, 8
    q = torch.randn(B, G, R, Dh, generator=g, device=cuda)
    ks = torch.exp2(torch.randint(-1, 2, (B, G, 1, Dh), generator=g, device=cuda).float())
    vs = torch.exp2(torch.randint(-1, 2, (B, G, 1, Dh), generator=g, device=cuda).float())
    kc = kv_quantize(torch.randn(B, G, S, Dh, generator=g, device=cuda), spec, ks)
    vc = kv_quantize(torch.randn(B, G, S, Dh, generator=g, device=cuda), spec, vs)
    pos = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32, device=cuda)
    got = kv_flash_decode(q, kc, ks, vc, vs, pos, spec)
    want = kv_flash_decode_ref(q, kc, ks, vc, vs, pos, spec)
    # online vs one-pass f32 softmax: a few ulps of the largest |v|
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("S", [128, 2048])
def test_kv_flash_decode_lse_and_blocks_combine(cuda, spec_s, S):
    """The lse output against the plain form's, local lengths of 0
    included (a grid rank's block past a row's position), and the blocks
    of a cache attended apart and merged (``merge_partials``) against the
    whole cache; the same out with and without the lse where a row has a
    valid position, one launch each."""
    from repro_torch.nn.sharding import merge_partials
    spec = parse_spec(spec_s)
    g = torch.Generator(device=cuda).manual_seed(4)
    B, G, R, Dh = 4, 4, 8, 128
    q = torch.randn(B, G, R, Dh, generator=g, device=cuda)
    ks = torch.exp2(torch.randint(-1, 2, (B, G, 1, Dh), generator=g, device=cuda).float())
    vs = torch.exp2(torch.randint(-1, 2, (B, G, 1, Dh), generator=g, device=cuda).float())
    kc = kv_quantize(torch.randn(B, G, 2 * S, Dh, generator=g, device=cuda), spec, ks)
    vc = kv_quantize(torch.randn(B, G, 2 * S, Dh, generator=g, device=cuda), spec, vs)
    pos = torch.tensor([1, S // 3, S + 5, 2 * S], dtype=torch.int32, device=cuda)
    parts = []
    for r in range(2):
        blk = slice(r * S, (r + 1) * S)
        n = (pos - r * S).clamp(0, S)
        before = LAUNCHES["kv_flash_decode"]
        out, lse = kv_flash_decode(q, kc[:, :, blk], ks, vc[:, :, blk], vs, n, spec,
                                   with_lse=True)
        assert LAUNCHES["kv_flash_decode"] == before + 1
        want, want_lse = kv_flash_decode_ref(q, kc[:, :, blk], ks, vc[:, :, blk], vs, n, spec,
                                             with_lse=True)
        torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
        # a row of length 0 reads nothing with the lse (out 0), where the
        # plain mask averages the block: the others agree bit for bit
        live = n > 0
        assert torch.equal(out[live], kv_flash_decode(q, kc[:, :, blk], ks, vc[:, :, blk], vs,
                                                      n, spec)[live])
        parts.append((out, lse))
    got = merge_partials(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]))
    whole = kv_flash_decode_ref(q, kc, ks, vc, vs, pos, spec)
    torch.testing.assert_close(got, whole, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("ps", [4, 16, 48])
def test_kv_flash_paged_decode_matches_plain_and_dense_kernel(cuda, spec_s, ps):
    """Scrambled tables (no slot's pages contiguous), garbage-page tails,
    pos 0 (every position masked: the plain version averages all
    max_pages * ps rows, garbage included) and a full slot."""
    spec = parse_spec(spec_s)
    g = torch.Generator(device=cuda).manual_seed(3)
    B, G, R, Dh, max_pages = 4, 4, 8, 128, -(-200 // ps)
    S = max_pages * ps
    n_pages = B * max_pages + 2
    ks = torch.exp2(torch.randint(-1, 2, (G, 1, Dh), generator=g, device=cuda).float())
    vs = torch.exp2(torch.randint(-1, 2, (G, 1, Dh), generator=g, device=cuda).float())
    kc = kv_quantize(torch.randn(n_pages, G, ps, Dh, generator=g, device=cuda), spec, ks)
    vc = kv_quantize(torch.randn(n_pages, G, ps, Dh, generator=g, device=cuda), spec, vs)
    q = torch.randn(B, G, R, Dh, generator=g, device=cuda)
    pos = torch.tensor([0, S // 3, S - 1, S], dtype=torch.int32, device=cuda)
    tables = torch.zeros(B, max_pages, dtype=torch.int32, device=cuda)
    order = torch.randperm(max_pages, generator=g, device=cuda)
    for b in range(B):     # slot b owns pages b+1, b+1+B, ...: never adjacent
        n = -(-max(int(pos[b]), 1) // ps)
        tables[b, :n] = (1 + b + B * order[:n]).to(torch.int32)
    before = LAUNCHES["kv_flash_paged_decode"]
    got = kv_flash_paged_decode(q, kc, ks, vc, vs, tables, pos, spec)
    assert LAUNCHES["kv_flash_paged_decode"] == before + 1
    want = kv_flash_paged_decode_ref(q, kc, ks, vc, vs, tables, pos, spec)
    # online vs one-pass f32 softmax: a few ulps of the largest |v|
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    # the dense kernel on the gathered cache walks the same tiles in the
    # same order: bit for bit
    dense = kv_flash_decode(q, gather_pages(kc, tables), ks[None].expand(B, G, 1, Dh),
                            gather_pages(vc, tables), vs[None].expand(B, G, 1, Dh),
                            pos, spec)
    assert torch.equal(got, dense)


def _kv_dense(dev, spec, B, G, R, S, Dh, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, G, R, Dh, generator=g, device=dev)
    ks = torch.exp2(torch.randint(-1, 2, (B, G, 1, Dh), generator=g, device=dev).float())
    vs = torch.exp2(torch.randint(-1, 2, (B, G, 1, Dh), generator=g, device=dev).float())
    kc = kv_quantize(torch.randn(B, G, S, Dh, generator=g, device=dev), spec, ks)
    vc = kv_quantize(torch.randn(B, G, S, Dh, generator=g, device=dev), spec, vs)
    return q, kc, ks, vc, vs


@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("S", [96, 1000, 4096])
def test_kv_flash_decode_pos_around_every_chunk_boundary(cuda, spec_s, S):
    """pos one below, at and one above every chunk boundary of the plan
    (four slots a call), and S = 4096, Yi-9B's context."""
    spec = parse_spec(spec_s)
    B, G, R, Dh = 4, 4, 8, 128
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, B, G, R, S, Dh, seed=S)
    L = kv_plan(B, G, S).chunk
    cands = sorted({p for c in range(0, S + L, L) for p in (c - 1, c, c + 1) if 0 <= p <= S})
    cands += [S] * (-len(cands) % B)
    for i in range(0, len(cands), B):
        pos = torch.tensor(cands[i:i + B], dtype=torch.int32, device=cuda)
        got = kv_flash_decode(q, kc, ks, vc, vs, pos, spec)
        want = kv_flash_decode_ref(q, kc, ks, vc, vs, pos, spec)
        # chunked online vs one-pass f32 softmax: a few ulps of the largest |v|
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("R,Dh", [(1, 128), (5, 64), (12, 128), (32, 32), (16, 256)])
def test_kv_flash_decode_query_row_groups_match_plain(cuda, R, Dh):
    """R beyond one block's 8 rows (more blocks, the last one partly
    filled) and below it, dense and paged."""
    spec = parse_spec("pofx8es2")
    B, G, S = 3, 2, 300
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, B, G, R, S, Dh, seed=R)
    pos = torch.tensor([0, 150, 300], dtype=torch.int32, device=cuda)
    want = kv_flash_decode_ref(q, kc, ks, vc, vs, pos, spec)
    torch.testing.assert_close(kv_flash_decode(q, kc, ks, vc, vs, pos, spec), want,
                               rtol=1e-4, atol=1e-5)
    # the same rows as one-row pages: slot b's position t on page 1 + t * B + b
    pool_k = torch.zeros(1 + S * B, G, 1, Dh, dtype=kc.dtype, device=cuda)
    pool_v = torch.zeros_like(pool_k)
    tables = (1 + torch.arange(S, device=cuda)[None] * B
              + torch.arange(B, device=cuda)[:, None]).to(torch.int32)
    pool_k[tables.flatten().long(), :, 0] = kc.permute(0, 2, 1, 3).reshape(B * S, G, Dh)
    pool_v[tables.flatten().long(), :, 0] = vc.permute(0, 2, 1, 3).reshape(B * S, G, Dh)
    ksg = ks[:1].expand(B, G, 1, Dh)
    vsg = vs[:1].expand(B, G, 1, Dh)
    dense = kv_flash_decode(q, kc, ksg, vc, vsg, pos, spec)
    paged = kv_flash_paged_decode(q, pool_k, ks[0], pool_v, vs[0], tables, pos, spec)
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("S", [96, 1000, 4096])
def test_kv_flash_decode_two_launches_bit_identical_one_count_each(cuda, S):
    spec = parse_spec("fxp8")
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, 4, 4, 8, S, 128, seed=7)
    pos = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32, device=cuda)
    before = LAUNCHES["kv_flash_decode"]
    first = kv_flash_decode(q, kc, ks, vc, vs, pos, spec)
    assert LAUNCHES["kv_flash_decode"] == before + 1
    assert torch.equal(kv_flash_decode(q, kc, ks, vc, vs, pos, spec), first)
    assert LAUNCHES["kv_flash_decode"] == before + 2


def test_kv_flash_decode_bf16_q_scalar_and_int64_pos(cuda):
    """q in bf16 and pos as one scalar or int64 go to the kernel as they
    are; the result is the plain version's on the same values."""
    spec = parse_spec("pofx8es2")
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, 4, 4, 8, 1000, 128, seed=8)
    qb = q.to(torch.bfloat16)
    for pos in (torch.tensor(777, device=cuda), torch.tensor([5, 64, 65, 1000], device=cuda)):
        got = kv_flash_decode(qb, kc, ks, vc, vs, pos, spec)
        want = kv_flash_decode_ref(qb, kc, ks, vc, vs, pos, spec)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("ps", [4, 16])
@pytest.mark.parametrize("max_len", [100, 1000, 4096])
def test_kv_flash_dense_at_max_len_equals_paged_at_whole_pages(cuda, spec_s, ps, max_len):
    """The dense cache of max_len against a paged one of ceil(max_len/ps)
    * ps holding the same rows (junk past max_len): bit for bit."""
    spec = parse_spec(spec_s)
    B, G, R, Dh = 4, 4, 8, 128
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, B, G, R, max_len, Dh, seed=ps + max_len)
    mp = -(-max_len // ps)
    ksg, vsg = ks[0], vs[0]                    # one scale grid, as the pool has
    ksd, vsd = ksg[None].expand(B, G, 1, Dh), vsg[None].expand(B, G, 1, Dh)
    g = torch.Generator(device=cuda).manual_seed(9)
    kpool = torch.randint(0, 128, (B * mp + 1, G, ps, Dh), generator=g, device=cuda)
    vpool = torch.randint(0, 128, (B * mp + 1, G, ps, Dh), generator=g, device=cuda)
    kpool, vpool = kpool.to(kc.dtype), vpool.to(vc.dtype)
    tables = torch.zeros(B, mp, dtype=torch.int32, device=cuda)
    for b in range(B):
        order = torch.randperm(mp, generator=g, device=cuda)
        tables[b] = (1 + b + B * order).to(torch.int32)
        for j in range(mp):
            t0, t1 = j * ps, min((j + 1) * ps, max_len)
            kpool[tables[b, j], :, :t1 - t0] = kc[b, :, t0:t1]
            vpool[tables[b, j], :, :t1 - t0] = vc[b, :, t0:t1]
    pos = torch.tensor([1, max_len // 3, max_len - 1, max_len], dtype=torch.int32,
                       device=cuda)
    dense = kv_flash_decode(q, kc, ksd, vc, vsd, pos, spec)
    paged = kv_flash_paged_decode(q, kpool, ksg, vpool, vsg, tables, pos, spec)
    assert torch.equal(dense, paged)


# moonshot-v1-16b-a3b's kernel shapes: q/k/v/o, shared gate/up, shared
# down, unembed (n = 163840)
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 2816), (2816, 2048), (2048, 163840)])
@pytest.mark.parametrize("m", [1, 4, 64])
def test_pofx_matmul_moe_serving_shapes_match_plain(cuda, m, k, n):
    x, codes, scale = _pofx_inputs(cuda, m, k, n, seed=k + m)
    for xt in (x.to(torch.bfloat16), x):
        before = LAUNCHES["pofx_matmul"]
        got = pofx_matmul(xt, codes, scale, 8, 2)
        assert LAUNCHES["pofx_matmul"] == before + 1
        _assert_pofx_close(got, pofx_matmul_ref(xt, codes, scale, 8, 2))


# (B, G, R, Dh): moonshot's 16 groups of one query row at 4 slots, and the
# llama4 smoke size's 2 groups of 2
@pytest.mark.parametrize("B,G,R,Dh", [(4, 16, 1, 128), (2, 2, 2, 32)])
@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("S", [96, 1000, 4096])
def test_kv_flash_decode_moe_geometry_dense_and_paged_match_plain(cuda, B, G, R, Dh,
                                                                  spec_s, S):
    """Both flash-decode kernels against their plain versions, and the
    paged one equal to the dense one on the same rows (16-token pages)."""
    _dense_and_paged_match_plain(cuda, B, G, R, Dh, spec_s, S)


# zamba2-1.2b's shared attention: 32 groups of one query row, Dh = 64
@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("S", [96, 1000, 4096])
def test_kv_flash_decode_hybrid_geometry_dense_and_paged_match_plain(cuda, spec_s, S):
    _dense_and_paged_match_plain(cuda, 4, 32, 1, 64, spec_s, S)


# nemotron-4-340b's attention: 8 groups of 12 query rows (two row groups of
# 8 a (b, g)), Dh = 192 (12-byte score loads, 6-byte P V loads)
@pytest.mark.parametrize("spec_s", ["fxp8", "pofx8es2"])
@pytest.mark.parametrize("S", [96, 1000, 4096])
def test_kv_flash_decode_dh192_geometry_dense_and_paged_match_plain(cuda, spec_s, S):
    _dense_and_paged_match_plain(cuda, 4, 8, 12, 192, spec_s, S)


@pytest.mark.parametrize("B,R", [(1, 1), (3, 5), (2, 32)])
def test_kv_flash_decode_dh192_bf16_q_and_row_counts_match_plain(cuda, B, R):
    spec = parse_spec("pofx6es1")
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, B, 2, R, 333, 192, seed=B * R)
    pos = torch.tensor([333, 1, 200][:B], dtype=torch.int32, device=cuda)
    for qq in (q, q.to(torch.bfloat16)):
        torch.testing.assert_close(kv_flash_decode(qq, kc, ks, vc, vs, pos, spec),
                                   kv_flash_decode_ref(qq, kc, ks, vc, vs, pos, spec),
                                   rtol=1e-4, atol=1e-5)


def test_flash_decode_wrappers_refuse_head_dims_not_built(cuda):
    spec = parse_spec("fxp8")
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, 1, 2, 2, 64, 96, seed=0)
    pos = torch.tensor([64], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="supports Dh"):
        kv_flash_decode(q, kc, ks, vc, vs, pos, spec)
    tables = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="supports Dh"):
        kv_flash_paged_decode(q, kc[0].reshape(4, 2, 16, 96), ks[0], vc[0].reshape(4, 2, 16, 96),
                              vs[0], tables, pos, spec)


def _dense_and_paged_match_plain(cuda, B, G, R, Dh, spec_s, S):
    spec = parse_spec(spec_s)
    q, kc, ks, vc, vs = _kv_dense(cuda, spec, B, G, R, S, Dh, seed=G * S + R)
    ksg, vsg = ks[0], vs[0]
    ksd, vsd = ksg[None].expand(B, G, 1, Dh), vsg[None].expand(B, G, 1, Dh)
    pos = torch.tensor([1, S // 3, S - 1, S][-B:], dtype=torch.int32, device=cuda)
    before = LAUNCHES["kv_flash_decode"]
    dense = kv_flash_decode(q, kc, ksd, vc, vsd, pos, spec)
    assert LAUNCHES["kv_flash_decode"] == before + 1
    torch.testing.assert_close(dense, kv_flash_decode_ref(q, kc, ksd, vc, vsd, pos, spec),
                               rtol=1e-4, atol=1e-5)
    ps, mp = 16, -(-S // 16)
    kpool = torch.zeros(B * mp + 1, G, ps, Dh, dtype=kc.dtype, device=cuda)
    vpool = torch.zeros_like(kpool)
    tables = (1 + torch.arange(mp, device=cuda)[None] * B
              + torch.arange(B, device=cuda)[:, None]).to(torch.int32)
    for b in range(B):
        for j in range(mp):
            t0, t1 = j * ps, min((j + 1) * ps, S)
            kpool[tables[b, j], :, :t1 - t0] = kc[b, :, t0:t1]
            vpool[tables[b, j], :, :t1 - t0] = vc[b, :, t0:t1]
    paged = kv_flash_paged_decode(q, kpool, ksg, vpool, vsg, tables, pos, spec)
    torch.testing.assert_close(
        paged, kv_flash_paged_decode_ref(q, kpool, ksg, vpool, vsg, tables, pos, spec),
        rtol=1e-4, atol=1e-5)
    assert torch.equal(dense, paged)


def test_wrappers_raise_on_mixed_devices(cuda):
    with pytest.raises(ValueError, match="CUDA"):
        pofx_matmul(torch.zeros(2, 8, device=cuda),
                    torch.zeros(8, 4, dtype=torch.uint8), torch.ones(4), 8, 2)
    pool = torch.zeros(3, 2, 4, 32, dtype=torch.int8, device=cuda)
    one = torch.ones(2, 1, 32, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        kv_flash_paged_decode(torch.zeros(1, 2, 2, 32, device=cuda), pool, one, pool,
                              one, torch.zeros(1, 2, dtype=torch.int32), 3,
                              parse_spec("fxp8"))
    with pytest.raises(ValueError, match="uint8"):
        pofx_matmul(torch.zeros(2, 8, device=cuda),
                    torch.zeros(8, 4, dtype=torch.int8, device=cuda),
                    torch.ones(4, device=cuda), 8, 2)


@pytest.mark.parametrize("N", range(3, 10))
@pytest.mark.parametrize("ES", range(5))
def test_pofx_decode_every_code_exact(cuda, N, ES):
    """At every (N, ES, M) the wrapper accepts: an (L, L) tile of arange(L)
    (its rows the decode table), and every byte (high bits ignored)."""
    L = 1 << (N - 1)
    tile = torch.arange(L, device=cuda, dtype=torch.uint8)[None].expand(L, L).contiguous()
    every = torch.arange(256, device=cuda, dtype=torch.uint8).reshape(16, 16)
    for M in range(1, 9):
        before = LAUNCHES["pofx_decode"]
        got = pofx_decode(tile, N, ES, M)
        assert LAUNCHES["pofx_decode"] == before + 1
        assert got.dtype == torch.int8 and torch.equal(got, pofx_decode_ref(tile, N, ES, M))
        lut = torch.as_tensor(pofx_norm_lut(N, ES, M), device=cuda).to(torch.int8)
        assert torch.equal(got[0], lut)
        assert torch.equal(pofx_decode(every, N, ES, M), pofx_decode_ref(every, N, ES, M))


def test_pofx_decode_grid_stride_walks_several_times(cuda):
    """A persistent grid of a few blocks a SM walks 8192 x 11008 codes in
    several strides, flat and as a strided view (rows walked apart)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    codes = torch.randint(0, 256, (8192, 11008), generator=g, device=cuda, dtype=torch.uint8)
    spans = codes.numel() // 16
    assert spans > 8 * 4 * torch.cuda.get_device_properties(cuda).multi_processor_count * 256
    for N, ES in ((8, 2), (9, 1)):
        lut = torch.as_tensor(pofx_norm_lut(N, ES, 8), device=cuda).to(torch.int8)
        want = lut[(codes & ((1 << (N - 1)) - 1)).long()]
        assert torch.equal(pofx_decode(codes, N, ES), want)
        assert torch.equal(pofx_decode(codes[:, 3:11003], N, ES), want[:, 3:11003])


@pytest.mark.parametrize("shape", [(257, 130), (1, 17), (33, 1), (3, 4099), (4096, 512)])
def test_pofx_decode_ragged_shapes_exact(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(4)
    codes = torch.randint(0, 256, shape, generator=g, device=cuda, dtype=torch.uint8)
    for N, ES, M in ((8, 2, 8), (6, 1, 8), (9, 2, 8), (7, 3, 6)):
        assert torch.equal(pofx_decode(codes, N, ES, M), pofx_decode_ref(codes, N, ES, M))


def test_pofx_decode_strided_views_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randint(0, 256, (257, 160), generator=g, device=cuda, dtype=torch.uint8)
    for view in (base[:, :130], base[:, 1:131], base[3:, 5:], base.t()):
        got = pofx_decode(view, 7, 1)
        assert got.is_contiguous() and torch.equal(got, pofx_decode_ref(view, 7, 1))


def test_pofx_decode_raises_on_non_uint8_codes(cuda):
    with pytest.raises(ValueError, match="uint8"):
        pofx_decode(torch.zeros(4, 4, dtype=torch.int32, device=cuda), 8, 2)
    with pytest.raises(ValueError, match="byte-wide"):
        pofx_decode(torch.zeros(4, 4, dtype=torch.uint8, device=cuda), 10, 2)
    with pytest.raises(ValueError, match="int8"):
        pofx_decode(torch.zeros(4, 4, dtype=torch.uint8, device=cuda), 8, 2, 9)


def test_prng_bits_on_the_card_equal_the_cpu_bits(cuda):
    """Integer hashing and the uniform's bit tricks are exact on both."""
    for seed in (0, 7):
        k_cpu = prng.fold_in(prng.PRNGKey(seed).expand(4, 2), torch.arange(4))
        k_gpu = k_cpu.to(cuda)
        assert torch.equal(prng.random_bits(k_gpu, (64000,)).cpu(),
                           prng.random_bits(k_cpu, (64000,)))
        assert torch.equal(prng.uniform(k_gpu, (64000,)).cpu(), prng.uniform(k_cpu, (64000,)))
        assert torch.equal(prng.fold_in(k_gpu, torch.arange(4, device=cuda) + 70).cpu(),
                           prng.fold_in(k_cpu, torch.arange(4) + 70))


def test_sample_tokens_on_the_card_equal_the_cpu_draw(cuda):
    """The same keys draw the same tokens on the card and on the CPU; the
    two logs may differ by an ulp, so a token may differ only where the
    two winners' scores are within 1e-5 (a near-tie)."""
    g = torch.Generator().manual_seed(6)
    B, V = 8, 64000
    logits = torch.randn(B, V, generator=g) * 3
    keys = prng.fold_in(prng.PRNGKey(3).expand(B, 2), torch.arange(B))
    temps = torch.tensor([0.0, 0.8, 0.8, 1.0, 0.5, 0.8, 1e-9, 2.0])
    topks = torch.tensor([0, 40, 0, 5, 1, 40, 0, 1000])
    for dt in (torch.float32, torch.bfloat16):
        lg = logits.to(dt)
        want = sample_tokens(lg, keys, temps, topks)
        got = sample_tokens(lg.to(cuda), keys.to(cuda), temps.to(cuda), topks.to(cuda)).cpu()
        for b in torch.nonzero(got != want).flatten().tolist():
            sc = prng.gumbel(keys[b], (V,)) + lg[b].float() / max(float(temps[b]), 1e-6)
            gap = (sc[got[b]] - sc[want[b]]).abs().item()
            assert gap < 1e-5, f"row {b}: {int(got[b])} vs {int(want[b])}, gap {gap}"


# -- training (no kernel of the port: flash backward and one train step) ------


def _naive_attention(q, k, v, causal):
    Sq, Skv, Dh = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float()) * Dh ** -0.5
    if causal:
        keep = torch.arange(Skv, device=q.device)[None] <= torch.arange(Sq, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bgrqk,bkgd->bqgrd", torch.softmax(s, -1), v.float()).to(q.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,qc", [(128, 1024), (640, 256)])
def test_flash_function_matches_naive_and_sdpa(cuda, causal, S, qc):
    """The flash Function's forward and backward against autograd through a
    materialized softmax (f32: 1e-5 of the largest value) and against SDPA
    with K/V repeated to every head (bf16: 2e-2)."""
    import torch.nn.functional as F
    from repro_torch.nn.attention import flash_attention
    g = torch.Generator(device=cuda).manual_seed(0)
    B, G, R, Dh = 2, 4, 8, 128
    shapes = ((B, S, G, R, Dh), (B, S, G, Dh), (B, S, G, Dh), (B, S, G, R, Dh))
    q, k, v, do = (torch.randn(s, generator=g, device=cuda) for s in shapes)
    for dt, tol, oracle in ((torch.float32, 1e-5, "naive"), (torch.bfloat16, 2e-2, "sdpa")):
        res = []
        for fn in ("flash", oracle):
            qq, kk, vv = (t.to(dt).clone().requires_grad_() for t in (q, k, v))
            if fn == "flash":
                o = flash_attention(qq, kk, vv, causal=causal, q_chunk=qc, kv_chunk=qc)
            elif fn == "naive":
                o = _naive_attention(qq, kk, vv, causal)
            else:
                rep = lambda t: t.repeat_interleave(R, dim=2).transpose(1, 2)
                o = F.scaled_dot_product_attention(
                    qq.reshape(B, S, G * R, Dh).transpose(1, 2), rep(kk), rep(vv),
                    is_causal=causal).transpose(1, 2).reshape(B, S, G, R, Dh)
            o.backward(do.to(dt))
            res.append([o.detach(), qq.grad, kk.grad, vv.grad])
        for name, a, b in zip(("out", "dq", "dk", "dv"), *res):
            err = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            assert err <= tol, (dt, name, err)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One train step of a 2-layer yi-9b-width-/8 model on the card and on
    a CPU copy of the same state (f32): loss, grad norm and parameters."""
    import dataclasses
    from repro_torch.configs import ARCHS, RunConfig
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.train import make_train_state, make_train_step
    from repro_torch.nn.models import build_model
    from repro_torch.optim import tree_leaves, tree_map
    cfg = dataclasses.replace(ARCHS["yi-9b"], n_layers=2, d_model=512, n_heads=4,
                              n_kv_heads=2, d_ff=1024, vocab_size=4000)
    rcfg = RunConfig(weight_dtype="f32", activation_dtype="f32", learning_rate=1e-3,
                     total_steps=10, warmup_steps=1, opt_state_quant="posit8")
    batch = synthetic_batch(DataConfig(vocab_size=4000, seq_len=64, global_batch=4), 0)
    out = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, rcfg, device=dev)
        if dev == "cuda":
            state = make_train_state(model, 0)
            host = lambda t: t.to("cpu", copy=True)
            moment = lambda q: dataclasses.replace(q, codes=host(q.codes), scale=host(q.scale))
            cpu_copy = {"params": tree_map(host, state["params"]),
                        "opt": {"m": tree_map(moment, state["opt"]["m"]),
                                "v": tree_map(moment, state["opt"]["v"]),
                                "count": host(state["opt"]["count"])}}
        else:
            state = cpu_copy
        state, m = make_train_step(model)(state, batch)
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    [p.cpu() for p in tree_leaves(state["params"])])
    (lc, gc, pc), (lh, gh, ph) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-5 * abs(lh) and abs(gc - gh) <= 1e-4 * gh
    for a, b in zip(pc, ph):
        # one Adam step moves each entry by ~lr = 1e-3; posit8 code flips at
        # rounding boundaries may move a few entries' steps
        d = (a - b).abs()
        assert (d > 3e-5).float().mean().item() <= 1e-3 and d.max().item() <= 5e-3
