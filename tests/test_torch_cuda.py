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
from repro_torch.kernels.pofx_matmul import pofx_matmul, pofx_matmul_ref

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


@pytest.mark.parametrize("N,ES", [(8, 2), (7, 1), (6, 3)])
def test_pofx_matmul_decodes_every_code_exactly(cuda, N, ES):
    L = 1 << (N - 1)
    codes = torch.arange(L, device=cuda, dtype=torch.uint8)[None].expand(L, L).contiguous()
    got = pofx_matmul(torch.eye(L, device=cuda), codes, torch.ones(L, device=cuda), N, ES)
    lut = torch.as_tensor(pofx_norm_lut(N, ES, 8), device=cuda).float() / 128
    assert torch.equal(got, lut[None].expand(L, L))


@pytest.mark.parametrize("m,k,n", [(4, 4096, 11008), (64, 11008, 4096), (3, 37, 70)])
def test_fxp_matmul_exact(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(1)
    a = torch.randint(-128, 128, (m, k), generator=g, device=cuda).to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=g, device=cuda).to(torch.int8)
    assert torch.equal(fxp_matmul(a, b), fxp_matmul_ref(a, b))


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


def test_wrappers_raise_on_mixed_devices(cuda):
    with pytest.raises(ValueError, match="CUDA"):
        pofx_matmul(torch.zeros(2, 8, device=cuda),
                    torch.zeros(8, 4, dtype=torch.uint8), torch.ones(4), 8, 2)
    with pytest.raises(ValueError, match="uint8"):
        pofx_matmul(torch.zeros(2, 8, device=cuda),
                    torch.zeros(8, 4, dtype=torch.int8, device=cuda),
                    torch.ones(4, device=cuda), 8, 2)
