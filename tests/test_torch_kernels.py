"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper computes its plain version; these tests hold those
against the reference kernels run in interpret mode (exact for fxp_matmul,
``allclose`` for the float kernels), the ``quant_matmul`` dispatch against
the reference's for pofx, fxp and bf16 weights, and the scale-layout
guards.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizers import QuantSpec as JSpec
from repro.core.quantizers import quantize as j_quantize
from repro.kernels.fxp_matmul import fxp_matmul as j_fxp_matmul
from repro.kernels.kv_flash_decode import kv_flash_decode as j_kv_flash_decode
from repro.kernels.ops import out_channel_scale as j_out_channel_scale
from repro.kernels.ops import quant_matmul as j_quant_matmul
from repro.kernels.pofx_matmul import pofx_matmul as j_pofx_matmul
from repro.core.quantizers import kv_quantize as j_kv_quantize
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.quantizers import QuantizedTensor as TQT
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.fxp_matmul import fxp_matmul
from repro_torch.kernels.kv_flash_decode import kv_flash_decode
from repro_torch.kernels.ops import KERNELS, PLAIN, out_channel_scale, quant_matmul
from repro_torch.kernels.pofx_matmul import pofx_matmul
from torch_bridge import tspec

# f32 sums of up to a few hundred terms taken in another order: a few ulps
RTOL, ATOL = 1e-5, 1e-5

FXP8 = JSpec(kind="fxp", M=8, F=7)
POFX8 = JSpec(kind="pofx", N=8, ES=2)


def _codes(rng, k, n, N):
    return rng.integers(0, 1 << (N - 1), (k, n)).astype(np.uint8)


@pytest.mark.parametrize("m,k,n", [(4, 64, 96), (13, 200, 72), (64, 128, 257)])
@pytest.mark.parametrize("N,ES", [(8, 2), (6, 1)])
def test_pofx_matmul_plain_matches_reference_kernel(m, k, n, N, ES):
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    codes = _codes(rng, k, n, N)
    scale = np.exp2(rng.integers(-3, 2, n)).astype(np.float32)
    want = np.asarray(j_pofx_matmul(jnp.asarray(x), jnp.asarray(codes),
                                    jnp.asarray(scale), N, ES, 8))
    got = pofx_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                      torch.from_numpy(scale), N, ES, 8)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pofx_matmul_bf16_activations():
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (5, 64)).astype(np.float32)
    codes = _codes(rng, 64, 40, 8)
    scale = np.ones(40, np.float32)
    want = np.asarray(j_pofx_matmul(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(codes), jnp.asarray(scale), 8, 2))
    got = pofx_matmul(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(codes), torch.from_numpy(scale), 8, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_pofx_matmul_rejects_mismatch():
    with pytest.raises(ValueError, match="contraction"):
        pofx_matmul(torch.zeros(2, 3), torch.zeros(4, 5, dtype=torch.uint8),
                    torch.ones(5), 8, 2)


@pytest.mark.parametrize("m,k,n", [(4, 96, 80), (33, 200, 65), (1, 7, 3)])
def test_fxp_matmul_plain_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    want = np.asarray(j_fxp_matmul(jnp.asarray(a), jnp.asarray(b)))
    got = fxp_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fxp_matmul_accumulator_headroom_exact():
    # all-extreme operands: |sum| = 128*128*k needs the int32 accumulator
    k = 4096
    a = np.full((2, k), -128, np.int8)
    b = np.full((k, 3), -128, np.int8)
    got = fxp_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (got == 128 * 128 * k).all()


def _kv_inputs(spec, B=3, G=2, R=4, S=45, Dh=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, G, R, Dh)).astype(np.float32)
    kf = rng.normal(0, 0.5, (B, G, S, Dh)).astype(np.float32)
    vf = rng.normal(0, 0.5, (B, G, S, Dh)).astype(np.float32)
    ks = np.exp2(rng.integers(-1, 2, (B, G, 1, Dh))).astype(np.float32)
    vs = np.exp2(rng.integers(-1, 2, (B, G, 1, Dh))).astype(np.float32)
    kc = np.array(j_kv_quantize(jnp.asarray(kf), spec, jnp.asarray(ks)))
    vc = np.array(j_kv_quantize(jnp.asarray(vf), spec, jnp.asarray(vs)))
    pos = np.array([1, 17, 45][:B], np.int32)
    return q, kc, ks, vc, vs, pos


@pytest.mark.parametrize("spec", [FXP8, POFX8, JSpec(kind="pofx", N=6, ES=1)],
                         ids=["fxp8", "pofx8es2", "pofx6es1"])
def test_kv_flash_decode_plain_matches_reference_kernel(spec):
    q, kc, ks, vc, vs, pos = _kv_inputs(spec)
    want = np.asarray(j_kv_flash_decode(*map(jnp.asarray, (q, kc, ks, vc, vs, pos)),
                                        spec, block_s=16))
    args = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs, pos)]
    got = kv_flash_decode(*args, tspec(spec))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_kv_flash_decode_scalar_pos_and_scale_guards():
    q, kc, ks, vc, vs, _ = _kv_inputs(FXP8)
    args = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs)]
    want = np.asarray(j_kv_flash_decode(*map(jnp.asarray, (q, kc, ks, vc, vs)),
                                        jnp.int32(9), FXP8))
    got = kv_flash_decode(*args, torch.tensor(9), tspec(FXP8))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    bad = torch.ones(3, 2, 2, 32)
    for i in (2, 4):
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError, match="per-head-dim-channel"):
            kv_flash_decode(*a, torch.tensor(9), tspec(FXP8))
    with pytest.raises(ValueError, match="shape mismatch"):
        kv_flash_decode(args[0], args[1], args[2], args[3][:, :, :5], args[4],
                        torch.tensor(9), tspec(FXP8))


def test_cpu_wrappers_launch_nothing():
    before = dict(LAUNCHES)
    pofx_matmul(torch.zeros(2, 8), torch.zeros(8, 4, dtype=torch.uint8),
                torch.ones(4), 8, 2)
    fxp_matmul(torch.zeros(2, 8, dtype=torch.int8), torch.zeros(8, 4, dtype=torch.int8))
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# quant_matmul dispatch and scale layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec_s", ["pofx8es2", "fxp8f7", "bf16", "pofx6es1", "posit8es2"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_quant_matmul_matches_reference(spec_s, use_kernel):
    from repro.core.policy import parse_spec
    spec = parse_spec(spec_s)
    rng = np.random.default_rng(11)
    w = rng.normal(0, 0.2, (48, 40)).astype(np.float32)
    x = rng.normal(0, 1, (2, 3, 48)).astype(np.float32)
    qj = j_quantize(jnp.asarray(w), spec, axis=-1)
    qt = TQT(tensor_from_numpy(np.asarray(qj.codes), "cpu"),
             tensor_from_numpy(np.asarray(qj.scale), "cpu"), tspec(spec))
    want = np.asarray(j_quant_matmul(jnp.asarray(x), qj, use_kernel=use_kernel))
    got = quant_matmul(torch.from_numpy(x), qt,
                       kernels=KERNELS if use_kernel else None)
    assert got.shape == (2, 3, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if use_kernel:   # the plain set computes the same datapath
        again = quant_matmul(torch.from_numpy(x), qt, kernels=PLAIN)
        np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("scale_shape,codes_shape", [
    ((1, 40), (48, 40)), ((40,), (48, 40)), ((1, 1, 8), (48, 5, 8)),
    ((), (48, 40)), ((1, 1), (48, 40)), ((48, 40), (48, 40)),
    ((48, 1), (48, 40)), ((1, 1, 1, 40), (48, 40)), ((7,), (48, 40)),
    ((3, 1, 8), (48, 5, 8))])
def test_out_channel_scale_raises_where_reference_raises(scale_shape, codes_shape):
    s = np.ones(scale_shape, np.float32)
    try:
        want = np.asarray(j_out_channel_scale(jnp.asarray(s), codes_shape))
    except ValueError:
        with pytest.raises(ValueError):
            out_channel_scale(torch.from_numpy(s), codes_shape)
        return
    got = out_channel_scale(torch.from_numpy(s), codes_shape)
    np.testing.assert_array_equal(got.numpy(), want)
