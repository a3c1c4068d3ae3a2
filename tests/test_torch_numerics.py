"""The port's numerics core against the reference, bit for bit.

Every (N, ES, M) of the reference's ``default_spec_grid`` is swept over all
of its codes: posit decode, the bit-level PoFx decode (Algorithm 1) and its
LUT, normalized-posit encode (on every lattice point, every midpoint and
their float32 neighbours), ``quantize`` codes and scales on seeded arrays,
and the KV-cache code path.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fxp as j_fxp
from repro.core import normalized_posit as j_np
from repro.core import pofx as j_pofx
from repro.core import posit as j_posit
from repro.core import quantizers as jq
from repro.core.analysis import default_spec_grid
from repro_torch.core import fxp as t_fxp
from repro_torch.core import normalized_posit as t_np
from repro_torch.core import pofx as t_pofx
from repro_torch.core import posit as t_posit
from repro_torch.core import quantizers as tq
from repro_torch.kernels.ref import decode_norm_to_fxp

GRID = default_spec_grid()
POFX = [s for s in GRID if s.kind == "pofx"]
POSIT_NES = sorted({(s.N, s.ES) for s in GRID if s.kind in ("posit", "pofx")})


def _id(s):
    return f"{s.kind}-N{s.N}-ES{s.ES}-M{s.M}-F{s.F}-{s.path}"


def _tspec(s):
    return tq.QuantSpec(**dataclasses.asdict(s))


def _probe_values(N, ES):
    """Every lattice value, every midpoint and their f32 neighbours, both
    signs, zero, beyond-maxpos and NaN."""
    table = t_posit.posit_value_table(N, ES).astype(np.float32)
    mids = ((table[:-1].astype(np.float64) + table[1:]) / 2).astype(np.float32)
    base = np.concatenate([table, mids, [table[-1] * 4, 1e30]]).astype(np.float32)
    near = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf))])
    return np.concatenate([near, -near, [np.nan]]).astype(np.float32)


@pytest.mark.parametrize("N,ES", POSIT_NES)
def test_posit_decode_and_table_exhaustive(N, ES):
    codes = np.arange(1 << N, dtype=np.int32)
    got = t_posit.posit_decode(torch.from_numpy(codes), N, ES).numpy()
    want = np.asarray(j_posit.posit_decode(jnp.asarray(codes), N, ES))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_posit.posit_value_table(N, ES),
                                  j_posit.posit_value_table(N, ES))
    assert t_posit.NAR(N) == j_posit.NAR(N)


@pytest.mark.parametrize("N,ES", POSIT_NES)
def test_posit_and_norm_encode_match(N, ES):
    x = _probe_values(N, ES)
    got = t_posit.posit_encode(torch.from_numpy(x), N, ES).numpy()
    want = np.asarray(j_posit.posit_encode(jnp.asarray(x), N, ES))
    np.testing.assert_array_equal(got, want)
    got = t_np.norm_encode(torch.from_numpy(x), N, ES).numpy()
    want = np.asarray(j_np.norm_encode(jnp.asarray(x), N, ES))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("spec", POFX, ids=_id)
def test_pofx_decode_exhaustive(spec):
    N, ES, M = spec.N, spec.ES, spec.M
    codes = np.arange(1 << (N - 1), dtype=np.int32)
    got, got_of = t_pofx.pofx_normalized(torch.from_numpy(codes), N, ES, M)
    want, want_of = j_pofx.pofx_normalized(jnp.asarray(codes), N, ES, M)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_of.numpy(), np.asarray(want_of))
    lut = t_pofx.pofx_norm_lut(N, ES, M)
    np.testing.assert_array_equal(lut, j_pofx.pofx_norm_lut(N, ES, M))
    # the table the kernels stage equals the bit-level decode on every code
    np.testing.assert_array_equal(
        lut, decode_norm_to_fxp(torch.from_numpy(codes), N, ES, M).numpy())
    # and norm_expand/compress round-trip every stored code
    back = t_np.norm_compress(t_np.norm_expand(torch.from_numpy(codes), N), N)
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("N,ES", [(8, 2), (6, 1)])
def test_pofx_nearest_rounding_matches(N, ES):
    codes = np.arange(1 << (N - 1), dtype=np.int32)
    got, _ = t_pofx.pofx_normalized(torch.from_numpy(codes), N, ES, 8, "nearest")
    want, _ = j_pofx.pofx_normalized(jnp.asarray(codes), N, ES, 8, "nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", GRID, ids=_id)
def test_quantize_codes_scales_dequantize_bit_exact(spec):
    rng = np.random.default_rng(hash(_id(spec)) % 2**32)
    for shape, axis, sd in (((48, 40), -1, 0.05), ((32, 3, 16), -1, 0.4),
                            ((64, 24), None, 2.0)):
        w = rng.normal(0, sd, shape).astype(np.float32)
        qj = jq.quantize(jnp.asarray(w), spec, axis=axis)
        qt = tq.quantize(torch.from_numpy(w), _tspec(spec), axis=axis)
        np.testing.assert_array_equal(
            qt.codes.numpy().astype(np.int64),
            np.asarray(qj.codes).astype(np.int64))
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
        np.testing.assert_array_equal(
            tq.dequantize(qt, torch.float32).numpy(),
            np.asarray(jq.dequantize(qj, jnp.float32)))
        assert tq.storage_bits(qt) == jq.storage_bits(qj)
        if spec.kind in ("fxp", "pofx") and spec.M <= 8:
            tc, tr = tq.fxp_view(qt)
            jc, jr = jq.fxp_view(qj)
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("mode", ["tensor", "tensor_pow2", "channel",
                                  "channel_pow2", "none"])
def test_compute_scale_matches(mode):
    w = np.random.default_rng(1).normal(0, 0.7, (24, 3, 20)).astype(np.float32)
    got = t_fxp.compute_scale(torch.from_numpy(w), mode, axis=-1).numpy()
    want = np.asarray(j_fxp.compute_scale(jnp.asarray(w), mode, axis=-1))
    np.testing.assert_array_equal(got, want)


def test_pow2_scale_is_exact_at_every_power_of_two():
    # the port rounds a channel max of exactly 2^k to 2^k for every k;
    # the reference agrees for |k| <= 12 (ROADMAP Queue C records where its
    # CPU log2/exp2 are off by an ulp)
    ks = np.arange(-39, 41)      # 2^-40 is below the 1e-12 eps floor
    w = np.exp2(ks).astype(np.float32)[None, :]
    got = t_fxp.compute_scale(torch.from_numpy(w), "channel_pow2", axis=-1)
    np.testing.assert_array_equal(got.numpy()[0], np.exp2(ks).astype(np.float32))
    small = np.abs(ks) <= 12
    want = np.asarray(j_fxp.compute_scale(jnp.asarray(w), "channel_pow2", axis=-1))
    np.testing.assert_array_equal(got.numpy()[0][small], want[0][small])


def test_fxp_quantize_rounds_half_to_even_like_reference():
    x = (np.arange(-300, 300) / 2 / 128).astype(np.float32)
    got = t_fxp.fxp_quantize(torch.from_numpy(x), 8, 7).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_fxp.fxp_quantize(jnp.asarray(x), 8, 7)))


KV_SPECS = [jq.QuantSpec(kind="fxp", M=8, F=7), jq.QuantSpec(kind="fxp", M=8, F=4),
            jq.QuantSpec(kind="pofx", N=8, ES=2), jq.QuantSpec(kind="pofx", N=6, ES=1),
            jq.QuantSpec(kind="pofx", N=8, ES=2, path="direct")]


@pytest.mark.parametrize("spec", KV_SPECS, ids=_id)
def test_kv_quantize_dequantize_bit_exact(spec):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 0.8, (2, 3, 7, 16)).astype(np.float32)
    scale = np.exp2(rng.integers(-1, 2, (2, 3, 1, 16))).astype(np.float32)
    cj = jq.kv_quantize(jnp.asarray(x), spec, jnp.asarray(scale))
    ct = tq.kv_quantize(torch.from_numpy(x), _tspec(spec), torch.from_numpy(scale))
    assert ct.dtype == tq.kv_code_dtype(_tspec(spec))
    assert str(ct.dtype).replace("torch.", "") == jnp.dtype(cj.dtype).name
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(
        tq.kv_dequantize(ct, _tspec(spec), torch.from_numpy(scale)).numpy(),
        np.asarray(jq.kv_dequantize(cj, spec, jnp.asarray(scale))))


def test_validate_kv_spec_rules_match():
    for spec in [None, jq.QuantSpec(kind="bf16"), jq.QuantSpec(kind="fp32")]:
        assert tq.validate_kv_spec(None if spec is None else _tspec(spec)) is None
    bad = [jq.QuantSpec(kind="posit", N=8, ES=2), jq.QuantSpec(kind="fxp", M=16, F=15),
           jq.QuantSpec(kind="pofx", N=8, ES=2, rounding="nearest")]
    for spec in bad:
        with pytest.raises(ValueError):
            jq.validate_kv_spec(spec)
        with pytest.raises(ValueError):
            tq.validate_kv_spec(_tspec(spec))
    with pytest.raises(ValueError, match="kv code path"):
        tq.kv_quantize(torch.ones(2, 2), tq.QuantSpec(kind="posit"), torch.ones(1))
