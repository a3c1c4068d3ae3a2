"""The rest of the port's ``core`` API against the reference: the package's
re-exports, the PoFx converters and tables over every code, the numpy FxP
codec, ``norm_max``, and the Pareto front and hypervolume functions, all
bit for bit.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import fxp as j_fxp
from repro.core import normalized_posit as j_np
from repro.core import pareto as j_pareto
from repro.core import pofx as j_pofx
from repro_torch.core import fxp as t_fxp
from repro_torch.core import normalized_posit as t_np
from repro_torch.core import pareto as t_pareto
from repro_torch.core import pofx as t_pofx
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

NES = [(N, ES) for N in range(3, 11) for ES in range(0, 5)]
# the (M, F) pairs of the reference's tests/test_pofx.py
MF = [(8, 7), (16, 12), (20, 10), (32, 20)]


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_core_reexports_the_reference_names():
    from repro_torch.core import (QuantSpec, hypervolume, policy_from_pareto,  # noqa: F401
                                  quantize)
    from repro_torch.core import analysis, pareto, policy  # noqa: F401
    assert _public(tcore) >= _public(jcore)
    for name in _public(jcore):
        mod = getattr(getattr(jcore, name), "__module__", None)
        if mod and mod.startswith("repro.core"):
            got = getattr(getattr(tcore, name), "__module__", "")
            assert got.startswith("repro_torch.core"), (name, got)


@pytest.mark.parametrize("N,ES", NES)
def test_pofx_convert_every_code(N, ES):
    codes = np.arange(1 << N, dtype=np.int32)
    for M, F in MF:
        for rounding in ("trunc", "nearest"):
            want, want_of = j_pofx.pofx_convert_np(codes, N, ES, M, F, rounding)
            got, got_of = t_pofx.pofx_convert_np(codes, N, ES, M, F, rounding)
            assert got.dtype == want.dtype and got_of.dtype == want_of.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_of, want_of)
            lut = t_pofx.pofx_lut(N, ES, M, F, rounding)
            assert lut.dtype == np.int32
            np.testing.assert_array_equal(lut, j_pofx.pofx_lut(N, ES, M, F, rounding))
            if M > 31:
                with pytest.raises(ValueError):
                    t_pofx.pofx_convert(torch.from_numpy(codes), N, ES, M, F, rounding)
                continue
            # the torch converter against the reference's golden numpy
            # conversion (the reference's own tests hold its jnp converter
            # to the same)
            to, tof = t_pofx.pofx_convert(torch.from_numpy(codes), N, ES, M, F, rounding)
            assert to.dtype == torch.int32 and tof.dtype == torch.bool
            np.testing.assert_array_equal(to.numpy(), want)
            np.testing.assert_array_equal(tof.numpy(), want_of)


@pytest.mark.parametrize("N,ES", [(3, 0), (6, 1), (8, 2), (10, 4)])
def test_pofx_convert_matches_jnp_converter(N, ES):
    codes = np.arange(1 << N, dtype=np.int32)
    for M, F in MF:
        if M > 31:
            with pytest.raises(ValueError):
                j_pofx.pofx_convert(codes, N, ES, M, F)
            with pytest.raises(ValueError):
                t_pofx.pofx_convert(torch.from_numpy(codes), N, ES, M, F)
            continue
        jo, jof = j_pofx.pofx_convert(codes, N, ES, M, F)
        to, tof = t_pofx.pofx_convert(torch.from_numpy(codes), N, ES, M, F)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tof.numpy(), np.asarray(jof))


@pytest.mark.parametrize("N,ES", NES)
def test_pofx_normalized_np_every_code(N, ES):
    codes = np.arange(1 << (N - 1), dtype=np.int32)
    for M in (8, 12, 16):
        for rounding in ("trunc", "nearest"):
            want, want_of = j_pofx.pofx_normalized_np(codes, N, ES, M, rounding)
            got, got_of = t_pofx.pofx_normalized_np(codes, N, ES, M, rounding)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got_of, want_of)


def test_pofx_lut_is_cached():
    assert t_pofx.pofx_lut(8, 2, 8, 7) is t_pofx.pofx_lut(8, 2, 8, 7)
    assert t_pofx.pofx_lut.cache_info().maxsize == j_pofx.pofx_lut.cache_info().maxsize


@pytest.mark.parametrize("M,F", [(7, 6), (8, 7), (16, 15), (16, 12), (20, 10)])
def test_fxp_numpy_codec(M, F):
    rng = np.random.default_rng(M * 100 + F)
    x = rng.standard_normal(4096) * 0.6
    step = 1.0 / (1 << F)
    halves = (np.arange(-40, 40) + 0.5) * step          # ties: half to even
    x = np.concatenate([x, halves, [0.0, -0.0, 1e9, -1e9, 2.0, -2.0]])
    want = j_fxp.fxp_quantize_np(x, M, F)
    got = t_fxp.fxp_quantize_np(x, M, F)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    back, jback = t_fxp.fxp_dequantize_np(got, F), j_fxp.fxp_dequantize_np(want, F)
    assert back.dtype == jback.dtype == np.float64
    np.testing.assert_array_equal(back, jback)


@pytest.mark.parametrize("N", range(3, 11))
def test_norm_max(N):
    for ES in range(0, 5):
        assert t_np.norm_max(N, ES) == j_np.norm_max(N, ES)


def _points(seed, n, d, levels):
    """Seeded points on a coarse grid (ties) with duplicated rows."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, levels, (n, d)).astype(np.float64) / levels
    return np.concatenate([pts, pts[: n // 4]])


CLOUDS = [(seed, n, d, levels) for seed, (n, d, levels) in
          enumerate([(6, 2, 4), (40, 2, 10), (40, 2, 1000), (30, 3, 5), (60, 3, 50),
                     (25, 4, 6)])]


@pytest.mark.parametrize("seed,n,d,levels", CLOUDS)
def test_pareto_and_hypervolume(seed, n, d, levels):
    pts = _points(seed, n, d, levels)
    np.testing.assert_array_equal(t_pareto.pareto_mask(pts), j_pareto.pareto_mask(pts))
    np.testing.assert_array_equal(t_pareto.pareto_front(pts), j_pareto.pareto_front(pts))
    for ref in (np.full(d, 1.1), np.full(d, 0.6), np.linspace(0.8, 1.3, d)):
        assert t_pareto.hypervolume(pts, ref) == j_pareto.hypervolume(pts, ref)
        half = len(pts) // 2
        assert (t_pareto.hypervolume_gain(pts[:half], pts[half:], ref)
                == j_pareto.hypervolume_gain(pts[:half], pts[half:], ref))


def test_hypervolume_edge_cases():
    ref = np.array([1.0, 1.0])
    inside, outside = np.array([[0.5, 0.5]]), np.array([[2.0, 0.5]])
    empty = np.zeros((0, 2))
    for mod in (t_pareto, j_pareto):
        assert mod.hypervolume(empty, ref) == 0.0
        assert mod.hypervolume(outside, ref) == 0.0
        assert mod.hypervolume_gain(outside, inside, ref) == float("inf")
        assert mod.hypervolume_gain(outside, outside, ref) == 0.0
        assert mod.hypervolume_gain(inside, inside, ref) == 0.0
    assert t_pareto.hypervolume(np.array([[1.0, 2.0], [2.0, 1.0]]), np.array([3.0, 3.0])) == 3.0
    assert t_pareto.hypervolume(np.array([[1.0, 1.0, 1.0]]),
                                np.array([2.0, 3.0, 4.0])) == 6.0
