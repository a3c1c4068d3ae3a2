"""The posit-compressed cross-pod gradient mean against the reference's.

* ``core.posit.posit_encode_arith`` and ``core.normalized_posit.
  norm_encode_arith`` equal the reference's bit for bit on every float32
  input class: +-0, subnormals, NaN and infinities, every posit value and
  the midpoints between neighbours (ties), one ulp either side of them, the
  regime boundaries (powers of useed), values past maxpos and below minpos,
  and random values and bit patterns over every binade.
* ``runtime.compression.pow2_scale`` is the exact power of two; the
  reference's ``_pow2_scale`` equals it for amax in [2^-12, 2^12] (its CPU
  ``exp2`` misses powers of two outside, ROADMAP Queue C item 4).
* ``posit_compressed_mean`` through ``compressed_grad_transform`` on a
  (pod 2, model 2) grid of CPU ranks (each rank a model block of its pod's
  leaves; a leaf whole; two leaves sharing one scale as the layers of a
  stacked reference leaf do), with and without residuals, against the
  reference's ``compressed_grad_transform`` under ``jax.vmap(...,
  axis_name="pod")``: means and residuals bit for bit where every amax lies
  in [2^-12, 2^12]; outside it (Queue C item 4) the port keeps its exact
  scale, and its codes part from the reference's by one step on at most
  0.1 % of entries.
"""
import numpy as np
import pytest
import torch

from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)
from repro_torch.core.normalized_posit import norm_encode_arith
from repro_torch.core.posit import posit_encode_arith, posit_value_table
from repro_torch.runtime.compression import pow2_scale

GRID = (2, 1, 2)
CONFIGS = [(8, 2), (8, 0), (8, 1), (6, 1), (7, 3), (16, 2), (5, 4)]


def sweep(N, ES):
    """float32 inputs of every class for Posit(N, ES)."""
    rng = np.random.RandomState(N * 10 + ES)
    table = posit_value_table(N, ES)
    vals = table[1:].astype(np.float32)
    mids = ((table[1:-1] + table[2:]) / 2).astype(np.float32)
    useed = 2.0 ** (2 ** ES)
    regimes = np.float32([useed ** k for k in range(-(N - 1), N)])
    base = np.concatenate([vals, mids, regimes, np.float32([table[1] / 2, table[1] * 0.75,
                                                            table[-1] * 1.5, 3e38])])
    near = np.concatenate([np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(0))])
    special = np.float32([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, 1.2e-38, 5e-39])
    binades = (rng.uniform(1, 2, 4000) * np.exp2(rng.randint(-149, 128, 4000))).astype(np.float32)
    bits = rng.randint(0, 2 ** 32, 8000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    x = np.concatenate([base, near, special, binades, bits])
    return np.concatenate([x, -x])


@pytest.mark.parametrize("N,ES", CONFIGS)
def test_arith_encoders_match_reference_bit_for_bit(N, ES):
    import jax.numpy as jnp
    from repro.core.normalized_posit import norm_encode_arith as j_norm
    from repro.core.posit import posit_encode_arith as j_posit
    import jax
    x = sweep(N, ES)
    got = posit_encode_arith(torch.from_numpy(x), N, ES).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(lambda v: j_posit(v, N, ES))(jnp.asarray(x))))
    got = norm_encode_arith(torch.from_numpy(x), N, ES).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(lambda v: j_norm(v, N, ES))(jnp.asarray(x))))


def test_pow2_scale_is_exact_and_the_reference_s_in_range():
    import jax.numpy as jnp
    from repro.runtime.compression import _pow2_scale
    rng = np.random.RandomState(0)
    amax = np.concatenate([np.exp2(np.arange(-40, 41)),
                           rng.uniform(1, 2, 400) * np.exp2(rng.randint(-40, 41, 400)),
                           [0.0, 1e-31, 1e-30, 1e38]]).astype(np.float32)
    got = np.array([float(pow2_scale(torch.tensor(a))) for a in amax])
    want = np.exp2(np.ceil(np.log2(np.maximum(amax.astype(np.float64), np.float32(1e-30)))))
    assert np.array_equal(got, want)
    inside = (amax >= 2.0 ** -12) & (amax <= 2.0 ** 12)
    import jax
    ref_scale = jax.jit(jax.vmap(_pow2_scale))
    ref = np.asarray(ref_scale(jnp.asarray(amax[inside])))
    assert np.array_equal(ref, got[inside])
    # outside the range the reference's exp2 lands within 1e-5 of the power
    # of two, and at an amax that is one its log2 may round up to the next
    ratio = np.asarray(ref_scale(jnp.asarray(amax[~inside]))) / got[~inside]
    assert (np.minimum(np.abs(ratio - 1), np.abs(ratio - 2)) <= 1e-5).all()
    assert (ratio != 1).any()


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=[GRID], timeout_s=120) as p:
        yield p


def leaves(rng, scales):
    """Each pod's gradient leaves: (P=2, 8, 12) model-split on dim 1, (2, 6,
    4, 5) split on dim 0, (2, 16) whole, and two (2, 8, 6) leaves of one
    name split on dim 1, at the magnitudes ``scales``."""
    shapes = [(2, 8, 12), (2, 6, 4, 5), (2, 16), (2, 8, 6), (2, 8, 6)]
    xs = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in zip(shapes, scales)]
    return xs, [1, 0, None, 1, 1], ["a", "b", "c", "d", "d"]


def reference(xs, residuals, names):
    """The reference's transform under vmap over the pods, on its tree (the
    two "d" leaves stacked, as a stacked leaf's layers are)."""
    import jax
    from repro.runtime.compression import compressed_grad_transform
    tree = {"a": xs[0], "b": xs[1], "c": xs[2], "d": np.stack([xs[3], xs[4]], 1)}
    res = None
    if residuals is not None:
        res = {"a": residuals[0], "b": residuals[1], "c": residuals[2],
               "d": np.stack([residuals[3], residuals[4]], 1)}
    fn = jax.jit(jax.vmap(lambda g, r: compressed_grad_transform(g, "pod", N=8, ES=2,
                                                                 residuals=r),
                          axis_name="pod"))
    mean, new = fn(tree, res)

    def flat(t):
        t = {k: np.asarray(v) for k, v in t.items()}
        return [t["a"], t["b"], t["c"], t["d"][:, 0], t["d"][:, 1]]
    return flat(mean), None if new is None else flat(new)


def on_grid(pool, xs, residuals, dims, names):
    """The port's transform on the (pod 2, model 2) ranks, each pod's
    blocks put back together: (means (P, ...), residuals (P, ...) or None)."""
    from grid_ranks import compressed_case
    res = pool.run(compressed_case, xs, residuals, dims, names, grid=GRID)

    def whole(k, i):
        out = []
        for p in range(2):
            blocks = [res[2 * p + m][k][i] for m in range(2)]
            d = dims[i]
            out.append(blocks[0] if d is None else np.concatenate(blocks, d))
        return np.stack(out)
    means = [whole(0, i) for i in range(len(xs))]
    new = None if residuals is None else [whole(1, i) for i in range(len(xs))]
    return means, new


@pytest.mark.parametrize("with_residuals", [False, True], ids=["plain", "ef"])
def test_compressed_mean_matches_reference_bit_for_bit(pool, with_residuals):
    """amax of every leaf within [2^-12, 2^12]: means (the same on both pods)
    and residuals equal the reference's bit for bit."""
    rng = np.random.RandomState(1)
    xs, dims, names = leaves(rng, [1e-3, 0.3, 7.0, 2e-2, 5e-3])
    residuals = None
    if with_residuals:
        residuals = [(rng.standard_normal(x.shape) * 1e-4).astype(np.float32) for x in xs]
    want, want_res = reference(xs, residuals, names)
    got, got_res = on_grid(pool, xs, residuals, dims, names)
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w, g), i
        assert np.array_equal(g[0], g[1]), i
    if with_residuals:
        for i, (w, g) in enumerate(zip(want_res, got_res)):
            assert np.array_equal(w, g), i


def test_compressed_mean_outside_the_exact_exp2_range(pool):
    """Queue C item 4: amax below 2^-12 or above 2^12. The port's scale is
    the exact power of two, the reference's a few ulps off it: codes part
    by one step on at most 0.1 % of entries, and elsewhere the means differ
    by the scales' ratio only (within 1e-6 of the pods' magnitudes)."""
    import jax.numpy as jnp
    from repro.core.normalized_posit import norm_encode_arith as j_norm
    from repro.runtime.compression import _pow2_scale
    rng = np.random.RandomState(2)
    # amax in (2^-18, 2^-17], (2^-16, 2^-15], (2^14, 2^15], (2^-20, 2^-19] (the
    # two "d" leaves): powers of two that the reference's exp2 misses
    xs, dims, names = leaves(rng, [1.7e-6, 8e-6, 8e3, 2.8e-7, 5e-7])
    import jax
    j_scale, j_enc = jax.jit(_pow2_scale), jax.jit(lambda v: j_norm(v, 8, 2))
    want, _ = reference(xs, None, names)
    got, _ = on_grid(pool, xs, None, dims, names)
    groups = {"a": [0], "b": [1], "c": [2], "d": [3, 4]}
    for name, idx in groups.items():
        for p in range(2):
            amax = max(np.abs(xs[i][p]).max() for i in idx)
            exact = float(pow2_scale(torch.tensor(amax)))
            ref_scale = float(j_scale(jnp.asarray(np.stack([xs[i][p] for i in idx]))))
            assert ref_scale != exact and abs(ref_scale / exact - 1) <= 1e-6, (name, p)
            for i in idx:
                x = xs[i][p]
                c_ref = np.asarray(j_enc(jnp.asarray(x / np.float32(ref_scale))))
                c_got = norm_encode_arith(torch.from_numpy(x / np.float32(exact)), 8, 2).numpy()
                signed = lambda c: np.where(c < 64, c, c - 128).astype(int)  # noqa: E731
                step = np.abs(signed(c_ref) - signed(c_got))
                assert step.max() <= 1 and (step > 0).mean() <= 1e-3, (name, i)
    for i, (w, g) in enumerate(zip(want, got)):
        # where the codes agree the means part by the scales' ratio only
        close = np.abs(g - w) <= 1e-6 * (np.abs(xs[i][0]) + np.abs(xs[i][1]))
        assert close.mean() >= 1 - 1e-3, i
