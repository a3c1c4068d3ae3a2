"""Megatron sequence parallelism on a training grid, the dense family, on the
CPU over gloo; and what every family shares: the rules table and each
leaf's gradient against the grid without it.

Under ``RunConfig(sequence_parallel=True)`` on a grid with a model axis
that divides the sequence, the residual stream between blocks is the
rank's block along seq: the embedding's sum is a reduce-scatter, each
sublayer gathers the whole sequence (``nn.sharding.gather_seq``, or
``gather_replicated`` before a leaf the model axis does not cut) and hands
back the rank's block (``scatter_seq`` or ``take_block``), and the norms on
the residual read their weights through ``copy_in``. The reference pins
the same layout with its "seq" rule (``make_ctx``); its numbers are its
tp = 1 step's, which the grids are held to (``grid_bridge``):

* yi-9b at the smoke size on (data 2, model 2), f32 and posit8 moments,
  with and without 2 microbatches, three steps against the reference's
  tp = 1 step under ``torch_bridge.assert_steps_match``'s bounds, with the
  exemptions of ``test_torch_train_grid.py``;
* (pod 2, model 2) under posit8_ef against the reference's pod
  composition (``grid_bridge.check_pod_case``);
* against the same grid without it: the first step's loss is equal (the
  forward computes every product on the same whole-sequence inputs, and
  model 2 sums two partials either way), and an odd sequence length,
  which the model axis does not divide, replicates: the steps are the
  steps without it, bit for bit;
* ``train_rules(..., sequence_parallel=True)`` is the reference's
  ``make_ctx`` table, key for key;
* every family's gradient, leaf by leaf and rank by rank, equals the grid
  without it (a norm weight that missed its model-axis sum fails by
  name).

The other families' three steps: ``test_torch_train_grid_sp_moe_ssm.py`` and
``test_torch_train_grid_sp_hybrid_encdec.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from grid_bridge import check_pod_case, reference, run_grid, three_steps
from torch_bridge import jax_compile_cache  # noqa: F401 (autouse)
from torch_bridge import (STEP_CASES, STEP_IDS, step_batches, step_kw,  # noqa: F401
                          torch_one_thread, walk)
from test_torch_train_grid import NOISE
from repro_torch.configs import ARCHS, smoke
from repro_torch.nn.sharding import train_rules

ARCH = "yi-9b"
GRID = (1, 2, 2)
POD_GRID = (2, 1, 2)
SP = {"sequence_parallel": True}


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, grids=[GRID, POD_GRID], timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


@pytest.mark.parametrize("quant,micro", STEP_CASES, ids=STEP_IDS)
def test_sp_grid_three_steps_match_reference(pool, quant, micro):
    three_steps(pool, ARCH, GRID, quant, micro, run_kw=SP, noise=NOISE)


def test_sp_pod_grid_posit8_ef_matches_reference(pool):
    """(pod 2, model 2), posit8_ef, posit8 moments: each pod's first
    gradients, the compressed mean bit for bit against the reference's
    transform of them, the three steps and both pods' residuals."""
    check_pod_case(pool, ARCH, POD_GRID, "posit8_ef", "posit8", 0, run_kw=SP)


def test_sp_first_loss_equals_the_grid_without_it(pool):
    """f32 moments: the first step's loss is the grid's without sequence
    parallelism, bit for bit; the later steps and the parameters after the
    third part only by the order of the backward's sums, within the f32
    bounds that both meet against the reference."""
    ref = reference(ARCH, "none", "none", 0)
    off, s_off, _ = run_grid(pool, ARCH, GRID, step_kw("none", 0), ref)
    on, s_on, _ = run_grid(pool, ARCH, GRID, step_kw("none", 0, **SP), ref)
    assert on[0]["loss"] == off[0]["loss"]
    for a, b in zip(on, off):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-5 * abs(b["grad_norm"])
    for path, a, b in walk(s_off["params"], s_on["params"]):
        assert np.abs(a - b).max() <= 3e-5, path


def test_odd_sequence_replicates_and_equals_no_sp(pool):
    """S = 31: the model axis does not divide the sequence, so the residual
    replicates (the reference's lenient spec) and two steps are the steps
    without sequence parallelism, bit for bit."""
    ref = reference(ARCH, "none", "posit8", 0)
    odd = {"init": ref["init"], "batches": step_batches(smoke(ARCHS[ARCH]), 2, 4, 31)}
    off, s_off, _ = run_grid(pool, ARCH, GRID, step_kw("posit8", 0), odd)
    on, s_on, _ = run_grid(pool, ARCH, GRID, step_kw("posit8", 0, **SP), odd)
    assert on == off
    leaves = list(walk(s_off, s_on))
    assert len(leaves) > 20
    for path, a, b in leaves:
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model"),
                                   ("data",), ("model",)])
@pytest.mark.parametrize("sp", [False, True])
def test_train_rules_equal_make_ctx(names, sp):
    from repro.nn.sharding import make_ctx
    mesh = SimpleNamespace(shape={a: 2 for a in names}, axis_names=names)
    want = {k: tuple(v) for k, v in make_ctx(mesh, sequence_parallel=sp).rules.items()}
    assert train_rules(names, sequence_parallel=sp) == want


FAMILY_ARCHS = ("yi-9b", "moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b",
                "falcon-mamba-7b", "zamba2-1.2b", "whisper-medium")
# the norm weights on the residual, each family's (their gradient sums over
# every rank's block of the sequence)
NORMS = {"yi-9b": ("blocks/ln1#0", "blocks/ln2#1", "ln_f#0"),
         "moonshot-v1-16b-a3b": ("blocks/moe/ln1#0", "blocks/moe/ln2#1", "ln_f#0"),
         "llama4-maverick-400b-a17b": ("blocks/dense/ln2#0", "blocks/moe/ln1#0", "ln_f#0"),
         "falcon-mamba-7b": ("blocks/ln#0", "blocks/ln#1", "ln_f#0"),
         "zamba2-1.2b": ("blocks/ln#2", "shared/ln1#0", "shared/ln2#0", "ln_f#0"),
         "whisper-medium": ("blocks/ln_x#1", "enc_blocks/ln1#0", "enc_ln#0", "ln_f#0")}


# top-1 routing: the router's gradient is zero in exact arithmetic, rounding
# noise in both (entries up to 1.4e-9), held to 1e-8
ZERO = {"llama4-maverick-400b-a17b": ("blocks/moe/moe/router#0",)}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_leaf_gradient_equals_the_grid_without_sp(pool, arch):
    """One forward and backward on (data 2, model 2), f32, S = 32: each
    rank's loss is the grid's without sequence parallelism, and each
    rank's gradient of every leaf, by name, within 1e-5 of the leaf's
    largest entry (the backward sums in another order: readings up to
    3.1e-7); the norms on the residual among them."""
    from grid_ranks import grads_case
    cfg = smoke(ARCHS[arch])
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    case = {"arch": arch, "batch": batch, "kw": {"remat": "block"}}
    off = pool.run(grads_case, case, grid=GRID)
    on = pool.run(grads_case, dict(case, kw={"remat": "block", **SP}), grid=GRID)
    assert set(NORMS[arch]) <= set(on[0][1])
    for r, ((l_off, g_off), (l_on, g_on)) in enumerate(zip(off, on)):
        assert l_on == l_off, r
        assert g_on.keys() == g_off.keys()
        for name, want in g_off.items():
            d = np.abs(g_on[name] - want).max()
            bound = 1e-8 if name in ZERO.get(arch, ()) else 1e-5 * np.abs(want).max()
            assert d <= bound, (r, name, d)
