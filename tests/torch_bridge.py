"""Test-side bridge between the reference package (JAX) and the port.

Flattens a reference parameter tree to the nested numpy dicts that
``repro_torch.convert.params_from_numpy`` takes (a QuantizedTensor becomes
{"codes", "scale", "spec": format_spec string}), converts reference specs
to port specs, builds matching tiny models in both packages, and lists
both trees' leaves in one form (``reference_leaves``, ``port_leaves``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os

import jax
import numpy as np
import pytest
from jax.experimental.compilation_cache import compilation_cache

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.core.policy import format_spec as j_format_spec
from repro.core.quantizers import QuantizedTensor as JQT, QuantSpec as JSpec
from repro.nn.models import apply_policy as j_apply_policy, build_model as j_build_model
from repro_torch.configs import ARCHS as T_ARCHS, RunConfig as TRunConfig, smoke as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import format_spec, named_leaves
from repro_torch.core.quantizers import QuantSpec as TSpec, QuantizedTensor
from repro_torch.nn.models import build_model as t_build_model


def to_numpy_tree(tree):
    """Reference param tree -> nested numpy dicts (QuantizedTensor as one
    {"codes", "scale", "spec"} leaf)."""
    if isinstance(tree, JQT):
        return {"codes": np.asarray(tree.codes), "scale": np.asarray(tree.scale),
                "spec": j_format_spec(tree.spec)}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def tspec(spec):
    """Reference QuantSpec (or None) -> port QuantSpec."""
    return None if spec is None else TSpec(**dataclasses.asdict(spec))


def jspec(spec):
    return None if spec is None else JSpec(**dataclasses.asdict(spec))


@functools.lru_cache(maxsize=16)
def _jax_params(jcfg, policy, seed):
    """Reference parameters (jit-initialized, jit-quantized), cached per
    (config, policy, seed): models are cheap facades, params are not."""
    jm = j_build_model(jcfg, JRunConfig(remat="none"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    if policy is not None:
        params = jax.jit(lambda p: j_apply_policy(p, policy))(params)
    return params


def pair(policy="pofx8", *, kv=None, use_kernel=False, arch="yi-9b", cfg_fn=None):
    """Matching (jax_model, jax_params, torch_model, torch_params) for the
    smoke-size ``arch`` at f32 activations (``cfg_fn`` edits both configs),
    with the reference's weights (seed 0, quantized by ``policy``) carried
    across."""
    jc, tc = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    if cfg_fn is not None:
        jc, tc = cfg_fn(jc), cfg_fn(tc)
    jm = j_build_model(jc,
                       JRunConfig(remat="none", activation_dtype="f32"),
                       use_kernel=use_kernel, kv_spec=jspec(kv))
    tm = t_build_model(tc,
                       TRunConfig(remat="none", activation_dtype="f32"),
                       device="cpu", use_kernel=use_kernel, kv_spec=tspec(kv))
    jp = _jax_params(jm.cfg, policy, 0)
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    return jm, jp, tm, tp


def reference_leaves(params):
    """{name: (format, codes shape, scale shape, count)} of the reference's
    tree, stacked axes stripped (the port's per-layer leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, JQT))[0]
    out = {}
    for path, leaf in flat:
        names = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        stacked = "blocks" in names or "enc_blocks" in names
        depth = (2 if "dense" in names else 1) if stacked else 0
        if isinstance(leaf, JQT):
            codes, scale = np.asarray(leaf.codes), np.asarray(leaf.scale)
            fmt = format_spec(leaf.spec)
            out["/".join(names)] = (fmt, codes.shape[depth:], scale.shape[depth:],
                                    math.prod(codes.shape[:depth]))
        else:
            a = np.asarray(leaf)
            out["/".join(names)] = (a.dtype.name, a.shape[depth:], None,
                                    math.prod(a.shape[:depth]))
    return out


def port_leaves(params):
    out = {}
    for name, leaf in named_leaves(params):
        if isinstance(leaf, QuantizedTensor):
            key = (format_spec(leaf.spec), tuple(leaf.codes.shape), tuple(leaf.scale.shape))
        else:
            key = (str(leaf.dtype).replace("torch.", ""), tuple(leaf.shape), None)
        fmt, shape, sshape, n = out.get(name, (*key, 0))
        assert (fmt, shape, sshape) == key, (name, key, (fmt, shape, sshape))
        out[name] = (fmt, shape, sshape, n + 1)
    return out


# -- training: matching f32 models, reference gradients and train steps -------

F32 = dict(weight_dtype="f32", activation_dtype="f32")


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the duration: the smoke-size
    tensors gain nothing from more, and under the suite's parallel workers
    idle pool threads only take CPU from the reference's compiles."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_compile_cache():
    """JAX's persistent compile cache for a whole port test module, autouse
    once the module imports it. Most of the differential tests' time is the
    reference's XLA compiles, and many are of the same computation: each
    engine a case makes jits its own step functions, and each of the
    suite's processes compiles the smoke models anew. The cache keeps every
    compile (of any length) under the checkout's git-ignored build/ and
    gives it back to a later compile of the same computation in this
    process or another. The settings are put back after the module, so the
    JAX package's own tests run as they would alone."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "build",
                        "jax_cache")
    settings = {"jax_compilation_cache_dir": path,
                "jax_persistent_cache_min_compile_time_secs": 0.0,
                "jax_persistent_cache_min_entry_size_bytes": 0}
    before = {name: getattr(jax.config, name) for name in settings}
    for name, value in settings.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for name, value in before.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """``one_thread`` for a whole test module, autouse once the module
    imports it: under the suite's parallel workers torch's default pool
    (a thread a core in every worker) oversubscribes the CPU many times
    over, and the smoke-size tensors gain nothing from it."""
    with one_thread():
        yield


def train_models(arch, over=(), **rkw):
    """Matching smoke-size (jax_model, torch_model) of ``arch`` (``over``:
    (field, value) pairs replacing config fields) at f32 weights and
    activations, on the CPU."""
    jc, tc = j_smoke(J_ARCHS[arch]), t_smoke(T_ARCHS[arch])
    if over:
        jc, tc = dataclasses.replace(jc, **dict(over)), dataclasses.replace(tc, **dict(over))
    return (j_build_model(jc, JRunConfig(**F32, **rkw)),
            t_build_model(tc, TRunConfig(**F32, **rkw), device="cpu"))


def train_batch(cfg, B, S, seed, frames=False):
    """A numpy batch {"tokens", "labels"[, "frames" (B, S, d_model) f32]}:
    B rows of S + 1 tokens from a seeded RandomState, shifted by one."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if frames:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return batch


def walk(a, b, path=""):
    """(path, a leaf, b leaf) over two nested dicts of the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            yield from walk(a[k], b[k], f"{path}/{k}")
    else:
        yield path, np.asarray(a), np.asarray(b)


def check_logits_and_grads(jm, tm, batch, *, seed=0, rtol=1e-4, zero_leaves=()):
    """The reference's f32 parameters (seed ``seed``) carried across:
    ``LM.forward`` logits within ``rtol`` (absolute and relative), the
    loss to 1e-6 and every leaf of the port's ``value_and_grad`` within
    ``rtol`` of the largest entry of ``jax.grad(model.loss)``'s leaf.
    ``zero_leaves`` names leaves whose gradient is zero in exact
    arithmetic (a top-1 router: its gate renormalises to 1), so that both
    frameworks give rounding noise only: there both must stay below
    ``rtol`` x 1e-2 of the largest entry of any leaf. Returns the number
    of leaves compared."""
    import torch
    from repro_torch.convert import params_to_numpy
    from repro_torch.launch.train import value_and_grad
    from repro_torch.optim import tree_map
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    frames = batch.get("frames")
    jl = jax.jit(lambda p, t, f: jm.forward(p, t, frames=f))(jp, jb["tokens"], jb.get("frames"))
    with torch.no_grad():
        tl = tm.forward(tp, torch.from_numpy(batch["tokens"]),
                        frames=None if frames is None else torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=rtol, atol=rtol)
    jloss, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))(jp, jb)
    tloss, tg = value_and_grad(tm, tp, batch)
    assert abs(float(tloss) - float(jloss)) <= 1e-6 * abs(float(jloss)), (tloss, jloss)
    it = iter(tg)
    got = params_to_numpy(tree_map(lambda _: next(it), tp))
    leaves = list(walk(to_numpy_tree(jg), got))
    top = max(np.abs(a).max() for _, a, _ in leaves)
    for path, a, b in leaves:
        assert np.isfinite(b).all(), path
        if path in zero_leaves:
            assert max(np.abs(a).max(), np.abs(b).max()) <= rtol * 1e-2 * top, path
            continue
        np.testing.assert_allclose(b, a, rtol=0, atol=rtol * np.abs(a).max(), err_msg=path)
    assert set(zero_leaves) <= {p for p, _, _ in leaves}
    return len(leaves)


# the (moment format, microbatch count) combinations of the three-step runs
STEP_CASES = [("none", 0), ("none", 2), ("posit8", 0), ("posit8", 2)]
STEP_IDS = [f"{q}-mb{m}" for q, m in STEP_CASES]


def step_kw(quant, micro, **extra):
    """The RunConfig fields of the three-step runs."""
    return dict(learning_rate=1e-3, total_steps=10, warmup_steps=1, remat="block",
                microbatch=micro, opt_state_quant=quant, **extra)


def step_batches(cfg, steps, B, S, frames=False):
    """The reference's synthetic batches of the three-step runs (plus
    seeded frames for encdec)."""
    from repro.data import DataConfig, synthetic_batch
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    out = []
    for s in range(steps):
        b = synthetic_batch(dc, s)
        if frames:
            b["frames"] = np.random.RandomState(s).standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


@functools.lru_cache(maxsize=None)
def reference_state(arch, quant, over=()):
    """The reference's seed-0 train state of the smoke ``arch`` (``over``
    as ``train_models`` takes it) with ``quant`` moments (jitted
    ``make_train_state``; the microbatch count does not enter it),
    computed once a process: JAX arrays are immutable and the steps below
    do not donate them."""
    from repro.launch.train import make_train_state as j_make_state
    jm, _ = train_models(arch, over, **step_kw(quant, 0))
    return jax.jit(lambda k: j_make_state(jm, k))(jax.random.PRNGKey(0))


def reference_steps(arch, quant, micro, *, frames=False, steps=3, B=4, S=32):
    """``steps`` steps of the reference's jitted step from its seed-0 state
    on ``step_batches``. Returns {"init": the initial state, "batches",
    "jmet": the metrics, "m1": the first moments after the first step with
    f32 moments (else None), "before", "want": the params before the last
    step and the state after it}, as numpy trees."""
    from repro.launch.train import make_train_step as j_make_step
    jm, _ = train_models(arch, **step_kw(quant, micro))
    jstate = reference_state(arch, quant)
    out = {"init": to_numpy_tree(jstate), "batches": step_batches(jm.cfg, steps, B, S, frames),
           "jmet": [], "m1": None}
    jstep = jax.jit(j_make_step(jm))
    for s, b in enumerate(out["batches"]):
        out["before"] = to_numpy_tree(jstate["params"])
        jstate, jm_ = jstep(jstate, {k: jax.numpy.asarray(v) for k, v in b.items()})
        if s == 0 and quant == "none":
            out["m1"] = to_numpy_tree(jstate["opt"]["m"])
        out["jmet"].append({k: float(v) for k, v in jm_.items()})
    out["want"] = to_numpy_tree(jstate)
    return out


def three_steps(arch, quant, micro, *, frames=False, steps=3, B=4, S=32):
    """``steps`` steps of the port's ``make_train_step`` and of the
    reference's jitted step from the same state (the reference's, carried
    across), on the reference's synthetic batches (plus seeded frames for
    encdec). Returns (metrics of the reference, metrics of the port, the
    reference's first moments after the first step with f32 moments
    (else None), the reference's states before and after the last step
    and the port's, as numpy trees)."""
    from repro_torch.convert import params_to_numpy, train_state_from_numpy
    from repro_torch.launch.train import make_train_step
    ref = reference_steps(arch, quant, micro, frames=frames, steps=steps, B=B, S=S)
    _, tm = train_models(arch, **step_kw(quant, micro))
    tstate = train_state_from_numpy(ref["init"], device="cpu")
    tstep = make_train_step(tm)
    tmet = []
    for b in ref["batches"]:
        tstate, tm_ = tstep(tstate, b)
        tmet.append({k: float(v) for k, v in tm_.items()})
    return (ref["jmet"], tmet, ref["m1"], ref["before"], ref["want"],
            params_to_numpy(tstate))


def assert_steps_match(quant, jmet, tmet, m1, before, want, got, *, zero_leaves=(),
                       noise=None, flips=None, wild=None, first=None):
    """The metrics to the bounds of tests/test_torch_train.py (loss to 1e-6,
    grad norm to 1e-5 and lr to 1e-6 relative; the loss falls over the
    steps where the reference's does), and the parameters to its bounds:
    with f32 moments every entry within 3e-5 of the reference's (3 % of one
    step's update at lr 1e-3); with posit8 moments at most 0.1 % of a
    leaf's entries past 3e-5 and none past 5e-3. Three exceptions, each
    asserted for what it is:

    * ``zero_leaves``: the leaf's gradient is zero in exact arithmetic,
      rounding noise in both (see ``check_logits_and_grads``); held to
      5e-3 alone.
    * ``noise`` {leaf: bound}, f32 moments: an entry whose first step's
      gradient is zero in exact arithmetic (the reference's first moment
      ``m1`` after it, (1 - b1) g, below 1e-6 of the leaf's largest) takes
      Adam's first step g / (|g| + 1e-8) from each framework's rounding
      noise, which moves it by up to lr either way.
      Only the named leaves may hold entries past 3e-5, only such entries,
      and none past the leaf's bound (its reading, rounded up).
    * posit8: an entry whose v codes to 0 while its m does not takes a
      step of m / sqrt(v) >> 1 from a new gradient near zero, in the
      reference as in the port. An entry past 5e-3 must be one that the
      reference moved by more than 10 lr in the last step, and the port's
      entry must lie within that move of the reference's.

    Two more, posit8 moments only, for a run whose gradients are summed in
    another order than the reference's (a training grid), each named per
    leaf with its bound (its reading, rounded up):

    * ``flips`` {leaf: n}: a moment code one rounding boundary apart from
      the reference's moves its entry by a step 6 to 12 % apart; in a leaf
      of a few hundred entries one such entry is past 0.1 %. The leaf may
      hold up to n entries past 3e-5 beyond 0.1 % of its entries.
    * ``wild`` {leaf: bound}: an entry of the leaf took the wild step above
      before the last step, from a gradient near zero whose rounding it
      amplifies; the losses after the first step may part by up to the
      bound (relative), and an entry past 5e-3 may be one that the
      reference moved by more than 10 lr since ``first`` (the parameters
      before the first step), the port's entry within that move."""
    noise, flips, wild = noise or {}, flips or {}, wild or {}
    loss_rtol = max([1e-6, *wild.values()])
    for s, (j, t) in enumerate(zip(jmet, tmet)):
        assert abs(t["loss"] - j["loss"]) <= (loss_rtol if s else 1e-6) * abs(j["loss"]), (s, t, j)
        assert abs(t["grad_norm"] - j["grad_norm"]) <= 1e-5 * abs(j["grad_norm"]), (t, j)
        assert abs(t["lr"] - j["lr"]) <= 1e-6 * abs(j["lr"]), (t, j)
    assert (tmet[-1]["loss"] < tmet[0]["loss"]) == (jmet[-1]["loss"] < jmet[0]["loss"])
    lr = jmet[-1]["lr"]
    leaves = list(walk(want["params"], got["params"]))
    assert set(zero_leaves) | set(noise) | set(flips) | set(wild) <= {p for p, _, _ in leaves}
    assert quant == "posit8" or not (flips or wild)
    g0 = {p: g for p, g, _ in walk(m1, m1)} if quant == "none" else {}
    start = {p: a for p, a, _ in walk(first, first)} if wild else {}
    for (path, a, b), (_, _, a0) in zip(leaves, walk(want["params"], before)):
        d = np.abs(a - b)
        if path in zero_leaves:
            assert d.max() <= 5e-3, (path, d.max())
            continue
        if quant == "none":
            off = d > 3e-5
            if off.any():
                g = np.abs(g0[path])
                assert path in noise, (path, d.max())
                assert (g[off] <= 1e-6 * g.max()).all(), (path, g[off] / g.max())
                assert d.max() <= noise[path], (path, d.max())
            continue
        assert (d > 3e-5).sum() <= 1e-3 * d.size + flips.get(path, 0), (path, (d > 3e-5).sum())
        far = d > 5e-3
        move = np.abs(a - (start[path] if path in wild else a0))[far]
        assert (move > 10 * lr).all() and (d[far] <= move).all(), (path, d.max())
    if quant == "posit8":
        # one scale per reference leaf (params_to_numpy refuses layers of a
        # stacked moment leaf whose scales differ): a power of two, the one
        # nearest the reference's (whose CPU exp2 misses powers of two by
        # a few ulps, ROADMAP Queue C)
        for name in ("m", "v"):
            for path, a, b in walk(want["opt"][name], got["opt"][name]):
                if path.endswith("/scale") and path.rsplit("/", 1)[0] not in zero_leaves:
                    assert (np.exp2(np.round(np.log2(a))) == b).all(), (path, a, b)


def check_remat_equal(arch, frames=False):
    """``remat="block"`` and ``"none"`` give the same loss and gradients,
    bit for bit (the recomputation runs the same operations)."""
    import torch
    from repro_torch.launch.train import value_and_grad
    _, on = train_models(arch, remat="block")
    _, off = train_models(arch, remat="none")
    params = on.init(0)
    batch = train_batch(on.cfg, 2, 16, seed=0, frames=frames)
    l1, g1 = value_and_grad(on, params, batch)
    l2, g2 = value_and_grad(off, params, batch)
    assert torch.equal(l1, l2)
    assert len(g1) == len(g2) and all(torch.equal(a, b) for a, b in zip(g1, g2))


def checkpoint_round_trip(arch, tmp_path, frames=False):
    """One reference train step (posit8 moments), then the state saved by
    the reference and, carried across, by the port: every file but the
    reference's ``treedef.pkl`` equal byte for byte; the reference's
    checkpoint restored into the port's own fresh state (its structure
    from ``make_train_state``) equals the reference's state."""
    import filecmp
    import os
    from repro.launch.train import make_train_state as j_make_state
    from repro.launch.train import make_train_step as j_make_step
    from repro.runtime import CheckpointManager as JManager
    from repro_torch.convert import params_to_numpy, train_state_from_numpy
    from repro_torch.launch.train import make_train_state
    from repro_torch.runtime import CheckpointManager
    kw = dict(opt_state_quant="posit8", learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jm, tm = train_models(arch, **kw)
    jstate = jax.jit(lambda k: j_make_state(jm, k))(jax.random.PRNGKey(0))
    batch = train_batch(jm.cfg, 2, 16, seed=3, frames=frames)
    jstate, _ = jax.jit(j_make_step(jm))(jstate, {k: jax.numpy.asarray(v)
                                                  for k, v in batch.items()})
    tstate = train_state_from_numpy(to_numpy_tree(jstate), device="cpu")
    JManager(str(tmp_path / "j"), async_save=False).save(1, jstate)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(1, tstate)
    a, b = tmp_path / "j" / "step_00000001", tmp_path / "t" / "step_00000001"
    files = sorted(f for f in os.listdir(a) if f != "treedef.pkl")
    assert files == sorted(os.listdir(b)) and len(files) > 2
    for f in files:
        assert filecmp.cmp(a / f, b / f, shallow=False), f
    got = CheckpointManager(str(tmp_path / "j")).restore(make_train_state(tm, 1))
    want = to_numpy_tree(jstate)
    for (path, x, y) in walk(want, params_to_numpy(got)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), path
    return len(files)


def cli_trains(arch, capsys):
    """The training CLI on the CPU at the smoke size: two steps with
    posit8 moments, finite losses and grad norms, its lines."""
    import math
    from repro_torch.launch import train as train_cli
    run = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--opt-quant", "posit8",
                          "--log-every", "1"])
    out = capsys.readouterr().out
    assert run["steps"] == [0, 1] and run["arch"] == arch
    assert all(map(math.isfinite, run["loss"] + run["grad_norm"]))
    assert "step     1 loss" in out and "train: {" in out
