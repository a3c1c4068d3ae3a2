"""Tensor-parallel serving in the port (DESIGN.md §9), on the CPU over gloo.

The port at tp = N must serve the token streams of the port at tp = 1 on
the same weights, request by request, at ``activation_dtype="f32"``:
greedy dense (kernels' plain versions on and off), tp = 4 on an MHA
variant, moe and hybrid; sampled hybrid; evict -> resume under an fxp8 KV
cache against the uninterrupted tp = 1 run; and the paged engine at tp = 2
against the dense tp = 1 engine. Greedy dense, moe and hybrid also equal
the reference's tp = 1 engine (the reference's own tp > 1 tests need fake
XLA devices, which this suite does not use). Every rank's streams must
equal rank 0's.

The ranks are one module-scoped ``launch.mesh.RankPool`` of 4 spawned
processes (a subgroup of the first 2 serves the tp = 2 cases), each pinned
to one thread; the rank-side function below imports no JAX, so the
processes start fast. The pure functions (``validate_scale_sharding``,
``attn_tp_mode``, the rank shards of every family's parameters, the
indivisible-tp error, the kernels' plans at the full-size shard shapes)
run in this process.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, RunConfig, smoke
from repro_torch.convert import rank_params_from_numpy
from repro_torch.core.policy import QuantPolicy, parse_spec
from repro_torch.core.quantizers import QuantizedTensor
from repro_torch.launch.engine import Request, SamplingParams, ServeEngine
from repro_torch.nn.models import build_model
from repro_torch.nn.sharding import TPContext, _strict_spec, map_with_logical

# (arch, cfg overrides): every stock dense smoke is GQA with 2 kv groups, so
# tp = 4 takes the MHA variant, as the reference's suite does
ARCH_CASES = {
    "dense": ("yi-9b", None),
    "dense-mha": ("yi-9b", {"n_kv_heads": 4, "n_heads": 4}),
    "moe": ("moonshot-v1-16b-a3b", None),
    "hybrid": ("zamba2-1.2b", None),
}


def _cfg(name):
    arch, over = ARCH_CASES[name]
    cfg = smoke(ARCHS[arch])
    return dataclasses.replace(cfg, **over) if over else cfg


def _requests(vocab, n=3, max_new=5, temp=0.0, top_k=0):
    """The reference suite's workload: seeded 8-token prompts, one arrival
    a decode step."""
    return [Request(rid=i, prompt=np.random.RandomState(i).randint(0, vocab, 8),
                    max_new=max_new, arrival=float(i),
                    sampling=SamplingParams(temperature=temp, top_k=top_k))
            for i in range(n)]


def _drive_evict(eng, reqs):
    """Serve with the first running request evicted after one chunk."""
    for r in reqs:
        eng.submit(r)
    eng.admit_ready()
    eng.step()
    eng.evict(eng.active_rids[0])
    while eng.pending_rids or eng.active_rids:
        eng.admit_ready()
        eng.step()
    assert sum(st.n_evictions for st in eng._states.values()) == 1
    return {rid: st.out for rid, st in eng._states.items()}


def serve_case(ctx, device, case):
    """One case on one rank (or in this process at tp = 1): the rank's
    model, its shard of the weights (the reference's, carried across, or
    the port's own init under tp), the engine, the streams {rid: tokens}."""
    cfg = _cfg(case["name"])
    kv = parse_spec(case["kv"]) if case.get("kv") else None
    model = build_model(cfg, RunConfig(remat="none", activation_dtype="f32"),
                        device=device, use_kernel=case.get("use_kernel", False),
                        kv_spec=kv, tp=ctx)
    if case.get("tree") is not None:
        params = rank_params_from_numpy(case["tree"], model)
    else:
        params = model.init(0, policy=case.get("quant"))
    eng = ServeEngine(model, params, n_slots=2, max_len=32, chunk=3, seed=0,
                      **case.get("engine", {}))
    reqs = _requests(cfg.vocab_size, **case.get("reqs", {}))
    if case.get("evict"):
        streams = _drive_evict(eng, reqs)
    else:
        streams = {s.req.rid: s.out for s in eng.run(reqs)}
    kv_cache = eng.cache["kv" if "kv" in eng.cache else "shared_kv"]
    return {"streams": streams, "kv_heads": int(kv_cache["k"].shape[-3])}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread in this process too: the smoke-size tensors gain
    nothing from more, and idle pool threads only take CPU from the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pool():
    from repro_torch.launch.mesh import RankPool
    with RankPool(4, "cpu", threads=1, sizes=(2,), timeout_s=120) as p:
        yield p
    assert not any(proc.is_alive() for proc in p._procs)


def _tp1(case):
    """The port at tp = 1 in this process."""
    return serve_case(TPContext(), "cpu", case)


def _tpn(pool, case, tp):
    """The case on ranks 0..tp-1: every rank's streams equal rank 0's, and
    each rank allocates its share of the kv heads."""
    res = pool.run(serve_case, case, size=tp)
    for r, got in enumerate(res[1:], 1):
        assert got["streams"] == res[0]["streams"], f"rank {r} parts from rank 0"
    G = _cfg(case["name"]).n_kv_heads
    assert [got["kv_heads"] for got in res] == [G // tp] * tp
    return res[0]


def _assert_same(got, want, label):
    from differential import assert_token_identical
    assert_token_identical(got, want, label=label, oracle_label="tp=1")


def _reference_model(name, policy):
    """The reference's f32 model and seed-0 weights (quantized by
    ``policy``) for an ARCH_CASES entry."""
    from torch_bridge import pair
    arch, over = ARCH_CASES[name]
    fn = (lambda c: dataclasses.replace(c, **over)) if over else None
    return pair(policy, arch=arch, cfg_fn=fn)[:2]


def _reference_streams(name, policy, evict=False):
    """The reference's tp = 1 engine's streams on the workload: greedy, or
    (``evict``) the evict case's sampled one with the fxp8 KV cache."""
    from repro.core.quantizers import QuantSpec as JSpec
    from repro.launch.engine import Request as JRequest, SamplingParams as JSampling
    from repro.launch.engine import ServeEngine as JEngine
    from torch_bridge import pair
    arch, over = ARCH_CASES[name]
    fn = (lambda c: dataclasses.replace(c, **over)) if over else None
    kv = JSpec(kind="fxp", M=8, F=7) if evict else None
    jm, jp = pair(policy, arch=arch, cfg_fn=fn, kv=kv)[:2]
    eng = JEngine(jm, jp, n_slots=2, max_len=32, chunk=3, seed=0)
    kw = {"max_new": 7, "temp": 0.7, "top_k": 8} if evict else {}
    reqs = [JRequest(rid=r.rid, prompt=r.prompt, max_new=r.max_new, arrival=r.arrival,
                     sampling=JSampling(r.sampling.temperature, r.sampling.top_k))
            for r in _requests(jm.cfg.vocab_size, **kw)]
    if evict:
        return _drive_evict(eng, reqs)
    return {s.req.rid: s.out for s in eng.run(reqs)}


# ---------------------------------------------------------------------------
# Token identity: the reference suite's matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,tp,use_kernel,vs_reference", [
    ("dense", 2, False, True),
    ("dense", 2, True, False),
    ("dense-mha", 4, True, False),
    ("moe", 2, False, True),
    ("hybrid", 2, False, True),
])
def test_tp_greedy_token_identical(pool, name, tp, use_kernel, vs_reference):
    """Greedy streams at tp = N equal tp = 1's on the reference's weights
    (pofx8 with the kernels' plain versions on); kernels off, they equal
    the reference's tp = 1 engine too."""
    from torch_bridge import to_numpy_tree
    policy = "pofx8" if use_kernel else None
    case = {"name": name, "tree": to_numpy_tree(_reference_model(name, policy)[1]),
            "use_kernel": use_kernel}
    one = _tp1(case)
    got = _tpn(pool, case, tp)
    _assert_same(got["streams"], one["streams"], f"tp={tp}")
    if vs_reference:
        _assert_same(one["streams"], _reference_streams(name, policy),
                     "port tp=1 vs reference tp=1")


def test_tp_sampled_streams_identical(pool):
    """Per-slot temperature / top-k streams survive TP: the sampler runs on
    the all-reduced logits, alike on every rank (the port's own init,
    cut to each rank's shard as it is drawn)."""
    case = {"name": "hybrid", "quant": "pofx8",
            "reqs": {"max_new": 6, "temp": 0.7, "top_k": 8}}
    _assert_same(_tpn(pool, case, 4)["streams"], _tp1(case)["streams"], "tp=4 sampled")


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_kv_quant_evict_resume_bit_identity(pool, tp):
    """With fxp8 KV codes and static scales split along the head axis, an
    evicted sampled request re-prefills to the same code shards (the
    reference's weights and cases: moe at tp = 2, the MHA variant at tp =
    4). The MHA variant's resumed stream matches the uninterrupted tp = 1
    run. The moe one cannot, in the reference either: the re-prefill (S > 1)
    routes under the capacity factor and drops assignments that decode
    (drop-free) keeps, so its evicted stream is held against the tp = 1
    evicted run, the port's and the reference's engine's."""
    from torch_bridge import to_numpy_tree
    name = "moe" if tp == 2 else "dense-mha"
    case = {"name": name, "tree": to_numpy_tree(_reference_model(name, None)[1]),
            "kv": "fxp8", "reqs": {"max_new": 7, "temp": 0.7, "top_k": 8}}
    got = _tpn(pool, dict(case, evict=True), tp)
    if name == "moe":
        want = _tp1(dict(case, evict=True))["streams"]
        _assert_same(want, _reference_streams(name, None, evict=True),
                     "port tp=1+evict vs reference tp=1+evict")
    else:
        want = _tp1(case)["streams"]
    _assert_same(got["streams"], want, f"tp={tp}+evict")


def test_paged_tp_token_identical(pool):
    """The paged engine at tp = 2 (4-token pages, pool and scales split
    along heads, block tables replicated) serves the dense tp = 1 engine's
    streams, sampled and greedy."""
    base = {"name": "dense", "quant": "pofx8", "kv": "fxp8", "use_kernel": True,
            "reqs": {"n": 4, "temp": 0.7, "top_k": 8}}
    want = _tp1(base)["streams"]
    got = _tpn(pool, dict(base, engine={"paged": True, "page_size": 4}), 2)
    _assert_same(got["streams"], want, "paged tp=2")


# ---------------------------------------------------------------------------
# Pure functions against the reference's
# ---------------------------------------------------------------------------

SCALE_GRID = [
    ((64, 128), (1, 1), (None, "tp")),
    ((64, 128), (1, 128), (None, "tp")),
    ((64, 128), (128,), (None, "tp")),
    ((64, 128), (64, 1), (None, "tp")),
    ((64, 128), (64, 1), ("tp", None)),
    ((64, 128), (1, 128), ("tp",)),
    ((8, 64, 128), (1, 1, 128), ("tp", None, None)),
    ((8, 64, 128), (8, 1, 1), ("tp", None, None)),
    ((64, 4, 32), (1, 1, 32), (None, "tp", None)),
    ((64, 4, 32), (1, 2, 32), (None, "tp", None)),     # incongruent: raises
    ((64, 128), (1, 64), (None, "tp")),                 # incongruent: raises
    ((64, 128), (1, 1, 128), (None, "tp")),             # scale rank > codes rank
    ((64, 128), (1, 128), ()),
]


@pytest.mark.parametrize("codes,scale,spec", SCALE_GRID)
def test_validate_scale_sharding_matches_reference(codes, scale, spec):
    from jax.sharding import PartitionSpec as P
    from repro.core.policy import validate_scale_sharding as j_validate
    from repro_torch.core.policy import validate_scale_sharding
    try:
        want = tuple(j_validate("blocks/mlp/wg", codes, scale, P(*spec)))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            validate_scale_sharding("blocks/mlp/wg", codes, scale, spec)
        assert str(got.value) == str(e)
        return
    assert validate_scale_sharding("blocks/mlp/wg", codes, scale, spec) == want


def test_attn_tp_mode_matches_reference():
    from repro.nn.attention import attn_tp_mode as j_mode
    from repro_torch.nn.attention import attn_tp_mode
    for H in (1, 4, 8, 32, 40, 128):
        for G in (1, 2, 4, 8, 32):
            if H % G:
                continue
            for tp in (0, 1, 2, 3, 4, 8, 16):
                assert attn_tp_mode(H, G, tp) == j_mode(H, G, tp), (H, G, tp)


SHARD_CASES = [("yi-9b", None, 2), ("yi-9b", {"n_kv_heads": 4, "n_heads": 4}, 4),
               ("moonshot-v1-16b-a3b", None, 2), ("moonshot-v1-16b-a3b", None, 4),
               ("llama4-maverick-400b-a17b", None, 2), ("zamba2-1.2b", None, 2),
               ("zamba2-1.2b", None, 4), ("falcon-mamba-7b", None, 4)]


def _leaves(tree, model):
    """{name: (leaf, logical axes)}; one entry a stacked path (layers alike)."""
    out = {}
    map_with_logical(lambda name, leaf, ax: out.setdefault(name, []).append((leaf, ax)),
                     tree, model.logical())
    return out


def _cat(shards, spec):
    dims = [d for d, a in enumerate(spec) if a is not None]
    assert len(dims) <= 1
    return torch.cat(shards, dims[0]) if dims else shards[0]


@pytest.mark.parametrize("arch,over,tp", SHARD_CASES)
def test_rank_shards_concatenate_to_the_tp1_leaf(arch, over, tp):
    """``LM.init`` under tp draws every full leaf, quantizes it whole and
    keeps the rank's slice: every leaf's rank shards, codes and scales,
    concatenate to the tp = 1 leaf bit for bit (a row-sharded leaf's
    per-column scales included), and a replicated leaf is the tp = 1 leaf
    on every rank."""
    cfg = smoke(ARCHS[arch])
    cfg = dataclasses.replace(cfg, **over) if over else cfg
    rcfg = RunConfig(remat="none")
    policy = QuantPolicy.from_string("pofx8")
    full_model = build_model(cfg, rcfg, device="cpu")
    full = full_model.init(0, policy=policy)
    ranks = []
    for r in range(tp):
        m = build_model(cfg, rcfg, device="cpu", tp=TPContext(rank=r, size=tp))
        ranks.append(_leaves(m.init(0, policy=policy), m))
    n_split = 0
    for name, layers in _leaves(full, full_model).items():
        assert all(len(rk[name]) == len(layers) for rk in ranks), name
        for i, (leaf, ax) in enumerate(layers):
            parts = [rk[name][i][0] for rk in ranks]
            is_q = isinstance(leaf, QuantizedTensor)
            codes = leaf.codes if is_q else leaf
            spec = _strict_spec(TPContext(0, tp), tuple(ax) + (None,) * codes.ndim,
                                tuple(codes.shape), name)
            n_split += any(a is not None for a in spec)
            got = _cat([p.codes if is_q else p for p in parts], spec)
            assert torch.equal(got, codes), name
            if is_q:
                off = codes.ndim - leaf.scale.ndim
                sspec = tuple(a if leaf.scale.shape[d - off] > 1 else None
                              for d, a in enumerate(spec) if d >= off)
                assert torch.equal(_cat([p.scale for p in parts], sspec), leaf.scale), name
    assert n_split > 0 or cfg.family == "ssm"


def _fake_reference_ctx(tp):
    """A reference ShardingCtx whose mesh has tp devices on its "tp" axis
    (its spec logic reads only the mesh's shape)."""
    from repro.nn.sharding import ShardingCtx, _tp_rules
    return ShardingCtx(SimpleNamespace(shape={"tp": tp}), _tp_rules())


@pytest.mark.parametrize("arch,over,tp", [("yi-9b", None, 4), ("moonshot-v1-16b-a3b", None, 8),
                                          ("llama4-maverick-400b-a17b", None, 4),
                                          ("zamba2-1.2b", None, 8), ("yi-9b", None, 3)])
def test_indivisible_tp_raises_the_reference_error(arch, over, tp):
    """A tp that does not divide a sharded dim raises the reference's
    ``shard_policy_params`` error word for word, naming the same leaf."""
    from repro.nn.sharding import shard_policy_params as j_shard
    from torch_bridge import _jax_params
    from repro.configs import ARCHS as J_ARCHS, RunConfig as JRun, smoke as j_smoke
    from repro.nn.models import build_model as j_build
    jm = j_build(j_smoke(J_ARCHS[arch]), JRun(remat="none"))
    with pytest.raises(ValueError) as want:
        j_shard(_jax_params(jm.cfg, None, 0), jm.logical(), _fake_reference_ctx(tp))
    with pytest.raises(ValueError) as got:
        build_model(smoke(ARCHS[arch]), RunConfig(remat="none"), device="cpu",
                    tp=TPContext(rank=0, size=tp))
    assert str(got.value) == str(want.value)
    assert "pick a tp that divides it" in str(got.value)


@pytest.mark.parametrize("arch", ["yi-9b", "moonshot-v1-16b-a3b", "zamba2-1.2b"])
def test_shard_specs_match_reference(arch):
    """The dims each leaf shards along, codes and scales, are the
    reference's ``shard_policy_params`` specs (its stacked layer axes
    aside), for pofx8 weights at tp = 2."""
    from jax.sharding import PartitionSpec as P
    from repro.core.quantizers import QuantizedTensor as JQT
    from repro.nn.sharding import shard_policy_params as j_shard
    from torch_bridge import pair
    import jax
    jm, jp, tm, tparams = pair("pofx8", arch=arch)
    specs = j_shard(jp, jm.logical(), _fake_reference_ctx(2))
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, (JQT, P)))[0]
    want = {}
    for path, s in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)
        want[name] = (tuple(s.codes), tuple(s.scale)) if isinstance(s, JQT) else (tuple(s), None)
    ctx = TPContext(0, 2)
    from repro_torch.core.policy import validate_scale_sharding
    for name, [(leaf, ax), *_] in _leaves(tparams, tm).items():
        shape = tuple(leaf.codes.shape if isinstance(leaf, QuantizedTensor) else leaf.shape)
        spec = _strict_spec(ctx, tuple(ax) + (None,) * len(shape), shape, name)
        w_codes, w_scale = want[name]
        assert w_codes[len(w_codes) - len(spec):] == spec, name
        if isinstance(leaf, QuantizedTensor):
            got = validate_scale_sharding(name, shape, tuple(leaf.scale.shape), spec)
            assert w_scale[len(w_scale) - len(got):] == got, name


# ---------------------------------------------------------------------------
# The kernels' plans at the full-size models' tp = 2 shard shapes
# ---------------------------------------------------------------------------

# (k, n) of every pofx_matmul a tp = 2 rank runs: yi-9b wq, wk/wv, attention
# wo, wg/wu, MLP wo; moonshot wq/wk/wv, wo, shared experts; zamba2 wq/wk/wv,
# wo, wi, MLP wo
TP2_SHAPES = [(4096, 2048), (4096, 256), (2048, 4096), (4096, 5504), (5504, 4096),
              (2048, 1024), (1024, 2048), (2048, 1408), (1408, 2048),
              (2048, 4096), (4096, 2048)]


@pytest.mark.parametrize("k,n", TP2_SHAPES)
def test_pofx_matmul_plan_at_tp2_shard_shapes(k, n):
    """At every shard shape, f32 and bf16, decode and prefill rows: the
    slices cover k exactly, the workspace holds every partial, the f32
    split does not depend on m, and decode fills the card as at tp = 1."""
    from repro_torch.kernels.pofx_matmul import (BK, BN, F32_PLAN, MAX_SLICES,
                                                 TARGET_BLOCKS, call_plan, plan)
    for bf16 in (False, True):
        for m in (1, 4, 17, 64):
            p = call_plan(m, k, n, bf16)
            assert p.slice_len % BK == 0 and 1 <= p.slices <= MAX_SLICES
            assert (p.slices - 1) * p.slice_len < k <= p.slices * p.slice_len
            last = ((p.slices - 1) * m + m - 1) * n + n - 1
            assert p.workspace(m, n) == (last + 1 if p.slices > 1 else 0)
            if not bf16:
                assert p == plan(k, n, **F32_PLAN)
    p = call_plan(4, k, n, True)
    n_blocks, tiles = -(-n // BN), -(-k // BK)
    blocks = n_blocks * p.slices
    assert blocks <= max(TARGET_BLOCKS, n_blocks)
    assert blocks >= min(TARGET_BLOCKS - 8, n_blocks * min(MAX_SLICES, tiles // 2))


@pytest.mark.parametrize("G,S", [(2, 96), (8, 96), (16, 96), (2, 4096), (16, 4096)])
def test_flash_decode_plan_at_tp2_shard_heads(G, S):
    """The split-S plan at a rank's kv heads (yi-9b G = 2, moonshot 8,
    zamba2 16) at 4 slots: tile chunks that cover S, blocks near two a SM."""
    from repro_torch.kernels.kv_flash_decode import SMS, TILE, plan
    p = plan(4, G, S)
    assert p.chunk % TILE == 0 and (p.splits - 1) * p.chunk < S <= p.splits * p.chunk
    assert 4 * G * p.splits <= max(4 * SMS, 2 * 4 * G)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_serve_cli_tp2_on_the_cpu(capfd):
    """``--tp 2 --device cpu --smoke``: two gloo ranks; rank 0 prints the
    header with tp=2 and the backend, and the run equals tp = 1's."""
    from repro_torch.launch import serve
    argv = ["--smoke", "--device", "cpu", "--use-kernel", "--kv-quant", "fxp8",
            "--batch", "2", "--requests", "3", "--prompt-len", "5", "--gen", "3"]
    run = serve.main(argv + ["--tp", "2"])
    out = capfd.readouterr().out
    assert "tp=2 backend=gloo]" in out and "decode:" in out
    assert run.tp == 2 and run.engine is None and len(run.rank_launches) == 2
    one = serve.main(argv)
    assert [s.out for s in run.done] == [s.out for s in one.done]
    assert run.stats["generated_tokens"] == one.stats["generated_tokens"] == 9


@pytest.mark.parametrize("extra", [["--legacy"], ["--arch", "whisper-medium"]])
def test_serve_cli_tp_refuses_the_legacy_path(extra, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--smoke", "--device", "cpu", "--tp", "2"] + extra)
    assert e.value.code == 2
    assert "--tp needs the engine path (not --legacy / encdec)" in capsys.readouterr().err


def test_make_tp_mesh_refuses_tp_below_one():
    from repro_torch.launch.mesh import make_tp_mesh
    with pytest.raises(ValueError, match="tp must be >= 1, got 0"):
        make_tp_mesh(0)
    assert make_tp_mesh(1) == TPContext()


def disagree(ctx, device):
    """Each rank reports its own rank: every rank but 0 parts from rank 0."""
    ctx.check_equal("the rank", ctx.rank)


def test_a_diverging_rank_raises_instead_of_hanging(pool):
    with pytest.raises(RuntimeError, match=r"ranks \[1\] diverged from rank 0 in the rank"):
        pool.run(disagree, size=2)
    # the pool still serves after the failed check (every rank raised alike)
    assert pool.run(_rank_of, size=2) == [0, 1]


def _rank_of(ctx, device):
    return ctx.rank
