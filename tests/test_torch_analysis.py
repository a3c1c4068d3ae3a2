"""The port's behavioral-analysis framework (Fig. 8) against the reference.

Level (a) and (b) errors for every spec of the paper's grid, the
three-level sweep, the report's table, the Pareto-derived policy,
``quantize_params``, and ``launch.analyze.run_analysis`` at the smoke size
on the reference's initial weights against the reference's functions
composed in ``examples/behavioral_analysis.py``'s order. Error statistics
are f32 means whose summation order differs between the frameworks
(rtol 1e-5); counts of bits and maxima are exact.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.core import analysis as ja
from repro.core import policy as jpol
from repro.core.quantizers import QuantSpec as JSpec, fxp_view as j_fxp_view, \
    quantize as j_quantize
from repro.data import DataConfig as JDataConfig, synthetic_batch as j_synthetic_batch
from repro.kernels.ops import quant_matmul as j_quant_matmul
from repro.nn.models import apply_policy as j_apply_policy, build_model as j_build_model, \
    ce_loss as j_ce_loss, quantize_params as j_quantize_params
from repro_torch.configs import ARCHS as T_ARCHS, RunConfig as TRunConfig, smoke as t_smoke
from repro_torch.convert import params_from_numpy
from repro_torch.core import analysis as ta
from repro_torch.core import policy as tpol
from repro_torch.core import prng
from repro_torch.core.policy import QuantPolicy, named_leaves
from repro_torch.core.quantizers import QuantizedTensor, dequantize, fxp_view, quantize
from repro_torch.data import DataConfig
from repro_torch.kernels.ops import KERNELS, quant_matmul
from repro_torch.launch import analyze
from repro_torch.nn.models import apply_policy, build_model, quantize_params
from torch_bridge import _jax_params, to_numpy_tree, tspec
from torch_bridge import jax_compile_cache, torch_one_thread  # noqa: F401 (autouse)

RTOL = 1e-5          # f32 error means, summed in another order
NLL_RTOL = 1e-4      # f32 eval NLL of a 2-layer model in two frameworks
GRID = ja.default_spec_grid(include_paths=True)


def _id(s):
    return ja.spec_name(s).replace(",", "-")


def _tensors():
    """Seeded weights of the smoke model's level-(a) shapes (wq, wg and
    the unembed: the reference's eager ops compile once a shape) at the
    reference test's scales, and a level-(b) input."""
    rng = np.random.default_rng(0)
    ws = [(rng.standard_normal((128, 128)) * 0.08).astype(np.float32),
          (rng.standard_normal((128, 256)) * 0.2).astype(np.float32),
          (rng.standard_normal((128, 512)) * 0.05).astype(np.float32)]
    return ws, rng.standard_normal((64, 128)).astype(np.float32)


def _matmul64(w, x):
    """``x @ w`` in float64, rounded to f32: one numpy product for both
    frameworks, so each output is the same f32 in both and only the
    statistics' f32 means are summed in another order."""
    y = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
    if isinstance(w, torch.Tensor):
        return torch.from_numpy(y.astype(np.float32))
    return jnp.asarray(y.astype(np.float32))


def _rows(w, x):
    """An elementwise layer: each output is one rounded product, the same
    bits in both frameworks."""
    return w * x[0][:, None]


def _close(got: dict, want: dict, exact=("bits", "max_abs"), rtol=RTOL):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in exact:
            assert got[k] == v, (k, got[k], v)
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=0, err_msg=k)


def test_spec_grid_and_names():
    for paths in (True, False):
        j, t = ja.default_spec_grid(paths), ta.default_spec_grid(paths)
        assert [dataclasses.asdict(s) for s in t] == [dataclasses.asdict(s) for s in j]
        assert [ta.spec_name(s) for s in t] == [ja.spec_name(s) for s in j]
    for s in ("fp32", "bf16"):
        assert ta.spec_name(tspec(JSpec(kind=s))) == ja.spec_name(JSpec(kind=s))


@pytest.mark.parametrize("spec", GRID, ids=_id)
def test_weight_and_activation_error(spec):
    ws, x = _tensors()
    t = tspec(spec)
    for w in ws:
        _close(ta.weight_error(torch.from_numpy(w), t, axis=-1),
               ja.weight_error(jnp.asarray(w), spec, axis=-1))
    # numpy in, the default axis
    _close(ta.weight_error(ws[0], t), ja.weight_error(ws[0], spec))
    tw, jw = torch.from_numpy(ws[1]), jnp.asarray(ws[1])
    _close(ta.activation_error(_rows, tw, t, torch.from_numpy(x)),
           ja.activation_error(_rows, jw, spec, jnp.asarray(x)), exact=("max_abs",))
    for w in ws[:2]:
        _close(ta.activation_error(_matmul64, torch.from_numpy(w), t, torch.from_numpy(x)),
               ja.activation_error(_matmul64, jnp.asarray(w), spec, jnp.asarray(x)),
               exact=("max_abs",))


def test_sweep_configs_matches():
    ws, x = _tensors()
    names = ("fc1", "fc2", "w3")
    jw = {k: jnp.asarray(w) for k, w in zip(names, ws)}
    tw = {k: torch.from_numpy(w) for k, w in zip(names, ws)}
    jl = {k: (_rows, jnp.asarray(x)) for k in ("fc1", "fc2", "absent")}
    tl = {k: (_rows, torch.from_numpy(x)) for k in ("fc1", "fc2", "absent")}

    def metric(spec):
        return -spec.stored_bits / 3 + spec.ES / 7

    kw = dict(prune_weight_err=0.12, prune_act_err=0.06)
    want = ja.sweep_configs(jw, GRID, layer_apply=jl, end_to_end=metric, **kw)
    got = ta.sweep_configs(tw, [tspec(s) for s in GRID], layer_apply=tl, end_to_end=metric,
                           **kw)
    assert want.pruned_at_a and want.pruned_at_b and want.survivors
    assert got.pruned_at_a == want.pruned_at_a
    assert got.pruned_at_b == want.pruned_at_b
    assert got.survivors == want.survivors
    assert list(got.per_config) == list(want.per_config)
    for name, rec in want.per_config.items():
        _close(got.per_config[name], rec, exact=("bits_per_weight", "weight_max_abs", "pruned",
                                                 "metric"))
    # no level (b) or (c): every config that passes (a) survives (the
    # reference's level (a) is the same as above)
    got = ta.sweep_configs(tw, [tspec(s) for s in GRID], prune_weight_err=0.12)
    assert (got.pruned_at_a, got.pruned_at_b) == (want.pruned_at_a, [])
    assert got.survivors == [ja.spec_name(s) for s in GRID
                             if ja.spec_name(s) not in want.pruned_at_a]
    assert all("act_avg_rel" not in r and "metric" not in r for r in got.per_config.values())


def test_report_table_is_the_reference_format():
    per_config = {"posit(8,2)": {"weight_avg_rel": 0.0274123, "act_avg_rel": 0.146,
                                 "metric": -6.07571, "bits_per_weight": 8.25},
                  "fxp7": {"weight_avg_rel": 0.5, "bits_per_weight": 7.25, "pruned": "level_a"},
                  "pofx(7,2,direct)": {"weight_avg_rel": 0.05862, "act_avg_rel": 0.31,
                                       "bits_per_weight": 7.25, "pruned": "level_b"},
                  "bf16": {}}
    args = (per_config, ["fxp7"], ["pofx(7,2,direct)"], ["posit(8,2)"])
    assert ta.BehavioralReport(*args).table() == ja.BehavioralReport(*args).table()


@pytest.mark.parametrize("max_avg_rel", [0.0, 0.03, 0.05, 1.0])
def test_policy_from_pareto_matches(max_avg_rel):
    """The default candidates at four error budgets (none met, some, the
    example's, all); at the example's, the pofx configs alone too."""
    ws, _ = _tensors()
    jg = {"attn/*": [jnp.asarray(ws[0]), jnp.asarray(ws[1])], "mlp/*": [jnp.asarray(ws[2])]}
    tg = {"attn/*": [torch.from_numpy(ws[0]), torch.from_numpy(ws[1])],
          "mlp/*": [torch.from_numpy(ws[2])]}
    kw = dict(max_avg_rel=max_avg_rel, fallback="pofx8es2")
    want = jpol.policy_from_pareto(jg, **kw)
    got = tpol.policy_from_pareto(tg, **kw)
    assert got.to_string() == want.to_string()
    if max_avg_rel != 0.05:
        return
    cands = [s for s in GRID if s.kind == "pofx"]
    want = jpol.policy_from_pareto(jg, cands, **kw)
    got = tpol.policy_from_pareto(tg, [tspec(s) for s in cands], **kw)
    assert got.to_string() == want.to_string()


def _same_tree(a, b):
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), name
        if isinstance(x, QuantizedTensor):
            assert x.spec == y.spec, name
            assert torch.equal(x.codes, y.codes) and torch.equal(x.scale, y.scale), name
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("spec,quant_embed", [("pofx8es2", True), ("fxp8", False),
                                               ("bf16", False)])
def test_quantize_params_is_a_uniform_policy(spec, quant_embed):
    jp = _jax_params(j_smoke(J_ARCHS["yi-9b"]), None, 0)
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    s = tpol.parse_spec(spec)
    got = quantize_params(tp, s, quant_embed=quant_embed)
    policy = QuantPolicy.uniform(s) if quant_embed else \
        QuantPolicy.from_string(f"*embed*=keep,*={spec}")
    _same_tree(got, apply_policy(tp, policy))
    ref = jax.jit(lambda p: j_quantize_params(p, jpol.parse_spec(spec),
                                              quant_embed=quant_embed))(jp)
    _same_tree(got, params_from_numpy(to_numpy_tree(ref), device="cpu"))


def test_fxp16_codes_wrap_under_kernels_like_the_reference():
    """fxp_view casts fxp16's codes to int8 for the int8 MAC path, in the
    reference and in the port alike: with kernels the product is the
    wrapped codes', not the fxp16 network's."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    jspec = JSpec(kind="fxp", M=16, F=15)
    jqt = j_quantize(jnp.asarray(w), jspec, axis=-1)
    tqt = quantize(torch.from_numpy(w), tspec(jspec), axis=-1)
    np.testing.assert_array_equal(tqt.codes.numpy(), np.asarray(jqt.codes))
    jc, jr = j_fxp_view(jqt)
    tc, tr = fxp_view(tqt)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert not np.array_equal(tc.numpy().astype(np.int32), tqt.codes.numpy())     # wrapped
    want = np.asarray(j_quant_matmul(jnp.asarray(x), jqt, use_kernel=True))
    got = quant_matmul(torch.from_numpy(x), tqt, kernels=KERNELS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    true = quant_matmul(torch.from_numpy(x), tqt).numpy()
    np.testing.assert_allclose(true, np.asarray(j_quant_matmul(jnp.asarray(x), jqt)),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(got - true).max() > 0.1 * np.abs(true).max()


# -- run_analysis against the example's composition ---------------------------

# a cut of the grid (each level-(c) config costs the reference a compile):
# configs pruned at (a) and at (b), and a survivor of every kind, at the
# smoke size's initial weights
ANALYSIS_SPECS = [JSpec(kind="fxp", M=8, F=7), JSpec(kind="posit", N=5, ES=0),
                  JSpec(kind="posit", N=6, ES=1), JSpec(kind="posit", N=8, ES=1),
                  JSpec(kind="pofx", N=7, ES=2, path="via_fxp"),
                  JSpec(kind="pofx", N=8, ES=2, path="direct")]
RUN = dict(learning_rate=1e-3, total_steps=60, warmup_steps=6, remat="none",
           activation_dtype="f32")


def _reference_analysis(jm, jp, dc):
    """The example's steps after training, with the reference's functions;
    the quantization and forward of each level-(c) config and of the
    policy jitted (one compile each; eager, the policy's quantization
    alone takes several times as long)."""
    cfg = jm.cfg
    blocks = jp["blocks"]
    weights = {"wq": jnp.asarray(blocks["attn"]["wq"][0].reshape(cfg.d_model, -1)),
               "wo": jnp.asarray(blocks["attn"]["wo"][0]),
               "wg": jnp.asarray(blocks["mlp"]["wg"][0]),
               "unembed": jnp.asarray(jp["unembed"])}
    x = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.d_model))
    layer_apply = {k: ((lambda w, x: x @ w), x) for k in ("wq", "wg")}
    eval_batch = j_synthetic_batch(dc, 9_999)
    tokens, labels = jnp.asarray(eval_batch["tokens"]), jnp.asarray(eval_batch["labels"])

    def end_to_end(spec):
        nll = jax.jit(lambda p: j_ce_loss(jm.forward(j_quantize_params(p, spec), tokens),
                                          labels))(jp)
        return -float(nll)

    report = ja.sweep_configs(weights, ANALYSIS_SPECS, layer_apply=layer_apply,
                              end_to_end=end_to_end, prune_weight_err=0.25,
                              prune_act_err=0.25)
    best = {}
    for name, rec in report.per_config.items():
        if rec.get("pruned") or "metric" not in rec:
            continue
        b = round(rec["bits_per_weight"])
        if b not in best or rec["metric"] > best[b][1]:
            best[b] = (name, rec["metric"])
    groups = {"attn/*": [weights["wq"], weights["wo"]], "mlp/*": [weights["wg"]],
              "*embed*": [weights["unembed"]]}
    policy = jpol.policy_from_pareto(groups, max_avg_rel=0.05, fallback="pofx8es2")
    qp = jax.jit(lambda p: j_apply_policy(p, policy))(jp)
    nll = float(jax.jit(lambda p: j_ce_loss(jm.forward(p, tokens), labels))(qp))
    return {"report": report, "best": best, "policy": policy.to_string(),
            "storage": jpol.storage_report(qp, policy), "nll": nll, "x": np.asarray(x)}


@pytest.fixture(scope="module")
def analyses():
    jc, tc = j_smoke(J_ARCHS["yi-9b"]), t_smoke(T_ARCHS["yi-9b"])
    jm = j_build_model(jc, JRunConfig(**RUN))
    tm = build_model(tc, TRunConfig(**RUN), device="cpu")
    jp = _jax_params(jc, None, 0)
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    want = _reference_analysis(jm, jp, JDataConfig(vocab_size=jc.vocab_size, seq_len=128,
                                                   global_batch=8))
    lines = []
    got = analyze.run_analysis(tm, tp, dc=DataConfig(vocab_size=tc.vocab_size, seq_len=128,
                                                      global_batch=8),
                               specs=[tspec(s) for s in ANALYSIS_SPECS],
                               x=torch.from_numpy(want["x"].copy()), out=lines.append)
    return want, got, lines, tm


def test_run_analysis_report_matches(analyses):
    want, got, _, _ = analyses
    w, g = want["report"], got.report
    assert w.pruned_at_a and w.pruned_at_b and len(w.survivors) >= 3
    assert (g.pruned_at_a, g.pruned_at_b, g.survivors) == \
        (w.pruned_at_a, w.pruned_at_b, w.survivors)
    assert list(g.per_config) == list(w.per_config)
    for name, rec in w.per_config.items():
        grec = g.per_config[name]
        assert set(grec) == set(rec)
        for k, v in rec.items():
            if k in ("pruned", "bits_per_weight", "weight_max_abs"):
                assert grec[k] == v, (name, k)
            else:
                np.testing.assert_allclose(grec[k], v, rtol=NLL_RTOL if k == "metric" else RTOL,
                                           err_msg=f"{name} {k}")
    assert set(got.seconds) >= {"a", "b", "c", "policy", "policy_eval", "analysis"}
    assert all(v >= 0 for v in got.seconds.values()), got.seconds
    assert set(got.launches) == set(w.survivors)          # none on the CPU
    assert not any(got.launches.values())


def test_run_analysis_picks_policy_and_nll_match(analyses):
    want, got, lines, _ = analyses
    assert sorted(got.best) == sorted(want["best"])
    for b, (name, metric) in want["best"].items():
        assert got.best[b][0] == name
        np.testing.assert_allclose(got.best[b][1], metric, rtol=NLL_RTOL)
    assert got.policy.to_string() == want["policy"]
    assert got.storage == want["storage"]
    np.testing.assert_allclose(got.policy_nll, want["nll"], rtol=NLL_RTOL)
    assert f"pareto-derived policy: {want['policy']}" in "\n".join(lines)


def test_level_b_input_is_the_references_draw(analyses):
    want, _, _, tm = analyses
    x = prng.normal(prng.PRNGKey(1), (64, tm.cfg.d_model)).numpy()
    np.testing.assert_allclose(x, want["x"], rtol=1e-6, atol=1e-6)


SECTIONS = ["trained 2 steps; loss=", "pruned at level a (weight err):",
            "pruned at level b (activation err):", "survivors:",
            "config,avg_rel_weight_err,act_err,metric,bits_per_weight,pruned",
            "best config per stored-bit budget:", "pareto-derived policy:", "  TOTAL",
            "eval_nll under pareto policy:"]


def test_cli_prints_the_examples_sections_in_order(capsys):
    run = analyze.main(["--smoke", "--device", "cpu", "--steps", "2"])
    text = capsys.readouterr().out
    at = [text.find(s) for s in SECTIONS]
    assert all(i >= 0 for i in at) and at == sorted(at), list(zip(SECTIONS, at))
    rep = run.report
    assert len(rep.per_config) == len(GRID)
    assert len(rep.pruned_at_a) + len(rep.pruned_at_b) + len(rep.survivors) == len(GRID)
    assert math.isfinite(run.train_loss) and math.isfinite(run.policy_nll)
    assert run.policy.to_string().endswith(",*=pofx8es2")
    assert set(run.seconds) >= {"train", "a", "b", "c", "analysis"}


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        analyze.main(["--steps", "0"])
