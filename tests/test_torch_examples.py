"""The reference's examples on the port (``repro_torch.examples``) against the
reference on the CPU.

* ``quickstart``: each format's stored bits equal the reference's, and its
  matmul's relative error against fp32 within 1e-6 of the reference's
  (``examples/quickstart.py``'s steps, with the reference's functions);
* ``train_lm`` at the smoke size (2 x 32 tokens a step), resuming from
  the reference's seed-0 state of the example's configuration, saved by
  the reference's own ``CheckpointManager`` as step 0: the port's trained
  parameters under each of the example's policies give the reference's
  ``apply_policy`` codes bit for bit and, at f32 activations, perplexities
  within 1e-5 relative of the reference's ``forward`` + ``ce_loss`` on the
  same eval batches; the ``paper-table6`` checkpoint's policy and storage
  report are the reference's; a second run on the same directory resumes
  from the last checkpoint, trains no step and holds the same parameters;
* ``serve_quantized --device cpu`` serves its staggered requests.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import ARCHS as J_ARCHS, RunConfig as JRunConfig, smoke as j_smoke
from repro.core.policy import QuantPolicy as JPolicy, parse_spec as j_parse_spec, \
    storage_report as j_storage_report
from repro.core.quantizers import quantize as j_quantize, storage_bits as j_storage_bits
from repro.kernels.ops import quant_matmul as j_quant_matmul
from repro.launch.train import make_train_state as j_make_train_state
from repro.nn.models import apply_policy as j_apply_policy, build_model as j_build_model, \
    ce_loss as j_ce_loss
from repro.runtime import CheckpointManager as JManager
from repro_torch.configs import RunConfig
from repro_torch.convert import params_to_numpy
from repro_torch.data import DataConfig
from repro_torch.examples import quickstart, serve_quantized, train_lm
from repro_torch.nn.models import apply_policy, build_model
from torch_bridge import jax_compile_cache, torch_one_thread, walk  # noqa: F401 (autouse)

STEPS = 3
BATCH, SEQ = 2, 32
PPL_RTOL = 1e-5


def test_quickstart_matches_the_reference(capsys):
    rows = quickstart.main(["--device", "cpu"])
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(0, 0.05, (512, 256)), jnp.float32)
    x = jnp.asarray(rng.normal(0, 1.0, (8, 512)), jnp.float32)
    y_ref = x @ w
    assert list(rows) == ["fxp8", "posit8es2", "pofx8es2", "pofx6es2"]
    for name, row in rows.items():
        qt = j_quantize(w, j_parse_spec(name), axis=-1)
        y = j_quant_matmul(x, qt, out_dtype=jnp.float32)
        rel = float(jnp.linalg.norm(y - y_ref) / jnp.linalg.norm(y_ref))
        assert row["storage_bits"] == j_storage_bits(qt), name
        assert row["bits_per_weight"] == j_storage_bits(qt) / w.size, name
        assert abs(row["rel_err"] - rel) <= 1e-6, (name, row["rel_err"], rel)
    text = capsys.readouterr().out
    assert text.splitlines()[0].split() == ["format", "bits/w", "storage", "matmul", "rel",
                                            "err"]


def _argv(ckpt):
    return ["--device", "cpu", "--steps", str(STEPS), "--batch", str(BATCH), "--seq",
            str(SEQ), "--ckpt-dir", ckpt]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's ``train_lm`` resuming from the reference's seed-0 state
    (the example's smoke config and run configuration) saved as step 0."""
    ckpt = str(tmp_path_factory.mktemp("train_lm") / "ckpt")
    rcfg = dict(learning_rate=1e-3, total_steps=STEPS, warmup_steps=max(STEPS // 10, 1),
                remat="block", opt_state_quant="posit8")
    jm = j_build_model(j_smoke(J_ARCHS["yi-9b"]), JRunConfig(**rcfg))
    jstate = jax.jit(lambda k: j_make_train_state(jm, k))(jax.random.PRNGKey(0))
    JManager(ckpt, async_save=False).save(0, jax.tree.map(np.asarray, jstate))
    return train_lm.main(_argv(ckpt)), ckpt


def test_train_lm_trains_from_the_references_checkpoint(trained):
    run, _ = trained
    assert run.start == 1
    assert [s for s, _ in run.losses] == list(range(1, STEPS))
    assert all(math.isfinite(v) for _, v in run.losses)
    assert run.n_params == sum(a.size for _, a, _ in walk(params_to_numpy(run.params),
                                                          params_to_numpy(run.params)))
    assert set(run.ppl) == {"fp32", *train_lm.POLICIES}
    assert all(math.isfinite(v) and v > 1 for v in run.ppl.values())


def test_train_lm_policies_match_the_reference(trained):
    """Each policy's codes, and each perplexity at f32 activations, against
    the reference's functions on the port's trained parameters."""
    run, _ = trained
    cfg = run.model.cfg
    jp = jax.tree.map(jnp.asarray, _bf16(params_to_numpy(run.params)))
    jm = j_build_model(j_smoke(J_ARCHS["yi-9b"]), JRunConfig(activation_dtype="f32"))
    tm = build_model(cfg, RunConfig(activation_dtype="f32"), device="cpu")
    batches = train_lm.eval_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                               global_batch=BATCH))

    # jitted: the reference's eager quantization takes several times as long
    nll = jax.jit(lambda p, t, lb: j_ce_loss(jm.forward(p, t), lb))

    def j_ppl(p):
        return math.exp(sum(float(nll(p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])))
                            for b in batches) / len(batches))

    def j_apply(pol):
        return jax.jit(lambda p: j_apply_policy(p, pol))(jp)

    for pol in (None, *train_lm.POLICIES):
        jq = jp if pol is None else j_apply(pol)
        tq = run.params if pol is None else apply_policy(run.params, pol)
        got = params_to_numpy(tq)
        for path, a, b in walk(jax.tree.map(np.asarray, _as_leaves(jq)), _bf16(got)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (pol, path)
        want = j_ppl(jq)
        ppl = train_lm.perplexity(tm, tq, batches)
        assert abs(ppl - want) <= PPL_RTOL * want, (pol, ppl, want)
    policy = JPolicy.from_string(train_lm.SAVED_POLICY)
    assert run.saved_policy == policy.to_string()
    assert run.storage == j_storage_report(j_apply(policy), policy)


def _bf16(tree):
    """``params_to_numpy``'s tree with its bfloat16 leaves (2-byte voids)
    as ml_dtypes' bfloat16, as JAX takes them."""
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype.kind == "V" and tree.dtype.itemsize == 2:
        return tree.view(jnp.bfloat16)
    return tree


def _as_leaves(tree):
    """A reference tree with each QuantizedTensor as the port's
    {"codes", "scale", "spec"} leaf (``convert.params_to_numpy``'s form)."""
    from repro.core.policy import format_spec
    from repro.core.quantizers import QuantizedTensor as JQT
    if isinstance(tree, JQT):
        return {"codes": tree.codes, "scale": tree.scale, "spec": format_spec(tree.spec)}
    if isinstance(tree, dict):
        return {k: _as_leaves(v) for k, v in tree.items()}
    return tree


def test_train_lm_resumes_from_its_last_checkpoint(trained):
    run, ckpt = trained
    again = train_lm.main(_argv(ckpt))
    assert again.start == STEPS and again.losses == []
    for path, a, b in walk(params_to_numpy(run.params), params_to_numpy(again.params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    assert again.ppl == run.ppl and again.storage == run.storage


def test_serve_quantized_runs_on_the_cpu(capsys):
    run = serve_quantized.main(["--device", "cpu"])
    assert run.model.cfg.d_model == 128 and len(run.done) == len(run.requests) == 8
    assert all(len(r.out) == 16 and r.finish_reason == "length" for r in run.done)
    assert "decode" in capsys.readouterr().out
