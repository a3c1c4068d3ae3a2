"""Test-side bridge between the reference package (JAX) and the port.

Flattens a reference parameter tree to the nested numpy dicts that
``repro_torch.convert.params_from_numpy`` takes (a QuantizedTensor becomes
{"codes", "scale", "spec": format_spec string}), converts reference specs
to port specs, builds matching tiny models in both packages, and lists
both trees' leaves in one form (``reference_leaves``, ``port_leaves``).
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import numpy as np

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


def pair(policy="pofx8", *, kv=None, use_kernel=False, arch="yi-9b"):
    """Matching (jax_model, jax_params, torch_model, torch_params) for the
    smoke-size ``arch`` at f32 activations, with the reference's weights
    (seed 0, quantized by ``policy``) carried across."""
    jm = j_build_model(j_smoke(J_ARCHS[arch]),
                       JRunConfig(remat="none", activation_dtype="f32"),
                       use_kernel=use_kernel, kv_spec=jspec(kv))
    tm = t_build_model(t_smoke(T_ARCHS[arch]),
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
