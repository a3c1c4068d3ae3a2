"""Model facade: one ``LM`` per (ModelConfig, RunConfig, device).

Port of the dense-family serving surface of ``repro/nn/models.py``:
``init`` (per-layer parameters, quantized leaf by leaf as they are made),
``init_cache``, ``prefill(length=)``, ``decode_step``, plus ``apply_policy``,
``kv_decode_bytes_per_token`` and ``build_model``.

Parameters are nested dicts like the reference's tree, except that
``blocks`` is a list with one dict per layer instead of layer-stacked
leaves. The decode cache keeps the reference layout: {"pos": scalar or
(B,) int32, "kv": {"k", "v": (L, B, G, S, Dh)[, "k_scale", "v_scale":
(L, B, G, 1, Dh)]}}; decode writes it in place.

Everything runs on ``device`` ("cuda" unless the caller asks otherwise);
asking for CUDA without a card raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizers import (QuantSpec, kv_code_dtype, quantize,
                                         validate_kv_spec)
from repro_torch.kernels.ops import KERNELS, KernelSet
from . import transformer as T
from .attention import attn_shapes
from .layers import matmul_param, mlp_shapes, rmsnorm

__all__ = ["LM", "build_model", "apply_policy", "kv_decode_bytes_per_token",
           "resolve_device"]

_NEVER_QUANT = ("ln", "norm", "A_log", "dt_bias", "D", "router", "conv_w",
                "conv_b", "q_norm", "k_norm")


def _dt(name: str) -> torch.dtype:
    return {"f32": torch.float32, "fp32": torch.float32,
            "bf16": torch.bfloat16}[name]


def resolve_device(device) -> torch.device:
    """The device to run on; CUDA without a card raises (no silent CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def _apply_rule(name: str, leaf: torch.Tensor, policy: Optional[QuantPolicy]):
    """One leaf of ``apply_policy``: quantize, cast or keep per the policy."""
    if policy is None:
        return leaf
    eligible = leaf.ndim >= 2 and not any(t in name for t in _NEVER_QUANT)
    spec = policy.match(name) if eligible else None
    if spec is None:
        return leaf
    if spec.kind in ("fp32", "bf16"):
        return leaf.to(torch.float32 if spec.kind == "fp32" else torch.bfloat16)
    return quantize(leaf.to(torch.float32), spec, axis=-1)


def apply_policy(params, policy):
    """Convert weight matrices to QuantizedTensor storage per a QuantPolicy.

    Each eligible leaf (a >= 2-D matmul weight; norms and the other
    never-quantize classes excluded) is matched by its reference path name
    ("blocks/attn/wq", "embed", ...); every layer is quantized on its own,
    so per-layer scales match the reference's layer-stacked ones.
    """
    if isinstance(policy, str):
        policy = QuantPolicy.from_string(policy)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, prefix) for v in tree]
        return _apply_rule(prefix.rstrip("/"), tree, policy)
    return walk(params, "")


@dataclasses.dataclass
class LM:
    cfg: ModelConfig
    rcfg: RunConfig
    device: Any = "cuda"
    use_kernel: bool = False
    # Decode KV-cache format: a byte-wide fxp/pofx QuantSpec allocates
    # code+scale cache leaves; None keeps a bf16/f32 cache. With
    # use_kernel, a quantized cache is read by kv_flash_decode, else by
    # the dequantize-on-read fallback.
    kv_spec: Optional[QuantSpec] = None
    # What the kernel datapath calls: KERNELS (the CUDA kernels' wrappers),
    # PLAIN (their plain PyTorch versions: a reference run of the same
    # datapath on the card) or a mix of the two.
    kernel_set: KernelSet = KERNELS

    def __post_init__(self):
        if self.cfg.family != "dense":
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ROADMAP A9); "
                "this slice serves the dense family")
        if self.cfg.tie_embeddings:
            raise NotImplementedError("tied embeddings are not ported yet")
        self.device = resolve_device(self.device)
        self.kv_spec = validate_kv_spec(self.kv_spec)

    @property
    def kernels(self) -> Optional[KernelSet]:
        return self.kernel_set if self.use_kernel else None

    @property
    def act_dtype(self) -> torch.dtype:
        return _dt(getattr(self.rcfg, "activation_dtype", "bf16"))

    @property
    def param_dtype(self) -> torch.dtype:
        return _dt(self.rcfg.weight_dtype)

    # -- init -----------------------------------------------------------------

    def init(self, seed: int = 0, policy=None) -> Dict[str, Any]:
        """Random parameters from a seeded ``torch.Generator`` on the device.

        With a ``policy`` every weight is quantized right after it is drawn,
        and its float copy is dropped before the next one is made, so the
        float model never exists as a whole (a full-width yi-9b is ~8.8 GB of
        pofx8 codes but ~35 GB of f32). The draws cannot reproduce
        ``jax.random``; tests pass weights across with ``convert``.
        """
        if isinstance(policy, str):
            policy = QuantPolicy.from_string(policy)
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))

        def dense(name, in_dim, out_dims, scale=None):
            scale = in_dim ** -0.5 if scale is None else scale
            w = torch.randn((in_dim, *out_dims), generator=gen, device=dev,
                            dtype=torch.float32) * scale
            return _apply_rule(name, w.to(dt), policy)

        def ones(name, n):
            return _apply_rule(name, torch.ones((n,), dtype=dt, device=dev),
                               policy)

        V, d = cfg.padded_vocab, cfg.d_model
        params: Dict[str, Any] = {"embed": dense("embed", V, (d,), scale=1.0),
                                  "ln_f": ones("ln_f", d),
                                  "unembed": dense("unembed", d, (V,))}
        blocks = []
        for _ in range(cfg.n_layers):
            blk = {"ln1": ones("blocks/ln1", d), "ln2": ones("blocks/ln2", d),
                   "attn": {n: dense(f"blocks/attn/{n}", i, o)
                            for n, (i, o) in attn_shapes(cfg).items()},
                   "mlp": {n: dense(f"blocks/mlp/{n}", i, o)
                           for n, (i, o) in mlp_shapes(d, cfg.d_ff, cfg.act).items()}}
            if cfg.qk_norm:
                blk["attn"]["q_norm"] = ones("blocks/attn/q_norm", cfg.d_head)
                blk["attn"]["k_norm"] = ones("blocks/attn/k_norm", cfg.d_head)
            blocks.append(blk)
        params["blocks"] = blocks
        return params

    # -- cache ----------------------------------------------------------------

    def _kv_cache(self, batch: int, max_len: int,
                  kv_spec: Optional[QuantSpec]) -> Dict[str, torch.Tensor]:
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
        sshape = (cfg.n_layers, batch, cfg.n_kv_heads, 1, cfg.d_head)
        if kv_spec is not None:
            cdt = kv_code_dtype(kv_spec)
            return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                    "k_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
                    "v": torch.zeros(shape, dtype=cdt, device=dev),
                    "v_scale": torch.ones(sshape, dtype=torch.float32, device=dev)}
        kdt = (torch.bfloat16 if self.rcfg.kv_cache_dtype == "int8"
               else _dt(self.rcfg.kv_cache_dtype))
        return {"k": torch.zeros(shape, dtype=kdt, device=dev),
                "v": torch.zeros(shape, dtype=kdt, device=dev)}

    def init_cache(self, batch: int, max_len: int,
                   kv_spec="auto") -> Dict[str, Any]:
        """Zero decode cache; ``kv_spec`` overrides the format for
        allocation only (prefill/decode_step reject a mismatched cache)."""
        spec = self.kv_spec if kv_spec == "auto" else validate_kv_spec(kv_spec)
        return {"pos": torch.zeros((), dtype=torch.int32, device=self.device),
                "kv": self._kv_cache(batch, max_len, spec)}

    def _check_cache_layout(self, cache) -> None:
        kv = cache["kv"]
        quant = "k_scale" in kv
        if (self.kv_spec is not None) != quant:
            raise ValueError(
                f"cache layout disagrees with the model's kv_spec="
                f"{self.kv_spec!r}: the cache "
                f"{'has' if quant else 'lacks'} scale leaves (was it "
                "allocated by init_cache(kv_spec=...) with a different "
                "format?)")
        if quant and kv["k"].dtype != kv_code_dtype(self.kv_spec):
            raise ValueError(
                f"cache code dtype {kv['k'].dtype} does not match the "
                f"model's kv_spec={self.kv_spec!r} "
                f"(expects {kv_code_dtype(self.kv_spec)})")

    @staticmethod
    def layer_cache(cache, i: int) -> Dict[str, torch.Tensor]:
        """Views of layer ``i``'s cache leaves (writes land in ``cache``)."""
        return {name: leaf[i] for name, leaf in cache["kv"].items()}

    # -- serving --------------------------------------------------------------

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, params["ln_f"], self.cfg.norm_eps)
        return matmul_param(x, params["unembed"], kernels=self.kernels)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, *, cache, length=None):
        """Run the prompt, filling the cache. Returns (cache, last_logits).

        ``length`` (scalar or (B,)) marks the true prompt length when
        ``tokens`` is right-padded to a bucket: logits are taken at
        ``length-1`` and ``cache["pos"]`` becomes the per-sequence length.
        """
        cfg, rcfg = self.cfg, self.rcfg
        self._check_cache_layout(cache)
        tokens = tokens.to(self.device)
        B, Sq = tokens.shape
        positions = torch.arange(Sq, device=self.device)[None, :].expand(B, Sq)
        x = T.embed_tokens(params["embed"], tokens, self.act_dtype)
        quant = self.kv_spec is not None
        for i, lp in enumerate(params["blocks"]):
            lc = self.layer_cache(cache, i)
            scales = ({"k_scale": lc["k_scale"], "v_scale": lc["v_scale"]}
                      if quant else None)
            x, kv = T.dense_block_forward(lp, x, cfg, rcfg, positions=positions,
                                          kernels=self.kernels,
                                          kv_spec=self.kv_spec,
                                          kv_scales=scales)
            for name in ("k", "v"):
                dst = lc[name]
                dst[:, :, :Sq] = kv[name].transpose(1, 2).to(dst.dtype)
        if length is None:
            last = x[:, -1]
            pos = torch.tensor(Sq, dtype=torch.int32, device=self.device)
        else:
            pos = torch.as_tensor(length, device=self.device).to(
                torch.int32).reshape(-1).expand(B).clone()
            last = x[torch.arange(B, device=self.device), pos.long() - 1]
        logits = self._logits(params, last)
        cache = dict(cache, pos=pos)
        return cache, logits

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One decode step. tokens: (B, 1). Returns (cache, logits (B, V)).

        ``cache["pos"]`` is a scalar or (B,) per-slot lengths; rotary
        positions, the KV write and the attention mask follow it per slot.
        The layer caches are updated in place; the returned dict carries
        ``pos + 1``.
        """
        cfg, rcfg = self.cfg, self.rcfg
        self._check_cache_layout(cache)
        B = tokens.shape[0]
        pos = cache["pos"]
        positions = pos.reshape(-1, 1).expand(B, 1)
        x = T.embed_tokens(params["embed"], tokens, self.act_dtype)
        for i, lp in enumerate(params["blocks"]):
            x, _ = T.dense_block_forward(lp, x, cfg, rcfg, positions=positions,
                                         cache=self.layer_cache(cache, i),
                                         cache_pos=pos, kernels=self.kernels,
                                         kv_spec=self.kv_spec)
        return dict(cache, pos=pos + 1), self._logits(params, x[:, 0])


def kv_decode_bytes_per_token(cfg: ModelConfig, context_len: int,
                              kv_spec: Optional[QuantSpec] = None,
                              cache_dtype_bytes: int = 2) -> Dict[str, float]:
    """Modeled device-memory bytes read from the KV cache per decoded token
    (every attention layer re-reads its valid K+V prefix each step)."""
    fam = cfg.family
    if fam == "ssm":
        n_attn = 0
    elif fam == "hybrid":
        n_attn = -(-cfg.n_layers // cfg.attn_every) if cfg.attn_every else 0
    else:
        n_attn = cfg.n_layers
    G, Dh = cfg.n_kv_heads, cfg.d_head
    per_elem = 1 if kv_spec is not None else cache_dtype_bytes
    return {
        "code_bytes": float(n_attn * 2 * G * context_len * Dh * per_elem),
        "scale_bytes": float(n_attn * 2 * G * Dh * 4) if kv_spec is not None
        else 0.0,
    }


def build_model(cfg: ModelConfig, rcfg: RunConfig, *, device="cuda",
                use_kernel: bool = False, kv_spec=None,
                kernel_set: KernelSet = KERNELS) -> LM:
    return LM(cfg, rcfg, device=device, use_kernel=use_kernel,
              kv_spec=kv_spec, kernel_set=kernel_set)
