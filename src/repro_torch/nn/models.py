"""Model facade: one ``LM`` per (ModelConfig, RunConfig, device).

Port of the serving surface of ``repro/nn/models.py`` for every family
the reference serves (dense, moe, ssm, hybrid and encdec): ``init``
(per-layer parameters, quantized leaf by leaf as they are made),
``init_cache``, ``prefill(length=, frames=)``, ``decode_step``, plus
``apply_policy`` (and ``quantize_params``, its uniform-policy shim),
``kv_decode_bytes_per_token`` and ``build_model``; and
the training surface of every family: ``forward`` (full-sequence logits,
each of the reference's remat units under ``torch.utils.checkpoint`` when
``rcfg.remat == "block"`` and gradients are on), ``loss`` and
``ce_loss``. ``tie_embeddings`` drops ``unembed`` and reads the logits
through the transposed embedding, as the reference does.

Parameters are nested dicts like the reference's tree, except that
``blocks`` is a list with one dict per layer, in execution order, instead
of layer-stacked leaves. The moe family's reference stacks groups of
``moe_every`` layers (``moe_every - 1`` dense layers, then one MoE layer)
as {"moe": (n_groups, ...), "dense": (n_groups, moe_every - 1, ...)}; here
each layer is one dict, an MoE layer's holding "moe" where a dense layer's
holds "mlp", and leaves are named by the reference's paths
(``core.policy.layer_prefixes``). The decode cache keeps the dense
family's reference layout for both families, L counting every attention
layer in execution order: {"pos": scalar or (B,) int32, "kv": {"k", "v":
(L, B, G, S, Dh)[, "k_scale", "v_scale": (L, B, G, 1, Dh)]}}; decode
writes it in place. The ssm family (falcon-mamba: mamba1 layers, no
attention) carries each layer's recurrent state instead, {"pos", "ssm":
{"conv": (L, B, K-1, conv_dim), "ssm": (L, B, ...)}} in f32; the hybrid
family (zamba2: mamba2 layers, and ONE shared attention + MLP block,
``params["shared"]``, run before each chunk of ``attn_every`` layers) adds
"shared_kv", one KV cache of the kv layout per chunk, (n_chunks, B, G, S,
Dh). Both refuse a right-padded prefill and the paged cache, as the
reference does. The encdec family (whisper) adds the encoder:
``enc_blocks`` (a list of dense blocks, run non-causally over the frame
positions) and ``enc_ln``; its decoder layers add "ln_x" and "xattn"
(leaves named "enc_blocks/..." and "blocks/xattn/..."). Its cache adds
"cross" ({"k", "v": (L, B, G, enc_len, Dh)}, bf16, filled once by the
prefill from the encoder states) and "xlen" (the encoder length); it takes
no quantized KV cache, no paged cache and no engine: the one-shot loop of
``launch.serve`` serves it. The paged cache
(``init_paged_cache``, ``prefill_paged``) replaces the batch and sequence
axes by one pool of pages: {"pos": (B,), "pages": (B, max_pages) int32
block tables, "kv": {"k", "v": (L, n_pages, G, ps, Dh)[, "k_scale",
"v_scale": (L, G, 1, Dh)]}}.

Everything runs on ``device`` ("cuda" unless the caller asks otherwise);
asking for CUDA without a card raises.

Tensor parallelism (``build_model(..., tp=TPContext)``, DESIGN.md §9): the
LM is one rank's model. ``init`` draws every full leaf from the one
generator on every rank (so the generator advances alike), quantizes the
whole leaf, keeps the rank's slice of codes and scale
(``nn.sharding.shard_leaf``) and drops the rest before the next draw: a
row-sharded leaf's per-column scales reduce over the rows that get
sharded, so quantizing a shard would give other scales, and slicing after
quantizing keeps each shard equal, bit for bit, to the tp = 1 leaf's. The
caches hold ``n_kv_heads // tp`` heads of codes and static scales.
``logical()`` names every leaf's axes; a tp that does not divide them
raises the reference's error when the model is built.

Training over a (pod, data, model) grid (``build_model(..., grid=
GridContext)``; every family): the LM is one rank's model, and each leaf
is cut to the rank's block by the training rules (``nn.sharding.
train_rules``: FSDP of ``p_embed`` over data; heads, kv_heads, mlp,
experts, vocab and the mamba channel dims over model; a dim that its axes
do not divide replicates, as the reference's ``ShardingCtx.spec`` has
it). ``specs()`` gives every leaf's spec. ``forward`` gathers a layer's
(or an encoder layer's, or the shared block's) data shards inside its
remat unit (``fsdp_gather``; the recompute gathers again, in the same
order on every rank), and each product takes its collectives from its
own leaf: a column-sharded product reads a whole input through
``TPContext.copy_in``, a row-sharded one sums through
``TPContext.reduce_out``, a leaf the model axis does not divide takes
neither (the rank computes it whole, and its gradient is whole on every
rank). The embedding lookup is vocab-parallel (rows outside the rank's
block masked, then reduce_out), and ``loss`` is the reference's
cross-entropy of the rank's rows on the rank's vocab block of the logits
(``nn.sharding.vocab_parallel_ce``: each reduction over the vocab a
partial all-reduced over model, so no rank gathers the logits); served
logits are gathered over model (``gather_replicated``). Under
``grad_compression="posit8*"`` the embedding's vocab dim replicates, as
the reference's ``LM.logical`` has it. An MoE layer routes the rank's rows as part of the batch that
``batch_axes`` names (``moe.moe_forward``). Under ``sequence_parallel``
the rules shard "seq" over model (``train_rules``), and where the model
axis divides the sequence (``seq_ctx``; an odd length or S = 1
replicates, as the reference's lenient spec has it, and the step is the
step without it) the residual stream between blocks is the rank's block
along seq (Megatron-SP): the embedding's sum is a reduce-scatter
(``scatter_seq``), each sublayer gathers the whole sequence and hands back
the rank's block, the norms on the residual (the blocks', ``ln_f``,
``enc_ln``) read their weights through ``copy_in``, and the unembedding
reads the whole sequence (``gather_seq``). The encoder's frames are cut
the same way along their own length, and each decoder layer's
cross-attention gathers them. Serving never takes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.policy import QuantPolicy, layer_prefixes
from repro_torch.core.quantizers import (QuantizedTensor, QuantSpec, kv_code_dtype,
                                         quantize, validate_kv_spec)
from repro_torch.kernels.ops import KERNELS, KernelSet
from . import ssm
from . import transformer as T
from .attention import attn_logical, attn_shapes
from .layers import matmul_param, mlp_logical, mlp_shapes, param_value, rmsnorm
from .moe import moe_logical, moe_shapes
from .sharding import (GridContext, TPContext, check_tp_shapes, fsdp_gather,
                       gather_quantized, gather_replicated, map_with_logical, placed,
                       scatter_seq, seq_in, shard_leaf, take_block, train_rules,
                       vocab_parallel_ce)
from .ssm import mamba_shapes

__all__ = ["LM", "build_model", "apply_policy", "quantize_params", "ce_loss",
           "kv_decode_bytes_per_token", "resolve_device", "input_specs", "TensorSpec"]

_NEVER_QUANT = ("ln", "norm", "A_log", "dt_bias", "D", "router", "conv_w",
                "conv_b", "q_norm", "k_norm")


def _dt(name: str) -> torch.dtype:
    return {"f32": torch.float32, "fp32": torch.float32,
            "bf16": torch.bfloat16}[name]


def ce_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            z_weight: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy over every position, in f32 over the padded
    vocab, with the max taken out of the gradient (a stop-gradient, as the
    reference's); ``z_weight`` adds z_weight * mean(lse^2)."""
    lg = logits.to(torch.float32)
    m = lg.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lg - m).sum(dim=-1)) + m[..., 0]
    ll = lg.gather(-1, labels.long()[..., None])[..., 0]
    nll = (lse - ll).mean()
    if z_weight:
        nll = nll + z_weight * torch.square(lse).mean()
    return nll


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
    return quantize(leaf, spec, axis=-1)


def apply_policy(params, policy):
    """Convert weight matrices to QuantizedTensor storage per a QuantPolicy.

    Each eligible leaf (a >= 2-D matmul weight; norms, the MoE router and
    the other never-quantize classes excluded) is matched by its reference
    path name ("blocks/attn/wq", "blocks/moe/moe/wg", "embed", ...); every
    layer is quantized on its own, so per-layer scales match the
    reference's layer-stacked ones. A stacked (E, in, out) expert leaf is
    quantized whole, as the reference does: one scale per output column,
    shared by all experts.
    """
    if isinstance(policy, str):
        policy = QuantPolicy.from_string(policy)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, p) for v, p in zip(tree, layer_prefixes(tree, prefix))]
        return _apply_rule(prefix.rstrip("/"), tree, policy)
    return walk(params, "")


def quantize_params(params, spec: QuantSpec, *, quant_embed: bool = True):
    """Back-compat shim: uniform-policy application of one QuantSpec.

    Equivalent to ``apply_policy(params, QuantPolicy.uniform(spec))``, with
    ``quant_embed=False`` expressed as a leading "*embed*=keep" rule.
    """
    rules = (("*embed*", None),) if not quant_embed else ()
    return apply_policy(params, QuantPolicy(rules=rules + (("*", spec),)))


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
    # this rank's tensor-parallel context (the default: tp = 1)
    tp: TPContext = dataclasses.field(default_factory=TPContext)
    # this rank's training grid (None: one device, or serving TP)
    grid: Optional[GridContext] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.kv_spec = validate_kv_spec(self.kv_spec)
        if self.grid is not None:
            self.tp = self.grid.model
            self._rules = train_rules(self.grid.axis_names,
                                      sequence_parallel=self.rcfg.sequence_parallel)
            self._specs = map_with_logical(
                lambda name, shape, ax: self.grid.spec(ax, shape, self._rules),
                self.param_shapes(), self.logical())
        elif self.tp.size > 1:
            if self.cfg.family == "encdec":
                raise ValueError("--tp needs the engine path (not --legacy / encdec)")
            check_tp_shapes(self.param_shapes(), self.logical(), self.tp)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The grid axes over whose ranks one forward's batch is cut, each
        rank a block of rows: (pod, data); under the posit8-compressed pod
        mean (``grad_compression`` "posit8*" on a grid with a pod axis)
        (data,) alone, since each pod runs the loss on its own rows (the
        reference's shard_map over "pod")."""
        if (str(self.rcfg.grad_compression).startswith("posit8")
                and "pod" in self.grid.axis_names):
            return ("data",)
        return ("pod", "data")

    def specs(self) -> Dict[str, Any]:
        """Every parameter's spec on the grid (``GridContext.spec`` of its
        logical axes and tp = 1 shape), in ``logical()``'s structure."""
        return self._specs

    def seq_ctx(self, seq_len: int) -> Optional[TPContext]:
        """The model axis where sequence parallelism cuts a residual of
        ``seq_len`` positions along seq (the "seq" rule's lenient spec), None
        where it does not (off a grid, ``sequence_parallel`` off, a model
        axis of one rank, or a length the model axis does not divide)."""
        if (self.grid is None or self.tp.size == 1
                or self.grid.spec(("seq",), (seq_len,), self._rules)[0] is None):
            return None
        return self.tp

    @property
    def n_kv_heads_local(self) -> int:
        """The kv heads a rank's cache holds: its shard of the head axis
        under serving TP; every head on a grid (whose rules cut the cache's
        sequence instead)."""
        if self.grid is not None:
            return self.cfg.n_kv_heads
        return self.cfg.n_kv_heads // self.tp.size

    @property
    def kernels(self) -> Optional[KernelSet]:
        return self.kernel_set if self.use_kernel else None

    @property
    def act_dtype(self) -> torch.dtype:
        return _dt(getattr(self.rcfg, "activation_dtype", "bf16"))

    @property
    def param_dtype(self) -> torch.dtype:
        return _dt(self.rcfg.weight_dtype)

    @property
    def n_groups(self) -> int:
        """Layer groups of the reference's stack: moe_every layers each in
        the moe family (the last of a group is the MoE layer)."""
        cfg = self.cfg
        if cfg.family == "moe":
            return cfg.n_layers // cfg.moe_every
        return cfg.n_layers

    def _hybrid_chunks(self):
        """zamba2: the sizes of the runs of mamba layers, each after one
        application of the shared block (attn_every layers, the last run
        shorter when attn_every does not divide n_layers)."""
        k, L = self.cfg.attn_every, self.cfg.n_layers
        return [min(k, L - done) for done in range(0, L, k)]

    # -- logical axes ---------------------------------------------------------

    def logical(self) -> Dict[str, Any]:
        """Logical-axis tree of the parameters (same structure as ``init``'s
        tree, one entry per layer of ``blocks``): the names ``nn.sharding``'s
        tensor-parallel rules map."""
        cfg = self.cfg
        # under posit8 gradient compression the reference keeps the embed
        # table's vocab dim replicated (its lookup runs inside a shard_map)
        compressed = str(self.rcfg.grad_compression).startswith("posit8")
        out: Dict[str, Any] = {"embed": (None if compressed else "vocab", "p_embed"),
                               "ln_f": ("p_unsharded",)}
        if not cfg.tie_embeddings:
            out["unembed"] = ("p_embed", "vocab")
        fam = cfg.family
        if fam in ("ssm", "hybrid"):
            out["blocks"] = [T.mamba_block_logical(cfg) for _ in range(cfg.n_layers)]
            if fam == "hybrid":
                out["shared"] = T.dense_block_logical(cfg)
        elif fam == "dense":
            out["blocks"] = [T.dense_block_logical(cfg) for _ in range(cfg.n_layers)]
        elif fam == "encdec":
            out["enc_blocks"] = [T.encdec_block_logical(cfg)
                                 for _ in range(cfg.n_enc_layers)]
            out["enc_ln"] = ("p_unsharded",)
            out["blocks"] = [T.encdec_block_logical(cfg, cross=True)
                             for _ in range(cfg.n_layers)]
        else:
            out["blocks"] = [T.moe_block_logical(cfg) if (i + 1) % cfg.moe_every == 0
                             else T.dense_block_logical(cfg)
                             for i in range(self.n_groups * cfg.moe_every)]
        return out

    def param_shapes(self) -> Dict[str, Any]:
        """The tp = 1 shapes of every leaf, in ``logical()``'s structure."""
        cfg = self.cfg
        d = cfg.d_model

        def shapes(table):
            return {n: (i, *o) for n, (i, o) in table.items()}

        def attn():
            a = shapes(attn_shapes(cfg))
            if cfg.qk_norm:
                a.update(q_norm=(cfg.d_head,), k_norm=(cfg.d_head,))
            return a

        def block(moe=False, cross=False):
            b = {"ln1": (d,), "ln2": (d,), "attn": attn()}
            if cross:
                b.update(ln_x=(d,), xattn=attn())
            if not moe:
                b["mlp"] = shapes(mlp_shapes(d, cfg.d_ff, cfg.act))
                return b
            m = moe_shapes(cfg)
            b["moe"] = dict(m["experts"], router=(d, cfg.n_experts))
            if "shared" in m:
                b["moe"]["shared"] = shapes(m["shared"])
            return b

        out: Dict[str, Any] = {"embed": (cfg.padded_vocab, d), "ln_f": (d,)}
        if not cfg.tie_embeddings:
            out["unembed"] = (d, cfg.padded_vocab)
        fam = cfg.family
        if fam in ("ssm", "hybrid"):
            out["blocks"] = [{"ln": (d,), "mix": mamba_shapes(cfg)}
                             for _ in range(cfg.n_layers)]
            if fam == "hybrid":
                out["shared"] = block()
        elif fam == "encdec":
            out["enc_blocks"] = [block() for _ in range(cfg.n_enc_layers)]
            out["enc_ln"] = (d,)
            out["blocks"] = [block(cross=True) for _ in range(cfg.n_layers)]
        else:
            moe_every = cfg.moe_every if fam == "moe" else 1
            out["blocks"] = [block(fam == "moe" and (i + 1) % moe_every == 0)
                             for i in range(self.n_groups * moe_every)]
        return out

    # -- init -----------------------------------------------------------------

    def init(self, seed: int = 0, policy=None) -> Dict[str, Any]:
        """Random parameters from a seeded ``torch.Generator`` on the device.

        With a ``policy`` every weight is quantized right after it is drawn,
        and its float copy is dropped before the next one is made, so the
        float model never exists as a whole (a full-width yi-9b is ~8.8 GB of
        pofx8 codes but ~35 GB of f32; moonshot-v1-16b-a3b ~29 GB of codes,
        its largest draw one (64, 2048, 1408) expert leaf). The draws cannot
        reproduce ``jax.random``; tests pass weights across with ``convert``.
        Under tensor parallelism each leaf that a rule shards is quantized
        whole and cut to the rank's shard before the next draw.
        """
        if isinstance(policy, str):
            policy = QuantPolicy.from_string(policy)
        cfg, dt, dev = self.cfg, self.param_dtype, self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        V, d = cfg.padded_vocab, cfg.d_model

        def dense(name, in_dim, out_dims, scale=None, dtype=dt, axes=None):
            scale = in_dim ** -0.5 if scale is None else scale
            w = torch.randn((in_dim, *out_dims), generator=gen, device=dev,
                            dtype=torch.float32)
            # in place, and the f32 draw dropped before the rule runs: a
            # 256000 x 18432 table (nemotron-4-340b) is 18.9 GB in f32
            w = w.mul_(scale).to(dtype)
            return place(name, _apply_rule(name, w, policy), axes)

        def place(name, w, axes):
            """The rank's block of a leaf drawn whole (a grid's, or serving
            TP's shard); on a grid a quantized leaf's codes are cut like the
            parameter and its scale stays whole."""
            if self.grid is not None:
                if isinstance(w, QuantizedTensor):
                    return QuantizedTensor(self.grid.shard(w.codes, self.grid.spec(
                        axes, w.codes.shape)), w.scale, w.spec)
                return self.grid.shard(w, self.grid.spec(axes, w.shape))
            return w if axes is None else shard_leaf(w, axes, self.tp, name)

        def ones(name, n):
            return _apply_rule(name, torch.ones((n,), dtype=dt, device=dev),
                               policy)

        def attn(pre):
            ax = attn_logical(cfg)
            a = {n: dense(f"{pre}{n}", i, o, axes=ax[n])
                 for n, (i, o) in attn_shapes(cfg).items()}
            if cfg.qk_norm:
                a["q_norm"] = ones(f"{pre}q_norm", cfg.d_head)
                a["k_norm"] = ones(f"{pre}k_norm", cfg.d_head)
            return a

        def block(pre, moe=False, cross=False):
            blk = {"ln1": ones(f"{pre}ln1", d), "ln2": ones(f"{pre}ln2", d),
                   "attn": attn(f"{pre}attn/")}
            if cross:
                blk["ln_x"] = ones(f"{pre}ln_x", d)
                blk["xattn"] = attn(f"{pre}xattn/")
            mlp_ax = mlp_logical(cfg.act)
            if not moe:
                blk["mlp"] = {n: dense(f"{pre}mlp/{n}", i, o, axes=mlp_ax[n])
                              for n, (i, o) in mlp_shapes(d, cfg.d_ff, cfg.act).items()}
                return blk
            shapes = moe_shapes(cfg)
            # the router stays f32 whatever the weight dtype (never quantized);
            # each (E, in, out) expert leaf is drawn and quantized whole
            mx = moe_logical(cfg)
            m = {"router": dense(f"{pre}moe/router", d, (cfg.n_experts,),
                                 dtype=torch.float32, axes=mx["router"])}
            m.update({n: dense(f"{pre}moe/{n}", E, (i, o), scale=i ** -0.5, axes=mx[n])
                      for n, (E, i, o) in shapes["experts"].items()})
            if "shared" in shapes:
                m["shared"] = {n: dense(f"{pre}moe/shared/{n}", i, o, axes=mlp_ax[n])
                               for n, (i, o) in shapes["shared"].items()}
            blk["moe"] = m
            return blk

        lg = self.logical() if self.grid is not None else {}
        params: Dict[str, Any] = {"embed": dense("embed", V, (d,), scale=1.0,
                                                 axes=lg.get("embed")),
                                  "ln_f": ones("ln_f", d)}
        if not cfg.tie_embeddings:
            params["unembed"] = dense("unembed", d, (V,), axes=lg.get("unembed"))
        if cfg.family in ("ssm", "hybrid"):
            mix_axes = T.mamba_block_logical(cfg)["mix"]

            def rule(name, w):
                return place(name, _apply_rule(name, w, policy),
                             mix_axes[name.rsplit("/", 1)[1]])

            params["blocks"] = [
                {"ln": ones("blocks/ln", d),
                 "mix": ssm.mamba_init(cfg, gen=gen, device=dev, dtype=dt,
                                       rule=rule, prefix="blocks/mix/")}
                for _ in range(cfg.n_layers)]
            if cfg.family == "hybrid":
                params["shared"] = block("shared/")
            return params
        if cfg.family == "dense":
            params["blocks"] = [block("blocks/") for _ in range(cfg.n_layers)]
            return params
        if cfg.family == "encdec":
            params["enc_blocks"] = [block("enc_blocks/") for _ in range(cfg.n_enc_layers)]
            params["enc_ln"] = ones("enc_ln", d)
            params["blocks"] = [block("blocks/", cross=True) for _ in range(cfg.n_layers)]
            return params
        # moe: each group runs its moe_every - 1 dense layers, then its MoE layer
        blocks = []
        for _ in range(self.n_groups):
            blocks += [block("blocks/dense/") for _ in range(cfg.moe_every - 1)]
            blocks.append(block("blocks/moe/", moe=True))
        params["blocks"] = blocks
        return params

    # -- cache ----------------------------------------------------------------

    def _kv_cache(self, batch: int, max_len: int, kv_spec: Optional[QuantSpec],
                  n_layers: int, device=None) -> Dict[str, torch.Tensor]:
        cfg, dev = self.cfg, device or self.device
        G = self.n_kv_heads_local
        shape = (n_layers, batch, G, max_len, cfg.d_head)
        sshape = (n_layers, batch, G, 1, cfg.d_head)
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

    def init_cache(self, batch: int, max_len: int, enc_len: Optional[int] = None,
                   kv_spec="auto") -> Dict[str, Any]:
        """Zero decode cache; ``enc_len`` sizes the encdec cross-attention
        cache (default ``max_len``); ``kv_spec`` overrides the format for
        allocation only (prefill/decode_step reject a mismatched cache).

        On a grid it is the rank's block of every leaf by ``cache_logical``
        and the grid's rules (``batch`` the whole batch): the batch over
        (pod, data) where they divide it, the KV sequence over model, the
        mamba states' channels over model where it divides them, every kv
        head; the scales keep their sequence axis of 1. The model axis must
        divide ``max_len`` (and ``enc_len``): the port always cuts the
        sequence, where the reference's lenient spec would replicate a
        cache of a length it does not divide on every rank."""
        spec = self.kv_spec if kv_spec == "auto" else validate_kv_spec(kv_spec)
        if spec is not None and self.cfg.family == "encdec":
            raise ValueError(
                "quantized KV cache is not supported for encdec: the "
                "legacy one-shot path owns its cross-attention cache")
        if self.grid is None:
            return self._cache_tree(batch, max_len, enc_len, spec, self.device)
        M = self.tp.size
        for n, what in ((max_len, "max_len"), (enc_len or max_len, "enc_len")):
            if n % M:
                raise ValueError(f"a grid's cache cuts its sequence over the model axis "
                                 f"({M} ranks), which does not divide {what}={n}")
        full = self._cache_tree(batch, max_len, enc_len, spec, "meta")
        grid = self.grid

        def block(name, t, logical):
            shape = grid.local_shape(grid.spec(logical, t.shape), t.shape)
            return torch.full(shape, 1 if name.endswith("_scale") else 0, dtype=t.dtype,
                              device=self.device)

        return map_with_logical(block, full, self.cache_logical(spec))

    def _cache_tree(self, batch: int, max_len: int, enc_len, spec, device):
        cfg = self.cfg
        cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
        if cfg.family in ("dense", "moe", "encdec"):
            cache["kv"] = self._kv_cache(batch, max_len, spec, cfg.n_layers, device)
            if cfg.family == "encdec":
                cache["cross"] = self._kv_cache(batch, enc_len or max_len, None,
                                                cfg.n_layers, device)
                cache["xlen"] = torch.zeros((), dtype=torch.int32, device=device)
            return cache
        cache["ssm"] = ssm.mamba_init_cache(cfg, cfg.n_layers, batch, device)
        if cfg.family == "hybrid":
            cache["shared_kv"] = self._kv_cache(batch, max_len, spec,
                                                len(self._hybrid_chunks()), device)
        return cache

    def cache_logical(self, kv_spec="auto") -> Dict[str, Any]:
        """Logical axes of every leaf of ``init_cache``'s tree (the
        reference's ``cache_logical`` on the port's layout, one L axis for
        every attention layer): the KV sequence is "kv_seq" (sharded over
        model on a grid's rules), its head axis "kv_heads_c" (the serving
        TP's); a quantized cache's scales share the codes' axes but the
        sequence. ``kv_spec`` names the cache's format (the model's by
        default)."""
        fam = self.cfg.family
        kv = {"k": ("layers", "batch", "kv_heads_c", "kv_seq", "head_dim"),
              "v": ("layers", "batch", "kv_heads_c", "kv_seq", "head_dim")}
        if (self.kv_spec if kv_spec == "auto" else kv_spec) is not None:
            kv["k_scale"] = ("layers", "batch", "kv_heads_c", None, "head_dim")
            kv["v_scale"] = ("layers", "batch", "kv_heads_c", None, "head_dim")
        out: Dict[str, Any] = {"pos": ()}
        if fam in ("dense", "moe", "encdec"):
            out["kv"] = kv
            if fam == "encdec":
                out["cross"] = {"k": kv["k"], "v": kv["v"]}
                out["xlen"] = ()
        elif fam == "ssm":
            out["ssm"] = {"conv": ("layers", "batch", "conv", "d_inner"),
                          "ssm": ("layers", "batch", "d_inner", "state")}
        else:
            out["ssm"] = {"conv": ("layers", "batch", "conv", "d_inner2"),
                          "ssm": ("layers", "batch", "heads_r", None, "state")}
            out["shared_kv"] = kv
        return out

    # -- paged cache ----------------------------------------------------------

    def _paged_pool(self, n_pages: int, page_size: int,
                    spec: Optional[QuantSpec]) -> Dict[str, torch.Tensor]:
        """Every layer's page pool: (L, n_pages, G, ps, Dh) pages (heads-major
        within a page, so a gather gives the dense cache's layout) and,
        quantized, ONE static per-channel scale leaf per layer, (L, G, 1, Dh)
        ones, global across pages: pages are shareable between requests only
        because every page quantizes under the same grid (paging.py)."""
        cfg, dev = self.cfg, self.device
        L, G, Dh = cfg.n_layers, self.n_kv_heads_local, cfg.d_head
        shape = (L, n_pages, G, page_size, Dh)
        if spec is not None:
            cdt = kv_code_dtype(spec)
            sshape = (L, G, 1, Dh)
            return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                    "k_scale": torch.ones(sshape, dtype=torch.float32, device=dev),
                    "v": torch.zeros(shape, dtype=cdt, device=dev),
                    "v_scale": torch.ones(sshape, dtype=torch.float32, device=dev)}
        kdt = (torch.bfloat16 if self.rcfg.kv_cache_dtype == "int8"
               else _dt(self.rcfg.kv_cache_dtype))
        return {"k": torch.zeros(shape, dtype=kdt, device=dev),
                "v": torch.zeros(shape, dtype=kdt, device=dev)}

    def _require_pageable(self) -> None:
        if self.grid is not None:
            raise ValueError("the paged cache is not served on a (pod, data, model) grid: "
                             "the reference has no paged serving on a production mesh")
        if self.cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"paged KV cache supports attention-only families "
                f"(dense/moe), not {self.cfg.family!r}: SSM recurrent "
                "state is O(1) per sequence (nothing to page) and cannot "
                "be position-shared, and encdec serves on the legacy "
                "one-shot path")

    def init_paged_cache(self, batch: int, max_len: int, *, n_pages: int,
                         page_size: int) -> Dict[str, Any]:
        """Paged decode cache: page pools + per-slot block tables.

        ``pages`` is the (batch, ceil(max_len / page_size)) block table of
        physical page ids (garbage page 0 when unallocated) that the host's
        ``launch.paging.PagedKVManager`` maintains; ``pos`` is the dense
        engine's per-slot length vector.
        """
        self._require_pageable()
        ps = int(page_size)
        if ps < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        max_pages = -(-int(max_len) // ps)
        dev = self.device
        return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "pages": torch.zeros((batch, max_pages), dtype=torch.int32,
                                     device=dev),
                "kv": self._paged_pool(int(n_pages), ps, self.kv_spec)}

    @staticmethod
    def _paged_page_size(cache) -> int:
        return int(cache["kv"]["k"].shape[-2])

    @torch.no_grad()
    def prefill_paged(self, params, tokens: torch.Tensor, *, cache, slot: int,
                      length, prefix_len: int = 0):
        """Admission prefill through the page pool (batch 1, one slot).

        ``tokens`` (1, S) is the context *suffix* (the part not already
        resident in shared pages), right-padded when S exceeds the true
        ``length``; ``prefix_len`` counts the shared resident tokens. The
        suffix attends to [prefix ; suffix] with the kv-chunk boundaries a
        dense prefill of the whole context would use, so the logits match
        the dense engine's, and writes its codes through slot's block-table
        row in place. Sets ``pos[slot]`` to ``prefix_len + length``.
        Returns (cache, last-token logits).
        """
        self._require_pageable()
        cfg, rcfg = self.cfg, self.rcfg
        self._check_cache_layout(cache)
        tokens = tokens.to(self.device)
        B, Sq = tokens.shape
        prefix_len = int(prefix_len)
        positions = (prefix_len + torch.arange(Sq, device=self.device))[None, :]
        positions = positions.expand(B, Sq)
        x = T.embed_tokens(params["embed"], tokens, self.act_dtype)
        row = cache["pages"][int(slot)]
        ps = self._paged_page_size(cache)
        for i, lp in enumerate(params["blocks"]):
            pp = {"pool": self.layer_cache(cache, i), "row": row,
                  "prefix_len": prefix_len, "page_size": ps}
            x, _ = T.block_forward(lp, x, cfg, rcfg, positions=positions,
                                   kernels=self.kernels, kv_spec=self.kv_spec,
                                   paged_prefill=pp, tp=self.tp)
        length = int(length)
        logits = self._logits(params, x[:, length - 1])
        cache["pos"][int(slot)] = prefix_len + length
        return cache, logits

    def _check_cache_layout(self, cache) -> None:
        if self.cfg.family == "encdec" and "cross" not in cache:
            raise ValueError("an encdec cache holds the cross-attention "
                             "cache too (init_cache(enc_len=...))")
        kv = cache.get("kv", cache.get("shared_kv"))
        if kv is None:                        # ssm: no attention, no KV
            return
        if "pages" in cache:
            self._require_pageable()
            for name in ("k_scale", "v_scale"):
                if name in kv and kv[name].ndim != 4:
                    raise ValueError(
                        f"paged cache {name} must be global per layer "
                        f"(L, G, 1, Dh); got {tuple(kv[name].shape)}")
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
    def layer_cache(cache, i: int, group: str = "kv") -> Dict[str, torch.Tensor]:
        """Views of layer ``i``'s leaves of ``cache[group]`` ("kv", "ssm",
        "shared_kv" or "cross"; writes land in ``cache``)."""
        return {name: leaf[i] for name, leaf in cache[group].items()}

    def _layer(self, params, key: str, i: Optional[int] = None):
        """``params[key]`` (``[i]``): a layer's parameters, on a grid
        gathered whole along their data-sharded dims (``_gather``)."""
        lp = params[key] if i is None else params[key][i]
        if self.grid is None:
            return lp
        return self._gather(lp, self._specs[key] if i is None else self._specs[key][i])

    def _mamba_layers(self, params, x, cache, first: int, n: int):
        """Run the ``n`` mamba layers from layer ``first`` and write their
        new recurrent states into ``cache["ssm"]`` in place (on a grid the
        rank's channels of them)."""
        variant = "mamba1" if self.cfg.family == "ssm" else "mamba2"
        tp = self.tp if self.grid is not None else None
        for j in range(first, first + n):
            lc = self.layer_cache(cache, j, "ssm")
            x, new = T.mamba_block_forward(self._layer(params, "blocks", j), x, self.cfg,
                                           cache=lc, kernels=self.kernels, variant=variant,
                                           tp=tp)
            for name, leaf in new.items():
                lc[name].copy_(leaf)
        return x

    def _layers(self, params, x, cache, attn):
        """Every layer in execution order; ``attn(layer params, x, layer
        cache)`` runs an attention block (a decoder layer, or hybrid's
        shared block with its chunk's cache). An encdec layer's cache also
        holds its cross cache, "xk" and "xv", and the encoder length "xlen"
        (the reference's merged layer cache)."""
        fam = self.cfg.family
        if fam == "ssm":
            return self._mamba_layers(params, x, cache, 0, self.cfg.n_layers)
        if fam == "hybrid":
            first = 0
            shared = self._layer(params, "shared")
            for ci, size in enumerate(self._hybrid_chunks()):
                x = attn(shared, x, self.layer_cache(cache, ci, "shared_kv"))
                x = self._mamba_layers(params, x, cache, first, size)
                first += size
            return x
        for i in range(len(params["blocks"])):
            lc = self.layer_cache(cache, i)
            if fam == "encdec":
                xc = self.layer_cache(cache, i, "cross")
                lc.update(xk=xc["k"], xv=xc["v"], xlen=cache["xlen"])
            x = attn(self._layer(params, "blocks", i), x, lc)
        return x

    # -- serving --------------------------------------------------------------

    def _final_norm(self, params, x: torch.Tensor, sp=None) -> torch.Tensor:
        ln_f = params["ln_f"] if sp is None else sp.copy_in(params["ln_f"])
        return rmsnorm(x, ln_f, self.cfg.norm_eps)

    def _logits(self, params, x: torch.Tensor, sp=None) -> torch.Tensor:
        x = self._final_norm(params, x, sp)
        if self.grid is not None:
            return self._grid_logits(params, x, sp)
        if self.cfg.tie_embeddings:
            # the reference's tied branch: the plain datapath, no kernels
            return matmul_param(x, param_value(params["embed"], x.dtype).transpose(0, 1))
        return matmul_param(x, params["unembed"], kernels=self.kernels)

    # -- training -------------------------------------------------------------

    def _gather(self, tree, specs):
        """A layer's (or one leaf's) parameters whole along their
        data-sharded dims (FSDP; the identity off a grid or at data = 1).
        A quantized leaf (served on a grid) gathers its code bytes and
        reads its scale's block (``nn.sharding.gather_quantized``)."""
        if self.grid is None:
            return tree
        if isinstance(tree, dict):
            return {k: self._gather(tree[k], specs[k]) for k in tree}
        if isinstance(tree, QuantizedTensor):
            return gather_quantized(tree, specs, self.grid)
        data = self.grid.axis("data")
        dims = [d for d, a in enumerate(specs) if a == "data"]
        return fsdp_gather(tree, data, dims[0]) if dims and data.size > 1 else tree

    def _embed(self, params, tokens: torch.Tensor, sp=None) -> torch.Tensor:
        """The embedding lookup; on a grid with the vocab over model, each
        rank looks up the tokens of its block of rows (the rest zero) and
        the rows are summed over model (under sequence parallelism ``sp``,
        reduce-scattered along seq: the rank keeps its block of positions;
        a table that every rank holds whole gives that block of the
        lookup)."""
        emb = params["embed"]
        if self.grid is None:
            return T.embed_tokens(emb, tokens, self.act_dtype)
        spec = self._specs["embed"]
        emb = self._gather(emb, spec)
        if spec[0] is None:
            x = T.embed_tokens(emb, tokens, self.act_dtype)
            return x if sp is None else take_block(x, sp, 1)
        n = (emb.codes if isinstance(emb, QuantizedTensor) else emb).shape[0]
        local = tokens - self.tp.rank * n
        inside = (local >= 0) & (local < n)
        rows = T.embed_tokens(emb, local.clamp(0, n - 1), self.act_dtype)
        rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))
        return self.tp.reduce_out(rows) if sp is None else scatter_seq(rows, sp)

    def _grid_logits(self, params, x: torch.Tensor, sp=None) -> torch.Tensor:
        """Logits on a grid: the rank's vocab block (``_grid_block_logits``)
        gathered over model; the whole vocab where it replicates."""
        logits, sharded = self._grid_block_logits(params, x, sp)
        return gather_replicated(logits, self.tp, logits.ndim - 1) if sharded else logits

    def _grid_block_logits(self, params, x: torch.Tensor, sp=None) -> Tuple[torch.Tensor, bool]:
        """(the logits of the rank's vocab block through its (data-gathered)
        unembed or embed shard, True), or (the whole vocab's, False) where
        the model axis does not cut the vocab. Under sequence parallelism
        (``sp``) x is the rank's block along seq, and the product reads the
        whole sequence (``seq_in``)."""
        if self.cfg.tie_embeddings:
            spec = self._specs["embed"]
            w = param_value(self._gather(params["embed"], spec), x.dtype).transpose(0, 1)
            sharded = spec[0] is not None
        else:
            spec = self._specs["unembed"]
            w = self._gather(params["unembed"], spec)
            sharded = spec[1] is not None
        return matmul_param(seq_in(x, sp, self.tp if sharded else None), w,
                            kernels=None if self.cfg.tie_embeddings else self.kernels), sharded

    def _remat(self):
        """``fn(*args)``, under ``torch.utils.checkpoint`` when
        ``rcfg.remat == "block"`` and gradients are on (the reference's
        ``jax.checkpoint`` of its ``scan_blocks`` body): the activations
        inside are recomputed in the backward."""
        if self.rcfg.remat == "block" and torch.is_grad_enabled():
            return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
        return lambda fn, *args: fn(*args)

    def forward(self, params, tokens: torch.Tensor, *, frames=None) -> torch.Tensor:
        """Full-sequence logits (B, S, padded vocab) for every family, each
        block called with ``positions`` and no cache. The remat unit is the
        reference's: a layer (dense, ssm; the encoder's and decoder's
        layers), a group of ``moe_every`` layers (moe: its dense layers,
        then its MoE layer), and for hybrid the shared block on its own at
        each application and each mamba2 layer (the shared block's gradient
        sums over its applications). encdec needs ``frames`` (B, Se,
        d_model): without them it stops where the reference's forward
        asserts, with its words. Under sequence parallelism (``seq_ctx``)
        the residual between the blocks is the rank's block along seq; the
        positions stay whole, as every sublayer attends over the whole
        sequence."""
        x, sp = self._trunk(params, tokens, frames)
        return self._logits(params, x, sp)

    def _trunk(self, params, tokens: torch.Tensor, frames=None):
        """``forward`` up to the final norm: (the residual after the last
        block, the sequence-parallel context it is cut by)."""
        cfg, rcfg = self.cfg, self.rcfg
        fam = cfg.family
        if fam == "encdec" and frames is None:
            raise AssertionError("encdec forward needs encoder frames")
        tokens = tokens.to(self.device).long()
        B, Sq = tokens.shape
        positions = torch.arange(Sq, device=self.device)[None, :].expand(B, Sq)
        sp = self.seq_ctx(Sq)
        x = self._embed(params, tokens, sp)
        run = self._remat()
        kw = dict(positions=positions, kernels=self.kernels, tp=self.tp, sp=sp)
        blocks = params["blocks"]
        # each layer's specs (FSDP's gathers) and, for an MoE layer, the
        # ranks that route the batch with this one
        specs = self._specs if self.grid is not None else {}
        block_specs = specs.get("blocks", [None] * len(blocks))
        batch = self.grid.axis(*self.batch_axes) if self.grid is not None else None

        def attn_block(lp, ls, h):
            return T.block_forward(self._gather(lp, ls), h, cfg, rcfg, batch=batch, **kw)[0]

        def mamba_block(lp, ls, h):
            return T.mamba_block_forward(self._gather(lp, ls), h, cfg, kernels=self.kernels,
                                         variant="mamba1" if fam == "ssm" else "mamba2",
                                         tp=self.tp, sp=sp)[0]

        def group(layers, lss, h):
            for lp, ls in zip(layers, lss):
                h = attn_block(lp, ls, h)
            return h

        if fam in ("dense", "moe"):
            k = cfg.moe_every if fam == "moe" else 1
            for g in range(0, len(blocks), k):
                x = run(group, blocks[g:g + k], block_specs[g:g + k], x)
        elif fam == "ssm":
            for lp, ls in zip(blocks, block_specs):
                x = run(mamba_block, lp, ls, x)
        elif fam == "hybrid":
            first = 0
            for size in self._hybrid_chunks():
                x = run(attn_block, params["shared"], specs.get("shared"), x)
                for lp, ls in zip(blocks[first:first + size], block_specs[first:first + size]):
                    x = run(mamba_block, lp, ls, x)
                first += size
        else:                                   # encdec
            xsp = self.seq_ctx(frames.shape[1])
            xa = self._encode(params, frames, xsp)

            def xblock(lp, ls, h, xa):
                return T.decoder_xblock_forward(self._gather(lp, ls), h, cfg, rcfg, xa=xa,
                                                xsp=xsp, **kw)[0]

            for lp, ls in zip(blocks, block_specs):
                x = run(xblock, lp, ls, x, xa)
        return x, sp

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean cross-entropy of ``batch["tokens"]``'s logits against
        ``batch["labels"]``, {"loss": the same}); encdec reads
        ``batch["frames"]``. As the reference's, it adds no MoE router
        loss (``moe.router_aux_loss`` is a function apart). On a grid whose
        model axis cuts the vocab, the loss is the reference's on the
        rank's vocab block of the logits (``vocab_parallel_ce``: three
        all-reduces of a float a row, no logits gathered); where the vocab
        replicates, ``ce_loss`` of the whole logits."""
        labels = batch["labels"].to(self.device)
        if self.grid is None:
            logits = self.forward(params, batch["tokens"], frames=batch.get("frames"))
            nll = ce_loss(logits, labels)
            return nll, {"loss": nll}
        x, sp = self._trunk(params, batch["tokens"], batch.get("frames"))
        logits, sharded = self._grid_block_logits(params, self._final_norm(params, x, sp), sp)
        nll = vocab_parallel_ce(logits, labels, self.tp) if sharded else ce_loss(logits, labels)
        return nll, {"loss": nll}

    def _encode(self, params, frames: torch.Tensor, xsp=None) -> torch.Tensor:
        """encdec: the encoder over (B, Se, d_model) frames, in the
        activation dtype; rotary over the frame positions, no causal mask,
        then ``enc_ln``. Each layer is remat'd as the decoder's are. Under
        sequence parallelism (``xsp``, the model axis where it cuts Se) the
        frames enter as the rank's block along Se, and the states leave
        so."""
        cfg, rcfg = self.cfg, self.rcfg
        xa = frames.to(self.device).to(self.act_dtype)
        B, Se, _ = xa.shape
        positions = torch.arange(Se, device=self.device)[None, :].expand(B, Se)
        if xsp is not None:
            xa = take_block(xa, xsp, 1)
        run = self._remat()
        enc = params["enc_blocks"]
        specs = self._specs["enc_blocks"] if self.grid is not None else [None] * len(enc)

        def layer(lp, ls, h):
            return T.dense_block_forward(self._gather(lp, ls), h, cfg, rcfg,
                                         positions=positions, causal=False,
                                         kernels=self.kernels, tp=self.tp, sp=xsp)[0]

        for lp, ls in zip(enc, specs):
            xa = run(layer, lp, ls, xa)
        enc_ln = params["enc_ln"] if xsp is None else xsp.copy_in(params["enc_ln"])
        return rmsnorm(xa, enc_ln, cfg.norm_eps)

    def _write_cross(self, lp, xa: torch.Tensor, lc) -> None:
        """encdec: the layer's static cross cache from the encoder states.
        The reference computes it through the plain datapath (its
        ``matmul_param`` there takes no ``use_kernel``) even when its
        prefill's cross-attention took the kernels; so does this."""
        B, Se, _ = xa.shape
        for name in ("k", "v"):
            w = lp["xattn"][f"w{name}"]
            t = matmul_param(xa, w).reshape(B, Se, -1, self.cfg.d_head)
            if self.grid is None:
                dst = lc[f"x{name}"]
                dst[:, :, :Se] = t.transpose(1, 2).to(dst.dtype)
                continue
            local = (w.codes if isinstance(w, QuantizedTensor) else w).shape[-2]
            tp = placed(self.tp, local, self.cfg.n_kv_heads)
            self._write_block(lc[f"x{name}"], t if tp is None else tp.all_gather(t, 2))

    def _write_block(self, dst: torch.Tensor, t: torch.Tensor) -> None:
        """A grid rank's block of positions of ``t`` (B, S, G, Dh), the K/V
        (or codes) of positions [0, S), into its layer cache ``dst`` (B, G,
        S_l, Dh), which holds positions [rank S_l, (rank + 1) S_l)."""
        S_l = dst.shape[2]
        start = self.tp.rank * S_l
        n = min(max(t.shape[1] - start, 0), S_l)
        if n:
            dst[:, :, :n] = t[:, start:start + n].transpose(1, 2).to(dst.dtype)

    def _rows(self, t, B: int):
        """The rank's rows (``GridContext.rows``) of ``t``, whose first dim
        is a batch of ``B`` rows; ``t`` as it is off a grid, or where it is
        None or has no such dim (one length for every row)."""
        if self.grid is None or t is None or not torch.is_tensor(t) \
                or t.ndim == 0 or t.shape[0] != B:
            return t
        r0, n = self.grid.rows(B)
        return t[r0:r0 + n]

    def _grid_serve_kw(self, B: int) -> Dict[str, Any]:
        """What a served block takes on a grid for a batch of ``B`` rows:
        the model axis that cuts the cache's sequence (``kv_seq``) and the
        ranks an MoE layer routes the batch with; nothing off a grid."""
        if self.grid is None:
            return {}
        return {"kv_seq": self.tp, "batch": self.grid.batch_group(B)}

    def _serve_logits(self, params, h: torch.Tensor, B: int) -> torch.Tensor:
        """The served rows' logits; on a grid every row of the batch of
        ``B`` rows, gathered over the ranks that hold the others."""
        logits = self._logits(params, h)
        if self.grid is None:
            return logits
        return self.grid.batch_group(B).all_gather(logits, 0)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, *, cache, frames=None,
                length=None):
        """Run the prompt, filling the cache. Returns (cache, last_logits).

        ``length`` (scalar or (B,)) marks the true prompt length when
        ``tokens`` is right-padded to a bucket: logits are taken at
        ``length-1`` and ``cache["pos"]`` becomes the per-sequence length.
        The ssm and hybrid families refuse it: the pad tokens would run
        into the recurrent state. Their prefill starts from the states in
        ``cache`` and writes the new ones in place. The encdec family
        encodes ``frames`` (B, Se, d_model) first, attends to them in every
        decoder layer, fills the cross cache and sets ``xlen`` to Se.

        On a grid every rank is given the whole batch (tokens, frames and a
        (B,) ``length``) and ``init_cache``'s block: it runs its rows
        (``GridContext.rows``) with the training forward's collectives (no
        remat, no gradient), writes its block of the prompt's positions
        into its cache, and returns the logits of every row of the batch
        (its vocab block gathered over model, its rows over (pod, data)).
        """
        cfg, rcfg = self.cfg, self.rcfg
        self._check_cache_layout(cache)
        if length is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                "bucketed prefill (length=) is attention-family only: "
                "right-padding pollutes the SSM recurrent state")
        tokens = tokens.to(self.device)
        B_all = tokens.shape[0]
        tokens = self._rows(tokens, B_all)
        xa = None
        if cfg.family == "encdec":
            if frames is None:
                raise ValueError("encdec prefill needs the encoder frames")
            xa = self._encode(params, self._rows(frames.to(self.device), B_all))
        if length is not None:
            length = self._rows(torch.as_tensor(length, device=self.device), B_all)
        B, Sq = tokens.shape
        positions = torch.arange(Sq, device=self.device)[None, :].expand(B, Sq)
        x = self._embed(params, tokens)
        quant = self.kv_spec is not None
        grid = self._grid_serve_kw(B_all)

        def attn(lp, x, lc):
            if xa is not None:
                x, kv = T.decoder_xblock_forward(lp, x, cfg, rcfg, positions=positions,
                                                 xa=xa, kernels=self.kernels, tp=self.tp,
                                                 kv_seq=grid.get("kv_seq"))
                self._write_cross(lp, xa, lc)
            else:
                scales = ({"k_scale": lc["k_scale"], "v_scale": lc["v_scale"]}
                          if quant else None)
                x, kv = T.block_forward(lp, x, cfg, rcfg, positions=positions,
                                        kernels=self.kernels, kv_spec=self.kv_spec,
                                        kv_scales=scales, tp=self.tp, **grid)
            for name in ("k", "v"):
                if grid:
                    self._write_block(lc[name], kv[name])
                    continue
                dst = lc[name]
                dst[:, :, :Sq] = kv[name].transpose(1, 2).to(dst.dtype)
            return x

        x = self._layers(params, x, cache, attn)
        if length is None:
            last = x[:, -1]
            pos = torch.tensor(Sq, dtype=torch.int32, device=self.device)
        else:
            pos = torch.as_tensor(length, device=self.device).to(
                torch.int32).reshape(-1).expand(B).clone()
            last = x[torch.arange(B, device=self.device), pos.long() - 1]
        logits = self._serve_logits(params, last, B_all)
        cache = dict(cache, pos=pos)
        if xa is not None:
            cache["xlen"] = torch.tensor(xa.shape[1], dtype=torch.int32,
                                         device=self.device)
        return cache, logits

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor):
        """One decode step. tokens: (B, 1). Returns (cache, logits (B, V)).

        ``cache["pos"]`` is a scalar or (B,) per-slot lengths; rotary
        positions, the KV write and the attention mask follow it per slot.
        A paged cache (``"pages"`` in it) is read and written through its
        block tables. The layer caches (KV and recurrent states) are
        updated in place; the returned dict carries ``pos + 1``. An encdec
        layer's cross-attention reads its static cross cache, masked at
        ``xlen``.

        On a grid every rank is given the whole batch's tokens and its block
        of the cache (``prefill``'s): it runs its rows, writes the new
        token's K/V on the rank that owns its position, attends over its
        block of positions and merges the blocks' softmaxes across the
        model group (``attention._grid_attn``), and returns the logits of
        every row.
        """
        cfg, rcfg = self.cfg, self.rcfg
        self._check_cache_layout(cache)
        B_all = tokens.shape[0]
        tokens = self._rows(tokens.to(self.device), B_all)
        B = tokens.shape[0]
        pos = cache["pos"]
        positions = pos.reshape(-1, 1).expand(B, 1)
        x = self._embed(params, tokens)
        paged = self._grid_serve_kw(B_all)
        if "pages" in cache:
            # the blocks read and write the page pool through the per-slot
            # block tables instead of per-slot rows
            paged = {"pages": cache["pages"],
                     "page_size": self._paged_page_size(cache)}

        def attn(lp, x, lc):
            if "xk" in lc:
                return T.decoder_xblock_forward(
                    lp, x, cfg, rcfg, positions=positions, cache=lc, cache_pos=pos,
                    kernels=self.kernels, tp=self.tp, kv_seq=paged.get("kv_seq"))[0]
            return T.block_forward(lp, x, cfg, rcfg, positions=positions,
                                   cache=lc, cache_pos=pos, kernels=self.kernels,
                                   kv_spec=self.kv_spec, tp=self.tp, **paged)[0]

        x = self._layers(params, x, cache, attn)
        return dict(cache, pos=pos + 1), self._serve_logits(params, x[:, 0], B_all)


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


class TensorSpec(NamedTuple):
    """A tensor's shape and dtype, nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape) -> Dict[str, TensorSpec]:
    """The abstract global batch of one (arch, shape) cell: train/prefill
    {tokens, labels[, frames]}, decode {tokens (B, 1)}."""
    B, Sq = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": TensorSpec((B, Sq), i32), "labels": TensorSpec((B, Sq), i32)}
        if cfg.family == "encdec":
            spec["frames"] = TensorSpec((B, Sq, cfg.d_model), torch.bfloat16)
        return spec
    return {"tokens": TensorSpec((B, 1), i32)}


def build_model(cfg: ModelConfig, rcfg: RunConfig, *, device="cuda",
                use_kernel: bool = False, kv_spec=None,
                kernel_set: KernelSet = KERNELS,
                tp: Optional[TPContext] = None,
                grid: Optional[GridContext] = None) -> LM:
    """The model (one rank's, given a TPContext ``tp`` of size > 1 for
    serving, or a training ``grid``)."""
    return LM(cfg, rcfg, device=device, use_kernel=use_kernel,
              kv_spec=kv_spec, kernel_set=kernel_set, tp=tp or TPContext(), grid=grid)
