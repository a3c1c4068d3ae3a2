"""Kernel benchmark: every hand-written kernel against its plain version.

The port's twin of ``benchmarks/bench_kernels.py``:

    PYTHONPATH=src python -m repro_torch.bench.kernels [--smoke] \\
        [--device cuda|cpu] [--out DIR]

Each row holds a kernel's time, its plain version's, a library call's (one
PyTorch call that computes the same function, where there is one), the
least time the card could take for the same work (``bound_ms``, by bytes or
operations) and the largest difference from the plain version beside its
tolerance (``ok`` is that check). pofx_matmul and fxp_matmul rows add the
kernel's and the library's times after a flush that leaves the L2 clean
(``*_clean_l2``, see ``common.Timer``); fxp_matmul rows also carry the
split's ``slice_len`` and ``slices``. pofx_decode rows time ``copy_`` of the
codes into a buffer (``copy_ms``): the same bytes read and written by one
PyTorch kernel, a yardstick of the memory rate the card reaches at that
size. The rows:

(a) the reference bench's sweep: pofx_decode at 128x256, 257x130 and
    512x512 for (N, ES) = (8, 2) and (6, 1), exact; pofx_matmul at
    64x128x96 and 130x257x66; fxp_matmul at 96x160x64, exact;
(b) the kernels at yi-9b serving shapes: pofx_matmul at m = 4 (decode) and
    m = 64 (prefill), and at m = 1 on the unembed (a prefill's last
    position), and fxp_matmul at the mlp shapes, m = 4 and 64;
    kv_flash_decode and kv_flash_paged_decode at 4 slots, S = 96, ~1000
    and 4096 (with the split's chunk and count), G = 4 groups of R = 8
    query rows; and at moonshot-v1-16b-a3b serving shapes: pofx_matmul at
    m = 1, 4 and 64 on q/k/v/o, the shared experts' gate/up and down and
    the unembed, both flash-decode kernels (fxp8) at G = 16, R = 1; and at
    the ssm and hybrid serving shapes: pofx_matmul at m = 4 and 64 on
    falcon-mamba-7b's in_proj, out_proj and unembed and on zamba2-1.2b's
    in_proj (n = 8384, a half-filled last 128-column tile), out_proj, shared
    q/k/v/o, wi, wo and unembed, and at m = 1 on both unembeds; both
    flash-decode kernels (fxp8) at zamba2's G = 32, R = 1, Dh = 64; and
    pofx_matmul at whisper-medium's q/k/v/o (self and cross), wi, wo and
    unembed at m = 4 (decode, and the one-shot prefill's unembed) and m =
    256 (the one-shot prefill: 4 sequences x 64 positions, encoder and
    decoder); both flash-decode kernels (fxp8) at nemotron-4-340b's G = 8,
    R = 12, Dh = 192 (two row groups of 8 a (b, g)); and at the shapes a
    rank serves at tensor parallelism tp = 2: pofx_matmul at m = 4 and 64 on
    yi-9b's, moonshot's and zamba2's weight shards (``TP2_SHAPES_POFX``) and
    both flash-decode kernels (fxp8) at yi-9b's G = 2, R = 8; and at a
    (data 2, model 2) grid rank's block of yi-9b's cache, kv_flash_decode
    with its lse output (``GRID_KV_SHAPES``, local lengths of 0 included);
(c) pofx_decode at the five yi-9b weight shapes, (N, ES) = (8, 2), and at
    the mlp shape with (9, 2).

Before the rows run exhaustive checks: pofx_decode, and pofx_matmul's
decode, on every code of every pofx spec (N = 6..8, ES = 1..3), pofx_decode
on every byte at every (N, ES, M) it accepts, and on ragged and strided
shapes. ``--smoke`` runs the checks and the reference bench's smoke subset
of (a). The default device is the card, where every wrapper launches its
kernel (there is no fallback). With ``--device cpu`` the wrappers compute
their plain versions, so the plain versions alone are timed, on the host
clock (``plain_cpu_ms``), and the kernel, plain, library and bound columns
stay empty. The rows go to
``<out>/kernels.csv`` (``--out``, else ``$REPRO_BENCH_OUT``, else
``chiprun_out/bench/``).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

from repro_torch.core.pofx import pofx_norm_lut
from repro_torch.core.policy import parse_spec
from repro_torch.core.quantizers import kv_dequantize, kv_quantize
from repro_torch.kernels.fxp_matmul import fxp_matmul, fxp_matmul_ref
from repro_torch.kernels.fxp_matmul import plan as fxp_plan
from repro_torch.kernels.kv_flash_decode import kv_flash_decode, kv_flash_decode_ref
from repro_torch.kernels.kv_flash_decode import plan as kv_plan
from repro_torch.kernels.kv_flash_paged_decode import (kv_flash_paged_decode,
                                                       kv_flash_paged_decode_ref)
from repro_torch.kernels.pofx_decode import pofx_decode, pofx_decode_ref
from repro_torch.kernels.pofx_matmul import pofx_matmul, pofx_matmul_ref
from repro_torch.kernels.ref import gather_pages
from .common import Timer, bound_ms, nvidia_smi, write_csv

__all__ = ["SHAPES_POFX", "MOE_SHAPES_POFX", "SSM_SHAPES_POFX",
           "WHISPER_SHAPES_POFX", "TP2_SHAPES_POFX", "POFX_SPECS", "run", "main"]

# yi-9b weight shapes (k, n): q/o, k/v, gate/up, down, unembed
SHAPES_POFX = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096), (4096, 64000)]
FXP_SHAPES = [(4096, 11008), (11008, 4096)]   # the mlp projections
# moonshot-v1-16b-a3b's kernel shapes (k, n): q/k/v/o, shared gate/up,
# shared down, unembed (the expert products are plain PyTorch)
MOE_SHAPES_POFX = [(2048, 2048), (2048, 2816), (2816, 2048), (2048, 163840)]
# falcon-mamba-7b's kernel shapes (k, n): in_proj, out_proj, unembed; then
# zamba2-1.2b's: in_proj, out_proj, the shared block's q/k/v/o, wi, wo and
# the unembed (x_proj, dt_proj and the mixers are plain PyTorch)
SSM_SHAPES_POFX = [(4096, 16384), (8192, 4096), (4096, 65024),
                   (2048, 8384), (4096, 2048), (2048, 2048), (2048, 8192), (8192, 2048),
                   (2048, 32000)]
SSM_UNEMBEDS = [(4096, 65024), (2048, 32000)]
# whisper-medium's kernel shapes (k, n): q/k/v/o (self and cross), wi, wo,
# the unembed (vocab 51865 padded to 51968)
WHISPER_SHAPES_POFX = [(1024, 1024), (1024, 4096), (4096, 1024), (1024, 51968)]
# a rank's weight shards at tp = 2 (k, n): yi-9b's q, k/v, attention o (k
# halved), gate/up and down; moonshot's q/k/v, o and shared experts' gate/up
# and down (zamba2's q/k/v and o are moonshot's, its wi and wo yi-9b's
# attention o and q)
TP2_SHAPES_POFX = [(4096, 2048), (4096, 256), (2048, 4096), (4096, 5504), (5504, 4096),
                   (2048, 1024), (1024, 2048), (2048, 1408), (1408, 2048)]
POFX_SPECS = [(N, ES) for N in (6, 7, 8) for ES in (1, 2, 3)]
# every (N, ES, M) pofx_decode accepts
DECODE_PARAMS = [(N, ES, M) for N in range(3, 10) for ES in range(5) for M in range(1, 9)]
KV_SHAPES = ((96, [65, 80, 90, 96]), (1000, [1, 333, 999, 1000]),
             (4096, [1, 1365, 4095, 4096]))   # the last: yi-9b's 4096-token context
# a grid rank's block of positions (chip_smoke's phase 21: model rank 1 of
# 2 holds positions 128-255 of 256, or 2048-4095 of 4096) and the local
# lengths clamp(pos + 1 - start, 0, S) of rows before, inside and past it
GRID_KV_SHAPES = ((128, [0, 37, 100, 128]), (2048, [0, 0, 0, 0]))


def log(msg: str) -> None:
    print(msg, flush=True)


class KernelBench:
    """Rows of one benchmark run on ``device``."""

    def __init__(self, device, timer: Optional[Timer] = None):
        self.dev = torch.device(device)
        self.card = self.dev.type == "cuda"
        self.timer = timer or Timer(self.dev)
        self.g = torch.Generator(device=self.dev).manual_seed(0)
        self.device_name = torch.cuda.get_device_name(self.dev) if self.card else "cpu"
        self.rows: List[Dict] = []

    def add(self, name: str, shape: str, *, err: float, tol: float, kernel, plain,
            library=None, library_name: Optional[str] = None, nbytes: float = 0.0,
            ops: float = 0.0, kind: str = "f32", **extra) -> Dict:
        """Check ``err <= tol`` (raise otherwise), then time and record.
        ``extra`` values that are callables are timed on the card."""
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: max |err| {err} > {tol}")
        row = {"name": name, "shape": shape, "device": self.device_name,
               "max_abs_err": err, "tol": tol, "ok": True, "ms": None, "plain_ms": None,
               "library_ms": None, "library": None, "bound_ms": None, "bound_by": None}
        if not self.card:
            row["plain_cpu_ms"] = self.timer.ms(plain)
        else:
            row["ms"], row["plain_ms"] = self.timer.ms(kernel), self.timer.ms(plain)
            if library is not None:
                row["library_ms"], row["library"] = self.timer.ms(library), library_name
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, kind)
        for key, val in extra.items():
            if callable(val):
                val = self.timer.ms(val, clean=key.endswith("clean_l2")) if self.card else None
            row[key] = val
        self.rows.append(row)
        log(f"  {row}")
        return row

    def randint(self, lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=self.g, device=self.dev, dtype=dtype)

    def randn(self, *shape):
        return torch.randn(*shape, generator=self.g, device=self.dev)

    # -- exhaustive checks ------------------------------------------------------

    def check_decode(self) -> Dict[str, int]:
        """pofx_decode and pofx_matmul's decode on every code of every pofx
        spec, pofx_decode on every byte at every (N, ES, M) its wrapper
        accepts, and on ragged and strided shapes: exact."""
        dev, n_specs = self.dev, 0
        for N, ES in POFX_SPECS:
            L = 1 << (N - 1)
            codes = torch.arange(L, device=dev, dtype=torch.uint8)[None].expand(L, L).contiguous()
            lut = torch.as_tensor(pofx_norm_lut(N, ES, 8), device=dev)
            if not torch.equal(pofx_decode(codes, N, ES).long(), lut[None].expand(L, L).long()):
                raise AssertionError(f"pofx_decode differs at N={N} ES={ES}")
            got = pofx_matmul(torch.eye(L, device=dev), codes, torch.ones(L, device=dev), N, ES, 8)
            if not torch.equal(got, (lut.float() / 128)[None].expand(L, L)):
                raise AssertionError(f"pofx_matmul decode differs at N={N} ES={ES}")
            n_specs += 1
        every = torch.arange(256, device=dev, dtype=torch.uint8).reshape(16, 16)
        n_params = 0
        for N, ES, M in DECODE_PARAMS:
            if not torch.equal(pofx_decode(every, N, ES, M), pofx_decode_ref(every, N, ES, M)):
                raise AssertionError(f"pofx_decode differs at N={N} ES={ES} M={M}")
            n_params += 1
        shapes = [(257, 130), (1, 17), (33, 1), (3, 4099), (129, 4096)]
        for r, c in shapes:
            codes = self.randint(0, 256, (r, c), torch.uint8)
            if not torch.equal(pofx_decode(codes, 8, 2), pofx_decode_ref(codes, 8, 2)):
                raise AssertionError(f"pofx_decode differs at {r}x{c}")
        base = self.randint(0, 256, (257, 160), torch.uint8)
        views = {"rows of stride 160": base[:, :130], "rows off by one byte": base[:, 1:131],
                 "transposed": base.t()}
        for what, v in views.items():
            if not torch.equal(pofx_decode(v, 7, 1), pofx_decode_ref(v, 7, 1)):
                raise AssertionError(f"pofx_decode differs on {what}")
        log(f"  pofx_decode and pofx_matmul decode: all codes of pofx(N=6..8, ES=1..3) exact; "
            f"pofx_decode exact on every byte at all {n_params} accepted (N, ES, M), at "
            f"{', '.join(f'{r}x{c}' for r, c in shapes)} and on {', '.join(views)} views")
        return {"specs": n_specs, "decode_params": n_params, "ragged_shapes": len(shapes),
                "views": len(views)}

    # -- rows -----------------------------------------------------------------

    def pofx_decode_row(self, r: int, c: int, N: int, ES: int, M: int = 8) -> Dict:
        codes = self.randint(0, 1 << (N - 1), (r, c), torch.uint8)
        got = pofx_decode(codes, N, ES, M)
        want = pofx_decode_ref(codes, N, ES, M)
        lut = torch.as_tensor(pofx_norm_lut(N, ES, M), device=self.dev).to(torch.int8)

        def library():      # long indices: a uint8 index tensor is a boolean mask
            return lut[codes.long()]
        err = float((got.int() - want.int()).abs().max())
        if not torch.equal(library(), want):
            raise AssertionError(f"table lookup differs from pofx_decode_ref at {r}x{c}")
        buf = torch.empty_like(codes)
        return self.add("pofx_decode", f"{r}x{c} ({N},{ES})", err=err, tol=0.0,
                        kernel=lambda: pofx_decode(codes, N, ES, M),
                        plain=lambda: pofx_decode_ref(codes, N, ES, M),
                        library=library, library_name="lut_i8[codes.long()]",
                        nbytes=2 * r * c, kind="int8",
                        copy_ms=lambda: buf.copy_(codes))

    def pofx_matmul_row(self, m: int, k: int, n: int, x_dtype, shape: str) -> Dict:
        x = self.randn(m, k).to(x_dtype)
        codes = self.randint(0, 128, (k, n), torch.uint8)
        scale = torch.exp2(self.randint(-4, 0, (n,), torch.int64).float())
        got = pofx_matmul(x, codes, scale, 8, 2, 8)
        want = pofx_matmul_ref(x, codes, scale, 8, 2, 8)
        err = (got - want).abs().max().item()
        # f32 sums of k products in another order than the plain version's:
        # 1e-4 of the largest output
        tol = 1e-4 * want.abs().max().item()
        w = (torch.as_tensor(pofx_norm_lut(8, 2, 8), device=self.dev)[codes.long()].float()
             / 128 * scale).to(x_dtype)
        xb = 2 if x_dtype == torch.bfloat16 else 4
        kind = "bf16" if x_dtype == torch.bfloat16 else "f32"
        return self.add("pofx_matmul", shape, err=err, tol=tol,
                        kernel=lambda: pofx_matmul(x, codes, scale, 8, 2, 8),
                        plain=lambda: pofx_matmul_ref(x, codes, scale, 8, 2, 8),
                        library=lambda: torch.matmul(x, w),
                        library_name=f"torch.matmul {kind} on decoded weights",
                        nbytes=m * k * xb + k * n + n * 4 + m * n * 4, ops=2 * m * k * n,
                        kind=kind,
                        ms_clean_l2=lambda: pofx_matmul(x, codes, scale, 8, 2, 8),
                        library_ms_clean_l2=lambda: torch.matmul(x, w))

    def fxp_matmul_row(self, m: int, k: int, n: int, shape: str) -> Dict:
        """Exact against the plain version. The library is ``torch._int_mm``
        where it takes the shape (k and n multiples of 8); it needs more than
        16 rows, so below that it runs on ``a`` padded with zero rows to 32
        (padded outside the timer) and its first m rows are checked."""
        a = self.randint(-127, 128, (m, k), torch.int8)
        b = self.randint(-128, 128, (k, n), torch.int8)
        got = fxp_matmul(a, b)
        want = fxp_matmul_ref(a, b)
        err = float((got.double() - want.double()).abs().max())
        lib = name = None
        if k % 8 == 0 and n % 8 == 0:    # what torch._int_mm takes
            a_lib = a
            if m <= 16:
                a_lib = torch.zeros((32, k), dtype=torch.int8, device=self.dev)
                a_lib[:m] = a
            lib = lambda: torch._int_mm(a_lib, b)      # noqa: E731
            name = "torch._int_mm" + ("" if a_lib is a else " (a padded to 32 rows)")
            if not torch.equal(lib()[:m], want):
                raise AssertionError(f"torch._int_mm differs from fxp_matmul_ref at {shape}")
        return self.add("fxp_matmul", shape, err=err, tol=0.0,
                        kernel=lambda: fxp_matmul(a, b), plain=lambda: fxp_matmul_ref(a, b),
                        library=lib, library_name=name,
                        nbytes=m * k + k * n + m * n * 4, ops=2 * m * k * n, kind="int8",
                        **fxp_plan(m, k, n)._asdict(),
                        ms_clean_l2=lambda: fxp_matmul(a, b),
                        library_ms_clean_l2=lib)

    def kv_flash_decode_row(self, spec_s: str, S: int, pos_list, G: int = 4,
                            R: int = 8, Dh: int = 128, lse: bool = False) -> Dict:
        """One kv_flash_decode row; ``lse`` calls it with its log-sum-exp
        output, held against the plain version's (raising beyond 1e-5 +
        1e-5 |lse|), at the shapes of a grid rank's block of positions
        (a length of 0: a block past a row's position)."""
        spec = parse_spec(spec_s)
        B = 4
        dev = self.dev
        q = self.randn(B, G, R, Dh)
        ks = torch.exp2(self.randint(0, 2, (B, G, 1, Dh), torch.int64).float())
        vs = torch.exp2(self.randint(0, 2, (B, G, 1, Dh), torch.int64).float())
        kc = kv_quantize(self.randn(B, G, S, Dh), spec, ks)
        vc = kv_quantize(self.randn(B, G, S, Dh), spec, vs)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        args = (q, kc, ks, vc, vs, pos, spec)
        if lse:
            (got, got_lse), (want, want_lse) = (kv_flash_decode(*args, with_lse=True),
                                                kv_flash_decode_ref(*args, with_lse=True))
            lse_err = (got_lse - want_lse).abs()
            # an empty row's lse is -inf in both
            if not ((got_lse == want_lse) | (lse_err <= 1e-5 + 1e-5 * want_lse.abs())).all():
                raise AssertionError(f"kv_flash_decode's lse {spec_s} S={S} pos={pos_list} "
                                     f"differs from the plain version's by "
                                     f"{lse_err.max().item()}")
        else:
            got = kv_flash_decode(*args)
            want = kv_flash_decode_ref(*args)
        err = (got - want).abs().max().item()
        # f32 online softmax vs a one-pass softmax: a few ulps of |v|
        tol = 1e-5 + 1e-4 * want.abs().max().item()
        kf = kv_dequantize(kc, spec, ks)
        vf = kv_dequantize(vc, spec, vs)
        mask = (torch.arange(S, device=dev)[None, :] < pos[:, None].long())[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # the slots' valid positions; a length of 0 (only in the lse rows: a
        # block wholly past the slot's position) reads nothing, not even q
        live = [min(p, S) for p in pos_list if p > 0]
        valid = sum(live)
        nbytes = (2 * G * valid * Dh + len(live) * (G * R * Dh * 4 + 2 * G * Dh * 4)
                  + B * G * R * Dh * 4 + B * 4 + (B * G * R * 4 if lse else 0))
        kw = {"with_lse": True} if lse else {}
        return self.add("kv_flash_decode", ("lse " if lse else "")
                        + f"{spec_s} B={B} G={G} R={R} S={S} Dh={Dh} pos={pos_list}",
                        err=err, tol=tol, kernel=lambda: kv_flash_decode(*args, **kw),
                        plain=lambda: kv_flash_decode_ref(*args, **kw),
                        library=lambda: sdpa(q, kf, vf, attn_mask=mask),
                        library_name="scaled_dot_product_attention on dequantized K/V",
                        nbytes=nbytes, ops=4 * G * R * valid * Dh, kind="f32",
                        **kv_plan(B, G, S)._asdict())

    def kv_flash_paged_decode_row(self, spec_s: str, S: int, pos_list, G: int = 4,
                                  R: int = 8, Dh: int = 128) -> Dict:
        """ps = 16, tables scrambled so that no slot's pages are contiguous
        in the pool, garbage page 0 past each slot's pages; also against
        kv_flash_decode on the gathered cache (bit for bit)."""
        spec = parse_spec(spec_s)
        B, ps = 4, 16
        dev, g = self.dev, self.g
        mp = -(-S // ps)
        n_pages = B * mp + 1
        q = self.randn(B, G, R, Dh)
        ks = torch.exp2(self.randint(0, 2, (G, 1, Dh), torch.int64).float())
        vs = torch.exp2(self.randint(0, 2, (G, 1, Dh), torch.int64).float())
        kc = kv_quantize(self.randn(n_pages, G, ps, Dh), spec, ks)
        vc = kv_quantize(self.randn(n_pages, G, ps, Dh), spec, vs)
        tables = torch.zeros(B, mp, dtype=torch.int32, device=dev)
        used = [-(-p // ps) for p in pos_list]
        for b in range(B):   # slot b owns pages 1+b+B*j in a random order
            order = torch.randperm(mp, generator=g, device=dev)[:used[b]]
            tables[b, :used[b]] = (1 + b + B * order).to(torch.int32)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        args = (q, kc, ks, vc, vs, tables, pos, spec)
        got = kv_flash_paged_decode(*args)
        want = kv_flash_paged_decode_ref(*args)
        err = (got - want).abs().max().item()
        tol = 1e-5 + 1e-4 * want.abs().max().item()
        kg, vg = gather_pages(kc, tables), gather_pages(vc, tables)
        ksb, vsb = ks[None].expand(B, G, 1, Dh), vs[None].expand(B, G, 1, Dh)
        dense_err = (got - kv_flash_decode(q, kg, ksb, vg, vsb, pos, spec)).abs().max().item()
        if dense_err != 0.0:
            raise AssertionError(f"kv_flash_paged_decode {spec_s} S={S} differs from "
                                 f"kv_flash_decode on the gathered cache by {dense_err}")

        def gather_dequant():
            return (kv_dequantize(gather_pages(kc, tables), spec, ks[None]),
                    kv_dequantize(gather_pages(vc, tables), spec, vs[None]))
        kf, vf = gather_dequant()
        Sg = mp * ps
        mask = (torch.arange(Sg, device=dev)[None, :] < pos[:, None].long())[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        valid = sum(min(p, Sg) for p in pos_list)
        nbytes = (2 * G * valid * Dh + 4 * sum(used) + 2 * B * G * R * Dh * 4
                  + 2 * G * Dh * 4 + B * 4)
        return self.add(
            "kv_flash_paged_decode",
            f"{spec_s} B={B} G={G} R={R} ps={ps} pages={mp} S={Sg} Dh={Dh} pos={pos_list}",
            err=err, tol=tol, kernel=lambda: kv_flash_paged_decode(*args),
            plain=lambda: kv_flash_paged_decode_ref(*args),
            library=lambda: sdpa(q, kf, vf, attn_mask=mask),
            library_name="scaled_dot_product_attention on K/V gathered and dequantized "
                         "(gather not timed)",
            nbytes=nbytes, ops=4 * G * R * valid * Dh, kind="f32",
            **kv_plan(B, G, Sg)._asdict(),
            max_abs_diff_dense_kernel=dense_err,
            dense_kernel_ms=lambda: kv_flash_decode(q, kg, ksb, vg, vsb, pos, spec),
            gather_dequant_ms=gather_dequant)


def run(device="cuda", *, smoke: bool = False, timer: Optional[Timer] = None) -> List[Dict]:
    """The checks, then every row; returns the rows (raises on a check)."""
    bench = KernelBench(device, timer)
    log(f"kernel benchmark on {bench.device_name}"
        + ("" if bench.card else ": the wrappers take their plain versions on CPU "
           "tensors, so only the plain versions are timed (host clock)"))
    bench.check_decode()
    # (a) the reference bench's sweep (its smoke subset with --smoke)
    for r, c in ((128, 256), (257, 130)) if smoke else ((128, 256), (257, 130), (512, 512)):
        for N, ES in ((8, 2),) if smoke else ((8, 2), (6, 1)):
            bench.pofx_decode_row(r, c, N, ES)
    for m, k, n in ((64, 128, 96),) if smoke else ((64, 128, 96), (130, 257, 66)):
        bench.pofx_matmul_row(m, k, n, torch.float32, f"{m}x{k}x{n} (8,2)")
    bench.fxp_matmul_row(96, 160, 64, "96x160x64")
    if smoke:
        return bench.rows
    # (b) the serving shapes
    for m in (4, 64):
        for k, n in SHAPES_POFX:
            bench.pofx_matmul_row(m, k, n, torch.bfloat16, f"m={m} k={k} n={n} x=bf16")
    k, n = SHAPES_POFX[-1]      # the prefill's unembed: its last position only
    bench.pofx_matmul_row(1, k, n, torch.bfloat16, f"m=1 k={k} n={n} x=bf16")
    for m in (4, 64):
        for k, n in FXP_SHAPES:
            bench.fxp_matmul_row(m, k, n, f"m={m} k={k} n={n}")
    for spec_s in ("fxp8", "pofx8es2"):
        for S, pos_list in KV_SHAPES:
            bench.kv_flash_decode_row(spec_s, S, pos_list)
    for spec_s in ("fxp8", "pofx8es2"):
        for S, pos_list in KV_SHAPES:
            bench.kv_flash_paged_decode_row(spec_s, S, pos_list)
    # moonshot: its kernels' weight shapes, and 16 groups of one query row
    for m in (1, 4, 64):
        for k, n in MOE_SHAPES_POFX:
            bench.pofx_matmul_row(m, k, n, torch.bfloat16, f"m={m} k={k} n={n} x=bf16")
    for S, pos_list in KV_SHAPES:
        bench.kv_flash_decode_row("fxp8", S, pos_list, G=16, R=1)
        bench.kv_flash_paged_decode_row("fxp8", S, pos_list, G=16, R=1)
    # falcon-mamba-7b and zamba2-1.2b: their kernels' weight shapes, and
    # zamba2's shared attention, 32 groups of one query row, Dh = 64
    for m in (4, 64):
        for k, n in SSM_SHAPES_POFX:
            bench.pofx_matmul_row(m, k, n, torch.bfloat16, f"m={m} k={k} n={n} x=bf16")
    for k, n in SSM_UNEMBEDS:
        bench.pofx_matmul_row(1, k, n, torch.bfloat16, f"m=1 k={k} n={n} x=bf16")
    for S, pos_list in KV_SHAPES:
        bench.kv_flash_decode_row("fxp8", S, pos_list, G=32, R=1, Dh=64)
        bench.kv_flash_paged_decode_row("fxp8", S, pos_list, G=32, R=1, Dh=64)
    # whisper-medium's one-shot loop: m = 4 a decode step, m = 256 in its prefill
    for m in (4, 256):
        for k, n in WHISPER_SHAPES_POFX:
            bench.pofx_matmul_row(m, k, n, torch.bfloat16, f"m={m} k={k} n={n} x=bf16")
    # nemotron-4-340b's attention: 8 groups of 12 query rows, Dh = 192
    for S, pos_list in KV_SHAPES:
        bench.kv_flash_decode_row("fxp8", S, pos_list, G=8, R=12, Dh=192)
        bench.kv_flash_paged_decode_row("fxp8", S, pos_list, G=8, R=12, Dh=192)
    # tp = 2: a rank's weight shards, and yi-9b's 2 kv groups a rank
    for m in (4, 64):
        for k, n in TP2_SHAPES_POFX:
            bench.pofx_matmul_row(m, k, n, torch.bfloat16, f"m={m} k={k} n={n} x=bf16 tp2")
    for S, pos_list in KV_SHAPES:
        bench.kv_flash_decode_row("fxp8", S, pos_list, G=2, R=8)
        bench.kv_flash_paged_decode_row("fxp8", S, pos_list, G=2, R=8)
    # a (data 2, model 2) grid rank's block of yi-9b's cache, with the lse
    # output: 4 of 8 slots, 128 (or 2048) of 256 (4096) positions
    for S, pos_list in GRID_KV_SHAPES:
        bench.kv_flash_decode_row("fxp8", S, pos_list, lse=True)
    # (c) pofx_decode at the yi-9b weight shapes; at the mlp shape also with
    # N = 9, whose 256-byte table has two words a bank (N = 8: one)
    for k, n in SHAPES_POFX:
        bench.pofx_decode_row(k, n, 8, 2)
    bench.pofx_decode_row(*FXP_SHAPES[0], 9, 2)
    return bench.rows


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="the exhaustive checks and the reference's smoke rows only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None,
                    help="output directory (default: $REPRO_BENCH_OUT or chiprun_out/bench)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("repro_torch.bench.kernels: no CUDA card (torch.cuda."
                             "is_available() is False); --device cpu times the plain "
                             "versions")
        log(nvidia_smi())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rows = run(args.device, smoke=args.smoke)
    path = write_csv("kernels", rows, args.out)
    log(f"{len(rows)} rows, all within tolerance -> {path}")
    return rows


if __name__ == "__main__":
    main()
