"""Continuous-batching serving engine: slot scheduler + chunked decode.

Port of ``repro/launch/engine.py`` (dense cache, single device):

* **Slots.** ``n_slots`` sequences share one decode cache whose ``pos`` is
  a per-slot (B,) length vector; ``decode_step`` rotates, writes KV and
  masks attention per slot.
* **Admission.** A request is prefilled alone (batch 1, optionally padded
  to a length bucket) into a batch-1 cache that carries the slot's static
  KV scales, and that cache is copied into the slot: every leaf that holds
  the batch on axis 1 (KV, the ssm and hybrid families' recurrent states,
  hybrid's shared-block KV). The first token comes from the prefill
  logits. The ssm and hybrid families prefill exact lengths only (a
  padded prompt would run into the recurrent state), so they refuse a
  prompt bucket above 1, as the reference does.
* **Decode.** ``chunk`` steps run as an eager loop on the device (the
  reference's ``lax.scan``) with no host synchronisation inside the chunk;
  a slot that hits EOS or its token budget freezes (pos stops, pad tokens
  are emitted) until the host retires it between chunks. The cache is
  updated in place (the reference donates it).
* **Sampling.** Greedy (temperature 0), temperature and top-k compose per
  slot (``sample_tokens``). Each request's key is the engine key folded
  with its rid, and every draw folds that key with the absolute position
  of the token's input (``core.prng``, the reference's threefry), so a
  request draws the reference's stream whatever the batch around it, and
  dense, paged and resumed admissions draw alike. The draw runs on the
  logits' device; a chunk whose live slots are all greedy takes the plain
  ``argmax``.
* **Eviction.** ``evict`` returns a running request to the head of the
  queue with its generated prefix folded into the context; re-admission
  prefills prompt+prefix and continues the stream. (A re-prefilled
  recurrent state is not bit-identical to one carried by decode steps, so
  an ssm or hybrid stream may part there, in the reference too.)
* **Paged mode** (``paged=True``). The per-slot dense cache becomes one
  pool of fixed-size token pages plus per-slot block tables; the host's
  ``launch.paging.PagedKVManager`` owns allocation, refcounts and the
  radix prefix index. Admission matches the context against the index,
  copies a borrowed page the suffix will write into (copy-on-write) and
  prefills only the unshared suffix; finish and eviction register the
  sequence's pages in the index and drop its references, so a resume
  re-attaches the surviving pages and re-prefills one token. Token
  streams are the dense engine's.
* **Tensor parallelism.** Over a rank's model (``build_model(...,
  tp=TPContext)``) each rank runs its own engine on its shard with the same
  requests, keys and call order; the all-reduces inside the model give
  every rank the same logits, so the host scheduler, replicated, never
  sees the rank count. Every first token and every chunk's tokens are
  checked equal to rank 0's (``TPContext.check_equal``): a rank that
  diverges raises on every rank instead of hanging.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.policy import format_spec
from .paging import PagedKVManager

__all__ = ["SamplingParams", "Request", "RequestState", "ServeEngine",
           "sample_tokens"]

NEG_INF = -1e30
# the dense cache's groups of per-slot leaves, batch on axis 1
SLOT_GROUPS = ("kv", "ssm", "shared_kv")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs; all compose per slot in the chunk."""
    temperature: float = 0.0     # 0 = greedy (argmax)
    top_k: int = 0               # 0 = no truncation


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int token ids
    max_new: int = 32            # tokens to generate (incl. prefill-sampled)
    sampling: SamplingParams = SamplingParams()
    arrival: float = 0.0         # virtual time (decode steps) of arrival


@dataclasses.dataclass
class RequestState:
    req: Request
    context: np.ndarray          # tokens to prefill (prompt, +prefix on resume)
    slot: int = -1
    out: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None   # "eos" | "length"
    admitted_at: float = -1.0
    finished_at: float = -1.0
    n_evictions: int = 0

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temps: torch.Tensor, topks: torch.Tensor,
                  use_topk: bool = True) -> torch.Tensor:
    """Per-slot greedy / temperature / top-k sampling.

    logits (B, V); keys (B, 2) ``core.prng`` keys; temps (B,) f32 (0 =
    greedy); topks (B,) int (0 = the full distribution). Greedy slots
    ignore their key. ``use_topk=False`` promises every topk is 0 and skips
    the sort. Logits below a slot's k-th largest are filtered to NEG_INF
    (ties with the k-th are kept), the rest divided by the temperature in
    f32, and the draw is the gumbel-max ``prng.categorical``.
    """
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    if use_topk:
        k = topks.clamp(1, V).to(torch.int64)
        sorted_lg = torch.sort(logits, dim=-1).values      # ascending
        kth = torch.gather(sorted_lg, -1, (V - k)[:, None])
        filt = torch.where((topks[:, None] > 0) & (logits < kth), NEG_INF,
                           logits)
    else:
        filt = logits
    scaled = filt / temps.clamp_min(1e-6)[:, None]
    sampled = prng.categorical(keys, scaled)
    return torch.where(temps > 0, sampled, greedy)


class ServeEngine:
    """Slot-based continuous batching over one ``LM`` + its parameters."""

    def __init__(self, model, params, *, n_slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 chunk: int = 8, prompt_bucket: int = 1, seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None):
        if model.cfg.family == "encdec":
            raise NotImplementedError(
                "encdec serving needs per-request encoder frames; use the "
                "one-shot path in repro_torch.launch.serve (--legacy)")
        if prompt_bucket > 1 and model.cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                "prompt_bucket > 1 right-pads prefill, which pollutes SSM "
                "recurrent state; use exact-length prefill (bucket 1)")
        if n_slots < 1 or chunk < 1:
            raise ValueError(
                f"need n_slots >= 1 and chunk >= 1, got {n_slots}/{chunk}")
        self.model, self.params = model, params
        self.device = model.device
        # tensor parallelism: only the agreement checks see the context
        tp = getattr(model, "tp", None)
        self._tp = tp if tp is not None and tp.size > 1 else None
        self.n_slots, self.max_len = int(n_slots), int(max_len)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.chunk = int(chunk)
        self.prompt_bucket = max(1, int(prompt_bucket))
        self.paged = bool(paged)
        if self.paged:
            # default pool: the dense cache's capacity (every slot can hold
            # max_len tokens) plus per-slot headroom for copy-on-write and
            # index retention, plus the garbage page
            self.page_size = int(page_size)
            self.max_pages = -(-self.max_len // self.page_size)
            if n_pages is None:
                n_pages = n_slots * self.max_pages + n_slots + 1
            self.n_pages = int(n_pages)
            self.cache = model.init_paged_cache(
                n_slots, max_len, n_pages=self.n_pages, page_size=self.page_size)
            # pages are shareable only between consumers of one cache format
            k = self.cache["kv"]["k"]
            spec_key = (format_spec(model.kv_spec) if model.kv_spec else
                        "raw:" + str(k.dtype).replace("torch.", ""))
            self._pager = PagedKVManager(self.n_pages, self.page_size,
                                         self.max_pages, spec_key)
            self._slot_pos = np.zeros(n_slots, np.int64)
        else:
            self.cache = model.init_cache(n_slots, max_len)
            self.cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                            device=self.device)
        self._tok = torch.full((n_slots, 1), self.pad_id, dtype=torch.int64,
                               device=self.device)
        self._base_key = prng.PRNGKey(seed, self.device)
        # placeholder slot keys, replaced at admission (a fold stream apart
        # from the per-request keys, which fold non-negative rids)
        filler = prng.fold_in(self._base_key, 0xFFFFFFFF)
        self._keys = prng.fold_in(filler.expand(n_slots, 2),
                                  torch.arange(n_slots, device=self.device))
        self._slot_rid = np.full(n_slots, -1, np.int64)
        self._states: Dict[int, RequestState] = {}
        self._pending: Deque[int] = deque()
        self._done_box: List[RequestState] = []
        self.clock = 0.0
        self.prefill_time = 0.0
        self.decode_time = 0.0
        self.total_time = 0.0
        self.decode_steps = 0
        self.n_prefill_sampled = 0

    # -- scheduler (host) ----------------------------------------------------

    @property
    def free_slots(self) -> List[int]:
        return [b for b in range(self.n_slots) if self._slot_rid[b] < 0]

    @property
    def active_rids(self) -> List[int]:
        return [int(r) for r in self._slot_rid if r >= 0]

    @property
    def pending_rids(self) -> List[int]:
        return list(self._pending)

    def submit(self, req: Request) -> None:
        if req.rid in self._states:
            raise ValueError(f"duplicate request id {req.rid}")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if prompt.size >= self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt length {prompt.size} >= "
                f"max_len {self.max_len}")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        self._states[req.rid] = RequestState(req=req, context=prompt)
        self._pending.append(req.rid)

    def evict(self, rid: int) -> None:
        """Preempt a running request back to the head of the pending queue;
        its generated prefix folds into the context."""
        st = self._states[rid]
        if st.slot < 0 or st.done:
            raise ValueError(f"request {rid} is not running")
        st.context = np.concatenate(
            [np.asarray(st.req.prompt, np.int32).reshape(-1),
             np.asarray(st.out, np.int32)])
        if self.paged:
            self._release_slot_pages(rid, st)
        self._slot_rid[st.slot] = -1
        st.slot = -1
        st.n_evictions += 1
        self._pending.appendleft(rid)

    def admit_ready(self) -> int:
        """Admit arrived pending requests (FIFO among arrived) into free
        slots; returns the count."""
        n = 0
        while self.free_slots:
            rid = next((r for r in self._pending
                        if self._states[r].req.arrival <= self.clock), None)
            if rid is None:
                break
            self._pending.remove(rid)
            self._admit(rid, self.free_slots[0])
            n += 1
        return n

    def _eff_max_new(self, st: RequestState) -> int:
        """max_new clamped so decode never writes past max_len."""
        return min(st.req.max_new,
                   self.max_len - int(np.asarray(st.req.prompt).size))

    def _admit_paged(self, rid: int, slot: int) -> None:
        """Paged admission: match the prefix index, attach the shared pages,
        copy a borrowed page the suffix writes into, prefill only the
        unshared suffix through the pool."""
        st = self._states[rid]
        ctx = st.context
        P = int(ctx.size)
        Pb = min(-(-P // self.prompt_bucket) * self.prompt_bucket, self.max_len)
        t0 = time.perf_counter()
        # bucketed prompts page-align the prefix hit as the reference does
        # (there to bound compile variants; here to serve the same tokens)
        plan = self._pager.admit(rid, ctx.tolist(), Pb,
                                 page_align=self.prompt_bucket > 1)
        prefix_len = int(plan.prefix_len)
        kv = self.cache["kv"]
        for src, dst in plan.copies:
            for name in ("k", "v"):
                kv[name][:, dst] = kv[name][:, src]
        self.cache["pages"][slot] = torch.from_numpy(plan.table).to(self.device)
        n_suffix = P - prefix_len
        padded = np.full((1, Pb - prefix_len), self.pad_id, np.int64)
        padded[0, :n_suffix] = ctx[prefix_len:]
        self.cache, logits = self.model.prefill_paged(
            self.params, torch.from_numpy(padded).to(self.device),
            cache=self.cache, slot=slot, length=n_suffix,
            prefix_len=prefix_len)
        # index the prompt's pages so concurrent and later requests with the
        # same prefix skip its prefill (writes past P touch only offsets
        # beyond the registered valid run)
        self._pager.register(rid, ctx.tolist(), P)
        self._slot_pos[slot] = P
        self._finish_admit(rid, slot, P, logits, t0)

    def _admit(self, rid: int, slot: int) -> None:
        if self.paged:
            return self._admit_paged(rid, slot)
        st = self._states[rid]
        ctx = st.context
        P = int(ctx.size)
        Pb = min(-(-P // self.prompt_bucket) * self.prompt_bucket, self.max_len)
        padded = np.full((1, Pb), self.pad_id, np.int64)
        padded[0, :P] = ctx
        t0 = time.perf_counter()
        small = self.model.init_cache(1, self.max_len)
        groups = [g for g in SLOT_GROUPS if g in small]
        for g in groups:
            for name, leaf in small[g].items():
                if name.endswith("_scale"):
                    # static scales are calibration state: the slot's own
                    # scales drive the admission prefill
                    leaf.copy_(self.cache[g][name][:, slot:slot + 1])
        length = None if Pb == P else torch.tensor(P, dtype=torch.int32)
        small, logits = self.model.prefill(
            self.params, torch.from_numpy(padded).to(self.device),
            cache=small, length=length)
        for g in groups:
            for name, leaf in small[g].items():
                self.cache[g][name][:, slot] = leaf[:, 0]
        self.cache["pos"][slot] = small["pos"].reshape(-1)[0]
        self._finish_admit(rid, slot, P, logits, t0)

    def _finish_admit(self, rid: int, slot: int, P: int,
                      logits: torch.Tensor, t0: float) -> None:
        """Shared admission tail: the first token from the prefill logits
        (a sampled one draws with the request key folded with the absolute
        position P-1, so dense, paged and resumed admissions draw alike),
        slot state, immediate retirement on eos/length."""
        st = self._states[rid]
        key = prng.fold_in(self._base_key, rid)
        sp = st.req.sampling
        if sp.temperature > 0:
            dev = logits.device
            tok0 = sample_tokens(
                logits, prng.fold_in(key, P - 1)[None],
                torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
                torch.tensor([sp.top_k], dtype=torch.int64, device=dev))
        else:
            tok0 = torch.argmax(logits, dim=-1)      # (1,)
        self._tok[slot, 0] = tok0[0]
        self._keys[slot] = key
        tok0 = int(tok0[0])                          # synchronises
        self.prefill_time += time.perf_counter() - t0
        if self._tp is not None:
            self._tp.check_equal(f"request {rid}'s first token", tok0)

        self._slot_rid[slot] = rid
        st.slot = slot
        if st.admitted_at < 0:
            st.admitted_at = self.clock
        st.out.append(tok0)
        self.n_prefill_sampled += 1
        if self.eos_id is not None and tok0 == self.eos_id:
            self._finish(rid, "eos")
        elif len(st.out) >= self._eff_max_new(st):
            self._finish(rid, "length")

    def _release_slot_pages(self, rid: int, st: RequestState) -> None:
        """Index the slot's pages (full pages + partial tail) for later
        prefix hits, return the sequence's references, and point the slot's
        block-table row at the garbage page so the retired slot's zombie
        decode writes (it rides in the batch until the next admission)
        cannot touch a live page. Valid tokens = written KV positions = the
        slot's pos (the last emitted token's KV is never written)."""
        slot = st.slot
        tokens = np.concatenate(
            [np.asarray(st.req.prompt, np.int32).reshape(-1),
             np.asarray(st.out, np.int32)])
        self._pager.suspend(rid, tokens.tolist(), int(self._slot_pos[slot]))
        self.cache["pages"][slot] = 0

    def _finish(self, rid: int, reason: str) -> None:
        st = self._states[rid]
        st.finish_reason = reason
        st.finished_at = self.clock
        if st.slot >= 0:
            if self.paged:
                self._release_slot_pages(rid, st)
            self._slot_rid[st.slot] = -1
            st.slot = -1
        self._done_box.append(st)

    # -- device chunk ----------------------------------------------------------

    @torch.no_grad()
    def _chunk(self, done, n_gen, max_new, temps, topks, *, steps: int,
               eos: int, greedy_only: bool, topk_any: bool) -> torch.Tensor:
        """``steps`` decode iterations with per-slot stopping; the
        emitted-token semantics mirror the host loop in ``step``.
        ``greedy_only`` (every live slot at temperature 0, decided on the
        host per chunk) takes the argmax without drawing; otherwise each
        step folds the slot keys with the slots' positions and samples."""
        toks = []
        cache, tok = self.cache, self._tok
        for _ in range(steps):
            pos = cache["pos"]
            cache, logits = self.model.decode_step(self.params, cache, tok)
            if greedy_only:
                nxt = torch.argmax(logits, dim=-1)
            else:
                nxt = sample_tokens(logits, prng.fold_in(self._keys, pos),
                                    temps, topks, use_topk=topk_any)
            stop = (nxt == eos) | (n_gen + 1 >= max_new)
            nxt = torch.where(done, torch.full_like(nxt, self.pad_id), nxt)
            n_gen = torch.where(done, n_gen, n_gen + 1)
            cache = dict(cache, pos=torch.where(done, pos, pos + 1))
            done = done | stop
            tok = nxt[:, None]
            toks.append(nxt)
        self.cache, self._tok = cache, tok
        return torch.stack(toks)                     # (steps, B)

    def step(self, steps: Optional[int] = None) -> List[RequestState]:
        """Run one decode chunk; returns requests finished in it. The chunk
        is capped at the largest remaining per-slot budget, rounded up to a
        power of two (as the reference does to bound its recompiles)."""
        steps = int(steps or self.chunk)
        B = self.n_slots
        live = self._slot_rid >= 0
        if not live.any():
            return []
        n_gen = np.zeros(B, np.int64)
        temps = np.zeros(B, np.float32)
        topks = np.zeros(B, np.int64)
        max_new = np.full(B, np.iinfo(np.int32).max, np.int64)
        for b, rid in enumerate(self._slot_rid):
            if rid < 0:
                continue
            st = self._states[rid]
            n_gen[b] = len(st.out)
            temps[b] = st.req.sampling.temperature
            topks[b] = st.req.sampling.top_k
            max_new[b] = self._eff_max_new(st)
        eos = self.eos_id if self.eos_id is not None else -1
        rem = int((max_new[live] - n_gen[live]).max())
        steps = min(steps, 1 << max(rem - 1, 0).bit_length())

        if self.paged:
            # page coverage for every live slot's worst-case advance in this
            # chunk, allocated on the host before the chunk runs
            for b, rid in enumerate(self._slot_rid):
                if rid < 0:
                    continue
                row = self._pager.ensure(
                    rid, min(int(self._slot_pos[b]) + steps, self.max_len))
                if row is not None:
                    self.cache["pages"][b] = torch.from_numpy(row).to(self.device)

        t0 = time.perf_counter()
        dev = self.device
        toks = self._chunk(torch.from_numpy(~live).to(dev),
                           torch.from_numpy(n_gen).to(dev),
                           torch.from_numpy(max_new).to(dev),
                           torch.from_numpy(temps).to(dev),
                           torch.from_numpy(topks).to(dev),
                           steps=steps, eos=int(eos),
                           greedy_only=bool((temps == 0).all()),
                           topk_any=bool((topks > 0).any()))
        toks = toks.cpu().numpy()                    # synchronises
        self.decode_time += time.perf_counter() - t0
        if self._tp is not None:
            self._tp.check_equal("a decode chunk's tokens", toks)
        self.decode_steps += steps
        self.clock += steps

        finished: List[RequestState] = []
        for b, rid in enumerate(self._slot_rid):
            if rid < 0:
                continue
            st = self._states[rid]
            limit = self._eff_max_new(st)
            for s in range(steps):
                t = int(toks[s, b])
                st.out.append(t)
                if self.paged:
                    # the device's pos advances once per emitted token and
                    # must be current before _finish releases the pages
                    self._slot_pos[b] += 1
                if self.eos_id is not None and t == self.eos_id:
                    self._finish(rid, "eos")
                    break
                if len(st.out) >= limit:
                    self._finish(rid, "length")
                    break
            if st.done:
                finished.append(st)
        return finished

    def run(self, requests: Sequence[Request],
            chunk: Optional[int] = None) -> List[RequestState]:
        """Serve a workload to completion; returns states sorted by rid.
        Arrival times are in decode steps of virtual time."""
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            self.submit(r)
        t0 = time.perf_counter()
        while self._pending or self.active_rids:
            self.admit_ready()
            if not self.active_rids:
                self.clock = max(self.clock, min(
                    self._states[rid].req.arrival for rid in self._pending))
                continue
            self.step(chunk)
        self.total_time = time.perf_counter() - t0
        done, self._done_box = self._done_box, []
        return sorted(done, key=lambda s: s.req.rid)

    def stats(self) -> Dict[str, Any]:
        gen = sum(len(s.out) for s in self._states.values())
        n_dec = gen - self.n_prefill_sampled
        out = {
            "requests": len(self._states),
            "generated_tokens": gen,
            "prefill_sampled_tokens": self.n_prefill_sampled,
            "decode_tokens": n_dec,
            "decode_steps": self.decode_steps,
            "prefill_time_s": self.prefill_time,
            "decode_time_s": self.decode_time,
            "decode_tok_per_s": n_dec / self.decode_time if self.decode_time else 0.0,
        }
        if self.paged:
            out.update(self._pager.stats())
        return out
