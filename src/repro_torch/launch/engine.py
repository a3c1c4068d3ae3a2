"""Continuous-batching serving engine: slot scheduler + chunked decode.

Port of ``repro/launch/engine.py`` (dense cache, single device):

* **Slots.** ``n_slots`` sequences share one decode cache whose ``pos`` is
  a per-slot (B,) length vector; ``decode_step`` rotates, writes KV and
  masks attention per slot.
* **Admission.** A request is prefilled alone (batch 1, optionally padded
  to a length bucket) into a batch-1 cache that carries the slot's static
  KV scales, and that cache is copied into the slot. The first token comes
  from the prefill logits.
* **Decode.** ``chunk`` steps run as an eager loop on the device (the
  reference's ``lax.scan``) with no host synchronisation inside the chunk;
  a slot that hits EOS or its token budget freezes (pos stops, pad tokens
  are emitted) until the host retires it between chunks. The cache is
  updated in place (the reference donates it).
* **Eviction.** ``evict`` returns a running request to the head of the
  queue with its generated prefix folded into the context; re-admission
  prefills prompt+prefix and continues the identical greedy stream.

Sampling is greedy. Temperature and top-k need a torch threefry that
reproduces the reference's PRNG streams (ROADMAP A6); until then a
request with ``temperature > 0`` raises.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["SamplingParams", "Request", "RequestState", "ServeEngine"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0     # 0 = greedy (argmax); > 0 is not ported yet


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


class ServeEngine:
    """Slot-based continuous batching over one ``LM`` + its parameters."""

    def __init__(self, model, params, *, n_slots: int = 4, max_len: int = 512,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 chunk: int = 8, prompt_bucket: int = 1):
        if n_slots < 1 or chunk < 1:
            raise ValueError(
                f"need n_slots >= 1 and chunk >= 1, got {n_slots}/{chunk}")
        self.model, self.params = model, params
        self.device = model.device
        self.n_slots, self.max_len = int(n_slots), int(max_len)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.chunk = int(chunk)
        self.prompt_bucket = max(1, int(prompt_bucket))
        self.cache = model.init_cache(n_slots, max_len)
        self.cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                        device=self.device)
        self._tok = torch.full((n_slots, 1), self.pad_id, dtype=torch.int64,
                               device=self.device)
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
        if req.sampling.temperature > 0:
            raise ValueError(
                f"request {req.rid}: temperature > 0 needs the torch "
                "threefry sampler that reproduces the reference's streams "
                "(ROADMAP A6), which is not ported yet; serve greedy "
                "(temperature 0)")
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

    def _admit(self, rid: int, slot: int) -> None:
        st = self._states[rid]
        ctx = st.context
        P = int(ctx.size)
        Pb = min(-(-P // self.prompt_bucket) * self.prompt_bucket, self.max_len)
        padded = np.full((1, Pb), self.pad_id, np.int64)
        padded[0, :P] = ctx
        t0 = time.perf_counter()
        small = self.model.init_cache(1, self.max_len)
        kv = self.cache["kv"]
        for name in small["kv"]:
            if name.endswith("_scale"):
                # static scales are calibration state: the slot's own
                # scales drive the admission prefill
                small["kv"][name].copy_(kv[name][:, slot:slot + 1])
        length = None if Pb == P else torch.tensor(P, dtype=torch.int32)
        small, logits = self.model.prefill(
            self.params, torch.from_numpy(padded).to(self.device),
            cache=small, length=length)
        for name, leaf in small["kv"].items():
            kv[name][:, slot] = leaf[:, 0]
        self.cache["pos"][slot] = small["pos"].reshape(-1)[0]
        tok0 = torch.argmax(logits, dim=-1)          # (1,)
        self._tok[slot, 0] = tok0[0]
        tok0 = int(tok0[0])                          # synchronises
        self.prefill_time += time.perf_counter() - t0

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

    def _finish(self, rid: int, reason: str) -> None:
        st = self._states[rid]
        st.finish_reason = reason
        st.finished_at = self.clock
        if st.slot >= 0:
            self._slot_rid[st.slot] = -1
            st.slot = -1
        self._done_box.append(st)

    # -- device chunk ----------------------------------------------------------

    @torch.no_grad()
    def _chunk(self, done, n_gen, max_new, *, steps: int, eos: int) -> torch.Tensor:
        """``steps`` greedy decode iterations with per-slot stopping; the
        emitted-token semantics mirror the host loop in ``step``."""
        toks = []
        cache, tok = self.cache, self._tok
        for _ in range(steps):
            pos = cache["pos"]
            cache, logits = self.model.decode_step(self.params, cache, tok)
            nxt = torch.argmax(logits, dim=-1)
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
        max_new = np.full(B, np.iinfo(np.int32).max, np.int64)
        for b, rid in enumerate(self._slot_rid):
            if rid < 0:
                continue
            st = self._states[rid]
            n_gen[b] = len(st.out)
            max_new[b] = self._eff_max_new(st)
        eos = self.eos_id if self.eos_id is not None else -1
        rem = int((max_new[live] - n_gen[live]).max())
        steps = min(steps, 1 << max(rem - 1, 0).bit_length())

        t0 = time.perf_counter()
        dev = self.device
        toks = self._chunk(torch.from_numpy(~live).to(dev),
                           torch.from_numpy(n_gen).to(dev),
                           torch.from_numpy(max_new).to(dev),
                           steps=steps, eos=int(eos))
        toks = toks.cpu().numpy()                    # synchronises
        self.decode_time += time.perf_counter() - t0
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
        return {
            "requests": len(self._states),
            "generated_tokens": gen,
            "prefill_sampled_tokens": self.n_prefill_sampled,
            "decode_tokens": n_dec,
            "decode_steps": self.decode_steps,
            "prefill_time_s": self.prefill_time,
            "decode_time_s": self.decode_time,
            "decode_tok_per_s": n_dec / self.decode_time if self.decode_time else 0.0,
        }
