"""Deterministic synthetic LM data + binary memmap reader.

A numpy copy of ``repro/data/pipeline.py`` (the port imports nothing of
the reference package): the same batches, files and windows.

Synthetic stream: Zipf-distributed unigrams overlaid with *induction
patterns* — each sequence repeats a randomly drawn motif of length
``motif_len`` with period ``motif_len`` — so a real LM has signal to learn
(copy heads drive the loss well below the unigram entropy). Batches are a
pure function of (seed, step, host_id): restarts and elastic re-shards
reproduce the exact stream with no data loss, and each host generates only
its own shard (no cross-host traffic, 1000-node posture).

TokenFileReader memory-maps a flat uint16/uint32 token file and serves
fixed-length windows; the same host-sharding contract applies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "synthetic_batch", "synthetic_batches",
           "write_token_file", "TokenFileReader"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.3
    motif_len: int = 8
    motif_prob: float = 0.8      # fraction of sequences carrying a motif


def _zipf_probs(vocab: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    return p / p.sum()


def _batch_rng(cfg: DataConfig, step: int, host_id: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))


def synthetic_batch(cfg: DataConfig, step: int, *, host_id: int = 0,
                    n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """One deterministic {tokens, labels} batch (host shard)."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global batch {cfg.global_batch} does not split over {n_hosts} hosts")
    b = cfg.global_batch // n_hosts
    rng = _batch_rng(cfg, step, host_id)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_alpha)
    # +1 so labels are a clean shift of the same stream.
    toks = rng.choice(cfg.vocab_size, size=(b, cfg.seq_len + 1), p=probs)
    has_motif = rng.random(b) < cfg.motif_prob
    motifs = rng.choice(cfg.vocab_size, size=(b, cfg.motif_len), p=probs)
    reps = int(np.ceil((cfg.seq_len + 1) / cfg.motif_len))
    tiled = np.tile(motifs, (1, reps))[:, : cfg.seq_len + 1]
    toks = np.where(has_motif[:, None], tiled, toks).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def synthetic_batches(cfg: DataConfig, *, start_step: int = 0,
                      host_id: int = 0, n_hosts: int = 1
                      ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, host_id=host_id, n_hosts=n_hosts)
        step += 1


# ---------------------------------------------------------------------------
# Binary token file (memmap)
# ---------------------------------------------------------------------------


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Flat little-endian token file with a tiny self-describing header."""
    tokens = np.asarray(tokens)
    dtype = np.uint16 if tokens.max() < 2**16 else np.uint32
    with open(path, "wb") as f:
        f.write(b"RPTK")
        f.write(np.asarray([1 if dtype == np.uint16 else 2, tokens.size],
                           dtype="<u8").tobytes())
        f.write(tokens.astype(f"<{np.dtype(dtype).str[1:]}").tobytes())


class TokenFileReader:
    """Memory-mapped fixed-window reader over a flat token file.

    Window w of host h at step s is a pure function of (s, h): windows are
    laid out round-robin across hosts, wrapping at the end — deterministic
    resume by step, no shuffle buffer state to checkpoint.
    """

    def __init__(self, path: str, seq_len: int, batch: int, *,
                 host_id: int = 0, n_hosts: int = 1):
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != b"RPTK":
                raise ValueError(f"bad token file {path!r}")
            kind, size = np.frombuffer(f.read(16), dtype="<u8")
        dtype = np.uint16 if kind == 1 else np.uint32
        self._data = np.memmap(path, dtype=f"<{np.dtype(dtype).str[1:]}",
                               mode="r", offset=20, shape=(int(size),))
        self.seq_len = seq_len
        self.batch = batch
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.n_windows = (int(size) - 1) // seq_len
        if self.n_windows <= 0:
            raise ValueError(f"token file {path!r} holds no {seq_len}-token window")

    def read_batch(self, step: int) -> Dict[str, np.ndarray]:
        idx = (step * self.batch * self.n_hosts
               + self.host_id * self.batch
               + np.arange(self.batch)) % self.n_windows
        tok = np.stack([self._data[i * self.seq_len: i * self.seq_len
                                   + self.seq_len + 1] for i in idx])
        tok = tok.astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
