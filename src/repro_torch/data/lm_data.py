"""Deterministic, restartable, elastic LM token stream (the twin of
``repro.data.lm_data``).

Every (step, global_row) cell of the logical batch grid is drawn from a
``torch.Generator`` seeded by a 64-bit mix of ``(seed, step, global_row)``:
no filesystem state, no iterator to checkpoint.  So

* restart-at-step-k reproduces exactly the batches an uninterrupted run
  would have seen;
* changing the shard count re-slices the *same* logical stream: the
  shards' rows concatenated are the global batch;
* no host reads ahead of any other.

The rows follow the reference's recipe (a Zipf-ish mixture with Markov
"topic" drift, so that losses fall measurably), but the draws are the CPU
generator's, not JAX's threefry bits: the two packages' streams differ
(ROADMAP.md §3).  Rows are drawn on the host, so a stream gives the same
batches on every device, and each batch is moved to the device the caller
names (the card unless another is named).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import torch

from repro_torch.data.table import resolve_device

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class StreamConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_shards == 0
        return self.global_batch // self.n_shards


def _mix(*vals: int) -> int:
    """A 64-bit seed from integers: each folded in by splitmix64's finalizer."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (v & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return h


def _row(cfg: StreamConfig, step: int, row: int) -> torch.Tensor:
    """``seq_len + 1`` tokens of one global row at one step."""
    g = torch.Generator().manual_seed(_mix(cfg.seed, step, row))
    V, n = cfg.vocab, cfg.seq_len + 1
    u = torch.rand(n, generator=g)
    topic = torch.randint(0, max(V // 16, 1), (), generator=g)
    zipf = (u * u * V).to(torch.int64)
    drift = torch.rand(n, generator=g) < 0.35
    toks = torch.where(drift, (topic + zipf % 17) % V, zipf)
    return torch.clamp(toks, 0, V - 1)


def batch_at(cfg: StreamConfig, step: int, device=None) -> Dict[str, torch.Tensor]:
    """The shard's batch for a given step, a pure function of (cfg, step):
    ``tokens`` and ``labels`` ``[local_batch, seq_len]`` int64 on
    ``device``."""
    dev = resolve_device(device)
    rows = range(cfg.shard_id * cfg.local_batch, (cfg.shard_id + 1) * cfg.local_batch)
    toks = torch.stack([_row(cfg, int(step), r) for r in rows]).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclass
class TokenStream:
    """Thin stateful wrapper; its entire state is the step counter, which
    lives in the checkpoint meta."""

    cfg: StreamConfig
    step: int = 0
    device: object = None

    def next(self) -> Dict[str, torch.Tensor]:
        b = batch_at(self.cfg, self.step, self.device)
        self.step += 1
        return b

    def state(self) -> Dict[str, int]:
        return {"data_step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        self.step = int(state.get("data_step", 0))

    def reshard(self, n_shards: int, shard_id: int) -> "TokenStream":
        """Elastic re-slice: same logical stream, new topology."""
        return TokenStream(replace(self.cfg, n_shards=n_shards, shard_id=shard_id), self.step, self.device)
