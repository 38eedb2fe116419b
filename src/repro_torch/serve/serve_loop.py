"""Batched serving loop: fixed-slot continuous batching over decode steps
(the twin of ``repro.serve.serve_loop``).

A ``Server`` owns B cache slots.  Requests (prompt token lists) queue up;
a free slot is filled by running its prompt through ``decode_step`` token by
token, each step advancing every slot (one ``len`` is shared by all slots;
the other slots' outputs of those steps are discarded), and the prompt's
last token waits to open the slot's first generated step.  Generation then
proceeds for the whole batch in lock-step, retiring sequences on EOS or
``max_new`` and recycling their slots at once.  Greedy at temperature 0;
otherwise tokens are sampled from ``softmax(logits / temperature)`` with a
``torch.Generator`` seeded from ``seed`` (its stream is not JAX's, so runs
of the two packages agree only at temperature 0).

The same queue/step/drain machinery serves the analytical path in
``serve.query_server``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.registry import Model


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


class Server:
    def __init__(
        self,
        model: Model,
        params,
        batch_slots: int = 4,
        cache_len: int = 128,
        eos: int = 0,
        temperature: float = 0.0,
        seed: int = 0,
    ):
        self.model = model
        self.params = params
        self.B = batch_slots
        self.cache_len = cache_len
        self.eos = eos
        self.temperature = temperature
        self.generator = torch.Generator(device=model.device).manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.remaining: List[int] = [0] * batch_slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.cache = model.init_cache(batch_slots, cache_len)
        self._step = model.decode_step
        self._pending_first: Dict[int, int] = {}
        self.steps_run = 0

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_slots(self) -> None:
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                self.remaining[i] = req.max_new
                # prefill via stepwise decode into this slot (slot-batched:
                # other slots advance with a token whose output is discarded)
                for t in req.prompt[:-1]:
                    self._advance(self._tokens_with(i, t))
                self._pending_first[i] = req.prompt[-1]

    def _tokens_with(self, slot: int, tok: int) -> torch.Tensor:
        toks = np.zeros((self.B,), np.int64)
        for j, r in enumerate(self.slots):
            if r is not None and r.out:
                toks[j] = r.out[-1]
        toks[slot] = tok
        return torch.from_numpy(toks).to(self.model.device)

    def _advance(self, tokens: torch.Tensor) -> np.ndarray:
        logits, self.cache = self._step(self.params, self.cache, tokens)
        self.steps_run += 1
        if self.temperature > 0.0:
            probs = torch.softmax(logits.float() / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.cpu().numpy()

    def step(self) -> bool:
        """One lock-step decode for all active slots; returns True if any
        work remains."""
        self._fill_slots()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return bool(self.queue)
        toks = np.zeros((self.B,), np.int64)
        for i in active:
            r = self.slots[i]
            if i in self._pending_first:
                toks[i] = self._pending_first.pop(i)
            elif r.out:
                toks[i] = r.out[-1]
            else:
                toks[i] = r.prompt[-1]
        nxt = self._advance(torch.from_numpy(toks).to(self.model.device))
        for i in active:
            r = self.slots[i]
            tok = int(nxt[i]) % self.model.cfg.vocab
            r.out.append(tok)
            self.remaining[i] -= 1
            if tok == self.eos or self.remaining[i] <= 0:
                r.done = True
                self.finished.append(r)
                self.slots[i] = None  # recycle immediately
        return any(s is not None for s in self.slots) or bool(self.queue)

    def run_until_done(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.step():
                break
        return self.finished
