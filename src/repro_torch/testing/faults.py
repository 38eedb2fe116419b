"""Deterministic fault injection (DESIGN.md §12).

Every recovery path in the serving stack — retry with backoff, the
degradation ladder, circuit breakers, load shedding — needs a *repeatable*
way to make the underlying machinery fail on CPU CI, where real device
OOMs and kernel faults never happen.  This module plants named **injection
points** at the real failure sites:

==================  ========================================================
point               site
==================  ========================================================
``compile``         cold-shape executable construction
                    (``engine.cached_executable`` /
                    ``cached_shared_executable`` cache miss)
``kernel-launch``   resident whole-plan dispatch (``Executable.__call__`` /
                    ``call_batched`` / ``SharedExecutable.__call__``) —
                    the streamed executor does NOT pass through it, which
                    is exactly why streaming is the ladder's last rung
``fused-region``    fused ``Pipeline`` region dispatch only
                    (``engine._run_pipeline`` resident path) — the
                    materialized node-by-node executor never hits it
``h2d``             encoded chunk host→device upload
                    (``storage.*.upload_chunk``)
``chunk-decode``    per-chunk decode-spec resolution in the streamed loop
                    (``storage.*.chunk_decode_spec``)
``dict-build``      dictionary construction (``engine.build_dict``) —
                    the port builds eagerly, so it fires on every call
                    that builds (the reference's fires at trace time)
``shard-exec``      sharded whole-plan dispatch
                    (``distributed.sharded_executor``'s run callable) —
                    the sharded twin of ``kernel-launch``; fires per call,
                    warm and cold
``shard-merge``     cross-shard collective realization
                    (``distributed._plan_exchange`` /
                    ``_plan_repartition``) — fires at trace time inside
                    the ``shard_map`` body, modelling a cold-path
                    all-to-all / all-gather / allreduce failure
``shard-oom``       per-shard local execution (``run_local`` inside the
                    ``shard_map`` body, trace time) — default error kind
                    ``oom``: one shard's device exhausting memory during
                    the partial phase
==================  ========================================================

A *spec* arms one point with fail-once / fail-nth / fail-rate / fail-always
semantics and a typed error kind (``fault`` → :class:`FaultInjected`,
``oom`` → :class:`DeviceOOMError`, ``compile`` → :class:`CompileError`).
Rate specs draw from a seeded counter hash — two identical runs inject the
identical fault sequence, so "retried results are bitwise-identical to the
fault-free run" is a testable property, not a hope.

Arming is explicit (``arm`` / ``injected``) or via the ``REPRO_FAULTS``
environment variable (parsed at import, armed only by ``arm_env()`` so a
CI-wide env var cannot silently perturb unrelated tests)::

    REPRO_FAULTS="compile:nth:2,h2d:rate:0.1:oom,chunk-decode:once"

``check(point)`` is the hot-path hook: a no-op dict lookup when nothing is
armed.
"""
from __future__ import annotations

import hashlib
import os
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.errors import (
    CompileError, DeviceOOMError, FaultInjected, ShardExecError,
)

POINTS = (
    "compile",
    "kernel-launch",
    "fused-region",
    "h2d",
    "chunk-decode",
    "dict-build",
    "shard-exec",
    "shard-merge",
    "shard-oom",
)

ERROR_KINDS = {
    "fault": FaultInjected,
    "oom": DeviceOOMError,
    "compile": CompileError,
    "shard": ShardExecError,
}

#: points whose unspecified error kind is NOT the generic ``fault`` —
#: ``shard-oom`` models a shard's device memory exhausting, so arming it
#: without an explicit kind raises ``DeviceOOMError``
DEFAULT_ERROR = {
    "shard-oom": "oom",
    "shard-merge": "shard",
}

MODES = ("once", "nth", "rate", "always")


@dataclass
class FaultSpec:
    """One armed injection: ``mode`` picks which hits fail.

    * ``once``   — the first hit fails, later hits pass;
    * ``nth``    — hit number ``n`` (1-based) fails, all others pass;
    * ``rate``   — each hit fails with probability ``rate``, drawn from a
      deterministic hash of (seed, point, hit index);
    * ``always`` — every hit fails (a persistent/sticky fault — what the
      circuit breaker and degradation ladder exist for).
    """

    point: str
    mode: str = "once"
    n: int = 1
    rate: float = 0.0
    error: str = "fault"
    seed: int = 0
    hits: int = 0  # times the point was reached while this spec was armed
    fired: int = 0  # times this spec actually raised

    def should_fire(self, hit: int) -> bool:
        if self.mode == "once":
            return hit == 1
        if self.mode == "nth":
            return hit == self.n
        if self.mode == "always":
            return True
        if self.mode == "rate":
            h = hashlib.sha256(
                f"{self.seed}:{self.point}:{hit}".encode()
            ).digest()
            u = int.from_bytes(h[:8], "big") / float(1 << 64)
            return u < self.rate
        raise ValueError(f"unknown fault mode {self.mode!r}")

    def make_error(self):
        cls = ERROR_KINDS[self.error]
        msg = (
            f"injected {self.error} at {self.point!r} "
            f"(hit {self.hits}, mode {self.mode})"
        )
        if cls is FaultInjected:
            return cls(msg, point=self.point)
        if cls is ShardExecError:
            return cls(msg, site=self.point)
        err = cls(msg)
        err.injected_point = self.point
        return err


_ARMED: Dict[str, List[FaultSpec]] = {}


def arm(
    point: str,
    mode: str = "once",
    n: int = 1,
    rate: float = 0.0,
    error: Optional[str] = None,
    seed: int = 0,
) -> FaultSpec:
    if point not in POINTS:
        raise ValueError(f"unknown injection point {point!r}; have {POINTS}")
    if mode not in MODES:
        raise ValueError(f"unknown fault mode {mode!r}; have {MODES}")
    if error is None:
        error = DEFAULT_ERROR.get(point, "fault")
    if error not in ERROR_KINDS:
        raise ValueError(
            f"unknown error kind {error!r}; have {tuple(ERROR_KINDS)}"
        )
    spec = FaultSpec(point, mode, n=n, rate=rate, error=error, seed=seed)
    _ARMED.setdefault(point, []).append(spec)
    return spec


def disarm(point: Optional[str] = None) -> None:
    """Disarm one point, or everything when ``point`` is None."""
    if point is None:
        _ARMED.clear()
    else:
        _ARMED.pop(point, None)


def active() -> Dict[str, List[FaultSpec]]:
    return {p: list(specs) for p, specs in _ARMED.items()}


def check(point: str, detail: str = "") -> None:
    """The injection hook planted at each failure site.  No-op (one dict
    lookup) unless the point is armed."""
    specs = _ARMED.get(point)
    if not specs:
        return
    for spec in specs:
        spec.hits += 1
        if spec.should_fire(spec.hits):
            spec.fired += 1
            err = spec.make_error()
            if detail:
                err.args = (f"{err.args[0]} [{detail}]",) + err.args[1:]
            raise err


@contextmanager
def injected(
    point: str,
    mode: str = "once",
    n: int = 1,
    rate: float = 0.0,
    error: Optional[str] = None,
    seed: int = 0,
):
    """Scoped arm/disarm — yields the spec so tests can assert hit/fired
    counts.  Only the spec armed here is removed on exit."""
    spec = arm(point, mode, n=n, rate=rate, error=error, seed=seed)
    try:
        yield spec
    finally:
        specs = _ARMED.get(point, [])
        if spec in specs:
            specs.remove(spec)
        if not specs:
            _ARMED.pop(point, None)


# -- REPRO_FAULTS environment parsing ---------------------------------------


def parse_env(value: str) -> List[FaultSpec]:
    """Parse ``REPRO_FAULTS``: comma-separated ``point[:mode[:arg[:error]]]``
    entries.  ``arg`` is ``n`` for nth, the probability for rate, ignored
    otherwise.  Examples::

        compile:nth:2          # 2nd cold compile raises FaultInjected
        h2d:rate:0.1:oom       # 10% of chunk uploads raise DeviceOOMError
        chunk-decode:once      # first chunk decode fails
        shard-exec:rate:0.1    # 10% of sharded dispatches fault
        shard-oom:once         # first per-shard trace raises DeviceOOMError
    """
    specs: List[FaultSpec] = []
    for entry in value.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        point = parts[0]
        mode = parts[1] if len(parts) > 1 and parts[1] else "once"
        arg = parts[2] if len(parts) > 2 and parts[2] else ""
        error = (
            parts[3] if len(parts) > 3 and parts[3]
            else DEFAULT_ERROR.get(point, "fault")
        )
        n, rate = 1, 0.0
        if mode == "nth":
            n = int(arg or 1)
        elif mode == "rate":
            rate = float(arg or 0.1)
        if point not in POINTS:
            raise ValueError(
                f"REPRO_FAULTS: unknown point {point!r} in {entry!r}"
            )
        specs.append(FaultSpec(point, mode, n=n, rate=rate, error=error))
    return specs


#: specs described by the environment at import time — NOT armed until a
#: caller opts in with ``arm_env()`` (the chaos suite), so an exported
#: REPRO_FAULTS cannot silently perturb unrelated tests
ENV_SPECS: List[FaultSpec] = parse_env(os.environ.get("REPRO_FAULTS", ""))


#: the specs the last ``arm_env()`` call armed — re-arming replaces them
_ENV_ARMED: List[FaultSpec] = []


def arm_env() -> List[FaultSpec]:
    """Arm the ``REPRO_FAULTS``-described specs (fresh copies, zeroed
    counters) and return them; [] when the env var is empty/absent.

    Idempotent: calling it again first removes the specs the previous call
    armed (fixture setup running twice must not double the injection rate),
    and re-arming after a ``disarm()`` re-plants fresh zeroed specs."""
    for prev in _ENV_ARMED:
        specs = _ARMED.get(prev.point, [])
        if prev in specs:
            specs.remove(prev)
        if not specs:
            _ARMED.pop(prev.point, None)
    _ENV_ARMED.clear()
    for s in ENV_SPECS:
        _ENV_ARMED.append(
            arm(s.point, s.mode, n=s.n, rate=s.rate, error=s.error,
                seed=s.seed)
        )
    return list(_ENV_ARMED)


def stats() -> Dict[str, Dict[str, int]]:
    return {
        p: {
            "hits": sum(s.hits for s in specs),
            "fired": sum(s.fired for s in specs),
        }
        for p, specs in _ARMED.items()
    }
