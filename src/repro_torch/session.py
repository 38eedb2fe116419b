"""The Session façade — the port's planning funnel for one device.

``repro_torch.connect(db)`` returns a :class:`Session` whose
``session.query(name_or_llql, **params)`` runs

    synthesize (Alg. 1) → lower.compile → plan.fuse → cached executable

with the cold half paid once per query shape, exactly as
``repro.connect(db).query(q)`` plans it, on the session's device — the card
unless the caller names another.

``connect(db, memory_budget=B, chunk_rows=R)`` runs out of core: the
storage plan keeps on the device only what the budget holds decoded; every
other relation stays in host memory as encoded chunks (``data.storage``),
pinned, and each query streams it chunk by chunk — an asynchronous upload,
the decode kernel on the card, then the region's stages or the
fused-pipeline kernel per chunk.

Every query runs under the degradation ladder (``execute_shape``): a
device OOM or a repeated transient fault re-runs it one rung down — fused
→ materialized → streamed resident, streamed → streamed-shrunk under a
budget — behind per-(shape, mode) circuit breakers, and a degraded result
is held against the primary rung's result for the same binding
(``degraded_equal``).

``connect(db, shards=N)`` runs the fact tables (``FACT_RELS``: lineitem and
orders) row-sharded over an N-way mesh (``exec.distributed``): choices are
synthesized under Δ_net, each shape compiles onto
``distributed.cached_sharded_executor``, and the ladder is fused-sharded →
materialized-sharded → single-shard.  The shards live on the session's
device's cards, shard ``i`` on ``cuda:(i % device_count)`` (all on one card
where there is one), or all on the host with ``device="cpu"``.

With ``adapt=`` truthy the session plans through
:class:`repro_torch.core.adapt.AdaptivePlanner`: near-cost Alg.-1
candidates are raced on warm-up traffic, validated by the device's rule
(``degraded_equal``), and the measured winner per ``(plan fingerprint,
binding bucket)`` serves steady-state requests with no replanning;
measured-vs-predicted residuals recalibrate the analytic cost model online
(DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import errors
from repro_torch.core import llql as L
from repro_torch.core import cost as C
from repro_torch.core import plan as P
from repro_torch.core.adapt import (  # noqa: F401 — bitwise_equal, CROSS_EXECUTOR_* re-exported
    CROSS_EXECUTOR_ATOL, CROSS_EXECUTOR_RTOL, AdaptConfig, AdaptivePlanner, bitwise_equal, degraded_equal,
    result_items,
)
from repro_torch.core.cost import AnalyticCostModel, FusionCostModel
from repro_torch.core.lower import compile as compile_plan
from repro_torch.core.synthesis import synthesize
from repro_torch.data import storage as S
from repro_torch.data.table import collect_stats, resolve_device
from repro_torch.exec import distributed as D
from repro_torch.exec import engine as E
from repro_torch.exec.queries import FACT_RELS, REGISTRY, Query


@dataclass
class Shape:
    """One compiled query shape owned by a session."""

    query: Query
    choices: Dict[str, object]
    plan: object  # fused physical plan
    executable: object
    planner: Optional[AdaptivePlanner] = None
    compile_s: float = 0.0
    served: int = 0
    synth_runs: int = 0
    # the ladder's lower rungs, built lazily: mode -> (executable, db)
    mode_ex: Dict[str, tuple] = field(default_factory=dict)


class Session:
    """See module docstring.  Construct via :func:`connect`."""

    def __init__(
        self,
        db,
        device=None,
        memory_budget: Optional[int] = None,
        chunk_rows: int = S.CHUNK_ROWS,
        shards: int = 0,
        adapt: Union[bool, AdaptConfig] = False,
        delta=None,
        queries: Optional[Dict[str, Query]] = None,
        clock=None,
    ):
        if memory_budget is not None and shards > 1:
            raise ValueError(
                "out-of-core streaming and sharded execution are separate "
                "executors; open one session per regime"
            )
        self.device = resolve_device(device)
        self.sigma = collect_stats(db)
        self.delta = delta if delta is not None else AnalyticCostModel()
        self.queries = dict(queries if queries is not None else REGISTRY)
        self.adapt_config: Optional[AdaptConfig] = None
        if adapt:
            self.adapt_config = adapt if isinstance(adapt, AdaptConfig) else AdaptConfig()
        # storage plan: chunk what the budget can't keep resident (encoding
        # runs on host copies), and tell the fusion model the real chunk
        # geometry so Δ_chained prices the spill-vs-chain decision with the
        # chunk count the engine will run
        self.memory_budget = memory_budget
        self.chunk_rows = chunk_rows
        if memory_budget is not None:
            self.db = self._chunked(db, memory_budget)
            self.fusion = dataclasses.replace(FusionCostModel(), chunk_rows=float(chunk_rows))
        else:
            self.db = {name: t.to(self.device) for name, t in db.items()}
            self.fusion = None
        self.streamed: Tuple[str, ...] = tuple(sorted(r for r, t in self.db.items() if S.is_chunked(t)))

        # sharded execution: one mesh per session, the fact tables row-sharded
        self.shards = int(shards or 0)
        self.mesh = None
        self.axis = "data"
        self.shard_rels: Tuple[str, ...] = ()
        self.net = None
        if self.shards > 1:
            self.mesh = D.make_mesh({self.axis: self.shards}, device=self.device)
            self.shard_rels = FACT_RELS
            self.net = C.NetCostModel(n_shards=self.shards)
        self._shapes: Dict[str, Shape] = {}
        self._last_report: Optional[E.ExecutionReport] = None

        # -- fault tolerance ------------------------------------------------
        #: monotonic clock driving breaker cooldowns (``clock=`` lets tests
        #: advance time instead of sleeping)
        self._clock = clock if clock is not None else time.monotonic
        #: consecutive transient failures before a mode counts as broken
        self.breaker_threshold = 2
        #: seconds a tripped (shape, mode) breaker stays open
        self.breaker_cooldown_s = 30.0
        self._breaker: Dict[Tuple[str, str], float] = {}  # -> open until
        self._breaker_fails: Dict[Tuple[str, str], int] = {}
        #: the primary rung's recent results per (shape, binding), as host
        #: ``result_items``: a degraded result is checked against them, and
        #: no device tensor is kept alive for it
        self._ref_results: Dict[tuple, Dict[int, np.ndarray]] = {}
        self._ref_results_max = 32
        #: the streamed rung's database, chunked once on first descent
        self._degraded_storage_cache = None
        #: the ladder's counts over the session's lifetime
        self.fault_stats = {"faults": 0, "retries": 0, "degraded": 0}

    def _chunked(self, src, budget: int) -> Dict[str, object]:
        """``src`` placed under ``budget`` bytes by the storage plan: a
        streamed relation is encoded from a host copy made for it alone, or
        kept as it is when ``src`` already holds it chunked (the session's
        ``chunk_rows`` encode it the same way again), and bound to the
        session's device (pinned on the card); a resident relation is moved
        to, or decoded on, the device."""
        plan = C.storage_plan(self.sigma, budget, block=S.BLOCK, chunk_rows=self.chunk_rows)
        db = {}
        for name, t in src.items():
            streamed = plan[name].mode == "streamed"
            if S.is_chunked(t):
                db[name] = t if streamed else t.decode()
            elif streamed:
                db[name] = S.chunk_table(t.to("cpu"), self.chunk_rows, stats=self.sigma.rels.get(name)).to(self.device)
            else:
                db[name] = t.to(self.device)
        return db

    def _resolve(self, q: Union[str, Query, L.Expr]) -> Tuple[str, Query]:
        if isinstance(q, str):
            query = self.queries.get(q)
            if query is None:
                raise KeyError(f"unknown query {q!r}; registered: {sorted(self.queries)}")
            return q, query
        if isinstance(q, Query):
            return q.name, q
        if isinstance(q, L.Expr):
            expr = q
            fp = compile_plan(expr, {}).fingerprint()
            name = f"llql:{fp[:12]}"
            return name, Query(name, lambda: expr, None, None)
        raise TypeError(f"cannot plan a {type(q).__name__}")

    def _build(self, expr: L.Expr, choices):
        """Γ → ``(plan, executable)`` through the executable caches: the
        fused plan and its executable, or on a sharded session the compiled
        plan and its sharded executable."""
        if self.mesh is not None:
            plan = compile_plan(expr, choices)
            run = D.cached_sharded_executor(
                plan, self.db, self.mesh, self.axis, shard_rels=self.shard_rels, sigma=self.sigma,
            )
            return plan, D.ShardedExecutable(run, self.db)
        plan = P.fuse(compile_plan(expr, choices), sigma=self.sigma, streamed=self.streamed, fusion=self.fusion)
        return plan, E.cached_executable(plan, self.db, sigma=self.sigma)

    # -- degradation ladder ------------------------------------------------
    #
    # Every rung realizes the same LLQL semantics under the same Γ:
    #
    #   resident:     fused  →  materialized  →  streamed
    #   out of core:  streamed  →  streamed-shrunk
    #   sharded:      fused-sharded  →  materialized-sharded  →  single-shard
    #
    # A DeviceOOMError descends at once (the same mode would run out
    # again); a transient fault re-raises for the caller to retry at the
    # same rung and descends only after ``breaker_threshold`` consecutive
    # failures.  A descent opens the (shape, mode) breaker: until its
    # cooldown ends, requests skip the broken rung.

    def _ladder_modes(self) -> Tuple[str, ...]:
        if self.mesh is not None:
            return ("fused-sharded", "materialized-sharded", "single-shard")
        if self.memory_budget is not None:
            return ("streamed", "streamed-shrunk")
        return ("fused", "materialized", "streamed")

    def _degraded_storage(self):
        """The streamed rung's ``(db, fusion, streamed)``: the session's
        tables placed under half its budget, or under half their decoded
        footprint when resident, so the rung fits where the resident modes
        did not.  Built once."""
        if self._degraded_storage_cache is None:
            if self.memory_budget is not None:
                budget = max(1, self.memory_budget // 2)
            else:
                budget = max(1, sum(
                    a.numel() * a.element_size() for t in self.db.values() for a in t.columns.values()
                ) // 2)
            db = self._chunked(self.db, budget)
            fusion = dataclasses.replace(FusionCostModel(), chunk_rows=float(self.chunk_rows))
            self._degraded_storage_cache = (db, fusion, tuple(sorted(r for r, t in db.items() if S.is_chunked(t))))
        return self._degraded_storage_cache

    def _mode_executable(self, shape: Shape, mode: str):
        """``(executable, db)`` realizing ``shape`` at rung ``mode``.  The
        primary rung is the shape's installed executable, read live so that
        an adaptive reinstall takes effect; lower rungs are built on first
        use through the same executable cache, under the Γ installed then."""
        modes = self._ladder_modes()
        if mode not in modes:
            raise ValueError(f"unknown ladder mode {mode!r}; this session's ladder is {modes}")
        if mode == modes[0]:
            return shape.executable, self.db
        cached = shape.mode_ex.get(mode)
        if cached is not None:
            return cached
        expr = shape.query.llql()
        if mode == "materialized":
            # the same plan unfused: node by node, no Pipeline regions
            db = self.db
            ex = E.cached_executable(compile_plan(expr, shape.choices), db, sigma=self.sigma)
        elif mode == "materialized-sharded":
            # the same legalized plan with the per-shard phase unfused: the
            # collectives and placement as before, no Pipeline regions
            db = self.db
            run = D.cached_sharded_executor(
                compile_plan(expr, shape.choices), db, self.mesh, self.axis,
                shard_rels=self.shard_rels, sigma=self.sigma, fuse=False,
            )
            ex = D.ShardedExecutable(run, db)
        elif mode == "single-shard":
            # the plan fused for one device over the whole database (the
            # session's tables, which the sharded executor slices into its
            # shards), no collectives: the mesh being sick does not strand
            # the query
            db = self.db
            plan = P.fuse(compile_plan(expr, shape.choices), sigma=self.sigma)
            ex = E.cached_executable(plan, db, sigma=self.sigma)
        else:  # streamed, streamed-shrunk
            db, fusion, streamed = self._degraded_storage()
            plan = P.fuse(compile_plan(expr, shape.choices), sigma=self.sigma, streamed=streamed, fusion=fusion)
            ex = E.cached_executable(plan, db, sigma=self.sigma)
        shape.mode_ex[mode] = (ex, db)
        return ex, db

    def _trip_breaker(self, name: str, mode: str) -> None:
        self._breaker[(name, mode)] = self._clock() + self.breaker_cooldown_s
        self._breaker_fails.pop((name, mode), None)

    def breakers(self) -> Dict[Tuple[str, str], float]:
        """Open circuit breakers: ``{(shape, mode): seconds left}``."""
        now = self._clock()
        return {k: until - now for k, until in self._breaker.items() if until > now}

    def _binding_key(self, name: str, bound) -> tuple:
        return (name,) + tuple(sorted((k, repr(v)) for k, v in (bound or {}).items()))

    def _validate_degraded(self, shape: Shape, key: tuple, items, mode: str = "") -> None:
        """Hold a degraded result against the primary rung's result for the
        same binding, when one is kept, by :func:`degraded_equal`.  The
        ``single-shard`` rung crosses executors (the sharded primary folds
        floats across shards in another order), so it is held at the
        cross-executor tolerance on every device."""
        ref = self._ref_results.get(key)
        if ref is None or degraded_equal(items, ref, self.device, across_executors=mode == "single-shard"):
            return
        raise errors.ReproError(
            f"degraded execution of {shape.query.name!r} at {mode!r} diverged from its "
            f"primary-mode reference — equivalence violation, not noise"
        )

    def execute_shape(self, shape: Shape, bound=None):
        """Execute one bound request for ``shape`` under the ladder: start
        at the first rung whose breaker is closed, descend on
        ``DeviceOOMError`` or repeated transient failure, re-raise typed
        transients for the caller to retry.  Returns the raw executor
        output; ``E.last_report()`` carries the fault and degradation
        counts."""
        return self._execute(shape, bound)[0]

    def _execute(self, shape: Shape, bound):
        """``execute_shape``'s ``(output, result_items)``."""
        name = shape.query.name
        modes = self._ladder_modes()
        now = self._clock()
        idx = 0
        while idx < len(modes) - 1 and self._breaker.get((name, modes[idx]), 0.0) > now:
            idx += 1
        faults = 0
        while True:
            mode = modes[idx]
            failed = oom = False
            try:
                ex, db = self._mode_executable(shape, mode)
                out = ex(db, bound)
                if self.device.type == "cuda":
                    # finish the rung's launches inside the try, so an
                    # asynchronous failure is triaged at its own rung and
                    # the next rung does not queue behind its work
                    torch.cuda.synchronize(self.device)
            except Exception as e:  # noqa: BLE001 — typed triage below
                typed = errors.classified(e)
                if not isinstance(typed, errors.ReproError):
                    raise  # a genuine bug keeps its type and traceback
                if isinstance(typed, errors.PlanError):
                    raise typed from (e if typed is not e else None)
                faults += 1
                self.fault_stats["faults"] += 1
                oom = isinstance(typed, errors.DeviceOOMError)
                degrade = oom
                if not degrade and errors.is_transient(typed):
                    k = (name, mode)
                    fails = self._breaker_fails.get(k, 0) + 1
                    self._breaker_fails[k] = fails
                    degrade = fails >= self.breaker_threshold
                if not (degrade and idx < len(modes) - 1):
                    if typed is e:
                        raise
                    raise typed from e
                self._trip_breaker(name, mode)
                failed = True
                typed = None
            if not failed:
                break
            if oom and self.device.type == "cuda":
                # the error's chained traceback kept the failed rung's
                # frames, and their device tensors, alive; those frames
                # form reference cycles, so collect them and hand the
                # freed blocks back before the lower rung allocates
                gc.collect()
                torch.cuda.empty_cache()
            idx += 1
        # success at rung ``idx``
        self._breaker_fails.pop((name, mode), None)
        key = self._binding_key(name, bound)
        items = result_items(out)
        if idx == 0:
            if len(self._ref_results) >= self._ref_results_max:
                self._ref_results.pop(next(iter(self._ref_results)))
            self._ref_results[key] = items
        else:
            self.fault_stats["degraded"] += 1
            self._validate_degraded(shape, key, items, mode=mode)
        rep = E.last_report()
        rep.faults += faults
        rep.degraded = idx
        rep.degradation = mode if idx else ""
        return out, items

    def shape(self, q: Union[str, Query, L.Expr]) -> Shape:
        """The compiled shape for a query — planned once, cached after.
        Adaptive sessions also run the warm-up race here (on the query's
        default binding), so the installed executable is already the
        measured winner when the first request lands."""
        name, query = self._resolve(q)
        shape = self._shapes.get(name)
        if shape is not None:
            return shape
        expr = query.llql()
        t0 = time.perf_counter()
        planner = None
        synth_runs = 1
        if self.adapt_config is not None:
            planner = AdaptivePlanner(
                expr, self.sigma, self.delta,
                make_executor=lambda ch: _ParamRunner(self, expr, ch),
                config=self.adapt_config,
                fingerprint=compile_plan(expr, {}).fingerprint(),
                device=self.device,
                net=self.net,
                sharded_rels=self.shard_rels or None,
            )
            choices = planner.choose(query.bind_defaults({}))
            synth_runs = len(planner.races)  # one enumeration a race round
        else:
            choices = dict(synthesize(
                expr, self.sigma, self.delta, net=self.net, sharded_rels=self.shard_rels or None,
            ).choices)
        plan, ex = self._build(expr, choices)
        shape = Shape(query, dict(choices), plan, ex, planner=planner, compile_s=time.perf_counter() - t0,
                      synth_runs=synth_runs)
        self._shapes[name] = shape
        return shape

    def query(self, q: Union[str, Query, L.Expr], **params) -> Dict[int, np.ndarray]:
        """Execute ``q`` (a registered query name, a ``Query`` or an LLQL
        program) and return its ``{key: np.ndarray}`` result.  Bindings are
        validated here (typed ``PlanError``), and execution runs under the
        degradation ladder (``execute_shape``)."""
        shape = self.shape(q)
        E.validate_binding(shape.plan, params, defaults=shape.query.bind_defaults({}))
        bound = shape.query.bind_defaults(params)
        if shape.planner is not None:
            choices = shape.planner.choose(bound)
            if choices != shape.choices:
                # a race moved the winner: reinstall it (the executable
                # cache returns the one the race ran); the ladder's primary
                # rung reads ``shape.executable``, lower rungs keep the Γ
                # they were built with
                shape.choices = dict(choices)
                shape.plan, shape.executable = self._build(shape.query.llql(), choices)
            shape.synth_runs = len(shape.planner.races)
        _, items = self._execute(shape, bound)
        shape.served += 1
        self._last_report = E.last_report()
        return items

    def report(self) -> Optional[E.ExecutionReport]:
        """The ExecutionReport of this session's last query."""
        return self._last_report

    def explain(self, q: Union[str, Query, L.Expr]) -> Dict[str, object]:
        """Planning summary for a shape: chosen Γ, the fused plan and — for
        adaptive sessions — the race history."""
        shape = self.shape(q)
        out: Dict[str, object] = {
            "choices": {s: str(c) for s, c in sorted(shape.choices.items())},
            "plan": shape.plan.describe(),
            "compile_s": shape.compile_s,
            "served": shape.served,
            "device": str(self.device),
            "streamed": self.streamed,
            "shards": self.shards,
        }
        if shape.planner is not None:
            out["races"] = [
                {
                    "bucket": rec.bucket,
                    "lanes": [
                        {
                            "swapped": ln.candidate.swapped or "<winner>",
                            "modeled_ms": ln.candidate.modeled_s * 1e3,
                            "measured_ms": ln.measured_s * 1e3 if ln.measured_s < float("inf") else None,
                            "validated": ln.validated,
                        }
                        for ln in rec.lanes
                    ],
                }
                for rec in shape.planner.races
            ]
        return out


class _ParamRunner:
    """Adapter: the planner's ``run(params)`` over a session executable for
    one fixed Γ, built on first call through the executable cache (resident
    or streamed, as the session is)."""

    def __init__(self, session: Session, expr: L.Expr, choices):
        self.session = session
        self.expr = expr
        self.choices = choices
        self._ex = None

    def __call__(self, params=None):
        if self._ex is None:
            _, self._ex = self.session._build(self.expr, self.choices)
        return self._ex(self.session.db, params)


def connect(
    db,
    device=None,
    memory_budget: Optional[int] = None,
    chunk_rows: int = S.CHUNK_ROWS,
    shards: int = 0,
    adapt: Union[bool, AdaptConfig] = False,
    delta=None,
    queries: Optional[Dict[str, Query]] = None,
    clock=None,
) -> Session:
    """Open a :class:`Session` over ``db`` (a ``{relation: Table}`` dict) on
    ``device`` — ``"cuda"`` unless another is named; raises when no CUDA
    device exists and none was named.  ``memory_budget`` (bytes of decoded
    columns the device may hold) streams what does not fit, in chunks of
    ``chunk_rows`` rows; ``shards`` runs the fact tables row-sharded over
    that many shards (choices synthesized under Δ_net); ``adapt`` — ``True``
    or an :class:`AdaptConfig` —
    races near-cost plans on warm-up traffic, validates them by the
    device's rule and serves the measured winner; ``clock`` drives the
    circuit breakers' cooldowns."""
    return Session(
        db, device=device, memory_budget=memory_budget, chunk_rows=chunk_rows, shards=shards, adapt=adapt,
        delta=delta, queries=queries, clock=clock,
    )
