"""Batched analytical serving over a port :class:`Session` (the twin of
``repro.serve.query_server``).

A ``QueryServer`` fronts a session and a request queue; requests are
``(query name, parameter binding)`` pairs.  Per query shape the server pays
the planning funnel once (``Session.shape``: Σ, Algorithm 1, lowering,
fusion, the cached executable); every later request with a fresh binding
is a warm hit, its parameters passed as 0-d tensors.  Over an adaptive
session (``connect(db, adapt=...)``) the cold path runs the session's
warm-up race, so serving rides the measured winner with no per-request
replanning; its enumerations count in ``synth_runs``.  Passing a raw
``{relation: Table}`` db instead of a session still works, as a deprecated
shim that opens a session through ``connect``, on the card.

Micro-batching: each ``step()`` drains up to ``max_batch`` queued requests
of the same query shape and runs them through ``Executable.call_batched``:
B warm calls, since the port's plain loops cannot ride ``torch.func.vmap``
(``vmapped_batches = False``).  Draining is round-based: a step serves only
requests that were queued when its round began, so a stream of one shape
cannot starve an earlier request of another.  With ``share_scans=True`` a
round's batch may mix shapes whose plans share a fact-table scan: it runs
as one shared pass (``plan.merge_shared_scans`` +
``engine.cached_shared_executable``) and responses demultiplex by rid.

Every submitted request terminates with a result or a typed error:

* **admission** — the queue is bounded (``max_queue``); beyond it
  ``submit`` raises :class:`AdmissionRejected` with the depth and a
  retry-after hint from warm throughput;
* **deadlines** — expired requests are swept to ``DeadlineExceeded``, and
  a request is never placed in a round that the shape's warm batch-wall
  EWMA predicts will miss its deadline (shed early, with the prediction);
* **validation** — bindings are checked per request (typed ``PlanError``),
  so one malformed request cannot poison its batch;
* **retry** — transient faults retry the batch with exponential backoff
  and deterministic jitter, capped per request;
* **degradation** — a device OOM or exhausted retries serves each request
  on its own through ``Session.execute_shape``, the degradation ladder.

On the card a batch's launches are finished inside its ``try`` (a device
synchronize), so an asynchronous failure is triaged with its batch; the
clock stops once the results are on the host, so the latency counters, the
EWMA and ``warm_rps`` measure what a client waits for.

Sharded sessions (``connect(db, shards=N)``) serve through the same loop:
``session.shape`` compiles onto ``distributed.cached_sharded_executor`` and
the ``ShardedExecutable`` speaks the executable interface, so admission,
deadlines, shedding, retry and the sharded ladder apply unchanged; a
sharded batch is B warm calls.  Only ``share_scans=True`` is refused
(:class:`UnsupportedSessionError` at construction): cross-query shared-scan
merging is per-host.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import errors
from repro_torch.core import plan as P
from repro_torch.core.adapt import result_items
from repro_torch.exec import engine as E
from repro_torch.exec.queries import QUERIES, Query
from repro_torch.session import Session, connect

#: retry-after hint (seconds) when admission-rejecting before any warm
#: latency has been observed: a client backing off this long cannot
#: re-arrive before the first batch could have drained.  Once a shape has
#: served warm traffic the hint uses the measured EWMA.
COLD_RETRY_AFTER_S = 0.05


@dataclass
class QueryRequest:
    rid: int
    qname: str
    params: Dict[str, object]
    t_submit: float = 0.0
    deadline_s: Optional[float] = None  # relative budget given at submit
    t_deadline: Optional[float] = None  # absolute (server-clock) deadline


@dataclass
class QueryResponse:
    rid: int
    qname: str
    params: Dict[str, object]
    result: Optional[Dict[int, np.ndarray]]
    latency_s: float
    warm: bool  # the shape was already compiled when this request ran
    batch_size: int = 1
    error: Optional[BaseException] = None  # typed ReproError on failure
    #: ``error.to_dict()`` wire form (kind, transient, message, payload);
    #: None on success
    error_info: Optional[Dict[str, object]] = None
    retries: int = 0  # transient-fault retries consumed
    degraded: str = ""  # the ladder rung that produced the result, if not primary

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class _Shape:
    """One compiled query shape: choices, cached executable, bookkeeping."""

    query: Query
    executable: object
    choices: Dict[str, object]
    compile_s: float  # cold cost paid: synthesis, lowering, first run
    plan: object = None  # fused physical plan (shared-scan merge input)
    session_shape: object = None  # the session's Shape (the ladder's entry)
    served: int = 0
    busy_s: float = 0.0  # execution wall attributed to this shape
    ewma_s: Optional[float] = None  # warm batch-wall EWMA (deadline predictor)


class QueryServer:
    def __init__(
        self,
        session,
        delta=None,
        queries: Optional[Dict[str, Query]] = None,
        max_batch: int = 8,
        share_scans: bool = False,
        max_queue: int = 1024,
        max_retries: int = 3,
        backoff_s: float = 0.001,
        backoff_cap_s: float = 0.05,
        default_deadline_s: Optional[float] = None,
        seed: int = 0,
        clock=None,
    ):
        if not isinstance(session, Session):
            # deprecated shim: a raw {relation: Table} db opens a session on the card
            session = connect(session, delta=delta, queries=queries)
        if session.mesh is not None and share_scans:
            raise errors.UnsupportedSessionError(
                f"share_scans=True cannot front a sharded session "
                f"({session.shards} shards): cross-query shared-scan "
                f"merging is per-host only; serve sharded sessions with "
                f"share_scans=False"
            )
        self.session = session
        self.db = session.db
        self.delta = session.delta
        self.queries = dict(queries or session.queries or QUERIES)
        self.max_batch = max_batch
        self.share_scans = share_scans
        self.max_queue = max_queue
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.default_deadline_s = default_deadline_s
        self._rng = random.Random(seed)  # deterministic backoff jitter
        #: monotonic clock driving deadlines, latency counters and the EWMA
        #: (``clock=`` lets tests advance time instead of sleeping)
        self._clock = clock if clock is not None else time.perf_counter
        self.sigma = session.sigma
        self.queue: List[QueryRequest] = []
        self.finished: List[QueryResponse] = []
        self._shapes: Dict[str, _Shape] = {}
        self._round: List[QueryRequest] = []  # current fairness round
        self._compat: Dict[tuple, bool] = {}  # qname pair -> mergeable
        self._next_rid = 0
        self.counters = {
            "requests": 0,
            "responses": 0,
            "batches": 0,
            "shared_batches": 0,
            "cold_compiles": 0,
            "synth_runs": 0,
            "warm_hits": 0,
            "rejected": 0,  # AdmissionRejected at submit
            "shed_deadline": 0,  # expired or predicted-to-miss requests
            "invalid": 0,  # PlanError responses (binding validation)
            "retries": 0,  # transient-fault retry attempts
            "faults": 0,  # typed faults observed while serving
            "degraded": 0,  # responses produced below the primary rung
            "errors": 0,  # responses carrying a typed error
        }
        self._lat = {"warm": [], "cold": []}
        self._busy = {"warm": 0.0, "cold": 0.0}

    def _sync(self) -> None:
        """Finish the session device's queued work (a no-op off the card)."""
        if self.session.device.type == "cuda":
            torch.cuda.synchronize(self.session.device)

    # -- cold path: once per query shape -----------------------------------
    def _shape(self, qname: str) -> _Shape:
        shape = self._shapes.get(qname)
        if shape is not None:
            self.counters["warm_hits"] += 1
            return shape
        q = self.queries[qname]
        t0 = self._clock()
        # the session's planning funnel, with an adaptive session's warm-up
        # race, so the installed executable is already the measured winner
        ss = self.session.shape(q)
        ex = ss.executable
        ex(self.db, q.bind_defaults({}))  # the first run, so the first serve is warm
        self._sync()
        shape = _Shape(q, ex, dict(ss.choices), self._clock() - t0, plan=ss.plan, session_shape=ss)
        self._shapes[qname] = shape
        self.counters["cold_compiles"] += 1
        self.counters["synth_runs"] += ss.synth_runs
        return shape

    def warm_up(self, qnames=None) -> None:
        """Compile shapes so first requests hit the warm path.  The port's
        executables batch as loops of warm calls (``vmapped_batches =
        False``), so there are no batch buckets to trace."""
        for qname in qnames or sorted(self.queries):
            self._shape(qname)

    # -- request intake ----------------------------------------------------
    def submit(self, qname: str, deadline_s: Optional[float] = None, **params) -> int:
        """Enqueue a request; returns its rid.  Raises ``KeyError`` for an
        unregistered query and :class:`AdmissionRejected` (with the queue
        depth and a retry-after hint) when the bounded queue is full."""
        if qname not in self.queries:
            raise KeyError(f"unknown query {qname!r}")
        depth = len(self.queue) + len(self._round)
        if depth >= self.max_queue:
            self.counters["rejected"] += 1
            raise errors.AdmissionRejected(
                f"queue full ({depth}/{self.max_queue})",
                queue_depth=depth, retry_after_s=self._retry_after_hint(depth),
            )
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        self.queue.append(QueryRequest(
            rid, qname, dict(params), t_submit=now, deadline_s=deadline_s,
            t_deadline=now + deadline_s if deadline_s is not None else None,
        ))
        self.counters["requests"] += 1
        return rid

    def _retry_after_hint(self, depth: int) -> float:
        """Pending rounds × the mean warm batch wall; before any warm
        traffic, :data:`COLD_RETRY_AFTER_S`."""
        walls = [s.ewma_s for s in self._shapes.values() if s.ewma_s is not None]
        per_batch = (sum(walls) / len(walls)) if walls else COLD_RETRY_AFTER_S
        return max(1, depth // max(1, self.max_batch)) * per_batch

    # -- serving loop ------------------------------------------------------
    def _mergeable(self, qa: str, qb: str) -> bool:
        """Whether the two shapes' plans share a fused scan — decided once a
        pair by running the merge on the two plans.  A typed failure while
        probing (a compile fault on a cold shape) only disables sharing for
        this round."""
        key = tuple(sorted((qa, qb)))
        hit = self._compat.get(key)
        if hit is None:
            try:
                sp = P.merge_shared_scans([self._shape(qa).plan, self._shape(qb).plan], sigma=self.sigma)
            except errors.ReproError:
                return False  # not cached: probe again next round
            hit = bool(sp.regions)
            self._compat[key] = hit
        return hit

    def _take_batch(self) -> List[QueryRequest]:
        """Up to ``max_batch`` requests of the head request's shape (and,
        under ``share_scans``, of mergeable shapes) from the current round,
        the rest kept in arrival order.  A round is the queue as it was when
        the previous round drained."""
        if not self._round:
            self._round, self.queue = self.queue, []
        if not self._round:
            return []
        head = self._round[0].qname
        batch, rest = [], []
        for req in self._round:
            ok = req.qname == head or (self.share_scans and self._mergeable(head, req.qname))
            if ok and len(batch) < self.max_batch:
                batch.append(req)
            else:
                rest.append(req)
        self._round = rest
        return batch

    # -- fault handling ----------------------------------------------------
    def _fail(self, req: QueryRequest, err: BaseException, warm: bool, retries: int = 0) -> QueryResponse:
        """Terminate ``req`` with a typed error response."""
        resp = QueryResponse(
            rid=req.rid, qname=req.qname, params=req.params, result=None,
            latency_s=self._clock() - req.t_submit, warm=warm, error=err, retries=retries,
            error_info=(
                err.to_dict() if isinstance(err, errors.ReproError)
                else {"kind": type(err).__name__, "transient": errors.is_transient(err), "message": str(err)}
            ),
        )
        self.counters["errors"] += 1
        self.counters["responses"] += 1
        self.finished.append(resp)
        return resp

    def _sweep_expired(self, now: float) -> List[QueryResponse]:
        """Expired requests get DeadlineExceeded, not silence."""
        out = []
        for store in (self._round, self.queue):
            keep = []
            for req in store:
                if req.t_deadline is not None and now > req.t_deadline:
                    self.counters["shed_deadline"] += 1
                    out.append(self._fail(
                        req,
                        errors.DeadlineExceeded(
                            f"deadline {req.deadline_s:.3f}s expired before service", deadline_s=req.deadline_s,
                        ),
                        warm=req.qname in self._shapes,
                    ))
                else:
                    keep.append(req)
            store[:] = keep
        return out

    def _shed_predicted_misses(self, batch: List[QueryRequest], now: float):
        """Shed now, with the prediction attached, every request whose
        shape's warm batch-wall EWMA says this round would miss its
        deadline; shapes with no history are admitted.  Returns ``(kept
        requests, shed responses)``."""
        kept, shed = [], []
        for req in batch:
            shape = self._shapes.get(req.qname)
            est = shape.ewma_s if shape is not None else None
            if req.t_deadline is not None and est is not None and now + est > req.t_deadline:
                self.counters["shed_deadline"] += 1
                shed.append(self._fail(
                    req,
                    errors.DeadlineExceeded(
                        f"round predicted to miss deadline ({est * 1e3:.2f}ms predicted)",
                        deadline_s=req.deadline_s, predicted_s=est,
                    ),
                    warm=True,
                ))
            else:
                kept.append(req)
        return kept, shed

    def _validate(self, batch: List[QueryRequest]):
        """Per-request binding validation: a malformed request gets a typed
        ``PlanError`` response.  Returns ``(kept requests, rejected
        responses)``."""
        kept, bad = [], []
        for req in batch:
            shape = self._shapes.get(req.qname)
            if shape is None:
                try:
                    shape = self._shape(req.qname)
                except Exception:  # noqa: BLE001 — the batch retry loop's job
                    kept.append(req)
                    continue
            try:
                E.validate_binding(shape.plan, req.params, defaults=shape.query.bind_defaults({}))
            except errors.PlanError as pe:
                self.counters["invalid"] += 1
                bad.append(self._fail(req, pe, warm=True))
                continue
            kept.append(req)
        return kept, bad

    def _backoff(self, attempt: int) -> None:
        """Exponential backoff with deterministic jitter, capped."""
        base = min(self.backoff_s * (2 ** (attempt - 1)), self.backoff_cap_s)
        time.sleep(base + self._rng.uniform(0.0, base))

    def _execute_batch(self, batch: List[QueryRequest]):
        """One attempt at the batched path, its launches finished.  Returns
        ``(shapes, results)``; raises typed errors on failure."""
        qnames = [r.qname for r in batch]
        if len(set(qnames)) == 1:
            shape = self._shape(batch[0].qname)
            bindings = [shape.query.bind_defaults(r.params) for r in batch]
            if len(batch) == 1:
                results = [shape.executable(self.db, bindings[0])]
            else:
                results = shape.executable.call_batched(self.db, bindings)
            self._sync()
            return [shape] * len(batch), results
        # a cross-query batch: one shared pass over the common scan,
        # demultiplexed by request order
        shapes = [self._shape(q) for q in qnames]
        sp = P.merge_shared_scans([s.plan for s in shapes], sigma=self.sigma)
        ex = E.cached_shared_executable(sp, self.db, sigma=self.sigma)
        results = ex(self.db, [s.query.bind_defaults(r.params) for s, r in zip(shapes, batch)])
        self._sync()
        self.counters["shared_batches"] += 1
        return shapes, results

    def _execute_one(self, req: QueryRequest):
        """Per-request fallback: the session's ladder with this server's
        retry and backoff around transient faults.  Returns ``(shape, out,
        retries)``; raises the final typed error."""
        shape = self._shape(req.qname)
        binding = shape.query.bind_defaults(req.params)
        attempt = 0
        while True:
            try:
                return shape, self.session.execute_shape(shape.session_shape, binding), attempt
            except errors.ReproError as e:
                self.counters["faults"] += 1
                if errors.is_transient(e) and attempt < self.max_retries:
                    attempt += 1
                    self.counters["retries"] += 1
                    self._backoff(attempt)
                    continue
                raise

    def step(self) -> List[QueryResponse]:
        """Serve one micro-batch; returns this step's responses, typed-error
        responses included ([] only when there is no work at all)."""
        now = self._clock()
        out = self._sweep_expired(now)
        batch = self._take_batch()
        # warm or cold by what was compiled when the round began
        warm = all(r.qname in self._shapes for r in batch) if batch else True
        t0 = self._clock()  # cold batches count the compile in busy time
        batch, bad = self._validate(batch)
        out.extend(bad)
        batch, shed = self._shed_predicted_misses(batch, self._clock())
        out.extend(shed)
        if not batch:
            return out
        head = batch[0].qname
        shapes = results = None
        batch_retries = 0
        while results is None:
            try:
                shapes, results = self._execute_batch(batch)
            except Exception as e:  # noqa: BLE001 — typed triage below
                typed = errors.classified(e)
                if not isinstance(typed, errors.ReproError):
                    raise  # a genuine bug keeps its type and traceback
                self.counters["faults"] += 1
                if errors.is_transient(typed) and batch_retries < self.max_retries:
                    batch_retries += 1
                    self.counters["retries"] += 1
                    self._backoff(batch_retries)
                    continue
                # degradable (OOM) or retries exhausted: each request down
                # the session's ladder on its own
                out.extend(self._step_degraded(batch, warm, t0))
                self.counters["batches"] += 1
                return out
        # a response is done once its result is on the host: the clock
        # counts the copy every response needs
        items = [result_items(res) for res in results]
        done = self._clock()
        self._busy["warm" if warm else "cold"] += done - t0
        uniq = list({id(s): s for s in shapes}.values())
        for s in uniq:
            s.busy_s += (done - t0) / len(uniq)
        if warm:
            self._note_wall(self._shapes[head], done - t0)
        E.last_report().retries += batch_retries
        for req, s, res in zip(batch, shapes, items):
            resp = QueryResponse(
                rid=req.rid, qname=req.qname, params=req.params, result=res,
                latency_s=done - req.t_submit, warm=warm, batch_size=len(batch), retries=batch_retries,
            )
            self._lat["warm" if warm else "cold"].append(resp.latency_s)
            self.finished.append(resp)
            out.append(resp)
            s.served += 1
        self.counters["responses"] += len(batch)
        self.counters["batches"] += 1
        return out

    def _step_degraded(self, batch: List[QueryRequest], warm: bool, t0: float) -> List[QueryResponse]:
        """The batched path failed hard: serve each request on its own
        through the ladder, so one poisoned request (or a mode-wide OOM)
        cannot strand the others."""
        out = []
        for req in batch:
            try:
                shape, res, retries = self._execute_one(req)
            except errors.ReproError as e:
                out.append(self._fail(req, e, warm=warm))
                continue
            res = result_items(res)
            done = self._clock()
            rep = E.last_report()
            rep.retries += retries
            if rep.degraded:
                self.counters["degraded"] += 1
            resp = QueryResponse(
                rid=req.rid, qname=req.qname, params=req.params, result=res,
                latency_s=done - req.t_submit, warm=warm, batch_size=1, retries=retries,
                degraded=rep.degradation,
            )
            self._lat["warm" if warm else "cold"].append(resp.latency_s)
            self.finished.append(resp)
            out.append(resp)
            shape.served += 1
            self.counters["responses"] += 1
            self._busy["warm" if warm else "cold"] += done - t0
            t0 = done
        return out

    def _note_wall(self, shape: _Shape, wall_s: float) -> None:
        shape.ewma_s = wall_s if shape.ewma_s is None else 0.3 * wall_s + 0.7 * shape.ewma_s

    def run_until_done(self, max_steps: int = 100_000) -> List[QueryResponse]:
        for _ in range(max_steps):
            if not self.step():
                break
        return self.finished

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        def pct(xs: List[float], p: float) -> float:
            return float(np.percentile(xs, p)) if xs else 0.0

        warm_n, cold_n = len(self._lat["warm"]), len(self._lat["cold"])
        return {
            **self.counters,
            "queued": len(self.queue) + len(self._round),
            "warm_p50_ms": pct(self._lat["warm"], 50) * 1e3,
            "warm_p99_ms": pct(self._lat["warm"], 99) * 1e3,
            "cold_p50_ms": pct(self._lat["cold"], 50) * 1e3,
            "cold_p99_ms": pct(self._lat["cold"], 99) * 1e3,
            "busy_s": self._busy["warm"] + self._busy["cold"],
            "warm_rps": warm_n / self._busy["warm"] if self._busy["warm"] else 0.0,
            "cold_rps": cold_n / self._busy["cold"] if self._busy["cold"] else 0.0,
            "shapes": {
                q: {"served": s.served, "compile_s": s.compile_s, "busy_s": s.busy_s, "ewma_ms": (s.ewma_s or 0.0) * 1e3}
                for q, s in self._shapes.items()
            },
        }
