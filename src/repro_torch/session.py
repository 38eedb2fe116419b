"""The Session façade — the port's planning funnel for one device.

``repro_torch.connect(db)`` returns a :class:`Session` whose
``session.query(name_or_llql, **params)`` runs

    synthesize (Alg. 1) → lower.compile → plan.fuse → cached executable

with the cold half paid once per query shape, exactly as
``repro.connect(db).query(q)`` plans it.  The data stays resident on the
session's device — the card unless the caller names another.
Out-of-core budgets, sharding, adaptive racing and the degradation ladder
are not ported yet (see ROADMAP.md).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core import llql as L
from repro_torch.core import plan as P
from repro_torch.core.cost import AnalyticCostModel
from repro_torch.core.lower import compile as compile_plan
from repro_torch.core.synthesis import synthesize
from repro_torch.data.table import collect_stats, resolve_device, to_numpy
from repro_torch.exec import engine as E
from repro_torch.exec.queries import REGISTRY, Query


def result_items(out) -> Dict[int, np.ndarray]:
    """Normalize any executor result to its ``{key: np.ndarray}`` view."""
    if hasattr(out, "items_np"):
        return out.items_np()
    if isinstance(out, dict):
        return {k: to_numpy(v) for k, v in out.items()}
    raise TypeError(f"cannot normalize result of type {type(out).__name__}")


@dataclass
class Shape:
    """One compiled query shape owned by a session."""

    query: Query
    choices: Dict[str, object]
    plan: object  # fused physical plan
    executable: object
    compile_s: float = 0.0
    served: int = 0


class Session:
    """See module docstring.  Construct via :func:`connect`."""

    def __init__(self, db, device=None, delta=None, queries: Optional[Dict[str, Query]] = None):
        self.device = resolve_device(device)
        self.db = {name: t.to(self.device) for name, t in db.items()}
        self.sigma = collect_stats(self.db)
        self.delta = delta if delta is not None else AnalyticCostModel()
        self.queries = dict(queries if queries is not None else REGISTRY)
        self._shapes: Dict[str, Shape] = {}
        self._last_report: Optional[E.ExecutionReport] = None

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

    def shape(self, q: Union[str, Query, L.Expr]) -> Shape:
        """The compiled shape for a query — planned once, cached after."""
        name, query = self._resolve(q)
        shape = self._shapes.get(name)
        if shape is not None:
            return shape
        expr = query.llql()
        t0 = time.perf_counter()
        choices = dict(synthesize(expr, self.sigma, self.delta).choices)
        plan = P.fuse(compile_plan(expr, choices), sigma=self.sigma)
        ex = E.cached_executable(plan, self.db, sigma=self.sigma)
        shape = Shape(query, choices, plan, ex, compile_s=time.perf_counter() - t0)
        self._shapes[name] = shape
        return shape

    def query(self, q: Union[str, Query, L.Expr], **params) -> Dict[int, np.ndarray]:
        """Execute ``q`` (a registered query name, a ``Query`` or an LLQL
        program) and return its ``{key: np.ndarray}`` result.  Bindings are
        validated here (typed ``PlanError``)."""
        shape = self.shape(q)
        E.validate_binding(shape.plan, params, defaults=shape.query.bind_defaults({}))
        out = shape.executable(self.db, shape.query.bind_defaults(params))
        shape.served += 1
        self._last_report = E.last_report()
        return result_items(out)

    def report(self) -> Optional[E.ExecutionReport]:
        """The ExecutionReport of this session's last query."""
        return self._last_report

    def explain(self, q: Union[str, Query, L.Expr]) -> Dict[str, object]:
        """Planning summary for a shape: chosen Γ and the fused plan."""
        shape = self.shape(q)
        return {
            "choices": {s: str(c) for s, c in sorted(shape.choices.items())},
            "plan": shape.plan.describe(),
            "compile_s": shape.compile_s,
            "served": shape.served,
            "device": str(self.device),
        }


def connect(db, device=None, delta=None, queries: Optional[Dict[str, Query]] = None) -> Session:
    """Open a :class:`Session` over ``db`` (a ``{relation: Table}`` dict) on
    ``device`` — ``"cuda"`` unless another is named; raises when no CUDA
    device exists and none was named."""
    return Session(db, device=device, delta=delta, queries=queries)
