"""Cardinality model Σ — the paper's §2.3 pluggable estimator.

The paper delegates cardinality estimation to "state-of-the-art" models and
treats Σ as an oracle with three queries (Fig. 8):

    Σ_card(e)  — cardinality of the dictionary produced by ``e``
    Σ_dist(e)  — number of distinct values of a key expression
    Σ_sel(e)   — selectivity of a condition

We implement the classic System-R–style uniform/independence estimator over
per-relation statistics (row count, per-column distinct counts and min/max,
plus which columns the relation is physically sorted on).  The estimator is
*pluggable*: anything with the same three methods can be swapped in
(``exec.stats.collect`` builds exact stats from data for the benchmarks).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from . import llql as L

# ---------------------------------------------------------------------------
# Statistics containers
# ---------------------------------------------------------------------------


@dataclass
class ColumnStats:
    distinct: float
    lo: float = 0.0
    hi: float = 1.0


@dataclass
class RelStats:
    rows: float
    columns: Dict[str, ColumnStats] = field(default_factory=dict)
    sorted_on: Tuple[str, ...] = ()  # physical order of the relation

    def col(self, name: str) -> ColumnStats:
        if name not in self.columns:
            # Unknown column: assume key-like (all-distinct) — conservative
            # for group-by cardinality, harmless for selectivity.
            self.columns[name] = ColumnStats(distinct=self.rows)
        return self.columns[name]


# ---------------------------------------------------------------------------
# Key-expression analysis: which relation columns feed a key expression?
# ---------------------------------------------------------------------------


def key_columns(e: L.Expr, loopvar: str) -> Tuple[str, ...]:
    """Columns of the loop variable's relation referenced by a key/grouping
    expression, e.g. ``r.key.K`` -> ("K",); records yield all fields."""
    cols = []

    def go(x: L.Expr) -> None:
        if isinstance(x, L.FieldAccess):
            base = x.rec
            if (
                isinstance(base, L.FieldAccess)
                and base.name == "key"
                and isinstance(base.rec, L.Var)
                and base.rec.name == loopvar
            ):
                cols.append(x.name)
                return
            if isinstance(base, L.Var) and base.name == loopvar and x.name == "key":
                cols.append("*")  # whole-row key
                return
        for c in x.children():
            go(c)

    go(e)
    return tuple(dict.fromkeys(cols))  # dedupe, keep order


# ---------------------------------------------------------------------------
# The Σ model
# ---------------------------------------------------------------------------


class CardModel:
    def __init__(self, rels: Dict[str, RelStats]):
        self.rels = dict(rels)
        # cardinalities for let-bound dictionary symbols, filled by the
        # annotation pass in core.cost (and overridable for tests)
        self.dict_card: Dict[str, float] = {}
        self.dict_key_dist: Dict[str, float] = {}

    # -- relations ---------------------------------------------------------
    def rel(self, name: str) -> RelStats:
        if name not in self.rels:
            raise KeyError(f"no statistics for relation {name!r}")
        return self.rels[name]

    def card_rel(self, name: str) -> float:
        return self.rel(name).rows

    # -- Σ_dist ------------------------------------------------------------
    def dist(self, rel: str, cols: Tuple[str, ...]) -> float:
        r = self.rel(rel)
        if not cols:
            return 1.0
        if "*" in cols:
            return r.rows
        d = 1.0
        for c in cols:
            d *= max(1.0, r.col(c).distinct)
        return min(d, r.rows)

    # -- Σ_sel -------------------------------------------------------------
    def sel(self, cond: L.Expr, loopvar: str, rel: str) -> float:
        """Uniformity/independence selectivity of a row predicate."""
        r = self.rel(rel)
        if isinstance(cond, L.BinOp):
            if cond.op in ("&&",):
                return self.sel(cond.lhs, loopvar, rel) * self.sel(
                    cond.rhs, loopvar, rel
                )
            if cond.op in ("||",):
                a = self.sel(cond.lhs, loopvar, rel)
                b = self.sel(cond.rhs, loopvar, rel)
                return min(1.0, a + b - a * b)
            cols = key_columns(cond, loopvar)
            konst = _const_of(cond)
            if cond.op in ("<", "<=", ">", ">=") and cols:
                if konst is not None:
                    cs = r.col(cols[0])
                    if cs.hi <= cs.lo:
                        return 0.5
                    frac = (float(konst) - cs.lo) / (cs.hi - cs.lo)
                    frac = min(1.0, max(0.0, frac))
                    return frac if cond.op in ("<", "<=") else 1.0 - frac
                if _has_param(cond):
                    # range predicate against a free Param: price at the
                    # midpoint of the column bounds, so one synthesis covers
                    # every binding (DESIGN.md §6) — the expected selectivity
                    # of a uniformly drawn threshold over [lo, hi]
                    return 0.5
            if cond.op == "==" and cols:
                return 1.0 / max(1.0, r.col(cols[0]).distinct)
            if cond.op == "!=" and cols:
                return 1.0 - 1.0 / max(1.0, r.col(cols[0]).distinct)
        if isinstance(cond, L.UnOp) and cond.op == "!":
            return 1.0 - self.sel(cond.operand, loopvar, rel)
        return 0.5  # unknown predicate: textbook default

    # -- orderedness -------------------------------------------------------
    def is_sorted_on(self, rel: str, cols: Tuple[str, ...]) -> bool:
        """Is the relation physically ordered by (a prefix covering) cols?"""
        r = self.rel(rel)
        if not cols or not r.sorted_on:
            return False
        return tuple(r.sorted_on[: len(cols)]) == tuple(cols)


def _const_of(e: L.BinOp) -> Optional[float]:
    for side in (e.rhs, e.lhs):
        if isinstance(side, L.Const) and isinstance(side.value, (int, float)):
            return float(side.value)
    return None


def _has_param(e: L.Expr) -> bool:
    return any(isinstance(n, L.Param) for n in L.walk(e))
