"""The paper's TPC-H evaluation queries (§6.3): Q1, Q3, Q5, Q9, Q18 — the
LLQL programs and numpy ``reference()`` oracles of ``repro.exec.queries``,
copied, over port tables (columns are read back through ``to_numpy``).

Each query exposes:

* ``llql()``   — the **complete** LLQL program (open ``@ds`` annotations),
  with its selectivity knobs declared as free ``L.Param``s (Q1/Q3's date,
  Q5's region, Q9's color, Q18's quantity threshold).  This is the single
  source of truth: cost inference and synthesis read it — once per query
  *shape*, covering every binding — and ``run`` is *derived* from it;
* ``run(db, choices, **params)`` — ``lower.compile(llql(), choices)`` →
  physical plan → ``engine.cached_executable``: the plan is built once per
  (plan, schema); later calls with fresh parameter bindings reuse it (zero
  synthesis, zero replanning — DESIGN.md §6).  One
  generic method on :class:`Query` — the former five per-query wrappers
  survive only as deprecated shims;
* ``reference(db, **params)`` — a numpy oracle for correctness tests;
* ``defaults`` — the binding used when a knob is not supplied (the former
  baked-in constants).

Queries register by name in ``REGISTRY`` (``QUERIES`` is the historical
alias), which is what lets ``repro_torch.connect(db).query("q18", threshold=200)``
resolve by name; ``register`` adds user-defined queries to the same
namespace.  ``queries.run(qname, db, ...)`` and the ``qN_run`` module
functions are deprecated shims over ``REGISTRY[qname].run`` — new code
should go through ``repro_torch.connect`` (the Session façade plans, fuses,
caches, and reports; see DESIGN.md §11).

The queries are structurally faithful simplifications (same joins, same
group-bys, same selectivity knobs); text/date predicates act on the encoded
columns of the synthetic generator (``repro_torch.data.tpch``).  Multi-hop queries
(Q5/Q9) are expressed as chains of partitioned joins whose record-keyed
outputs are the intermediate relations — exactly the shape the plan compiler
turns into HashBuild/HashProbe/Project pipelines.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core import llql as L
from repro_torch.core import operators as O
from repro_torch.core.cost import DictChoice, GammaDict
from repro_torch.core.llql import (
    Const,
    DictLookup,
    DictNew,
    DictUpdate,
    For,
    If,
    Input,
    RecordCtor,
    Var,
    let,
    seq,
)
from repro_torch.data.table import Table, collect_stats, to_numpy
from . import engine as E


def _c(x: float) -> L.Const:
    return L.Const(x, L.DOUBLE)

def _i(x: int) -> L.Const:
    return L.Const(x, L.INT)


def _rec(**fields: L.Expr) -> RecordCtor:
    return RecordCtor(tuple(fields.items()))


# Σ statistics cache: run() compiles capacities from per-relation distinct
# counts; the stats are data-derived and immutable per db dict, so cache by
# identity (benchmarks call run() in a timing loop).  Entries hold a strong
# reference to the db and re-verify identity on hit — a bare id() key could
# alias a recycled address after the original dict is collected.
_STATS_CACHE: Dict[int, Tuple[Dict[str, Table], object]] = {}


def _stats_for(db: Dict[str, Table]):
    key = id(db)
    hit = _STATS_CACHE.get(key)
    if hit is None or hit[0] is not db:
        if len(_STATS_CACHE) > 8:  # benchmarks generate a handful of dbs
            _STATS_CACHE.pop(next(iter(_STATS_CACHE)))
        _STATS_CACHE[key] = (db, collect_stats(db))
    return _STATS_CACHE[key][1]


def _run_llql(
    prog: L.Expr,
    db: Dict[str, Table],
    choices: GammaDict,
    params: Dict[str, object],
):
    """The derived physical plan: compile the LLQL under the synthesized
    choices, fuse the row-parallel regions (a costed choice under Δ_fuse —
    DESIGN.md §7), and execute through the executable cache — the paper's
    generate-then-run, with compile-once/execute-many on top: recompiling
    the same (program, choices) is a cache hit, and the binding is passed
    as runtime scalars."""
    from repro_torch.core import plan as P
    from repro_torch.core.lower import compile as compile_plan

    sigma = _stats_for(db)
    plan = P.fuse(compile_plan(prog, choices), sigma=sigma)
    ex = E.cached_executable(plan, db, sigma=sigma)
    return ex(db, params).items_np()


@dataclass
class Query:
    name: str
    llql: Callable[[], L.Expr]
    reference: Callable[..., Dict[int, np.ndarray]]
    defaults: Dict[str, object] = None  # free-Param fallback binding

    def bind_defaults(self, params: Dict[str, object]) -> Dict[str, object]:
        return {**(self.defaults or {}), **params}

    def run(
        self, db, choices: GammaDict = None, **params
    ) -> Dict[int, np.ndarray]:
        """The ONE generic execution path every registered query shares:
        compile this query's LLQL under ``choices`` and run it through the
        executable cache with ``params`` bound over ``defaults``."""
        return _run_llql(
            self.llql(), db, choices or {}, self.bind_defaults(params)
        )


# ---------------------------------------------------------------------------
# Q1 — scan-heavy multi-aggregate group-by on lineitem (tiny group count)
# ---------------------------------------------------------------------------


def q1_llql() -> L.Expr:
    r = L.Var("r")
    key = r.key.get("returnflag") * _i(2) + r.key.get("linestatus")
    val = L.record(
        qty=r.key.get("quantity"),
        price=r.key.get("extendedprice"),
        disc_price=r.key.get("extendedprice") * (_c(1.0) - r.key.get("discount")),
        charge=r.key.get("extendedprice")
        * (_c(1.0) - r.key.get("discount"))
        * (_c(1.0) + r.key.get("tax")),
        cnt=_c(1.0),
    )
    return O.groupby(
        "lineitem",
        grp=lambda rr: key,
        aggfn=lambda rr: val,
        pred=lambda rr: rr.key.get("shipdate") <= L.Param("date", L.DOUBLE),
        out="Agg",
    )


def q1_run(db, choices, **params):
    """Deprecated shim — use ``REGISTRY["q1"].run`` or the Session façade."""
    return REGISTRY["q1"].run(db, choices, **params)


def q1_reference(db, date: float = 0.9):
    li = db["lineitem"]
    m = to_numpy(li.col("shipdate")) <= date
    k = to_numpy(li.col("returnflag")) * 2 + to_numpy(li.col("linestatus"))
    ep = to_numpy(li.col("extendedprice"))
    dc = to_numpy(li.col("discount"))
    tx = to_numpy(li.col("tax"))
    q = to_numpy(li.col("quantity"))
    out = {}
    for key in np.unique(k[m]):
        s = m & (k == key)
        out[int(key)] = np.array(
            [
                q[s].sum(),
                ep[s].sum(),
                (ep[s] * (1 - dc[s])).sum(),
                (ep[s] * (1 - dc[s]) * (1 + tx[s])).sum(),
                s.sum(),
            ],
            np.float32,
        )
    return out


# ---------------------------------------------------------------------------
# Q3 — the running example: orders(date<δ) groupjoin lineitem on orderkey
# ---------------------------------------------------------------------------


def q3_llql() -> L.Expr:
    return O.groupjoin(
        "lineitem",
        "orders",
        key_r=lambda r: r.key.get("orderkey"),
        key_s=lambda s: s.key.get("orderkey"),
        g=lambda s: _c(1.0),
        f=lambda r: r.key.get("extendedprice") * (_c(1.0) - r.key.get("discount")),
        pred_s=lambda s: s.key.get("orderdate") < L.Param("date", L.DOUBLE),
        build="OD",
        out="Agg",
    )


def q3_run(db, choices, **params):
    """Deprecated shim — use ``REGISTRY["q3"].run`` or the Session façade."""
    return REGISTRY["q3"].run(db, choices, **params)


def q3_reference(db, date: float = 0.05):
    li, od = db["lineitem"], db["orders"]
    sel = to_numpy(od.col("orderdate")) < date
    ok = set(to_numpy(od.col("orderkey"))[sel].tolist())
    k = to_numpy(li.col("orderkey"))
    v = to_numpy(li.col("extendedprice")) * (1 - to_numpy(li.col("discount")))
    out = {}
    for kk, vv in zip(k, v):
        if int(kk) in ok:
            out[int(kk)] = out.get(int(kk), 0.0) + float(vv)
    return {k2: np.array([v2], np.float32) for k2, v2 in out.items()}


# ---------------------------------------------------------------------------
# Q5 — 4-way join: revenue per nation for one region
# ---------------------------------------------------------------------------


def q5_llql() -> L.Expr:
    """The full chain, dictionaries innermost-first:

    * ``NR``  — nationkey index over region-filtered nation (semijoin side);
    * ``C2``  — customer ⋈ NR projected to (custkey, nationkey);
    * ``CN``  — custkey index over C2;
    * ``OC``  — orders ⋈ CN projected to (orderkey, c_nat);
    * ``OD``  — orderkey index over OC;
    * ``LO``  — lineitem ⋈ OD projected to (suppkey, c_nat, rev);
    * ``SN``  — suppkey index over supplier;
    * ``Agg`` — Σ rev per supplier nation, keeping supplier-nation == customer-nation.
    """
    n, c, x, o, cc, l, od, y, sp = (Var(v) for v in
                                    ("n", "c", "x", "o", "cc", "l", "od", "y", "sp"))
    nr_loop = For(
        "n",
        Input("nation"),
        If(
            n.key.get("regionkey").eq(L.Param("region", L.INT)),
            DictUpdate(Var("NR"), n.key.get("nationkey"), DictNew(None, n.key, n.val)),
        ),
    )
    c2_loop = For(
        "c",
        Input("customer"),
        For(
            "x",
            DictLookup(Var("NR"), c.key.get("nationkey")),
            DictUpdate(
                Var("C2"),
                _rec(custkey=c.key.get("custkey"), nationkey=c.key.get("nationkey")),
                c.val * x.val,
            ),
        ),
    )
    cn_loop = For(
        "c2",
        Var("C2"),
        DictUpdate(Var("CN"), Var("c2").key.get("custkey"), DictNew(None, Var("c2").key, Var("c2").val)),
    )
    oc_loop = For(
        "o",
        Input("orders"),
        For(
            "cc",
            DictLookup(Var("CN"), o.key.get("custkey")),
            DictUpdate(
                Var("OC"),
                _rec(orderkey=o.key.get("orderkey"), c_nat=cc.key.get("nationkey")),
                o.val * cc.val,
            ),
        ),
    )
    od_loop = For(
        "oc", Var("OC"),
        DictUpdate(Var("OD"), Var("oc").key.get("orderkey"), DictNew(None, Var("oc").key, Var("oc").val)),
    )
    lo_loop = For(
        "l",
        Input("lineitem"),
        For(
            "od",
            DictLookup(Var("OD"), l.key.get("orderkey")),
            DictUpdate(
                Var("LO"),
                _rec(
                    suppkey=l.key.get("suppkey"),
                    c_nat=od.key.get("c_nat"),
                    rev=l.key.get("extendedprice") * (_c(1.0) - l.key.get("discount")),
                ),
                l.val * od.val,
            ),
        ),
    )
    sn_loop = For(
        "s",
        Input("supplier"),
        DictUpdate(Var("SN"), Var("s").key.get("suppkey"), DictNew(None, Var("s").key, Var("s").val)),
    )
    agg_loop = For(
        "y",
        Var("LO"),
        For(
            "sp",
            DictLookup(Var("SN"), y.key.get("suppkey")),
            If(
                sp.key.get("nationkey").eq(y.key.get("c_nat")),
                DictUpdate(
                    Var("Agg"),
                    sp.key.get("nationkey"),
                    y.key.get("rev") * y.val * sp.val,
                ),
            ),
        ),
    )
    body = seq(nr_loop, c2_loop, cn_loop, oc_loop, od_loop, lo_loop, sn_loop,
               agg_loop, Var("Agg"))
    for sym in ("Agg", "SN", "LO", "OD", "OC", "CN", "C2", "NR"):
        body = let(sym, DictNew(None), body)
    return body


def q5_run(db, choices, **params):
    """Deprecated shim — use ``REGISTRY["q5"].run`` or the Session façade."""
    return REGISTRY["q5"].run(db, choices, **params)


def q5_reference(db, region: int = 0):
    li, od, cu, su, na = (
        db["lineitem"], db["orders"], db["customer"], db["supplier"], db["nation"]
    )
    reg = to_numpy(na.col("regionkey"))
    cn = to_numpy(cu.col("nationkey"))
    cust_ok = reg[cn] == region
    ord_nat = {}
    ok_arr = to_numpy(od.col("orderkey"))
    ock = to_numpy(od.col("custkey"))
    for okey, ck in zip(ok_arr, ock):
        if cust_ok[ck]:
            ord_nat[int(okey)] = int(cn[ck])
    sn = to_numpy(su.col("nationkey"))
    out = {}
    lk = to_numpy(li.col("orderkey"))
    ls = to_numpy(li.col("suppkey"))
    rv = to_numpy(li.col("extendedprice")) * (1 - to_numpy(li.col("discount")))
    for okey, sk, r in zip(lk, ls, rv):
        nat = ord_nat.get(int(okey))
        if nat is not None and sn[sk] == nat:
            out[nat] = out.get(nat, 0.0) + float(r)
    return {k: np.array([v], np.float32) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Q9 — profit per (nation, year-bucket) over part-filtered lineitems
# ---------------------------------------------------------------------------

_YEARS = 7


def q9_llql() -> L.Expr:
    """Chain: PX (color-filtered part index) → LP (lineitem ⋈ PX carrying the
    profit inputs) → SN (supplier index) → LS (+nation) → OD (orders index)
    → Agg keyed (nation, year-bucket)."""
    p, l, pp, x, sp, o, y, oo = (Var(v) for v in
                                 ("p", "l", "pp", "x", "sp", "o", "y", "oo"))
    px_loop = For(
        "p",
        Input("part"),
        If(
            p.key.get("color").eq(L.Param("color", L.INT)),
            DictUpdate(Var("PX"), p.key.get("partkey"), DictNew(None, p.key, p.val)),
        ),
    )
    lp_loop = For(
        "l",
        Input("lineitem"),
        For(
            "pp",
            DictLookup(Var("PX"), l.key.get("partkey")),
            DictUpdate(
                Var("LP"),
                _rec(
                    suppkey=l.key.get("suppkey"),
                    orderkey=l.key.get("orderkey"),
                    qty=l.key.get("quantity"),
                    ep=l.key.get("extendedprice"),
                    disc=l.key.get("discount"),
                    retail=pp.key.get("retailprice"),
                ),
                l.val * pp.val,
            ),
        ),
    )
    sn_loop = For(
        "s",
        Input("supplier"),
        DictUpdate(Var("SN"), Var("s").key.get("suppkey"), DictNew(None, Var("s").key, Var("s").val)),
    )
    ls_loop = For(
        "x",
        Var("LP"),
        For(
            "sp",
            DictLookup(Var("SN"), x.key.get("suppkey")),
            DictUpdate(
                Var("LS"),
                _rec(
                    orderkey=x.key.get("orderkey"),
                    nat=sp.key.get("nationkey"),
                    qty=x.key.get("qty"),
                    ep=x.key.get("ep"),
                    disc=x.key.get("disc"),
                    retail=x.key.get("retail"),
                ),
                x.val * sp.val,
            ),
        ),
    )
    od_loop = For(
        "o",
        Input("orders"),
        DictUpdate(Var("OD"), o.key.get("orderkey"), DictNew(None, o.key, o.val)),
    )
    profit = y.key.get("ep") * (_c(1.0) - y.key.get("disc")) - y.key.get(
        "qty"
    ) * y.key.get("retail") * _c(0.01)
    yearkey = y.key.get("nat") * _i(_YEARS) + L.UnOp(
        "floor", oo.key.get("orderdate") * _c(float(_YEARS))
    )
    agg_loop = For(
        "y",
        Var("LS"),
        For(
            "oo",
            DictLookup(Var("OD"), y.key.get("orderkey")),
            DictUpdate(Var("Agg"), yearkey, profit * y.val * oo.val),
        ),
    )
    body = seq(px_loop, lp_loop, sn_loop, ls_loop, od_loop, agg_loop, Var("Agg"))
    for sym in ("Agg", "OD", "LS", "SN", "LP", "PX"):
        body = let(sym, DictNew(None), body)
    return body


def q9_run(db, choices, **params):
    """Deprecated shim — use ``REGISTRY["q9"].run`` or the Session façade."""
    return REGISTRY["q9"].run(db, choices, **params)


def q9_reference(db, color: int = 3):
    li, pa, su, od = db["lineitem"], db["part"], db["supplier"], db["orders"]
    pcol = to_numpy(pa.col("color"))
    pprice = to_numpy(pa.col("retailprice"))
    sn = to_numpy(su.col("nationkey"))
    odate = to_numpy(od.col("orderdate"))
    out = {}
    lk = to_numpy(li.col("partkey"))
    lsk = to_numpy(li.col("suppkey"))
    lok = to_numpy(li.col("orderkey"))
    ep = to_numpy(li.col("extendedprice"))
    dc = to_numpy(li.col("discount"))
    qt = to_numpy(li.col("quantity"))
    for i in range(len(lk)):
        if pcol[lk[i]] != color:
            continue
        year = int(odate[lok[i]] * _YEARS)
        key = int(sn[lsk[i]]) * _YEARS + year
        profit = ep[i] * (1 - dc[i]) - qt[i] * pprice[lk[i]] * 0.01
        out[key] = out.get(key, 0.0) + float(profit)
    return {k: np.array([v], np.float32) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Q18 — high-cardinality aggregation (the paper's sort-based winner)
# ---------------------------------------------------------------------------


def q18_llql() -> L.Expr:
    """Group quantities per order, then the HAVING + join-back: scan the
    aggregate dictionary, keep the big groups, and re-join orders for
    totalprice — a dictionary scan feeding a probe, all in one program."""
    l, o, g, oo = Var("l"), Var("o"), Var("g"), Var("oo")
    qty_loop = For(
        "l",
        Input("lineitem"),
        DictUpdate(Var("QtyAgg"), l.key.get("orderkey"), l.key.get("quantity") * l.val),
    )
    od_loop = For(
        "o",
        Input("orders"),
        DictUpdate(Var("OD"), o.key.get("orderkey"), DictNew(None, o.key, o.val)),
    )
    big_loop = For(
        "g",
        Var("QtyAgg"),
        If(
            g.val > L.Param("threshold", L.DOUBLE),
            For(
                "oo",
                DictLookup(Var("OD"), g.key),
                DictUpdate(
                    Var("Big"),
                    g.key,
                    L.record(qty=g.val, totalprice=oo.key.get("totalprice")),
                ),
            ),
        ),
    )
    body = seq(qty_loop, od_loop, big_loop, Var("Big"))
    for sym in ("Big", "OD", "QtyAgg"):
        body = let(sym, DictNew(None), body)
    return body


def q18_run(db, choices, **params):
    """Deprecated shim — use ``REGISTRY["q18"].run`` or the Session façade."""
    return REGISTRY["q18"].run(db, choices, **params)


def q18_reference(db, threshold: float = 150.0):
    li, od = db["lineitem"], db["orders"]
    k = to_numpy(li.col("orderkey"))
    q = to_numpy(li.col("quantity"))
    tp = to_numpy(od.col("totalprice"))
    agg = {}
    for kk, qq in zip(k, q):
        agg[int(kk)] = agg.get(int(kk), 0.0) + float(qq)
    return {
        kk: np.array([vv, tp[kk]], np.float32)
        for kk, vv in agg.items()
        if vv > threshold
    }


# the query namespace: name → (llql, reference oracle, default binding).
# ``session.query("q18", threshold=200)`` resolves here; QUERIES is the
# historical alias external callers and the test suite import.
REGISTRY: Dict[str, Query] = {
    "q1": Query("q1", q1_llql, q1_reference, {"date": 0.9}),
    "q3": Query("q3", q3_llql, q3_reference, {"date": 0.05}),
    "q5": Query("q5", q5_llql, q5_reference, {"region": 0}),
    "q9": Query("q9", q9_llql, q9_reference, {"color": 3}),
    "q18": Query("q18", q18_llql, q18_reference, {"threshold": 150.0}),
}
QUERIES = REGISTRY


def register(query: Query) -> Query:
    """Add a user-defined query to the namespace (returns it, so usable as
    a decorator-ish helper around a ``Query(...)`` literal)."""
    REGISTRY[query.name] = query
    return query


def run(qname: str, db, choices: GammaDict = None, **params):
    """Deprecated shim for the pre-Session API: ``queries.run("q1", db)``.
    New code goes through ``repro_torch.connect(db).query(qname, **params)``."""
    return REGISTRY[qname].run(db, choices, **params)

def synthesize_choices(
    qname: str, db: Dict[str, Table], delta, extra_syms: Tuple[str, ...] = ()
) -> GammaDict:
    """Run Algorithm 1 on the query's LLQL against real-data statistics and
    return per-symbol choices.  The LLQL now covers every dictionary the plan
    materializes, so ``extra_syms`` only backfills caller-invented aliases."""
    from repro_torch.core.synthesis import synthesize

    q = QUERIES[qname]
    sigma = _stats_for(db)
    res = synthesize(q.llql(), sigma, delta)
    choices = dict(res.choices)
    for sym in extra_syms:
        if sym not in choices and choices:
            choices[sym] = next(iter(choices.values()))
    return choices
