"""LLQL operator builders — the paper's Fig. 6 / Fig. 7 listings as programs.

Each builder returns an ``llql.Expr`` tree in exactly the shape of the paper's
listings, with the dictionary annotations left open (``ds=None``) unless the
caller fixes them — synthesis (Alg. 1) fills them in.

Row-level expressions (predicates, keys, aggregates) are supplied as Python
callables that take the loop variable *expression* and return an LLQL
expression, e.g. ``lambda r: r.key.get("K")`` for ``part(r.key)``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from . import llql as L
from .llql import (
    BinOp,
    Const,
    DictIter,
    DictLookup,
    DictNew,
    DictUpdate,
    Expr,
    For,
    HintedLookup,
    HintedUpdate,
    If,
    Input,
    Let,
    Noop,
    RecordCtor,
    RefAdd,
    RefNew,
    Seq,
    Var,
    let,
    seq,
)

RowFn = Callable[[Expr], Expr]


def _rec(fields: Sequence[Tuple[str, Expr]]) -> RecordCtor:
    return RecordCtor(tuple(fields))


# ---------------------------------------------------------------------------
# §3.3 basic operators
# ---------------------------------------------------------------------------


def selection(rel: str, pred: RowFn, out: str = "sel", ds: Optional[str] = None) -> Expr:
    """§3.3.1:  for r in R: if p(r.key): sel(r.key) += r.val"""
    r = Var("r")
    return let(
        out,
        DictNew(ds),
        seq(
            For(
                "r",
                Input(rel),
                If(pred(r), DictUpdate(Var(out), r.key, r.val)),
            ),
            Var(out),
        ),
    )


def projection(rel: str, proj: RowFn, out: str = "proj", ds: Optional[str] = None) -> Expr:
    """§3.3.2:  for r in R: proj(f(r.key)) += r.val"""
    r = Var("r")
    return let(
        out,
        DictNew(ds),
        seq(
            For("r", Input(rel), DictUpdate(Var(out), proj(r), r.val)),
            Var(out),
        ),
    )


def nested_loop_join(
    rel_r: str,
    rel_s: str,
    cond: Callable[[Expr, Expr], Expr],
    out_key: Callable[[Expr, Expr], Expr],
    out: str = "join",
    ds: Optional[str] = None,
) -> Expr:
    """§3.3.3 nested-loop join."""
    r, s = Var("r"), Var("s")
    return let(
        out,
        DictNew(ds),
        seq(
            For(
                "r",
                Input(rel_r),
                For(
                    "s",
                    Input(rel_s),
                    If(
                        cond(r, s),
                        DictUpdate(Var(out), out_key(r, s), r.val * s.val),
                    ),
                ),
            ),
            Var(out),
        ),
    )


def scalar_aggregate(
    rel: str, aggfn: RowFn, agg_type: L.Type = L.DOUBLE, pred: Optional[RowFn] = None
) -> Expr:
    """§3.3.4:  agg += aggFun(r.key) * r.val"""
    r = Var("r")
    body: Expr = RefAdd(Var("agg"), aggfn(r) * r.val)
    if pred is not None:
        body = If(pred(r), body)
    return let(
        "agg",
        RefNew(agg_type),
        seq(For("r", Input(rel), body), Var("agg")),
    )


def groupby(
    rel: str,
    grp: RowFn,
    aggfn: RowFn,
    out: str = "Agg",
    ds: Optional[str] = None,
    hinted: bool = False,
    pred: Optional[RowFn] = None,
) -> Expr:
    """§3.6 / Fig. 6c-6d group-by aggregate (hinted variant = Fig. 6d)."""
    r = Var("r")
    if hinted:
        upd: Expr = HintedUpdate(Var(out), Var("it"), grp(r), aggfn(r) * r.val)
    else:
        upd = DictUpdate(Var(out), grp(r), aggfn(r) * r.val)
    if pred is not None:
        upd = If(pred(r), upd)
    loop = For("r", Input(rel), upd)
    inner = seq(loop, Var(out))
    if hinted:
        inner = let("it", DictIter(Var(out)), inner)
    return let(out, DictNew(ds), inner)


# ---------------------------------------------------------------------------
# §3.4 partitioned joins (Fig. 6a / 6b)
# ---------------------------------------------------------------------------


def partitioned_join(
    rel_r: str,
    rel_s: str,
    part_r: RowFn,
    part_s: RowFn,
    out_key: Callable[[Expr, Expr], Expr],
    build: str = "Sd",
    out: str = "RS",
    build_ds: Optional[str] = None,
    out_ds: Optional[str] = None,
    hinted_lookup: bool = False,
    hinted_build: bool = False,
    pred_r: Optional[RowFn] = None,
    pred_s: Optional[RowFn] = None,
) -> Expr:
    """Fig. 6a (hash join) / Fig. 6b (sort-merge join, hinted).

    Build ``build`` as a partition dictionary  part(s.key) -> {{s.key->s.val}}
    then probe with R, emitting ``out_key(r, s) -> r.val * s.val``.
    """
    r, s = Var("r"), Var("s")

    # -- build phase
    inner_single = DictNew(None, s.key, s.val)  # {{ s.key -> s.val }}
    if hinted_build:
        bupd: Expr = HintedUpdate(Var(build), Var("it_b"), part_s(s), inner_single)
    else:
        bupd = DictUpdate(Var(build), part_s(s), inner_single)
    if pred_s is not None:
        bupd = If(pred_s(s), bupd)
    build_loop = For("s", Input(rel_s), bupd)

    # -- probe phase
    if hinted_lookup:
        probe_src: Expr = HintedLookup(Var(build), Var("it"), Var("rkey"))
    else:
        probe_src = DictLookup(Var(build), Var("rkey"))
    probe_body: Expr = Let(
        "rkey",
        part_r(r),
        For(
            "s",
            probe_src,
            DictUpdate(Var(out), out_key(r, s), r.val * s.val),
        ),
    )
    if pred_r is not None:
        probe_body = If(pred_r(r), probe_body)
    probe_loop = For("r", Input(rel_r), probe_body)

    probe_part: Expr = seq(probe_loop, Var(out))
    if hinted_lookup:
        probe_part = let("it", DictIter(Var(build)), probe_part)
    body: Expr = let(out, DictNew(out_ds), probe_part)
    build_part: Expr = seq(build_loop, body)
    if hinted_build:
        build_part = let("it_b", DictIter(Var(build)), build_part)
    return let(build, DictNew(build_ds), build_part)


def hash_join(*args, **kw) -> Expr:
    kw.setdefault("build_ds", "ht_linear")
    return partitioned_join(*args, **kw)


def sort_merge_join(*args, **kw) -> Expr:
    kw.setdefault("build_ds", "st_sorted")
    kw.setdefault("hinted_lookup", True)
    return partitioned_join(*args, **kw)


def index_nested_loop_join(
    rel_r: str,
    index: str,
    part_r: RowFn,
    out_key: Callable[[Expr, Expr], Expr],
    out: str = "RS",
    out_ds: Optional[str] = None,
    pred_r: Optional[RowFn] = None,
) -> Expr:
    """§3.5 — probe a pre-built index (an input dictionary) directly."""
    r, s = Var("r"), Var("s")
    probe_body: Expr = For(
        "s",
        DictLookup(Input(index), part_r(r)),
        DictUpdate(Var(out), out_key(r, s), r.val * s.val),
    )
    if pred_r is not None:
        probe_body = If(pred_r(r), probe_body)
    return let(
        out,
        DictNew(out_ds),
        seq(For("r", Input(rel_r), probe_body), Var(out)),
    )


# ---------------------------------------------------------------------------
# §3.7 groupjoin (Fig. 6e / 6f) — the paper's running example shape
# ---------------------------------------------------------------------------


def groupjoin(
    rel_r: str,
    rel_s: str,
    key_r: RowFn,
    key_s: RowFn,
    g: RowFn,
    f: RowFn,
    build: str = "Sd",
    out: str = "Agg",
    build_ds: Optional[str] = None,
    out_ds: Optional[str] = None,
    hinted: bool = False,
    pred_s: Optional[RowFn] = None,
    pred_r: Optional[RowFn] = None,
) -> Expr:
    """Fig. 6e/6f: build partial aggregate of S on A, then for each r of R
    combine ``f(r) * g_sum(s)`` into Agg keyed by A.

        for s in S:  Sd(s.key.A) += g(s)
        for r in R:  for gs in Sd(r.key.A):  Agg(r.key.A) += f(r) * gs.val
    """
    r, s = Var("r"), Var("s")
    bupd: Expr = (
        HintedUpdate(Var(build), Var("it1"), key_s(s), g(s) * s.val)
        if hinted
        else DictUpdate(Var(build), key_s(s), g(s) * s.val)
    )
    if pred_s is not None:
        bupd = If(pred_s(s), bupd)
    build_loop = For("s", Input(rel_s), bupd)

    probe_src: Expr = (
        HintedLookup(Var(build), Var("it1"), key_r(r))
        if hinted
        else DictLookup(Var(build), key_r(r))
    )
    # Sd maps A -> partial aggregate (scalar); lookup yields the partial sum,
    # missing keys annihilate the product (no match -> no contribution).
    agg_upd: Expr = (
        HintedUpdate(Var(out), Var("it2"), key_r(r), f(r) * r.val * probe_src)
        if hinted
        else DictUpdate(Var(out), key_r(r), f(r) * r.val * probe_src)
    )
    if pred_r is not None:
        agg_upd = If(pred_r(r), agg_upd)
    probe_loop = For("r", Input(rel_r), agg_upd)

    inner: Expr = seq(build_loop, probe_loop, Var(out))
    if hinted:
        inner = let("it1", DictIter(Var(build)), let("it2", DictIter(Var(out)), inner))
    return let(build, DictNew(build_ds), let(out, DictNew(out_ds), inner))


def running_example(
    rel_o: str = "O",
    rel_l: str = "L",
    date: float = 0.5,
    ds: Optional[str] = None,
) -> Expr:
    """The paper's §1 motivating query (simplified TPC-H Q3) as a groupjoin:

        init Dict
        for o in O:   if o.T < DATE:  Dict(o.K) = 0         (build: mark keys)
        for l in L:   if Dict.contains(l.K): Dict(l.K) += l.P * l.D
    """
    o, l = Var("o"), Var("l")
    build_loop = For(
        "o",
        Input(rel_o),
        If(
            o.key.get("T") < Const(date, L.DOUBLE),
            DictUpdate(Var("D"), o.key.get("K"), Const(0.0, L.DOUBLE)),
        ),
    )
    probe_loop = For(
        "l",
        Input(rel_l),
        DictUpdate(
            Var("D"),
            l.key.get("K"),
            l.key.get("P") * l.key.get("D") * l.val * DictLookup(Var("Dmark"), l.key.get("K")),
        ),
    )
    # NOTE: the paper uses `contains` — we express it as multiplying by a
    # 0/1-marker dictionary Dmark so the program stays in the Fig. 5 grammar.
    # The canonical contains-style form is what `groupjoin_contains` builds.
    del probe_loop
    return groupjoin_contains(rel_o, rel_l, date=date, ds=ds)


def groupjoin_contains(
    rel_o: str = "O",
    rel_l: str = "L",
    date: float = 0.5,
    ds: Optional[str] = None,
    out: str = "D",
) -> Expr:
    """Running example in contains-guard form:

        for o in O: if o.T < DATE: D(o.K) += 0
        for l in L: for _m in D(l.K):  D(l.K) += l.P * l.D * l.val
    """
    o, l = Var("o"), Var("l")
    build_loop = For(
        "o",
        Input(rel_o),
        If(
            o.key.get("T") < Const(date, L.DOUBLE),
            DictUpdate(Var(out), o.key.get("K"), Const(0.0, L.DOUBLE)),
        ),
    )
    # `for m in D(l.K)` over a scalar value is not iterable; the paper's
    # `contains` guard is expressed by probing the dictionary and multiplying
    # the increment by 1 when present.  We model contains as a lookup whose
    # MISSING annihilates the update (interp: MISSING * x = MISSING, and
    # update_add with MISSING value is a no-op via guard below).
    probe_loop = For(
        "l",
        Input(rel_l),
        If(
            BinOp("!=", DictLookup(Var(out), l.key.get("K")), Const(None, L.DOUBLE)),
            DictUpdate(
                Var(out),
                l.key.get("K"),
                l.key.get("P") * l.key.get("D") * l.val,
            ),
        ),
    )
    return let(out, DictNew(ds), seq(build_loop, probe_loop, Var(out)))


# ---------------------------------------------------------------------------
# §3.8 in-DB ML: covariance matrix over a join (Fig. 7a → 7d)
# ---------------------------------------------------------------------------
# Schema: S(s, i, u), R(s, c); Q = S ⋈ R on s; covariance terms over F={i, c}.


def covar_naive() -> Expr:
    """Fig. 7a — materialize Q = S ⋈ R then aggregate i·i, i·c, c·c."""
    r, s, x = Var("r"), Var("s"), Var("x")
    cov_t = L.RecordT((("i_i", L.DOUBLE), ("i_c", L.DOUBLE), ("c_c", L.DOUBLE)))
    prog = let(
        "Rp",
        DictNew(None),
        seq(
            For(
                "r",
                Input("R"),
                DictUpdate(
                    Var("Rp"),
                    r.key.get("s"),
                    DictNew(None, r.key, r.val),
                ),
            ),
            let(
                "Q",
                DictNew(None),
                seq(
                    For(
                        "s",
                        Input("S"),
                        For(
                            "r",
                            DictLookup(Var("Rp"), s.key.get("s")),
                            DictUpdate(
                                Var("Q"),
                                _rec(
                                    [("i", s.key.get("i")), ("c", r.key.get("c"))]
                                ),
                                r.val * s.val,
                            ),
                        ),
                    ),
                    let(
                        "Covar",
                        RefNew(cov_t),
                        seq(
                            For(
                                "x",
                                Var("Q"),
                                RefAdd(
                                    Var("Covar"),
                                    _rec(
                                        [
                                            ("i_i", x.key.get("i") * x.key.get("i") * x.val),
                                            ("i_c", x.key.get("i") * x.key.get("c") * x.val),
                                            ("c_c", x.key.get("c") * x.key.get("c") * x.val),
                                        ]
                                    ),
                                ),
                            ),
                            Var("Covar"),
                        ),
                    ),
                ),
            ),
        ),
    )
    return prog


def covar_interleaved(ragg_ds: Optional[str] = None) -> Expr:
    """Fig. 7b — push partial aggregates of R (m, c, c_c) below the join."""
    r, s = Var("r"), Var("s")
    cov_t = L.RecordT((("i_i", L.DOUBLE), ("i_c", L.DOUBLE), ("c_c", L.DOUBLE)))
    ragg_loop = For(
        "r",
        Input("R"),
        DictUpdate(
            Var("Ragg"),
            r.key.get("s"),
            _rec(
                [
                    ("m", r.val),
                    ("c", r.key.get("c") * r.val),
                    ("c_c", r.key.get("c") * r.key.get("c") * r.val),
                ]
            ),
        ),
    )
    s_loop = For(
        "s",
        Input("S"),
        Let(
            "ra",
            DictLookup(Var("Ragg"), s.key.get("s")),
            RefAdd(
                Var("Covar"),
                _rec(
                    [
                        (
                            "i_i",
                            s.key.get("i") * s.key.get("i") * s.val * Var("ra").get("m"),
                        ),
                        ("i_c", s.key.get("i") * s.val * Var("ra").get("c")),
                        ("c_c", s.val * Var("ra").get("c_c")),
                    ]
                ),
            ),
        ),
    )
    return let(
        "Ragg",
        DictNew(ragg_ds),
        seq(
            ragg_loop,
            let("Covar", RefNew(cov_t), seq(s_loop, Var("Covar"))),
        ),
    )


def covar_factorized(ragg_ds: Optional[str] = None, hinted: bool = False) -> Expr:
    """Fig. 7d — trie-indexed S (input ``Strie``: s -> {{ i -> mult }}) with
    inner partial aggregates hoisted out (factorization + LICM)."""
    st, s = Var("st"), Var("s")
    cov_t = L.RecordT((("i_i", L.DOUBLE), ("i_c", L.DOUBLE), ("c_c", L.DOUBLE)))
    sagg_t = L.RecordT((("i_i", L.DOUBLE), ("i", L.DOUBLE), ("m", L.DOUBLE)))
    r = Var("ra")
    ragg_loop = For(
        "r",
        Input("R"),
        DictUpdate(
            Var("Ragg"),
            Var("r").key.get("s"),
            _rec(
                [
                    ("m", Var("r").val),
                    ("c", Var("r").key.get("c") * Var("r").val),
                    (
                        "c_c",
                        Var("r").key.get("c") * Var("r").key.get("c") * Var("r").val,
                    ),
                ]
            ),
        ),
    )
    lookup: Expr = (
        HintedLookup(Var("Ragg"), Var("it"), st.key) if hinted else DictLookup(Var("Ragg"), st.key)
    )
    inner = Let(
        "ra",
        lookup,
        Let(
            "sagg",
            RefNew(sagg_t),
            seq(
                For(
                    "s",
                    st.val,
                    RefAdd(
                        Var("sagg"),
                        _rec(
                            [
                                ("i_i", s.key * s.key * s.val),
                                ("i", s.key * s.val),
                                ("m", s.val),
                            ]
                        ),
                    ),
                ),
                RefAdd(
                    Var("Covar"),
                    _rec(
                        [
                            ("i_i", Var("sagg").get("i_i") * r.get("m")),
                            ("i_c", Var("sagg").get("i") * r.get("c")),
                            ("c_c", Var("sagg").get("m") * r.get("c_c")),
                        ]
                    ),
                ),
            ),
        ),
    )
    trie_loop = For("st", Input("Strie"), inner)
    body: Expr = let("Covar", RefNew(cov_t), seq(trie_loop, Var("Covar")))
    if hinted:
        body = let("it", DictIter(Var("Ragg")), body)
    return let("Ragg", DictNew(ragg_ds), seq(ragg_loop, body))


def covar_semiring_terms(
    ragg_ds: Optional[str] = None, with_b: bool = False
) -> List[Tuple[str, Expr]]:
    """§3.8 on the semiring path: the covariance matrix as independent
    sum-of-product programs whose S (and R) scans merge into ONE shared
    pass (``plan.merge_shared_scans`` — DESIGN.md §9).

    Each normal-equation term is its own tiny LLQL program ending in a
    scalar ``SemiringAgg("sum_product", ...)`` reduce:

        i_i = Σ_S i·i·s.val
        i_c = Σ_S i·Ragg[s].c·s.val       Ragg[s].c   = Σ_R c·r.val
        c_c = Σ_S Ragg[s].c_c·s.val       Ragg[s].c_c = Σ_R c·c·r.val

    With ``with_b`` the right-hand side rides the same scans
    (b_i = Σ_S i·u·s.val, b_c = Σ_S u·Ragg[s].c·s.val), so the whole
    linear regression is one pass over S plus one pass over R.  Returns
    ``[(term name, program)]`` in a stable order.
    """
    s, r, ra = Var("s"), Var("r"), Var("ra")

    def sp(*xs: Expr) -> Expr:
        return L.SemiringAgg("sum_product", tuple(xs))

    def ref_t(name: str) -> L.RecordT:
        return L.RecordT(((name, L.DOUBLE),))

    def s_only(name: str, payload: Expr) -> Expr:
        return let(
            "Covar",
            RefNew(ref_t(name)),
            seq(
                For("s", Input("S"), RefAdd(Var("Covar"), _rec([(name, payload)]))),
                Var("Covar"),
            ),
        )

    def with_ragg(name: str, lane: str, lane_payload: Expr, payload: Expr) -> Expr:
        ragg_loop = For(
            "r",
            Input("R"),
            DictUpdate(Var("Ragg"), r.key.get("s"), _rec([(lane, lane_payload)])),
        )
        s_loop = For(
            "s",
            Input("S"),
            Let(
                "ra",
                DictLookup(Var("Ragg"), s.key.get("s")),
                RefAdd(Var("Covar"), _rec([(name, payload)])),
            ),
        )
        return let(
            "Ragg",
            DictNew(ragg_ds),
            seq(
                ragg_loop,
                let("Covar", RefNew(ref_t(name)), seq(s_loop, Var("Covar"))),
            ),
        )

    i, u, sval = s.key.get("i"), s.key.get("u"), s.val
    c, rval = r.key.get("c"), r.val
    terms = [
        ("i_i", s_only("i_i", sp(i, i, sval))),
        ("i_c", with_ragg("i_c", "c", sp(c, rval), sp(i, sval, ra.get("c")))),
        ("c_c", with_ragg("c_c", "c_c", sp(c, c, rval), sp(sval, ra.get("c_c")))),
    ]
    if with_b:
        terms += [
            ("b_i", s_only("b_i", sp(i, u, sval))),
            ("b_c", with_ragg("b_c", "c", sp(c, rval), sp(u, sval, ra.get("c")))),
        ]
    return terms
