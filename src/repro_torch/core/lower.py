"""LLQL → physical-plan lowering (PyTorch twin of ``repro.core.lower``).

``compile`` is pure translation — the reference's code, unchanged — so the
port plans exactly as ``repro`` does.  ``compile_rowfn_frame`` evaluates a
row expression over torch columns with JAX's result types: ``int / int``
is float32, ``%`` is floor-mod, Python constants are weakly typed, ``!`` is
logical on bool and bitwise on int.  Anything ``compile`` does not
recognise falls back to the reference interpreter with a warning.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.data.table import Table, to_numpy
from repro_torch.errors import PlanError
from . import llql as L
from . import plan as P
from .cardinality import CardModel
from .cost import DictChoice, GammaDict

# Reserved column names of a materialized dictionary scan (`for g in Agg`):
# `g.key` / `g.val` compile to these columns; extra value lanes get an index
# suffix (`__val__1`, ...).
DICT_KEY = "__key__"
DICT_VAL = "__val__"


# ---------------------------------------------------------------------------
# row-expression compiler
# ---------------------------------------------------------------------------


def _scalar_pair(fn, pyfn):
    """A binary op that accepts Python scalars on either side (torch's
    ``minimum``/``maximum`` take tensors only); a Python scalar is weakly
    typed: it takes the tensor's result type, as in JAX."""

    def op(a, b):
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if not ta and not tb:
            return pyfn(a, b)
        if not ta:
            a = torch.tensor(a, dtype=torch.result_type(b, a), device=b.device)
        if not tb:
            b = torch.tensor(b, dtype=torch.result_type(a, b), device=a.device)
        return fn(a, b)

    return op


def _floor(v):
    if isinstance(v, torch.Tensor):
        return torch.floor(v) if v.is_floating_point() else v
    return float(math.floor(v))


_BIN = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&&": lambda a, b: a & b,
    "||": lambda a, b: a | b,
    "min": _scalar_pair(torch.minimum, min),
    "max": _scalar_pair(torch.maximum, max),
}

_UN = {
    "!": lambda v: ~v,
    "-": lambda v: -v,
    "floor": _floor,
}


class _Unsupported(PlanError):
    """An LLQL shape outside the recognized lowering forms (permanent)."""


def as_column(x, dtype: torch.dtype, n: int, device) -> torch.Tensor:
    """A row-expression value (tensor or Python scalar) as an ``[n]`` column
    of ``dtype`` — ``jnp.broadcast_to(jnp.asarray(x, dtype), (n,))``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype).expand(n) if x.dim() == 0 else x.to(dtype)
    return torch.full((n,), x, dtype=torch.float64 if isinstance(x, float) else torch.int64, device=device).to(dtype)


def compile_rowfn_frame(
    e: L.Expr, tables: Dict[str, Table], params: Optional[Dict[str, object]] = None
):
    """Evaluate a row-level expression over one or more loop variables into
    a torch column (or a Python scalar when it reads no column); ``tables``
    maps each bound variable to its aligned table.  ``v.key.a`` reads column
    ``a``; ``v.val`` is the dictionary value lane for dict scans and the bag
    multiplicity otherwise; ``v.key`` (whole) is a dict scan's key column.
    ``params`` maps free ``L.Param`` names to 0-d tensors (or scalars)."""

    def go(x: L.Expr):
        if isinstance(x, L.Const):
            return x.value
        if isinstance(x, L.Param):
            if params is None or x.name not in params:
                raise _Unsupported(f"unbound parameter ?{x.name}")
            return params[x.name]
        if isinstance(x, L.FieldAccess):
            base = x.rec
            if (
                isinstance(base, L.FieldAccess)
                and base.name == "key"
                and isinstance(base.rec, L.Var)
                and base.rec.name in tables
            ):
                return tables[base.rec.name].col(x.name)
            if isinstance(base, L.Var) and base.name in tables:
                t = tables[base.name]
                if x.name == "val":
                    if DICT_VAL in t.columns:
                        return t.col(DICT_VAL)
                    return t.multiplicity()
                if x.name == "key":
                    if DICT_KEY in t.columns:
                        return t.col(DICT_KEY)
                    raise _Unsupported("whole-row key")
            raise _Unsupported(f"field access {L.pretty(x)}")
        if isinstance(x, L.BinOp):
            return _BIN[x.op](go(x.lhs), go(x.rhs))
        if isinstance(x, L.UnOp):
            return _UN[x.op](go(x.operand))
        raise _Unsupported(f"row expr {type(x).__name__}")

    return go(e)


# ---------------------------------------------------------------------------
# LLQL → Plan
# ---------------------------------------------------------------------------


def compile(
    expr: L.Expr,
    choices: Optional[GammaDict] = None,
    sigma: Optional[CardModel] = None,
) -> P.Plan:
    """Translate an LLQL program into a physical plan, baking the synthesized
    per-dictionary ``choices`` into the dictionary-producing nodes (symbols
    not covered fall back to their ``@ds`` annotation, then the default).
    Raises ``_Unsupported`` on program shapes outside the recognized forms
    (``execute`` catches it and falls back to the interpreter)."""
    del sigma  # capacity decisions happen at execution time
    choices = dict(choices or {})
    nodes: List[P.Node] = []
    dict_ann: Dict[str, Optional[str]] = {}
    ref_syms: Dict[str, L.Type] = {}
    result: List[Optional[str]] = [None]
    counter = [0]

    def fresh() -> str:
        counter[0] += 1
        return f"%{counter[0] - 1}"

    def choice_of(sym: str) -> DictChoice:
        if sym in choices:
            return choices[sym]
        ann = dict_ann.get(sym)
        return DictChoice(ann) if ann else DictChoice()

    def emit(node: P.Node) -> None:
        nodes.append(node)

    # -- statement level ----------------------------------------------------
    def stmt(x: L.Expr) -> None:
        if isinstance(x, L.Seq):
            stmt(x.first)
            stmt(x.second)
            return
        if isinstance(x, L.Let):
            v = x.value
            if isinstance(v, L.DictNew) and v.key is None:
                dict_ann[x.name] = v.ds
            elif isinstance(v, L.RefNew):
                ref_syms[x.name] = v.type
            elif isinstance(v, L.DictIter) and isinstance(v.dict, L.Var):
                pass  # hintedness rides on HintedUpdate/HintedLookup nodes
            else:
                raise _Unsupported(f"let of {type(v).__name__}")
            stmt(x.body)
            return
        if isinstance(x, L.For):
            loop(x)
            return
        if isinstance(x, L.Var):
            result[0] = x.name
            return
        if isinstance(x, L.Noop):
            return
        raise _Unsupported(f"top-level {type(x).__name__}")

    # -- loop level ---------------------------------------------------------
    def loop(f: L.For) -> None:
        src = f.source
        if isinstance(src, L.Input):
            src_name = src.name
        elif isinstance(src, L.Var) and src.name in dict_ann:
            src_name = src.name  # derived relation or dictionary scan
        else:
            raise _Unsupported("loop over non-input")
        frame = fresh()
        emit(P.Scan(frame, source=src_name, var=f.var))

        body = f.body
        if isinstance(body, L.If) and isinstance(body.els, L.Noop):
            sel = fresh()
            emit(P.Select(sel, source=frame, pred=body.cond))
            frame, body = sel, body.then

        # optional `let rkey = keyexpr in ...` aliases
        key_alias: Dict[str, L.Expr] = {}
        while isinstance(body, L.Let) and not isinstance(
            body.value,
            (L.DictNew, L.RefNew, L.DictIter, L.DictLookup, L.HintedLookup),
        ):
            key_alias[body.name] = body.value
            body = body.body

        def resolve(x: L.Expr) -> L.Expr:
            return L.rewrite(
                x,
                lambda n: key_alias.get(n.name, n) if isinstance(n, L.Var) else n,
            )

        if isinstance(body, (L.DictUpdate, L.HintedUpdate)):
            dict_update(frame, body, resolve)
            return
        if isinstance(body, L.For):
            probe_loop(frame, body, resolve)
            return
        if isinstance(body, L.Let) and isinstance(
            body.value, (L.DictLookup, L.HintedLookup)
        ):
            # Fig. 7b: let ra = Ragg(key) in Covar += {...}
            lk = body.value
            inner = body.body
            if (
                isinstance(inner, L.RefAdd)
                and isinstance(inner.value, L.RecordCtor)
                and isinstance(inner.ref, L.Var)
                and isinstance(lk.dict, L.Var)
            ):
                fields, ops = _record_lanes(tuple(inner.value.fields))
                emit(
                    P.Reduce(
                        inner.ref.name,
                        source=frame,
                        fields=fields,
                        lookup_sym=lk.dict.name,
                        lookup_key=resolve(lk.keyexpr),
                        lookup_var=body.name,
                        ops=ops,
                    )
                )
                return
            raise _Unsupported("lookup-let form")
        if isinstance(body, L.RefAdd) and isinstance(body.ref, L.Var):
            val = resolve(body.value)
            if isinstance(val, L.RecordCtor):
                fields, ops = _record_lanes(tuple(val.fields))
            elif isinstance(val, L.SemiringAgg):
                fields = (("_0", val.contribution()),)
                ops = _norm_ops((val.combine,))
            else:
                fields, ops = (("_0", val),), ()
            emit(P.Reduce(body.ref.name, source=frame, fields=fields, ops=ops))
            return
        raise _Unsupported(f"loop body {type(body).__name__}")

    def dict_update(frame: str, upd, resolve: Callable[[L.Expr], L.Expr]) -> None:
        if not isinstance(upd.dict, L.Var):
            raise _Unsupported("update of non-let-bound dictionary")
        sym = upd.dict.name
        hinted = isinstance(upd, L.HintedUpdate)
        key = resolve(upd.keyexpr)
        val = resolve(upd.value)
        lk = _find_lookup(val)
        if lk is not None and isinstance(lk.dict, L.Var) and lk.dict.name in dict_ann:
            emit(
                P.GroupJoin(
                    sym,
                    source=frame,
                    build=lk.dict.name,
                    keyexpr=key,
                    f_expr=_strip_lookup(val, lk),
                    choice=choice_of(sym),
                    hinted=hinted or isinstance(lk, L.HintedLookup),
                )
            )
        elif isinstance(val, L.DictNew):  # partition/index build
            emit(
                P.HashBuild(
                    sym, source=frame, keyexpr=key, choice=choice_of(sym), hinted=hinted
                )
            )
        else:
            lanes, ops = _value_lanes(val)
            emit(
                P.GroupBy(
                    sym,
                    source=frame,
                    keyexpr=key,
                    values=lanes,
                    choice=choice_of(sym),
                    hinted=hinted,
                    ops=ops,
                )
            )

    def probe_loop(frame: str, nf: L.For, resolve) -> None:
        src = nf.source
        if (
            not isinstance(src, (L.DictLookup, L.HintedLookup))
            or not isinstance(src.dict, L.Var)
            or src.dict.name not in dict_ann
        ):
            raise _Unsupported("nested loop form")
        probe = fresh()
        emit(
            P.HashProbe(
                probe,
                source=frame,
                build=src.dict.name,
                keyexpr=resolve(src.keyexpr),
                inner_var=nf.var,
                hinted=isinstance(src, L.HintedLookup),
            )
        )
        inner = nf.body
        if isinstance(inner, L.If) and isinstance(inner.els, L.Noop):
            sel = fresh()
            emit(P.Select(sel, source=probe, pred=resolve(inner.cond)))
            probe, inner = sel, inner.then
        if isinstance(inner, (L.DictUpdate, L.HintedUpdate)) and isinstance(
            inner.dict, L.Var
        ):
            osym = inner.dict.name
            okey = resolve(inner.keyexpr)
            oval = resolve(inner.value)
            if isinstance(okey, L.RecordCtor):
                # record-keyed join output: a relation downstream loops scan
                emit(P.Project(osym, source=probe, fields=tuple(okey.fields)))
            else:
                lanes, ops = _value_lanes(oval)
                emit(
                    P.GroupBy(
                        osym,
                        source=probe,
                        keyexpr=okey,
                        values=lanes,
                        choice=choice_of(osym),
                        hinted=isinstance(inner, L.HintedUpdate),
                        ops=ops,
                    )
                )
            return
        raise _Unsupported("nested probe body")

    stmt(expr)
    choice_items = tuple((s, choice_of(s)) for s in dict_ann)
    plan_params = tuple(
        (p.name, p.type.kind if isinstance(p.type, L.ScalarT) else str(p.type))
        for p in L.params_of(expr)
    )
    return P.Plan(tuple(nodes), result[0], choice_items, plan_params)


def _lane_contrib(fx: L.Expr) -> L.Expr:
    """A record field's per-row contribution: SemiringAgg lanes contribute
    their payload expression, plain fields contribute themselves."""
    return fx.contribution() if isinstance(fx, L.SemiringAgg) else fx


def _lane_combine(fx: L.Expr) -> str:
    return fx.combine if isinstance(fx, L.SemiringAgg) else "sum"


def _norm_ops(ops: Tuple[str, ...]) -> Tuple[str, ...]:
    """All-sum lanes normalize to the empty tuple — the legacy encoding, so
    sum-only plans keep their structure (fingerprints, describe goldens)."""
    return () if all(o == "sum" for o in ops) else ops


def _value_lanes(
    val: L.Expr,
) -> Tuple[Tuple[Tuple[str, L.Expr], ...], Tuple[str, ...]]:
    """Aggregate lanes + per-lane combine ops of a dictionary value.
    ``record * m`` (the Fig. 6c ``aggfn(r) * r.val`` shape with a record
    aggregate) distributes the multiplicity into each *additive* lane —
    ``min``/``max`` lanes ignore bag multiplicity."""
    if isinstance(val, L.RecordCtor):
        lanes = tuple((a, _lane_contrib(fx)) for a, fx in val.fields)
        ops = _norm_ops(tuple(_lane_combine(fx) for _, fx in val.fields))
        return lanes, ops
    if isinstance(val, L.BinOp) and val.op == "*":
        for rec, mult in ((val.lhs, val.rhs), (val.rhs, val.lhs)):
            if isinstance(rec, L.RecordCtor):
                lanes = []
                ops = []
                for a, fx in rec.fields:
                    op = _lane_combine(fx)
                    cx = _lane_contrib(fx)
                    if op == "sum":
                        cx = L.BinOp("*", cx, mult)
                    lanes.append((a, cx))
                    ops.append(op)
                return tuple(lanes), _norm_ops(tuple(ops))
    if isinstance(val, L.SemiringAgg):
        return (("_0", val.contribution()),), _norm_ops((val.combine,))
    return (("_0", val),), ()


def _value_fields(val: L.Expr) -> Tuple[Tuple[str, L.Expr], ...]:
    """Aggregate lanes of a dictionary value (compat view of
    ``_value_lanes`` without the combine ops)."""
    return _value_lanes(val)[0]


def _record_lanes(
    fields: Tuple[Tuple[str, L.Expr], ...],
) -> Tuple[Tuple[Tuple[str, L.Expr], ...], Tuple[str, ...]]:
    """Scalar-aggregate record lanes (Reduce): contributions + combine ops.
    No multiplicity distribution here — the executor's ``scalar_aggregate``
    applies bag multiplicity to additive lanes itself."""
    lanes = tuple((a, _lane_contrib(fx)) for a, fx in fields)
    ops = _norm_ops(tuple(_lane_combine(fx) for _, fx in fields))
    return lanes, ops


def _find_lookup(e: L.Expr):
    for n in L.walk(e):
        if isinstance(n, (L.DictLookup, L.HintedLookup)):
            return n
    return None


def _strip_lookup(e: L.Expr, lk: L.Expr) -> L.Expr:
    """Remove the multiplicative lookup factor, keeping f(r): rewrites the
    lookup node to the constant 1."""
    return L.rewrite(e, lambda n: L.Const(1.0, L.DOUBLE) if n is lk else n)


# ---------------------------------------------------------------------------
# structural analysis view (compat shim over compile)
# ---------------------------------------------------------------------------

_OPERATOR_NODES = (P.HashBuild, P.GroupBy, P.GroupJoin, P.HashProbe, P.Reduce)


@dataclass
class Program:
    """Flattened operator view of a compiled plan (historic ``analyze`` API:
    ``phases`` are the operator nodes, Scans/Selects/Projects elided)."""

    dict_syms: Dict[str, Optional[str]] = field(default_factory=dict)
    ref_syms: Dict[str, L.Type] = field(default_factory=dict)
    phases: List[object] = field(default_factory=list)
    result: Optional[str] = None


def analyze(e: L.Expr) -> Program:
    plan = compile(e)
    prog = Program()
    for n in L.walk(e):
        if isinstance(n, L.Let):
            if isinstance(n.value, L.DictNew) and n.value.key is None:
                prog.dict_syms[n.name] = n.value.ds
            elif isinstance(n.value, L.RefNew):
                prog.ref_syms[n.name] = n.value.type
    prog.phases = [n for n in plan.nodes if isinstance(n, _OPERATOR_NODES)]
    prog.result = plan.result
    return prog


# ---------------------------------------------------------------------------
# execution entry point
# ---------------------------------------------------------------------------


def execute(
    expr: L.Expr,
    db: Dict[str, Table],
    choices: Optional[GammaDict] = None,
    sigma: Optional[CardModel] = None,
    params: Optional[Dict[str, object]] = None,
):
    """Compile, fuse, and run.  Returns a ``DictResult`` for
    dictionary-valued programs, a ``Table`` for relation results, or a dict
    of scalars for Ref results.  On unrecognized structure, tables on the
    CPU fall back to the interpreter; tables on any other device raise a
    ``PlanError`` rather than leave the device."""
    from repro_torch.exec import engine as E

    try:
        plan = P.fuse(compile(expr, choices), sigma=sigma)
        return E.execute_plan(plan, db, sigma=sigma, params=params)
    except _Unsupported as why:
        off_cpu = sorted({str(t.device) for t in db.values()} - {"cpu"})
        if off_cpu:
            raise PlanError(f"LLQL lowering unsupported on {off_cpu}: {why}") from why
        warnings.warn(f"LLQL lowering fell back to interpreter: {why}")
        return _interpret_fallback(expr, db, params=params)


def _interpret_fallback(
    expr: L.Expr, db: Dict[str, Table], params: Optional[Dict[str, object]] = None
):
    from . import interp as I

    pydb = {}
    for name, t in db.items():
        mask = to_numpy(t.live_mask())
        cols = {k: to_numpy(v) for k, v in t.columns.items()}
        rows = [
            {k: v[i].item() for k, v in cols.items()}
            for i in range(t.nrows)
            if mask[i]
        ]
        pydb[name] = I.relation(rows, name)
    return I.run(expr, pydb, params=params)
