"""Reference interpreter for LLQL — the executable semantics of the language.

This is deliberately *slow and obviously correct*: dictionaries are Python
dicts, records are immutable field maps, iteration follows the annotation
(``@st``-family iterates in key order, ``@ht``-family in insertion order).
It is the oracle for (1) the vectorized JAX lowering in ``core.lower`` and
(2) the per-backend dictionary implementations in ``repro_torch.dicts``.

Besides values, the interpreter collects **operation statistics** per
dictionary symbol (inserts, hits, misses, hinted ops, orderedness of the
access sequence).  The cost-model tests use these to validate the static
cost inference of ``core.cost`` against actually-executed operation counts —
the paper's Γ/Σ reasoning checked against ground truth.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dfield
from typing import Any, Dict, List, Optional, Tuple

from . import llql as L

# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------


class Missing:
    """Result of a failed lookup: behaves as additive zero, empty dict, and a
    record of zeros — matching the paper's bag semantics where absent keys
    have multiplicity 0."""

    _inst: Optional["Missing"] = None

    def __new__(cls) -> "Missing":
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self) -> str:
        return "MISSING"


MISSING = Missing()


@dataclass(frozen=True)
class Rec:
    """Immutable record value; supports field-wise + and scalar *."""

    fields: Tuple[Tuple[str, Any], ...]

    def get(self, name: str) -> Any:
        for a, v in self.fields:
            if a == name:
                return v
        raise KeyError(f"record has no field {name!r}: {self.fields}")

    def names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.fields)

    def __add__(self, other: Any) -> "Rec":
        if isinstance(other, Missing):
            return self
        assert isinstance(other, Rec) and self.names() == other.names(), (
            f"record shape mismatch: {self.names()} vs {other}"
        )
        return Rec(
            tuple(
                (a, value_add(v, other.get(a))) for a, v in self.fields
            )
        )

    __radd__ = __add__

    def __mul__(self, s: Any) -> "Rec":
        return Rec(tuple((a, v * s) for a, v in self.fields))

    __rmul__ = __mul__

    def sort_key(self) -> Tuple:
        return tuple(v for _, v in self.fields)

    def __repr__(self) -> str:
        return "{" + ", ".join(f"{a}={v}" for a, v in self.fields) + "}"


@dataclass(frozen=True)
class SRVal:
    """A semiring lane value (``L.SemiringAgg``): a scalar that combines
    under its own monoid instead of ``+``.  Multiplicity scaling applies to
    additive lanes only — ``min``/``max`` over a bag ignore multiplicity."""

    op: str  # combine monoid: "sum" | "min" | "max"
    value: Any

    def __add__(self, other: Any) -> "SRVal":
        if isinstance(other, Missing):
            return self
        if isinstance(other, SRVal):
            assert other.op == self.op, f"lane combine mismatch {self.op}/{other.op}"
            o = other.value
        else:
            # a ref cell's pristine zero record: identity for every monoid
            if other == 0:
                return self
            o = other
        if self.op == "min":
            return SRVal(self.op, min(self.value, o))
        if self.op == "max":
            return SRVal(self.op, max(self.value, o))
        return SRVal(self.op, self.value + o)

    __radd__ = __add__

    def __mul__(self, s: Any) -> "SRVal":
        if self.op == "sum":
            return SRVal(self.op, self.value * s)
        return self

    __rmul__ = __mul__

    def __repr__(self) -> str:
        return f"{self.op}:{self.value}"


def sr_value(v: Any) -> Any:
    """Unwrap a semiring lane value to its plain scalar."""
    return v.value if isinstance(v, SRVal) else v


@dataclass
class OpStats:
    """Per-dictionary operation counters — ground truth for the cost model."""

    inserts: int = 0
    update_hits: int = 0
    lookup_hits: int = 0
    lookup_misses: int = 0
    hinted_lookups: int = 0
    hinted_updates: int = 0
    # orderedness of the *update* and *lookup* key sequences
    update_keys_sorted: bool = True
    lookup_keys_sorted: bool = True
    _last_update_key: Any = None
    _last_lookup_key: Any = None

    def note_update(self, k: Any, hit: bool, hinted: bool) -> None:
        if hit:
            self.update_hits += 1
        else:
            self.inserts += 1
        if hinted:
            self.hinted_updates += 1
        kk = _orderable(k)
        if self._last_update_key is not None and kk < self._last_update_key:
            self.update_keys_sorted = False
        self._last_update_key = kk

    def note_lookup(self, k: Any, hit: bool, hinted: bool) -> None:
        if hit:
            self.lookup_hits += 1
        else:
            self.lookup_misses += 1
        if hinted:
            self.hinted_lookups += 1
        kk = _orderable(k)
        if self._last_lookup_key is not None and kk < self._last_lookup_key:
            self.lookup_keys_sorted = False
        self._last_lookup_key = kk


def _orderable(k: Any) -> Any:
    return k.sort_key() if isinstance(k, Rec) else k


class LDict:
    """An LLQL dictionary at runtime: a mutable map + its ``@ds`` annotation
    + op statistics.  ``@st``-family implementations iterate in key order."""

    def __init__(self, ds: Optional[str], name: str = "<anon>") -> None:
        self.ds = ds
        self.name = name
        self.data: Dict[Any, Any] = {}
        self.stats = OpStats()

    # -- semantics ---------------------------------------------------------
    def lookup(self, k: Any, hinted: bool = False) -> Any:
        hit = k in self.data
        self.stats.note_lookup(k, hit, hinted)
        return self.data[k] if hit else MISSING

    def update_add(self, k: Any, v: Any, hinted: bool = False) -> None:
        hit = k in self.data
        self.stats.note_update(k, hit, hinted)
        if hit:
            self.data[k] = value_add(self.data[k], v)
        else:
            self.data[k] = v

    def items(self) -> List[Tuple[Any, Any]]:
        if self.ds is not None and self.ds.startswith("st"):
            return sorted(self.data.items(), key=lambda kv: _orderable(kv[0]))
        return list(self.data.items())

    def __len__(self) -> int:
        return len(self.data)

    def __repr__(self) -> str:
        ann = f"@{self.ds} " if self.ds else ""
        return ann + "{{" + ", ".join(f"{k} -> {v}" for k, v in self.items()) + "}}"


class ItHint:
    """Iterator hint object (``d.iter``); position-carrying, per the paper."""

    def __init__(self, d: LDict) -> None:
        self.dict = d
        self.pos_key: Any = None  # last key serviced through this hint


@dataclass
class RefCell:
    value: Any

    def add(self, v: Any) -> None:
        self.value = value_add(self.value, v)


def value_add(a: Any, b: Any) -> Any:
    if isinstance(a, Missing):
        return b
    if isinstance(b, Missing):
        return a
    if isinstance(a, LDict) and isinstance(b, LDict):
        for k, v in b.items():
            a.update_add(k, v)
        return a
    return a + b


def zero_of(t: L.Type) -> Any:
    if isinstance(t, L.ScalarT):
        return {"int": 0, "double": 0.0, "bool": False, "string": ""}[t.kind]
    if isinstance(t, L.RecordT):
        return Rec(tuple((a, zero_of(ft)) for a, ft in t.fields))
    if isinstance(t, L.DictT):
        return LDict(t.ds)
    raise TypeError(f"no zero for {t}")


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

_BINOPS = {
    "+": value_add,
    "-": lambda a, b: a - b,
    "*": lambda a, b: (a * b),
    "/": lambda a, b: a / b,
    "%": lambda a, b: a % b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "&&": lambda a, b: bool(a) and bool(b),
    "||": lambda a, b: bool(a) or bool(b),
    "min": lambda a, b: min(a, b),
    "max": lambda a, b: max(a, b),
}


class Interp:
    def __init__(
        self,
        database: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.database = dict(database or {})
        self.params = dict(params or {})
        self.dicts: Dict[str, LDict] = {}  # let-bound dicts, for stats readout

    def run(self, e: L.Expr) -> Any:
        return self._eval(e, {})

    # -- helpers -----------------------------------------------------------
    def _as_ldict(self, v: Any, name: str = "<input>") -> LDict:
        if isinstance(v, LDict):
            return v
        if isinstance(v, dict):
            d = LDict(None, name)
            d.data = dict(v)
            return d
        raise TypeError(f"not a dictionary: {v!r}")

    # -- eval --------------------------------------------------------------
    def _eval(self, e: L.Expr, env: Dict[str, Any]) -> Any:
        if isinstance(e, L.Const):
            return e.value
        if isinstance(e, L.Param):
            if e.name not in self.params:
                raise NameError(f"unbound parameter {e.name}")
            return self.params[e.name]
        if isinstance(e, L.Var):
            if e.name not in env:
                raise NameError(f"unbound variable {e.name}")
            return env[e.name]
        if isinstance(e, L.Input):
            if e.name not in self.database:
                raise NameError(f"unknown input relation {e.name}")
            v = self.database[e.name]
            self.database[e.name] = v = self._as_ldict(v, e.name)
            return v
        if isinstance(e, L.Noop):
            return None
        if isinstance(e, L.Seq):
            self._eval(e.first, env)
            return self._eval(e.second, env)
        if isinstance(e, L.Let):
            v = self._eval(e.value, env)
            if isinstance(v, LDict) and v.name == "<anon>":
                v.name = e.name
                self.dicts[e.name] = v
            env2 = dict(env)
            env2[e.name] = v
            return self._eval(e.body, env2)
        if isinstance(e, L.If):
            c = self._eval(e.cond, env)
            return self._eval(e.then if c else e.els, env)
        if isinstance(e, L.RecordCtor):
            return Rec(tuple((a, self._eval(x, env)) for a, x in e.fields))
        if isinstance(e, L.FieldAccess):
            r = self._eval(e.rec, env)
            if isinstance(r, Missing):
                return MISSING
            if isinstance(r, RefCell):
                r = r.value
            assert isinstance(r, Rec), f"field access on non-record {r!r}"
            return sr_value(r.get(e.name))
        if isinstance(e, L.SemiringAgg):
            v = self._eval(e.contribution(), env)
            if isinstance(v, Missing):
                return MISSING
            return SRVal(e.combine, v)
        if isinstance(e, L.BinOp):
            a = self._eval(e.lhs, env)
            b = self._eval(e.rhs, env)
            if isinstance(a, Missing) or isinstance(b, Missing):
                return self._missing_binop(e.op, a, b)
            return _BINOPS[e.op](a, b)
        if isinstance(e, L.UnOp):
            v = self._eval(e.operand, env)
            if e.op == "!":
                return not v
            if e.op == "floor":
                import math

                return float(math.floor(v))
            return -v
        if isinstance(e, L.RefNew):
            return RefCell(zero_of(e.type))
        if isinstance(e, L.RefAdd):
            cell = self._eval(e.ref, env)
            assert isinstance(cell, RefCell)
            cell.add(self._eval(e.value, env))
            return None
        if isinstance(e, L.DictNew):
            d = LDict(e.ds)
            if e.key is not None:
                d.update_add(self._eval(e.key, env), self._eval(e.val, env))
                # singleton construction isn't a dictionary *operation*
                d.stats = OpStats()
            return d
        if isinstance(e, L.For):
            src = self._eval(e.source, env)
            if isinstance(src, Missing):
                return None
            src = self._as_ldict(src)
            env2 = dict(env)
            for k, v in src.items():
                env2[e.var] = Rec((("key", k), ("val", v)))
                self._eval(e.body, env2)
            return None
        if isinstance(e, L.DictUpdate):
            d = self._as_ldict(self._eval(e.dict, env))
            v = self._eval(e.value, env)
            if isinstance(v, Missing):
                return None  # missing probe ⇒ empty inner loop ⇒ no update
            d.update_add(self._eval(e.keyexpr, env), v)
            return None
        if isinstance(e, L.DictLookup):
            d = self._as_ldict(self._eval(e.dict, env))
            return d.lookup(self._eval(e.keyexpr, env))
        if isinstance(e, L.DictIter):
            return ItHint(self._as_ldict(self._eval(e.dict, env)))
        if isinstance(e, L.HintedUpdate):
            d = self._as_ldict(self._eval(e.dict, env))
            it = self._eval(e.hint, env)
            assert isinstance(it, ItHint) and it.dict is d, "hint/dict mismatch"
            k = self._eval(e.keyexpr, env)
            v = self._eval(e.value, env)
            if isinstance(v, Missing):
                return None
            d.update_add(k, v, hinted=True)
            it.pos_key = k
            return None
        if isinstance(e, L.HintedLookup):
            d = self._as_ldict(self._eval(e.dict, env))
            it = self._eval(e.hint, env)
            assert isinstance(it, ItHint) and it.dict is d, "hint/dict mismatch"
            k = self._eval(e.keyexpr, env)
            it.pos_key = k
            return d.lookup(k, hinted=True)
        raise TypeError(f"cannot interpret {type(e)}")  # pragma: no cover

    @staticmethod
    def _missing_binop(op: str, a: Any, b: Any) -> Any:
        # MISSING is additive zero and multiplicative annihilator; comparisons
        # against MISSING are vacuously false (absent row matches nothing).
        if op == "+":
            return value_add(a, b)
        if op in ("*", "-", "/"):
            if op == "-" and isinstance(b, Missing):
                return a
            return MISSING if op in ("*", "/") else (b if op == "-" else MISSING)
        if op in ("==", "!=", "<", "<=", ">", ">=", "&&"):
            return False
        if op == "||":
            return bool(a) if not isinstance(a, Missing) else bool(b) if not isinstance(b, Missing) else False
        raise TypeError(f"binop {op} on MISSING")


# ---------------------------------------------------------------------------
# Helpers to build relation inputs (bag semantics: row-record -> multiplicity)
# ---------------------------------------------------------------------------


def relation(rows: List[Dict[str, Any]], name: str = "<rel>") -> LDict:
    """Build an input relation as a dictionary row-record -> multiplicity."""
    d = LDict(None, name)
    for row in rows:
        k = Rec(tuple(sorted(row.items())))
        d.data[k] = d.data.get(k, 0) + 1
    return d


def run(
    e: L.Expr,
    database: Optional[Dict[str, Any]] = None,
    params: Optional[Dict[str, Any]] = None,
) -> Any:
    return Interp(database, params=params).run(e)
