"""LLQL — the paper's low-level, dictionary-based intermediate language (Fig. 5).

The IR is a small, typed, expression-oriented AST.  Dictionaries are the core
data type: relations are dictionaries from row-records to multiplicities (bag
semantics), join/aggregate state is a dictionary, and trie indices are nested
dictionaries.  The data-structure choice for every dictionary is an annotation
(``@ht`` / ``@st`` families) on its constructor — the whole point of the paper
is that this annotation is chosen by cost-based synthesis, not by the engine
developer.

Grammar coverage (paper Fig. 5):

    e ::= e ; e | () | let x = e in e | if(e) then e else e
        | { a = e, ... } | e.a | e bop e | uop e | n | r | false | true | "s"
        | ref(T) | e += e
        | @ds {{ e -> e }} | for (x <- e) e
        | e(e) += e | e(e) | e.iter | e<it>(e) += e | e<it>(e)

    T ::= @ds {{ T -> T }} | int | double | bool | string | { a: T, ... }

    @ds ::= @ht | @st | ... (any registered dictionary implementation id)

Design notes
------------
* Nodes are frozen dataclasses → hashable, structurally comparable, safe to
  use as pattern-matching subjects in the lowerer.
* ``DictNew.ds`` may be ``None`` — "unannotated"; synthesis (Alg. 1) fills it.
* Hinted ops carry the *name* of the iterator binding (``Let`` of ``DictIter``)
  exactly like the paper's ``dict<it>(k)`` surface syntax.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional, Tuple

# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Type:
    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.__class__.__name__


@dataclass(frozen=True)
class ScalarT(Type):
    kind: str  # "int" | "double" | "bool" | "string"

    def __str__(self) -> str:
        return self.kind


INT = ScalarT("int")
DOUBLE = ScalarT("double")
BOOL = ScalarT("bool")
STRING = ScalarT("string")


@dataclass(frozen=True)
class RecordT(Type):
    fields: Tuple[Tuple[str, Type], ...]

    def __str__(self) -> str:
        inner = ", ".join(f"{a}: {t}" for a, t in self.fields)
        return "{" + inner + "}"

    def field_type(self, name: str) -> Type:
        for a, t in self.fields:
            if a == name:
                return t
        raise KeyError(name)


@dataclass(frozen=True)
class DictT(Type):
    key: Type
    val: Type
    ds: Optional[str] = None  # implementation annotation, None = unchosen

    def __str__(self) -> str:
        pre = f"@{self.ds} " if self.ds else ""
        return pre + "{{" + f"{self.key} -> {self.val}" + "}}"


@dataclass(frozen=True)
class RefT(Type):
    inner: Type

    def __str__(self) -> str:
        return f"ref({self.inner})"


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Expr:
    def children(self) -> Tuple["Expr", ...]:
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Expr):
                out.append(v)
            elif isinstance(v, tuple):
                out.extend(x for x in v if isinstance(x, Expr))
            elif isinstance(v, dict):  # pragma: no cover - no dict fields today
                out.extend(x for x in v.values() if isinstance(x, Expr))
        return tuple(out)

    # Sugar so programs read like the paper.
    def __add__(self, other: "Expr") -> "Expr":
        return BinOp("+", self, _e(other))

    def __sub__(self, other: "Expr") -> "Expr":
        return BinOp("-", self, _e(other))

    def __mul__(self, other: "Expr") -> "Expr":
        return BinOp("*", self, _e(other))

    def __mod__(self, other: "Expr") -> "Expr":
        return BinOp("%", self, _e(other))

    def __lt__(self, other: "Expr") -> "Expr":
        return BinOp("<", self, _e(other))

    def __le__(self, other: "Expr") -> "Expr":
        return BinOp("<=", self, _e(other))

    def __gt__(self, other: "Expr") -> "Expr":
        return BinOp(">", self, _e(other))

    def __ge__(self, other: "Expr") -> "Expr":
        return BinOp(">=", self, _e(other))

    def eq(self, other: "Expr") -> "Expr":
        return BinOp("==", self, _e(other))

    def ne(self, other: "Expr") -> "Expr":
        return BinOp("!=", self, _e(other))

    def get(self, name: str) -> "Expr":
        return FieldAccess(self, name)

    # r.key / r.val sugar used everywhere in the paper's listings
    @property
    def key(self) -> "Expr":
        return FieldAccess(self, "key")

    @property
    def val(self) -> "Expr":
        return FieldAccess(self, "val")


def _e(x: Any) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, bool):
        return Const(x, BOOL)
    if isinstance(x, int):
        return Const(x, INT)
    if isinstance(x, float):
        return Const(x, DOUBLE)
    if isinstance(x, str):
        return Const(x, STRING)
    raise TypeError(f"cannot lift {x!r} into LLQL")


@dataclass(frozen=True)
class Const(Expr):
    value: Any
    type: Type


@dataclass(frozen=True)
class Param(Expr):
    """A free query parameter (``?name``): a scalar whose value is supplied at
    execution time, not synthesis time.  Parameterization is what makes the
    compile-once/execute-many split possible — synthesis and lowering see one
    program per query *shape*, and ``Plan.bind`` substitutes fresh values
    without re-synthesizing or re-tracing (DESIGN.md §6)."""

    name: str
    type: Type


@dataclass(frozen=True)
class Var(Expr):
    name: str


@dataclass(frozen=True)
class Noop(Expr):
    pass


@dataclass(frozen=True)
class Seq(Expr):
    first: Expr
    second: Expr


@dataclass(frozen=True)
class Let(Expr):
    name: str
    value: Expr
    body: Expr


@dataclass(frozen=True)
class If(Expr):
    cond: Expr
    then: Expr
    els: Expr = field(default_factory=Noop)


@dataclass(frozen=True)
class RecordCtor(Expr):
    fields: Tuple[Tuple[str, Expr], ...]


@dataclass(frozen=True)
class FieldAccess(Expr):
    rec: Expr
    name: str


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / && || == != < <= > >= min max
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class UnOp(Expr):
    op: str  # ! -
    operand: Expr


@dataclass(frozen=True)
class RefNew(Expr):
    """``ref(T)`` — a mutable scalar/record accumulator, initialised to zero."""

    type: Type


@dataclass(frozen=True)
class RefAdd(Expr):
    """``x += e`` where x binds a ``RefNew``."""

    ref: Expr
    value: Expr


@dataclass(frozen=True)
class DictNew(Expr):
    """``@ds {{ k -> v }}`` or the empty ``@ds {{ }}``.

    ``ds`` None means the implementation is left to synthesis.
    """

    ds: Optional[str] = None
    key: Optional[Expr] = None
    val: Optional[Expr] = None
    type: Optional[DictT] = None  # optional declared type


@dataclass(frozen=True)
class For(Expr):
    """``for (x <- e) body`` — iterate key/value pairs of a dictionary."""

    var: str
    source: Expr
    body: Expr


@dataclass(frozen=True)
class DictUpdate(Expr):
    """``d(k) += v``"""

    dict: Expr
    keyexpr: Expr
    value: Expr


@dataclass(frozen=True)
class DictLookup(Expr):
    """``d(k)``"""

    dict: Expr
    keyexpr: Expr


@dataclass(frozen=True)
class DictIter(Expr):
    """``d.iter``"""

    dict: Expr


@dataclass(frozen=True)
class HintedUpdate(Expr):
    """``d<it>(k) += v``"""

    dict: Expr
    hint: Expr
    keyexpr: Expr
    value: Expr


@dataclass(frozen=True)
class HintedLookup(Expr):
    """``d<it>(k)``"""

    dict: Expr
    hint: Expr
    keyexpr: Expr


# Semiring aggregate lanes (arXiv 2103.06376): LLQL dictionaries are semiring
# dictionaries — the value record of an aggregation dictionary (or a scalar
# ref record) is a product of semiring lanes, each combining row
# contributions under its own monoid.  ``sum``/``count``/``sum_product``
# combine additively (the numeric semiring the engine always had);
# ``min``/``max`` combine under the tropical semirings.  A lane's
# *contribution* is the per-row expression fed to the combine.

SEMIRING_OPS = ("sum", "count", "min", "max", "sum_product")

# lane combine monoid per semiring op (what the dictionary build applies)
SEMIRING_COMBINE = {
    "sum": "sum",
    "count": "sum",
    "sum_product": "sum",
    "min": "min",
    "max": "max",
}


@dataclass(frozen=True)
class SemiringAgg(Expr):
    """One semiring aggregate lane: ``op`` over a ``payload`` vector.

    Used as a field value inside the ``RecordCtor`` of a ``DictUpdate`` /
    ``RefAdd`` — the surface form of the paper's aggregation dictionaries,
    generalized beyond sums.  ``count`` takes no payload; ``sum``/``min``/
    ``max`` take one expression; ``sum_product`` multiplies its whole
    payload vector per row (the in-DB ML covariance entries)."""

    op: str
    payload: Tuple[Expr, ...] = ()

    def __post_init__(self) -> None:
        if self.op not in SEMIRING_OPS:
            raise ValueError(f"unknown semiring op {self.op!r}")
        if self.op == "count":
            if self.payload:
                raise ValueError("count takes no payload")
        elif not self.payload:
            raise ValueError(f"{self.op} needs a payload")
        elif self.op != "sum_product" and len(self.payload) != 1:
            raise ValueError(f"{self.op} takes exactly one payload expression")

    @property
    def combine(self) -> str:
        """The lane's combine monoid: "sum" | "min" | "max"."""
        return SEMIRING_COMBINE[self.op]

    def contribution(self) -> Expr:
        """The per-row contribution expression this lane feeds its combine."""
        if self.op == "count":
            return Const(1.0, DOUBLE)
        if self.op == "sum_product":
            out = self.payload[0]
            for x in self.payload[1:]:
                out = BinOp("*", out, x)
            return out
        return self.payload[0]


# A free relation/dictionary input to the program (a named table).
@dataclass(frozen=True)
class Input(Expr):
    name: str
    type: Optional[DictT] = None


# ---------------------------------------------------------------------------
# Traversal / rewriting helpers
# ---------------------------------------------------------------------------


def walk(e: Expr) -> Iterator[Expr]:
    """Pre-order traversal."""
    stack = [e]
    while stack:
        n = stack.pop()
        yield n
        stack.extend(reversed(n.children()))


def rewrite(e: Expr, fn) -> Expr:
    """Bottom-up rewrite: ``fn`` sees each node after its children were
    rewritten; returning the node unchanged keeps it."""

    def go(n: Expr) -> Expr:
        reps = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, Expr):
                nv = go(v)
                if nv is not v:
                    reps[f.name] = nv
            elif isinstance(v, tuple) and v and isinstance(v[0], tuple):
                # tuple of (name, Expr) pairs (RecordCtor.fields)
                nt = tuple(
                    (a, go(x)) if isinstance(x, Expr) else (a, x) for a, x in v
                )
                if nt != v:
                    reps[f.name] = nt
            elif isinstance(v, tuple) and v and isinstance(v[0], Expr):
                # plain tuple of Exprs (SemiringAgg.payload)
                nt = tuple(go(x) if isinstance(x, Expr) else x for x in v)
                if nt != v:
                    reps[f.name] = nt
        if reps:
            n = dataclasses.replace(n, **reps)
        return fn(n)

    return go(e)


def dict_symbols(e: Expr) -> Tuple[str, ...]:
    """Names of all ``let``-bound dictionaries constructed in the program, in
    program order (Alg. 1 line 2: ExtractDictSymbols)."""
    out = []
    for n in walk(e):
        if isinstance(n, Let) and isinstance(n.value, DictNew):
            out.append(n.name)
    return tuple(out)


def params_of(e: Expr) -> Tuple["Param", ...]:
    """Free parameters of a program, in first-occurrence order, deduped by
    name.  A name appearing with two different types is a program error."""
    seen: dict = {}
    for n in walk(e):
        if isinstance(n, Param):
            prev = seen.get(n.name)
            if prev is not None and prev != n:
                raise TypeError(
                    f"parameter {n.name!r} declared with conflicting types"
                )
            seen.setdefault(n.name, n)
    return tuple(seen.values())


def bind_params(e: Expr, bindings: dict) -> Expr:
    """Substitute ``Param`` nodes with ``Const`` values — the const-baked
    program a non-parameterized pipeline would have written.  Used by tests
    to check bound plans against the one-program-per-value path; the fast
    path never rewrites (``Plan.bind`` passes values at runtime)."""

    def fn(n: Expr) -> Expr:
        if isinstance(n, Param):
            if n.name not in bindings:
                raise KeyError(f"unbound parameter {n.name!r}")
            return Const(bindings[n.name], n.type)
        return n

    return rewrite(e, fn)


def annotate(e: Expr, choices: dict) -> Expr:
    """Replace the ``@ds`` annotation of each let-bound dictionary symbol with
    the synthesis choice (Alg. 1 line 9: ChooseDictDS)."""

    def fn(n: Expr) -> Expr:
        if isinstance(n, Let) and isinstance(n.value, DictNew) and n.name in choices:
            return dataclasses.replace(
                n, value=dataclasses.replace(n.value, ds=choices[n.name])
            )
        return n

    return rewrite(e, fn)


# ---------------------------------------------------------------------------
# Pretty printer (paper surface syntax)
# ---------------------------------------------------------------------------


def pretty(e: Expr, indent: int = 0) -> str:
    pad = "  " * indent

    def p(x: Expr) -> str:
        return pretty(x, indent)

    if isinstance(e, Const):
        return repr(e.value)
    if isinstance(e, Param):
        return f"?{e.name}"
    if isinstance(e, Var):
        return e.name
    if isinstance(e, Input):
        return e.name
    if isinstance(e, Noop):
        return "()"
    if isinstance(e, Seq):
        return f"{p(e.first)} ;\n{pad}{p(e.second)}"
    if isinstance(e, Let):
        return (
            f"let {e.name} = {p(e.value)} in\n{pad}{pretty(e.body, indent)}"
        )
    if isinstance(e, If):
        if isinstance(e.els, Noop):
            return f"if({p(e.cond)}) then {p(e.then)} else ()"
        return f"if({p(e.cond)}) then {p(e.then)} else {p(e.els)}"
    if isinstance(e, RecordCtor):
        inner = ", ".join(f"{a} = {p(x)}" for a, x in e.fields)
        return "{ " + inner + " }"
    if isinstance(e, FieldAccess):
        return f"{p(e.rec)}.{e.name}"
    if isinstance(e, BinOp):
        return f"({p(e.lhs)} {e.op} {p(e.rhs)})"
    if isinstance(e, UnOp):
        return f"({e.op}{p(e.operand)})"
    if isinstance(e, RefNew):
        return f"ref({e.type})"
    if isinstance(e, RefAdd):
        return f"{p(e.ref)} += {p(e.value)}"
    if isinstance(e, DictNew):
        ann = f"@{e.ds} " if e.ds else ""
        if e.key is None:
            return ann + "{{ }}"
        return ann + "{{ " + f"{p(e.key)} -> {p(e.val)}" + " }}"
    if isinstance(e, For):
        return (
            f"for({e.var} <- {p(e.source)}) {{\n"
            + "  " * (indent + 1)
            + pretty(e.body, indent + 1)
            + f"\n{pad}}}"
        )
    if isinstance(e, DictUpdate):
        return f"{p(e.dict)}({p(e.keyexpr)}) += {p(e.value)}"
    if isinstance(e, DictLookup):
        return f"{p(e.dict)}({p(e.keyexpr)})"
    if isinstance(e, DictIter):
        return f"{p(e.dict)}.iter"
    if isinstance(e, HintedUpdate):
        return f"{p(e.dict)}<{p(e.hint)}>({p(e.keyexpr)}) += {p(e.value)}"
    if isinstance(e, HintedLookup):
        return f"{p(e.dict)}<{p(e.hint)}>({p(e.keyexpr)})"
    if isinstance(e, SemiringAgg):
        inner = ", ".join(p(x) for x in e.payload)
        return f"{e.op}({inner})"
    raise TypeError(f"unknown node {type(e)}")  # pragma: no cover


# ---------------------------------------------------------------------------
# Convenience builders (used by core.operators and tests)
# ---------------------------------------------------------------------------


def let(name: str, value: Expr, body: Expr) -> Let:
    return Let(name, value, body)


def seq(*exprs: Expr) -> Expr:
    exprs = [x for x in exprs if not isinstance(x, Noop)]
    if not exprs:
        return Noop()
    out = exprs[-1]
    for x in reversed(exprs[:-1]):
        out = Seq(x, out)
    return out


def record(**fields: Expr) -> RecordCtor:
    return RecordCtor(tuple((k, _e(v)) for k, v in fields.items()))


def const(v: Any) -> Const:
    return _e(v)  # type: ignore[return-value]
