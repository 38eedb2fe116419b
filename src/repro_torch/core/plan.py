"""Physical-plan IR — the bridge between synthesized LLQL and execution.

DBFlex generates specialized C++ straight from the annotated LLQL program;
here the same role is split in two: ``core.lower.compile`` turns the LLQL
program into this small physical-plan IR, and an *executor* realizes the
plan — single-shard (``repro_torch.exec.engine.execute_plan``; the reference
also runs it sharded, ``repro.exec.distributed.execute_plan_sharded``).  The plan is
the paper's "generated engine" made explicit as data: every dictionary-
producing node carries the ``DictChoice`` the synthesizer made for it, so one
plan object serves costing, single-core execution, and scale-out.

Node vocabulary (DESIGN.md §3):

* ``Scan``      — bind a loop variable over a base relation, a derived
                  relation (a previous join/projection output), or the
                  key/value pairs of a materialized dictionary (dict-scan);
* ``Select``    — static-shape filter (mask, never compaction);
* ``Project``   — materialize named columns from the current frame; the
                  output is a *relation* downstream Scans can iterate;
* ``HashBuild`` — key → row-index dictionary (join index) with its choice;
* ``HashProbe`` — probe a built index, binding the inner loop variable to
                  the gathered build-side row (FK join);
* ``GroupBy``   — dictionary aggregate build (Fig. 6c/6d);
* ``GroupJoin`` — Fig. 6e/6f compound probe+aggregate;
* ``Reduce``    — scalar aggregation into a ref, with the optional
                  interleaved lookup of Fig. 7b;
* ``Exchange``  — cross-shard merge of a per-shard dictionary (shuffle by
                  key hash, or all-reduce for scalar refs).  Identity on a
                  single shard.
* ``Repartition`` — cross-shard movement of *rows* (a frame): ``hash``
                  routes every row to the shard owning ``hash(keyexpr)``,
                  ``broadcast`` all-gathers the rows onto every shard.
                  Identity on a single shard.

Distribution is planned, not hard-coded: every symbol carries a
*partitioning property* — :class:`Replicated`, :class:`ShardedArbitrary`, or
:class:`HashPartitioned` — and :func:`legalize` converts between properties
by inserting explicit ``Repartition``/``Exchange`` nodes (DESIGN.md §4).

Expressions inside nodes are LLQL row expressions over the loop variables
bound by the node chain (``Scan.var`` / ``HashProbe.inner_var``); executors
compile them to columnar jnp values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

from . import llql as L
from .cost import DictChoice, GammaDict


@dataclass(frozen=True)
class Node:
    out: str  # symbol this node defines (frame, relation, dict, or ref)


@dataclass(frozen=True)
class Scan(Node):
    source: str  # base relation, derived relation symbol, or dict symbol
    var: str  # LLQL loop variable bound to the rows


@dataclass(frozen=True)
class Select(Node):
    source: str
    pred: L.Expr  # row predicate over the frame's bound variables


@dataclass(frozen=True)
class Project(Node):
    source: str
    fields: Tuple[Tuple[str, L.Expr], ...]  # name -> row expression


@dataclass(frozen=True)
class HashBuild(Node):
    source: str
    keyexpr: L.Expr
    choice: DictChoice
    hinted: bool = False  # program-level hinted insert (Fig. 6b/6d form)


@dataclass(frozen=True)
class GroupBy(Node):
    source: str
    keyexpr: L.Expr
    values: Tuple[Tuple[str, L.Expr], ...]  # aggregate lanes
    choice: DictChoice
    hinted: bool = False
    # per-lane semiring combine monoids ("sum" | "min" | "max"), aligned with
    # ``values``; empty means all-sum — the engine's historical behaviour
    ops: Tuple[str, ...] = ()


@dataclass(frozen=True)
class HashProbe(Node):
    source: str
    build: str  # HashBuild output symbol
    keyexpr: L.Expr
    inner_var: str  # variable bound to the matched build-side row
    hinted: bool = False  # program-level hinted lookup (merge form)


@dataclass(frozen=True)
class GroupJoin(Node):
    source: str
    build: str  # GroupBy output symbol holding g-side partial aggregates
    keyexpr: L.Expr
    f_expr: L.Expr  # multiplicand over the probe side (lookup stripped)
    choice: DictChoice
    hinted: bool = False


@dataclass(frozen=True)
class Reduce(Node):
    source: str
    fields: Tuple[Tuple[str, L.Expr], ...]
    lookup_sym: Optional[str] = None  # Fig. 7b interleaved lookup
    lookup_key: Optional[L.Expr] = None
    lookup_var: Optional[str] = None
    # per-field semiring combine monoids ("sum" | "min" | "max"), aligned
    # with ``fields``; empty means all-sum (the historical scalar Σ)
    ops: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Exchange(Node):
    source: str  # per-shard dictionary symbol to merge
    kind: str  # "shuffle" | "allreduce"
    choice: DictChoice = field(default_factory=DictChoice)
    # per-lane semiring combine monoids for the cross-shard merge, copied
    # from the producing GroupBy/Reduce by ``legalize``: ``ops`` aligns with
    # the dictionary's value lanes (shuffle merges re-build with these);
    # ``field_ops`` maps scalar-record field name -> op (allreduce merges
    # psum/pmin/pmax per field).  Empty means all-sum — the legacy merge.
    ops: Tuple[str, ...] = ()
    field_ops: Tuple[Tuple[str, str], ...] = ()


@dataclass(frozen=True)
class Pipeline(Node):
    """A fused region: a maximal chain of row-parallel nodes
    (``Scan → Select* → HashProbe* → GroupBy/GroupJoin/Reduce/HashBuild/
    Project``) executed as ONE streaming pass — fact rows travel
    HBM→VMEM once, predicates become in-register masks, probed dictionaries
    stay resident, and only the terminal node's output is materialized
    (DESIGN.md §7).  Formed by :func:`fuse` as a *costed* choice under
    ``cost.FusionCostModel`` (Δ_fuse), never by default.

    ``source`` is the symbol the first stage consumes: a base relation or
    dictionary symbol when ``stages[0]`` is a ``Scan``, otherwise a frame
    symbol produced by an (unfused) upstream node — the latter is how a
    region *split* at a probe boundary re-enters the plan.  ``out`` equals
    ``stages[-1].out``; intermediate stage symbols are private to the
    region and never materialize.

    ``partitions > 0`` marks the region for **radix-partitioned** fused
    execution (DESIGN.md §8): ``part_sym``'s dictionary exceeds the
    per-slab residency bound, so fact rows and dictionary slabs are
    co-partitioned by the probe key's radix and each grid step co-resides
    one partition — priced against the split-materialized alternative by
    ``FusionCostModel.delta_partition``, never a default.  Executors
    without a partitioned substrate (the XLA region path) run the region
    as one computation regardless — the field changes execution strategy,
    never semantics."""

    source: str
    stages: Tuple[Node, ...] = ()
    partitions: int = 0
    part_sym: str = ""


@dataclass(frozen=True)
class Repartition(Node):
    """Move frame rows across shards: ``hash`` routes each row to the shard
    owning ``hash(keyexpr)`` (the dictionaries' own mix, so a dictionary
    built after a hash repartition is co-partitioned with every other symbol
    hashed on the same key values); ``broadcast`` all-gathers the rows so
    every shard holds all of them.  Identity on a single shard."""

    source: str  # frame symbol to move
    kind: str  # "hash" | "broadcast"
    keyexpr: Optional[L.Expr] = None  # hash only: partitioning expression


DICT_NODES = (HashBuild, GroupBy, GroupJoin)


# ---------------------------------------------------------------------------
# Partitioning properties
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Replicated:
    """Every shard holds the full data (dimension tables, merged scalars)."""


@dataclass(frozen=True)
class ShardedArbitrary:
    """Rows are split across shards with no key alignment; ``rel`` names the
    sharded base relation the rows descend from ("?" when mixed/derived)."""

    rel: str = "?"


@dataclass(frozen=True)
class HashPartitioned:
    """Rows/entries are owned by ``hash(key) % n_shards``.

    ``key`` is the partitioning witness: an LLQL expression for frames (the
    routed key expression, compared structurally for co-partitioning), a
    column name for relations (Project outputs), and ``None`` for
    dictionaries — a dictionary is always partitioned by its own key."""

    key: Optional[object] = None


Partitioning = Union[Replicated, ShardedArbitrary, HashPartitioned]


@dataclass(frozen=True)
class Plan:
    nodes: Tuple[Node, ...]
    result: Optional[str]  # symbol of the program result (None: ref record)
    choices: Tuple[Tuple[str, DictChoice], ...] = ()
    # free query parameters: (name, scalar kind) — row expressions inside
    # nodes may reference them as ``L.Param``; executors receive the values
    # at call time (as traced jit arguments, so rebinding never re-traces)
    params: Tuple[Tuple[str, str], ...] = ()

    def choice_map(self) -> GammaDict:
        return dict(self.choices)

    def param_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.params)

    def bind(self, bindings: Optional[Dict[str, object]] = None, **kw) -> "BoundPlan":
        """Attach parameter values — a cheap substitution, not a recompile.
        The returned ``BoundPlan`` is accepted everywhere a ``Plan`` is; the
        values are passed to the (cached) executable as runtime arrays."""
        vals = {**(bindings or {}), **kw}
        unknown = set(vals) - set(self.param_names())
        if unknown:
            raise KeyError(f"unknown parameters {sorted(unknown)}")
        missing = set(self.param_names()) - set(vals)
        if missing:
            raise KeyError(f"missing bindings for {sorted(missing)}")
        return BoundPlan(self, tuple(sorted(vals.items())))

    def fingerprint(self) -> str:
        """Stable structural identity of the plan — node tree (including row
        expressions and baked constants), result symbol, per-dictionary
        choices, and free parameters.  Two plans with equal fingerprints
        compute the same function of (database, parameter values); the
        executable cache keys on it."""
        import hashlib

        blob = repr((self.nodes, self.result, self.choices, self.params))
        return hashlib.sha1(blob.encode()).hexdigest()

    def node_defining(self, sym: str) -> Optional[Node]:
        for n in self.nodes:
            if n.out == sym:
                return n
        return None

    def dict_nodes(self) -> Iterator[Node]:
        for n in self.nodes:
            if isinstance(n, DICT_NODES):
                yield n

    def describe(self) -> str:
        """Stable rendering (golden tests, explain): one line per node, with
        ``Pipeline`` regions rendering their fused stages indented."""
        lines = []
        for n in self.nodes:
            if isinstance(n, Pipeline):
                radix = (
                    f", radix P={n.partitions} on {n.part_sym}"
                    if n.partitions
                    else ""
                )
                lines.append(
                    f"Pipeline {n.out} <- {n.source} "
                    f"[{len(n.stages)} stages{radix}]"
                )
                lines.extend("  | " + _describe_node(s) for s in n.stages)
            else:
                lines.append(_describe_node(n))
        lines.append(f"Result {self.result}")
        return "\n".join(lines)


def _render_ops(ops: Tuple[str, ...]) -> str:
    """Render a node's semiring combine ops — only when they carry
    information (non-empty, not all-sum), so legacy describe goldens hold."""
    if not ops or all(o == "sum" for o in ops):
        return ""
    return " ops=" + ",".join(ops)


def _describe_node(n: Node) -> str:
    if isinstance(n, Scan):
        return f"Scan {n.out} <- {n.source} as {n.var}"
    if isinstance(n, Select):
        return f"Select {n.out} <- {n.source}"
    if isinstance(n, Project):
        cols = ",".join(a for a, _ in n.fields)
        return f"Project {n.out} <- {n.source} [{cols}]"
    if isinstance(n, HashBuild):
        return f"HashBuild {n.out} <- {n.source} [{n.choice}]"
    if isinstance(n, GroupBy):
        lanes = ",".join(a for a, _ in n.values)
        ops = _render_ops(n.ops)
        return f"GroupBy {n.out} <- {n.source} [{n.choice}] lanes={lanes}{ops}"
    if isinstance(n, HashProbe):
        return f"HashProbe {n.out} <- {n.source} ⋈ {n.build} as {n.inner_var}"
    if isinstance(n, GroupJoin):
        return f"GroupJoin {n.out} <- {n.source} ⋈ {n.build} [{n.choice}]"
    if isinstance(n, Reduce):
        lanes = ",".join(a for a, _ in n.fields)
        lk = f" lookup={n.lookup_sym}" if n.lookup_sym else ""
        ops = _render_ops(n.ops)
        return f"Reduce {n.out} <- {n.source} lanes={lanes}{lk}{ops}"
    if isinstance(n, Exchange):
        return f"Exchange {n.out} <- {n.source} ({n.kind}) [{n.choice}]"
    if isinstance(n, Repartition):
        how = f"hash {L.pretty(n.keyexpr)}" if n.kind == "hash" else n.kind
        return f"Repartition {n.out} <- {n.source} ({how})"
    return repr(n)  # pragma: no cover


@dataclass(frozen=True)
class BoundPlan:
    """A plan plus parameter values: the unit of a serving request.  Binding
    is O(#params) — no synthesis, no lowering, no tracing happens here."""

    plan: Plan
    bindings: Tuple[Tuple[str, object], ...]

    def binding_map(self) -> Dict[str, object]:
        return dict(self.bindings)


class PlanShardError(Exception):
    """The plan cannot be realized under the sharded executor.  Since the
    partitioning-property legalizer replaced the taint-bit analysis this is
    reserved for genuinely unknown node kinds — sharded builds, probes of
    sharded dictionaries, and sharded groupjoins/reduce-lookups all legalize
    into Repartition/Exchange nodes instead of raising."""


def _frame_key(var: str, col: Optional[str] = None) -> L.Expr:
    """Partitioning witness for a frame bound by ``Scan(var)``: the key of a
    dict scan (``var.key``) or a named column (``var.key.col``)."""
    key = L.FieldAccess(L.Var(var), "key")
    return key if col is None else L.FieldAccess(key, col)


def legalize(
    plan: Plan, sharded_rels: Tuple[str, ...]
) -> Tuple[Plan, Dict[str, Partitioning]]:
    """Rewrite a single-shard plan for sharded execution by tracking a
    partitioning property per symbol and inserting explicit conversion nodes
    (DESIGN.md §4).  Returns ``(plan', props)``.

    * A dictionary built from sharded rows is *placed*: ``partition`` (the
      default) hash-repartitions the build rows by the build key and builds
      per-shard slices; ``broadcast`` (``DictChoice.placement``) all-gathers
      the rows and builds a replicated copy.  The choice is made by synthesis
      under Δ_net, not hard-coded here.
    * A probe of a hash-partitioned dictionary repartitions the probe side to
      match (co-partitioned join) — unless the probe frame is already
      partitioned on the same key expression (elided), or replicated (each
      shard's found-mask then selects exactly the keys it owns: a
      "mask-partitioned" probe needing no data movement).
    * ``GroupBy``/``GroupJoin`` over sharded rows keep the per-shard partial
      + shuffle-``Exchange`` form, but the Exchange is *elided* when the
      input frame is already hash-partitioned on the group key.
    * Scalar ``Reduce`` results over sharded (or mask-partitioned) rows get
      an all-reduce ``Exchange``.
    """
    props: Dict[str, Partitioning] = {}
    out_nodes: List[Node] = []
    fresh_ctr = [0]

    def prop(sym: str) -> Partitioning:
        return props.get(sym, Replicated())

    def emit(n: Node) -> None:
        out_nodes.append(n)

    def repartitioned(frame: str, keyexpr: L.Expr) -> str:
        """Frame symbol holding ``frame``'s rows hash-routed by ``keyexpr``."""
        p = prop(frame)
        if isinstance(p, HashPartitioned) and p.key == keyexpr:
            return frame
        out = f"{frame}#part{fresh_ctr[0]}"
        fresh_ctr[0] += 1
        emit(Repartition(out, source=frame, kind="hash", keyexpr=keyexpr))
        props[out] = HashPartitioned(keyexpr)
        return out

    def broadcasted(frame: str) -> str:
        """Frame symbol holding ``frame``'s rows gathered onto every shard."""
        if isinstance(prop(frame), Replicated):
            return frame
        out = f"{frame}#bcast{fresh_ctr[0]}"
        fresh_ctr[0] += 1
        emit(Repartition(out, source=frame, kind="broadcast"))
        props[out] = Replicated()
        return out

    def copartitioned(frame: str, keyexpr: L.Expr) -> bool:
        p = prop(frame)
        return isinstance(p, HashPartitioned) and p.key == keyexpr

    def partial_with_exchange(n: Node) -> None:
        local = _rename(n, n.out + "#local")
        emit(local)
        props[local.out] = ShardedArbitrary()
        emit(Exchange(
            n.out, source=local.out, kind="shuffle", choice=n.choice,
            ops=tuple(getattr(n, "ops", ()) or ()),
        ))
        props[n.out] = HashPartitioned()  # merged slices own their key hashes

    for n in plan.nodes:
        if isinstance(n, Scan):
            if n.source in sharded_rels:
                props[n.out] = ShardedArbitrary(n.source)
            else:
                p = prop(n.source)
                if isinstance(p, HashPartitioned):
                    # dict scan / derived relation: partitioned-by-own-key
                    # becomes partitioned on the bound variable's key expr
                    col = p.key if isinstance(p.key, str) else None
                    props[n.out] = HashPartitioned(_frame_key(n.var, col))
                else:
                    props[n.out] = p
            emit(n)
        elif isinstance(n, Select):
            props[n.out] = prop(n.source)  # masking moves no rows
            emit(n)
        elif isinstance(n, Project):
            p = prop(n.source)
            if isinstance(p, HashPartitioned):
                # partitioned on a projected column iff some output column is
                # exactly the partitioning expression
                cols = [a for a, fx in n.fields if fx == p.key]
                props[n.out] = (
                    HashPartitioned(cols[0]) if cols else ShardedArbitrary()
                )
            else:
                props[n.out] = p
            emit(n)
        elif isinstance(n, HashBuild):
            p = prop(n.source)
            if isinstance(p, Replicated):
                props[n.out] = Replicated()
                emit(n)
            elif copartitioned(n.source, n.keyexpr):
                props[n.out] = HashPartitioned()
                emit(n)
            elif getattr(n.choice, "placement", "") == "broadcast":
                emit(_resrc(n, broadcasted(n.source)))
                props[n.out] = Replicated()
            else:  # co-partitioned placement (default)
                emit(_resrc(n, repartitioned(n.source, n.keyexpr)))
                props[n.out] = HashPartitioned()
        elif isinstance(n, HashProbe):
            bp = prop(n.build)
            if isinstance(bp, Replicated):
                props[n.out] = prop(n.source)
                emit(n)
            elif isinstance(prop(n.source), Replicated):
                # replicated probe rows against a partitioned dict: the local
                # found-mask keeps exactly the keys this shard owns — the
                # result is hash-partitioned with zero data movement
                props[n.out] = HashPartitioned(n.keyexpr)
                emit(n)
            else:
                src = (
                    n.source
                    if copartitioned(n.source, n.keyexpr)
                    else repartitioned(n.source, n.keyexpr)
                )
                props[n.out] = HashPartitioned(n.keyexpr)
                emit(_resrc(n, src))
        elif isinstance(n, GroupBy):
            p = prop(n.source)
            if isinstance(p, Replicated):
                props[n.out] = Replicated()
                emit(n)
            elif copartitioned(n.source, n.keyexpr):
                # input already owns its group keys: elide the Exchange
                props[n.out] = HashPartitioned()
                emit(n)
            else:
                partial_with_exchange(n)
        elif isinstance(n, GroupJoin):
            # probes ``build`` and aggregates by the *same* key expression
            bp = prop(n.build)
            p = prop(n.source)
            if isinstance(bp, Replicated):
                if isinstance(p, Replicated):
                    props[n.out] = Replicated()
                    emit(n)
                elif copartitioned(n.source, n.keyexpr):
                    props[n.out] = HashPartitioned()
                    emit(n)
                else:
                    partial_with_exchange(n)
            else:
                # partitioned build: align the probe side (or ride the
                # mask-partition of a replicated frame) — the aggregate is
                # then disjoint by key and needs no Exchange
                if isinstance(p, Replicated) or copartitioned(
                    n.source, n.keyexpr
                ):
                    src = n.source
                else:
                    src = repartitioned(n.source, n.keyexpr)
                props[n.out] = HashPartitioned()
                emit(_resrc(n, src))
        elif isinstance(n, Reduce):
            src = n.source
            lp = (
                prop(n.lookup_sym) if n.lookup_sym is not None else Replicated()
            )
            if isinstance(lp, HashPartitioned) and not isinstance(
                prop(src), Replicated
            ):
                # align sharded rows with the partitioned dictionary — a
                # no-op when already co-partitioned on the lookup key;
                # replicated rows ride the found-mask instead
                src = repartitioned(src, n.lookup_key)
            emit(_resrc(n, src))
            sharded_rows = not isinstance(prop(src), Replicated)
            mask_partitioned = isinstance(lp, HashPartitioned)
            if sharded_rows or mask_partitioned:
                fops = tuple(
                    (name, op)
                    for (name, _), op in zip(n.fields, n.ops or ())
                )
                emit(Exchange(
                    n.out + "#sum", source=n.out, kind="allreduce",
                    field_ops=fops,
                ))
            props[n.out] = Replicated()  # all-reduced scalar record
        elif isinstance(n, Pipeline):
            # fusion happens per executor, after legalization: the sharded
            # executor legalizes the unfused plan and fuses the result (the
            # per-shard partial phase), so regions never straddle the
            # Repartition/Exchange boundaries legalization inserts
            raise PlanShardError(
                f"cannot legalize fused plan (Pipeline {n.out}); "
                "legalize first, then fuse"
            )
        elif isinstance(n, (Exchange, Repartition)):
            raise PlanShardError(f"plan already legalized at {n.out}")
        else:  # pragma: no cover
            raise PlanShardError(f"unknown node {type(n).__name__}")

    return Plan(tuple(out_nodes), plan.result, plan.choices, plan.params), props


# ---------------------------------------------------------------------------
# Data-centric pipeline fusion (DESIGN.md §7)
# ---------------------------------------------------------------------------

_CHAIN_NODES = (Select, HashProbe)
_TERMINAL_NODES = (GroupBy, GroupJoin, Reduce, HashBuild, Project)


def _node_exprs(n: Node):
    """Row expressions a node evaluates (column-liveness analysis)."""
    if isinstance(n, Select):
        yield n.pred
    elif isinstance(n, Project):
        for _, fx in n.fields:
            yield fx
    elif isinstance(n, HashBuild):
        yield n.keyexpr
    elif isinstance(n, HashProbe):
        yield n.keyexpr
    elif isinstance(n, GroupBy):
        yield n.keyexpr
        for _, fx in n.values:
            yield fx
    elif isinstance(n, GroupJoin):
        yield n.keyexpr
        yield n.f_expr
    elif isinstance(n, Reduce):
        for _, fx in n.fields:
            yield fx
        if n.lookup_key is not None:
            yield n.lookup_key
    elif isinstance(n, Repartition):
        if n.keyexpr is not None:
            yield n.keyexpr


def _node_refs(n: Node):
    """Symbols a node consumes (beyond its ``source``)."""
    yield n.source  # type: ignore[attr-defined]
    if isinstance(n, (HashProbe, GroupJoin)):
        yield n.build
    elif isinstance(n, Reduce) and n.lookup_sym is not None:
        yield n.lookup_sym


def needed_columns(stages: Tuple[Node, ...]) -> Dict[str, Tuple[str, ...]]:
    """Per loop variable, the columns a fused region actually reads — what a
    probe must gather (everything else is pruned) and what the streaming
    kernel keeps of the fact tile.  ``__key__``/``__val__`` stand for
    whole-key / value-lane accesses of dictionary scans (``lower.DICT_KEY``
    / ``DICT_VAL``)."""
    out: Dict[str, Dict[str, None]] = {}

    def add(var: str, col: str) -> None:
        out.setdefault(var, {})[col] = None

    def scan(x: L.Expr) -> None:
        if isinstance(x, L.FieldAccess):
            b = x.rec
            if (
                isinstance(b, L.FieldAccess)
                and b.name == "key"
                and isinstance(b.rec, L.Var)
            ):
                add(b.rec.name, x.name)  # v.key.col
                return
            if isinstance(b, L.Var):
                if x.name == "val":
                    add(b.name, "__val__")
                    return
                if x.name == "key":
                    add(b.name, "__key__")
                    return
        for c in x.children():
            scan(c)

    for n in stages:
        for e in _node_exprs(n):
            scan(e)
    return {v: tuple(cols) for v, cols in out.items()}


@dataclass
class _DictInfo:
    """Static estimate of a dictionary symbol's fused-execution footprint."""

    cap: float  # estimated static capacity (engine's 2×-slack pow2 rule)
    lanes: float  # value arity
    src_rows: float  # rows of the frame it was built from
    src_ncols: float  # columns of the build-side source (gather width)
    ds: str = "ht_linear"


def _pow2cap(n: float) -> float:
    from repro_torch.dicts.base import default_capacity

    return float(default_capacity(int(max(n, 1.0))))


class _Shape:
    """Static shadow of the executor's frame bookkeeping: rows per frame
    symbol, base relation per loop variable, vars per frame — enough to
    mirror ``engine._capacity`` without touching data."""

    def __init__(self, plan: Plan, sigma, fusion) -> None:
        self.sigma = sigma
        self.fusion = fusion
        self.rows: Dict[str, float] = {}  # frame/relation sym -> est rows
        self.frame_vars: Dict[str, Tuple[str, ...]] = {}
        self.var_rel: Dict[str, Optional[str]] = {}
        self.dicts: Dict[str, _DictInfo] = {}
        defined = set()
        for n in plan.nodes:
            self._visit(n, defined)
            defined.add(n.out)

    def _rel_rows(self, rel: str) -> float:
        if self.sigma is not None:
            try:
                return float(self.sigma.rel(rel).rows)
            except KeyError:
                pass
        return self.fusion.default_rows

    def _rel_ncols(self, rel: Optional[str]) -> float:
        if rel is not None and self.sigma is not None:
            try:
                return float(len(self.sigma.rel(rel).columns))
            except KeyError:
                pass
        return self.fusion.default_cols

    def _key_dist(self, frame: str, keyexpr: L.Expr) -> float:
        """Distinct-count estimate of a key expression over a frame —
        ``engine._capacity``'s Σ path, statically."""
        from .cardinality import key_columns

        for var in self.frame_vars.get(frame, ()):
            cols = key_columns(keyexpr, var)
            if not cols:
                continue
            rel = self.var_rel.get(var)
            if rel is not None and self.sigma is not None and "*" not in cols:
                try:
                    return float(self.sigma.dist(rel, cols))
                except KeyError:
                    pass
            break
        return self.rows.get(frame, self.fusion.default_rows)

    def _visit(self, n: Node, defined: set) -> None:
        if isinstance(n, Scan):
            if n.source in self.dicts:
                rows = self.dicts[n.source].cap
                rel = None
            elif n.source in defined:
                rows = self.rows.get(n.source, self.fusion.default_rows)
                rel = None
            else:
                rows = self._rel_rows(n.source)
                rel = n.source
            self.rows[n.out] = rows
            self.frame_vars[n.out] = (n.var,)
            self.var_rel[n.var] = rel
        elif isinstance(n, (Select, Repartition)):
            self.rows[n.out] = self.rows.get(n.source, self.fusion.default_rows)
            self.frame_vars[n.out] = self.frame_vars.get(n.source, ())
        elif isinstance(n, HashProbe):
            self.rows[n.out] = self.rows.get(n.source, self.fusion.default_rows)
            self.frame_vars[n.out] = self.frame_vars.get(n.source, ()) + (
                n.inner_var,
            )
            self.var_rel[n.inner_var] = None
        elif isinstance(n, Project):
            self.rows[n.out] = self.rows.get(n.source, self.fusion.default_rows)
        elif isinstance(n, (HashBuild, GroupBy, GroupJoin)):
            rows = self.rows.get(n.source, self.fusion.default_rows)
            cap = _pow2cap(self._key_dist(n.source, n.keyexpr))
            if isinstance(n, GroupBy):
                lanes = float(len(n.values))
            elif isinstance(n, GroupJoin):
                lanes = self.dicts.get(
                    n.build, _DictInfo(cap, 1.0, rows, 0.0)
                ).lanes
            else:
                lanes = 1.0
            rel = None
            vars_ = self.frame_vars.get(n.source, ())
            if vars_:
                rel = self.var_rel.get(vars_[0])
            self.dicts[n.out] = _DictInfo(
                cap, lanes, rows, self._rel_ncols(rel), n.choice.ds
            )
        elif isinstance(n, Exchange):
            src = self.dicts.get(n.source)
            if src is not None:
                self.dicts[n.out] = src


def fuse(plan: Plan, sigma=None, fusion=None, streamed=()) -> Plan:
    """Group maximal chains of row-parallel nodes into :class:`Pipeline`
    regions — a *costed* choice under Δ_fuse (``cost.FusionCostModel``), not
    a default (DESIGN.md §7).

    Region grammar: ``Scan → (Select | HashProbe)* → terminal`` where the
    terminal is a materializing node (``GroupBy``/``GroupJoin``/``Reduce``/
    ``HashBuild``/``Project``) and every intermediate symbol is consumed
    only inside the region.  For each candidate the pass estimates, from Σ:

    * **saved HBM bytes** — elided Select masks and probe-gathered build
      columns, written+reread by the unfused executor at probe-stream
      width;
    * **resident VMEM bytes** — every probed dictionary slab plus its
      gather payload, plus the terminal's accumulator.

    A region is fused iff ``Δ_fuse > 0`` and the working set fits the VMEM
    budget; an over-budget region is **split** at probe boundaries — the
    leading stages through the overflowing probe stay materialized and the
    remainder re-enters as a frame-sourced region — until it fits or no
    probes remain (then it stays unfused).  ``Exchange``/``Repartition``
    nodes are natural region boundaries: they are not chain members, and
    fusing a legalized plan fuses exactly the per-shard partial phase.

    ``streamed`` names relations the storage plan keeps host-side as
    encoded chunks (``cost.storage_plan`` mode ``"streamed"``).  A chain
    scanning one ALWAYS fuses: the unfused alternative would materialize a
    decoded fact-table-sized intermediate — the very thing the memory
    budget ruled out — and the VMEM sizing above prices the Pallas
    resident path, not the chunked XLA loop, whose working set is one
    chunk regardless of region shape (the kernel dispatch re-checks its
    own residency contract per chunk).  A Project terminal over a streamed
    source yields a *pending* host-chunked intermediate; a chain scanning
    THAT faces its own costed decision (``fusion.delta_chained``): fusing
    chains it onto the chunk loop, paying a capacity-sized carried-state
    rewrite per chunk, while leaving the chain unfused spills the
    projected intermediate and runs the consumer resident — far cheaper
    below small scales (the intermediate is a narrow subset of the fact
    table), mandatory-to-avoid above them (the decoded intermediate no
    longer fits ``fusion.spill_budget``).
    """
    from .cost import FusionCostModel

    fusion = fusion or FusionCostModel()
    shape = _Shape(plan, sigma, fusion)

    # symbols referenced by each node, for the single-consumer safety check
    all_refs: List[Tuple[int, str]] = []
    for i, n in enumerate(plan.nodes):
        for s in _node_refs(n):
            all_refs.append((i, s))
    if plan.result is not None:
        all_refs.append((len(plan.nodes), plan.result))

    def consumed_outside(syms: set, lo: int, hi: int) -> bool:
        return any(
            s in syms for i, s in all_refs if not (lo <= i < hi)
        )

    out_nodes: List[Node] = []
    i = 0
    nodes = plan.nodes
    wet = set(streamed)
    # pending-stream intermediates: out symbol of a force-fused
    # Project-terminal chain over a streamed source -> (intermediate rows,
    # intermediate cols, streamed source rows)
    pending: Dict[str, Tuple[float, float, float]] = {}
    while i < len(nodes):
        chain = _match_chain(nodes, i)
        if chain is None:
            out_nodes.append(nodes[i])
            i += 1
            continue
        hi = i + len(chain)
        inner = {n.out for n in chain[:-1]}
        if consumed_outside(inner, i, hi):
            out_nodes.append(nodes[i])
            i += 1
            continue
        src = chain[0].source
        if src in wet:
            src_rows = shape.rows.get(chain[0].out, fusion.default_rows)
            out_nodes.append(
                Pipeline(
                    chain[-1].out,
                    source=src,
                    stages=tuple(chain),
                    partitions=0,
                    part_sym="",
                )
            )
            if isinstance(chain[-1], Project):
                pending[chain[-1].out] = (
                    shape.rows.get(chain[-1].out, fusion.default_rows),
                    float(len(chain[-1].fields)),
                    src_rows,
                )
        elif src in pending:
            if _chained_delta(chain, pending[src], shape, fusion) > 0.0:
                # chaining wins: the usual costed decision (fused regions
                # scanning the pending symbol join its chunk loop)
                decided = _decide_region(chain, shape, fusion)
                out_nodes.extend(decided)
                for nd in decided:
                    if (
                        isinstance(nd, Pipeline)
                        and nd.source == src
                        and isinstance(nd.stages[-1], Project)
                    ):
                        pending[nd.out] = (
                            shape.rows.get(nd.out, fusion.default_rows),
                            float(len(nd.stages[-1].fields)),
                            pending[src][2],
                        )
            else:  # spill the pending intermediate; consumer runs resident
                out_nodes.extend(chain)
        else:
            out_nodes.extend(_decide_region(chain, shape, fusion))
        i = hi
    return Plan(tuple(out_nodes), plan.result, plan.choices, plan.params)


def _chained_delta(
    chain: List[Node], inter: Tuple[float, float, float], shape: "_Shape",
    fusion,
) -> float:
    """Δ_chained for a chain scanning a pending streamed intermediate: the
    per-chunk carried-state rewrite a dictionary terminal pays when chained
    versus spilling the projection and running resident.  Non-dictionary
    terminals carry no capacity-sized state (Reduce folds scalars, Project
    streams through), so chaining them is free."""
    inter_rows, inter_cols, src_rows = inter
    term = chain[-1]
    state_bytes = 0.0
    if isinstance(term, (GroupBy, GroupJoin)):
        lanes = float(len(term.values)) if isinstance(term, GroupBy) else 1.0
        # the chained terminal has no Σ row for its intermediate input, so
        # the engine sizes the carried state for the FULL source row count
        # (engine._exec_streamed_chain) — capacity ≈ 2× next-pow2 rows
        state_bytes = fusion.dict_bytes(2.0 * src_rows, lanes)
    n_chunks = max(1.0, src_rows / float(fusion.chunk_rows))
    return fusion.delta_chained(inter_rows, inter_cols, state_bytes, n_chunks)


def _match_chain(nodes: Tuple[Node, ...], i: int) -> Optional[List[Node]]:
    if not isinstance(nodes[i], Scan):
        return None
    chain: List[Node] = [nodes[i]]
    k = i + 1
    while k < len(nodes) and isinstance(nodes[k], _CHAIN_NODES):
        if nodes[k].source != chain[-1].out:  # type: ignore[attr-defined]
            return None
        chain.append(nodes[k])
        k += 1
    if (
        k < len(nodes)
        and isinstance(nodes[k], _TERMINAL_NODES)
        and nodes[k].source == chain[-1].out  # type: ignore[attr-defined]
    ):
        chain.append(nodes[k])
        return chain
    return None


@dataclass
class _RegionCost:
    """Byte accounting of one candidate region: total saved/resident plus
    the per-probed-dictionary resident slabs and the terminal accumulator —
    enough for :func:`_decide_region` to re-price the radix-partitioned
    variant (one slab shrunk by P, the accumulator possibly partitioned)
    without re-walking the stages."""

    saved: float
    resident: float
    rows: float
    dict_bytes: Dict[str, float]  # probed dict sym -> resident slab bytes
    acc_bytes: float  # dictionary terminal's accumulator (0 for Reduce)


def _region_cost(stages: List[Node], shape: _Shape, fusion) -> _RegionCost:
    rows = shape.rows.get(stages[0].out, fusion.default_rows)
    need = needed_columns(tuple(stages))
    saved = 0.0
    per_dict: Dict[str, float] = {}
    for n in stages:
        if isinstance(n, Select):
            saved += rows * fusion.mask_bytes
        elif isinstance(n, HashProbe):
            info = shape.dicts.get(n.build)
            ncols = info.src_ncols if info else fusion.default_cols
            # the unfused executor materializes EVERY build-side column at
            # probe-stream width plus the found mask; fused gathers stay in
            # registers
            saved += rows * (fusion.col_bytes * ncols + fusion.mask_bytes)
            cap = info.cap if info else fusion.default_rows
            per_dict[n.build] = per_dict.get(n.build, 0.0) + (
                fusion.dict_bytes(cap, 1.0)
                + fusion.payload_bytes(cap, len(need.get(n.inner_var, ())))
            )
        elif isinstance(n, GroupJoin):
            info = shape.dicts.get(n.build)
            cap = info.cap if info else fusion.default_rows
            lanes = info.lanes if info else 1.0
            # fused probe+aggregate: the looked-up g-values and found mask
            # never round-trip between the probe and the aggregate
            saved += rows * (fusion.col_bytes * lanes + fusion.mask_bytes)
            per_dict[n.build] = per_dict.get(n.build, 0.0) + fusion.dict_bytes(
                cap, lanes
            )
        elif isinstance(n, Reduce) and n.lookup_sym is not None:
            info = shape.dicts.get(n.lookup_sym)
            cap = info.cap if info else fusion.default_rows
            lanes = info.lanes if info else 1.0
            saved += rows * (fusion.col_bytes * lanes + fusion.mask_bytes)
            per_dict[n.lookup_sym] = per_dict.get(
                n.lookup_sym, 0.0
            ) + fusion.dict_bytes(cap, lanes)
    term = stages[-1]
    info = shape.dicts.get(term.out)
    acc = fusion.dict_bytes(info.cap, info.lanes) if info is not None else 0.0
    resident = sum(per_dict.values()) + acc
    return _RegionCost(saved, resident, rows, per_dict, acc)


def _probe_key_of(stages: List[Node], sym: str):
    """The key expression probing dictionary ``sym`` inside the region."""
    for n in stages:
        if isinstance(n, (HashProbe, GroupJoin)) and n.build == sym:
            return n.keyexpr
        if isinstance(n, Reduce) and n.lookup_sym == sym:
            return n.lookup_key
    return None


@dataclass
class _PartitionChoice:
    n_parts: int
    sym: str
    delta: float


def _partition_candidate(
    stages: List[Node], shape: _Shape, fusion, rc: _RegionCost
) -> Optional[_PartitionChoice]:
    """Price the radix-partitioned realization of the region, or ``None``
    when it is infeasible: the region must start at a Scan (partition keys
    are computed from the streamed columns), exactly one probed dictionary
    may exceed the per-slab residency bound, its family must support
    slot-range partitioning, its probe key must read only the scan
    variable, and the terminal must either fit residency or aggregate by
    the partition key itself (then the accumulator partitions too)."""
    from repro_torch.dicts import registry

    if fusion.max_partitions <= 1 or not isinstance(stages[0], Scan):
        return None
    term = stages[-1]
    if not isinstance(term, (GroupBy, GroupJoin, Reduce)):
        return None  # only kernel-dispatchable terminals benefit
    slots = float(fusion.kernel_slots)
    oversized = [
        s
        for s in rc.dict_bytes
        if shape.dicts.get(s) is not None and shape.dicts[s].cap > slots
    ]
    if len(oversized) > 1:
        return None
    if oversized:
        target = oversized[0]
    elif rc.dict_bytes:  # over the byte budget only: shrink the biggest slab
        target = max(rc.dict_bytes, key=rc.dict_bytes.get)
    else:
        return None
    info = shape.dicts[target]
    if not registry.partitionable(info.ds):
        return None
    keyexpr = _probe_key_of(stages, target)
    if keyexpr is None:
        return None
    scan_var = stages[0].var
    key_need = needed_columns((Select("", "", keyexpr),))
    if set(key_need) - {scan_var}:
        return None  # partition key must come from the streamed columns
    part_terminal = (
        isinstance(term, (GroupBy, GroupJoin)) and term.keyexpr == keyexpr
    )
    tinfo = shape.dicts.get(term.out)
    if (
        tinfo is not None
        and not part_terminal
        and tinfo.cap > slots
    ):
        return None  # accumulator can neither fit nor partition
    other = sum(b for s, b in rc.dict_bytes.items() if s != target)
    tgt_bytes = rc.dict_bytes[target]
    p = 2
    while p <= fusion.max_partitions:
        cp = info.cap / p
        if cp >= 256 and info.cap % p == 0:
            acc = rc.acc_bytes
            if part_terminal and tinfo is not None:
                acc = fusion.dict_bytes(
                    _pow2cap(cp), tinfo.lanes
                )  # per-partition accumulator (≤ cp live keys per block)
            resident_p = other + tgt_bytes / p + acc
            if cp <= slots and resident_p <= fusion.vmem_budget:
                ncols = len(
                    needed_columns(tuple(stages)).get(scan_var, ())
                )
                # when the target slab exceeds the residency bound, the
                # split alternative probes it OUT of residency — every
                # probe pays HBM random-access latency, credited to the
                # partitioned form.  A region over the byte budget only
                # (every slab individually resident) gets no such credit:
                # there the routing pass must pay for itself.
                saved = rc.saved + (
                    rc.rows * fusion.probe_random_bytes if oversized else 0.0
                )
                return _PartitionChoice(
                    p,
                    target,
                    fusion.delta_partition(
                        saved, resident_p, rc.rows, max(1.0, ncols)
                    ),
                )
        p *= 2
    return None


def _split_region(
    chain: List[Node], shape: _Shape, fusion
) -> Tuple[List[Node], float]:
    """Today's over-budget fallback: peel leading stages through the first
    probe until the remainder fits, fusing it when profitable.  Returns the
    emitted nodes and the fused remainder's Δ (0 when nothing fuses)."""
    prefix: List[Node] = []
    stages = list(chain)
    while True:
        rc = _region_cost(stages, shape, fusion)
        if rc.resident <= fusion.vmem_budget:
            break
        # peel through the first probe: its dictionary + payload leave the
        # working set; the peeled nodes materialize exactly as the unfused
        # executor would run them
        k = next(
            (j for j, s in enumerate(stages) if isinstance(s, HashProbe)),
            None,
        )
        if k is None or len(stages) - (k + 1) < 2:
            return prefix + stages, 0.0  # cannot fit: stay materialized
        prefix += stages[: k + 1]
        stages = stages[k + 1:]
    delta = fusion.delta_fuse(rc.saved, rc.resident)
    if len(stages) < 2 or delta <= 0.0:
        return prefix + stages, 0.0
    pipe = Pipeline(
        stages[-1].out,
        source=stages[0].source,  # type: ignore[attr-defined]
        stages=tuple(stages),
    )
    return prefix + [pipe], delta


def _decide_region(chain: List[Node], shape: _Shape, fusion) -> List[Node]:
    """Fuse (resident or radix-partitioned), split, or keep ``chain``
    materialized; returns emitted nodes.  The partitioned form is a COSTED
    alternative (Δ_partition vs the best split's Δ_fuse), never a default."""
    stages = list(chain)
    rc = _region_cost(stages, shape, fusion)
    slot_over = any(
        shape.dicts[s].cap > fusion.kernel_slots
        for s in rc.dict_bytes
        if shape.dicts.get(s) is not None
    )

    def pipe(partitions: int = 0, part_sym: str = "") -> Pipeline:
        return Pipeline(
            stages[-1].out,
            source=stages[0].source,  # type: ignore[attr-defined]
            stages=tuple(stages),
            partitions=partitions,
            part_sym=part_sym,
        )

    if rc.resident <= fusion.vmem_budget:
        if len(stages) < 2 or fusion.delta_fuse(rc.saved, rc.resident) <= 0.0:
            return stages
        if slot_over:
            # fits the byte budget but some slab exceeds the kernel's
            # per-dictionary residency contract: mark the region partitioned
            # when that prices positive, so the Pallas path stays fused
            # instead of falling back (the XLA path runs it as one
            # computation either way)
            cand = _partition_candidate(stages, shape, fusion, rc)
            if cand is not None and cand.delta > 0.0:
                return [pipe(cand.n_parts, cand.sym)]
        return [pipe()]
    split_nodes, split_delta = _split_region(chain, shape, fusion)
    cand = _partition_candidate(stages, shape, fusion, rc)
    if cand is not None and cand.delta > max(split_delta, 0.0):
        return [pipe(cand.n_parts, cand.sym)]
    return split_nodes


# ---------------------------------------------------------------------------
# Cross-plan shared scans (DESIGN.md §9)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SharedBranch:
    """One plan's contribution to a shared-scan region: the fused region
    (synthesized on the fly for a materialized Scan-rooted chain) plus the
    symbols of the original plan's nodes the region subsumes — the shared
    executor skips those nodes and publishes the region's terminal instead."""

    plan_idx: int
    pipe: Pipeline
    covered: Tuple[str, ...]


@dataclass(frozen=True)
class SharedRegion:
    """Regions from *different* plans fused over ONE pass of ``source``:
    the fact stream is read once and every branch's filters, probes, and
    semiring accumulators run against the same resident tiles."""

    source: str  # shared base relation
    branches: Tuple[SharedBranch, ...]


@dataclass(frozen=True)
class SharedPlan:
    """A batch of plans plus the shared-scan regions merged across them.
    Plans keep their identities — results demultiplex per plan — and any
    node not covered by a region executes exactly as in per-query mode."""

    plans: Tuple["Plan", ...]
    regions: Tuple[SharedRegion, ...] = ()

    def covered_of(self, plan_idx: int) -> Tuple[str, ...]:
        out: List[str] = []
        for r in self.regions:
            for b in r.branches:
                if b.plan_idx == plan_idx:
                    out.extend(b.covered)
        return tuple(out)

    def fingerprint(self) -> str:
        import hashlib

        blob = repr(
            (
                tuple(p.fingerprint() for p in self.plans),
                self.regions,
            )
        )
        return hashlib.sha1(blob.encode()).hexdigest()

    def describe(self) -> str:
        """Stable rendering of the merged batch (golden tests, explain):
        each shared scan lists its merged terminals, then each plan with
        region-covered nodes elided to a marker."""
        lines = [
            f"SharedPlan [{len(self.plans)} plans, "
            f"{len(self.regions)} shared scans]"
        ]
        for r in self.regions:
            lines.append(
                f"SharedScan {r.source} [{len(r.branches)} branches]"
            )
            for b in r.branches:
                lines.append(
                    f"  p{b.plan_idx} | " + _describe_node(b.pipe.stages[-1])
                )
        return "\n".join(lines)


def _flat_nodes(plan: Plan) -> Tuple[Node, ...]:
    """The plan's nodes with fused regions expanded inline — the node order
    the unfused executor would see, which is what ``_Shape`` walks."""
    out: List[Node] = []
    for n in plan.nodes:
        if isinstance(n, Pipeline):
            out.extend(n.stages)
        else:
            out.append(n)
    return tuple(out)


def _plan_refs(plan: Plan) -> List[Tuple[int, str]]:
    """(node index, referenced symbol) pairs, looking through Pipelines."""
    refs: List[Tuple[int, str]] = []
    for i, n in enumerate(plan.nodes):
        if isinstance(n, Pipeline):
            refs.append((i, n.source))
            for s in n.stages:
                refs.extend((i, r) for r in _node_refs(s))
        else:
            refs.extend((i, r) for r in _node_refs(n))
    if plan.result is not None:
        refs.append((len(plan.nodes), plan.result))
    return refs


def _branch_candidates(plan: Plan, plan_idx: int) -> List[SharedBranch]:
    """Shared-scan branch candidates of one plan: fused Pipeline regions
    rooted at a base-relation Scan, plus *materialized* Scan-rooted chains
    (regions ``fuse`` declined on Δ_fuse alone — a shared pass changes the
    economics, since the scan cost is amortized across the batch)."""
    defined = {n.out for n in plan.nodes}
    for n in plan.nodes:
        if isinstance(n, Pipeline):
            defined.update(s.out for s in n.stages)
    refs = _plan_refs(plan)
    out: List[SharedBranch] = []
    covered_already: set = set()
    for i, n in enumerate(plan.nodes):
        if isinstance(n, Pipeline):
            if (
                n.stages
                and isinstance(n.stages[0], Scan)
                and n.stages[0].source not in defined
            ):
                out.append(SharedBranch(plan_idx, n, (n.out,)))
            continue
        chain = _match_chain(plan.nodes, i)
        if chain is None or not isinstance(chain[0], Scan):
            continue
        if chain[0].source in defined:
            continue  # dict-scan / derived input: not a base-relation scan
        lo, hi = i, i + len(chain)
        if any(s.out in covered_already for s in chain):
            continue
        inner = {s.out for s in chain[:-1]}
        if any(
            s in inner for j, s in refs if not (lo <= j < hi)
        ):
            continue  # an intermediate leaks outside the chain
        pipe = Pipeline(
            chain[-1].out,
            source=chain[0].source,
            stages=tuple(chain),
        )
        out.append(
            SharedBranch(plan_idx, pipe, tuple(s.out for s in chain))
        )
        covered_already.update(s.out for s in chain)
    return out


def _branch_stream_cols(pipe: Pipeline) -> Tuple[str, ...]:
    """Fact columns the branch reads off the shared scan variable."""
    scan = pipe.stages[0]
    assert isinstance(scan, Scan)
    return needed_columns(pipe.stages).get(scan.var, ())


def merge_shared_scans(
    plans, sigma=None, fusion=None
) -> SharedPlan:
    """Merge fused regions from *different* plans that scan the same base
    relation into shared-scan regions (DESIGN.md §9) — the LMFAO move: an
    analytical batch is dominated by the fact-table scan, so a batch of
    aggregates should pay it once.

    Eligibility per branch: the region must be rooted at a Scan of a base
    relation (fused ``Pipeline`` or a materialized Scan-rooted chain whose
    intermediates stay private), and must not consume a symbol produced by
    another branch of the same region.  Each group of ≥2 branches over one
    relation is priced by ``FusionCostModel.delta_share``: saved bytes are
    the per-branch fact streams minus the single shared stream (the branch
    column sets union under the shared pass), resident bytes the *sum* of
    every branch's fused working set — when over budget the largest-resident
    branch is dropped (declined) until the rest fit, reusing the PR-5
    capacity rules through each branch's own ``partitions`` marking."""
    from .cost import FusionCostModel

    fusion = fusion or FusionCostModel()
    plans = tuple(plans)
    shapes = [
        _Shape(
            Plan(_flat_nodes(p), p.result, p.choices, p.params), sigma, fusion
        )
        for p in plans
    ]

    by_rel: Dict[str, List[SharedBranch]] = {}
    for idx, p in enumerate(plans):
        for b in _branch_candidates(p, idx):
            by_rel.setdefault(b.pipe.stages[0].source, []).append(b)

    regions: List[SharedRegion] = []
    for rel in sorted(by_rel):
        branches = by_rel[rel]
        # a branch must not depend on another branch's terminal: they run
        # against the same pass and cannot be ordered within it
        terminals = {b.pipe.out for b in branches}
        branches = [
            b
            for b in branches
            if not any(
                r in terminals and r != b.pipe.out
                for s in b.pipe.stages
                for r in _node_refs(s)
            )
        ]
        while len(branches) >= 2:
            costs = [
                _region_cost(list(b.pipe.stages), shapes[b.plan_idx], fusion)
                for b in branches
            ]
            rows = max(c.rows for c in costs)
            union_cols: set = set()
            per_branch_stream = 0.0
            for b in branches:
                cols = _branch_stream_cols(b.pipe)
                union_cols.update(cols)
                per_branch_stream += rows * (
                    fusion.col_bytes * len(cols) + fusion.mask_bytes
                )
            shared_stream = rows * (
                fusion.col_bytes * len(union_cols) + fusion.mask_bytes
            )
            saved = per_branch_stream - shared_stream
            resident = sum(c.resident for c in costs)
            delta = fusion.delta_share(saved, resident)
            if delta == float("-inf"):
                # decline the largest-resident branch, keep trying the rest
                drop = max(
                    range(len(branches)), key=lambda j: costs[j].resident
                )
                branches = branches[:drop] + branches[drop + 1:]
                continue
            if delta <= 0.0:
                branches = []
                break
            regions.append(SharedRegion(rel, tuple(branches)))
            break
    return SharedPlan(plans, tuple(regions))


def _rename(n: Node, new_out: str) -> Node:
    import dataclasses

    return dataclasses.replace(n, out=new_out)


def _resrc(n: Node, new_source: str) -> Node:
    import dataclasses

    if n.source == new_source:  # type: ignore[attr-defined]
        return n
    return dataclasses.replace(n, source=new_source)
