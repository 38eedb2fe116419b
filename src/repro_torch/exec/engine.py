"""Vectorized physical operators — the generated-engine runtime, in PyTorch.

The twin of ``repro.exec.engine``.
Static shapes throughout: selection is masking (never compaction), joins
are FK index-gathers with found-masks, group-bys are fixed-capacity
dictionary builds.  ``repro`` traces the whole plan under ``jax.jit``; the
port runs eagerly on the tables' device and keeps the same masking, so
capacities and results match.

Fused ``Pipeline`` regions whose terminal aggregates run through the
fused-pipeline kernel (``kernels.fused_pipeline``: the CUDA kernel on the
card, its plain twin on the CPU), radix-partitioned where the plan marked
the region (``kernel-radix``); every other region runs as plain PyTorch on
the tables' device (mode ``"xla"``, as the reference computes those regions
in XLA outside Pallas).  Sorted-probe lookups of sort-family
dictionaries go through the merge-lookup kernel.

The executable cache (``cached_executable``) plans a query shape once;
``Executable.call_batched`` runs a batch of bindings as a loop of warm
calls (the plain loops end on a host-synced ``.any()``, which
``torch.func.vmap`` cannot batch), and a ``BoundPlan`` comes back as a
``BoundExecutable`` whose call-time params override the bound ones.

The node loop is a generator a shard (``_plan_steps``): it stops at each
``Repartition`` / ``Exchange`` node that has an implementation, so
``execute_plan_lockstep`` runs one loop per shard database in lockstep and
realizes each collective over every shard at once (the sharded executor,
``exec.distributed``); ``execute_plan`` is that over one shard, whose
collectives are the identity unless hooks are given.

Shared-scan batches (``execute_shared_plan``, ``SharedExecutable``) run
every plan of a ``plan.SharedPlan`` with each merged region executed once
for all its branches.  The in-DB ML operators (``sort_groupby_arrays``,
``covar_factorized``, ``covar_naive``) aggregate sorted runs through the
segment-reduce kernel.

Out of core (``data.storage``): a region that scans a chunked relation
streams it — chunk i+1's encoded upload starts before chunk i is computed,
each chunk decodes on the device through the decode kernel, and an
aggregating terminal folds every chunk into an accumulator sized for the
whole relation (where the region is kernel-eligible, one fused-pipeline
launch per chunk carries the accumulator as ``init=`` and reads the chunk's
encoded columns as ``encoded=`` streams, ``streamed-kernel:N``; else the
region's stages per chunk, ``streamed:N``).  Project terminals defer into ``_PendingStream`` chains
that downstream regions extend or spill to host memory.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import errors as _errors
from repro_torch.core import llql as L
from repro_torch.core import plan as P
from repro_torch.core.cardinality import key_columns
from repro_torch.core.lower import _BIN, _UN, DICT_KEY, DICT_VAL, _Unsupported, as_column, compile_rowfn_frame
from repro_torch.data import storage as STG
from repro_torch.data.table import Table, to_numpy
from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry
from repro_torch.kernels import decode as DK
from repro_torch.kernels import fused_pipeline as _fp
from repro_torch.kernels import ops as kops
from repro_torch.testing import faults as _faults

from .region import lower_expr, lower_reduce_field


def _zero(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=a.dtype, device=a.device)


def items_np(keys: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor) -> Dict[int, np.ndarray]:
    """``{key: value row}`` of a dictionary's live slots; the live rows are
    selected on the device, so only they cross to the host."""
    idx = torch.nonzero(valid.to(torch.bool)).squeeze(1)
    ks, vs = to_numpy(keys[idx]), to_numpy(vals[idx])
    return dict(zip(ks.tolist(), vs))


@dataclass
class DictResult:
    """A materialized LLQL dictionary: backend table + its annotation."""

    ds: str
    table: object  # HashTable | SortedTable

    def items_np(self) -> Dict[int, np.ndarray]:
        return items_np(*registry.get(self.ds).items(self.table))

    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return registry.get(self.ds).items(self.table)

    def size(self) -> int:
        return int(registry.get(self.ds).size(self.table))


def _safe_gather(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` tolerant of zero-row gather sources (only ever gathered
    under an all-false found mask)."""
    if a.shape[0] == 0:
        a = torch.zeros((1,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
    return a[idx.to(torch.int64)]


def capacity_for(ds: str, n_distinct: int) -> int:
    """Static capacity (``dicts.base.default_capacity``)."""
    return dbase.default_capacity(n_distinct)


# ---------------------------------------------------------------------------
# dictionary build / probe with ds dispatch
# ---------------------------------------------------------------------------


def build_dict(ds, keys, vals, capacity, valid=None, assume_sorted=False, ops=None) -> DictResult:
    _faults.check("dict-build", detail=ds)
    ops = None if dbase.all_sum(ops) else tuple(ops)
    kw = {} if ops is None else {"ops": ops}
    t = registry.get(ds).build(
        keys.to(torch.int32), vals, capacity, assume_sorted=assume_sorted,
        valid=valid, **kw,
    )
    return DictResult(ds, t)


def lookup_dict(d: DictResult, queries, valid=None, sorted_probes: bool = False):
    """(vals[n, V], found[n]).  ``sorted_probes`` routes sort-family lookups
    through the merge-lookup kernel (the paper's hinted lookup)."""
    queries = queries.to(torch.int32)
    if d.ds.startswith("st") and sorted_probes:
        vals, found = kops.merge_lookup(d.table.keys, d.table.vals, queries)
        return dbase.mask_rows(vals, found, valid)
    return registry.get(d.ds).lookup(d.table, queries, valid=valid)


# ---------------------------------------------------------------------------
# relational operators
# ---------------------------------------------------------------------------


def _weight(table: Table, vals: torch.Tensor, ops) -> torch.Tensor:
    """Bag multiplicity multiplies additive lanes only."""
    mult = table.multiplicity()[:, None]
    if dbase.all_sum(ops):
        return vals * mult
    sel = torch.tensor([o == "sum" for o in ops], device=vals.device)
    return torch.where(sel[None, :], vals * mult, vals)


def groupby(table: Table, keys, vals, ds: str, capacity: int, assume_sorted=False, ops=()) -> DictResult:
    """Group-by aggregate (Fig. 6c/6d): dict[key] ⊕= val per lane monoid."""
    if vals.dim() == 1:
        vals = vals[:, None]
    return build_dict(
        ds, keys, _weight(table, vals, ops), capacity, valid=table.mask,
        assume_sorted=assume_sorted, ops=ops,
    )


def scalar_aggregate(table: Table, vals, ops=()) -> torch.Tensor:
    """Per-lane combine over live rows; vals [n, V] -> [V]."""
    if vals.dim() == 1:
        vals = vals[:, None]
    mult = table.multiplicity()
    if dbase.all_sum(ops):
        return (vals * mult[:, None]).sum(dim=0)
    live = table.live_mask()
    lanes = []
    for j, op in enumerate(ops):
        col = vals[:, j]
        if op == "sum":
            lanes.append((col * mult).sum())
        elif op == "min":
            lanes.append(torch.where(live, col, float("inf")).min())
        else:
            lanes.append(torch.where(live, col, float("-inf")).max())
    return torch.stack(lanes)


def build_index(ds, keys, capacity, valid=None, assume_sorted=False) -> DictResult:
    """Key -> row-index dictionary for FK joins; row indices ride the
    float32 value lane (exact below 2^24 rows)."""
    n = keys.shape[0]
    if n >= (1 << 24):
        raise ValueError("index payload exceeds float32 exactness")
    idx = torch.arange(n, dtype=torch.float32, device=keys.device)[:, None]
    return build_dict(ds, keys, idx, capacity, valid=valid, assume_sorted=assume_sorted)


def fk_join(left: Table, left_keys, right: Table, index: DictResult, take, sorted_probes=False, prefix="") -> Table:
    """Key/foreign-key join: probe ``index`` (built on the unique side) with
    ``left_keys``; gather ``take`` columns from ``right``.  The output keeps
    the left table's shape; non-matching rows are masked out."""
    vals, found = lookup_dict(index, left_keys, valid=left.mask, sorted_probes=sorted_probes)
    ridx = torch.where(found, vals[:, 0].to(torch.int32), 0)
    cols = dict(left.columns)
    for c in take:
        a = right.col(c)
        cols[prefix + c] = torch.where(found, _safe_gather(a, ridx), _zero(a))
    return Table(cols, left.nrows, mask=found, sorted_on=left.sorted_on)


def semijoin(left: Table, left_keys, index: DictResult, sorted_probes=False) -> Table:
    _, found = lookup_dict(index, left_keys, valid=left.mask, sorted_probes=sorted_probes)
    return left.with_mask(found)


def groupjoin(r_table, r_keys, f_vals, s_dict, out_ds, out_capacity, sorted_probes=False, assume_sorted=False) -> DictResult:
    """Fig. 6e/6f compound groupjoin: Agg[k] += f(r) * Sd(k)."""
    g_vals, found = lookup_dict(s_dict, r_keys, valid=r_table.mask, sorted_probes=sorted_probes)
    if f_vals.dim() == 1:
        f_vals = f_vals[:, None]
    tbl = r_table.with_mask(found)
    return groupby(tbl, r_keys, f_vals * g_vals, out_ds, out_capacity, assume_sorted=assume_sorted)


# ---------------------------------------------------------------------------
# physical-plan executor (single device)
# ---------------------------------------------------------------------------


@dataclass
class Frame:
    """Aligned row bindings of a plan pipeline: every bound loop variable
    maps to a table with the same row count and the same mask."""

    tables: Dict[str, Table]
    order: Tuple[str, ...]
    rels: Dict[str, Optional[str]]  # var -> base relation name (None: derived)

    @property
    def primary(self) -> Table:
        return self.tables[self.order[0]]

    def with_mask(self, m) -> "Frame":
        return Frame({v: t.with_mask(m) for v, t in self.tables.items()}, self.order, self.rels)


@dataclass
class BuiltDict:
    """A dictionary materialized by a plan node, plus what probes need."""

    res: DictResult
    choice: object  # DictChoice
    lanes: Tuple[str, ...] = ()
    kind: str = "agg"  # "agg" | "index"
    src: Optional[Table] = None  # index only: gather target


def _dict_scan_table(d: BuiltDict) -> Table:
    ks, vs, valid = d.res.arrays()
    cols = {DICT_KEY: ks}
    for i in range(vs.shape[1]):
        cols[DICT_VAL if i == 0 else f"{DICT_VAL}{i}"] = vs[:, i]
    sorted_on = (DICT_KEY,) if d.res.ds.startswith("st") else ()
    return Table(cols, ks.shape[0], mask=valid.to(torch.bool), sorted_on=sorted_on)


def _key_info(frame: Frame, keyexpr):
    """(base relation, key columns, probe/build sequence sorted?)."""
    for var in frame.order:
        cols = key_columns(keyexpr, var)
        if not cols:
            continue
        t = frame.tables[var]
        if "*" in cols:
            if DICT_KEY in t.columns:
                cols = (DICT_KEY,)
            else:
                return frame.rels.get(var), cols, False
        srt = bool(cols) and t.sorted_on[: len(cols)] == tuple(cols)
        return frame.rels.get(var), cols, srt
    return None, (), False


def _capacity(frame: Frame, keyexpr, ds: str, sigma) -> int:
    rel, cols, _ = _key_info(frame, keyexpr)
    if sigma is not None and rel is not None and cols and "*" not in cols:
        try:
            return capacity_for(ds, int(sigma.dist(rel, cols)))
        except KeyError:
            pass
    return capacity_for(ds, frame.primary.nrows)


def execute_plan(plan, db: Dict[str, Table], sigma=None, allow_sorted: bool = True, params=None,
                 exchange_impl=None, repartition_impl=None):
    """Run a physical plan (``repro_torch.core.plan``) against a database.
    ``allow_sorted=False`` disables the sorted-input/merge fast paths;
    ``params`` supplies the plan's free ``L.Param`` values.

    ``exchange_impl`` realizes Exchange nodes and ``repartition_impl``
    Repartition nodes, as in :func:`execute_plan_lockstep` (here over one
    shard); without them both are the identity, rows being all here."""
    return execute_plan_lockstep(plan, [db], sigma, allow_sorted, [params], exchange_impl, repartition_impl)[0]


def execute_plan_lockstep(plan, dbs, sigma=None, allow_sorted: bool = True, params_list=None,
                          exchange_impl=None, repartition_impl=None):
    """Run ``plan`` once per shard database of ``dbs``, the shards' node
    loops in lockstep: each loop advances up to the next node that has an
    implementation (``Repartition``: ``repartition_impl(node, frames,
    params_list)``; ``Exchange``: ``exchange_impl(node, operands)``, the
    shuffle's per-shard dictionaries or the allreduce's scalar records),
    which takes every shard's operand at once and returns each shard's part
    of the collective's result; then every loop resumes with its part.  One
    report covers the call: a region's record holds the shards' summed wall.
    Returns the shards' results in ``dbs`` order."""
    params_list = list(params_list) if params_list is not None else [None] * len(dbs)
    at = tuple(t for t, impl in ((P.Repartition, repartition_impl), (P.Exchange, exchange_impl)) if impl is not None)
    rep = _begin_report()
    t_plan = time.perf_counter()
    try:
        timed: set = set()
        steps = [
            _plan_steps(plan, db, sigma, allow_sorted, p, at, rep, timed, shard)
            for shard, (db, p) in enumerate(zip(dbs, params_list))
        ]
        return _lockstep(steps, exchange_impl, repartition_impl)
    finally:
        _end_report(rep, time.perf_counter() - t_plan)


class Collective(NamedTuple):
    """A ``Repartition`` or ``Exchange`` node one shard's node loop has
    reached, with that shard's operand — the Repartition's frame, the
    shuffle Exchange's partial dictionary (a ``BuiltDict``), the allreduce
    Exchange's scalar record — and its binding.  The loop resumes with the
    shard's part of the collective's result."""

    node: object
    operand: object
    params: object


def _note_wall(rep, sym: str, dt: float, timed: set, key, shard: int) -> None:
    """Add a node's host time to its region record: shard 0 sets a record
    no streamed region has timed itself, later shards add to it."""
    rec = rep.regions.get(sym)
    if rec is None:
        return
    if shard == 0:
        if rec.wall_s == 0.0:
            rec.wall_s = dt
            timed.add(key)
    elif key in timed:
        rec.wall_s += dt


def _plan_steps(plan, db, sigma, allow_sorted, params, at, rep, timed, shard):
    """One shard's node loop as a generator: it yields a
    :class:`Collective` at each node of the types ``at`` and is resumed
    with the shard's part of the result; it returns the plan's result."""
    env: Dict[str, object] = {}
    refs: Dict[str, object] = {}
    for node in plan.nodes:
        if isinstance(node, at):
            yield from _collective(node, env, refs, sigma, allow_sorted, params)
            continue
        t_node = time.perf_counter()
        _exec_node(node, env, refs, db, sigma, allow_sorted, params)
        if isinstance(node, P.Pipeline):
            _note_wall(rep, node.out, time.perf_counter() - t_node, timed, node.out, shard)
    if plan.result is not None and isinstance(env.get(plan.result), _PendingStream):
        env[plan.result].force(env, refs, sigma, allow_sorted, params)
    return _plan_result(plan, env, refs)


def _collective(node, env, refs, sigma, allow_sorted, params):
    """Yield one shard's operand of a Repartition / Exchange node and store
    the part of the result it is resumed with."""
    if isinstance(node, P.Repartition):
        env[node.out] = yield Collective(node, _frame_of(node.source, env, refs, sigma, allow_sorted, params), params)
    elif node.kind == "shuffle":
        env[node.out] = yield Collective(node, env[node.source], params)
    else:  # allreduce over a scalar ref record
        refs[node.source] = yield Collective(node, refs[node.source], params)


def _resume(shard: int, steps, value):
    """Advance shard ``shard``'s node loop to its next collective."""
    return steps.send(value)


def _lockstep(steps, exchange_impl, repartition_impl):
    """Drive the shards' node loops together: run each up to its next
    collective in shard order, realize the collective over all of them,
    resume each with its part; return the loops' results."""
    sent: list = [None] * len(steps)
    while True:
        got, results = [], []
        for shard, g in enumerate(steps):
            try:
                got.append(_resume(shard, g, sent[shard]))
            except StopIteration as stop:
                results.append(stop.value)
        if len(results) == len(steps):
            return results
        if results or any(c.node is not got[0].node for c in got):
            raise RuntimeError("the shards' node loops reached different collectives")
        node, operands = got[0].node, [c.operand for c in got]
        if isinstance(node, P.Repartition):
            sent = list(repartition_impl(node, operands, [c.params for c in got]))
        else:
            sent = list(exchange_impl(node, operands))


def _plan_result(plan, env, refs):
    if plan.result is None:
        if len(refs) == 1:
            return next(iter(refs.values()))
        return refs
    if plan.result in refs:
        return refs[plan.result]
    out = env.get(plan.result)
    if isinstance(out, BuiltDict):
        return out.res
    return out


def _frame_of(sym: str, env, refs, sigma, allow_sorted, params) -> Frame:
    """The frame bound to ``sym``, its pending stream spilled or its chunked
    relation decoded for a bare-node consumer."""
    v = env[sym]
    if not isinstance(v, Frame):
        raise TypeError(f"{sym} is not a row frame")
    p0 = v.tables[v.order[0]]
    if isinstance(p0, _PendingStream):  # bare-node consumer: spill
        p0 = p0.force(env, refs, sigma, allow_sorted, params)
    if _is_chunked(p0):  # bare-node fallback: materialize the relation
        v = Frame({**v.tables, v.order[0]: p0.decode()}, v.order, v.rels)
        env[sym] = v
    return v


def _exec_node(node, env, refs, db, sigma, allow_sorted, params):
    """Execute ONE plan node against (env, refs)."""
    def rowfn(x, tables):
        return compile_rowfn_frame(x, tables, params)

    def frame_of(sym: str) -> Frame:
        return _frame_of(sym, env, refs, sigma, allow_sorted, params)

    if isinstance(node, P.Scan):
        if node.source in env:
            src = env[node.source]
            if isinstance(src, BuiltDict):
                t, rel = _dict_scan_table(src), None
            elif isinstance(src, (Table, _PendingStream)) or _is_chunked(src):
                t, rel = src, None
            else:
                raise TypeError(f"cannot scan {node.source}")
        else:
            t, rel = db[node.source], node.source
        env[node.out] = Frame({node.var: t}, (node.var,), {node.var: rel})

    elif isinstance(node, P.Select):
        f = frame_of(node.source)
        m = as_column(rowfn(node.pred, f.tables), torch.bool, f.primary.nrows, f.primary.device)
        env[node.out] = f.with_mask(m)

    elif isinstance(node, P.Project):
        f = frame_of(node.source)
        env[node.out] = _project(node, f, rowfn)

    elif isinstance(node, P.HashBuild):
        f = frame_of(node.source)
        n, dev = f.primary.nrows, f.primary.device
        keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
        _, _, srt = _key_info(f, node.keyexpr)
        srt = srt and allow_sorted
        cap = _capacity(f, node.keyexpr, node.choice.ds, sigma)
        d = build_index(
            node.choice.ds, keys, cap, valid=f.primary.mask,
            assume_sorted=srt and (node.choice.hinted or node.hinted),
        )
        env[node.out] = BuiltDict(d, node.choice, kind="index", src=f.primary)

    elif isinstance(node, P.HashProbe):
        f = frame_of(node.source)
        b = env[node.build]
        if not (isinstance(b, BuiltDict) and b.kind == "index"):
            raise TypeError(f"{node.build} is not an index")
        src_cols = {c: b.src.col(c) for c in b.src.names()}
        env[node.out] = _probe(node, f, b, src_cols, rowfn, allow_sorted)

    elif isinstance(node, P.GroupBy):
        fv = env[node.source]
        if isinstance(fv, Frame) and _is_chunked(fv.tables[fv.order[0]]):
            # bare group-by over a chunked relation: a one-stage streamed
            # region (the same fold machinery as fused pipelines)
            v0 = fv.order[0]
            _run_streamed_pipeline(
                node, [node], fv.tables[v0], v0, fv.rels.get(v0), env, refs, db,
                sigma, allow_sorted, params, P.needed_columns((node,)),
            )
            return
        f = frame_of(node.source)
        env[node.out] = BuiltDict(
            DictResult(node.choice.ds, _groupby_table(node, f, rowfn, sigma, allow_sorted)),
            node.choice, lanes=tuple(a for a, _ in node.values),
        )

    elif isinstance(node, P.GroupJoin):
        f = frame_of(node.source)
        b = env[node.build]
        env[node.out] = BuiltDict(
            DictResult(node.choice.ds, _groupjoin_table(node, f, b, rowfn, sigma, allow_sorted)),
            node.choice, lanes=("_0",),
        )

    elif isinstance(node, P.Reduce):
        f = frame_of(node.source)
        refs[node.out] = _reduce(node, f, env, rowfn, allow_sorted, params)

    elif isinstance(node, P.Pipeline):
        _run_pipeline(node, env, refs, db, sigma, allow_sorted, params)

    elif isinstance(node, (P.Repartition, P.Exchange)):
        # no collective implementation given: identity (rows all "here")
        if node.source in env:
            env[node.out] = env[node.source]

    else:
        raise AssertionError(node)


# -- per-node bodies shared by the node-by-node executor and the region path


def _project(node, f: Frame, rowfn) -> Table:
    n, dev = f.primary.nrows, f.primary.device
    cols = {}
    sorted_on: Tuple[str, ...] = ()
    for name, fx in node.fields:
        x = rowfn(fx, f.tables)
        cols[name] = x.expand(n) if isinstance(x, torch.Tensor) else as_column(x, torch.float32 if isinstance(x, float) else torch.int32, n, dev)
        # an identity copy of a sort-leading column keeps its orderedness
        if (
            not sorted_on
            and isinstance(fx, L.FieldAccess)
            and isinstance(fx.rec, L.FieldAccess)
            and fx.rec.name == "key"
            and isinstance(fx.rec.rec, L.Var)
            and fx.rec.rec.name in f.tables
            and f.tables[fx.rec.rec.name].sorted_on[:1] == (fx.name,)
        ):
            sorted_on = (name,)
    return Table(cols, n, mask=f.primary.mask, sorted_on=sorted_on)


def _probe(node, f: Frame, b: BuiltDict, src_cols, rowfn, allow_sorted) -> Frame:
    n, dev = f.primary.nrows, f.primary.device
    keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
    _, _, srt = _key_info(f, node.keyexpr)
    srt = srt and allow_sorted
    vals, found = lookup_dict(
        b.res, keys, valid=f.primary.mask,
        sorted_probes=srt and (node.hinted or b.choice.hinted),
    )
    ridx = torch.where(found, vals[:, 0].to(torch.int32), 0)
    gcols = {
        c: torch.where(found, _safe_gather(a, ridx), _zero(a))
        for c, a in src_cols.items()
    }
    gathered = Table(gcols, n, mask=found)
    masked = f.with_mask(found)
    return Frame(
        {**masked.tables, node.inner_var: gathered},
        masked.order + (node.inner_var,),
        {**masked.rels, node.inner_var: None},
    )


def _groupby_table(node, f: Frame, rowfn, sigma, allow_sorted):
    n, dev = f.primary.nrows, f.primary.device
    keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
    _, _, srt = _key_info(f, node.keyexpr)
    srt = srt and allow_sorted
    vals = torch.stack([as_column(rowfn(fx, f.tables), torch.float32, n, dev) for _, fx in node.values], dim=1)
    cap = _capacity(f, node.keyexpr, node.choice.ds, sigma)
    return groupby(
        f.primary, keys, vals, node.choice.ds, cap,
        assume_sorted=srt and (node.choice.hinted or node.hinted),
        ops=tuple(node.ops),
    ).table


def _groupjoin_table(node, f: Frame, b: BuiltDict, rowfn, sigma, allow_sorted):
    n, dev = f.primary.nrows, f.primary.device
    keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
    _, _, srt = _key_info(f, node.keyexpr)
    srt = srt and allow_sorted
    f_vals = as_column(rowfn(node.f_expr, f.tables), torch.float32, n, dev)
    cap = _capacity(f, node.keyexpr, node.choice.ds, sigma)
    return groupjoin(
        f.primary, keys, f_vals[:, None], b.res, node.choice.ds, cap,
        sorted_probes=srt and (node.hinted or b.choice.hinted),
        assume_sorted=srt and node.choice.hinted,
    ).table


def _groupby_fold(node, f: Frame, rowfn, allow_sorted, stream):
    """One streamed fold step of a GroupBy terminal (``stream=(state,
    capacity, final)``): the chunk's rows merge into the carried state."""
    n, dev = f.primary.nrows, f.primary.device
    keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
    _, _, srt = _key_info(f, node.keyexpr)
    srt = srt and allow_sorted
    vals = torch.stack([as_column(rowfn(fx, f.tables), torch.float32, n, dev) for _, fx in node.values], dim=1)
    state, cap, final = stream
    ds, ops = node.choice.ds, tuple(node.ops)
    if isinstance(state, _SortedStreamState):
        return _sorted_stream_merge(f.primary, keys, vals, ds, cap, state, ops=ops, final=final)
    return _merge_groupby(f.primary, keys, vals, ds, cap, state, ops=ops, sorted_merge=srt and ds.startswith("st")).table


def _groupjoin_fold(node, f: Frame, b: BuiltDict, rowfn, allow_sorted, stream):
    """One streamed fold step of a GroupJoin terminal."""
    n, dev = f.primary.nrows, f.primary.device
    keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
    _, _, srt = _key_info(f, node.keyexpr)
    srt = srt and allow_sorted
    f_vals = as_column(rowfn(node.f_expr, f.tables), torch.float32, n, dev)
    g_vals, found = lookup_dict(
        b.res, keys, valid=f.primary.mask, sorted_probes=srt and (node.hinted or b.choice.hinted),
    )
    state, cap, final = stream
    ds, tbl = node.choice.ds, f.primary.with_mask(found)
    if isinstance(state, _SortedStreamState):
        return _sorted_stream_merge(tbl, keys, f_vals[:, None] * g_vals, ds, cap, state, final=final)
    return _merge_groupby(tbl, keys, f_vals[:, None] * g_vals, ds, cap, state, sorted_merge=srt and ds.startswith("st")).table


def _reduce(node, f: Frame, denv, rowfn, allow_sorted, params):
    lanes: Tuple[str, ...] = ("m", "c", "c_c")
    lookup_vals = None
    if node.lookup_sym is not None:
        b = denv[node.lookup_sym]
        lanes = b.lanes or lanes
        n, dev = f.primary.nrows, f.primary.device
        keys = as_column(rowfn(node.lookup_key, f.tables), torch.int32, n, dev)
        _, _, srt = _key_info(f, node.lookup_key)
        srt = srt and allow_sorted
        lookup_vals, found = lookup_dict(
            b.res, keys, valid=f.primary.mask, sorted_probes=srt and b.choice.hinted
        )
        f = f.with_mask(found)
    fops = node.ops or ("sum",) * len(node.fields)
    total = {}
    for k, (name, fx) in enumerate(node.fields):
        col = _reduce_field(fx, f, node.lookup_var, lookup_vals, lanes, params=params)
        total[name] = scalar_aggregate(f.primary, col, ops=(fops[k],))[0]
    return total


def _reduce_field(fx, frame: Frame, lookup_var, lookup_vals, lane_names, params=None):
    """One field of a scalar-agg record; lookup-value accesses (``ra.m``)
    resolve into the looked-up value lanes by name (Fig. 7b's Ragg)."""
    lanes = {nm: i for i, nm in enumerate(lane_names)}

    def go(x):
        if isinstance(x, L.FieldAccess) and isinstance(x.rec, L.Var) and x.rec.name == lookup_var:
            return lookup_vals[:, lanes[x.name]]
        if isinstance(x, L.BinOp):
            return _BIN[x.op](go(x.lhs), go(x.rhs))
        if isinstance(x, L.UnOp):
            return _UN[x.op](go(x.operand))
        if isinstance(x, L.Const):
            return x.value
        return compile_rowfn_frame(x, frame.tables, params)

    return as_column(go(fx), torch.float32, frame.primary.nrows, frame.primary.device)


# ---------------------------------------------------------------------------
# structured execution telemetry
# ---------------------------------------------------------------------------


@dataclass
class RegionRecord:
    """Telemetry for ONE fused region, keyed by its terminal symbol.
    ``mode``: "xla" / "xla-radix-planned" (plain PyTorch region path),
    "kernel-resident" / "kernel-radix" (the fused-pipeline kernel, whole or
    radix-partitioned), "shared:N", or a streamed
    mode — "streamed:N" (N chunks through the region's stages),
    "streamed-kernel:N" (one fused-pipeline launch per chunk),
    "streamed-chained:N", "streamed-deferred"; ``family`` is the terminal
    dictionary's ds; ``wall_s`` host time; ``chunks`` and ``h2d_bytes`` the
    region's share of the streaming ledger."""

    sym: str
    mode: str = ""
    family: str = ""
    wall_s: float = 0.0
    chunks: int = 0
    h2d_bytes: int = 0


@dataclass
class ExecutionReport:
    """Per-execution telemetry attached to every ``execute_plan`` call:
    ``regions`` maps each fused region's terminal symbol to its
    :class:`RegionRecord`; ``wall_s`` is the call's host wall time; the
    streaming ledger counts streamed regions, chunks, the encoded bytes
    that crossed the host→device link, the largest decoded chunk working
    set (two chunks in flight plus chained intermediates) and the largest
    carried accumulator state, all computed from shapes."""

    regions: Dict[str, RegionRecord] = field(default_factory=dict)
    wall_s: float = 0.0
    chunks: int = 0
    h2d_bytes: int = 0
    peak_chunk_bytes: int = 0
    peak_state_bytes: int = 0
    streamed_regions: int = 0
    trace_count: int = 0
    shards: int = 1  # shards the call ran on (the sharded executor's)
    # fault-tolerance ledger, stamped by Session and QueryServer
    faults: int = 0  # typed faults observed while producing this result
    retries: int = 0  # same-mode retry attempts consumed
    degraded: int = 0  # ladder rungs descended (0 = primary mode)
    shed: int = 0  # requests shed by admission or deadline in the same round
    degradation: str = ""  # the rung that served, when degraded

    def modes(self) -> Dict[str, str]:
        return {s: r.mode for s, r in self.regions.items()}

    def mode(self, sym: str, default: str = "") -> str:
        rec = self.regions.get(sym)
        return rec.mode if rec is not None else default

    def region(self, sym: str) -> Optional[RegionRecord]:
        return self.regions.get(sym)

    def copy(self) -> "ExecutionReport":
        rep = ExecutionReport(regions={
            s: RegionRecord(r.sym, r.mode, r.family, r.wall_s, r.chunks, r.h2d_bytes)
            for s, r in self.regions.items()
        })
        for f in (
            "wall_s", "chunks", "h2d_bytes", "peak_chunk_bytes", "peak_state_bytes",
            "streamed_regions", "trace_count", "shards", "faults", "retries", "degraded", "shed", "degradation",
        ):
            setattr(rep, f, getattr(self, f))
        return rep

    def summary(self) -> str:
        parts = [f"wall={self.wall_s * 1e3:.2f}ms"]
        if self.shards > 1:
            parts.append(f"shards={self.shards}")
        if self.chunks:
            parts.append(f"chunks={self.chunks} h2d={self.h2d_bytes >> 10}KiB")
        if self.degraded:
            parts.append(f"degraded={self.degradation or '?'}")
        if self.faults or self.retries:
            parts.append(f"faults={self.faults} retries={self.retries}")
        lines = [" ".join(parts)]
        for s, r in self.regions.items():
            lines.append(f"  {s}: {r.mode}" + (f" [{r.family}]" if r.family else ""))
        return "\n".join(lines)


_ACTIVE_REPORTS: List[ExecutionReport] = []
_LAST_REPORT = ExecutionReport()


def last_report() -> ExecutionReport:
    """The ExecutionReport of the most recent execution in this process."""
    return _LAST_REPORT


def republish_report(base: Optional[ExecutionReport], wall_s: float, trace_count: int = 0,
                     shards: int = 1) -> ExecutionReport:
    """Publish a copy of ``base`` with a call's wall time, capture count and
    shard count (the sharded executor's report of each call)."""
    global _LAST_REPORT
    rep = base.copy() if base is not None else ExecutionReport()
    rep.wall_s = wall_s
    rep.trace_count = trace_count
    rep.shards = shards
    _LAST_REPORT = rep
    return rep


def _begin_report() -> ExecutionReport:
    rep = ExecutionReport()
    _ACTIVE_REPORTS.append(rep)
    return rep


def _end_report(rep: ExecutionReport, wall_s: float) -> None:
    global _LAST_REPORT
    if rep in _ACTIVE_REPORTS:
        _ACTIVE_REPORTS.remove(rep)
    rep.wall_s = wall_s
    _LAST_REPORT = rep


def _record_region(sym: str, mode: str, family: str = "", chunks: int = 0, h2d_bytes: int = 0, wall_s: float = 0.0) -> None:
    if _ACTIVE_REPORTS:
        rep = _ACTIVE_REPORTS[-1]
        rec = rep.regions.get(sym)
        if rec is None:
            rec = rep.regions[sym] = RegionRecord(sym=sym)
        rec.mode = mode
        if family:
            rec.family = family
        rec.chunks += chunks
        rec.h2d_bytes += h2d_bytes
        rec.wall_s += wall_s


# Per-process streaming ledger, reset by ``reset_stream_stats``; the
# structured ``ExecutionReport`` (``last_report()``) carries the same
# counts per execution.
STREAM_STATS: Dict[str, int] = {}


def reset_stream_stats() -> None:
    STREAM_STATS.update(regions=0, chunks=0, h2d_bytes=0, peak_chunk_bytes=0, peak_state_bytes=0)


reset_stream_stats()


def _account_stream(regions: int = 0, chunks: int = 0, h2d_bytes: int = 0, peak_chunk_bytes: int = 0, peak_state_bytes: int = 0) -> None:
    """Update the streaming ledger on the active report and ``STREAM_STATS``."""
    STREAM_STATS["regions"] += regions
    STREAM_STATS["chunks"] += chunks
    STREAM_STATS["h2d_bytes"] += h2d_bytes
    STREAM_STATS["peak_chunk_bytes"] = max(STREAM_STATS["peak_chunk_bytes"], peak_chunk_bytes)
    STREAM_STATS["peak_state_bytes"] = max(STREAM_STATS["peak_state_bytes"], peak_state_bytes)
    if _ACTIVE_REPORTS:
        rep = _ACTIVE_REPORTS[-1]
        rep.streamed_regions += regions
        rep.chunks += chunks
        rep.h2d_bytes += h2d_bytes
        rep.peak_chunk_bytes = max(rep.peak_chunk_bytes, peak_chunk_bytes)
        rep.peak_state_bytes = max(rep.peak_state_bytes, peak_state_bytes)


def _terminal_family(term) -> str:
    return getattr(getattr(term, "choice", None), "ds", "") or ""


# ---------------------------------------------------------------------------
# fused pipeline regions
# ---------------------------------------------------------------------------


def _region_input(pipe, env, refs, db, sigma, allow_sorted, params, need):
    """The frame a region runs over and the stages that run on it — or
    ``None`` when the region's input is chunked storage or a pending
    streamed chain, in which case the region has been handed to the
    streamed driver (``_run_streamed_pipeline``) and is done or deferred."""
    stages = pipe.stages
    if isinstance(stages[0], P.Scan):
        sc = stages[0]
        if sc.source in env:
            src = env[sc.source]
            if isinstance(src, BuiltDict):
                t, rel = _dict_scan_table(src), None
            elif isinstance(src, _PendingStream):
                if not isinstance(stages[-1], P.HashBuild):
                    # chain this pipeline's stages onto the pending loop
                    _run_streamed_pipeline(pipe, stages[1:], src, sc.var, None, env, refs, db, sigma, allow_sorted, params, need)
                    return None
                # index terminals need the materialized rows: spill
                t, rel = src.force(env, refs, sigma, allow_sorted, params), None
            elif isinstance(src, Table) or _is_chunked(src):
                t, rel = src, None
            else:
                raise TypeError(f"cannot scan {sc.source}")
        else:
            t, rel = db[sc.source], sc.source
        if _is_chunked(t):
            if not isinstance(stages[-1], P.HashBuild):
                _run_streamed_pipeline(pipe, stages[1:], t, sc.var, rel, env, refs, db, sigma, allow_sorted, params, need)
                return None
            # index terminals need global row ids, and their source serves
            # downstream gathers of columns this region never reads: decode
            # the relation whole
            t = t.decode(None)
        return Frame({sc.var: t}, (sc.var,), {sc.var: rel}), stages[1:]
    f = env[pipe.source]
    if not isinstance(f, Frame):
        raise TypeError(f"{pipe.source} is not a row frame")
    p0 = f.tables[f.order[0]]
    if isinstance(p0, _PendingStream):
        p0 = p0.force(env, refs, sigma, allow_sorted, params)
        f = Frame({**f.tables, f.order[0]: p0}, f.order, f.rels)
    if _is_chunked(p0):
        if len(f.order) == 1 and not isinstance(stages[-1], P.HashBuild):
            _run_streamed_pipeline(pipe, stages, p0, f.order[0], f.rels.get(f.order[0]), env, refs, db, sigma, allow_sorted, params, need)
            return None
        f = Frame({**f.tables, f.order[0]: p0.decode()}, f.order, f.rels)
    return f, stages


def _pruned_src_cols(rest, env, need) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per probe, the build-side columns later stages read."""
    src_cols: Dict[str, Dict[str, torch.Tensor]] = {}
    for node in rest:
        if isinstance(node, P.HashProbe):
            b = env[node.build]
            want = need.get(node.inner_var, ())
            src_cols[node.out] = {c: b.src.col(c) for c in b.src.names() if c in want}
    return src_cols


def _run_pipeline(pipe, env, refs, db, sigma, allow_sorted, params):
    """Execute a fused ``Pipeline`` region as one streaming pass: the
    fused-pipeline kernel when the region is eligible, else the region's
    stages as plain PyTorch with pruned probe gathers (only build-side
    columns later stages read are gathered).  A region over chunked storage
    streams chunk by chunk instead (``_run_streamed_pipeline``)."""
    need = P.needed_columns(pipe.stages)
    got = _region_input(pipe, env, refs, db, sigma, allow_sorted, params, need)
    if got is None:
        return
    f, rest = got
    _faults.check("fused-region", detail=pipe.out)
    if _kernel_pipeline(pipe, rest, f, env, refs, sigma, params, need):
        return
    _record_region(
        pipe.out,
        "xla-radix-planned" if getattr(pipe, "partitions", 0) else "xla",
        family=_terminal_family(rest[-1]),
    )
    _region_stages(rest, f, env, refs, _pruned_src_cols(rest, env, need), params, sigma, allow_sorted)


def _region_stages(rest, f, env, refs, src_cols, params, sigma, allow_sorted, stream=None):
    """Run a region's stage list over an input frame and store the
    terminal's result under its symbol.

    ``stream=(state, capacity, final)`` turns a GroupBy/GroupJoin terminal
    from a one-shot build into one streamed fold step: the chunk's rows
    merge into the carried accumulator, and the stored dictionary's table is
    the new state.  Every other stage is the resident math."""
    def rowfn(x, tables):
        return compile_rowfn_frame(x, tables, params)

    for node in rest:
        if isinstance(node, P.Select):
            m = as_column(rowfn(node.pred, f.tables), torch.bool, f.primary.nrows, f.primary.device)
            f = f.with_mask(m)
        elif isinstance(node, P.HashProbe):
            f = _probe(node, f, env[node.build], src_cols[node.out], rowfn, allow_sorted)
        elif isinstance(node, P.Project):
            env[node.out] = _project(node, f, rowfn)
            return
        elif isinstance(node, P.HashBuild):
            n, dev = f.primary.nrows, f.primary.device
            keys = as_column(rowfn(node.keyexpr, f.tables), torch.int32, n, dev)
            _, _, srt = _key_info(f, node.keyexpr)
            srt = srt and allow_sorted
            cap = _capacity(f, node.keyexpr, node.choice.ds, sigma)
            d = build_index(
                node.choice.ds, keys, cap, valid=f.primary.mask,
                assume_sorted=srt and (node.choice.hinted or node.hinted),
            )
            env[node.out] = BuiltDict(d, node.choice, kind="index", src=f.primary)
            return
        elif isinstance(node, P.GroupBy):
            table = (
                _groupby_table(node, f, rowfn, sigma, allow_sorted) if stream is None
                else _groupby_fold(node, f, rowfn, allow_sorted, stream)
            )
            env[node.out] = BuiltDict(DictResult(node.choice.ds, table), node.choice, lanes=tuple(a for a, _ in node.values))
            return
        elif isinstance(node, P.GroupJoin):
            b = env[node.build]
            table = (
                _groupjoin_table(node, f, b, rowfn, sigma, allow_sorted) if stream is None
                else _groupjoin_fold(node, f, b, rowfn, allow_sorted, stream)
            )
            env[node.out] = BuiltDict(DictResult(node.choice.ds, table), node.choice, lanes=("_0",))
            return
        elif isinstance(node, P.Reduce):
            refs[node.out] = _reduce(node, f, env, rowfn, allow_sorted, params)
            return
        else:
            raise AssertionError(node)
    raise AssertionError("region has no terminal")


def _param_scalar(v, device) -> torch.Tensor:
    """A binding as a 0-d tensor on ``device`` (bool, int32 or float32)."""
    if isinstance(v, torch.Tensor):
        return v.to(device).reshape(())
    if isinstance(v, (bool, np.bool_)):
        return torch.tensor(bool(v), device=device)
    if isinstance(v, (int, np.integer)):
        return torch.tensor(int(v), dtype=torch.int32, device=device)
    return torch.tensor(float(v), dtype=torch.float32, device=device)


class _KernelRegion(NamedTuple):
    """A region lowered for the fused-pipeline kernel: the program, the
    frame columns it streams (``(var, column)`` in program order), the
    resident dictionary bundles and parameter scalars, and the terminal.
    A radix region also carries its partition count, the partitioned
    dictionary and the LLQL key its fact rows are routed by."""

    program: object
    col_refs: Tuple[Tuple[str, str], ...]
    dicts: list
    pvals: list
    term: object
    acc_ds: Optional[str]
    out_cap: Optional[int]
    n_parts: int = 0
    radix_dict: object = None  # the partitioned BuiltDict
    radix_key: object = None


def _kernel_pipeline(pipe, rest, f, env, refs, sigma, params, need) -> bool:
    """Run the region through the fused-pipeline kernel; returns True when
    it ran and stored the terminal's result (see :func:`_kernel_region`).
    A region the plan marked for radix partitioning (``pipe.partitions``)
    routes its rows by the partition key first and records
    ``kernel-radix``."""
    n_parts = getattr(pipe, "partitions", 0)
    kr = _kernel_region(rest, f, env, sigma, params, need, n_parts=n_parts,
                        radix_sym=getattr(pipe, "part_sym", "") if n_parts else "")
    if kr is None:
        return False
    if kr.n_parts:
        cols, live, radix = _radix_inputs(kr, f, params)
        res = _fp.fused_pipeline(kr.program, cols, live, kr.dicts, kr.pvals, radix=radix)
    else:
        cols = [f.tables[v].col(c) for v, c in kr.col_refs]
        res = _fp.fused_pipeline(kr.program, cols, f.primary.live_mask(), kr.dicts, kr.pvals)
    term = kr.term
    _record_region(term.out, "kernel-radix" if kr.n_parts else "kernel-resident", family=_terminal_family(term))
    if kr.acc_ds is not None:
        lanes_out = tuple(a for a, _ in term.values) if isinstance(term, P.GroupBy) else ("_0",)
        env[term.out] = BuiltDict(DictResult(kr.acc_ds, _kernel_table(kr, res)), term.choice, lanes=lanes_out)
    else:
        refs[term.out] = {name: res[i] for i, (name, _) in enumerate(term.fields)}
    return True


def _radix_inputs(kr: _KernelRegion, f: Frame, params):
    """The region's columns and live mask routed by partition id, and the
    radix plan.  The partition key runs through the row compiler over the
    frame and the routing is plain torch, as the reference computes both in
    XLA outside its kernel."""
    kvals = as_column(compile_rowfn_frame(kr.radix_key, f.tables, params), torch.int32,
                      f.primary.nrows, f.primary.device)
    b = kr.radix_dict
    part = registry.get(b.res.ds).partition_assign(b.res.table, kvals, kr.n_parts)
    cols = {k: f.tables[v].col(c) for k, (v, c) in enumerate(kr.col_refs)}
    routed, live, plan = _fp.radix_route(cols, f.primary.live_mask(), part, kr.n_parts, _fp.ROW_BLOCK)
    plan = plan._replace(part_terminal=kr.program.part_terminal)
    return [routed[k] for k in range(len(kr.col_refs))], live, plan


def _kernel_table(kr: _KernelRegion, res):
    """The terminal dictionary's backend table from a launch's accumulator."""
    tk, tv = res
    term_ops = tuple(getattr(kr.term, "ops", ()) or ())
    if kr.program.part_terminal:  # [P, Cacc] per-partition accumulators: flatten
        tk = tk.reshape(-1)
        tv = tv.reshape(tk.shape[0], -1)
    elif registry.accumulates_resident(kr.acc_ds):
        # hash-family terminal: the accumulator IS the family's layout
        # (min/max lanes: clear the identity residue off dead slots)
        tv = dbase.finalize_dead(tk, tv, term_ops, dbase.EMPTY)
        return dbase.HashTable(tk, tv, _fp.MAX_PROBES)
    # sort-family (or partition-flattened) terminal: finalize through the
    # family's build — keys are unique per entry, so no sums move
    kw = {} if dbase.all_sum(term_ops) else {"ops": term_ops}
    return registry.get(kr.acc_ds).build(tk, tv, kr.out_cap, valid=tk != dbase.EMPTY, **kw)


def _kernel_region(rest, f, env, sigma, params, need, n_parts=0, radix_sym="", out_cap=None) -> Optional[_KernelRegion]:
    """Lower a region for the fused-pipeline kernel, or ``None`` when it is
    not eligible.

    Eligibility is structural only: an aggregating terminal, resident
    dictionary families with a CUDA find, and no probe symbol used twice.
    The kernel reads whole dictionaries from device memory, so only a
    radix-marked region (``n_parts`` on ``radix_sym``) partitions, as the
    reference's does: its dictionary must be partitionable into blocks of
    at least 256 slots, and a terminal keyed by the partition key
    accumulates per partition into ``next_pow2(2·cp)`` slots.  Only the
    frame's column names and dtypes, its relations and its row count are
    read, so one lowering serves every chunk of a stream; ``out_cap`` sizes
    a streamed terminal's accumulator for the whole relation."""
    term = rest[-1] if rest else None
    if not isinstance(term, (P.GroupBy, P.GroupJoin, P.Reduce)):
        return None
    probe_builds = [n.build for n in rest if isinstance(n, P.HashProbe)]
    if len(set(probe_builds)) != len(probe_builds):
        return None

    def _resident_ok(b, sym) -> bool:
        if not (isinstance(b, BuiltDict) and registry.resident(b.res.ds) and b.res.ds in _fp.FAMILIES):
            return False
        if sym != radix_sym:
            return True
        cap = registry.get(b.res.ds).resident_slabs(b.res.table)[0].shape[0]
        return registry.partitionable(b.res.ds) and cap % n_parts == 0 and cap // n_parts >= 256

    dev = f.primary.device
    col_refs, col_types = [], []
    scope: Dict[str, Dict[str, tuple]] = {}
    for var in f.order:
        t = f.tables[var]
        scope[var] = {}
        for c in t.names():
            if c in need.get(var, ()):
                ty = _fp.type_of(t.col(c).dtype)
                scope[var][c] = ("col", ty, len(col_refs))
                col_refs.append((var, c))
                col_types.append(ty)
    pnames = sorted(params or {})
    pvals = [_param_scalar(params[k], dev) for k in pnames]
    pnodes = {k: ("param", _fp.type_of(v.dtype), i) for i, (k, v) in enumerate(zip(pnames, pvals))}

    dicts, specs, stages = [], [], []
    radix = {}  # the partitioned dictionary and the key that probes it

    def add_dict(b, sym, fv, iv, keyexpr) -> int:
        if sym == radix_sym:
            dicts.append(_fp.partitioned_bundle(b.res.ds, b.res.table, fv, iv, n_parts))
            radix.update(dict=b, key=keyexpr)
        else:
            dicts.append(_fp.resident_bundle(b.res.ds, b.res.table, fv, iv))
        specs.append(_fp.DictSpec(b.res.ds, fv.shape[1], iv.shape[1], part=sym == radix_sym))
        return len(dicts) - 1

    def value_dict(b, sym, keyexpr) -> int:
        ks, vs, _ = b.res.arrays()
        return add_dict(b, sym, vs.to(torch.float32), torch.zeros((ks.shape[0], 0), dtype=torch.int32, device=dev), keyexpr)

    def lo(x):
        return lower_expr(x, scope, pnodes)

    term_ir = None
    try:
        for node in rest:
            if isinstance(node, P.Select):
                stages.append(("select", _fp.cast(lo(node.pred), "bool")))
            elif isinstance(node, P.HashProbe):
                b = env[node.build]
                if not (_resident_ok(b, node.build) and b.kind == "index"):
                    return None
                src_t = b.src
                want = tuple(c for c in src_t.names() if c in need.get(node.inner_var, ()))
                ks, vs, slot_ok = b.res.arrays()
                cap = ks.shape[0]
                rowidx = torch.where(slot_ok, vs[:, 0].to(torch.int32), 0)
                # payload re-keyed to dictionary slab positions; integer columns
                # ride the int32 slab (a float32 round-trip loses values > 2^24)
                want_f = tuple(c for c in want if src_t.col(c).is_floating_point())
                want_i = tuple(c for c in want if c not in want_f)
                gathered = {
                    c: torch.where(slot_ok, _safe_gather(src_t.col(c), rowidx), _zero(src_t.col(c)))
                    for c in want
                }
                fv = (
                    torch.stack([gathered[c].to(torch.float32) for c in want_f], dim=1)
                    if want_f else torch.zeros((cap, 0), dtype=torch.float32, device=dev)
                )
                iv = (
                    torch.stack([gathered[c].to(torch.int32) for c in want_i], dim=1)
                    if want_i else torch.zeros((cap, 0), dtype=torch.int32, device=dev)
                )
                key = _fp.cast(lo(node.keyexpr), "i32")
                d = add_dict(b, node.build, fv, iv, node.keyexpr)
                stages.append(("probe", d, key))
                scope[node.inner_var] = {
                    **{c: ("gath", _fp.type_of(src_t.col(c).dtype), d, "f", j) for j, c in enumerate(want_f)},
                    **{c: ("gath", _fp.type_of(src_t.col(c).dtype), d, "i", j) for j, c in enumerate(want_i)},
                }
            elif isinstance(node, P.GroupBy):
                term_ir = (
                    "groupby", _fp.cast(lo(node.keyexpr), "i32"),
                    tuple(_fp.cast(lo(fx), "f32") for _, fx in node.values),
                )
            elif isinstance(node, P.GroupJoin):
                b = env[node.build]
                if not _resident_ok(b, node.build):
                    return None
                d = value_dict(b, node.build, node.keyexpr)
                term_ir = (
                    "groupjoin", d, _fp.cast(lo(node.keyexpr), "i32"),
                    _fp.cast(lo(node.f_expr), "f32"),
                )
            elif isinstance(node, P.Reduce):
                lanes: Tuple[str, ...] = ("m", "c", "c_c")
                d, key, lookup_lanes = -1, None, {}
                if node.lookup_sym is not None:
                    b = env[node.lookup_sym]
                    if not _resident_ok(b, node.lookup_sym):
                        return None
                    lanes = b.lanes or lanes
                    d = value_dict(b, node.lookup_sym, node.lookup_key)
                    key = _fp.cast(lo(node.lookup_key), "i32")
                    lookup_lanes = {nm: ("gath", "f32", d, "f", j) for j, nm in enumerate(lanes)}
                term_ir = (
                    "reduce", d, key,
                    tuple(
                        lower_reduce_field(fx, scope, pnodes, node.lookup_var, lookup_lanes)
                        for _, fx in node.fields
                    ),
                )
    except _Unsupported:
        # a row expression the region program cannot hold: structurally
        # ineligible, so the region takes the plain-torch path on its device
        return None
    if radix_sym and not radix:
        return None  # the plan marked a partition target the region never probes
    if radix and not set(P.needed_columns((P.Select("", "", radix["key"]),))) <= set(f.order):
        return None  # the partition key is not computable from the streamed columns

    term_ops = tuple(getattr(term, "ops", ()) or ())
    acc_ds = None
    part_terminal = False
    if isinstance(term, (P.GroupBy, P.GroupJoin)):
        acc_ds = term.choice.ds
        if acc_ds not in registry.names():
            return None
        out_cap = out_cap or _capacity(f, term.keyexpr, acc_ds, sigma)
        n_lanes = len(term.values) if isinstance(term, P.GroupBy) else specs[term_ir[1]].nf
        acc_family = acc_ds if registry.accumulates_resident(acc_ds) else "ht_linear"
        if acc_family not in _fp.ACC_KIND:
            return None
        acc_cap = out_cap
        part_terminal = bool(radix) and term.keyexpr == radix["key"]
        if part_terminal:
            # a partition's terminal keys are among its block's live keys
            # (<= cp + overlap <= 2·cp): 2·cp slots bound the load at ~0.5
            acc_cap = dbase.next_pow2(2 * next(d.cp for d in dicts if d.n_parts))
        out = ("dict", acc_family, acc_cap, n_lanes, term_ops)
    else:
        out = ("sum", len(term.fields), term_ops)

    program = _fp.Program(tuple(col_types), tuple(v[1] for v in pnodes.values()), tuple(specs), tuple(stages),
                          term_ir, out, part_terminal=part_terminal)
    return _KernelRegion(program, tuple(col_refs), dicts, pvals, term, acc_ds, out_cap,
                         n_parts if radix else 0, radix.get("dict"), radix.get("key"))


# ---------------------------------------------------------------------------
# out-of-core streaming
# ---------------------------------------------------------------------------


def _is_chunked(x) -> bool:
    return STG.is_chunked(x)


def _tensor_bytes(x) -> int:
    """Device bytes of the tensors of a backend table or stream state."""
    return sum(t.numel() * t.element_size() for t in x if isinstance(t, torch.Tensor))


def _stream_capacity(meta_frame, keyexpr, ds: str, sigma, total_rows: int) -> int:
    """Dictionary capacity of a streamed terminal — what the resident path
    would pick: the Σ distinct estimate when available, else the TOTAL row
    count, never the per-chunk row count."""
    rel, cols, _ = _key_info(meta_frame, keyexpr)
    if sigma is not None and rel is not None and cols and "*" not in cols:
        try:
            return capacity_for(ds, int(sigma.dist(rel, cols)))
        except KeyError:
            pass
    return capacity_for(ds, total_rows)


def _merge_groupby(table, keys, vals, ds, capacity, state, ops=(), sorted_merge: bool = False) -> DictResult:
    """One streamed group-by step: fold a chunk's rows into the carried
    accumulator.  The state's live entries are re-presented as (key, value)
    rows AHEAD of the chunk's rows and rebuilt, so each key's fold continues
    in row order.  ``sorted_merge`` (a sort-family dictionary keyed by the
    stream's sort key): every state key precedes every chunk key, so the
    concatenation's live rows are already ordered and the build skips its
    sort."""
    if vals.dim() == 1:
        vals = vals[:, None]
    vals = _weight(table, vals, ops)
    sk, sv = state.keys, state.vals
    svalid = (sk != dbase.PAD) & (sk != dbase.EMPTY)
    mk = torch.cat([torch.where(svalid, sk, dbase.PAD), keys.to(torch.int32)])
    mv = torch.cat([sv, vals])
    valid = torch.cat([svalid, table.live_mask()])
    return build_dict(ds, mk, mv, capacity, valid=valid, assume_sorted=sorted_merge, ops=ops)


class _SortedStreamState(NamedTuple):
    """Carried accumulator of the sorted-stream path (a sort-family
    group-by keyed by the stream's sort key): chunks are contiguous slices
    of a key-sorted stream, so a group is complete once the stream moves
    past its key.  Each chunk appends its completed groups to
    ``out_k``/``out_v`` at row ``off`` (in place) and carries only the open
    boundary group (``bk``/``bv``)."""

    out_k: torch.Tensor  # [capacity + cap_chunk] emitted unique keys, PAD tail
    out_v: torch.Tensor  # [capacity + cap_chunk, V]
    off: int  # rows of out_k filled so far
    bk: int  # open boundary group's key (PAD when none)
    bv: torch.Tensor  # [V] boundary group's partial fold
    bvalid: bool


def _sorted_stream_chunk_cap(chunk_rows: int) -> int:
    # distinct keys in a chunk + the seeded boundary row, padded to the
    # st_blocked leaf multiple
    return -(-(chunk_rows + 1) // 128) * 128


def _sorted_stream_init(cap: int, chunk_rows: int, n_lanes: int, device) -> _SortedStreamState:
    cc = _sorted_stream_chunk_cap(chunk_rows)
    return _SortedStreamState(
        torch.full((cap + cc,), dbase.PAD, dtype=torch.int32, device=device),
        torch.zeros((cap + cc, n_lanes), dtype=torch.float32, device=device),
        0, dbase.PAD, torch.zeros((n_lanes,), dtype=torch.float32, device=device), False,
    )


def _sorted_stream_merge(table, keys, vals, ds, capacity, state: _SortedStreamState, ops=(), final: bool = False):
    """One sorted-stream fold step: group the chunk alone, seeded with the
    carried boundary partial (first, so the group's fold continues in row
    order), emit its completed groups, carry the new boundary.  On the
    ``final`` chunk the boundary is emitted too and the unique rows are laid
    out by one ordered build at the resident capacity."""
    if vals.dim() == 1:
        vals = vals[:, None]
    vals = _weight(table, vals, ops)
    dev = keys.device
    cap_chunk = state.out_k.shape[0] - capacity
    mk = torch.cat([torch.tensor([state.bk], dtype=torch.int32, device=dev), keys.to(torch.int32)])
    mv = torch.cat([state.bv[None, :], vals])
    valid = torch.cat([torch.tensor([state.bvalid], device=dev), table.live_mask()])
    t = build_dict(ds, mk, mv, cap_chunk, valid=valid, assume_sorted=True, ops=ops).table
    c = t.n if final else max(t.n - 1, 0)
    keep = torch.arange(cap_chunk, device=dev) < c
    state.out_k[state.off: state.off + cap_chunk] = torch.where(keep, t.keys, dbase.PAD)
    state.out_v[state.off: state.off + cap_chunk] = torch.where(keep[:, None], t.vals, _zero(t.vals))
    if final:
        fk = state.out_k[:capacity]
        return build_dict(ds, fk, state.out_v[:capacity], capacity, valid=fk != dbase.PAD, assume_sorted=True, ops=ops).table
    has = t.n > 0
    i = max(t.n - 1, 0)
    return _SortedStreamState(
        state.out_k, state.out_v, state.off + c,
        int(t.keys[i]) if has else dbase.PAD,
        t.vals[i] if has else torch.zeros_like(state.bv),
        has,
    )


def _empty_dict_state(ds: str, n_lanes: int, capacity: int, ops, device):
    """A zero-entry accumulator table (an all-invalid build) to seed the
    streamed fold; its shapes equal every later merge's."""
    return build_dict(
        ds,
        torch.full((1,), dbase.PAD, dtype=torch.int32, device=device),
        torch.zeros((1, n_lanes), dtype=torch.float32, device=device),
        capacity,
        valid=torch.zeros((1,), dtype=torch.bool, device=device),
        ops=ops,
    ).table


class _StreamSegment(NamedTuple):
    """One pipeline's worth of a streamed chunk loop: its stages (after the
    Scan), the var they address, and the build-side inputs (dictionaries,
    pruned gather sources) captured when the pipeline was reached."""

    out: str
    pipe: object  # the Pipeline node (or a bare GroupBy)
    rest: tuple
    var: str
    rel: Optional[str]
    builts: Dict[str, object]
    src_cols: Dict[str, Dict[str, torch.Tensor]]
    needed: Tuple[str, ...]  # pruned SOURCE columns (segment 0 only)
    need: Dict[str, tuple]


def _stream_segment(pipe, rest, var, rel, env, need, ct) -> _StreamSegment:
    dict_syms = []
    for node in rest:
        if isinstance(node, (P.HashProbe, P.GroupJoin)):
            dict_syms.append(node.build)
        elif isinstance(node, P.Reduce) and node.lookup_sym is not None:
            dict_syms.append(node.lookup_sym)
    builts = {s: env[s] for s in dict.fromkeys(dict_syms)}
    want = need.get(var, ())
    needed = tuple(c for c in ct.names() if c in want) or tuple(ct.names())
    return _StreamSegment(pipe.out, pipe, tuple(rest), var, rel, builts, _pruned_src_cols(rest, env, need), needed, dict(need))


class _PendingStream:
    """A streamed region whose Project-terminal output has NOT been
    materialized.  A downstream single-var pipeline that scans it extends
    the chain: its stages run as the next segment of the SAME chunk loop.
    Any consumer that needs the rows calls ``force``, which runs the chain
    and spills each chunk to a ``HostChunkedTable``.  Each extension builds
    a new pending sharing the prefix, so a second consumer re-streams from
    the source."""

    def __init__(self, ct, segments: tuple):
        self.ct = ct
        self.segments = segments

    @property
    def out(self) -> str:
        return self.segments[-1].out

    def names(self):  # metadata surface for needed-column pruning
        term = self.segments[-1].rest[-1]
        return tuple(name for name, _ in term.fields)

    def force(self, env, refs, sigma, allow_sorted, params):
        _exec_streamed_chain(self.ct, self.segments, env, refs, sigma, allow_sorted, params)
        return env[self.out]


def _make_streamed_chain_fn(segments, ct, needed, sigma, allow_sorted, cap, params):
    """The per-chunk function of a streamed chain: upload-complete chunk
    ``i`` is decoded on the device column by column (``ct.chunk_device`` →
    ``kernels.decode``), then the chained segments run back to back, one
    segment's Project output becoming the next segment's input frame.
    ``run(i, payloads, state, final)`` returns the last segment's terminal
    value: the folded state (GroupBy/GroupJoin), the projected
    ``(columns, mask, sorted_on)`` (Project) or the partial scalar record
    (Reduce)."""

    def run(i, payloads, state, final):
        t = ct.chunk_device(i, needed, pad=True, uploaded=payloads)
        cols, mask, srt = dict(t.columns), t.mask, t.sorted_on
        for j, seg in enumerate(segments):
            f = Frame({seg.var: Table(cols, ct.chunk_rows, mask=mask, sorted_on=srt)}, (seg.var,), {seg.var: seg.rel})
            scratch, srefs = dict(seg.builts), {}
            last = j == len(segments) - 1
            _region_stages(
                seg.rest, f, scratch, srefs, seg.src_cols, params, sigma, allow_sorted,
                stream=(state, cap, final) if last and state is not None else None,
            )
            term = seg.rest[-1]
            if isinstance(term, P.Project):
                out = scratch[term.out]
                cols, mask, srt = dict(out.columns), out.mask, out.sorted_on
            elif isinstance(term, P.Reduce):
                return srefs[term.out]
            else:
                return scratch[term.out].res.table
        return cols, mask, srt

    return run


def _run_streamed_pipeline(pipe, rest, ct, var, rel, env, refs, db, sigma, allow_sorted, params, need):
    """Entry point for a region whose scanned input is chunked storage (or a
    pending streamed chain).  A Project terminal does not run yet: it
    publishes a ``_PendingStream`` so downstream pipelines can chain onto
    the same chunk loop; any other terminal runs the chain now."""
    seg = _stream_segment(pipe, rest, var, rel, env, need, ct)
    if isinstance(ct, _PendingStream):
        segments, ct = ct.segments + (seg,), ct.ct
    else:
        segments = (seg,)
    if isinstance(rest[-1], P.Project):
        env[pipe.out] = _PendingStream(ct, segments)
        _record_region(pipe.out, "streamed-deferred")
        return
    _exec_streamed_chain(ct, segments, env, refs, sigma, allow_sorted, params)


def _exec_streamed_chain(ct, segments, env, refs, sigma, allow_sorted, params):
    """Run a chain of fused regions as ONE pass over a chunked relation.
    Chunks cross the host→device link encoded, chunk i+1's upload is
    started before chunk i is computed, each chunk decodes on the device
    and flows through every chained segment.  A GroupBy/GroupJoin terminal
    folds each chunk into an accumulator sized for the FULL relation (the
    fused-pipeline kernel per chunk where the region is eligible,
    ``_stream_kernel_chunks``); a Project terminal (a forced pending) spills
    each chunk back to host memory as a ``HostChunkedTable``; a Reduce
    terminal combines the per-chunk partials by each lane's monoid.  No
    decoded fact-table-sized array exists on the device."""
    t_chain = time.perf_counter()
    seg0, seg_last = segments[0], segments[-1]
    term = seg_last.rest[-1]
    needed = seg0.needed
    nchunks = ct.n_chunks
    dev = ct.device

    # -- carried accumulator for dict terminals -----------------------------
    is_dict_term = isinstance(term, (P.GroupBy, P.GroupJoin))
    state, cap, sorted_stream = None, 0, False
    term_ops: Tuple[str, ...] = ()
    if is_dict_term:
        term_ops = tuple(term.ops) if isinstance(term, P.GroupBy) else ()
        n_lanes = len(term.values) if isinstance(term, P.GroupBy) else 1
        if len(segments) == 1:
            meta_f = Frame({seg_last.var: ct}, (seg_last.var,), {seg_last.var: seg_last.rel})
            cap = _stream_capacity(meta_f, term.keyexpr, term.choice.ds, sigma, ct.nrows)
            # sort-family terminal keyed by the stream's sort key: fold by
            # completed-group emission instead of capacity-sized rebuilds
            if allow_sorted and term.choice.ds.startswith("st"):
                sorted_stream = bool(_key_info(meta_f, term.keyexpr)[2])
        else:
            # a chained input is an intermediate with no Σ row: size for the
            # full source row count
            cap = capacity_for(term.choice.ds, ct.nrows)
        state = (
            _sorted_stream_init(cap, ct.chunk_rows, n_lanes, dev) if sorted_stream
            else _empty_dict_state(term.choice.ds, n_lanes, cap, term_ops, dev)
        )
        _account_stream(peak_state_bytes=_tensor_bytes(state))

    chunk_dec_bytes = ct.chunk_rows * (4 * len(needed) + 1)
    # two decoded source chunks live at once (current compute + prefetched
    # next) plus each chained segment's intermediate projection of the chunk
    inter_bytes = sum(ct.chunk_rows * (4 * len(seg.rest[-1].fields) + 1) for seg in segments[:-1])
    _account_stream(regions=len(segments), peak_chunk_bytes=2 * chunk_dec_bytes + inter_bytes)

    # -- the fused-pipeline kernel per chunk, where the region is eligible --
    if is_dict_term and nchunks and len(segments) == 1:
        if _stream_kernel_chunks(seg0, ct, needed, cap, env, sigma, params):
            return

    # -- the region's stages per chunk --------------------------------------
    run = _make_streamed_chain_fn(segments, ct, needed, sigma, allow_sorted, cap, params)
    pin = dev.type == "cuda"
    host_chunks: list = []
    host_masks: list = []
    partials: list = []
    chain_h2d = 0
    up_next = ct.upload_chunk(0, needed)
    for i in range(nchunks):
        up, up_next = up_next, (ct.upload_chunk(i + 1, needed) if i + 1 < nchunks else None)
        chain_h2d += up[1]
        _account_stream(chunks=1, h2d_bytes=up[1])
        out = run(i, up[0], state, sorted_stream and i == nchunks - 1)
        if is_dict_term:
            state = out
        elif isinstance(term, P.Project):
            cols, mask, _ = out
            host_chunks.append({c: STG.host_copy(a, pin) for c, a in cols.items()})
            host_masks.append(STG.host_copy(mask, pin))
        else:
            partials.append(out)

    for seg in segments[:-1]:
        _record_region(seg.out, f"streamed-chained:{nchunks}", chunks=nchunks)
    _record_region(
        seg_last.out, f"streamed:{nchunks}", family=_terminal_family(term),
        chunks=nchunks, h2d_bytes=chain_h2d, wall_s=time.perf_counter() - t_chain,
    )

    # -- publish the terminal -----------------------------------------------
    if is_dict_term:
        lanes = tuple(a for a, _ in term.values) if isinstance(term, P.GroupBy) else ("_0",)
        env[term.out] = BuiltDict(DictResult(term.choice.ds, state), term.choice, lanes=lanes)
    elif isinstance(term, P.Project):
        if pin:  # the spill copies ran without blocking: land them first
            torch.cuda.current_stream(dev).synchronize()
        env[term.out] = STG.HostChunkedTable(
            chunks=host_chunks, masks=host_masks, chunk_rows=ct.chunk_rows, nrows=ct.nrows,
            schema={c: str(a.dtype).replace("torch.", "") for c, a in host_chunks[0].items()},
            sorted_on=tuple(out[2] or ()), device=dev,
        )
    else:  # scalar ref record: combine per-lane monoid partials
        fops = term.ops or ("sum",) * len(term.fields)
        total = {}
        for k, (name, _fx) in enumerate(term.fields):
            acc = partials[0][name]
            for p in partials[1:]:
                if fops[k] == "sum":
                    acc = acc + p[name]
                elif fops[k] == "min":
                    acc = torch.minimum(acc, p[name])
                else:
                    acc = torch.maximum(acc, p[name])
            total[name] = acc
        refs[term.out] = total


def _stream_kernel_chunks(seg, ct, needed, cap, env, sigma, params) -> bool:
    """One fused-pipeline launch per chunk for a single-segment dict
    terminal, folding into ONE accumulator sized for the whole relation:
    chunk i's launch takes the accumulator after chunk i-1 as ``init=``
    (updated in place), and after the last chunk ``_kernel_table``
    finalizes it once.  The region's columns that a chunk stores bitpacked,
    frame-of-reference, dictionary or RLE encoded reach the kernel as
    ``encoded=`` streams straight from the upload; the rest decode through
    ``chunk_device`` as before.  Returns False when the region is not
    kernel-eligible (decided structurally, before any chunk moves); a build
    or launch failure propagates."""
    rest, var, rel = seg.rest, seg.var, seg.rel
    term = rest[-1]
    nchunks = ct.n_chunks
    t_kern = time.perf_counter()
    # the lowering reads only column names and dtypes: an empty frame of
    # the chunk's shape stands in for chunk 0
    meta = Table(
        {c: torch.empty((0,), dtype=getattr(torch, ct.schema[c]), device=ct.device) for c in needed},
        ct.chunk_rows, sorted_on=ct.sorted_on,
    )
    kr = _kernel_region(rest, Frame({var: meta}, (var,), {var: rel}), {**env, **seg.builts}, sigma, params,
                        seg.need, out_cap=cap)
    if kr is None:
        return False
    # a column that is encoded in any chunk is read through an encoded
    # stream in every chunk (a plain chunk's decoded rows ride as raw), so
    # one program serves the whole stream
    encodable = isinstance(ct, STG.ChunkedTable)
    enc = tuple(encodable and any(ch[c].kind in DK.KINDS for ch in ct.chunks) for _, c in kr.col_refs)
    kr = kr._replace(program=kr.program._replace(enc=enc))
    _, _, acc_cap, V, ops = kr.program.out
    dev = ct.device
    acc = (
        torch.full((acc_cap,), dbase.EMPTY, dtype=torch.int32, device=dev),
        torch.zeros((acc_cap, V), dtype=torch.float32, device=dev) + dbase.lane_identity_row(ops, V, dev)[None, :],
    )
    kern_h2d = 0
    up_next = ct.upload_chunk(0, needed)
    for i in range(nchunks):
        up, up_next = up_next, (ct.upload_chunk(i + 1, needed) if i + 1 < nchunks else None)
        kern_h2d += up[1]
        _account_stream(chunks=1, h2d_bytes=up[1])
        streams = {
            k: DK.encoded_stream(ct.chunks[i][c], up[0][c]) for k, (_, c) in enumerate(kr.col_refs)
            if encodable and ct.chunks[i][c].kind in DK.KINDS
        }
        decoded = tuple(c for k, (_, c) in enumerate(kr.col_refs) if k not in streams)
        t_i = ct.chunk_device(i, decoded, pad=True, uploaded=up[0])
        cols = [None if k in streams else t_i.col(c) for k, (_, c) in enumerate(kr.col_refs)]
        acc = _fp.fused_pipeline(kr.program, cols, t_i.live_mask(), kr.dicts, kr.pvals, init=acc, encoded=streams)
    table = _kernel_table(kr, acc)
    _record_region(
        seg.out, f"streamed-kernel:{nchunks}", family=_terminal_family(term),
        chunks=nchunks, h2d_bytes=kern_h2d, wall_s=time.perf_counter() - t_kern,
    )
    lanes = tuple(a for a, _ in term.values) if isinstance(term, P.GroupBy) else ("_0",)
    env[term.out] = BuiltDict(DictResult(term.choice.ds, table), term.choice, lanes=lanes)
    return True


# ---------------------------------------------------------------------------
# cross-plan shared-scan execution
# ---------------------------------------------------------------------------


def _run_shared_region(region, envs, refss, db, sigma, allow_sorted, params_list):
    """Execute one shared-scan region and publish each branch's terminal
    into its owning plan's environment.

    Each branch the fused-pipeline kernel takes runs as its own launch
    (mode ``kernel-resident``), as the reference runs each branch through
    ``_run_pipeline`` under its kernel policy.  The remaining branches run
    as one plain-PyTorch pass: every branch re-frames the same scan-table
    column tensors and runs the region stages (mode ``shared:M``, M the
    branches in that pass).  Eager PyTorch reads the columns once per
    branch; the reference's XLA pass reads them once."""
    plain = []
    for br in region.branches:
        env, refs = envs[br.plan_idx], refss[br.plan_idx]
        need = P.needed_columns(br.pipe.stages)
        got = _region_input(br.pipe, env, refs, db, sigma, allow_sorted, params_list[br.plan_idx], need)
        if got is None:  # streamed over chunked storage, already published
            continue
        f, rest = got
        _faults.check("fused-region", detail=br.pipe.out)
        if not _kernel_pipeline(br.pipe, rest, f, env, refs, sigma, params_list[br.plan_idx], need):
            plain.append((br, f, rest, need))
    for br, f, rest, need in plain:
        env = envs[br.plan_idx]
        _region_stages(
            rest, f, env, refss[br.plan_idx], _pruned_src_cols(rest, env, need),
            params_list[br.plan_idx], sigma, allow_sorted,
        )
        _record_region(br.pipe.out, f"shared:{len(plain)}", family=_terminal_family(rest[-1]))


def execute_shared_plan(sp, db: Dict[str, Table], sigma=None, allow_sorted: bool = True, params_list=None,
                        exchange_impl=None, repartition_impl=None):
    """Execute every plan of a ``SharedPlan``, running each shared-scan
    region once for all its branches.  Results come back in ``sp.plans``
    order, each equal to what per-query ``execute_plan`` returns.  The
    collective hooks are :func:`execute_plan`'s."""
    return execute_shared_plan_lockstep(sp, [db], sigma, allow_sorted, [params_list], exchange_impl,
                                        repartition_impl)[0]


def execute_shared_plan_lockstep(sp, dbs, sigma=None, allow_sorted: bool = True, params_lists=None,
                                 exchange_impl=None, repartition_impl=None):
    """:func:`execute_shared_plan` once per shard database of ``dbs``, the
    shards' schedulers in lockstep at their collectives, as
    :func:`execute_plan_lockstep` runs plans.  Returns each shard's list of
    results."""
    nplans = len(sp.plans)
    params_lists = list(params_lists) if params_lists is not None else [None] * len(dbs)
    at = tuple(t for t, impl in ((P.Repartition, repartition_impl), (P.Exchange, exchange_impl)) if impl is not None)
    rep = _begin_report()
    t_plan = time.perf_counter()
    try:
        timed: set = set()
        steps = [
            _shared_plan_steps(sp, db, sigma, allow_sorted, list(pl) if pl is not None else [None] * nplans,
                               at, rep, timed, shard)
            for shard, (db, pl) in enumerate(zip(dbs, params_lists))
        ]
        return _lockstep(steps, exchange_impl, repartition_impl)
    finally:
        _end_report(rep, time.perf_counter() - t_plan)


def _shared_plan_steps(sp, db, sigma, allow_sorted, params_list, at, rep, timed, shard):
    """The readiness scheduler of one shard, as a generator that yields at
    its collectives (see :func:`_plan_steps`): each plan advances node by
    node until it stalls on a shared region that has not run; a region runs
    once every branch's external inputs (build-side dictionaries of its own
    plan) exist; nodes a region covers are skipped, since the region
    publishes their terminal symbols."""
    envs: List[Dict[str, object]] = [{} for _ in sp.plans]
    refss: List[Dict[str, object]] = [{} for _ in sp.plans]
    region_of: Dict[Tuple[int, str], int] = {}
    for ri, rg in enumerate(sp.regions):
        for b in rg.branches:
            for s in b.covered:
                region_of[(b.plan_idx, s)] = ri
    done = [False] * len(sp.regions)
    pos = [0] * len(sp.plans)

    def _ready(rg) -> bool:
        for b in rg.branches:
            own = {st.out for st in b.pipe.stages}
            env, refs = envs[b.plan_idx], refss[b.plan_idx]
            for st in b.pipe.stages:
                for r in P._node_refs(st):
                    if r in own or r == b.pipe.source or r in db:
                        continue
                    if r not in env and r not in refs:
                        return False
        return True

    while True:
        progress = False
        for i, p in enumerate(sp.plans):
            while pos[i] < len(p.nodes):
                nd = p.nodes[pos[i]]
                ri = region_of.get((i, nd.out))
                if ri is not None and not done[ri]:
                    break  # stalled on a pending shared region
                if ri is None and isinstance(nd, at):
                    yield from _collective(nd, envs[i], refss[i], sigma, allow_sorted, params_list[i])
                elif ri is None:
                    t_node = time.perf_counter()
                    _exec_node(nd, envs[i], refss[i], db, sigma, allow_sorted, params_list[i])
                    if isinstance(nd, P.Pipeline):
                        _note_wall(rep, nd.out, time.perf_counter() - t_node, timed, (i, nd.out), shard)
                pos[i] += 1
                progress = True
        if all(pos[i] >= len(p.nodes) for i, p in enumerate(sp.plans)):
            break
        for ri, rg in enumerate(sp.regions):
            if not done[ri] and _ready(rg):
                t_rg = time.perf_counter()
                _run_shared_region(rg, envs, refss, db, sigma, allow_sorted, params_list)
                dt = time.perf_counter() - t_rg
                for bi, b in enumerate(rg.branches):
                    _note_wall(rep, b.pipe.stages[-1].out, dt, timed, ("region", ri, bi), shard)
                done[ri] = True
                progress = True
        if not progress:  # pragma: no cover
            raise RuntimeError(
                "shared-scan scheduler stalled: a region's inputs depend on "
                "nodes the region itself covers"
            )
    return [_plan_result(p, envs[i], refss[i]) for i, p in enumerate(sp.plans)]


# ---------------------------------------------------------------------------
# executable cache: plan once per query shape, execute many bindings
# ---------------------------------------------------------------------------


@dataclass
class PlanResult:
    """Array view of a dictionary-valued plan result."""

    ds: str
    keys: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor

    def arrays(self):
        return self.keys, self.vals, self.valid

    def items_np(self) -> Dict[int, np.ndarray]:
        return items_np(self.keys, self.vals, self.valid)

    def size(self) -> int:
        return int(self.valid.sum())


_KIND_DTYPES = {
    "int": torch.int32,
    "bool": torch.bool,
    "double": torch.float32,
    "string": torch.int32,  # dictionary-encoded
}


def _raise_classified(err: BaseException):
    """Re-raise ``err`` as its typed classification, or unchanged."""
    typed = _errors.classify(err)
    if typed is not None and typed is not err:
        raise typed from err
    raise err


def coerce_bindings(plan, params, device="cpu"):
    """Validate a binding against ``plan.params`` and coerce every value to
    a 0-d tensor of its declared dtype on ``device``."""
    params = dict(params or {})
    declared = dict(plan.params)
    unknown = set(params) - set(declared)
    if unknown:
        raise KeyError(f"unknown parameters {sorted(unknown)}")
    missing = set(declared) - set(params)
    if missing:
        raise KeyError(f"missing bindings for {sorted(missing)}")
    return {
        name: torch.as_tensor(
            params[name].item() if isinstance(params[name], torch.Tensor) else params[name],
            dtype=_KIND_DTYPES.get(kind, torch.float32), device=device,
        )
        for name, kind in plan.params
    }


def validate_binding(plan, params, defaults=None):
    """API-boundary binding validation: raises a permanent
    :class:`repro_torch.errors.PlanError` for unknown names, missing
    bindings, NaN floats and kind-incompatible values.  Returns the merged
    plain-python binding dict."""
    merged = {**(defaults or {}), **(params or {})}
    declared = dict(plan.params)
    unknown = sorted(set(merged) - set(declared))
    if unknown:
        raise _errors.PlanError(f"unknown parameter(s) {unknown}; declared: {sorted(declared)}")
    missing = sorted(set(declared) - set(merged))
    if missing:
        raise _errors.PlanError(f"missing binding(s) for {missing}")
    for name, kind in plan.params:
        v = merged[name]
        if isinstance(v, (torch.Tensor, np.ndarray, np.generic)):
            if np.ndim(to_numpy(v)) != 0:
                raise _errors.PlanError(f"parameter {name!r} must be a scalar, got shape {tuple(v.shape)}")
            v = to_numpy(v).item()
        if kind == "double":
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise _errors.PlanError(f"parameter {name!r} is double; got {type(v).__name__} {v!r}")
            if isinstance(v, float) and v != v:
                raise _errors.PlanError(f"parameter {name!r} is NaN")
        elif kind in ("int", "string"):
            if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
                raise _errors.PlanError(f"parameter {name!r} is {kind} (integral); got {type(v).__name__} {v!r}")
        elif kind == "bool":
            if not isinstance(v, (bool, np.bool_)):
                raise _errors.PlanError(f"parameter {name!r} is bool; got {type(v).__name__} {v!r}")
    return merged


class Executable:
    """A planned query shape: the plan, run eagerly on the tables' device
    with the binding passed as 0-d tensors.  ``trace_count`` counts
    captures of the shape (one; rebinding never re-plans)."""

    #: a batch runs as B warm calls: the plain loops end each round on a
    #: host-synced ``.any()``, which ``torch.func.vmap`` cannot batch
    vmapped_batches = False

    def __init__(self, plan, db: Dict[str, Table], sigma=None):
        self.plan = plan
        self.sigma = sigma
        self.fused_regions = sum(isinstance(n, P.Pipeline) for n in plan.nodes)
        self.trace_count = 0
        self.calls = 0
        self.last_report: Optional[ExecutionReport] = None

    def _check_dispatch(self):
        """The resident whole-plan dispatch's fault points."""
        _faults.check("kernel-launch")
        if self.fused_regions:
            _faults.check("fused-region")

    def _run(self, db: Dict[str, Table], params):
        self.calls += 1
        device = next(iter(db.values())).device
        try:
            out = execute_plan(self.plan, db, sigma=self.sigma, params=coerce_bindings(self.plan, params, device=device))
        except Exception as e:  # noqa: BLE001 — boundary translation only
            _raise_classified(e)
        self.trace_count = max(self.trace_count, 1)
        rep = last_report()
        rep.trace_count = self.trace_count
        self.last_report = rep
        return _result_view(out)

    def __call__(self, db: Dict[str, Table], params=None):
        self._check_dispatch()
        return self._run(db, params)

    def call_batched(self, db: Dict[str, Table], params_list):
        """B same-shape requests as B warm calls, with the dispatch points
        checked once for the batch.  A plan without params runs once and
        every request shares that result."""
        if not params_list:
            return []
        self._check_dispatch()
        if not self.plan.params:
            one = self._run(db, None)
            return [one for _ in params_list]
        return [self._run(db, p) for p in params_list]


def _result_view(out):
    """A plan's result as callers receive it: dictionaries as array views."""
    if isinstance(out, DictResult):
        return PlanResult(out.ds, *out.arrays())
    return out


class StreamedExecutable(Executable):
    """Executable for databases holding chunked (out-of-core) relations.
    The streamed driver is a host-side loop over chunks, so each call runs
    ``execute_plan`` eagerly on the device the chunks stream to; the report
    carries the call's streaming ledger."""

    def _check_dispatch(self):
        """None: the streamed executor's fault points are the stream's (``h2d``,
        ``chunk-decode``) and its resident regions' ``fused-region``, which
        is why streaming is the degradation ladder's last rung."""


@dataclass
class BoundExecutable:
    """A cached executable viewed through a ``BoundPlan``'s bindings: the
    underlying executable is shared across bindings; call-time params
    override the bound ones."""

    executable: Executable
    bindings: Dict[str, object]

    def __call__(self, db, params=None):
        return self.executable(db, {**self.bindings, **(params or {})})

    def call_batched(self, db, params_list):
        return self.executable.call_batched(db, [{**self.bindings, **(p or {})} for p in params_list])

    @property
    def trace_count(self) -> int:
        return self.executable.trace_count

    @property
    def vmapped_batches(self) -> bool:
        return self.executable.vmapped_batches

    @property
    def last_report(self) -> Optional[ExecutionReport]:
        return self.executable.last_report

    @property
    def plan(self):
        return self.executable.plan


_EXEC_CACHE: Dict[tuple, Executable] = {}
_EXEC_CACHE_STATS = {"hits": 0, "misses": 0}
_EXEC_CACHE_MAX = 64


def _db_signature(db: Dict[str, Table]) -> tuple:
    sig = []
    for rel, t in sorted(db.items()):
        if _is_chunked(t):
            sig.append((rel, "chunked") + tuple(t.signature()))
        else:
            sig.append((
                rel, t.nrows, t.mask is None, t.sorted_on, str(t.device),
                tuple((c, str(a.dtype)) for c, a in sorted(t.columns.items())),
            ))
    return tuple(sig)


def _sigma_signature(sigma) -> tuple:
    if sigma is None:
        return ()
    return tuple(
        (rel, st.rows, tuple(sorted((c, cs.distinct) for c, cs in st.columns.items())))
        for rel, st in sorted(sigma.rels.items())
    )


def cached_executable(plan, db: Dict[str, Table], sigma=None):
    """The executable cache, keyed by (plan fingerprint, DictChoice tuple,
    table schema, Σ signature); a database with chunked relations gets a
    :class:`StreamedExecutable`.  A ``BoundPlan`` shares its plan's entry
    and comes back as a :class:`BoundExecutable` over it."""
    bound = None
    if isinstance(plan, P.BoundPlan):
        bound = plan.binding_map()
        plan = plan.plan
    key = (plan.fingerprint(), plan.choices, _db_signature(db), _sigma_signature(sigma))
    ex = _EXEC_CACHE.get(key)
    if ex is None:
        _EXEC_CACHE_STATS["misses"] += 1
        # a failed compile leaves no entry: a retry compiles from scratch
        _faults.check("compile", detail=str(plan.fingerprint())[:40])
        cls = StreamedExecutable if any(_is_chunked(t) for t in db.values()) else Executable
        ex = cls(plan, db, sigma=sigma)
        if len(_EXEC_CACHE) >= _EXEC_CACHE_MAX:
            _EXEC_CACHE.pop(next(iter(_EXEC_CACHE)))
        _EXEC_CACHE[key] = ex
    else:
        _EXEC_CACHE_STATS["hits"] += 1
    return ex if bound is None else BoundExecutable(ex, bound)


def exec_cache_stats() -> Dict[str, int]:
    return dict(_EXEC_CACHE_STATS, entries=len(_EXEC_CACHE))


class SharedExecutable:
    """A planned multi-query batch (a ``SharedPlan``), run eagerly on the
    tables' device; shared regions run once for all their branches.  Output
    order matches ``sp.plans`` and each result is wrapped as
    :class:`Executable` wraps it, so callers demultiplex by position.
    ``trace_count`` is 1 after the first call and stays there."""

    def __init__(self, sp, db: Dict[str, Table], sigma=None):
        self.sp = sp
        self.sigma = sigma
        self.trace_count = 0
        self.calls = 0
        self.last_report: Optional[ExecutionReport] = None

    def coerce_params(self, params_list=None, device="cpu"):
        params_list = params_list or [None] * len(self.sp.plans)
        return [coerce_bindings(p, params_list[i], device=device) for i, p in enumerate(self.sp.plans)]

    def __call__(self, db: Dict[str, Table], params_list=None):
        self.calls += 1
        device = next(iter(db.values())).device
        _faults.check("kernel-launch", detail="shared")
        try:
            outs = execute_shared_plan(
                self.sp, db, sigma=self.sigma,
                params_list=self.coerce_params(params_list, device=device),
            )
        except Exception as e:  # noqa: BLE001 — boundary translation only
            _raise_classified(e)
        self.trace_count = max(self.trace_count, 1)
        rep = last_report()
        rep.trace_count = self.trace_count
        self.last_report = rep
        return [_result_view(out) for out in outs]


_SHARED_EXEC_CACHE: Dict[tuple, SharedExecutable] = {}


def cached_shared_executable(sp, db: Dict[str, Table], sigma=None) -> SharedExecutable:
    """Shared-batch twin of :func:`cached_executable`: keyed by the
    SharedPlan fingerprint (plan fingerprints + merged regions), schema and
    Σ signature."""
    key = (sp.fingerprint(), _db_signature(db), _sigma_signature(sigma))
    ex = _SHARED_EXEC_CACHE.get(key)
    if ex is None:
        _faults.check("compile", detail="shared")
        ex = SharedExecutable(sp, db, sigma=sigma)
        if len(_SHARED_EXEC_CACHE) >= _EXEC_CACHE_MAX:
            _SHARED_EXEC_CACHE.pop(next(iter(_SHARED_EXEC_CACHE)))
        _SHARED_EXEC_CACHE[key] = ex
    return ex


def clear_exec_cache() -> None:
    """Drop every cached executable, single-query and shared, and reset
    the cache's hit and miss counts."""
    _EXEC_CACHE.clear()
    _SHARED_EXEC_CACHE.clear()
    _EXEC_CACHE_STATS.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# sort-based aggregation via the segment-reduce kernel (direct form)
# ---------------------------------------------------------------------------


def sort_groupby_arrays(keys, vals, valid=None, assume_sorted: bool = False):
    """``(keys [n], sums [n, V], ends [n])``: run totals at run ends.  The
    raw sort-aggregate pipeline (sort, then segment reduce), used by the
    in-DB ML operator where the dictionary object itself is not needed.
    Masked rows become PAD keys with zero values and sort to the tail; the
    sort is stable, as ``jnp.argsort`` is, so sums fold in the same order."""
    if vals.dim() == 1:
        vals = vals[:, None]
    keys = keys.to(torch.int32)
    vals = vals.to(torch.float32)
    if valid is not None:
        valid = valid.to(torch.bool)
        keys = torch.where(valid, keys, dbase.PAD)
        vals = torch.where(valid[:, None], vals, _zero(vals))
        assume_sorted = False
    if not assume_sorted:
        perm = torch.argsort(keys, stable=True)
        keys, vals = keys[perm], vals[perm]
    sums, ends = kops.segment_reduce(keys.contiguous(), vals.contiguous())
    return keys, sums, ends


# ---------------------------------------------------------------------------
# in-DB ML: factorized covariance (paper Fig. 7d)
# ---------------------------------------------------------------------------


def covar_factorized(
    s_table: Table,
    r_table: Table,
    join_col: str = "s",
    i_col: str = "i",
    c_col: str = "c",
    ragg_ds: str = "st_sorted",
    sorted_probes: bool = True,
    ragg_capacity: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Covariance terms over S ⋈ R without materializing the join.

    S's inner partial aggregates (i·i, i, 1 per join key — Fig. 7d's
    ``sagg``) come from one segment-reduce pass (no sort when S is ordered
    on the join column); R's partial aggregates (m, c, c·c — ``Ragg``) are
    one group-by; the combine probes Ragg with S's run keys, a sorted probe
    stream (the hinted, merge-lookup path for sort-family dictionaries).
    Results are 0-d float32 tensors on the tables' device."""
    s = s_table.col(join_col)
    i = s_table.col(i_col)
    sagg_in = torch.stack([i * i, i, torch.ones_like(i)], dim=1)
    skeys, ssums, sends = sort_groupby_arrays(
        s, sagg_in, valid=s_table.mask,
        assume_sorted=s_table.sorted_on[:1] == (join_col,),
    )
    c = r_table.col(c_col)
    ragg_in = torch.stack([torch.ones_like(c), c, c * c], dim=1)  # m, c, c_c
    cap = ragg_capacity or capacity_for(ragg_ds, r_table.nrows)
    ragg = groupby(
        r_table, r_table.col(join_col), ragg_in, ragg_ds, cap,
        assume_sorted=r_table.sorted_on[:1] == (join_col,),
    )
    rvals, found = lookup_dict(ragg, skeys, valid=sends, sorted_probes=sorted_probes)
    zero = _zero(rvals)
    return {
        "i_i": torch.where(found, ssums[:, 0] * rvals[:, 0], zero).sum(),
        "i_c": torch.where(found, ssums[:, 1] * rvals[:, 1], zero).sum(),
        "c_c": torch.where(found, ssums[:, 2] * rvals[:, 2], zero).sum(),
    }


def covar_naive(
    s_table: Table,
    r_table: Table,
    join_col: str = "s",
    i_col: str = "i",
    c_col: str = "c",
    index_ds: str = "ht_linear",
) -> Dict[str, torch.Tensor]:
    """Fig. 7a baseline: materialize the join (FK gather), then aggregate."""
    cap = capacity_for(index_ds, r_table.nrows)
    idx = build_index(index_ds, r_table.col(join_col), cap, valid=r_table.mask)
    joined = fk_join(s_table, s_table.col(join_col), r_table, idx, take=[c_col], prefix="r_")
    i = joined.col(i_col)
    c = joined.col("r_" + c_col)
    out = scalar_aggregate(joined, torch.stack([i * i, i * c, c * c], dim=1))
    return {"i_i": out[0], "i_c": out[1], "c_c": out[2]}
