"""Vectorized physical operators — the generated-engine runtime, in PyTorch.

The twin of ``repro.exec.engine`` for the in-memory, single-device path.
Static shapes throughout: selection is masking (never compaction), joins
are FK index-gathers with found-masks, group-bys are fixed-capacity
dictionary builds.  ``repro`` traces the whole plan under ``jax.jit``; the
port runs eagerly on the tables' device and keeps the same masking, so
capacities and results match.

Fused ``Pipeline`` regions whose terminal aggregates run through the
fused-pipeline kernel (``kernels.fused_pipeline``: the CUDA kernel on the
card, its plain twin on the CPU); every other region runs as plain PyTorch
on the tables' device (mode ``"xla"``, as the reference computes those
regions in XLA outside Pallas).  Sorted-probe lookups of sort-family
dictionaries go through the merge-lookup kernel.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import errors as _errors
from repro_torch.core import llql as L
from repro_torch.core import plan as P
from repro_torch.core.cardinality import key_columns
from repro_torch.core.lower import _BIN, _UN, DICT_KEY, DICT_VAL, _Unsupported, as_column, compile_rowfn_frame
from repro_torch.data.table import Table, to_numpy
from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry
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
        if valid is not None:
            found = found & valid.to(torch.bool)
            vals = torch.where(found[:, None], vals, _zero(vals))
        return vals, found
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


def execute_plan(plan, db: Dict[str, Table], sigma=None, allow_sorted: bool = True, params=None):
    """Run a physical plan (``repro_torch.core.plan``) against a database.
    ``allow_sorted=False`` disables the sorted-input/merge fast paths;
    ``params`` supplies the plan's free ``L.Param`` values."""
    env: Dict[str, object] = {}
    refs: Dict[str, object] = {}
    rep = _begin_report()
    t_plan = time.perf_counter()
    try:
        for node in plan.nodes:
            t_node = time.perf_counter()
            _exec_node(node, env, refs, db, sigma, allow_sorted, params)
            if isinstance(node, P.Pipeline):
                rec = rep.regions.get(node.out)
                if rec is not None and rec.wall_s == 0.0:
                    rec.wall_s = time.perf_counter() - t_node
        return _plan_result(plan, env, refs)
    finally:
        _end_report(rep, time.perf_counter() - t_plan)


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


def _exec_node(node, env, refs, db, sigma, allow_sorted, params):
    """Execute ONE plan node against (env, refs)."""
    def rowfn(x, tables):
        return compile_rowfn_frame(x, tables, params)

    def frame_of(sym: str) -> Frame:
        v = env[sym]
        if not isinstance(v, Frame):
            raise TypeError(f"{sym} is not a row frame")
        return v

    if isinstance(node, P.Scan):
        if node.source in env:
            src = env[node.source]
            if isinstance(src, BuiltDict):
                t, rel = _dict_scan_table(src), None
            elif isinstance(src, Table):
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
        # single device: identity (rows already all "here")
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
    ``mode``: "xla" / "xla-radix-planned" (plain PyTorch region path) or
    "kernel-resident" (the fused-pipeline kernel); ``family`` is the
    terminal dictionary's ds; ``wall_s`` host dispatch time."""

    sym: str
    mode: str = ""
    family: str = ""
    wall_s: float = 0.0


@dataclass
class ExecutionReport:
    """Per-execution telemetry attached to every ``execute_plan`` call:
    ``regions`` maps each fused region's terminal symbol to its
    :class:`RegionRecord`; ``wall_s`` is the call's host wall time."""

    regions: Dict[str, RegionRecord] = field(default_factory=dict)
    wall_s: float = 0.0
    trace_count: int = 0

    def modes(self) -> Dict[str, str]:
        return {s: r.mode for s, r in self.regions.items()}

    def mode(self, sym: str, default: str = "") -> str:
        rec = self.regions.get(sym)
        return rec.mode if rec is not None else default

    def region(self, sym: str) -> Optional[RegionRecord]:
        return self.regions.get(sym)

    def summary(self) -> str:
        lines = [f"wall={self.wall_s * 1e3:.2f}ms"]
        for s, r in self.regions.items():
            lines.append(f"  {s}: {r.mode}" + (f" [{r.family}]" if r.family else ""))
        return "\n".join(lines)


_ACTIVE_REPORTS: List[ExecutionReport] = []
_LAST_REPORT = ExecutionReport()


def last_report() -> ExecutionReport:
    """The ExecutionReport of the most recent execution in this process."""
    return _LAST_REPORT


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


def _record_region(sym: str, mode: str, family: str = "") -> None:
    if _ACTIVE_REPORTS:
        rep = _ACTIVE_REPORTS[-1]
        rec = rep.regions.get(sym)
        if rec is None:
            rec = rep.regions[sym] = RegionRecord(sym=sym)
        rec.mode = mode
        if family:
            rec.family = family


def _terminal_family(term) -> str:
    return getattr(getattr(term, "choice", None), "ds", "") or ""


# ---------------------------------------------------------------------------
# fused pipeline regions
# ---------------------------------------------------------------------------


def _run_pipeline(pipe, env, refs, db, sigma, allow_sorted, params):
    """Execute a fused ``Pipeline`` region as one streaming pass: the
    fused-pipeline kernel when the region is eligible, else the region's
    stages as plain PyTorch with pruned probe gathers (only build-side
    columns later stages read are gathered)."""
    need = P.needed_columns(pipe.stages)
    stages = pipe.stages
    if isinstance(stages[0], P.Scan):
        sc = stages[0]
        if sc.source in env:
            src = env[sc.source]
            if isinstance(src, BuiltDict):
                t, rel = _dict_scan_table(src), None
            elif isinstance(src, Table):
                t, rel = src, None
            else:
                raise TypeError(f"cannot scan {sc.source}")
        else:
            t, rel = db[sc.source], sc.source
        f = Frame({sc.var: t}, (sc.var,), {sc.var: rel})
        rest = stages[1:]
    else:
        f = env[pipe.source]
        if not isinstance(f, Frame):
            raise TypeError(f"{pipe.source} is not a row frame")
        rest = stages

    _faults.check("fused-region", detail=pipe.out)
    if _kernel_pipeline(pipe, rest, f, env, refs, sigma, params, need):
        return
    _record_region(
        pipe.out,
        "xla-radix-planned" if getattr(pipe, "partitions", 0) else "xla",
        family=_terminal_family(rest[-1]),
    )
    src_cols: Dict[str, Dict[str, torch.Tensor]] = {}
    for node in rest:
        if isinstance(node, P.HashProbe):
            b = env[node.build]
            want = need.get(node.inner_var, ())
            src_cols[node.out] = {c: b.src.col(c) for c in b.src.names() if c in want}
    _region_stages(rest, f, env, refs, src_cols, params, sigma, allow_sorted)


def _region_stages(rest, f, env, refs, src_cols, params, sigma, allow_sorted):
    """Run a region's stage list over an input frame and store the
    terminal's result under its symbol."""
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
            env[node.out] = BuiltDict(
                DictResult(node.choice.ds, _groupby_table(node, f, rowfn, sigma, allow_sorted)),
                node.choice, lanes=tuple(a for a, _ in node.values),
            )
            return
        elif isinstance(node, P.GroupJoin):
            env[node.out] = BuiltDict(
                DictResult(node.choice.ds, _groupjoin_table(node, f, env[node.build], rowfn, sigma, allow_sorted)),
                node.choice, lanes=("_0",),
            )
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


def _kernel_pipeline(pipe, rest, f, env, refs, sigma, params, need) -> bool:
    """Run the region through the fused-pipeline kernel; returns True when
    it ran and stored the terminal's result.

    Eligibility is structural only: an aggregating terminal, resident
    dictionary families with a CUDA find, and no probe symbol used twice.
    The kernel reads dictionaries from device memory, so there is no
    residency bound: radix-marked regions (``pipe.partitions``) run
    unpartitioned over the whole dictionary, and the terminal accumulates
    into ``out_cap`` slots."""
    term = rest[-1] if rest else None
    if not isinstance(term, (P.GroupBy, P.GroupJoin, P.Reduce)):
        return False
    probe_builds = [n.build for n in rest if isinstance(n, P.HashProbe)]
    if len(set(probe_builds)) != len(probe_builds):
        return False

    def _resident_ok(b) -> bool:
        return (
            isinstance(b, BuiltDict)
            and registry.resident(b.res.ds)
            and b.res.ds in _fp.FAMILIES
        )

    dev = f.primary.device
    n = f.primary.nrows
    cols, col_types = [], []
    scope: Dict[str, Dict[str, tuple]] = {}
    for var in f.order:
        t = f.tables[var]
        scope[var] = {}
        for c in t.names():
            if c in need.get(var, ()):
                a = t.col(c)
                ty = _fp.type_of(a.dtype)
                scope[var][c] = ("col", ty, len(cols))
                cols.append(a)
                col_types.append(ty)
    pnames = sorted(params or {})
    pvals = [_param_scalar(params[k], dev) for k in pnames]
    pnodes = {k: ("param", _fp.type_of(v.dtype), i) for i, (k, v) in enumerate(zip(pnames, pvals))}

    dicts, specs, stages = [], [], []

    def add_dict(b, fv, iv) -> int:
        dicts.append(_fp.resident_bundle(b.res.ds, b.res.table, fv, iv))
        specs.append(_fp.DictSpec(b.res.ds, fv.shape[1], iv.shape[1]))
        return len(dicts) - 1

    def value_dict(b) -> int:
        ks, vs, _ = b.res.arrays()
        return add_dict(b, vs.to(torch.float32), torch.zeros((ks.shape[0], 0), dtype=torch.int32, device=dev))

    def lo(x):
        return lower_expr(x, scope, pnodes)

    term_ir = None
    try:
        for node in rest:
            if isinstance(node, P.Select):
                stages.append(("select", _fp.cast(lo(node.pred), "bool")))
            elif isinstance(node, P.HashProbe):
                b = env[node.build]
                if not (_resident_ok(b) and b.kind == "index"):
                    return False
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
                d = add_dict(b, fv, iv)
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
                if not _resident_ok(b):
                    return False
                d = value_dict(b)
                term_ir = (
                    "groupjoin", d, _fp.cast(lo(node.keyexpr), "i32"),
                    _fp.cast(lo(node.f_expr), "f32"),
                )
            elif isinstance(node, P.Reduce):
                lanes: Tuple[str, ...] = ("m", "c", "c_c")
                d, key, lookup_lanes = -1, None, {}
                if node.lookup_sym is not None:
                    b = env[node.lookup_sym]
                    if not _resident_ok(b):
                        return False
                    lanes = b.lanes or lanes
                    d = value_dict(b)
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
        return False

    term_ops = tuple(getattr(term, "ops", ()) or ())
    acc_ds = out_cap = None
    if isinstance(term, (P.GroupBy, P.GroupJoin)):
        acc_ds = term.choice.ds
        if acc_ds not in registry.names():
            return False
        out_cap = _capacity(f, term.keyexpr, acc_ds, sigma)
        n_lanes = len(term.values) if isinstance(term, P.GroupBy) else specs[term_ir[1]].nf
        acc_family = acc_ds if registry.accumulates_resident(acc_ds) else "ht_linear"
        if acc_family not in _fp.ACC_KIND:
            return False
        out = ("dict", acc_family, out_cap, n_lanes, term_ops)
    else:
        out = ("sum", len(term.fields), term_ops)

    program = _fp.Program(tuple(col_types), tuple(v[1] for v in pnodes.values()), tuple(specs), tuple(stages), term_ir, out)
    res = _fp.fused_pipeline(program, cols, f.primary.live_mask(), dicts, pvals)
    _record_region(term.out, "kernel-resident", family=_terminal_family(term))
    if out[0] == "dict":
        tk, tv = res
        if registry.accumulates_resident(acc_ds):
            # hash-family terminal: the accumulator IS the family's layout
            # (min/max lanes: clear the identity residue off dead slots)
            tv = dbase.finalize_dead(tk, tv, term_ops, dbase.EMPTY)
            table = dbase.HashTable(tk, tv, _fp.MAX_PROBES)
        else:
            # sort-family terminal: finalize through the family's build —
            # keys are unique per entry, so no sums move
            kw = {} if dbase.all_sum(term_ops) else {"ops": term_ops}
            table = registry.get(acc_ds).build(tk, tv, out_cap, valid=tk != dbase.EMPTY, **kw)
        lanes_out = tuple(a for a, _ in term.values) if isinstance(term, P.GroupBy) else ("_0",)
        env[term.out] = BuiltDict(DictResult(acc_ds, table), term.choice, lanes=lanes_out)
    else:
        refs[term.out] = {name: res[i] for i, (name, _) in enumerate(term.fields)}
    return True


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

    def __init__(self, plan, db: Dict[str, Table], sigma=None):
        self.plan = plan
        self.sigma = sigma
        self.fused_regions = sum(isinstance(n, P.Pipeline) for n in plan.nodes)
        self.trace_count = 0
        self.calls = 0
        self.last_report: Optional[ExecutionReport] = None

    def __call__(self, db: Dict[str, Table], params=None):
        self.calls += 1
        device = next(iter(db.values())).device
        _faults.check("kernel-launch")
        if self.fused_regions:
            _faults.check("fused-region")
        try:
            out = execute_plan(
                self.plan, db, sigma=self.sigma,
                params=coerce_bindings(self.plan, params, device=device),
            )
        except Exception as e:  # noqa: BLE001 — boundary translation only
            _raise_classified(e)
        self.trace_count = max(self.trace_count, 1)
        rep = last_report()
        rep.trace_count = self.trace_count
        self.last_report = rep
        if isinstance(out, DictResult):
            return PlanResult(out.ds, *out.arrays())
        return out


_EXEC_CACHE: Dict[tuple, Executable] = {}
_EXEC_CACHE_MAX = 64


def _db_signature(db: Dict[str, Table]) -> tuple:
    return tuple(
        (
            rel, t.nrows, t.mask is None, t.sorted_on, str(t.device),
            tuple((c, str(a.dtype)) for c, a in sorted(t.columns.items())),
        )
        for rel, t in sorted(db.items())
    )


def _sigma_signature(sigma) -> tuple:
    if sigma is None:
        return ()
    return tuple(
        (rel, st.rows, tuple(sorted((c, cs.distinct) for c, cs in st.columns.items())))
        for rel, st in sorted(sigma.rels.items())
    )


def cached_executable(plan, db: Dict[str, Table], sigma=None) -> Executable:
    """The executable cache, keyed by (plan fingerprint, DictChoice tuple,
    table schema, Σ signature)."""
    key = (plan.fingerprint(), plan.choices, _db_signature(db), _sigma_signature(sigma))
    ex = _EXEC_CACHE.get(key)
    if ex is None:
        _faults.check("compile", detail=str(plan.fingerprint())[:40])
        ex = Executable(plan, db, sigma=sigma)
        if len(_EXEC_CACHE) >= _EXEC_CACHE_MAX:
            _EXEC_CACHE.pop(next(iter(_EXEC_CACHE)))
        _EXEC_CACHE[key] = ex
    return ex
