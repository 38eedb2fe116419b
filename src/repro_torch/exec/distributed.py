"""Sharded query execution — the twin of ``repro.exec.distributed``.

Distribution is plan-driven, as in the reference: ``plan.legalize`` gives
every symbol a partitioning property and inserts explicit conversion
nodes, and this module realizes them:

* ``Repartition(hash)``      — ``_plan_repartition``: every live frame row
  goes to the shard owning ``hash(key) % n_shards`` (an all-to-all), so a
  dictionary built after a hash repartition and a probe stream
  repartitioned on the same key land on the same shards;
* ``Repartition(broadcast)`` — the live frame rows gathered onto every
  shard (an all-gather);
* ``Exchange(shuffle)``      — ``_plan_exchange``: each shard's partial
  dictionary's entries routed to their owner shard and rebuilt there at
  ``next_pow2(n_shards × C)`` slots through the family's ``build``, each
  value lane combining by the monoid ``legalize`` copied from the producing
  node;
* ``Exchange(allreduce)``    — psum / pmin / pmax of scalar records, per
  field.

One controller drives every shard, as the reference's single ``shard_map``
does.  Each shard holds its own tables (sharded relations row-split,
padded to a multiple of the shard count with masked rows; every other
relation replicated) and runs the engine's node loop; the loops advance in
lockstep (``engine.execute_plan_lockstep``) and meet at each collective,
which takes every shard's operand at once and hands each shard its part.
Collectives are explicit tensor moves: a shard's rows for another shard
are selected by exact counts and copied to that shard's device
(``.to(device, non_blocking=True)``, peer to peer between cards, a copy
within the device on one card), all-gather is a concatenation (along any
dimension), a permute hands each tensor to its pair's destination, and a
reduction folds the shards' partials in shard order and copies the result
to every shard.  The LM side (``repro_torch.sharding``,
``models.moe.moe_apply_sharded``) runs its regions over the same meshes and
collectives.

A :class:`Mesh` is an ordered axis shape and a device per shard:
``make_mesh({"data": 4})`` puts shard ``i`` on ``cuda:(i % device_count)``,
so with one card every shard lives on it; ``device="cpu"`` keeps every
shard on the host.  A collective over an axis tuple runs over the product
of those axes, shards in row-major order of the tuple; shards that differ
only on the other axes form separate groups, each holding the same data.

The route uses the dictionaries' own multiplicative mix
(``dicts.base._mix``), bit-identical to the reference's, so every row's
owner shard equals the reference's.  Each shard runs the ported kernels
(the fused pipeline, the hash build and probe, the sorted lookup) through
``kernels.ops`` as the single-device engine does; the sorted-input fast
paths stay off per shard (``allow_sorted=False``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import plan as cplan
from repro_torch.core.lower import as_column, compile_rowfn_frame
from repro_torch.data.table import Table
from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry
from repro_torch.exec import engine as E
from repro_torch.testing import faults as _faults

Axis = Union[str, Tuple[str, ...]]


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered axis shape (``(("pod", 2), ("data", 4))``) and one device
    per shard, shards in row-major order of the axes."""

    axes: Tuple[Tuple[str, int], ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: Axis) -> int:
        """Shards along ``axis``: the product of a tuple's axes."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        return math.prod(self.shape[a] for a in names)

    def groups(self, axis: Axis) -> List[Tuple[int, ...]]:
        """The shard indices each collective over ``axis`` spans: shards
        equal on every other axis, in row-major order of ``axis``."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = set(names) - set(self.shape)
        if unknown:
            raise ValueError(f"mesh {self.axes} has no axis {sorted(unknown)}")
        sizes = [n for _, n in self.axes]
        coords = [dict(zip((a for a, _ in self.axes), _unravel(i, sizes))) for i in range(self.size)]
        out: Dict[tuple, List[Tuple[tuple, int]]] = {}
        for i, c in enumerate(coords):
            rest = tuple(c[a] for a, _ in self.axes if a not in names)
            out.setdefault(rest, []).append((tuple(c[a] for a in names), i))
        return [tuple(i for _, i in sorted(members)) for _, members in sorted(out.items())]


def _unravel(i: int, sizes: Sequence[int]) -> Tuple[int, ...]:
    out = []
    for n in reversed(sizes):
        out.append(i % n)
        i //= n
    return tuple(reversed(out))


def make_mesh(shape, device=None) -> Mesh:
    """A mesh of ``shape`` (``{"data": 4}``, ``{"pod": 2, "data": 4}`` or
    ``(name, size)`` pairs).  With ``device`` None or ``"cuda"``, shard ``i``
    lives on ``cuda:(i % torch.cuda.device_count())`` (raises without a
    card); any other device (``"cpu"``, ``"cuda:1"``) holds every shard."""
    axes = tuple((str(a), int(n)) for a, n in dict(shape).items())
    if not axes or any(n < 1 for _, n in axes):
        raise ValueError(f"bad mesh shape {axes}")
    n = math.prod(s for _, s in axes)
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to shard on the host")
        count = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        devices = (dev,) * n
    return Mesh(axes, devices)


# ---------------------------------------------------------------------------
# collectives over per-shard lists (index = mesh shard)
# ---------------------------------------------------------------------------


def _route(keys: torch.Tensor, n_sh: int) -> torch.Tensor:
    """Each row's owner shard, ``hash(key) % n_sh`` (int64)."""
    return dbase._mix(keys.to(torch.int32), dbase._H2) % n_sh


def _split_rows(tgt: torch.Tensor, n_sh: int, cols: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """``out[d]``: the rows of ``cols`` whose target is ``d``, in row order
    (a stable sort by target, then a split by the exact counts)."""
    order = torch.argsort(tgt, stable=True)
    counts = torch.bincount(tgt, minlength=n_sh).tolist()
    parts = [torch.split(c[order], counts) for c in cols]
    return [[p[d] for p in parts] for d in range(n_sh)]


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x.to(dev, non_blocking=True)


def all_to_all(sends: List[List[List[torch.Tensor]]], mesh: Mesh, axis: Axis) -> List[List[torch.Tensor]]:
    """``sends[s][d]``: the columns shard ``s`` sends to the ``d``-th shard of
    its group.  Returns, per shard, each column concatenated over its
    group's source shards in shard order, on the shard's device."""
    out: List[Optional[List[torch.Tensor]]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for d, dst in enumerate(group):
            dev = mesh.devices[dst]
            ncols = len(sends[group[0]][d])
            out[dst] = [torch.cat([_to(sends[src][d][c], dev) for src in group]) for c in range(ncols)]
    return out


def all_gather(values: List[torch.Tensor], mesh: Mesh, axis: Axis, dim: int = 0) -> List[torch.Tensor]:
    """Every shard's tensor concatenated along ``dim`` over its group, on
    each shard (``lax.all_gather(..., axis=dim, tiled=True)``)."""
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for dst in group:
            out[dst] = torch.cat([_to(values[src], mesh.devices[dst]) for src in group], dim=dim)
    return out


def ppermute(values: List[torch.Tensor], mesh: Mesh, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``lax.ppermute``: within each group of ``axis``, the tensor of the
    shard at position ``src`` moves to the shard at position ``dst`` for
    every ``(src, dst)`` pair; a shard no pair names receives zeros."""
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for src, dst in perm:
            out[group[dst]] = _to(values[group[src]], mesh.devices[group[dst]])
        for s in group:
            if out[s] is None:
                out[s] = torch.zeros_like(values[s])
    return out


_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def _reduce(values, op: str, mesh: Mesh, axis: Axis):
    """The shards' tensors combined by ``op`` in shard order, on each shard."""
    out = [None] * mesh.size
    for group in mesh.groups(axis):
        dev0 = mesh.devices[group[0]]
        acc = values[group[0]]
        for src in group[1:]:
            acc = _COMBINE[op](acc, _to(values[src], dev0))
        for dst in group:
            out[dst] = _to(acc, mesh.devices[dst])
    return out


def psum(values, mesh: Mesh, axis: Axis):
    return _reduce(values, "sum", mesh, axis)


def pmin(values, mesh: Mesh, axis: Axis):
    return _reduce(values, "min", mesh, axis)


def pmax(values, mesh: Mesh, axis: Axis):
    return _reduce(values, "max", mesh, axis)


def pmean(values, mesh: Mesh, axis: Axis):
    """``psum`` over ``axis`` divided by the number of shards along it."""
    n = mesh.axis_size(axis)
    return [v / n for v in psum(values, mesh, axis)]


def repartition_cols(
    keys: List[torch.Tensor],
    mask: List[torch.Tensor],
    cols: List[Dict[str, torch.Tensor]],
    mesh: Mesh,
    axis: Axis,
) -> Tuple[List[torch.Tensor], List[Dict[str, torch.Tensor]]]:
    """Route every live row to the shard owning ``hash(key) % n_sh`` (an
    all-to-all sized by exact counts).  Returns ``(mask', cols')`` per
    shard: only live rows move, so every returned row is live."""
    n_sh = mesh.axis_size(axis)
    names = list(cols[0])
    sends = []
    for k, m, c in zip(keys, mask, cols):
        live = m.to(torch.bool)
        sends.append(_split_rows(_route(k[live], n_sh), n_sh, [c[name][live] for name in names]))
    recv = all_to_all(sends, mesh, axis)
    new_cols = [dict(zip(names, r)) for r in recv]
    new_mask = [torch.ones((r[0].shape[0],), dtype=torch.bool, device=mesh.devices[s]) for s, r in enumerate(recv)]
    return new_mask, new_cols


def broadcast_cols(
    mask: List[torch.Tensor], cols: List[Dict[str, torch.Tensor]], mesh: Mesh, axis: Axis
) -> Tuple[List[torch.Tensor], List[Dict[str, torch.Tensor]]]:
    """Every shard's live rows gathered onto every shard of its group
    (the broadcast-build placement).  Returns ``(mask', cols')`` per shard,
    every row live and every shard of a group equal."""
    live = [m.to(torch.bool) for m in mask]
    names = list(cols[0])
    gathered = {name: all_gather([c[name][lv] for c, lv in zip(cols, live)], mesh, axis) for name in names}
    new_cols = [{name: gathered[name][s] for name in names} for s in range(mesh.size)]
    new_mask = [
        torch.ones((gathered[names[0]][s].shape[0],), dtype=torch.bool, device=mesh.devices[s])
        for s in range(mesh.size)
    ]
    return new_mask, new_cols


# ---------------------------------------------------------------------------
# the plan's collectives (engine hooks over every shard at once)
# ---------------------------------------------------------------------------


def _plan_repartition(node, frames, params_list, *, mesh: Mesh, axis: Axis):
    """Realize a ``Repartition`` node over every shard's frame: the rows of
    every bound loop variable's table move together (they share row order
    and mask), so the bindings hold; the moved rows are unordered."""
    # the cross-shard row movement fault point: fires on every call (the
    # port runs eagerly; the reference's fires while tracing)
    _faults.check("shard-merge", detail=f"repartition {node.kind}")
    masks, flats = [], []
    for f in frames:
        masks.append(f.primary.live_mask())
        flats.append({f"{var}\0{c}": a for var in f.order for c, a in f.tables[var].columns.items()})
    if node.kind == "broadcast":
        new_masks, new_flats = broadcast_cols(masks, flats, mesh, axis)
    else:
        keys = [
            as_column(compile_rowfn_frame(node.keyexpr, f.tables, p), torch.int32, f.primary.nrows, f.primary.device)
            for f, p in zip(frames, params_list)
        ]
        new_masks, new_flats = repartition_cols(keys, masks, flats, mesh, axis)
    out = []
    for f, nm, nf in zip(frames, new_masks, new_flats):
        tables = {}
        for var in f.order:
            pre = f"{var}\0"
            cols = {k[len(pre):]: a for k, a in nf.items() if k.startswith(pre)}
            tables[var] = Table(cols, nm.shape[0], mask=nm, sorted_on=())
        out.append(E.Frame(tables, f.order, f.rels))
    return out


@dataclasses.dataclass
class ShardedDictResult:
    """A sharded result dictionary: each shard's slots (its hash-owned
    keys), concatenated over shards on shard 0's device; the live keys are
    globally unique."""

    ds: str
    keys: torch.Tensor
    vals: torch.Tensor
    valid: torch.Tensor

    def arrays(self):
        return self.keys, self.vals, self.valid

    def items_np(self):
        return E.items_np(self.keys, self.vals, self.valid)

    def size(self) -> int:
        return int(self.valid.sum())


def _allreduce(records, fops: Dict[str, str], mesh: Mesh, axis: Axis):
    """Per-field psum / pmin / pmax of the shards' scalar records."""
    if not isinstance(records[0], dict):
        return psum(records, mesh=mesh, axis=axis)
    merged = {name: _reduce([r[name] for r in records], fops.get(name, "sum"), mesh, axis) for name in records[0]}
    return [{name: merged[name][s] for name in records[0]} for s in range(mesh.size)]


def _plan_exchange(node, builts, *, mesh: Mesh, axis: Axis):
    """Realize an ``Exchange`` node over every shard: an allreduce folds
    the scalar records field by field; a shuffle routes each partial
    dictionary's live entries to their owner shard and rebuilds there with
    one build of the family, ``ops``-aware, at ``next_pow2(n_sh × C)``
    slots (one shard may own every routed entry)."""
    _faults.check("shard-merge", detail=f"exchange {node.kind}")
    if node.kind == "allreduce":
        return _allreduce(builts, dict(getattr(node, "field_ops", ()) or ()), mesh, axis)
    n_sh = mesh.axis_size(axis)
    ds = builts[0].res.ds
    sends, caps = [], []
    for b in builts:
        ks, vs, valid = b.res.arrays()
        live = valid.to(torch.bool)
        caps.append(ks.shape[0])
        sends.append(_split_rows(_route(ks[live], n_sh), n_sh, [ks[live], vs[live]]))
    recv = all_to_all(sends, mesh, axis)
    ops = tuple(getattr(node, "ops", ()) or ())
    kw = {} if dbase.all_sum(ops) else {"ops": ops}
    out = list(builts)
    for group in mesh.groups(axis):
        merge_cap = dbase.next_pow2(n_sh * max(caps[s] for s in group))
        for s in group:
            rk, rv = recv[s]
            b = builts[s]
            out[s] = E.BuiltDict(E.DictResult(ds, registry.get(ds).build(rk, rv, merge_cap, **kw)), b.choice,
                                 lanes=b.lanes, kind=b.kind)
    return out


# ---------------------------------------------------------------------------
# the sharded executors
# ---------------------------------------------------------------------------


def _shard_dbs(db, mesh: Mesh, axis: Axis, shard_rels) -> List[Dict[str, Table]]:
    """Each shard's tables: a relation of ``shard_rels`` padded to a
    multiple of the shard count with masked zero rows and split into equal
    slices (the ``j``-th shard of a group holds slice ``j``); every other
    relation whole, on the shard's device."""
    n_sh = mesh.axis_size(axis)
    pos = {s: j for group in mesh.groups(axis) for j, s in enumerate(group)}
    dbs: List[Dict[str, Table]] = [{} for _ in range(mesh.size)]
    for rel, t in db.items():
        if rel not in shard_rels:
            for s in range(mesh.size):
                dbs[s][rel] = t.to(mesh.devices[s])
            continue
        pad = (-t.nrows) % n_sh
        cols, mask = dict(t.columns), t.mask
        if pad:
            cols = {c: torch.cat([v, torch.zeros((pad,), dtype=v.dtype, device=v.device)]) for c, v in cols.items()}
            mask = torch.cat([t.live_mask(), torch.zeros((pad,), dtype=torch.bool, device=t.device)])
        n_local = (t.nrows + pad) // n_sh
        for s in range(mesh.size):
            sl = slice(pos[s] * n_local, (pos[s] + 1) * n_local)
            dev = mesh.devices[s]
            dbs[s][rel] = Table(
                {c: v[sl].to(dev) for c, v in cols.items()}, n_local,
                mask=None if mask is None else mask[sl].to(dev), sorted_on=t.sorted_on,
            )
    return dbs


def _synchronize(mesh: Mesh) -> None:
    """Finish every card's queued work, so a failure surfaces in the call."""
    for dev in dict.fromkeys(d for d in mesh.devices if d.type == "cuda"):
        torch.cuda.synchronize(dev)


def _dict_result(outs, shards, replicated: bool, choice) -> ShardedDictResult:
    """A dictionary result over shards: a replicated result's first copy,
    else every shard's slots concatenated on the first shard's device."""
    ds = choice.ds if choice is not None else "ht_linear"
    arrays = [outs[s].arrays() for s in shards[:1 if replicated else None]]
    dev = arrays[0][0].device
    ks, vs, valid = (torch.cat([a[i].to(dev) for a in arrays]) for i in range(3))
    return ShardedDictResult(ds, ks, vs, valid.to(torch.bool))


def _hooks(mesh: Mesh, axis: Axis):
    """The engine's ``(exchange_impl, repartition_impl)`` over ``mesh``,
    each looked up when called."""
    def exchange(node, operands):
        return _plan_exchange(node, operands, mesh=mesh, axis=axis)

    def repartition(node, frames, params_list):
        return _plan_repartition(node, frames, params_list, mesh=mesh, axis=axis)

    return exchange, repartition


def sharded_executor(
    plan,
    db,
    mesh: Mesh,
    axis: Axis,
    shard_rels: Tuple[str, ...] = ("lineitem",),
    sigma=None,
    fuse: bool = True,
):
    """The sharded realization of a compiled physical plan, with
    ``shard_rels`` row-sharded over ``axis`` and every other relation
    replicated: a callable ``run(params=None)``.  ``plan.legalize`` makes
    every cross-shard conversion an explicit node, then (unless
    ``fuse=False``, the materialized form) ``plan.fuse`` under Σ forms the
    per-shard regions, whose boundaries those nodes are.

    Each shard runs the plan with the global Σ, so its dictionaries are
    sized as the whole database's would be; ``allow_sorted=False``, as in
    the reference.  Fault points: ``shard-exec`` on each call, ``shard-oom``
    for each shard's local phase, ``shard-merge`` at each collective; a
    failure leaves through ``engine._raise_classified``.  The same plan
    object the single-device executor runs is accepted here."""
    if isinstance(plan, cplan.BoundPlan):
        default_params = plan.binding_map()
        plan = plan.plan
    else:
        default_params = None
    splan, props = cplan.legalize(plan, tuple(shard_rels))
    if fuse:
        splan = cplan.fuse(splan, sigma=sigma)
    n_sh = mesh.axis_size(axis)
    dbs = _shard_dbs(db, mesh, axis, tuple(shard_rels))
    shards = mesh.groups(axis)[0]  # a group's shards hold the whole answer
    exchange, repartition = _hooks(mesh, axis)
    trace_counter = [0]
    fused_regions = sum(isinstance(n, cplan.Pipeline) for n in splan.nodes)
    result_node = plan.node_defining(plan.result) if plan.result is not None else None
    scalar = result_node is None or isinstance(result_node, cplan.Reduce)
    replicated = isinstance(props.get(plan.result), cplan.Replicated)

    def run(params=None):
        _faults.check("shard-exec")
        t0 = time.perf_counter()
        try:
            merged = {**(default_params or {}), **(params or {})}
            pvals = [E.coerce_bindings(plan, merged, device=dev) for dev in mesh.devices]
            for s in range(mesh.size):
                _faults.check("shard-oom", detail=f"shard {s} of {mesh.size}")
            outs = E.execute_plan_lockstep(
                splan, dbs, sigma=sigma, allow_sorted=False, params_list=pvals,
                exchange_impl=exchange, repartition_impl=repartition,
            )
            if scalar:  # the allreduce left every shard the whole record
                out = outs[shards[0]]
            else:
                out = _dict_result(outs, shards, replicated, getattr(result_node, "choice", None))
            _synchronize(mesh)
        except Exception as e:  # noqa: BLE001 — boundary translation only
            E._raise_classified(e)
        trace_counter[0] = max(trace_counter[0], 1)
        run.last_report = E.republish_report(E.last_report(), time.perf_counter() - t0, trace_counter[0], shards=n_sh)
        return out

    run.trace_counter = trace_counter
    run.last_report = None
    run.fused_regions = fused_regions
    run.n_shards = n_sh
    run.plan = splan
    return run


def sharded_shared_executor(
    plans,
    db,
    mesh: Mesh,
    axis: Axis,
    shard_rels: Tuple[str, ...] = ("lineitem",),
    sigma=None,
    fusion=None,
):
    """The sharded shared-scan batch executor: each plan legalized and
    fused as in :func:`sharded_executor`, their per-shard partial phases
    merged by ``plan.merge_shared_scans`` (a shard-local fact pass paid once
    for the batch), every plan keeping its own collectives.  Returns
    ``run(params_list) -> [result, ...]`` in ``plans`` order."""
    plans = tuple(plans)
    if any(isinstance(p, cplan.BoundPlan) for p in plans):
        raise TypeError("bind parameters per call via params_list")
    splans, propss = [], []
    for p in plans:
        sp_, props = cplan.legalize(p, tuple(shard_rels))
        splans.append(cplan.fuse(sp_, sigma=sigma))
        propss.append(props)
    shared = cplan.merge_shared_scans(splans, sigma=sigma, fusion=fusion)
    n_sh = mesh.axis_size(axis)
    dbs = _shard_dbs(db, mesh, axis, tuple(shard_rels))
    shards = mesh.groups(axis)[0]
    trace_counter = [0]
    kinds = []
    for sp_, props in zip(splans, propss):
        rn = sp_.node_defining(sp_.result) if sp_.result is not None else None
        if rn is None or isinstance(rn, cplan.Reduce):
            kinds.append(("refs", None, False))
        else:
            kinds.append(("dict", getattr(rn, "choice", None), isinstance(props.get(sp_.result), cplan.Replicated)))

    def run(params_list=None):
        params_list = list(params_list or [None] * len(plans))
        t0 = time.perf_counter()
        pvals = [[E.coerce_bindings(p, params_list[i], device=dev) for i, p in enumerate(plans)]
                 for dev in mesh.devices]
        exchange, repartition = _hooks(mesh, axis)
        outs = E.execute_shared_plan_lockstep(
            shared, dbs, sigma=sigma, allow_sorted=False, params_lists=pvals,
            exchange_impl=exchange, repartition_impl=repartition,
        )
        res = []
        for i, (kind, choice, replicated) in enumerate(kinds):
            per_shard = [o[i] for o in outs]
            res.append(per_shard[shards[0]] if kind == "refs" else _dict_result(per_shard, shards, replicated, choice))
        _synchronize(mesh)
        trace_counter[0] = max(trace_counter[0], 1)
        run.last_report = E.republish_report(E.last_report(), time.perf_counter() - t0, trace_counter[0], shards=n_sh)
        return res

    run.trace_counter = trace_counter
    run.last_report = None
    run.shared_plan = shared
    return run


def execute_plan_sharded(
    plan,
    db,
    mesh: Mesh,
    axis: Axis,
    shard_rels: Tuple[str, ...] = ("lineitem",),
    params=None,
    sigma=None,
    fuse: bool = True,
):
    """Build and run :func:`sharded_executor` once.  Callers running a plan
    repeatedly hold the executor, or go through
    :func:`cached_sharded_executor`."""
    return sharded_executor(plan, db, mesh, axis, shard_rels, sigma=sigma, fuse=fuse)(params)


class ShardedExecutable:
    """The ``engine.Executable`` interface over a sharded ``run``, so that
    ``Session`` and ``QueryServer`` drive sharded and single-device shapes
    through one calling convention, ``ex(db, params)``.  The executor holds
    its build-time shard tables, so ``db`` must be that database (or None).
    ``call_batched`` runs a batch as B warm calls."""

    #: a batch is a loop of warm calls
    vmapped_batches = False

    def __init__(self, run, db=None):
        self._run = run
        self._db = db
        self.calls = 0

    @property
    def fused_regions(self) -> int:
        return getattr(self._run, "fused_regions", 0)

    @property
    def n_shards(self) -> int:
        return getattr(self._run, "n_shards", 1)

    @property
    def trace_count(self) -> int:
        return self._run.trace_counter[0]

    @property
    def last_report(self):
        return getattr(self._run, "last_report", None)

    @property
    def plan(self):
        """The legalized (and, but for the materialized rung, fused) plan
        each shard runs."""
        return self._run.plan

    def __call__(self, db=None, params=None):
        if db is not None and self._db is not None and db is not self._db:
            raise ValueError("a sharded executable runs over the database it was built on")
        self.calls += 1
        return self._run(params)

    def call_batched(self, db, params_list):
        return [self(db, p) for p in params_list]


_SHARDED_CACHE: Dict[tuple, Tuple[object, object]] = {}
_SHARDED_CACHE_STATS = {"hits": 0, "misses": 0}
_SHARDED_CACHE_MAX = 32


def cached_sharded_executor(
    plan,
    db,
    mesh: Mesh,
    axis: Axis,
    shard_rels: Tuple[str, ...] = ("lineitem",),
    sigma=None,
    fuse: bool = True,
):
    """The sharded twin of ``engine.cached_executable``, keyed by (plan
    fingerprint, choices, database identity and schema, Σ signature, mesh,
    axis, sharded relations, ``fuse``).  The executor holds the database's
    shard tables, so the database is kept in the entry and checked by
    identity on a hit.  A ``BoundPlan`` shares its plan's entry, its
    bindings the call's defaults."""
    bound = None
    if isinstance(plan, cplan.BoundPlan):
        bound = plan.binding_map()
        plan = plan.plan
    key = (
        plan.fingerprint(),
        plan.choices,
        id(db),
        E._db_signature(db),
        E._sigma_signature(sigma),
        mesh.axes,
        mesh.devices,
        axis if isinstance(axis, str) else tuple(axis),
        tuple(shard_rels),
        fuse,
    )
    hit = _SHARDED_CACHE.get(key)
    if hit is not None and hit[0] is db:
        _SHARDED_CACHE_STATS["hits"] += 1
        run = hit[1]
    else:
        _SHARDED_CACHE_STATS["misses"] += 1
        # a failed build leaves no entry: a retry builds from scratch
        _faults.check("compile", detail=f"sharded {str(plan.fingerprint())[:32]}")
        run = sharded_executor(plan, db, mesh, axis, shard_rels, sigma=sigma, fuse=fuse)
        if len(_SHARDED_CACHE) >= _SHARDED_CACHE_MAX:
            _SHARDED_CACHE.pop(next(iter(_SHARDED_CACHE)))
        _SHARDED_CACHE[key] = (db, run)
    if bound is None:
        return run

    def bound_run(params=None):
        return run({**bound, **(params or {})})

    bound_run.trace_counter = run.trace_counter
    bound_run.fused_regions = run.fused_regions
    bound_run.n_shards = run.n_shards
    bound_run.plan = run.plan
    return bound_run


def sharded_cache_stats() -> Dict[str, int]:
    return dict(_SHARDED_CACHE_STATS, entries=len(_SHARDED_CACHE))


def clear_sharded_cache() -> None:
    """Drop every cached sharded executor and reset the hit and miss counts."""
    _SHARDED_CACHE.clear()
    _SHARDED_CACHE_STATS.update(hits=0, misses=0)


# ---------------------------------------------------------------------------
# low-cardinality aggregate: all-reduce instead of shuffle
# ---------------------------------------------------------------------------


def dist_groupby_lowcard_shard(
    keys: List[torch.Tensor],
    vals: List[torch.Tensor],
    *,
    mesh: Mesh,
    axis: Axis,
    n_groups: int,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Dense group ids (``[0, n_groups)``, PAD dead) aggregated with no
    shuffle: each shard adds its rows into a dense ``[n_groups, V]``
    accumulator and a count, and one psum finishes both."""
    accs, cnts = [], []
    for k, v in zip(keys, vals):
        valid = k != dbase.PAD
        safe = torch.where(valid, k, n_groups).to(torch.int64)
        v2 = v if v.dim() == 2 else v[:, None]
        acc = torch.zeros((n_groups + 1, v2.shape[1]), dtype=v2.dtype, device=v2.device)
        acc.index_add_(0, safe, torch.where(valid[:, None], v2, torch.zeros((), dtype=v2.dtype, device=v2.device)))
        cnt = torch.zeros((n_groups + 1,), dtype=torch.int32, device=k.device)
        cnt.index_add_(0, safe, valid.to(torch.int32))
        accs.append(acc[:n_groups])
        cnts.append(cnt[:n_groups])
    return psum(accs, mesh=mesh, axis=axis), psum(cnts, mesh=mesh, axis=axis)
