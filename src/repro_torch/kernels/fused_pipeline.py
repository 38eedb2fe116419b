"""Data-centric pipeline fusion as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``repro/kernels/fused_pipeline.py:
fused_pipeline``: one launch runs a whole ``Pipeline`` region — fact rows
stream through once, selects become a per-row early exit, probes go to
dictionaries through each family's find and read the payload slabs, and the
terminal accumulates into a dictionary or a scalar reduce.

There the row semantics arrive as a traced Python callable.  Here the
executor lowers the region into a small **region program**
(:class:`Program`: typed row expressions plus the stage list) and two back
ends read it:

* :func:`fused_pipeline_plain` — a PyTorch evaluator over whole columns,
  the plain twin (CPU tests; the yardstick on the card);
* :func:`emit_source` — a CUDA emitter: one ``__device__`` row function per
  region, included into the fixed kernels of ``csrc/fused_kernels.cuh``.
  The source's hash names the library under ``build/kernels/``; it is
  compiled at first use.

Both back ends follow JAX's result types (weak Python constants, ``int /
int`` → float32, floor ``%``) with explicit casts, and the CUDA build
disables FMA contraction, so keys and per-row values agree bit for bit;
only the order of the float accumulation differs (atomics).

The reference's three further modes are here too:

* ``radix=`` (:class:`RadixPlan`, :func:`partitioned_bundle`,
  :func:`radix_route`): fact rows arrive routed into tile-aligned runs by
  the partition id of their probe key, one dictionary is stacked into
  ``[P, Lp]`` key-range (or slot-range) blocks, and each 1,024-row tile
  probes only block ``tile_part[t]``; when the terminal aggregates by the
  partition key its accumulator is ``[P, Cacc]`` too;
* ``init=(keys, vals)`` seeds a dictionary terminal's accumulator with
  carried state: one launch is one fold step of a chunked stream;
* ``encoded=`` hands columns over compressed (bitpack, FOR, dictionary,
  RLE) and the row function reads each row straight from its encoded words.

What bounds it on an H100: device-memory traffic and, for a dictionary
terminal, claims and atomics on the accumulator.  A thread takes a row in a
grid-stride loop that moves a whole warp at a time; dictionaries and payload
slabs are read from device memory through L2.  The terminal claims and
combines as ``csrc/claim_table.cuh`` does it: the warp folds its live rows
by key (``__match_any_sync`` and shuffles), so one lane a distinct key
claims (``atomicCAS``, its first read a plain L1-cached load) and combines
(``atomicAdd`` for sum lanes, CAS loops for min/max).  When the
accumulator holds at most ``PRIV_FLOATS`` value lanes, each block claims in
a private copy in shared memory first — keys beside the lanes, in the
accumulator's probe layout — and flushes its occupied slots once, one claim
a key; the grid is then the blocks resident at once.  A scalar Reduce
combines per block, then one atomic per lane.  In radix mode a block walks
a run of tiles instead and, where the partition's key slab (and directory)
fits in shared memory (``STAGE_BYTES``), stages it there once per partition
it meets; a larger block is read through L2 (see :func:`radix_staging`).
``init=`` accumulates into the carried tensors in place (no copy of
``capacity·(1+V)·4`` bytes a fold step).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry
from repro_torch.dicts.ht_linear import MAX_PROBES  # the builders' probe bound

from . import build
from . import decode as DK

FAMILIES = ("ht_linear", "ht_twochoice", "st_sorted", "st_blocked")
ROW_BLOCK = 1024  # rows a radix tile holds (the reference's tile)
ACC_KIND = {"ht_linear": 0, "ht_twochoice": 1}  # accumulator probe layouts
#: value lanes (capacity x lanes) a block privatizes in shared memory (32 KB, keys beside them)
PRIV_FLOATS = 8192
_OP_ID = {"sum": 0, "min": 1, "max": 2}

# ---------------------------------------------------------------------------
# region program: typed row expressions (tuples, head = kind, [1] = type)
#
#   ("const", t, value)         Python value; t weak ("wb"/"wi"/"wf") or strong
#   ("col", t, k)               k-th streamed column
#   ("param", t, k)             k-th runtime scalar
#   ("gath", t, d, "f"|"i", j)  lane j of dictionary d's float/int payload
#   ("mult", "f32")             bag multiplicity of the row (its liveness)
#   ("bin", t, op, a, b)        a, b already cast to the computation type
#   ("un", t, op, a)
#   ("cast", t, a)
#
# Strong types: "bool", "i32", "f32".
# ---------------------------------------------------------------------------

DTYPES = {"bool": torch.bool, "i32": torch.int32, "f32": torch.float32}
_CTYPES = {"bool": "bool", "i32": "int", "f32": "float"}
_RANK = {"bool": 0, "i32": 1, "f32": 2}
_STRONG_OF = {"wb": "bool", "wi": "i32", "wf": "f32"}
_CMP = ("==", "!=", "<", "<=", ">", ">=")


def type_of(dtype: torch.dtype) -> str:
    for t, d in DTYPES.items():
        if d == dtype:
            return t
    raise TypeError(f"fused pipeline: unsupported column dtype {dtype}")


def _is_weak(t: str) -> bool:
    return t in _STRONG_OF


def const(value) -> tuple:
    if isinstance(value, bool):
        return ("const", "wb", value)
    if isinstance(value, int):
        return ("const", "wi", value)
    return ("const", "wf", float(value))


def promote(ta: str, tb: str) -> str:
    """JAX's result type of a binary op: a weak (Python) operand adopts the
    strong operand's type unless its kind ranks higher (a Python float
    with an int32 column gives float32)."""
    if _is_weak(ta) and _is_weak(tb):
        return max(_STRONG_OF[ta], _STRONG_OF[tb], key=_RANK.get)
    if _is_weak(ta):
        ta, tb = tb, ta
    sb = _STRONG_OF.get(tb, tb)
    return ta if _RANK[ta] >= _RANK[sb] else sb


def cast(e: tuple, t: str) -> tuple:
    if e[1] == t:
        return e
    if e[0] == "const":
        v = e[2]
        v = bool(v) if t == "bool" else int(v) if t == "i32" else float(v)
        return ("const", t, v)
    return ("cast", t, e)


# Python semantics of constant-only subexpressions — exactly what the
# reference's row compiler computes for them (``repro.core.lower._BIN``)
_PY_BIN = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "%": lambda a, b: a % b, "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b, "&&": lambda a, b: a & b,
    "||": lambda a, b: a | b, "min": min, "max": max,
}
_PY_UN = {"!": lambda v: ~v, "-": lambda v: -v, "floor": lambda v: float(math.floor(v))}


def binop(op: str, a: tuple, b: tuple) -> tuple:
    if a[0] == "const" and b[0] == "const" and _is_weak(a[1]) and _is_weak(b[1]):
        return const(_PY_BIN[op](a[2], b[2]))
    ct = promote(a[1], b[1])
    if op == "/" and ct != "f32":
        ct = "f32"  # true division of ints is float32, as in JAX
    rt = "bool" if op in _CMP else ct
    return ("bin", rt, op, cast(a, ct), cast(b, ct))


def unop(op: str, a: tuple) -> tuple:
    if a[0] == "const" and _is_weak(a[1]):
        return const(_PY_UN[op](a[2]))
    t = _STRONG_OF.get(a[1], a[1])
    return ("un", t, op, cast(a, t))


class DictSpec(NamedTuple):
    """A probed dictionary in a program: its family and payload widths, and
    whether it arrives radix-partitioned (stacked ``[P, Lp]`` blocks)."""

    ds: str
    nf: int  # float payload lanes
    ni: int  # int32 payload lanes
    part: bool = False


class Program(NamedTuple):
    """One fused region, lowered.  ``stages``: ``("select", pred)`` and
    ``("probe", d, key)``; ``term``: ``("groupby", key, lanes)``,
    ``("groupjoin", d, key, f)`` or ``("reduce", d | -1, key | None,
    fields)``; ``out``: ``("dict", accumulator family, capacity, V, ops)``
    or ``("sum", V, ops)`` (``ops`` = per-lane monoids, () = all-sum).
    ``part_terminal``: the accumulator is partitioned too (``[P, capacity]``,
    radix mode, terminal keyed by the partition key); ``enc``: per column,
    whether the kernel reads it through an encoded stream (a raw tensor is
    then passed as a stream of kind ``raw``)."""

    cols: Tuple[str, ...]
    params: Tuple[str, ...]
    dicts: Tuple[DictSpec, ...]
    stages: Tuple[tuple, ...]
    term: tuple
    out: tuple
    part_terminal: bool = False
    enc: Tuple[bool, ...] = ()

    @property
    def radix(self) -> bool:
        return any(d.part for d in self.dicts)


class ResidentDict(NamedTuple):
    """Runtime inputs of one probed dictionary: the family's key-side slabs
    (``resident_slabs``) and the payload slabs aligned to slab positions
    (int build columns ride the int32 slab, exact past 2^24).  With
    ``n_parts > 0`` every array is stacked ``[P, ...]`` (the family's
    ``partition_slabs``) and ``cp`` is the global slot stride between
    blocks (``capacity // n_parts``)."""

    slabs: Tuple[torch.Tensor, ...]
    fvals: torch.Tensor  # [C, nf] float32  ([P, Lp, nf] partitioned)
    ivals: torch.Tensor  # [C, ni] int32  ([P, Lp, ni] partitioned)
    n_parts: int = 0
    cp: int = 0


class RadixPlan(NamedTuple):
    """Routing of the fact stream of a radix-partitioned region: built by
    :func:`radix_route`, consumed by :func:`fused_pipeline`."""

    n_parts: int
    tile_part: torch.Tensor  # [T] int32 partition id per tile (nondecreasing)
    visited: torch.Tensor  # [P] bool, partitions that own at least one row
    part_terminal: bool = False  # terminal accumulator partitioned too


def resident_bundle(ds: str, table, fvals: torch.Tensor, ivals: torch.Tensor) -> ResidentDict:
    return ResidentDict(tuple(registry.get(ds).resident_slabs(table)), fvals, ivals)


def partitioned_bundle(ds: str, table, fvals: torch.Tensor, ivals: torch.Tensor, n_parts: int) -> ResidentDict:
    """Radix-partitioned bundle: stacked ``[P, ...]`` slab blocks from the
    family's ``partition_slabs``, payload slabs gathered through the same
    slot map so probed positions stay aligned."""
    mod = registry.get(ds)
    slabs, gidx, _ = mod.partition_slabs(table, n_parts)
    capacity = mod.resident_slabs(table)[0].shape[0]
    g = gidx.to(torch.int64)
    return ResidentDict(tuple(s.contiguous() for s in slabs), fvals[g], ivals[g], n_parts, capacity // n_parts)


def radix_route(cols: Dict, live: torch.Tensor, part: torch.Tensor, n_parts: int, block: int = ROW_BLOCK):
    """Route fact rows into tile-aligned partition runs.

    Rows are stably ordered by partition id and scattered into a padded
    stream where every partition starts on a tile boundary, so each tile's
    rows probe one partition's block.  The padded length is static:
    ``ceil(n/block) + n_parts`` tiles bound the alignment waste whatever the
    skew; filler tiles past the last busy one ride the final partition
    with dead rows.  Returns the routed columns (same keys), the routed
    live mask and the :class:`RadixPlan`."""
    n, dev = live.shape[0], live.device
    part = part.to(torch.int64)
    order = torch.argsort(part, stable=True)  # equal ids keep row order
    sp = part[order]
    counts = torch.bincount(part, minlength=n_parts)
    tiles_per = (counts + block - 1) // block
    tile_start = torch.cumsum(tiles_per, 0) - tiles_per  # [P] first tile
    row_start = torch.cumsum(counts, 0) - counts  # [P] first sorted row
    pos = tile_start[sp] * block + torch.arange(n, device=dev) - row_start[sp]
    n_tiles = n // block + int(n % block > 0) + n_parts
    n_pad = n_tiles * block
    routed = {}
    for name, a in cols.items():
        out = torch.zeros((n_pad,), dtype=a.dtype, device=dev)
        out[pos] = a[order]
        routed[name] = out
    live_r = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    live_r[pos] = live.to(torch.bool)[order]
    t_ids = torch.arange(n_tiles, device=dev)
    tile_part = torch.searchsorted(tile_start, t_ids, right=True) - 1
    tile_part = torch.clamp(tile_part, 0, n_parts - 1).to(torch.int32)
    return routed, live_r, RadixPlan(n_parts, tile_part, counts > 0)


def _lane_ops(ops, V: int) -> Tuple[str, ...]:
    return tuple(ops) if ops else ("sum",) * V


# ---------------------------------------------------------------------------
# plain twin: the PyTorch evaluator
# ---------------------------------------------------------------------------

_T_BIN = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "%": torch.remainder, "==": torch.eq, "!=": torch.ne, "<": torch.lt,
    "<=": torch.le, ">": torch.gt, ">=": torch.ge,
    "&&": torch.bitwise_and, "||": torch.bitwise_or,
    "min": torch.minimum, "max": torch.maximum,
}


class _Rows:
    """Evaluation state of the plain twin: columns, params, the current
    live mask and each probe's (slot, found).  In radix mode ``row_part``
    holds each row's partition and a partitioned dictionary's slots are
    flat positions ``p * Lp + local`` into its stacked payload."""

    def __init__(self, program, cols, params, dicts, live, row_part=None, visited=()):
        self.p = program
        self.cols = cols
        self.params = params
        self.dicts = dicts
        self.live = live
        self.row_part = row_part
        self.visited = visited
        self.probes: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def payload(self, d: int, kind: str) -> torch.Tensor:
        slab = self.dicts[d].fvals if kind == "f" else self.dicts[d].ivals
        return slab.reshape(-1, slab.shape[-1]) if self.p.dicts[d].part else slab

    def ev(self, e):
        k = e[0]
        if k == "const":
            if _is_weak(e[1]):
                return e[2]
            return torch.tensor(e[2], dtype=DTYPES[e[1]], device=self.live.device)
        if k == "col":
            return self.cols[e[2]]
        if k == "param":
            return self.params[e[2]]
        if k == "mult":
            return self.live.to(torch.float32)
        if k == "gath":
            _, t, d, kind, j = e
            slot, found = self.probes[d]
            v = dbase.gather_rows(self.payload(d, kind)[:, j : j + 1], slot, found)[:, 0]
            return v.to(DTYPES[t]) if kind == "f" else (v != 0 if t == "bool" else v)
        if k == "cast":
            return self._t(self.ev(e[2]), e[1])
        if k == "bin":
            _, t, op, a, b = e
            ct = a[1]
            x, y = self._t(self.ev(a), ct), self._t(self.ev(b), ct)
            if ct == "bool" and op in ("+", "-", "*"):
                raise TypeError(f"arithmetic {op!r} on bool rows")
            return _T_BIN[op](x, y)
        if k == "un":
            _, t, op, a = e
            x = self._t(self.ev(a), t)
            if op == "!":
                return torch.logical_not(x) if t == "bool" else torch.bitwise_not(x)
            if op == "-":
                return torch.neg(x)
            return torch.floor(x) if t == "f32" else x
        raise ValueError(f"unknown program node {k!r}")

    def _t(self, x, t):
        if isinstance(x, torch.Tensor):
            return x.to(DTYPES[t])
        return torch.tensor(x, dtype=DTYPES[t], device=self.live.device)

    def column(self, e, t: str) -> torch.Tensor:
        x = self._t(self.ev(e), t)
        return x.expand(self.live.shape[0]) if x.dim() == 0 else x

    def probe(self, d: int, key) -> torch.Tensor:
        spec, rd = self.p.dicts[d], self.dicts[d]
        q = self.column(key, "i32")
        find = registry.get(spec.ds).resident_find
        if not spec.part:
            slot, found = find(rd.slabs, q, capacity=rd.slabs[0].shape[0], max_probes=MAX_PROBES)
        else:  # each visited partition's rows find against block p only
            lp = rd.slabs[0].shape[1]
            slot = torch.full(q.shape, -1, dtype=torch.int64, device=q.device)
            for p in self.visited:
                sel = self.row_part == p
                loc, hit = find(tuple(s[p] for s in rd.slabs), q[sel], capacity=rd.n_parts * rd.cp,
                                base_slot=p * rd.cp, max_probes=MAX_PROBES)
                slot[sel] = torch.where(hit, p * lp + loc, -1)
            found = slot >= 0
        self.probes[d] = (slot, found)
        self.live = self.live & found
        return found


def _evaluate(program: Program, cols, live, dicts, params, probe_rows=None, row_part=None, visited=()):
    """Run the stages and the terminal's row math over whole columns:
    ``(final live mask, keys or None, vals [n, V])``.  ``probe_rows``, when
    given, collects ``(dictionary, live rows probing it)`` per probe."""
    r = _Rows(program, list(cols), list(params), list(dicts), live.to(torch.bool), row_part, visited)

    def probe(d, key):
        if probe_rows is not None:
            probe_rows.append((d, int(r.live.sum())))
        r.probe(d, key)

    for st in program.stages:
        if st[0] == "select":
            r.live = r.live & r.column(st[1], "bool")
        else:
            probe(st[1], st[2])
    term = program.term
    keys = None
    if term[0] == "groupby":
        keys = r.column(term[1], "i32")
        vals = torch.stack([r.column(x, "f32") for x in term[2]], dim=1)
    elif term[0] == "groupjoin":
        keys = r.column(term[2], "i32")
        probe(term[1], term[2])
        f_v = r.column(term[3], "f32")
        slot, found = r.probes[term[1]]
        vals = f_v[:, None] * dbase.gather_rows(r.payload(term[1], "f"), slot, found)
    else:
        if term[1] >= 0:
            probe(term[1], term[2])
        vals = torch.stack([r.column(x, "f32") for x in term[3]], dim=1)
    return r.live, keys, vals


def _decoded_columns(cols, live, encoded) -> list:
    """The program's columns with every encoded stream decoded to the
    stream's rows (the decode kernel's plain twin: bit for bit the values
    the kernel reads in registers)."""
    cols = list(cols)
    for k, es in (encoded or {}).items():
        cols[k] = DK.decode_plain(DK.stream_code(es), DK.stream_payload(es), live.shape[0])
    return cols


def _radix_rows(radix, n: int):
    """``(row partition ids [n], visited partition ids)`` of a routed stream."""
    if radix is None:
        return None, ()
    if n != radix.tile_part.shape[0] * ROW_BLOCK:
        raise ValueError(f"fused_pipeline: a radix stream holds {radix.tile_part.shape[0]} tiles of {ROW_BLOCK} rows")
    row_part = radix.tile_part.to(torch.int64).repeat_interleave(ROW_BLOCK)
    return row_part, tuple(torch.nonzero(radix.visited).flatten().tolist())


def _check_modes(program: Program, radix, init, encoded) -> None:
    _check((radix is not None) == program.radix, "a radix stream goes with a program that has a partitioned dictionary")
    _check(radix is None or not encoded, "encoded streams are positional; radix routing moves decoded rows")
    _check(radix is None or radix.part_terminal == program.part_terminal, "the radix plan and the program disagree on the terminal")
    _check(init is None or (program.out[0] == "dict" and not program.part_terminal),
           "carried state applies to a non-partitioned dictionary terminal")
    enc = program.enc or (False,) * len(program.cols)
    _check(all(enc[k] for k in (encoded or {})), "an encoded stream goes to a column the program reads encoded")


def fused_pipeline_plain(program: Program, cols, live, dicts, params, *, radix=None, init=None, encoded=None):
    """The plain twin of :func:`fused_pipeline`: the same function over
    whole columns in PyTorch (any device).  Radix mode loops over the
    visited partitions; ``init`` is not modified."""
    _check_modes(program, radix, init, encoded)
    cols = _decoded_columns(cols, live, encoded)
    row_part, visited = _radix_rows(radix, live.shape[0])
    live, keys, vals = _evaluate(program, cols, live, dicts, params, row_part=row_part, visited=visited)
    if program.out[0] == "dict":
        _, acc_ds, cap, V, ops = program.out
        dev = live.device
        acc = registry.get(acc_ds).resident_accumulate
        ks = torch.where(live, keys, dbase.PAD)
        ident = dbase.lane_identity_row(ops, V, dev)[None, :]
        if program.part_terminal:
            P = radix.n_parts
            tk = torch.full((P, cap), dbase.EMPTY, dtype=torch.int32, device=dev)
            tv = torch.zeros((P, cap, V), dtype=torch.float32, device=dev) + ident
            for p in visited:
                sel = row_part == p
                tk[p], tv[p] = acc(tk[p], tv[p], ks[sel], vals[sel], live[sel], max_probes=MAX_PROBES, ops=ops or None)
            return tk, tv
        if init is not None:
            tk, tv = init
        else:
            tk = torch.full((cap,), dbase.EMPTY, dtype=torch.int32, device=dev)
            tv = torch.zeros((cap, V), dtype=torch.float32, device=dev) + ident
        return acc(tk, tv, ks, vals, live, max_probes=MAX_PROBES, ops=ops or None)
    _, V, ops = program.out
    lanes = []
    for j, op in enumerate(_lane_ops(ops, V)):
        col = vals[:, j]
        if op == "sum":
            lanes.append(torch.where(live, col, 0.0).sum())
        elif op == "min":
            lanes.append(torch.where(live, col, math.inf).min())
        else:
            lanes.append(torch.where(live, col, -math.inf).max())
    return torch.stack(lanes)


def _exprs(program: Program):
    """Every row expression of a program, stages then terminal."""
    for st in program.stages:
        yield st[-1]
    term = program.term
    if term[0] == "groupby":
        yield term[1]
        yield from term[2]
    elif term[0] == "groupjoin":
        yield from term[2:]
    else:
        if term[2] is not None:
            yield term[2]
        yield from term[3]


def _nodes(e) -> int:
    if e[0] == "bin":
        return 1 + _nodes(e[3]) + _nodes(e[4])
    if e[0] in ("un", "cast"):
        return 1 + _nodes(e[-1])
    return 1


def roofline(program: Program, cols, live, dicts, params, *, radix=None, init=None, encoded=None) -> Tuple[int, int]:
    """``(bytes, operations)`` the region needs for these inputs, for the
    least-time bound: every streamed column (an encoded one: its payload),
    the live mask, the params and the tile partition ids read once; for
    each probed dictionary one key and one payload row per live probing row,
    capped at the slab sizes (what this data needs); the accumulator written
    once (every slot: the launch fills it) or, when carried in (``init``),
    each slot a live row reaches read and written once.  Operations: one per
    program node per row."""
    probe_rows: List[Tuple[int, int]] = []
    row_part, visited = _radix_rows(radix, live.shape[0])
    final, _, _ = _evaluate(program, _decoded_columns(cols, live, encoded), live, dicts, params, probe_rows,
                            row_part, visited)
    nbytes = sum(c.numel() * c.element_size() for c in cols if c is not None) + live.numel()
    nbytes += sum(t.numel() * t.element_size() for es in (encoded or {}).values() for t in DK.stream_payload(es).values())
    nbytes += sum(p.numel() * p.element_size() for p in params)
    if radix is not None:
        nbytes += radix.tile_part.numel() * 4
    for d, rows in probe_rows:
        rd, spec = dicts[d], program.dicts[d]
        full = sum(t.numel() * t.element_size() for t in (*rd.slabs, rd.fvals, rd.ivals))
        nbytes += min(full, rows * 4 * (1 + spec.nf + spec.ni))
    if program.out[0] == "dict":
        _, _, cap, V, _ = program.out
        if init is not None:
            nbytes += 2 * min(cap, int(final.sum())) * 4 * (1 + V)
        else:
            nbytes += cap * 4 * (1 + V) * (radix.n_parts if program.part_terminal else 1)
    else:
        nbytes += program.out[1] * 4

    nodes = sum(_nodes(e) for e in _exprs(program))
    return nbytes, nodes * live.shape[0]


# ---------------------------------------------------------------------------
# CUDA emitter
# ---------------------------------------------------------------------------


def _c_const(t: str, v) -> str:
    if t in ("bool", "wb"):
        return "true" if v else "false"
    if t in ("i32", "wi"):
        v = int(v)
        if not -(2**31) <= v < 2**31:
            raise ValueError(f"int32 constant out of range: {v}")
        return f"((int){v})" if v != -(2**31) else "((int)0x80000000)"
    v = float(v)
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    if math.isnan(v):
        return "NAN"
    return f"((float){v!r})"


class _Emitter:
    def __init__(self, program: Program):
        self.p = program
        self.enc = program.enc or (False,) * len(program.cols)

    def ex(self, e) -> str:
        k = e[0]
        if k == "const":
            return _c_const(e[1], e[2])
        if k == "col":
            if self.enc[e[2]]:
                return f"fp::enc_{e[1]}(a.enc[{e[2]}], i)"
            return f"(((const {_CTYPES[e[1]]}*)a.col[{e[2]}])[i])"
        if k == "param":
            return f"(*(const {_CTYPES[e[1]]}*)a.param[{e[2]}])"
        if k == "mult":
            return "1.0f"  # rows past an early exit are live
        if k == "gath":
            _, t, d, kind, j = e
            spec = self.p.dicts[d]
            if kind == "f":
                return f"(a.dict[{d}].fv[g{d} * {spec.nf} + {j}])"
            v = f"(a.dict[{d}].iv[g{d} * {spec.ni} + {j}])"
            return f"({v} != 0)" if t == "bool" else v
        if k == "cast":
            return f"(({_CTYPES[e[1]]})({self.ex(e[2])}))"
        if k == "bin":
            _, t, op, a, b = e
            ct = a[1]
            x, y = self.ex(a), self.ex(b)
            if op in _CMP:
                return f"({x} {op} {y})"
            if op == "%":
                return f"fp::floor_mod({x}, {y})"
            if op in ("min", "max"):
                if ct == "f32":
                    return f"{'fminf' if op == 'min' else 'fmaxf'}({x}, {y})"
                return f"{op}({x}, {y})"
            if op in ("&&", "||"):
                sym = {"&&": "&&", "||": "||"}[op] if ct == "bool" else {"&&": "&", "||": "|"}[op]
                return f"({x} {sym} {y})"
            if ct == "i32" and op in ("+", "-", "*"):
                return f"fp::{ {'+': 'add_w', '-': 'sub_w', '*': 'mul_w'}[op] }({x}, {y})"
            if ct == "bool":
                raise TypeError(f"arithmetic {op!r} on bool rows")
            return f"({x} {op} {y})"
        if k == "un":
            _, t, op, a = e
            x = self.ex(a)
            if op == "!":
                return f"(!{x})" if t == "bool" else f"(~{x})"
            if op == "-":
                return f"(-{x})"
            return f"floorf({x})" if t == "f32" else x
        raise ValueError(f"unknown program node {k!r}")

    def find(self, d: int, q: str) -> List[str]:
        spec = self.p.dicts[d]
        ds = spec.ds
        if spec.part:
            call = {
                "ht_linear": f"fp::find_linear_part(a.dict[{d}], pt, {q}, {MAX_PROBES})",
                "st_sorted": f"fp::find_sorted_part(a.dict[{d}], pt, {q})",
                "st_blocked": f"fp::find_blocked_part(a.dict[{d}], pt, {q})",
            }.get(ds)
            if call is None:
                raise ValueError(f"family {ds!r} does not partition")
            at = f"(long long)pt.p * a.dict[{d}].lp + s{d}"
        else:
            call = {
                "ht_linear": f"fp::find_hash<0>(a.dict[{d}], {q}, {MAX_PROBES})",
                "ht_twochoice": f"fp::find_hash<1>(a.dict[{d}], {q}, {MAX_PROBES})",
                "st_sorted": f"fp::find_st_sorted(a.dict[{d}], {q})",
            }.get(ds, f"fp::find_st_blocked(a.dict[{d}], {q})")
            at = f"s{d}"
        return [
            f"  const int s{d} = {call};",
            f"  if (s{d} < 0) return false;",
            f"  const long long g{d} = {at};",
        ]

    def source(self) -> str:
        p = self.p
        nc, npar, nd = len(p.cols), len(p.params), len(p.dicts)
        V = p.out[3] if p.out[0] == "dict" else p.out[1]
        ops = _lane_ops(p.out[-1], V)
        rd = next((d for d, spec in enumerate(p.dicts) if spec.part), -1)
        body = ["  if (!a.live[i]) return false;"]
        for st in p.stages:
            if st[0] == "select":
                body.append(f"  if (!({self.ex(cast(st[1], 'bool'))})) return false;")
            else:
                body += self.find(st[1], self.ex(cast(st[2], "i32")))
        term = p.term
        if term[0] == "groupby":
            body.append(f"  key = {self.ex(cast(term[1], 'i32'))};")
            body += [f"  v[{j}] = {self.ex(cast(x, 'f32'))};" for j, x in enumerate(term[2])]
        elif term[0] == "groupjoin":
            d = term[1]
            body.append(f"  key = {self.ex(cast(term[2], 'i32'))};")
            body += self.find(d, "key")
            body.append(f"  const float f_ = {self.ex(cast(term[3], 'f32'))};")
            body += [f"  v[{j}] = f_ * a.dict[{d}].fv[g{d} * {p.dicts[d].nf} + {j}];" for j in range(V)]
        else:
            if term[1] >= 0:
                body += self.find(term[1], self.ex(cast(term[2], "i32")))
            body.append("  key = 0;")
            body += [f"  v[{j}] = {self.ex(cast(x, 'f32'))};" for j, x in enumerate(term[3])]
        body.append("  return true;")

        launch = ["  Args a;", "  int p = 0, q = 0;"]
        for k in range(nc):
            if self.enc[k]:
                launch += [
                    f"  a.enc[{k}].a = (const unsigned*)ptrs[p++];",
                    f"  a.enc[{k}].b = (const unsigned*)ptrs[p++];",
                    f"  a.enc[{k}].n = ints[q++];",
                    *[f"  a.enc[{k}].{f} = (int)ints[q++];" for f in ("kind", "bits", "ref", "block", "runs")],
                ]
            else:
                launch.append(f"  a.col[{k}] = ptrs[p++];")
        launch += [
            "  a.live = (const bool*)ptrs[p++];",
            "  a.n = ints[q++];",
            *[f"  a.param[{k}] = ptrs[p++];" for k in range(npar)],
        ]
        for d, spec in enumerate(p.dicts):
            launch += [
                f"  a.dict[{d}].keys = (const int*)ptrs[p++];",
                f"  a.dict[{d}].bm = (const int*)ptrs[p++];",
                f"  a.dict[{d}].fv = (const float*)ptrs[p++];",
                f"  a.dict[{d}].iv = (const int*)ptrs[p++];",
                *[f"  a.dict[{d}].{f} = (int)ints[q++];" for f in ("cap", "nb", "lp", "cp", "nbp")],
                f"  a.dict[{d}].nf = {spec.nf};",
                f"  a.dict[{d}].ni = {spec.ni};",
            ]
        launch.append("  if (a.n == 0) return 0;")
        if p.radix:
            launch += [
                "  const int* tile_part = (const int*)ptrs[p++];",
                "  const long long n_tiles = ints[q++];",
                "  const int tpc = (int)ints[q++];",
                "  const bool stage = ints[q++] != 0;",
                "  const unsigned grid = (unsigned)((n_tiles + tpc - 1) / tpc);",
                "  const size_t slab = stage ? (size_t)(a.dict[RD].lp + a.dict[RD].nbp) * sizeof(int) : 0;",
            ]
        else:
            launch.append("  const long long want = (a.n + 255) / 256;")
        priv = p.out[0] == "dict" and p.out[2] * V <= PRIV_FLOATS and not p.part_terminal
        cu = "(cudaStream_t)stream"
        if p.out[0] == "dict":
            kind = ACC_KIND[p.out[1]]
            launch += [
                "  int* out_keys = (int*)ptrs[p++];",
                "  float* out_vals = (float*)ptrs[p++];",
                "  const int cap = (int)ints[q++];",
                "  const size_t priv = PRIV ? (size_t)cap * (NV + 1) * sizeof(float) : 0;",
            ]
            if p.radix:
                pt = "true" if p.part_terminal else "false"
                for stage in ("true", "false"):
                    k = f"fp_radix_dict_kernel<{kind}, {stage}, {pt}>"
                    launch += [
                        f"  if (stage == {stage}) {{",
                        f"    const cudaError_t e = cudaFuncSetAttribute({k}, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)(priv + slab));",
                        "    if (e != cudaSuccess) return (int)e;",
                        f"    {k}<<<grid, 256, priv + slab, {cu}>>>(a, tile_part, n_tiles, tpc, out_keys, out_vals, cap, {MAX_PROBES});",
                        "  }",
                    ]
            else:
                k = f"fp_dict_kernel<{kind}>"
                launch += [
                    "  static int resident = 0;  // blocks resident at once at this region's shared memory",
                    "  if (resident == 0) {",
                    f"    cudaError_t e = cudaFuncSetAttribute({k}, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)priv);",
                    "    int dev = 0, sms = 0, per_sm = 0;",
                    "    if (e == cudaSuccess) e = cudaGetDevice(&dev);",
                    "    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);",
                    f"    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, {k}, 256, priv);",
                    "    if (e != cudaSuccess) return (int)e;",
                    "    resident = sms * (per_sm > 0 ? per_sm : 1);",
                    "  }",
                    "  const unsigned grid = (unsigned)(want < resident ? want : resident);",
                    f"  {k}<<<grid, 256, priv, {cu}>>>(a, out_keys, out_vals, cap, {MAX_PROBES});",
                ]
        else:
            launch.append("  float* out = (float*)ptrs[p++];")
            if p.radix:
                for stage in ("true", "false"):
                    k = f"fp_radix_sum_kernel<{stage}>"
                    launch += [
                        f"  if (stage == {stage}) {{",
                        f"    const cudaError_t e = cudaFuncSetAttribute({k}, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)slab);",
                        "    if (e != cudaSuccess) return (int)e;",
                        f"    {k}<<<grid, 256, slab, {cu}>>>(a, tile_part, n_tiles, tpc, out);",
                        "  }",
                    ]
            else:
                launch += [
                    "  const unsigned grid = (unsigned)(want < 4224 ? want : 4224);",
                    f"  fp_sum_kernel<<<grid, 256, 0, {cu}>>>(a, out);",
                ]
        launch.append("  return (int)cudaGetLastError();")
        op_list = ", ".join(str(_OP_ID[o]) for o in ops)
        return "\n".join([
            "// Generated by repro_torch.kernels.fused_pipeline.emit_source: one fused",
            "// region's row function over the fixed kernels of fused_kernels.cuh.",
            '#include "fused_pipeline.cuh"',
            "",
            "struct Args {",
            f"  const void* col[{max(nc, 1)}];",
            f"  fp::Enc enc[{max(nc, 1)}];",
            "  const bool* live;",
            "  long long n;",
            f"  const void* param[{max(npar, 1)}];",
            f"  fp::Dict dict[{max(nd, 1)}];",
            "};",
            f"constexpr int NV = {V};",
            f"constexpr bool PRIV = {'true' if priv else 'false'};",
            f"constexpr int RD = {rd};",
            "__device__ __forceinline__ int lane_op(int j) {",
            f"  constexpr int ops[NV] = {{{op_list}}};",
            "  return ops[j];",
            "}",
            "",
            "__device__ __forceinline__ bool row(const Args& a, long long i, int& key, float* v, const fp::Part& pt) {",
            *body,
            "}",
            "",
            '#include "fused_kernels.cuh"',
            "",
            "// ptrs: columns (raw: data; encoded: words or run values, dictionary",
            "// values or run ends), live, params, per dict (keys, block maxima, fvals,",
            "// ivals), [radix: tile partition ids], outputs; ints: per encoded column",
            "// (rows, kind, bits, ref, block, runs), n, per dict (capacity, directory",
            "// blocks, block slab length, slot stride, directory blocks a partition),",
            "// [radix: tiles, tiles a block, staged], accumulator capacity",
            'extern "C" int fused_region_launch(void** ptrs, long long* ints, void* stream) {',
            *launch,
            "}",
            "",
        ])


def emit_source(program: Program) -> str:
    """The CUDA source of one region (deterministic in the program)."""
    return _Emitter(program).source()


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

FLAGS = ("--fmad=false",)  # no FMA contraction: per-row values match the twin
#: dynamic shared memory a block may use on an H100 (227 KB)
STAGE_BYTES = 232448
_LAUNCHERS: Dict[Program, object] = {}
_RAW_KIND = 4  # fp::ENC_RAW; the encoded kinds are decode.KINDS' ids
_SMS = 132  # streaming multiprocessors of an H100 SXM


def _launcher(program: Program):
    fn = _LAUNCHERS.get(program)
    if fn is None:
        lib = build.load("fused_region", emit_source(program), FLAGS)
        fn = _LAUNCHERS[program] = build.launcher(lib, "fused_region_launch")
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_pipeline: {msg}")


def radix_staging(program: Program, dicts: Sequence[ResidentDict]) -> Tuple[bool, int]:
    """``(staged, bytes)``: whether a radix launch stages each partition's
    key slab (and st_blocked directory) in shared memory, and the dynamic
    shared memory a block then asks for (the PRIV accumulator's private
    table, keys and value lanes, included).  A slab that does not fit
    under ``STAGE_BYTES`` is read through L2 instead."""
    rd = next(dicts[d] for d, spec in enumerate(program.dicts) if spec.part)
    lp = rd.slabs[0].shape[1]
    nbp = rd.slabs[1].shape[1] if len(rd.slabs) > 1 else 0
    priv = 0
    if program.out[0] == "dict" and not program.part_terminal and program.out[2] * program.out[3] <= PRIV_FLOATS:
        priv = program.out[2] * (program.out[3] + 1) * 4  # value lanes and keys
    staged = priv + (lp + nbp) * 4 <= STAGE_BYTES
    return staged, priv + ((lp + nbp) * 4 if staged else 0)


def _enc_args(es, n: int, dev, dtype) -> Tuple[List[torch.Tensor], List[int]]:
    """Pointers' tensors and ints of one column read through ``fp::Enc``."""
    if isinstance(es, torch.Tensor):
        _check(es.device == dev and es.dtype == dtype and es.shape == (n,), f"column must be [{n}] {dtype} on {dev}")
        return [es, es], [n, _RAW_KIND, 0, 0, 0, 0]
    _check(es.kind in DK.KINDS and DK.DTYPES.get(es.dtype) == dtype and es.n >= 1,
           f"an encoded {es.kind} {es.dtype} stream cannot be a {dtype} column")
    tensors = list(DK.stream_payload(es).values())
    _check(all(t.device == dev and t.is_contiguous() and t.element_size() == 4 for t in tensors),
           "encoded payloads must be contiguous 4-byte tensors on the live mask's device")
    nt = -(-es.n // es.block)
    if es.kind == "rle":
        runs = es.values.shape[1]
        _check(es.values.shape == es.ends.shape == (nt, runs) and es.ends.dtype == torch.int32 and runs >= 1,
               f"RLE tables must be [{nt}, R>=1]")
        return [es.values, es.ends], [es.n, DK.KINDS["rle"], 0, 0, es.block, runs]
    _check(es.bits in (1, 2, 4, 8, 16) and es.words.dtype == torch.int32
           and es.words.shape == (nt * DK.words_per_tile(es.bits, es.block),), "packed words must be int32, whole tiles")
    b = es.values if es.kind == "dict" else es.words
    return [es.words, b], [es.n, DK.KINDS[es.kind], es.bits, es.ref, es.block, 0]


def fused_pipeline(
    program: Program,
    cols: Sequence[Optional[torch.Tensor]],
    live: torch.Tensor,
    dicts: Sequence[ResidentDict],
    params: Sequence[torch.Tensor],
    *,
    radix: Optional[RadixPlan] = None,
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    encoded: Optional[Dict[int, "DK.EncodedStream"]] = None,
):
    """Run one fused region.  Returns ``(keys [C] int32, vals [C, V]
    float32)`` — the accumulator in the terminal family's probe layout,
    EMPTY in unclaimed slots, lane identities in their values — for a
    dictionary terminal (``[P, C]`` / ``[P, C, V]`` when the terminal is
    partitioned), or ``sums [V]`` for a scalar Reduce.

    ``radix``: ``cols`` and ``live`` come routed by :func:`radix_route` and
    the program's partitioned dictionary is a :func:`partitioned_bundle`.
    ``init=(keys, vals)``: the accumulator to fold into, updated in place and
    returned.  ``encoded``: column position -> encoded stream (``cols[k]``
    is then None).  CPU tensors take :func:`fused_pipeline_plain`; CUDA
    tensors launch the kernel or raise."""
    if not live.is_cuda:
        modes = {k: v for k, v in (("radix", radix), ("init", init), ("encoded", encoded or None)) if v is not None}
        return fused_pipeline_plain(program, cols, live, dicts, params, **modes)
    _check_modes(program, radix, init, encoded)
    encoded = encoded or {}
    enc = program.enc or (False,) * len(program.cols)
    dev = live.device
    n = live.shape[0]
    _check(live.dtype == torch.bool and live.dim() == 1, "live must be a 1-D bool mask")
    _check(len(cols) == len(program.cols) and len(params) == len(program.params)
           and len(dicts) == len(program.dicts), "inputs do not match the program")
    keep: List[torch.Tensor] = []  # operands stay referenced until the launch is enqueued
    ptrs: List[int] = []
    ints: List[int] = []
    for k, (t, c) in enumerate(zip(program.cols, cols)):
        if enc[k]:
            ts, xs = _enc_args(encoded.get(k, c), n, dev, DTYPES[t])
            keep += ts
            ptrs += [x.data_ptr() for x in ts]
            ints += xs
        else:
            _check(c is not None and c.device == dev and c.dtype == DTYPES[t] and c.shape == (n,),
                   f"column must be [{n}] {t} on {dev}")
            keep.append(c.contiguous())
            ptrs.append(keep[-1].data_ptr())
    keep.append(live.contiguous())
    ptrs.append(keep[-1].data_ptr())
    ints.append(n)
    for t, s in zip(program.params, params):
        _check(s.device == dev and s.dtype == DTYPES[t] and s.numel() == 1, f"param must be a {t} scalar on {dev}")
        keep.append(s.contiguous())
        ptrs.append(keep[-1].data_ptr())
    for spec, rd in zip(program.dicts, dicts):
        keys = rd.slabs[0]
        _check(spec.ds in FAMILIES, f"no CUDA find for family {spec.ds!r}")
        _check(all(s.device == dev and s.dtype == torch.int32 and s.is_contiguous() for s in rd.slabs),
               "key slabs must be contiguous int32 on the live mask's device")
        _check(spec.part == (rd.n_parts > 0), "a partitioned dictionary goes with a partitioned bundle")
        bm = rd.slabs[1] if len(rd.slabs) > 1 else keys
        if spec.part:
            P, lp = keys.shape
            cap, lead = rd.cp * P, (P, lp)
            nbp = bm.shape[1] if len(rd.slabs) > 1 else 0
            nb = P * nbp
            _check(radix is not None and P == radix.n_parts, "partition blocks must match the radix plan")
        else:
            cap = lp = keys.shape[0]
            lead, nb, nbp = (cap,), bm.shape[0], 0
        _check(cap & (cap - 1) == 0, "dictionary capacity must be a power of two")
        _check(rd.fvals.dtype == torch.float32 and rd.fvals.shape == (*lead, spec.nf) and rd.fvals.device == dev,
               f"float payload must be [{', '.join(map(str, lead))}, {spec.nf}] float32")
        _check(rd.ivals.dtype == torch.int32 and rd.ivals.shape == (*lead, spec.ni) and rd.ivals.device == dev,
               f"int payload must be [{', '.join(map(str, lead))}, {spec.ni}] int32")
        fv, iv = rd.fvals.contiguous(), rd.ivals.contiguous()
        keep += [fv, iv]
        ptrs += [keys.data_ptr(), bm.data_ptr(), fv.data_ptr(), iv.data_ptr()]
        ints += [cap, nb, lp, rd.cp, nbp]
    if radix is not None:
        tp = radix.tile_part
        n_tiles = tp.shape[0]
        _check(tp.device == dev and tp.dtype == torch.int32 and tp.is_contiguous() and n == n_tiles * ROW_BLOCK,
               f"a radix stream is whole {ROW_BLOCK}-row tiles with int32 tile partition ids")
        staged, _ = radix_staging(program, dicts)
        per = max(1, -(-n_tiles // (_SMS * (2 if staged else 8))))  # tiles a block walks
        keep.append(tp)
        ptrs.append(tp.data_ptr())
        ints += [n_tiles, per, int(staged)]
    fn = _launcher(program)
    if program.out[0] == "dict":
        _, _, cap, V, ops = program.out
        _check(cap & (cap - 1) == 0, "accumulator capacity must be a power of two")
        lead = (radix.n_parts, cap) if program.part_terminal else (cap,)
        if init is not None:
            out_keys, out_vals = init
            _check(out_keys.device == dev and out_keys.dtype == torch.int32 and out_keys.shape == lead
                   and out_keys.is_contiguous() and out_vals.device == dev and out_vals.dtype == torch.float32
                   and out_vals.shape == (*lead, V) and out_vals.is_contiguous(),
                   f"carried state must be contiguous [{cap}] int32 keys and [{cap}, {V}] float32 values")
        else:
            out_keys = torch.full(lead, dbase.EMPTY, dtype=torch.int32, device=dev)
            out_vals = torch.empty((*lead, V), dtype=torch.float32, device=dev)
            out_vals.copy_(dbase.lane_identity_row(ops, V, dev).expand(*lead, V))
        ptrs += [out_keys.data_ptr(), out_vals.data_ptr()]
        ints.append(cap)
        out = (out_keys, out_vals)
    else:
        _, V, ops = program.out
        out = dbase.lane_identity_row(ops, V, dev).contiguous()
        ptrs.append(out.data_ptr())
    build.launch(fn, ptrs, ints, torch.cuda.current_stream(dev).cuda_stream)
    _FUSED.launches += 1
    modes = _FUSED.mode_launches
    for mode, used in (("radix", radix is not None), ("init", init is not None), ("encoded", bool(encoded))):
        if used:
            modes[mode] += 1
    if not (radix is not None or init is not None or encoded):
        modes["resident"] += 1
    del keep
    return out


# the launch counts live on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own: ``launches`` counts every
# launch, ``mode_launches`` the launches that used each mode (a launch with
# init and encoded streams counts under both; "resident" is a launch with
# neither mode)
fused_pipeline.launches = 0
fused_pipeline.mode_launches = {"resident": 0, "radix": 0, "init": 0, "encoded": 0}
_FUSED = fused_pipeline
