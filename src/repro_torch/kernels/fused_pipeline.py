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

What bounds it on an H100: device-memory traffic and, for a dictionary
terminal, atomics on the accumulator.  The first design is right and
simple: a thread per row in a grid-stride loop, dictionaries and payload
slabs read from device memory through L2 (no residency bound, so the
reference's radix partitioning — a VMEM workaround — is not needed), an
``atomicCAS`` claim per accumulated row, ``atomicAdd`` for sum lanes and CAS
loops for min/max — into a block-private shared-memory copy of the value
lanes when the accumulator holds at most ``PRIV_FLOATS`` of them, flushed
once per block — and a block reduction then one atomic per lane for a
scalar Reduce.  Shared-memory slabs, radix locality and warp-aggregated
atomics are later work.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry
from repro_torch.dicts.ht_linear import MAX_PROBES  # the builders' probe bound

from . import build

FAMILIES = ("ht_linear", "ht_twochoice", "st_sorted", "st_blocked")
ACC_KIND = {"ht_linear": 0, "ht_twochoice": 1}  # accumulator probe layouts
#: value lanes (capacity x lanes) a block privatizes in shared memory (32 KB)
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
    """A probed dictionary in a program: its family and payload widths."""

    ds: str
    nf: int  # float payload lanes
    ni: int  # int32 payload lanes


class Program(NamedTuple):
    """One fused region, lowered.  ``stages``: ``("select", pred)`` and
    ``("probe", d, key)``; ``term``: ``("groupby", key, lanes)``,
    ``("groupjoin", d, key, f)`` or ``("reduce", d | -1, key | None,
    fields)``; ``out``: ``("dict", accumulator family, capacity, V, ops)``
    or ``("sum", V, ops)`` (``ops`` = per-lane monoids, () = all-sum)."""

    cols: Tuple[str, ...]
    params: Tuple[str, ...]
    dicts: Tuple[DictSpec, ...]
    stages: Tuple[tuple, ...]
    term: tuple
    out: tuple


class ResidentDict(NamedTuple):
    """Runtime inputs of one probed dictionary: the family's key-side slabs
    (``resident_slabs``) and the payload slabs aligned to slab positions
    (int build columns ride the int32 slab, exact past 2^24)."""

    slabs: Tuple[torch.Tensor, ...]
    fvals: torch.Tensor  # [C, nf] float32
    ivals: torch.Tensor  # [C, ni] int32


def resident_bundle(ds: str, table, fvals: torch.Tensor, ivals: torch.Tensor) -> ResidentDict:
    return ResidentDict(tuple(registry.get(ds).resident_slabs(table)), fvals, ivals)


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
    live mask and each probe's (slot, found)."""

    def __init__(self, program, cols, params, dicts, live):
        self.p = program
        self.cols = cols
        self.params = params
        self.dicts = dicts
        self.live = live
        self.probes: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

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
            slab = self.dicts[d].fvals if kind == "f" else self.dicts[d].ivals
            v = dbase.gather_rows(slab[:, j : j + 1], slot, found)[:, 0]
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
        slot, found = registry.get(spec.ds).resident_find(
            rd.slabs, q, capacity=rd.slabs[0].shape[0], max_probes=MAX_PROBES
        )
        self.probes[d] = (slot, found)
        self.live = self.live & found
        return found


def _evaluate(program: Program, cols, live, dicts, params, probe_rows=None):
    """Run the stages and the terminal's row math over whole columns:
    ``(final live mask, keys or None, vals [n, V])``.  ``probe_rows``, when
    given, collects ``(dictionary, live rows probing it)`` per probe."""
    r = _Rows(program, list(cols), list(params), list(dicts), live.to(torch.bool))

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
        vals = f_v[:, None] * dbase.gather_rows(r.dicts[term[1]].fvals, slot, found)
    else:
        if term[1] >= 0:
            probe(term[1], term[2])
        vals = torch.stack([r.column(x, "f32") for x in term[3]], dim=1)
    return r.live, keys, vals


def fused_pipeline_plain(program: Program, cols, live, dicts, params):
    """The plain twin of :func:`fused_pipeline`: the same function over
    whole columns in PyTorch (any device)."""
    live, keys, vals = _evaluate(program, cols, live, dicts, params)
    if program.out[0] == "dict":
        _, acc_ds, cap, V, ops = program.out
        dev = live.device
        tk = torch.full((cap,), dbase.EMPTY, dtype=torch.int32, device=dev)
        tv = torch.zeros((cap, V), dtype=torch.float32, device=dev) + dbase.lane_identity_row(ops, V, dev)[None, :]
        ks = torch.where(live, keys, dbase.PAD)
        return registry.get(acc_ds).resident_accumulate(
            tk, tv, ks, vals, live, max_probes=MAX_PROBES, ops=ops or None
        )
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


def roofline(program: Program, cols, live, dicts, params) -> Tuple[int, int]:
    """``(bytes, operations)`` the region needs for these inputs, for the
    least-time bound: every streamed column, the live mask and the params
    read once; for each probed dictionary one key and one payload row per
    live probing row, capped at the slab sizes (what this data needs); the
    output written once.  Operations: one per program node per row."""
    probe_rows: List[Tuple[int, int]] = []
    _evaluate(program, cols, live, dicts, params, probe_rows)
    nbytes = sum(c.numel() * c.element_size() for c in cols) + live.numel()
    nbytes += sum(p.numel() * p.element_size() for p in params)
    for d, rows in probe_rows:
        rd, spec = dicts[d], program.dicts[d]
        full = sum(t.numel() * t.element_size() for t in (*rd.slabs, rd.fvals, rd.ivals))
        nbytes += min(full, rows * 4 * (1 + spec.nf + spec.ni))
    if program.out[0] == "dict":
        _, _, cap, V, _ = program.out
        nbytes += cap * 4 * (1 + V)
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

    def ex(self, e) -> str:
        k = e[0]
        if k == "const":
            return _c_const(e[1], e[2])
        if k == "col":
            return f"(((const {_CTYPES[e[1]]}*)a.col[{e[2]}])[i])"
        if k == "param":
            return f"(*(const {_CTYPES[e[1]]}*)a.param[{e[2]}])"
        if k == "mult":
            return "1.0f"  # rows past an early exit are live
        if k == "gath":
            _, t, d, kind, j = e
            spec = self.p.dicts[d]
            if kind == "f":
                return f"(a.dict[{d}].fv[(long long)s{d} * {spec.nf} + {j}])"
            v = f"(a.dict[{d}].iv[(long long)s{d} * {spec.ni} + {j}])"
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

    def find(self, d: int, q: str) -> str:
        ds = self.p.dicts[d].ds
        if ds == "ht_linear":
            return f"fp::find_hash<0>(a.dict[{d}], {q}, {MAX_PROBES})"
        if ds == "ht_twochoice":
            return f"fp::find_hash<1>(a.dict[{d}], {q}, {MAX_PROBES})"
        if ds == "st_sorted":
            return f"fp::find_st_sorted(a.dict[{d}], {q})"
        return f"fp::find_st_blocked(a.dict[{d}], {q})"

    def probe(self, d: int, key) -> List[str]:
        return [
            f"  const int s{d} = {self.find(d, self.ex(cast(key, 'i32')))};",
            f"  if (s{d} < 0) return false;",
        ]

    def source(self) -> str:
        p = self.p
        nc, npar, nd = len(p.cols), len(p.params), len(p.dicts)
        V = p.out[3] if p.out[0] == "dict" else p.out[1]
        ops = _lane_ops(p.out[-1], V)
        body = ["  if (!a.live[i]) return false;"]
        for st in p.stages:
            if st[0] == "select":
                body.append(f"  if (!({self.ex(cast(st[1], 'bool'))})) return false;")
            else:
                body += self.probe(st[1], st[2])
        term = p.term
        if term[0] == "groupby":
            body.append(f"  key = {self.ex(cast(term[1], 'i32'))};")
            body += [f"  v[{j}] = {self.ex(cast(x, 'f32'))};" for j, x in enumerate(term[2])]
        elif term[0] == "groupjoin":
            d = term[1]
            body.append(f"  key = {self.ex(cast(term[2], 'i32'))};")
            body += [f"  const int s{d} = {self.find(d, 'key')};", f"  if (s{d} < 0) return false;"]
            body.append(f"  const float f_ = {self.ex(cast(term[3], 'f32'))};")
            body += [
                f"  v[{j}] = f_ * a.dict[{d}].fv[(long long)s{d} * {p.dicts[d].nf} + {j}];"
                for j in range(V)
            ]
        else:
            if term[1] >= 0:
                body += self.probe(term[1], term[2])
            body.append("  key = 0;")
            body += [f"  v[{j}] = {self.ex(cast(x, 'f32'))};" for j, x in enumerate(term[3])]
        body.append("  return true;")

        launch = [
            "  Args a;",
            "  int p = 0, q = 0;",
            *[f"  a.col[{k}] = ptrs[p++];" for k in range(nc)],
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
                f"  a.dict[{d}].cap = (int)ints[q++];",
                f"  a.dict[{d}].nb = (int)ints[q++];",
                f"  a.dict[{d}].nf = {spec.nf};",
                f"  a.dict[{d}].ni = {spec.ni};",
            ]
        launch += [
            "  if (a.n == 0) return 0;",
            "  const long long want = (a.n + 255) / 256;",
            "  const unsigned grid = (unsigned)(want < 4224 ? want : 4224);",
        ]
        priv = p.out[0] == "dict" and p.out[2] * V <= PRIV_FLOATS
        if p.out[0] == "dict":
            kind = ACC_KIND[p.out[1]]
            launch += [
                "  int* out_keys = (int*)ptrs[p++];",
                "  float* out_vals = (float*)ptrs[p++];",
                "  const int cap = (int)ints[q++];",
                "  const size_t smem = PRIV ? (size_t)cap * NV * sizeof(float) : 0;",
                f"  fp_dict_kernel<{kind}><<<grid, 256, smem, (cudaStream_t)stream>>>"
                f"(a, out_keys, out_vals, cap, {MAX_PROBES});",
            ]
        else:
            launch += [
                "  float* out = (float*)ptrs[p++];",
                "  fp_sum_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(a, out);",
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
            "  const bool* live;",
            "  long long n;",
            f"  const void* param[{max(npar, 1)}];",
            f"  fp::Dict dict[{max(nd, 1)}];",
            "};",
            f"constexpr int NV = {V};",
            f"constexpr bool PRIV = {'true' if priv else 'false'};",
            "__device__ __forceinline__ int lane_op(int j) {",
            f"  constexpr int ops[NV] = {{{op_list}}};",
            "  return ops[j];",
            "}",
            "",
            "__device__ __forceinline__ bool row(const Args& a, long long i, int& key, float* v) {",
            *body,
            "}",
            "",
            '#include "fused_kernels.cuh"',
            "",
            "// ptrs: columns, live, params, per dict (keys, block maxima, fvals, ivals),",
            "// outputs; ints: n, per dict (capacity, directory blocks), accumulator capacity",
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
_LAUNCHERS: Dict[Program, object] = {}


def _launcher(program: Program):
    fn = _LAUNCHERS.get(program)
    if fn is None:
        lib = build.load("fused_region", emit_source(program), FLAGS)
        fn = _LAUNCHERS[program] = build.launcher(lib, "fused_region_launch")
    return fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_pipeline: {msg}")


def fused_pipeline(
    program: Program,
    cols: Sequence[torch.Tensor],
    live: torch.Tensor,
    dicts: Sequence[ResidentDict],
    params: Sequence[torch.Tensor],
):
    """Run one fused region.  Returns ``(keys [C] int32, vals [C, V]
    float32)`` — the accumulator in the terminal family's probe layout,
    EMPTY in unclaimed slots, lane identities in their values — for a
    dictionary terminal, or ``sums [V]`` for a scalar Reduce.  CPU tensors
    take :func:`fused_pipeline_plain`; CUDA tensors launch the kernel or
    raise."""
    if not live.is_cuda:
        return fused_pipeline_plain(program, cols, live, dicts, params)
    dev = live.device
    n = live.shape[0]
    _check(live.dtype == torch.bool and live.dim() == 1, "live must be a 1-D bool mask")
    _check(len(cols) == len(program.cols) and len(params) == len(program.params)
           and len(dicts) == len(program.dicts), "inputs do not match the program")
    for t, c in zip(program.cols, cols):
        _check(c.device == dev and c.dtype == DTYPES[t] and c.shape == (n,), f"column must be [{n}] {t} on {dev}")
    for t, s in zip(program.params, params):
        _check(s.device == dev and s.dtype == DTYPES[t] and s.numel() == 1, f"param must be a {t} scalar on {dev}")
    # contiguous operands stay referenced until the launch is enqueued
    keep = [c.contiguous() for c in cols] + [live.contiguous()] + [s.contiguous() for s in params]
    ptrs: List[int] = [t.data_ptr() for t in keep]
    ints: List[int] = [n]
    for spec, rd in zip(program.dicts, dicts):
        keys = rd.slabs[0]
        cap = keys.shape[0]
        bm = rd.slabs[1] if len(rd.slabs) > 1 else keys
        _check(spec.ds in FAMILIES, f"no CUDA find for family {spec.ds!r}")
        _check(all(s.device == dev and s.dtype == torch.int32 and s.is_contiguous() for s in rd.slabs),
               "key slabs must be contiguous int32 on the live mask's device")
        _check(cap & (cap - 1) == 0, "dictionary capacity must be a power of two")
        _check(rd.fvals.dtype == torch.float32 and rd.fvals.shape == (cap, spec.nf) and rd.fvals.device == dev,
               f"float payload must be [{cap}, {spec.nf}] float32")
        _check(rd.ivals.dtype == torch.int32 and rd.ivals.shape == (cap, spec.ni) and rd.ivals.device == dev,
               f"int payload must be [{cap}, {spec.ni}] int32")
        fv, iv = rd.fvals.contiguous(), rd.ivals.contiguous()
        keep += [fv, iv]
        ptrs += [keys.data_ptr(), bm.data_ptr(), fv.data_ptr(), iv.data_ptr()]
        ints += [cap, bm.shape[0]]
    fn = _launcher(program)
    if program.out[0] == "dict":
        _, _, cap, V, ops = program.out
        _check(cap & (cap - 1) == 0, "accumulator capacity must be a power of two")
        out_keys = torch.full((cap,), dbase.EMPTY, dtype=torch.int32, device=dev)
        out_vals = torch.empty((cap, V), dtype=torch.float32, device=dev)
        out_vals.copy_(dbase.lane_identity_row(ops, V, dev)[None, :].expand(cap, V))
        ptrs += [out_keys.data_ptr(), out_vals.data_ptr()]
        ints.append(cap)
        out = (out_keys, out_vals)
    else:
        _, V, ops = program.out
        out = dbase.lane_identity_row(ops, V, dev).contiguous()
        ptrs.append(out.data_ptr())
    build.launch(fn, ptrs, ints, torch.cuda.current_stream(dev).cuda_stream)
    _FUSED.launches += 1
    del keep
    return out


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
fused_pipeline.launches = 0
_FUSED = fused_pipeline
