"""Lowering of LLQL row expressions into the fused-pipeline region program.

The executor (``exec.engine._kernel_pipeline``) walks a region's stages and
turns every row expression into the typed nodes of
``kernels.fused_pipeline`` — the same reading of ``v.key.c`` / ``v.val`` /
``v.key`` as ``core.lower.compile_rowfn_frame``, with JAX's result types
made explicit, so the PyTorch evaluator and the CUDA emitter compute what
the unfused executor computes.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import llql as L
from repro_torch.core.lower import DICT_KEY, DICT_VAL, _Unsupported
from repro_torch.kernels import fused_pipeline as fp

MULT = ("mult", "f32")

Scope = Dict[str, Dict[str, tuple]]  # var -> {column: program node}


def lower_expr(x: L.Expr, scope: Scope, params: Dict[str, tuple]) -> tuple:
    """One row expression as a program node.  ``scope`` maps each bound
    variable to its readable columns; ``params`` maps parameter names to
    their ``("param", t, k)`` nodes."""

    def go(e: L.Expr) -> tuple:
        if isinstance(e, L.Const):
            return fp.const(e.value)
        if isinstance(e, L.Param):
            if e.name not in params:
                raise _Unsupported(f"unbound parameter ?{e.name}")
            return params[e.name]
        if isinstance(e, L.FieldAccess):
            base = e.rec
            if (
                isinstance(base, L.FieldAccess)
                and base.name == "key"
                and isinstance(base.rec, L.Var)
                and base.rec.name in scope
            ):
                return scope[base.rec.name][e.name]
            if isinstance(base, L.Var) and base.name in scope:
                cols = scope[base.name]
                if e.name == "val":
                    return cols.get(DICT_VAL, MULT)
                if e.name == "key":
                    if DICT_KEY in cols:
                        return cols[DICT_KEY]
                    raise _Unsupported("whole-row key")
            raise _Unsupported(f"field access {L.pretty(e)}")
        if isinstance(e, L.BinOp):
            return fp.binop(e.op, go(e.lhs), go(e.rhs))
        if isinstance(e, L.UnOp):
            return fp.unop(e.op, go(e.operand))
        raise _Unsupported(f"row expr {type(e).__name__}")

    return go(x)


def lower_reduce_field(
    x: L.Expr, scope: Scope, params: Dict[str, tuple],
    lookup_var: Optional[str], lookup_lanes: Dict[str, tuple],
) -> tuple:
    """A scalar-agg record field: ``ra.m``-style accesses of the lookup
    variable resolve into the looked-up value lanes by name (the reference
    ``engine._reduce_field``); everything else lowers as a row expression."""

    def go(e: L.Expr) -> tuple:
        if (
            isinstance(e, L.FieldAccess)
            and isinstance(e.rec, L.Var)
            and e.rec.name == lookup_var
        ):
            return lookup_lanes[e.name]
        if isinstance(e, L.BinOp):
            return fp.binop(e.op, go(e.lhs), go(e.rhs))
        if isinstance(e, L.UnOp):
            return fp.unop(e.op, go(e.operand))
        if isinstance(e, L.Const):
            return fp.const(e.value)
        return lower_expr(e, scope, params)

    return fp.cast(go(x), "f32")
