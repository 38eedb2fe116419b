"""Kernel dispatch — the single entry point the engine uses (the twin of
``repro.kernels.ops``).

Policy: a CUDA tensor goes to the hand-written kernel, a CPU tensor to its
plain PyTorch twin; the kernels' own structural preconditions (the same
rules as the reference) route to the plain definitions of ``ref`` on either
device.  Nothing routes on a failure: a kernel that does not build or launch
raises.

The dictionary families reach the dictionary kernels through this module,
by structural rules alone:

* ``ht_linear.lookup`` → :func:`hash_probe` (bound ``ht_linear.MAX_PROBES``);
  the family applies its ``valid`` mask to the result;
* ``st_sorted.lookup`` → :func:`sorted_lookup`, in any probe order (the
  engine sends hinted, non-decreasing probes to :func:`merge_lookup`);
* ``ht_linear.build`` with all-sum lanes → :func:`hash_build` with
  ``max_probes=ht_linear.MAX_PROBES``, the family's own bound, so it drops
  no row the plain build would place.

These stay on the plain path on either device: builds with min/max lanes
(the reference kernel sums only), ``update_add`` (the kernel starts from an
empty table, as the reference's does), and ``ht_twochoice`` and
``st_blocked`` (no reference kernel).

The Mamba layers reach :func:`selective_scan`, a kernel with no
``pallas_call`` behind it (the reference's ``lax.scan`` over time), and in
training on the card its backward kernel (the reference's autodiff of that
scan).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import decode as _dk
from . import flash_attention as _fa
from . import hash_build as _hb
from . import hash_probe as _hp
from . import merge_lookup as _ml
from . import ref
from . import segment_reduce as _sr
from . import selective_scan as _ss
from . import sorted_lookup as _sl


def hash_probe(table_keys, table_vals, queries, max_probes: int = _hp.MAX_PROBES) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V], found [n])`` of ``queries`` in a linear-probe table
    (``C`` a power of two); misses give zero rows.  The kernel on CUDA
    tensors, its twin on CPU tensors."""
    return _hp.hash_probe(table_keys, table_vals, queries, max_probes)


def sorted_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V], found [n])`` of ``queries`` (any order) in a sorted,
    PAD-tailed key array.  The kernel on CUDA tensors, its twin on CPU
    tensors."""
    return _sl.sorted_lookup(table_keys, table_vals, queries)


def hash_build(keys, vals, *, capacity: int, max_probes: int = _hb.MAX_PROBES,
               valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table_keys [C], table_vals [C, V])``: an empty linear-probe table
    of ``capacity`` slots with ``vals [N, V]`` summed per key (rows where
    ``valid``); rows pending after ``max_probes`` slots are dropped.  The
    kernel on CUDA tensors, its twin on CPU tensors."""
    return _hb.hash_build(keys, vals, capacity, max_probes, valid)


def merge_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probes MUST be non-decreasing (the hinted-lookup contract).  Tables
    smaller than two windows take the plain lookup, as in the reference."""
    if table_keys.shape[0] >= 2 * _ml.WINDOW:
        return _ml.merge_lookup(table_keys, table_vals, queries)
    return ref.merge_lookup(table_keys, table_vals, queries)


def segment_reduce(keys, vals) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys MUST be sorted ascending (PAD tail allowed).  The kernel on CUDA
    tensors, its twin on CPU tensors."""
    return _sr.segment_reduce(keys, vals)


def decode(code, payload, out_rows) -> torch.Tensor:
    """One encoded column chunk (``decode.ColumnCode`` + payload tensors) to
    ``[out_rows]`` rows.  The kernel on CUDA payloads, its twin on CPU ones."""
    return _dk.decode(code, payload, out_rows)


def flash_attention(q, k, v, *, causal=True, window=0, kv_valid=None) -> torch.Tensor:
    """Attention of ``q [B, H, Tq, D]`` over ``k``, ``v [B, Hkv, Tk, D]``.
    Without ``kv_valid``: the kernel on CUDA tensors, its twin on CPU
    tensors; where grad mode is on and an input requires grad (training),
    through :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`,
    whose backward is the reference's plain route.  A ``kv_valid`` mask (the
    serve path's count of live cache slots) takes that plain route
    (:func:`ref.attention_route`), as in the reference, whose kernel has no
    such mask."""
    if kv_valid is None:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _fa.FlashAttentionFn.apply(q, k, v, causal, window)
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.attention_route(q, k, v, causal=causal, window=window, kv_valid=kv_valid)


def selective_scan(xc, dt, Bt, Ct, A, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_T)`` of a Mamba layer's scan (``kernels/selective_scan.py``):
    the kernel on CUDA tensors, its twin on CPU tensors.  Under grad mode
    with a CUDA input that requires grad (training), through
    :class:`~repro_torch.kernels.selective_scan.SelectiveScanFn`: the kernel
    forward and the backward kernel, first-order only; on the CPU autograd
    runs through the twin."""
    if xc.is_cuda and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xc, dt, Bt, Ct, A, h0)):
        return _ss.SelectiveScanFn.apply(xc, dt, Bt, Ct, A, h0)
    return _ss.selective_scan(xc, dt, Bt, Ct, A, h0)
