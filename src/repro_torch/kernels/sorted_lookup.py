"""Sorted lookup — probes in any order into a sorted dictionary, as a
hand-written Hopper kernel (``csrc/sorted_lookup.cu``).

Replaces ``repro/kernels/sorted_lookup.py:sorted_lookup``.  One thread a
query runs the reference's branchless lower bound, ``C.bit_length()`` rounds
over any ``C``, clamps to ``C - 1``, compares and gathers (zeros for a miss).
The plain twin, :func:`sorted_lookup_plain`, is the reference's
``ref.sorted_lookup`` (``dicts.base.sorted_lookup``: ``searchsorted``,
clamp, compare, gather); the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dicts import base as dbase

from . import build
from .hash_probe import check_table


def sorted_lookup_plain(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V], found [n])`` of ``queries`` in the ascending,
    PAD-tailed ``table_keys``; misses give zero rows."""
    return dbase.sorted_lookup(table_keys, table_vals, queries)


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "sorted_lookup.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("sorted_lookup", src), "sorted_lookup_launch")
    return _LIB["fn"]


def sorted_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V] float32, found [n] bool)``; probes in any order.  CPU
    tensors take :func:`sorted_lookup_plain`; CUDA tensors launch the kernel
    or raise."""
    if not queries.is_cuda:
        return sorted_lookup_plain(table_keys, table_vals, queries)
    check_table("sorted_lookup", table_keys, table_vals, queries)
    C, V = table_vals.shape
    if C >= 2**30:
        raise ValueError(f"sorted_lookup: C={C} keys overflow the search's int32 bracket")
    table_keys, table_vals, queries = table_keys.contiguous(), table_vals.contiguous(), queries.contiguous()
    n = queries.shape[0]
    out_vals = torch.empty((n, V), dtype=torch.float32, device=queries.device)
    out_found = torch.empty((n,), dtype=torch.bool, device=queries.device)
    if n == 0:
        return out_vals, out_found
    build.launch(
        _launcher(),
        [table_keys.data_ptr(), table_vals.data_ptr(), queries.data_ptr(),
         out_vals.data_ptr(), out_found.data_ptr()],
        [n, C, V, max(1, C.bit_length())],  # the reference's round count
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _LOOKUP.launches += 1
    return out_vals, out_found


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
sorted_lookup.launches = 0
_LOOKUP = sorted_lookup
