"""``st_sorted`` — sorted-array dictionary (the paper's ``boost_flat_map``).

The PyTorch twin of ``repro.dicts.st_sorted``.  Build = sort + duplicate
aggregation, the sort skipped when the input is known ordered (the paper's
hinted insert).  Lookup = binary search; ordered probe streams go through
the merge-lookup kernel (``kernels/ops.merge_lookup``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import base
from .base import SortedTable


def build(ks, vs, capacity: int, *, assume_sorted: bool = False, valid=None, ops=None) -> SortedTable:
    return base.build_sorted(
        ks, vs, capacity, assume_sorted=assume_sorted, block=0, valid=valid,
        ops=ops,
    )


def update_add(table: SortedTable, ks, vs, *, assume_sorted: bool = False, ops=None) -> SortedTable:
    del assume_sorted
    base.check_ops_update(ops)
    return base.merge_update_sorted(table, ks, vs, block=0)


def lookup(table: SortedTable, qs, *, assume_sorted: bool = False, valid=None):
    vals, found = base.sorted_lookup(table, qs)
    if valid is not None:
        found = found & valid.to(torch.bool)
        vals = torch.where(found[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return vals, found


items = base.sorted_items


def size(table: SortedTable) -> int:
    return int(table.n)


FAMILY = "sort"
SUPPORTS_HINTS = True

# Resident hooks: binary search over the power-of-two key slab.
RESIDENT = True
PARTITIONABLE = True
RESIDENT_ACCUMULATE = False  # terminals accumulate in hash scratch, then
# finalize through this family's ``build``


def resident_slabs(table: SortedTable) -> Tuple[torch.Tensor, ...]:
    return (table.keys,)


def resident_find(slabs, qs, *, capacity: int, max_probes: int = 0):
    """Binary search the slab; returns ``(slab position, found)``."""
    del capacity, max_probes
    (tk,) = slabs
    pos = base.lower_bound_pow2(tk, qs)
    found = tk[pos] == qs
    return torch.where(found, pos, -1), found
