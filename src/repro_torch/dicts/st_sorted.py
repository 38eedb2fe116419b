"""``st_sorted`` — sorted-array dictionary (the paper's ``boost_flat_map``).

The PyTorch twin of ``repro.dicts.st_sorted``.  Build = sort + duplicate
aggregation, the sort skipped when the input is known ordered (the paper's
hinted insert).  Lookup = binary search through ``kernels.ops.sorted_lookup``
(the hand-written kernel on the card, its plain twin on the CPU); ordered
probe streams go through the merge-lookup kernel (``kernels/ops.merge_lookup``,
called by the engine).
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
    del assume_sorted  # hinted probes reach the merge lookup through the engine
    from repro_torch.kernels import ops as kops  # lazy: the kernels' twins import dicts.base

    vals, found = kops.sorted_lookup(table.keys, table.vals, qs.to(torch.int32))
    return base.mask_rows(vals, found, valid)


items = base.sorted_items


def size(table: SortedTable) -> int:
    return int(table.n)


FAMILY = "sort"
SUPPORTS_HINTS = True

# Resident hooks: binary search over the power-of-two key slab.  Partitions
# are key ranges: block p covers sorted positions [p*Cp, (p+1)*Cp), and a
# query belongs to the block whose first key is its greatest lower bound (no
# overlap: keys are unique).
RESIDENT = True
PARTITIONABLE = True
RESIDENT_ACCUMULATE = False  # terminals accumulate in hash scratch, then
# finalize through this family's ``build``


def resident_slabs(table: SortedTable) -> Tuple[torch.Tensor, ...]:
    return (table.keys,)


def resident_find(slabs, qs, *, capacity: int, base_slot=0, max_probes: int = 0):
    """Binary search the slab (a whole table or one partition block alike);
    returns ``(slab position, found)``."""
    del capacity, base_slot, max_probes
    (tk,) = slabs
    pos = base.lower_bound_pow2(tk, qs)
    found = tk[pos] == qs
    return torch.where(found, pos, -1), found


def partition_assign(table: SortedTable, qs, n_parts: int) -> torch.Tensor:
    """Block whose key range holds each query: the count of block-leading
    keys <= q, minus one (clamped: queries below the first key probe block 0
    and miss there)."""
    return base.block_of(table.keys, qs, n_parts)


def partition_slabs(table: SortedTable, n_parts: int):
    idx, base_slots = base.slot_partition_plan(table.keys.shape[0], n_parts, 0, table.keys.device)
    return (table.keys[idx.to(torch.int64)],), idx, base_slots
