"""``st_blocked`` — sorted dictionary with a block-max index.

The PyTorch twin of ``repro.dicts.st_blocked`` (the paper's B+-tree
dictionaries flattened to one directory level): a flat per-block max-key
directory over ``BLOCK``-wide sorted leaves.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import base
from .base import SortedTable

BLOCK = 128


def build(ks, vs, capacity: int, *, assume_sorted: bool = False, valid=None, ops=None) -> SortedTable:
    if capacity % BLOCK:
        raise ValueError("capacity must be a multiple of BLOCK")
    return base.build_sorted(
        ks, vs, capacity, assume_sorted=assume_sorted, block=BLOCK, valid=valid,
        ops=ops,
    )


def update_add(table: SortedTable, ks, vs, *, assume_sorted: bool = False, ops=None) -> SortedTable:
    del assume_sorted
    base.check_ops_update(ops)
    return base.merge_update_sorted(table, ks, vs, block=BLOCK)


def lookup(table: SortedTable, qs, *, assume_sorted: bool = False, valid=None):
    vals, found = base.blocked_lookup(table, qs, BLOCK)
    if valid is not None:
        found = found & valid.to(torch.bool)
        vals = torch.where(found[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    return vals, found


items = base.sorted_items


def size(table: SortedTable) -> int:
    return int(table.n)


FAMILY = "sort"
SUPPORTS_HINTS = True

# Resident hooks: directory search, then the leaf.  Key-range partitions
# slice the leaves and the directory alike (``BLOCK`` divides a partition,
# so no leaf straddles two).
RESIDENT = True
PARTITIONABLE = True
RESIDENT_ACCUMULATE = False


def resident_slabs(table: SortedTable) -> Tuple[torch.Tensor, ...]:
    return (table.keys, table.block_max)


def resident_find(slabs, qs, *, capacity: int, base_slot=0, max_probes: int = 0):
    """Directory-then-leaf search over a whole table or one partition
    block.  The leaf id is the count of block maxima below the query (the
    reference compare-counts the whole directory; a lower bound over the
    sorted maxima gives the same id), and the in-leaf offset is the count of
    leaf keys below the query."""
    del capacity, base_slot, max_probes
    tk, bm = slabs
    L = tk.shape[0]
    nb = bm.shape[0]
    qs = qs.to(torch.int32)
    blk = torch.clamp(torch.searchsorted(bm, qs, side="left"), max=nb - 1)
    base_pos = blk * BLOCK
    lt = torch.clamp(torch.searchsorted(tk, qs, side="left") - base_pos, 0, BLOCK)
    pos = torch.clamp(base_pos + lt, max=L - 1)
    found = tk[pos] == qs
    return torch.where(found, pos, -1), found


def partition_assign(table: SortedTable, qs, n_parts: int) -> torch.Tensor:
    return base.block_of(table.keys, qs, n_parts)


def partition_slabs(table: SortedTable, n_parts: int):
    C = table.keys.shape[0]
    cp = C // n_parts
    if cp % BLOCK:
        raise ValueError("partition width must be a multiple of BLOCK")
    idx, base_slots = base.slot_partition_plan(C, n_parts, 0, table.keys.device)
    bm = table.block_max.reshape(n_parts, cp // BLOCK)
    return (table.keys[idx.to(torch.int64)], bm), idx, base_slots
