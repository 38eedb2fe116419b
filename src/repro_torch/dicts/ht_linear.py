"""``ht_linear`` — open-addressing hash dictionary with linear probing.

The PyTorch twin of ``repro.dicts.ht_linear``: one multiplicative hash,
probe sequence ``h(k), h(k)+1, ...`` (mod C), whole-batch rounds.  The CUDA
fused-pipeline kernel probes and accumulates the same layout
(``kernels/csrc/dicts.cuh``: ``ht_linear_find`` / ``acc_insert``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import base
from .base import EMPTY, HashTable

MAX_PROBES = 128


def _probe(capacity: int):
    def fn(ks: torch.Tensor, t: int) -> torch.Tensor:
        return (base.hash1(ks, capacity) + t) & (capacity - 1)

    return fn


def empty(capacity: int, arity: int = 1, ops=None, device="cpu") -> HashTable:
    ident = base.lane_identity_row(ops, arity, device)
    return HashTable(
        keys=torch.full((capacity,), EMPTY, dtype=torch.int32, device=device),
        vals=torch.zeros((capacity, arity), dtype=torch.float32, device=device) + ident[None, :],
        max_t=0,
    )


def build(ks, vs, capacity: int, *, assume_sorted: bool = False, valid=None, ops=None) -> HashTable:
    del assume_sorted  # hash tables are order-insensitive (paper §4.1)
    arity = 1 if vs.dim() == 1 else vs.shape[-1]
    t = base.generic_insert(
        empty(capacity, arity, ops, ks.device), ks, vs, _probe(capacity),
        MAX_PROBES, valid=valid, ops=ops,
    )
    return t._replace(vals=base.finalize_dead(t.keys, t.vals, ops, EMPTY))


def update_add(table: HashTable, ks, vs, *, assume_sorted: bool = False, valid=None, ops=None) -> HashTable:
    del assume_sorted
    base.check_ops_update(ops)
    return base.generic_insert(
        table, ks, vs, _probe(table.capacity), MAX_PROBES, valid=valid
    )


def lookup(table: HashTable, qs, *, assume_sorted: bool = False, valid=None):
    del assume_sorted
    return base.generic_lookup(
        table, qs, _probe(table.capacity), MAX_PROBES, valid=valid
    )


items = base.hash_items
size = base.hash_size
FAMILY = "hash"
SUPPORTS_HINTS = False

# ---------------------------------------------------------------------------
# Resident (in-kernel) hooks: the plain twins of the CUDA device functions.
# ---------------------------------------------------------------------------

RESIDENT = True  # resident_find available: fused-kernel eligible
PARTITIONABLE = True  # slot-range radix partitioning (planner capability)
PARTITION_OVERLAP = MAX_PROBES


def resident_slabs(table: HashTable) -> Tuple[torch.Tensor, ...]:
    """Key-side slabs the kernel reads (payload slabs are assembled by the
    executor, aligned to ``slabs[0]``'s positions)."""
    return (table.keys,)


def resident_find(slabs, qs, *, capacity: int, max_probes: int = MAX_PROBES):
    """Early-terminating linear probe over the whole key slab.  Returns
    ``(slab position, found)``; position is -1 on a miss."""
    (tk,) = slabs
    n = qs.shape[0]
    h0 = base.hash1(qs, capacity).to(torch.int64)
    active = torch.ones((n,), dtype=torch.bool, device=qs.device)
    slot_found = torch.full((n,), -1, dtype=torch.int64, device=qs.device)
    t = 0
    while t < max_probes and bool(active.any()):
        slot = (h0 + t) & (capacity - 1)
        cur = tk[slot]
        hit = active & (cur == qs)
        miss = active & (cur == EMPTY)
        slot_found = torch.where(hit, slot, slot_found)
        active = active & ~hit & ~miss
        t += 1
    return slot_found, slot_found >= 0


RESIDENT_ACCUMULATE = True


def resident_accumulate(tk, tv, ks, vs, pending, *, max_probes: int = MAX_PROBES, ops=None):
    """``dict[k] ⊕= v`` into an accumulator in this family's own layout."""
    tk, tv, _ = base.resident_insert_rounds(
        _probe(tk.shape[0]), tk, tv, ks, vs, pending, max_probes, ops=ops
    )
    return tk, tv
