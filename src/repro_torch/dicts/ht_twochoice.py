"""``ht_twochoice`` — bucketized two-choice hash dictionary.

The PyTorch twin of ``repro.dicts.ht_twochoice``: each key has two
candidate buckets of ``BUCKET`` slots (hashes h1, h2); the probe walks
bucket 1, then bucket 2, then falls back to linear probing from bucket 2.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import base
from .base import EMPTY, HashTable

BUCKET = 8
MAX_PROBES = 2 * BUCKET + 64  # bucket phase + rare linear overflow


def _probe(capacity: int):
    nb = capacity // BUCKET

    def fn(ks: torch.Tensor, t: int) -> torch.Tensor:
        if t < BUCKET:
            return base.hash1(ks, nb) * BUCKET + t
        b2 = base.hash2(ks, nb) * BUCKET
        if t < 2 * BUCKET:
            return b2 + (t - BUCKET)
        return (b2 + t) & (capacity - 1)

    return fn


def empty(capacity: int, arity: int = 1, ops=None, device="cpu") -> HashTable:
    if capacity % BUCKET:
        raise ValueError("capacity must be a multiple of BUCKET")
    ident = base.lane_identity_row(ops, arity, device)
    return HashTable(
        keys=torch.full((capacity,), EMPTY, dtype=torch.int32, device=device),
        vals=torch.zeros((capacity, arity), dtype=torch.float32, device=device) + ident[None, :],
        max_t=0,
    )


def build(ks, vs, capacity: int, *, assume_sorted: bool = False, valid=None, ops=None) -> HashTable:
    del assume_sorted
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

# Resident hooks.  A key's two buckets lie far apart, so the family is
# resident-eligible but not slot-range partitionable.
RESIDENT = True
PARTITIONABLE = False


def resident_slabs(table: HashTable) -> Tuple[torch.Tensor, ...]:
    return (table.keys,)


def resident_find(slabs, qs, *, capacity: int, max_probes: int = MAX_PROBES):
    """Early-terminating bucket-then-overflow probe over the whole table."""
    (tk,) = slabs
    if tk.shape[0] != capacity:
        raise ValueError("ht_twochoice probes need the whole table")
    probe = _probe(capacity)
    n = qs.shape[0]
    active = torch.ones((n,), dtype=torch.bool, device=qs.device)
    slot_found = torch.full((n,), -1, dtype=torch.int64, device=qs.device)
    t = 0
    while t < max_probes and bool(active.any()):
        slot = probe(qs, t).to(torch.int64)
        cur = tk[slot]
        hit = active & (cur == qs)
        miss = active & (cur == EMPTY)
        slot_found = torch.where(hit, slot, slot_found)
        active = active & ~hit & ~miss
        t += 1
    return slot_found, slot_found >= 0


RESIDENT_ACCUMULATE = True


def resident_accumulate(tk, tv, ks, vs, pending, *, max_probes: int = MAX_PROBES, ops=None):
    """Accumulate in this family's own layout — the terminal needs no
    rebuild."""
    tk, tv, _ = base.resident_insert_rounds(
        _probe(tk.shape[0]), tk, tv, ks, vs, pending, max_probes, ops=ops
    )
    return tk, tv
