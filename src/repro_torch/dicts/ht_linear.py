"""``ht_linear`` — open-addressing hash dictionary with linear probing.

The PyTorch twin of ``repro.dicts.ht_linear``: one multiplicative hash,
probe sequence ``h(k), h(k)+1, ...`` (mod C).  ``lookup`` and the all-sum
``build`` go through ``kernels.ops`` (``hash_probe``, ``hash_build``): the
hand-written kernels on the card, on the CPU their plain twins, the
whole-batch rounds of ``dicts.base``.  The CUDA fused-pipeline kernel probes
and accumulates the same layout (``kernels/csrc/fused_pipeline.cuh``:
``find_hash<0>`` / ``acc_slot<0>``).
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
    if base.all_sum(ops):
        from repro_torch.kernels import ops as kops  # lazy: the kernels' twins import dicts.base

        vs = vs[:, None] if vs.dim() == 1 else vs
        tk, tv = kops.hash_build(
            ks.to(torch.int32), vs.to(torch.float32), capacity=capacity, max_probes=MAX_PROBES,
            valid=None if valid is None else valid.to(torch.bool),
        )
        # a kernel-built table has no recorded probe depth: the family's bound
        # is exact, since every lookup stops at its key or an EMPTY slot
        return HashTable(tk, tv, MAX_PROBES - 1)
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
    from repro_torch.kernels import ops as kops  # lazy: the kernels' twins import dicts.base

    vals, found = kops.hash_probe(table.keys, table.vals, qs.to(torch.int32), max_probes=MAX_PROBES)
    return base.mask_rows(vals, found, valid)


items = base.hash_items
size = base.hash_size
FAMILY = "hash"
SUPPORTS_HINTS = False

# ---------------------------------------------------------------------------
# Resident (in-kernel) hooks: the plain twins of the CUDA device functions.
# ---------------------------------------------------------------------------

RESIDENT = True  # resident_find available: fused-kernel eligible
PARTITIONABLE = True  # slot-range radix partitioning supported
PARTITION_OVERLAP = MAX_PROBES  # probe chains run <= MAX_PROBES past a block


def resident_slabs(table: HashTable) -> Tuple[torch.Tensor, ...]:
    """Key-side slabs the kernel reads (payload slabs are assembled by the
    executor, aligned to ``slabs[0]``'s positions)."""
    return (table.keys,)


def resident_find(slabs, qs, *, capacity: int, base_slot=0, max_probes: int = MAX_PROBES):
    """Early-terminating linear probe over a key slab.  ``capacity`` is the
    FULL table capacity (the hash modulus); ``base_slot`` the global slot of
    slab position 0, nonzero when probing one radix partition, whose slab
    runs ``PARTITION_OVERLAP`` slots past the partition so chains never wrap
    out of it (a position outside the slab reads as EMPTY, a miss).
    Returns ``(slab position, found)``; position is -1 on a miss."""
    (tk,) = slabs
    n, L = qs.shape[0], tk.shape[0]
    full = L == capacity  # the whole table: chains wrap modulo it
    h0 = base.hash1(qs, capacity).to(torch.int64) - (0 if full else base_slot)
    active = torch.ones((n,), dtype=torch.bool, device=qs.device)
    slot_found = torch.full((n,), -1, dtype=torch.int64, device=qs.device)
    t = 0
    while t < max_probes and bool(active.any()):
        slot = (h0 + t) & (capacity - 1) if full else h0 + t
        inside = (slot >= 0) & (slot < L)
        cur = torch.where(inside, tk[slot.clamp(0, L - 1)], EMPTY)
        hit = active & (cur == qs)
        miss = active & (cur == EMPTY)
        slot_found = torch.where(hit, slot, slot_found)
        active = active & ~hit & ~miss
        t += 1
    return slot_found, slot_found >= 0


def partition_assign(table: HashTable, qs, n_parts: int) -> torch.Tensor:
    """Radix partition id of each probe key: the high bits of its hash slot."""
    return base.hash1(qs, table.capacity) // (table.capacity // n_parts)


def partition_slabs(table: HashTable, n_parts: int):
    """``(stacked key slabs ([P, Lp],), gather_idx [P, Lp], base [P])``; the
    executor gathers payload slabs through the same ``gather_idx``."""
    idx, base_slots = base.slot_partition_plan(table.capacity, n_parts, PARTITION_OVERLAP, table.keys.device)
    return (table.keys[idx.to(torch.int64)],), idx, base_slots


RESIDENT_ACCUMULATE = True


def resident_accumulate(tk, tv, ks, vs, pending, *, max_probes: int = MAX_PROBES, ops=None):
    """``dict[k] ⊕= v`` into an accumulator in this family's own layout."""
    tk, tv, _ = base.resident_insert_rounds(
        _probe(tk.shape[0]), tk, tv, ks, vs, pending, max_probes, ops=ops
    )
    return tk, tv
