"""Dictionary runtime — the paper's Fig. 4 API as whole-batch tensor ops.

The PyTorch twin of ``repro.dicts.base``.  Every dictionary operation is a
vector operation over fixed-capacity struct-of-array state:

    build(keys, vals, capacity, **hints)      -> table (a NamedTuple)
    lookup(table, queries, **hints)           -> (vals[n, V], found[n])
    update_add(table, keys, vals, **hints)    -> table'
    items(table)                              -> (keys[C], vals[C, V], valid[C])
    size(table)                               -> int

Conventions (identical to the reference):

* keys are ``int32``; ``EMPTY`` (int32 min) and ``PAD`` (int32 max) are
  reserved sentinels;
* values are ``float32 [*, V]``; duplicate keys in a batch aggregate under
  each lane's combine monoid (``sum`` | ``min`` | ``max``);
* capacities are static powers of two; every tensor an operation creates
  lives on the device of its inputs.

Scatter "drop" semantics (JAX's ``mode="drop"``) are realised with one
extra sink row at index ``C`` that is sliced away afterwards.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

EMPTY = -(2**31)  # hash-table empty slot
PAD = 2**31 - 1  # sorted-array tail padding

# Knuth multiplicative hashing constants (distinct streams).
_H1 = 2654435761
_H2 = 2246822519
_M32 = 0xFFFFFFFF

OP_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}


def all_sum(ops) -> bool:
    return not ops or all(o == "sum" for o in ops)


def lane_identity_row(ops, V: int, device, dtype=torch.float32) -> torch.Tensor:
    """[V] per-lane combine identities (zeros when all-sum)."""
    if all_sum(ops):
        return torch.zeros((V,), dtype=dtype, device=device)
    return torch.tensor([OP_IDENTITY[o] for o in ops], dtype=dtype, device=device)


def _sink(idx: torch.Tensor, C: int) -> torch.Tensor:
    """Route out-of-range (negative or ≥ C) scatter indices to the sink row."""
    return torch.where((idx >= 0) & (idx < C), idx, C).to(torch.int64)


def combine_at(tv: torch.Tensor, idx: torch.Tensor, vs: torch.Tensor, ops) -> torch.Tensor:
    """Scatter-combine value rows into ``tv`` at ``idx`` (drop-mode: indices
    outside ``[0, C)`` are dropped), each lane under its own monoid."""
    C = tv.shape[0]
    ext = torch.cat([tv, tv.new_zeros((1,) + tv.shape[1:])])
    idx = _sink(idx, C)
    if all_sum(ops):
        ext.index_add_(0, idx, vs.to(tv.dtype))
        return ext[:C]
    for j, op in enumerate(ops):
        col = ext[:, j].clone()
        if op == "sum":
            col.index_add_(0, idx, vs[:, j].to(tv.dtype))
        else:
            col.scatter_reduce_(
                0, idx, vs[:, j].to(tv.dtype), "amin" if op == "min" else "amax"
            )
        ext[:, j] = col
    return ext[:C]


def neutralize_rows(vs: torch.Tensor, live: torch.Tensor, ops) -> torch.Tensor:
    """Replace dead rows with the per-lane combine identity."""
    if all_sum(ops):
        return torch.where(live[:, None], vs, torch.zeros((), dtype=vs.dtype, device=vs.device))
    ident = lane_identity_row(ops, vs.shape[1], vs.device, vs.dtype)
    return torch.where(live[:, None], vs, ident[None, :])


def finalize_dead(keys: torch.Tensor, vals: torch.Tensor, ops, sentinel) -> torch.Tensor:
    """Zero the value rows of unoccupied slots after an ops-aware build —
    min/max accumulation leaves ±inf identities there."""
    if all_sum(ops):
        return vals
    return torch.where((keys != sentinel)[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


def check_ops_update(ops) -> None:
    """Incremental ``update_add`` after an ops-aware build is unsupported
    (dead slots are zero-filled, not identity-filled)."""
    if not all_sum(ops):
        raise NotImplementedError(
            "update_add on min/max semiring lanes is not supported"
        )


def _mul32(h: torch.Tensor, mult: int) -> torch.Tensor:
    """``(h * mult) mod 2^32`` for ``0 ≤ h < 2^32`` in int64 without
    overflow: the multiplier is split into 16-bit halves."""
    lo = h * (mult & 0xFFFF)
    hi = (h * (mult >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Bit-identical to ``repro.dicts.base._mix`` (uint32 arithmetic), kept
    in int64 masked to 32 bits: CPU torch has no uint32 right shift."""
    h = _mul32(x.to(torch.int64) & _M32, mult)
    h = h ^ (h >> 15)
    h = _mul32(h, 2654435769)
    h = h ^ (h >> 13)
    return h


def hash1(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    return (_mix(keys, _H1) & (capacity - 1)).to(torch.int32)


def hash2(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    return (_mix(keys, _H2) & (capacity - 1)).to(torch.int32)


class HashTable(NamedTuple):
    """Open-addressing hash table (both probing families)."""

    keys: torch.Tensor  # [C] int32, EMPTY where unoccupied
    vals: torch.Tensor  # [C, V] float32
    max_t: int  # longest probe distance used at build

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


ProbeFn = Callable[[torch.Tensor, int], torch.Tensor]
# (keys[n], t) -> slot[n]


# ---------------------------------------------------------------------------
# Generic round-based vectorized insertion
# ---------------------------------------------------------------------------


def resident_insert_rounds(
    probe: ProbeFn,
    tk: torch.Tensor,
    tv: torch.Tensor,
    ks: torch.Tensor,
    vs: torch.Tensor,
    pending: torch.Tensor,
    max_probes: int,
    ops: Optional[Tuple[str, ...]] = None,
    max_t: int = 0,
):
    """``generic_insert``'s round loop: every round gathers the probed slot's
    key, aggregates hits, settles claims on EMPTY slots by scatter-max
    arbitration on the element id, re-checks losers (duplicate-key races)
    and advances survivors.  Early-terminating: one host sync per round.
    Returns ``(keys, vals, max_t)``."""
    n = ks.shape[0]
    C = tk.shape[0]
    dev = tk.device
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    tk, tv = tk.clone(), tv.clone()
    t = 0
    while t < max_probes and bool(pending.any()):
        slot = probe(ks, t).to(torch.int64)
        cur = tk[slot]
        hit = pending & (cur == ks)
        want = pending & (cur == EMPTY)
        claim = torch.full((C + 1,), -1, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(want, slot, C), ids, "amax")
        won = want & (claim[slot] == ids)
        ext = torch.cat([tk, tk.new_full((1,), EMPTY)])
        ext[torch.where(won, slot, C)] = ks
        tk = ext[:C]
        cur2 = tk[slot]
        hit2 = pending & ~hit & ~won & (cur2 == ks)
        write = hit | won | hit2
        tv = combine_at(tv, torch.where(write, slot, C), vs, ops)
        if bool(write.any()):
            max_t = max(max_t, t)
        pending = pending & ~write
        t += 1
    return tk, tv, max_t


def generic_insert(
    table: HashTable,
    ks: torch.Tensor,
    vs: torch.Tensor,
    probe: ProbeFn,
    max_probes: int,
    valid: Optional[torch.Tensor] = None,
    ops: Optional[Tuple[str, ...]] = None,
) -> HashTable:
    """Insert/aggregate a batch (see ``resident_insert_rounds``)."""
    if vs.dim() == 1:
        vs = vs[:, None]
    pending = (
        torch.ones(ks.shape, dtype=torch.bool, device=ks.device)
        if valid is None
        else valid.to(torch.bool)
    )
    tk, tv, max_t = resident_insert_rounds(
        probe, table.keys, table.vals, ks.to(torch.int32), vs, pending,
        max_probes, ops, table.max_t,
    )
    return HashTable(tk, tv, max_t)


def generic_lookup(
    table: HashTable,
    qs: torch.Tensor,
    probe: ProbeFn,
    max_probes: int,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch lookup: probe until key found or EMPTY reached; the bound is
    ``min(max_probes, build max_t + 1)``."""
    n = qs.shape[0]
    dev = qs.device
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    found_slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    t = 0
    while t <= table.max_t and t < max_probes and bool(active.any()):
        slot = probe(qs, t).to(torch.int64)
        cur = table.keys[slot]
        hit = active & (cur == qs)
        miss = active & (cur == EMPTY)
        found_slot = torch.where(hit, slot, found_slot)
        active = active & ~hit & ~miss
        t += 1
    found = found_slot >= 0
    if valid is not None:
        found = found & valid.to(torch.bool)
    return gather_rows(table.vals, found_slot, found), found


def gather_rows(vals: torch.Tensor, slot: torch.Tensor, found: torch.Tensor) -> torch.Tensor:
    """``vals[slot]`` where found, zero rows elsewhere (dtype preserved)."""
    rows = vals[torch.where(found, slot, 0).to(torch.int64)]
    return torch.where(found[:, None], rows, torch.zeros((), dtype=vals.dtype, device=vals.device))


def hash_items(table: HashTable):
    return table.keys, table.vals, table.keys != EMPTY


def hash_size(table: HashTable) -> int:
    return int((table.keys != EMPTY).sum())


# ---------------------------------------------------------------------------
# Sorted-array machinery shared by st_sorted / st_blocked
# ---------------------------------------------------------------------------


class SortedTable(NamedTuple):
    keys: torch.Tensor  # [C] int32 ascending, PAD tail
    vals: torch.Tensor  # [C, V] float32 (zeros on pad rows)
    n: int  # number of live (unique) keys
    block_max: torch.Tensor  # [NB] int32 per-block max (st_blocked index); [1] dummy


def dedupe_sorted(ks, vs, capacity: int, ops=None):
    """Aggregate duplicate keys of a sorted-with-holes sequence; returns
    padded unique arrays ``(uk [capacity], uv [capacity, V], n_unique)``.
    A live key starts a new segment iff it differs from the previous *live*
    key (running max over live keys), so PAD holes never split a run."""
    if vs.dim() == 1:
        vs = vs[:, None]
    dev = ks.device
    V = vs.shape[1]
    live = ks != PAD
    if ks.shape[0]:
        run_max = torch.cummax(torch.where(live, ks, EMPTY).to(torch.int64), 0).values
        prev_live = torch.cat([run_max.new_full((1,), EMPTY), run_max[:-1]])
    else:
        prev_live = ks.to(torch.int64)
    head = live & (ks.to(torch.int64) != prev_live)
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    seg = torch.where(live, seg, capacity)
    sink = _sink(seg, capacity)
    uk = torch.full((capacity + 1,), PAD, dtype=torch.int32, device=dev)
    uk.scatter_reduce_(0, sink, torch.where(live, ks, PAD).to(torch.int32), "amin")
    uk = uk[:capacity]
    if all_sum(ops):
        uv = torch.zeros((capacity + 1, V), dtype=vs.dtype, device=dev)
        uv.index_add_(0, sink, torch.where(live[:, None], vs, torch.zeros((), dtype=vs.dtype, device=dev)))
        uv = uv[:capacity]
    else:
        ident = lane_identity_row(ops, V, dev, vs.dtype)
        uv0 = torch.zeros((capacity, V), dtype=vs.dtype, device=dev) + ident[None, :]
        uv = combine_at(uv0, seg, neutralize_rows(vs, live, ops), ops)
        uv = finalize_dead(uk, uv, ops, PAD)
    return uk, uv, int(head.sum())


def build_sorted(
    ks, vs, capacity: int, *, assume_sorted: bool = False, block: int = 0,
    valid=None, ops=None,
) -> SortedTable:
    """Sort (skipped when the input is known ordered — the paper's hinted
    insert), aggregate duplicates, pad to capacity.  A ``valid`` mask turns
    masked keys into PAD holes in place; ``dedupe_sorted`` routes them off
    the table, so no re-sort is needed."""
    if vs.dim() == 1:
        vs = vs[:, None]
    ks = ks.to(torch.int32)
    if valid is not None:
        ks = torch.where(valid.to(torch.bool), ks, PAD)
    if not assume_sorted:
        perm = torch.argsort(ks, stable=True)
        ks, vs = ks[perm], vs[perm]
    uk, uv, n = dedupe_sorted(ks, vs, capacity, ops)
    return SortedTable(uk, uv, n, _block_index(uk, block))


def _block_index(keys: torch.Tensor, block: int) -> torch.Tensor:
    if block <= 0:
        return torch.full((1,), PAD, dtype=torch.int32, device=keys.device)
    C = keys.shape[0]
    nb = max(1, C // block)
    return keys[: nb * block].reshape(nb, block).amax(dim=1)


def sorted_lookup(keys: torch.Tensor, vals: torch.Tensor, qs: torch.Tensor):
    """Vectorized binary search of ``qs`` in the sorted ``keys`` (the PAD
    tail keeps it in range); misses give zero rows of ``vals``."""
    C = keys.shape[0]
    idx = torch.searchsorted(keys, qs.to(torch.int32), side="left")
    idx = torch.clamp(idx, max=C - 1)
    found = keys[idx] == qs
    return gather_rows(vals, idx, found), found


def mask_rows(vals: torch.Tensor, found: torch.Tensor, valid: Optional[torch.Tensor]):
    """A lookup's ``(vals, found)`` with the probe rows outside ``valid``
    turned into misses (zero rows)."""
    if valid is None:
        return vals, found
    found = found & valid.to(torch.bool)
    return torch.where(found[:, None], vals, torch.zeros((), dtype=vals.dtype, device=vals.device)), found


def blocked_lookup(table: SortedTable, qs: torch.Tensor, block: int):
    """Two-level search: the block-max directory picks the leaf, then the
    count of leaf keys below the query — computed as a clamped lower bound
    (the leaf is a sorted slice of the key array), which equals the
    reference's within-leaf compare-count without an ``[n, block]`` gather."""
    C = table.keys.shape[0]
    nb = table.block_max.shape[0]
    qs = qs.to(torch.int32)
    blk = torch.clamp(torch.searchsorted(table.block_max, qs, side="left"), max=nb - 1)
    base = blk * block
    lb = torch.searchsorted(table.keys, qs, side="left")
    lt = torch.clamp(lb - base, 0, block)
    idx = torch.clamp(base + lt, max=C - 1)
    found = table.keys[idx] == qs
    return gather_rows(table.vals, idx, found), found


def merge_update_sorted(table: SortedTable, ks, vs, *, block: int = 0) -> SortedTable:
    """``update_add`` for sorted dictionaries: merge batch into table."""
    if vs.dim() == 1:
        vs = vs[:, None]
    cat_k = torch.cat([table.keys, ks.to(torch.int32)])
    cat_v = torch.cat([table.vals, vs.to(table.vals.dtype)])
    perm = torch.argsort(cat_k, stable=True)
    uk, uv, n = dedupe_sorted(cat_k[perm], cat_v[perm], table.keys.shape[0])
    return SortedTable(uk, uv, n, _block_index(uk, block))


def sorted_items(table: SortedTable):
    return table.keys, table.vals, table.keys != PAD


# ---------------------------------------------------------------------------
# Resident (in-kernel) machinery shared by the per-family ``resident_*`` hooks
# ---------------------------------------------------------------------------


def lower_bound_pow2(keys: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Branchless lower bound over a sorted power-of-two slab:
    ``min(count of keys < q, L-1)`` per query, log2(L) gather+compare
    rounds — the plain twin of the CUDA kernel's ``lower_bound_pow2``."""
    L = keys.shape[0]
    if L & (L - 1):
        raise ValueError("slab length must be a power of two")
    pos = torch.zeros(qs.shape, dtype=torch.int64, device=qs.device)
    bit = L >> 1
    while bit:
        cand = pos + bit
        below = keys[cand - 1] < qs
        pos = torch.where(below, cand, pos)
        bit >>= 1
    return pos


def slot_partition_plan(capacity: int, n_parts: int, overlap: int, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot-range partitioning of a ``capacity``-slot table into ``n_parts``
    blocks of ``capacity//n_parts + overlap`` slots each, the overlap
    wrapping modulo capacity (hash probe chains run past a block's end by at
    most ``max_probes`` slots; sorted slabs use overlap 0).  Returns
    ``(gather_idx [P, Lp], base [P])``: ``gather_idx`` maps every block
    position to its global slot (keys and payload slabs partition through
    the same map, so probed positions stay aligned), ``base[p]`` is the
    global slot of block p's position 0."""
    if capacity % n_parts:
        raise ValueError("capacity must be a multiple of the partition count")
    cp = capacity // n_parts
    lp = cp + min(overlap, capacity - cp) if overlap else cp
    base = torch.arange(n_parts, dtype=torch.int32, device=device) * cp
    idx = (base[:, None] + torch.arange(lp, dtype=torch.int32, device=device)[None, :]) % capacity
    return idx, base


def block_of(keys: torch.Tensor, qs: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Key-range partition of each query over a sorted slab: the count of
    block-leading keys (``keys[::C/P]``) <= q, minus one, clamped at 0 (a
    sorted search over the leading keys, equal to the reference's
    compare-count)."""
    bounds = keys[:: keys.shape[0] // n_parts].contiguous()
    le = torch.searchsorted(bounds, qs.to(torch.int32).contiguous(), right=True)
    return torch.clamp(le - 1, min=0).to(torch.int32)


def next_pow2(x: int) -> int:
    c = 1
    while c < x:
        c <<= 1
    return c


def default_capacity(n_distinct: int) -> int:
    """The static capacity rule — 2× slack over the estimated distinct
    count, 256-slot floor, power of two (shared by the executor and the
    fusion cost model)."""
    return next_pow2(max(2 * int(n_distinct), 256))
