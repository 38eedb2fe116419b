"""Hash build — batched insert-aggregate into an empty ``ht_linear`` table,
as a hand-written Hopper kernel (``csrc/hash_build.cu``).

Replaces ``repro/kernels/hash_build.py:hash_build``.  Rows claim their
key's slot with ``atomicCAS`` (a CAS lost to the same key joins it) after
each warp folds its rows by key, and add their sum lanes; rows still pending
after ``max_probes`` slots are dropped, as in the reference.  Three paths,
chosen by :func:`build_path` from the shapes: claims in device memory
(``global``), block-private tables in shared memory flushed by key
(``private``, small tables under many rows), and a build partitioned by
slot range, one shared-memory slice a block (``partitioned``, tables larger
than L2; no separate fill).  The plain twin, :func:`hash_build_plain`, is
``dicts.base.generic_insert`` into an empty table with the same bound; the
wrapper takes it only for CPU tensors.  On request it models the private
and the partitioned builds instead (``blocks=``, ``slice_slots=``).  Slot
layouts differ between them (the order of claims), key sets do not.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dicts import base as dbase
from repro_torch.dicts import ht_linear

from . import build

MAX_PROBES = 32  # the reference kernel's default bound
BLOCK = 256  # threads a block (csrc/hash_build.cu)
#: a block's private table (keys and lanes, C·(1+V)·4 bytes) in shared memory
PRIVATE_BYTES = 96 * 1024
#: rows a private block takes for each slot of its table
PRIVATE_ROWS = 2
#: one slice of the partitioned build (S·(1+V)·4 bytes) in shared memory
SLICE_BYTES = 64 * 1024
MAX_SLICES = 8192  # the count and scatter launches' histogram (32 KB)
MIN_SLICE = 256
PATHS = ("global", "private", "partitioned")
LAUNCHES = {"global": 1, "private": 1, "partitioned": 5}  # kernels a call launches


def _empty(capacity: int, V: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((capacity,), dbase.EMPTY, dtype=torch.int32, device=device),
            torch.zeros((capacity, V), dtype=torch.float32, device=device))


def slice_slots(capacity: int, V: int, sms: int) -> int:
    """Slots S of a slice of the partitioned build: the largest power of two
    whose keys and lanes fit ``SLICE_BYTES`` and that leaves at least two
    slices (blocks) a multiprocessor."""
    S = 1
    while 2 * S * 2 * sms <= capacity and 2 * S * (1 + V) * 4 <= SLICE_BYTES:
        S *= 2
    return S


def build_path(n: int, capacity: int, V: int, sms: int, l2_bytes: int) -> str:
    """The kernel path for ``n`` rows into ``capacity`` slots of ``V`` lanes
    on a card of ``sms`` multiprocessors and an L2 cache of ``l2_bytes``:

    * ``private`` where the table fits a block's shared memory and the rows
      make blocks of ``PRIVATE_ROWS`` rows a slot for at least half the
      multiprocessors (fewer rows leave the card idle while a few blocks
      fill and flush their tables);
    * ``partitioned`` where the table is larger than L2 (its claims in
      device memory would then go to DRAM) and splits into at most
      ``MAX_SLICES`` slices of at least ``MIN_SLICE`` slots
      (:func:`slice_slots`); a table in L2 is claimed faster in place;
    * else ``global``."""
    table = capacity * (1 + V) * 4
    if table <= PRIVATE_BYTES and 2 * (n // (PRIVATE_ROWS * capacity)) >= sms:
        return "private"
    S = slice_slots(capacity, V, sms)
    if table > l2_bytes and S >= MIN_SLICE and capacity // S <= MAX_SLICES:
        return "partitioned"
    return "global"


def _wall(ks: torch.Tensor) -> int:
    """A key no row carries and not EMPTY: a slot that stops no chain."""
    w = dbase.EMPTY + 1
    while bool((ks == w).any()):
        w += 1
    return w


def _chain_holds(tk, ks, slot_of, steps: int) -> torch.Tensor:
    """Rows whose key lies in ``tk`` at ``slot_of(t)`` for some t < steps."""
    found = torch.zeros(ks.shape, dtype=torch.bool, device=ks.device)
    for t in range(steps):
        found |= tk[slot_of(t)] == ks
    return found


def _partitioned_model(ks, vs, capacity: int, max_probes: int, S: int):
    """The partitioned build: each slice of ``S`` slots built alone (linear
    probing inside it, no wrap; a wall key past its end), then the keys whose
    chain ran off a slice's end claimed in the written table from there, in
    the remaining probes."""
    if S < 1 or S & (S - 1) or capacity % S:
        raise ValueError(f"hash_build_plain: slice_slots must be a power of two dividing the capacity, got {S}")
    C, V, dev = capacity, vs.shape[1], ks.device
    h = dbase.hash1(ks, C).to(torch.int64)
    sl, local = h // S, h % S
    width = S + 1
    wall = _wall(ks)
    tk = torch.full(((C // S) * width,), dbase.EMPTY, dtype=torch.int32, device=dev)
    tk[S::width] = wall
    tv = torch.zeros((tk.shape[0], V), dtype=torch.float32, device=dev)
    pending = torch.ones(ks.shape, dtype=torch.bool, device=dev)
    tk, tv, _ = dbase.resident_insert_rounds(
        lambda _k, t: sl * width + torch.clamp(local + t, max=S), tk, tv, ks, vs, pending, max_probes)
    placed = _chain_holds(tk, ks, lambda t: sl * width + torch.clamp(local + t, max=S), min(max_probes, S))
    used = S - local  # probes a chain that runs off the slice's end has used
    over = ~placed & (used < max_probes)
    tk = torch.cat([tk.view(-1, width)[:, :S].reshape(C), tk.new_full((1,), wall)])
    tv = torch.cat([tv.view(-1, width, V)[:, :S].reshape(C, V), tv.new_zeros((1, V))])
    ok, ov, oh, ou = ks[over], vs[over], h[over], used[over]
    tk, tv, _ = dbase.resident_insert_rounds(
        lambda _k, t: torch.where(ou + t < max_probes, (oh + ou + t) & (C - 1), C), tk, tv, ok, ov,
        torch.ones(ok.shape, dtype=torch.bool, device=dev), max_probes)
    return tk[:C], tv[:C]


def _private_model(ks, vs, rows, capacity: int, max_probes: int, B: int):
    """Private tables: block ``(row // BLOCK) % B`` (the kernel's grid-stride
    loop) claims its rows in its own table of the same layout; a row whose
    chain there runs past ``max_probes`` goes to the global table directly;
    then every block's occupied slots are claimed there, one a key."""
    if B < 1:
        raise ValueError(f"hash_build_plain: blocks must be at least 1, got {B}")
    C, V, dev = capacity, vs.shape[1], ks.device
    h = dbase.hash1(ks, C).to(torch.int64)
    blk = (rows // BLOCK) % B
    pk = torch.full((B * C,), dbase.EMPTY, dtype=torch.int32, device=dev)
    pv = torch.zeros((B * C, V), dtype=torch.float32, device=dev)
    ones = torch.ones(ks.shape, dtype=torch.bool, device=dev)
    pk, pv, _ = dbase.resident_insert_rounds(lambda _k, t: blk * C + ((h + t) & (C - 1)), pk, pv, ks, vs, ones,
                                             max_probes)
    direct = ~_chain_holds(pk, ks, lambda t: blk * C + ((h + t) & (C - 1)), min(max_probes, C))
    tk, tv = _empty(C, V, dev)
    probe = ht_linear._probe(C)
    tk, tv, _ = dbase.resident_insert_rounds(probe, tk, tv, ks[direct], vs[direct], ones[direct], max_probes)
    occ = pk != dbase.EMPTY
    tk, tv, _ = dbase.resident_insert_rounds(probe, tk, tv, pk[occ], pv[occ], occ[occ], max_probes)
    return tk, tv


def hash_build_plain(keys, vals, capacity: int, max_probes: int = MAX_PROBES,
                     valid: Optional[torch.Tensor] = None, *, slice_slots: Optional[int] = None,
                     blocks: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table_keys [C], table_vals [C, V])``: rows (where ``valid``) summed
    per key into an empty linear-probe table; rows pending after
    ``max_probes`` slots are dropped.  By default the reference's round
    loop; ``slice_slots=S`` models the partitioned build (slices of ``S``
    slots and the overflow pass), ``blocks=B`` the private tables of ``B``
    blocks flushed by key — each the same function, in another order."""
    if slice_slots is None and blocks is None:
        tk, tv = _empty(capacity, vals.shape[1], keys.device)
        t = dbase.generic_insert(dbase.HashTable(tk, tv, 0), keys, vals, ht_linear._probe(capacity), max_probes,
                                 valid=valid)
        return t.keys, t.vals
    if slice_slots is not None and blocks is not None:
        raise ValueError("hash_build_plain: model one build, slice_slots= or blocks=")
    rows = torch.arange(keys.shape[0], device=keys.device)
    if valid is not None:
        rows = rows[valid.to(torch.bool)]
    ks, vs = keys.to(torch.int32)[rows], vals.to(torch.float32)[rows]
    if slice_slots is not None:
        return _partitioned_model(ks, vs, capacity, max_probes, slice_slots)
    return _private_model(ks, vs, rows, capacity, max_probes, blocks)


_LIB = {}
_CARD = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "hash_build.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("hash_build", src), "hash_build_launch")
    return _LIB["fn"]


def _card(dev) -> Tuple[int, int]:
    """(multiprocessors, L2 bytes) of a card."""
    if dev not in _CARD:
        props = torch.cuda.get_device_properties(dev)
        _CARD[dev] = props.multi_processor_count, props.L2_cache_size
    return _CARD[dev]


def hash_build(keys, vals, capacity: int, max_probes: int = MAX_PROBES,
               valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table_keys [C] int32, table_vals [C, V] float32)`` from ``keys
    [N]`` int32 and ``vals [N, V]`` float32, duplicate keys summed;
    ``capacity`` a power of two, ``valid`` an optional ``[N]`` bool row mask.
    CPU tensors take :func:`hash_build_plain`; CUDA tensors launch the kernels
    of the path :func:`build_path` picks, or raise."""
    if not keys.is_cuda:
        return hash_build_plain(keys, vals, capacity, max_probes, valid)
    dev = keys.device
    if not (vals.is_cuda and vals.device == dev and (valid is None or (valid.is_cuda and valid.device == dev))):
        raise ValueError("hash_build: all tensors must be on one CUDA device")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32 or (valid is not None and valid.dtype != torch.bool):
        raise TypeError("hash_build takes int32 keys, float32 values and a bool row mask")
    n = keys.shape[0]
    if keys.dim() != 1 or vals.dim() != 2 or vals.shape[0] != n or (valid is not None and valid.shape != (n,)):
        raise ValueError(f"hash_build: keys must be [N], vals [N, V], valid [N]; got {tuple(keys.shape)}, "
                         f"{tuple(vals.shape)}, {None if valid is None else tuple(valid.shape)}")
    if capacity < 1 or capacity & (capacity - 1) or capacity >= 2**31:
        raise ValueError(f"hash_build: capacity must be a power of two below 2^31, got {capacity}")
    V = vals.shape[1]
    if n == 0:
        return _empty(capacity, V, dev)
    keys, vals = keys.contiguous(), vals.contiguous()
    valid = None if valid is None else valid.contiguous()
    sms, l2 = _card(dev)
    path = build_path(n, capacity, V, sms, l2)
    ptrs = [keys.data_ptr(), vals.data_ptr(), 0 if valid is None else valid.data_ptr()]
    ints = [n, capacity, V, max_probes, PATHS.index(path)]
    if path == "partitioned":
        S = slice_slots(capacity, V, sms)
        nslices = capacity // S
        tk = torch.empty((capacity,), dtype=torch.int32, device=dev)  # every slice writes all its slots
        tv = torch.empty((capacity, V), dtype=torch.float32, device=dev)
        counts = torch.zeros((nslices + 1,), dtype=torch.int32, device=dev)  # the last: the overflow count
        scratch = [counts, torch.empty((nslices + 1,), dtype=torch.int32, device=dev),
                   torch.empty((nslices,), dtype=torch.int32, device=dev),
                   torch.empty((n,), dtype=torch.int32, device=dev), torch.empty((n, V), device=dev),
                   torch.empty((n,), dtype=torch.int32, device=dev), torch.empty((n,), dtype=torch.int32, device=dev),
                   torch.empty((n, V), device=dev)]
        ptrs += [tk.data_ptr(), tv.data_ptr()] + [t.data_ptr() for t in scratch]
        ints += [0, S.bit_length() - 1]
    else:
        tk, tv = _empty(capacity, V, dev)
        ptrs += [tk.data_ptr(), tv.data_ptr()]
        want = -(-n // BLOCK) if path == "global" else max(1, n // (PRIVATE_ROWS * capacity))
        ints.append(want)
    build.launch(_launcher(), ptrs, ints, torch.cuda.current_stream(dev).cuda_stream)
    _BUILD.launches += LAUNCHES[path]
    return tk, tv


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
hash_build.launches = 0
_BUILD = hash_build
