"""Merge lookup — sorted probes into a sorted dictionary (the paper's hinted
lookup), as a hand-written Hopper kernel (``csrc/merge_lookup.cu``).

Replaces ``repro/kernels/merge_lookup.py:merge_lookup``.  Two launches: the
first gives every :data:`TILE`-probe tile its key range (the lower bounds of
its first probe and of the next tile's first, one warp a boundary, all
tiles at once); the second stages each tile's range in shared memory when it
holds at most :data:`STAGE` keys (else the tile searches the same range in
global memory), and each thread searches its first probe there and gallops
from it for the rest of its :data:`PER` consecutive probes.  The plain twin,
:func:`merge_lookup_plain`, is the same function (``searchsorted``, clamp,
compare, gather, any probe order); with ``tile=`` it models the kernel's
tile ranges (:func:`tile_ranges`) and per-thread cursor instead.  The
wrapper takes the twin only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

THREADS, PER = 512, 8  # a block's threads and each thread's consecutive probes (csrc/merge_lookup.cu)
TILE = THREADS * PER  # probes a block takes at once
STAGE = 4096  # keys of a tile's range that fit the block's shared memory
# the reference's window: tables route to the kernel under its rule
# (C % WINDOW == 0, C >= 2 * WINDOW), so the same tables take the kernel
WINDOW = 2048


def tile_ranges(table_keys, queries, tile: int = TILE):
    """``(start, count)`` of each ``tile``-probe tile of the non-decreasing
    ``queries``: its probes' lower bounds, clamped to ``C - 1``, all lie in
    ``[start, start + count)``.  The kernel stages a range of at most
    :data:`STAGE` keys in shared memory and searches a longer one in
    global memory."""
    C = table_keys.shape[0]
    n = queries.shape[0]
    heads = torch.cat([queries[::tile], queries[n - 1:]])  # each tile's first probe, then the last
    bounds = torch.searchsorted(table_keys, heads, side="left")
    start = torch.clamp(bounds[:-1], max=C - 1)
    return start, torch.clamp(bounds[1:], max=C - 1) - start + 1


def _lower_bound(key_at, lo, hi, q):
    """Lower bound of each ``q`` in its bracket ``[lo, hi)`` (``hi`` if
    none), a vectorised binary search; ``key_at(i)`` reads the keys."""
    lo, hi = lo.clone(), hi.clone()
    for _ in range(int((hi - lo).max()).bit_length() if lo.numel() else 0):
        active = lo < hi
        mid = (lo + hi) >> 1
        right = active & (key_at(torch.where(active, mid, 0)) < q)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def _tile_model(table_keys, queries, tile):
    """Each non-decreasing query's clamped lower bound as the kernel finds
    it: its tile's range from :func:`tile_ranges`, a thread's first probe
    searched over that range, each later one from the index before it (the
    kernel gallops from there).  Where the kernel stages a range it reads
    a copy of the same keys, so staging decides where the reads go, not
    what they return."""
    n = queries.shape[0]
    dev = queries.device
    start, count = tile_ranges(table_keys, queries, tile)
    T = start.shape[0]
    # [threads, PER] probes; the last tile's rows past n repeat the last probe
    q = torch.cat([queries, queries[-1:].expand(T * tile - n)]).reshape(-1, PER)
    t_of = torch.arange(q.shape[0], device=dev) * PER // tile
    base, cnt = start[t_of], count[t_of]

    def key_at(local):
        return table_keys[base + local]

    cur = torch.zeros_like(base)
    idx = torch.empty_like(q, dtype=base.dtype)
    for p in range(PER):
        cur = _lower_bound(key_at, cur, cnt, q[:, p])
        idx[:, p] = base + torch.minimum(cur, cnt - 1)
    return idx.reshape(-1)[:n]


def merge_lookup_plain(table_keys, table_vals, queries, *, tile=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V], found [n])``: the lower bound of each query in the
    sorted, PAD-tailed ``table_keys``, clamped to ``C - 1``, a compare, the
    value row where the keys match (zeros for a miss).

    Without ``tile`` one ``searchsorted`` finds the bounds, for probes in
    any order.  With ``tile`` (a multiple of :data:`PER`; the kernel's is
    :data:`TILE`) the non-decreasing probes go through the kernel's
    algorithm over tiles of ``tile`` probes (:func:`_tile_model`)."""
    C = table_keys.shape[0]
    n = queries.shape[0]
    V = table_vals.shape[1]
    if tile is not None and (tile <= 0 or tile % PER):
        raise ValueError(f"merge_lookup_plain: tile={tile} is no positive multiple of {PER}")
    if n == 0:
        return (torch.zeros((0, V), dtype=table_vals.dtype, device=queries.device),
                torch.zeros((0,), dtype=torch.bool, device=queries.device))
    if tile is None:
        idx = torch.clamp(torch.searchsorted(table_keys, queries, side="left"), max=C - 1)
    else:
        idx = _tile_model(table_keys, queries, tile)
    found = table_keys[idx] == queries
    vals = torch.where(
        found[:, None], table_vals[idx], torch.zeros((), dtype=table_vals.dtype, device=table_vals.device)
    )
    return vals, found


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "merge_lookup.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("merge_lookup", src), "merge_lookup_launch")
    return _LIB["fn"]


def merge_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V] float32, found [n] bool)``.  Probes MUST be
    non-decreasing.  CPU tensors take :func:`merge_lookup_plain`; CUDA
    tensors launch the kernel (two launches: the tile ranges, the lookup)
    or raise."""
    if not queries.is_cuda:
        return merge_lookup_plain(table_keys, table_vals, queries)
    C = table_keys.shape[0]
    n = queries.shape[0]
    V = table_vals.shape[1] if table_vals.dim() == 2 else 0
    if not (table_keys.is_cuda and table_vals.is_cuda
            and table_keys.device == queries.device == table_vals.device):
        raise ValueError("merge_lookup: all tensors must be on one CUDA device")
    if table_keys.dtype != torch.int32 or queries.dtype != torch.int32 or table_vals.dtype != torch.float32:
        raise TypeError("merge_lookup takes int32 keys/queries and float32 values")
    if table_vals.dim() != 2 or table_vals.shape[0] != C or V < 1:
        raise ValueError(f"merge_lookup: vals must be [C={C}, V>=1], got {tuple(table_vals.shape)}")
    if C % WINDOW or C < 2 * WINDOW:
        raise ValueError(f"merge_lookup needs C >= {2 * WINDOW} and C % {WINDOW} == 0, got C={C}")
    table_keys, table_vals, queries = (
        table_keys.contiguous(), table_vals.contiguous(), queries.contiguous()
    )
    out_vals = torch.empty((n, V), dtype=torch.float32, device=queries.device)
    out_found = torch.empty((n,), dtype=torch.bool, device=queries.device)
    if n == 0:
        return out_vals, out_found
    bounds = torch.empty((-(-n // TILE) + 1,), dtype=torch.int32, device=queries.device)
    build.launch(
        _launcher(),
        [table_keys.data_ptr(), table_vals.data_ptr(), queries.data_ptr(),
         out_vals.data_ptr(), out_found.data_ptr(), bounds.data_ptr()],
        [n, C, V],
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _MERGE.launches += 2
    return out_vals, out_found


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
merge_lookup.launches = 0
_MERGE = merge_lookup
