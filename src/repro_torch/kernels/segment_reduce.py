"""Segment reduce — per-run sums over sorted keys (the sort-based group-by of
in-DB ML), as a hand-written Hopper kernel (``csrc/segment_reduce.cu``).

Replaces ``repro/kernels/segment_reduce.py:segment_reduce``.  One launch:
each block claims the next 4,096-row tile from a counter, sums its rows run
by run, scans its threads' ``(has_end, tail)`` descriptors in one
block-wide segmented scan over all V lanes, and carries the run that
enters the tile from the tiles before it by decoupled look-back over their
published descriptors (:func:`combine`), adding it to the tile's first run
end.  The plain twin, :func:`segment_reduce_plain`, models that algorithm
tile by tile in vectorised PyTorch; the wrapper takes it only for CPU
tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dicts import base as dbase

from . import build

THREADS, ROWS = 256, 16  # a block's threads and each thread's rows (csrc/segment_reduce.cu)
TILE = THREADS * ROWS  # rows a block claims
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def smem_bytes(V: int) -> int:
    """Shared memory of one block at ``V`` value lanes: the tile's values,
    each thread's 16 rows padded by 16 bytes, plus the scan's scratch (the
    tile id, 8 warps' flags and lane sums, the carry)."""
    return THREADS * (4 * V + 1) * 16 + 8 + 4 * 8 + 4 * 8 * V + 4 * V


#: the most value lanes the kernel takes: its staged tile fills one block's shared memory
MAX_V = max(V for V in range(1, 64) if smem_bytes(V) <= _SMEM_LIMIT)


def combine(prev, cur):
    """The look-back's operator on tile descriptors ``(has_end, tail)``:
    ``cur`` when it holds a run end, else ``prev``'s flag or'd in and its
    tail added.  Associative, so the kernel's tiles may combine in any
    grouping; ``has_end`` is a bool tensor, ``tail`` a tensor whose first
    dimensions match it."""
    f0, x0 = prev
    f1, x1 = cur
    keep = f1.reshape(f1.shape + (1,) * (x1.dim() - f1.dim()))
    return f0 | f1, torch.where(keep, x1, x0 + x1)


def segment_reduce_plain(keys, vals, *, tile=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums [n, V], ends [n] bool)`` for ``keys`` sorted ascending with a
    PAD tail: ``sums[i]`` is the total of the run ending at row ``i`` where
    ``ends[i]``, zero elsewhere; PAD rows are never run ends.

    It models the kernel's look-back over tiles of ``tile`` rows (``None``:
    the kernel's :data:`TILE`), vectorised, with no loop over tiles: each run
    end's part inside its tile, each tile's descriptor ``(has_end, tail)``,
    their exclusive prefix under :func:`combine` as the carry into each
    tile (the tails since the last tile before it with a run end), added at
    the tile's first run end.  Sums are taken as float64 prefix
    differences, then rounded to ``vals.dtype``."""
    n, V = vals.shape
    dev = keys.device
    if n == 0:
        return torch.zeros((0, V), dtype=vals.dtype, device=dev), torch.zeros((0,), dtype=torch.bool, device=dev)
    tile = tile or TILE
    live = keys != dbase.PAD
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    ends = torch.cat([keys[:-1] != keys[1:], one]) & live
    f64 = torch.float64

    def prefix(x):  # [V, m] -> [V, m + 1]: the sums of the first i columns (scans along the inner dim)
        return torch.cat([torch.zeros((V, 1), dtype=f64, device=dev), torch.cumsum(x, 1)], 1)

    # lane-major: rows < i of each lane
    cs = prefix(torch.where(live, vals.t(), torch.zeros((), dtype=vals.dtype, device=dev)).to(f64))
    idx = torch.arange(n, device=dev)
    last_end = torch.cummax(torch.where(ends, idx, -1), 0).values  # the last end at or before each row
    prev_end = torch.cat([torch.full((1,), -1, dtype=last_end.dtype, device=dev), last_end[:-1]])
    start = idx - idx % tile  # each row's tile start
    # a run end's rows inside its tile
    part = cs[:, idx + 1] - cs[:, torch.maximum(prev_end + 1, start)]
    # tile descriptors: whether the tile holds an end, the rows after its last end
    T = -(-n // tile)
    bt = torch.arange(T, device=dev)
    t0 = bt * tile
    t1 = torch.clamp(t0 + tile, max=n)
    lei = last_end[t1 - 1]
    has_end = lei >= t0
    tail = cs[:, t1] - cs[:, torch.maximum(lei + 1, t0)]
    # the carry into tile b, the exclusive prefix of the tiles before it:
    # the tails of tiles L .. b-1, L the last tile before b with an end (else 0)
    tc = prefix(tail)
    last_with_end = torch.cummax(torch.where(has_end, bt, -1), 0).values
    lo = torch.clamp(torch.cat([torch.full((1,), -1, dtype=bt.dtype, device=dev), last_with_end[:-1]]), min=0)
    carry = tc[:, bt] - tc[:, lo]
    del cs, tc
    first_in_tile = ends & (prev_end < start)  # the tile's first run end takes the carry
    part += torch.where(first_in_tile, carry[:, idx // tile], torch.zeros((), dtype=f64, device=dev))
    sums = torch.where(ends, part, torch.zeros((), dtype=f64, device=dev)).to(vals.dtype).t().contiguous()
    return sums, ends


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "segment_reduce.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("segment_reduce", src), "segment_reduce_launch")
    return _LIB["fn"]


def segment_reduce(keys, vals) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums [n, V] float32, ends [n] bool)`` over ``keys`` sorted
    ascending (PAD tail allowed).  CPU tensors take
    :func:`segment_reduce_plain`; CUDA tensors launch the kernel or raise."""
    if not (keys.is_cuda or vals.is_cuda):
        return segment_reduce_plain(keys, vals)
    if not (keys.is_cuda and vals.is_cuda and vals.device == keys.device):
        raise ValueError("segment_reduce: keys and vals must be on one CUDA device")
    if keys.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError("segment_reduce takes int32 keys and float32 values")
    if keys.dim() != 1 or vals.dim() != 2 or vals.shape[0] != keys.shape[0] or vals.shape[1] < 1:
        raise ValueError(f"segment_reduce: keys must be [n], vals [n, V>=1]; got {tuple(keys.shape)}, {tuple(vals.shape)}")
    if not (keys.is_contiguous() and vals.is_contiguous()):
        raise ValueError("segment_reduce: keys and vals must be contiguous")
    n, V = vals.shape
    if V > MAX_V:
        raise ValueError(f"segment_reduce: V={V} value lanes exceed one block's shared memory (at most {MAX_V})")
    dev = keys.device
    sums = torch.empty((n, V), dtype=torch.float32, device=dev)
    ends = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return sums, ends
    T = -(-n // TILE)
    # the tile counter, then each tile's status word; the descriptors' values
    status = torch.zeros((1 + T,), dtype=torch.int32, device=dev)
    desc = torch.zeros((2, T, V), dtype=torch.float32, device=dev)  # aggregates, inclusive prefixes
    build.launch(
        _launcher(),
        [keys.data_ptr(), vals.data_ptr(), sums.data_ptr(), ends.data_ptr(), status.data_ptr(),
         desc[0].data_ptr(), desc[1].data_ptr()],
        [n, V],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _SEGMENT.launches += 1
    return sums, ends


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
segment_reduce.launches = 0
_SEGMENT = segment_reduce
