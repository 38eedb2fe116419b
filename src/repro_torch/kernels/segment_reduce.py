"""Segment reduce — per-run sums over sorted keys (the sort-based group-by of
in-DB ML), as a hand-written Hopper kernel (``csrc/segment_reduce.cu``).

Replaces ``repro/kernels/segment_reduce.py:segment_reduce``.  A tile pass
scans each 1024-row tile (segmented scan per value lane, run totals at run
ends), and a carry pass adds the partial sums of runs that cross tiles to
the first run end of the tile they close in.  The plain twin,
:func:`segment_reduce_plain`, is the same function (run ids, one
``index_add_``, a gather at run ends) in PyTorch; the wrapper takes it only
for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dicts import base as dbase

from . import build

TILE = 1024  # rows per tile of the tile pass (csrc/segment_reduce.cu)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def segment_reduce_plain(keys, vals) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sums [n, V], ends [n] bool)`` for ``keys`` sorted ascending with a
    PAD tail: ``sums[i]`` is the total of the run ending at row ``i`` where
    ``ends[i]``, zero elsewhere; PAD rows are never run ends."""
    n, V = vals.shape
    dev = keys.device
    if n == 0:
        return torch.zeros((0, V), dtype=vals.dtype, device=dev), torch.zeros((0,), dtype=torch.bool, device=dev)
    live = keys != dbase.PAD
    differs = keys[:-1] != keys[1:]
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    ends = torch.cat([differs, one]) & live
    heads = torch.cat([one, differs]) & live
    seg = torch.cumsum(heads.to(torch.int64), 0) - 1
    seg = torch.where(live, seg, n)
    totals = torch.zeros((n + 1, V), dtype=vals.dtype, device=dev)
    totals.index_add_(0, seg, torch.where(live[:, None], vals, torch.zeros((), dtype=vals.dtype, device=dev)))
    sums = torch.where(ends[:, None], totals[torch.clamp(seg, max=n - 1)], torch.zeros((), dtype=vals.dtype, device=dev))
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
    if TILE * V * 4 > _SMEM_LIMIT:
        raise ValueError(f"segment_reduce: V={V} value lanes exceed one block's shared memory")
    dev = keys.device
    sums = torch.empty((n, V), dtype=torch.float32, device=dev)
    ends = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return sums, ends
    T = -(-n // TILE)
    tile_ints = torch.empty((4, T), dtype=torch.int32, device=dev)  # first/last key, open, first end
    tail = torch.empty((T, V), dtype=torch.float32, device=dev)
    build.launch(
        _launcher(),
        [keys.data_ptr(), vals.data_ptr(), sums.data_ptr(), ends.data_ptr(),
         tile_ints[0].data_ptr(), tile_ints[1].data_ptr(), tile_ints[2].data_ptr(),
         tile_ints[3].data_ptr(), tail.data_ptr()],
        [n, V],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _SEGMENT.launches += 1
    return sums, ends


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
segment_reduce.launches = 0
_SEGMENT = segment_reduce
