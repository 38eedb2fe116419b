"""Merge lookup — sorted probes into a sorted dictionary (the paper's hinted
lookup), as a hand-written Hopper kernel (``csrc/merge_lookup.cu``).

Replaces ``repro/kernels/merge_lookup.py:merge_lookup``.  Every 512-query
block stages its ``2·WINDOW``-key table window (keys and values) in shared
memory and binary-searches there; a block whose window does not cover its
queries searches the whole table instead.  The plain twin,
:func:`merge_lookup_plain`, is the same function (a lower-bound lookup with
the PAD tail clamp) in PyTorch; the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

QUERY_BLOCK = 512
WINDOW = 2048  # table keys per window row; a block sees two rows
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use


def merge_lookup_plain(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower-bound lookup of ``queries`` (any order) in the sorted,
    PAD-tailed ``table_keys``; misses give zero rows."""
    C = table_keys.shape[0]
    idx = torch.clamp(torch.searchsorted(table_keys, queries, side="left"), max=C - 1)
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
    tensors launch the kernel or raise."""
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
    if 2 * WINDOW * 4 * (1 + V) > _SMEM_LIMIT:
        raise ValueError(f"merge_lookup: V={V} value lanes exceed one block's shared memory")
    table_keys, table_vals, queries = (
        table_keys.contiguous(), table_vals.contiguous(), queries.contiguous()
    )
    out_vals = torch.empty((n, V), dtype=torch.float32, device=queries.device)
    out_found = torch.empty((n,), dtype=torch.bool, device=queries.device)
    if n == 0:
        return out_vals, out_found
    build.launch(
        _launcher(),
        [table_keys.data_ptr(), table_vals.data_ptr(), queries.data_ptr(),
         out_vals.data_ptr(), out_found.data_ptr()],
        [n, C, V],
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _MERGE.launches += 1
    return out_vals, out_found


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
merge_lookup.launches = 0
_MERGE = merge_lookup
