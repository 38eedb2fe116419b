"""Hash build — batched insert-aggregate into an empty ``ht_linear`` table,
as a hand-written Hopper kernel (``csrc/hash_build.cu``).

Replaces ``repro/kernels/hash_build.py:hash_build``.  One thread a row
claims its slot with ``atomicCAS`` (a CAS lost to the same key joins it)
and adds the row's sum lanes with ``atomicAdd``; rows still pending after
``max_probes`` slots are dropped, as in the reference.  The plain twin,
:func:`hash_build_plain`, is ``dicts.base.generic_insert`` into an empty
table with the same bound; the wrapper takes it only for CPU tensors.
Slot layouts differ between the two (the order of claims), key sets do not.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.dicts import base as dbase
from repro_torch.dicts import ht_linear

from . import build

MAX_PROBES = 32  # the reference kernel's default bound


def _empty(capacity: int, V: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((capacity,), dbase.EMPTY, dtype=torch.int32, device=device),
            torch.zeros((capacity, V), dtype=torch.float32, device=device))


def hash_build_plain(keys, vals, capacity: int, max_probes: int = MAX_PROBES,
                     valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table_keys [C], table_vals [C, V])``: rows (where ``valid``) summed
    per key into an empty linear-probe table; rows pending after
    ``max_probes`` slots are dropped."""
    tk, tv = _empty(capacity, vals.shape[1], keys.device)
    t = dbase.generic_insert(dbase.HashTable(tk, tv, 0), keys, vals, ht_linear._probe(capacity), max_probes, valid=valid)
    return t.keys, t.vals


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "hash_build.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("hash_build", src), "hash_build_launch")
    return _LIB["fn"]


def hash_build(keys, vals, capacity: int, max_probes: int = MAX_PROBES,
               valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table_keys [C] int32, table_vals [C, V] float32)`` from ``keys
    [N]`` int32 and ``vals [N, V]`` float32, duplicate keys summed;
    ``capacity`` a power of two, ``valid`` an optional ``[N]`` bool row mask.
    CPU tensors take :func:`hash_build_plain`; CUDA tensors launch the kernel
    or raise."""
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
    tk, tv = _empty(capacity, V, dev)
    if n == 0:
        return tk, tv
    keys, vals = keys.contiguous(), vals.contiguous()
    valid = None if valid is None else valid.contiguous()
    build.launch(
        _launcher(),
        [keys.data_ptr(), vals.data_ptr(), 0 if valid is None else valid.data_ptr(),
         tk.data_ptr(), tv.data_ptr()],
        [n, capacity, V, max_probes],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _BUILD.launches += 1
    return tk, tv


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
hash_build.launches = 0
_BUILD = hash_build
