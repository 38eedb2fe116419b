"""Hash probe — batched lookups into an ``ht_linear`` table, as a
hand-written Hopper kernel (``csrc/hash_probe.cu``).

Replaces ``repro/kernels/hash_probe.py:hash_probe``.  One thread a query
reads its home slot's key, walks the rest of its linear-probe chain (four
aligned slots a load) only where the home key is another one, at most
``max_probes`` slots, then gathers the value row of the slot that holds
the key (zeros for a miss); queries and outputs stream past L2 while the
table is read under an evict-last policy where it is a large share of L2
(:func:`probe_path`), and a warp writes V > 1 value rows together.
The plain twin, :func:`hash_probe_plain`, is the reference's
``ref.hash_probe``: ``dicts.base.generic_lookup`` with ``ht_linear``'s probe
sequence and the same bound; the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dicts import base as dbase
from repro_torch.dicts import ht_linear
from repro_torch.dicts.ht_linear import MAX_PROBES  # covers the deepest chain the family's build places

from . import build


def hash_probe_plain(table_keys, table_vals, queries, max_probes: int = MAX_PROBES) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V], found [n])``: linear probing from ``hash1(q)`` until
    the key or EMPTY, at most ``max_probes`` slots; misses give zero rows."""
    table = dbase.HashTable(table_keys, table_vals, max_probes - 1)
    return dbase.generic_lookup(table, queries, ht_linear._probe(table_keys.shape[0]), max_probes)


def check_table(what, keys, vals, queries):
    """Device, dtype and shape checks shared by the lookup kernels."""
    if not (keys.is_cuda and vals.is_cuda and keys.device == queries.device == vals.device):
        raise ValueError(f"{what}: all tensors must be on one CUDA device")
    if keys.dtype != torch.int32 or queries.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"{what} takes int32 keys/queries and float32 values")
    C = keys.shape[0]
    if keys.dim() != 1 or queries.dim() != 1 or vals.dim() != 2 or vals.shape[0] != C or C < 1:
        raise ValueError(f"{what}: keys must be [C>=1], vals [C, V], queries [n]; got "
                         f"{tuple(keys.shape)}, {tuple(vals.shape)}, {tuple(queries.shape)}")


#: queries a launch takes: the kernel's indices are 32-bit
MAX_QUERIES = 2**31

def probe_path(C: int, V: int, l2_bytes: int) -> str:
    """``"hinted"`` where the table (keys and value rows) is larger than a
    quarter of L2: queries and outputs stream evict-first past a table read
    evict-last, which keeps more of it in L2 (8 % at SF 1's 33.5 MB table);
    ``"plain"`` for smaller tables, where the hints cost up to 6 % (the
    sweep's 8 MB tables; ``PERF.md`` §6)."""
    return "hinted" if C * (4 + 4 * V) > l2_bytes // 4 else "plain"


def check_launch(C: int, n: int) -> None:
    """The kernel's own limits: ``C`` a power of two (the chain wraps by a
    mask) and fewer than 2^31 queries (its indices are 32-bit)."""
    if C & (C - 1):
        raise ValueError(f"hash_probe: capacity must be a power of two, got {C}")
    if n >= MAX_QUERIES:
        raise ValueError(f"hash_probe: the kernel indexes queries in 32 bits, got {n} >= 2^31")


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "hash_probe.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("hash_probe", src), "hash_probe_launch")
    return _LIB["fn"]


def hash_probe(table_keys, table_vals, queries, max_probes: int = MAX_PROBES) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V] float32, found [n] bool)`` of ``queries`` in an
    ``ht_linear`` table (``C`` a power of two).  CPU tensors take
    :func:`hash_probe_plain`; CUDA tensors launch the kernel or raise."""
    if not queries.is_cuda:
        return hash_probe_plain(table_keys, table_vals, queries, max_probes)
    check_table("hash_probe", table_keys, table_vals, queries)
    C, V = table_vals.shape
    n = queries.shape[0]
    check_launch(C, n)
    table_keys, table_vals, queries = table_keys.contiguous(), table_vals.contiguous(), queries.contiguous()
    out_vals = torch.empty((n, V), dtype=torch.float32, device=queries.device)
    out_found = torch.empty((n,), dtype=torch.bool, device=queries.device)
    if n == 0:
        return out_vals, out_found
    build.launch(
        _launcher(),
        [table_keys.data_ptr(), table_vals.data_ptr(), queries.data_ptr(),
         out_vals.data_ptr(), out_found.data_ptr()],
        [n, C, V, max_probes,
         int(probe_path(C, V, torch.cuda.get_device_properties(queries.device).L2_cache_size) == "hinted")],
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    _PROBE.launches += 1
    return out_vals, out_found


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
hash_probe.launches = 0
_PROBE = hash_probe
