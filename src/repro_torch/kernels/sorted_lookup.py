"""Sorted lookup — probes in any order into a sorted dictionary, as a
hand-written Hopper kernel (``csrc/sorted_lookup.cu``).

Replaces ``repro/kernels/sorted_lookup.py:sorted_lookup``.  Where the
probes are many enough to pay for it (:func:`search_path`), the search's
top levels run in shared memory: a table of at most :data:`SAMPLE_KEYS`
keys is staged whole; a larger one is sampled first (one small launch:
every ``S``-th of its ``L`` keys below PAD, ``S`` from
:func:`sample_stride`), and each probe finds its sample bucket on chip,
then its lower bound among the ``S - 1`` keys of that bucket in global
memory.  Fewer probes search the whole array in global memory, one thread
a probe.  The plain twin,
:func:`sorted_lookup_plain`, is the same function (``dicts.base``'s
``searchsorted``, clamp, compare, gather); with ``stride=`` it builds the
kernel's sample and searches bucket by bucket with its fixed, branchless
rounds instead.  The wrapper takes the twin only for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dicts import base as dbase

from . import build
from .hash_probe import check_table

SAMPLE_KEYS = 49152  # keys one block holds in shared memory (csrc/sorted_lookup.cu)
BLOCK = 1024  # the staged search's threads a block, one block an SM (csrc/sorted_lookup.cu)
# the staged search needs a block's probes to number at least 1/STAGE_SHARE
# of the keys it stages (measured on an H100: tools/lookup_timings.py)
STAGE_SHARE = 16


def sample_stride(live: int, stride: int = 1) -> int:
    """The sample's stride over ``live`` keys: the least power of two that
    leaves at most :data:`SAMPLE_KEYS` samples, and at least ``stride``."""
    S = 1
    while -(-live // S) > SAMPLE_KEYS:
        S <<= 1
    return max(S, stride)


def search_path(n: int, C: int, sms: int) -> str:
    """The kernel's path for ``n`` probes into ``C`` keys on a card of
    ``sms`` SMs: ``"global"`` (one thread a probe in global memory) unless
    each SM's block would search at least :data:`BLOCK` probes and
    ``1/STAGE_SHARE`` of the keys it stages; then ``"table"`` (the whole
    table staged, ``C <= SAMPLE_KEYS``) or ``"sampled"`` (the sample
    launch, then the search over it)."""
    staged = min(C, SAMPLE_KEYS)
    if n < sms * max(BLOCK, staged // STAGE_SHARE):
        return "global"
    return "table" if C <= SAMPLE_KEYS else "sampled"


def _branchless(key_at, lo, hi, q, rounds):
    """The kernel's search: ``rounds`` fixed rounds, each reading
    ``key_at(mid)`` and moving ``lo`` or ``hi`` by the compare."""
    for _ in range(rounds):
        mid = (lo + hi) >> 1
        right = key_at(mid) < q
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    return lo


def sorted_lookup_plain(table_keys, table_vals, queries, *, stride=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V], found [n])`` of ``queries`` in the ascending,
    PAD-tailed ``table_keys``: the lower bound, clamped to ``C - 1``, a
    compare, the value row where the keys are equal (zeros elsewhere).

    Without ``stride`` one ``searchsorted`` finds the bounds.  With it the
    twin runs the kernel's search: ``stride=1`` takes the kernel's own
    choice (a table of at most :data:`SAMPLE_KEYS` keys is its own sample,
    ``S = 1``, ``L = C``; a larger one is sampled), a larger ``stride``
    samples any table at least that sparsely.  Sampled, ``L`` counts the
    keys below PAD, the sample holds every ``S``-th of them,
    ``S = sample_stride(L, stride)``, and a probe's lower bound ``b`` in the
    sample (``M.bit_length()`` rounds) brackets its lower bound to keys
    ``((b - 1) S, min(b S, L)]``, searched in ``(S - 1).bit_length()``
    rounds."""
    if stride is None:
        return dbase.sorted_lookup(table_keys, table_vals, queries)
    if stride < 1:
        raise ValueError(f"sorted_lookup_plain: stride={stride} is below 1")
    C = table_keys.shape[0]
    q = queries.to(torch.int32)
    if stride == 1 and C <= SAMPLE_KEYS:
        L, S = C, 1
    else:
        L = int(torch.searchsorted(table_keys, torch.tensor([dbase.PAD], dtype=table_keys.dtype,
                                                             device=table_keys.device)))
        S = sample_stride(L, stride)
    sample = table_keys[:L:S]
    M = sample.shape[0]
    zero = torch.zeros_like(q, dtype=torch.int64)
    b = _branchless(lambda i: sample[torch.clamp(i, max=M - 1)], zero, zero + M, q, M.bit_length())
    b = torch.clamp(b, max=M)
    lo = torch.where(b > 0, (b - 1) * S + 1, 0)
    hi = torch.where(b > 0, torch.clamp(b * S, max=L), 0)
    lo = _branchless(lambda i: table_keys[torch.clamp(i, max=C - 1)], lo, hi, q, (S - 1).bit_length())
    idx = torch.clamp(lo, max=C - 1)
    found = table_keys[idx] == q
    return dbase.gather_rows(table_vals, idx, found), found


_LIB = {}
_PATHS = ("global", "table", "sampled")  # the launcher's path codes


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "sorted_lookup.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("sorted_lookup", src), "sorted_lookup_launch")
    return _LIB["fn"]


def sorted_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals [n, V] float32, found [n] bool)``; probes in any order.  CPU
    tensors take :func:`sorted_lookup_plain`; CUDA tensors launch the kernel
    on the path :func:`search_path` picks (the sample launch first where
    the table is sampled, each launch counted) or raise."""
    if not queries.is_cuda:
        return sorted_lookup_plain(table_keys, table_vals, queries)
    check_table("sorted_lookup", table_keys, table_vals, queries)
    C, V = table_vals.shape
    if C >= 2**30:
        raise ValueError(f"sorted_lookup: C={C} keys overflow the search's int32 bracket")
    table_keys, table_vals, queries = table_keys.contiguous(), table_vals.contiguous(), queries.contiguous()
    n = queries.shape[0]
    dev = queries.device
    out_vals = torch.empty((n, V), dtype=torch.float32, device=dev)
    out_found = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out_vals, out_found
    path = search_path(n, C, torch.cuda.get_device_properties(dev).multi_processor_count)
    # the header (4 int32), then the sample
    scratch = torch.empty((4 + SAMPLE_KEYS,), dtype=torch.int32, device=dev) if path == "sampled" else None
    build.launch(
        _launcher(),
        [table_keys.data_ptr(), table_vals.data_ptr(), queries.data_ptr(),
         out_vals.data_ptr(), out_found.data_ptr(), 0 if scratch is None else scratch.data_ptr()],
        [n, C, V, _PATHS.index(path)],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _LOOKUP.launches += 2 if path == "sampled" else 1
    return out_vals, out_found


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
sorted_lookup.launches = 0
_LOOKUP = sorted_lookup
