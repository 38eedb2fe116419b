"""Plain PyTorch definitions the dispatch layer uses where a kernel's
structural precondition does not hold (the twin of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Tuple

import torch

from . import hash_build as _hb
from . import hash_probe as _hp
from .decode import decode_plain
from .hash_build import hash_build_plain
from .hash_probe import hash_probe_plain
from .merge_lookup import merge_lookup_plain
from .segment_reduce import segment_reduce_plain
from .sorted_lookup import sorted_lookup_plain


def hash_probe(table_keys, table_vals, queries, max_probes: int = _hp.MAX_PROBES) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear probing from ``hash1(q)`` until the key or EMPTY, at most
    ``max_probes`` slots (covers ``ht_linear``'s build chains); misses give
    zero rows."""
    return hash_probe_plain(table_keys, table_vals, queries, max_probes)


def sorted_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower bound, clamped to ``C - 1``, compare, gather; any probe order."""
    return sorted_lookup_plain(table_keys, table_vals, queries)


def hash_build(keys, vals, capacity: int, max_probes: int = _hb.MAX_PROBES, valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-based insert-aggregate (``dicts.base.generic_insert``) into an
    empty linear-probe table; rows pending after ``max_probes`` are dropped."""
    return hash_build_plain(keys, vals, capacity, max_probes, valid)


def merge_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """A lower-bound lookup in any probe order; sorted probes only change cost."""
    return merge_lookup_plain(table_keys, table_vals, queries)


def segment_reduce(keys, vals) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run totals at run ends over sorted keys; PAD rows are never run ends."""
    return segment_reduce_plain(keys, vals)


def decode(code, payload, out_rows) -> torch.Tensor:
    """Shift-and-mask unpack, a gather for dictionary codes, ``searchsorted``
    over the run ends for RLE; rows past ``n`` repeat row ``n - 1``."""
    return decode_plain(code, payload, out_rows)


def flash_attention(q, k, v, causal: bool = True, window: int = 0, kv_valid=None) -> torch.Tensor:
    """Softmax attention, dense: ``q [B, H, Tq, D]``, ``k``, ``v [B, H, Tk,
    D]`` (heads already matched), query rows aligned to the end of the keys;
    ``kv_valid`` (a count, a Python int or a 0-d tensor) masks the key slots
    at and past it.  A row with no visible key returns 0."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    Tq, Tk = q.shape[2], k.shape[2]
    qi = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    ki = torch.arange(Tk, device=q.device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= ki > qi - window
    if kv_valid is not None:
        mask = mask & (ki < kv_valid)
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def flash_attention_chunked(q, k, v, causal: bool = True, window: int = 0, chunk: int = 1024,
                            kv_valid=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks, the same function as
    :func:`flash_attention` with ``O(Tq · chunk)`` temporaries.  GQA-native:
    ``k``, ``v`` keep their ``Hkv`` heads and ``q`` is viewed as ``[B, Hkv,
    g, Tq, D]``, so K/V are never repeated to ``H`` heads."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, Tq, D)
    scale = D ** -0.5
    qi = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    m = torch.full((B, Hkv, g, Tq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, g, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, g, Tq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Tk, chunk):
        kb, vb = k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb).float() * scale
        ki = torch.arange(c0, c0 + kb.shape[2], device=q.device)[None, :]
        msk = torch.ones((Tq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            msk &= ki <= qi
        if window > 0:
            msk &= ki > qi - window
        if kv_valid is not None:
            msk = msk & (ki < kv_valid)
        s = torch.where(msk, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(m_new[..., None] <= -5e29, 0.0, torch.exp(s - m_new[..., None]))
        alpha = torch.where(m_new <= -5e29, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb.float())
        m = m_new
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom[..., None]).reshape(B, H, Tq, D).to(q.dtype)


def attention_route(q, k, v, causal: bool = True, window: int = 0, kv_valid=None) -> torch.Tensor:
    """The reference's plain attention route (``repro/kernels/ops.py:92-104``)
    for ``q [B, H, Tq, D]`` over ``k``, ``v [B, Hkv, Tk, D]``: the chunked
    online softmax above 2,048 key slots (K/V stay at ``Hkv`` heads), else
    the dense softmax over K/V repeated to ``H`` heads."""
    if k.shape[2] > 2048:
        return flash_attention_chunked(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return flash_attention(q, k, v, causal=causal, window=window, kv_valid=kv_valid)
