"""Compute/communication overlap helpers (the twin of
``repro.sharding.overlap``).

``ring_allgather_matmul`` computes ``all_gather(X) @ w`` as a ring: each
step multiplies the chunk in hand and writes it at its source shard's rows,
then a permute to shard ``i + 1`` moves the chunks around the ring.  This
is the TP-overlap primitive for a column-parallel layer consuming
row-sharded activations.

One controller drives every shard (``exec.distributed``): the arguments
are per-shard lists in mesh order and so is the result.  With the shards on
distinct cards a permute is a peer-to-peer copy queued behind the matmul
that produced nothing it reads, so the copy can run beside the next
matmul; with all shards on one card it is a copy within the card, and
there is no traffic between cards to hide.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.exec import distributed as D


def ring_allgather_matmul(x_locals: List[torch.Tensor], w: torch.Tensor, mesh: D.Mesh,
                          axis: D.Axis) -> List[torch.Tensor]:
    """``x_locals[s]``: shard ``s``'s ``[m_loc, K]`` rows of a row-sharded X;
    ``w``: ``[K, N]``, replicated.  Returns, per shard, ``all_gather(X) @
    w`` = ``[m_loc · n, N]`` over the shard's group along ``axis``, built in
    ``n`` steps of ``chunk @ w`` written at the rows of the shard that
    produced the chunk, each followed by a permute to the next shard."""
    n = mesh.axis_size(axis)
    pos = {s: i for group in mesh.groups(axis) for i, s in enumerate(group)}
    m_loc = x_locals[0].shape[0]
    ws = [w.to(dev) for dev in mesh.devices]
    outs = [torch.zeros((n * m_loc, w.shape[1]), dtype=w.dtype, device=dev) for dev in mesh.devices]
    perm = [(i, (i + 1) % n) for i in range(n)]
    chunks = list(x_locals)
    for step in range(n):
        for s, chunk in enumerate(chunks):
            src = (pos[s] - step) % n  # the chunk now held came from this position
            outs[s][src * m_loc:(src + 1) * m_loc] = chunk @ ws[s]
        chunks = D.ppermute(chunks, mesh, axis, perm)
    return outs


def allgather_matmul_reference(x_locals: List[torch.Tensor], w: torch.Tensor, mesh: D.Mesh,
                               axis: D.Axis) -> List[torch.Tensor]:
    """The unoverlapped form: a tiled all-gather of X, then one matmul a
    shard."""
    return [xg @ w.to(xg.device) for xg in D.all_gather(list(x_locals), mesh, axis)]
