"""Column-store tables + statistics collection (PyTorch twin of
``repro.data.table``).

A ``Table`` is a dict of equal-length torch columns on one device plus an
optional selection mask (static-shape filtering: rows are masked, never
compacted).  String columns are dictionary-encoded to int32 at load time.
``collect_stats`` builds the Σ statistics Algorithm 1 consumes from the
actual data.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cardinality import CardModel, ColumnStats, RelStats
from repro_torch.dicts import base as dbase


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises when no CUDA device exists and none was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass
class Table:
    columns: Dict[str, torch.Tensor]
    nrows: int
    mask: Optional[torch.Tensor] = None  # bool [nrows]; None = all live
    sorted_on: Tuple[str, ...] = ()

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def names(self) -> Tuple[str, ...]:
        return tuple(self.columns)

    @property
    def device(self) -> torch.device:
        return next(iter(self.columns.values())).device

    def live_mask(self) -> torch.Tensor:
        if self.mask is None:
            return torch.ones((self.nrows,), dtype=torch.bool, device=self.device)
        return self.mask

    def with_mask(self, mask: torch.Tensor) -> "Table":
        new = mask if self.mask is None else (self.mask & mask)
        return replace(self, mask=new)

    def multiplicity(self) -> torch.Tensor:
        """Bag multiplicity column (1.0 for live rows, 0.0 for masked)."""
        return self.live_mask().to(torch.float32)

    def to(self, device) -> "Table":
        return Table(
            {k: v.to(device) for k, v in self.columns.items()},
            self.nrows,
            None if self.mask is None else self.mask.to(device),
            self.sorted_on,
        )


def from_numpy(cols: Dict[str, np.ndarray], sorted_on: Sequence[str] = (), device=None) -> Table:
    dev = resolve_device(device)
    n = len(next(iter(cols.values())))
    out = {}
    for k, v in cols.items():
        v = np.asarray(v)
        if v.dtype.kind in "iu":
            a = v.astype(np.int32)
        elif v.dtype.kind == "f":
            a = v.astype(np.float32)
        elif v.dtype.kind in "US O":  # strings -> dictionary-encode
            _, codes = np.unique(v, return_inverse=True)
            a = codes.astype(np.int32)
        else:
            raise TypeError(f"unsupported column dtype {v.dtype} for {k}")
        if len(v) != n:
            raise ValueError(f"ragged column {k}")
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return Table(out, n, sorted_on=tuple(sorted_on))


def to_numpy(a) -> np.ndarray:
    """Host copy of a column (tensor on any device, or array-like)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# key packing: compound keys -> single int32
# ---------------------------------------------------------------------------


def pack_keys(table: Table, cols: Sequence[str], domains: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """Pack the named columns into one int32 key: exact arithmetic packing
    when the product of domains fits 31 bits, hash mixing otherwise."""
    if len(cols) == 1:
        return table.col(cols[0]).to(torch.int32)
    doms = []
    for c in cols:
        d = (domains or {}).get(c)
        if d is None:
            d = int(table.col(c).max()) + 1
        doms.append(max(d, 1))
    total = 1
    for d in doms:
        total *= d
    if total < 2**31:
        key = torch.zeros((table.nrows,), dtype=torch.int32, device=table.device)
        for c, d in zip(cols, doms):
            key = key * d + table.col(c).to(torch.int32)
        return key
    key = torch.zeros((table.nrows,), dtype=torch.int64, device=table.device)
    for c in cols:
        signed = torch.where(key >= 2**31, key - 2**32, key).to(torch.int32)
        key = dbase._mix(signed ^ table.col(c).to(torch.int32), dbase._H1)
    return (key & 0x7FFFFFFF).to(torch.int32)


# ---------------------------------------------------------------------------
# Σ statistics from real data
# ---------------------------------------------------------------------------


def table_stats(t: Table) -> RelStats:
    cols = {}
    mask = None if t.mask is None else to_numpy(t.mask)
    for name, arr in t.columns.items():
        a = to_numpy(arr)
        if mask is not None:
            a = a[mask]
        if len(a) == 0:
            cols[name] = ColumnStats(distinct=0, lo=0.0, hi=0.0)
            continue
        cols[name] = ColumnStats(
            distinct=float(len(np.unique(a))),
            lo=float(a.min()),
            hi=float(a.max()),
        )
    rows = float(t.nrows if mask is None else int(mask.sum()))
    return RelStats(rows=rows, columns=cols, sorted_on=t.sorted_on)


def collect_stats(tables: Dict[str, Table]) -> CardModel:
    """Σ from the actual data."""
    return CardModel({name: table_stats(t) for name, t in tables.items()})
