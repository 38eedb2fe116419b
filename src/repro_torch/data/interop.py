"""Conversion of the reference package's data into port objects.

Duck-typed: reads ``.columns``, ``.mask``, ``.nrows``, ``.sorted_on`` (and
a built dictionary's NamedTuple fields) through ``np.asarray`` — nothing of
the reference package is imported, so the port stays free of it while the
tests feed both packages the same bytes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry

from .table import Table, resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def from_reference(tables: Dict[str, object], device=None) -> Dict[str, Table]:
    """``{name: reference Table}`` -> ``{name: port Table}`` on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, t in tables.items():
        mask = None if t.mask is None else _tensor(t.mask, dev).to(torch.bool)
        out[name] = Table(
            {c: _tensor(a, dev) for c, a in t.columns.items()},
            int(t.nrows),
            mask,
            tuple(t.sorted_on),
        )
    return out


def dict_from_reference(ds: str, table, device=None):
    """A reference ``HashTable``/``SortedTable`` built under ``ds`` -> the
    port's NamedTuple, so one built dictionary is probed in both packages."""
    dev = resolve_device(device)
    if registry.family(ds) == "hash":
        return dbase.HashTable(
            _tensor(table.keys, dev), _tensor(table.vals, dev), int(np.asarray(table.max_t))
        )
    return dbase.SortedTable(
        _tensor(table.keys, dev),
        _tensor(table.vals, dev),
        int(np.asarray(table.n)),
        _tensor(table.block_max, dev),
    )
