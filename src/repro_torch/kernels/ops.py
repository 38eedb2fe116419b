"""Kernel dispatch — the single entry point the engine uses (the twin of
``repro.kernels.ops``).

Policy: a CUDA tensor goes to the hand-written kernel, a CPU tensor to its
plain PyTorch twin; the kernels' own structural preconditions (the same
rules as the reference) route to the plain lookup on either device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import merge_lookup as _ml
from . import ref


def merge_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probes MUST be non-decreasing (the hinted-lookup contract).  Tables
    smaller than two windows take the plain lookup, as in the reference."""
    if table_keys.shape[0] >= 2 * _ml.WINDOW:
        return _ml.merge_lookup(table_keys, table_vals, queries)
    return ref.merge_lookup(table_keys, table_vals, queries)
