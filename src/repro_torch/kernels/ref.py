"""Plain PyTorch definitions the dispatch layer uses where a kernel's
structural precondition does not hold (the twin of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Tuple

import torch

from .merge_lookup import merge_lookup_plain


def merge_lookup(table_keys, table_vals, queries) -> Tuple[torch.Tensor, torch.Tensor]:
    """A lower-bound lookup in any probe order; sorted probes only change cost."""
    return merge_lookup_plain(table_keys, table_vals, queries)
