"""Plain PyTorch definitions the dispatch layer uses where a kernel's
structural precondition does not hold (the twin of ``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Tuple

import torch

from .decode import decode_plain
from .merge_lookup import merge_lookup_plain
from .segment_reduce import segment_reduce_plain


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
