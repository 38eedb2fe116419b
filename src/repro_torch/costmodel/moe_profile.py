"""Learned MoE-dispatch cost model — the installation stage applied to the
LM side's dictionary choice (the twin of ``repro.costmodel.moe_profile``).

Profiles ``positions_sort`` against ``positions_scatter`` over (n_tokens,
n_experts) on the device it is given (the card unless the caller names
another), fits one knn4 regressor per strategy and stores them in that
device's store, ``store.default_dir(device)/moe_dispatch.npz``, under the
reference's keys (``"<strategy>::<state key>"``), so either package loads
the other's file.  ``models.moe.auto_dispatch`` consults
:func:`load_dispatch_model` for its tensors' device: the dispatch decision
is learned per machine, as the paper's dictionary choice is.

Timing protocol (``profiler.py``'s): one warm-up call, then the median of
``repeats`` eager calls, each ending in ``torch.cuda.synchronize()`` on the
card.

Divergences from the reference: a file that exists but cannot be read
raises (the reference's ``auto_dispatch`` swallows every exception of its
learned path and falls back); a loaded model is cached per file, keyed by
its modification time and size, so a layer call costs one ``os.stat``
rather than an ``np.load`` (the reference reads the file at every call);
:func:`install_dispatch` writes a temporary file beside the store's and
renames it onto it, so a process reading the store mid-install sees the old
file or the new one, never half of one.
"""
from __future__ import annotations

import os
import tempfile
import zipfile
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.table import resolve_device
from repro_torch.models import moe as M

from . import regression, store
from .profiler import _time_fn

_PATH = "moe_dispatch.npz"
STRATEGIES = ("sort", "scatter")
# path -> ((mtime_ns, size), model) of the file last read there
_CACHE: Dict[str, Tuple[Tuple[int, int], "DispatchModel"]] = {}


@dataclass
class DispatchModel:
    models: Dict[str, regression.Regressor]

    def choose(self, n_tokens: int, n_experts: int) -> str:
        X = regression.with_log_features(np.array([[float(n_tokens), float(n_experts)]]))
        t_sort = float(self.models["sort"].predict(X)[0])
        t_scatter = float(self.models["scatter"].predict(X)[0])
        return "sort" if t_sort <= t_scatter else "scatter"


def profile_dispatch(token_counts=(1024, 8192, 65536), expert_counts=(8, 32, 128), repeats: int = 3,
                     seed: int = 0, device=None):
    """``(strategy, n_tokens, n_experts, seconds)`` rows over the grid, the
    reference's numpy draws of expert ids on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = []
    for n in token_counts:
        for e in expert_counts:
            eid = torch.from_numpy(rng.integers(0, e, n).astype(np.int64)).to(dev)
            for name, fn in (("sort", M.positions_sort), ("scatter", M.positions_scatter)):
                rows.append((name, n, e, _time_fn(fn, eid, e, repeats=repeats, device=dev)))
    return rows


def _file(directory: Optional[str], device) -> str:
    return os.path.join(directory or store.default_dir(device), _PATH)


def install_dispatch(directory: Optional[str] = None, device=None, **kw) -> DispatchModel:
    """Profile on ``device``, fit knn4 per strategy, store it (in the
    device's store unless ``directory`` is given); always profiles afresh,
    as the reference does."""
    rows = profile_dispatch(device=device, **kw)
    models, blob = {}, {}
    for strat in STRATEGIES:
        sub = [(n, e, s) for name, n, e, s in rows if name == strat]
        X = regression.with_log_features(np.array([[n, e] for n, e, _ in sub], float))
        y = np.array([s for _, _, s in sub])
        models[strat] = regression.make("knn4").fit(X, y)
        for k, v in models[strat].to_state().items():
            blob[f"{strat}::{k}"] = np.asarray(v)
    path = _file(directory, device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".moe_dispatch.", suffix=".npz.tmp", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **blob)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    st = os.stat(path)
    model = DispatchModel(models)
    _CACHE[path] = ((st.st_mtime_ns, st.st_size), model)
    return model


def load_dispatch_model(directory: Optional[str] = None, device=None) -> Optional[DispatchModel]:
    """The model stored in ``directory`` (the device's store unless given);
    ``None`` when no file exists there.  A file that cannot be read raises
    ``ValueError``."""
    path = _file(directory, device)
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    key = (st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    try:
        with np.load(path, allow_pickle=False) as blob:
            states: Dict[str, Dict[str, np.ndarray]] = {}
            for full in blob.files:
                strat, k = full.split("::")
                states.setdefault(strat, {})[k] = blob[full]
        model = DispatchModel({s: regression.KNNRegressor.from_state(states[s]) for s in STRATEGIES})
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as exc:
        raise ValueError(f"{path}: the installed MoE dispatch model cannot be read") from exc
    _CACHE[path] = (key, model)
    return model
