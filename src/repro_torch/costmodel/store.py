"""Learned dictionary cost model Δ + its on-disk store.

The twin of ``repro.costmodel.store``.  The paper's best method —
**individual models with feature engineering** — is the default: one
regressor per (backend, op, orderedness) trained on ``[size, n, log2 size,
log2 n]`` features.  The store persists both the raw profiling table
(``profile.npy``) and the fitted model states (``delta.npz``, the
reference's key layout, so either package loads the other's files) so the
installation stage runs once per machine.

The default store is ``build/costmodel/<device>/`` at the root of the
checkout (git-ignored), one directory per device name: an installation made
on one device is never reused as another's Δ.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost import AnalyticCostModel
from repro_torch.data.table import resolve_device

from . import regression
from .profiler import INSTALL_SIZES, OPS, ProfileTable, profile, profile_quick

STORE_ROOT = Path(__file__).resolve().parents[3] / "build" / "costmodel"

Key = Tuple[str, str, bool]  # (ds, op, ordered)


def default_dir(device=None) -> str:
    """``build/costmodel/<device name>``: ``torch.cuda.get_device_name`` for
    a CUDA device (the card unless another is named), else the device type."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return str(STORE_ROOT / re.sub(r"[^A-Za-z0-9._-]+", "_", name))


@dataclass
class LearnedCostModel:
    """Δ implementation backed by per-(ds, op, ordered) regressors."""

    models: Dict[Key, regression.Regressor]
    model_name: str = "knn4"
    log_features: bool = True  # featurization used at fit time

    def op_cost(self, ds: str, op: str, n: float, size: float, ordered: bool) -> float:
        if n <= 0:
            return 0.0
        key = (ds, op, bool(ordered))
        if key not in self.models:
            # backend profiled only without ordering distinction, or unseen:
            key = (ds, op, False)
        if key not in self.models:
            return AnalyticCostModel().op_cost(ds, op, n, size, ordered)
        X = np.array([[max(size, 1.0), max(n, 1.0)]], float)
        if self.log_features:
            X = regression.with_log_features(X)
        sec = float(self.models[key].predict(X)[0])
        # profiling covers n in [size/4, 4·size]; extrapolate linearly in n
        # beyond the profiled ratio range (costs are per-batch)
        return max(sec, 0.0)


def train(
    table: ProfileTable, model_name: str = "knn4", log_features: bool = True
) -> LearnedCostModel:
    models: Dict[Key, regression.Regressor] = {}
    combos = {(r.ds, r.op, r.ordered) for r in table.rows}
    for ds, op, ordered in sorted(combos):
        sub = table.filter(ds=ds, op=op, ordered=ordered)
        X, y = sub.features_labels()
        if log_features:
            X = regression.with_log_features(X)
        m = regression.make(model_name)
        m.fit(X, y)
        models[(ds, op, ordered)] = m
    return LearnedCostModel(models, model_name, log_features)


def train_all_in_one(
    table: ProfileTable, model_name: str = "knn4"
) -> "AllInOneCostModel":
    X, y = table.onehot_features_labels()
    Xl = np.concatenate([X[:, :2], np.log2(np.maximum(X[:, :2], 1.0)), X[:, 2:]], axis=1)
    m = regression.make(model_name)
    m.fit(Xl, y)
    ds_names = sorted({r.ds for r in table.rows})
    return AllInOneCostModel(m, ds_names)


@dataclass
class AllInOneCostModel:
    """The paper's §6.2.1 'All in One Model' baseline featurization."""

    model: regression.Regressor
    ds_names: Sequence[str]

    def op_cost(self, ds: str, op: str, n: float, size: float, ordered: bool) -> float:
        if n <= 0:
            return 0.0
        row = [max(size, 1.0), max(n, 1.0)]
        row += [np.log2(row[0]), np.log2(row[1]), float(ordered)]
        row += [1.0 if ds == d else 0.0 for d in self.ds_names]
        row += [1.0 if op == o else 0.0 for o in OPS]
        return max(float(self.model.predict(np.array([row]))[0]), 0.0)


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------


def _key_str(key: Key) -> str:
    return f"{key[0]}|{key[1]}|{int(key[2])}"


def save_model(model: LearnedCostModel, directory: Optional[str] = None) -> None:
    directory = directory or default_dir()
    os.makedirs(directory, exist_ok=True)
    blob: Dict[str, np.ndarray] = {"__model_name__": np.array(model.model_name)}
    for key, reg in model.models.items():
        for sname, arr in reg.to_state().items():
            blob[f"{_key_str(key)}::{sname}"] = np.asarray(arr)
    np.savez(os.path.join(directory, "delta.npz"), **blob)


def load_model(directory: Optional[str] = None) -> Optional[LearnedCostModel]:
    path = os.path.join(directory or default_dir(), "delta.npz")
    if not os.path.exists(path):
        return None
    blob = np.load(path, allow_pickle=False)
    model_name = str(blob["__model_name__"])
    states: Dict[Key, Dict[str, np.ndarray]] = {}
    for full in blob.files:
        if full == "__model_name__":
            continue
        keypart, sname = full.split("::")
        ds, op, o = keypart.split("|")
        key = (ds, op, bool(int(o)))
        states.setdefault(key, {})[sname] = blob[full]
    cls = regression.MODEL_ZOO[model_name]
    models = {k: cls.from_state(s) for k, s in states.items()}
    return LearnedCostModel(models, model_name)


def install(
    directory: Optional[str] = None,
    quick: bool = False,
    model_name: str = "knn4",
    verbose: bool = False,
    device=None,
    **profile_kw,
) -> LearnedCostModel:
    """The full installation stage on ``device`` (the card unless another is
    named): profile + train + persist into ``directory`` (the device's
    default store unless given).  Reuses an existing installation unless
    absent.  The full sweep covers ``INSTALL_SIZES`` (the reference's sizes,
    extended to 2^21 keys) unless ``profile_kw`` names others; ``quick``
    takes the reference's quick sweep."""
    directory = directory or default_dir(device)
    existing = load_model(directory)
    if existing is not None:
        return existing
    if quick:
        table = profile_quick(verbose=verbose, device=device, **profile_kw)
    else:
        profile_kw.setdefault("sizes", INSTALL_SIZES)
        table = profile(verbose=verbose, device=device, **profile_kw)
    os.makedirs(directory, exist_ok=True)
    table.save(os.path.join(directory, "profile.npy"))
    model = train(table, model_name=model_name)
    save_model(model, directory)
    return model


def load_profile(directory: Optional[str] = None) -> Optional[ProfileTable]:
    path = os.path.join(directory or default_dir(), "profile.npy")
    if not os.path.exists(path):
        return None
    return ProfileTable.load(path)
