"""Regression model zoo — numpy re-implementations of the paper's §B models
(a copy of ``repro.costmodel.regression``: numpy only, no device code).

The paper trains scikit-learn regressors over the profiling set; sklearn is
not available offline here, so the same model classes are implemented from
scratch on numpy: Linear, Polynomial(2), KNN(k=4), DecisionTree(depth 5),
RandomForest(200), GradientBoost(200) and AdaBoost.R2(200).  All share a
tiny ``fit/predict`` interface and are serializable via ``to_state`` /
``from_state`` (plain dicts of ndarrays) for the installation-stage model
store.

Labels are fit in log-space (the paper's Figs. 9/16 evaluate proportionality
on a log scale, and §B explains why log features dominate); ``predict``
returns linear-space values.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# feature helpers
# ---------------------------------------------------------------------------


def with_log_features(X: np.ndarray) -> np.ndarray:
    """The paper's 'feature engineering': append log2 of each raw feature,
    plus the log-ratio of the first two (for dictionary ops: log(n/size) —
    the duplication factor that drives scatter-conflict degradation; see
    EXPERIMENTS.md §Perf engine-side iterations)."""
    logs = np.log2(np.maximum(X, 1.0))
    cols = [X, logs]
    if X.shape[1] >= 2:
        cols.append((logs[:, 1] - logs[:, 0])[:, None])
    return np.concatenate(cols, axis=1)


def _standardize_fit(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd = np.where(sd < 1e-12, 1.0, sd)
    return mu, sd


# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------


class Regressor:
    name = "base"

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Regressor":
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def to_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "Regressor":
        raise NotImplementedError


class _LogSpaceMixin:
    """Fit on log(y), predict exp — keeps the 3-orders-of-magnitude spread of
    dictionary op costs well-conditioned."""

    def _encode_y(self, y: np.ndarray) -> np.ndarray:
        return np.log(np.maximum(y, 1e-12))

    def _decode_y(self, z: np.ndarray) -> np.ndarray:
        return np.exp(z)


# ---------------------------------------------------------------------------
# linear / polynomial
# ---------------------------------------------------------------------------


class LinearRegression(Regressor, _LogSpaceMixin):
    name = "linear"

    def __init__(self) -> None:
        self.w: Optional[np.ndarray] = None
        self.mu = self.sd = None

    def _design(self, X: np.ndarray) -> np.ndarray:
        Z = (X - self.mu) / self.sd
        return np.concatenate([Z, np.ones((len(Z), 1))], axis=1)

    def fit(self, X, y):
        self.mu, self.sd = _standardize_fit(X)
        A = self._design(X)
        self.w, *_ = np.linalg.lstsq(A, self._encode_y(y), rcond=None)
        return self

    def predict(self, X):
        return self._decode_y(self._design(X) @ self.w)

    def to_state(self):
        return {"w": self.w, "mu": self.mu, "sd": self.sd}

    @classmethod
    def from_state(cls, s):
        m = cls()
        m.w, m.mu, m.sd = s["w"], s["mu"], s["sd"]
        return m


class PolynomialRegression(LinearRegression):
    name = "poly2"

    def _design(self, X):
        Z = (X - self.mu) / self.sd
        n, d = Z.shape
        cols = [Z, np.ones((n, 1))]
        for i in range(d):
            for j in range(i, d):
                cols.append((Z[:, i] * Z[:, j])[:, None])
        return np.concatenate(cols, axis=1)


# ---------------------------------------------------------------------------
# KNN (the paper's best: K=4 with log features)
# ---------------------------------------------------------------------------


class KNNRegressor(Regressor, _LogSpaceMixin):
    name = "knn4"

    def __init__(self, k: int = 4) -> None:
        self.k = k
        self.X: Optional[np.ndarray] = None
        self.z: Optional[np.ndarray] = None
        self.mu = self.sd = None

    def fit(self, X, y):
        self.mu, self.sd = _standardize_fit(X)
        self.X = (X - self.mu) / self.sd
        self.z = self._encode_y(y)
        return self

    def predict(self, X):
        Z = (X - self.mu) / self.sd
        d2 = ((Z[:, None, :] - self.X[None, :, :]) ** 2).sum(-1)
        k = min(self.k, len(self.X))
        nn = np.argpartition(d2, k - 1, axis=1)[:, :k]
        # inverse-distance weighting (ties at d=0 handled by epsilon)
        w = 1.0 / (np.take_along_axis(d2, nn, axis=1) + 1e-9)
        zs = self.z[nn]
        return self._decode_y((zs * w).sum(1) / w.sum(1))

    def to_state(self):
        return {"k": np.int64(self.k), "X": self.X, "z": self.z, "mu": self.mu, "sd": self.sd}

    @classmethod
    def from_state(cls, s):
        m = cls(int(s["k"]))
        m.X, m.z, m.mu, m.sd = s["X"], s["z"], s["mu"], s["sd"]
        return m


# ---------------------------------------------------------------------------
# decision tree + ensembles
# ---------------------------------------------------------------------------


@dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0  # leaf prediction (log space)


class DecisionTreeRegressor(Regressor, _LogSpaceMixin):
    name = "tree5"

    def __init__(self, max_depth: int = 5, min_leaf: int = 2) -> None:
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.nodes: List[_Node] = []

    # -- fitting -----------------------------------------------------------
    def _best_split(self, X, z, sw):
        best = (None, None, np.inf)
        n, d = X.shape
        for f in range(d):
            order = np.argsort(X[:, f], kind="stable")
            xs, zs, ws = X[order, f], z[order], sw[order]
            cw = np.cumsum(ws)
            cz = np.cumsum(ws * zs)
            cz2 = np.cumsum(ws * zs * zs)
            tot_w, tot_z, tot_z2 = cw[-1], cz[-1], cz2[-1]
            for i in range(self.min_leaf - 1, n - self.min_leaf):
                if xs[i] == xs[i + 1]:
                    continue
                lw, lz, lz2 = cw[i], cz[i], cz2[i]
                rw, rz, rz2 = tot_w - lw, tot_z - lz, tot_z2 - lz2
                sse = (lz2 - lz * lz / lw) + (rz2 - rz * rz / rw)
                if sse < best[2]:
                    best = (f, (xs[i] + xs[i + 1]) / 2.0, sse)
        return best

    def _grow(self, X, z, sw, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(np.average(z, weights=sw))))
        if depth >= self.max_depth or len(X) < 2 * self.min_leaf or np.ptp(z) < 1e-12:
            return idx
        f, t, _ = self._best_split(X, z, sw)
        if f is None:
            return idx
        m = X[:, f] <= t
        node = self.nodes[idx]
        node.feature, node.thresh = f, t
        node.left = self._grow(X[m], z[m], sw[m], depth + 1)
        node.right = self._grow(X[~m], z[~m], sw[~m], depth + 1)
        return idx

    def fit(self, X, y, sample_weight: Optional[np.ndarray] = None):
        self.nodes = []
        sw = np.ones(len(X)) if sample_weight is None else sample_weight
        self._grow(np.asarray(X, float), self._encode_y(np.asarray(y, float)), sw, 0)
        return self

    def fit_log(self, X, z, sw=None):
        """Fit directly on log-space residuals (for boosting)."""
        self.nodes = []
        sw = np.ones(len(X)) if sw is None else sw
        self._grow(np.asarray(X, float), np.asarray(z, float), sw, 0)
        return self

    def _predict_log(self, X):
        out = np.empty(len(X))
        for i, x in enumerate(np.asarray(X, float)):
            n = 0
            while self.nodes[n].feature >= 0:
                n = self.nodes[n].left if x[self.nodes[n].feature] <= self.nodes[n].thresh else self.nodes[n].right
            out[i] = self.nodes[n].value
        return out

    def predict(self, X):
        return self._decode_y(self._predict_log(X))

    def to_state(self):
        arr = np.array(
            [(n.feature, n.thresh, n.left, n.right, n.value) for n in self.nodes],
            dtype=np.float64,
        )
        return {"nodes": arr, "max_depth": np.int64(self.max_depth)}

    @classmethod
    def from_state(cls, s):
        m = cls(int(s["max_depth"]))
        m.nodes = [
            _Node(int(f), float(t), int(l), int(r), float(v))
            for f, t, l, r, v in s["nodes"]
        ]
        return m


class RandomForestRegressor(Regressor, _LogSpaceMixin):
    name = "forest"

    def __init__(self, n_estimators: int = 50, max_depth: int = 6, seed: int = 0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.seed = seed
        self.trees: List[DecisionTreeRegressor] = []

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        z = self._encode_y(np.asarray(y, float))
        self.trees = []
        for _ in range(self.n_estimators):
            idx = rng.integers(0, len(X), len(X))
            t = DecisionTreeRegressor(self.max_depth)
            t.fit_log(X[idx], z[idx])
            self.trees.append(t)
        return self

    def predict(self, X):
        zs = np.mean([t._predict_log(X) for t in self.trees], axis=0)
        return self._decode_y(zs)

    def to_state(self):
        return {
            "n": np.int64(len(self.trees)),
            **{f"tree{i}": t.to_state()["nodes"] for i, t in enumerate(self.trees)},
        }

    @classmethod
    def from_state(cls, s):
        m = cls(int(s["n"]))
        m.trees = [
            DecisionTreeRegressor.from_state(
                {"nodes": s[f"tree{i}"], "max_depth": np.int64(0)}
            )
            for i in range(int(s["n"]))
        ]
        return m


class GradientBoostRegressor(Regressor, _LogSpaceMixin):
    name = "gboost"

    def __init__(self, n_estimators: int = 100, lr: float = 0.1, max_depth: int = 3):
        self.n_estimators = n_estimators
        self.lr = lr
        self.max_depth = max_depth
        self.base = 0.0
        self.trees: List[DecisionTreeRegressor] = []

    def fit(self, X, y):
        z = self._encode_y(np.asarray(y, float))
        self.base = float(z.mean())
        resid = z - self.base
        self.trees = []
        for _ in range(self.n_estimators):
            t = DecisionTreeRegressor(self.max_depth)
            t.fit_log(X, resid)
            resid = resid - self.lr * t._predict_log(X)
            self.trees.append(t)
        return self

    def predict(self, X):
        z = np.full(len(X), self.base)
        for t in self.trees:
            z += self.lr * t._predict_log(X)
        return self._decode_y(z)

    def to_state(self):
        return {
            "n": np.int64(len(self.trees)),
            "base": np.float64(self.base),
            "lr": np.float64(self.lr),
            **{f"tree{i}": t.to_state()["nodes"] for i, t in enumerate(self.trees)},
        }

    @classmethod
    def from_state(cls, s):
        m = cls(int(s["n"]), float(s["lr"]))
        m.base = float(s["base"])
        m.trees = [
            DecisionTreeRegressor.from_state(
                {"nodes": s[f"tree{i}"], "max_depth": np.int64(0)}
            )
            for i in range(int(s["n"]))
        ]
        return m


MODEL_ZOO = {
    m.name: m
    for m in (
        LinearRegression,
        PolynomialRegression,
        KNNRegressor,
        DecisionTreeRegressor,
        RandomForestRegressor,
        GradientBoostRegressor,
    )
}


def make(name: str) -> Regressor:
    return MODEL_ZOO[name]()
