"""Installation-stage profiler (paper §4.1 / Fig. 3 "Installation Stage").

The twin of ``repro.costmodel.profiler``: it generates the same synthetic
profiling workload (the same sweep, the same numpy draws, the same row
order), times every registered dictionary backend's operations **on the
device it is given** (the card unless the caller names another), and
returns a training table:

    features: dictionary size, number of accessed tuples, orderedness
    label   : wall seconds for the whole operation batch

ops: ``insert`` (build of n elements), ``lookup_hit`` (n present keys),
``lookup_miss`` (n absent keys); each × ordered/unordered key sequences.
Hash backends are profiled under both orderings too — the paper notes their
order-insensitivity, and the learned model should *discover* that, not
assume it.

Operations are timed through the family modules (``mod.build``,
``mod.lookup``), so on the card ``ht_linear`` builds and lookups and
``st_sorted`` lookups run the hand-written dictionary kernels.  Timing
protocol (the reference's): one warm-up call, then the median of
``repeats`` host-wall calls, each ending in ``torch.cuda.synchronize()`` on
the card.  :meth:`ProfileTable.save` writes the reference's ``.npy`` layout,
so either package loads the other's file.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.table import resolve_device
from repro_torch.dicts import base as dbase
from repro_torch.dicts import registry

DEFAULT_SIZES = (2**4, 2**6) + tuple(2**p for p in range(8, 18))  # 16 .. 128k
# the installation sweep on the card adds 2^18 .. 2^21, so that Δ covers
# TPC-H SF 1's largest dictionary (orders: 1,500,000 keys)
LARGE_SIZES = tuple(2**p for p in range(18, 22))
INSTALL_SIZES = DEFAULT_SIZES + LARGE_SIZES
QUICK_SIZES = (2**8, 2**11, 2**14)
OPS = ("insert", "lookup_hit", "lookup_miss")


@dataclass
class ProfileRow:
    ds: str
    op: str
    ordered: bool
    size: int  # dictionary cardinality
    n: int  # accessed/inserted tuples
    seconds: float  # total batch seconds

    @property
    def per_op_ns(self) -> float:
        return self.seconds / max(self.n, 1) * 1e9


@dataclass
class ProfileTable:
    rows: List[ProfileRow] = field(default_factory=list)

    def filter(self, ds=None, op=None, ordered=None) -> "ProfileTable":
        out = [
            r
            for r in self.rows
            if (ds is None or r.ds == ds)
            and (op is None or r.op == op)
            and (ordered is None or r.ordered == ordered)
        ]
        return ProfileTable(out)

    def features_labels(self) -> Tuple[np.ndarray, np.ndarray]:
        X = np.array([[r.size, r.n] for r in self.rows], float)
        y = np.array([r.seconds for r in self.rows], float)
        return X, y

    def onehot_features_labels(self) -> Tuple[np.ndarray, np.ndarray]:
        """'All in One Model' featurization: size, n, ordered + one-hot
        (dictionary, op) — the paper's §6.2.1 first method."""
        ds_names = sorted({r.ds for r in self.rows})
        X = []
        for r in self.rows:
            row = [r.size, r.n, float(r.ordered)]
            row += [1.0 if r.ds == d else 0.0 for d in ds_names]
            row += [1.0 if r.op == o else 0.0 for o in OPS]
            X.append(row)
        y = np.array([r.seconds for r in self.rows], float)
        return np.array(X, float), y

    def save(self, path: str) -> None:
        arr = np.array(
            [
                (r.ds, r.op, int(r.ordered), r.size, r.n, r.seconds)
                for r in self.rows
            ],
            dtype=object,
        )
        np.save(path, arr, allow_pickle=True)

    @classmethod
    def load(cls, path: str) -> "ProfileTable":
        arr = np.load(path, allow_pickle=True)
        return cls(
            [
                ProfileRow(str(ds), str(op), bool(int(o)), int(s), int(n), float(sec))
                for ds, op, o, s, n, sec in arr
            ]
        )


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, *args, repeats: int = 3, device: torch.device) -> float:
    fn(*args)
    _sync(device)  # warm-up (builds a kernel at its first use)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _capacity_for(ds: str, size: int) -> int:
    cap = dbase.next_pow2(max(2 * size, 256))
    return cap


# ---------------------------------------------------------------------------
# the profiling sweep
# ---------------------------------------------------------------------------


def profile(
    backends: Optional[Sequence[str]] = None,
    sizes: Sequence[int] = DEFAULT_SIZES,
    lookup_ratios: Sequence[float] = (0.25, 1.0, 4.0),
    repeats: int = 3,
    seed: int = 0,
    verbose: bool = False,
    device=None,
    stats: Optional[Dict[str, float]] = None,
) -> ProfileTable:
    """The sweep on ``device`` (the card unless another is named).  A
    ``stats`` dict receives where the sweep's host time went: ``draw_s``
    (numpy draws and sorts), ``upload_s`` (copies to the device) and
    ``call_s`` (every operation call, warm-ups included)."""
    dev = resolve_device(device)
    backends = list(backends or registry.names())
    rng = np.random.default_rng(seed)
    table = ProfileTable()
    acc = {"draw_s": 0.0, "upload_s": 0.0, "call_s": 0.0}

    def put(a):
        t0 = time.perf_counter()
        out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        _sync(dev)
        acc["upload_s"] += time.perf_counter() - t0
        return out

    def timed(fn, *args):
        t0 = time.perf_counter()
        sec = _time_fn(fn, *args, repeats=repeats, device=dev)
        acc["call_s"] += time.perf_counter() - t0
        return sec

    for size in sizes:
        cap = None
        # distinct int keys for the dictionary, plus disjoint miss keys
        t0 = time.perf_counter()
        universe = rng.choice(np.arange(1, 8 * size, dtype=np.int32), 2 * size, replace=False)
        present, absent = universe[:size], universe[size:]
        vals = rng.normal(size=(size, 1)).astype(np.float32)
        acc["draw_s"] += time.perf_counter() - t0
        for ds in backends:
            mod = registry.get(ds)
            cap = _capacity_for(ds, size)
            for ordered in (False, True):
                t0 = time.perf_counter()
                ks = np.sort(present) if ordered else present
                vs = vals  # value order irrelevant for timing
                acc["draw_s"] += time.perf_counter() - t0
                jks, jvs = put(ks), put(vs)

                # ---- insert: distinct batch AND duplicate-heavy batches
                # (bag aggregation: n_ops rows collapsing into `size` keys —
                # hash scatter conflicts degrade here, the model must see it)
                def build(k, v, _m=mod, _c=cap, _o=ordered):
                    return _m.build(k, v, _c, assume_sorted=_o)

                sec = timed(build, jks, jvs)
                table.rows.append(
                    ProfileRow(ds, "insert", ordered, size, size, sec)
                )
                dups = (4, 16, 64) if size > 256 else (4, 16, 64, 1024, 8192)
                for dup in dups:
                    t0 = time.perf_counter()
                    n_dup = min(size * dup, 2**18)
                    dk = rng.choice(present, n_dup, replace=True)
                    if ordered:
                        dk = np.sort(dk)
                    dv = rng.normal(size=(n_dup, 1)).astype(np.float32)
                    acc["draw_s"] += time.perf_counter() - t0
                    sec_d = timed(build, put(dk), put(dv))
                    table.rows.append(
                        ProfileRow(ds, "insert", ordered, size, n_dup, sec_d)
                    )

                # ---- lookups against the built table
                t = build(jks, jvs)
                for ratio in lookup_ratios:
                    t0 = time.perf_counter()
                    n = max(8, int(size * ratio))
                    hit_q = rng.choice(present, n, replace=True)
                    miss_q = rng.choice(absent, n, replace=True)
                    if ordered:
                        hit_q, miss_q = np.sort(hit_q), np.sort(miss_q)
                    acc["draw_s"] += time.perf_counter() - t0

                    def lookup(tt, q, _m=mod):
                        return _m.lookup(tt, q)

                    sec_hit = timed(lookup, t, put(hit_q))
                    sec_miss = timed(lookup, t, put(miss_q))
                    table.rows.append(
                        ProfileRow(ds, "lookup_hit", ordered, size, n, sec_hit)
                    )
                    table.rows.append(
                        ProfileRow(ds, "lookup_miss", ordered, size, n, sec_miss)
                    )
            if verbose:
                print(f"profiled {ds} size={size}")
    if stats is not None:
        stats.update(acc)
    return table


def profile_quick(**kw) -> ProfileTable:
    kw.setdefault("sizes", QUICK_SIZES)
    kw.setdefault("lookup_ratios", (1.0,))
    kw.setdefault("repeats", 2)
    return profile(**kw)
