"""The port's executor against ``repro.exec.engine.execute_plan`` and the
numpy oracles: the five TPC-H queries × the three choice sets of
``tests/test_lowering_queries.py``, fused and unfused, plus one region
forced radix-marked by a small kernel slot bound."""
import dataclasses

import numpy as np
import pytest

from repro.core import plan as RP
from repro.core.cost import DictChoice as RChoice
from repro.core.cost import FusionCostModel as RFusion
from repro.core.lower import compile as rcompile
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rstats
from repro.exec import engine as RE
from repro.exec.queries import REGISTRY as RQ

from repro_torch.core import plan as TP
from repro_torch.core.cost import DictChoice as TChoice
from repro_torch.core.cost import FusionCostModel as TFusion
from repro_torch.core.lower import compile as tcompile
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tstats
from repro_torch.exec import engine as TE
from repro_torch.exec.queries import REGISTRY as TQ

RTOL, ATOL = 3e-3, 3e-2
_SYMS = ("Agg", "Sd", "OD", "QtyAgg", "CN", "SN", "PX", "Ragg")
CHOICE_SETS = [
    ({}, {}),
    ({s: RChoice("st_sorted", True) for s in _SYMS}, {s: TChoice("st_sorted", True) for s in _SYMS}),
    ({s: RChoice("ht_twochoice") for s in _SYMS}, {s: TChoice("ht_twochoice") for s in _SYMS}),
]


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(scale=0.002, seed=3).tables()
    tdb = from_reference(rdb, device="cpu")
    return rdb, rstats(rdb), tdb, tstats(tdb)


def _check(got, want, ref):
    g, w = got.items_np(), want.items_np()
    assert set(g) == set(w) == set(ref)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g[k], ref[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qname", sorted(TQ))
@pytest.mark.parametrize("ci", range(len(CHOICE_SETS)))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_query_matches_reference_engine(qname, ci, fused, dbs):
    rdb, rsig, tdb, tsig = dbs
    rch, tch = CHOICE_SETS[ci]
    rplan = rcompile(RQ[qname].llql(), rch)
    tplan = tcompile(TQ[qname].llql(), tch)
    if fused:
        rplan, tplan = RP.fuse(rplan, sigma=rsig), TP.fuse(tplan, sigma=tsig)
    assert rplan.describe() == tplan.describe()
    params = dict(RQ[qname].defaults)
    want = RE.execute_plan(rplan, rdb, sigma=rsig, params=params)
    got = TE.execute_plan(tplan, tdb, sigma=tsig, params=params)
    if fused:  # aggregating regions run through the fused pipeline
        for node in tplan.nodes:
            if isinstance(node, TP.Pipeline) and isinstance(node.stages[-1], (TP.GroupBy, TP.GroupJoin, TP.Reduce)):
                assert TE.last_report().mode(node.out) == "kernel-resident"
    _check(got, want, TQ[qname].reference(tdb))


@pytest.mark.parametrize("qname", ["q3", "q18"])
def test_radix_marked_region_runs_unpartitioned(qname, dbs):
    """A small slot bound makes the planner radix-mark the region in both
    packages; the port runs it radix-partitioned through the fused pipeline
    (``kernel-radix``; the reference's CPU path records
    ``xla-radix-planned``)."""
    rdb, rsig, tdb, tsig = dbs
    rfus = dataclasses.replace(RFusion(), kernel_slots=256)
    tfus = dataclasses.replace(TFusion(), kernel_slots=256)
    rplan = RP.fuse(rcompile(RQ[qname].llql(), {}), sigma=rsig, fusion=rfus)
    tplan = TP.fuse(tcompile(TQ[qname].llql(), {}), sigma=tsig, fusion=tfus)
    assert rplan.describe() == tplan.describe()
    marked = [n for n in tplan.nodes if isinstance(n, TP.Pipeline) and n.partitions]
    assert marked, tplan.describe()
    params = dict(RQ[qname].defaults)
    want = RE.execute_plan(rplan, rdb, sigma=rsig, params=params)
    got = TE.execute_plan(tplan, tdb, sigma=tsig, params=params)
    for node in marked:
        assert TE.last_report().mode(node.out) == "kernel-radix"
    _check(got, want, TQ[qname].reference(tdb))


@pytest.mark.parametrize("ds", ["ht_linear", "st_blocked"])
def test_fk_join_and_semijoin_match_reference(ds):
    rng = np.random.default_rng(4)
    from repro.data.table import from_numpy as rfrom_numpy

    R = {"s": np.arange(40, dtype=np.int32), "c": rng.normal(size=40).astype(np.float32)}
    S = {"s": np.sort(rng.integers(0, 50, 300)).astype(np.int32), "i": rng.normal(size=300).astype(np.float32)}
    rdb = {"R": rfrom_numpy(R, sorted_on=("s",)), "S": rfrom_numpy(S, sorted_on=("s",))}
    tdb = from_reference(rdb, device="cpu")
    ridx = RE.build_index(ds, rdb["R"].col("s"), 256)
    tidx = TE.build_index(ds, tdb["R"].col("s"), 256)
    want = RE.fk_join(rdb["S"], rdb["S"].col("s"), rdb["R"], ridx, take=["c"], prefix="r_")
    got = TE.fk_join(tdb["S"], tdb["S"].col("s"), tdb["R"], tidx, take=["c"], prefix="r_")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.col("r_c").numpy(), np.asarray(want.col("r_c")))
    semi = TE.semijoin(tdb["S"], tdb["S"].col("s"), tidx, sorted_probes=ds.startswith("st"))
    np.testing.assert_array_equal(semi.mask.numpy(), np.asarray(want.mask))


def test_region_that_fails_to_lower_takes_region_path(dbs, monkeypatch):
    """A row expression the region program cannot hold makes the region
    structurally ineligible: it runs the plain-torch region path on its own
    device and records ``xla``, with the same answer."""
    from repro_torch.core.lower import _Unsupported

    def refuse(*_):
        raise _Unsupported("row expr under test")

    monkeypatch.setattr(TE, "lower_expr", refuse)
    rdb, rsig, tdb, tsig = dbs
    rplan = RP.fuse(rcompile(RQ["q1"].llql(), {}), sigma=rsig)
    tplan = TP.fuse(tcompile(TQ["q1"].llql(), {}), sigma=tsig)
    params = dict(RQ["q1"].defaults)
    want = RE.execute_plan(rplan, rdb, sigma=rsig, params=params)
    got = TE.execute_plan(tplan, tdb, sigma=tsig, params=params)
    assert TE.last_report().mode(tplan.result) == "xla"
    _check(got, want, TQ["q1"].reference(tdb))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_unsupported_plan_interprets_only_on_cpu(device, monkeypatch):
    """``lower.execute`` interprets an unrecognized shape only when the
    tables are on the CPU; tables on the card raise a ``PlanError``."""
    import types
    import warnings

    import torch

    from repro_torch.core import lower as TLower
    from repro_torch.errors import PlanError

    def refuse(*_):
        raise TLower._Unsupported("shape under test")

    monkeypatch.setattr(TLower, "compile", refuse)
    monkeypatch.setattr(TLower, "_interpret_fallback", lambda *a, **k: "interpreted")
    db = {"t": types.SimpleNamespace(device=torch.device(device))}
    expr = TQ["q1"].llql()
    if device == "cpu":
        with pytest.warns(UserWarning, match="fell back to interpreter"):
            assert TLower.execute(expr, db) == "interpreted"
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(PlanError, match="unsupported on"):
                TLower.execute(expr, db)
