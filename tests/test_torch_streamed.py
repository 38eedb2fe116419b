"""The port's out-of-core path against ``repro``'s: the five TPC-H queries
over a database whose lineitem streams in chunks (scale 0.002, 2,048-row
chunks, a budget that holds every other relation), through
``execute_plan`` and through ``connect(..., memory_budget=...)``.

Keys are exact and floats within rtol=3e-3, atol=3e-2 against the
reference's streamed result and the port's resident result; the stream
ledger (chunks, encoded bytes moved, decoded chunk working set) equals the
reference's.  On the CPU the port's streamed aggregates run the fused
pipeline's plain twin once per chunk (``streamed-kernel:N``) where the
reference records ``streamed:N``; q3, q5, q9 and q18 are bitwise equal to
the port's resident result, q1 is not (its float sums fold per chunk).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro
from repro.core import plan as RP
from repro.core.cost import AnalyticCostModel as RDelta
from repro.core.cost import DictChoice as RChoice
from repro.core.cost import FusionCostModel as RFusion
from repro.core.lower import compile as rcompile
from repro.core.synthesis import synthesize as rsynth
from repro.data import storage as RS
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rstats
from repro.exec import engine as RE
from repro.exec.queries import REGISTRY as RQ

import repro_torch
from repro_torch import errors as terrors
from repro_torch.core import llql as L
from repro_torch.core import plan as TP
from repro_torch.core.cost import AnalyticCostModel as TDelta
from repro_torch.core.cost import DictChoice as TChoice
from repro_torch.core.cost import FusionCostModel as TFusion
from repro_torch.core.lower import compile as tcompile
from repro_torch.core.synthesis import synthesize as tsynth
from repro_torch.data import storage as TS
from repro_torch.data.interop import from_reference
from repro_torch.data.table import Table
from repro_torch.data.table import collect_stats as tstats
from repro_torch.exec import engine as TE
from repro_torch.exec.queries import REGISTRY as TQ
from repro_torch.testing import faults

RTOL, ATOL = 3e-3, 3e-2
CHUNK = 2048
QUERIES = sorted(TQ)
BITWISE_VS_RESIDENT = ("q3", "q5", "q9", "q18")


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(scale=0.002, seed=3).tables()
    tdb = from_reference(rdb, device="cpu")
    rsig, tsig = rstats(rdb), tstats(tdb)
    budget = int(sum(4 * st.rows * len(st.columns) for rel, st in rsig.rels.items() if rel != "lineitem"))
    rcdb = RS.chunk_db(rdb, budget, chunk_rows=CHUNK)
    tcdb = TS.chunk_db(tdb, budget, chunk_rows=CHUNK)
    assert [r for r, t in tcdb.items() if TS.is_chunked(t)] == ["lineitem"]
    assert RS.is_chunked(rcdb["lineitem"])
    return rdb, rsig, rcdb, tdb, tsig, tcdb, budget


def _plans(qname, rsig, tsig, rch=None, tch=None):
    rexpr, texpr = RQ[qname].llql(), TQ[qname].llql()
    rch = rch if rch is not None else rsynth(rexpr, rsig, RDelta()).choices
    tch = tch if tch is not None else tsynth(texpr, tsig, TDelta()).choices
    rfus = dataclasses.replace(RFusion(), chunk_rows=float(CHUNK))
    tfus = dataclasses.replace(TFusion(), chunk_rows=float(CHUNK))
    rplan = RP.fuse(rcompile(rexpr, rch), sigma=rsig, streamed=("lineitem",), fusion=rfus)
    tplan = TP.fuse(tcompile(texpr, tch), sigma=tsig, streamed=("lineitem",), fusion=tfus)
    assert rplan.describe() == tplan.describe()
    return rplan, tplan


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qname", QUERIES)
def test_streamed_plan_matches_reference_and_resident(qname, dbs):
    rdb, rsig, rcdb, tdb, tsig, tcdb, _ = dbs
    rplan, tplan = _plans(qname, rsig, tsig)
    params = dict(RQ[qname].defaults)
    want = RE.execute_plan(rplan, rcdb, sigma=rsig, params=params).items_np()
    rrep = RE.last_report()
    got = TE.execute_plan(tplan, tcdb, sigma=tsig, params=params).items_np()
    trep = TE.last_report()
    resident = TE.execute_plan(tplan, tdb, sigma=tsig, params=params).items_np()
    _close(got, want)
    _close(got, resident)
    _close(got, TQ[qname].reference(tdb))
    assert (trep.chunks, trep.h2d_bytes, trep.peak_chunk_bytes, trep.streamed_regions) == (
        rrep.chunks, rrep.h2d_bytes, rrep.peak_chunk_bytes, rrep.streamed_regions)
    assert trep.chunks >= 2 and trep.peak_state_bytes >= 0
    assert trep.modes().keys() == rrep.modes().keys()
    for sym, mode in rrep.modes().items():
        if mode.startswith("streamed:") and trep.mode(sym).startswith("streamed-kernel:"):
            assert trep.mode(sym).split(":")[1] == mode.split(":")[1]  # same chunk count
        elif mode.startswith("streamed"):
            assert trep.mode(sym) == mode
    assert {s: r.h2d_bytes for s, r in trep.regions.items()} == {s: r.h2d_bytes for s, r in rrep.regions.items()}
    if qname in BITWISE_VS_RESIDENT:
        for k in resident:
            np.testing.assert_array_equal(got[k], resident[k])


@pytest.mark.parametrize("qname", QUERIES)
@pytest.mark.parametrize("choice", ["default", "st_sorted"])
def test_streamed_region_stages_without_kernel(qname, choice, dbs, monkeypatch):
    """With the kernel lowering declined, every streamed region runs its
    stages per chunk (mode ``streamed:N``, as the reference's CPU path):
    the group-by and groupjoin folds and, under sorted dictionaries, the
    sorted-stream path."""
    rdb, rsig, rcdb, tdb, tsig, tcdb, _ = dbs
    syms = ("Agg", "Sd", "OD", "QtyAgg", "CN", "SN", "PX", "Ragg")
    rch = tch = None
    if choice == "st_sorted":
        rch = {s: RChoice("st_sorted", True) for s in syms}
        tch = {s: TChoice("st_sorted", True) for s in syms}
    rplan, tplan = _plans(qname, rsig, tsig, rch, tch)
    params = dict(RQ[qname].defaults)
    want = RE.execute_plan(rplan, rcdb, sigma=rsig, params=params).items_np()
    rrep = RE.last_report()
    monkeypatch.setattr(TE, "_kernel_region", lambda *a, **k: None)
    got = TE.execute_plan(tplan, tcdb, sigma=tsig, params=params).items_np()
    trep = TE.last_report()
    _close(got, want)
    assert {s: m for s, m in trep.modes().items() if m.startswith("streamed")} == {
        s: m for s, m in rrep.modes().items() if m.startswith("streamed")}
    assert (trep.chunks, trep.h2d_bytes, trep.peak_chunk_bytes) == (rrep.chunks, rrep.h2d_bytes, rrep.peak_chunk_bytes)


@pytest.fixture(scope="module")
def sessions(dbs):
    rdb, _, _, tdb, _, _, budget = dbs
    return (
        repro.connect(rdb, memory_budget=budget, chunk_rows=CHUNK),
        repro_torch.connect(tdb, device="cpu", memory_budget=budget, chunk_rows=CHUNK),
    )


@pytest.mark.parametrize("qname", QUERIES)
def test_connect_with_budget_matches_reference(qname, sessions):
    rs, ts = sessions
    assert ts.streamed == rs.streamed == ("lineitem",)
    _close(ts.query(qname), rs.query(qname))
    assert ts.shape(qname).plan.describe() == rs.shape(qname).plan.describe()
    assert isinstance(ts.shape(qname).executable, TE.StreamedExecutable)
    assert ts.report().h2d_bytes == rs.report().h2d_bytes > 0
    assert ts.explain(qname)["streamed"] == ("lineitem",)


def test_streamed_executable_dispatch(dbs):
    _, _, _, tdb, tsig, tcdb, _ = dbs
    q = TQ["q1"]
    plan = TP.fuse(tcompile(q.llql(), {}), sigma=tsig)
    ex_res = TE.cached_executable(plan, tdb, sigma=tsig)
    ex_str = TE.cached_executable(plan, tcdb, sigma=tsig)
    assert isinstance(ex_str, TE.StreamedExecutable)
    assert not isinstance(ex_res, TE.StreamedExecutable)
    assert TE.cached_executable(plan, tcdb, sigma=tsig) is ex_str
    got, ref = ex_str(tcdb, q.defaults).items_np(), ex_res(tdb, q.defaults).items_np()
    _close(got, ref)
    assert ex_str.last_report.chunks == tcdb["lineitem"].n_chunks


@pytest.mark.parametrize("point", ["h2d", "chunk-decode"])
def test_stream_fault_points_fire(point, dbs):
    _, _, _, tdb, tsig, tcdb, _ = dbs
    plan = TP.fuse(tcompile(TQ["q1"].llql(), {}), sigma=tsig)
    with faults.injected(point, mode="nth", n=3) as spec:
        with pytest.raises(terrors.FaultInjected, match=point):
            TE.execute_plan(plan, tcdb, sigma=tsig, params=dict(TQ["q1"].defaults))
    assert spec.fired == 1 and spec.hits == 3
    # disarmed: the same plan streams to the end
    TE.execute_plan(plan, tcdb, sigma=tsig, params=dict(TQ["q1"].defaults))


@pytest.mark.parametrize("qname", ["q1", "q18"])
def test_empty_relation_streams(qname, dbs):
    _, _, _, tdb, _, _, _ = dbs
    empty = {
        rel: Table({c: a[:0] for c, a in t.columns.items()}, 0, sorted_on=t.sorted_on) if rel in ("lineitem", "orders") else t
        for rel, t in tdb.items()
    }
    # as the reference's test: a 1-byte budget streams the populated
    # dimensions and keeps the empty facts (0 decoded bytes) resident
    session = repro_torch.connect(empty, device="cpu", memory_budget=1, chunk_rows=1024)
    assert session.streamed == ("customer", "nation", "part", "supplier")
    assert session.query(qname) == {}
    # the empty fact relation itself as one zero-row chunk
    cdb = dict(empty, lineitem=TS.chunk_table(empty["lineitem"], chunk_rows=1024))
    sigma = tstats(empty)
    plan = TP.fuse(tcompile(TQ[qname].llql(), {}), sigma=sigma, streamed=("lineitem",))
    assert TE.execute_plan(plan, cdb, sigma=sigma, params=dict(TQ[qname].defaults)).items_np() == {}
    assert TE.last_report().chunks == 1


def test_spilled_projection_round_trips(dbs):
    """A forced pending stream spills each chunk to a ``HostChunkedTable``
    whose decode is the projection's rows."""
    _, _, _, tdb, tsig, tcdb, _ = dbs
    ct = tcdb["lineitem"]
    qty = L.FieldAccess(L.FieldAccess(L.Var("l"), "key"), "quantity")
    scan = TP.Scan(out="Ls", source="lineitem", var="l")
    proj = TP.Project(out="LQ", source="Ls", fields=(("q", qty),))
    pipe = TP.Pipeline(out="LQ", source="lineitem", stages=(scan, proj))
    env = {}
    TE._run_streamed_pipeline(pipe, (proj,), ct, "l", "lineitem", env, {}, tcdb, tsig, True, {}, TP.needed_columns(pipe.stages))
    assert isinstance(env["LQ"], TE._PendingStream)
    spilled = env["LQ"].force(env, {}, tsig, True, {})
    assert isinstance(spilled, TS.HostChunkedTable) and spilled.n_chunks == ct.n_chunks
    dec = spilled.decode()
    assert torch.equal(dec.col("q"), tdb["lineitem"].col("quantity").to(dec.col("q").dtype))
    assert dec.nrows == ct.nrows and bool(dec.live_mask().all())
    up, nbytes = spilled.upload_chunk(0)
    assert nbytes == spilled.chunk_rows * 5 and spilled.chunk_device(0, uploaded=up).nrows == spilled.chunk_rows
