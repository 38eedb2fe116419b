"""The port's shared-scan batches against its own per-query execution and
against ``repro.exec.engine.execute_shared_plan``, on the CPU: the merge
structure of the five TPC-H queries, the merge-compatible pairs of
``tests/test_shared_scan.py``, the ``SharedExecutable`` cache, and the mode
each merged terminal records."""
import numpy as np
import pytest

from repro.core import plan as RP
from repro.core.cost import AnalyticCostModel as RDelta
from repro.core.lower import compile as rcompile
from repro.core.synthesis import synthesize as rsynthesize
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rstats
from repro.exec import engine as RE
from repro.exec.queries import REGISTRY as RQ

from repro_torch.core import plan as TP
from repro_torch.core.cost import AnalyticCostModel as TDelta
from repro_torch.core.lower import compile as tcompile
from repro_torch.core.synthesis import synthesize as tsynthesize
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tstats
from repro_torch.exec import engine as TE
from repro_torch.exec.queries import REGISTRY as TQ

RTOL, ATOL = 3e-3, 3e-2  # float32 sums folded in another order
PAIRS = [("q1", "q3"), ("q1", "q18"), ("q3", "q18"), ("q5", "q9"), ("q3", "q5"), ("q9", "q18")]


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(scale=0.001, seed=0).tables()
    tdb = from_reference(rdb, device="cpu")
    return rdb, rstats(rdb), tdb, tstats(tdb)


def _fused(qnames, dbs):
    """Each query planned in both packages as ``Session.query`` plans it."""
    _, rsig, _, tsig = dbs
    rplans, tplans, params = [], [], []
    for q in qnames:
        rexpr, texpr = RQ[q].llql(), TQ[q].llql()
        rplans.append(RP.fuse(rcompile(rexpr, rsynthesize(rexpr, rsig, RDelta()).choices), sigma=rsig))
        tplans.append(TP.fuse(tcompile(texpr, tsynthesize(texpr, tsig, TDelta()).choices), sigma=tsig))
        params.append(dict(TQ[q].defaults))
    return rplans, tplans, params


def _arrays(out):
    if hasattr(out, "arrays"):
        return tuple(a.numpy() for a in out.arrays())
    return tuple(v.numpy() for _, v in sorted(out.items()))


def _items(out):
    if hasattr(out, "items_np"):
        return out.items_np()
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want):
    g, w = _items(got), _items(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


def test_merge_structure_five_queries(dbs):
    _, rsig, _, tsig = dbs
    rplans, tplans, _ = _fused(sorted(TQ), dbs)
    rsp = RP.merge_shared_scans(rplans, sigma=rsig)
    tsp = TP.merge_shared_scans(tplans, sigma=tsig)
    assert {rg.source: len(rg.branches) for rg in tsp.regions} == {"lineitem": 5, "orders": 4, "supplier": 2}
    assert tsp.describe() == rsp.describe()
    assert tsp.fingerprint() == rsp.fingerprint()
    assert [p.describe() for p in tsp.plans] == [p.describe() for p in rplans]
    for trg, rrg in zip(tsp.regions, rsp.regions):
        assert trg.source == rrg.source
        assert [(b.plan_idx, b.covered, b.pipe.out) for b in trg.branches] == [
            (b.plan_idx, b.covered, b.pipe.out) for b in rrg.branches
        ]
        assert [TP._describe_node(b.pipe) for b in trg.branches] == [RP._describe_node(b.pipe) for b in rrg.branches]


def _aggregating(pipe) -> bool:
    return isinstance(pipe.stages[-1], (TP.GroupBy, TP.GroupJoin, TP.Reduce))


def _check_modes(sp, plans, modes):
    """Aggregating branches ran the fused pipeline; the rest ran as one
    plain pass per region.  The report is keyed by symbol, so a terminal
    whose name is also an uncovered node of another plan, or the terminal
    of a branch that ran the other way, is skipped."""
    covered = {(b.plan_idx, s) for rg in sp.regions for b in rg.branches for s in b.covered}
    want = {}
    for rg in sp.regions:
        n_plain = sum(not _aggregating(b.pipe) for b in rg.branches)
        for b in rg.branches:
            mode = "kernel-resident" if _aggregating(b.pipe) else f"shared:{n_plain}"
            want.setdefault(b.pipe.out, set()).add(mode)
    clobbered = {t for t, ms in want.items() if len(ms) > 1}
    for i, p in enumerate(plans):
        for n in p.nodes:
            outs = [st.out for st in n.stages] if isinstance(n, TP.Pipeline) else [n.out]
            clobbered.update(o for o in outs if (i, o) not in covered)
    checked = 0
    for sym, ms in want.items():
        if sym not in clobbered:
            assert modes[sym] == next(iter(ms)), (sym, modes)
            checked += 1
    return checked


@pytest.mark.parametrize("pair", PAIRS, ids=["+".join(p) for p in PAIRS])
def test_shared_pair_matches_per_query_and_reference(pair, dbs):
    rdb, rsig, tdb, tsig = dbs
    rplans, tplans, params = _fused(pair, dbs)
    tsp = TP.merge_shared_scans(tplans, sigma=tsig)
    assert tsp.regions, pair  # every listed pair merges
    shared = TE.execute_shared_plan(tsp, tdb, sigma=tsig, params_list=params)
    modes = TE.last_report().modes()
    per = [TE.execute_plan(p, tdb, sigma=tsig, params=pv) for p, pv in zip(tplans, params)]
    for s, q in zip(shared, per):  # bitwise: the same ops on the same tensors
        for a, b in zip(_arrays(s), _arrays(q)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert (a == b).all()
    rsp = RP.merge_shared_scans(rplans, sigma=rsig)
    ref = RE.execute_shared_plan(rsp, rdb, sigma=rsig, params_list=params)
    for s, r, q in zip(shared, ref, pair):
        _close(s, r)
        _close(s, TQ[q].reference(tdb))
    assert _check_modes(tsp, tplans, modes) > 0


def test_five_query_batch_modes(dbs):
    _, _, tdb, tsig = dbs
    _, tplans, params = _fused(sorted(TQ), dbs)
    tsp = TP.merge_shared_scans(tplans, sigma=tsig)
    outs = TE.cached_shared_executable(tsp, tdb, sigma=tsig)(tdb, params)
    modes = TE.last_report().modes()
    assert _check_modes(tsp, tplans, modes) > 0
    assert any(m.startswith("shared:") for m in modes.values()), modes
    for q, out in zip(sorted(TQ), outs):
        _close(out, TQ[q].reference(tdb))


def test_shared_executable_demux_cache_and_trace_count(dbs):
    _, _, tdb, tsig = dbs
    _, tplans, params = _fused(("q1", "q3", "q18"), dbs)
    sp = TP.merge_shared_scans(tplans, sigma=tsig)
    TE.clear_exec_cache()
    ex = TE.cached_shared_executable(sp, tdb, sigma=tsig)
    outs = ex(tdb, params)
    assert len(outs) == 3 and ex.trace_count == 1
    assert ex.last_report.trace_count == 1
    outs2 = ex(tdb, params)  # rebinding plans nothing again
    assert ex.trace_count == 1 and ex.calls == 2
    assert TE.cached_shared_executable(sp, tdb, sigma=tsig) is ex
    for o1, o2, p, pv in zip(outs, outs2, tplans, params):
        for a, b, c in zip(_arrays(o1), _arrays(o2), _arrays(TE.cached_executable(p, tdb, sigma=tsig)(tdb, pv))):
            assert (a == b).all() and (a == c).all()
    TE.clear_exec_cache()
    assert TE.cached_shared_executable(sp, tdb, sigma=tsig) is not ex
