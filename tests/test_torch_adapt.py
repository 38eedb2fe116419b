"""The port's adaptive planner against ``repro``'s: ``repro_torch.core.adapt``
and ``repro_torch.connect(..., adapt=...)`` beside ``repro.core.adapt`` and
``repro.connect(..., adapt=...)`` on the same numpy data.

* the pure functions (``binding_bucket``, ``choices_key``,
  ``enumerate_candidates``) give equal answers;
* races driven by a fake clock (each package's adapt module's own ``time``
  name, never the global module) that charges each Γ a fixed cost give
  equal race records, winners and correction tables — the poisoned-model
  convergence of ``tests/test_adapt.py`` without wall-clock timing;
* every raced lane of the five queries validates bitwise on the CPU, and
  the validation rule is the device's (``degraded_equal``);
* sessions, resident and streamed, serve the reference's results, do not
  re-race or rebuild at steady state, race once more per new binding
  bucket, and explain their races as the reference does; a
  ``QueryServer`` over an adaptive session counts ``synth_runs`` as the
  reference's does; a fault injected during a race propagates as in the
  reference."""
from types import SimpleNamespace

import numpy as np
import pytest

import repro
from repro import session as RS
from repro.core import adapt as RA
from repro.core import cost as RC
from repro.core import synthesis as RSYN
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rcollect
from repro.exec.queries import REGISTRY as RREG
from repro.serve import query_server as RQS
from repro.testing import faults as rfaults

import repro_torch
from repro_torch import session as TS
from repro_torch.core import adapt as TA
from repro_torch.core import cost as TC
from repro_torch.core import synthesis as TSYN
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tcollect
from repro_torch.exec.queries import REGISTRY as TREG
from repro_torch.serve import query_server as TQS
from repro_torch.testing import faults as tfaults

RTOL, ATOL = 3e-3, 3e-2
QUERIES = sorted(TREG)
#: a second binding a query (q9 has no parameter)
OTHER = {"q1": {"date": 0.8}, "q3": {"date": 0.05}, "q5": {"region": 2}, "q9": {}, "q18": {"threshold": 150.0}}
WIDE = dict(band=50.0, top_k=3, warmup=1, repeats=1)
POISONED = dict(band=1e6, top_k=6, warmup=4, repeats=2, residual_alpha=1.0)


@pytest.fixture(autouse=True)
def _clean_faults():
    rfaults.disarm()
    tfaults.disarm()
    yield
    rfaults.disarm()
    tfaults.disarm()


@pytest.fixture(scope="module")
def pkgs():
    rdb = rtpch.generate(scale=0.002, seed=0).tables()
    tdb = from_reference(rdb, device="cpu")
    ref = SimpleNamespace(
        name="repro", A=RA, C=RC, SYN=RSYN, S=RS, QS=RQS, faults=rfaults, REG=RREG, db=rdb,
        sigma=rcollect(rdb), connect=lambda **kw: repro.connect(dict(rdb), **kw),
    )
    port = SimpleNamespace(
        name="repro_torch", A=TA, C=TC, SYN=TSYN, S=TS, QS=TQS, faults=tfaults, REG=TREG, db=tdb,
        sigma=tcollect(tdb), connect=lambda **kw: repro_torch.connect(dict(tdb), device="cpu", **kw),
    )
    return ref, port


def poisoned_delta(pkg):
    """The prior with hash ops priced ~free and sort ops two orders up
    (``benchmarks/adapt_bench.py``'s misranked table)."""
    return pkg.C.AnalyticCostModel(
        constants={k: (1.0 if k[0].startswith("ht") else 100.0) for k in pkg.C.PRIOR_OP_NS}
    )


def same_items(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=RTOL, atol=ATOL)


# -- the pure functions ------------------------------------------------------


BINDINGS = [
    {"threshold": 199.0}, {"threshold": 201.0}, {"threshold": 200.0}, {"threshold": 2.0},
    {"threshold": 2.1}, {"threshold": 0.0}, {"threshold": -3.5}, {"region": 1}, {"region": 2},
    {"region": np.int32(2)}, {"flag": True}, {"a": 1, "b": 2.0}, {"b": 2.0, "a": 1},
    {"name": "BUILDING"}, {"x": np.float32(0.3)}, None, {},
]


def test_binding_bucket_and_choices_key_match(pkgs):
    ref, port = pkgs
    buckets = [port.A.binding_bucket(b) for b in BINDINGS]
    assert buckets == [ref.A.binding_bucket(b) for b in BINDINGS]
    # the reference's properties (tests/test_adapt.py:48-80)
    assert buckets[0] == buckets[1] and buckets[2] != buckets[3]
    assert buckets[7] != buckets[8] and buckets[8] == buckets[9] and buckets[11] == buckets[12]
    assert buckets[-1] == buckets[-2] == ()
    q = port.REG["q3"].llql()
    cands = port.A.enumerate_candidates(q, port.sigma, port.C.AnalyticCostModel(), band=50.0, top_k=4)
    rcands = ref.A.enumerate_candidates(ref.REG["q3"].llql(), ref.sigma, ref.C.AnalyticCostModel(),
                                        band=50.0, top_k=4)
    assert [port.A.choices_key(c.choices) for c in cands] == [ref.A.choices_key(c.choices) for c in rcands]
    keys = [c.key for c in cands]
    assert len(keys) == len(set(keys)) and cands[0].swapped == "" and all(c.swapped for c in cands[1:])


@pytest.mark.parametrize("model", ["prior", "poisoned", "tight"])
@pytest.mark.parametrize("qname", QUERIES)
def test_enumerate_candidates_match(pkgs, qname, model):
    """Equal rosters: Γs, swapped symbols and modeled seconds (1e-12
    relative), under the prior, the poisoned table and a band of 0."""
    lists = []
    for pkg in pkgs:
        delta = poisoned_delta(pkg) if model == "poisoned" else pkg.C.AnalyticCostModel()
        band, top_k = (0.0, 5) if model == "tight" else (1e6, 6)
        cands = pkg.A.enumerate_candidates(pkg.REG[qname].llql(), pkg.sigma, delta, band=band, top_k=top_k)
        lists.append([(c.key, c.swapped, c.modeled_s) for c in cands])
    (rl, tl) = lists
    assert [(k, s) for k, s, _ in tl] == [(k, s) for k, s, _ in rl]
    np.testing.assert_allclose([m for *_, m in tl], [m for *_, m in rl], rtol=1e-12, atol=0)
    if model == "tight":  # the winner and its ties only (q1: the winner alone)
        assert tl[0][1] == "" and all(m <= tl[0][2] for *_, m in tl)
        assert qname != "q1" or len(tl) == 1
    else:
        assert len(tl) >= 2


# -- races under a fake clock -------------------------------------------------


def fake_clock(monkeypatch, pkg, ht_s=10e-3, st_s=1e-3):
    """Patch ``pkg``'s adapt module's ``time`` with a clock that moves only
    when a planner executor runs: by ``ht_s`` a hash-family symbol of its Γ
    and ``st_s`` a sorted-family one (hash plans measure slow)."""
    t = [0.0]
    real = pkg.S._ParamRunner.__call__

    def call(self, params=None):
        out = real(self, params)
        t[0] += sum(ht_s if c.ds.startswith("ht") else st_s for c in self.choices.values())
        return out

    monkeypatch.setattr(pkg.S._ParamRunner, "__call__", call)
    monkeypatch.setattr(pkg.A, "time", SimpleNamespace(perf_counter=lambda: t[0]))


def race_view(planner):
    return [
        (rec.bucket, rec.winner_key,
         [(ln.candidate.key, ln.candidate.swapped, ln.measured_s, ln.validated) for ln in rec.lanes])
        for rec in planner.races
    ]


@pytest.mark.parametrize("qname", ["q3", "q18"])
def test_fake_clock_races_match_and_converge(pkgs, monkeypatch, qname):
    """The poisoned model (hash ops ~100× underpriced) picks hash
    dictionaries; the clock measures sorted ones faster.  Both packages
    race the same lanes, measure the same seconds, install the same winners
    and learn the same corrections; the served plan leaves the poisoned
    choice within the warm-up rounds and the corrected model re-ranks."""
    views = []
    for pkg in pkgs:
        fake_clock(monkeypatch, pkg)
        delta = poisoned_delta(pkg)
        poisoned = dict(pkg.SYN.synthesize(pkg.REG[qname].llql(), pkg.sigma, delta).choices)
        assert all(c.ds.startswith("ht") for c in poisoned.values()), "poison did not take"
        s = pkg.connect(adapt=pkg.A.AdaptConfig(**POISONED), delta=delta)
        for _ in range(5):
            s.query(qname)
        shape = s.shape(qname)
        assert shape.choices != poisoned
        assert any(c.ds.startswith("st") for c in shape.choices.values())
        assert len(shape.planner.races) == 4  # warmup=4: the shape's race and three requests'
        assert dict(pkg.SYN.synthesize(pkg.REG[qname].llql(), pkg.sigma, delta).choices) != poisoned
        views.append((race_view(shape.planner), {k[1]: pkg.A.choices_key(v) for k, v in shape.planner.winners.items()},
                      pkg.A.choices_key(shape.choices), dict(delta.corrections)))
    (r_races, r_win, r_served, r_corr), (t_races, t_win, t_served, t_corr) = views
    assert t_served == r_served and t_win == r_win
    assert [(b, w, [(k, s, v) for k, s, _, v in lanes]) for b, w, lanes in t_races] == \
        [(b, w, [(k, s, v) for k, s, _, v in lanes]) for b, w, lanes in r_races]
    np.testing.assert_allclose([m for *_, lanes in t_races for _, _, m, _ in lanes],
                               [m for *_, lanes in r_races for _, _, m, _ in lanes], rtol=1e-12)
    assert t_corr.keys() == r_corr.keys() and t_corr
    np.testing.assert_allclose([t_corr[k] for k in sorted(t_corr)], [r_corr[k] for k in sorted(r_corr)], rtol=1e-9)
    assert max(v for k, v in t_corr.items() if k[0].startswith("ht")) > 10.0


@pytest.mark.parametrize("device,validated", [("cpu", [True, False, False]), ("cuda", [True, True, False])])
def test_lanes_validate_by_the_device_rule(pkgs, monkeypatch, device, validated):
    """A lane one float ulp off the model's lane is rejected on the CPU and
    accepted on the card; a lane with another key set is rejected on
    both.  (No card is needed: the planner only reads the device's type.)"""
    _, port = pkgs
    monkeypatch.setattr(port.A, "_sync", lambda device: None)
    base = np.asarray([1.0, 2.0], np.float32)
    outs = iter([
        {1: base}, {1: np.nextafter(base, np.float32(3.0))}, {2: base},
    ])
    results = {}

    def make_executor(choices):
        out = results.setdefault(port.A.choices_key(choices), next(outs))
        return lambda params=None: out

    planner = port.A.AdaptivePlanner(
        port.REG["q3"].llql(), port.sigma, port.C.AnalyticCostModel(), make_executor,
        config=port.A.AdaptConfig(band=1e6, top_k=3, repeats=1), device=device,
    )
    rec = planner.race({})
    assert [ln.validated for ln in rec.lanes] == validated
    assert all(ln.first_s >= 0.0 for ln in rec.lanes)
    assert rec.winner.validated


# -- sessions -----------------------------------------------------------------


@pytest.mark.parametrize("qname", QUERIES)
def test_session_races_and_serves_like_the_reference(pkgs, qname):
    """Every raced lane validates bitwise on the CPU (>= 2 lanes a query);
    the adaptive sessions serve the reference's results at two bindings;
    ``explain()["races"]`` has the reference's structure and lanes."""
    ref, port = pkgs
    rs = ref.connect(adapt=ref.A.AdaptConfig(**WIDE))
    ts = port.connect(adapt=port.A.AdaptConfig(**WIDE))
    for params in ({}, OTHER[qname]):
        same_items(ts.query(qname, **params), rs.query(qname, **params))
    same_items(ts.query(qname), TREG[qname].reference(port.db, **TREG[qname].defaults))
    planner = ts.shape(qname).planner
    for rec in planner.races:
        assert len(rec.lanes) >= 2
        assert all(ln.validated for ln in rec.lanes), [ln.candidate.swapped for ln in rec.lanes]
        assert rec.winner is not None and rec.winner.measured_s < float("inf")
    rx, tx = rs.explain(qname), ts.explain(qname)
    assert len(tx["races"]) == len(rx["races"])
    for r, t in zip(rx["races"], tx["races"]):
        assert t.keys() == r.keys() and t["bucket"] == r["bucket"]
        assert [sorted(ln) for ln in t["lanes"]] == [sorted(ln) for ln in r["lanes"]]
    # the first race ran before any correction: equal rosters and verdicts
    first = [(ln["swapped"], ln["validated"], ln["modeled_ms"]) for ln in tx["races"][0]["lanes"]]
    assert first == [(ln["swapped"], ln["validated"], ln["modeled_ms"]) for ln in rx["races"][0]["lanes"]]
    assert ts.shape(qname).synth_runs == len(planner.races)


def test_steady_state_does_not_rerace_or_rebuild(pkgs):
    """``tests/test_adapt.py::test_warm_cache_no_replanning`` through both
    packages: equal race counts at each step."""
    counts = []
    for pkg in pkgs:
        s = pkg.connect(adapt=pkg.A.AdaptConfig(band=50.0, top_k=2, warmup=1, repeats=1))
        s.query("q18")
        planner = s.shape("q18").planner
        after_warmup = len(planner.races)
        ex = s.shape("q18").executable
        traces = ex.trace_count
        for _ in range(5):
            s.query("q18")
        assert len(planner.races) == after_warmup, "steady state re-raced"
        assert s.shape("q18").executable is ex and ex.trace_count == traces
        s.query("q18", threshold=2.0)  # a new bucket: one race
        s.query("q18", threshold=2.1)  # the same bucket: none
        assert len(planner.races) == after_warmup + 1
        counts.append((after_warmup, len(planner.races), s.shape("q18").synth_runs))
    assert counts[0] == counts[1]


@pytest.mark.parametrize("qname", ["q1", "q3"])
def test_streamed_session_races_and_serves(pkgs, qname):
    """A budget session (lineitem chunked at 1,024 rows) races streamed
    executables, validates every lane and serves the reference's streamed
    adaptive result and the port's resident one."""
    ref, port = pkgs
    cfg = dict(band=50.0, top_k=2, warmup=1, repeats=1)
    rs = ref.connect(memory_budget=1, chunk_rows=1024, adapt=ref.A.AdaptConfig(**cfg))
    ts = port.connect(memory_budget=1, chunk_rows=1024, adapt=port.A.AdaptConfig(**cfg))
    got = ts.query(qname)
    assert "lineitem" in ts.streamed
    assert any(m.startswith("streamed") for m in ts.report().modes().values()), ts.report().modes()
    same_items(got, rs.query(qname))
    same_items(got, port.connect().query(qname))
    rec = ts.shape(qname).planner.races[0]
    assert len(rec.lanes) == 2 and all(ln.validated for ln in rec.lanes)
    assert [ln.candidate.swapped for ln in rec.lanes] == [ln.candidate.swapped for ln in rs.shape(qname).planner.races[0].lanes]


def test_query_server_counts_the_race(pkgs):
    """A ``QueryServer`` over an adaptive session: the cold path runs the
    warm-up race, ``synth_runs`` counts its enumerations as the
    reference's server does, and the responses match."""
    done, stats = [], []
    for pkg in pkgs:
        s = pkg.connect(adapt=pkg.A.AdaptConfig(**WIDE))
        srv = pkg.QS.QueryServer(s, max_batch=4)
        for q, p in [("q1", {}), ("q3", {"date": 0.05}), ("q18", {}), ("q1", {"date": 0.7}), ("q18", {"threshold": 150.0})]:
            srv.submit(q, **p)
        done.append(srv.run_until_done())
        st = srv.stats()
        assert st["synth_runs"] == sum(len(s.shape(q).planner.races) for q in ("q1", "q3", "q18"))
        stats.append({k: st[k] for k in ("synth_runs", "cold_compiles", "responses", "batches", "errors")})
    assert stats[0] == stats[1]
    for r, t in zip(*done):
        assert (t.rid, t.qname, t.ok) == (r.rid, r.qname, r.ok)
        same_items(t.result, r.result)


# -- faults -------------------------------------------------------------------


def fault_during_race(pkg, point, error):
    """A fault armed while the warm-up race runs: the race calls executors
    outside the ladder, so the typed error reaches the caller, no fault is
    counted, no shape is kept; disarmed, the query races and serves."""
    s = pkg.connect(adapt=pkg.A.AdaptConfig(**WIDE))
    with pkg.faults.injected(point, mode="always", error=error):
        with pytest.raises(Exception) as ei:
            s.query("q1")
    obs = [type(ei.value).__name__, dict(s.fault_stats), sorted(s._shapes)]
    got = s.query("q1")
    obs.append((len(s.shape("q1").planner.races), s.report().degraded))
    return got, obs


def reinstalled_winner_descends(pkg, monkeypatch):
    """Under the poisoned model and the fake clock, the races move q3's
    winner; an OOM at ``kernel-launch`` then sends the reinstalled winner
    down the ladder, where its result is held against the primary results
    kept before and after the reinstall, and passes."""
    fake_clock(monkeypatch, pkg)
    s = pkg.connect(adapt=pkg.A.AdaptConfig(**POISONED), delta=poisoned_delta(pkg))
    first = s.shape("q3").choices
    for _ in range(4):
        s.query("q3")
    moved = s.shape("q3").choices != first
    with pkg.faults.injected("kernel-launch", mode="always", error="oom"):
        got = s.query("q3")
    rep = s.report()
    return got, [moved, rep.degradation, rep.degraded, dict(s.fault_stats)]


@pytest.mark.parametrize("point,error", [("kernel-launch", None), ("kernel-launch", "oom"), ("fused-region", "oom")])
def test_fault_during_a_race_propagates(pkgs, point, error):
    (rgot, robs), (tgot, tobs) = (fault_during_race(pkg, point, error) for pkg in pkgs)
    assert tobs == robs
    assert tobs[1] == {"faults": 0, "retries": 0, "degraded": 0} and tobs[2] == []
    same_items(tgot, rgot)


def test_reinstalled_winner_descends_the_ladder(pkgs, monkeypatch):
    (rgot, robs), (tgot, tobs) = (reinstalled_winner_descends(pkg, monkeypatch) for pkg in pkgs)
    assert tobs == robs and tobs[0] and tobs[2] > 0
    same_items(tgot, rgot)
    same_items(tgot, TREG["q3"].reference(pkgs[1].db, **TREG["q3"].defaults))
