"""The port's ``QueryServer`` against ``repro``'s: the scenarios of the
reference's serving and server-fault suites through both packages' servers
on the same numpy data, with injected clocks, must give the same responses
in the same order (rid, ok, error type and wire kind, batch size, retries,
rung) and the same counters, and results that agree at the suite's
tolerance.  Also the batched executor: ``call_batched`` against one call a
request, one ``kernel-launch`` check a batch, ``BoundExecutable`` and the
executable cache's hit and miss counts."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro
from repro import errors as rerrors
from repro.core import plan as RP
from repro.core.lower import compile as rcompile
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rcollect
from repro.exec import engine as RE
from repro.exec.queries import QUERIES as RQ
from repro.serve import query_server as RQS
from repro.testing import faults as rfaults

import repro_torch
from repro_torch import errors as terrors
from repro_torch import session as TS
from repro_torch.core import llql as TL
from repro_torch.core import plan as TP
from repro_torch.core.lower import compile as tcompile
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tcollect
from repro_torch.exec import engine as TE
from repro_torch.exec.queries import QUERIES as TQ
from repro_torch.serve import query_server as TQS
from repro_torch.testing import faults as tfaults

RTOL, ATOL = 3e-3, 3e-2
COUNTERS = ("requests", "responses", "batches", "shared_batches", "retries", "faults", "degraded",
            "rejected", "shed_deadline", "invalid", "errors")


@pytest.fixture(autouse=True)
def _clean_faults():
    rfaults.disarm()
    tfaults.disarm()
    yield
    rfaults.disarm()
    tfaults.disarm()


@pytest.fixture(scope="module")
def pkgs():
    rdb = rtpch.generate(scale=0.002, seed=3).tables()
    tdb = from_reference(rdb, device="cpu")
    ref = SimpleNamespace(
        name="repro", faults=rfaults, errors=rerrors, E=RE, QS=RQS, Q=RQ, db=rdb,
        connect=lambda **kw: repro.connect(dict(rdb), **kw),
    )
    port = SimpleNamespace(
        name="repro_torch", faults=tfaults, errors=terrors, E=TE, QS=TQS, Q=TQ, db=tdb,
        connect=lambda **kw: repro_torch.connect(dict(tdb), device="cpu", **kw),
    )
    return ref, port


def ticking(start=100.0, step=1e-3):
    """A server clock that moves ``step`` seconds a reading."""
    t = [start]

    def clock():
        t[0] += step
        return t[0]

    clock.t = t
    return clock


def _server(pkg, queries=("q1", "q18"), **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("backoff_s", 1e-4)
    kw.setdefault("backoff_cap_s", 1e-3)
    kw.setdefault("clock", ticking())
    return pkg.QS.QueryServer(pkg.connect(), queries={q: pkg.Q[q] for q in queries}, **kw)


def _dates(n):
    return [round(0.5 + 0.02 * i, 3) for i in range(n)]


# -- the scenarios: each returns the drained server --------------------------


def mixed_workload(pkg):
    srv = _server(pkg)
    for qname, params in (("q18", {"threshold": 150.0}), ("q18", {"threshold": 80.0}), ("q1", {"date": 0.5}),
                          ("q18", {"threshold": 200.0}), ("q1", {})):
        srv.submit(qname, **params)
    srv.run_until_done()
    return srv


def warm_path(pkg):
    srv = _server(pkg, queries=("q3",), max_batch=2)
    srv.warm_up()
    traces = srv._shapes["q3"].executable.trace_count
    for date in (0.05, 0.1, 0.15, 0.2):
        srv.submit("q3", date=date)
        srv.step()
    assert srv._shapes["q3"].executable.trace_count == traces
    assert srv.counters["synth_runs"] == 1 and all(r.warm for r in srv.finished)
    return srv


def microbatches(pkg):
    srv = _server(pkg)
    for t in (150.0, 120.0, 90.0, 60.0, 200.0):
        srv.submit("q18", threshold=t)
    srv.submit("q1", date=0.5)
    steps = [len(srv.step()) for _ in range(4)]
    assert steps == [4, 1, 1, 0]
    return srv


def counters_and_stats(pkg):
    pkg.E.clear_exec_cache()
    srv = _server(pkg, queries=("q1",), max_batch=2)
    srv.submit("q1", date=0.7)  # cold
    srv.step()
    srv.submit("q1", date=0.4)
    srv.step()
    s = srv.stats()
    assert s["cold_compiles"] == 1 and s["synth_runs"] == 1 and s["queued"] == 0
    assert s["cold_p50_ms"] > 0 and s["warm_p50_ms"] > 0 and s["warm_rps"] > 0
    assert s["shapes"]["q1"]["served"] == 2
    return srv


def round_fairness(pkg):
    srv = _server(pkg)
    srv.submit("q18", threshold=150.0)
    srv.submit("q18", threshold=120.0)
    srv.submit("q1", date=0.5)
    srv.step()
    for t in (90.0, 60.0, 30.0):  # a burst of the hot shape mid-round
        srv.submit("q18", threshold=t)
    srv.run_until_done()
    return srv


def share_scans(pkg):
    srv = _server(pkg, share_scans=True)
    srv.warm_up()
    for qname, params in (("q1", {"date": 0.5}), ("q18", {"threshold": 150.0}), ("q1", {"date": 0.9})):
        srv.submit(qname, **params)
    assert len(srv.step()) == 3  # one cross-query batch, demultiplexed
    return srv


def share_scans_off(pkg):
    srv = _server(pkg)
    srv.submit("q1", date=0.5)
    srv.submit("q18", threshold=150.0)
    srv.run_until_done()
    return srv


def retried_once(pkg):
    srv = _server(pkg)
    srv.warm_up(["q1"])
    with pkg.faults.injected("kernel-launch", mode="once"):
        srv.submit("q1", date=_dates(1)[0])
        srv.step()
    return srv


def persistent_oom(pkg):
    srv = _server(pkg)
    srv.warm_up(["q1"])
    with pkg.faults.injected("kernel-launch", mode="always", error="oom"):
        srv.submit("q1", date=_dates(1)[0])
        srv.step()
    return srv


def expired_deadline(pkg):
    srv = _server(pkg)
    srv.warm_up(["q1"])
    srv.submit("q1", deadline_s=0.0, date=0.9)
    srv.step()
    srv.submit("q1", date=0.7)
    srv.step()
    return srv


def predicted_miss(pkg):
    srv = _server(pkg)
    srv.warm_up(["q1"])
    srv.submit("q1", date=0.9)
    srv.step()  # the warm batch-wall EWMA
    srv._shapes["q1"].ewma_s = 10.0
    calls = srv._shapes["q1"].executable.calls
    srv.submit("q1", deadline_s=1.0, date=0.91)
    (resp,) = srv.step()
    assert resp.error.predicted_s == 10.0
    assert srv._shapes["q1"].executable.calls == calls  # shed before execution
    return srv


def admission(pkg):
    srv = _server(pkg, max_queue=2)
    srv.warm_up(["q1"])
    srv.submit("q1", date=0.5)
    srv.submit("q1", date=0.51)
    with pytest.raises(pkg.errors.AdmissionRejected) as ei:
        srv.submit("q1", date=0.52)
    assert ei.value.queue_depth == 2 and ei.value.retry_after_s > 0
    srv.run_until_done()
    return srv


def malformed(pkg):
    srv = _server(pkg)
    srv.warm_up(["q1"])
    for d in (0.7, float("nan"), 0.8):
        srv.submit("q1", date=d)
    srv.step()
    return srv


def clock_sweep(pkg):
    srv = _server(pkg, clock=ticking(step=0.0))
    srv.warm_up(["q1"])
    srv.submit("q1", deadline_s=5.0, date=0.7)
    srv._clock.t[0] += 10.0  # the deadline passes without sleeping
    (resp,) = srv.step()
    assert resp.latency_s == pytest.approx(10.0)
    return srv


def cold_retry_hint(pkg):
    srv = _server(pkg, max_queue=1)
    srv.submit("q1", date=0.5)
    with pytest.raises(pkg.errors.AdmissionRejected) as ei:
        srv.submit("q1", date=0.51)
    assert ei.value.retry_after_s == pytest.approx(pkg.QS.COLD_RETRY_AFTER_S)
    assert ei.value.to_dict()["kind"] == "AdmissionRejected"
    srv.run_until_done()
    return srv


SCENARIOS = {
    f.__name__: f for f in (
        mixed_workload, warm_path, microbatches, counters_and_stats, round_fairness, share_scans,
        share_scans_off, retried_once, persistent_oom, expired_deadline, predicted_miss, admission,
        malformed, clock_sweep, cold_retry_hint,
    )
}


def _responses(srv):
    return [
        (r.rid, r.qname, r.ok, type(r.error).__name__ if r.error is not None else None,
         (r.error_info or {}).get("kind"), r.batch_size, r.retries, r.degraded)
        for r in srv.finished
    ]


def _close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_server_matches_reference(name, pkgs):
    ref, port = pkgs
    rsrv, tsrv = SCENARIOS[name](ref), SCENARIOS[name](port)
    assert _responses(tsrv) == _responses(rsrv)
    assert {k: tsrv.counters[k] for k in COUNTERS} == {k: rsrv.counters[k] for k in COUNTERS}
    assert tsrv.stats()["queued"] == rsrv.stats()["queued"] == 0
    for t, r in zip(tsrv.finished, rsrv.finished):
        if r.ok:
            _close(t.result, r.result, f"{name}: rid {r.rid}")
        else:
            assert t.error_info["transient"] == r.error_info["transient"]


def test_raw_db_shim_opens_a_session_on_the_card(pkgs, monkeypatch):
    _, port = pkgs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQS.QueryServer(port.db)


def test_wire_form_error_info(pkgs):
    _, port = pkgs
    srv = _server(port)
    srv.warm_up(["q1"])
    srv.submit("q1", deadline_s=0.0, date=0.9)
    (resp,) = srv.step()
    assert resp.error_info["kind"] == "DeadlineExceeded" and resp.error_info["transient"] is False
    assert resp.error_info["deadline_s"] == 0.0
    assert isinstance(terrors.from_dict(resp.error_info), terrors.DeadlineExceeded)
    srv.submit("q1", date=0.7)
    (ok,) = srv.step()
    assert ok.ok and ok.error_info is None


def test_share_scans_equals_per_query_serving(pkgs):
    _, port = pkgs
    shared, plain = SCENARIOS["share_scans"](port), SCENARIOS["share_scans_off"](port)
    assert shared.counters["shared_batches"] == 1
    plain_srv = _server(port)
    for r in shared.finished:
        plain_srv.submit(r.qname, **r.params)
    by_rid = {r.rid: r for r in plain_srv.run_until_done()}
    for r in shared.finished:
        assert TS.bitwise_equal(r.result, by_rid[r.rid].result)
    assert plain.counters["shared_batches"] == 0


@pytest.mark.parametrize("name,n,queries,rate,seed", [
    ("chaos", 24, ("q1",), 0.1, 5),
    ("env_matrix_chaos", 16, ("q1", "q18"), 0.15, 9),
])
def test_chaos_every_request_terminates(name, n, queries, rate, seed, pkgs):
    # the two packages pass their fault points a different number of times,
    # so their rate draws differ: only termination is held across them
    for pkg in pkgs:
        clean = _server(pkg, queries=queries)
        chaos = _server(pkg, queries=queries, seed=1)
        chaos.warm_up(["q1"])  # q18, where served, stays cold
        reqs = [("q1", {"date": d}) for d in _dates(12 if len(queries) > 1 else n)]
        reqs += [("q18", {"threshold": 100.0 + i}) for i in range(n - len(reqs))]
        for srv in (clean, chaos):
            if srv is chaos:
                armed = pkg.faults.arm("kernel-launch", mode="rate", rate=rate, seed=seed)
            try:
                for qname, params in reqs:
                    srv.submit(qname, **params)
                srv.run_until_done()
            finally:
                pkg.faults.disarm()
        stats = chaos.stats()
        assert stats["responses"] == n and stats["queued"] == 0 and len(chaos.finished) == n
        assert armed.hits > 0
        want = {r.rid: r for r in clean.finished}
        for r in chaos.finished:
            if r.ok:
                assert TS.bitwise_equal(r.result, want[r.rid].result)
            else:
                assert isinstance(r.error, pkg.errors.ReproError)
        if name == "chaos":
            assert stats["faults"] > 0


# -- the batched executor ----------------------------------------------------


BINDINGS = {
    "q1": [{"date": 0.5}, {"date": 0.7}, {"date": 0.9}],
    "q3": [{"date": 0.1}, {"date": 0.2}],
    "q5": [{"region": 1}, {"region": 2}, {"region": 3}],
    "q9": [{"color": 2}, {"color": 3}],
    "q18": [{"threshold": 100.0}, {"threshold": 250.0}],
}


@pytest.mark.parametrize("qname", sorted(BINDINGS))
def test_call_batched_equals_one_call_a_request(qname, pkgs):
    _, port = pkgs
    s = port.connect()
    shape = s.shape(qname)
    ex = shape.executable
    assert ex.vmapped_batches is False
    params = [shape.query.bind_defaults(p) for p in BINDINGS[qname]]
    assert ex.call_batched(s.db, []) == []
    with tfaults.injected("kernel-launch", mode="nth", n=10**9) as spec:
        batched = ex.call_batched(s.db, params)
    assert spec.hits == 1  # once a batch
    for p, got in zip(params, batched):
        assert TS.bitwise_equal(TS.result_items(got), TS.result_items(ex(s.db, p)))


def test_batch_checks_kernel_launch_once_as_the_reference(pkgs):
    hits = {}
    for pkg in pkgs:
        s = pkg.connect()
        shape = s.shape("q1")
        params = [shape.query.bind_defaults({"date": d}) for d in _dates(4)]
        shape.executable.call_batched(s.db, params)  # a vmapped bucket traces once
        with pkg.faults.injected("kernel-launch", mode="nth", n=10**9) as spec:
            shape.executable.call_batched(s.db, params)
        hits[pkg.name] = spec.hits
        # a `once` fault fails the whole batch
        with pkg.faults.injected("kernel-launch", mode="once"):
            with pytest.raises(pkg.errors.FaultInjected):
                shape.executable.call_batched(s.db, params)
    assert hits == {"repro": 1, "repro_torch": 1}


def test_plan_without_params_runs_once_for_a_batch(pkgs):
    _, port = pkgs
    s = port.connect()
    ex = s.shape(TL.bind_params(TQ["q1"].llql(), {"date": 0.7})).executable
    assert not ex.plan.params
    calls = ex.calls
    out = ex.call_batched(s.db, [None, None, None])
    assert ex.calls == calls + 1 and out[0] is out[1] is out[2]


def test_bound_executable_overrides_bound_params(pkgs):
    _, port = pkgs
    s = port.connect()
    plan = s.shape("q1").plan
    bex = TE.cached_executable(TP.BoundPlan(plan, (("date", 0.6),)), s.db, sigma=s.sigma)
    assert isinstance(bex, TE.BoundExecutable)
    assert bex.executable is TE.cached_executable(plan, s.db, sigma=s.sigma)
    assert bex.plan == plan and bex.vmapped_batches is False
    bound = TS.result_items(bex(s.db))
    assert TS.bitwise_equal(bound, s.query("q1", date=0.6))
    assert TS.bitwise_equal(TS.result_items(bex(s.db, {"date": 0.8})), s.query("q1", date=0.8))
    batch = bex.call_batched(s.db, [None, {"date": 0.8}])
    assert TS.bitwise_equal(TS.result_items(batch[0]), bound)
    assert TS.bitwise_equal(TS.result_items(batch[1]), s.query("q1", date=0.8))
    assert bex.trace_count == 1 and bex.last_report is bex.executable.last_report


def test_exec_cache_stats_match_reference(pkgs):
    ref, port = pkgs
    stats = {}
    for pkg, P, compile_plan, collect in ((ref, RP, rcompile, rcollect), (port, TP, tcompile, tcollect)):
        pkg.E.clear_exec_cache()
        assert pkg.E.exec_cache_stats() == {"hits": 0, "misses": 0, "entries": 0}
        sigma = collect(pkg.db)
        plans = {q: P.fuse(compile_plan(pkg.Q[q].llql(), {}), sigma=sigma) for q in ("q1", "q18")}
        seq = []
        for q in ("q1", "q1", "q18", "q1", "q18"):
            pkg.E.cached_executable(plans[q], pkg.db, sigma=sigma)
            seq.append(dict(pkg.E.exec_cache_stats()))
        pkg.E.cached_executable(P.BoundPlan(plans["q1"], (("date", 0.5),)), pkg.db, sigma=sigma)
        seq.append(dict(pkg.E.exec_cache_stats()))
        stats[pkg.name] = seq
        pkg.E.clear_exec_cache()
        assert pkg.E.exec_cache_stats() == {"hits": 0, "misses": 0, "entries": 0}
    assert stats["repro_torch"] == stats["repro"]
    assert stats["repro"][-1] == {"hits": 4, "misses": 2, "entries": 2}
