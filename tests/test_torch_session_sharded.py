"""Sharded sessions of the port against ``repro``'s: ``connect(db,
shards=N)`` serving the five TPC-H queries, the ``QueryServer`` over them
(micro-batches, chaos, the ``share_scans`` refusal), the sharded ladder
(fused-sharded → materialized-sharded → single-shard), ``memory_budget``
with ``shards``, the report's shard count and the adaptive 4-shard races
— the scenarios of ``tests/test_serve_sharded.py`` and
``tests/test_distributed_tpch.py:176-209``.

``repro`` shards only over several devices, so its side of each scenario
runs once in a subprocess with 8 host devices, through the same scenario
functions (this module, imported there), and pickles what it saw; the
port runs on the CPU with every shard on the host.  Within the port the
sharded rungs and every raced lane agree bit for bit; across packages, and
against the single-shard rung, key sets are exact and float lanes within
rtol=3e-3, atol=3e-2."""
import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

import repro
from repro.data import tpch as rtpch

import repro_torch
from repro_torch import errors as terrors
from repro_torch.core.adapt import AdaptConfig as TAdaptConfig
from repro_torch.core.adapt import result_items as tresult_items
from repro_torch.data.interop import from_reference
from repro_torch.exec import engine as TE
from repro_torch.exec.queries import REGISTRY as TREG
from repro_torch.serve.query_server import QueryServer as TQueryServer
from repro_torch.testing import faults as tfaults

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RTOL, ATOL = 3e-3, 3e-2
SCALE, SEED = 0.002, 3
QUERIES = sorted(TREG)
RACE = dict(band=50.0, top_k=2, warmup=1, repeats=1)


def _port():
    tdb = from_reference(rtpch.generate(scale=SCALE, seed=SEED).tables(), device="cpu")
    return SimpleNamespace(
        name="repro_torch", faults=tfaults, errors=terrors, E=TE, QueryServer=TQueryServer,
        AdaptConfig=TAdaptConfig, result_items=tresult_items, db=tdb,
        connect=lambda **kw: repro_torch.connect(dict(tdb), device="cpu", **kw),
    )


def _reference():
    """The reference package's namespace (needs 8 devices: subprocess only)."""
    from repro import errors
    from repro.core.adapt import AdaptConfig, result_items
    from repro.exec import engine as E
    from repro.serve.query_server import QueryServer
    from repro.testing import faults

    rdb = rtpch.generate(scale=SCALE, seed=SEED).tables()
    return SimpleNamespace(
        name="repro", faults=faults, errors=errors, E=E, QueryServer=QueryServer, AdaptConfig=AdaptConfig,
        result_items=result_items, db=rdb, connect=lambda **kw: repro.connect(dict(rdb), **kw),
    )


# -- the scenarios: each runs in either package and returns what it saw ----


def sharded_results(pkg, shards=2):
    """Each query through a sharded session: its result and the report."""
    sess = pkg.connect(shards=shards)
    out = {}
    for qname in QUERIES:
        got = sess.query(qname)
        rep = sess.report()
        out[qname] = (got, rep.shards, rep.degraded, sess.explain(qname)["shards"])
    return out


def ladder(pkg):
    """The reference suite's ladder: a persistent ``shard-exec`` OOM served
    by single-shard; a primary rung broken by transient faults served by
    materialized-sharded."""
    sess = pkg.connect(shards=2)
    server = pkg.QueryServer(sess, max_batch=2, max_retries=1, backoff_s=1e-4, backoff_cap_s=1e-3)
    server.warm_up(["q1"])
    ref1 = sess.query("q1")
    with pkg.faults.injected("shard-exec", mode="always", error="oom"):
        server.submit("q1")
        (resp,) = server.step()
    single = (resp.ok, resp.degraded, server.counters["degraded"], sorted({m for _, m in sess.breakers()}),
              dict(sess.fault_stats))

    sess2 = pkg.connect(shards=2)
    shape = sess2.shape("q5")
    ref5 = sess2.query("q5")
    transient = []
    for _ in range(sess2.breaker_threshold):
        with pkg.faults.injected("shard-exec", mode="once"):
            try:
                sess2.execute_shape(shape, shape.query.bind_defaults({}))
            except pkg.errors.ReproError as e:
                transient.append(pkg.errors.is_transient(e))
    out5 = sess2.execute_shape(shape, shape.query.bind_defaults({}))
    mx = shape.mode_ex["materialized-sharded"][0]
    materialized = (transient, sorted({m for _, m in sess2.breakers()}), pkg.E.last_report().degradation,
                    mx.fused_regions, mx.n_shards, dict(sess2.fault_stats))
    return {"single": single, "single_result": (resp.result, ref1), "materialized": materialized,
            "materialized_result": (pkg.result_items(out5), ref5)}


def races(pkg):
    """Adaptive 4-shard sessions racing every query on a wide band."""
    sess = pkg.connect(shards=4, adapt=pkg.AdaptConfig(**RACE))
    out = {}
    for qname in QUERIES:
        got = sess.query(qname)
        planner = sess.shape(qname).planner
        lanes = [[(ln.candidate.swapped, {s: str(c) for s, c in sorted(ln.candidate.choices.items())},
                   ln.validated) for ln in rec.lanes] for rec in planner.races]
        out[qname] = (got, lanes, sess.report().shards)
    return out


def share_scans_refused(pkg):
    with pytest.raises(pkg.errors.UnsupportedSessionError) as ei:
        pkg.QueryServer(pkg.connect(shards=2), share_scans=True)
    return str(ei.value)


REFERENCE_JOB = """
import pickle, sys
sys.path.insert(0, %r)
import test_torch_session_sharded as T
pkg = T._reference()
out = {"results": T.sharded_results(pkg), "ladder": T.ladder(pkg), "races": T.races(pkg),
       "share_scans": T.share_scans_refused(pkg)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % HERE


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """What the reference saw in each scenario, from one 8-device
    subprocess."""
    path = tmp_path_factory.mktemp("ref_sharded") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC)
    env.pop("REPRO_FAULTS", None)  # the scenarios arm their own faults
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_JOB), str(path)],
                          capture_output=True, text=True, env=env, timeout=540, cwd=HERE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)  # written by the job above


@pytest.fixture(scope="module")
def port():
    return _port()


@pytest.fixture(autouse=True)
def _clean():
    tfaults.disarm()
    yield
    tfaults.disarm()


def _close(got, want, what):
    assert set(got) == set(want), f"{what}: key sets differ ({len(got)} vs {len(want)})"
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}/{k}")


def _bitwise(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), f"{what}/{k}"


def test_sharded_session_matches_reference(ref, port):
    got = sharded_results(port)
    for qname in QUERIES:
        res, shards, degraded, explained = got[qname]
        want = ref["results"][qname]
        assert (shards, degraded, explained) == want[1:] == (2, 0, 2), qname
        _close(res, want[0], f"{qname} vs repro")
        q = TREG[qname]
        _close(res, q.reference(port.db, **q.defaults), f"{qname} vs numpy")


@pytest.mark.parametrize("shards", [2, 4])
def test_served_sharded_in_batches(port, shards):
    """A ``QueryServer`` over a sharded session serves every query in
    micro-batches: responses bit for bit the session's, close to a
    single-device server's, no rebuild under more warm traffic."""
    sess = port.connect(shards=shards)
    server = TQueryServer(sess, max_batch=4)
    server.warm_up()
    single = TQueryServer(port.connect(), max_batch=4)
    single.warm_up()
    for qname in QUERIES:
        for srv in (server, single):
            for _ in range(3):
                srv.submit(qname)
    server.run_until_done()
    single.run_until_done()
    assert all(r.ok for r in server.finished), [r.error for r in server.finished if not r.ok]
    ref = {r.qname: r.result for r in single.finished}
    traces = {}
    for qname in QUERIES:
        rs = [r for r in server.finished if r.qname == qname]
        assert len(rs) == 3 and all(r.batch_size == 3 for r in rs)
        direct = sess.query(qname)
        for r in rs:
            _bitwise(r.result, direct, f"{qname} served vs session")
            _close(r.result, ref[qname], f"{qname} served vs single-device")
        ex = sess.shape(qname).executable
        assert ex.n_shards == shards and not ex.vmapped_batches
        traces[qname] = ex.trace_count
    for qname in QUERIES:
        server.submit(qname)
    server.run_until_done()
    assert {q: sess.shape(q).executable.trace_count for q in QUERIES} == traces
    stats = server.stats()
    assert stats["responses"] == 4 * len(QUERIES) and stats["queued"] == 0 and stats["errors"] == 0


def test_sharded_chaos_every_request_terminates(port):
    """``shard-exec`` at rate 0.1: every request ends in a result equal to
    the clean run's or a typed error."""
    sess = port.connect(shards=2)
    server = TQueryServer(sess, max_batch=4, backoff_s=1e-4, backoff_cap_s=1e-3)
    server.warm_up()
    clean = {q: sess.query(q) for q in QUERIES}
    with tfaults.injected("shard-exec", mode="rate", rate=0.1, seed=3):
        for qname in QUERIES:
            for _ in range(4):
                server.submit(qname)
        server.run_until_done()
    stats = server.stats()
    n = 4 * len(QUERIES)
    assert stats["responses"] == n and stats["queued"] == 0 and len(server.finished) == n
    for r in server.finished:
        if r.ok:
            _close(r.result, clean[r.qname], f"chaos {r.qname}")
        else:
            assert isinstance(r.error, terrors.ReproError) and r.error_info["kind"], r.error
    assert stats["faults"] > 0


def test_sharded_ladder_descends_like_the_reference(ref, port):
    got = ladder(port)
    # a persistent shard-exec OOM poisons both sharded rungs: single-shard
    # serves, within the cross-executor tolerance of the sharded primary
    assert got["single"][:4] == (True, "single-shard", 1, ["fused-sharded", "materialized-sharded"])
    assert got["single"] == ref["ladder"]["single"]
    _close(*got["single_result"], "q1 at single-shard vs its sharded primary")
    _close(got["single_result"][0], ref["ladder"]["single_result"][0], "q1 at single-shard vs repro")
    # transient faults break the primary rung only: materialized-sharded
    # serves, bit for bit the primary's result
    assert got["materialized"] == ref["ladder"]["materialized"]
    # the second injected fault trips the breaker, and materialized-sharded
    # serves that call already
    assert got["materialized"][:5] == ([True], ["fused-sharded"], "materialized-sharded", 0, 2)
    _bitwise(*got["materialized_result"], "q5 at materialized-sharded vs its primary")
    _close(got["materialized_result"][0], ref["ladder"]["materialized_result"][0], "q5 vs repro")


def test_fused_region_fault_descends_to_materialized_sharded(port):
    """The port's eager regions pass ``fused-region`` on every call: an OOM
    there lands on the fused-sharded rung and materialized-sharded (no
    regions) serves, bit for bit."""
    sess = port.connect(shards=2)
    clean = sess.query("q1")
    with tfaults.injected("fused-region", mode="always", error="oom"):
        got = sess.query("q1")
    rep = sess.report()
    assert (rep.degradation, rep.degraded, rep.faults, rep.shards) == ("materialized-sharded", 1, 1, 2)
    _bitwise(got, clean, "q1 at materialized-sharded")


def test_share_scans_refused(ref, port):
    assert share_scans_refused(port) == ref["share_scans"]


def test_memory_budget_and_shards_refused(port):
    """Streaming and sharding are separate executors, in both packages."""
    msgs = []
    for connect in (lambda **kw: repro.connect(dict(rtpch.generate(scale=SCALE, seed=SEED).tables()), **kw),
                    port.connect):
        with pytest.raises(ValueError) as ei:
            connect(memory_budget=1 << 20, shards=2)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_report_counts_shards(port):
    sess = port.connect(shards=4)
    sess.query("q3")
    rep = sess.report()
    assert rep.shards == 4 and "shards=4" in rep.summary() and rep.copy().shards == 4
    assert rep.modes() and all(m for m in rep.modes().values())
    assert sess.explain("q3")["shards"] == 4


@pytest.mark.parametrize("qname", QUERIES)
def test_race_roster_under_net_matches(port, qname):
    """The candidates a 4-shard race enumerates (Alg. 1 under Δ_net and its
    near-cost swaps) equal the reference's."""
    from repro.core import adapt as RA
    from repro.core import cost as RC
    from repro.data.table import collect_stats as rcollect
    from repro.exec.queries import FACT_RELS as RFACT
    from repro.exec.queries import REGISTRY as RREG

    from repro_torch.core import adapt as TA
    from repro_torch.core import cost as TC
    from repro_torch.data.table import collect_stats as tcollect
    from repro_torch.exec.queries import FACT_RELS

    rsig = rcollect(rtpch.generate(scale=SCALE, seed=SEED).tables())
    want = RA.enumerate_candidates(RREG[qname].llql(), rsig, RC.AnalyticCostModel(), band=RACE["band"],
                                   top_k=RACE["top_k"], net=RC.NetCostModel(n_shards=4), sharded_rels=RFACT)
    got = TA.enumerate_candidates(TREG[qname].llql(), tcollect(port.db), TC.AnalyticCostModel(),
                                  band=RACE["band"], top_k=RACE["top_k"], net=TC.NetCostModel(n_shards=4),
                                  sharded_rels=FACT_RELS)
    assert [(c.swapped, str(sorted(c.choices.items()))) for c in got] == [
        (c.swapped, str(sorted(c.choices.items()))) for c in want]
    np.testing.assert_allclose([c.modeled_s for c in got], [c.modeled_s for c in want], rtol=1e-9)


def test_adaptive_races_validate_bitwise_sharded(ref, port):
    """Every query raced on an adaptive 4-shard session: at least 2 lanes a
    race, every lane validated bit for bit, results the reference's.  The
    first query races before any measured residual has moved the cost
    model, so its roster is the reference's; later rosters follow each
    package's own timings."""
    got = races(port)
    for qname in QUERIES:
        res, lanes, shards = got[qname]
        want_res, want_lanes, want_shards = ref["races"][qname]
        assert shards == want_shards == 4, qname
        assert lanes and all(len(rec) >= 2 for rec in lanes), (qname, lanes)
        assert all(v for rec in lanes for _, _, v in rec), (qname, lanes)
        _close(res, want_res, f"{qname} raced vs repro")
    first = QUERIES[0]
    assert [[ln[:2] for ln in rec] for rec in got[first][1]] == [[ln[:2] for ln in rec] for rec in ref["races"][first][1]]
