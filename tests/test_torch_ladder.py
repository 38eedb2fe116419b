"""The port's degradation ladder against ``repro``'s: the same fault
scenarios through ``repro.connect`` and ``repro_torch.connect(...,
device="cpu")`` on the same numpy data must descend to the same rung with
the same fault counts, open the same breakers, and give the result of a
clean run — bitwise within the port, at the suite's tolerance across
packages.  Also the ladder's pieces: the device rule of
``degraded_equal``, host-held primary results, ``ExecutionReport.copy``
and the ``dict-build`` point, which the eager port passes on every call."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro
from repro import errors as rerrors
from repro.data import tpch as rtpch
from repro.exec import engine as RE
from repro.testing import faults as rfaults

import repro_torch
from repro_torch import errors as terrors
from repro_torch import session as TS
from repro_torch.data.interop import from_reference
from repro_torch.exec import engine as TE
from repro_torch.testing import faults as tfaults

RTOL, ATOL = 3e-3, 3e-2


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
        name="repro", faults=rfaults, errors=rerrors, E=RE,
        connect=lambda **kw: repro.connect(dict(rdb), **kw),
    )
    port = SimpleNamespace(
        name="repro_torch", faults=tfaults, errors=terrors, E=TE,
        connect=lambda **kw: repro_torch.connect(dict(tdb), device="cpu", **kw),
    )
    return ref, port


def _state(session):
    """What the ladder did on the session's last query."""
    rep = session.report()
    return (
        rep.degradation, rep.degraded, rep.faults,
        sorted(session.breakers()), dict(session.fault_stats),
    )


def _raises(pkg, fn, err):
    with pytest.raises(getattr(pkg.errors, err)) as ei:
        fn()
    return type(ei.value).__name__


# -- the scenarios: each returns (clean result, served results, observations)


def oom_full_ladder(pkg):
    s = pkg.connect()
    clean = s.query("q18")
    with pkg.faults.injected("kernel-launch", mode="always", error="oom"):
        degraded = s.query("q18")
        obs = [_state(s)]
    pinned = s.query("q18")  # breakers pin both broken rungs: no failure paid
    obs.append(_state(s))
    return clean, [degraded, pinned], obs


def fused_region_stops_at_materialized(pkg):
    s = pkg.connect()
    clean = s.query("q1")
    with pkg.faults.injected("fused-region", mode="always", error="oom"):
        degraded = s.query("q1")
        obs = [_state(s)]
    return clean, [degraded], obs


def transient_trips_the_breaker(pkg):
    s = pkg.connect()
    s.breaker_threshold = 2
    clean = s.query("q1")
    obs = []
    with pkg.faults.injected("kernel-launch", mode="always"):
        obs.append(_raises(pkg, lambda: s.query("q1"), "FaultInjected"))  # fused fails #1
        obs.append(_raises(pkg, lambda: s.query("q1"), "FaultInjected"))  # fused trips, materialized #1
        degraded = s.query("q1")  # materialized trips: streamed serves
        obs.append(_state(s))
    return clean, [degraded], obs


def cooldown_restores_the_primary(pkg):
    t = [0.0]
    s = pkg.connect(clock=lambda: t[0])
    s.breaker_cooldown_s = 0.2
    clean = s.query("q1")
    with pkg.faults.injected("kernel-launch", mode="always", error="oom"):
        degraded = s.query("q1")
        obs = [_state(s)]
    t[0] += 0.25  # past the cooldown, the fault gone
    healed = s.query("q1")
    obs.append(_state(s))
    return clean, [degraded, healed], obs


def chunked_session_shrinks_its_budget(pkg):
    s = pkg.connect(memory_budget=1, chunk_rows=1024)
    clean = s.query("q1")
    with pkg.faults.injected("h2d", mode="always", error="oom"):
        # the shrunken rung uploads chunks too: the typed error surfaces
        obs = [_raises(pkg, lambda: s.query("q1"), "DeviceOOMError")]
    degraded = s.query("q1")  # the primary's breaker is open: shrunk serves
    obs.append(_state(s))
    return clean, [degraded], obs


def breaker_with_injected_clock(pkg):
    t = [0.0]
    s = pkg.connect(clock=lambda: t[0])
    s._trip_breaker("q1", "fused")
    obs = [sorted(s.breakers().items())]
    shape = s.shape("q1")
    clean = TS.result_items(s.execute_shape(shape, shape.query.bind_defaults({})))
    obs.append((dict(s.fault_stats), pkg.E.last_report().degradation))
    t[0] = s.breaker_cooldown_s + 1.0
    obs.append(s.breakers())
    healed = TS.result_items(s.execute_shape(shape, shape.query.bind_defaults({})))
    obs.append((dict(s.fault_stats), pkg.E.last_report().degradation))
    return clean, [healed], obs


def streamed_points_fire(pkg):
    s = pkg.connect(memory_budget=1, chunk_rows=1024)
    clean = s.query("q1")
    obs, served = [], []
    for point in ("h2d", "chunk-decode"):
        s._breaker_fails.clear()  # each point's fault is the first transient
        with pkg.faults.injected(point, mode="once") as spec:
            obs.append(_raises(pkg, lambda: s.query("q1", date=0.77), "ReproError"))
            obs.append((point, spec.fired))
        served.append(s.query("q1", date=0.77))
        obs.append(_state(s))
    return clean, served, obs


SCENARIOS = {
    f.__name__: f for f in (
        oom_full_ladder, fused_region_stops_at_materialized, transient_trips_the_breaker,
        cooldown_restores_the_primary, chunked_session_shrinks_its_budget,
        breaker_with_injected_clock, streamed_points_fire,
    )
}


def _close(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ladder_matches_reference(name, pkgs):
    ref, port = pkgs
    r_clean, r_served, r_obs = SCENARIOS[name](ref)
    t_clean, t_served, t_obs = SCENARIOS[name](port)
    assert t_obs == r_obs
    assert len(t_served) == len(r_served)
    _close(t_clean, r_clean, f"{name}: clean")
    for i, (got, want) in enumerate(zip(t_served, r_served)):
        # a degraded or re-served result equals the port's clean run bit for bit
        if name != "streamed_points_fire":  # that one is served under another binding
            assert TS.bitwise_equal(got, t_clean), f"{name}: result {i} differs from the clean run"
        _close(got, want, f"{name}: result {i}")


def test_streamed_rung_passes_no_dispatch_point(pkgs):
    # the reference's streamed executor never checks kernel-launch: that is
    # what makes streaming the last rung under a kernel-launch fault
    _, port = pkgs
    s = port.connect()
    shape = s.shape("q18")
    ex, db = s._mode_executable(shape, "streamed")
    assert isinstance(ex, TE.StreamedExecutable) and TS.S.is_chunked(db["lineitem"])
    assert s._mode_executable(shape, "streamed") == (ex, db)  # built once
    with tfaults.injected("kernel-launch", mode="always") as spec:
        ex(db, shape.query.bind_defaults({}))
    assert spec.hits == 0


def test_sharded_rungs_are_not_ported(pkgs):
    """A session's ladder holds its own regime's rungs only: a resident
    session refuses the sharded rungs, a sharded session the resident ones."""
    _, port = pkgs
    s = port.connect()
    shape = s.shape("q1")
    for mode in ("materialized-sharded", "single-shard", "bogus"):
        with pytest.raises(ValueError, match="unknown ladder mode"):
            s._mode_executable(shape, mode)
    assert s._ladder_modes() == ("fused", "materialized", "streamed")
    assert port.connect(memory_budget=1, chunk_rows=1024)._ladder_modes() == ("streamed", "streamed-shrunk")
    sharded = port.connect(shards=2)
    assert sharded._ladder_modes() == ("fused-sharded", "materialized-sharded", "single-shard")
    with pytest.raises(ValueError, match="unknown ladder mode"):
        sharded._mode_executable(sharded.shape("q1"), "materialized")


def test_degraded_equal_by_device():
    a = {1: np.array([1.0, 2.0], np.float32), 2: np.array([3], np.int32)}
    near = {1: np.array([1.0, 2.001], np.float32), 2: np.array([3], np.int32)}
    far = {1: np.array([1.0, 2.5], np.float32), 2: np.array([3], np.int32)}
    int_off = {1: np.array([1.0, 2.0], np.float32), 2: np.array([4], np.int32)}
    keys_off = {1: np.array([1.0, 2.0], np.float32), 3: np.array([3], np.int32)}
    for dev in ("cpu", "cuda"):
        assert TS.degraded_equal(a, dict(a), dev)
        for bad in (far, int_off, keys_off):
            assert not TS.degraded_equal(bad, a, dev)
    # within the card's tolerance, not bitwise: the card accepts, the CPU not
    assert TS.degraded_equal(near, a, "cuda")
    assert not TS.degraded_equal(near, a, "cpu")
    # the CPU rule is bitwise for every query: one ulp off is refused there
    ulp = {1: np.nextafter(a[1], np.float32(3)), 2: a[2]}
    assert TS.degraded_equal(ulp, a, "cuda")
    assert not TS.degraded_equal(ulp, a, "cpu")


def test_validate_degraded_raises_outside_the_rule(pkgs):
    _, port = pkgs
    s = port.connect()
    shape = s.shape("q1")
    key = s._binding_key("q1", shape.query.bind_defaults({}))
    clean = s.query("q1")
    assert TS.bitwise_equal(s._ref_results[key], clean)
    k0 = next(iter(clean))
    near = {**clean, k0: clean[k0] * np.float32(1 + 1e-4)}
    far = {**clean, k0: clean[k0] * np.float32(1.5)}
    s._validate_degraded(shape, key, dict(clean), mode="materialized")
    with pytest.raises(terrors.ReproError, match="diverged"):
        s._validate_degraded(shape, key, near, mode="materialized")
    s.device = torch.device("cuda")  # the rule only reads the device's type
    s._validate_degraded(shape, key, near, mode="materialized")
    with pytest.raises(terrors.ReproError, match="diverged"):
        s._validate_degraded(shape, key, far, mode="materialized")


def test_reference_results_hold_no_tensor(pkgs):
    _, port = pkgs
    s = port.connect()
    for q in ("q1", "q3", "q18"):
        s.query(q)
    s.query("q1", date=0.6)
    assert len(s._ref_results) == 4
    for items in s._ref_results.values():
        assert isinstance(items, dict)
        assert all(isinstance(v, np.ndarray) for v in items.values())
        assert not any(isinstance(v, torch.Tensor) for v in items.values())


@pytest.mark.parametrize("E", [RE, TE], ids=["repro", "repro_torch"])
def test_report_copy_carries_fault_counters(E):
    rep = E.ExecutionReport(faults=3, retries=2, degraded=1, shed=4, degradation="streamed")
    rep.regions["X"] = E.RegionRecord("X", "xla")
    cp = rep.copy()
    assert (cp.faults, cp.retries, cp.degraded, cp.shed, cp.degradation) == (3, 2, 1, 4, "streamed")
    assert cp.regions["X"] is not rep.regions["X"] and cp.modes() == {"X": "xla"}
    assert "degraded=streamed" in rep.summary() and "faults=3" in rep.summary()


def test_dict_build_fires_on_every_port_call(pkgs):
    # the reference builds dictionaries while tracing, so its point fires on
    # the cold call only; the port runs eagerly and passes it on every call
    ref, port = pkgs
    hits = {}
    for pkg in (ref, port):
        pkg.E.clear_exec_cache()
        s = pkg.connect()
        s.query("q5")
        with pkg.faults.injected("dict-build", mode="nth", n=10**9) as spec:
            s.query("q5")  # warm
        hits[pkg.name] = spec.hits
        # the reference's own scenario holds in both packages: a cold call
        # fails once, and the fault being transient, the next call serves
        pkg.E.clear_exec_cache()
        s = pkg.connect()
        with pkg.faults.injected("dict-build", mode="once") as spec:
            with pytest.raises(pkg.errors.FaultInjected):
                s.query("q5")
            assert spec.fired == 1
        assert s.query("q5")
    assert hits["repro"] == 0 and hits["repro_torch"] > 0


def test_rungs_share_the_session_tables(pkgs):
    # a resident session builds every rung from its own device tables; a
    # budget session keeps no decoded copy of the caller's tables: its
    # shrunk rung reuses the primary's chunks, re-encoding only what the
    # smaller budget newly streams, to the bytes chunking it afresh gives
    _, port = pkgs
    s = port.connect()
    assert not hasattr(s, "base_db")
    db, _, streamed = s._degraded_storage()
    assert streamed == ("lineitem",)
    assert all(db[r].col(c) is s.db[r].col(c) for r in db if r not in streamed for c in db[r].names())

    def encoded(ct):
        return [{c: (e.kind, {k: np.asarray(v).tobytes() for k, v in e.payload.items()}) for c, e in ch.items()}
                for ch in ct.chunks]

    for budget, primary, lower in ((10**6, (), ("lineitem",)), (100_000, ("lineitem",), ("lineitem", "orders"))):
        b = port.connect(memory_budget=budget, chunk_rows=1024)
        shrunk, _, more = b._degraded_storage()
        assert (b.streamed, more) == (primary, lower)
        assert all(shrunk[r] is b.db[r] for r in b.streamed)
        for r in set(more) - set(b.streamed):
            assert encoded(shrunk[r]) == encoded(TS.S.chunk_table(b.db[r].to("cpu"), 1024))
        for r in shrunk:
            if not TS.S.is_chunked(shrunk[r]):
                assert all(shrunk[r].col(c) is b.db[r].col(c) for c in shrunk[r].names())
