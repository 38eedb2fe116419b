"""The port's installation stage (``repro_torch.costmodel``) against the
reference's (``repro.costmodel``), on the CPU.

* every regressor of ``MODEL_ZOO`` predicts what the reference's does on the
  same numpy data, also after a state round trip through either package;
* ``train`` and ``train_all_in_one`` on one profiling table give equal
  ``op_cost`` in both packages;
* ``delta.npz`` and ``profile.npy`` written by either package load in the
  other;
* Algorithm 1 under the two packages' learned Δ, trained on one table, makes
  the same choices and the same fused plans for the five TPC-H queries, and
  ``connect(db, delta=learned, device="cpu")`` matches the numpy oracles and
  ``repro.connect(db, delta=...)``;
* one profiling cell runs on the CPU with the reference's row count and row
  order, ``install`` stores and reuses, and the default store is under
  ``build/``.
"""
import pathlib

import numpy as np
import pytest

import repro
from repro.core.synthesis import synthesize as rsynthesize
from repro.costmodel import regression as RR
from repro.costmodel import profiler as RPROF
from repro.costmodel import store as RS
from repro.core import plan as RP
from repro.core.lower import compile as rcompile
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rstats
from repro.exec.queries import REGISTRY as RQ

import repro_torch
from repro_torch import costmodel as TC
from repro_torch.core import plan as TP
from repro_torch.core.lower import compile as tcompile
from repro_torch.core.synthesis import synthesize as tsynthesize
from repro_torch.costmodel import profiler as TPROF
from repro_torch.costmodel import regression as TR
from repro_torch.costmodel import store as TS
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tstats
from repro_torch.exec.queries import REGISTRY as TQ

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 3e-3, 3e-2
QUERIES = ("q1", "q3", "q5", "q9", "q18")


def _rows():
    """Synthetic profiling rows for all four families with known shapes:
    hash ~ c·n, sorted ~ c·n·log2(size) unordered and c·n ordered (the
    reference's ``test_costmodel_learned.py`` table, widened)."""
    rows = []
    for size in (64, 256, 1024, 4096, 16384, 65536):
        lg = np.log2(size)
        for ratio in (0.25, 1.0, 4.0):
            n = int(size * ratio)
            for ordered in (False, True):
                for ds, ins, hit, miss in (
                    ("ht_linear", 26e-9 * n, 20e-9 * n, 30e-9 * n),
                    ("ht_twochoice", 40e-9 * n, 18e-9 * n, 35e-9 * n),
                    ("st_sorted", (7e-9 if ordered else 14e-9 * lg) * n, (9e-9 if ordered else 11e-9 * lg) * n,
                     (9e-9 if ordered else 11e-9 * lg) * n),
                    ("st_blocked", (8e-9 if ordered else 15e-9 * lg) * n, (6e-9 if ordered else 5e-9 * lg) * n,
                     (6e-9 if ordered else 5e-9 * lg) * n),
                ):
                    for op, sec in (("insert", ins), ("lookup_hit", hit), ("lookup_miss", miss)):
                        rows.append((ds, op, ordered, size, n, sec))
    return rows


def _tables():
    rows = _rows()
    return (RPROF.ProfileTable([RPROF.ProfileRow(*r) for r in rows]),
            TPROF.ProfileTable([TPROF.ProfileRow(*r) for r in rows]))


GRID = [(ds, op, o, n, s) for ds in ("ht_linear", "ht_twochoice", "st_sorted", "st_blocked")
        for op in ("insert", "lookup_hit", "lookup_miss") for o in (False, True)
        for n, s in ((1, 1), (100, 5000), (5000, 4096), (3e6, 1.5e6), (0, 10))]


def _costs(model):
    return np.array([model.op_cost(ds, op, n, s, o) for ds, op, o, n, s in GRID])


@pytest.mark.parametrize("name", sorted(RR.MODEL_ZOO))
def test_regressors_match_reference(name):
    assert sorted(TR.MODEL_ZOO) == sorted(RR.MODEL_ZOO)
    rng = np.random.default_rng(5)
    X = rng.random((80, 2)) * 1000 + 1
    y = X[:, 0] * 0.3 + X[:, 1] ** 1.1 + 3
    Xf = TR.with_log_features(X)
    np.testing.assert_array_equal(Xf, RR.with_log_features(X))
    Xq = TR.with_log_features(rng.random((40, 2)) * 2000 + 1)
    r, t = RR.make(name).fit(Xf, y), TR.make(name).fit(Xf, y)
    want = r.predict(Xq)
    np.testing.assert_array_equal(t.predict(Xq), want)
    # state round trips, within and across packages
    np.testing.assert_array_equal(TR.MODEL_ZOO[name].from_state(t.to_state()).predict(Xq), want)
    np.testing.assert_array_equal(TR.MODEL_ZOO[name].from_state(r.to_state()).predict(Xq), want)
    np.testing.assert_array_equal(RR.MODEL_ZOO[name].from_state(t.to_state()).predict(Xq), want)


@pytest.mark.parametrize("kind", ["individual", "all_in_one"])
def test_training_gives_the_reference_op_costs(kind):
    rtab, ttab = _tables()
    if kind == "individual":
        rm, tm = RS.train(rtab), TS.train(ttab)
        assert sorted(tm.models) == sorted(rm.models)
    else:
        rm, tm = RS.train_all_in_one(rtab), TS.train_all_in_one(ttab)
    np.testing.assert_array_equal(_costs(tm), _costs(rm))
    assert (_costs(tm) >= 0).all()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_files_load_in_either_package(writer, tmp_path):
    rtab, ttab = _tables()
    if writer == "port":
        TS.save_model(TS.train(ttab), str(tmp_path))
        ttab.save(str(tmp_path / "profile.npy"))
    else:
        RS.save_model(RS.train(rtab), str(tmp_path))
        rtab.save(str(tmp_path / "profile.npy"))
    want = _costs(RS.train(rtab))
    for load_model, load_profile in ((TS.load_model, TS.load_profile), (RS.load_model, RS.load_profile)):
        np.testing.assert_array_equal(_costs(load_model(str(tmp_path))), want)
        got = load_profile(str(tmp_path))
        assert [(r.ds, r.op, r.ordered, r.size, r.n, r.seconds) for r in got.rows] == _rows()
    assert TS.load_model(str(tmp_path / "absent")) is None and TS.load_profile(str(tmp_path / "absent")) is None


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(scale=0.002, seed=7).tables()
    tdb = from_reference(rdb, device="cpu")
    rtab, ttab = _tables()
    return rdb, tdb, RS.train(rtab), TS.train(ttab)


@pytest.mark.parametrize("qname", QUERIES)
def test_learned_delta_gives_the_reference_choices(qname, dbs):
    rdb, tdb, rmodel, tmodel = dbs
    rsig, tsig = rstats(rdb), tstats(tdb)
    rexpr, texpr = RQ[qname].llql(), TQ[qname].llql()
    rch, tch = rsynthesize(rexpr, rsig, rmodel).choices, tsynthesize(texpr, tsig, tmodel).choices
    assert {s: str(c) for s, c in tch.items()} == {s: str(c) for s, c in rch.items()}
    rplan = RP.fuse(rcompile(rexpr, rch), sigma=rsig)
    tplan = TP.fuse(tcompile(texpr, tch), sigma=tsig)
    assert tplan.describe() == rplan.describe()


def test_learned_delta_moves_choices(dbs):
    """The synthetic Δ is not the analytic one: some choice moves."""
    rdb, tdb, rmodel, tmodel = dbs
    from repro_torch.core.cost import AnalyticCostModel

    tsig = tstats(tdb)
    moved = [q for q in QUERIES
             if tsynthesize(TQ[q].llql(), tsig, tmodel).choices
             != tsynthesize(TQ[q].llql(), tsig, AnalyticCostModel()).choices]
    assert moved


@pytest.fixture(scope="module")
def sessions(dbs):
    rdb, tdb, rmodel, tmodel = dbs
    return repro.connect(rdb, delta=rmodel), repro_torch.connect(tdb, device="cpu", delta=tmodel)


@pytest.mark.parametrize("qname", QUERIES)
def test_connect_with_learned_delta_matches_reference(qname, dbs, sessions):
    rdb, tdb, _, tmodel = dbs
    rs, ts = sessions
    assert ts.delta is tmodel
    got, want = ts.query(qname), rs.query(qname)
    oracle = TQ[qname].reference(tdb, **TQ[qname].defaults)
    assert set(got) == set(want) == set(oracle)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[k], oracle[k], rtol=RTOL, atol=ATOL)
    ex = ts.explain(qname)
    assert ex["choices"] == rs.explain(qname)["choices"]
    assert ex["plan"] == rs.shape(qname).plan.describe()
    # the executable cache serves the shape planned under the learned Δ
    shape = ts.shape(qname)
    ts.query(qname)
    assert ts.shape(qname) is shape and shape.served >= 2


def test_profile_cell_on_cpu_has_the_reference_rows():
    kw = dict(backends=("ht_linear",), sizes=(256,), lookup_ratios=(1.0,), repeats=1)
    stats = {}
    tab = TC.profile(device="cpu", stats=stats, **kw)
    # per ordering: 1 distinct insert + 5 duplicate-heavy inserts + hit + miss
    assert len(tab.rows) == 16
    assert all(r.seconds > 0 for r in tab.rows)
    assert set(stats) == {"draw_s", "upload_s", "call_s"} and stats["call_s"] > 0
    want = [(r.ds, r.op, r.ordered, r.size, r.n) for r in RPROF.profile(**kw).rows]
    assert [(r.ds, r.op, r.ordered, r.size, r.n) for r in tab.rows] == want
    assert TPROF.DEFAULT_SIZES == RPROF.DEFAULT_SIZES and TPROF.QUICK_SIZES == RPROF.QUICK_SIZES
    assert TPROF.INSTALL_SIZES == RPROF.DEFAULT_SIZES + (2**18, 2**19, 2**20, 2**21)


def test_install_stores_and_reuses(tmp_path):
    kw = dict(device="cpu", sizes=(64,), backends=("ht_linear", "st_sorted"), lookup_ratios=(1.0,), repeats=1)
    model = TC.install(str(tmp_path), **kw)
    assert (tmp_path / "delta.npz").exists() and (tmp_path / "profile.npy").exists()
    tab = TC.load_profile(str(tmp_path))
    assert {r.ds for r in tab.rows} == {"ht_linear", "st_sorted"} and {r.size for r in tab.rows} == {64}
    again = TC.install(str(tmp_path), **kw)  # reused, not profiled anew
    np.testing.assert_array_equal(_costs(again), _costs(model))
    np.testing.assert_array_equal(_costs(TC.load_model(str(tmp_path))), _costs(model))


def test_default_store_is_under_build_per_device():
    d = pathlib.Path(TC.default_dir("cpu"))
    assert d == ROOT / "build" / "costmodel" / "cpu"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
