"""The port's sharded executor (``repro_torch.exec.distributed``) against
``repro``'s: the row movers, the low-cardinality all-reduce, the five TPC-H
queries at 1, 2 and 4 shards (lineitem and orders row-sharded), plans
synthesized under Δ_net, shared-scan pairs, the materialized form and the
executor cache.

``repro`` runs sharded only over several devices, so its side runs once,
in a subprocess with 8 host devices (``XLA_FLAGS``, as
``tests/test_distributed_tpch.py`` does), and pickles its results; this
process sees one device and runs the port on the CPU, with every shard on
the host.  Key sets and integer lanes must be equal, float lanes within
rtol=3e-3, atol=3e-2; within the port the CPU folds in one order, so the
fused and materialized forms agree bit for bit."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.data import tpch as rtpch

from repro_torch import errors as terrors
from repro_torch.core import plan as TP
from repro_torch.core.cost import AnalyticCostModel, NetCostModel
from repro_torch.core.lower import compile as compile_plan
from repro_torch.core.synthesis import synthesize
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats
from repro_torch.dicts import base as dbase
from repro_torch.exec import distributed as D
from repro_torch.exec import engine as E
from repro_torch.exec.queries import FACT_RELS, QUERIES
from repro_torch.testing import faults as tfaults

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RTOL, ATOL = 3e-3, 3e-2
SCALE, SEED = 0.002, 3
SHARDS = (1, 2, 4)
SYNTH_QUERIES = ("q9", "q18")
# the reference suite's shared batches and how many regions each merges
# (tests/test_distributed_tpch.py:112-117)
SHARED_BATCHES = ((("q1", "q3"), 0), (("q1", "q18"), 1), (("q3", "q18"), 0), (("q1", "q3", "q18"), 1))

# the primitives' data: 8 shards of 256 rows, as the reference suite's
N_PRIM, PRIM_SEED, N_KEYS = 8 * 256, 1, 150

REFERENCE_JOB = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro import compat
from repro.core import plan as RP
from repro.core.cost import AnalyticCostModel, NetCostModel
from repro.core.lower import compile as compile_plan
from repro.core.synthesis import synthesize
from repro.data import tpch
from repro.data.table import collect_stats
from repro.exec import distributed as D
from repro.exec.queries import FACT_RELS, QUERIES

out = {}
# -- the row movers on a (2, 4) mesh over the axis tuple
mesh = compat.make_mesh((2, 4), ("pod", "data"))
axis = ("pod", "data")
rng = np.random.default_rng(%(prim_seed)d)
N = %(n_prim)d
keys = rng.integers(0, %(n_keys)d, N).astype(np.int32)
vals = rng.normal(size=N).astype(np.float32)
mask = rng.random(N) < 0.8
put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(axis)))
spec = (P(axis),) * 3

def body(k, m, v):
    nm, cols = D.repartition_cols(k, m, {"k": k, "v": v}, axis)
    return nm, cols["k"], cols["v"]

def bcast(k, m, v):
    nm, cols = D.broadcast_cols(m, {"k": k, "v": v}, axis)
    return nm, cols["k"], cols["v"]

for name, fn in (("repartition", body), ("broadcast", bcast)):
    nm, nk, nv = map(np.asarray, compat.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec)(
        put(keys), put(mask), put(vals)))
    per = nm.shape[0] // 8
    out[name] = [(nk[s * per:(s + 1) * per][nm[s * per:(s + 1) * per]],
                  nv[s * per:(s + 1) * per][nm[s * per:(s + 1) * per]]) for s in range(8)]

# -- the low-cardinality all-reduce on 8 shards
mesh8 = compat.make_mesh((8,), ("data",))
lk = rng.integers(0, 6, 8 * 16).astype(np.int32)
lk[::7] = 2**31 - 1  # dead rows
lv = rng.normal(size=(8 * 16, 2)).astype(np.float32)
import functools
fn = functools.partial(D.dist_groupby_lowcard_shard, axis="data", n_groups=6)
acc, cnt = compat.shard_map(fn, mesh=mesh8, in_specs=(P("data"), P("data", None)), out_specs=(P(), P()))(
    jax.device_put(jnp.asarray(lk), NamedSharding(mesh8, P("data"))),
    jax.device_put(jnp.asarray(lv), NamedSharding(mesh8, P("data", None))))
out["lowcard"] = (lk, lv, np.asarray(acc), np.asarray(cnt))

# -- TPC-H, lineitem and orders row-sharded
db = tpch.generate(scale=%(scale)r, seed=%(seed)d).tables()
sigma = collect_stats(db)
for shards in %(shards)r:
    mesh = compat.make_mesh((shards,), ("data",))
    for qname in sorted(QUERIES):
        q = QUERIES[qname]
        plan = compile_plan(q.llql(), {})
        out[("tpch", shards, qname)] = D.execute_plan_sharded(
            plan, db, mesh, "data", shard_rels=FACT_RELS, params=q.defaults).items_np()

mesh = compat.make_mesh((4,), ("data",))
for qname in %(synth)r:
    res = synthesize(QUERIES[qname].llql(), sigma, AnalyticCostModel(),
                     net=NetCostModel(n_shards=4), sharded_rels=FACT_RELS)
    plan = compile_plan(QUERIES[qname].llql(), res.choices)
    legal = RP.legalize(plan, FACT_RELS)[0]
    out[("synth", qname)] = (
        {s: str(c) for s, c in sorted(res.choices.items())}, legal.describe(),
        RP.fuse(legal, sigma=sigma).describe(),
        D.execute_plan_sharded(plan, db, mesh, "data", shard_rels=FACT_RELS,
                               params=QUERIES[qname].defaults).items_np())

mesh = compat.make_mesh((2,), ("data",))
for batch, _ in %(batches)r:
    plans = [compile_plan(QUERIES[qn].llql(), {}) for qn in batch]
    run = D.sharded_shared_executor(plans, db, mesh, "data", shard_rels=FACT_RELS, sigma=sigma)
    res = run([QUERIES[qn].defaults for qn in batch])
    out[("shared", batch)] = (len(run.shared_plan.regions), [r.items_np() for r in res])

with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % dict(prim_seed=PRIM_SEED, n_prim=N_PRIM, n_keys=N_KEYS, scale=SCALE, seed=SEED, shards=SHARDS,
           synth=SYNTH_QUERIES, batches=SHARED_BATCHES)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's sharded results, from one 8-device subprocess."""
    path = tmp_path_factory.mktemp("ref_dist") / "ref.pkl"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE_JOB), str(path)],
                          capture_output=True, text=True, env=env, timeout=540)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)  # written by the job above


@pytest.fixture(scope="module")
def tpch_db():
    rdb = rtpch.generate(scale=SCALE, seed=SEED).tables()
    db = from_reference(rdb, device="cpu")
    return db, collect_stats(db)


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


def _prim_data():
    rng = np.random.default_rng(PRIM_SEED)
    keys = rng.integers(0, N_KEYS, N_PRIM).astype(np.int32)
    vals = rng.normal(size=N_PRIM).astype(np.float32)
    mask = rng.random(N_PRIM) < 0.8
    return rng, keys, vals, mask


def _split(a, n):
    return [torch.from_numpy(p.copy()) for p in np.split(a, n)]


# -- the primitives ----------------------------------------------------------


def test_mesh_groups_and_devices():
    mesh = D.make_mesh({"pod": 2, "data": 4}, device="cpu")
    assert mesh.size == 8 and mesh.axis_size(("pod", "data")) == 8 and mesh.axis_size("data") == 4
    assert mesh.groups(("pod", "data")) == [tuple(range(8))]
    assert mesh.groups("data") == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert mesh.groups("pod") == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert mesh.groups(("data", "pod")) == [(0, 4, 1, 5, 2, 6, 3, 7)]
    assert all(d == torch.device("cpu") for d in mesh.devices)
    with pytest.raises(ValueError):
        mesh.groups("model")


def test_repartition_moves_every_live_row_to_its_owner(ref):
    """Every live row once, on the owner shard the reference's hash gives,
    in the reference's order (source shard, then row)."""
    _, keys, vals, mask = _prim_data()
    mesh = D.make_mesh({"pod": 2, "data": 4}, device="cpu")
    axis = ("pod", "data")
    ks, ms = _split(keys, 8), _split(mask, 8)
    nm, cols = D.repartition_cols(ks, ms, [{"k": k, "v": v} for k, v in zip(ks, _split(vals, 8))], mesh, axis)
    assert sum(int(m.sum()) for m in nm) == int(mask.sum())
    for s in range(8):
        assert bool(nm[s].all())
        owner = (dbase._mix(cols[s]["k"], dbase._H2) % 8).numpy()
        assert (owner == s).all()
        want_k, want_v = ref["repartition"][s]
        np.testing.assert_array_equal(cols[s]["k"].numpy(), want_k)
        np.testing.assert_array_equal(cols[s]["v"].numpy(), want_v)


def test_broadcast_replicates_every_live_row(ref):
    _, keys, vals, mask = _prim_data()
    mesh = D.make_mesh({"pod": 2, "data": 4}, device="cpu")
    ks = _split(keys, 8)
    nm, cols = D.broadcast_cols(_split(mask, 8), [{"k": k, "v": v} for k, v in zip(ks, _split(vals, 8))],
                                mesh, ("pod", "data"))
    for s in range(8):
        assert int(nm[s].sum()) == int(mask.sum())
        want_k, want_v = ref["broadcast"][s]
        np.testing.assert_array_equal(cols[s]["k"].numpy(), want_k)
        np.testing.assert_array_equal(cols[s]["v"].numpy(), want_v)
        np.testing.assert_array_equal(want_k, keys[mask])


def test_repartition_within_groups_of_an_axis():
    """Over one axis of a (2, 4) mesh each pod's group routes on its own:
    both groups end as a one-axis mesh of 4 ends."""
    _, keys, vals, mask = _prim_data()
    two = D.make_mesh({"pod": 2, "data": 4}, device="cpu")
    one = D.make_mesh({"data": 4}, device="cpu")
    ks, ms, cs = _split(keys[:1024], 4), _split(mask[:1024], 4), [{"k": k} for k in _split(keys[:1024], 4)]
    want_m, want_c = D.repartition_cols(ks, ms, cs, one, "data")
    got_m, got_c = D.repartition_cols(ks + ks, ms + ms, cs + cs, two, "data")
    for s in range(8):
        assert torch.equal(got_c[s]["k"], want_c[s % 4]["k"]) and torch.equal(got_m[s], want_m[s % 4])
        assert ((dbase._mix(got_c[s]["k"], dbase._H2) % 4).numpy() == s % 4).all()


def test_psum_pmin_pmax_fold_in_shard_order():
    mesh = D.make_mesh({"data": 4}, device="cpu")
    vals = [torch.tensor([float(i), -float(i)]) for i in range(4)]
    assert all(torch.equal(v, torch.tensor([6.0, -6.0])) for v in D.psum(vals, mesh, "data"))
    assert all(torch.equal(v, torch.tensor([0.0, -3.0])) for v in D.pmin(vals, mesh, "data"))
    assert all(torch.equal(v, torch.tensor([3.0, 0.0])) for v in D.pmax(vals, mesh, "data"))
    got = D.all_gather([torch.arange(i) for i in range(4)], mesh, "data")
    assert all(torch.equal(g, torch.tensor([0, 0, 1, 0, 1, 2])) for g in got)


def test_lowcard_groupby_against_reference_and_numpy(ref):
    lk, lv, racc, rcnt = ref["lowcard"]
    mesh = D.make_mesh({"data": 8}, device="cpu")
    acc, cnt = D.dist_groupby_lowcard_shard(_split(lk, 8), _split(lv, 8), mesh=mesh, axis="data", n_groups=6)
    live = lk != dbase.PAD
    want = np.zeros((6, 2), np.float64)
    np.add.at(want, lk[live], lv[live])
    for s in range(8):
        np.testing.assert_allclose(acc[s].numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(acc[s].numpy(), racc, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(cnt[s].numpy(), rcnt)
        np.testing.assert_array_equal(cnt[s].numpy(), np.bincount(lk[live], minlength=6))


# -- TPC-H -------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
def test_tpch_sharded_matches_reference_and_single_shard(ref, tpch_db, shards):
    """The five queries through ``execute_plan_sharded`` against the
    reference's sharded results, the port's single-device results and
    numpy; the report counts the shards."""
    db, sigma = tpch_db
    mesh = D.make_mesh({"data": shards}, device="cpu")
    for qname in sorted(QUERIES):
        q = QUERIES[qname]
        plan = compile_plan(q.llql(), {})
        single = E.execute_plan(plan, db, sigma=sigma, params=E.coerce_bindings(plan, q.defaults)).items_np()
        for s in (None, sigma):  # the reference's call (no Σ) and the Session's
            got = D.execute_plan_sharded(plan, db, mesh, "data", shard_rels=FACT_RELS, params=q.defaults,
                                         sigma=s).items_np()
            assert E.last_report().shards == shards
            _close(got, ref[("tpch", shards, qname)], f"{qname} at {shards} shards vs repro")
            _close(got, single, f"{qname} at {shards} shards vs single-shard")
            _close(got, q.reference(db, **q.defaults), f"{qname} at {shards} shards vs numpy")


def test_synthesized_under_net_cost_model(ref, tpch_db):
    """Alg. 1 under Δ_net picks implementations and placements; the choices
    and the legalized and fused plans equal the reference's, and the
    sharded run honours them."""
    db, sigma = tpch_db
    mesh = D.make_mesh({"data": 4}, device="cpu")
    for qname in SYNTH_QUERIES:
        q = QUERIES[qname]
        res = synthesize(q.llql(), sigma, AnalyticCostModel(), net=NetCostModel(n_shards=4), sharded_rels=FACT_RELS)
        choices, legal_desc, fused_desc, want = ref[("synth", qname)]
        assert {s: str(c) for s, c in sorted(res.choices.items())} == choices, qname
        plan = compile_plan(q.llql(), res.choices)
        legal = TP.legalize(plan, FACT_RELS)[0]
        assert legal.describe() == legal_desc, qname
        assert TP.fuse(legal, sigma=sigma).describe() == fused_desc, qname
        got = D.execute_plan_sharded(plan, db, mesh, "data", shard_rels=FACT_RELS, params=q.defaults,
                                     sigma=sigma).items_np()
        _close(got, want, f"{qname} synthesized vs repro")
        _close(got, q.reference(db, **q.defaults), f"{qname} synthesized vs numpy")


@pytest.mark.parametrize("shards", (2, 4))
def test_shared_pairs_sharded(ref, tpch_db, shards):
    """Merge-compatible pairs through the sharded shared-scan executor
    merge as the reference's do and equal the reference's 2-shard batch
    and the port's per-query single-device results."""
    db, sigma = tpch_db
    mesh = D.make_mesh({"data": shards}, device="cpu")
    for batch, want_regions in SHARED_BATCHES:
        plans = [compile_plan(QUERIES[qn].llql(), {}) for qn in batch]
        params = [QUERIES[qn].defaults for qn in batch]
        run = D.sharded_shared_executor(plans, db, mesh, "data", shard_rels=FACT_RELS, sigma=sigma)
        assert len(run.shared_plan.regions) == want_regions, batch
        n_regions, rres = ref[("shared", batch)]
        assert n_regions == want_regions
        for qn, pv, out, want in zip(batch, params, run(params), rres):
            plan = compile_plan(QUERIES[qn].llql(), {})
            single = E.execute_plan(plan, db, sigma=sigma, params=E.coerce_bindings(plan, pv)).items_np()
            got = out.items_np()
            _close(got, want, f"{batch}/{qn} vs repro")
            _close(got, single, f"{batch}/{qn} vs single-shard")
        assert run.last_report.shards == shards


def test_fused_equals_materialized_bitwise(tpch_db):
    """The fused per-shard phase against ``fuse=False`` (the
    materialized-sharded rung): one mesh, one order of collectives."""
    db, sigma = tpch_db
    mesh = D.make_mesh({"data": 4}, device="cpu")
    for qname in sorted(QUERIES):
        q = QUERIES[qname]
        plan = compile_plan(q.llql(), {})
        fused = D.sharded_executor(plan, db, mesh, "data", FACT_RELS, sigma=sigma)
        mat = D.sharded_executor(plan, db, mesh, "data", FACT_RELS, sigma=sigma, fuse=False)
        assert mat.fused_regions == 0 and mat.n_shards == 4
        _bitwise(fused(q.defaults).items_np(), mat(q.defaults).items_np(), qname)


def test_sharded_cache_hits_and_misses(tpch_db):
    db, sigma = tpch_db
    mesh = D.make_mesh({"data": 2}, device="cpu")
    D.clear_sharded_cache()
    q = QUERIES["q3"]
    plan = compile_plan(q.llql(), {})
    with tfaults.injected("compile", mode="once"):
        with pytest.raises(terrors.FaultInjected):
            D.cached_sharded_executor(plan, db, mesh, "data", FACT_RELS, sigma=sigma)
    assert D.sharded_cache_stats() == {"hits": 0, "misses": 1, "entries": 0}  # a failed build keeps nothing
    run = D.cached_sharded_executor(plan, db, mesh, "data", FACT_RELS, sigma=sigma)
    assert D.cached_sharded_executor(plan, db, mesh, "data", FACT_RELS, sigma=sigma) is run
    D.cached_sharded_executor(plan, db, mesh, "data", FACT_RELS, sigma=sigma, fuse=False)  # its own entry
    D.cached_sharded_executor(plan, dict(db), mesh, "data", FACT_RELS, sigma=sigma)  # another database
    assert D.sharded_cache_stats() == {"hits": 1, "misses": 4, "entries": 3}
    first = run(q.defaults).items_np()
    bound = D.cached_sharded_executor(TP.BoundPlan(plan, (("date", 0.02),)), db, mesh, "data", FACT_RELS,
                                      sigma=sigma)
    assert bound.trace_counter is run.trace_counter and run.trace_counter[0] == 1
    _close(bound().items_np(), q.reference(db, date=0.02), "q3 bound at date=0.02")
    _bitwise(bound({"date": q.defaults["date"]}).items_np(), first, "q3 bound, rebound to the default")
    assert D.sharded_cache_stats()["hits"] == 2


def test_fault_points_fire_per_call(tpch_db):
    """``shard-exec`` on each call, ``shard-oom`` in a shard's local phase,
    ``shard-merge`` at a collective; each leaves typed."""
    db, sigma = tpch_db
    mesh = D.make_mesh({"data": 2}, device="cpu")
    q = QUERIES["q1"]
    run = D.sharded_executor(compile_plan(q.llql(), {}), db, mesh, "data", FACT_RELS, sigma=sigma)
    want = run(q.defaults).items_np()
    for point, err in (("shard-exec", terrors.FaultInjected), ("shard-oom", terrors.DeviceOOMError),
                       ("shard-merge", terrors.ShardExecError)):
        with tfaults.injected(point, mode="once"):
            with pytest.raises(err):
                run(q.defaults)
        _bitwise(run(q.defaults).items_np(), want, f"q1 after {point}")
