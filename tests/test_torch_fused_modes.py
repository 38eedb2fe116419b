"""The fused pipeline's radix, ``init=`` and ``encoded=`` modes against
``repro``, on the CPU (the kernel's plain twin runs every mode).

* the partition machinery — ``slot_partition_plan``, each family's
  ``partition_assign`` / ``partition_slabs`` / local ``resident_find`` and
  ``radix_route`` — bit for bit against the reference's jnp functions,
  skewed ids and empty partitions included;
* radix regions: the plain twin partitioned (with and without a partitioned
  terminal, and a scalar Reduce) equal in ``items()`` to the same region
  unpartitioned; a dictionary past the residency bound through
  ``execute_plan`` (``kernel-radix``; the reference's CPU path records
  ``xla-radix-planned``) and TPC-H q3 / q18 planned under a small fusion
  budget, against ``repro`` and the numpy oracle;
* ``encoded=`` (bitpack, RLE, FOR, dictionary) bit for bit equal to the
  raw-column launch, its decode equal to the reference's ``decode_tile`` /
  ``unpack_words`` on the same words; an ``init=`` carry over two halves
  equal to one launch (the reference's ``tests/test_storage.py`` cases);
* the out-of-core fold: the five queries through ``connect(memory_budget=)``
  carry ``init=`` from chunk to chunk, read their encoded columns through
  ``encoded=``, finalize once, and equal ``repro``'s streamed engine and the
  port's resident result, with the reference's stream ledger and the
  port's fault-point hits as they were before the fold carried ``init=``.

Keys and int lanes are exact; floats within rtol=3e-3, atol=3e-2 (the
reference suite's tolerance against numpy) unless a test says bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core import llql as RL
from repro.core import plan as RP
from repro.core.cost import DictChoice as RChoice
from repro.core.cost import FusionCostModel as RFusion
from repro.core.lower import compile as rcompile
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rstats
from repro.data.table import from_numpy as rfrom_numpy
from repro.dicts import base as rbase
from repro.dicts import registry as rregistry
from repro.exec import engine as RE
from repro.exec.queries import REGISTRY as RQ
from repro.kernels import decode as RDK
from repro.kernels import fused_pipeline as RFP

import repro_torch
from repro_torch.core import llql as L
from repro_torch.core import plan as TP
from repro_torch.core.cost import DictChoice as TChoice
from repro_torch.core.cost import FusionCostModel as TFusion
from repro_torch.core.lower import compile as tcompile
from repro_torch.data import storage as TS
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tstats
from repro_torch.data.table import from_numpy as tfrom_numpy
from repro_torch.dicts import base as tbase
from repro_torch.dicts import registry as tregistry
from repro_torch.exec import engine as TE
from repro_torch.exec.queries import REGISTRY as TQ
from repro_torch.kernels import decode as TDK
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.testing import faults as tfaults

RTOL, ATOL = 3e-3, 3e-2
FAMILIES = ("ht_linear", "st_sorted", "st_blocked")
CHUNK = 2048
# a fusion budget under which both packages radix-mark q3's Agg and q18's
# Big at scale 0.002 (P = 8 on OD), as the default budget does at SF 1
SMALL_FUSION = dict(vmem_budget=50_000, kernel_slots=1024)


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# partition machinery, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap,parts,overlap", [(1024, 4, 128), (4096, 16, 0), (512, 2, 128), (2048, 1, 128)])
def test_slot_partition_plan_matches_reference(cap, parts, overlap):
    ridx, rb = rbase.slot_partition_plan(cap, parts, overlap)
    tidx, tb = tbase.slot_partition_plan(cap, parts, overlap)
    assert np.array_equal(np.asarray(ridx), _np(tidx)) and np.array_equal(np.asarray(rb), _np(tb))
    assert tidx.dtype == torch.int32


@pytest.mark.parametrize("ds", FAMILIES)
def test_partition_hooks_match_reference(ds):
    rng = np.random.default_rng(1)
    keys = rng.choice(200_000, 5000, replace=False).astype(np.int32)
    vals = rng.normal(size=(5000, 2)).astype(np.float32)
    C, n_parts = 16384, 8
    rmod, tmod = rregistry.get(ds), tregistry.get(ds)
    rt = rmod.build(jnp.asarray(keys), jnp.asarray(vals), C)
    tt = tmod.build(torch.from_numpy(keys), torch.from_numpy(vals), C)
    # hits, misses, queries below the first key and past the last, PAD
    qs = np.concatenate([keys[:3000], rng.integers(-5, 210_000, 3000), [-(2**31) + 1, 2**31 - 1]]).astype(np.int32)
    rpart = np.asarray(rmod.partition_assign(rt, jnp.asarray(qs), n_parts))
    tpart = _np(tmod.partition_assign(tt, torch.from_numpy(qs), n_parts))
    assert np.array_equal(rpart, tpart) and tpart.dtype == np.int32
    rslabs, ridx, rb = rmod.partition_slabs(rt, n_parts)
    tslabs, tidx, tb = tmod.partition_slabs(tt, n_parts)
    assert len(rslabs) == len(tslabs)
    for a, b in zip(rslabs, tslabs):
        assert np.array_equal(np.asarray(a), _np(b))
    assert np.array_equal(np.asarray(ridx), _np(tidx)) and np.array_equal(np.asarray(rb), _np(tb))
    # each partition's queries find against its block alone, at the same
    # local positions
    cp = C // n_parts
    for p in range(n_parts):
        q = qs[tpart == p]
        rpos, rfound = rmod.resident_find(tuple(jnp.asarray(np.asarray(s)[p]) for s in rslabs), jnp.asarray(q),
                                          capacity=C, base_slot=p * cp)
        tpos, tfound = tmod.resident_find(tuple(s[p] for s in tslabs), torch.from_numpy(q),
                                          capacity=C, base_slot=p * cp)
        assert np.array_equal(np.asarray(rpos), _np(tpos)) and np.array_equal(np.asarray(rfound), _np(tfound))


@pytest.mark.parametrize("case", ["uniform", "skewed", "empty_parts", "ragged", "one_tile"])
def test_radix_route_matches_reference(case):
    rng = np.random.default_rng(2)
    n, parts, block = {"uniform": (5000, 8, 512), "skewed": (6000, 8, 256), "empty_parts": (3000, 16, 256),
                       "ragged": (4097, 4, 1024), "one_tile": (100, 4, 1024)}[case]
    part = rng.integers(0, parts, n)
    if case == "skewed":
        part = np.where(rng.random(n) < 0.9, 5, part)
    elif case == "empty_parts":
        part = rng.choice([1, 2, 9, 15], n)
    part = part.astype(np.int32)
    a = rng.integers(-1000, 1000, n).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    live = rng.random(n) < 0.7
    rcols, rlive, rplan = RFP.radix_route({"a": jnp.asarray(a), "w": jnp.asarray(w)}, jnp.asarray(live),
                                          jnp.asarray(part), parts, block)
    tcols, tlive, tplan = fp.radix_route({"a": torch.from_numpy(a), "w": torch.from_numpy(w)},
                                         torch.from_numpy(live), torch.from_numpy(part), parts, block)
    for c in ("a", "w"):
        assert np.array_equal(np.asarray(rcols[c]), _np(tcols[c]))
    assert np.array_equal(np.asarray(rlive), _np(tlive))
    assert np.array_equal(np.asarray(rplan.tile_part), _np(tplan.tile_part)) and tplan.tile_part.dtype == torch.int32
    assert np.array_equal(np.asarray(rplan.visited), _np(tplan.visited))
    assert tplan.n_parts == parts and not tplan.part_terminal


# ---------------------------------------------------------------------------
# radix regions through the engine
# ---------------------------------------------------------------------------


def _key(L_, var, col):
    return L_.FieldAccess(L_.FieldAccess(L_.Var(var), "key"), col)


def _rs(rng, nr=50_000, ns=20_000):
    """R(a unique, m), S(a foreign, b small group key, w)."""
    R = {"a": np.arange(nr, dtype=np.int32), "m": rng.normal(size=nr).astype(np.float32)}
    S = {"a": rng.integers(0, nr + 5000, ns).astype(np.int32), "b": rng.integers(0, 50, ns).astype(np.int32),
         "w": rng.normal(size=ns).astype(np.float32)}
    return R, S


def _region_plan(P_, L_, Choice, kind, ds):
    """A plan whose one fused region probes ``G`` (built over R by ``ds``):
    ``part_term`` groups by the probe key, ``groupby`` by another column,
    ``reduce`` folds a scalar through an interleaved lookup of G."""
    def k(var, col):
        return _key(L_, var, col)

    scan_r = P_.Scan("%r", source="R", var="r")
    if kind == "reduce":
        return P_.Plan((
            scan_r,
            P_.GroupBy("G", source="%r", keyexpr=k("r", "a"), values=(("t", k("r", "m")),), choice=Choice(ds)),
            P_.Scan("%s", source="S", var="s"),
            P_.Reduce("Tot", source="%s", fields=(
                ("sw", L_.BinOp("*", k("s", "w"), L_.FieldAccess(L_.Var("g"), "t"))), ("n", k("s", "w"))),
                lookup_sym="G", lookup_key=k("s", "a"), lookup_var="g"),
        ), "Tot")
    group_key = k("s", "a") if kind == "part_term" else k("s", "b")
    return P_.Plan((
        scan_r,
        P_.HashBuild("G", source="%r", keyexpr=k("r", "a"), choice=Choice(ds)),
        P_.Scan("%s", source="S", var="s"),
        P_.HashProbe("%p", source="%s", build="G", keyexpr=k("s", "a"), inner_var="g"),
        P_.GroupBy("Agg", source="%p", keyexpr=group_key,
                   values=(("x", L_.BinOp("*", k("s", "w"), k("g", "m"))), ("c", L_.Const(1.0, L_.DOUBLE))),
                   choice=Choice("ht_linear")),
    ), "Agg")


def _mark(plan, n_parts, sym="G"):
    return TP.Plan(tuple(
        dataclasses.replace(n, partitions=n_parts, part_sym=sym) if isinstance(n, TP.Pipeline) and n.source == "S" else n
        for n in plan.nodes), plan.result)


@pytest.mark.parametrize("kind", ["part_term", "groupby", "reduce"])
@pytest.mark.parametrize("ds", FAMILIES)
def test_plain_twin_radix_equals_unpartitioned(ds, kind):
    rng = np.random.default_rng(3)
    R, S = _rs(rng, nr=4000, ns=6000)
    db = {"R": tfrom_numpy(R, device="cpu"), "S": tfrom_numpy(S, device="cpu")}
    sigma = tstats(db)
    fused = TP.fuse(_region_plan(TP, L, TChoice, kind, ds), sigma=sigma)
    assert any(isinstance(n, TP.Pipeline) and n.stages[0].source == "S" for n in fused.nodes)
    seen = []
    real = fp.fused_pipeline_plain

    def record(program, *args, **kwargs):
        seen.append((program, kwargs))
        return real(program, *args, **kwargs)

    fp.fused_pipeline_plain = record
    try:
        flat = TE.execute_plan(fused, db, sigma=sigma)
        parted = TE.execute_plan(_mark(fused, 4), db, sigma=sigma)
    finally:
        fp.fused_pipeline_plain = real
    assert TE.last_report().mode(fused.result) == "kernel-radix"
    prog, kw = seen[-1]
    assert prog.radix and kw["radix"].n_parts == 4
    assert prog.part_terminal == (kind == "part_term") == kw["radix"].part_terminal
    if kind == "reduce":
        got, want = parted, flat
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5, atol=1e-4)
    else:
        got, want = parted.items_np(), flat.items_np()
        assert set(got) == set(want)
        for k in want:  # the same rows per group, folded in routed order
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ds", FAMILIES)
def test_oversized_dict_region_runs_radix(ds):
    """A dictionary over the reference's 64k-slot residency bound: both
    planners radix-mark the region; the port records ``kernel-radix`` and
    equals the reference (``xla-radix-planned`` on the CPU) and numpy."""
    rng = np.random.default_rng(4)
    R, S = _rs(rng)
    rdb = {"R": rfrom_numpy(R), "S": rfrom_numpy(S)}
    tdb = {"R": tfrom_numpy(R, device="cpu"), "S": tfrom_numpy(S, device="cpu")}

    def plan(P_, L_, Choice):
        def k(var, col):
            return _key(L_, var, col)
        return P_.Plan((
            P_.Scan("%r", source="R", var="r"),
            P_.GroupBy("G", source="%r", keyexpr=k("r", "a"), values=(("t", k("r", "m")),), choice=Choice(ds)),
            P_.Scan("%s", source="S", var="s"),
            P_.GroupJoin("Agg", source="%s", build="G", keyexpr=k("s", "a"), f_expr=k("s", "w"), choice=Choice()),
        ), "Agg")

    rplan = RP.fuse(plan(RP, RL, RChoice), sigma=rstats(rdb))
    tplan = TP.fuse(plan(TP, L, TChoice), sigma=tstats(tdb))
    assert rplan.describe() == tplan.describe()
    pipe = next(n for n in tplan.nodes if isinstance(n, TP.Pipeline))
    assert pipe.partitions >= 2 and pipe.part_sym == "G"
    want = RE.execute_plan(rplan, rdb, sigma=rstats(rdb)).items_np()
    assert RE.last_report().mode("Agg") == "xla-radix-planned"
    got = TE.execute_plan(tplan, tdb, sigma=tstats(tdb)).items_np()
    assert TE.last_report().mode("Agg") == "kernel-radix"
    _close(got, want)
    oracle = {}
    for a, w in zip(S["a"], S["w"]):
        if a < len(R["a"]):
            oracle[int(a)] = oracle.get(int(a), 0.0) + float(w) * float(R["m"][a])
    _close({k: float(v[0]) for k, v in got.items()}, oracle)


@pytest.fixture(scope="module")
def tpch_dbs():
    rdb = rtpch.generate(scale=0.002, seed=7).tables()
    tdb = from_reference(rdb, device="cpu")
    return rdb, rstats(rdb), tdb, tstats(tdb)


@pytest.mark.parametrize("qname", ["q3", "q18"])
def test_tpch_radix_regions_match_reference(qname, tpch_dbs):
    rdb, rsig, tdb, tsig = tpch_dbs
    rplan = RP.fuse(rcompile(RQ[qname].llql(), {}), sigma=rsig, fusion=dataclasses.replace(RFusion(), **SMALL_FUSION))
    tplan = TP.fuse(tcompile(TQ[qname].llql(), {}), sigma=tsig, fusion=dataclasses.replace(TFusion(), **SMALL_FUSION))
    assert rplan.describe() == tplan.describe()
    marked = [n for n in tplan.nodes if isinstance(n, TP.Pipeline) and n.partitions]
    assert [(n.out, n.partitions, n.part_sym) for n in marked] == [({"q3": "Agg", "q18": "Big"}[qname], 8, "OD")]
    params = dict(RQ[qname].defaults)
    want = RE.execute_plan(rplan, rdb, sigma=rsig, params=params).items_np()
    got = TE.execute_plan(tplan, tdb, sigma=tsig, params=params).items_np()
    assert TE.last_report().mode(marked[0].out) == "kernel-radix"
    _close(got, want)
    _close(got, TQ[qname].reference(tdb, **TQ[qname].defaults))


# ---------------------------------------------------------------------------
# encoded streams and carried state (the reference's storage tests)
# ---------------------------------------------------------------------------


def _groupby_program(enc):
    """``select off > 50020; group by g: sum(w * p)`` over columns
    (g i32, w f32, off i32, p f32)."""
    col = [("col", t, k) for k, t in enumerate(("i32", "f32", "i32", "f32"))]
    pred = fp.binop(">", col[2], fp.const(50020))
    return fp.Program(("i32", "f32", "i32", "f32"), (), (), (("select", fp.cast(pred, "bool")),),
                      ("groupby", col[0], (fp.binop("*", col[1], col[3]),)), ("dict", "ht_linear", 256, 1, ()),
                      enc=enc)


def _acc_items(keys, vals):
    """``{key: value row}`` of an accumulator's claimed slots (slot layouts
    depend on the order rows claim slots in; the items do not)."""
    return {int(k): v for k, v in zip(_np(keys), _np(vals)) if k != tbase.EMPTY}


def _mode_inputs(n=4096, seed=11):
    rng = np.random.default_rng(seed)
    grp = rng.integers(0, 40, n).astype(np.int32)  # bitpack-able
    w = np.repeat(rng.standard_normal(n // 256).astype(np.float32), 256)  # rle
    off = (rng.integers(0, 200, n) + 50000).astype(np.int32)  # for-able
    price = rng.choice(rng.standard_normal(7).astype(np.float32), n)  # dict
    live = rng.random(n) < 0.8
    return [grp, w, off, price], live


@pytest.mark.parametrize("block", [512, 1024])
def test_encoded_streams_equal_raw_launch(block):
    arrays, live = _mode_inputs()
    kinds = ("bitpack", "rle", "for", "dict")
    raw = fp.fused_pipeline(_groupby_program(()), [torch.from_numpy(a) for a in arrays], torch.from_numpy(live), [], [])
    streams = {}
    for k, (a, kind) in enumerate(zip(arrays, kinds)):
        e = TS.encode_column(a, block=block, mode=kind)
        assert e.kind == kind
        streams[k] = TDK.encoded_stream(e)
        # the stream decodes to the reference's tile bodies on the same words
        got = _np(TDK.decode_plain(TDK.stream_code(streams[k]), TDK.stream_payload(streams[k]), e.n))
        if kind == "rle":
            want = np.concatenate([np.asarray(RDK.decode_tile("rle", values=jnp.asarray(v), ends_row=jnp.asarray(r),
                                                              block=block))
                                   for v, r in zip(e.payload["values"], e.payload["ends"])])[: e.n]
        else:
            codes = np.asarray(RDK.unpack_words(jnp.asarray(e.payload["words"]), e.meta["bits"]))[: e.n]
            want = e.payload["values"][codes] if kind == "dict" else codes + np.int32(e.meta.get("ref", 0))
        assert np.array_equal(got.view(np.int32), np.asarray(want, dtype=a.dtype).view(np.int32))
        assert np.array_equal(got, a)
    out = fp.fused_pipeline(_groupby_program((True,) * 4), [None] * 4, torch.from_numpy(live), [], [],
                            encoded=streams)
    assert torch.equal(out[0], raw[0]) and torch.equal(out[1], raw[1])


def test_init_carry_over_two_halves_equals_one_launch():
    arrays, live = _mode_inputs()
    n, h = len(live), len(live) // 2
    prog = _groupby_program(())
    cols = [torch.from_numpy(a) for a in arrays]
    lv = torch.from_numpy(live)
    full = fp.fused_pipeline(prog, cols, lv, [], [])
    first = fp.fused_pipeline(prog, [c[:h] for c in cols], lv[:h], [], [])
    kept = tuple(t.clone() for t in first)
    both = fp.fused_pipeline(prog, [c[h:] for c in cols], lv[h:], [], [], init=first)
    assert all(torch.equal(a, b) for a, b in zip(first, kept))  # the twin leaves init as it was
    got, one = _acc_items(*both), _acc_items(*full)
    assert got.keys() == one.keys()
    for k in one:  # each key's rows fold in the same order: bit for bit
        assert np.array_equal(got[k], one[k])
    oracle = {}
    for i in range(n):
        if live[i] and arrays[2][i] > 50020:
            oracle[int(arrays[0][i])] = oracle.get(int(arrays[0][i]), 0.0) + float(arrays[1][i] * arrays[3][i])
    _close({k: float(v[0]) for k, v in got.items()}, oracle)


def test_modes_refuse_what_the_reference_excludes():
    arrays, live = _mode_inputs(n=2048)
    cols = [torch.from_numpy(a) for a in arrays]
    lv = torch.from_numpy(live)
    e = TDK.encoded_stream(TS.encode_column(arrays[0], mode="bitpack"))
    with pytest.raises(ValueError, match="encoded"):  # encoded with a program that reads the column raw
        fp.fused_pipeline(_groupby_program(()), [None] + cols[1:], lv, [], [], encoded={0: e})
    plan = fp.RadixPlan(2, torch.zeros(4, dtype=torch.int32), torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="radix"):  # radix with a program that partitions nothing
        fp.fused_pipeline(_groupby_program(()), cols, lv, [], [], radix=plan)
    sums = fp.Program(("i32",), (), (), (), ("reduce", -1, None, (("col", "i32", 0),)), ("sum", 1, ()))
    with pytest.raises(ValueError, match="carried state"):  # init with a scalar Reduce
        fp.fused_pipeline(sums, cols[:1], lv, [], [], init=(cols[0], cols[1]))


# ---------------------------------------------------------------------------
# the out-of-core fold: init= from chunk to chunk, encoded= straight from
# the upload
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions(tpch_dbs):
    rdb, rsig, tdb, _ = tpch_dbs
    budget = int(sum(4 * st.rows * len(st.columns) for rel, st in rsig.rels.items() if rel != "lineitem"))
    return (
        repro.connect(rdb, memory_budget=budget, chunk_rows=CHUNK),
        repro_torch.connect(tdb, device="cpu", memory_budget=budget, chunk_rows=CHUNK),
        repro_torch.connect(tdb, device="cpu"),
    )


def _hits(faults_mod, fn):
    """Hits of the stream's fault points during ``fn()`` (armed, never firing)."""
    specs = {}
    with faults_mod.injected("h2d", mode="nth", n=10**9) as specs["h2d"], \
            faults_mod.injected("chunk-decode", mode="nth", n=10**9) as specs["chunk-decode"], \
            faults_mod.injected("fused-region", mode="nth", n=10**9) as specs["fused-region"]:
        out = fn()
    return out, {k: s.hits for k, s in specs.items()}


# the port's fault-point hits per query at this scale and chunk size, as
# they were before the fold carried ``init=`` (one upload and one decode call
# a chunk, one ``fused-region`` check a resident region the executor
# dispatches; as in the reference, the streamed executor passes no
# whole-plan dispatch point, so the streamed regions check none)
FAULT_HITS = {
    "q1": {"h2d": 6, "chunk-decode": 6, "fused-region": 0},
    "q3": {"h2d": 6, "chunk-decode": 6, "fused-region": 1},
    "q5": {"h2d": 6, "chunk-decode": 6, "fused-region": 3},
    "q9": {"h2d": 6, "chunk-decode": 6, "fused-region": 1},
    "q18": {"h2d": 6, "chunk-decode": 6, "fused-region": 1},
}


@pytest.mark.parametrize("qname", sorted(TQ))
def test_streamed_fold_carries_init_and_reads_encoded(qname, sessions, monkeypatch):
    rs, ts, res = sessions
    ct = ts.db["lineitem"]
    launches, decoded, finals = [], [], []
    real_plain, real_chunk, real_table = fp.fused_pipeline_plain, TS.ChunkedTable.chunk_device, TE._kernel_table

    def plain(program, *args, **kwargs):
        launches.append((program, kwargs))
        return real_plain(program, *args, **kwargs)

    def chunk_device(self, i, cols=None, pad=False, uploaded=None):
        decoded.append((i, tuple(cols) if cols is not None else tuple(self.chunks[i])))
        return real_chunk(self, i, cols, pad, uploaded)

    def kernel_table(kr, res_):
        finals.append(kr.program)
        return real_table(kr, res_)

    monkeypatch.setattr(fp, "fused_pipeline_plain", plain)
    monkeypatch.setattr(TS.ChunkedTable, "chunk_device", chunk_device)
    monkeypatch.setattr(TE, "_kernel_table", kernel_table)
    got, thits = _hits(tfaults, lambda: ts.query(qname))
    trep = ts.report()
    want = rs.query(qname)
    rrep = rs.report()
    _close(got, want)
    _close(got, res.query(qname))
    assert thits == FAULT_HITS[qname]
    assert (trep.chunks, trep.h2d_bytes, trep.peak_chunk_bytes, trep.streamed_regions) == (
        rrep.chunks, rrep.h2d_bytes, rrep.peak_chunk_bytes, rrep.streamed_regions)
    kernel_regions = [m for m in trep.modes().values() if m.startswith("streamed-kernel:")]
    folds = [(p, kw) for p, kw in launches if "init" in kw]
    assert len(folds) == sum(int(m.split(":")[1]) for m in kernel_regions)
    # one finalizing build per streamed-kernel region, none per chunk
    assert len([p for p in finals if p in {f[0] for f in folds}]) == len(kernel_regions)
    for program, kw in folds:
        for k in kw.get("encoded", {}):
            assert program.enc[k]
    if kernel_regions:
        # lineitem streams through this region alone: no chunk_device call
        # decoded a column that its chunk stores encoded, and the folds read
        # such columns as encoded streams
        assert decoded and not any(ct.chunks[i][c].kind in ENCODED for i, names in decoded for c in names)
        assert any(kw.get("encoded") for _, kw in folds)


ENCODED = ("bitpack", "for", "dict", "rle")
