"""The port's kernel modules against the reference, on the CPU.

* the plain merge lookup against ``repro``'s Pallas kernel in interpret
  mode, inside one window and across a window miss (whole-table fallback);
* the fused pipeline's plain twin (the port's ``kernel-resident`` path on
  CPU tensors) against ``repro``'s region result for every terminal kind;
* the CUDA emitter writes a source for every eligible region of the five
  TPC-H queries;
* the plain segment reduce against ``repro``'s Pallas kernel in interpret
  mode and against its semantic oracle (``repro.kernels.ref``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import llql as RL
from repro.core import operators as RO
from repro.core import plan as RP
from repro.core.cost import DictChoice as RChoice
from repro.core.lower import compile as rcompile
from repro.data.table import collect_stats as rstats
from repro.data.table import from_numpy as rfrom_numpy
from repro.exec import engine as RE
from repro.kernels import ref as rref
from repro.kernels.merge_lookup import merge_lookup as r_merge_lookup
from repro.kernels.segment_reduce import segment_reduce as r_segment_reduce

import repro_torch
from repro_torch.core import llql as TL
from repro_torch.core import operators as TO
from repro_torch.core import plan as TP
from repro_torch.core.cost import DictChoice as TChoice
from repro_torch.core.lower import compile as tcompile
from repro_torch.data import tpch
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats as tstats
from repro_torch.exec import engine as TE
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import merge_lookup as ml
from repro_torch.kernels import ops as kops
from repro_torch.kernels import segment_reduce as sr

RTOL, ATOL = 3e-3, 3e-2  # float32 sums folded in another order


def _table(C: int, V: int, seed: int):
    rng = np.random.default_rng(seed)
    live = np.sort(rng.choice(10**7, size=C - 100, replace=False)).astype(np.int32)
    keys = np.concatenate([live, np.full(100, 2**31 - 1, np.int32)])  # PAD tail
    vals = rng.normal(size=(C, V)).astype(np.float32)
    vals[C - 100:] = 0.0
    return keys, vals


@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("case", ["in_window", "window_miss"])
def test_merge_lookup_plain_matches_reference_kernel(V, case):
    C = 8192
    keys, vals = _table(C, V, seed=V)
    rng = np.random.default_rng(10 + V)
    if case == "in_window":
        # one block's queries inside rows [2048, 6144); the reference's
        # 12-round search misses window position 1 (ROADMAP.md §3), so the
        # sample skips it — the next test covers that position
        pos = rng.choice(np.arange(2050, 6000), size=400, replace=False)
        qs = np.concatenate([keys[pos], keys[pos] + 1])
    else:
        pos = rng.choice(np.arange(C - 100), size=3000, replace=False)
        qs = np.concatenate([keys[pos], keys[pos] - 1, np.asarray([-5, 2**31 - 2], np.int32)])
    qs = np.sort(qs).astype(np.int32)
    rv, rf = r_merge_lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs), interpret=True)
    tv, tf = ml.merge_lookup(torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(qs))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_merge_lookup_finds_window_position_one():
    """The key at window offset 1 is found, as the reference's semantic
    oracle (``kernels.ref.merge_lookup``) finds it."""
    C = 8192
    keys, vals = _table(C, 1, seed=7)
    qs = np.sort(keys[[1, 2, 3, 50]]).astype(np.int32)
    rv, rf = rref.merge_lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs))
    tv, tf = ml.merge_lookup(torch.from_numpy(keys), torch.from_numpy(vals), torch.from_numpy(qs))
    assert bool(tf.all())
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


# ---------------------------------------------------------------------------
# fused pipeline: one region per terminal kind, built in both packages
# ---------------------------------------------------------------------------


def _db(seed: int):
    rng = np.random.default_rng(seed)
    R = {
        "a": np.arange(3000, dtype=np.int32),
        "m": rng.normal(size=3000).astype(np.float32),
    }
    S = {
        "a": rng.integers(0, 3600, 5000).astype(np.int32),
        "w": rng.normal(size=5000).astype(np.float32),
        "k": rng.integers(-40, 40, 5000).astype(np.int32),
    }
    rdb = {"R": rfrom_numpy(R), "S": rfrom_numpy(S)}
    return rdb, from_reference(rdb, device="cpu")


def _plans(L, P, Choice, ds):
    def key(var, col):
        return L.FieldAccess(L.FieldAccess(L.Var(var), "key"), col)

    def c(x):
        return L.Const(x, L.DOUBLE if isinstance(x, float) else L.INT)

    groupby = P.Plan((
        P.Scan("%s", source="S", var="s"),
        P.Select("%t", source="%s", pred=L.BinOp(">", key("s", "w"), c(-0.5))),
        P.GroupBy(
            "Agg", source="%t",
            keyexpr=L.BinOp("%", key("s", "k"), c(7)),
            values=(
                ("sum", L.BinOp("*", key("s", "w"), c(2.0))),
                ("lo", L.BinOp("/", key("s", "k"), c(3))),
                ("hi", key("s", "w")),
            ),
            choice=Choice(ds), ops=("sum", "min", "max"),
        ),
    ), "Agg")
    groupjoin = P.Plan((
        P.Scan("%r", source="R", var="r"),
        P.GroupBy("G", source="%r", keyexpr=key("r", "a"),
                  values=(("t", key("r", "m")),), choice=Choice(ds)),
        P.Scan("%s", source="S", var="s"),
        P.GroupJoin("Agg", source="%s", build="G", keyexpr=key("s", "a"),
                    f_expr=key("s", "w"), choice=Choice(ds)),
    ), "Agg")
    reduce = P.Plan((
        P.Scan("%s", source="S", var="s"),
        P.Select("%t", source="%s", pred=L.BinOp("<", key("s", "a"), c(3000))),
        P.Reduce("Tot", source="%t", fields=(
            ("lo", key("s", "w")), ("hi", L.BinOp("-", c(0), key("s", "k"))),
            ("n", L.FieldAccess(L.Var("s"), "val")),
        ), ops=("min", "max", "sum")),
    ), "Tot")
    return {"groupby": groupby, "groupjoin": groupjoin, "reduce": reduce}


def _same(got, want):
    if isinstance(want, dict) and not hasattr(want, "items_np"):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(np.asarray(want[k])), rtol=RTOL, atol=ATOL)
        return
    g, w = got.items_np(), want.items_np()
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)


_FAMILIES = ("ht_linear", "ht_twochoice", "st_sorted", "st_blocked")


@pytest.mark.parametrize(
    "kind,ds",
    [("groupby", d) for d in _FAMILIES] + [("groupjoin", d) for d in _FAMILIES]
    + [("reduce", "ht_linear")],
)
def test_fused_plain_matches_reference_region(kind, ds):
    rdb, tdb = _db(seed=11)
    rplan = RP.fuse(_plans(RL, RP, RChoice, ds)[kind], sigma=rstats(rdb))
    tplan = TP.fuse(_plans(TL, TP, TChoice, ds)[kind], sigma=tstats(tdb))
    assert rplan.describe() == tplan.describe()
    want = RE.execute_plan(rplan, rdb, sigma=rstats(rdb))
    got = TE.execute_plan(tplan, tdb, sigma=tstats(tdb))
    term = tplan.result
    assert TE.last_report().mode(term) == "kernel-resident", TE.last_report().modes()
    _same(got, want)


def test_fused_plain_lookup_reduce_matches_reference():
    """A Reduce terminal with an interleaved dictionary lookup (Fig. 7b)."""
    rng = np.random.default_rng(12)
    S = {"s": np.sort(rng.integers(0, 40, 800)).astype(np.int32), "i": rng.normal(size=800).astype(np.float32)}
    R = {"s": np.arange(40, dtype=np.int32), "c": rng.normal(size=40).astype(np.float32)}
    rdb = {"S": rfrom_numpy(S, sorted_on=("s",)), "R": rfrom_numpy(R, sorted_on=("s",))}
    tdb = from_reference(rdb, device="cpu")
    rplan = RP.fuse(rcompile(RO.covar_interleaved(), {"Ragg": RChoice("st_sorted", True)}), sigma=rstats(rdb))
    tplan = TP.fuse(tcompile(TO.covar_interleaved(), {"Ragg": TChoice("st_sorted", True)}), sigma=tstats(tdb))
    want = RE.execute_plan(rplan, rdb, sigma=rstats(rdb))
    got = TE.execute_plan(tplan, tdb, sigma=tstats(tdb))
    assert TE.last_report().mode("Covar") == "kernel-resident"
    _same(got, want)


# ---------------------------------------------------------------------------
# the CUDA emitter
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tpch_programs():
    """Every region program the five queries hand the fused pipeline."""
    db = tpch.generate(scale=0.002, seed=7, device="cpu").tables()
    seen = []
    real = fp.fused_pipeline_plain

    def record(program, *args):
        seen.append(program)
        return real(program, *args)

    fp.fused_pipeline_plain = record
    try:
        s = repro_torch.connect(db, device="cpu")
        for q in ("q1", "q3", "q5", "q9", "q18"):
            s.query(q)
    finally:
        fp.fused_pipeline_plain = real
    return seen


def test_emitter_writes_source_for_every_tpch_region(tpch_programs):
    assert len(tpch_programs) >= 5  # q1, q3 (two regions), q5, q9, q18 at this scale
    for program in tpch_programs:
        src = fp.emit_source(program)
        assert 'extern "C" int fused_region_launch' in src
        assert "__device__ __forceinline__ bool row(" in src
        assert src.count("{") == src.count("}")
        assert fp.emit_source(program) == src  # deterministic: names the build


# ---------------------------------------------------------------------------
# segment reduce
# ---------------------------------------------------------------------------

# (distinct keys, rows, reference block, value lanes, PAD rows at the tail,
# integer-valued inputs): the cases of tests/test_kernels.py, then one key
# over many blocks, a single row, a PAD tail, a ragged last block, V = 1, 5
SEGMENT_CASES = {
    "k30": (30, 2000, 256, 2, 0, False),
    "k3": (3, 1500, 512, 2, 0, False),
    "k1": (1, 600, 128, 2, 0, False),
    "k1200": (1200, 2048, 1024, 2, 0, False),
    "all_equal": (1, 5000, 128, 3, 0, True),
    "one_row": (4, 1, 128, 3, 0, False),
    "pad_tail": (40, 3000, 256, 3, 700, True),
    "ragged": (500, 3001, 1024, 3, 0, False),
    "v1": (60, 2500, 512, 1, 13, False),
    "v5": (60, 2500, 512, 5, 0, True),
}


def _segment_inputs(nkeys, n, V, pad, ints, seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, nkeys, n)).astype(np.int32)
    if pad:
        keys[n - pad:] = 2**31 - 1
    if ints:
        vals = rng.integers(-50, 50, (n, V)).astype(np.float32)
    else:
        vals = rng.normal(size=(n, V)).astype(np.float32)
    return keys, vals


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_reduce_plain_matches_reference(case):
    nkeys, n, block, V, pad, ints = SEGMENT_CASES[case]
    keys, vals = _segment_inputs(nkeys, n, V, pad, ints, seed=n + V)
    ts, te = kops.segment_reduce(torch.from_numpy(keys), torch.from_numpy(vals))
    assert sr.segment_reduce.launches == 0  # CPU tensors take the twin
    for rs, re in (
        r_segment_reduce(jnp.asarray(keys), jnp.asarray(vals), block=block, interpret=True),
        rref.segment_reduce(jnp.asarray(keys), jnp.asarray(vals)),
    ):
        np.testing.assert_array_equal(te.numpy(), np.asarray(re))
        if ints:  # integer-valued sums are exact in any order
            np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        else:
            np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=3e-4, atol=1e-4)
    if pad:
        assert not te[n - pad:].any() and not ts[n - pad:].any()


def test_segment_reduce_plain_empty():
    sums, ends = sr.segment_reduce(torch.zeros((0,), dtype=torch.int32), torch.zeros((0, 3)))
    assert sums.shape == (0, 3) and ends.shape == (0,) and ends.dtype == torch.bool
