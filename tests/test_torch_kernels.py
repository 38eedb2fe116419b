"""The port's kernel modules against the reference, on the CPU.

* the plain merge lookup against ``repro``'s Pallas kernel in interpret
  mode, inside one window and across a window miss (whole-table fallback);
* the fused pipeline's plain twin (the port's ``kernel-resident`` path on
  CPU tensors) against ``repro``'s region result for every terminal kind;
* the CUDA emitter writes a source for every eligible region of the five
  TPC-H queries;
* the plain segment reduce against ``repro``'s Pallas kernel in interpret
  mode and against its semantic oracle (``repro.kernels.ref``);
* the plain flash attention against ``repro``'s Pallas kernel in interpret
  mode and against its dense oracle, on the reference suite's six cases, a
  fully masked row and bfloat16.
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
from repro.kernels.flash_attention import flash_attention as r_flash_attention
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
from repro_torch.kernels import flash_attention as fa
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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (B, H, Hkv, Tq, Tk, D, causal, window): the reference suite's six cases
# (tests/test_kernels.py), then Tq > Tk under causality, whose first rows
# see no key and return 0; pixtral's head dim 160 (GQA 4:1 causal,
# non-causal, unaligned); whisper's cross attention (non-causal, a few
# queries and one query over more keys)
FLASH_CASES = {
    "mha": (1, 2, 2, 64, 64, 16, True, 0),
    "gqa": (1, 4, 2, 64, 64, 16, True, 0),
    "mqa_decode": (1, 4, 1, 32, 96, 16, True, 0),
    "cross": (1, 2, 2, 64, 64, 16, False, 0),
    "window": (1, 2, 1, 96, 96, 16, True, 40),
    "unaligned": (1, 1, 1, 50, 70, 16, True, 0),
    "masked_rows": (2, 4, 2, 40, 24, 16, True, 0),
    "d160_gqa": (1, 4, 1, 64, 64, 160, True, 0),
    "d160_noncausal": (1, 2, 2, 40, 40, 160, False, 0),
    "d160_unaligned": (1, 4, 1, 50, 70, 160, True, 0),
    "whisper_cross": (2, 4, 4, 7, 150, 16, False, 0),
    "whisper_cross_decode": (2, 4, 4, 1, 150, 16, False, 0),
}
FLASH_TOL = 2e-3  # the reference suite's tolerance for its kernel against the oracle


def _qkv(B, H, Hkv, Tq, Tk, D, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Tq, D)).astype(dtype), rng.normal(size=(B, Hkv, Tk, D)).astype(dtype),
            rng.normal(size=(B, Hkv, Tk, D)).astype(dtype))


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_reference_kernel(case):
    B, H, Hkv, Tq, Tk, D, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(B, H, Hkv, Tq, Tk, D, seed=Tq * Tk + H)
    got = kops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=causal, window=window).numpy()
    assert fa.flash_attention.launches == 0  # CPU tensors take the twin
    pallas = r_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                               bq=32, bk=32, interpret=True)
    g = H // Hkv
    dense = rref.flash_attention(jnp.asarray(q), jnp.repeat(jnp.asarray(k), g, axis=1),
                                 jnp.repeat(jnp.asarray(v), g, axis=1), causal=causal, window=window)
    for want in (pallas, dense):
        np.testing.assert_allclose(got, np.asarray(want), rtol=FLASH_TOL, atol=FLASH_TOL)
    if case == "masked_rows":  # rows at key positions < 0 see nothing
        assert not got[:, :, : Tq - Tk].any()


@pytest.mark.parametrize("case", ["gqa", "window", "unaligned", "d160_gqa", "d160_unaligned", "whisper_cross"])
def test_flash_attention_plain_matches_reference_kernel_bf16(case):
    """bfloat16 in and out, float32 accumulation, ``p`` rounded to bfloat16
    before the PV product in both.  Tolerance 1e-2: the outputs are rounded
    to bfloat16 (a step of 2^-8 = 3.9e-3 just below 1, 2^-7 above), and a
    ``p`` that lands on the other side of a rounding boundary moves the sum."""
    B, H, Hkv, Tq, Tk, D, causal, window = FLASH_CASES[case]
    q, k, v = _qkv(B, H, Hkv, Tq, Tk, D, seed=Tq + Tk)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tq, tk, tv))
    want = r_flash_attention(jq, jk, jv, causal=causal, window=window, bq=32, bk=32, interpret=True)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("case", ["gqa", "window", "masked_rows"])
def test_flash_attention_plain_tile_skips_are_exact(case):
    """The key tiles the twin (and the kernel) skip are masked whole: one
    tile over everything, which skips nothing, gives the same result to
    float32 rounding of the regrouped sums."""
    B, H, Hkv, Tq, Tk, D, causal, window = FLASH_CASES[case]
    q, k, v = (torch.from_numpy(a) for a in _qkv(B, H, Hkv, Tq, Tk, D, seed=7))
    tiled = fa.flash_attention_plain(q, k, v, causal=causal, window=window, bq=16, bk=8)
    whole = fa.flash_attention_plain(q, k, v, causal=causal, window=window, bq=Tq, bk=Tk)
    np.testing.assert_allclose(tiled.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)


def test_flash_attention_chunked_matches_reference():
    q, k, v = _qkv(1, 4, 2, 64, 96, 16, seed=3)
    for causal, window, kv_valid in [(True, 0, None), (False, 0, None), (True, 24, None), (False, 0, 50)]:
        got = kops.ref.flash_attention_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                               causal=causal, window=window, chunk=32, kv_valid=kv_valid)
        want = rref.flash_attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                            window=window, chunk=32, kv_valid=kv_valid)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Tk,kv_valid", [(48, 1), (48, 30), (48, 48), (2100, 1500)])
def test_flash_attention_kv_valid_matches_reference_ops(Tk, kv_valid):
    """A ``kv_valid`` mask takes the plain definitions in both packages: the
    dense softmax over repeated K/V up to 2,048 slots, the chunked online
    softmax above."""
    from repro.kernels import ops as rops

    q, k, v = _qkv(2, 4, 2, 1, Tk, 16, seed=Tk + kv_valid)
    got = kops.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               causal=False, kv_valid=torch.tensor(kv_valid))
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                kv_valid=jnp.int32(kv_valid))
    assert fa.flash_attention.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
