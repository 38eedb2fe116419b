"""The CUDA kernels against their plain twins, at small shapes, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips where no
CUDA device exists (decided at run time, so every worker collects the same
tests).  On a machine with the card: ``python -m pytest -m gpu tests``.

The fused pipeline is generated per region, so the TPC-H regions run under
every dictionary choice set (each family's find and accumulator is its own
device code), and two scalar Reduce regions cover the block-reduction
kernel.  Every launch is held against its plain twin on the same inputs.
The segment reduce runs adversarial run layouts (one run over thousands of
tiles, a PAD tail, a ragged last tile, V = 1 and 5; n = 1, 4,095, 4,096 and
4,097 and one run of 3,000,001 rows at V = 1, 3, 5, 8 bit for bit;
unaligned inputs; its lane limit), and the in-DB ML path
(the normal-equation batch, the factorized and naive covariance) runs at a
small size with every kernel launch held against its twin.  The decode
kernel runs every encoding and bit width on ragged and short final chunks,
bit for bit against its twin, and a small out-of-core session streams
lineitem through it.  The flash-attention kernel runs bfloat16 and float32
at the shapes ``chip_smoke.py`` gives it (MHA, GQA, MQA, a window, unaligned
lengths, Tq < Tk, Tq > Tk, non-causal, strided head splits; the wgmma
kernel at D = 64 and 128 over lengths on both sides of its 128-row tiles,
windows of 40 and 200, strided heads bit for bit), and a reduced
llama forward on the card launches it once per layer, as a reduced scout
(MoE) forward does, whose sort dispatch equals its scatter dispatch on the
card at 8,192 and 65,536 tokens over 16 and 128 experts.  Its gradient
(``FlashAttentionFn``: the kernel forward, the reference's plain route
backward) is held against the plain route in float32, and a reduced llama
trains on the card with two launches a layer a step (forward and remat
recompute), its losses following the CPU's.  The dictionary
kernels (hash probe, sorted lookup, hash build) run against their twins at
small and TPC-H SF 0.01 shapes, through the families' routes too, and the
installation sweep's smallest cell launches all three.  The merge lookup
runs across tile edges (n = 1 to 200,003) on staged tiles, tiles searched in
global memory, one key, window offset 1 and EMPTY/PAD probes, V = 1 to 9;
the sorted lookup on each of its paths (the global search, the table on
chip, sampled at S = 2, 4 and 32; odd C, a live count no multiple of S,
fewer keys than a stride, runs of equal keys), both with unaligned inputs,
bit for bit.  An adaptive session races q1 and q3 at TPC-H SF 0.01, every
lane valid by the card's rule, and records whether two runs of one Γ are
bitwise equal.  A 2-shard session runs q3 and q18 at TPC-H SF 0.01 on the
card against the resident session and numpy, every launch of its warm run
held against its twin.  The selective-scan kernel runs bfloat16 and float32
at d_state 4, 8 and 16 against its twin (a carried state, T = 1, ragged
time tiles and channel blocks, strided B / C; its two-stage ring wrapped
with a ragged tail, a width one channel past a block, every d_state with
B > 1, 64 steps at jamba's width) and refuses what it does not take;
its backward kernel runs the same cases against its twin, two launches
bitwise equal, refuses what the forward refuses and a second-order
gradient; a reduced jamba trains 3 steps on the card (the scan kernel in
the forward and the remat recompute, the backward kernel once a Mamba
sub-layer), its losses following the CPU's; reduced rwkv6 and jamba
forwards and decode steps on the card follow the CPU's, the scan kernel
launched once a Mamba sub-layer.  The flash-attention kernel also runs pixtral's head dim 160
(its layer at 2,048, unaligned, non-causal, Tq < Tk; the wgmma kernel over
the same lengths as at D = 64 and 128, strided heads bit for bit) and
whisper's encoder and cross shapes (1,500 frames; 448 and 1 queries over
them); its gradient runs non-causal with Tq != Tk and at D = 160; a reduced
whisper (encoder, decoder self and cross attention) and a reduced pixtral
at D = 160 with patches forward on the card against the CPU, one launch an
attention call, and whisper's decode launches once a layer a step.  The
LM sharding runs with every shard on the card: the expert-parallel MoE
region on a (data 2, model 4) mesh against ``moe_apply`` per data half and
the CPU's region, the ring all-gather matmul against ``X @ W``, and
``compressed_psum`` against the float sum.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import llql as L
from repro_torch.core import operators as O
from repro_torch.core import plan as P
from repro_torch.core.cost import AnalyticCostModel, DictChoice
from repro_torch.core.lower import compile as compile_plan
from repro_torch.core.synthesis import synthesize
from repro_torch.data import storage as S
from repro_torch.data import tpch
from repro_torch.data.table import collect_stats, from_numpy
from repro_torch.dicts import base as dbase
from repro_torch.exec import engine as E
from repro_torch.exec.queries import REGISTRY
from repro_torch.kernels import decode as dk
from repro_torch.kernels import flash_attention as fa
from repro_torch.costmodel import profile
from repro_torch.dicts import ht_linear, st_sorted
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import hash_build as hb
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import merge_lookup as ml
from repro_torch.kernels import ref
from repro_torch.kernels import sorted_lookup as sl
from repro_torch.kernels import segment_reduce as sr
from repro_torch.kernels import ops as kops
from repro_torch.kernels import selective_scan as ssk
from repro_torch.models import common, jamba, lm, moe, rwkv6, whisper
from repro_torch.models.registry import get_model, get_model_by_name

pytestmark = pytest.mark.gpu

RTOL, ATOL = 3e-3, 3e-2  # atomics fold float32 sums in another order
_SYMS = ("Agg", "Sd", "OD", "QtyAgg", "CN", "SN", "PX", "Ragg")
CHOICE_SETS = {
    "default": {},
    "st_sorted": {s: DictChoice("st_sorted", True) for s in _SYMS},
    "ht_twochoice": {s: DictChoice("ht_twochoice") for s in _SYMS},
    "ht_linear": {s: DictChoice("ht_linear") for s in _SYMS},
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tpch_db(cuda):
    db = tpch.generate(scale=0.002, seed=7, device=cuda).tables()
    return db, collect_stats(db)


@contextlib.contextmanager
def recording(module, name):
    """Record every call of ``module.name`` as ``(args, kwargs, out)``; a
    carried ``init`` state, which the launch updates in place and later
    launches update again, is recorded as it was before and after the
    call."""
    real, calls = getattr(module, name), []

    def record(*args, **kwargs):
        before = dict(kwargs)
        if kwargs.get("init") is not None:
            before["init"] = tuple(t.clone() for t in kwargs["init"])
        out = real(*args, **kwargs)
        calls.append((args, before, tuple(t.clone() for t in out) if kwargs.get("init") is not None else out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _flat(acc):
    """A dictionary accumulator with its partitions (if any) laid end to end."""
    keys, vals = acc
    return keys.reshape(-1), vals.reshape(keys.numel(), -1)


def _dict_items(keys, vals):
    ks, vs = keys.cpu().numpy(), vals.cpu().numpy()
    return {int(k): v for k, v in zip(ks, vs) if k != dbase.EMPTY}


def _same_items(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def _same_tables(got, want):
    """Equal key sets and value rows within the tolerance, compared on the
    device (tables of millions of slots)."""
    def live_sorted(keys, vals):
        keep = keys != dbase.EMPTY
        order = torch.argsort(keys[keep])
        return keys[keep][order], vals[keep][order]

    (gk, gv), (wk, wv) = live_sorted(*got), live_sorted(*want)
    assert torch.equal(gk, wk)
    torch.testing.assert_close(gv, wv, rtol=RTOL, atol=ATOL)


def _fused_calls_match_plain(calls):
    for args, kwargs, out in calls:
        want = fp.fused_pipeline_plain(*args, **kwargs)
        torch.cuda.synchronize()
        if args[0].out[0] == "sum":
            torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        else:
            _same_items(_dict_items(*_flat(out)), _dict_items(*_flat(want)))


@pytest.mark.parametrize("V", [1, 4])
def test_merge_lookup_kernel_matches_plain(cuda, V):
    rng = np.random.default_rng(V)
    C = 1 << 14
    keys = np.concatenate([np.sort(rng.choice(10**7, C - 50, replace=False)), np.full(50, dbase.PAD)]).astype(np.int32)
    vals = rng.normal(size=(C, V)).astype(np.float32)
    near = np.sort(keys[rng.choice(C - 50, 5000)] + rng.integers(0, 2, 5000)).astype(np.int32)
    spread = np.sort(rng.integers(-5, 10**7, 3000)).astype(np.int32)
    for qs in (near, spread):
        k, v, q = (torch.from_numpy(a).to(cuda) for a in (keys, vals, qs))
        before = ml.merge_lookup.launches
        gv, gf = ml.merge_lookup(k, v, q)
        torch.cuda.synchronize()
        assert ml.merge_lookup.launches == before + 2  # the tile ranges, then the lookup
        pv, pf = ml.merge_lookup_plain(k, v, q)
        assert torch.equal(gf, pf)
        assert torch.equal(gv, pv)


def _merge_edge(case, n, V, rng):
    """(keys [C], vals [C, V], non-decreasing probes, whether every tile's
    range is staged) at ``n`` probes into a 2^17-key PAD-tailed table."""
    C = 1 << 17
    live = np.sort(rng.choice(10**8, C - 999, replace=False)).astype(np.int32)
    keys = np.concatenate([live, np.full(999, dbase.PAD, np.int32)])
    vals = rng.normal(size=(C, V)).astype(np.float32)
    vals[C - 999:] = 0.0
    if case == "dense":  # about four probes a key: every tile staged
        s0 = int(rng.integers(0, C // 2))
        pos = np.sort(rng.integers(s0, s0 + n // 4 + 1, n))
        qs = keys[pos] + (rng.random(n) < 0.3)
    elif case == "sparse":  # probes spread over the table: tiles search in global memory
        qs = rng.integers(-10, 10**8 + 10, n)
    elif case == "one_key":
        qs = np.full(n, keys[C // 3])
    elif case == "window_offset_1":  # keys at offset 1 of every 2,048-key window, and around them
        at = np.arange(1, C - 999, 2048)
        qs = np.resize(np.concatenate([keys[at], keys[at - 1], keys[at + 1]]), n)
    else:  # EMPTY, PAD, below the first and past the last key
        m = max(n, 8)
        qs = np.resize(np.concatenate([np.full(m // 4, dbase.EMPTY), keys[rng.integers(0, C - 999, m // 2)],
                                       [keys[0] - 1, keys[C - 1000] + 1], np.full(m - m // 4 - m // 2 - 2, dbase.PAD)]), n)
    qs = np.sort(qs).astype(np.int32)
    return keys, vals, qs


@pytest.mark.parametrize("V", [1, 3, 5, 9])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 5, 200_003])
@pytest.mark.parametrize("case", ["dense", "sparse", "one_key", "window_offset_1", "pad_empty"])
def test_merge_lookup_kernel_edges(cuda, case, n, V):
    """The kernel against its twin bit for bit across tile edges: staged
    tiles, tiles whose range overflows the stage (global search), one key,
    window offset 1, EMPTY/PAD probes; V = 9 takes the kernel's run-time-V
    instance; queries read one int32 off 16-byte alignment."""
    rng = np.random.default_rng(n + V)
    keys, vals, qs = _merge_edge(case, n, V, rng)
    k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    q = torch.from_numpy(qs).to(cuda)
    _, count = ml.tile_ranges(k, q)
    staged = count <= ml.STAGE
    if case in ("dense", "one_key"):
        assert bool(staged.all())
    if case == "sparse" and 1 < n < 100_000:  # a tile spans more keys than the stage holds
        assert not bool(staged.all())
    qpad = torch.cat([q[:1], q])  # the same probes, the view one int32 past an aligned start
    for probes in (q, qpad[1:]):
        before = ml.merge_lookup.launches
        gv, gf = ml.merge_lookup(k, v, probes)
        torch.cuda.synchronize()
        assert ml.merge_lookup.launches == before + 2
        for tile in (None, ml.TILE):  # the searchsorted twin, the kernel's tile model
            pv, pf = ml.merge_lookup_plain(k, v, probes, tile=tile)
            assert torch.equal(gf, pf) and torch.equal(gv, pv)
        wv, wf = dbase.sorted_lookup(k, v, probes)
        assert torch.equal(gf, wf) and torch.equal(gv, wv)
    if case == "window_offset_1":
        assert bool(gf.all())


@pytest.mark.parametrize("choices", sorted(CHOICE_SETS))
def test_fused_pipeline_kernel_matches_plain_on_tpch(cuda, tpch_db, choices):
    """Every region program of the five queries under one choice set,
    kernel vs plain twin on the same card inputs, and each query's result
    against its numpy reference."""
    db, sigma = tpch_db
    with recording(fp, "fused_pipeline") as fused, recording(ml, "merge_lookup") as merged:
        for q in ("q1", "q3", "q5", "q9", "q18"):
            plan = P.fuse(compile_plan(REGISTRY[q].llql(), CHOICE_SETS[choices]), sigma=sigma)
            got = E.execute_plan(plan, db, sigma=sigma, params=dict(REGISTRY[q].defaults))
            _same_items(got.items_np(), REGISTRY[q].reference(db))
    assert fused
    if choices != "default":  # the chosen family is probed or accumulated on the card
        used = {d.ds for args, _, _ in fused for d in args[0].dicts}
        used |= {args[0].out[1] for args, _, _ in fused if args[0].out[0] == "dict"}
        assert choices in used, used
    _fused_calls_match_plain(fused)
    for (keys, vals, qs), _, (gv, gf) in merged:
        pv, pf = ml.merge_lookup_plain(keys, vals, qs)
        assert torch.equal(gf, pf)
        assert torch.equal(gv, pv)


def _scalar_reduce_plan():
    def key(var, col):
        return L.FieldAccess(L.FieldAccess(L.Var(var), "key"), col)

    return P.Plan((
        P.Scan("%s", source="S", var="s"),
        P.Select("%t", source="%s", pred=L.BinOp("<", key("s", "a"), L.Const(3000, L.INT))),
        P.Reduce("Tot", source="%t", fields=(
            ("lo", key("s", "w")), ("hi", L.BinOp("-", L.Const(0, L.INT), key("s", "k"))),
            ("n", L.FieldAccess(L.Var("s"), "val")),
        ), ops=("min", "max", "sum")),
    ), "Tot")


@pytest.mark.parametrize("kind", ["min_max_sum", "lookup"])
def test_fused_pipeline_reduce_kernel_matches_plain(cuda, kind):
    """A scalar Reduce terminal (block reduction, one atomic per lane), plain
    and with an interleaved ``st_sorted`` lookup (Fig. 7b)."""
    rng = np.random.default_rng(5)
    if kind == "min_max_sum":
        db = {"S": from_numpy({
            "a": rng.integers(0, 3600, 50_000).astype(np.int32),
            "w": rng.normal(size=50_000).astype(np.float32),
            "k": rng.integers(-40, 40, 50_000).astype(np.int32),
        }, device=cuda)}
        plan = P.fuse(_scalar_reduce_plan(), sigma=collect_stats(db))
    else:
        db = {
            "S": from_numpy({"s": np.sort(rng.integers(0, 400, 50_000)).astype(np.int32),
                             "i": rng.normal(size=50_000).astype(np.float32)}, sorted_on=("s",), device=cuda),
            "R": from_numpy({"s": np.arange(400, dtype=np.int32),
                             "c": rng.normal(size=400).astype(np.float32)}, sorted_on=("s",), device=cuda),
        }
        plan = P.fuse(compile_plan(O.covar_interleaved(), {"Ragg": DictChoice("st_sorted", True)}),
                      sigma=collect_stats(db))
    with recording(fp, "fused_pipeline") as fused:
        E.execute_plan(plan, db, sigma=collect_stats(db))
    assert E.last_report().mode(plan.result) == "kernel-resident"
    assert [args[0].out[0] for args, _, _ in fused] == ["sum"]
    _fused_calls_match_plain(fused)


def test_queries_on_card_match_reference(cuda):
    db = tpch.generate(scale=0.002, seed=7, device=cuda).tables()
    s = repro_torch.connect(db, device=cuda)
    for name, q in repro_torch.exec.queries.REGISTRY.items():
        got = s.query(name)
        ref = q.reference(db, **q.defaults)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=3e-3, atol=3e-2)


# (distinct keys, rows, V, PAD rows at the tail, integer-valued inputs)
SEGMENT_CASES = {
    "k30": (30, 2000, 2, 0, False),
    "one_row": (4, 1, 3, 0, False),
    # one run over 2,198 tiles of 4,096 rows: the look-back walks through it
    "all_equal": (1, 9_000_000, 3, 0, True),
    "few_long_runs": (7, 9_000_000, 2, 1000, True),
    "pad_tail": (40, 300_000, 3, 70_000, True),
    "ragged": (5000, 3_000_001, 3, 0, False),
    "v1": (60, 25_000, 1, 13, False),
    "v5": (600, 250_000, 5, 0, True),
}


@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_reduce_kernel_matches_plain(cuda, case):
    nkeys, n, V, pad, ints = SEGMENT_CASES[case]
    rng = np.random.default_rng(n + V)
    keys = np.sort(rng.integers(0, nkeys, n)).astype(np.int32)
    if pad:
        keys[n - pad:] = dbase.PAD
    # integer values in [-1, 1]: every partial sum stays below 2^24, so any
    # summation order is exact
    vals = (rng.integers(-1, 2, (n, V)) if ints else rng.normal(size=(n, V))).astype(np.float32)
    k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    before = sr.segment_reduce.launches
    gs, ge = sr.segment_reduce(k, v)
    torch.cuda.synchronize()
    assert sr.segment_reduce.launches == before + 1
    ps, pe = sr.segment_reduce_plain(k, v)
    assert torch.equal(ge, pe)
    if ints:
        assert torch.equal(gs, ps)
    else:
        torch.testing.assert_close(gs, ps, rtol=RTOL, atol=ATOL)


def test_segment_reduce_kernel_refuses_what_it_does_not_take(cuda):
    k = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sr.segment_reduce(k, torch.zeros((8, 2), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        sr.segment_reduce(k, torch.zeros((2, 8), device=cuda).t())
    with pytest.raises(ValueError):
        sr.segment_reduce(k.cpu(), torch.zeros((8, 2), device=cuda))


# n = 1, one tile less one row, one tile, one tile and a row; then one run of
# 3,000,001 equal keys across all 733 tiles.  Integer values in [-1, 1]
# keep every partial sum exact, so the kernel equals its twin bit for bit.
@pytest.mark.parametrize("V", [1, 3, 5, 8])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3_000_001])
def test_segment_reduce_lookback_edges(cuda, n, V):
    rng = np.random.default_rng(n + 7 * V)
    keys = np.zeros(n, np.int32) if n > 4097 else np.sort(rng.integers(0, 30, n)).astype(np.int32)
    vals = rng.integers(-1, 2, (n, V)).astype(np.float32)
    k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    before = sr.segment_reduce.launches
    gs, ge = sr.segment_reduce(k, v)
    torch.cuda.synchronize()
    assert sr.segment_reduce.launches == before + 1
    ps, pe = sr.segment_reduce_plain(k, v)
    assert torch.equal(ge, pe) and torch.equal(gs, ps)
    if n > 4097:  # the one run's total sits at the last row
        assert int(ge.sum()) == 1 and torch.equal(gs[-1].cpu(), torch.from_numpy(vals.sum(0, dtype=np.float64)).float())


def test_segment_reduce_unaligned_inputs_take_plain_loads(cuda):
    """Inputs that are not 16-byte aligned (a slice one row in) take the
    kernel's plain loads and stores in every tile."""
    rng = np.random.default_rng(5)
    n, V = 50_001, 3
    keys = torch.from_numpy(np.sort(rng.integers(0, 900, n + 1)).astype(np.int32)).to(cuda)[1:]
    vals = torch.from_numpy(rng.integers(-1, 2, (n + 1, V)).astype(np.float32)).to(cuda)[1:]
    assert keys.data_ptr() % 16 and vals.data_ptr() % 16
    before = sr.segment_reduce.launches
    gs, ge = sr.segment_reduce(keys, vals)
    torch.cuda.synchronize()
    assert sr.segment_reduce.launches == before + 1
    ps, pe = sr.segment_reduce_plain(keys, vals)
    assert torch.equal(ge, pe) and torch.equal(gs, ps)


def test_segment_reduce_kernel_lane_limit(cuda):
    """V up to the kernel's shared-memory limit runs; one lane more raises."""
    rng = np.random.default_rng(6)
    n = 20_000
    k = torch.from_numpy(np.sort(rng.integers(0, 500, n)).astype(np.int32)).to(cuda)
    v = torch.from_numpy(rng.integers(-1, 2, (n, sr.MAX_V)).astype(np.float32)).to(cuda)
    before = sr.segment_reduce.launches
    gs, ge = sr.segment_reduce(k, v)
    torch.cuda.synchronize()
    assert sr.segment_reduce.launches == before + 1
    ps, pe = sr.segment_reduce_plain(k, v)
    assert torch.equal(ge, pe) and torch.equal(gs, ps)
    with pytest.raises(ValueError):
        sr.segment_reduce(k, torch.zeros((n, sr.MAX_V + 1), device=cuda))
    assert sr.segment_reduce.launches == before + 1


def test_indb_ml_path_on_card(cuda):
    """The normal-equation batch, the factorized covariance under Alg. 1's
    Ragg choice and under the LMFAO policy, and the naive join, against
    float64 numpy; every kernel launch against its twin."""
    rng = np.random.default_rng(0)
    n_fact, n_dim = 200_000, 3000
    c = rng.normal(size=n_dim).astype(np.float32)
    s = np.sort(rng.integers(0, n_dim, n_fact)).astype(np.int32)
    i = rng.normal(size=n_fact).astype(np.float32)
    u = (0.8 * i - 0.5 * c[s] + 0.1 * rng.normal(size=n_fact)).astype(np.float32)
    S = from_numpy({"s": s, "i": i, "u": u}, sorted_on=("s",), device=cuda)
    R = from_numpy({"s": np.arange(n_dim, dtype=np.int32), "c": c}, sorted_on=("s",), device=cuda)
    db = {"S": S, "R": R}
    sigma, delta = collect_stats(db), AnalyticCostModel()
    f64 = np.float64
    cs = c[s].astype(f64)
    want = {"i_i": np.sum(i.astype(f64) ** 2), "i_c": np.sum(i * cs), "c_c": np.sum(cs * cs),
            "b_i": np.sum(i.astype(f64) * u), "b_c": np.sum(cs * u)}

    def close(got):
        for k, v in got.items():
            assert abs(float(v) - want[k]) <= 1e-3 * (abs(want[k]) + 1.0), (k, float(v), want[k])

    terms = O.covar_semiring_terms(with_b=True)
    plans = [P.fuse(compile_plan(prog, synthesize(prog, sigma, delta).choices), sigma=sigma) for _, prog in terms]
    sp = P.merge_shared_scans(plans, sigma=sigma)
    assert {rg.source: len(rg.branches) for rg in sp.regions} == {"S": 5, "R": 3}
    ragg = synthesize(O.covar_interleaved(), sigma, delta).choices["Ragg"]
    with recording(fp, "fused_pipeline") as fused, recording(ml, "merge_lookup") as merged, \
            recording(sr, "segment_reduce") as segs:
        outs = E.cached_shared_executable(sp, db, sigma=sigma)(db, [{}] * len(plans))
        modes = E.last_report().modes()
        close({name: out[name] for (name, _), out in zip(terms, outs)})
        close(E.covar_factorized(S, R, ragg_ds=ragg.ds, sorted_probes=ragg.hinted))
        close(E.covar_factorized(S, R, ragg_ds="st_sorted", sorted_probes=True))
        close(E.covar_naive(S, R))
    assert set(modes.values()) == {"kernel-resident"}, modes
    assert len(fused) == 8 and len(segs) == 2 and merged
    _fused_calls_match_plain(fused)
    for (keys, vals, qs), _, (gv, gf) in merged:
        pv, pf = ml.merge_lookup_plain(keys, vals, qs)
        assert torch.equal(gf, pf) and torch.equal(gv, pv)
    for (keys, vals), _, (gs, ge) in segs:
        ps, pe = sr.segment_reduce_plain(keys, vals)
        assert torch.equal(ge, pe)
        torch.testing.assert_close(gs, ps, rtol=RTOL, atol=ATOL)


def _decode_columns(rng, n):
    """Columns forced to each encoding and bit width: (name, array, kind)."""
    cols = []
    for b in (1, 2, 4, 8, 16):
        a = rng.integers(0, 1 << b, n).astype(np.int32)
        a[0] = (1 << b) - 1  # the column needs all b bits
        cols.append((f"bitpack{b}", a, "bitpack"))
    cols += [
        ("for", (rng.integers(0, 60000, n) - 123456).astype(np.int32), "for"),
        ("for_wide", ((1 << 30) + rng.integers(0, 3, n)).astype(np.int32), "for"),
        ("dict_i32", rng.choice(np.array([-9, 4, 77, 1 << 28], np.int32), n), "dict"),
        ("dict_f32", rng.choice(rng.standard_normal(300).astype(np.float32), n), "dict"),
        ("rle_i32", np.repeat(rng.integers(-5, 5, n // 7 + 1), 7)[:n].astype(np.int32), "rle"),
        ("rle_f32", np.repeat(rng.standard_normal(n // 300 + 1).astype(np.float32), 300)[:n], "rle"),
    ]
    return cols


@pytest.mark.parametrize("n", [1, 777, 4096, 65_536 - 5, 200_003])
def test_decode_kernel_matches_plain_on_every_kind(cuda, n):
    rng = np.random.default_rng(n)
    chunk_rows = max(65_536, -(-n // 1024) * 1024)
    for name, a, kind in _decode_columns(rng, n):
        enc = S.encode_column(a, block=1024, mode=kind)
        payload = {k: torch.from_numpy(np.array(v)).to(cuda) for k, v in enc.payload.items()}
        code = dk.column_code(enc)
        for rows in (n, chunk_rows):  # unpadded, and padded to the chunk
            before = dk.decode.launches
            got = dk.decode(code, payload, rows)
            torch.cuda.synchronize()
            assert dk.decode.launches == before + 1
            want = dk.decode_plain(code, payload, rows)
            assert got.dtype == want.dtype == torch.from_numpy(a).dtype, name
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (name, rows)
            np.testing.assert_array_equal(got[:n].cpu().numpy(), a)


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    enc = S.encode_column(np.arange(100, dtype=np.int32), mode="bitpack")
    payload = {"words": torch.from_numpy(enc.payload["words"]).to(cuda)}
    code = dk.column_code(enc)
    with pytest.raises(ValueError):
        dk.decode(code._replace(bits=3), payload, 100)
    with pytest.raises(ValueError):
        dk.decode(code, {"words": payload["words"][:-1]}, 100)
    with pytest.raises(ValueError):
        dk.decode(code, payload, 50)  # fewer output rows than encoded rows


def test_streamed_session_on_card(cuda):
    """lineitem streams in 4,096-row chunks through the decode kernel and
    the fused pipeline (its folds carrying ``init=`` and reading encoded
    columns as ``encoded=`` streams); results equal the resident session's
    and the numpy oracle; every decode launch is bitwise its twin and every
    fused launch within the tolerance of its twin."""
    db = tpch.generate(scale=0.01, seed=7, device=cuda).tables()
    sigma = collect_stats(db)
    budget = int(sum(4 * st.rows * len(st.columns) for rel, st in sigma.rels.items() if rel != "lineitem"))
    streamed = repro_torch.connect(db, device=cuda, memory_budget=budget, chunk_rows=4096)
    resident = repro_torch.connect(db, device=cuda)
    assert streamed.streamed == ("lineitem",)
    ct = streamed.db["lineitem"]
    assert ct.device.type == "cuda" and all(t.is_pinned() for p in ct._host[0].values() for t in p.values())
    for name, q in REGISTRY.items():
        with recording(dk, "decode") as decodes, recording(fp, "fused_pipeline") as fused:
            got = streamed.query(name)
        rep = streamed.report()
        _same_items(got, resident.query(name))
        _same_items(got, q.reference(db, **q.defaults))
        assert rep.chunks >= ct.n_chunks and rep.h2d_bytes > 0
        assert any(m.startswith("streamed") for m in rep.modes().values())
        kernel_chunks = sum(int(m.split(":")[1]) for m in rep.modes().values() if m.startswith("streamed-kernel:"))
        assert len(fused) >= kernel_chunks
        # encoded columns reach the card through the decode kernel or, in a
        # streamed-kernel fold, as the fused pipeline's encoded streams
        assert decodes or any(kw.get("encoded") for _, kw, _ in fused), name
        for args, _, out in decodes:
            assert torch.equal(out.view(torch.int32), dk.decode_plain(*args).view(torch.int32))
        _fused_calls_match_plain(fused)


# (B, H, Hkv, Tq, Tk, D, causal, window)
FLASH_CASES = {
    "llama_2048": (1, 24, 8, 2048, 2048, 128, True, 0),
    "mha": (1, 2, 2, 64, 64, 16, True, 0),
    "gqa": (2, 4, 2, 64, 64, 64, True, 0),
    "mqa_decode": (1, 4, 1, 32, 96, 16, True, 0),
    "cross": (1, 2, 2, 64, 64, 16, False, 0),
    "window": (1, 2, 1, 96, 96, 128, True, 40),
    "unaligned": (1, 1, 1, 50, 70, 16, True, 0),
    "masked_rows": (2, 4, 2, 100, 37, 64, True, 0),
    "tq_lt_tk": (1, 6, 3, 130, 515, 128, True, 0),
    # pixtral's layer (D = 160) at 2,048 and unaligned, GQA 4:1, non-causal, Tq < Tk
    "pixtral_2048": (1, 32, 8, 2048, 2048, 160, True, 0),
    "d160_unaligned": (1, 8, 2, 1000, 1000, 160, True, 0),
    "d160_cross": (2, 4, 1, 7, 1500, 160, False, 0),
    # whisper: the encoder (non-causal over 1,500 frames) and cross attention
    # of 448 decoder tokens and of one decode token over them
    "whisper_encoder": (1, 20, 20, 1500, 1500, 64, False, 0),
    "whisper_cross": (2, 20, 20, 448, 1500, 64, False, 0),
    "whisper_cross_decode": (4, 20, 20, 1, 1500, 64, False, 0),
}
# float32: the same products summed in another order; bfloat16: the outputs
# are rounded to bfloat16 (a step of 2^-8 just below 1), and a p that rounds
# the other way moves the weighted sum by about as much
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# bfloat16 rows that see more than 256 keys average down to outputs of about
# 0.05, where 1e-2 is loose: there each row's |kernel - twin| stays within
# 1e-2 of the twin's norm (one bf16 step is at most 2^-7 of a value; a
# 64-key tile dropped from a 2,048-key row moves it by 0.08 or more)
FLASH_LONG_ROW, FLASH_REL_TOL = 256, 1e-2


def _long_row_rel_err(got, want, Tk, causal, window):
    Tq = got.shape[2]
    row = torch.arange(Tq, device=got.device) + (Tk - Tq)
    hi = torch.clamp(row + 1, max=Tk) if causal else torch.full_like(row, Tk)
    lo = torch.clamp(row - window + 1, min=0) if window > 0 else torch.zeros_like(row)
    sel = (hi - lo) > FLASH_LONG_ROW
    w = want[:, :, sel].float()
    return float(((got[:, :, sel].float() - w).norm(dim=-1) / w.norm(dim=-1)).max()) if bool(sel.any()) else 0.0


def _flash_inputs(case, dtype, dev, seed=0):
    B, H, Hkv, Tq, Tk, D, causal, window = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Tq, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(dtype)
    return q, k, v, causal, window


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, causal, window = _flash_inputs(case, dtype, cuda)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == n + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert _long_row_rel_err(got, want, k.shape[2], causal, window) <= FLASH_REL_TOL
    if case == "masked_rows":
        assert not got[:, :, : q.shape[2] - k.shape[2]].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_flash_attention_kernel_reads_strided_heads(cuda, dtype):
    """Heads split off a [B, T, H·D] projection (no copy) give the result of
    contiguous inputs; the output is [B, Tq, H, D] memory seen as [B, H, Tq, D]."""
    B, T, H, Hkv, D = 2, 77, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((B, T, H * D), generator=g, device=cuda).to(dtype).view(B, T, H, D).transpose(1, 2)
    kv = torch.randn((B, T, 2 * Hkv * D), generator=g, device=cuda).to(dtype)
    k = kv[..., : Hkv * D].view(B, T, Hkv, D).transpose(1, 2)
    v = kv[..., Hkv * D:].view(B, T, Hkv, D).transpose(1, 2)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# the wgmma kernel (bfloat16, D = 64, 128 and 160): lengths on both sides of
# the 128-row tiles (and D = 160's 64-key tiles), Tq < Tk and Tq > Tk (rows
# that see no key) under causality, windows of 40 and 200 (smaller and larger
# than a tile), and non-causal
WGMMA_LENGTHS = (1, 127, 128, 129, 1000)
WGMMA_CASES = (
    [(Tq, Tk, True, 0) for Tq in WGMMA_LENGTHS for Tk in WGMMA_LENGTHS]
    + [(Tq, Tk, True, w) for w in (40, 200) for Tq, Tk in ((1000, 1000), (129, 1000), (1000, 129))]
    + [(127, 1000, False, 0), (1000, 129, False, 40)]
)


@pytest.mark.parametrize("D", [64, 128, 160])
@pytest.mark.parametrize("Tq,Tk,causal,window", WGMMA_CASES)
def test_flash_attention_wgmma_kernel_matches_plain(cuda, Tq, Tk, causal, window, D):
    g = torch.Generator(device=cuda).manual_seed(Tq * 31 + Tk + D + window)
    q, k, v = (torch.randn((1, h, T, D), generator=g, device=cuda).to(torch.bfloat16)
               for h, T in ((4, Tq), (2, Tk), (2, Tk)))
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == n + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _long_row_rel_err(got, want, Tk, causal, window) <= FLASH_REL_TOL
    if causal and Tq > Tk:  # rows at key positions < 0 see nothing
        assert not got[:, :, : Tq - Tk].any()


@pytest.mark.parametrize("D", [64, 128, 160])
def test_flash_attention_wgmma_kernel_reads_strided_heads(cuda, D):
    """Heads split off a [B, T, H·D] projection (no copy) give, bit for bit,
    the result of contiguous inputs, through the tensor maps' strides."""
    B, T, H, Hkv = 2, 300, 8, 2
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn((B, T, H * D), generator=g, device=cuda).to(torch.bfloat16).view(B, T, H, D).transpose(1, 2)
    kv = torch.randn((B, T, 2 * Hkv * D), generator=g, device=cuda).to(torch.bfloat16)
    k = kv[..., : Hkv * D].view(B, T, Hkv, D).transpose(1, 2)
    v = kv[..., Hkv * D:].view(B, T, Hkv, D).transpose(1, 2)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=100)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, window=100)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 2
    assert torch.equal(got, want)


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    for D in (32, 96, 192):
        q = torch.zeros((1, 2, 8, D), device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            fa.flash_attention(q, q, q)  # a head dim no kernel serves
    h = torch.zeros((1, 2, 8, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        fa.flash_attention(h, h, h)  # float16
    x = torch.zeros((1, 3, 8, 16), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x[:, :2], x[:, :2])  # 3 query heads over 2 KV heads
    y = torch.zeros((1, 2, 16, 8), device=cuda, dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError):
        fa.flash_attention(y, y, y)  # last dimension not contiguous


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_forward_on_card_launches_the_kernel_once_per_layer(cuda, act_dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = get_model_by_name("llama3.2-3b", reduced=True, device="cpu")
    cfg = dataclasses.replace(cpu.cfg, n_kv_heads=2, act_dtype=act_dtype)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator().manual_seed(1))
    want, _ = lm.forward(cfg, params, toks)
    dev_params = {"embed": {"table": params["embed"]["table"].to(cuda)},
                  "layers": [{b: {n: t.to(cuda) for n, t in d.items()} for b, d in lp.items()} for lp in params["layers"]],
                  "final_norm": {"scale": params["final_norm"]["scale"].to(cuda)}}
    fa.flash_attention.launches = 0
    got, _ = lm.forward(cfg, dev_params, toks.to(cuda))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == cfg.n_layers
    tol = 1e-4 if act_dtype == "float32" else 5e-2  # bf16: the CPU and the card round differently
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("n", [8192, 65536])
@pytest.mark.parametrize("e", [16, 128])
def test_moe_dispatch_on_card(cuda, n, e):
    """Sort dispatch equals scatter dispatch on the card exactly (and the
    CPU's ranks), on a draw and on one expert taking every token."""
    ids = torch.from_numpy(np.random.default_rng(n + e).integers(0, e, n))
    for eid in (ids, torch.full((n,), e - 1)):
        want = moe.positions_scatter(eid, e)
        for fn in (moe.positions_scatter, moe.positions_sort):
            assert torch.equal(fn(eid.to(cuda), e).cpu(), want)


def test_moe_zero_router_ties_on_card(cuda):
    """A zero router ties every expert: each token goes to expert 0 (top-1)
    or 0 and 1 (top-2) on the card too, and both dispatches drop the same
    tokens."""
    g = torch.Generator().manual_seed(0)
    p = moe.moe_init(g, 64, 128, 16, True, "cpu")
    p["router"].zero_()
    x = torch.randn((2, 300, 64), generator=g)
    for top_k in (1, 2):
        _, _, _, experts = moe.route({k: v.to(cuda) for k, v in p.items() if k == "router"},
                                     x.view(-1, 64).to(cuda), top_k)
        assert torch.equal(experts.cpu(), torch.arange(top_k).expand(600, top_k))
        dev_p = {k: (v.to(cuda) if torch.is_tensor(v) else {n: t.to(cuda) for n, t in v.items()}) for k, v in p.items()}
        want, want_aux = moe.moe_apply(p, x, n_experts=16, top_k=top_k, dispatch="scatter")
        for dispatch in ("sort", "scatter"):
            got, aux = moe.moe_apply(dev_p, x.to(cuda), n_experts=16, top_k=top_k, dispatch=dispatch)
            assert float(aux["drop_fraction"]) == pytest.approx(float(want_aux["drop_fraction"]), abs=1e-7)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_moe_forward_on_card(cuda, monkeypatch):
    """Reduced scout (float32) through the attention kernel, one launch a
    layer, against the CPU's forward: logits and aux.  (In bfloat16 the two
    devices may round two experts' logits apart and route a token
    differently.)"""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = get_model_by_name("llama4-scout-17b-a16e", reduced=True, device="cpu")
    cfg = dataclasses.replace(cpu.cfg, n_kv_heads=2)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator().manual_seed(1))
    want, want_aux = lm.forward(cfg, params, toks)
    dev_params = common.tree_map(lambda t: t.to(cuda), params)
    fa.flash_attention.launches = 0
    got, aux = lm.forward(cfg, dev_params, toks.to(cuda))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)


# (B, H, Hkv, T, D, window): GQA, MQA and a window on the dense route, and
# above 2,048 keys on the chunked one; pixtral's head dim 160
GRAD_CASES = [(2, 4, 2, 100, 16, 0), (1, 4, 1, 129, 64, 0), (1, 2, 2, 200, 128, 40), (1, 4, 2, 2100, 64, 0),
              (1, 8, 2, 300, 160, 0)]


@pytest.mark.parametrize("case", GRAD_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_gradient_on_card(cuda, case, dtype, monkeypatch):
    """The forward launches the kernel once; dq, dk, dv are the plain route's
    (``ref.attention_route``) on the same inputs, and within rounding of it
    in float32."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    B, H, Hkv, T, D, window = case
    g = torch.Generator(device=cuda).manual_seed(T)
    q, k, v = (torch.randn((B, h, T, D), generator=g, device=cuda).to(getattr(torch, dtype)).requires_grad_()
               for h in (H, Hkv, Hkv))
    d_out = torch.randn((B, H, T, D), generator=g, device=cuda).to(q.dtype)
    n = fa.flash_attention.launches
    out = fa.FlashAttentionFn.apply(q, k, v, True, window)
    assert fa.flash_attention.launches == n + 1
    got = torch.autograd.grad(out, (q, k, v), d_out)
    assert fa.flash_attention.launches == n + 1
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.attention_route(qf, kf, vf, causal=True, window=window), (qf, kf, vf),
                               d_out.float())
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == q.dtype and a.shape == b.shape and bool(torch.isfinite(a).all()), name
        cos = float(torch.nn.functional.cosine_similarity(a.float().flatten(), b.flatten(), dim=0))
        assert cos >= (0.999 if dtype == "bfloat16" else 1 - 1e-6), (name, cos)


def test_training_step_on_card_launches_twice_a_layer(cuda, tmp_path, monkeypatch):
    """A reduced llama trains on the card from the CPU's initial weights and
    stream: each step launches the kernel in the forward and again in each
    layer's remat recompute, and the losses follow the CPU's."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from repro_torch.data.lm_data import StreamConfig
    from repro_torch.models.common import tree_map
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.train_loop import TrainConfig, Trainer

    init = get_model_by_name("llama3.2-3b", reduced=True, device="cpu").init(torch.Generator().manual_seed(0))
    losses, launches = {}, {}
    for dev in ("cpu", "cuda"):
        m = get_model_by_name("llama3.2-3b", reduced=True, device=dev)
        t = Trainer(m, TrainConfig(steps=3, ckpt_dir=str(tmp_path / dev), ckpt_async=False, log_every=1000,
                                   opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)),
                    StreamConfig(vocab=m.cfg.vocab, global_batch=2, seq_len=40))
        t.params = tree_map(lambda p: p.to(dev, copy=True).requires_grad_(), init)
        t.opt_state = init_state(t.params, t.tcfg.opt)
        fa.flash_attention.launches = 0
        losses[dev] = [x["loss"] for x in t.run()]
        launches[dev] = fa.flash_attention.launches
    assert launches == {"cpu": 0, "cuda": 3 * 2 * m.cfg.n_layers}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _dict_case(shape, rng):
    """(keys to build, value rows, probes) at a small shape or TPC-H SF 0.01's
    (orderkeys of orders, lineitem's l_orderkey probes)."""
    if shape == "sf0.01":
        db = tpch.generate(scale=0.01, seed=7, device="cpu").tables()
        keys = db["orders"].col("orderkey").to(torch.int32).numpy()
        qs = db["lineitem"].col("orderkey").to(torch.int32).numpy()
        V = 1
    else:
        n, V = (700, 3) if shape == "small_v3" else (5000, 1)
        keys = rng.integers(0, 3 * n, n).astype(np.int32)
        qs = np.concatenate([rng.integers(0, 6 * n, 2 * n), [dbase.PAD, dbase.EMPTY]]).astype(np.int32)
    vals = rng.normal(size=(len(keys), V)).astype(np.float32)
    return keys, vals, qs


@pytest.mark.parametrize("shape", ["small_v1", "small_v3", "sf0.01"])
def test_dict_kernels_match_plain(cuda, shape):
    rng = np.random.default_rng(7)
    keys, vals, qs = _dict_case(shape, rng)
    k, v, q = (torch.from_numpy(a).to(cuda) for a in (keys, vals, qs))
    cap = dbase.default_capacity(len(np.unique(keys)))
    valid = torch.from_numpy(rng.random(len(keys)) < 0.9).to(cuda)
    counts = [f.launches for f in (hb.hash_build, hp.hash_probe, sl.sorted_lookup)]
    for mask in (None, valid):
        tk, tv = hb.hash_build(k, v, cap, ht_linear.MAX_PROBES, mask)
        pk, pv = hb.hash_build_plain(k, v, cap, ht_linear.MAX_PROBES, mask)
        torch.cuda.synchronize()
        _same_items(_dict_items(tk, tv), _dict_items(pk, pv))
        for table in ((tk, tv), (pk, pv)):  # the probe finds keys in either layout
            gv, gf = hp.hash_probe(*table, q)
            wv, wf = hp.hash_probe_plain(*table, q)
            assert torch.equal(gf, wf) and torch.equal(gv, wv)
    st = st_sorted.build(k, v, cap)
    gv, gf = sl.sorted_lookup(st.keys, st.vals, q)
    wv, wf = sl.sorted_lookup_plain(st.keys, st.vals, q)
    assert torch.equal(gf, wf) and torch.equal(gv, wv)
    # a sorted key array whose length is no power of two, and an empty batch
    odd = torch.cat([torch.sort(torch.unique(k)).values, torch.full((3,), dbase.PAD, dtype=torch.int32, device=cuda)])
    ov = torch.randn((odd.shape[0], v.shape[1]), device=cuda)
    assert torch.equal(sl.sorted_lookup(odd, ov, q)[0], sl.sorted_lookup_plain(odd, ov, q)[0])
    assert sl.sorted_lookup(odd, ov, q[:0])[0].shape == (0, v.shape[1])
    assert [f.launches for f in (hb.hash_build, hp.hash_probe, sl.sorted_lookup)] == [
        counts[0] + 2, counts[1] + 4, counts[2] + 2]
    # the families' routes on the card
    t = ht_linear.build(k, v, cap)
    assert t.max_t == ht_linear.MAX_PROBES - 1
    _same_items(_dict_items(t.keys, t.vals), _dict_items(*hb.hash_build_plain(k, v, cap, ht_linear.MAX_PROBES)))
    fv, ff = ht_linear.lookup(t, q, valid=q % 2 == 0)
    assert torch.equal(ff, hp.hash_probe_plain(t.keys, t.vals, q)[1] & (q % 2 == 0))
    assert hb.hash_build.launches == counts[0] + 3 and hp.hash_probe.launches == counts[1] + 5


def _sorted_edge(case, rng):
    """(sorted PAD-tailed keys [C], vals [C, 3], shuffled probes)."""
    if case == "sampled_s2":  # more keys than the sample holds: S = 2, a live count no multiple of it
        live, C = np.sort(rng.choice(10**7, 60_001, replace=False)), 1 << 17
    elif case == "sampled_s4":
        live, C = np.sort(rng.choice(10**7, 150_001, replace=False)), 1 << 18
    elif case == "sampled_s32":  # SF 1's stride: 1,500,000 live keys of 4,194,304
        live, C = np.sort(rng.choice(10**8, 1_500_000, replace=False)), 1 << 22
    elif case == "full_no_pad":  # no PAD tail, C = 2^16 + 3 (odd): S = 2 over every slot
        live, C = np.sort(rng.choice(10**7, (1 << 16) + 3, replace=False)), (1 << 16) + 3
    elif case == "dup_runs_sampled":  # runs of equal keys across bucket edges, S = 4
        live = np.sort(np.repeat(rng.choice(10**6, 3000, replace=False), rng.integers(1, 90, 3000)))[:130_000]
        C = 1 << 18
    elif case == "below_stride":
        live, C = np.sort(rng.choice(1000, 5, replace=False)), 7
    elif case == "dup_runs":  # on chip
        live, C = np.sort(np.repeat(rng.choice(10**5, 500, replace=False), rng.integers(1, 90, 500))), 40_000
        live = live[:39_000]
    else:  # odd C on chip, every key's neighbours, EMPTY and PAD
        live, C = np.sort(rng.choice(10**6, 9_999, replace=False)), 12_345
    keys = np.full(C, dbase.PAD, np.int32)
    keys[: len(live)] = live
    vals = rng.normal(size=(C, 3)).astype(np.float32)
    vals[len(live):] = 0.0
    L = len(live)
    qs = np.concatenate([keys[:L], keys[:L] - 1, keys[:L] + 1, rng.integers(-10, 10**7 + 10, 5000),
                         [dbase.PAD, dbase.EMPTY, keys[0] - 1, dbase.PAD - 1]]).astype(np.int32)
    rng.shuffle(qs)
    return keys, vals, qs


SORTED_EDGES = ["sampled_s2", "sampled_s4", "sampled_s32", "full_no_pad", "dup_runs_sampled",
                "below_stride", "dup_runs", "odd_c"]


@pytest.mark.parametrize("path", ["auto", "global", "staged"])
@pytest.mark.parametrize("case", SORTED_EDGES)
def test_sorted_lookup_kernel_edges(cuda, monkeypatch, case, path):
    """The kernel against its twins bit for bit on each path (the one
    ``search_path`` picks, the global search, and the staged search: the
    whole table on chip or sampled at S = 2, 4 and 32): every key and its
    neighbours, so every sampled key and bucket edge, an odd C, fewer keys
    than a stride, runs of equal keys, EMPTY/PAD probes; the sample launch
    counts."""
    rng = np.random.default_rng(SORTED_EDGES.index(case))
    keys, vals, qs = _sorted_edge(case, rng)
    k, v, q = (torch.from_numpy(a).to(cuda) for a in (keys, vals, qs))
    C = len(keys)
    assert (C > sl.SAMPLE_KEYS) == case.startswith(("sampled", "full", "dup_runs_sampled"))
    taken = sl.search_path(len(qs), C, torch.cuda.get_device_properties(cuda).multi_processor_count)
    if path != "auto":
        taken = path if path == "global" else "table" if C <= sl.SAMPLE_KEYS else "sampled"
        monkeypatch.setattr(sl, "search_path", lambda n, C, sms: taken)
    before = sl.sorted_lookup.launches
    gv, gf = sl.sorted_lookup(k, v, q)
    torch.cuda.synchronize()
    assert sl.sorted_lookup.launches == before + (2 if taken == "sampled" else 1)
    for stride in (None, 1):  # the searchsorted twin, the kernel's search
        pv, pf = sl.sorted_lookup_plain(k, v, q, stride=stride)
        assert torch.equal(gf, pf) and torch.equal(gv, pv)
    wv, wf = dbase.sorted_lookup(k, v, q)
    assert torch.equal(gf, wf) and torch.equal(gv, wv)
    # unaligned probes and table: one int32 off a 16-byte boundary
    ko = torch.cat([k[:1], k])[1:]
    qo = torch.cat([q[:1], q])[1:]
    gv, gf = sl.sorted_lookup(ko, v, qo)
    assert torch.equal(gf, wf) and torch.equal(gv, wv)


def test_dict_kernels_refuse_what_they_do_not_take(cuda):
    k = torch.arange(8, dtype=torch.int32, device=cuda)
    v = torch.ones((8, 1), device=cuda)
    with pytest.raises(ValueError):
        hb.hash_build(k, v, 100)  # capacity not a power of two
    with pytest.raises(TypeError):
        hb.hash_build(k.long(), v, 64)
    with pytest.raises(ValueError):
        hb.hash_build(k, v.cpu(), 64)
    tk, tv = hb.hash_build(k, v, 64)
    with pytest.raises(ValueError):
        hp.hash_probe(tk[:48], tv[:48], k)  # capacity not a power of two
    with pytest.raises(TypeError):
        hp.hash_probe(tk, tv.double(), k)
    with pytest.raises(ValueError):
        sl.sorted_lookup(k, v, k.cpu().cuda()[None])
    with pytest.raises(TypeError):
        sl.sorted_lookup(k, v, k.long())


def test_profile_cell_on_card_launches_the_dict_kernels(cuda):
    before = [f.launches for f in (hb.hash_build, hp.hash_probe, sl.sorted_lookup)]
    tab = profile(backends=("ht_linear", "st_sorted"), sizes=(256,), lookup_ratios=(1.0,), repeats=1, device=cuda)
    assert len(tab.rows) == 32 and all(r.seconds > 0 for r in tab.rows)
    after = [f.launches for f in (hb.hash_build, hp.hash_probe, sl.sorted_lookup)]
    assert all(a > b for a, b in zip(after, before)), (before, after)


# ---------------------------------------------------------------------------
# the fused pipeline's radix, init= and encoded= modes
# ---------------------------------------------------------------------------


def _mode_plan(kind, ds):
    """One fused region over S probing ``G`` (built over R by ``ds``):
    ``part_term`` groups by the probe key (a partitioned accumulator),
    ``groupby`` by another column, ``reduce`` folds scalars through an
    interleaved lookup of G."""
    def k(var, col):
        return L.FieldAccess(L.FieldAccess(L.Var(var), "key"), col)

    scan_r = P.Scan("%r", source="R", var="r")
    if kind == "reduce":
        return P.Plan((
            scan_r,
            P.GroupBy("G", source="%r", keyexpr=k("r", "a"), values=(("t", k("r", "m")),), choice=DictChoice(ds)),
            P.Scan("%s", source="S", var="s"),
            P.Reduce("Tot", source="%s", fields=(
                ("sw", L.BinOp("*", k("s", "w"), L.FieldAccess(L.Var("g"), "t"))), ("n", k("s", "w"))),
                lookup_sym="G", lookup_key=k("s", "a"), lookup_var="g"),
        ), "Tot")
    return P.Plan((
        scan_r,
        P.HashBuild("G", source="%r", keyexpr=k("r", "a"), choice=DictChoice(ds)),
        P.Scan("%s", source="S", var="s"),
        P.HashProbe("%p", source="%s", build="G", keyexpr=k("s", "a"), inner_var="g"),
        P.GroupBy("Agg", source="%p", keyexpr=k("s", "a") if kind == "part_term" else k("s", "b"),
                  values=(("x", L.BinOp("*", k("s", "w"), k("g", "m"))), ("c", L.Const(1.0, L.DOUBLE))),
                  choice=DictChoice("ht_linear")),
    ), "Agg")


@pytest.mark.parametrize("parts", [2, 32], ids=["l2", "staged"])
@pytest.mark.parametrize("kind", ["part_term", "groupby", "reduce"])
@pytest.mark.parametrize("ds", ["ht_linear", "st_sorted", "st_blocked"])
def test_fused_radix_kernel_matches_plain(cuda, ds, kind, parts):
    """A region radix-partitioned over a 131,072-slot dictionary: 2 blocks
    of 65,536+ slots read through L2, or 32 blocks of 4,096+ staged in
    shared memory; the launch against its twin, the result against the same
    region unpartitioned."""
    rng = np.random.default_rng(parts)
    nr, ns = 60_000, 200_000
    db = {
        "R": from_numpy({"a": np.arange(nr, dtype=np.int32), "m": rng.normal(size=nr).astype(np.float32)}, device=cuda),
        "S": from_numpy({"a": rng.integers(0, nr + 5000, ns).astype(np.int32),
                         "b": rng.integers(0, 50, ns).astype(np.int32),
                         "w": rng.normal(size=ns).astype(np.float32)}, device=cuda),
    }
    sigma = collect_stats(db)
    fused = P.fuse(_mode_plan(kind, ds), sigma=sigma)
    marked = P.Plan(tuple(
        dataclasses.replace(n, partitions=parts, part_sym="G") if isinstance(n, P.Pipeline) and n.source == "S" else n
        for n in fused.nodes), fused.result)
    flat = E.execute_plan(fused, db, sigma=sigma)
    before = dict(fp.fused_pipeline.mode_launches)
    with recording(fp, "fused_pipeline") as calls:
        got = E.execute_plan(marked, db, sigma=sigma)
    assert E.last_report().mode(fused.result) == "kernel-radix"
    assert fp.fused_pipeline.mode_launches["radix"] == before["radix"] + 1
    (args, kwargs, _), = calls
    assert kwargs["radix"].part_terminal == (kind == "part_term") == args[0].part_terminal
    staged, _ = fp.radix_staging(args[0], args[3])
    assert staged == (parts == 32)
    _fused_calls_match_plain(calls)
    if kind == "reduce":
        for name in flat:
            torch.testing.assert_close(got[name], flat[name], rtol=RTOL, atol=ATOL)
    else:
        _same_items(got.items_np(), flat.items_np())


def _enc_cases(rng, n):
    """An encoded-stream case per encoding and bit width: (name, array, kind)."""
    return _decode_columns(rng, n)


@pytest.mark.parametrize("n", [777, 65_536 - 5, 200_003])
def test_fused_encoded_and_init_kernel_matches_plain(cuda, n):
    """Every encoding and bit width read through ``encoded=``, one group a
    row (keys = row ids), so each value lane is the decoded row itself: the
    kernel's in-register reads equal the decode kernel's bit for bit.  The
    same rows then fold as two ``init=`` steps equal to one launch."""
    rng = np.random.default_rng(n)
    rows = max(65_536, -(-n // 1024) * 1024)  # the chunk's padded length
    ids = torch.arange(rows, dtype=torch.int32, device=cuda)
    live = ids < n
    cap = dbase.next_pow2(2 * rows)
    for name, a, kind in _enc_cases(rng, n):
        t = "f32" if a.dtype == np.float32 else "i32"
        prog = fp.Program(("i32", t), (), (), (), ("groupby", ("col", "i32", 0), (fp.cast(("col", t, 1), "f32"),)),
                          ("dict", "ht_linear", cap, 1, ()), enc=(False, True))
        enc = S.encode_column(a, block=1024, mode=kind)
        es = dk.encoded_stream(enc, {k: torch.from_numpy(np.array(v)).to(cuda) for k, v in enc.payload.items()})
        before = fp.fused_pipeline.mode_launches["encoded"]
        got = fp.fused_pipeline(prog, [ids, None], live, [], [], encoded={1: es})
        torch.cuda.synchronize()
        assert fp.fused_pipeline.mode_launches["encoded"] == before + 1
        want = fp.fused_pipeline_plain(prog, [ids, None], live, [], [], encoded={1: es})
        g, w = _dict_items(*got), _dict_items(*want)
        assert g.keys() == w.keys() == set(range(n)), name
        assert all(np.array_equal(g[k], w[k]) for k in w), name
        col = dk.decode(dk.column_code(enc), dk.stream_payload(es), rows)
        raw = fp.fused_pipeline(prog._replace(enc=()), [ids, col], live, [], [])
        assert all(np.array_equal(v, g[k]) for k, v in _dict_items(*raw).items()), name
        # two fold steps with a carried accumulator equal one launch
        half = rows // 2
        first = fp.fused_pipeline(prog, [ids, col], live & (ids < half), [], [])
        kept = tuple(x.clone() for x in first)
        both = fp.fused_pipeline(prog, [ids, col], live & (ids >= half), [], [], init=first)
        assert both[0].data_ptr() == first[0].data_ptr()  # folded in place
        carried = fp.fused_pipeline_plain(prog, [ids, col], live & (ids >= half), [], [], init=kept)
        _same_items(_dict_items(*both), _dict_items(*carried))
        _same_items(_dict_items(*both), g)


# ---------------------------------------------------------------------------
# the redesigned claim terminal: the hash build's paths, the fused dictionary
# terminal's warp aggregation and private tables
# ---------------------------------------------------------------------------


def _home(keys, cap):
    return dbase.hash1(torch.from_numpy(keys), cap).numpy()


def _hb_case(case, path, rng, sms):
    """(keys, vals, valid, capacity, max_probes) of one hash-build case; the
    edge case puts homes in the last three slots of the path's slices."""
    cap, V, mp, valid = {"large": 2**18}.get(case, 4096), 1, ht_linear.MAX_PROBES, None
    V = {"v3": 3, "v5": 5, "v8": 8}.get(case, 1)
    cand = rng.choice(10**8, size=2_000_000, replace=False).astype(np.int32)
    if case == "edges":
        S = hb.slice_slots(cap, V, sms)
        keys = np.repeat(cand[_home(cand, cap) % S >= S - min(3, S)][:1500], 3)
    elif case == "wrap":
        keys = np.repeat(cand[_home(cand, cap) >= cap - 4][:60], 5)
    elif case == "drops":  # 40 keys on one home slot, 16 probes: 16 keys kept whole
        mp = 16
        keys = np.repeat(cand[_home(cand, cap) == cap // 2 + 5][:40], 7)
    elif case == "one_key":
        keys = np.full(200_003, 77, np.int32)
    elif case == "n0":
        keys = np.zeros((0,), np.int32)
    elif case == "large":
        keys = rng.integers(0, 2**17, 400_000).astype(np.int32)
    else:  # masked, v1, v3, v5, v8: 8,192 rows a key on average into 1,000 keys
        keys = rng.integers(0, 1000, 2**19 if case in ("masked", "v1") else 2**17).astype(np.int32)
    keys = rng.permutation(keys)
    if case == "masked":
        valid = rng.random(len(keys)) < 0.5
    vals = rng.normal(size=(len(keys), V)).astype(np.float32)
    return keys, vals, valid, cap, mp


HB_CASES = ["edges", "wrap", "drops", "one_key", "masked", "v1", "v3", "v5", "v8", "n0", "large"]


@pytest.mark.parametrize("path,case", [(p, c) for p in hb.PATHS for c in HB_CASES if (p, c) != ("private", "large")])
def test_hash_build_paths_match_plain(cuda, monkeypatch, path, case):
    """Each hash-build path (forced) against the twin: equal key sets and sums
    within the tolerance, a dropped key dropped whole, the same count kept,
    the probe finding every kept key in the kernel's table."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    rng = np.random.default_rng(HB_CASES.index(case))
    keys, vals, valid, cap, mp = _hb_case(case, path, rng, sms)
    k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(vals).to(cuda)
    m = None if valid is None else torch.from_numpy(valid).to(cuda)
    monkeypatch.setattr(hb, "build_path", lambda n, C, V, s, l2: path)
    before = hb.hash_build.launches
    tk, tv = hb.hash_build(k, v, cap, mp, m)
    torch.cuda.synchronize()
    assert hb.hash_build.launches == before + (hb.LAUNCHES[path] if len(keys) else 0)
    got, want = _dict_items(tk, tv), _dict_items(*hb.hash_build_plain(k, v, cap, mp, m))
    if case == "drops":
        assert len(got) == len(want) == mp
        sums = {int(x): vals[keys == x].sum(0) for x in np.unique(keys)}
        for x, row in got.items():
            np.testing.assert_allclose(row, sums[x], rtol=RTOL, atol=ATOL)
    else:
        _same_items(got, want)
    if case == "n0":
        assert not got and (tk == dbase.EMPTY).all() and not tv.any()
        return
    qs = torch.from_numpy(np.unique(keys)).to(cuda)
    gv, gf = hp.hash_probe(tk, tv, qs, mp)
    wv, wf = hp.hash_probe_plain(tk, tv, qs, mp)
    assert torch.equal(gf, wf) and torch.equal(gv, wv)
    assert set(qs[gf].tolist()) == set(got)


def test_hash_build_rule_paths_on_card(cuda):
    """The rule's own pick, against the twin, with the probe over the
    kernel's table: SF 10's orderkeys (a table larger than L2:
    partitioned), SF 1's (global), 2^18 rows into 64 keys (private), 2^18
    into 2^15 keys (global)."""
    rng = np.random.default_rng(19)
    props = torch.cuda.get_device_properties(cuda)
    i = np.arange(15_000_000)
    sf10 = ((i // 8) * 32 + i % 8 + 1).astype(np.int32)
    shapes = [sf10, sf10[:1_500_000], rng.integers(1, 65, 2**18).astype(np.int32),
              rng.integers(1, 2**15 + 1, 2**18).astype(np.int32)]
    for keys, cap, want in zip(shapes, (2**25, 4_194_304, 256, 65_536), ("partitioned", "global", "private", "global")):
        assert hb.build_path(len(keys), cap, 1, props.multi_processor_count, props.L2_cache_size) == want
        k = torch.from_numpy(rng.permutation(keys)).to(cuda)
        v = torch.randn((len(keys), 1), device=cuda)
        tk, tv = hb.hash_build(k, v, cap, ht_linear.MAX_PROBES)
        pk, pv = hb.hash_build_plain(k, v, cap, ht_linear.MAX_PROBES)
        torch.cuda.synchronize()
        _same_tables((tk, tv), (pk, pv))
        q = torch.from_numpy(rng.integers(0, 2 * int(keys.max()), 100_000).astype(np.int32)).to(cuda)
        for table in ((tk, tv), (pk, pv)):
            gv, gf = hp.hash_probe(*table, q)
            wv, wf = hp.hash_probe_plain(*table, q)
            assert torch.equal(gf, wf) and torch.equal(gv, wv)
        assert torch.equal(hp.hash_probe(tk, tv, q)[1], hp.hash_probe(pk, pv, q)[1])


def _terminal_program(acc_ds, cap, ops):
    V = len(ops)
    return fp.Program(("i32",) + ("f32",) * V, (), (), (),
                      ("groupby", ("col", "i32", 0), tuple(("col", "f32", 1 + j) for j in range(V))),
                      ("dict", acc_ds, cap, V, ops))


# name: (accumulator family, capacity, lane ops, key layout)
TERMINALS = {
    "one_group": ("ht_linear", 256, ("sum", "min", "max"), 1),
    "two_groups": ("ht_linear", 256, ("sum", "sum", "min"), 2),
    "three_groups": ("ht_linear", 256, ("max", "sum"), 3),
    "four_groups": ("ht_linear", 256, ("sum",) * 5, 4),
    "twochoice_private": ("ht_twochoice", 2048, ("sum", "max"), 700),
    "twochoice_global": ("ht_twochoice", 2**17, ("sum", "min"), 30_000),
    "private_limit": ("ht_linear", 8192, ("sum",), 3000),  # 8,192 lanes: the last private size
    "past_private_limit": ("ht_linear", 4096, ("sum", "min", "max"), 1500),  # 12,288 lanes: device memory
    "sorted_runs": ("ht_linear", 2**20, ("sum", "max"), "runs"),  # lineitem's 1 to 7 rows a key, in order
}


@pytest.mark.parametrize("name", sorted(TERMINALS))
def test_fused_dict_terminal_matches_plain(cuda, name):
    """The warp-aggregated claim terminal, private (capacity x lanes <=
    8,192) or in device memory, against its twin: equal key sets, sums
    within the tolerance, min and max lanes exact; then the same rows folded
    as two ``init=`` steps equal one launch."""
    acc_ds, cap, ops, groups = TERMINALS[name]
    rng = np.random.default_rng(len(name))
    n = 200_003
    if groups == "runs":
        keys = np.repeat(np.arange(1, n, dtype=np.int32) * 4, rng.integers(1, 8, n - 1))[:n]
    else:
        keys = rng.integers(0, groups, n).astype(np.int32) * 7919 + 3
    cols = [torch.from_numpy(keys).to(cuda)] + [torch.randn(n, device=cuda) for _ in ops]
    live = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    prog = _terminal_program(acc_ds, cap, ops)
    assert (cap * len(ops) <= fp.PRIV_FLOATS) == (name in ("one_group", "two_groups", "three_groups", "four_groups",
                                                            "twochoice_private", "private_limit"))
    got = fp.fused_pipeline(prog, cols, live, [], [])
    want = fp.fused_pipeline_plain(prog, cols, live, [], [])
    torch.cuda.synchronize()
    g, w = _dict_items(*got), _dict_items(*want)
    _same_items(g, w)
    for j, op in enumerate(ops):
        if op != "sum":
            assert all(g[k][j] == w[k][j] for k in w), op
    half = live & (torch.arange(n, device=cuda) < n // 2)
    first = fp.fused_pipeline(prog, cols, half, [], [])
    both = fp.fused_pipeline(prog, cols, live & ~half, [], [], init=first)
    torch.cuda.synchronize()
    assert both[0].data_ptr() == first[0].data_ptr()
    _same_items(_dict_items(*both), w)


@pytest.mark.parametrize("ds", ["ht_linear", "st_sorted"])
def test_fused_radix_part_term_sorted_runs(cuda, ds):
    """A radix region whose terminal is keyed by the partition key (the
    ``[P, C]`` accumulator in device memory), its probe keys in sorted runs
    of 1 to 7 rows: each warp folds a run into one claim."""
    rng = np.random.default_rng(11)
    nr = 60_000
    a = np.repeat(np.arange(nr + 5000, dtype=np.int32), rng.integers(1, 8, nr + 5000))[:200_000]
    db = {
        "R": from_numpy({"a": np.arange(nr, dtype=np.int32), "m": rng.normal(size=nr).astype(np.float32)}, device=cuda),
        "S": from_numpy({"a": a, "b": rng.integers(0, 50, len(a)).astype(np.int32),
                         "w": rng.normal(size=len(a)).astype(np.float32)}, device=cuda),
    }
    sigma = collect_stats(db)
    fused = P.fuse(_mode_plan("part_term", ds), sigma=sigma)
    marked = P.Plan(tuple(
        dataclasses.replace(n, partitions=32, part_sym="G") if isinstance(n, P.Pipeline) and n.source == "S" else n
        for n in fused.nodes), fused.result)
    flat = E.execute_plan(fused, db, sigma=sigma)
    with recording(fp, "fused_pipeline") as calls:
        got = E.execute_plan(marked, db, sigma=sigma)
    assert E.last_report().mode(fused.result) == "kernel-radix"
    (args, kwargs, _), = calls
    assert args[0].part_terminal
    _fused_calls_match_plain(calls)
    _same_items(got.items_np(), flat.items_np())


# (capacity, V, max_probes, kind) of the hash-probe cases of
# tests/test_torch_probe_decode_redesign.py, on the card
PROBE_CASES = {
    "home_hits_v1": (4096, 1, 128, "home"),
    "home_hits_v3": (4096, 3, 128, "home"),
    "displaced_v1": (2048, 1, 128, "displaced"),
    "displaced_v3": (2048, 3, 128, "displaced"),
    "wrap_v1": (1024, 1, 128, "wrap"),
    "wrap_v3": (1024, 3, 128, "wrap"),
    "cut_at_max_probes": (2048, 1, 8, "cut"),
    "cut_at_max_probes_v3": (2048, 3, 8, "cut"),
    "misses_at_empty": (4096, 1, 128, "miss"),
    "mixed_v2": (8192, 2, 128, "mixed"),
    "mixed_v5": (8192, 5, 128, "mixed"),
    "mixed_v8": (8192, 8, 128, "mixed"),
    "mixed_v9": (8192, 9, 128, "mixed"),  # wider than the speculative rows: gathered after the keys
    "tiny_c2": (2, 1, 128, "mixed"),  # C < 4: one slot a load
}


def _probe_card_case(case, rng, dev):
    """(table keys [C], table vals [C, V], queries [100,003], max_probes):
    the plain twin's build of the case's keys, queries shuffled."""
    cap, V, mp, kind = PROBE_CASES[case]
    cand = rng.choice(10**7, size=400_000, replace=False).astype(np.int32)
    home = _home(cand, cap)
    if kind == "home":  # distinct homes
        _, first = np.unique(home, return_index=True)
        keys = cand[np.sort(first)][:1200]
    elif kind == "displaced":  # chains of 10 on 6 homes, two of them adjacent
        keys = np.concatenate([cand[home == s][:10] for s in (3, 400, 401, 900, 1500, 2040)])
    elif kind == "wrap":  # homes at C - 4 .. C - 1
        keys = cand[home >= cap - 4][:30]
    elif kind == "cut":  # 20 keys on one home, probed 8 slots deep
        keys = cand[home == cap // 2][:20]
    else:
        keys = cand[: max(cap // 3, 1)]
    vals = rng.normal(size=(len(keys), V)).astype(np.float32)
    tk, tv = hb.hash_build_plain(torch.from_numpy(keys).to(dev), torch.from_numpy(vals).to(dev), cap,
                                 ht_linear.MAX_PROBES)
    if kind == "miss":
        qs = rng.integers(10**7, 2 * 10**7, 100_003)
    else:
        qs = rng.choice(keys, 100_003)
        if kind == "mixed":
            qs[::3] = rng.integers(10**7, 2 * 10**7, len(qs[::3]))
    return tk, tv, torch.from_numpy(qs.astype(np.int32)).to(dev), mp


@pytest.mark.parametrize("path", ["plain", "hinted"])
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("order", ["shuffled", "sorted"])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_hash_probe_kernel_cases(cuda, monkeypatch, case, order, layout, path):
    """Every probe case, bit for bit against the twin, the table aligned and
    at a 4-byte offset, on each path ``probe_path`` can pick (forced)."""
    monkeypatch.setattr(hp, "probe_path", lambda C, V, l2_bytes: path)
    tk, tv, qs, mp = _probe_card_case(case, np.random.default_rng(len(case)), cuda)
    if order == "sorted":
        qs = torch.sort(qs).values
    if layout == "offset":
        bk = torch.empty((tk.shape[0] + 1,), dtype=torch.int32, device=cuda)
        bv = torch.empty((tk.shape[0] + 1, tv.shape[1]), device=cuda)
        bk[1:], bv[1:] = tk, tv
        tk, tv = bk[1:], bv[1:]
        assert tk.data_ptr() % 16 and tk.is_contiguous() and tv.is_contiguous()
    before = hp.hash_probe.launches
    for n in (qs.shape[0], 1, 31, 257):  # n no multiple of a warp or a block
        gv, gf = hp.hash_probe(tk, tv, qs[:n], mp)
        wv, wf = hp.hash_probe_plain(tk, tv, qs[:n], mp)
        torch.cuda.synchronize()
        assert torch.equal(gf, wf), (case, n)
        assert torch.equal(gv.view(torch.int32), wv.view(torch.int32)), (case, n)
    assert hp.hash_probe.launches == before + 4
    found = hp.hash_probe_plain(tk, tv, qs, mp)[1]
    kind = PROBE_CASES[case][3]
    if kind in ("home", "displaced", "wrap"):
        assert bool(found.all())
    if kind == "cut":
        assert 0 < int(found.sum()) < found.shape[0]
    if kind == "miss":
        assert not bool(found.any())
    assert hp.hash_probe(tk, tv, qs, 0)[1].sum() == 0  # no probe: every query misses


@pytest.mark.parametrize("n", [1_048_576 - 17, 231_168, 5])
def test_decode_kernel_at_the_chunk_shape(cuda, n):
    """Every kind and width at a 1,048,576-row chunk: 17 rows short of it,
    SF 10's short final chunk (231,168 rows) and a 5-row one, each padded to
    the chunk and unpadded, bit for bit against the twin."""
    rng = np.random.default_rng(n)
    for name, a, kind in _decode_columns(rng, n):
        enc = S.encode_column(a, block=1024, mode=kind)
        payload = {k: torch.from_numpy(np.array(v)).to(cuda) for k, v in enc.payload.items()}
        code = dk.column_code(enc)
        for rows in (n, 1_048_576):
            got = dk.decode(code, payload, rows)
            want = dk.decode_plain(code, payload, rows)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (name, rows)
            np.testing.assert_array_equal(got[:n].cpu().numpy(), a)


# -- the degradation ladder and the QueryServer on the card ------------------


@pytest.fixture(scope="module")
def ladder_db(cuda):
    db = tpch.generate(scale=0.01, seed=7, device=cuda).tables()
    return db, {name: q.reference(db, **q.defaults) for name, q in REGISTRY.items()}


@pytest.mark.parametrize("qname", sorted(REGISTRY))
def test_ladder_rungs_on_card(cuda, ladder_db, qname):
    """Each rung of the resident ladder on the card against the primary by
    the card's rule (keys and integer lanes exact, floats at the suite's
    tolerance) and against numpy."""
    from repro_torch import session as SESS

    db, refs = ladder_db
    s = repro_torch.connect(db, device=cuda, chunk_rows=16_384)
    primary = s.query(qname)
    _same_items(primary, refs[qname])
    shape = s.shape(qname)
    bound = shape.query.bind_defaults({})
    for mode in s._ladder_modes()[1:]:
        ex, mdb = s._mode_executable(shape, mode)
        got = SESS.result_items(ex(mdb, bound))
        assert SESS.degraded_equal(got, primary, cuda), mode
        _same_items(got, refs[qname])
    assert s._degraded_storage()[2] == ("lineitem",)
    # a fault that reaches the streamed rung, through the ladder
    from repro_torch.testing import faults

    with faults.injected("kernel-launch", mode="always", error="oom"):
        got = s.query(qname)
    assert s.report().degradation == "streamed" and s.fault_stats["degraded"] == 1
    _same_items(got, refs[qname])


def test_real_oom_is_served_by_a_lower_rung(cuda):
    """``repro_torch.testing.oom.oom_job`` at TPC-H SF 0.1 in a fresh process (its
    caching allocator holds only the job's memory): under a memory-fraction
    cap between the lighter lower rung's measured peak and the fused
    pass's, q3's fused pass fails with a real ``torch.cuda.OutOfMemoryError``,
    classified ``DeviceOOMError``, a lower rung serves the right result, and
    with the fraction restored the fused rung serves again."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.testing.oom import oom_job

    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        out = pool.submit(oom_job, 0.1, 7, 65_536, "q3").result()
    assert out["served"] in ("materialized", "streamed"), out["lines"]
    assert out["degraded"] >= 1 and out["faults"] >= 1


def test_query_server_on_card(cuda, ladder_db):
    from repro_torch.serve.query_server import QueryServer

    db, _ = ladder_db
    s = repro_torch.connect(db, device=cuda)
    reqs = [("q1", {"date": 0.5 + 0.05 * i}) for i in range(4)] + [("q3", {"date": 0.05})] * 2
    reqs += [("q5", {"region": i}) for i in range(4)] + [("q9", {})] * 2
    reqs += [("q18", {"threshold": 100.0 + 50.0 * i}) for i in range(4)]
    srv = QueryServer(s, max_batch=8, share_scans=True)
    srv.warm_up()
    for q, p in reqs:
        srv.submit(q, **p)
    done = srv.run_until_done()
    assert len(done) == 16 and all(r.ok for r in done)
    assert srv.stats()["shared_batches"] > 0
    for r in done:
        _same_items(r.result, s.query(r.qname, **r.params))


def test_budget_session_shrinks_from_its_own_chunks(cuda):
    # the shrunk rung reuses the primary's pinned chunks and holds no
    # decoded host copy of the caller's tables
    db = tpch.generate(scale=0.002, seed=7, device=cuda).tables()
    s = repro_torch.connect(db, device=cuda, memory_budget=10**6, chunk_rows=4096)
    shrunk, _, _ = s._degraded_storage()
    assert all(shrunk[r] is s.db[r] for r in shrunk if S.is_chunked(s.db[r]))
    assert not hasattr(s, "base_db")


# -- adaptive planning on the card --------------------------------------------


@pytest.mark.parametrize("qname", ["q1", "q3"])
def test_race_validates_by_the_card_rule(cuda, ladder_db, record_property, qname):
    """A race on the card validates every lane by ``degraded_equal``'s card
    rule and serves the numpy result.  Two runs of one Γ are held to that
    rule too; whether they are also bitwise equal is recorded, not
    asserted: the fused terminal folds float sums by atomics, so a bitwise
    check cannot be the card's validation."""
    from repro_torch.core import adapt as A

    db, refs = ladder_db
    s = repro_torch.connect(db, device=cuda, adapt=A.AdaptConfig(band=50.0, top_k=3, warmup=1, repeats=1))
    _same_items(s.query(qname), refs[qname])
    shape = s.shape(qname)
    rec = shape.planner.races[0]
    assert len(rec.lanes) >= 2 and all(ln.validated for ln in rec.lanes)
    run = shape.planner.executor_for(rec.lanes[0].candidate.choices)
    bound = shape.query.bind_defaults({})
    a, b = A.result_items(run(bound)), A.result_items(run(bound))
    assert A.degraded_equal(a, b, cuda)
    record_property("bitwise_equal_runs", A.bitwise_equal(a, b))
    print(f"{qname}: two runs of the model's Γ bitwise equal: {A.bitwise_equal(a, b)}")


# -- sharded execution on the card --------------------------------------------


@pytest.fixture(scope="module")
def shard_db(cuda):
    db = tpch.generate(scale=0.01, seed=7, device=cuda).tables()
    return db, {q: REGISTRY[q].reference(db, **REGISTRY[q].defaults) for q in ("q3", "q18")}


@pytest.mark.parametrize("qname", ["q3", "q18"])
def test_sharded_session_on_card(cuda, shard_db, qname):
    """``connect(db, shards=2)`` on the card: the result against the
    resident session's and numpy's, and every launch of the warm run (the
    shards' fused regions and builds, the shuffles' rebuilds, the probes)
    against its twin."""
    db, refs = shard_db
    want = repro_torch.connect(db, device=cuda).query(qname)
    s = repro_torch.connect(db, device=cuda, shards=2)
    assert all(d.type == "cuda" for d in s.mesh.devices)
    s.query(qname)  # cold: the regions build
    with recording(fp, "fused_pipeline") as fcalls, recording(hb, "hash_build") as bcalls, \
            recording(hp, "hash_probe") as pcalls, recording(sl, "sorted_lookup") as scalls:
        got = s.query(qname)
    rep = s.report()
    assert rep.shards == 2 and rep.degraded == 0 and rep.faults == 0
    _same_items(got, want)
    _same_items(got, refs[qname])
    assert len(fcalls) >= 2 and len(bcalls) >= 2, (len(fcalls), len(bcalls))
    _fused_calls_match_plain(fcalls)
    for args, _, out in bcalls:
        _same_tables(out, hb.hash_build_plain(*args))
    for calls, twin in ((pcalls, hp.hash_probe_plain), (scalls, sl.sorted_lookup_plain)):
        for args, _, out in calls:
            vals, found = twin(*args)
            assert torch.equal(out[1], found) and torch.equal(out[0], vals)


# (B, T, d_in, ds, carried): jamba's d_state, ragged time tiles and channel
# blocks, one step with a carried state, the smaller state sizes; the
# redesign's edges: the ring wrapping with a ragged tail (2·TILE + 5 steps),
# a width one channel past a block (BLOCK + 1), every d_state with B > 1,
# 64 steps at jamba's width
SCAN_CASES = [(1, 300, 384, 16, False), (2, 77, 200, 16, True), (1, 1, 130, 16, True), (3, 33, 64, 4, True),
              (1, 64, 129, 8, False), (2, 2 * ssk.TILE + 5, 200, 16, True), (2, 40, ssk.BLOCK + 1, 16, False),
              (2, 2 * ssk.TILE + 5, 1000, 4, False), (3, 50, 136, 8, True), (2, 19, 72, 16, False),
              (1, 64, 16384, 16, True)]


def _scan_inputs(case, dtype, cuda, seed=0):
    B, T, d_in, ds, carried = case
    g = torch.Generator().manual_seed(seed)
    xc = torch.randn((B, T, d_in), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((B, T, d_in), generator=g) - 2)
    proj = torch.randn((B, T, 2 * ds + 3), generator=g)  # B and C as strided slices of a projection
    A = -torch.exp(torch.log(torch.arange(1, ds + 1, dtype=torch.float32)).repeat(d_in, 1))
    h0 = torch.randn((B, d_in, ds), generator=g) if carried else None
    dev = [t.to(cuda) for t in (xc, dt, proj)]
    xc, dt, proj = (t.to(dtype) for t in dev)
    return xc, dt, proj[..., 3:3 + ds], proj[..., 3 + ds:], A.to(cuda).to(dtype), (
        None if h0 is None else h0.to(cuda))


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_kernel_matches_plain(cuda, case, dtype):
    args = _scan_inputs(case, dtype, cuda)
    ssk.selective_scan.launches = 0
    y, h = ssk.selective_scan(*args)
    torch.cuda.synchronize()
    assert ssk.selective_scan.launches == 1 and y.dtype == h.dtype == torch.float32
    want_y, want_h = ssk.selective_scan_plain(*args)
    # the same roundings to the streams' dtype: only float32 summation order differs
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


def test_selective_scan_kernel_refuses_what_it_does_not_take(cuda):
    xc, dt, Bt, Ct, A, _ = _scan_inputs((1, 8, 64, 16, False), torch.float32, cuda)
    with pytest.raises(ValueError, match="state size"):
        ssk.selective_scan(xc, dt, Bt[..., :5], Ct[..., :5], A[:, :5])
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        ssk.selective_scan(xc, dt.to(torch.bfloat16), Bt, Ct, A)
    with pytest.raises(ValueError, match="h0"):
        ssk.selective_scan(xc, dt, Bt, Ct, A, torch.zeros((1, 64, 16), device=cuda, dtype=torch.bfloat16))
    dy = torch.zeros((1, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="state size"):
        ssk.selective_scan_backward(xc, dt, Bt[..., :5], Ct[..., :5], A[:, :5], None, dy)
    with pytest.raises(ValueError, match="bfloat16 or all float32"):
        ssk.selective_scan_backward(xc, dt.to(torch.bfloat16), Bt, Ct, A, None, dy)
    with pytest.raises(ValueError, match="dy must be float32"):
        ssk.selective_scan_backward(xc, dt, Bt, Ct, A, None, dy.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dh_T"):
        ssk.selective_scan_backward(xc, dt, Bt, Ct, A, None, dy, torch.zeros((1, 64, 8), device=cuda))
    # the backward kernel is first-order: a second-order gradient is refused
    x = xc.clone().requires_grad_()
    y, _ = kops.selective_scan(x, dt, Bt, Ct, A)
    (first,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch.autograd.grad(first.sum(), x)


@pytest.mark.parametrize("case", SCAN_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_selective_scan_backward_kernel_matches_plain(cuda, case, dtype):
    """The backward kernel against its twin on the same inputs and output
    gradients (``dh_T`` where the case carries a state): one launch counted,
    two launches bitwise equal, each gradient in its input's dtype; float32
    within 1e-5 of the largest gradient (summation order), bf16 within one
    bf16 step (2^-7) of it where a sum in another order flips a rounding,
    cosine >= 0.9999 in both."""
    args = _scan_inputs(case, dtype, cuda, seed=1)
    g = torch.Generator(device=cuda).manual_seed(2)
    B, T, d_in, ds, carried = case
    dy = torch.randn((B, T, d_in), generator=g, device=cuda)
    dh_T = torch.randn((B, d_in, ds), generator=g, device=cuda) if carried else None
    ssk.selective_scan_backward.launches = 0
    got = ssk.selective_scan_backward(*args, dy, dh_T)
    again = ssk.selective_scan_backward(*args, dy, dh_T)
    torch.cuda.synchronize()
    assert ssk.selective_scan_backward.launches == 2
    want = ssk.selective_scan_backward_plain(*args, dy, dh_T)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    for name, a, b, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got, again, want):
        if w is None:
            assert a is None and b is None, name
            continue
        assert torch.equal(a, b), name
        assert a.dtype == w.dtype and a.shape == w.shape, name
        scale = float(w.float().abs().max())
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol * scale, msg=name)
        cos = float(torch.nn.functional.cosine_similarity(a.float().flatten(), w.float().flatten(), dim=0))
        assert cos >= 0.9999 or scale == 0.0, (name, cos)


def test_jamba_training_on_card_launches_the_scan_kernels(cuda, tmp_path, monkeypatch):
    """A reduced jamba (float32) trains 3 steps on the card from the CPU's
    initial weights and stream: each step launches the scan kernel once a
    Mamba sub-layer in the forward and once in its period's remat recompute,
    the backward kernel once a Mamba sub-layer, and the losses follow the
    CPU's."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    from repro_torch.data.lm_data import StreamConfig
    from repro_torch.models.common import tree_map
    from repro_torch.train.optimizer import OptConfig, init_state
    from repro_torch.train.train_loop import TrainConfig, Trainer

    arch = "jamba-1.5-large-398b"
    init = get_model_by_name(arch, reduced=True, device="cpu").init(torch.Generator().manual_seed(0))
    losses, launches = {}, {}
    for dev in ("cpu", "cuda"):
        m = get_model_by_name(arch, reduced=True, device=dev)
        t = Trainer(m, TrainConfig(steps=3, ckpt_dir=str(tmp_path / dev), ckpt_async=False, log_every=1000,
                                   opt=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3)),
                    StreamConfig(vocab=m.cfg.vocab, global_batch=2, seq_len=40))
        t.params = tree_map(lambda p: p.to(dev, copy=True).requires_grad_(), init)
        t.opt_state = init_state(t.params, t.tcfg.opt)
        ssk.selective_scan.launches = ssk.selective_scan_backward.launches = 0
        log = t.run()
        losses[dev] = [x["loss"] for x in log]
        assert all(np.isfinite(x["grad_norm"]) for x in log)
        launches[dev] = (ssk.selective_scan.launches, ssk.selective_scan_backward.launches)
    n_mamba = m.cfg.n_layers // m.cfg.attn_period * (m.cfg.attn_period - 1)
    assert launches == {"cpu": (0, 0), "cuda": (3 * 2 * n_mamba, 3 * n_mamba)}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-1.5-large-398b"])
def test_recurrent_forward_and_decode_on_card(cuda, arch, monkeypatch):
    """A reduced rwkv6 / jamba (float32) forward and 4 decode steps on the
    card against the CPU's; jamba's scan kernel launches once a Mamba
    sub-layer and its attention kernel once a period."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cpu = get_model_by_name(arch, reduced=True, device="cpu")
    cfg = dataclasses.replace(cpu.cfg, n_kv_heads=2) if arch.startswith("jamba") else cpu.cfg
    mod = jamba if arch.startswith("jamba") else rwkv6
    params = mod.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    want, _ = mod.forward(cfg, params, toks)
    dev_params = common.tree_map(lambda t: t.to(cuda), params)
    ssk.selective_scan.launches = fa.flash_attention.launches = 0
    got, _ = mod.forward(cfg, dev_params, toks.to(cuda))
    torch.cuda.synchronize()
    if arch.startswith("jamba"):
        n_periods = cfg.n_layers // cfg.attn_period
        assert ssk.selective_scan.launches == n_periods * (cfg.attn_period - 1)
        assert fa.flash_attention.launches == n_periods
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    tc = mod.init_cache(cfg, 2, 16, fill_len=0, device="cpu")
    dc = mod.init_cache(cfg, 2, 16, fill_len=0, device=cuda)
    for t in range(4):
        w, tc = mod.decode_step(cfg, params, tc, toks[:, t])
        g, dc = mod.decode_step(cfg, dev_params, dc, toks[:, t].to(cuda))
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


# (B, H, Hkv, Tq, Tk, D): whisper's cross attention (non-causal, Tq != Tk:
# decoder tokens and one decode token over the frames) and its encoder
# (non-causal, unaligned), pixtral's head dim over more keys
CROSS_GRAD_CASES = [(2, 4, 4, 48, 150, 64), (2, 4, 4, 1, 150, 64), (1, 4, 4, 300, 300, 64), (1, 4, 2, 33, 200, 160)]


@pytest.mark.parametrize("case", CROSS_GRAD_CASES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_noncausal_attention_gradient_on_card(cuda, case, dtype, monkeypatch):
    """``FlashAttentionFn`` non-causal and with Tq != Tk: one launch, and dq,
    dk, dv the plain route's within rounding of it in float32."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    B, H, Hkv, Tq, Tk, D = case
    g = torch.Generator(device=cuda).manual_seed(Tq + Tk + D)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((B, h, T, D), generator=g, device=cuda).to(dt).requires_grad_()
               for h, T in ((H, Tq), (Hkv, Tk), (Hkv, Tk)))
    d_out = torch.randn((B, H, Tq, D), generator=g, device=cuda).to(dt)
    n = fa.flash_attention.launches
    out = fa.FlashAttentionFn.apply(q, k, v, False, 0)
    got = torch.autograd.grad(out, (q, k, v), d_out)
    assert fa.flash_attention.launches == n + 1
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.attention_route(qf, kf, vf, causal=False, window=0), (qf, kf, vf), d_out.float())
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dt and a.shape == b.shape and bool(torch.isfinite(a).all()), name
        cos = float(torch.nn.functional.cosine_similarity(a.float().flatten(), b.flatten(), dim=0))
        assert cos >= (0.999 if dtype == "bfloat16" else 1 - 1e-6), (name, cos)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_encdec_and_vlm_forward_on_card(cuda, arch, act_dtype, monkeypatch):
    """A reduced whisper (encoder, decoder self and cross attention: one
    launch each a layer) and a reduced pixtral at head dim 160 with patches
    in front (one launch a layer) on the card against the CPU's; whisper's
    decode steps from a cache over ``encode(frames)`` launch the kernel once
    a layer a step (cross attention; self attention takes the plain
    ``kv_valid`` route)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    over = {"act_dtype": act_dtype} if arch.startswith("whisper") else {"act_dtype": act_dtype, "head_dim": 160,
                                                                         "n_kv_heads": 2}
    cpu = get_model_by_name(arch, reduced=True, device="cpu")
    cfg = dataclasses.replace(cpu.cfg, **over)
    mod = whisper if arch.startswith("whisper") else lm
    params = mod.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1))
    extra = torch.randn((2, cfg.enc_seq if arch.startswith("whisper") else cfg.vision_tokens, cfg.d_model),
                        generator=torch.Generator().manual_seed(2))
    kw = "frames" if arch.startswith("whisper") else "patches"
    want, _ = get_model(cfg, device="cpu").forward(params, toks, **{kw: extra})
    dev_params = common.tree_map(lambda t: t.to(cuda), params)
    fa.flash_attention.launches = 0
    got, _ = get_model(cfg, device=cuda).forward(dev_params, toks.to(cuda), **{kw: extra.to(cuda)})
    torch.cuda.synchronize()
    per_layer = (cfg.enc_layers + 2 * cfg.n_layers) if arch.startswith("whisper") else cfg.n_layers
    assert fa.flash_attention.launches == per_layer
    tol = 1e-4 if act_dtype == "float32" else 5e-2  # bf16: the CPU and the card round differently
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol, atol=tol)
    if arch.startswith("whisper") and act_dtype == "float32":
        tc = whisper.init_cache(cfg, 2, 16, fill_len=0, device="cpu")
        dc = whisper.init_cache(cfg, 2, 16, fill_len=0, device=cuda)
        tc["enc_out"] = whisper.encode(cfg, params, extra)
        dc["enc_out"] = whisper.encode(cfg, dev_params, extra.to(cuda))
        for t in range(4):
            fa.flash_attention.launches = 0
            w, tc = whisper.decode_step(cfg, params, tc, toks[:, t])
            g, dc = whisper.decode_step(cfg, dev_params, dc, toks[:, t].to(cuda))
            assert fa.flash_attention.launches == cfg.n_layers
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("top_k, shared", [(1, True), (2, False)])
def test_moe_apply_sharded_on_card(cuda, top_k, shared, monkeypatch):
    """The expert-parallel region on an 8-shard (data 2, model 4) mesh, every
    shard on the card: the output equals ``moe_apply`` run on each data
    half (the region sizes capacity per data shard), the region ran (no
    fallback), and its result equals the CPU's region."""
    from repro_torch.exec import distributed as D

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(top_k)
    p = moe.moe_init(g, 64, 128, 16, shared, "cpu")
    x = torch.randn((4, 300, 64), generator=g)
    kw = dict(n_experts=16, top_k=top_k, dispatch="scatter")
    dev_p = common.tree_map(lambda t: t.to(cuda), p)
    mesh = D.make_mesh({"data": 2, "model": 4})
    assert all(d.type == "cuda" for d in mesh.devices)
    regions = moe.moe_apply_sharded.regions
    got, aux = moe.moe_apply_sharded(dev_p, x.to(cuda), mesh=mesh, **kw)
    assert moe.moe_apply_sharded.regions == regions + 1
    want = torch.cat([moe.moe_apply(dev_p, h, **kw)[0] for h in x.to(cuda).split(2)])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    cpu_got, cpu_aux = moe.moe_apply_sharded(p, x, mesh=D.make_mesh({"data": 2, "model": 4}, device="cpu"), **kw)
    torch.testing.assert_close(got.cpu(), cpu_got, rtol=1e-4, atol=1e-4)
    for key in ("load_balance", "router_z", "drop_fraction"):
        assert float(aux[key]) == pytest.approx(float(cpu_aux[key]), rel=1e-5, abs=1e-6), key


def test_ring_allgather_matmul_on_card(cuda, monkeypatch):
    """The ring over 4 shards on the card equals the gathered product and
    ``X @ W`` (float32)."""
    from repro_torch.exec import distributed as D
    from repro_torch.sharding import overlap, partition

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(0)
    X, W = torch.randn((512, 96), generator=g).to(cuda), torch.randn((96, 80), generator=g).to(cuda)
    mesh = D.make_mesh({"tp": 4})
    xs = partition.shard(X, partition.NamedSharding(mesh, partition.P("tp", None)))
    ring = overlap.ring_allgather_matmul(xs, W, mesh, "tp")
    gathered = overlap.allgather_matmul_reference(xs, W, mesh, "tp")
    for r, a in zip(ring, gathered):
        assert r.device.type == "cuda"
        torch.testing.assert_close(r, a, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r, X @ W, rtol=1e-4, atol=1e-4)


def test_compressed_psum_on_card(cuda):
    """``compressed_psum`` over 4 shards on the card: within the int8 bound
    of the float sum (tests/test_distributed.py:109), carries bit for bit,
    and equal to the CPU's on the same trees."""
    from repro_torch.exec import distributed as D
    from repro_torch.train import optimizer as opt

    g = torch.Generator().manual_seed(0)
    grads = [{"w": torch.randn((64, 32), generator=g), "b": torch.randn((32,), generator=g)} for _ in range(4)]
    ef = [{k: torch.randn(v.shape, generator=g) * 1e-3 for k, v in t.items()} for t in grads]
    on = lambda trees: [{k: v.to(cuda) for k, v in t.items()} for t in trees]
    summed, carries = opt.compressed_psum(on(grads), on(ef), D.make_mesh({"data": 4}), "data")
    cpu_summed, cpu_carries = opt.compressed_psum(grads, ef, D.make_mesh({"data": 4}, device="cpu"), "data")
    for k in ("w", "b"):
        want = sum(t[k] for t in grads)
        assert float((summed[0][k].cpu() - want).abs().max() / want.abs().max()) < 0.05
        torch.testing.assert_close(summed[0][k].cpu(), cpu_summed[0][k], rtol=1e-6, atol=1e-6)
        for s in range(4):
            target = grads[s][k].to(cuda) + ef[s][k].to(cuda)
            assert torch.equal(carries[s][k], target - opt._dequantize(*opt._quantize(target)))
