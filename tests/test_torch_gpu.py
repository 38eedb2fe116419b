"""The CUDA kernels against their plain twins, at small shapes, on the card.

Marked ``gpu``: each test takes the ``cuda`` fixture, which skips where no
CUDA device exists (decided at run time, so every worker collects the same
tests).  On a machine with the card: ``python -m pytest -m gpu tests``.

The fused pipeline is generated per region, so the TPC-H regions run under
every dictionary choice set (each family's find and accumulator is its own
device code), and two scalar Reduce regions cover the block-reduction
kernel.  Every launch is held against its plain twin on the same inputs.
"""
import contextlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import llql as L
from repro_torch.core import operators as O
from repro_torch.core import plan as P
from repro_torch.core.cost import DictChoice
from repro_torch.core.lower import compile as compile_plan
from repro_torch.data import tpch
from repro_torch.data.table import collect_stats, from_numpy
from repro_torch.dicts import base as dbase
from repro_torch.exec import engine as E
from repro_torch.exec.queries import REGISTRY
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import merge_lookup as ml

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
    """Record every call of ``module.name`` as ``(args, out)``."""
    real, calls = getattr(module, name), []

    def record(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _dict_items(keys, vals):
    ks, vs = keys.cpu().numpy(), vals.cpu().numpy()
    return {int(k): v for k, v in zip(ks, vs) if k != dbase.EMPTY}


def _same_items(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)


def _fused_calls_match_plain(calls):
    for args, out in calls:
        want = fp.fused_pipeline_plain(*args)
        torch.cuda.synchronize()
        if args[0].out[0] == "sum":
            torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        else:
            _same_items(_dict_items(*out), _dict_items(*want))


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
        assert ml.merge_lookup.launches == before + 1
        pv, pf = ml.merge_lookup_plain(k, v, q)
        assert torch.equal(gf, pf)
        assert torch.equal(gv, pv)


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
        used = {d.ds for args, _ in fused for d in args[0].dicts}
        used |= {args[0].out[1] for args, _ in fused if args[0].out[0] == "dict"}
        assert choices in used, used
    _fused_calls_match_plain(fused)
    for (keys, vals, qs), (gv, gf) in merged:
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
    assert [args[0].out[0] for args, _ in fused] == ["sum"]
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
