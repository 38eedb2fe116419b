"""The port's in-DB ML path against ``repro.exec.engine`` and float64 numpy,
on the CPU: the sort-aggregate pipeline, the factorized covariance under
every Ragg family (hinted and not) and the naive join-then-aggregate
baseline, each over an S ordered on the join column and over a masked S
(the argsort path); then the normal-equation batch through shared scans,
with θ recovered."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.table import from_numpy as rfrom_numpy
from repro.exec import engine as RE

from repro_torch.core import operators as TO
from repro_torch.core import plan as TP
from repro_torch.core.cost import AnalyticCostModel
from repro_torch.core.lower import compile as tcompile
from repro_torch.core.synthesis import synthesize
from repro_torch.data.interop import from_reference
from repro_torch.data.table import collect_stats, from_numpy
from repro_torch.exec import engine as TE

RTOL, ATOL = 3e-3, 3e-2  # float32 sums folded in another order
FAMILIES = ("ht_linear", "ht_twochoice", "st_sorted", "st_blocked")


def _snowflake(n_fact: int, n_dim: int, seed: int):
    """The example's generator: S(s sorted, i, u), R(s, c), u = 0.8·i − 0.5·c[s] + noise."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n_dim).astype(np.float32)
    s = np.sort(rng.integers(0, n_dim, n_fact)).astype(np.int32)
    i = rng.normal(size=n_fact).astype(np.float32)
    u = (0.8 * i - 0.5 * c[s] + 0.1 * rng.normal(size=n_fact)).astype(np.float32)
    return {"s": s, "i": i, "u": u}, {"s": np.arange(n_dim, dtype=np.int32), "c": c}


def _dbs(masked: bool, seed: int = 5):
    S, R = _snowflake(3000, 90, seed)
    rdb = {"S": rfrom_numpy(S, sorted_on=("s",)), "R": rfrom_numpy(R, sorted_on=("s",))}
    if masked:
        keep = np.random.default_rng(seed + 1).random(3000) < 0.7
        rdb["S"] = rdb["S"].with_mask(jnp.asarray(keep))
    return rdb, from_reference(rdb, device="cpu")


def _same_terms(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dim() == 0 and got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["sorted", "masked"])
def test_sort_groupby_arrays_matches_reference(case):
    rng = np.random.default_rng(8)
    n = 2500
    keys = rng.integers(-20, 300, n).astype(np.int32)
    vals = rng.normal(size=(n, 3)).astype(np.float32)
    valid = None
    if case == "sorted":
        keys = np.sort(keys)
    else:
        valid = rng.random(n) < 0.6
    rk, rs, re = RE.sort_groupby_arrays(
        jnp.asarray(keys), jnp.asarray(vals),
        valid=None if valid is None else jnp.asarray(valid), assume_sorted=case == "sorted",
    )
    tk, ts, te = TE.sort_groupby_arrays(
        torch.from_numpy(keys), torch.from_numpy(vals),
        valid=None if valid is None else torch.from_numpy(valid), assume_sorted=case == "sorted",
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["sorted", "masked"])
@pytest.mark.parametrize("hinted", [False, True], ids=["plain", "hinted"])
@pytest.mark.parametrize("ds", FAMILIES)
def test_covar_factorized_matches_reference(ds, hinted, case):
    rdb, tdb = _dbs(masked=case == "masked")
    want = RE.covar_factorized(rdb["S"], rdb["R"], ragg_ds=ds, sorted_probes=hinted)
    got = TE.covar_factorized(tdb["S"], tdb["R"], ragg_ds=ds, sorted_probes=hinted)
    _same_terms(got, want)


@pytest.mark.parametrize("case", ["sorted", "masked"])
def test_covar_naive_matches_reference(case):
    rdb, tdb = _dbs(masked=case == "masked")
    want = RE.covar_naive(rdb["S"], rdb["R"])
    got = TE.covar_naive(tdb["S"], tdb["R"])
    _same_terms(got, want)
    _same_terms(TE.covar_factorized(tdb["S"], tdb["R"]), want)


def test_covar_semiring_batch_matches_numpy():
    """The normal-equation terms as one shared-scan batch (S×5, R×3), held
    against float64 numpy with the example's test, then θ recovered."""
    S, R = _snowflake(30_000, 700, seed=3)
    db = {"S": from_numpy(S, sorted_on=("s",), device="cpu"), "R": from_numpy(R, sorted_on=("s",), device="cpu")}
    sigma = collect_stats(db)
    terms = TO.covar_semiring_terms(with_b=True)
    plans = [
        TP.fuse(tcompile(prog, synthesize(prog, sigma, AnalyticCostModel()).choices), sigma=sigma)
        for _, prog in terms
    ]
    sp = TP.merge_shared_scans(plans, sigma=sigma)
    assert {rg.source: len(rg.branches) for rg in sp.regions} == {"S": 5, "R": 3}
    outs = TE.cached_shared_executable(sp, db, sigma=sigma)(db, [{}] * len(plans))
    got = {name: float(out[name]) for (name, _), out in zip(terms, outs)}
    f64 = np.float64
    i, u, cs = S["i"].astype(f64), S["u"].astype(f64), R["c"][S["s"]].astype(f64)
    want = {"i_i": np.sum(i * i), "i_c": np.sum(i * cs), "c_c": np.sum(cs * cs),
            "b_i": np.sum(i * u), "b_c": np.sum(cs * u)}
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3 * (abs(v) + 1.0), (k, got[k], v)
    theta = np.linalg.solve(
        np.array([[got["i_i"], got["i_c"]], [got["i_c"], got["c_c"]]]), np.array([got["b_i"], got["b_c"]])
    )
    assert abs(theta[0] - 0.8) < 0.05 and abs(theta[1] + 0.5) < 0.05
