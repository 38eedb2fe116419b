"""The port's dictionary kernels' plain twins against the reference, on the CPU.

* ``hash_probe``, ``sorted_lookup`` and ``hash_build`` (the twins the
  wrappers run on CPU tensors, and ``kernels.ops``/``kernels.ref``) against
  ``repro``'s Pallas kernels in interpret mode and ``repro.kernels.ref``, on
  the reference suite's shapes (``tests/test_kernels.py``) and on the edges:
  a V = 3 table, an all-miss batch, an empty batch, probe chains longer than
  32 slots, queries equal to PAD or EMPTY, a sorted table whose length is
  not a power of two, a row mask, and rows dropped past ``max_probes``;
* the families' routes through ``kernels.ops`` on the CPU compute what the
  plain loops of ``dicts.base`` compute, bit for bit and slot for slot, and
  launch no kernel.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dicts import base as rbase
from repro.dicts import registry as rregistry
from repro.kernels import ref as rref
from repro.kernels.hash_build import hash_build as r_hash_build
from repro.kernels.hash_probe import hash_probe as r_hash_probe
from repro.kernels.sorted_lookup import sorted_lookup as r_sorted_lookup

from repro_torch.dicts import base as tbase
from repro_torch.dicts import ht_linear, st_sorted
from repro_torch.kernels import hash_build as hb
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sorted_lookup as sl

EMPTY, PAD = rbase.EMPTY, rbase.PAD


def _t(a):
    return torch.from_numpy(np.array(a))


def _clustered_keys(cap, n, rng):
    """``n`` distinct keys whose first probe slot is one of the table's first
    four: their chains run far past 32 slots."""
    cand = rng.choice(10**7, size=200_000, replace=False).astype(np.int32)
    h = np.asarray(rbase.hash1(jnp.asarray(cand), cap))
    return cand[h < 4][:n]


def _probe_case(case, rng):
    """(table keys, table vals, queries) built by the reference's ht_linear."""
    if case in ("700x2048x1", "2000x8192x3", "64x1024x2"):
        n, cap, V = (int(x) for x in case.split("x"))
        keys = rng.integers(0, 3 * n, n).astype(np.int32)
        qs = rng.integers(0, 6 * n, max(n // 2, 8)).astype(np.int32)
    elif case == "low_occupancy":  # test_kernels.py:239
        n, cap, V = 1, 1024, 1
        keys = np.asarray([7], np.int32)
        qs = rng.integers(0, 10000, 600).astype(np.int32)
    elif case == "v3_all_miss":
        n, cap, V = 900, 2048, 3
        keys = rng.integers(0, 5000, n).astype(np.int32)
        qs = rng.integers(10_000, 20_000, 700).astype(np.int32)
    elif case == "long_chains":
        cap, V = 4096, 2
        keys = _clustered_keys(cap, 70, rng)
        n = len(keys)
        qs = np.concatenate([keys, keys + 1, np.asarray([EMPTY, PAD], np.int32)])
    else:  # empty batch
        n, cap, V = 300, 1024, 2
        keys = rng.integers(0, 900, n).astype(np.int32)
        qs = np.zeros((0,), np.int32)
    vals = rng.normal(size=(n, V)).astype(np.float32)
    t = rregistry.get("ht_linear").build(jnp.asarray(keys), jnp.asarray(vals), cap)
    return np.asarray(t.keys), np.asarray(t.vals), qs.astype(np.int32)


PROBE_CASES = ["700x2048x1", "2000x8192x3", "64x1024x2", "low_occupancy", "v3_all_miss", "long_chains", "empty_batch"]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_hash_probe_twin_matches_reference(case):
    rng = np.random.default_rng(PROBE_CASES.index(case))
    tk, tv, qs = _probe_case(case, rng)
    if case == "long_chains":
        h = np.asarray(rbase.hash1(jnp.asarray(qs[:70]), tk.shape[0]))
        pos = np.array([np.flatnonzero(tk == q)[0] for q in qs[:70]])
        assert ((pos - h) % tk.shape[0]).max() > 32  # chains past the build kernel's bound
    rv, rf = rref.hash_probe(jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(qs))
    want_v, want_f = np.asarray(rv), np.asarray(rf)
    if len(qs):
        kv, kf = r_hash_probe(jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(qs), block=256, interpret=True)
        np.testing.assert_array_equal(np.asarray(kf), want_f)
        np.testing.assert_array_equal(np.asarray(kv), want_v)
    for fn in (hp.hash_probe, hp.hash_probe_plain, kops.hash_probe, tref.hash_probe):
        gv, gf = fn(_t(tk), _t(tv), _t(qs))
        assert gv.shape == (len(qs), tv.shape[1]) and gv.dtype == torch.float32
        np.testing.assert_array_equal(gf.numpy(), want_f)
        np.testing.assert_array_equal(gv.numpy(), want_v)
    if case == "long_chains":
        assert want_f[:70].all() and not want_f[70:140].any()
    if case == "v3_all_miss":
        assert not want_f.any() and not want_v.any()


def _sorted_case(case, rng):
    """(sorted PAD-tailed keys, vals, queries)."""
    if case in ("500x2048", "3000x4096"):  # test_kernels.py:30
        n, cap = (int(x) for x in case.split("x"))
        keys = np.unique(rng.integers(0, 5 * n, n)).astype(np.int32)
        V = 2
        qs = rng.integers(0, 10 * n, 900).astype(np.int32)
    elif case == "v3_pad_empty":
        keys = np.unique(rng.integers(-5000, 5000, 1500)).astype(np.int32)
        cap, V = 2048, 3
        qs = np.concatenate([rng.integers(-6000, 6000, 800), [PAD, EMPTY, PAD - 1, EMPTY + 1]]).astype(np.int32)
    elif case == "not_pow2":
        keys = np.unique(rng.integers(0, 3000, 900)).astype(np.int32)
        cap, V = 1000, 1  # bit_length rounds over a length that is no power of two
        qs = np.concatenate([keys[::7], rng.integers(-10, 3100, 500)]).astype(np.int32)
    elif case == "all_miss":
        keys = (np.arange(700) * 2).astype(np.int32)
        cap, V = 1024, 2
        qs = (rng.integers(0, 700, 600) * 2 + 1).astype(np.int32)
    else:  # empty batch
        keys = np.arange(50, dtype=np.int32)
        cap, V = 64, 2
        qs = np.zeros((0,), np.int32)
    vals = rng.normal(size=(len(keys), V)).astype(np.float32)
    tk = np.full(cap, PAD, np.int32)
    tk[: len(keys)] = keys
    tv = np.zeros((cap, V), np.float32)
    tv[: len(keys)] = vals
    return tk, tv, qs


SORTED_CASES = ["500x2048", "3000x4096", "v3_pad_empty", "not_pow2", "all_miss", "empty_batch"]


@pytest.mark.parametrize("case", SORTED_CASES)
def test_sorted_lookup_twin_matches_reference(case):
    rng = np.random.default_rng(100 + SORTED_CASES.index(case))
    tk, tv, qs = _sorted_case(case, rng)
    if case in ("500x2048", "3000x4096"):  # the table as the reference's st_sorted builds it
        t = rregistry.get("st_sorted").build(jnp.asarray(tk[tk != PAD]), jnp.asarray(tv[tk != PAD]), tk.shape[0])
        np.testing.assert_array_equal(np.asarray(t.keys), tk)
    rv, rf = rref.sorted_lookup(jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(qs))
    want_v, want_f = np.asarray(rv), np.asarray(rf)
    if len(qs):
        kv, kf = r_sorted_lookup(jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(qs), block=256, interpret=True)
        np.testing.assert_array_equal(np.asarray(kf), want_f)
        np.testing.assert_array_equal(np.asarray(kv), want_v)
    for fn in (sl.sorted_lookup, sl.sorted_lookup_plain, kops.sorted_lookup, tref.sorted_lookup):
        gv, gf = fn(_t(tk), _t(tv), _t(qs))
        assert gv.shape == (len(qs), tv.shape[1])
        np.testing.assert_array_equal(gf.numpy(), want_f)
        np.testing.assert_array_equal(gv.numpy(), want_v)
    if case == "all_miss":
        assert not want_f.any()


def _sums(keys, vals, valid=None):
    exp = collections.defaultdict(lambda: np.zeros(vals.shape[1], np.float64))
    for i, (k, v) in enumerate(zip(keys, vals)):
        if valid is None or valid[i]:
            exp[int(k)] += v
    return exp


def _items(tk, tv):
    return {int(k): tv[i] for i, k in enumerate(tk) if k != EMPTY}


# (n, capacity, V, reference block, case)
BUILD_CASES = {
    "1500x2048_tiles": (1500, 2048, 2, 512, "dups"),  # test_kernels.py:114
    "300x1024_tiles": (300, 1024, 2, 128, "dups"),
    "v3_one_tile": (1000, 4096, 3, 1024, "dups"),
    "masked": (800, 2048, 1, 1024, "masked"),
    "drops_past_32": (0, 4096, 2, 1024, "clustered"),
    "empty": (0, 256, 2, 1024, "empty"),
}


@pytest.mark.parametrize("case", sorted(BUILD_CASES))
def test_hash_build_twin_matches_reference(case):
    n, cap, V, block, kind = BUILD_CASES[case]
    rng = np.random.default_rng(200 + sorted(BUILD_CASES).index(case))
    valid = None
    if kind == "clustered":
        keys = np.repeat(_clustered_keys(cap, 60, rng), 3)
        rng.shuffle(keys)
        n = len(keys)
    else:
        keys = rng.integers(0, max(n // 2, 1), n).astype(np.int32)
    if kind == "masked":
        valid = rng.random(n) < 0.6
    vals = rng.normal(size=(n, V)).astype(np.float32)
    got = [fn(_t(keys), _t(vals), cap, hb.MAX_PROBES, None if valid is None else _t(valid))
           for fn in (hb.hash_build, hb.hash_build_plain, tref.hash_build)]
    got.append(kops.hash_build(_t(keys), _t(vals), capacity=cap, valid=None if valid is None else _t(valid)))
    for gk, gv in got[1:]:  # one function: equal slot layouts
        assert torch.equal(gk, got[0][0]) and torch.equal(gv, got[0][1])
    gk, gv = got[0][0].numpy(), got[0][1].numpy()
    assert gk.shape == (cap,) and gv.shape == (cap, V)
    if kind == "empty":
        assert (gk == EMPTY).all() and not gv.any()
        return
    kept = keys if valid is None else keys[valid]
    kv = vals if valid is None else vals[valid]
    rk, rv = r_hash_build(jnp.asarray(kept), jnp.asarray(kv), capacity=cap, block=block, interpret=True)
    rk, rv = np.asarray(rk), np.asarray(rv)
    if valid is None and n <= block:
        # one reference tile runs generic_insert's rounds: equal slots and drops
        np.testing.assert_array_equal(gk, rk)
    got_items, ref_items = _items(gk, gv), _items(rk, rv)
    assert set(got_items) == set(ref_items)
    for k in ref_items:
        np.testing.assert_allclose(got_items[k], ref_items[k], rtol=3e-4, atol=3e-4)
    exp = _sums(keys, vals, valid)
    if kind == "clustered":  # rows of keys whose chain ends past 32 slots are dropped
        assert 0 < len(got_items) < len(exp)
    else:
        assert set(got_items) == set(exp)
    for k, v in got_items.items():
        np.testing.assert_allclose(v, exp[k], rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_family_routes_equal_the_plain_loops_on_cpu(seed):
    """``ht_linear.build``/``lookup`` and ``st_sorted.lookup`` route through
    ``kernels.ops``; on the CPU they compute what the plain loops do."""
    rng = np.random.default_rng(300 + seed)
    n, cap, V = 3000, 8192, 2
    ks = _t(rng.integers(0, 2500, n).astype(np.int32))
    vs = _t(rng.normal(size=(n, V)).astype(np.float32))
    valid = _t(rng.random(n) < 0.8)
    qs = _t(rng.integers(-100, 3000, 1700).astype(np.int32))
    qvalid = _t(rng.random(1700) < 0.7)
    probe = ht_linear._probe(cap)
    counts = [f.launches for f in (hp.hash_probe, sl.sorted_lookup, hb.hash_build)]
    for mask in (None, valid):
        t = ht_linear.build(ks, vs, cap, valid=mask)
        plain = tbase.generic_insert(ht_linear.empty(cap, V), ks, vs, probe, ht_linear.MAX_PROBES, valid=mask)
        assert torch.equal(t.keys, plain.keys) and torch.equal(t.vals, plain.vals)
        assert t.max_t == ht_linear.MAX_PROBES - 1
        for qmask in (None, qvalid):
            gv, gf = ht_linear.lookup(t, qs, valid=qmask)
            pv, pf = tbase.generic_lookup(plain, qs, probe, ht_linear.MAX_PROBES, valid=qmask)
            assert torch.equal(gf, pf) and torch.equal(gv, pv)
    # 1-D values and the min/max lanes, which keep the plain build
    t1 = ht_linear.build(ks, vs[:, 0], cap)
    assert torch.equal(t1.vals[:, 0], ht_linear.build(ks, vs[:, :1], cap).vals[:, 0])
    tm = ht_linear.build(ks, vs, cap, ops=("min", "max"))
    pm = tbase.generic_insert(ht_linear.empty(cap, V, ("min", "max")), ks, vs, probe, ht_linear.MAX_PROBES,
                              ops=("min", "max"))
    assert torch.equal(tm.keys, pm.keys) and tm.max_t == pm.max_t
    st = st_sorted.build(ks, vs, cap, valid=valid)
    for qmask in (None, qvalid):
        gv, gf = st_sorted.lookup(st, qs, valid=qmask)
        pv, pf = tbase.mask_rows(*tbase.sorted_lookup(st.keys, st.vals, qs), qmask)
        assert torch.equal(gf, pf) and torch.equal(gv, pv)
    # plain routes on CPU tensors launch nothing
    assert [f.launches for f in (hp.hash_probe, sl.sorted_lookup, hb.hash_build)] == counts
