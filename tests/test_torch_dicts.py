"""The port's dictionaries against the reference's, on the same numpy inputs.

Hashes must be bit-identical; builds, lookups and resident finds of every
family must agree with ``repro.dicts`` on adversarial key sets (duplicates,
misses, negative and sentinel-adjacent keys, capacity-edge loads), with
sum/min/max lanes.  Slot layouts may differ where claims race, so builds are
compared through ``items()``; resident finds probe ONE built dictionary
(``interop.dict_from_reference``) in both packages, so their slots match.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dicts import base as rbase
from repro.dicts import registry as rreg
from repro_torch.data.interop import dict_from_reference
from repro_torch.dicts import base as tbase
from repro_torch.dicts import registry as treg
from repro_torch.kernels import fused_pipeline as fp

FAMILIES = ("ht_linear", "ht_twochoice", "st_sorted", "st_blocked")
OPS = (None, ("sum", "max"), ("min", "max"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _adversarial(cap: int, seed: int):
    """Duplicate-heavy build set at the 2×-slack maximum distinct count,
    with negative and sentinel-adjacent keys; probes mix hits and misses."""
    rng = np.random.default_rng(seed)
    n_distinct = cap // 2
    uniq = np.concatenate([
        np.asarray([-(2**30), -7, 0, 1, 2**31 - 2], np.int32),
        rng.choice(2**30, size=n_distinct - 5, replace=False).astype(np.int32),
    ])
    ks = np.concatenate([uniq, rng.choice(uniq, size=3 * len(uniq))]).astype(np.int32)
    vs = rng.normal(size=(len(ks), 2)).astype(np.float32)
    misses = rng.integers(2**30, 2**31 - 2, size=len(uniq)).astype(np.int32)
    qs = np.concatenate([uniq, misses, np.asarray([-1, 2**31 - 2, -(2**31) + 1], np.int32)])
    return ks, vs, qs


def _small_range(seed: int):
    """The ``tests/test_dicts.py`` shape: few distinct keys, masked rows."""
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, 120, 400).astype(np.int32)
    vs = rng.normal(size=(400, 2)).astype(np.float32)
    qs = np.concatenate([np.arange(-3, 130, dtype=np.int32), np.asarray([5000], np.int32)])
    return ks, vs, qs


def _items(keys, vals, valid):
    keys, vals, valid = (np.asarray(a) for a in (keys, vals, valid))
    return {int(k): vals[i] for i, k in enumerate(keys) if valid[i]}


@pytest.mark.parametrize("cap", [256, 1024, 1 << 22])
def test_hashes_bit_identical(cap):
    rng = np.random.default_rng(1)
    keys = np.concatenate([
        rng.integers(-(2**31), 2**31 - 1, 5000, dtype=np.int64).astype(np.int32),
        np.asarray([-(2**31), -(2**31) + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int32),
    ])
    for rh, th in ((rbase.hash1, tbase.hash1), (rbase.hash2, tbase.hash2)):
        want = np.asarray(rh(jnp.asarray(keys), cap))
        got = th(_t(keys), cap).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ds", FAMILIES)
@pytest.mark.parametrize("case", ["adversarial", "small_range", "masked"])
@pytest.mark.parametrize("ops", OPS, ids=["sum", "sum_max", "min_max"])
def test_build_lookup_match_reference(ds, case, ops):
    if case == "adversarial":
        cap = 1024
        ks, vs, qs = _adversarial(cap, seed=2)
        valid = None
    else:
        cap = 512
        ks, vs, qs = _small_range(seed=3)
        valid = np.random.default_rng(4).random(len(ks)) < 0.4 if case == "masked" else None
    rmod, tmod = rreg.get(ds), treg.get(ds)
    rkw = {} if ops is None else {"ops": ops}
    rt = rmod.build(jnp.asarray(ks), jnp.asarray(vs), cap,
                    valid=None if valid is None else jnp.asarray(valid), **rkw)
    tt = tmod.build(_t(ks), _t(vs), cap, valid=None if valid is None else _t(valid), ops=ops)
    want = _items(*rmod.items(rt))
    got = _items(*tmod.items(tt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert int(tmod.size(tt)) == int(rmod.size(rt))
    rv, rf = rmod.lookup(rt, jnp.asarray(qs))
    tv, tf = tmod.lookup(tt, _t(qs))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rf))
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ds", FAMILIES)
def test_resident_find_matches_reference(ds):
    """Both packages probe the same built dictionary: positions and found
    flags are identical, and so are the gathered value rows."""
    cap = 1024
    ks, vs, qs = _adversarial(cap, seed=5)
    rmod, tmod = rreg.get(ds), treg.get(ds)
    rt = rmod.build(jnp.asarray(ks), jnp.asarray(vs), cap)
    tt = dict_from_reference(ds, rt, device="cpu")
    rslot, rfound = rmod.resident_find(rmod.resident_slabs(rt), jnp.asarray(qs), capacity=cap, max_probes=128)
    tslot, tfound = tmod.resident_find(tmod.resident_slabs(tt), _t(qs), capacity=cap, max_probes=128)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(rfound))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(rslot))
    ref_v, ref_f = rmod.lookup(rt, jnp.asarray(qs))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(ref_f))
    got = tbase.gather_rows(tt.vals, tslot, tfound).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_v))


@pytest.mark.parametrize("ds", FAMILIES)
def test_resident_probe_int_payload_exact(ds):
    """Integer payloads above 2^24 ride the int32 slab and come back exact
    through the fused pipeline's plain twin: the gathered int is the
    terminal's group key, so a float32 round-trip would move every value."""
    rng = np.random.default_rng(6)
    cap = 512
    uniq = np.unique(rng.integers(0, 10**6, 200)).astype(np.int32)
    big = (1 << 25) + 3
    tt = treg.get(ds).build(_t(uniq), torch.zeros((len(uniq), 1)), cap)
    tks, _, valid = treg.get(ds).items(tt)
    ivals = torch.where(valid[:, None], tks[:, None] + big, 0).to(torch.int32)
    prog = fp.Program(
        cols=("i32",), params=(), dicts=(fp.DictSpec(ds, 0, 1),),
        stages=(("probe", 0, ("col", "i32", 0)),),
        term=("groupby", ("gath", "i32", 0, "i", 0), (fp.const(1.0),)),
        out=("dict", "ht_linear", tbase.next_pow2(2 * len(uniq)), 1, ()),
    )
    bundle = fp.resident_bundle(ds, tt, torch.zeros((cap, 0)), ivals)
    tk, _ = fp.fused_pipeline(prog, [_t(uniq)], torch.ones(len(uniq), dtype=torch.bool), [bundle], [])
    got = sorted(int(k) for k in tk.numpy() if k != tbase.EMPTY)
    assert got == sorted(int(u) + big for u in uniq)


@pytest.mark.parametrize("ds", FAMILIES)
def test_update_add_matches_reference(ds):
    """A second batch merged into a built dictionary (sum lanes)."""
    ks, vs, _ = _small_range(seed=8)
    ks2, vs2, _ = _small_range(seed=9)
    rmod, tmod = rreg.get(ds), treg.get(ds)
    rt = rmod.update_add(rmod.build(jnp.asarray(ks), jnp.asarray(vs), 512), jnp.asarray(ks2), jnp.asarray(vs2))
    tt = tmod.update_add(tmod.build(_t(ks), _t(vs), 512), _t(ks2), _t(vs2))
    want = _items(*rmod.items(rt))
    got = _items(*tmod.items(tt))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
