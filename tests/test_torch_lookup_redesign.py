"""The twins of the two lookup kernels redesigned for the card, at small
tiles and strides, against the reference on the CPU.

* ``merge_lookup_plain(..., tile=)``, the model of the merge-lookup
  kernel (each tile's key range from its first probe and the next tile's,
  a cursor per thread), and its ``searchsorted`` default, against
  ``repro``'s Pallas ``merge_lookup`` in interpret mode and
  ``repro.kernels.ref``: dense probes, a tile whose range overflows the
  staging buffer, all probes on one key, EMPTY and PAD probes, and a probe
  at window offset 1 (against the oracle: the Pallas kernel misses it,
  ROADMAP.md §3); ``tile_ranges`` brackets every probe and tells the
  tiles whose range overflows a stage;
* ``sorted_lookup_plain(..., stride=)``, the model of the sorted-lookup
  kernel (a sample of every ``S``-th live key searched on chip, then one
  bucket), and its ``searchsorted`` default, against ``repro``'s Pallas ``sorted_lookup`` in interpret mode,
  ``repro.kernels.ref`` and ``dicts.base``'s loop: queries equal to sampled
  keys, runs of equal keys and the PAD tail across bucket edges, tables
  whose length is no multiple of the stride or below one stride, queries
  below the first key and equal to PAD and EMPTY, and tables larger than
  the sample, which the kernel samples (``stride=1``) at S = 2, 4 and 32;
  ``search_path``, which stages only where the probes pay for it;
* V in {1, 3, 5}, all bit for bit, on numpy inputs made from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.merge_lookup import merge_lookup as r_merge_lookup
from repro.kernels.sorted_lookup import sorted_lookup as r_sorted_lookup

from repro_torch.dicts import base as dbase
from repro_torch.kernels import merge_lookup as ml
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sorted_lookup as sl

PAD, EMPTY = dbase.PAD, dbase.EMPTY
WINDOW, BLOCK = 32, 64  # the Pallas kernels' window and query block, small for interpret mode


def _t(a):
    return torch.from_numpy(np.array(a))


def _pad_table(live, C, V, rng):
    """Sorted ``live`` keys, PAD-tailed to ``C``; value rows, zero on PAD."""
    keys = np.full(C, PAD, np.int32)
    keys[: len(live)] = live
    vals = rng.normal(size=(C, V)).astype(np.float32)
    vals[len(live):] = 0.0
    return keys, vals


# ---------------------------------------------------------------------------
# the merge lookup
# ---------------------------------------------------------------------------

MERGE_CASES = ["dense", "overflow", "one_key", "pad_empty", "window_offset_1"]


def _merge_case(case, V, rng):
    """(keys [C], vals [C, V], non-decreasing probes)."""
    # "overflow": a larger table, so that one 4,096-probe tile spans more keys than a stage holds
    C, span = (512 * WINDOW, 10**6) if case == "overflow" else (8 * WINDOW, 10_000)
    live = np.sort(rng.choice(span, C - 20, replace=False)).astype(np.int32)
    keys, vals = _pad_table(live, C, V, rng)
    if case == "dense":  # about 8 probes a key, hits and misses
        pos = rng.integers(0, C - 20, 1500)
        qs = keys[pos] + rng.integers(0, 2, 1500)
    elif case == "overflow":  # sparse probes over the whole table
        qs = rng.integers(-100, span + 100, 700)
    elif case == "one_key":
        qs = np.full(900, keys[100])
    elif case == "pad_empty":
        qs = np.concatenate([np.full(40, EMPTY), keys[rng.integers(0, C - 20, 300)], np.full(60, PAD), [PAD - 1]])
    else:  # the keys at window offset 1 of every window row, and their neighbours
        qs = np.concatenate([keys[1:C - 20:WINDOW], keys[2:C - 20:WINDOW], keys[0:C - 20:WINDOW]])
    return keys, vals, np.sort(qs).astype(np.int32)


@pytest.mark.parametrize("V", [1, 3, 5])
@pytest.mark.parametrize("case", MERGE_CASES)
def test_merge_twin_at_small_tiles_matches_reference(case, V):
    rng = np.random.default_rng(10 * V + MERGE_CASES.index(case))
    keys, vals, qs = _merge_case(case, V, rng)
    rv, rf = rref.merge_lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs))
    want_v, want_f = np.asarray(rv), np.asarray(rf)
    if case == "window_offset_1":
        assert want_f.all()
    else:
        # the Pallas kernel, on the probes its 12-round window search finds
        # (it misses the key at window offset 1, ROADMAP.md §3)
        keep = ~np.isin(qs, keys[1::WINDOW])
        kv, kf = r_merge_lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs[keep]),
                                block=BLOCK, window=WINDOW, interpret=True)
        np.testing.assert_array_equal(np.asarray(kf), want_f[keep])
        np.testing.assert_array_equal(np.asarray(kv), want_v[keep])
    K, Vv, Q = _t(keys), _t(vals), _t(qs)
    _, count = ml.tile_ranges(K, Q)
    if case == "overflow":
        assert bool((count > ml.STAGE).any())  # the tile searches its range in global memory
    if case in ("dense", "one_key"):
        assert bool((count <= ml.STAGE).all())
    for tile in (8, 16, 64, ml.TILE, None):
        gv, gf = ml.merge_lookup_plain(K, Vv, Q, tile=tile)
        np.testing.assert_array_equal(gf.numpy(), want_f)
        np.testing.assert_array_equal(gv.numpy(), want_v)
    for fn in (ml.merge_lookup, kops.merge_lookup, tref.merge_lookup):
        gv, gf = fn(K, Vv, Q)
        np.testing.assert_array_equal(gf.numpy(), want_f)
        np.testing.assert_array_equal(gv.numpy(), want_v)
    if case == "one_key":
        assert want_f.all()


@pytest.mark.parametrize("tile", [8, 16, 24, 4096])
def test_tile_ranges_bracket_every_probe(tile):
    rng = np.random.default_rng(tile)
    keys = torch.sort(_t(rng.integers(0, 5000, 3000).astype(np.int32))).values
    qs = torch.sort(_t(rng.integers(-10, 5100, 2500).astype(np.int32))).values
    start, count = ml.tile_ranges(keys, qs, tile)
    assert start.shape == (-(-2500 // tile),)
    lb = torch.clamp(torch.searchsorted(keys, qs), max=keys.shape[0] - 1)
    t_of = torch.arange(2500) // tile
    assert bool(((lb >= start[t_of]) & (lb < start[t_of] + count[t_of])).all())


def test_merge_twin_empty_and_tile_rule():
    keys, vals = _pad_table(np.arange(100, dtype=np.int32), 128, 2, np.random.default_rng(0))
    gv, gf = ml.merge_lookup_plain(_t(keys), _t(vals), _t(np.zeros(0, np.int32)))
    assert gv.shape == (0, 2) and gf.shape == (0,)
    with pytest.raises(ValueError):
        ml.merge_lookup_plain(_t(keys), _t(vals), _t(keys[:5]), tile=12)
    assert ml.TILE == ml.THREADS * ml.PER and ml.TILE % ml.PER == 0


# ---------------------------------------------------------------------------
# the sorted lookup
# ---------------------------------------------------------------------------

SORTED_CASES = ["sampled_keys", "dup_runs", "pad_edge", "not_multiple", "below_stride", "pad_empty"]


def _sorted_case(case, V, rng):
    """(sorted PAD-tailed keys [C], vals [C, V], probes in any order)."""
    if case == "below_stride":  # fewer keys than one stride of 32
        live, C = np.sort(rng.choice(200, 11, replace=False)), 13
    elif case == "not_multiple":  # C = 1,001 and 997 live keys: no multiple of 4, 7 or 32
        live, C = np.sort(rng.choice(5000, 997, replace=False)), 1001
    elif case == "dup_runs":  # runs of equal keys longer than a bucket, across its edges
        live, C = np.sort(np.repeat(rng.choice(300, 40, replace=False), rng.integers(1, 40, 40))), 2048
        live = live[:1900]
    elif case == "pad_edge":  # the PAD tail starts inside a bucket and runs over many edges
        live, C = np.sort(rng.choice(4000, 333, replace=False)), 1024
    else:
        live, C = np.sort(rng.choice(4000, 700, replace=False)), 1024
    keys, vals = _pad_table(live.astype(np.int32), C, V, rng)
    L = len(live)
    if case == "sampled_keys":  # every key at a multiple of 4, 7 or 32, and its neighbours
        at = np.unique(np.concatenate([np.arange(0, L, s) for s in (4, 7, 32)]))
        qs = np.concatenate([keys[at], keys[at] - 1, keys[at] + 1])
    elif case == "pad_empty":
        qs = np.concatenate([keys[rng.integers(0, L, 200)], [PAD, EMPTY, PAD - 1, EMPTY + 1, PAD, EMPTY]])
    else:  # hits, misses, below the first key and above the last
        qs = np.concatenate([keys[rng.integers(0, L, 300)], rng.integers(-50, 5100, 300),
                             [keys[0] - 1, keys[L - 1] + 1, PAD]])
    qs = qs.astype(np.int32)
    rng.shuffle(qs)
    return keys, vals, qs


@pytest.mark.parametrize("V", [1, 3, 5])
@pytest.mark.parametrize("case", SORTED_CASES)
def test_sorted_twin_at_small_strides_matches_reference(case, V):
    rng = np.random.default_rng(100 + 10 * V + SORTED_CASES.index(case))
    keys, vals, qs = _sorted_case(case, V, rng)
    rv, rf = rref.sorted_lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs))
    want_v, want_f = np.asarray(rv), np.asarray(rf)
    kv, kf = r_sorted_lookup(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs), block=BLOCK, interpret=True)
    np.testing.assert_array_equal(np.asarray(kf), want_f)
    np.testing.assert_array_equal(np.asarray(kv), want_v)
    K, Vv, Q = _t(keys), _t(vals), _t(qs)
    for stride in (None, 1, 4, 7, 32):
        gv, gf = sl.sorted_lookup_plain(K, Vv, Q, stride=stride)
        np.testing.assert_array_equal(gf.numpy(), want_f)
        np.testing.assert_array_equal(gv.numpy(), want_v)
    for fn in (sl.sorted_lookup, kops.sorted_lookup, tref.sorted_lookup, dbase.sorted_lookup):
        gv, gf = fn(K, Vv, Q)
        np.testing.assert_array_equal(gf.numpy(), want_f)
        np.testing.assert_array_equal(gv.numpy(), want_v)
    if case == "pad_empty":  # PAD probes find a PAD slot (a zero row); EMPTY ones miss
        assert want_f[qs == PAD].all() and not want_f[qs == EMPTY].any()


@pytest.mark.parametrize("n_live,C,S", [(60_000, 1 << 17, 2), (150_001, 1 << 18, 4), (800_000, 1 << 20, 32)])
def test_sorted_twin_samples_a_table_larger_than_the_sample(n_live, C, S):
    """Past :data:`SAMPLE_KEYS` keys the kernel samples: ``stride=1`` models
    its choice of S over the live keys, forced strides sample more sparsely;
    keys at sample positions and their neighbours, misses, PAD and EMPTY,
    equal to ``dicts.base``'s loop."""
    rng = np.random.default_rng(n_live)
    live = np.sort(rng.choice(10**7, n_live, replace=False)).astype(np.int32)
    keys, vals = _pad_table(live, C, 1, rng)
    at = np.arange(0, n_live, S)[:: max(1, n_live // S // 5000)]
    qs = np.concatenate([live[at], live[at] - 1, live[at] + 1, live[rng.integers(0, n_live, 10_000)],
                         rng.integers(-5, 10**7 + 5, 10_000), [PAD, EMPTY, live[-1] + 1]]).astype(np.int32)
    rng.shuffle(qs)
    assert sl.sample_stride(n_live) == S
    K, Vv, Q = _t(keys), _t(vals), _t(qs)
    wv, wf = dbase.sorted_lookup(K, Vv, Q)
    for stride in (None, 1, 3, 256):
        gv, gf = sl.sorted_lookup_plain(K, Vv, Q, stride=stride)
        assert torch.equal(gf, wf) and torch.equal(gv, wv)


def test_sorted_twin_rejects_a_stride_below_one():
    keys, vals = _pad_table(np.arange(10, dtype=np.int32), 16, 1, np.random.default_rng(0))
    with pytest.raises(ValueError):
        sl.sorted_lookup_plain(_t(keys), _t(vals), _t(keys[:3]), stride=0)


@pytest.mark.parametrize("n,C,want", [
    (6_000_000, 4_194_304, "sampled"),  # SF 1
    (6_000_000, 32_768, "table"),  # a small dictionary under SF 1's probes
    (4_096, 2_048, "global"), (65_536, 32_768, "global"), (262_144, 131_072, "global"),  # sweep 2^10, 2^14, 2^16
    (524_288, 262_144, "sampled"), (8_388_608, 4_194_304, "sampled"),  # sweep 2^17, 2^21
])
def test_search_path_stages_only_where_probes_pay(n, C, want):
    """The sorted lookup's path on a 132-SM card: staged where every
    block searches at least BLOCK probes and a sixteenth of the keys it
    stages, the global search elsewhere."""
    assert sl.search_path(n, C, 132) == want


@pytest.mark.parametrize("live,stride,want", [
    (0, 1, 1), (49_152, 1, 1), (49_153, 1, 2), (1_500_000, 1, 32), (2_097_152, 1, 64),
    (4_194_304, 1, 128), (100, 7, 7), (1_500_000, 64, 64),
])
def test_sample_stride_keeps_the_sample_on_chip(live, stride, want):
    S = sl.sample_stride(live, stride)
    assert S == want
    assert -(-live // S) <= sl.SAMPLE_KEYS
