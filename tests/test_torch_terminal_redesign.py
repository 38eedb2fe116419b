"""The redesigned hash build and fused-pipeline terminal, on the CPU.

The hash build's kernels (``csrc/hash_build.cu``) run only on the card;
their plain models run here on request: ``hash_build_plain(...,
slice_slots=S)`` builds each slice of ``S`` slots alone and claims the keys
whose chain ran off a slice's end in an overflow pass, ``hash_build_plain(...,
blocks=B)`` claims in ``B`` private tables and flushes them by key.  Both
are held against the default twin (the reference's round loop), against
``repro``'s Pallas kernel in interpret mode, and, through
``repro.kernels.ref.hash_probe``, against the probe invariant every table
of the family keeps: each kept key lies on its chain from ``hash1(k)`` with
no EMPTY slot before it.  Cases: chains that cross a slice's edge, chains
that wrap at C − 1, drops past ``max_probes`` (a key kept or dropped
whole), every row one key, a row mask, V = 1 … 8 and no rows.

The claim terminal's warp fold (``claim_table.cuh``: ``warp_peers``,
``leads``, ``warp_fold``) is transcribed lane by lane and checked to fold
every group into its leader; the generated launcher and ``radix_staging``
size the private table with its keys.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dicts import base as rbase
from repro.kernels import ref as rref
from repro.kernels.hash_build import hash_build as r_hash_build

from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import hash_build as hb

EMPTY = rbase.EMPTY
TOL = dict(rtol=3e-4, atol=3e-4)  # float32 sums of a few rows, added in other orders


def _t(a):
    return torch.from_numpy(np.array(a))


def _home(keys, cap):
    return np.asarray(rbase.hash1(jnp.asarray(keys), cap))


def _keys_at(cap, pred, n, rng):
    """``n`` distinct keys whose home slot satisfies ``pred``."""
    cand = rng.choice(10**7, size=400_000, replace=False).astype(np.int32)
    keep = cand[pred(_home(cand, cap))][:n]
    assert len(keep) == n
    return keep


# (capacity, V, max_probes, slice slots, kind)
CASES = {
    "slice_edges": (4096, 2, 128, 64, "edges"),  # homes in the last 3 slots of 64-slot slices
    "wrap": (1024, 1, 128, 256, "wrap"),  # homes at C - 4 .. C - 1: chains wrap to slot 0
    "drops": (2048, 3, 16, 256, "drops"),  # 40 keys on one home slot: 16 kept whole
    "drops_across_edge": (2048, 1, 16, 256, "drops_edge"),  # the same, home 6 slots before a slice's end
    "one_key": (256, 2, 128, 256, "one_key"),
    "masked": (2048, 4, 128, 512, "masked"),
    "v1": (2048, 1, 128, 512, "dups"),
    "v5": (1024, 5, 128, 256, "dups"),
    "v8": (1024, 8, 128, 128, "dups"),
    "no_rows": (512, 3, 128, 128, "empty"),
}


def _case(case, rng):
    cap, V, mp, S, kind = CASES[case]
    valid = None
    if kind == "edges":
        keys = _keys_at(cap, lambda h: h % S >= S - 3, 300, rng)
    elif kind == "wrap":
        keys = _keys_at(cap, lambda h: h >= cap - 4, 30, rng)
    elif kind in ("drops", "drops_edge"):
        home = cap // 2 + (S - 6 if kind == "drops_edge" else 5)
        keys = _keys_at(cap, lambda h: h == home, 40, rng)
    elif kind == "one_key":
        keys = np.asarray([123457], np.int32)
    elif kind == "empty":
        keys = np.zeros((0,), np.int32)
    else:
        keys = rng.integers(0, cap // 3, 2 * cap).astype(np.int32)
    if kind not in ("dups", "masked", "empty"):
        keys = np.repeat(keys, 1 if kind == "one_key" else 3)
        keys = np.concatenate([keys, np.full(997, keys[0], np.int32)]) if kind == "one_key" else keys
    keys = rng.permutation(keys)
    if kind == "masked":
        keys = rng.integers(0, cap // 3, 3 * cap).astype(np.int32)
        valid = rng.random(len(keys)) < 0.6
    vals = rng.normal(size=(len(keys), V)).astype(np.float32)
    return keys, vals, valid, cap, mp, S


def _items(tk, tv):
    tk, tv = np.asarray(tk), np.asarray(tv)
    return {int(k): tv[i] for i, k in enumerate(tk) if k != EMPTY}


def _sums(keys, vals, valid):
    exp = collections.defaultdict(lambda: np.zeros(vals.shape[1], np.float64))
    for i, (k, v) in enumerate(zip(keys, vals)):
        if valid is None or valid[i]:
            exp[int(k)] += v
    return exp


def _chains_unbroken(tk, cap):
    """Every key lies on its chain from its home slot with no EMPTY before it."""
    tk = np.asarray(tk)
    for s in np.flatnonzero(tk != EMPTY):
        h = int(_home(tk[s:s + 1], cap)[0])
        d = (s - h) % cap
        assert not (tk[(h + np.arange(d)) % cap] == EMPTY).any(), f"key {tk[s]} at {s}: an EMPTY slot on its chain"


def _builds(keys, vals, valid, cap, mp, S):
    """The twin and each model: ``{name: (keys, vals)}``."""
    args = (_t(keys), _t(vals), cap, mp, None if valid is None else _t(valid))
    return {
        "twin": hb.hash_build_plain(*args),
        f"slices of {S}": hb.hash_build_plain(*args, slice_slots=S),
        f"slices of {S // 2}": hb.hash_build_plain(*args, slice_slots=S // 2),
        "1 block": hb.hash_build_plain(*args, blocks=1),
        "3 blocks": hb.hash_build_plain(*args, blocks=3),
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_models_match_twin_and_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    keys, vals, valid, cap, mp, S = _case(case, rng)
    builds = _builds(keys, vals, valid, cap, mp, S)
    exp = _sums(keys, vals, valid)
    kept = keys if valid is None else keys[valid]
    kv = vals if valid is None else vals[valid]
    if len(kept):
        ref = r_hash_build(jnp.asarray(kept), jnp.asarray(kv), capacity=cap, max_probes=mp, block=1024, interpret=True)
        builds["repro"] = tuple(np.asarray(a) for a in ref)
    sizes = set()
    for name, (tk, tv) in builds.items():
        tk, tv = np.asarray(tk), np.asarray(tv)
        assert tk.shape == (cap,) and tv.shape == (cap, vals.shape[1]), name
        got = _items(tk, tv)
        sizes.add(len(got))
        assert set(got) <= set(exp), name
        for k, v in got.items():  # a kept key holds all its rows
            np.testing.assert_allclose(v, exp[k], **TOL, err_msg=f"{name}: key {k}")
        if not case.startswith("drops"):
            assert set(got) == set(exp), name
        _chains_unbroken(tk, cap)
        if got:  # the probe finds every kept key, and nothing else
            qs = np.asarray(list(exp) + [k + 1 for k in exp if k + 1 not in exp], np.int32)
            pv, pf = rref.hash_probe(jnp.asarray(tk), jnp.asarray(tv), jnp.asarray(qs), max_probes=mp)
            np.testing.assert_array_equal(np.asarray(pf), np.isin(qs, list(got)), err_msg=name)
            for q, v, f in zip(qs, np.asarray(pv), np.asarray(pf)):
                if f:
                    np.testing.assert_array_equal(v, got[int(q)], err_msg=name)
        if not len(kept):
            assert (tk == EMPTY).all() and not tv.any(), name
    if case.startswith("drops"):  # one home slot: the first max_probes keys claimed stay, whatever the order
        assert sizes == {mp}, sizes


def test_slice_model_overflows_at_edges_and_wraps():
    """The edge and wrap cases do run chains off a slice's end (the overflow
    pass places them), and the last slice's overflow wraps to slot 0."""
    rng = np.random.default_rng(sorted(CASES).index("slice_edges"))
    keys, vals, _, cap, mp, S = _case("slice_edges", rng)
    tk, _ = hb.hash_build_plain(_t(keys), _t(vals), cap, mp, slice_slots=S)
    tk = tk.numpy()
    at = np.flatnonzero(tk != EMPTY)
    home = _home(tk[at], cap)
    assert ((home // S) != (at // S)).sum() > 10  # keys stored in the next slice
    rng = np.random.default_rng(sorted(CASES).index("wrap"))
    keys, vals, _, cap, mp, S = _case("wrap", rng)
    tk, _ = hb.hash_build_plain(_t(keys), _t(vals), cap, mp, slice_slots=S)
    assert (tk.numpy()[:20] != EMPTY).any()


def test_build_models_reject_bad_shapes():
    k, v = _t(np.arange(8, dtype=np.int32)), _t(np.ones((8, 1), np.float32))
    with pytest.raises(ValueError):
        hb.hash_build_plain(k, v, 64, slice_slots=48)
    with pytest.raises(ValueError):
        hb.hash_build_plain(k, v, 64, slice_slots=128)
    with pytest.raises(ValueError):
        hb.hash_build_plain(k, v, 64, blocks=0)
    with pytest.raises(ValueError):
        hb.hash_build_plain(k, v, 64, slice_slots=16, blocks=2)


L2 = 50 * 2**20  # an H100's L2 cache


@pytest.mark.parametrize("n,cap,V,want", [
    (15_000_000, 2**25, 1, "partitioned"),  # TPC-H SF 10's orderkeys: a 268 MB table
    (1_500_000, 4_194_304, 1, "global"),  # SF 1's: 33.5 MB, claimed in L2
    (2**21, 2**22, 1, "global"),
    (2**22, 2**22, 3, "partitioned"),  # 67 MB
    (2**18, 2**16, 1, "global"),
    (2**17, 256, 1, "private"),  # 8,192 rows a key into 16 keys
    (2**18, 512, 1, "private"),
    (33_792, 256, 1, "private"),  # blocks of 512 rows for half the multiprocessors
    (33_791, 256, 1, "global"),
    (16_384, 256, 1, "global"),
    (2**18, 8192, 1, "global"),  # 16 blocks: the card would idle
    (2**22, 8192, 1, "private"),
    (2**22, 8192, 12, "global"),  # 8,192 · 13 · 4 B do not fit a block
    (5000, 2**26, 200, "global"),  # a slice of 256 slots does not fit
])
def test_build_path_rule(n, cap, V, want):
    assert hb.build_path(n, cap, V, 132, L2) == want


def test_slice_slots_fit_shared_memory_and_the_card():
    for cap, V in ((2**22, 1), (2**25, 3), (2**18, 1), (2**17, 8)):
        S = hb.slice_slots(cap, V, 132)
        assert S & (S - 1) == 0 and S * (1 + V) * 4 <= hb.SLICE_BYTES and cap // S >= 2 * 132


# ---------------------------------------------------------------------------
# the claim terminal
# ---------------------------------------------------------------------------


def _warp_fold(live, key, v, op):
    """``claim_table.cuh``'s warp_peers / warp_fold / leads, lane by lane."""
    live_lanes = sum(1 << i for i in range(32) if live[i])
    peers = []
    for i in range(32):
        same = sum(1 << j for j in range(32) if key[j] == key[i])
        peers.append(same & live_lanes if live[i] else 1 << i)
    v = list(v)
    rest = [p & ((0xFFFFFFFE << i) & 0xFFFFFFFF) for i, p in enumerate(peers)]
    rank = [bin(p & ((1 << i) - 1)).count("1") for i, p in enumerate(peers)]
    while any(rest):
        src = [(r & -r).bit_length() - 1 for r in rest]
        x = [v[s & 31] for s in src]
        v = [op(v[i], x[i]) if src[i] >= 0 else v[i] for i in range(32)]
        ballot = sum(1 << i for i in range(32) if rank[i] % 2 == 0)
        rest = [r & ballot for r in rest]
        rank = [r >> 1 for r in rank]
    leads = [p & ((1 << i) - 1) == 0 for i, p in enumerate(peers)]
    return v, leads


@pytest.mark.parametrize("pattern", ["distinct", "one_key", "four_groups", "runs", "random", "half_dead"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_warp_fold_gives_each_leader_its_group(pattern, op):
    rng = np.random.default_rng(7)
    key = {
        "distinct": list(range(32)), "one_key": [5] * 32, "four_groups": [i % 4 for i in range(32)],
        "runs": [i // 7 for i in range(32)], "random": list(rng.integers(0, 6, 32)),
        "half_dead": list(rng.integers(0, 3, 32)),
    }[pattern]
    live = [pattern != "half_dead" or i % 2 == 0 for i in range(32)]
    v = [float(x) for x in rng.integers(-50, 50, 32)]
    fn = {"sum": lambda a, b: a + b, "min": min, "max": max}[op]
    got, leads = _warp_fold(live, key, v, fn)
    groups = collections.defaultdict(list)
    for i in range(32):
        if live[i]:
            groups[key[i]].append(i)
    for lanes in groups.values():
        want = v[lanes[0]]
        for i in lanes[1:]:
            want = fn(want, v[i])
        assert leads[lanes[0]] and not any(leads[i] for i in lanes[1:])
        assert got[lanes[0]] == want
    assert all(leads[i] for i in range(32) if not live[i])  # a dead lane leads itself alone, and makes no claim


def _dict_program(cap, V, ops=()):
    return fp.Program(("i32", "f32"), (), (), (), ("groupby", ("col", "i32", 0), (("col", "f32", 1),) * V),
                      ("dict", "ht_linear", cap, V, ops))


def test_launcher_sizes_the_grid_to_resident_blocks():
    """A dictionary terminal launches the blocks resident at once at its
    shared memory (the private table's keys and lanes); the scalar Reduce
    keeps its fixed grid."""
    src = fp.emit_source(_dict_program(256, 5))
    assert "constexpr bool PRIV = true;" in src
    assert "(size_t)cap * (NV + 1) * sizeof(float)" in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fp_dict_kernel<0>, 256, priv)" in src
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)priv" in src
    big = fp.emit_source(_dict_program(1 << 20, 2))
    assert "constexpr bool PRIV = false;" in big and "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in big
    red = fp.emit_source(fp.Program(("f32",), (), (), (), ("reduce", -1, None, (("col", "f32", 0),)),
                                    ("sum", 1, ())))
    assert "want < 4224 ? want : 4224" in red and "cudaOccupancy" not in red


@pytest.mark.parametrize("cap,V,priv", [(256, 5, True), (8192, 1, True), (4096, 2, True), (8192, 2, False)])
def test_radix_staging_counts_the_private_keys(cap, V, priv):
    program = _dict_program(cap, V)._replace(dicts=(fp.DictSpec("ht_linear", 1, 0, True),))
    lp = 4096
    rd = fp.ResidentDict((torch.zeros((4, lp), dtype=torch.int32),), torch.zeros((4, lp, 1)),
                         torch.zeros((4, lp, 0), dtype=torch.int32), 4, lp)
    staged, nbytes = fp.radix_staging(program, [rd])
    assert staged
    assert nbytes == (cap * (V + 1) * 4 if priv else 0) + lp * 4
    assert (cap * V <= fp.PRIV_FLOATS) == priv
