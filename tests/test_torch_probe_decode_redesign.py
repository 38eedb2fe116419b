"""The redesigned hash probe and decode, on the CPU.

Their CUDA kernels (``csrc/hash_probe.cu``, ``csrc/decode.cu``) run only on
the card.  Here:

* the hash probe's twin against ``repro``'s Pallas kernel in interpret mode
  and ``repro.kernels.ref.hash_probe`` on home-slot hits, displaced keys,
  chains that wrap past C − 1, a chain cut at ``max_probes``, misses that
  stop at EMPTY, V = 1 and 3, sorted and shuffled queries, n no multiple
  of a block; and a transcription of the kernel's index map (the chain
  from the home slot; a warp's V-lane rows written as 32·V contiguous
  elements, element ``u·32 + lane`` in pass ``u``) against the twin;
* a transcription of the decode kernel's index map — four rows a thread,
  the word ``r >> log2(32 / bits)`` and the shift ``(r & (32 / bits − 1))
  · bits``, rows past ``n`` clamped, the 16-byte store only where all four
  rows are below ``out_rows``; RLE one tile staged at a time, a binary
  search for a thread's first row and a forward walk for the next three —
  bit for bit against ``repro``'s ``pallas_decode`` in interpret mode and
  ``EncodedColumn.decode()``, for every kind, bits 1/2/4/8/16, int32 and
  float32, and ``out_rows > n`` tails;
* the wrappers' new refusals (``hash_probe.check_launch``,
  ``decode.launch_args``).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dicts import base as rbase
from repro.dicts import registry as rregistry
from repro.kernels import decode as RDK
from repro.kernels import ref as rref
from repro.kernels.hash_probe import hash_probe as r_hash_probe

from repro_torch.data import storage as S
from repro_torch.kernels import decode as dk
from repro_torch.kernels import hash_probe as hp

EMPTY = rbase.EMPTY
THREADS = 256  # the kernels' block size
WARP = 32


def _home(keys, cap):
    return np.asarray(rbase.hash1(jnp.asarray(keys), cap))


def _keys_at(cap, pred, n, rng):
    """``n`` distinct keys whose home slot satisfies ``pred``."""
    cand = rng.choice(10**7, size=400_000, replace=False).astype(np.int32)
    keep = cand[pred(_home(cand, cap))][:n]
    assert len(keep) == n
    return keep


# (capacity, V, max_probes, kind)
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
    "mixed_v3": (8192, 3, 128, "mixed"),
}


def _probe_case(case, rng):
    """(table keys [C], table vals [C, V], queries, max_probes); the table
    is the reference's ``ht_linear`` build, queries n = 1,000 + 7 (no
    multiple of a warp or a block) in a shuffled order."""
    cap, V, mp, kind = PROBE_CASES[case]
    if kind == "home":  # distinct home slots: every key at its home
        cand = rng.choice(10**7, size=20_000, replace=False).astype(np.int32)
        _, first = np.unique(_home(cand, cap), return_index=True)
        keys = cand[np.sort(first)][:1200]
    elif kind == "displaced":  # 60 keys on 6 homes: chains of 10
        keys = np.concatenate([_keys_at(cap, lambda h, s=s: h == s, 10, rng) for s in (3, 400, 401, 900, 1500, 2040)])
    elif kind == "wrap":  # homes at C - 4 .. C - 1: chains run past C - 1 to slot 0 on
        keys = _keys_at(cap, lambda h: h >= cap - 4, 30, rng)
    elif kind == "cut":  # 20 keys on one home, probed 8 slots deep: 12 cut off
        keys = _keys_at(cap, lambda h: h == cap // 2, 20, rng)
    else:
        keys = rng.choice(10**6, size=cap // 3, replace=False).astype(np.int32)
    vals = rng.normal(size=(len(keys), V)).astype(np.float32)
    t = rregistry.get("ht_linear").build(jnp.asarray(keys), jnp.asarray(vals), cap)
    if kind == "miss":
        absent = np.setdiff1d(np.arange(1, 10**6, dtype=np.int32), keys)
        qs = rng.choice(absent, 1007)
    else:
        qs = rng.choice(keys, 1007)
        if kind == "mixed":
            qs[::3] = rng.integers(10**6, 2 * 10**6, len(qs[::3]))
    return np.asarray(t.keys), np.asarray(t.vals), qs.astype(np.int32), mp


def _resolve(keys, q, h, max_probes):
    """``resolve``: the chain from the home slot, one slot a load."""
    C = len(keys)
    for t in range(max_probes):
        s = (h + t) & (C - 1)
        if keys[s] == q:
            return s
        if keys[s] == EMPTY:
            return -1
    return -1


def _kernel_model(keys, vals, qs, max_probes):
    """The kernel's index map in numpy: each query's slot on its chain,
    then its value row; at V > 1 each warp writes its 32 value rows as 32·V
    contiguous elements, lane ``l`` of pass ``u`` element ``u·32 + l`` of
    row ``j // V``, lane ``j % V``, taking the row's slot by a shuffle."""
    C, V = vals.shape
    n = len(qs)
    h = _home(qs, C) if n else np.zeros((0,), np.int64)
    slot = np.array([_resolve(keys, qs[i], h[i], max_probes) for i in range(n)], np.int64)
    out = np.full((n * V,), np.nan, np.float32)
    for wbase in range(0, -(-n // THREADS) * THREADS, WARP):
        for u in range(V):
            for lane in range(WARP):
                j = u * WARP + lane
                r, c = divmod(j, V)
                if wbase + r < n:
                    s = slot[wbase + r]
                    out[wbase * V + j] = vals[s, c] if s >= 0 else 0.0
    return out.reshape(n, V), slot >= 0


@pytest.mark.parametrize("order", ["shuffled", "sorted"])
@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_twin_and_kernel_model_match_reference(case, order):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    keys, vals, qs, mp = _probe_case(case, rng)
    if order == "sorted":
        qs = np.sort(qs)
    gv, gf = hp.hash_probe_plain(*(torch.from_numpy(np.array(a)) for a in (keys, vals, qs)), mp)
    pv, pf = r_hash_probe(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs), max_probes=mp, interpret=True)
    rv, rf = rref.hash_probe(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(qs), mp)
    for v, f in ((pv, pf), (rv, rf), _kernel_model(keys, vals, qs, mp)):
        np.testing.assert_array_equal(gf.numpy(), np.asarray(f))
        np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(v).view(np.uint32))
    kind = PROBE_CASES[case][3]
    found = gf.numpy()
    if kind in ("home", "displaced", "wrap"):
        assert found.all()
    if kind == "home":  # every key at its home slot
        assert (keys[_home(qs, len(keys))] == qs).all()
    if kind == "wrap":  # some hit lies past C - 1, at the table's start
        slots = [int(np.nonzero(keys == q)[0][0]) for q in np.unique(qs)]
        assert min(slots) < 4
    if kind == "cut":
        assert 0 < found.sum() < len(qs)  # chains of 20, probed 8 deep
    if kind == "miss":
        assert not found.any() and (gv.numpy() == 0).all()


def test_probe_empty_batch_and_no_probes():
    keys, vals, qs, _ = _probe_case("mixed_v3", np.random.default_rng(1))
    gv, gf = hp.hash_probe_plain(*(torch.from_numpy(np.array(a)) for a in (keys, vals, qs[:0])))
    assert gv.shape == (0, 3) and gf.shape == (0,)
    gv, gf = hp.hash_probe_plain(*(torch.from_numpy(np.array(a)) for a in (keys, vals, qs)), 0)
    mv, mf = _kernel_model(keys, vals, qs, 0)
    assert not gf.any() and not mf.any() and (gv.numpy() == mv).all()


@pytest.mark.parametrize("C, V, want", [
    (4_194_304, 1, "hinted"),  # TPC-H SF 1's orders table: 33.5 MB
    (4_194_304, 3, "hinted"),
    (2**22, 1, "hinted"),  # the sweep's 2^21-key tables
    (2**21, 1, "hinted"),  # 16 MB
    (2**20, 1, "plain"),  # the sweep's 2^19-key tables: 8 MB, where the hints cost 4-6 %
    (2**18, 1, "plain"),
    (2048, 1, "plain"),
    (2**20, 2, "plain"),  # 12 MB: at a quarter of L2
    (2**20, 3, "hinted"),
])
def test_probe_path_hints_tables_over_a_quarter_of_l2(C, V, want):
    assert hp.probe_path(C, V, 50 * 2**20) == want  # an H100's L2


def test_probe_refusals():
    hp.check_launch(4096, 6_000_000)
    with pytest.raises(ValueError):
        hp.check_launch(4095, 10)  # capacity not a power of two
    with pytest.raises(ValueError):
        hp.check_launch(4096, 2**31)  # past the kernel's 32-bit indices


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _words_u32(payload):
    return np.asarray(payload["words"]).view(np.uint32)


def _packed_model(enc, out_rows):
    """The packed kernel's rows: four a thread, clamped to n - 1, the word
    and shift by 32-bit shifts; the vector store only where all four rows
    are below ``out_rows``, scalar stores for the rest."""
    bits, n = enc.meta["bits"], enc.n
    lv = (32 // bits).bit_length() - 1
    words = _words_u32(enc.payload)
    groups = -(-out_rows // 4)
    r0 = np.arange(groups, dtype=np.uint32) * 4
    codes = np.empty((groups, 4), np.uint32)
    if bits == 16:  # two words a step
        full = r0 + 3 < n
        w0, w1 = words[(r0[full] >> 1)], words[(r0[full] >> 1) + 1]
        codes[full] = np.stack([w0 & 0xFFFF, w0 >> 16, w1 & 0xFFFF, w1 >> 16], 1)
    else:
        full = np.zeros((groups,), bool)
    for k in range(4):
        r = np.minimum(r0 + k, n - 1).astype(np.uint32)
        rest = ~full
        codes[rest, k] = (words[r[rest] >> lv] >> ((r[rest] & ((1 << lv) - 1)) * bits)) & ((1 << bits) - 1)
    if enc.kind == "dict":
        dct = np.asarray(enc.payload["values"]).view(np.uint32)
        vals = dct[codes]
    else:
        vals = codes + np.uint32(np.int64(enc.meta.get("ref", 0)) & 0xFFFFFFFF)
    out = np.zeros((groups * 4,), np.uint32)
    vec = r0 + 3 < out_rows
    out.reshape(groups, 4)[vec] = vals[vec]
    for g in np.nonzero(~vec)[0]:
        for k in range(4):
            if r0[g] + k < out_rows:
                out[r0[g] + k] = vals[g, k]
    return out[:out_rows]


def _rle_model(enc, out_rows):
    """The RLE kernel's rows: one tile staged at a time (a tile past the
    encoded ones restages the last), each thread's first row found by a
    binary search over the staged ends, the next three by a forward walk."""
    values = np.asarray(enc.payload["values"]).view(np.uint32)
    ends = np.asarray(enc.payload["ends"])
    block, n = enc.block, enc.n
    nt, runs = ends.shape
    out = np.zeros((out_rows,), np.uint32)
    for t in range(-(-out_rows // block)):
        src = min(t, nt - 1)
        s_end, s_val = ends[src], values[src]
        base, src_base = t * block, src * block
        for o in range(0, block, 4):
            r0 = base + o
            if r0 >= out_rows:
                break
            off0 = min(r0, n - 1) - src_base
            lo = min(int(np.searchsorted(s_end, off0, side="right")), runs - 1)
            for k in range(4):
                off = min(r0 + k, n - 1) - src_base
                while lo < runs - 1 and s_end[lo] <= off:
                    lo += 1
                if r0 + k < out_rows:
                    out[r0 + k] = s_val[lo]
    return out


def _columns(rng, n):
    """(name, array, kind) forcing every kind and bit width, int32 and float32."""
    cols = []
    for b in (1, 2, 4, 8, 16):
        a = rng.integers(0, 1 << b, n).astype(np.int32)
        a[0] = (1 << b) - 1
        cols.append((f"bitpack{b}", a, "bitpack"))
    cols += [
        ("for4", (rng.integers(0, 16, n) - 123456).astype(np.int32), "for"),
        ("for16", (rng.integers(0, 60000, n) + (1 << 30)).astype(np.int32), "for"),
        ("dict_i32", rng.choice(np.array([-9, 4, 77, 1 << 28], np.int32), n), "dict"),
        ("dict_f32", rng.choice(rng.standard_normal(300).astype(np.float32), n), "dict"),
        ("rle_i32", np.repeat(rng.integers(-5, 5, n // 7 + 1), 7)[:n].astype(np.int32), "rle"),
        ("rle_f32", np.repeat(rng.standard_normal(n // 300 + 1).astype(np.float32), 300)[:n], "rle"),
        ("rle_runs_of_one", rng.integers(-1000, 1000, n).astype(np.int32), "rle"),
    ]
    return cols


@pytest.mark.parametrize("block", [1024, 256])
@pytest.mark.parametrize("n", [1, 5, 3001, 4096])
def test_decode_model_matches_pallas_and_host(n, block):
    rng = np.random.default_rng(n + block)
    for name, a, kind in _columns(rng, n):
        enc = S.encode_column(a, block=block, mode=kind)
        pal = np.asarray(RDK.pallas_decode(enc, {k: jnp.asarray(v) for k, v in enc.payload.items()},
                                           interpret=True)).view(np.uint32)
        host = enc.decode().view(np.uint32)
        np.testing.assert_array_equal(pal, host, err_msg=name)
        for out_rows in (n, n + 3, -(-n // block) * block + 2 * block + 1):
            got = (_rle_model if kind == "rle" else _packed_model)(enc, out_rows)
            np.testing.assert_array_equal(got[:n], host, err_msg=f"{name} out_rows={out_rows}")
            assert (got[n:] == host[-1]).all(), (name, out_rows)
            payload = {k: torch.from_numpy(np.array(v)) for k, v in enc.payload.items()}
            twin = dk.decode_plain(dk.column_code(enc), payload, out_rows).numpy().view(np.uint32)
            np.testing.assert_array_equal(got, twin, err_msg=name)


def test_decode_launch_args_and_refusals():
    a = np.repeat(np.arange(40, dtype=np.int32), 50)
    enc = S.encode_column(a, block=1024, mode="rle")
    payload = {k: torch.from_numpy(np.array(v)) for k, v in enc.payload.items()}
    code = dk.column_code(enc)
    _, _, ints = dk.launch_args(code, payload, 4096)
    assert ints == [dk.KINDS["rle"], 2000, 4096, 0, 0, 10, payload["values"].shape[1]]
    with pytest.raises(ValueError):
        dk.launch_args(code._replace(block=1000), payload, 4096)  # tiles no power of two
    with pytest.raises(ValueError):
        dk.launch_args(code._replace(block=16), payload, 4096)  # tiles shorter than a 1-bit word
    with pytest.raises(ValueError):
        dk.launch_args(code, payload, 2**31)  # past the kernel's 32-bit indices
    wide = {"values": torch.zeros((1, dk.MAX_RUNS + 1), dtype=torch.int32),
            "ends": torch.arange(1, dk.MAX_RUNS + 2, dtype=torch.int32)[None]}
    with pytest.raises(ValueError):
        dk.launch_args(dk.ColumnCode("rle", "int32", 5000, block=8192), wide, 8192)  # runs past the stage
    enc = S.encode_column(a, block=1024, mode="bitpack")
    bp = {"words": torch.from_numpy(enc.payload["words"])}
    _, _, ints = dk.launch_args(dk.column_code(enc), bp, 2000)
    assert ints == [dk.KINDS["bitpack"], 2000, 2000, 8, 0, 10, 0]
    with pytest.raises(ValueError):
        dk.launch_args(dk.column_code(enc)._replace(bits=3), bp, 2000)
