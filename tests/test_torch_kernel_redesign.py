"""The rules and twins of the two Hopper kernels redesigned for the card,
against brute force and the reference, on the CPU.

* flash attention's tile classifier (skip, full, masked) and visited-tile
  range against brute-force masks over many shapes: Tq != Tk, windows
  smaller than a tile, rows that see no key; a skipped tile has no visible
  pair, a full tile no masked one, a masked tile of query rows at least
  one visible;
* ``flash_attention_plain`` at the wgmma kernel's 128 x 128 tiles (bfloat16,
  D = 64 and 128) against ``repro``'s Pallas kernel in interpret mode and
  its dense oracle, at shapes that cross 128-row tiles;
* ``segment_reduce_plain``, the vectorised model of the kernel's look-back
  over tiles, at small tiles against ``repro``'s Pallas kernel in interpret
  mode and ``repro.kernels.ref``: runs over many tiles, all keys equal, a
  PAD tail, n = tile - 1, tile, tile + 1, V in {1, 3, 5};
* the look-back's descriptor combine is associative, exactly on integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as r_flash_attention
from repro.kernels.segment_reduce import segment_reduce as r_segment_reduce

from repro_torch.dicts import base as dbase
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_reduce as sr

# ---------------------------------------------------------------------------
# flash attention: tile classes
# ---------------------------------------------------------------------------

# (Tq, Tk, causal, window, BQ, BK)
CLASS_CASES = {
    "square": (200, 200, True, 0, 128, 128),
    "tq_lt_tk": (127, 129, True, 0, 128, 128),
    "tq_gt_tk": (129, 127, True, 0, 128, 128),
    "long_keys": (64, 500, True, 0, 128, 128),
    "no_key_rows": (500, 64, True, 0, 128, 128),
    "window_40": (300, 300, True, 40, 128, 128),
    "window_200": (300, 300, True, 200, 128, 128),
    "window_1": (129, 129, True, 1, 128, 128),
    "window_tq_lt_tk": (100, 333, True, 40, 128, 128),
    "non_causal": (200, 200, False, 0, 128, 128),
    "non_causal_window": (200, 333, False, 40, 64, 128),
    "decode_row": (1, 1000, True, 0, 128, 128),
    "long_window": (1000, 1000, True, 200, 128, 128),
    "small_tiles": (37, 41, True, 5, 16, 8),
    "d16_tiles": (100, 37, True, 0, 64, 64),
}


@pytest.mark.parametrize("case", list(CLASS_CASES))
def test_tile_class_matches_brute_force(case):
    Tq, Tk, causal, window, BQ, BK = CLASS_CASES[case]
    q_off = Tk - Tq
    # the block's rows, then each consumer warpgroup's (the kernel classifies per warpgroup)
    spans = (BQ, fa.WARPGROUP_ROWS) if BQ > fa.WARPGROUP_ROWS else (BQ,)
    for rows in spans:
        for r0 in range(0, -(-Tq // BQ) * BQ, rows):
            row0 = r0 + q_off
            pos = np.arange(row0, row0 + rows)[:, None]
            visited = fa.visited_tiles(row0, rows, Tk, BK, causal, window)
            for j in range(-(-Tk // BK)):
                cols = np.arange(j * BK, (j + 1) * BK)[None, :]
                vis = (cols < Tk) & ((cols <= pos) | (not causal)) & ((cols > pos - window) | (window <= 0))
                cls = fa.tile_class(row0, rows, j * BK, BK, Tk, causal, window)
                what = f"rows {row0}..{row0 + rows - 1}, tile {j}: class {cls}"
                if cls == fa.SKIP:
                    assert not vis.any(), what
                elif cls == fa.FULL:
                    assert vis.all(), what
                else:  # tight where every row is a query row (padding rows sit past Tk)
                    assert cls == fa.MASKED and not vis.all() and (vis.any() or r0 + rows > Tq), what
                assert (j in visited) == (cls != fa.SKIP), what


def test_tiles_are_keyed_by_dtype_and_head_dim():
    for D in (64, 128):
        assert fa.TILES[(torch.bfloat16, D)] == (128, 128)
    assert fa.TILES[(torch.bfloat16, 16)] == (64, 64)
    assert all(fa.TILES[(torch.float32, D)] == (32, 16) for D in fa.HEAD_DIMS)


# ---------------------------------------------------------------------------
# flash attention: the twin at the wgmma kernel's tiles
# ---------------------------------------------------------------------------

# (B, H, Hkv, Tq, Tk, D, causal, window): shapes that cross 128-row tiles
FLASH_CASES = {
    "gqa_127_129_d128": (1, 4, 2, 127, 129, 128, True, 0),
    "gqa_129_127_d64": (1, 4, 2, 129, 127, 64, True, 0),
    "window_200_d128": (1, 2, 1, 200, 200, 128, True, 40),
    "window_129_200_d64": (1, 4, 2, 129, 200, 64, True, 40),
    "tq_lt_tk_127_200_d64": (1, 2, 2, 127, 200, 64, True, 0),
    "non_causal_200_129_d128": (1, 2, 1, 200, 129, 128, False, 0),
    "masked_rows_200_127_d64": (2, 2, 1, 200, 127, 64, True, 0),
}
# bfloat16 in and out, float32 accumulation, p rounded to bfloat16 before
# the PV product: the outputs are rounded to bfloat16 (a step of 2^-8 just
# below 1), and a p that lands on the other side of a rounding boundary
# moves the weighted sum by about as much (tests/test_torch_kernels.py)
BF16_TOL = 1e-2


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_at_kernel_tiles_matches_reference(case):
    B, H, Hkv, Tq, Tk, D, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(Tq * 7 + Tk + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, h, T, D)).astype(np.float32)).to(torch.bfloat16)
               for h, T in ((H, Tq), (Hkv, Tk), (Hkv, Tk)))
    got = fa.flash_attention(q, k, v, causal=causal, window=window)  # CPU tensors take the twin
    assert fa.flash_attention.launches == 0
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=causal, window=window, bq=128, bk=128))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    pallas = r_flash_attention(jq, jk, jv, causal=causal, window=window, bq=32, bk=32, interpret=True)
    g = H // Hkv
    dense = rref.flash_attention(jnp.asarray(q.float().numpy()), jnp.repeat(jnp.asarray(k.float().numpy()), g, axis=1),
                                 jnp.repeat(jnp.asarray(v.float().numpy()), g, axis=1), causal=causal, window=window)
    for want in (pallas, dense):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL, atol=BF16_TOL)
    if case.startswith("masked_rows"):  # rows at key positions < 0 see nothing
        assert not got[:, :, : Tq - Tk].float().any()


# ---------------------------------------------------------------------------
# segment reduce: the look-back model
# ---------------------------------------------------------------------------

# (distinct keys, rows, V, tile (None: the kernel's), PAD rows at the tail,
# integer-valued inputs)
SEGMENT_CASES = {
    "runs_over_many_tiles": (5, 1000, 3, 16, 0, True),
    "all_equal": (1, 1000, 3, 16, 0, True),
    "all_equal_float": (1, 700, 1, 8, 0, False),
    "pad_tail": (20, 1000, 3, 32, 300, True),
    "pad_tail_v5": (20, 1000, 5, 32, 999, False),
    "n_tile_minus_1": (7, 63, 3, 64, 0, True),
    "n_tile": (7, 64, 3, 64, 0, True),
    "n_tile_plus_1": (7, 65, 3, 64, 0, True),
    "v1": (50, 777, 1, 16, 0, False),
    "v5": (50, 777, 5, 16, 10, False),
    "one_row": (1, 1, 3, 16, 0, False),
    "kernel_tile": (300, 9000, 3, None, 100, False),
    "kernel_tile_one_key": (1, 9000, 5, None, 0, True),
}


@pytest.mark.parametrize("case", list(SEGMENT_CASES))
def test_segment_reduce_plain_models_the_lookback(case):
    nkeys, n, V, tile, pad, ints = SEGMENT_CASES[case]
    rng = np.random.default_rng(n * 10 + V)
    keys = np.sort(rng.integers(0, nkeys, n)).astype(np.int32)
    if pad:
        keys[n - pad:] = dbase.PAD
    vals = (rng.integers(-50, 50, (n, V)) if ints else rng.normal(size=(n, V))).astype(np.float32)
    ts, te = sr.segment_reduce_plain(torch.from_numpy(keys), torch.from_numpy(vals), tile=tile)
    for rs, re in (
        r_segment_reduce(jnp.asarray(keys), jnp.asarray(vals), block=128, interpret=True),
        rref.segment_reduce(jnp.asarray(keys), jnp.asarray(vals)),
    ):
        np.testing.assert_array_equal(te.numpy(), np.asarray(re))
        if ints:  # integer-valued sums are exact in any order
            np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        else:
            np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=3e-4, atol=1e-4)
    if pad:
        assert not te[n - pad:].any() and not ts[n - pad:].any()


def test_segment_reduce_plain_tile_default_is_the_kernels():
    assert sr.TILE == sr.THREADS * sr.ROWS == 4096
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(np.sort(rng.integers(0, 40, 10_000)).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-9, 9, (10_000, 2)).astype(np.float32))
    for a, b in zip(sr.segment_reduce_plain(keys, vals), sr.segment_reduce_plain(keys, vals, tile=sr.TILE)):
        assert torch.equal(a, b)


def test_segment_reduce_lane_limit_is_shared_memory():
    assert sr.smem_bytes(sr.MAX_V) <= sr._SMEM_LIMIT < sr.smem_bytes(sr.MAX_V + 1)
    assert sr.MAX_V == 13


def test_combine_is_associative():
    rng = np.random.default_rng(0)
    m, V = 4096, 3

    def draw():
        return (torch.from_numpy(rng.random(m) < 0.3),
                torch.from_numpy(rng.integers(-1000, 1000, (m, V)).astype(np.float64)))

    a, b, c = draw(), draw(), draw()
    left = sr.combine(sr.combine(a, b), c)
    right = sr.combine(a, sr.combine(b, c))
    assert torch.equal(left[0], right[0]) and torch.equal(left[1], right[1])
    identity = (torch.zeros(m, dtype=torch.bool), torch.zeros((m, V), dtype=torch.float64))
    for got in (sr.combine(identity, a), sr.combine(a, identity)):
        assert torch.equal(got[0], a[0]) and torch.equal(got[1], a[1])
