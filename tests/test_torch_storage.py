"""The port's out-of-core storage against ``repro.data.storage``: the numpy
encoders give the same payload bytes, the decode's plain twin is bitwise
equal to the reference's Pallas decode (interpret mode) and to the host
decode, chunked tables round-trip, and the storage plan decides alike."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import cost as RC
from repro.data import storage as RS
from repro.data import tpch as rtpch
from repro.data.table import collect_stats as rstats
from repro.kernels import decode as RDK

from repro_torch.core import cost as TC
from repro_torch.data import storage as TS
from repro_torch.data.interop import from_reference
from repro_torch.data.table import Table
from repro_torch.data.table import collect_stats as tstats
from repro_torch.kernels import decode as DK
from repro_torch.kernels import ops, ref


def _adversarial():
    """The adversarial columns of the reference's storage tests: name ->
    (array, encodings that must apply to it)."""
    rng = np.random.default_rng(7)
    n = 1000  # deliberately not a tile multiple
    return {
        "all_constant": (np.full(n, 42, np.int32), ("rle", "bitpack", "dict")),
        "all_distinct": (rng.permutation(n).astype(np.int32), ("bitpack",)),
        "skewed_runs": (np.repeat(rng.integers(0, 5, 40), 25).astype(np.int32), ("rle", "bitpack", "dict")),
        "negatives": ((rng.integers(0, 100, n) - 50).astype(np.int32), ("for", "dict")),
        "wide_frame": (((1 << 24) - 500 + rng.integers(0, 1000, n)).astype(np.int32), ("for",)),
        "float_dict": (rng.choice(np.abs(rng.standard_normal(9)).astype(np.float32), n), ("dict", "rle")),
        "single_row": (np.asarray([-7], np.int32), ("rle", "dict", "for")),
    }


CASES = sorted(_adversarial())
BLOCKS = (256, 1024)


def _payload(enc):
    return {k: torch.from_numpy(np.array(v)) for k, v in enc.payload.items()}


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", CASES)
def test_encode_column_matches_reference(name, block):
    a, modes = _adversarial()[name]
    for mode in ("auto", "plain", *modes):
        want = RS.encode_column(a, block=block, mode=mode)
        got = TS.encode_column(a, block=block, mode=mode)
        assert (got.kind, got.dtype, got.n, got.block, got.meta) == (want.kind, want.dtype, want.n, want.block, want.meta)
        assert got.payload.keys() == want.payload.keys()
        for k in want.payload:
            assert got.payload[k].dtype == want.payload[k].dtype
            np.testing.assert_array_equal(got.payload[k], want.payload[k])
        np.testing.assert_array_equal(got.decode(), a)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", CASES)
def test_decode_plain_bitwise_vs_pallas_decode(name, block):
    a, modes = _adversarial()[name]
    for mode in modes:
        enc = TS.encode_column(a, block=block, mode=mode)
        pal = np.asarray(RDK.pallas_decode(
            enc, {k: jnp.asarray(v) for k, v in enc.payload.items()}, interpret=True,
        ))
        code = DK.column_code(enc)
        plain = DK.decode_plain(code, _payload(enc), enc.n).numpy()
        assert plain.dtype == a.dtype
        np.testing.assert_array_equal(plain.view(np.uint32), pal.view(np.uint32))
        np.testing.assert_array_equal(DK.decode_device(enc, _payload(enc)).numpy(), plain)
        assert torch.equal(ops.decode(code, _payload(enc), enc.n), ref.decode(code, _payload(enc), enc.n))
        # the padded tail repeats the last row
        out_rows = enc.n + 3 * block + 5
        padded = DK.decode_device(enc, _payload(enc), out_rows).numpy()
        np.testing.assert_array_equal(padded[: enc.n], a)
        assert (padded[enc.n:] == a[-1]).all()


def test_decode_on_cpu_takes_the_plain_twin_and_counts_no_launch():
    a, _ = _adversarial()["skewed_runs"]
    before = DK.decode.launches
    enc = TS.encode_column(a, block=256, mode="rle")
    out = DK.decode(DK.column_code(enc), _payload(enc), 2048)
    assert DK.decode.launches == before
    np.testing.assert_array_equal(out[: len(a)].numpy(), a)
    assert DK.decode_device(TS.encode_column(a, block=256, mode="plain"), {"data": torch.from_numpy(a)}, len(a) + 4).shape == (len(a) + 4,)


@pytest.fixture(scope="module")
def dbs():
    rdb = rtpch.generate(scale=0.01, seed=3).tables()
    return rdb, from_reference(rdb, device="cpu")


def test_chunk_table_round_trip_with_short_final_chunk(dbs):
    rdb, tdb = dbs
    t = tdb["lineitem"]
    ct = TS.chunk_table(t, chunk_rows=1 << 12)
    rct = RS.chunk_table(rdb["lineitem"], chunk_rows=1 << 12)
    assert ct.nrows == t.nrows and ct.n_chunks == -(-t.nrows // (1 << 12)) == rct.n_chunks
    assert ct.chunk_nrows(ct.n_chunks - 1) < ct.chunk_rows  # short final chunk
    assert ct.encodings() == rct.encodings()
    assert ct.encoded_nbytes == rct.encoded_nbytes < ct.decoded_nbytes == rct.decoded_nbytes
    dec = ct.decode()
    for c in t.names():
        assert torch.equal(dec.col(c), t.col(c))
    for i in (0, ct.n_chunks - 1):
        up, nbytes = ct.upload_chunk(i)
        assert nbytes == sum(e.nbytes for e in ct.chunks[i].values())
        td = ct.chunk_device(i, pad=True, uploaded=up)
        host = ct.chunk(i, pad=True)
        lo, n = i * ct.chunk_rows, ct.chunk_nrows(i)
        assert td.nrows == host.nrows == ct.chunk_rows
        assert torch.equal(td.mask, torch.arange(ct.chunk_rows) < n)
        assert torch.equal(host.live_mask(), td.mask)
        for c in t.names():
            assert torch.equal(td.col(c)[:n], t.col(c)[lo: lo + n])
            assert torch.equal(td.col(c), host.col(c))  # pad repeats the last row
        unpadded = ct.chunk_device(i, cols=("quantity",))
        assert unpadded.mask is None and unpadded.nrows == n


def test_zero_row_chunk_round_trip(dbs):
    _, tdb = dbs
    empty = Table({c: a[:0] for c, a in tdb["lineitem"].columns.items()}, 0, sorted_on=tdb["lineitem"].sorted_on)
    ct = TS.chunk_table(empty, chunk_rows=1024)
    assert ct.n_chunks == 1 and ct.nrows == 0 and ct.chunk_nrows(0) == 0
    assert ct.decode().nrows == 0
    up, nbytes = ct.upload_chunk(0)
    assert nbytes == 0
    dev = ct.chunk_device(0, pad=True, uploaded=up)
    assert dev.nrows == 1024 and int(dev.live_mask().sum()) == 0
    assert all(a.shape == (1024,) for a in dev.columns.values())


@pytest.mark.parametrize("budget", [0, 1 << 20, 1 << 22, 1 << 40])
def test_storage_plan_decides_as_reference(dbs, budget):
    rdb, tdb = dbs
    want = RC.storage_plan(rstats(rdb), budget, chunk_rows=1 << 13)
    got = TC.storage_plan(tstats(tdb), budget, chunk_rows=1 << 13)
    assert {r: (d.mode, d.encodings) for r, d in got.items()} == {r: (d.mode, d.encodings) for r, d in want.items()}
    placed = TS.chunk_db(tdb, budget, chunk_rows=1 << 13)
    rplaced = RS.chunk_db(rdb, budget, chunk_rows=1 << 13)
    assert {r for r, t in placed.items() if TS.is_chunked(t)} == {r for r, t in rplaced.items() if RS.is_chunked(t)}
