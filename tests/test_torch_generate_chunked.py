"""``data.tpch.generate_chunked`` against the reference's, on the CPU: at
scale 0.002 and a budget that keeps every relation but lineitem resident,
the same relations are chunked and resident, with the same chunks, rows and
encodings, and every chunk decodes to the reference's rows."""
import numpy as np
import pytest

from repro.data import storage as RS
from repro.data import tpch as rtpch

from repro_torch.data import storage as TS
from repro_torch.data import tpch as ttpch


@pytest.mark.parametrize("budget, chunk_rows", [(1 << 16, 2048), (1 << 40, 4096), (0, 1 << 16)])
def test_generate_chunked_matches_reference(budget, chunk_rows):
    kw = dict(scale=0.002, seed=3, memory_budget_bytes=budget, chunk_rows=chunk_rows)
    want = rtpch.generate_chunked(**kw)
    got = ttpch.generate_chunked(**kw, device="cpu")
    assert got.keys() == want.keys()
    chunked = {r for r, t in got.items() if TS.is_chunked(t)}
    assert chunked == {r for r, t in want.items() if RS.is_chunked(t)}
    assert (budget == 1 << 40) == (not chunked)
    for rel, t in got.items():
        w = want[rel]
        assert t.nrows == w.nrows and tuple(t.sorted_on) == tuple(w.sorted_on), rel
        if rel not in chunked:
            for c in w.columns:
                np.testing.assert_array_equal(t.columns[c].numpy(), np.asarray(w.columns[c]), err_msg=f"{rel}.{c}")
            continue
        assert t.n_chunks == w.n_chunks and t.chunk_rows == w.chunk_rows == chunk_rows, rel
        assert t.encodings() == w.encodings(), rel
        for i in range(t.n_chunks):
            assert t.chunk_nrows(i) == w.chunk_nrows(i)
            for c in t.schema:
                np.testing.assert_array_equal(t.chunks[i][c].decode(), w.chunks[i][c].decode(),
                                              err_msg=f"{rel}.{c} chunk {i}")
