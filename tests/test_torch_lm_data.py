"""The port's LM token stream (``repro_torch.data.lm_data``) on the CPU.

Its draws are the CPU generator's, not ``repro``'s threefry bits, so the
two streams differ token by token; these tests hold the properties the
reference's stream has: a pure function of (cfg, step), elastic re-slicing,
the token range, ``labels`` the ``tokens`` shifted by one, the drifting
mixture the recipe describes, and a restorable ``TokenStream``.
"""
import numpy as np
import pytest
import torch

from repro.data.lm_data import StreamConfig as RStreamConfig
from repro.data.lm_data import batch_at as r_batch_at

from repro_torch.data import lm_data as L

CPU = torch.device("cpu")


def _cfg(**kw):
    base = dict(vocab=100, global_batch=8, seq_len=16, seed=7)
    base.update(kw)
    return L.StreamConfig(**base)


def test_config_matches_reference():
    for kw in ({}, {"n_shards": 4, "shard_id": 3}):
        t, r = _cfg(**kw), RStreamConfig(vocab=100, global_batch=8, seq_len=16, seed=7, **kw)
        assert t.local_batch == r.local_batch


def test_batch_is_a_pure_function_of_config_and_step():
    a, b = L.batch_at(_cfg(), 3, CPU), L.batch_at(_cfg(), 3, CPU)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], L.batch_at(_cfg(), 4, CPU)["tokens"])
    assert not torch.equal(a["tokens"], L.batch_at(_cfg(seed=8), 3, CPU)["tokens"])
    rows = a["tokens"]
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]  # rows differ


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shards_concatenate_to_the_global_batch(n_shards):
    full = L.batch_at(_cfg(), 5, CPU)
    parts = [L.batch_at(_cfg(n_shards=n_shards, shard_id=s), 5, CPU) for s in range(n_shards)]
    for key in ("tokens", "labels"):
        assert torch.equal(full[key], torch.cat([p[key] for p in parts]))


@pytest.mark.parametrize("vocab", [1, 17, 500, 128256])
def test_tokens_in_range_and_labels_shifted(vocab):
    b = L.batch_at(_cfg(vocab=vocab, seq_len=64), 0, CPU)
    t, y = b["tokens"], b["labels"]
    assert t.shape == y.shape == (8, 64) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) < vocab and int(y.max()) < vocab
    assert torch.equal(t[:, 1:], y[:, :-1])


def test_the_mixture_of_the_recipe():
    """Zipf-ish marginals (the low ids dominate) with about 35 % of
    positions drifted into a row's topic band of 17 ids, as the reference's
    stream draws them."""
    V = 4096
    cfg = _cfg(vocab=V, global_batch=32, seq_len=255)
    got = torch.cat([L.batch_at(cfg, s, CPU)["tokens"].flatten() for s in range(4)]).numpy()
    want = np.asarray(r_batch_at(RStreamConfig(vocab=V, global_batch=32, seq_len=255, seed=7), 0)["tokens"]).ravel()
    for toks in (got, want):
        assert (toks < V // 4).mean() > 0.45  # P(u^2 < 1/4) = 1/2, plus the drift
    # each row's most common band of 17 consecutive ids holds about the drift share
    def band_share(row):
        c = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=V))])
        return (c[17:] - c[:-17]).max() / row.size

    for toks in (L.batch_at(cfg, 9, CPU)["tokens"].numpy(), np.asarray(r_batch_at(
            RStreamConfig(vocab=V, global_batch=32, seq_len=255, seed=7), 9)["tokens"])):
        assert 0.3 < float(np.median([band_share(r) for r in toks])) < 0.5


def test_token_stream_state_restore_and_reshard():
    s = L.TokenStream(_cfg(), device=CPU)
    s.next(), s.next()
    assert s.state() == {"data_step": 2}
    s2 = L.TokenStream(_cfg(), device=CPU)
    s2.restore(s.state())
    assert torch.equal(s.next()["tokens"], s2.next()["tokens"])
    half = s.reshard(2, 1)
    assert half.step == s.step and half.cfg.local_batch == 4
    assert torch.equal(half.next()["tokens"], L.batch_at(_cfg(), s.step, CPU)["tokens"][4:])


def test_batches_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.batch_at(_cfg(), 0)
