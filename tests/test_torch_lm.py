"""The port's LM inference path against the reference, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, where attention runs the kernel's plain
twin):

* every config (all ten architectures) equals ``repro.configs.get(name)``
  field by field;
* ``rmsnorm``, ``rope`` (1-D and 2-D positions) and ``attention`` without a
  cache and with a ring cache, a wrap past ``cache_len`` included;
* the whole model in float32 (reduced llama3.2-3b with 2 KV heads, so that
  GQA runs; reduced qwen1.5-0.5b with random QKV biases) and in bfloat16
  activations, through ``params_from_reference``;
* ``decode_step`` step by step with a ring wrap, and the port's own
  decode-equals-forward;
* the greedy ``Server`` against ``repro``'s;
* the launcher on the CPU, and the entry points raising without a card;
* ``tests/data/torch_lm_reduced.npz`` (``chip_smoke.py`` holds the CUDA
  kernel's forward against it) still equals what ``repro`` computes.

Regenerate the fixture with ``PYTHONPATH=src python tests/test_torch_lm.py``.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import common as rcommon
from repro.models import lm as rlm
from repro.models.config import SHAPES as RSHAPES
from repro.models.registry import get_model as r_get_model
from repro.serve.serve_loop import Request as RRequest
from repro.serve.serve_loop import Server as RServer

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.config import ArchConfig, shape
from repro_torch.models.interop import params_from_reference
from repro_torch.models.registry import get_model, get_model_by_name
from repro_torch.serve.serve_loop import Request as TRequest
from repro_torch.serve.serve_loop import Server as TServer

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "torch_lm_reduced.npz"
CPU = torch.device("cpu")
F32_TOL = 1e-4  # float32 through both packages: sums in another order
# bfloat16 activations: every matmul output, norm and residual add rounds to
# 8 significant bits (a relative step of 2^-8 = 3.9e-3), and the packages
# round at different places (XLA keeps some elementwise chains in float32)
BF16_TOL = 3e-2

MODELS = {
    # GQA: reduce() alone gives n_kv_heads = 4 = n_heads
    "llama_gqa": ("llama3.2-3b", {"n_kv_heads": 2}),
    # QKV bias
    "qwen_bias": ("qwen1.5-0.5b", {}),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_params(cfg, seed):
    """``repro``'s parameters for ``cfg`` with random QKV biases (the
    reference initializes them to zero, which would test nothing)."""
    params = rlm.init(cfg, jax.random.PRNGKey(seed))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = dict(params["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(size=attn[name].shape).astype(np.float32) * 0.1)
        params = {**params, "layers": {**params["layers"], "attn": attn}}
    return params


def _pair(case, **overrides):
    """(reference cfg, port cfg, reference params, port params) for a case."""
    name, kw = MODELS[case]
    rcfg = rconfigs.get(name).reduce(**kw, **overrides)
    tcfg = tconfigs.get(name).reduce(**kw, **overrides)
    rp = _reference_params(rcfg, seed=len(name))
    return rcfg, tcfg, rp, params_from_reference(tcfg, _np_tree(rp), device=CPU)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", tconfigs.PORTED_IDS)
def test_config_matches_reference(name):
    t, r = tconfigs.get(name), rconfigs.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert dataclasses.asdict(t.reduce()) == dataclasses.asdict(r.reduce())
    assert (t.hd, t.padded_vocab) == (r.hd, r.padded_vocab)


def test_shapes_match_reference():
    assert [dataclasses.asdict(s) for s in TSHAPES] == [dataclasses.asdict(s) for s in RSHAPES]
    assert shape("prefill_32k").seq_len == 32768


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3.0
    scale = rng.normal(size=(64,)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tcommon.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    want = rcommon.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(tx.float().numpy()).astype(dtype))
    assert got.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else 2e-2  # one bfloat16 step of |x| <= 4
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("positions", ["1d", "2d"])
def test_rope_matches_reference(positions):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = np.arange(7) + 40 if positions == "1d" else rng.integers(0, 5000, (2, 7))
    got = tcommon.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5)
    want = rcommon.rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def _attention_params(seed, bias):
    rp = rcommon.attention_init(jax.random.PRNGKey(seed), 64, 4, 2, 16, qkv_bias=bias)
    if bias:
        rng = np.random.default_rng(seed)
        rp = {k: (jnp.asarray(rng.normal(size=a.shape).astype(np.float32)) if k.startswith("b") else a)
              for k, a in rp.items()}
    tp = {k: torch.from_numpy(np.array(a).T.copy() if k.startswith("w") else np.array(a)) for k, a in rp.items()}
    return rp, tp


@pytest.mark.parametrize("case", ["prefill", "prefill_window", "cache", "cache_wrap"])
def test_attention_matches_reference(case):
    """GQA (4 query heads over 2 KV heads), QKV bias; a decode step into a
    ring cache of 12 slots at position 5, and at 12 + 3 (the write wraps to
    slot 3 and every slot is live)."""
    rp, tp = _attention_params(seed=2, bias=True)
    rng = np.random.default_rng(3)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=1e4)
    if case.startswith("prefill"):
        x = rng.normal(size=(2, 9, 64)).astype(np.float32)
        window = 4 if case == "prefill_window" else 0
        got, got_cache = tcommon.attention(tp, torch.from_numpy(x), window=window, **kw)
        want, _ = rcommon.attention(rp, jnp.asarray(x), window=window, **kw)
        assert got_cache is None
    else:
        M, length = 12, (5 if case == "cache" else 15)
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        ck, cv = (rng.normal(size=(2, 2, M, 16)).astype(np.float32) for _ in range(2))
        kv_valid = min(length + 1, M)
        tcache = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
        got, got_cache = tcommon.attention(tp, torch.from_numpy(x), positions=torch.tensor([length]), cache=tcache,
                                           kv_valid=torch.tensor(kv_valid), **kw)
        want, want_cache = rcommon.attention(rp, jnp.asarray(x), positions=jnp.asarray([length]),
                                             cache=(jnp.asarray(ck), jnp.asarray(cv)), kv_valid=jnp.int32(kv_valid), **kw)
        assert got_cache[0] is tcache[0]  # written in place
        for g, w in zip(got_cache, want_cache):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)
        slot = length % M
        assert not np.array_equal(got_cache[0][:, :, slot].numpy(), ck[:, :, slot])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MODELS))
def test_forward_matches_reference(case):
    rcfg, tcfg, rp, tp = _pair(case)
    toks = _tokens(tcfg, 2, 20, seed=5)
    got, aux = tlm.forward(tcfg, tp, torch.from_numpy(toks))
    want, _ = rlm.forward(rcfg, rp, jnp.asarray(toks))
    assert got.shape == (2, 20, tcfg.padded_vocab) and got.dtype == torch.float32
    assert not aux.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", list(MODELS))
def test_forward_bf16_matches_reference(case):
    """float32 parameters cast at use to bfloat16 activations, in both."""
    rcfg, tcfg, rp, tp = _pair(case, act_dtype="bfloat16")
    toks = _tokens(tcfg, 2, 20, seed=6)
    got, _ = tlm.forward(tcfg, tp, torch.from_numpy(toks))
    want, _ = rlm.forward(rcfg, rp, jnp.asarray(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=BF16_TOL, atol=BF16_TOL)


def test_decode_matches_reference_through_a_ring_wrap():
    """12 steps into 8 slots from an empty cache: from step 8 on, each write
    overwrites the oldest slot and every slot is live."""
    rcfg, tcfg, rp, tp = _pair("llama_gqa")
    toks = _tokens(tcfg, 2, 12, seed=7)
    tc = tlm.init_cache(tcfg, 2, 8, fill_len=0, device=CPU)
    rc = rlm.init_cache(rcfg, 2, 8, fill_len=0)
    for t in range(12):
        got, tc = tlm.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        want, rc = rlm.decode_step(rcfg, rp, rc, jnp.asarray(toks[:, t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    assert int(tc["len"]) == int(rc["len"]) == 12
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(rc[name]), rtol=F32_TOL, atol=F32_TOL)


def test_decode_equals_forward():
    """The port's own consistency (as ``tests/test_models_smoke.py`` checks
    the reference's): stepwise decode from an empty ring cache equals the
    teacher-forced forward at every position."""
    m = get_model_by_name("llama3.2-3b", reduced=True, device=CPU)
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(m.cfg, 2, 6, seed=1))
    logits_f, _ = m.forward(params, toks)
    cache = tlm.init_cache(m.cfg, 2, 16, fill_len=0, device=CPU)
    for t in range(6):
        logits_s, cache = m.decode_step(params, cache, toks[:, t])
        np.testing.assert_allclose(logits_s.numpy(), logits_f[:, t].numpy(), rtol=2e-3, atol=2e-3)


def test_server_matches_reference():
    """Greedy serving: 6 requests over 2 slots, 16 cache slots (the steps
    wrap the ring), the same tokens as ``repro``'s ``Server``."""
    rcfg, tcfg, rp, tp = _pair("llama_gqa")
    prompts = [[1 + i % 7, 2, 3 + i] for i in range(6)]
    outs = {}
    for name, srv, Req in (
        ("repro", RServer(r_get_model(rcfg), rp, batch_slots=2, cache_len=16), RRequest),
        ("port", TServer(get_model(tcfg, device=CPU), tp, batch_slots=2, cache_len=16), TRequest),
    ):
        for i, p in enumerate(prompts):
            srv.submit(Req(rid=i, prompt=p, max_new=5))
        done = srv.run_until_done()
        outs[name] = ({r.rid: r.out for r in done}, srv.steps_run)
    assert outs["port"] == outs["repro"]
    assert len(outs["port"][0]) == 6 and outs["port"][1] > 16


def test_server_samples_reproducibly_at_temperature():
    m = get_model_by_name("llama3.2-3b", reduced=True, device=CPU)
    params = m.init(torch.Generator().manual_seed(0))
    runs = []
    for seed in (3, 3, 4):
        srv = TServer(m, params, batch_slots=2, cache_len=16, eos=-1, temperature=0.8, seed=seed)
        for i in range(3):
            srv.submit(TRequest(rid=i, prompt=[1 + i, 2, 3], max_new=6))
        runs.append({r.rid: r.out for r in srv.run_until_done()})
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(len(o) == 6 and all(0 <= t < m.cfg.vocab for t in o) for o in runs[0].values())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_launcher_runs_reduced_on_cpu(capsys):
    tlaunch.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--requests", "5", "--slots", "2",
                  "--max-new", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[serve] no checkpoint — random weights (demo mode)"
    assert lines[-1].startswith("[serve] 5 requests, 20 tokens, ")
    assert lines[-1].endswith("tok/s aggregate over 2 slots, 22 decode steps)")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("llama3.2-3b").reduce()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model_by_name("llama3.2-3b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        tlm.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_reference(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--arch", "llama3.2-3b", "--reduced"])


def test_other_model_kinds_raise():
    # lm.init builds decoders only (rwkv, jamba and encdec have modules of
    # their own, tests/test_torch_{rwkv6,jamba,whisper}.py); a kind that no
    # package has is refused by the registry
    rwkv = ArchConfig("r", "ssm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
                      model_kind="rwkv")
    with pytest.raises(NotImplementedError, match="decoders only"):
        tlm.init(rwkv, torch.Generator(), CPU)
    other = dataclasses.replace(rwkv, model_kind="diffusion")
    with pytest.raises(NotImplementedError, match="none of the reference's"):
        get_model(other, device=CPU)


def test_model_batches_and_support_matrix():
    m = get_model_by_name("granite-20b", reduced=True, device=CPU)
    g = torch.Generator().manual_seed(0)
    dec = m.make_batch(shape("decode_32k"), g)
    assert dec["token"].shape == (128,) and int(dec["cache"]["len"]) == 32768
    assert dec["cache"]["k"].shape == (m.cfg.n_layers, 128, 1, 32768, 16)
    del dec
    pre = m.make_batch(dataclasses.replace(shape("prefill_32k"), seq_len=16), g)
    assert pre["tokens"].shape == (32, 16) and int(pre["tokens"].max()) < m.cfg.vocab
    assert m.supports(shape("long_500k")) == r_get_model(rconfigs.get("granite-20b")).supports(shape("long_500k"))
    assert m.supports(shape("prefill_32k"))[0]


def test_forward_takes_the_twin_on_cpu():
    m = get_model_by_name("llama3.2-3b", reduced=True, device=CPU)
    params = m.init(torch.Generator().manual_seed(0))
    fa.flash_attention.launches = 0
    logits, _ = m.forward(params, torch.from_numpy(_tokens(m.cfg, 1, 9, seed=2)))
    assert fa.flash_attention.launches == 0 and torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the chip fixture
# ---------------------------------------------------------------------------


def reference_fixture():
    """What ``tests/data/torch_lm_reduced.npz`` holds: ``repro``'s reduced
    llama3.2-3b with 2 KV heads (its parameters under ``params/<path>``), a
    token batch and ``repro``'s float32 forward logits."""
    cfg = rconfigs.get("llama3.2-3b").reduce(n_kv_heads=2)
    params = rlm.init(cfg, jax.random.PRNGKey(14))
    tokens = np.random.default_rng(14).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    logits, _ = rlm.forward(cfg, params, jnp.asarray(tokens))
    out = {"tokens": tokens, "logits": np.asarray(logits, np.float32)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    return out


def _unflatten(flat):
    tree = {}
    for key, a in flat.items():
        if key.startswith("params/"):
            *parents, leaf = key.split("/")[1:]
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a
    return tree


def test_fixture_matches_reference():
    with np.load(FIXTURE) as f:
        stored = dict(f)
    fresh = reference_fixture()
    assert sorted(stored) == sorted(fresh)
    for key, a in fresh.items():
        if key == "logits":
            np.testing.assert_allclose(stored[key], a, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(stored[key], a)
    assert FIXTURE.stat().st_size < 1_100_000
    # and the port computes the same logits from it
    cfg = tconfigs.get("llama3.2-3b").reduce(n_kv_heads=2)
    got, _ = tlm.forward(cfg, params_from_reference(cfg, _unflatten(stored), device=CPU),
                         torch.from_numpy(stored["tokens"]))
    np.testing.assert_allclose(got.numpy(), stored["logits"], rtol=F32_TOL, atol=F32_TOL)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez(FIXTURE, **reference_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
