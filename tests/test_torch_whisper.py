"""The port's whisper (the ``encdec`` kind, ``audio`` family) against the
reference, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, where attention runs the kernel's plain
twin), at the reduced config (2 encoder + 4 decoder layers, d 64, head dim
16, 16 frames):

* ``gelu_mlp`` (the tanh gelu, as ``jax.nn.gelu``), ``_sinusoid``, and
  ``attention`` without rope (with and without a ring cache) and with
  ``cross_kv``;
* ``encode``, ``forward`` in float32 and bfloat16 activations, ``loss_fn``
  with every gradient leaf against ``jax.value_and_grad``;
* ``decode_step`` over a ring wrap from a cache whose ``enc_out`` is
  ``encode(frames)``, and ``init_cache``;
* the reference's decode adds no position embedding: both packages' decode
  differ from the forward, and both equal it once the step's sinusoid is
  added by hand (``ROADMAP.md`` §3);
* ``params_from_reference`` and the port's own ``init`` (one tree), the
  greedy ``Server`` token for token, ``make_batch``, ``supports``, the full
  config's parameter count, the launcher;
* ``tests/data/torch_encdec_vlm_reduced.npz`` (``chip_smoke.py`` holds the
  CUDA kernels against it) still equals what ``repro`` computes.

Regenerate the fixture with ``PYTHONPATH=src python tests/test_torch_whisper.py``
(it also holds the reduced pixtral at head dim 160).
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
from repro.models import whisper as rwhisper
from repro.models.config import SHAPES as RSHAPES
from repro.models.registry import get_model as r_get_model
from repro.serve.serve_loop import Request as RRequest
from repro.serve.serve_loop import Server as RServer

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as twhisper
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.config import shape
from repro_torch.models.interop import params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.serve.serve_loop import Request as TRequest
from repro_torch.serve.serve_loop import Server as TServer

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "torch_encdec_vlm_reduced.npz"
CPU = torch.device("cpu")
ARCH = "whisper-large-v3"
F32_TOL = 1e-4  # float32 through both packages: sums in another order
# bfloat16 activations: every matmul output, norm and residual add rounds to
# 8 significant bits, and the packages round at different places
BF16_TOL = 3e-2
# the chip fixture's configs: narrower than reduce() so that both fit the
# file's 1.1 MB (the pixtral case at head dim 160, where the kernel's own
# D = 160 path runs)
FIXTURE_CFGS = {
    "whisper": (ARCH, dict(d_model=32, n_layers=2)),
    "pixtral": ("pixtral-12b", dict(d_model=32, n_layers=2, n_heads=2, n_kv_heads=1, head_dim=160, d_ff=64)),
}
FIXTURE_DECODE_STEPS = 4


def close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg, tcfg = rconfigs.get(ARCH).reduce(**overrides), tconfigs.get(ARCH).reduce(**overrides)
    rp = rwhisper.init(rcfg, jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, params_from_reference(tcfg, _np(rp), device=CPU)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _frames(cfg, B, seed):
    return (np.random.default_rng(seed).normal(size=(B, cfg.enc_seq, cfg.d_model)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_reference(dtype):
    rng = np.random.default_rng(0)
    rp = rcommon.gelu_mlp_init(jax.random.PRNGKey(1), 64, 128)
    rp = {k: (jnp.asarray(rng.normal(size=a.shape).astype(np.float32)) if k.startswith("b") else a)
          for k, a in rp.items()}
    tp = {k: torch.from_numpy(np.array(a).T.copy() if k.startswith("w") else np.array(a)) for k, a in rp.items()}
    x = (rng.normal(size=(2, 7, 64)) * 2).astype(np.float32)
    dt = getattr(torch, dtype)
    got = tcommon.gelu_mlp(tcommon.cast_tree(tp, dt), torch.from_numpy(x).to(dt))
    want = rcommon.gelu_mlp(rcommon.cast_tree(rp, jnp.dtype(dtype)), jnp.asarray(x).astype(dtype))
    assert got.dtype == dt
    close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)
    # the tanh approximation: the exact erf form is another function
    exact = torch.nn.functional.linear(torch.nn.functional.gelu(torch.nn.functional.linear(
        torch.from_numpy(x), tp["wi"], tp["bi"])), tp["wo"], tp["bo"])
    assert float((exact - tcommon.gelu_mlp(tp, torch.from_numpy(x))).abs().max()) > 1e-4
    init = tcommon.gelu_mlp_init(torch.Generator(), 64, 128, CPU)
    assert {k: tuple(t.shape)[::-1] if k.startswith("w") else tuple(t.shape) for k, t in init.items()} == {
        k: a.shape for k, a in rcommon.gelu_mlp_init(jax.random.PRNGKey(0), 64, 128).items()}
    assert not init["bi"].any() and not init["bo"].any()


@pytest.mark.parametrize("T,d", [(16, 64), (1500, 1280), (7, 10)])
def test_sinusoid_matches_reference(T, d):
    got = twhisper._sinusoid(T, d)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    close(got, rwhisper._sinusoid(T, d))


def _attention_params(seed):
    rp = rcommon.attention_init(jax.random.PRNGKey(seed), 64, 4, 4, 16)
    return rp, {k: torch.from_numpy(np.array(a).T.copy()) for k, a in rp.items()}


@pytest.mark.parametrize("case", ["causal", "noncausal", "cache", "cache_wrap"])
def test_attention_without_rope_matches_reference(case):
    """``use_rope=False``: neither q nor k rotated (whisper's self attention
    and encoder), with and without a ring cache of 12 slots."""
    rp, tp = _attention_params(seed=2)
    rng = np.random.default_rng(3)
    kw = dict(n_heads=4, n_kv=4, head_dim=16, use_rope=False)
    if case in ("causal", "noncausal"):
        x = rng.normal(size=(2, 9, 64)).astype(np.float32)
        causal = case == "causal"
        got, _ = tcommon.attention(tp, torch.from_numpy(x), causal=causal, **kw)
        want, _ = rcommon.attention(rp, jnp.asarray(x), causal=causal, **kw)
        # positions change nothing without rope
        moved, _ = tcommon.attention(tp, torch.from_numpy(x), causal=causal, positions=torch.arange(9) + 100, **kw)
        close(moved, want)
    else:
        M, length = 12, (5 if case == "cache" else 15)
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        ck, cv = (rng.normal(size=(2, 4, M, 16)).astype(np.float32) for _ in range(2))
        kv_valid = min(length + 1, M)
        tcache = (torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()))
        got, got_cache = tcommon.attention(tp, torch.from_numpy(x), positions=torch.tensor([length]), cache=tcache,
                                           kv_valid=torch.tensor(kv_valid), **kw)
        want, want_cache = rcommon.attention(rp, jnp.asarray(x), positions=jnp.asarray([length]),
                                             cache=(jnp.asarray(ck), jnp.asarray(cv)), kv_valid=jnp.int32(kv_valid),
                                             **kw)
        assert got_cache[0] is tcache[0]  # written in place
        for g, w in zip(got_cache, want_cache):
            close(g, w)
    close(got, want)


@pytest.mark.parametrize("Tq", [1, 6])
def test_cross_attention_matches_reference(Tq):
    """``cross_kv``: K and V given ``[B, H, Te, hd]`` (the encoder's), no
    cache, nothing rotated, non-causal; the module's own ``wk`` / ``wv`` are
    not read."""
    rp, tp = _attention_params(seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, Tq, 64)).astype(np.float32)
    k, v = (rng.normal(size=(2, 4, 11, 16)).astype(np.float32) for _ in range(2))
    kw = dict(n_heads=4, n_kv=4, head_dim=16, causal=False, use_rope=False)
    got, got_cache = tcommon.attention(tp, torch.from_numpy(x), cross_kv=(torch.from_numpy(k), torch.from_numpy(v)),
                                       **kw)
    want, _ = rcommon.attention(rp, jnp.asarray(x), cross_kv=(jnp.asarray(k), jnp.asarray(v)), **kw)
    assert got_cache is None
    close(got, want)
    tp_no_kv = {n: t for n, t in tp.items() if n not in ("wk", "wv")}
    again, _ = tcommon.attention(tp_no_kv, torch.from_numpy(x), cross_kv=(torch.from_numpy(k), torch.from_numpy(v)),
                                 **kw)
    assert torch.equal(again, got)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_encode_matches_reference():
    rcfg, tcfg, rp, tp = _pair(seed=0)
    frames = _frames(tcfg, 2, seed=1)
    fa.flash_attention.launches = 0
    got = twhisper.encode(tcfg, tp, torch.from_numpy(frames))
    assert fa.flash_attention.launches == 0  # the CPU runs the twin
    want = rwhisper.encode(rcfg, rp, jnp.asarray(frames))
    assert got.shape == (2, tcfg.enc_seq, tcfg.d_model)
    close(got, want)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(act_dtype):
    rcfg, tcfg, rp, tp = _pair(seed=1, act_dtype=act_dtype)
    toks, frames = _tokens(tcfg, 2, 13, seed=2), _frames(tcfg, 2, seed=3)
    got, aux = get_model(tcfg, device=CPU).forward(tp, torch.from_numpy(toks), frames=torch.from_numpy(frames))
    want, want_aux = rwhisper.forward(rcfg, rp, jnp.asarray(toks), jnp.asarray(frames))
    assert got.shape == (2, 13, tcfg.padded_vocab) and got.dtype == getattr(torch, act_dtype)
    close(got, want, F32_TOL if act_dtype == "float32" else BF16_TOL)
    close(aux, want_aux)


def _trainable(params):
    return tcommon.tree_map(lambda t: t.requires_grad_(True), params)


def test_loss_and_gradients_match_reference():
    """A padded vocabulary tail (500 of 512 ids live) and a loss mask; every
    gradient leaf within 1e-4 of the leaf's largest gradient."""
    rcfg, tcfg, rp, tp = _pair(seed=3, vocab=500)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, tcfg.vocab, (2, 11)).astype(np.int32) for k in ("tokens", "labels")}
    batch["frames"] = _frames(tcfg, 2, seed=4)
    batch["loss_mask"] = (rng.random((2, 11)) < 0.8).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: rwhisper.loss_fn(rcfg, p, b)))(rp, batch)
    tp = _trainable(tp)
    got = get_model(tcfg, device=CPU).loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    want = dict(tcommon.tree_items(params_from_reference(tcfg, _np(grads), device=CPU)))
    have = dict(tcommon.tree_items(tcommon.tree_map(lambda p: p.grad, tp)))
    assert have.keys() == want.keys()
    for key, w in want.items():
        err = float((have[key] - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-8, (key, err)


def _decode_caches(rcfg, tcfg, rp, tp, frames, M):
    """Both packages' caches of ``M`` slots with ``len`` 0 and the encoder's
    output of ``frames`` as cross-attention memory."""
    rc = rwhisper.init_cache(rcfg, frames.shape[0], M)
    rc = {**rc, "enc_out": rwhisper.encode(rcfg, rp, jnp.asarray(frames)), "len": jnp.zeros((), jnp.int32)}
    tc = twhisper.init_cache(tcfg, frames.shape[0], M, fill_len=0, device=CPU)
    tc["enc_out"] = twhisper.encode(tcfg, tp, torch.from_numpy(frames))
    return rc, tc


def test_decode_matches_reference_through_a_ring_wrap():
    """12 steps into 8 slots: from step 8 on each write overwrites the oldest
    slot; each step's logits and the cache they leave."""
    rcfg, tcfg, rp, tp = _pair(seed=4)
    toks, frames = _tokens(tcfg, 2, 12, seed=5), _frames(tcfg, 2, seed=6)
    rc, tc = _decode_caches(rcfg, tcfg, rp, tp, frames, 8)
    step = jax.jit(lambda p, c, t: rwhisper.decode_step(rcfg, p, c, t))
    k0 = tc["k"]
    for t in range(12):
        got, tc = twhisper.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        want, rc = step(rp, rc, jnp.asarray(toks[:, t]))
        close(got, want)
    assert tc["k"] is k0  # written in place
    for key in ("k", "v", "enc_out"):
        close(tc[key], rc[key])
    assert int(tc["len"]) == int(rc["len"]) == 12


def _step_with_position(mod, common, stack, cfg, params, cache, tok, layer_params, pos):
    """One decode step as ``decode_step`` runs it (float32 configs), with the
    sinusoid at the step's position added to the token's embedding; returns
    (logits, the cache it leaves)."""
    x = common.embed(params["embed"], tok[:, None]) + mod._sinusoid(pos + 1, cfg.d_model)[pos]
    ks, vs = [], []
    for i, lp in enumerate(layer_params):
        x, (k, v) = mod._dec_layer(cfg, lp, x, cache["enc_out"], positions=cache["len"][None],
                                   cache=(cache["k"][i], cache["v"][i]))
        ks.append(k)
        vs.append(v)
    logits = common.unembed(params["embed"], common.layernorm(params["dec_norm"], x))[:, 0]
    return logits, {**cache, "k": stack(ks), "v": stack(vs), "len": cache["len"] + 1}


def test_reference_decode_omits_the_position_embedding():
    """The reference's ``decode_step`` embeds the token with no position
    (``forward`` adds ``_sinusoid``), and the port keeps that: from an empty
    cache over ``encode(frames)`` both packages' steps differ from the
    teacher-forced forward, and both equal it once the step's sinusoid is
    added."""
    rcfg, tcfg, rp, tp = _pair(seed=0)
    T = 6
    toks, frames = _tokens(tcfg, 2, T, seed=0), _frames(tcfg, 2, seed=0)
    fwd = np.asarray(rwhisper.forward(rcfg, rp, jnp.asarray(toks), jnp.asarray(frames))[0])
    r_layers = [jax.tree.map(lambda a, i=i: a[i], rp["dec_layers"]) for i in range(rcfg.n_layers)]
    rc, tc = _decode_caches(rcfg, tcfg, rp, tp, frames, 8)
    rc_pos, tc_pos = _decode_caches(rcfg, tcfg, rp, tp, frames, 8)
    gaps = {"repro": 0.0, "port": 0.0}
    for t in range(T):
        r_step, rc = rwhisper.decode_step(rcfg, rp, rc, jnp.asarray(toks[:, t]))
        t_step, tc = twhisper.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        close(t_step, r_step)
        gaps["repro"] = max(gaps["repro"], float(np.abs(np.asarray(r_step) - fwd[:, t]).max()))
        gaps["port"] = max(gaps["port"], float((t_step - torch.from_numpy(fwd[:, t].copy())).abs().max()))
        # with the step's position added, both equal the forward
        r_pos, rc_pos = _step_with_position(rwhisper, rcommon, jnp.stack, rcfg, rp, rc_pos,
                                            jnp.asarray(toks[:, t]), r_layers, t)
        with torch.no_grad():
            t_pos, tc_pos = _step_with_position(twhisper, tcommon, torch.stack, tcfg, tp, tc_pos,
                                                torch.from_numpy(toks[:, t]), tp["dec_layers"], t)
        close(r_pos, fwd[:, t])
        close(t_pos, fwd[:, t])
    assert gaps["repro"] > 1e-2 and gaps["port"] > 1e-2, gaps


def test_init_cache_matches_reference():
    rcfg, tcfg = rconfigs.get(ARCH).reduce(), tconfigs.get(ARCH).reduce()
    want = rwhisper.init_cache(rcfg, 3, 16)
    got = twhisper.init_cache(tcfg, 3, 16, device=CPU)
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert not got[key].any() if key != "len" else int(got[key]) == int(want[key]) == 16
    assert int(twhisper.init_cache(tcfg, 3, 16, fill_len=0, device=CPU)["len"]) == 0


def test_params_and_init_share_the_reference_tree():
    """``params_from_reference`` unstacks both layer stacks, transposes the
    attention projections (``self_attn``, ``cross_attn``, ``attn``) and the
    MLP's ``wi`` / ``wo``, and keeps the MLP biases and the layernorms; the
    port's own ``init`` gives the same tree, its leaves cast as drawn."""
    rcfg, tcfg, rp, tp = _pair(seed=5)
    r = _np(rp)
    assert list(tp) == ["embed", "enc_layers", "dec_layers", "enc_norm", "dec_norm"]
    assert (len(tp["enc_layers"]), len(tp["dec_layers"])) == (tcfg.enc_layers, tcfg.n_layers) == (2, 4)
    for i, layer in enumerate(tp["dec_layers"]):
        for block in ("self_attn", "cross_attn"):
            for name in ("wq", "wk", "wv", "wo"):
                np.testing.assert_array_equal(layer[block][name].numpy(), r["dec_layers"][block][name][i].T)
        for name in ("wi", "wo"):
            np.testing.assert_array_equal(layer["mlp"][name].numpy(), r["dec_layers"]["mlp"][name][i].T)
        for name in ("bi", "bo"):
            np.testing.assert_array_equal(layer["mlp"][name].numpy(), r["dec_layers"]["mlp"][name][i])
        np.testing.assert_array_equal(layer["cross_norm"]["scale"].numpy(), r["dec_layers"]["cross_norm"]["scale"][i])
    for i, layer in enumerate(tp["enc_layers"]):
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(), r["enc_layers"]["attn"]["wq"][i].T)
    shapes = {k: tuple(t.shape) for k, t in tcommon.tree_items(tp)}
    own = twhisper.init(tcfg, torch.Generator().manual_seed(0), CPU)
    assert {k: tuple(t.shape) for k, t in tcommon.tree_items(own)} == shapes
    bf = twhisper.init(tcfg, torch.Generator().manual_seed(0), CPU, dtype=torch.bfloat16)
    for (key, a), (_, b) in zip(tcommon.tree_items(own), tcommon.tree_items(bf)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b), key


def test_server_matches_reference():
    """Greedy serving: 5 requests over 2 slots, the same tokens as
    ``repro``'s ``Server`` (both serve with the zero ``enc_out`` that
    ``init_cache`` gives)."""
    rcfg, tcfg, rp, tp = _pair(seed=6)
    prompts = [[1 + i % 7, 2, 3 + i] for i in range(5)]
    outs = {}
    for name, srv, Req in (
        ("repro", RServer(r_get_model(rcfg), rp, batch_slots=2, cache_len=16), RRequest),
        ("port", TServer(get_model(tcfg, device=CPU), tp, batch_slots=2, cache_len=16), TRequest),
    ):
        for i, p in enumerate(prompts):
            srv.submit(Req(rid=i, prompt=p, max_new=5))
        done = srv.run_until_done()
        outs[name] = ({r.rid: r.out for r in done}, srv.steps_run)
    assert outs["port"] == outs["repro"] and len(outs["port"][0]) == 5


def test_make_batch_shapes():
    m = get_model(tconfigs.get(ARCH).reduce(), device=CPU)
    b = m.make_batch(dataclasses.replace(shape("train_4k"), seq_len=12, global_batch=3), torch.Generator().manual_seed(0))
    assert set(b) == {"frames", "tokens", "labels"}
    assert b["frames"].shape == (3, 16, 64) and b["frames"].dtype == torch.float32
    assert b["tokens"].shape == b["labels"].shape == (3, 12)
    assert 0.01 < float(b["frames"].std()) < 0.03
    loss = m.loss_fn(m.init(torch.Generator().manual_seed(1)), b)
    assert torch.isfinite(loss)
    dec = m.make_batch(dataclasses.replace(shape("decode_32k"), seq_len=8, global_batch=2), torch.Generator())
    assert dec["cache"]["enc_out"].shape == (2, 16, 64) and int(dec["cache"]["len"]) == 8


@pytest.mark.parametrize("reduced", [True, False])
def test_supports_matches_reference(reduced):
    rcfg, tcfg = rconfigs.get(ARCH), tconfigs.get(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduce(), tcfg.reduce()
    t, r = get_model(tcfg, device=CPU), r_get_model(rcfg)
    for s, ts in zip(RSHAPES, TSHAPES):
        assert t.supports(ts) == r.supports(s)
    assert not t.supports(shape("long_500k"))[0]


def test_full_config_parameter_count():
    m = get_model(tconfigs.get(ARCH), device=CPU)
    shapes = m.init_shapes()
    n = sum(t.numel() for t in tcommon.tree_leaves(shapes))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(r_get_model(rconfigs.get(ARCH)).init_shapes()))
    assert n == want == 1_535_349_760
    assert all(t.device.type == "meta" for t in tcommon.tree_leaves(shapes))


def test_launcher_runs_reduced_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                  "--max-new", "4", "--temperature", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[serve] no checkpoint — random weights (demo mode)"
    assert lines[-1].startswith("[serve] 3 requests, 12 tokens, ")


# ---------------------------------------------------------------------------
# the chip fixture
# ---------------------------------------------------------------------------


def _flat_params(prefix, params):
    return {f"{prefix}/params/" + "/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def reference_fixture():
    """What ``tests/data/torch_encdec_vlm_reduced.npz`` holds, under
    ``whisper/`` and ``pixtral/``: ``repro``'s parameters (``params/<path>``)
    of each config of :data:`FIXTURE_CFGS`; whisper's frames, tokens,
    float32 forward logits and the logits of 4 decode steps from a cache
    whose ``enc_out`` is ``encode(frames)`` (``len`` 0, 16 slots); pixtral's
    patches, tokens and forward logits (the patch rows included)."""
    out = {}
    name, kw = FIXTURE_CFGS["whisper"]
    cfg = rconfigs.get(name).reduce(**kw)
    params = rwhisper.init(cfg, jax.random.PRNGKey(27))
    rng = np.random.default_rng(27)
    frames = (rng.normal(size=(2, cfg.enc_seq, cfg.d_model)) * 0.5).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    logits, _ = rwhisper.forward(cfg, params, jnp.asarray(tokens), jnp.asarray(frames))
    cache = {**rwhisper.init_cache(cfg, 2, 16), "enc_out": rwhisper.encode(cfg, params, jnp.asarray(frames)),
             "len": jnp.zeros((), jnp.int32)}
    steps = []
    for t in range(FIXTURE_DECODE_STEPS):
        lg, cache = rwhisper.decode_step(cfg, params, cache, jnp.asarray(tokens[:, t]))
        steps.append(np.asarray(lg, np.float32))
    out.update(_flat_params("whisper", params))
    out.update({"whisper/frames": frames, "whisper/tokens": tokens, "whisper/logits": np.asarray(logits, np.float32),
                "whisper/decode": np.stack(steps, axis=1)})
    name, kw = FIXTURE_CFGS["pixtral"]
    cfg = rconfigs.get(name).reduce(**kw)
    params = rlm.init(cfg, jax.random.PRNGKey(28))
    rng = np.random.default_rng(28)
    patches = (rng.normal(size=(2, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    logits, _ = rlm.forward(cfg, params, jnp.asarray(tokens), patch_embeds=jnp.asarray(patches))
    out.update(_flat_params("pixtral", params))
    out.update({"pixtral/patches": patches, "pixtral/tokens": tokens, "pixtral/logits": np.asarray(logits, np.float32)})
    return out


def _unflatten(flat, prefix):
    tree = {}
    for key, a in flat.items():
        if key.startswith(prefix + "/params/"):
            *parents, leaf = key.split("/")[2:]
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
        if key.endswith(("logits", "decode")):
            np.testing.assert_allclose(stored[key], a, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(stored[key], a)
    assert FIXTURE.stat().st_size < 1_100_000
    # and the port computes the same logits from it
    name, kw = FIXTURE_CFGS["whisper"]
    cfg = tconfigs.get(name).reduce(**kw)
    params = params_from_reference(cfg, _unflatten(stored, "whisper"), device=CPU)
    frames = torch.from_numpy(stored["whisper/frames"])
    tokens = torch.from_numpy(stored["whisper/tokens"])
    close(twhisper.forward(cfg, params, tokens, frames)[0], stored["whisper/logits"])
    cache = twhisper.init_cache(cfg, 2, 16, fill_len=0, device=CPU)
    cache["enc_out"] = twhisper.encode(cfg, params, frames)
    for t in range(FIXTURE_DECODE_STEPS):
        lg, cache = twhisper.decode_step(cfg, params, cache, tokens[:, t])
        close(lg, stored["whisper/decode"][:, t])
    name, kw = FIXTURE_CFGS["pixtral"]
    cfg = tconfigs.get(name).reduce(**kw)
    assert cfg.hd == 160
    params = params_from_reference(cfg, _unflatten(stored, "pixtral"), device=CPU)
    got, _ = tlm.forward(cfg, params, torch.from_numpy(stored["pixtral/tokens"]),
                         patch_embeds=torch.from_numpy(stored["pixtral/patches"]))
    close(got, stored["pixtral/logits"])


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez(FIXTURE, **reference_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
