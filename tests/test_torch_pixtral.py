"""The port's pixtral (the ``vlm`` family: the decoder with patch embeddings
in front of the tokens) against the reference, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, where attention runs the kernel's plain
twin), at the reduced config (4 layers, d 64, head dim 16, 8 patches) and at
``reduce(head_dim=160)``, the full config's head dim, so that the twin runs
at D = 160 against the reference:

* ``forward`` with ``patch_embeds`` in float32 and bfloat16 activations, and
  without patches;
* ``loss_fn`` with ``patches`` (their logits dropped) and every gradient
  leaf against ``jax.value_and_grad``;
* ``decode_step`` over a ring wrap, ``init_cache``, the greedy ``Server``
  token for token;
* ``params_from_reference`` (the decoder's tree), ``make_batch``'s shapes
  (``patches [B, min(vision_tokens, T // 2), d]`` and ``T - Nv`` tokens),
  ``supports``, the full config's parameter count and head dim, the
  launcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
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
from repro_torch.models.config import shape
from repro_torch.models.interop import params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.serve.serve_loop import Request as TRequest
from repro_torch.serve.serve_loop import Server as TServer

CPU = torch.device("cpu")
ARCH = "pixtral-12b"
F32_TOL = 1e-4  # float32 through both packages: sums in another order
# bfloat16 activations: every matmul output, norm and residual add rounds to
# 8 significant bits, and the packages round at different places
BF16_TOL = 3e-2
# the reduced config, and the same at the full config's head dim (the kernel's D = 160)
HEAD_DIMS = {"hd16": {}, "hd160": {"head_dim": 160}}


def close(got, want, tol=F32_TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg, tcfg = rconfigs.get(ARCH).reduce(**overrides), tconfigs.get(ARCH).reduce(**overrides)
    rp = rlm.init(rcfg, jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, params_from_reference(tcfg, _np(rp), device=CPU)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _patches(cfg, B, seed, n=None):
    n = cfg.vision_tokens if n is None else n
    return (np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)) * 0.02).astype(np.float32)


@pytest.mark.parametrize("hd", list(HEAD_DIMS))
@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_forward_with_patches_matches_reference(hd, act_dtype):
    rcfg, tcfg, rp, tp = _pair(seed=1, act_dtype=act_dtype, **HEAD_DIMS[hd])
    assert tcfg.hd == (160 if hd == "hd160" else 16)
    toks, patches = _tokens(tcfg, 2, 11, seed=2), _patches(tcfg, 2, seed=3)
    fa.flash_attention.launches = 0
    got, aux = get_model(tcfg, device=CPU).forward(tp, torch.from_numpy(toks), patches=torch.from_numpy(patches))
    assert fa.flash_attention.launches == 0  # the CPU runs the twin
    want, want_aux = rlm.forward(rcfg, rp, jnp.asarray(toks), patch_embeds=jnp.asarray(patches))
    assert got.shape == (2, tcfg.vision_tokens + 11, tcfg.padded_vocab) and got.dtype == getattr(torch, act_dtype)
    close(got, want, F32_TOL if act_dtype == "float32" else BF16_TOL)
    close(aux, want_aux)


@pytest.mark.parametrize("hd", list(HEAD_DIMS))
def test_forward_without_patches_matches_reference(hd):
    rcfg, tcfg, rp, tp = _pair(seed=2, **HEAD_DIMS[hd])
    toks = _tokens(tcfg, 2, 9, seed=4)
    got, _ = tlm.forward(tcfg, tp, torch.from_numpy(toks))
    close(got, rlm.forward(rcfg, rp, jnp.asarray(toks))[0])


def _trainable(params):
    return tcommon.tree_map(lambda t: t.requires_grad_(True), params)


@pytest.mark.parametrize("hd", list(HEAD_DIMS))
def test_loss_with_patches_and_gradients_match_reference(hd):
    """The patches' logits are dropped before the loss; a padded vocabulary
    tail (500 of 512 ids live) and a loss mask; every gradient leaf within
    1e-4 of the leaf's largest gradient."""
    rcfg, tcfg, rp, tp = _pair(seed=3, vocab=500, **HEAD_DIMS[hd])
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, tcfg.vocab, (2, 10)).astype(np.int32) for k in ("tokens", "labels")}
    batch["patches"] = _patches(tcfg, 2, seed=5)
    batch["loss_mask"] = (rng.random((2, 10)) < 0.8).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss_fn(rcfg, p, b)))(rp, batch)
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


@pytest.mark.parametrize("hd", list(HEAD_DIMS))
def test_decode_matches_reference_through_a_ring_wrap(hd):
    """12 steps into 8 slots from an empty cache (the decoder's decode: no
    patches, no kernel)."""
    rcfg, tcfg, rp, tp = _pair(seed=4, **HEAD_DIMS[hd])
    toks = _tokens(tcfg, 2, 12, seed=7)
    tc = tlm.init_cache(tcfg, 2, 8, fill_len=0, device=CPU)
    rc = rlm.init_cache(rcfg, 2, 8, fill_len=0)
    step = jax.jit(lambda p, c, t: rlm.decode_step(rcfg, p, c, t))
    for t in range(12):
        got, tc = tlm.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        want, rc = step(rp, rc, jnp.asarray(toks[:, t]))
        close(got, want)
    for key in ("k", "v"):
        close(tc[key], rc[key])


def test_init_cache_matches_reference():
    for hd, kw in HEAD_DIMS.items():
        rcfg, tcfg = rconfigs.get(ARCH).reduce(**kw), tconfigs.get(ARCH).reduce(**kw)
        want = rlm.init_cache(rcfg, 3, 16)
        got = tlm.init_cache(tcfg, 3, 16, device=CPU)
        assert got.keys() == want.keys()
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, (hd, key)
        assert got["k"].shape[-1] == tcfg.hd and int(got["len"]) == 16


def test_server_matches_reference():
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


def test_params_are_the_decoders_tree():
    rcfg, tcfg, rp, tp = _pair(seed=5, head_dim=160)
    r = _np(rp)
    assert list(tp) == ["embed", "layers", "final_norm"]  # tied embedding: no head
    for i, layer in enumerate(tp["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(layer["attn"][name].numpy(), r["layers"]["attn"][name][i].T)
    assert tp["layers"][0]["attn"]["wq"].shape == (4 * 160, 64)
    own = tlm.init(tcfg, torch.Generator().manual_seed(0), CPU)
    assert {k: tuple(t.shape) for k, t in tcommon.tree_items(own)} == {
        k: tuple(t.shape) for k, t in tcommon.tree_items(tp)}


def test_make_batch_shapes():
    m = get_model(tconfigs.get(ARCH).reduce(), device=CPU)
    g = torch.Generator().manual_seed(0)
    for T, nv in ((12, 6), (40, 8)):  # min(vision_tokens, T // 2) patches, T - nv tokens
        b = m.make_batch(dataclasses.replace(shape("train_4k"), seq_len=T, global_batch=3), g)
        assert set(b) == {"patches", "tokens", "labels"}
        assert b["patches"].shape == (3, nv, 64) and b["patches"].dtype == torch.float32
        assert b["tokens"].shape == b["labels"].shape == (3, T - nv)
    assert 0.01 < float(b["patches"].std()) < 0.03
    logits, _ = m.forward(m.init(torch.Generator().manual_seed(1)), b["tokens"], patches=b["patches"])
    assert logits.shape == (3, 40, m.cfg.padded_vocab)
    assert torch.isfinite(m.loss_fn(m.init(torch.Generator().manual_seed(1)), b))


@pytest.mark.parametrize("reduced", [True, False])
def test_supports_matches_reference(reduced):
    rcfg, tcfg = rconfigs.get(ARCH), tconfigs.get(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduce(), tcfg.reduce()
    t, r = get_model(tcfg, device=CPU), r_get_model(rcfg)
    for s, ts in zip(RSHAPES, TSHAPES):
        assert t.supports(ts) == r.supports(s)
    assert not t.supports(shape("long_500k"))[0]


def test_full_config_parameter_count_and_head_dim():
    cfg = tconfigs.get(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab) == (
        40, 5120, 32, 8, 160, 14336, 131072)
    assert cfg.hd in fa.HEAD_DIMS and cfg.tie_embeddings
    m = get_model(cfg, device=CPU)
    shapes = m.init_shapes()
    n = sum(t.numel() for t in tcommon.tree_leaves(shapes))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(r_get_model(rconfigs.get(ARCH)).init_shapes()))
    assert n == want == 12_100_981_760


def test_launcher_runs_reduced_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                  "--max-new", "4", "--temperature", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[serve] no checkpoint — random weights (demo mode)"
    assert lines[-1].startswith("[serve] 3 requests, 12 tokens, ")
