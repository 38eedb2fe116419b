"""The port's rwkv6 (``ssm`` family) against the reference, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, float32, the reduced config: d 64, head
size 16), at rtol 1e-4 / atol 1e-5 unless a check names the reference's
own tolerance for it (``tests/test_models_smoke.py``):

* ``layernorm``;
* ``wkv6_chunked`` at chunk 16 and 1, T 48 and 37 (a padded tail), with and
  without a carried state, against the reference's and against the port's
  ``wkv6_step`` loop;
* ``timemix`` and ``channelmix`` with and without the state and shift
  carries;
* the reduced model: ``forward``, 8 ``decode_step``s from an empty cache and
  the cache they leave, ``loss_fn`` with every gradient leaf against
  ``jax.value_and_grad``, the greedy ``Server`` token for token;
  ``params_from_reference`` and the port's own ``init`` (the same tree);
  ``init_cache``'s shapes; the full config's parameter count through
  ``init_shapes``; ``supports`` at every shape; the launcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import common as rcommon
from repro.models import rwkv6 as rrwkv
from repro.models.config import SHAPES as RSHAPES
from repro.models.registry import get_model as r_get_model
from repro.serve.serve_loop import Request as RRequest
from repro.serve.serve_loop import Server as RServer

from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.interop import params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.serve.serve_loop import Request as TRequest
from repro_torch.serve.serve_loop import Server as TServer

CPU = torch.device("cpu")
ARCH = "rwkv6-3b"
RTOL, ATOL = 1e-4, 1e-5  # float32 through both packages: sums in another order
STEP_TOL = 3e-4  # chunked against stepwise (tests/test_models_smoke.py:72)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0):
    rcfg, tcfg = rconfigs.get(ARCH).reduce(), tconfigs.get(ARCH).reduce()
    rp = rrwkv.init(rcfg, jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, params_from_reference(tcfg, _np(rp), device=CPU)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _wkv_inputs(T, seed, B=2, H=2, hs=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, H, T, hs)).astype(np.float32) * 0.5 for _ in range(3))
    w = (1 / (1 + np.exp(-rng.normal(size=(B, H, T, hs)))) * 0.5 + 0.45).astype(np.float32)
    u = (rng.normal(size=(H, hs)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(B, H, hs, hs)) * 0.3).astype(np.float32)
    return r, k, v, w, u, s0


def test_layernorm_matches_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 64)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32), "bias": rng.normal(size=64).astype(np.float32)}
    got = tcommon.layernorm({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x))
    close(got, rcommon.layernorm({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x)))
    init = tcommon.layernorm_init(64, CPU)
    assert {k: (tuple(t.shape), t.dtype) for k, t in init.items()} == {
        k: (tuple(a.shape), torch.float32) for k, a in rcommon.layernorm_init(64).items()}
    bf = tcommon.layernorm(init, torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("chunk", [16, 1])
@pytest.mark.parametrize("T", [48, 37])
@pytest.mark.parametrize("carried", [False, True])
def test_wkv6_chunked_matches_reference(chunk, T, carried):
    r, k, v, w, u, s0 = _wkv_inputs(T, seed=T + chunk)
    s0 = s0 if carried else None
    want, want_s = rrwkv.wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                      s0=None if s0 is None else jnp.asarray(s0), chunk=chunk)
    t = [torch.from_numpy(a) for a in (r, k, v, w, u)]
    got, got_s = trwkv.wkv6_chunked(*t, s0=None if s0 is None else torch.from_numpy(s0), chunk=chunk)
    assert got.shape == (2, 2, T, 8) and got_s.dtype == torch.float32
    close(got, want)
    close(got_s, want_s)
    # and the port's per-timestep step, at the reference's chunked-against-stepwise tolerance
    s = torch.from_numpy(s0) if s0 is not None else torch.zeros((2, 2, 8, 8))
    outs = []
    for i in range(T):
        o, s = trwkv.wkv6_step(*(a[:, :, i] for a in t[:4]), t[4], s)
        outs.append(o)
    close(got, torch.stack(outs, 2), rtol=STEP_TOL, atol=STEP_TOL)
    close(got_s, s, rtol=STEP_TOL, atol=STEP_TOL)


def test_wkv6_chunked_keeps_the_activation_dtype():
    r, k, v, w, u, _ = _wkv_inputs(20, seed=3)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v, w, u)]
    out, s = trwkv.wkv6_chunked(*t, chunk=16)
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    f32, s32 = trwkv.wkv6_chunked(*(a.float() for a in t), chunk=16)
    close(out.float(), f32, rtol=3e-2, atol=3e-2)  # bf16 rounds the output and the bonus term


@pytest.mark.parametrize("carries", [False, True])
def test_timemix_and_channelmix_match_reference(carries):
    rcfg, tcfg, rp, tp = _pair(seed=2)
    hs, d = tcfg.rwkv_head_size, tcfg.d_model
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 21, d)).astype(np.float32)
    s = (rng.normal(size=(2, d // hs, hs, hs)) * 0.2).astype(np.float32) if carries else None
    xl = rng.normal(size=(2, d)).astype(np.float32) if carries else None
    jx = (lambda a: None if a is None else jnp.asarray(a))
    tx = (lambda a: None if a is None else torch.from_numpy(a))
    rl = jax.tree.map(lambda a: a[1], rp["layers"])
    tl = tp["layers"][1]
    want, want_s = rrwkv.timemix(rl["tmix"], jnp.asarray(x), hs, state=jx(s), x_last=jx(xl), chunk=tcfg.scan_chunk)
    got, got_s = trwkv.timemix(tl["tmix"], torch.from_numpy(x), hs, state=tx(s), x_last=tx(xl),
                               chunk=tcfg.scan_chunk)
    close(got, want)
    close(got_s, want_s)
    close(trwkv.channelmix(tl["cmix"], torch.from_numpy(x), x_last=tx(xl)),
          rrwkv.channelmix(rl["cmix"], jnp.asarray(x), x_last=jx(xl)))


def test_forward_matches_reference():
    rcfg, tcfg, rp, tp = _pair(seed=0)
    toks = _tokens(tcfg, 2, 37, seed=5)
    got, aux = trwkv.forward(tcfg, tp, torch.from_numpy(toks), window=8)  # window is taken and ignored
    want, want_aux = rrwkv.forward(rcfg, rp, jnp.asarray(toks))
    assert got.shape == (2, 37, tcfg.padded_vocab)
    close(got, want)
    close(aux, want_aux)


def test_decode_matches_reference():
    """8 steps from an empty cache, each step's logits and the cache they
    leave; the port's decode also follows its own forward (the reference's
    decode-against-forward tolerance, tests/test_models_smoke.py:85)."""
    rcfg, tcfg, rp, tp = _pair(seed=1)
    toks = _tokens(tcfg, 2, 8, seed=7)
    rc = rrwkv.init_cache(rcfg, 2, 0)
    tc = trwkv.init_cache(tcfg, 2, 0, device=CPU)
    step = jax.jit(lambda p, c, t: rrwkv.decode_step(rcfg, p, c, t))
    for t in range(8):
        got, tc = trwkv.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        want, rc = step(rp, rc, jnp.asarray(toks[:, t]))
        close(got, want)
    for key in ("s", "x_t", "x_c"):
        close(tc[key], rc[key])
    assert int(tc["len"]) == int(rc["len"]) == 8
    fwd, _ = trwkv.forward(tcfg, tp, torch.from_numpy(toks))
    close(got, fwd[:, -1], rtol=3e-3, atol=3e-3)


def _trainable(params):
    return tcommon.tree_map(lambda t: t.requires_grad_(True), params)


def test_loss_and_gradients_match_reference():
    rcfg, tcfg, rp, tp = _pair(seed=3)
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, tcfg.vocab, (2, 19)).astype(np.int32) for k in ("tokens", "labels")}
    batch["loss_mask"] = (rng.random((2, 19)) < 0.8).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: rrwkv.loss_fn(rcfg, p, b)))(rp, batch)
    tp = _trainable(tp)
    got = get_model(tcfg, device=CPU).loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    close(got, loss)
    want = dict(tcommon.tree_items(params_from_reference(tcfg, _np(grads), device=CPU)))
    have = dict(tcommon.tree_items(tcommon.tree_map(lambda p: p.grad, tp)))
    assert have.keys() == want.keys()
    for key, w in want.items():
        # the tied table sums the unembedding's gradient over every position
        # (entries up to ~3): the reference's chunked-against-stepwise tolerance
        tol = (STEP_TOL, STEP_TOL) if key == "embed/table" else (RTOL, ATOL)
        close(have[key], w.numpy(), *tol)


def test_server_matches_reference():
    """Greedy serving: 5 requests over 2 slots, the same tokens as
    ``repro``'s ``Server``."""
    rcfg, tcfg, rp, tp = _pair(seed=4)
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


def test_params_and_init_share_the_reference_tree():
    """``params_from_reference`` transposes the projections and keeps
    ``mu``, ``w0``, ``u`` and the layernorms; the port's own ``init`` gives
    the same tree, its leaves cast as drawn."""
    rcfg, tcfg, rp, tp = _pair(seed=5)
    rl = _np(rp["layers"])
    for i, layer in enumerate(tp["layers"]):
        for name in ("wr", "wk", "wv", "wg", "ww", "wo"):
            np.testing.assert_array_equal(layer["tmix"][name].numpy(), rl["tmix"][name][i].T)
        for name in ("wk", "wv", "wr"):
            np.testing.assert_array_equal(layer["cmix"][name].numpy(), rl["cmix"][name][i].T)
        for name in ("mu", "w0", "u"):
            np.testing.assert_array_equal(layer["tmix"][name].numpy(), rl["tmix"][name][i])
        np.testing.assert_array_equal(layer["tmix"]["ln_x"]["bias"].numpy(), rl["tmix"]["ln_x"]["bias"][i])
    shapes = {k: tuple(t.shape) for k, t in tcommon.tree_items(tp)}
    own = trwkv.init(tcfg, torch.Generator().manual_seed(0), CPU)
    assert {k: tuple(t.shape) for k, t in tcommon.tree_items(own)} == shapes
    bf = trwkv.init(tcfg, torch.Generator().manual_seed(0), CPU, dtype=torch.bfloat16)
    for (key, a), (_, b) in zip(tcommon.tree_items(own), tcommon.tree_items(bf)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b), key


def test_init_cache_matches_reference():
    rcfg, tcfg = rconfigs.get(ARCH).reduce(), tconfigs.get(ARCH).reduce()
    for cache_len in (16, 524288):
        want = rrwkv.init_cache(rcfg, 3, cache_len)
        got = trwkv.init_cache(tcfg, 3, cache_len, device=CPU)
        assert got.keys() == want.keys()
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, key
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
        assert int(got["len"]) == cache_len
    # the state does not grow with the context
    nbytes = [sum(t.numel() * t.element_size() for t in trwkv.init_cache(tcfg, 1, n, device=CPU).values())
              for n in (256, 524288)]
    assert nbytes[0] == nbytes[1]


def test_full_config_parameter_count():
    m = get_model(tconfigs.get(ARCH), device=CPU)
    shapes = m.init_shapes()
    n = sum(t.numel() for t in tcommon.tree_leaves(shapes))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(r_get_model(rconfigs.get(ARCH)).init_shapes()))
    assert n == want == 3_105_018_880
    assert all(t.device.type == "meta" for t in tcommon.tree_leaves(shapes))


@pytest.mark.parametrize("reduced", [True, False])
def test_supports_matches_reference(reduced):
    rcfg, tcfg = rconfigs.get(ARCH), tconfigs.get(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduce(), tcfg.reduce()
    t, r = get_model(tcfg, device=CPU), r_get_model(rcfg)
    for s, ts in zip(RSHAPES, TSHAPES):
        assert dataclasses.asdict(s) == dataclasses.asdict(ts)
        assert t.supports(ts) == r.supports(s)
    assert t.supports(TSHAPES[-1])[0] and TSHAPES[-1].name == "long_500k"


def test_launcher_runs_reduced_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                  "--max-new", "4", "--temperature", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[serve] no checkpoint — random weights (demo mode)"
    assert lines[-1].startswith("[serve] 3 requests, 12 tokens, ")
