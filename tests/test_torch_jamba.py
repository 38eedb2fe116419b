"""The port's jamba (``hybrid`` family) against the reference, on the CPU,
and the chip fixture of the recurrent families.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, float32, the reduced config: d 64, 2
periods of 4 sub-layers, 4 experts top-2; the scan runs its plain twin,
attention the kernel's twin), at rtol 1e-4 / atol 1e-5 unless a check
names the reference's own tolerance for it:

* the period's layout (attention at ``period // 2``, MoE at odd positions)
  and ``n_periods``' check;
* ``forward``, also with ``window=8`` at T = 40; 8 ``decode_step``s from an
  empty cache and one at ``len = 40,000`` (a ring of ``long_window``
  slots), the caches they leave; ``loss_fn`` and every gradient leaf
  against ``jax.value_and_grad`` (a remat period a ``torch.utils
  .checkpoint``); the greedy ``Server``; ``init_cache``'s shapes with the
  ``long_window`` cut; the full config's parameter count through
  ``init_shapes``; ``supports`` at every shape; the launcher;
* ``tests/data/torch_recurrent_reduced.npz`` (``chip_smoke.py`` holds the
  card path against it) still equals what ``repro`` computes.

Both packages' MoE dispatch stores point at an empty directory, so the
dispatch is the analytic crossover (as ``tests/test_torch_moe.py`` pins it).
Regenerate the fixture with ``PYTHONPATH=src python tests/test_torch_jamba.py``.
"""
import dataclasses
import functools
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.costmodel import moe_profile as rprofile
from repro.models import jamba as rjamba
from repro.models import rwkv6 as rrwkv
from repro.models.config import SHAPES as RSHAPES
from repro.models.registry import get_model as r_get_model
from repro.serve.serve_loop import Request as RRequest
from repro.serve.serve_loop import Server as RServer

from repro_torch import configs as tconfigs
from repro_torch.costmodel import store as tstore
from repro_torch.launch import serve as tlaunch
from repro_torch.models import common as tcommon
from repro_torch.models import jamba as tjamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.interop import params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.serve.serve_loop import Request as TRequest
from repro_torch.serve.serve_loop import Server as TServer

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "torch_recurrent_reduced.npz"
CPU = torch.device("cpu")
ARCH = "jamba-1.5-large-398b"
RTOL, ATOL = 1e-4, 1e-5
LONG = 40_000  # a cache past 32,768 tokens: the attention keeps long_window slots


@pytest.fixture(autouse=True)
def empty_stores(tmp_path, monkeypatch):
    """Both packages' dispatch stores in an empty directory: ``auto`` takes
    the analytic crossover."""
    store = tmp_path / "store"
    monkeypatch.setattr(tstore, "default_dir", lambda device=None: str(store))
    monkeypatch.setattr(rprofile, "load_dispatch_model",
                        functools.partial(rprofile.load_dispatch_model, str(store)))
    return store


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seed=0, **kw):
    rcfg, tcfg = rconfigs.get(ARCH).reduce(**kw), tconfigs.get(ARCH).reduce(**kw)
    rp = rjamba.init(rcfg, jax.random.PRNGKey(seed))
    return rcfg, tcfg, rp, params_from_reference(tcfg, _np(rp), device=CPU)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


def test_period_layout_and_n_periods():
    rcfg, tcfg, rp, tp = _pair()
    assert len(tp["periods"]) == tjamba.n_periods(tcfg) == rjamba.n_periods(rcfg) == 2
    n = tcfg.attn_period
    for period in tp["periods"]:
        assert list(period) == [f"sub{i}" for i in range(n)]
        for i in range(n):
            sub, rsub = period[f"sub{i}"], rp["periods"][f"sub{i}"]
            assert ("attn" in sub) == (i == n // 2) == ("attn" in rsub)
            assert ("mamba" in sub) == (i != n // 2) == ("mamba" in rsub)
            assert ("moe" in sub) == (i % 2 == 1) == ("moe" in rsub)
            assert "shared" not in sub.get("moe", {})
    bad = dataclasses.replace(tcfg, n_layers=6)
    with pytest.raises(ValueError, match="attn_period"):
        tjamba.n_periods(bad)
    with pytest.raises(AssertionError):
        rjamba.n_periods(dataclasses.replace(rcfg, n_layers=6))


def test_params_and_init_share_the_reference_tree():
    """Mamba's projections transposed and its conv, ``dt_bias``, ``A_log``
    and ``D`` kept; the expert stacks kept and the router transposed; the
    port's own ``init`` gives the same tree, its leaves cast as drawn."""
    rcfg, tcfg, rp, tp = _pair(seed=1)
    rpp = _np(rp["periods"])
    for p, period in enumerate(tp["periods"]):
        m, rm = period["sub0"]["mamba"], rpp["sub0"]["mamba"]
        for name in ("in_proj", "x_proj", "dt_proj", "out_proj"):
            np.testing.assert_array_equal(m[name].numpy(), rm[name][p].T)
        for name in ("conv_w", "conv_b", "dt_bias", "A_log", "D"):
            np.testing.assert_array_equal(m[name].numpy(), rm[name][p])
        moe, rmoe = period["sub1"]["moe"], rpp["sub1"]["moe"]
        np.testing.assert_array_equal(moe["router"].numpy(), rmoe["router"][p].T)
        for name in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(moe[name].numpy(), rmoe[name][p])
            np.testing.assert_array_equal(period["sub2"]["mlp"][name].numpy(), rpp["sub2"]["mlp"][name][p].T)
    shapes = {k: tuple(t.shape) for k, t in tcommon.tree_items(tp)}
    own = tjamba.init(tcfg, torch.Generator().manual_seed(0), CPU)
    assert {k: tuple(t.shape) for k, t in tcommon.tree_items(own)} == shapes
    bf = tjamba.init(tcfg, torch.Generator().manual_seed(0), CPU, dtype=torch.bfloat16)
    for (key, a), (_, b) in zip(tcommon.tree_items(own), tcommon.tree_items(bf)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.to(torch.bfloat16), b), key


@pytest.mark.parametrize("T, window", [(20, 0), (40, 8)])
def test_forward_matches_reference(T, window):
    rcfg, tcfg, rp, tp = _pair(seed=2)
    toks = _tokens(tcfg, 2, T, seed=T)
    got, aux = tjamba.forward(tcfg, tp, torch.from_numpy(toks), window=window)
    want, want_aux = rjamba.forward(rcfg, rp, jnp.asarray(toks), window=window)
    assert got.shape == (2, T, tcfg.padded_vocab)
    close(got, want)
    close(aux, want_aux)


def _decode_pair(rcfg, tcfg, rp, tp, toks, cache_len, fill):
    """Each step's logits of both packages from a cache of ``cache_len``
    slots holding ``fill`` tokens."""
    rc = dict(rjamba.init_cache(rcfg, toks.shape[0], cache_len), len=jnp.int32(fill))
    tc = tjamba.init_cache(tcfg, toks.shape[0], cache_len, fill_len=fill, device=CPU)
    step = jax.jit(lambda p, c, t: rjamba.decode_step(rcfg, p, c, t))
    got, want = [], []
    for t in range(toks.shape[1]):
        g, tc = tjamba.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        w, rc = step(rp, rc, jnp.asarray(toks[:, t]))
        got.append(g)
        want.append(w)
    return got, want, tc, rc


def test_decode_matches_reference():
    """8 steps from an empty cache: each step's logits, and the ring, conv
    tails and scan states they leave; the port's decode follows its own
    forward at the reference's decode-against-forward tolerance
    (tests/test_models_smoke.py:85) on the first row, whose 8 tokens rank
    first in every expert and so are never dropped (capacity 10)."""
    rcfg, tcfg, rp, tp = _pair(seed=3)
    toks = _tokens(tcfg, 2, 8, seed=7)
    got, want, tc, rc = _decode_pair(rcfg, tcfg, rp, tp, toks, 16, 0)
    for g, w in zip(got, want):
        close(g, w)
    for key in ("k", "v", "conv", "h"):
        close(tc[key], rc[key])
    assert int(tc["len"]) == int(rc["len"]) == 8
    fwd, _ = tjamba.forward(tcfg, tp, torch.from_numpy(toks))
    for t in range(8):
        close(got[t][0], fwd[0, t], rtol=3e-3, atol=3e-3)


def test_decode_at_a_long_context_matches_reference():
    """Steps at ``len = 40,000``: the attention ring holds ``long_window``
    slots, written at ``len % M``, all of them live."""
    rcfg, tcfg, rp, tp = _pair(seed=4)
    toks = _tokens(tcfg, 2, 3, seed=8)
    got, want, tc, rc = _decode_pair(rcfg, tcfg, rp, tp, toks, LONG, LONG)
    assert tc["k"].shape[3] == tcfg.long_window == 64
    for g, w in zip(got, want):
        close(g, w)
    close(tc["k"], rc["k"])
    slot = LONG % tcfg.long_window
    assert bool(tc["k"][:, :, :, slot:slot + 3].abs().sum(-1).gt(0).all())


def _trainable(params):
    return tcommon.tree_map(lambda t: t.requires_grad_(True), params)


def test_loss_and_gradients_match_reference():
    rcfg, tcfg, rp, tp = _pair(seed=5)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, tcfg.vocab, (2, 13)).astype(np.int32) for k in ("tokens", "labels")}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: rjamba.loss_fn(rcfg, p, b)))(rp, batch)
    tp = _trainable(tp)
    got = get_model(tcfg, device=CPU).loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    close(got, loss)
    want = dict(tcommon.tree_items(params_from_reference(tcfg, _np(grads), device=CPU)))
    have = dict(tcommon.tree_items(tcommon.tree_map(lambda p: p.grad, tp)))
    assert have.keys() == want.keys()
    for key, w in want.items():
        close(have[key], w.numpy())


def test_server_matches_reference():
    """Greedy serving: 5 requests over 2 slots, the same tokens as
    ``repro``'s ``Server``."""
    rcfg, tcfg, rp, tp = _pair(seed=6)
    prompts = [[1 + i % 7, 2, 3 + i] for i in range(5)]
    outs = {}
    for name, srv, Req in (
        ("repro", RServer(r_get_model(rcfg), rp, batch_slots=2, cache_len=16), RRequest),
        ("port", TServer(get_model(tcfg, device=CPU), tp, batch_slots=2, cache_len=16), TRequest),
    ):
        for i, p in enumerate(prompts):
            srv.submit(Req(rid=i, prompt=p, max_new=4))
        done = srv.run_until_done()
        outs[name] = ({r.rid: r.out for r in done}, srv.steps_run)
    assert outs["port"] == outs["repro"] and len(outs["port"][0]) == 5


@pytest.mark.parametrize("cache_len", [16, LONG])
def test_init_cache_matches_reference(cache_len):
    rcfg, tcfg = rconfigs.get(ARCH).reduce(), tconfigs.get(ARCH).reduce()
    want = rjamba.init_cache(rcfg, 3, cache_len)
    got = tjamba.init_cache(tcfg, 3, cache_len, device=CPU)
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
    assert got["k"].shape[3] == (tcfg.long_window if cache_len > 32768 else cache_len)
    assert int(got["len"]) == cache_len


@pytest.mark.parametrize("arch, want", [(ARCH, 398_018_240_512), ("rwkv6-3b", 3_105_018_880)])
def test_full_config_parameter_count(arch, want):
    m = get_model(tconfigs.get(arch), device=CPU)
    n = sum(t.numel() for t in tcommon.tree_leaves(m.init_shapes()))
    r = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(r_get_model(rconfigs.get(arch)).init_shapes()))
    assert n == r == want


@pytest.mark.parametrize("reduced", [True, False])
def test_supports_matches_reference(reduced):
    rcfg, tcfg = rconfigs.get(ARCH), tconfigs.get(ARCH)
    if reduced:
        rcfg, tcfg = rcfg.reduce(), tcfg.reduce()
    t, r = get_model(tcfg, device=CPU), r_get_model(rcfg)
    for s, ts in zip(RSHAPES, TSHAPES):
        assert t.supports(ts) == r.supports(s)
    assert t.supports(TSHAPES[-1])[0] and TSHAPES[-1].name == "long_500k"


def test_launcher_runs_reduced_on_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                  "--max-new", "4", "--temperature", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[serve] no checkpoint — random weights (demo mode)"
    assert lines[-1].startswith("[serve] 3 requests, 12 tokens, ")


# ---------------------------------------------------------------------------
# the chip fixture
# ---------------------------------------------------------------------------

# the fixture's configs: the reduced configs at d 32 (jamba with 2 KV heads:
# GQA in the kernel; one period), small enough to keep the file < 1.4 MB
FIXTURE_CFGS = {
    "rwkv": ("rwkv6-3b", rrwkv, trwkv, dict(d_model=32, n_layers=2)),
    "jamba": (ARCH, rjamba, tjamba, dict(d_model=32, n_layers=4, n_kv_heads=2)),
}
FIXTURE_STEPS = 8


def fixture_config(family, package="repro"):
    name, _, _, kw = FIXTURE_CFGS[family]
    return (rconfigs if package == "repro" else tconfigs).get(name).reduce(**kw)


def reference_fixture():
    """What ``tests/data/torch_recurrent_reduced.npz`` holds, per family
    (``rwkv/...``, ``jamba/...``): ``repro``'s parameters under
    ``<family>/params/<path>``, a token batch, the float32 forward logits,
    and the logits of 8 decode steps over the batch's first tokens from an
    empty cache (``decode_empty``) and from one past 32,768 tokens
    (``decode_long``)."""
    out = {}
    for family, (_, rmod, _, _) in FIXTURE_CFGS.items():
        cfg = fixture_config(family)
        params = rmod.init(cfg, jax.random.PRNGKey(26))
        tokens = np.random.default_rng(26).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
        out[f"{family}/tokens"] = tokens
        out[f"{family}/logits"] = np.asarray(rmod.forward(cfg, params, jnp.asarray(tokens))[0], np.float32)
        step = jax.jit(lambda p, c, t, cfg=cfg, rmod=rmod: rmod.decode_step(cfg, p, c, t))
        for label, fill in (("empty", 0), ("long", LONG)):
            cache = dict(rmod.init_cache(cfg, 2, max(fill, 16)), len=jnp.int32(fill))
            logits = []
            for t in range(FIXTURE_STEPS):
                lg, cache = step(params, cache, jnp.asarray(tokens[:, t]))
                logits.append(np.asarray(lg, np.float32))
            out[f"{family}/decode_{label}"] = np.stack(logits, 1)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{family}/params/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    return out


def unflatten(flat, family):
    tree = {}
    for key, a in flat.items():
        if key.startswith(f"{family}/params/"):
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
        if "/params/" in key or key.endswith("/tokens"):
            np.testing.assert_array_equal(stored[key], a)
        else:
            np.testing.assert_allclose(stored[key], a, rtol=1e-5, atol=1e-5)
    assert FIXTURE.stat().st_size < 1_400_000
    # and the port computes the same logits from it
    for family, (_, _, tmod, _) in FIXTURE_CFGS.items():
        cfg = fixture_config(family, "port")
        params = params_from_reference(cfg, unflatten(stored, family), device=CPU)
        tokens = torch.from_numpy(stored[f"{family}/tokens"])
        close(tmod.forward(cfg, params, tokens)[0], stored[f"{family}/logits"])
        for label, fill in (("empty", 0), ("long", LONG)):
            cache = tmod.init_cache(cfg, 2, max(fill, 16), fill_len=fill, device=CPU)
            for t in range(FIXTURE_STEPS):
                lg, cache = tmod.decode_step(cfg, params, cache, tokens[:, t])
                close(lg, stored[f"{family}/decode_{label}"][:, t])


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez_compressed(FIXTURE, **reference_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
