"""The port's MoE family (llama4 scout and maverick) against the reference,
on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, float32, reduced configs: d 64, head dim
16; attention runs the kernel's plain twin).  The reference runs plainly,
as ``tests/test_models_smoke.py`` runs it:

* ``positions_scatter`` / ``positions_sort`` exactly, against the
  reference's and each other (E = 1, 4, 8, 128; one expert taking every
  token; N not a multiple of E);
* ``auto_dispatch``'s analytic answer over a grid of (N, E), both stores
  pointed at an empty ``tmp_path``;
* ``moe_apply`` at top-k 1 and 2, with and without the shared expert, at
  the default capacity and at ``capacity_factor=0.5`` (drops), under each
  dispatch; the router's top-k on ties (a zero router, bfloat16-rounded
  logits) expert for expert;
* reduced scout and maverick (and scout at top-2): ``forward``'s logits
  and aux, 8 ``decode_step``s, ``loss_fn`` with its aux terms and every
  gradient leaf against ``jax.value_and_grad``, one ``Trainer`` step from
  ``opt_state_from_reference``; ``params_from_reference`` on the MoE
  leaves; ``init(dtype=)``;
* the dispatch model's file across packages, the port's own install, the
  cache, an unreadable file raising;
* the launchers at the reduced scout config;
* ``tests/data/torch_moe_reduced.npz`` (``chip_smoke.py`` holds the CUDA
  kernel's forward against it) still equals what ``repro`` computes.

Regenerate the fixture with ``PYTHONPATH=src python tests/test_torch_moe.py``.
"""
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
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models.registry import get_model as r_get_model
from repro.train import optimizer as ropt

from repro_torch import configs as tconfigs
from repro_torch.costmodel import moe_profile as tprofile
from repro_torch.costmodel import store as tstore
from repro_torch.data.lm_data import StreamConfig
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.interop import opt_state_from_reference, params_from_reference
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import TrainConfig, Trainer

FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "torch_moe_reduced.npz"
CPU = torch.device("cpu")
F32_TOL = 1e-4  # tests/test_torch_lm.py: float32 through both packages
LOSS_RTOL = 1e-5  # tests/test_torch_train.py
GRAD_REL = 1e-4  # a leaf's max |delta| against its largest |gradient| (tests/test_torch_train.py)
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5  # tests/test_models_smoke.py:110, one MoE layer
MODELS = {
    "scout": ("llama4-scout-17b-a16e", {}),
    # 16 experts: decode's few tokens take the sort dispatch (E > 4·log2 N)
    "maverick": ("llama4-maverick-400b-a17b", {"moe_experts": 16}),
    # top-2 over GQA (jamba's router is top-2)
    "scout_top2": ("llama4-scout-17b-a16e", {"moe_top_k": 2, "n_kv_heads": 2}),
}


@pytest.fixture(autouse=True)
def empty_stores(tmp_path, monkeypatch):
    """Both packages' dispatch stores in an empty directory: ``auto``
    takes the analytic crossover unless a test installs a model."""
    store = tmp_path / "store"
    monkeypatch.setattr(tstore, "default_dir", lambda device=None: str(store))
    monkeypatch.setattr(rprofile, "load_dispatch_model",
                        functools.partial(rprofile.load_dispatch_model, str(store)))
    return store


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _layer_params(seed, d, f, E, shared):
    """``repro``'s ``moe_init`` and the port's layout of it."""
    rp = rmoe.moe_init(jax.random.PRNGKey(seed), d, f, E, shared)
    tp = {"router": torch.from_numpy(np.array(rp["router"]).T.copy()),
          **{n: torch.from_numpy(np.array(rp[n])) for n in ("wi", "wg", "wo")}}
    if shared:
        tp["shared"] = {n: torch.from_numpy(np.array(a).T.copy()) for n, a in rp["shared"].items()}
    return rp, tp


def _pair(case):
    name, kw = MODELS[case]
    rcfg = rconfigs.get(name).reduce(**kw)
    tcfg = tconfigs.get(name).reduce(**kw)
    rp = rlm.init(rcfg, jax.random.PRNGKey(len(case)))
    return rcfg, tcfg, rp


def _same_drops(got, want, slots):
    """Equal dropped counts out of ``slots`` (token, expert) pairs; the
    fractions within float32 rounding (XLA's mean multiplies by 1/N)."""
    assert round(float(got) * slots) == round(float(want) * slots), (float(got), float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)


def _tokens(cfg, B, T, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# dispatch positions
# ---------------------------------------------------------------------------

# (N, E, ids): a draw over E experts, or one expert taking every token
POSITION_CASES = {
    "e1": (37, 1, None),
    "e4": (64, 4, None),
    "e8_ragged": (101, 8, None),
    "e128": (1024, 128, None),
    "e128_ragged": (129, 128, None),
    "one_expert": (50, 8, 3),
    "one_expert_e128": (300, 128, 127),
}


@pytest.mark.parametrize("case", list(POSITION_CASES))
def test_positions_match_reference(case):
    n, e, only = POSITION_CASES[case]
    ids = np.full(n, only) if only is not None else np.random.default_rng(n).integers(0, e, n)
    want = np.asarray(rmoe.positions_scatter(jnp.asarray(ids.astype(np.int32)), e))
    np.testing.assert_array_equal(np.asarray(rmoe.positions_sort(jnp.asarray(ids.astype(np.int32)), e)), want)
    t = torch.from_numpy(ids.astype(np.int64))
    for fn in (tmoe.positions_scatter, tmoe.positions_sort):
        got = fn(t, e)
        assert got.dtype == torch.int64 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy(), want)
    if only is not None:
        np.testing.assert_array_equal(want, np.arange(n))


def test_auto_dispatch_analytic_matches_reference():
    grid = [(n, e) for n in (1, 2, 3, 16, 24, 100, 1024, 8192, 65536, 1 << 20)
            for e in (1, 4, 8, 16, 32, 64, 128, 256)]
    got = [tmoe.auto_dispatch(n, e, CPU) for n, e in grid]
    assert got == [rmoe.auto_dispatch(n, e) for n, e in grid]
    assert {"sort", "scatter"} == set(got)
    assert tmoe.auto_dispatch(8192, 16, CPU) == "scatter" and tmoe.auto_dispatch(8192, 128, CPU) == "sort"


# ---------------------------------------------------------------------------
# one MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_matches_reference(top_k, shared, capacity_factor):
    E = 4
    rp, tp = _layer_params(top_k * 10 + shared, 64, 128, E, shared)
    x = np.random.default_rng(top_k + 2 * shared).normal(size=(2, 24, 64)).astype(np.float32)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=capacity_factor)
    want, want_aux = rmoe.moe_apply(rp, jnp.asarray(x), **kw)
    drops = []
    for dispatch in ("auto", "sort", "scatter"):
        got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), dispatch=dispatch, **kw)
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_RTOL, atol=MOE_ATOL, err_msg=dispatch)
        _same_drops(aux["drop_fraction"], want_aux["drop_fraction"], 48 * top_k)
        for key in ("load_balance", "router_z"):
            np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), rtol=MOE_RTOL, atol=MOE_ATOL,
                                       err_msg=key)
        drops.append(float(aux["drop_fraction"]))
    if capacity_factor < 1:
        assert drops[0] > 0  # the case drops tokens


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("router", ["zero", "bf16_ties"])
def test_top_k_ties_match_reference(router, top_k):
    """Equal probabilities order experts by index, as ``jax.lax.top_k``
    does: a zero router (every token ties on every expert: all to expert 0,
    most dropped) and logits rounded to bfloat16 at 128 experts (many
    ties)."""
    E = 4 if router == "zero" else 128
    rp, tp = _layer_params(7, 64, 32, E, False)
    x = np.random.default_rng(3).normal(size=(1, 40, 64)).astype(np.float32)
    if router == "zero":
        rp = {**rp, "router": jnp.zeros_like(rp["router"])}
        tp = {**tp, "router": torch.zeros_like(tp["router"])}
    else:  # bf16 logits over 128 experts tie often: coarse weights make sure
        r = np.round(np.asarray(rp["router"]) * 64) / 64
        rp = {**rp, "router": jnp.asarray(r)}
        tp = {**tp, "router": torch.from_numpy(r.T.copy())}
        x = np.round(x * 2) / 2
    xb = x.reshape(-1, 64)
    logits = xb @ np.asarray(rp["router"])
    if router == "bf16_ties":
        assert len(np.unique(logits[0])) < E  # ties among a token's experts
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want_gates, want_experts = jax.lax.top_k(probs, top_k)
    _, _, gates, experts = tmoe.route(tp, torch.from_numpy(xb), top_k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(want_experts))
    np.testing.assert_allclose(gates.numpy(), np.asarray(want_gates), rtol=1e-6)
    if router == "zero":
        assert (experts[:, 0] == 0).all()
    kw = dict(n_experts=E, top_k=top_k)
    want, want_aux = rmoe.moe_apply(rp, jnp.asarray(x), **kw)
    for dispatch in ("sort", "scatter"):
        got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), dispatch=dispatch, **kw)
        _same_drops(aux["drop_fraction"], want_aux["drop_fraction"], 40 * top_k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MOE_RTOL, atol=MOE_ATOL)
    if router == "zero":  # each chosen expert keeps its capacity's tokens
        capacity = max(8, int(1.25 * 40 * top_k / E))
        _same_drops(want_aux["drop_fraction"], (40 - capacity) / 40, 40 * top_k)


def test_dropped_tokens_get_no_gradient():
    """A token past its expert's capacity gets no gradient through the
    experts (the reference zeroes it through ``where(keep, ...)``): with no
    shared expert its input's gradient is 0."""
    rp, tp = _layer_params(5, 16, 32, 2, False)
    tp = {**tp, "router": torch.zeros_like(tp["router"])}  # every token to expert 0
    x = torch.randn(1, 20, 16, generator=torch.Generator().manual_seed(0), requires_grad=True)
    out, aux = tmoe.moe_apply(tp, x, n_experts=2, capacity_factor=0.5)
    out.sum().backward()
    g = x.grad[0].abs().sum(dim=-1)
    _same_drops(aux["drop_fraction"], 12 / 20, 20)  # capacity max(8, 5)
    assert (g[:8] > 0).all() and (g[8:] == 0).all()


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MODELS))
def test_forward_matches_reference(case):
    rcfg, tcfg, rp = _pair(case)
    toks = _tokens(tcfg, 2, 20, seed=5)
    got, aux = tlm.forward(tcfg, params_from_reference(tcfg, _np(rp), device=CPU), torch.from_numpy(toks))
    want, want_aux = rlm.forward(rcfg, rp, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=F32_TOL, atol=F32_TOL)
    assert float(aux[0]) > 0 and float(aux[1]) > 0


@pytest.mark.parametrize("case", list(MODELS))
def test_decode_matches_reference(case):
    rcfg, tcfg, rp = _pair(case)
    tp = params_from_reference(tcfg, _np(rp), device=CPU)
    toks = _tokens(tcfg, 2, 8, seed=7)
    tc = tlm.init_cache(tcfg, 2, 16, fill_len=0, device=CPU)
    rc = rlm.init_cache(rcfg, 2, 16, fill_len=0)
    step = jax.jit(functools.partial(rlm.decode_step, rcfg))
    for t in range(8):
        got, tc = tlm.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, t]))
        want, rc = step(rp, rc, jnp.asarray(toks[:, t]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    # the port's own decode equals its forward where the forward drops no
    # token: the first row's 8 tokens rank first in every expert (capacity >= 8)
    fwd, _ = tlm.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got[0].numpy(), fwd[0, -1].numpy(), rtol=2e-3, atol=2e-3)


def _trainable(params):
    return tcommon.tree_map(lambda t: t.requires_grad_(True), params)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32) for k in ("tokens", "labels")}


def _close_leaves(got_tree, want_tree, rel):
    got, want = dict(tcommon.tree_items(got_tree)), dict(tcommon.tree_items(want_tree))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        err = float((got[key] - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-30, (key, err)


@pytest.mark.parametrize("case", list(MODELS))
def test_loss_and_gradients_match_reference(case):
    rcfg, tcfg, rp = _pair(case)
    batch = _batch(tcfg, seed=3)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss_fn(rcfg, p, b)))(rp, batch)
    _, want_aux = rlm.forward(rcfg, rp, jnp.asarray(batch["tokens"]))
    assert float(want_aux[0]) > 0  # the aux terms are in the loss
    tp = _trainable(params_from_reference(tcfg, _np(rp), device=CPU))
    got = get_model(tcfg, device=CPU).loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=LOSS_RTOL)
    _close_leaves(tcommon.tree_map(lambda p: p.grad, tp), params_from_reference(tcfg, _np(grads), device=CPU),
                  GRAD_REL)


@pytest.mark.parametrize("case", list(MODELS))
def test_trainer_step_matches_reference(case):
    """Two reference steps give (params, state); from there one ``Trainer``
    step and one reference step on the same batch agree: the loss, the
    metrics, every parameter and moment (the moments' history keeps a
    sign flip of a near-zero gradient from moving the update)."""
    rcfg, tcfg, rp = _pair(case)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    ocfg = ropt.OptConfig(**kw)

    @jax.jit
    def r_step(p, s, b):
        loss, g = jax.value_and_grad(lambda p: rlm.loss_fn(rcfg, p, b))(p)
        p, s, m = ropt.apply_updates(p, s, g, ocfg)
        return p, s, dict(m, loss=loss)

    p, s = rp, ropt.init_state(rp, ocfg)
    for seed in (0, 1):
        p, s, _ = r_step(p, s, _batch(rcfg, seed))
    t = Trainer(get_model(tcfg, device=CPU), TrainConfig(opt=topt.OptConfig(**kw)),
                StreamConfig(vocab=tcfg.vocab, global_batch=2, seq_len=12))
    t.params = _trainable(params_from_reference(tcfg, _np(p), device=CPU))
    t.opt_state = opt_state_from_reference(tcfg, _np(s), device=CPU)
    batch = _batch(rcfg, 2)
    p, s, want = r_step(p, s, batch)
    got = t.train_step({k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=LOSS_RTOL)
    for key in ("grad_norm", "lr", "param_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=F32_TOL, err_msg=key)
    # parameters at tests/test_torch_train.py's rule: rtol with an atol of
    # rtol × the leaf's largest entry
    want_p = params_from_reference(tcfg, _np(p), device=CPU)
    for (key, a), (_, b) in zip(tcommon.tree_items(t.params), tcommon.tree_items(want_p)):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=F32_TOL, atol=F32_TOL * float(b.abs().max()),
                                   err_msg=key)
    want_s = opt_state_from_reference(tcfg, _np(s), device=CPU)
    for part in ("m", "v"):
        _close_leaves(t.opt_state[part], want_s[part], GRAD_REL)
    assert int(t.opt_state["step"]) == int(s["step"]) == 3


def test_params_from_reference_maps_the_moe_leaves():
    """The router and the shared expert transposed to ``[d_out, d_in]``, the
    expert stacks copied in the reference's ``[E, d, f]`` / ``[E, f, d]``
    layout, in the parameters and in the optimizer's moments."""
    rcfg, tcfg, rp = _pair("maverick")
    rp = _np(rp)
    tp = params_from_reference(tcfg, rp, device=CPU)
    E, d, f = tcfg.moe_experts, tcfg.d_model, tcfg.d_ff
    shapes = {"router": (E, d), "wi": (E, d, f), "wg": (E, d, f), "wo": (E, f, d)}
    for i, layer in enumerate(tp["layers"]):
        assert "mlp" not in layer and layer.keys() == {"attn_norm", "mlp_norm", "attn", "moe"}
        moe, ref = layer["moe"], rp["layers"]["moe"]
        for n, shape in shapes.items():
            assert moe[n].shape == shape and moe[n].dtype == torch.float32
            want = ref[n][i].T if n == "router" else ref[n][i]
            np.testing.assert_array_equal(moe[n].numpy(), want)
        for n in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(moe["shared"][n].numpy(), ref["shared"][n][i].T)
    # the port's own init has the same tree and shapes
    own = tlm.init(tcfg, torch.Generator().manual_seed(0), CPU)
    assert [(k, t.shape) for k, t in tcommon.tree_items(own)] == [(k, t.shape) for k, t in tcommon.tree_items(tp)]
    state = opt_state_from_reference(tcfg, _np(ropt.init_state(rp, ropt.OptConfig())), device=CPU)
    assert [(k, t.shape) for k, t in tcommon.tree_items(state["m"])] == [(k, t.shape) for k, t in tcommon.tree_items(tp)]


def test_init_casts_each_leaf_as_drawn():
    """``init(dtype=bfloat16)`` equals the float32 init cast afterwards,
    leaf for leaf (the same draws), and the expert stacks keep the
    reference's scales."""
    cfg = tconfigs.get("llama4-maverick-400b-a17b").reduce(moe_experts=16)
    f32 = tlm.init(cfg, torch.Generator().manual_seed(4), CPU)
    bf16 = tlm.init(cfg, torch.Generator().manual_seed(4), CPU, dtype=torch.bfloat16)
    for (key, a), (_, b) in zip(tcommon.tree_items(f32), tcommon.tree_items(bf16)):
        assert b.dtype == torch.bfloat16, key
        assert torch.equal(a.to(torch.bfloat16), b), key
    moe = f32["layers"][0]["moe"]
    for n, scale in (("router", 0.02), ("wi", cfg.d_model ** -0.5), ("wg", cfg.d_model ** -0.5),
                     ("wo", cfg.d_ff ** -0.5)):
        assert abs(float(moe[n].std()) / scale - 1) < 0.05, n


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"])
def test_support_matrix_matches_reference(name):
    """Full attention: ``long_500k`` unsupported, the other shapes supported,
    as the reference answers (``tests/test_models_smoke.py:128``)."""
    t = get_model(tconfigs.get(name).reduce(), device=CPU)
    r = r_get_model(rconfigs.get(name).reduce())
    for s in TSHAPES:
        assert t.supports(s)[0] == r.supports(s)[0] == (s.name != "long_500k"), s.name


# ---------------------------------------------------------------------------
# the learned dispatch model
# ---------------------------------------------------------------------------

GRID = [(n, e) for n in (4, 64, 256, 1000, 4096, 1 << 16) for e in (2, 4, 16, 64, 128)]


def test_reference_dispatch_file_loads_in_the_port(tmp_path, empty_stores):
    """A ``moe_dispatch.npz`` written by the reference's ``install_dispatch``
    loads in the port and chooses as the reference does; ``auto_dispatch``
    consults it through the device's store."""
    want = rprofile.install_dispatch(str(empty_stores), token_counts=(64, 1024), expert_counts=(4, 64), repeats=1)
    got = tprofile.load_dispatch_model(device=CPU)
    assert got is not None and set(got.models) == {"sort", "scatter"}
    choices = [got.choose(n, e) for n, e in GRID]
    assert choices == [want.choose(n, e) for n, e in GRID]
    assert [tmoe.auto_dispatch(n, e, CPU) for n, e in GRID] == choices
    assert [rmoe.auto_dispatch(n, e) for n, e in GRID] == choices


def test_port_install_round_trips_and_refreshes(tmp_path, empty_stores):
    kw = dict(token_counts=(64, 1024), expert_counts=(4, 64), repeats=1)
    rows = tprofile.profile_dispatch(device=CPU, **kw)
    assert [(s, n, e) for s, n, e, _ in rows] == [(s, n, e) for n in (64, 1024) for e in (4, 64)
                                                  for s in ("sort", "scatter")]
    assert all(sec > 0 for *_, sec in rows)
    model = tprofile.install_dispatch(device=CPU, **kw)
    path = empty_stores / "moe_dispatch.npz"
    assert path.exists()
    loaded = tprofile.load_dispatch_model(device=CPU)
    assert loaded is model  # cached at install
    assert [loaded.choose(n, e) for n, e in GRID] == [model.choose(n, e) for n, e in GRID]
    # a fresh read (another process) and the reference read the same file alike
    tprofile._CACHE.clear()
    fresh = tprofile.load_dispatch_model(device=CPU)
    assert fresh is not model and tprofile.load_dispatch_model(device=CPU) is fresh
    ref = rprofile.load_dispatch_model()  # pointed at the store
    assert [fresh.choose(n, e) for n, e in GRID] == [ref.choose(n, e) for n, e in GRID] \
        == [model.choose(n, e) for n, e in GRID]
    # a reinstall replaces the cached model
    again = tprofile.install_dispatch(device=CPU, **kw)
    assert tprofile.load_dispatch_model(device=CPU) is again


def test_install_replaces_the_file_whole(empty_stores, monkeypatch):
    """``install_dispatch`` renames a finished file onto the store's: a write
    that fails midway leaves the installed file as it was, readable, and no
    temporary file beside it."""
    kw = dict(token_counts=(64, 1024), expert_counts=(4, 64), repeats=1)
    first = tprofile.install_dispatch(device=CPU, **kw)
    path = empty_stores / "moe_dispatch.npz"
    before = path.read_bytes()

    def torn(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    with monkeypatch.context() as m, pytest.raises(OSError, match="disk full"):
        m.setattr(tprofile.np, "savez", torn)
        tprofile.install_dispatch(device=CPU, **kw)
    assert path.read_bytes() == before
    assert [p.name for p in empty_stores.iterdir()] == ["moe_dispatch.npz"]
    assert tprofile.load_dispatch_model(device=CPU) is first
    tprofile._CACHE.clear()
    fresh = tprofile.load_dispatch_model(device=CPU)
    assert [fresh.choose(n, e) for n, e in GRID] == [first.choose(n, e) for n, e in GRID]


def test_unreadable_dispatch_file_raises(empty_stores):
    """A file that exists but cannot be read raises, in ``auto_dispatch``
    too; only a missing file falls back to the analytic choice."""
    assert tprofile.load_dispatch_model(device=CPU) is None
    empty_stores.mkdir(parents=True)
    (empty_stores / "moe_dispatch.npz").write_bytes(b"not an npz")
    with pytest.raises(ValueError, match="cannot be read"):
        tprofile.load_dispatch_model(device=CPU)
    with pytest.raises(ValueError, match="cannot be read"):
        tmoe.auto_dispatch(8192, 16, CPU)
    np.savez(empty_stores / "moe_dispatch.npz", **{"sort::k": np.int64(4)})  # no scatter model
    with pytest.raises(ValueError, match="cannot be read"):
        tprofile.load_dispatch_model(device=CPU)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_launchers_run_reduced_scout(tmp_path, capsys):
    arch = "llama4-scout-17b-a16e"
    d = str(tmp_path / "ck")
    ttrain.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3", "--global-batch", "2",
                 "--seq-len", "16", "--ckpt-dir", d])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"[launch.train] {arch} from step 0" and out[1].startswith("step      0  loss ")
    assert np.isfinite(float(out[1].split()[3]))
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--requests", "3", "--slots", "2",
                 "--max-new", "4", "--ckpt-dir", d])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"[serve] restored step 3 from {d}"
    assert out[-1].startswith("[serve] 3 requests, 12 tokens, ")


# ---------------------------------------------------------------------------
# the chip fixture
# ---------------------------------------------------------------------------


def reference_fixture():
    """What ``tests/data/torch_moe_reduced.npz`` holds, made as
    ``tests/data/torch_lm_reduced.npz`` is: ``repro``'s reduced scout (2
    layers, 2 KV heads; its parameters under ``params/<path>``), a token
    batch and ``repro``'s float32 forward logits and aux."""
    cfg = rconfigs.get("llama4-scout-17b-a16e").reduce(n_layers=2, n_kv_heads=2)
    params = rlm.init(cfg, jax.random.PRNGKey(25))
    tokens = np.random.default_rng(25).integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    logits, aux = rlm.forward(cfg, params, jnp.asarray(tokens))
    out = {"tokens": tokens, "logits": np.asarray(logits, np.float32), "aux": np.asarray(aux, np.float32)}
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
        if key in ("logits", "aux"):
            np.testing.assert_allclose(stored[key], a, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(stored[key], a)
    assert FIXTURE.stat().st_size < 1_400_000
    # and the port computes the same logits from it
    cfg = tconfigs.get("llama4-scout-17b-a16e").reduce(n_layers=2, n_kv_heads=2)
    got, aux = tlm.forward(cfg, params_from_reference(cfg, _unflatten(stored), device=CPU),
                           torch.from_numpy(stored["tokens"]))
    np.testing.assert_allclose(got.numpy(), stored["logits"], rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(aux.numpy(), stored["aux"], rtol=F32_TOL, atol=F32_TOL)


if __name__ == "__main__":
    FIXTURE.parent.mkdir(exist_ok=True)
    np.savez(FIXTURE, **reference_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)", file=sys.stderr)
