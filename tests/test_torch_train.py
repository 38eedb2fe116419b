"""The port's LM training path against the reference, on the CPU.

The same numpy inputs (made from a seed) go through ``repro`` and
``repro_torch`` (``device="cpu"``, float32; attention's forward runs the
kernel's plain twin, its backward the reference's plain route):

* ``Model.loss_fn`` and every gradient leaf against
  ``jax.value_and_grad(repro's loss_fn)`` through ``params_from_reference``
  (reduced llama3.2-3b with 2 KV heads and a padded vocabulary, reduced
  qwen1.5-0.5b with QKV biases and a loss mask); remat on against off, bit
  for bit, with the forward called again a period in the backward;
* ``FlashAttentionFn``'s ``dq``, ``dk``, ``dv`` against autograd through
  ``repro.kernels.ref.flash_attention`` (GQA, MQA, a window, Tq < Tk, rows
  that see no key, above 2,048 keys, where the chunked route runs, whisper's
  non-causal cross attention and pixtral's head dim 160);
* ``loss_fn`` with patch embeddings in front of the tokens (pixtral's
  batch) against the reference's, every gradient leaf;
* ``schedule``, ``compress_grads`` and three ``apply_updates`` steps against
  ``repro.train.optimizer`` from one state (``opt_state_from_reference``),
  float32 and bfloat16 moments, with compression; the compressed update in
  place against the plain update fed ``compress_grads``;
* the checkpoint: atomic, retained, bf16 round trip, a partial ``like``, a
  shape mismatch, ``AsyncSaver``;
* the ``Trainer`` against ``repro``'s over 5 steps from one init, fed the
  reference's batches; restart equality; the loss falling; the launchers,
  and their checkpoint directories under TMPDIR by default.
"""
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data.lm_data import StreamConfig as RStreamConfig
from repro.data.lm_data import batch_at as r_batch_at
from repro.kernels import ref as rref
from repro.models import lm as rlm
from repro.models.registry import get_model as r_get_model
from repro.train import optimizer as ropt
from repro.train.train_loop import TrainConfig as RTrainConfig
from repro.train.train_loop import Trainer as RTrainer

from repro_torch import configs as tconfigs
from repro_torch.data.lm_data import StreamConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.interop import opt_state_from_reference, params_from_reference
from repro_torch.models.registry import get_model, get_model_by_name
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_loop import SimulatedFailure, TrainConfig, Trainer

CPU = torch.device("cpu")
LOSS_RTOL = 1e-5  # float32 through both packages: sums in another order
GRAD_REL = 1e-4  # a leaf's max |delta| against its largest |gradient|
OPT_RTOL = 1e-6
MODELS = {
    # GQA and a padded vocabulary tail (500 of 512 ids live)
    "llama_gqa": ("llama3.2-3b", {"n_kv_heads": 2, "vocab": 500}),
    # QKV bias, and a loss mask
    "qwen_bias": ("qwen1.5-0.5b", {}),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference_params(cfg, seed):
    """``repro``'s parameters with random QKV biases (its init zeroes them)."""
    params = rlm.init(cfg, jax.random.PRNGKey(seed))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = dict(params["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(size=attn[name].shape).astype(np.float32) * 0.1)
        params = {**params, "layers": {**params["layers"], "attn": attn}}
    return params


def _pair(case, **overrides):
    name, kw = MODELS[case]
    rcfg = rconfigs.get(name).reduce(**kw, **overrides)
    tcfg = tconfigs.get(name).reduce(**kw, **overrides)
    return rcfg, tcfg, _reference_params(rcfg, seed=len(name))


def _batch(cfg, B, T, seed, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, T)) < 0.7).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _trainable(params):
    return tcommon.tree_map(lambda t: t.requires_grad_(True), params)


def _close_leaves(got_tree, want_tree, rel):
    """Every leaf's max |got - want| within ``rel`` of the leaf's max |want|."""
    got, want = dict(tcommon.tree_items(got_tree)), dict(tcommon.tree_items(want_tree))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        scale = float(w.abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * scale + 1e-30, (key, err, scale)


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MODELS))
def test_loss_and_gradients_match_reference(case):
    rcfg, tcfg, rp = _pair(case)
    batch = _batch(tcfg, 2, 12, seed=3, mask=case == "qwen_bias")
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss_fn(rcfg, p, b)))(rp, batch)
    model = get_model(tcfg, device=CPU)
    tp = _trainable(params_from_reference(tcfg, _np(rp), device=CPU))
    got = model.loss_fn(tp, _torch_batch(batch))
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=LOSS_RTOL)
    _close_leaves(tcommon.tree_map(lambda p: p.grad, tp), params_from_reference(tcfg, _np(grads), device=CPU), GRAD_REL)


@pytest.mark.parametrize("period", [1, 2])
def test_remat_gradients_equal_no_remat_bitwise(period, monkeypatch):
    """Each checkpointed period calls the attention forward again during the
    backward (a second kernel launch on the card)."""
    _, tcfg, rp = _pair("llama_gqa", remat_period=period)
    batch = _torch_batch(_batch(tcfg, 2, 10, seed=4))
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def grads(remat):
        tp = _trainable(params_from_reference(tcfg, _np(rp), device=CPU))
        logits, _ = tlm.forward(tcfg, tp, batch["tokens"], remat=remat)
        live = torch.arange(tcfg.padded_vocab) < tcfg.vocab
        loss = tcommon.cross_entropy(torch.where(live, logits, -1e30), batch["labels"])
        calls.clear()
        loss.backward()
        return loss, len(calls), tcommon.tree_map(lambda p: p.grad, tp)

    l1, n1, g1 = grads(True)
    l0, n0, g0 = grads(False)
    assert (n1, n0) == (tcfg.n_layers, 0)
    assert torch.equal(l1, l0)
    for (key, a), (_, b) in zip(tcommon.tree_items(g1), tcommon.tree_items(g0)):
        assert torch.equal(a, b), key


def test_loss_fn_with_patches_matches_reference():
    """Patch embeddings in front of the tokens (pixtral's batch, here on the
    reduced llama): the loss over the token positions and every gradient
    leaf against ``jax.value_and_grad``."""
    rcfg, tcfg, rp = _pair("llama_gqa")
    b = _batch(tcfg, 2, 6, seed=0, mask=True)
    b["patches"] = (np.random.default_rng(1).normal(size=(2, 3, tcfg.d_model)) * 0.02).astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, x: rlm.loss_fn(rcfg, p, x)))(rp, b)
    tp = _trainable(params_from_reference(tcfg, _np(rp), device=CPU))
    got = tlm.loss_fn(tcfg, tp, _torch_batch(b))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=LOSS_RTOL)
    _close_leaves(tcommon.tree_map(lambda p: p.grad, tp), params_from_reference(tcfg, _np(grads), device=CPU),
                  GRAD_REL)


def test_init_shapes_are_meta_and_match_init():
    m = get_model_by_name("llama3.2-3b", reduced=True, device=CPU)
    shapes = dict(tcommon.tree_items(m.init_shapes()))
    real = dict(tcommon.tree_items(m.init(torch.Generator().manual_seed(0))))
    assert shapes.keys() == real.keys()
    for key, t in shapes.items():
        assert t.is_meta and t.shape == real[key].shape and t.dtype == real[key].dtype


# ---------------------------------------------------------------------------
# the attention gradient
# ---------------------------------------------------------------------------

# (B, H, Hkv, Tq, Tk, causal, window, D): GQA, MQA, MHA with a window, Tq <
# Tk, Tq > Tk (the first rows see no key), non-causal, above 2,048 keys;
# whisper's cross attention (non-causal, MHA, a few queries over more keys,
# and one query); pixtral's head dim 160, causal and non-causal over more keys
ATTN_CASES = {
    "gqa_causal": (2, 4, 2, 24, 24, True, 0, 16),
    "mqa_causal": (1, 4, 1, 17, 17, True, 0, 16),
    "mha_window": (1, 2, 2, 30, 30, True, 7, 16),
    "gqa_tq_lt_tk": (1, 4, 2, 9, 40, True, 0, 16),
    "empty_rows": (1, 2, 1, 20, 12, True, 0, 16),
    "noncausal": (1, 4, 2, 12, 19, False, 0, 16),
    "chunked_gqa": (1, 4, 2, 5, 2100, True, 0, 16),
    "chunked_window": (1, 2, 1, 6, 2305, True, 300, 16),
    "cross_mha": (2, 4, 4, 7, 30, False, 0, 16),
    "cross_one_query": (2, 4, 4, 1, 30, False, 0, 16),
    "d160_gqa_causal": (1, 4, 1, 21, 21, True, 0, 160),
    "d160_cross": (1, 4, 2, 5, 33, False, 0, 160),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_gradient_matches_reference(case):
    B, H, Hkv, Tq, Tk, causal, window, D = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, H, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    d_out = rng.normal(size=(B, H, Tq, D)).astype(np.float32)

    def ref_out(q, k, v):
        g = H // Hkv
        return rref.flash_attention(q, jnp.repeat(k, g, axis=1), jnp.repeat(v, g, axis=1), causal=causal, window=window)

    @jax.jit  # one program: op by op, the reference's eager vjp takes seconds
    def ref_vjp(q, k, v, d_out):
        out, vjp = jax.vjp(ref_out, q, k, v)
        return out, vjp(d_out)

    want_out, want = ref_vjp(q, k, v, d_out)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = kops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(d_out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * float(np.abs(w).max()) + 1e-7, name


def test_attention_records_no_graph_when_serving():
    q, k, v = (torch.randn(1, 2, 6, 16, requires_grad=True) for _ in range(3))
    with torch.no_grad():
        assert kops.flash_attention(q, k, v).grad_fn is None
    q0 = q.detach()
    assert kops.flash_attention(q0, k.detach(), v.detach()).grad_fn is None
    # the serve path's kv_valid mask takes the plain route, with its own gradient
    out = kops.flash_attention(q, k, v, causal=False, kv_valid=torch.tensor(4))
    assert type(out.grad_fn).__name__ != "FlashAttentionFnBackward"


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_schedule_matches_reference():
    for cfg in (topt.OptConfig(lr=1e-2, warmup_steps=10, total_steps=100), topt.OptConfig(warmup_steps=0, total_steps=1)):
        rcfg = ropt.OptConfig(**cfg.__dict__)
        for step in (0, 1, 5, 10, 11, 57, 100, 250):
            np.testing.assert_allclose(float(topt.schedule(cfg, torch.tensor(step, dtype=torch.int32))),
                                       float(ropt.schedule(rcfg, jnp.int32(step))), rtol=OPT_RTOL)


def _opt_tree(seed):
    """A reduced llama parameter tree and three steps of gradients, numpy."""
    rcfg, tcfg, rp = _pair("llama_gqa")
    rng = np.random.default_rng(seed)
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 10 ** rng.uniform(-3, 0)).astype(np.float32), rp)
             for _ in range(3)]
    return tcfg, _np(rp), grads


@pytest.mark.parametrize("variant", ["float32", "bfloat16", "compress", "clipped"])
def test_apply_updates_matches_reference(variant):
    tcfg, rp, grads = _opt_tree(seed=11)
    # the clip scales every gradient by grad_clip / |g|, and the two packages
    # sum |g|'s 10^5 float32 squares in another order (about 1e-6 apart):
    # the other variants do not clip, and the clipped one compares at 1e-5
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1, grad_clip=1e9)
    kw.update({"bfloat16": {"moments_dtype": "bfloat16"}, "compress": {"compress": True},
               "clipped": {"grad_clip": 1.0}}.get(variant, {}))
    tol = 1e-5 if variant == "clipped" else OPT_RTOL
    rcfg, cfg = ropt.OptConfig(**kw), topt.OptConfig(**kw)
    r_params = jax.tree.map(jnp.asarray, rp)
    r_state = ropt.init_state(r_params, rcfg)
    t_params = params_from_reference(tcfg, rp, device=CPU)
    t_state = opt_state_from_reference(tcfg, _np(r_state), device=CPU)
    assert t_state.keys() == r_state.keys()
    bf16 = variant == "bfloat16"
    # jitted (op by op the reference takes seconds), but for compression:
    # the compiled quantizer differs from its eager ops by an ulp, which
    # moves the carry (the eager ops are the ones the port's agree with)
    r_apply = ropt.apply_updates if cfg.compress else jax.jit(ropt.apply_updates, static_argnums=3)
    for g in grads:
        r_params, r_state, r_metrics = r_apply(r_params, r_state, g, rcfg)
        before = [id(t) for t in tcommon.tree_leaves(t_params)]
        t_params, t_state, t_metrics = topt.apply_updates(t_params, t_state,
                                                          params_from_reference(tcfg, g, device=CPU), cfg)
        assert [id(t) for t in tcommon.tree_leaves(t_params)] == before  # in place
        assert t_metrics.keys() == r_metrics.keys()
        for key, val in r_metrics.items():
            np.testing.assert_allclose(float(t_metrics[key]), float(val), rtol=tol, err_msg=key)
    assert int(t_state["step"]) == int(r_state["step"]) == 3
    # elementwise at ``tol``, with an atol of ``tol`` of the leaf's largest
    # entry: a moment summed from steps of either sign cancels towards 0.
    # bfloat16 moments: a float32 moment one ulp apart can round to the
    # neighbouring bfloat16 (2^-8 of the leaf's largest entry at most), and
    # each step's update (lr 1e-2) reads it, so parameters move apart by up
    # to 3 · 1e-2 · 2^-8
    want_p = params_from_reference(tcfg, _np(r_params), device=CPU)
    for (key, a), (_, b) in zip(tcommon.tree_items(t_params), tcommon.tree_items(want_p)):
        atol = 3 * 1e-2 * 2 ** -8 if bf16 else tol * float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=atol, err_msg=key)
    want_s = opt_state_from_reference(tcfg, _np(r_state), device=CPU)
    for part in [p for p in ("m", "v", "ef") if p in want_s]:
        for (key, a), (_, b) in zip(tcommon.tree_items(t_state[part]), tcommon.tree_items(want_s[part])):
            assert a.dtype == b.dtype == (torch.bfloat16 if bf16 else torch.float32)
            amax = float(b.float().abs().max())
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2 ** -7 if bf16 else tol,
                                       atol=(2 ** -8 if bf16 else tol) * amax, err_msg=f"{part}/{key}")


def test_compress_grads_matches_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.normal(size=(64, 64)).astype(np.float32), "b": [rng.normal(size=(7,)).astype(np.float32) * 1e-3]}
    ef = {"a": rng.normal(size=(64, 64)).astype(np.float32) * 1e-2, "b": [np.zeros(7, np.float32)]}
    rdeq, ref_ef, rstats = ropt.compress_grads(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, ef))
    to_t = lambda t: tcommon.tree_map(torch.from_numpy, t)
    deq, new_ef, stats = topt.compress_grads(to_t(g), to_t(ef))
    for got, want in ((deq, rdeq), (new_ef, ref_ef)):
        np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), rtol=OPT_RTOL, atol=1e-9)
        np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]), rtol=OPT_RTOL, atol=1e-12)
    np.testing.assert_allclose(float(stats["compress_rel_err"]), float(rstats["compress_rel_err"]), rtol=OPT_RTOL)
    # the int8 round trip's error is carried whole
    np.testing.assert_allclose((deq["a"] + new_ef["a"]).numpy(), g["a"] + ef["a"], rtol=1e-5, atol=1e-6)
    # half to even, as jnp.round
    q, s = topt._quantize(torch.tensor([2.5, -0.5, 1.5, 127.0]))
    assert float(s) == 1.0 and q.tolist() == [2, 0, 2, 127]


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_compressed_update_in_place(moments):
    """The compressed update leaves the gradients as they were, writes the
    new carry into ``ef`` itself, and equals the plain update fed
    ``compress_grads``' output, bit for bit."""
    tcfg, rp, grads = _opt_tree(seed=5)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, moments_dtype=moments)
    cfg, plain = topt.OptConfig(compress=True, **kw), topt.OptConfig(**kw)
    params = params_from_reference(tcfg, rp, device=CPU)
    want_p = tcommon.tree_map(torch.clone, params)
    state = topt.init_state(params, cfg)
    want_s = topt.init_state(want_p, plain)
    for g in grads:
        g = params_from_reference(tcfg, g, device=CPU)
        g_before = tcommon.tree_map(torch.clone, g)
        ef = tcommon.tree_leaves(state["ef"])
        deq, carry, stats = topt.compress_grads(g, state["ef"])
        _, want_s, want_m = topt.apply_updates(want_p, want_s, deq, plain)
        _, state, metrics = topt.apply_updates(params, state, g, cfg)
        assert all(torch.equal(a, b) for a, b in zip(tcommon.tree_leaves(g), tcommon.tree_leaves(g_before)))
        assert [id(e) for e in tcommon.tree_leaves(state["ef"])] == [id(e) for e in ef]
        for got, want in zip(tcommon.tree_leaves(state["ef"]), tcommon.tree_leaves(carry)):
            assert torch.equal(got, want.to(got.dtype))
        assert float(metrics["compress_rel_err"]) == float(stats["compress_rel_err"])
        assert float(metrics["grad_norm"]) == float(want_m["grad_norm"])
    for part, got, want in (("params", params, want_p), ("m", state["m"], want_s["m"]), ("v", state["v"], want_s["v"])):
        assert all(torch.equal(a, b) for a, b in zip(tcommon.tree_leaves(got), tcommon.tree_leaves(want))), part


def test_checkpoint_defaults_follow_tmpdir(monkeypatch, tmp_path):
    """Without ``--ckpt-dir`` / ``ckpt_dir`` the checkpoints go under this
    process's temporary directory, so two checkouts with their own TMPDIR
    never resume each other's runs."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert TrainConfig().ckpt_dir == str(tmp_path / "repro_ckpt")
    seen = {}
    monkeypatch.setattr(Trainer, "restore_or_init", lambda t: seen.update(dir=t.tcfg.ckpt_dir) or 0)
    monkeypatch.setattr(Trainer, "run", lambda t: None)
    ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--steps", "1"])
    assert seen["dir"] == str(tmp_path / "repro_launch_train")


def test_schedule_and_clip():
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=10, total_steps=100, grad_clip=0.5)
    params = {"w": torch.ones(4)}
    st = topt.init_state(params, cfg)
    _, st, m = topt.apply_updates(params, st, {"w": torch.full((4,), 100.0)}, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(m["lr"]) == pytest.approx(1e-2 / 10, rel=1e-3)  # warmup step 1
    assert torch.isfinite(params["w"]).all() and int(st["step"]) == 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_atomic_and_retained(tmp_path):
    d = str(tmp_path / "ckpts")
    tree = {"w": torch.arange(8.0), "b": {"x": torch.ones((2, 2))}, "layers": [{"s": torch.tensor(3, dtype=torch.int32)}]}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, tree, {"note": s}, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"] and ckpt.latest_step(d) == 5
    like = tcommon.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    restored, meta = ckpt.restore(d, like, device=CPU)
    assert torch.equal(restored["w"], torch.arange(8.0)) and restored["layers"][0]["s"].dtype == torch.int32
    assert meta == {"step": 5, "note": 5}
    # a torn write (no COMMIT) and an uncommitted temporary are never picked up
    os.makedirs(os.path.join(d, "step_00000099"))
    os.makedirs(os.path.join(d, "step_00000098.tmp0"))
    open(os.path.join(d, "step_00000098.tmp0", ckpt.COMMIT_MARKER), "w").close()
    assert ckpt.latest_step(d) == 5
    ckpt.save(d, 6, tree, keep=2)
    assert ckpt.latest_step(d) == 6 and not os.path.exists(os.path.join(d, "step_00000004"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), like, device=CPU)


def test_checkpoint_bf16_round_trip_partial_like_and_shape_check(tmp_path):
    d = str(tmp_path / "bf")
    x = torch.randn(5, 3).to(torch.bfloat16)
    tree = {"params": {"w": torch.randn(4, 2)}, "opt": {"m": x, "step": torch.tensor(7, dtype=torch.int32)}}
    ckpt.save(d, 7, tree, {"data_step": 7})
    got, meta = ckpt.restore(d, {"params": {"w": torch.empty(4, 2)}}, device=CPU)  # params alone
    assert torch.equal(got["params"]["w"], tree["params"]["w"]) and meta == {"step": 7, "data_step": 7}
    got, _ = ckpt.restore(d, tree, device=CPU)
    assert got["opt"]["m"].dtype == torch.bfloat16 and torch.equal(got["opt"]["m"].view(torch.int16), x.view(torch.int16))
    with pytest.raises(ValueError, match="params/w"):
        ckpt.restore(d, {"params": {"w": torch.empty(2, 4)}}, device=CPU)


def test_async_saver_snapshots_at_call(tmp_path):
    d = str(tmp_path / "async")
    w = torch.ones(4)
    saver = ckpt.AsyncSaver()
    saver.save(d, 1, {"w": w})
    w.add_(1.0)  # the next step updates the parameters in place
    saver.wait()
    assert ckpt.latest_step(d) == 1
    assert torch.equal(ckpt.restore(d, {"w": w}, device=CPU)[0]["w"], torch.ones(4))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class _ReferenceBatches:
    """A stream that serves ``repro``'s ``batch_at`` batches."""

    def __init__(self, cfg):
        self.cfg, self.step = cfg, 0

    def next(self):
        b = r_batch_at(self.cfg, self.step)
        self.step += 1
        return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}

    def state(self):
        return {"data_step": self.step}


def test_trainer_matches_reference_trainer(tmp_path):
    rcfg, tcfg, _ = _pair("llama_gqa")
    kw = dict(steps=5, ckpt_every=100, ckpt_async=False, log_every=1000)
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    rscfg = RStreamConfig(vocab=rcfg.vocab, global_batch=2, seq_len=16, seed=0)
    rt = RTrainer(r_get_model(rcfg), RTrainConfig(ckpt_dir=str(tmp_path / "r"), opt=ropt.OptConfig(**okw), **kw), rscfg)
    rt.init()
    init = _np(rt.params)  # the reference's step donates its inputs
    want = [x["loss"] for x in rt.run()]
    t = Trainer(get_model(tcfg, device=CPU), TrainConfig(ckpt_dir=str(tmp_path / "t"), opt=topt.OptConfig(**okw), **kw),
                StreamConfig(vocab=tcfg.vocab, global_batch=2, seq_len=16))
    t.params = _trainable(params_from_reference(tcfg, init, device=CPU))
    t.opt_state = topt.init_state(t.params, t.tcfg.opt)
    t.stream = _ReferenceBatches(rscfg)
    got = [x["loss"] for x in t.run()]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert ckpt.latest_step(str(tmp_path / "t")) == 5


def _trainer(tmp, steps=10, compress=False):
    m = get_model_by_name("qwen1.5-0.5b", reduced=True, device=CPU)
    scfg = StreamConfig(vocab=m.cfg.vocab, global_batch=4, seq_len=24, seed=0)
    tc = TrainConfig(steps=steps, ckpt_every=4, ckpt_dir=tmp, ckpt_async=False, log_every=1000,
                     opt=topt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps, compress=compress))
    return Trainer(m, tc, scfg)


def test_restart_equals_an_uninterrupted_run(tmp_path):
    d = str(tmp_path / "ck")
    t1 = _trainer(d, steps=9)
    t1.init()
    straight = [x["loss"] for x in t1.run()]
    shutil.rmtree(d)
    t2 = _trainer(d, steps=9)
    t2.init()
    with pytest.raises(SimulatedFailure):
        t2.run(fail_at=6)
    t3 = _trainer(d, steps=9)  # a fresh process
    t3.run()
    assert t3.metrics_log[0]["step"] == 4  # resumed from the step-4 checkpoint
    merged = {x["step"]: x["loss"] for x in t2.metrics_log + t3.metrics_log}
    for step, loss in enumerate(straight):
        np.testing.assert_allclose(loss, merged[step], rtol=1e-6)


def test_training_reduces_loss(tmp_path):
    t = _trainer(str(tmp_path / "ck2"), steps=20)
    t.init()
    log = t.run()
    assert np.mean([x["loss"] for x in log[-4:]]) < log[0]["loss"]
    assert all(np.isfinite([x["grad_norm"] for x in log]))


def test_compressed_training_converges(tmp_path):
    t = _trainer(str(tmp_path / "ck3"), steps=8, compress=True)
    t.init()
    log = t.run()
    assert log[-1]["loss"] < log[0]["loss"] and "compress_rel_err" in log[-1]


def test_launchers_train_then_serve_the_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "launch")
    ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--steps", "3", "--global-batch", "2",
                 "--seq-len", "16", "--ckpt-dir", d])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[launch.train] llama3.2-3b from step 0" and out[1].startswith("step      0  loss ")
    assert ckpt.latest_step(d) == 3
    tserve.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--requests", "2", "--slots", "2",
                 "--max-new", "3", "--ckpt-dir", d])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"[serve] restored step 3 from {d}"
    assert out[-1].startswith("[serve] 2 requests, 6 tokens, ")
    # a second launch resumes from the checkpoint
    ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--device", "cpu", "--steps", "4", "--global-batch", "2",
                 "--seq-len", "16", "--ckpt-dir", d])
    assert capsys.readouterr().out.splitlines()[0] == "[launch.train] llama3.2-3b from step 3"
    assert ckpt.latest_step(d) == 4


def test_training_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "llama3.2-3b", "--reduced", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(str(tmp_path), {}, step=0)
