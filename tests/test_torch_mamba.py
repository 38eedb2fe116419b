"""The port's Mamba layer and its selective-scan twin against the reference,
on the CPU.

The same numpy inputs (made from a seed) go through ``repro.models.mamba``
and ``repro_torch.models.mamba`` (``device="cpu"``, float32, jamba's reduced
config: d 64, d_inner 128), at rtol 1e-4 / atol 1e-5:

* ``_conv_causal`` with and without the decode tail;
* ``_ssm_scan`` at d_state 16 and 4, with and without a carried ``h0``
  (the port's runs ``selective_scan_plain``, the kernel's twin);
* ``selective_scan_plain`` in bfloat16 against the reference's step body
  run by JAX on the same bfloat16 streams (its rounding points);
* ``apply`` as a whole and token by token from ``init_state``;
* the wrapper: CPU tensors take the twin and count no launch; a CUDA input
  that requires grad goes through ``SelectiveScanFn``, whose gradients are
  the twin's and whose second-order gradient is refused.

The kernel itself runs on the card (``tests/test_torch_gpu.py -k
selective_scan``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import mamba as rmamba

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import mamba as tmamba

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5
ARCH = "jamba-1.5-large-398b"

# mamba.layer_init's dt_proj / in_proj etc. in the reference's [d_in, d_out]
_TRANSPOSED = ("in_proj", "x_proj", "dt_proj", "out_proj")


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _cfgs(**kw):
    return rconfigs.get(ARCH).reduce(**kw), tconfigs.get(ARCH).reduce(**kw)


def _layer(seed, **kw):
    rcfg, tcfg = _cfgs(**kw)
    rp = jax.tree.map(np.asarray, rmamba.layer_init(rcfg, jax.random.PRNGKey(seed)))
    tp = {k: torch.from_numpy(np.array(a.T if k in _TRANSPOSED else a)) for k, a in rp.items()}
    return rcfg, tcfg, rp, tp


@pytest.mark.parametrize("with_tail", [False, True])
def test_conv_causal_matches_reference(with_tail):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    tail = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_tail else None
    want, want_tail = rmamba._conv_causal(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
                                          None if tail is None else jnp.asarray(tail))
    got, got_tail = tmamba._conv_causal(torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(x),
                                        None if tail is None else torch.from_numpy(tail))
    close(got, want)
    close(got_tail, want_tail)
    # a float32 tail promotes a bfloat16 stream, as JAX promotes it
    if with_tail:
        bf, new = tmamba._conv_causal(torch.from_numpy(w).bfloat16(), torch.from_numpy(b).bfloat16(),
                                      torch.from_numpy(x).bfloat16(), torch.from_numpy(tail))
        assert bf.dtype == new.dtype == torch.float32


@pytest.mark.parametrize("ds", [16, 4])
@pytest.mark.parametrize("carried", [False, True])
def test_ssm_scan_matches_reference(ds, carried):
    rcfg, tcfg, rp, tp = _layer(3, mamba_d_state=ds)
    d_in = tcfg.mamba_expand * tcfg.d_model
    rng = np.random.default_rng(ds)
    xc = rng.normal(size=(2, 23, d_in)).astype(np.float32)
    h0 = rng.normal(size=(2, d_in, ds)).astype(np.float32) if carried else None
    want, want_h = rmamba._ssm_scan(rp, jnp.asarray(xc), ds, None if h0 is None else jnp.asarray(h0))
    ss.selective_scan.launches = 0
    got, got_h = tmamba._ssm_scan(tp, torch.from_numpy(xc), ds, None if h0 is None else torch.from_numpy(h0))
    assert ss.selective_scan.launches == 0  # CPU tensors take the twin
    assert got.dtype == got_h.dtype == torch.float32
    close(got, want)
    close(got_h, want_h)


def _reference_steps(xc, dt, Bt, Ct, A, h):
    """The reference's scan body (``repro/models/mamba.py:81-86``) run by JAX
    op by op on the given streams, so that every op rounds its result to its
    dtype (compiled, XLA's CPU fusion keeps some bfloat16 chains in float32)."""
    ys = []
    with jax.disable_jit():
        for t in range(xc.shape[1]):
            x_t, dt_t, b_t, c_t = xc[:, t], dt[:, t], Bt[:, t], Ct[:, t]
            da = jnp.exp(dt_t[..., None] * A[None])
            h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
            ys.append(jnp.einsum("bds,bs->bd", h, c_t))
    return jnp.stack(ys, 1), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_selective_scan_plain_rounds_as_the_reference(dtype):
    """The twin rounds ``exp(dt·A)``, ``dt·x`` and ``(dt·x)·b`` to the
    streams' dtype where the reference's operands in that dtype round them:
    on the same bfloat16 streams the two agree to float32 summation order
    (``h`` and the sum stay float32)."""
    rng = np.random.default_rng(7)
    B, T, d_in, ds = 2, 19, 40, 8
    xc = rng.normal(size=(B, T, d_in)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, T, d_in)) - 2)).astype(np.float32)
    Bt, Ct = (rng.normal(size=(B, T, ds)).astype(np.float32) for _ in range(2))
    A = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (d_in, 1))
    h0 = rng.normal(size=(B, d_in, ds)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want, want_h = _reference_steps(*(jnp.asarray(a).astype(jdt) for a in (xc, dt, Bt, Ct, A)), jnp.asarray(h0))
    tdt = getattr(torch, dtype)
    got, got_h = ss.selective_scan_plain(*(torch.from_numpy(a).to(tdt) for a in (xc, dt, Bt, Ct)),
                                         torch.from_numpy(A).to(tdt), torch.from_numpy(h0))
    assert got.dtype == got_h.dtype == torch.float32
    close(got, want)
    close(got_h, want_h)


def test_apply_whole_and_stepwise_match_reference():
    rcfg, tcfg, rp, tp = _layer(5)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    want, none = rmamba.apply(rp, jnp.asarray(x), rcfg)
    got, tnone = tmamba.apply(tp, torch.from_numpy(x), tcfg)
    assert none is None and tnone is None
    close(got, want)
    rs, ts = rmamba.init_state(rcfg, 2), tmamba.init_state(tcfg, 2, CPU)
    assert {k: (tuple(t.shape), t.dtype) for k, t in ts.items()} == {
        k: (a.shape, torch.float32) for k, a in rs.items()}
    steps = []
    for t in range(9):
        w1, rs = rmamba.apply(rp, jnp.asarray(x[:, t:t + 1]), rcfg, state=rs)
        g1, ts = tmamba.apply(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, state=ts)
        close(g1, w1)
        steps.append(g1)
    close(ts["conv"], rs["conv"])
    close(ts["h"], rs["h"])
    # stepwise against whole at the reference's tolerance (tests/test_models_smoke.py:101)
    close(torch.cat(steps, 1), got, rtol=2e-3, atol=3e-4)


def test_selective_scan_refuses_a_cuda_input_that_requires_grad(monkeypatch):
    """A CUDA call under grad mode goes through ``SelectiveScanFn`` (the
    kernel forward, the backward kernel), whose gradient is first-order: its
    gradients equal the twin's autograd, and a second-order gradient through
    it is refused with ``NotImplementedError`` naming ROADMAP.md (the
    reference's ``lax.scan`` differentiates twice; the card's port does not
    yet).  Stand-ins for CUDA tensors reach the dispatch without a card; the
    forward and backward launchers are replaced by their plain twins."""
    rng = np.random.default_rng(8)
    B, T, d_in, ds = 2, 21, 8, 4
    streams = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.normal(size=(B, T, d_in)), np.log1p(np.exp(rng.normal(size=(B, T, d_in)) - 2)),
        rng.normal(size=(B, T, ds)), rng.normal(size=(B, T, ds)), -np.tile(np.arange(1, ds + 1), (d_in, 1)))]
    h0 = torch.from_numpy(rng.normal(size=(B, d_in, ds)).astype(np.float32))

    def loss(fn, leaves):
        y, h_T = fn(*leaves)
        return y.square().sum() + h_T.sum()

    plain = [t.clone().requires_grad_() for t in (*streams, h0)]
    want = torch.autograd.grad(loss(ss.selective_scan_plain, plain), plain)
    monkeypatch.setattr(ss, "selective_scan", ss.selective_scan_plain)
    monkeypatch.setattr(ss, "selective_scan_backward", ss.selective_scan_backward_plain)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    leaves = [t.clone().requires_grad_() for t in (*streams, h0)]
    y, _ = kops.selective_scan(*leaves)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    got = torch.autograd.grad(loss(kops.selective_scan, leaves), leaves)
    for g, w in zip(got, want):
        close(g, w.numpy(), rtol=1e-5, atol=1e-5 * float(w.abs().max()))
    first = torch.autograd.grad(loss(kops.selective_scan, leaves), leaves[0], create_graph=True)[0]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        torch.autograd.grad(first.sum(), leaves[0])


def test_selective_scan_is_differentiable_on_the_cpu():
    rcfg, tcfg, rp, tp = _layer(6)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(1, 5, tcfg.d_model)).astype(np.float32))
    tp = {k: t.requires_grad_(True) for k, t in tp.items()}
    y, _ = tmamba.apply(tp, x, tcfg)
    y.square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in tp.values())

    def loss(p):
        return jnp.sum(jnp.square(rmamba.apply(p, jnp.asarray(x.numpy()), rcfg)[0]))

    grads = jax.grad(loss)(rp)
    for k, g in grads.items():
        want = np.asarray(g).T if k in _TRANSPOSED else np.asarray(g)
        close(tp[k].grad, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def test_layer_init_draws_the_reference_shapes():
    rcfg, tcfg = _cfgs()
    rp = rmamba.layer_init(rcfg, jax.random.PRNGKey(0))
    tp = tmamba.layer_init(tcfg, torch.Generator().manual_seed(0), CPU)
    assert tp.keys() == rp.keys()
    for k, a in rp.items():
        assert tuple(tp[k].shape) == (a.shape[::-1] if k in _TRANSPOSED else a.shape), k
    close(tp["A_log"], rp["A_log"], rtol=1e-6, atol=0)
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 1e-1 * 1.001
    bf = tmamba.layer_init(tcfg, torch.Generator().manual_seed(0), CPU, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 and torch.equal(tp[k].to(torch.bfloat16), t) for k, t in bf.items())
