"""The selective scan's gradient on the CPU: the backward kernel's plain
twin, ``SelectiveScanFn`` and a Mamba layer trained through it.

The kernel (``kernels/csrc/selective_scan_bwd.cu``) runs only on the card
(``tests/test_torch_gpu.py -k selective_scan_backward``); these tests hold
what it is checked against there, and the Python around it:

* ``selective_scan_backward_plain`` (checkpoints of ``h`` every
  ``BWD_TILE`` steps, each tile recomputed and walked back) against
  autograd through ``selective_scan_plain``, at d_state 4, 8 and 16, T = 1,
  T not a multiple of either tile, T = 2·TILE + 5, d_in not a multiple of
  ``ALIGN``, B > 1, with and without ``h0`` and ``dh_T``: in float32 at
  summation-order tolerance (rtol 1e-5, atol 1e-5 of the largest
  gradient), in bfloat16, whose gradients the twin rounds where autograd
  rounds them, within one bf16 step (2^-7) of the largest gradient;
* ``SelectiveScanFn`` on CPU tensors (the forward and backward twins)
  against the same autograd: the gradients' dtypes and shapes, the values;
* zero channels appended up to the kernel's width (``pad_channels``, with
  zero ``dy`` and ``dh_T``) leave the real channels' gradients as they are
  and give the padded ones zero, which the wrapper's cut relies on;
* a reduced Mamba layer (jamba's reduced config, d 64, d_inner 128) whose
  scan runs through ``SelectiveScanFn``: its parameter gradients against
  ``jax.grad`` of ``repro.models.mamba.apply``, with and without a carried
  state, at ``tests/test_torch_mamba.py``'s tolerance;
* a numpy transcription of the kernel's ``warp_sum8`` (the sums over a
  warp's channels) lane by lane, and the Python constants against the
  source's ``constexpr`` ones.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import mamba as rmamba

from repro_torch import configs as tconfigs
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import mamba as tmamba

ARCH = "jamba-1.5-large-398b"
RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_mamba.py's
_TRANSPOSED = ("in_proj", "x_proj", "dt_proj", "out_proj")
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")
# the largest gradient's share that two sums in another order may differ by
# in float32, and one bf16 step where a rounding point may flip
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}

# (B, T, d_in, ds, h0, dh_T)
CASES = [(1, 1, 8, 16, False, False), (2, 37, 10, 4, True, True), (2, 2 * ss.TILE + 5, 12, 8, True, False),
         (3, ss.BWD_TILE, 16, 16, False, True), (1, 2 * ss.BWD_TILE + 3, 20, 16, True, True)]
IDS = [f"B{c[0]}-T{c[1]}-d{c[2]}-ds{c[3]}" + ("-h0" if c[4] else "") + ("-dhT" if c[5] else "") for c in CASES]


def _inputs(case, dtype, seed=0):
    """The scan's streams as a Mamba layer gives them (dt a softplus, A =
    -(1 .. ds)), an output gradient ``dy`` and, where asked, ``h0`` and
    ``dh_T``, all drawn with numpy."""
    B, T, d_in, ds, with_h0, with_dh = case
    rng = np.random.default_rng(seed)
    xc = rng.normal(size=(B, T, d_in))
    dt = np.log1p(np.exp(rng.normal(size=(B, T, d_in)) - 2))
    Bt, Ct = rng.normal(size=(B, T, ds)), rng.normal(size=(B, T, ds))
    A = -np.tile(np.arange(1, ds + 1), (d_in, 1))
    streams = [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in (xc, dt, Bt, Ct, A)]
    h0 = torch.from_numpy(rng.normal(size=(B, d_in, ds)).astype(np.float32)) if with_h0 else None
    dy = torch.from_numpy(rng.normal(size=(B, T, d_in)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(B, d_in, ds)).astype(np.float32)) if with_dh else None
    return (*streams, h0), dy, dh


def _autograd(fn, args, dy, dh):
    """The gradients of ``<y, dy> + <h_T, dh>`` through ``fn`` by autograd,
    for every input that is not None."""
    leaves = [None if a is None else a.clone().requires_grad_() for a in args]
    y, h_T = fn(*leaves)
    loss = (y * dy).sum() + ((h_T * dh).sum() if dh is not None else 0.0)
    grads = torch.autograd.grad(loss, [t for t in leaves if t is not None])
    it = iter(grads)
    return [None if a is None else next(it) for a in args]


def _close(got, want, dtype):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape, w.shape)
        scale = max(float(w.float().abs().max()), 1e-30)
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype], atol=TOL[dtype] * scale, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_plain_matches_autograd(case, dtype):
    args, dy, dh = _inputs(case, dtype)
    want = _autograd(ss.selective_scan_plain, args, dy, dh)
    got = ss.selective_scan_backward_plain(*args, dy, dh)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_selective_scan_fn_on_cpu_matches_autograd(case, dtype):
    """CPU tensors: the function's forward and backward are the twins, and
    no kernel launch is counted."""
    args, dy, dh = _inputs(case, dtype, seed=1)
    want = _autograd(ss.selective_scan_plain, args, dy, dh)
    ss.selective_scan.launches = ss.selective_scan_backward.launches = 0
    got = _autograd(ss.SelectiveScanFn.apply, args, dy, dh)
    assert ss.selective_scan.launches == ss.selective_scan_backward.launches == 0
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_padded_channels_leave_the_gradients_as_they_are(dtype):
    case = (2, 2 * ss.BWD_TILE + 5, 13, 8, True, True)
    (xc, dt, Bt, Ct, A, h0), dy, dh = _inputs(case, dtype, seed=2)
    d_in = xc.shape[-1]
    width = ss.launch_geometry(xc.shape[0], d_in, A.shape[1]).width
    assert width > d_in
    want = ss.selective_scan_backward_plain(xc, dt, Bt, Ct, A, h0, dy, dh)
    pxc, pdt, pA, ph0 = ss.pad_channels(width, xc, dt, A, h0)
    pad = width - d_in
    got = ss.selective_scan_backward_plain(pxc, pdt, Bt, Ct, pA, ph0, torch.nn.functional.pad(dy, (0, pad)),
                                           torch.nn.functional.pad(dh, (0, 0, 0, pad)))
    for name, g in zip(NAMES, got):
        if name in ("dx", "ddt"):
            assert not g[..., d_in:].float().any(), name
        elif name in ("dA", "dh0"):
            assert not g[..., d_in:, :].float().any(), name
    cut = (got[0][..., :d_in], got[1][..., :d_in], got[2], got[3], got[4][:d_in], got[5][:, :d_in])
    _close(cut, want, dtype)


def _layer(seed, **kw):
    rcfg, tcfg = rconfigs.get(ARCH).reduce(**kw), tconfigs.get(ARCH).reduce(**kw)
    rp = jax.tree.map(np.asarray, rmamba.layer_init(rcfg, jax.random.PRNGKey(seed)))
    tp = {k: torch.from_numpy(np.array(a.T if k in _TRANSPOSED else a)) for k, a in rp.items()}
    return rcfg, tcfg, rp, tp


@pytest.mark.parametrize("carried", [False, True], ids=["whole", "carried"])
def test_mamba_layer_gradients_through_the_function_match_reference(carried, monkeypatch):
    """The layer's scan through ``SelectiveScanFn`` (as a CUDA call under
    grad mode takes it), its gradients against ``jax.grad``; carried: a
    state from an earlier chunk, its ``h`` among the differentiated."""
    routed = []

    def through_fn(*a):
        routed.append(1)
        return ss.SelectiveScanFn.apply(*a)

    monkeypatch.setattr(kops, "selective_scan", through_fn)
    rcfg, tcfg, rp, tp = _layer(7)
    d_in = tcfg.mamba_expand * tcfg.d_model
    rng = np.random.default_rng(7)
    T = 5 if carried else 2 * ss.BWD_TILE + 3
    x = rng.normal(size=(2, T, tcfg.d_model)).astype(np.float32)
    state = ({"conv": rng.normal(size=(2, tcfg.mamba_conv - 1, d_in)).astype(np.float32),
              "h": rng.normal(size=(2, d_in, tcfg.mamba_d_state)).astype(np.float32)} if carried else None)

    def loss(p, h):
        st = None if state is None else {"conv": jnp.asarray(state["conv"]), "h": h}
        out, new = rmamba.apply(p, jnp.asarray(x), rcfg, state=st)
        return jnp.sum(jnp.square(out)) + (jnp.sum(new["h"]) if st is not None else 0.0)

    h_ref = None if state is None else jnp.asarray(state["h"])
    grads, g_h = jax.jit(jax.grad(loss, argnums=(0, 1)))(rp, h_ref)
    tp = {k: t.requires_grad_(True) for k, t in tp.items()}
    th = None if state is None else torch.from_numpy(state["h"]).requires_grad_(True)
    st = None if state is None else {"conv": torch.from_numpy(state["conv"]), "h": th}
    out, new = tmamba.apply(tp, torch.from_numpy(x), tcfg, state=st)
    (out.square().sum() + (new["h"].sum() if st is not None else 0.0)).backward()
    assert routed == [1]
    for k, g in grads.items():
        want = np.asarray(g).T if k in _TRANSPOSED else np.asarray(g)
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=RTOL,
                                   atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=k)
    if carried:
        want = np.asarray(g_h)
        np.testing.assert_allclose(th.grad.numpy(), want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())))


def _warp_sum8(v):
    """``warp_sum8`` of ``csrc/selective_scan_bwd.cu`` transcribed: ``v`` is
    [32 lanes, 8 values]; returns each lane's one sum, exchange by
    exchange (``__shfl_xor_sync(.., m)`` reads lane L ^ m)."""
    lanes = np.arange(32)
    b4, b3, b2 = (lanes & 16) > 0, (lanes & 8) > 0, (lanes & 4) > 0
    r = np.empty((32, 4))
    for i in range(4):
        send = np.where(b4, v[:, i], v[:, i + 4])
        r[:, i] = np.where(b4, v[:, i + 4], v[:, i]) + send[lanes ^ 16]
    s = np.empty((32, 2))
    for i in range(2):
        send = np.where(b3, r[:, i], r[:, i + 2])
        s[:, i] = np.where(b3, r[:, i + 2], r[:, i]) + send[lanes ^ 8]
    send = np.where(b2, s[:, 0], s[:, 1])
    q = np.where(b2, s[:, 1], s[:, 0]) + send[lanes ^ 4]
    q = q + q[lanes ^ 2]
    return q + q[lanes ^ 1]


def test_warp_sum8_gives_each_lane_one_sum_over_the_warp():
    v = np.random.default_rng(3).integers(-1000, 1000, size=(32, 8)).astype(np.float64)
    q = _warp_sum8(v)
    lanes = np.arange(32)
    np.testing.assert_array_equal(q, v.sum(0)[(lanes >> 2) & 7])
    # the four lanes of a quad hold the same sum, formed in one order
    assert (q.reshape(8, 4) == q.reshape(8, 4)[:, :1]).all()


def test_constants_match_the_source():
    src = (build.CSRC / "selective_scan_bwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("STATES"), const("BLOCK"), const("CHUNK"), const("ALIGN")) == (
        ss.STATES, ss.BLOCK, ss.BWD_TILE, ss.ALIGN)
