"""The selective scan of a Mamba layer, as a hand-written Hopper kernel
(``csrc/selective_scan.cu``).

It replaces no ``pallas_call``: the reference runs the scan as a
``lax.scan`` over time, one token a step (``repro/models/mamba.py:95``),
which on the TPU is one compiled loop.  Eager PyTorch would pay several
launches a token and layer, so the port gives the scan a kernel, with the
reference's per-step loop as its plain twin.

Contract: ``selective_scan(xc, dt, Bt, Ct, A, h0=None) -> (y, h_T)``.
``xc`` and ``dt`` are ``[B, T, d_in]``, ``Bt`` and ``Ct`` ``[B, T, ds]``,
all four in one dtype (bfloat16 or float32); ``A = -exp(A_log)`` is
``[d_in, ds]``; ``h0`` and ``h_T`` are float32 ``[B, d_in, ds]``; ``y`` is
float32 ``[B, T, d_in]``, without the ``D`` skip term.  Each step is the
reference's (``mamba.py:81-86``)::

    h = exp(dt·A)·h + (dt·x)·b        y = Σ_n h·c

with ``exp(dt·A)``, ``dt·x`` and ``(dt·x)·b`` rounded to the input dtype
where the reference's operands in that dtype round them, and ``h`` and the
sum in float32; so kernel and twin differ only in float32 summation order.

The kernel (the design and its reasons are in the source's header): a
group of ``ds / STATES`` threads serves one (batch row, channel), each
thread keeping :data:`STATES` lanes of ``h`` and of ``A`` in registers (a
warp's threads hold the same lanes of 32 channels), the group's partial
``y`` added in shared memory; a block of :data:`BLOCK`
channels walks time in tiles of :data:`TILE` steps through a two-stage
``cp.async`` ring, so the next tile's ``dt`` / ``x`` columns and ``Bt`` /
``Ct`` rows arrive while the current one is consumed, and ``y`` leaves a
tile at a time in 16-byte stores.  :func:`launch_geometry` computes the
launch (threads a channel, blocks, the padded width) for the wrapper, the
tests and ``chip_smoke.py``.

The gradient (``csrc/selective_scan_bwd.cu``, again no ``pallas_call``
behind it: the reference's is JAX's autodiff through its ``lax.scan``):
:func:`selective_scan_backward` returns ``(dx, ddt, dB, dC, dA, dh0)``
from the forward's inputs and ``dy`` (float32 ``[B, T, d_in]``) and ``dh_T``
(float32 ``[B, d_in, ds]`` or ``None``), each in its input's dtype and
rounded where the twin's autograd rounds it.  The kernel walks the scan
forward once to keep ``h`` at the start of every :data:`BWD_TILE` steps,
then walks the chunks back from the last, each recomputed from its
checkpoint; every sum over channels, lanes and batch rows is taken in one
order, so two launches give bitwise-equal gradients.
:func:`selective_scan_backward_plain` is that algorithm in torch ops, and
:class:`SelectiveScanFn` the autograd function (the kernel forward, the
kernel backward, first-order only) that ``kernels/ops.py`` routes a CUDA
call under grad mode through.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build

D_STATES = (4, 8, 16)
STATES = 4  # state lanes a thread (csrc/selective_scan.cu)
BLOCK = 64  # channels a block
TILE = 32  # time steps a tile of the ring
ALIGN = 8  # the kernel's width is d_in padded to this many channels: whole 16-byte chunks
BWD_TILE = 16  # steps between the backward's checkpoints of h (csrc/selective_scan_bwd.cu: CHUNK)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GRID_Y = 65535


def selective_scan_plain(xc, dt, Bt, Ct, A, h0=None):
    """The reference's per-step loop: ``(y [B, T, d_in] float32, h_T [B,
    d_in, ds] float32)``.  Differentiable (the CPU's training path)."""
    B, T, d_in = xc.shape
    ds = A.shape[1]
    dtype = xc.dtype

    def rnd(t):  # the reference's rounding to the streams' dtype
        return t.to(dtype).float()

    A = A.float()
    h = h0 if h0 is not None else torch.zeros((B, d_in, ds), dtype=torch.float32, device=xc.device)
    ys = []
    for t in range(T):
        d = dt[:, t].float()
        da = rnd(torch.exp(rnd(d[..., None] * A)))
        u = rnd(rnd(d * xc[:, t].float())[..., None] * Bt[:, t, None, :].float())
        h = da * h + u
        ys.append((h * Ct[:, t, None, :].float()).sum(-1))
    y = torch.stack(ys, dim=1) if ys else torch.zeros((B, 0, d_in), dtype=torch.float32, device=xc.device)
    return y, h


def selective_scan_backward_plain(xc, dt, Bt, Ct, A, h0, dy, dh_T=None):
    """The kernel's backward in torch ops: ``(dx, ddt, dB, dC, dA, dh0)``,
    each in its input's dtype (``dh0`` None without ``h0``).  A first walk
    keeps ``h`` at the start of every :data:`BWD_TILE` steps; then, from the
    last tile, each tile's states are recomputed from its checkpoint and walked
    back with ``g = dL/dh`` carried from ``dh_T``.  Every gradient is rounded
    to the streams' dtype where autograd through :func:`selective_scan_plain`
    rounds it (at each cast of the forward), so in float32 the two differ in
    summation order only."""
    B, T, d_in = xc.shape
    ds = A.shape[1]
    dtype, dev = xc.dtype, xc.device

    def rnd(t):
        return t.to(dtype).float()

    Af = A.float()
    zeros = torch.zeros((B, d_in, ds), dtype=torch.float32, device=dev)

    def step_inputs(t):
        d = dt[:, t].float()
        z = rnd(d[..., None] * Af)
        e = torch.exp(z)
        v = rnd(d * xc[:, t].float())
        return d, e, rnd(e), v, rnd(v[..., None] * Bt[:, t, None, :].float())

    h = zeros if h0 is None else h0.float()
    ckpt = []
    for t in range(T):
        if t % BWD_TILE == 0:
            ckpt.append(h)
        _, _, a, _, u = step_inputs(t)
        h = a * h + u
    g = zeros if dh_T is None else dh_T.float()
    dx = torch.empty((B, T, d_in), dtype=dtype, device=dev)
    ddt = torch.empty_like(dx)
    dB = torch.empty((B, T, ds), dtype=dtype, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.zeros((d_in, ds), dtype=torch.float32, device=dev)
    for k in reversed(range(len(ckpt))):
        t0 = k * BWD_TILE
        hs = [ckpt[k]]
        for t in range(t0, min(t0 + BWD_TILE, T)):
            _, _, a, _, u = step_inputs(t)
            hs.append(a * hs[-1] + u)
        for j in reversed(range(len(hs) - 1)):
            t = t0 + j
            d, e, a, v, _ = step_inputs(t)
            gy = dy[:, t].float()
            gn = gy[..., None] * Ct[:, t, None, :].float() + g  # dL/dh_t
            dC[:, t] = (gy[..., None] * hs[j + 1]).sum(1).to(dtype)
            gu = rnd(gn)  # dL/du_t
            dB[:, t] = (gu * v[..., None]).sum(1).to(dtype)
            dv = rnd((gu * Bt[:, t, None, :].float()).sum(-1))
            dz = rnd(rnd(gn * hs[j]) * e)  # dL/d(dt·A)
            dx[:, t] = (dv * d).to(dtype)
            ddt[:, t] = ((dz * Af).sum(-1) + dv * xc[:, t].float()).to(dtype)
            dA += (dz * d[..., None]).sum(0)
            g = gn * a
    return dx, ddt, dB, dC, dA.to(A.dtype), None if h0 is None else g


class Geometry(NamedTuple):
    """One launch: ``group`` threads a channel, each holding ``states``
    lanes; blocks of ``threads`` threads over ``channels`` channels,
    ``blocks_x`` along the (padded) ``width`` and one a batch row
    (``blocks_y``)."""

    group: int
    states: int
    channels: int
    threads: int
    tile: int
    blocks_x: int
    blocks_y: int
    width: int

    @property
    def warps(self) -> int:
        return self.blocks_x * self.blocks_y * self.threads // 32


def launch_geometry(B: int, d_in: int, ds: int) -> Geometry:
    """The kernel's launch at ``[B, T, d_in]`` streams and ``ds`` states
    (``T`` only sets the number of tiles each block walks)."""
    _check(ds in D_STATES, f"state size {ds} is not one of {D_STATES}")
    group = ds // STATES
    width = -(-d_in // ALIGN) * ALIGN
    return Geometry(group, STATES, BLOCK, BLOCK * group, TILE, -(-width // BLOCK), B, width)


def block_lanes(geom: Geometry):
    """``(channel in the block, first state)`` of each thread of a block, as
    the kernel computes them from ``threadIdx.x``: warp ``w`` holds state
    lanes ``(w % G) · STATES ..`` of 32 consecutive channels from ``32 ·
    (w // G)``.  Block ``(x, y)`` serves batch row ``y`` and channels from
    ``x · BLOCK``."""
    tid = np.arange(geom.threads)
    warp = tid // 32
    return tid % 32 + 32 * (warp // geom.group), (warp % geom.group) * geom.states


def pad_channels(width: int, xc, dt, A, h0=None):
    """``xc``, ``dt``, ``A`` and ``h0`` with zero channels appended up to
    ``width``: a padded channel's state stays zero and its outputs are cut
    off, so the real channels are untouched."""
    pad = width - xc.shape[-1]
    if pad == 0:
        return xc, dt, A, h0
    return (F.pad(xc, (0, pad)), F.pad(dt, (0, pad)), F.pad(A, (0, 0, 0, pad)),
            None if h0 is None else F.pad(h0, (0, 0, 0, pad)))


def _aligned(t):
    """``t`` contiguous and at a 16-byte aligned address (the kernel's
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "selective_scan.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("selective_scan", src), "selective_scan_launch")
    return _LIB["fn"]


def _bwd_launcher():
    if "bwd" not in _LIB:
        src = (build.CSRC / "selective_scan_bwd.cu").read_text()
        _LIB["bwd"] = build.launcher(build.load("selective_scan_bwd", src), "selective_scan_backward_launch")
    return _LIB["bwd"]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan: {msg}")


def _checked(xc, dt, Bt, Ct, A, h0):
    """The kernels' preconditions on the forward's inputs (a ``ValueError``
    for each one not met); ``(B, T, d_in, ds)``."""
    dev = xc.device
    _check(xc.dim() == 3 and dt.shape == xc.shape, f"xc and dt must be one [B, T, d_in] shape, got "
           f"{tuple(xc.shape)} and {tuple(dt.shape)}")
    B, T, d_in = xc.shape
    _check(A.dim() == 2 and A.shape[0] == d_in, f"A must be [d_in, ds], got {tuple(A.shape)}")
    ds = A.shape[1]
    _check(ds in D_STATES, f"state size {ds} is not one of {D_STATES}")
    _check(Bt.shape == (B, T, ds) and Ct.shape == (B, T, ds), f"Bt and Ct must be [B, T, {ds}], got "
           f"{tuple(Bt.shape)} and {tuple(Ct.shape)}")
    _check(xc.dtype in _DTYPE_CODE and all(t.dtype == xc.dtype for t in (dt, Bt, Ct)),
           f"xc, dt, Bt and Ct must all be bfloat16 or all float32, got {xc.dtype}, {dt.dtype}, {Bt.dtype}, {Ct.dtype}")
    _check(all(t.device == dev for t in (dt, Bt, Ct, A)) and (h0 is None or h0.device == dev),
           "every input must be on one CUDA device")
    _check(h0 is None or (h0.shape == (B, d_in, ds) and h0.dtype == torch.float32),
           f"h0 must be float32 [B, d_in, ds], got {None if h0 is None else (tuple(h0.shape), h0.dtype)}")
    _check(B <= _MAX_GRID_Y, "too many batch rows")
    return B, T, d_in, ds


def selective_scan(xc, dt, Bt, Ct, A, h0=None):
    """``(y, h_T)`` as in the module docstring.  CPU tensors take
    :func:`selective_scan_plain`; CUDA tensors launch the kernel or raise."""
    if not xc.is_cuda:
        return selective_scan_plain(xc, dt, Bt, Ct, A, h0)
    dev = xc.device
    B, T, d_in, ds = _checked(xc, dt, Bt, Ct, A, h0)
    geom = launch_geometry(B, d_in, ds)
    xc, dt, A, h0 = pad_channels(geom.width, xc, dt, A.float(), h0)
    xc, dt, Bt, Ct, A = (_aligned(t) for t in (xc, dt, Bt, Ct, A))
    if h0 is not None:
        h0 = _aligned(h0)
    y = torch.empty((B, T, geom.width), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, geom.width, ds), dtype=torch.float32, device=dev)
    build.launch(
        _launcher(),
        [xc.data_ptr(), dt.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), A.data_ptr(),
         0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_T.data_ptr()],
        [B, T, geom.width, ds, _DTYPE_CODE[xc.dtype], geom.blocks_x, geom.threads],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if geom.width != d_in:
        y, h_T = y[..., :d_in].contiguous(), h_T[:, :d_in].contiguous()
    _SS.launches += 1
    return y, h_T


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
selective_scan.launches = 0
_SS = selective_scan


def selective_scan_backward(xc, dt, Bt, Ct, A, h0, dy, dh_T=None):
    """``(dx, ddt, dB, dC, dA, dh0)`` of the scan at the forward's inputs,
    from ``dy`` (float32 ``[B, T, d_in]``) and ``dh_T`` (float32 ``[B, d_in,
    ds]``, or None for zero), each in its input's dtype (``dh0`` None
    without ``h0``).  CPU tensors take :func:`selective_scan_backward_plain`;
    CUDA tensors launch the kernel (two launches: the walk, then the
    fixed-order sums over blocks and batch rows) or raise, on the forward's
    preconditions too."""
    if not xc.is_cuda:
        return selective_scan_backward_plain(xc, dt, Bt, Ct, A, h0, dy, dh_T)
    dev = xc.device
    B, T, d_in, ds = _checked(xc, dt, Bt, Ct, A, h0)
    _check(dy.shape == (B, T, d_in) and dy.dtype == torch.float32 and dy.device == dev,
           f"dy must be float32 [B, T, d_in] on the inputs' device, got {tuple(dy.shape)} {dy.dtype}")
    _check(dh_T is None or (dh_T.shape == (B, d_in, ds) and dh_T.dtype == torch.float32 and dh_T.device == dev),
           f"dh_T must be float32 [B, d_in, ds], got {None if dh_T is None else (tuple(dh_T.shape), dh_T.dtype)}")
    geom = launch_geometry(B, d_in, ds)
    W, dtype = geom.width, xc.dtype
    xc, dt, Af, h0p = pad_channels(W, xc, dt, A.float(), h0)
    if W != d_in:  # zero output gradients for the padded channels
        dy = F.pad(dy, (0, W - d_in))
        dh_T = None if dh_T is None else F.pad(dh_T, (0, 0, 0, W - d_in))
    xc, dt, Bt, Ct, Af, dy = (_aligned(t) for t in (xc, dt, Bt, Ct, Af, dy))
    h0p, dh_T = (None if t is None else _aligned(t) for t in (h0p, dh_T))
    f32 = dict(dtype=torch.float32, device=dev)
    ck = torch.empty((B, -(-T // BWD_TILE), W, ds), **f32)
    dx = torch.empty((B, T, W), dtype=dtype, device=dev)
    ddt = torch.empty_like(dx)
    pB = torch.empty((geom.blocks_x, B, T, ds), **f32)
    pC = torch.empty_like(pB)
    pA = torch.empty((B, W, ds), **f32)
    dh0 = None if h0 is None else torch.empty((B, W, ds), **f32)
    dB = torch.empty((B, T, ds), dtype=dtype, device=dev)
    dC = torch.empty_like(dB)
    dA = torch.zeros((W, ds), **f32)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    build.launch(
        _bwd_launcher(),
        [ptr(t) for t in (xc, dt, Bt, Ct, Af, h0p, dy, dh_T, ck, dx, ddt, pB, pC, pA, dh0, dB, dC, dA)],
        [B, T, W, ds, _DTYPE_CODE[dtype], geom.blocks_x, geom.threads],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if W != d_in:
        dx, ddt, dA = dx[..., :d_in].contiguous(), ddt[..., :d_in].contiguous(), dA[:d_in].contiguous()
        dh0 = None if dh0 is None else dh0[:, :d_in].contiguous()
    _SSB.launches += 1
    return dx, ddt, dB, dC, dA.to(A.dtype), dh0


selective_scan_backward.launches = 0
_SSB = selective_scan_backward

SECOND_ORDER = ("selective_scan: the scan kernel's backward is first-order; a second-order gradient through "
                "it is not ported (ROADMAP.md)")


class _SecondOrderRefused(torch.autograd.Function):
    """Passes the first-order gradients through (views of them); a gradient
    taken of them raises."""

    @staticmethod
    def forward(ctx, n, *ts):
        return tuple(t.view_as(t) for t in ts[:n])

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError(SECOND_ORDER)


def _first_order(backward):
    """``once_differentiable`` with ``NotImplementedError``: the backward runs
    without a graph; where one is asked for (``create_graph=True``) its
    gradients hang from a node over the saved inputs that refuses to be
    differentiated, so a second-order gradient raises where it is taken."""

    @functools.wraps(backward)
    def wrapper(ctx, *grads):
        with torch.no_grad():
            out = backward(ctx, *grads)
        if not torch.is_grad_enabled():
            return out
        live = [i for i, t in enumerate(out) if t is not None]
        deps = [t for t in (*ctx.saved_tensors, *grads) if t is not None and t.requires_grad]
        if not deps:
            return out
        passed = iter(_SecondOrderRefused.apply(len(live), *(out[i] for i in live), *deps))
        return tuple(next(passed) if t is not None else None for t in out)

    return wrapper


class SelectiveScanFn(torch.autograd.Function):
    """``(y, h_T)`` of :func:`selective_scan` with its gradient from
    :func:`selective_scan_backward`: on CUDA tensors the forward and the
    backward kernel, on CPU tensors their plain twins.  First-order only."""

    @staticmethod
    def forward(ctx, xc, dt, Bt, Ct, A, h0=None):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xc, dt, Bt, Ct, A, h0)
        return selective_scan(xc, dt, Bt, Ct, A, h0)

    @staticmethod
    @_first_order
    def backward(ctx, dy, dh_T):
        xc, dt, Bt, Ct, A, h0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xc.shape, dtype=torch.float32, device=xc.device)
        return selective_scan_backward(xc, dt, Bt, Ct, A, h0, dy, dh_T)
