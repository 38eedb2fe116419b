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
"""
from __future__ import annotations

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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"selective_scan: {msg}")


def selective_scan(xc, dt, Bt, Ct, A, h0=None):
    """``(y, h_T)`` as in the module docstring.  CPU tensors take
    :func:`selective_scan_plain`; CUDA tensors launch the kernel or raise."""
    if not xc.is_cuda:
        return selective_scan_plain(xc, dt, Bt, Ct, A, h0)
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
