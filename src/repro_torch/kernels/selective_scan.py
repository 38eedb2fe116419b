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

The kernel: one thread a (batch row, channel) keeps ``h[ds]`` and its row
of ``A`` in registers (``ds`` a template parameter over :data:`D_STATES`);
a block of :data:`BLOCK` channels walks time in tiles of :data:`TILE`
steps, staging the tile's ``Bt`` / ``Ct`` rows (shared by every channel of
the batch row) and its own ``dt`` / ``x`` columns in shared memory, read
and written coalesced.
"""
from __future__ import annotations

import torch

from . import build

D_STATES = (4, 8, 16)
BLOCK = 128  # channels a block (csrc/selective_scan.cu)
TILE = 32  # time steps a block stages at once
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
    xc, dt, Bt, Ct = (t.contiguous() for t in (xc, dt, Bt, Ct))
    A = A.float().contiguous()
    y = torch.empty((B, T, d_in), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, d_in, ds), dtype=torch.float32, device=dev)
    if h0 is not None:
        h0 = h0.contiguous()
    build.launch(
        _launcher(),
        [xc.data_ptr(), dt.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), A.data_ptr(),
         0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_T.data_ptr()],
        [B, T, d_in, ds, _DTYPE_CODE[xc.dtype]],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _SS.launches += 1
    return y, h_T


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
selective_scan.launches = 0
_SS = selective_scan
