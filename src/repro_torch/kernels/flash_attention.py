"""Flash attention — online-softmax attention with GQA, causal and window
masks, as a hand-written Hopper kernel (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py:flash_attention``.  One CUDA
block per (query head, query tile, batch row) walks the key tiles in order,
keeping the running max, the running sum and the float32 accumulator of its
rows, and visits only the key tiles that :func:`tile_class` does not skip.
Which kernel serves which ``(dtype, D)`` (:data:`TILES` gives each one's
query and key tile):

* bfloat16 at D = 64, 128 and 160 (every config of the port): 128 × 128
  tiles (128 × 64 at D = 160); a producer warpgroup loads Q once and K/V
  into a two-stage shared-memory ring with TMA (tensor maps built in the
  library through the driver's ``cuTensorMapEncodeTiled``), two consumer
  warpgroups compute ``S = Q Kᵀ`` and ``O += P V`` with ``wgmma`` (P from
  registers), and only the tiles :func:`tile_class` calls masked test each
  element.  At D = 160 (pixtral) a row is staged as three 64-column boxes
  whose last 32 columns TMA fills with zeros; 128-key stages of that width
  would not fit a block's 227 KB of shared memory, 64-key ones take 144 KB;
* bfloat16 at D = 16 (the reduced test models): ``mma.sync``, 64 × 64 tiles;
* float32: plain FMA, 32 × 16 tiles, so that its sums stay float32.

The plain twin, :func:`flash_attention_plain`, runs the same tiles and the
same sentinels in PyTorch; the wrapper takes it only for CPU tensors.

Training differentiates through :class:`FlashAttentionFn`.  Its forward is
:func:`flash_attention` (the kernel's launch on CUDA tensors, counted; the
twin on CPU tensors).  Its backward is the reference's own gradient route,
not a fallback: the reference's Pallas kernel has no backward (``jax.grad``
through it fails in ``_pallas_call_jvp_rule``), so the reference trains
through its plain route, ``repro/kernels/ops.py:92-104``.  The backward
recomputes that route (:func:`ref.attention_route`) on detached copies of
``q``, ``k``, ``v`` in their dtype and returns its gradient against ``dO``;
``dk`` and ``dv`` come back at ``Hkv`` heads, summed over each group.  A
query row that sees no key has the gradient that route gives it (zero, as
the reference's), never a NaN where the reference's is finite.  Under remat
a checkpointed layer calls the forward again during the backward: a second
launch.

Semantics kept from the reference:

* query row ``r`` sits at key position ``r + (Tk - Tq)``: causal masks
  ``col <= row``, a window ``col > row - window``, and ``col < Tk`` always;
* query head ``h`` reads KV head ``h // (H / Hkv)`` (no repeated K/V);
* masked logits are ``-1e30``; ``p`` and the rescale are 0 while the running
  max is at most ``-5e29``; a row with no visible key returns 0;
* the scale ``1/sqrt(D)`` multiplies the float32 logits (the wgmma kernel
  folds ``scale·log2(e)`` into one FMA and takes ``ex2.approx``); ``p`` is
  rounded to ``v.dtype`` before the PV product, and the sum of ``p`` is not.
"""
from __future__ import annotations

import math

import torch

from . import build
from . import ref

NEG_INF = -1e30
HEAD_DIMS = (16, 64, 128, 160)
#: (query rows, key columns) of a block's tile, per (dtype, head dim)
#: (``csrc/flash_attention.cu``: the wgmma kernel at bf16 D = 64, 128 and
#: 160, ``mma.sync`` at bf16 D = 16, FMA in float32)
TILES = {
    (torch.bfloat16, 16): (64, 64),
    (torch.bfloat16, 64): (128, 128),
    (torch.bfloat16, 128): (128, 128),
    (torch.bfloat16, 160): (128, 64),
    **{(torch.float32, d): (32, 16) for d in HEAD_DIMS},
}
#: the wgmma kernel's consumer warpgroup: it classifies each key tile for its own rows
WARPGROUP_ROWS = 64
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_MAX_GRID_Y = 65535

SKIP, FULL, MASKED = 0, 1, 2


def tile_class(row0: int, rows: int, col0: int, cols: int, Tk: int, causal: bool, window: int) -> int:
    """The class of a [row0, row0 + rows) × [col0, col0 + cols) tile
    (``row0`` a key position): :data:`SKIP` when no pair is visible,
    :data:`FULL` when every pair is (no per-element mask), :data:`MASKED`
    otherwise (the diagonal, window-edge and ragged ``col >= Tk`` tiles).
    The kernel's ``tile_class`` is the same rule."""
    if (causal and col0 > row0 + rows - 1) or (window > 0 and col0 + cols - 1 <= row0 - window):
        return SKIP
    if col0 + cols <= Tk and (not causal or col0 + cols - 1 <= row0) and (window <= 0 or col0 > row0 + rows - 1 - window):
        return FULL
    return MASKED


def visited_tiles(row0: int, rows: int, Tk: int, bk: int, causal: bool, window: int) -> range:
    """The key tiles a block of ``rows`` query rows from key position
    ``row0`` visits, as the kernel's ``visited_tiles`` computes them: every
    tile :func:`tile_class` does not skip, a contiguous range (causality
    bounds the last, the window the first)."""
    last = min(Tk - 1, row0 + rows - 1) if causal else Tk - 1
    hi = 0 if last < 0 else last // bk + 1
    lo = max(0, row0 - window + 1) // bk if window > 0 else 0
    return range(lo, hi)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0, bq=None, bk=None) -> torch.Tensor:
    """``[B, H, Tq, D]`` in ``q.dtype`` from ``q [B, H, Tq, D]`` and ``k``,
    ``v [B, Hkv, Tk, D]``: the kernel's algorithm tile by tile (by default
    its tiles for ``(q.dtype, D)``), accumulated in float32; only the tiles
    :func:`tile_class` calls masked take the mask."""
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    dq, dk = TILES.get((q.dtype, D), (64, 64))
    bq, bk = bq or dq, bk or dk
    scale = 1.0 / math.sqrt(D)
    q_off = Tk - Tq
    dev = q.device
    qg = q.reshape(B, Hkv, g, Tq, D).float()  # GQA: the group's heads share their KV head
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hkv, g, Tq, D), dtype=q.dtype, device=dev)
    for i0 in range(0, Tq, bq):
        rows = torch.arange(i0, min(i0 + bq, Tq), device=dev) + q_off  # key positions of the rows
        n = rows.shape[0]
        m = torch.full((B, Hkv, g, n), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, g, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, g, n, D), dtype=torch.float32, device=dev)
        for jt in visited_tiles(i0 + q_off, bq, Tk, bk, causal, window):
            j0 = jt * bk
            cols = torch.arange(j0, min(j0 + bk, Tk), device=dev)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, i0:i0 + n], kf[:, :, j0:j0 + bk]) * scale
            if tile_class(i0 + q_off, bq, j0, bk, Tk, causal, window) == MASKED:
                mask = torch.ones((n, cols.shape[0]), dtype=torch.bool, device=dev)
                if causal:
                    mask &= cols[None, :] <= rows[:, None]
                if window > 0:
                    mask &= cols[None, :] > rows[:, None] - window
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            dead = m_new <= NEG_INF / 2
            p = torch.where(dead[..., None], 0.0, torch.exp(s - m_new[..., None]))
            alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), vf[:, :, j0:j0 + bk])
            acc = acc * alpha[..., None] + pv
            m = m_new
        denom = torch.where(l == 0.0, 1.0, l)
        out[:, :, :, i0:i0 + n] = (acc / denom[..., None]).to(q.dtype)
    return out.reshape(B, H, Tq, D)


_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "flash_attention.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("flash_attention", src), "flash_attention_launch")
    return _LIB["fn"]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """``[B, H, Tq, D]`` in ``q.dtype``.  CPU tensors take
    :func:`flash_attention_plain`; CUDA tensors launch the kernel that
    serves ``(q.dtype, D)`` (see :data:`TILES`) or raise.

    The kernel reads any layout whose last dimension is contiguous and whose
    other strides are multiples of 16 bytes (a head split of a projection
    needs no copy), and writes its output in ``[B, Tq, H, D]`` memory, so
    that merging the heads back is a view."""
    if not (q.is_cuda or k.is_cuda or v.is_cuda):
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    dev = q.device
    _check(k.device == dev and v.device == dev, "q, k and v must be on one CUDA device")
    _check(q.dtype in _DTYPE_CODE and k.dtype == q.dtype and v.dtype == q.dtype,
           f"q, k and v must all be bfloat16 or all float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape, "q must be [B, H, Tq, D], k and v [B, Hkv, Tk, D]")
    B, H, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    _check(k.shape[0] == B and k.shape[3] == D, f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    _check(D in HEAD_DIMS, f"head dim {D} is not one of {HEAD_DIMS}")
    _check(Hkv >= 1 and H % Hkv == 0, f"{H} query heads are not a multiple of {Hkv} KV heads")
    _check(Tq >= 1 and Tk >= 1 and B >= 1, "empty q or k")
    _check(window >= 0, "window must be >= 0")
    _check(-(-Tq // TILES[(q.dtype, D)][0]) <= _MAX_GRID_Y and B <= _MAX_GRID_Y, "too many query tiles or batch rows")
    esz = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(3) == 1, f"{name}'s last dimension must be contiguous")
        _check(t.data_ptr() % 16 == 0 and all(t.stride(i) * esz % 16 == 0 for i in range(3)),
               f"{name}'s pointer and strides must be multiples of 16 bytes")
    out = torch.empty((B, Tq, H, D), dtype=q.dtype, device=dev).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    build.launch(
        _launcher(),
        [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()],
        [B, H, Hkv, Tq, Tk, D, int(causal), window, _DTYPE_CODE[q.dtype], *strides],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _FA.launches += 1
    return out


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
flash_attention.launches = 0
_FA = flash_attention


#: the profiler range of :class:`FlashAttentionFn`'s backward
BACKWARD_RANGE = "flash_attention_backward"


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient (see the module docstring):
    ``FlashAttentionFn.apply(q, k, v, causal, window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        # a profiler range, so that a trace can tell this route's device time
        with torch.enable_grad(), torch.profiler.record_function(BACKWARD_RANGE):
            out = ref.attention_route(q, k, v, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), d_out)
        return dq, dk, dv, None, None
