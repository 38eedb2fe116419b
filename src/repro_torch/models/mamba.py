"""Mamba (selective SSM) layer, the state-space part of Jamba (the twin of
``repro.models.mamba``).

A Mamba-1 block: in-projection → causal depthwise conv → selective scan
(Δ, B and C computed from the data) → gate → out-projection.  The scan
carries ``h: [B, d_inner, d_state]`` (float32) across time; it runs through
``kernels/ops.py:selective_scan`` (the hand-written kernel on the card, the
reference's per-step loop on the CPU).

The dtype flow is the reference's: ``dt``, ``Bt`` and ``Ct`` are cast to
the stream's dtype, the state is float32, the ``D`` skip term is added to
the float32 ``y`` before it is cast to the input's dtype.  In decode a
float32 conv tail promotes the stream to float32 (as JAX promotes it); a
projection weight is then widened to the stream's dtype, which is exact.

Decode: one step of the state update (O(1) in the context length) with a
conv tail of ``d_conv - 1`` columns.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

from . import common
from .common import Params
from .config import ArchConfig


def layer_init(cfg: ArchConfig, generator, device, dtype: torch.dtype = torch.float32) -> Params:
    """The reference's distributions (``dt_bias`` the inverse softplus of a
    log-uniform draw in [1e-3, 1e-1], ``A_log = log(1 .. ds)`` on every
    channel, ``D`` ones), each leaf cast to ``dtype`` before the next draw."""
    d = cfg.d_model
    d_in = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dt_rank = max(1, d // 16)
    lo, hi = math.log(1e-3), math.log(1e-1)
    p = {}
    p["in_proj"] = common.dense_init(generator, d, 2 * d_in, device).to(dtype)
    p["conv_w"] = (torch.randn((cfg.mamba_conv, d_in), generator=generator, device=device) * 0.2).to(dtype)
    p["conv_b"] = torch.zeros((d_in,), device=device, dtype=dtype)
    p["x_proj"] = common.dense_init(generator, d_in, dt_rank + 2 * ds, device).to(dtype)
    p["dt_proj"] = common.dense_init(generator, dt_rank, d_in, device, scale=dt_rank**-0.5).to(dtype)
    u = torch.rand((d_in,), generator=generator, device=device) * (hi - lo) + lo
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u))).to(dtype)
    p["A_log"] = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=device))[None, :].repeat(d_in, 1).to(dtype)
    p["D"] = torch.ones((d_in,), device=device, dtype=dtype)
    p["out_proj"] = common.dense_init(generator, d_in, d, device).to(dtype)
    return p


def _conv_causal(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time: ``x [B, T, d_in]``, kernel ``[K,
    d_in]``.  ``tail`` carries the last K-1 inputs for decode."""
    K = w.shape[0]
    xp = F.pad(x, (0, 0, K - 1, 0)) if tail is None else torch.cat([tail, x], dim=1)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * w[i] for i in range(K)) + b
    return out, xp[:, xp.shape[1] - (K - 1):]


def _ssm_scan(p: Params, xc: torch.Tensor, ds: int,
              h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, T, d_in] float32 with the D term, h_T)`` of the post-conv
    activations ``xc``."""
    dt_rank = p["dt_proj"].shape[1]
    proj = F.linear(xc, p["x_proj"].to(xc.dtype))  # [B, T, dt_rank + 2·ds]
    dt = F.softplus(F.linear(proj[..., :dt_rank], p["dt_proj"].to(xc.dtype)) + p["dt_bias"]).to(xc.dtype)
    Bt = proj[..., dt_rank:dt_rank + ds].to(xc.dtype)
    Ct = proj[..., dt_rank + ds:].to(xc.dtype)
    A = -torch.exp(p["A_log"])  # [d_in, ds], in the parameters' dtype as the reference rounds it
    y, h = kops.selective_scan(xc, dt, Bt, Ct, A, h0)
    return y + xc * p["D"], h


def apply(p: Params, x: torch.Tensor, cfg: ArchConfig,
          state: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """``(out [B, T, d] in x.dtype, new state or None)``; ``state`` holds the
    conv tail ``conv`` and the scan's ``h`` (decode)."""
    d_in = cfg.mamba_expand * cfg.d_model
    xi = F.linear(x, p["in_proj"])
    xz, z = xi[..., :d_in], xi[..., d_in:]
    xc, new_tail = _conv_causal(p["conv_w"], p["conv_b"], xz, state["conv"] if state is not None else None)
    xc = F.silu(xc)
    y, h_fin = _ssm_scan(p, xc, cfg.mamba_d_state, state["h"] if state is not None else None)
    y = y.to(x.dtype)
    out = F.linear(y * F.silu(z), p["out_proj"]).to(x.dtype)
    return out, ({"conv": new_tail, "h": h_fin} if state is not None else None)


def init_state(cfg: ArchConfig, batch: int, device) -> Dict[str, torch.Tensor]:
    d_in = cfg.mamba_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.mamba_conv - 1, d_in), dtype=torch.float32, device=device),
        "h": torch.zeros((batch, d_in, cfg.mamba_d_state), dtype=torch.float32, device=device),
    }
