"""Jamba, the hybrid Mamba + attention + MoE LM (the twin of
``repro.models.jamba``).

A period of ``attn_period`` (8) sub-layers: Mamba everywhere but position
``period // 2``, which is attention; the FFN is MoE (``models.moe``, no
shared expert) at odd positions and a dense swiglu at even ones.  Under
``sharding.partition.use_mesh(mesh)`` the MoE FFN runs the expert-parallel
region (``moe.moe_apply_sharded``), as the reference's does.  The
reference scans over periods, each a remat body; the port keeps the
periods in a list, and under grad mode each period is one
``torch.utils.checkpoint``, as ``lm.forward`` does.

Above 32,768 tokens the attention layers take a window of
``cfg.long_window`` (4,096), which bounds the decode cache: ``init_cache``
holds ``min(cache_len, long_window)`` slots, written as a ring at ``len %
M``.  The Mamba layers carry their O(1) state (conv tail and scan state,
float32).

Entry points (as ``models.lm``):
    init(cfg, generator, device, dtype)         -> params
    forward(cfg, params, tokens, window, remat) -> (logits, aux)
    loss_fn(cfg, params, batch)                 -> scalar
    init_cache(cfg, batch, cache_len, fill_len) -> decode cache
    decode_step(cfg, params, cache, tok)        -> (logits, cache)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.data.table import resolve_device
from repro_torch.sharding.partition import current_mesh

from . import common, mamba
from . import moe as moe_mod
from .common import Params
from .config import ArchConfig
from .lm import act_dtype

LONG_CONTEXT = 32768  # above this many tokens the attention takes ``long_window``


def _sub_init(cfg: ArchConfig, i: int, generator, device, dtype: torch.dtype) -> Params:
    """Sub-layer ``i`` of a period: attention at ``attn_period // 2``, Mamba
    elsewhere; MoE (no shared expert) at odd ``i``, a swiglu at even ones.
    Each leaf is cast to ``dtype`` as drawn."""
    sub = common.cast_tree({"pre_norm": common.rmsnorm_init(cfg.d_model, device),
                            "ffn_norm": common.rmsnorm_init(cfg.d_model, device)}, dtype)
    if i == cfg.attn_period // 2:
        sub["attn"] = common.cast_tree(
            common.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, device), dtype)
    else:
        sub["mamba"] = mamba.layer_init(cfg, generator, device, dtype)
    if i % 2 == 1 and cfg.moe_experts > 0:
        sub["moe"] = moe_mod.moe_init(generator, cfg.d_model, cfg.d_ff, cfg.moe_experts, False, device, dtype)
    else:
        sub["mlp"] = common.cast_tree(common.swiglu_init(generator, cfg.d_model, cfg.d_ff, device), dtype)
    return sub


def _period_init(cfg: ArchConfig, generator, device, dtype: torch.dtype) -> Params:
    """One period: ``attn_period`` sub-layers."""
    return {f"sub{i}": _sub_init(cfg, i, generator, device, dtype) for i in range(cfg.attn_period)}


def n_periods(cfg: ArchConfig) -> int:
    if cfg.attn_period <= 0 or cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a multiple of attn_period {cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def init(cfg: ArchConfig, generator: torch.Generator, device=None, dtype: torch.dtype = torch.float32) -> Params:
    """The reference's distributions (``mamba.layer_init``,
    ``moe.moe_init``, the attention and swiglu as ``models.common`` draws
    them), drawn in float32 and cast to ``dtype`` leaf by leaf or a small
    block at a time."""
    device = resolve_device(device)
    n = n_periods(cfg)
    return {
        "embed": common.cast_tree(common.embed_init(generator, cfg.padded_vocab, cfg.d_model, device), dtype),
        "periods": [_period_init(cfg, generator, device, dtype) for _ in range(n)],
        "final_norm": common.cast_tree(common.rmsnorm_init(cfg.d_model, device), dtype),
    }


def _sub_apply(cfg: ArchConfig, sub: Params, x: torch.Tensor, window: int, state: Optional[Params] = None,
               positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """One sub-layer: ``(x + mixer + FFN, the mixer's new state or None)``.
    With a ``state`` (decode) the attention writes its K/V into the ring in
    place and attends over ``min(len + 1, M)`` live slots."""
    h_in = common.rmsnorm(sub["pre_norm"], x)
    new_state: Optional[Params] = None
    if "attn" in sub:
        cache = (state["k"], state["v"]) if state is not None else None
        kv_valid = None
        if cache is not None:
            # the ring's size is the window; only unfilled slots are masked
            cur = positions[0] if positions is not None else torch.zeros((), dtype=torch.int32, device=x.device)
            kv_valid = torch.clamp(cur + 1, max=cache[0].shape[2])
        h, new_kv = common.attention(
            sub["attn"], h_in, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd, positions=positions,
            causal=True, window=0 if cache is not None else window, rope_theta=cfg.rope_theta, cache=cache,
            kv_valid=kv_valid,
        )
        if state is not None:
            new_state = {"k": new_kv[0], "v": new_kv[1]}
    else:
        h, new_state = mamba.apply(sub["mamba"], h_in, cfg, state=state)
    x = x + h
    f_in = common.rmsnorm(sub["ffn_norm"], x)
    if "moe" in sub:
        f, _ = moe_mod.moe_dispatch_auto(sub["moe"], f_in, cfg, mesh=current_mesh())
    else:
        f = common.swiglu(sub["mlp"], f_in)
    return x + f, new_state


def _logits(params: Params, x: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    x = common.rmsnorm(common.cast_tree(params["final_norm"], adt), x)
    return common.unembed(common.cast_tree(params["embed"], adt), x)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, window: int = 0,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, T, padded_vocab], zeros(3))``: the reference returns no
    aux from jamba's MoE layers."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], tokens).to(adt)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def period(pp, y):
        pp = common.cast_tree(pp, adt)
        for i in range(cfg.attn_period):
            y, _ = _sub_apply(cfg, pp[f"sub{i}"], y, window, positions=positions)
        return y

    checkpointed = remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in common.tree_leaves(params["periods"]))
    for pp in params["periods"]:
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(period, pp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = period(pp, x)
    return _logits(params, x, adt), torch.zeros((3,), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross entropy; above 32,768 tokens the attention takes
    the ``long_window``."""
    window = cfg.long_window if batch["tokens"].shape[1] > LONG_CONTEXT else 0
    logits, _ = forward(cfg, params, batch["tokens"], window=window)
    if cfg.padded_vocab != cfg.vocab:
        live = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    return common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode: Mamba states beside windowed attention caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, fill_len: Optional[int] = None, device=None) -> Params:
    """The attention layers hold ``min(cache_len, long_window)`` slots above
    32,768 tokens (``cache_len`` below); the Mamba layers' conv tails and
    scan states are float32.  ``len`` = tokens already present
    (``cache_len`` unless ``fill_len`` is given)."""
    device = resolve_device(device)
    P = n_periods(cfg)
    M = min(cache_len, cfg.long_window) if cache_len > LONG_CONTEXT else cache_len
    d_in = cfg.mamba_expand * cfg.d_model
    adt = act_dtype(cfg)
    kv = (P, batch, cfg.n_kv_heads, M, cfg.hd)
    return {
        "k": torch.zeros(kv, dtype=adt, device=device),
        "v": torch.zeros(kv, dtype=adt, device=device),
        "conv": torch.zeros((P, cfg.attn_period - 1, batch, cfg.mamba_conv - 1, d_in), dtype=torch.float32,
                            device=device),
        "h": torch.zeros((P, cfg.attn_period - 1, batch, d_in, cfg.mamba_d_state), dtype=torch.float32,
                         device=device),
        "len": torch.tensor(cache_len if fill_len is None else fill_len, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Params, token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence.  The K/V ring, conv tails and scan
    states are updated in place (the returned cache holds the same tensors
    and ``len + 1``)."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], token[:, None]).to(adt)
    pos = cache["len"][None]
    for p, pp in enumerate(params["periods"]):
        pp = common.cast_tree(pp, adt)
        mi = 0
        for i in range(cfg.attn_period):
            sub = pp[f"sub{i}"]
            if "attn" in sub:
                x, _ = _sub_apply(cfg, sub, x, 0, state={"k": cache["k"][p], "v": cache["v"][p]}, positions=pos)
            else:
                x, st = _sub_apply(cfg, sub, x, 0, state={"conv": cache["conv"][p, mi], "h": cache["h"][p, mi]},
                                   positions=pos)
                cache["conv"][p, mi].copy_(st["conv"])
                cache["h"][p, mi].copy_(st["h"])
                mi += 1
    logits = _logits(params, x, adt)
    return logits[:, 0], {**cache, "len": cache["len"] + 1}
