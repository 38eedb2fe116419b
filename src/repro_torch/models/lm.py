"""Decoder-only LM, dense GQA (granite / qwen / llama / the pixtral
backbone) and uniform MoE (llama4 scout / maverick) — the twin of
``repro.models.lm``.  pixtral's patch embeddings (its vision frontend is a
stub in the reference too) are put in front of the embedded tokens.

The reference scans a stacked layer body under remat; the port runs
eagerly, so the layers are a list walked by a plain loop, and where a
gradient is recorded each period of ``cfg.remat_period`` layers is one
``torch.utils.checkpoint`` (the reference's ``nothing_saveable`` policy:
only the period's input is kept, the rest is recomputed in the backward).
Under ``sharding.partition.use_mesh(mesh)`` a MoE layer runs the
expert-parallel region (``moe.moe_apply_sharded``) over the mesh, as the
reference's ``current_mesh()`` routes it, in ``forward`` and
``decode_step``; the reference's activation hints (``shard_hint``), value
no-ops, are not called.  ``forward`` records a graph only
under grad mode with parameters that require grad: the serving callers run
it under ``torch.no_grad()``.

Entry points:
    init(cfg, generator, device, dtype)         -> params
    forward(cfg, params, tokens, window, remat, patch_embeds)
                                                -> (logits, aux)   (train / prefill)
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

from . import common
from . import moe as moe_mod
from .common import Params
from .config import ArchConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.act_dtype]


def _decoder_only(cfg: ArchConfig) -> None:
    if cfg.model_kind != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: models.lm builds decoders only; a {cfg.model_kind!r} model has a module of its own "
            "(models.registry.get_model)"
        )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(cfg: ArchConfig, generator, device, dtype: torch.dtype) -> Params:
    p = common.cast_tree({
        "attn_norm": common.rmsnorm_init(cfg.d_model, device),
        "mlp_norm": common.rmsnorm_init(cfg.d_model, device),
        "attn": common.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, device, cfg.qkv_bias
        ),
    }, dtype)
    if cfg.moe_experts > 0 and cfg.moe_every == 1:  # the reference's uniform MoE (llama4)
        p["moe"] = moe_mod.moe_init(generator, cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.moe_shared_expert,
                                    device, dtype)
    else:
        p["mlp"] = common.cast_tree(common.swiglu_init(generator, cfg.d_model, cfg.d_ff, device), dtype)
    return p


def init(cfg: ArchConfig, generator: torch.Generator, device=None, dtype: torch.dtype = torch.float32) -> Params:
    """Parameters drawn from ``generator`` (which lies on ``device``): the
    reference's distributions (projections normal · 1/sqrt(d_in), the
    embedding normal · 0.02, norms ones, biases zeros; MoE layers as
    ``moe.moe_init``), drawn in float32 and cast to ``dtype`` as they are
    drawn (a layer's dense leaves together, the expert stacks one by one),
    so that a bfloat16 model never holds its float32 draw whole.
    ``device`` is the card unless the caller names another."""
    _decoder_only(cfg)
    device = resolve_device(device)
    p = {
        "embed": common.cast_tree(common.embed_init(generator, cfg.padded_vocab, cfg.d_model, device), dtype),
        "layers": [_layer_init(cfg, generator, device, dtype) for _ in range(cfg.n_layers)],
        "final_norm": common.cast_tree(common.rmsnorm_init(cfg.d_model, device), dtype),
    }
    if not cfg.tie_embeddings:
        p["head"] = {"w": common.dense_init(generator, cfg.d_model, cfg.padded_vocab, device).to(dtype)}
    return p


def _logits(params: Params, x: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    x = common.rmsnorm(common.cast_tree(params["final_norm"], adt), x)
    if "head" in params:
        return torch.nn.functional.linear(x, params["head"]["w"].to(adt))
    return common.unembed(common.cast_tree(params["embed"], adt), x)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The layer's FFN on the normed residual: (out, the MoE aux dict or
    ``None`` for a dense layer)."""
    y = common.rmsnorm(p["mlp_norm"], x)
    if "moe" in p:
        return moe_mod.moe_dispatch_auto(p["moe"], y, cfg, mesh=current_mesh())
    return common.swiglu(p["mlp"], y), None


def _layer_apply(cfg: ArchConfig, p: Params, x: torch.Tensor, positions: torch.Tensor,
                 window: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    h, _ = common.attention(
        p["attn"],
        common.rmsnorm(p["attn_norm"], x),
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd,
        positions=positions,
        causal=True,
        window=window,
        rope_theta=cfg.rope_theta,
    )
    x = x + h
    m, auxd = _ffn(cfg, p, x)
    if auxd is None:
        return x + m, None
    return x + m, torch.stack([auxd[k].float() for k in ("load_balance", "router_z", "drop_fraction")])


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, window: int = 0,
            remat: bool = True, patch_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B, T_total, padded_vocab], aux[3]); ``aux`` is the
    reference's MoE terms (load balance, router z, drop fraction) summed
    over the layers, zeros for a dense model.  ``patch_embeds [B, Nv, d]``
    (pixtral) go in front of the embedded tokens, cast to the activation
    dtype, and the positions run over the whole ``Nv + T``.  Each layer's
    parameters are cast to the activation dtype inside its period, as the
    reference casts inside its remat body; a checkpointed period returns its
    aux beside its output."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], tokens).to(adt)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(adt), x], dim=1)
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)
    period = max(1, cfg.remat_period)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a multiple of remat_period {period}")

    def period_body(lps, y):
        aux = torch.zeros((3,), dtype=torch.float32, device=y.device)
        for lp in lps:
            y, aux_i = _layer_apply(cfg, common.cast_tree(lp, adt), y, positions, window)
            if aux_i is not None:
                aux = aux + aux_i
        return y, aux

    checkpointed = remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in common.tree_leaves(params["layers"]))
    aux = torch.zeros((3,), dtype=torch.float32, device=x.device)
    for i in range(0, cfg.n_layers, period):
        lps = params["layers"][i:i + period]
        if checkpointed:
            # the forward draws no random numbers: no RNG state to keep
            x, aux_p = torch.utils.checkpoint.checkpoint(period_body, lps, x, use_reentrant=False,
                                                         preserve_rng_state=False)
        else:
            x, aux_p = period_body(lps, x)
        aux = aux + aux_p
    return _logits(params, x, adt), aux


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["labels"]`` (where
    ``batch["loss_mask"]``, if given), in float32; the padded vocabulary's
    tail is masked out.  A MoE model adds ``0.01·load_balance +
    0.001·router_z`` (summed over its layers), as the reference.  With
    ``batch["patches"]`` (pixtral) the patches go in front of the tokens and
    their ``Nv`` logits are dropped before the loss."""
    patches = batch.get("patches")
    logits, aux = forward(cfg, params, batch["tokens"], patch_embeds=patches)
    if patches is not None:
        logits = logits[:, patches.shape[1]:]
    if cfg.padded_vocab != cfg.vocab:
        live = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    loss = common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    if cfg.moe_experts:
        loss = loss + 0.01 * aux[0] + 0.001 * aux[1]
    return loss


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, fill_len: Optional[int] = None, device=None) -> Params:
    """``cache_len`` slots; ``len`` = tokens already present (serve shapes
    start with a full cache; real serving starts at fill_len=0).  ``device``
    is the card unless another is named."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.hd)
    adt = act_dtype(cfg)
    fill = cache_len if fill_len is None else fill_len
    return {
        "k": torch.zeros(shape, dtype=adt, device=device),
        "v": torch.zeros(shape, dtype=adt, device=device),
        "len": torch.tensor(fill, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Params, token: torch.Tensor,
                window: int = 0) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence in the batch, attending over the cache.
    The new K/V are written into ``cache["k"]`` / ``cache["v"]`` in place
    (the returned cache holds the same tensors and ``len + 1``)."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], token[:, None]).to(adt)  # [B, 1, d]
    pos = cache["len"][None]
    M = cache["k"].shape[3]
    kv_valid = torch.clamp(cache["len"] + 1, max=M)
    for i, lp in enumerate(params["layers"]):
        lp = common.cast_tree(lp, adt)
        h, _ = common.attention(
            lp["attn"],
            common.rmsnorm(lp["attn_norm"], x),
            n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd,
            positions=pos,
            causal=True,
            window=window,
            rope_theta=cfg.rope_theta,
            cache=(cache["k"][i], cache["v"][i]),
            kv_valid=kv_valid,
        )
        x = x + h
        x = x + _ffn(cfg, lp, x)[0]
    logits = _logits(params, x, adt)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "len": cache["len"] + 1}
