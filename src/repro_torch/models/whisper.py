"""Whisper-style encoder-decoder (arXiv:2212.04356), the transformer backbone
(the twin of ``repro.models.whisper``).

As in the reference, the conv/mel frontend is a stub: the caller gives the
frame embeddings ``[B, enc_seq, d_model]`` that the two conv layers would
make of 30 s of audio.  From there: sinusoidal positions, ``enc_layers``
bidirectional encoder layers, and ``n_layers`` causal decoder layers with
cross attention over the encoder's output; LayerNorm and the tanh GELU MLP.
No layer rotates its queries or keys.  The layers run as an eager loop over
lists (the reference scans stacked layers); under grad mode with parameters
that require grad each layer is one ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` a layer).

Cross attention projects the encoder's output to K and V in every decoder
layer on every call, ``decode_step`` included (the reference's
``_dec_layer``); nothing caches them.  ``decode_step`` embeds the token
without a position embedding, as the reference does, so stepwise decode is
not the teacher-forced ``forward`` (ROADMAP.md §3).  The self-attention
cache is written in place.

Entry points (as ``models.lm``; ``forward`` takes and ignores ``window``):
    init(cfg, generator, device, dtype)                 -> params
    encode(cfg, params, frames, remat)                  -> enc_out [B, enc_seq, d]
    forward(cfg, params, tokens, frames, window, remat) -> (logits, aux)
    loss_fn(cfg, params, batch)                         -> scalar
    init_cache(cfg, batch, cache_len, fill_len)         -> decode cache
    decode_step(cfg, params, cache, tok)                -> (logits, cache)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.data.table import resolve_device

from . import common
from .common import Params
from .config import ArchConfig
from .lm import act_dtype


def _sinusoid(T: int, d: int, device=None) -> torch.Tensor:
    """``[T, d]`` float32 positions: the sines of ``pos / 10000^(2i/d)`` in
    the first half, their cosines in the second."""
    pos = torch.arange(T, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _enc_layer_init(cfg: ArchConfig, generator, device, dtype: torch.dtype) -> Params:
    return common.cast_tree({
        "attn_norm": common.layernorm_init(cfg.d_model, device),
        "mlp_norm": common.layernorm_init(cfg.d_model, device),
        "attn": common.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, device),
        "mlp": common.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, device),
    }, dtype)


def _dec_layer_init(cfg: ArchConfig, generator, device, dtype: torch.dtype) -> Params:
    return common.cast_tree({
        "self_norm": common.layernorm_init(cfg.d_model, device),
        "cross_norm": common.layernorm_init(cfg.d_model, device),
        "mlp_norm": common.layernorm_init(cfg.d_model, device),
        "self_attn": common.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, device),
        # its wk / wv project the encoder's output (cross attention is MHA)
        "cross_attn": common.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_heads, cfg.hd, device),
        "mlp": common.gelu_mlp_init(generator, cfg.d_model, cfg.d_ff, device),
    }, dtype)


def init(cfg: ArchConfig, generator: torch.Generator, device=None, dtype: torch.dtype = torch.float32) -> Params:
    """The reference's tree and distributions (projections normal ·
    1/sqrt(d_in), the embedding normal · 0.02, layernorms ones and zeros,
    MLP biases zeros), drawn in float32 and cast to ``dtype`` a layer at a
    time.  ``device`` is the card unless the caller names another."""
    device = resolve_device(device)
    return {
        "embed": common.cast_tree(common.embed_init(generator, cfg.padded_vocab, cfg.d_model, device), dtype),
        "enc_layers": [_enc_layer_init(cfg, generator, device, dtype) for _ in range(cfg.enc_layers)],
        "dec_layers": [_dec_layer_init(cfg, generator, device, dtype) for _ in range(cfg.n_layers)],
        "enc_norm": common.cast_tree(common.layernorm_init(cfg.d_model, device), dtype),
        "dec_norm": common.cast_tree(common.layernorm_init(cfg.d_model, device), dtype),
    }


def _run(layers, x: torch.Tensor, fn, remat: bool) -> torch.Tensor:
    """``x`` through ``fn(lp, x)`` for each layer, a checkpoint a layer where
    a gradient is recorded."""
    checkpointed = remat and torch.is_grad_enabled() and any(t.requires_grad for t in common.tree_leaves(layers))
    for lp in layers:
        if checkpointed:
            # the layers draw no random numbers: no RNG state to keep
            x = torch.utils.checkpoint.checkpoint(fn, lp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = fn(lp, x)
    return x


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encode(cfg: ArchConfig, params: Params, frames: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """frames: ``[B, enc_seq, d]`` from the stub frontend; the positions are
    added in float32 and the sum cast to the activation dtype.  The layers
    attend without a mask and without rope."""
    adt = act_dtype(cfg)
    x = (frames + _sinusoid(frames.shape[1], cfg.d_model, frames.device)[None]).to(adt)

    def layer(lp, y):
        lp = common.cast_tree(lp, adt)
        h, _ = common.attention(
            lp["attn"],
            common.layernorm(lp["attn_norm"], y),
            n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads,
            head_dim=cfg.hd,
            causal=False,
            use_rope=False,
        )
        y = y + h
        return y + common.gelu_mlp(lp["mlp"], common.layernorm(lp["mlp_norm"], y))

    x = _run(params["enc_layers"], x, layer, remat)
    return common.layernorm(params["enc_norm"], x)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _dec_layer(
    cfg: ArchConfig,
    lp: Params,
    x: torch.Tensor,
    enc_out: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Causal self attention (through the ring cache when one is given), cross
    attention over ``enc_out`` (K and V projected here, on every call), the
    MLP; returns ``(x, the self-attention cache)``."""
    kv_valid = None
    if cache is not None and positions is not None:
        kv_valid = torch.clamp(positions[0] + 1, max=cache[0].shape[2])
    h, new_kv = common.attention(
        lp["self_attn"],
        common.layernorm(lp["self_norm"], x),
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads,
        head_dim=cfg.hd,
        positions=positions,
        causal=True,
        use_rope=False,
        cache=cache,
        kv_valid=kv_valid,
    )
    x = x + h
    B, Te, _ = enc_out.shape
    ca = lp["cross_attn"]
    k = F.linear(enc_out, ca["wk"]).view(B, Te, cfg.n_heads, cfg.hd).transpose(1, 2)
    v = F.linear(enc_out, ca["wv"]).view(B, Te, cfg.n_heads, cfg.hd).transpose(1, 2)
    h, _ = common.attention(
        ca,
        common.layernorm(lp["cross_norm"], x),
        n_heads=cfg.n_heads,
        n_kv=cfg.n_heads,
        head_dim=cfg.hd,
        causal=False,
        use_rope=False,
        cross_kv=(k, v),
    )
    x = x + h
    x = x + common.gelu_mlp(lp["mlp"], common.layernorm(lp["mlp_norm"], x))
    return x, new_kv


def _logits(params: Params, x: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    x = common.layernorm(common.cast_tree(params["dec_norm"], adt), x)
    return common.unembed(common.cast_tree(params["embed"], adt), x)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, frames: torch.Tensor, window: int = 0,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, T, padded_vocab], zeros(3))`` of ``tokens [B, T]``
    (teacher-forced, sinusoidal positions added to their embeddings) over
    the encoded ``frames``."""
    adt = act_dtype(cfg)
    enc_out = encode(cfg, params, frames, remat=remat)
    x = common.embed(params["embed"], tokens).to(adt)
    x = x + _sinusoid(tokens.shape[1], cfg.d_model, x.device)[None].to(adt)

    def layer(lp, y):
        return _dec_layer(cfg, common.cast_tree(lp, adt), y, enc_out)[0]

    x = _run(params["dec_layers"], x, layer, remat)
    return _logits(params, x, adt), torch.zeros((3,), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["labels"]`` (where
    ``batch["loss_mask"]``, if given) over ``batch["tokens"]`` and
    ``batch["frames"]``, in float32; the padded vocabulary's tail is masked
    out."""
    logits, _ = forward(cfg, params, batch["tokens"], batch["frames"])
    if cfg.padded_vocab != cfg.vocab:
        live = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    return common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode (serve) path
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, fill_len: Optional[int] = None, device=None) -> Params:
    """The decoder's self-attention ring (``cache_len`` slots a layer), the
    encoder's output as cross-attention memory (zeros until the caller puts
    ``encode(frames)`` there, as the reference's server leaves it) and
    ``len`` = tokens already present (``cache_len`` unless ``fill_len`` is
    given).  ``device`` is the card unless another is named."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.hd)
    adt = act_dtype(cfg)
    return {
        "k": torch.zeros(shape, dtype=adt, device=device),
        "v": torch.zeros(shape, dtype=adt, device=device),
        "enc_out": torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=adt, device=device),
        "len": torch.tensor(cache_len if fill_len is None else fill_len, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Params, token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence, attending over the self-attention cache
    and ``cache["enc_out"]``.  The token's embedding gets no position (the
    reference's decode adds none).  The new K/V are written into
    ``cache["k"]`` / ``cache["v"]`` in place (the returned cache holds the
    same tensors and ``len + 1``)."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], token[:, None]).to(adt)  # [B, 1, d]
    pos = cache["len"][None]
    enc_out = cache["enc_out"]
    for i, lp in enumerate(params["dec_layers"]):
        x, _ = _dec_layer(cfg, common.cast_tree(lp, adt), x, enc_out, positions=pos,
                          cache=(cache["k"][i], cache["v"][i]))
    logits = _logits(params, x, adt)
    return logits[:, 0], {"k": cache["k"], "v": cache["v"], "enc_out": enc_out, "len": cache["len"] + 1}
