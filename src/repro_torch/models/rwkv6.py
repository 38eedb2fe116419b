"""RWKV-6 ("Finch"), the attention-free LM with data-dependent decay (the
twin of ``repro.models.rwkv6``).

The wkv6 recurrence per head (head size ``hs``):

    S_t   = diag(w_t) · S_{t-1} + k_tᵀ v_t          (state: [hs, hs])
    out_t = r_t · (S_{t-1} + diag(u) · k_tᵀ v_t)

with the per-channel decay ``w_t = exp(-exp(w0 + x̃_t W_w))`` computed from
the data, token-shift input mixing and a squared-ReLU channel-mix FFN.

``wkv6_chunked`` keeps the reference's chunked algorithm (chunks of 16 by
default, the per-step log-decay clamped at ``LOG_W_MIN`` so that
``exp(±cumsum log w)`` stays inside float32 within a chunk, the padded tail
w = 1 and k = v = 0, the state in float32).  The reference runs it as a
``lax.scan`` over chunks; the port computes every chunk-local term (the
cumulative log-decay, ``r_in``, the strict-lower intra-chunk product, the
bonus, each chunk's ``k_scaled ⊗ v``) for all chunks in batched ops, and
only the carried state, one ``addcmul`` a chunk, runs in a loop.  The sums
are the reference's, taken in another order.  It has no Pallas kernel in
the reference, so it stays plain PyTorch.

Entry points (as ``models.lm``; ``forward`` takes and ignores ``window``,
so that ``Model.forward`` serves every kind):
    init(cfg, generator, device, dtype)         -> params
    forward(cfg, params, tokens, window, remat) -> (logits, aux)
    loss_fn(cfg, params, batch)                 -> scalar
    init_cache(cfg, batch, cache_len, fill_len) -> O(1) state
    decode_step(cfg, params, cache, tok)        -> (logits, cache)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.profiler import record_function

from repro_torch.data.table import resolve_device

from . import common
from .common import Params
from .config import ArchConfig
from .lm import act_dtype

LOG_W_MIN = -4.5  # per-step decay clamp: chunk·|log w| stays inside float32's exp range
#: the profiler range around ``wkv6_chunked`` in ``timemix``, so that a trace
#: splits a layer's device time
WKV_RANGE = "rwkv.wkv"


# ---------------------------------------------------------------------------
# wkv6 core
# ---------------------------------------------------------------------------


def wkv6_chunked(
    r: torch.Tensor,  # [B, H, T, hs]
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # decay in (0, 1), same shape
    u: torch.Tensor,  # [H, hs] bonus
    s0: Optional[torch.Tensor] = None,  # [B, H, hs, hs] float32
    chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, T, hs] in r.dtype, final state [B, H, hs, hs] float32)``."""
    B, H, T, hs = r.shape
    pad = -T % chunk
    if pad:
        # the padded tail: w = 1 (log 0), k = v = 0, so it never touches the state
        r, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, pad), value=1.0)
    n = (T + pad) // chunk

    def chunks(t):
        return t.reshape(B, H, n, chunk, hs)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    lw = torch.clamp(torch.log(chunks(w).float()), min=LOG_W_MIN)
    cum = torch.cumsum(lw, dim=3)  # inclusive
    last = cum[:, :, :, -1:, :]
    vf = vc.float()
    # reading the state: r_i scaled by the decay down to its chunk's start
    r_in = rc * torch.exp(cum - lw)
    # within a chunk: the strict-lower decay-weighted attention, exp(cum_ex_i - cum_j)
    a = torch.einsum("bhnik,bhnjk->bhnij", r_in, kc * torch.exp(-cum))
    a = torch.tril(a, diagonal=-1)
    out = torch.einsum("bhnij,bhnjv->bhniv", a, vf)
    bonus = (rc * (kc * u[None, :, None, None, :])).sum(-1)  # the diagonal, in the activation dtype
    # each chunk's contribution to the state, laid [n, B, H, hs, hs] for the loop
    kv = torch.einsum("bhnck,bhncv->nbhkv", kc * torch.exp(last - cum), vf)
    decay = torch.exp(last[:, :, :, 0, :]).permute(2, 0, 1, 3)[..., None]  # [n, B, H, hs, 1]
    s = s0 if s0 is not None else torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    starts = []
    for i in range(n):  # the carried state: the one sequential part
        starts.append(s)
        s = torch.addcmul(kv[i], decay[i], s)
    out = out + torch.einsum("bhnck,nbhkv->bhncv", r_in, torch.stack(starts)) + bonus[..., None] * vc
    out = out.reshape(B, H, n * chunk, hs)
    if pad:
        out = out[:, :, :T]
    return out.to(r.dtype), s


def wkv6_step(r, k, v, w, u, s) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-timestep reference (r, k, v, w ``[B, H, hs]``, ``s [B, H,
    hs, hs]``): ``(out, new state)``."""
    w = torch.exp(torch.clamp(torch.log(w.float()), min=LOG_W_MIN))
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, s + u[None, :, :, None] * kv)
    return out, w[..., None] * s + kv


# ---------------------------------------------------------------------------
# the RWKV-6 block
# ---------------------------------------------------------------------------


def _timemix_init(generator, d: int, hs: int, device) -> Params:
    return {
        "mu": torch.rand((5, d), generator=generator, device=device),  # shift-mix for r, k, v, w, g
        "wr": common.dense_init(generator, d, d, device),
        "wk": common.dense_init(generator, d, d, device),
        "wv": common.dense_init(generator, d, d, device),
        "wg": common.dense_init(generator, d, d, device),
        "w0": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "ww": common.dense_init(generator, d, d, device, scale=0.01),  # the data-dependent decay
        "u": torch.randn((d // hs, hs), generator=generator, device=device) * 0.1,
        "wo": common.dense_init(generator, d, d, device),
        "ln_x": common.layernorm_init(d, device),
    }


def _channelmix_init(generator, d: int, d_ff: int, device) -> Params:
    return {
        "mu": torch.rand((2, d), generator=generator, device=device),
        "wk": common.dense_init(generator, d, d_ff, device),
        "wv": common.dense_init(generator, d_ff, d, device),
        "wr": common.dense_init(generator, d, d, device),
    }


def layer_init(cfg: ArchConfig, generator, device, dtype: torch.dtype = torch.float32) -> Params:
    return common.cast_tree({
        "norm1": common.layernorm_init(cfg.d_model, device),
        "norm2": common.layernorm_init(cfg.d_model, device),
        "tmix": _timemix_init(generator, cfg.d_model, cfg.rwkv_head_size, device),
        "cmix": _channelmix_init(generator, cfg.d_model, cfg.d_ff, device),
    }, dtype)


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token shift: the previous timestep's activations ([B, T, d])."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def timemix(p: Params, x: torch.Tensor, hs: int, state: Optional[torch.Tensor] = None,
            x_last: Optional[torch.Tensor] = None, chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, T, d], new wkv state)`` of ``x [B, T, d]``."""
    B, T, d = x.shape
    H = d // hs
    dx = _shift(x, x_last) - x

    def mix(i):
        return x + dx * p["mu"][i]

    def heads(t):
        return t.view(B, T, H, hs).transpose(1, 2)

    r = heads(F.linear(mix(0), p["wr"]))
    k = heads(F.linear(mix(1), p["wk"]))
    v = heads(F.linear(mix(2), p["wv"]))
    w = heads(torch.exp(-torch.exp(p["w0"] + F.linear(mix(3), p["ww"]))))
    g = F.silu(F.linear(mix(4), p["wg"]))
    with record_function(WKV_RANGE):
        out, s_new = wkv6_chunked(r, k, v, w, p["u"], s0=state, chunk=chunk)
    out = out.transpose(1, 2).reshape(B, T, d).to(x.dtype)
    out = common.layernorm(p["ln_x"], out) * g
    return F.linear(out, p["wo"]).to(x.dtype), s_new


def channelmix(p: Params, x: torch.Tensor, x_last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared-ReLU FFN with a receptance gate (the RWKV channel mix)."""
    dx = _shift(x, x_last) - x
    xk = x + dx * p["mu"][0]
    xr = x + dx * p["mu"][1]
    k = torch.square(F.relu(F.linear(xk, p["wk"])))
    return torch.sigmoid(F.linear(xr, p["wr"])) * F.linear(k, p["wv"])


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, generator: torch.Generator, device=None, dtype: torch.dtype = torch.float32) -> Params:
    """The reference's distributions (``mu`` uniform, projections normal ·
    1/sqrt(d_in), the decay projection · 0.01, ``w0`` 0.5, ``u`` normal ·
    0.1, layernorms ones and zeros, the embedding normal · 0.02), drawn in
    float32 and cast to ``dtype`` a layer at a time."""
    device = resolve_device(device)
    return {
        "embed": common.cast_tree(common.embed_init(generator, cfg.padded_vocab, cfg.d_model, device), dtype),
        "layers": [layer_init(cfg, generator, device, dtype) for _ in range(cfg.n_layers)],
        "final_norm": common.cast_tree(common.layernorm_init(cfg.d_model, device), dtype),
    }


def _layer(cfg: ArchConfig, lp: Params, y: torch.Tensor) -> torch.Tensor:
    t, _ = timemix(lp["tmix"], common.layernorm(lp["norm1"], y), cfg.rwkv_head_size, chunk=cfg.scan_chunk)
    y = y + t
    return y + channelmix(lp["cmix"], common.layernorm(lp["norm2"], y))


def _logits(params: Params, x: torch.Tensor, adt: torch.dtype) -> torch.Tensor:
    x = common.layernorm(common.cast_tree(params["final_norm"], adt), x)
    return common.unembed(common.cast_tree(params["embed"], adt), x)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor, window: int = 0,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(logits [B, T, padded_vocab], zeros(3))``.  Under grad mode with
    parameters that require grad each layer is one ``torch.utils.checkpoint``
    (the reference's ``jax.checkpoint`` a layer)."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], tokens).to(adt)

    def layer(lp, y):
        return _layer(cfg, common.cast_tree(lp, adt), y)

    checkpointed = remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in common.tree_leaves(params["layers"]))
    for lp in params["layers"]:
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(layer, lp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = layer(lp, x)
    return _logits(params, x, adt), torch.zeros((3,), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    logits, _ = forward(cfg, params, batch["tokens"])
    if cfg.padded_vocab != cfg.vocab:
        live = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(live, logits, -1e30)
    return common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# decode: the O(1) recurrent state
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, fill_len: Optional[int] = None, device=None) -> Params:
    """A layer's wkv state ``[H, hs, hs]`` a sequence (float32) and its two
    token-shift carries (the activation dtype); the size does not depend on
    ``cache_len``.  ``len`` = tokens already seen (``cache_len`` unless
    ``fill_len`` is given)."""
    device = resolve_device(device)
    H, hs = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    adt = act_dtype(cfg)
    return {
        "s": torch.zeros((cfg.n_layers, batch, H, hs, hs), dtype=torch.float32, device=device),
        "x_t": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=adt, device=device),
        "x_c": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=adt, device=device),
        "len": torch.tensor(cache_len if fill_len is None else fill_len, dtype=torch.int32, device=device),
    }


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Params, cache: Params, token: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One token for every sequence, through ``timemix(..., chunk=1)`` as the
    reference's decode runs it.  The state and carries are updated in place
    (the returned cache holds the same tensors and ``len + 1``)."""
    adt = act_dtype(cfg)
    x = common.embed(params["embed"], token[:, None]).to(adt)  # [B, 1, d]
    for i, lp in enumerate(params["layers"]):
        lp = common.cast_tree(lp, adt)
        yn = common.layernorm(lp["norm1"], x)
        t, s_new = timemix(lp["tmix"], yn, cfg.rwkv_head_size, state=cache["s"][i], x_last=cache["x_t"][i], chunk=1)
        x = x + t
        yn2 = common.layernorm(lp["norm2"], x)
        x = x + channelmix(lp["cmix"], yn2, x_last=cache["x_c"][i])
        cache["s"][i].copy_(s_new)
        cache["x_t"][i].copy_(yn[:, 0])
        cache["x_c"][i].copy_(yn2[:, 0])
    logits = _logits(params, x, adt)
    return logits[:, 0], {**cache, "len": cache["len"] + 1}
