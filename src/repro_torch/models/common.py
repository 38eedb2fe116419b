"""Shared model components: norms, rotary embeddings, attention, MLPs, the
loss (the twin of ``repro.models.common``).

Parameters are plain nested dicts of tensors, as in the reference.  A
projection weight is stored in ``nn.Linear``'s ``[d_out, d_in]`` layout and
applied with ``torch.nn.functional.linear`` (the reference stores
``[d_in, d_out]`` for ``x @ W``; ``models.interop`` converts).  Every layer
exposes ``*_init(generator, ..., device) -> params`` and an apply function.
The reference's sharding hints are no-ops on one device and have no
counterpart here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops

Params = Dict[str, Any]


def tree_items(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a parameter tree in a fixed order, paths
    joined by ``/`` (a list's entries by their index: ``layers/0/attn/wq``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree):
    return [leaf for _, leaf in tree_items(tree)]


def tree_map(fn, tree):
    """A tree of the same structure with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cast_tree(tree, dtype: torch.dtype):
    """Cast every floating tensor of a parameter tree to ``dtype`` at its use
    site.  The reference casts its float32 leaves and lets JAX promote a
    narrower leaf against a float32 activation; widening a bfloat16 leaf is
    exact, so the products agree."""
    return tree_map(lambda t: t.to(dtype) if torch.is_tensor(t) and t.is_floating_point() else t, tree)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, device, scale: Optional[float] = None) -> torch.Tensor:
    """A ``[d_out, d_in]`` weight, normal · ``1/sqrt(d_in)`` (float32)."""
    scale = scale if scale is not None else (1.0 / math.sqrt(d_in))
    return torch.randn((d_out, d_in), generator=generator, device=device, dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # variance in float32; the inverse is cast to the activation dtype before
    # the x-sized multiply, as in the reference
    var = x.square().float().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def layernorm_init(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance in float32 over the last dimension, the affine
    terms applied in float32, the result cast back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [B, H, T, hd]; positions: [T] or [B, T].  Angles in float32; the
    result is cast back to ``x.dtype``."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        ang = positions[:, None].float() * freqs[None, :]  # [T, half]
        ang = ang[None, None]  # [1, 1, T, half]
    else:
        ang = positions[..., None].float() * freqs
        ang = ang[:, None]  # [B, 1, T, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, optional bias, optional KV cache, causal/window)
# ---------------------------------------------------------------------------


def attention_init(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int, device,
                   qkv_bias: bool = False) -> Params:
    p = {
        "wq": dense_init(generator, d_model, n_heads * head_dim, device),
        "wk": dense_init(generator, d_model, n_kv * head_dim, device),
        "wv": dense_init(generator, d_model, n_kv * head_dim, device),
        "wo": dense_init(generator, n_heads * head_dim, d_model, device),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=torch.float32, device=device)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=torch.float32, device=device)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=torch.float32, device=device)
    return p


def attention(
    p: Params,
    x: torch.Tensor,  # [B, T, d]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k, v) [B, Hkv, M, hd]
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (k, v) [B, H, Te, hd]
    kv_valid=None,  # count of live kv slots (a 0-d tensor or an int)
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (out [B, T, d], new_cache).  Decode: T=1, the cache holds the
    history.  The new K/V are written into the cache tensors in place, at
    slot ``positions[0] % M`` (a ring; the reference returns updated
    arrays), and ``new_cache`` is those same tensors.  Cross attention
    (whisper's decoder): ``cross_kv`` gives K and V (the encoder's, projected
    by the caller), no cache is written and nothing is rotated; pass
    ``causal=False``.  ``use_rope=False`` (whisper, whose positions are
    sinusoids added to the embeddings) rotates neither q nor k."""
    B, T, _ = x.shape
    q = F.linear(x, p["wq"], p.get("bq")).view(B, T, n_heads, head_dim).transpose(1, 2)
    new_cache = None
    if cross_kv is not None:
        k, v = cross_kv
    else:
        k = F.linear(x, p["wk"], p.get("bk")).view(B, T, n_kv, head_dim).transpose(1, 2)
        v = F.linear(x, p["wv"], p.get("bv")).view(B, T, n_kv, head_dim).transpose(1, 2)
        if use_rope:
            pos = positions if positions is not None else torch.arange(T, device=x.device)
            k = rope(k, pos, rope_theta)
        if cache is not None:
            ck, cv = cache
            M = ck.shape[2]
            cur_len = positions[0] if positions is not None else torch.tensor(M, device=x.device)
            # the write starts at len % M, clamped so that T slots fit (as
            # dynamic_update_slice clamps); softmax does not care about slot order
            start = torch.clamp(torch.remainder(cur_len.long(), M), max=M - T)
            idx = start + torch.arange(T, device=x.device)
            ck.index_copy_(2, idx, k.to(ck.dtype))
            cv.index_copy_(2, idx, v.to(cv.dtype))
            k, v = ck, cv
            new_cache = (ck, cv)
    if use_rope and cross_kv is None:
        if positions is not None:
            qpos = positions
        else:
            qpos = torch.arange(T, device=x.device) + (k.shape[2] - T if cache is not None else 0)
        q = rope(q, qpos, rope_theta)

    out = kops.flash_attention(q, k, v, causal=causal and cache is None, window=window, kv_valid=kv_valid)
    out = out.transpose(1, 2).reshape(B, T, n_heads * head_dim)
    return F.linear(out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_init(generator, d_model: int, d_ff: int, device) -> Params:
    return {
        "wi": dense_init(generator, d_model, d_ff, device),
        "wg": dense_init(generator, d_model, d_ff, device),
        "wo": dense_init(generator, d_ff, d_model, device),
    }


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(F.silu(F.linear(x, p["wg"])) * F.linear(x, p["wi"]), p["wo"])


def gelu_mlp_init(generator, d_model: int, d_ff: int, device) -> Params:
    return {
        "wi": dense_init(generator, d_model, d_ff, device),
        "bi": torch.zeros((d_ff,), dtype=torch.float32, device=device),
        "wo": dense_init(generator, d_ff, d_model, device),
        "bo": torch.zeros((d_model,), dtype=torch.float32, device=device),
    }


def gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x Wi + bi) Wo + bo`` with the tanh approximation of gelu, as
    ``jax.nn.gelu`` computes it by default (``F.gelu``'s default is the
    exact erf form)."""
    return F.linear(F.gelu(F.linear(x, p["wi"], p["bi"]), approximate="tanh"), p["wo"], p["bo"])


# ---------------------------------------------------------------------------
# embedding / head / loss
# ---------------------------------------------------------------------------


def embed_init(generator, vocab: int, d_model: int, device) -> Params:
    return {"table": torch.randn((vocab, d_model), generator=generator, device=device, dtype=torch.float32) * 0.02}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p["table"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` in float32: ``logsumexp``
    minus the gold logit, averaged over the positions where ``mask`` is set
    (all of them without one)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
