"""AdamW, its schedule and error-feedback gradient compression (the twin of
``repro.train.optimizer``).

* AdamW with decoupled weight decay, global-norm clipping, and a
  warmup + cosine schedule;
* error-feedback int8 gradient compression: ``compress_grads`` quantizes
  (grad + error carry) to int8, one scale a tensor of the reference's
  layout (a parameter's layers together), and keeps the quantization
  residual as the next step's carry.  The single-process form round-trips
  the quantizer; the distributed form (``compressed_psum``) sums the
  shards' int8 payloads (dequantized, in shard order) over a mesh axis of
  ``exec.distributed``, each shard keeping its own carry.

The reference's update is functional and donates its inputs to XLA, which
reuses their buffers; the port updates ``params`` and the state's tensors
in place under ``torch.no_grad()`` (a second copy of the weights and
moments would not fit beside the first at llama3.2-3b on one card).  With
compression the carry is updated in place as well, and the compressed
gradient is held as int8 codes, dequantized one leaf at a time.  The
moment math runs in float32 and is stored in ``moments_dtype``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Tuple

import torch

from repro_torch.models.common import tree_items, tree_leaves, tree_map

Pytree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress: bool = False  # error-feedback int8 gradient exchange
    moments_dtype: str = "float32"  # "bfloat16" halves Adam state


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in float32: linear warmup,
    then a cosine from 1 to 0.1 of ``lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_state(params: Pytree, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments (and carry, with compression) in ``cfg.moments_dtype``
    beside each parameter, and ``step`` 0 as a 0-d int32 tensor."""
    mdt = _DTYPES[cfg.moments_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = tree_leaves(params)[0].device
    state = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.compress:
        state["ef"] = tree_map(zeros, params)  # error-feedback carry
    return state


# ---------------------------------------------------------------------------
# int8 quantizer (per-tensor absmax scaling)
# ---------------------------------------------------------------------------


def _quantize(x: torch.Tensor, amax=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``x`` and their scale, ``max(|x|) / 127`` (or
    ``amax / 127`` where the caller gives the absmax of a larger tensor)."""
    scale = torch.clamp(x.abs().max() if amax is None else amax, min=1e-12) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _scale_groups(tree: Pytree) -> List[List[int]]:
    """Leaf indices that share one quantization scale: a parameter's entries
    in every layer (``layers/*/attn/wq``), as the reference's leaf holds all
    layers stacked ``[L, ...]`` and scales it as one tensor."""
    groups: Dict[str, List[int]] = {}
    for i, (path, _) in enumerate(tree_items(tree)):
        groups.setdefault("/".join("*" if p.isdigit() else p for p in path.split("/")), []).append(i)
    return list(groups.values())


def _compress_into(grads: Pytree, carries: List[torch.Tensor]):
    """``compress_grads`` one leaf at a time: each (g + carry) to int8 codes
    under its group's absmax scale, the residual written into its carry in
    place.  Returns the (codes, scale) of each leaf, a quarter of the
    gradients' bytes, and the stats; no tree of float32 temporaries is held
    beside the gradients and the carries."""
    g_leaves = tree_leaves(grads)
    codes: List[Tuple[torch.Tensor, torch.Tensor]] = [None] * len(g_leaves)
    err: List[torch.Tensor] = [None] * len(g_leaves)
    for idx in _scale_groups(grads):
        amax = torch.stack([(g_leaves[i] + carries[i]).abs().max() for i in idx]).max()
        for i in idx:
            target = g_leaves[i] + carries[i]
            codes[i] = _quantize(target, amax)
            res = target.sub_(_dequantize(*codes[i]))
            err[i] = torch.sum(torch.square(res))
            carries[i].copy_(res)
    tot = sum(torch.sum(torch.square(g)) for g in g_leaves) + 1e-30
    return codes, {"compress_rel_err": torch.sqrt(sum(err) / tot)}


def compress_grads(grads: Pytree, ef: Pytree) -> Tuple[Pytree, Pytree, Dict[str, torch.Tensor]]:
    """Quantize (g + carry) to int8 and back, one absmax scale a tensor of
    the reference's layout; returns (g̃, new carry, stats)."""
    carry = tree_map(lambda e: e.to(torch.float32, copy=True), ef)
    codes, stats = _compress_into(grads, tree_leaves(carry))
    it = iter(codes)
    return tree_map(lambda _: _dequantize(*next(it)), grads), carry, stats


def compressed_psum(grads: List[Pytree], ef: List[Pytree], mesh, axis) -> Tuple[List[Pytree], List[Pytree]]:
    """The distributed form over ``mesh``'s ``axis``: ``grads[s]`` and
    ``ef[s]`` are shard ``s``'s gradient and carry trees.  Each shard
    quantizes ``g + e`` to int8 codes (one scale a leaf of the reference's
    layout, as ``compress_grads``), the codes times their scales are summed
    over the axis in shard order (``exec.distributed.psum``), and the new
    carry is ``(g + e) - dequantize(codes)``.  Returns (the summed
    gradients, the new carries), per shard."""
    from repro_torch.exec import distributed as D

    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in ef]
    summed: List[List[torch.Tensor]] = [[None] * len(flat_g[0]) for _ in grads]
    carries: List[List[torch.Tensor]] = [[None] * len(flat_g[0]) for _ in grads]
    for idx in _scale_groups(grads[0]):
        payload: List[List[torch.Tensor]] = [[] for _ in grads]
        for s in range(len(grads)):
            targets = [flat_g[s][i] + flat_e[s][i] for i in idx]
            amax = torch.stack([t.abs().max() for t in targets]).max()
            for i, t in zip(idx, targets):
                deq = _dequantize(*_quantize(t, amax))  # the int8 payload times its scale
                payload[s].append(deq)
                carries[s][i] = t - deq
        for k, i in enumerate(idx):
            for s, v in enumerate(D.psum([payload[s][k] for s in range(len(grads))], mesh, axis)):
                summed[s][i] = v
    return [_unflatten(grads[0], v) for v in summed], [_unflatten(grads[0], c) for c in carries]


def _unflatten(like: Pytree, leaves: List[torch.Tensor]) -> Pytree:
    """``leaves`` in the structure of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# AdamW update
# ---------------------------------------------------------------------------


def _norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def global_norm(tree: Pytree) -> torch.Tensor:
    return _norm(tree_leaves(tree))


@torch.no_grad()
def apply_updates(params: Pytree, state: Dict[str, Any], grads: Pytree,
                  cfg: OptConfig) -> Tuple[Pytree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params``, ``state["m"]``, ``state["v"]``
    (and ``state["ef"]``) are updated and returned as the same tensors,
    ``state["step"]`` is the next step; metrics ``grad_norm``, ``lr``,
    ``param_norm`` (and ``compress_rel_err``) are 0-d tensors."""
    metrics: Dict[str, torch.Tensor] = {}
    g_leaves: List[torch.Tensor] = tree_leaves(grads)
    grad_at = g_leaves.__getitem__
    if cfg.compress:
        # the carry is updated in place and the compressed gradient is kept
        # as int8 codes, dequantized a leaf at a time where it is read
        codes, cstats = _compress_into(grads, tree_leaves(state["ef"]))
        grad_at = lambda i: _dequantize(*codes[i])
        metrics.update(cstats)

    gnorm = _norm(grad_at(i) for i in range(len(g_leaves)))
    metrics["grad_norm"] = gnorm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    state["step"] = state["step"] + 1
    lr = schedule(cfg, state["step"])
    metrics["lr"] = lr
    stepf = state["step"].to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)

    p_leaves = tree_leaves(params)
    for i, (p, m, v) in enumerate(zip(p_leaves, tree_leaves(state["m"]), tree_leaves(state["v"]))):
        g = grad_at(i) * scale
        # moment math in float32 (in place when the moments are float32),
        # storage in cfg.moments_dtype
        m32, v32 = m.float(), v.float()
        m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
        upd = (m32 / b1c).div_((v32 / b2c).sqrt_().add_(cfg.eps)).add_(p, alpha=cfg.weight_decay)
        p.sub_(upd.mul_(lr))
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    metrics["param_norm"] = global_norm(p_leaves)
    return params, state, metrics
