"""Mixture-of-Experts FFN with dictionary-selected dispatch (the twin of
``repro.models.moe``'s dense path).

Token → expert routing is a group-by: tokens grouped by expert id into
capacity-bounded buckets.  Two dispatch implementations mirror the
dictionary families:

* ``scatter`` (hash-family analogue): a token's rank within its expert from
  a one-hot running count (``[E, N]`` int32, O(N·E) work, no sort);
* ``sort`` (sort-family analogue): a stable argsort by expert id, the group
  starts by ``searchsorted``, the ranks scattered back (O(N log N),
  independent of E).

``dispatch="auto"`` consults the dispatch model installed for the tensors'
device (``repro_torch.costmodel.moe_profile``), learned per machine; with
none installed it takes the analytic crossover.  Both give equal ranks,
hence equal outputs.

Layout: the router is ``[E, d]`` (``nn.Linear``'s ``[d_out, d_in]``,
applied with ``F.linear``, as every projection of the port); the expert
stacks keep the reference's ``[E, d, f]`` (``wi``, ``wg``) and ``[E, f, d]``
(``wo``), applied as batched ``x @ W`` (``torch.bmm``), so
``models.interop`` copies them unchanged; the shared expert is a
``swiglu`` like the dense ``mlp``.

Divergences from the reference (same results):

* top-k breaks ties toward the lower expert index explicitly (a stable
  descending sort), as ``jax.lax.top_k`` orders them; ``torch.topk``
  promises no order between equal values, and bfloat16 router logits tie;
* ``moe_init`` draws the expert stacks leaf by leaf, each cast to ``dtype``
  before the next draw (maverick's float32 ``[128, 5120, 8192]`` leaf is
  21.5 GB: three at once do not fit beside the rest on one card);
* each part of ``moe_apply`` runs inside a profiler range (``RANGES``), so
  a trace splits the layer's device time;
* the expert-parallel ``moe_apply_sharded`` is the reference's
  ``shard_map`` region run by one controller over the port's mesh
  (``exec.distributed.Mesh``): its inputs placed by
  ``sharding.partition.shard``, the region's body once a shard in mesh
  order, its collectives (the ZeRO gather, the ``psum`` over ``"model"``,
  the ``pmean`` of the aux over the data axes) ``exec.distributed``'s; the
  gather and the psum run in profiler ranges of their own
  (``SHARDED_RANGES``), and ``moe_apply_sharded.regions`` /
  ``.fallbacks`` count the calls that ran the region and those that took
  the dense path.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.exec import distributed as D
from repro_torch.sharding.partition import NamedSharding, PartitionSpec, shard

from . import common
from .common import Params

#: the profiler ranges of ``moe_apply``: router and top-k, positions, the
#: buffer scatter, the expert matmuls, the shared expert, the combine
RANGES = ("moe.router", "moe.positions", "moe.scatter", "moe.experts", "moe.shared", "moe.combine")
#: ``moe_apply_sharded``'s: ``RANGES`` and its collectives, the placement
#: with the ZeRO gather of the expert stacks, and the psum over "model"
SHARDED_RANGES = RANGES + ("moe.gather", "moe.psum")


def _draw(generator, shape, scale: float, device, dtype: torch.dtype) -> torch.Tensor:
    """normal · ``scale`` drawn in float32, cast to ``dtype``."""
    t = torch.randn(shape, generator=generator, device=device, dtype=torch.float32).mul_(scale)
    return t.to(dtype)


def moe_init(generator, d_model: int, d_ff: int, n_experts: int, shared: bool, device,
             dtype: torch.dtype = torch.float32) -> Params:
    """The reference's distributions: the router normal · 0.02, ``wi`` /
    ``wg`` normal · d^-0.5, ``wo`` normal · f^-0.5, an optional shared
    swiglu; each leaf is cast to ``dtype`` before the next is drawn."""
    p = {
        "router": common.dense_init(generator, d_model, n_experts, device, scale=0.02).to(dtype),
        "wi": _draw(generator, (n_experts, d_model, d_ff), d_model**-0.5, device, dtype),
        "wg": _draw(generator, (n_experts, d_model, d_ff), d_model**-0.5, device, dtype),
        "wo": _draw(generator, (n_experts, d_ff, d_model), d_ff**-0.5, device, dtype),
    }
    if shared:
        p["shared"] = common.cast_tree(common.swiglu_init(generator, d_model, d_ff, device), dtype)
    return p


# ---------------------------------------------------------------------------
# dispatch position assignment: the group-by core
# ---------------------------------------------------------------------------


def positions_scatter(expert_id: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Hash-family analogue: each token's rank within its expert (the tokens
    before it with the same id) from a one-hot running count.  ``[N]`` int64
    ids -> ``[N]`` int64 ranks.  The one-hot is laid out ``[E, N]`` (the
    reference's ``[N, E]`` transposed), so that the count runs along the
    contiguous dimension: PyTorch's scan along the outer dimension of a
    narrow ``[N, E]`` took 10.7–21.0 ms at 65,536 tokens on the H100."""
    onehot = torch.zeros((n_experts, expert_id.shape[0]), dtype=torch.int32, device=expert_id.device)
    onehot.scatter_(0, expert_id[None, :], 1)
    counts = torch.cumsum(onehot, dim=1, dtype=torch.int32)  # rank + 1 in one's own row
    return torch.gather(counts, 0, expert_id[None, :])[0].long() - 1


def positions_sort(expert_id: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Sort-family analogue: a stable argsort by expert, rank = index − the
    group's start (segment arithmetic on the sorted stream)."""
    n = expert_id.shape[0]
    order = torch.argsort(expert_id, stable=True)
    sorted_e = expert_id[order]
    start = torch.searchsorted(sorted_e, torch.arange(n_experts, dtype=expert_id.dtype, device=expert_id.device))
    rank_sorted = torch.arange(n, device=expert_id.device) - start[sorted_e]
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def auto_dispatch(n_tokens: int, n_experts: int, device=None) -> str:
    """The dispatch model installed for ``device`` (the card unless another
    is named) where its file exists, else the analytic crossover (sort's
    N·log N against scatter's N·E).  A file that exists but cannot be read
    raises."""
    from repro_torch.costmodel import moe_profile  # it profiles this module's functions

    m = moe_profile.load_dispatch_model(device=device)
    if m is not None:
        return m.choose(n_tokens, n_experts)
    return analytic_dispatch(n_tokens, n_experts)


def analytic_dispatch(n_tokens: int, n_experts: int) -> str:
    """The crossover before installation: sort where E > 4·log2 N."""
    return "sort" if n_experts > 4 * max(1.0, math.log2(n_tokens)) else "scatter"


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def route(p: Params, xt: torch.Tensor, top_k: int):
    """(logits [N, E] in the activation dtype, float32 probabilities, the
    top-k gates [N, k], their experts [N, k]).  Equal probabilities keep the
    lower expert index first, as ``jax.lax.top_k`` orders them."""
    logits = F.linear(xt, p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    return logits, probs, gate_vals[:, :top_k], experts[:, :top_k]


def moe_apply(
    p: Params,
    x: torch.Tensor,  # [B, T, d]
    *,
    n_experts: int,
    top_k: int = 1,
    capacity_factor: float = 1.25,
    dispatch: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (out [B, T, d], aux): each token's top-k experts' swiglu
    outputs weighted by their router probabilities (plus the shared
    expert's), tokens past an expert's capacity dropped; aux holds
    ``load_balance``, ``router_z`` and ``drop_fraction``."""
    B, T, d = x.shape
    N, E = B * T, n_experts
    xt = x.reshape(N, d)
    if dispatch == "auto":
        dispatch = auto_dispatch(N * top_k, E, x.device)
    capacity = max(8, int(capacity_factor * N * top_k / E))
    out, kept, load_balance, router_z = _local_experts(
        p["router"], xt, p["wi"], p["wg"], p["wo"], e0=0, e_loc=E, cap=capacity, n_experts=E, top_k=top_k,
        dispatch=dispatch)
    if "shared" in p:
        with record_function("moe.shared"):
            out = out + common.swiglu(p["shared"], xt)
    aux = {"load_balance": load_balance, "router_z": router_z, "drop_fraction": 1.0 - kept / (N * top_k)}
    return out.view(B, T, d), aux


def _local_experts(router: torch.Tensor, xt: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor, *,
                   e0: int, e_loc: int, cap: int, n_experts: int, top_k: int, dispatch: str):
    """The layer's body over the experts ``e0 .. e0 + e_loc`` (all of them
    in ``moe_apply``, one shard's in the expert-parallel region): the
    tokens ``xt [N, d]`` routed over all ``n_experts``, those of these
    experts within capacity ``cap`` through them.  Returns (the gated
    output ``[N, d]``, the kept (token, expert) count, the load-balance and
    router-z aux terms)."""
    N, d = xt.shape
    pos_fn = positions_sort if dispatch == "sort" else positions_scatter
    with record_function("moe.router"):
        logits, probs, gate_vals, experts = route({"router": router}, xt, top_k)
    with record_function("moe.positions"):
        flat_e = experts.reshape(-1)  # [N*k], token-major
        ranks = pos_fn(flat_e, n_experts)
        keep = ranks < cap
        if e_loc < n_experts:
            keep &= (flat_e >= e0) & (flat_e < e0 + e_loc)
        slot = torch.where(keep, (flat_e - e0) * cap + ranks, e_loc * cap)

    with record_function("moe.scatter"):
        # tokens into [e_loc, C, d] buckets; dropped ones (and, in a shard,
        # other shards' tokens) all land on the off-range row, which is cut
        # (so no gradient reaches them through it)
        src = xt.repeat_interleave(top_k, dim=0) if top_k > 1 else xt
        buf = torch.zeros((e_loc * cap + 1, d), dtype=xt.dtype, device=xt.device).index_copy(0, slot, src)
        buf = buf[:-1].view(e_loc, cap, d)

    with record_function("moe.experts"):
        h = torch.bmm(buf, wg)
        hi = torch.bmm(buf, wi)
        y = torch.bmm(F.silu(h) * hi, wo)

    with record_function("moe.combine"):
        # each token gathers its slot's output × its gate
        yf = y.reshape(e_loc * cap, d)
        out_flat = torch.where(keep[:, None], yf[torch.clamp(slot, max=e_loc * cap - 1)], 0.0)
        contrib = out_flat * gate_vals.reshape(-1, 1).to(xt.dtype)
        out = contrib.view(N, top_k, d).sum(dim=1)

    # aux losses (load balance + router z), used in the training loss
    top1 = experts[:, 0]
    me = torch.zeros((n_experts,), dtype=torch.float32, device=xt.device).index_add_(
        0, top1, torch.ones(top1.shape, dtype=torch.float32, device=xt.device)) / N
    load_balance = n_experts * torch.sum(me * probs.mean(dim=0))
    router_z = torch.logsumexp(logits, dim=-1).square().mean()
    return out, keep.float().sum(), load_balance, router_z


# ---------------------------------------------------------------------------
# expert-parallel MoE: the reference's shard_map region, one controller
# ---------------------------------------------------------------------------
#
# The layout of the reference's region: tokens split over the data axes and
# replicated over "model"; expert stacks split over "model" (EP = TP axis)
# and ZeRO-split over the data axes.  Hence:
#
#   * dispatch = shard-local (each model shard serves its own experts for its
#                replica of the local tokens): no communication;
#   * weights  = one tiled all-gather over the data axes (the ZeRO gather);
#   * combine  = one psum over "model" (each shard contributes its experts'
#                outputs, zeros elsewhere).


def moe_apply_sharded(
    p: Params,
    x: torch.Tensor,  # [B, T, d]
    *,
    mesh: D.Mesh,
    n_experts: int,
    top_k: int = 1,
    capacity_factor: float = 1.25,
    dispatch: str = "auto",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_apply`` as the reference's expert-parallel region over
    ``mesh``.  Falls back to ``moe_apply`` where the reference does: no
    ``"model"`` axis of size > 1, experts that do not divide over it, or a
    batch that does not divide over the data axes (``"pod"``, ``"data"``).

    Capacity is sized and tokens ranked per data shard, as in the
    reference, so with a data axis other tokens drop than in ``moe_apply``
    over the whole batch.  The output (on ``x``'s device) is the first
    model group's data blocks in order; the aux is the reference's (load
    balance from the top-1 experts, router z, ``1 - kept / (N_l · k)``),
    averaged over the data shards."""
    B, T, d = x.shape
    E = n_experts
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_model = mesh.shape.get("model", 1)
    n_dp = mesh.axis_size(dp_axes) if dp_axes else 1
    if n_model == 1 or E % n_model or B % n_dp:
        moe_apply_sharded.fallbacks += 1
        return moe_apply(p, x, n_experts=E, top_k=top_k, capacity_factor=capacity_factor, dispatch=dispatch)
    moe_apply_sharded.regions += 1
    e_loc = E // n_model
    n_local = (B // n_dp) * T
    cap = max(8, int(capacity_factor * n_local * top_k / E))
    if dispatch == "auto":
        dispatch = auto_dispatch(n_local * top_k, E, x.device)

    xt = x.reshape(B * T, d)
    dp = (dp_axes if len(dp_axes) > 1 else dp_axes[0]) if dp_axes else None

    def placed(t, *spec):
        return shard(t, NamedSharding(mesh, PartitionSpec(*spec)))

    with record_function("moe.gather"):
        xs, routers = placed(xt, dp, None), placed(p["router"], None, None)
        wi, wg, wo = placed(p["wi"], "model", dp, None), placed(p["wg"], "model", dp, None), placed(
            p["wo"], "model", None, dp)
        if dp_axes:  # the ZeRO gather: each shard's experts whole again
            wi, wg = D.all_gather(wi, mesh, dp_axes, dim=1), D.all_gather(wg, mesh, dp_axes, dim=1)
            wo = D.all_gather(wo, mesh, dp_axes, dim=2)
    model_pos = {s: i for group in mesh.groups("model") for i, s in enumerate(group)}
    parts = [_local_experts(routers[s], xs[s], wi[s], wg[s], wo[s], e0=model_pos[s] * e_loc, e_loc=e_loc, cap=cap,
                            n_experts=E, top_k=top_k, dispatch=dispatch) for s in range(mesh.size)]
    del wi, wg, wo
    with record_function("moe.psum"):
        outs = D.psum([o for o, _, _, _ in parts], mesh, "model")
        kept = D.psum([k for _, k, _, _ in parts], mesh, "model")
    aux = [torch.stack([lb, rz, 1.0 - kp / (xs[s].shape[0] * top_k)])
           for s, ((_, _, lb, rz), kp) in enumerate(zip(parts, kept))]
    if dp_axes:
        aux = D.pmean(aux, mesh, dp_axes)
    first = mesh.groups(dp_axes)[0] if dp_axes else (0,)
    out = torch.cat([outs[s].to(x.device) for s in first]).view(B, T, d)
    if "shared" in p:
        with record_function("moe.shared"):
            out = out + common.swiglu(p["shared"], xt).view(B, T, d)
    a = aux[0].to(x.device)
    return out, {"load_balance": a[0], "router_z": a[1], "drop_fraction": a[2]}


moe_apply_sharded.regions = 0  # calls that ran the region
moe_apply_sharded.fallbacks = 0  # calls that took moe_apply


def moe_dispatch_auto(p: Params, x: torch.Tensor, cfg, mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The models' entry point: the expert-parallel region under a mesh with
    a ``"model"`` axis, else the dense path; dispatch chosen by
    ``auto_dispatch``."""
    kw = dict(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor)
    if mesh is not None and "model" in mesh.shape:
        return moe_apply_sharded(p, x, mesh=mesh, **kw)
    return moe_apply(p, x, **kw)
