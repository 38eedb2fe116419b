"""Parameter / optimizer-state / batch / cache sharding rules for the LM
stack (the twin of ``repro.sharding.params``).

Policy (as the reference's):

* weights: tensor-parallel on "model" along the head / ffn / expert /
  vocab dim **and** ZeRO/FSDP-sharded on ("pod", "data") along the other
  large dim;
* every rule is divisibility-guarded: a dim that does not divide its axis
  size is replicated instead (whisper's 20 heads on a 16-way model axis);
* decode caches: batch on ("pod", "data"); kv-heads on "model" when
  divisible, else head_dim on "model".

The table is path-pattern → logical dims, resolved by
``partition.spec_for``, written for the port's trees:

* the layers are lists (``layers/<i>/attn/wq``, ``periods/<i>/sub1/...``),
  so no leaf carries the reference's stacked ``[L, ...]`` axis and no rule
  prepends an unsharded dim for it;
* projections are ``nn.Linear``'s ``[d_out, d_in]``, so each leaf
  ``models.interop`` transposes has the reference's logical dims swapped
  (``attn/wq``: ``("model", "fsdp")`` against the reference's ``("fsdp",
  "model")``; the router ``[E, d]``: ``(None, "fsdp")``); the expert
  stacks keep ``[E, d, f]`` / ``[E, f, d]`` and their rules;
* shapes come from ``Model.init_shapes()`` (``meta`` tensors): nothing is
  allocated to plan a layout.

The caches keep the reference's layout (``[L, B, H, T, hd]`` K/V, jamba's
``[P, 7, B, ...]`` Mamba states, rwkv's ``[L, B, ...]`` states, whisper's
``enc_out [B, T_enc, d]``), so ``cache_shardings`` is the reference's rule.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

from repro_torch.models.common import tree_items, tree_map

from .partition import NamedSharding, PartitionSpec, spec_for

# (path regex, logical dims of the port's leaf), first match wins
_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / heads
    (r"embed/table$", ("vocab", "fsdp")),  # [V, d]: V × model, d × (pod, data)
    (r"head/w$", ("vocab", "fsdp")),  # [V, d]
    # attention
    (r"attn/wq$", ("model", "fsdp")),
    (r"attn/wk$", ("model", "fsdp")),
    (r"attn/wv$", ("model", "fsdp")),
    (r"attn/wo$", ("fsdp", "model")),
    (r"(self_attn|cross_attn)/w[qkv]$", ("model", "fsdp")),
    (r"(self_attn|cross_attn)/wo$", ("fsdp", "model")),
    # dense mlp
    (r"mlp/w[ig]$", ("model", "fsdp")),
    (r"mlp/wo$", ("fsdp", "model")),
    (r"mlp/wi$", ("model", "fsdp")),
    # moe: expert dim on "expert" (= model), fsdp on the d dim
    (r"moe/router$", (None, "fsdp")),  # [E, d]
    (r"moe/w[ig]$", ("expert", "fsdp", None)),  # [E, d, f]
    (r"moe/wo$", ("expert", None, "fsdp")),  # [E, f, d]
    (r"moe/shared/w[ig]$", ("model", "fsdp")),
    (r"moe/shared/wo$", ("fsdp", "model")),
    # mamba
    (r"mamba/in_proj$", ("model", "fsdp")),
    (r"mamba/out_proj$", ("fsdp", "model")),
    (r"mamba/x_proj$", (None, "model")),  # [R + 2N, d_in]
    (r"mamba/dt_proj$", ("model", None)),  # [d_in, R]
    (r"mamba/conv_w$", (None, "model")),  # [K, d_in], as the reference's
    (r"mamba/(conv_b|dt_bias|D)$", ("model",)),
    (r"mamba/A_log$", ("model", None)),
    # rwkv time / channel mix
    (r"tmix/w[rkvg]$", ("model", "fsdp")),
    (r"tmix/ww$", ("model", "fsdp")),
    (r"tmix/wo$", ("fsdp", "model")),
    (r"cmix/wk$", ("model", "fsdp")),
    (r"cmix/wv$", ("fsdp", "model")),
    (r"cmix/wr$", ("model", "fsdp")),
)

_OPT_PREFIX = re.compile(r"^(m|v|ef)/")


def layout_overrides(cfg, global_batch: int = 0, mesh=None) -> dict:
    """Logical-axis remapping for a config's layout policy.

    The pure-DP layout only applies when the global batch covers the whole
    mesh; serving shapes with small batches keep the TP layout, where the
    model axis carries real work."""
    if getattr(cfg, "layout", "tp") != "dp":
        return {}
    if mesh is not None and global_batch and global_batch % mesh.size != 0:
        return {}
    axes = ("pod", "data", "model")
    return {"batch": axes, "fsdp": axes, "model": None, "expert": None, "vocab": None, "sp": None, "seq": None}


def param_spec(mesh, path_str: str, shape: Sequence[int]) -> PartitionSpec:
    """The spec of the leaf at ``path_str`` (``layers/3/attn/wq``): the first
    matching rule's dims, or all replicated where none matches or its dims
    do not fit the leaf's rank."""
    dims: Optional[Tuple[Optional[str], ...]] = None
    for pat, d in _RULES:
        if re.search(pat, path_str):
            dims = d
            break
    if dims is None or len(dims) != len(shape):
        dims = (None,) * len(shape)
    return spec_for(mesh, dims, shape)


def param_shardings(mesh, params_shapes: Any) -> Any:
    """Same-structure tree of :class:`NamedSharding` for a params (or
    optimizer-moment) tree of tensors (``meta`` ones too)."""
    specs = iter([NamedSharding(mesh, param_spec(mesh, path, leaf.shape)) for path, leaf in tree_items(params_shapes)])
    return tree_map(lambda _: next(specs), params_shapes)


def opt_state_shardings(mesh, opt_shapes: Any) -> Any:
    """AdamW's moments (and the error-feedback carry) mirror the parameter
    layout (the ``m/``, ``v/``, ``ef/`` prefix stripped); scalars
    (``step``) replicate."""

    def one(path, leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, PartitionSpec())
        return NamedSharding(mesh, param_spec(mesh, _OPT_PREFIX.sub("", path), leaf.shape))

    specs = iter([one(path, leaf) for path, leaf in tree_items(opt_shapes)])
    return tree_map(lambda _: next(specs), opt_shapes)


def batch_shardings(mesh, batch_shapes: Any) -> Any:
    """tokens / labels ``[B, T]``: batch over (pod, data); where B does not
    divide (long_500k's B = 1), the sequence dim over data instead."""

    def one(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, PartitionSpec())
        dims = ["batch"] + [None] * (leaf.ndim - 1)
        spec = spec_for(mesh, dims, leaf.shape)
        if spec[0] is None and leaf.ndim >= 2:
            dims = [None, "seq"] + [None] * (leaf.ndim - 2)
            spec = spec_for(mesh, dims, leaf.shape)
        return NamedSharding(mesh, spec)

    return tree_map(one, batch_shapes)


def cache_shardings(mesh, cache_shapes: Any) -> Any:
    """Decode caches: ``[L, B, H, T, hd]`` K/V or ``[L, B, ...]`` states.
    Batch on (pod, data); heads on model if divisible, else head_dim; a
    batch of 1 puts the time axis on data."""

    def one(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, PartitionSpec())
        dims: list = [None] * leaf.ndim
        if leaf.ndim >= 2:
            dims[1] = "batch"
        if leaf.ndim >= 3:
            dims[2] = "model"  # heads / channel groups
        spec = spec_for(mesh, dims, leaf.shape)
        if leaf.ndim >= 5 and spec[2] is None:  # non-divisible head counts (MQA)
            dims[2], dims[4] = None, "model"
            spec = spec_for(mesh, dims, leaf.shape)
        if leaf.ndim >= 4 and spec[1] is None:  # batch 1, long context
            dims[3] = "seq"
            spec = spec_for(mesh, dims, leaf.shape)
        return NamedSharding(mesh, spec)

    return tree_map(one, cache_shapes)
