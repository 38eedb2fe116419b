"""Logical sharding rules, the active mesh and placement on it (the twin of
``repro.sharding.partition``).

Logical axis names used across the model code:

    "batch"    -> ("pod", "data")   (data parallel, hierarchical)
    "seq"      -> "data"            (sequence parallel for long-context decode)
    "model"    -> "model"           (tensor parallel: heads / d_ff / vocab / experts)
    "expert"   -> "model"           (expert parallel shares the TP axis)

``spec_for`` resolves logical dims to a :class:`PartitionSpec` on a mesh,
dropping (replicating) an axis where the dim does not divide its size, so
one rule table serves every architecture on every mesh.

The mesh is ``repro_torch.exec.distributed.Mesh``: one controller drives
every shard, as the reference's ``shard_map`` does, and a shard lives on
``mesh.devices[i]`` (all shards on one card where there is one).  What XLA
does for the reference from a ``NamedSharding`` is explicit here:

* ``shard(x, sharding)`` is ``jax.device_put(x, sharding)``: each shard's
  block of ``x``, on that shard's device, in mesh order (a block is a view
  of ``x`` where ``x`` already lies on the shard's device);
* ``unshard(blocks, sharding)`` reassembles ``x`` from its blocks;
* a :class:`Sharded` holds the blocks with their sharding, as one leaf of
  a tree (what ``checkpoint.restore(shardings=)`` returns);
* ``shard_hint`` (``with_sharding_constraint``) is a value no-op, as the
  reference's is on one device: the port places nothing implicitly, so the
  models do not call it (the expert-parallel MoE region places its inputs
  itself).

``use_mesh(mesh, overrides)`` sets the mesh the models read through
``current_mesh()`` (the MoE layers take the expert-parallel region under a
mesh with a ``"model"`` axis) and the logical-axis overrides ``_resolve``
applies, thread-locally, as the reference does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.exec.distributed import _unravel

_state = threading.local()

Phys = Union[str, Tuple[str, ...]]

LOGICAL_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "batch": ("pod", "data"),
    "batch_nopod": "data",
    "seq": "data",
    "fsdp": ("pod", "data"),  # ZeRO weight sharding axis
    "sp": "model",  # Megatron-style sequence parallelism between blocks
    "model": "model",
    "expert": "model",
    "vocab": "model",
    "none": None,
}


class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (replicated), a mesh axis name, or a
    tuple of axis names (split over their product, the first the major);
    trailing dimensions not named are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a :class:`PartitionSpec` over its axes."""

    def __init__(self, mesh, spec: PartitionSpec):
        named = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
        if set(named) - set(mesh.shape):
            raise ValueError(f"spec {spec} names axes {sorted(set(named) - set(mesh.shape))} that mesh {mesh.axes} lacks")
        if len(set(named)) != len(named):
            raise ValueError(f"spec {spec} maps a mesh axis to more than one dimension")
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.axes}, spec={self.spec})"


def current_mesh():
    return getattr(_state, "mesh", None)


def current_overrides() -> Dict[str, Union[str, Tuple[str, ...], None]]:
    return getattr(_state, "overrides", {})


@contextlib.contextmanager
def use_mesh(mesh, overrides=None):
    """``overrides`` remaps logical axes for the block, e.g. the pure-DP
    layout of ``params.layout_overrides``: {"batch": ("pod", "data",
    "model"), "model": None, ...}."""
    prev, prev_ov = current_mesh(), current_overrides()
    _state.mesh = mesh
    _state.overrides = dict(overrides or {})
    try:
        yield
    finally:
        _state.mesh = prev
        _state.overrides = prev_ov


def _resolve(mesh, logical: Optional[str]) -> Optional[Phys]:
    """The mesh axis (or axes) a logical name maps to under the current
    overrides, keeping only axes the mesh has; ``None`` for none."""
    if logical is None or logical == "none":
        return None
    ov = current_overrides()
    phys = ov[logical] if logical in ov else LOGICAL_RULES.get(logical, logical)
    if phys is None:
        return None
    names = (phys,) if isinstance(phys, str) else tuple(phys)
    present = tuple(n for n in names if n in mesh.shape)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


def _axis_size(mesh, phys: Phys) -> int:
    if isinstance(phys, str):
        return mesh.shape[phys]
    return math.prod(mesh.shape[a] for a in phys)


def spec_for(mesh, dims: Sequence[Optional[str]], shape: Sequence[int]) -> PartitionSpec:
    """Resolve logical dims to a PartitionSpec, dropping non-divisible axes."""
    out = []
    for logical, size in zip(dims, shape):
        phys = _resolve(mesh, logical)
        out.append(phys if phys is not None and size % _axis_size(mesh, phys) == 0 else None)
    return PartitionSpec(*out)


def shard_hint(x: torch.Tensor, *dims: Optional[str]) -> torch.Tensor:
    """The reference's activation constraint: ``x`` itself.  Outside a mesh,
    for a non-tensor or where ``dims`` do not name every dimension it
    returns ``x`` untouched, as the reference does; under a mesh the spec is
    resolved (so that a bad logical name raises) and ``x`` is returned, as
    ``with_sharding_constraint`` leaves a value unchanged."""
    mesh = current_mesh()
    if mesh is None or not hasattr(x, "shape") or len(dims) != x.ndim:
        return x
    spec_for(mesh, dims, x.shape)
    return x


def named_sharding(mesh, *dims: Optional[str], shape=None) -> NamedSharding:
    if shape is None:  # no divisibility check possible; resolve optimistically
        spec = PartitionSpec(*[_resolve(mesh, d) for d in dims])
    else:
        spec = spec_for(mesh, dims, shape)
    return NamedSharding(mesh, spec)


# ---------------------------------------------------------------------------
# placement: jax.device_put(x, NamedSharding) and back
# ---------------------------------------------------------------------------


def block_slices(sharding: NamedSharding, shape: Sequence[int]) -> List[Tuple[slice, ...]]:
    """Each shard's block of an array of ``shape``, as slices, in mesh
    order.  A dim split over a tuple of axes takes the index row-major over
    the tuple (the first axis the major), as JAX does; a dim that does not
    divide its axes' size raises."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)} has dims")
    out = []
    for i in range(mesh.size):
        c = dict(zip((a for a, _ in mesh.axes), _unravel(i, [n for _, n in mesh.axes])))
        sl = []
        for d, size in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            if entry is None:
                sl.append(slice(None))
                continue
            names = (entry,) if isinstance(entry, str) else tuple(entry)
            n = _axis_size(mesh, names)
            if size % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {names} ({n} shards)")
            idx = 0
            for a in names:
                idx = idx * mesh.shape[a] + c[a]
            step = size // n
            sl.append(slice(idx * step, (idx + 1) * step))
        out.append(tuple(sl))
    return out


def shard(x: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """``x``'s block for each shard, on that shard's device, in mesh order."""
    return [x[sl].to(dev) for sl, dev in zip(block_slices(sharding, x.shape), sharding.mesh.devices)]


def unshard(blocks: Sequence[torch.Tensor], sharding: NamedSharding) -> torch.Tensor:
    """The array whose blocks ``blocks`` are, on the first block's device;
    replicated blocks are written over one another (they are equal)."""
    mesh, spec = sharding.mesh, sharding.spec
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size} shards")
    shape = [n * (_axis_size(mesh, spec[d]) if d < len(spec) and spec[d] is not None else 1)
             for d, n in enumerate(blocks[0].shape)]
    dev = blocks[0].device
    out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
    for sl, b in zip(block_slices(sharding, shape), blocks):
        out[sl] = b.to(dev)
    return out


@dataclasses.dataclass(frozen=True)
class Sharded:
    """An array placed on a mesh: its shards' blocks, in mesh order, and the
    sharding that cut them.  One leaf to the tree walkers, where a plain list
    of blocks would read as a list of layers."""

    blocks: List[torch.Tensor]
    sharding: NamedSharding

    @classmethod
    def place(cls, x: torch.Tensor, sharding: NamedSharding) -> "Sharded":
        return cls(shard(x, sharding), sharding)

    def unshard(self) -> torch.Tensor:
        return unshard(self.blocks, self.sharding)
