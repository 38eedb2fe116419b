"""Dictionary-implementation registry — the paper's §2.3 extension point.

A backend is any module exposing ``build / lookup / update_add / items /
size`` plus ``FAMILY`` and ``SUPPORTS_HINTS``.  The capability flags are the
reference's (``repro.dicts.registry``), so Algorithm 1 and ``plan.fuse``
make the same decisions in both packages.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, Tuple

from . import ht_linear, ht_twochoice, st_blocked, st_sorted

_REGISTRY: Dict[str, ModuleType] = {}


def register(name: str, mod: ModuleType) -> None:
    for attr in ("build", "lookup", "update_add", "items", "size", "FAMILY"):
        if not hasattr(mod, attr):
            raise TypeError(f"backend {name} lacks {attr}")
    _REGISTRY[name] = mod


def get(name: str) -> ModuleType:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dictionary implementation {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def family(name: str) -> str:
    return get(name).FAMILY


def resident(name: str) -> bool:
    """True when the backend ships ``resident_slabs``/``resident_find``,
    making it eligible for the fused-pipeline kernel."""
    mod = get(name)
    return bool(getattr(mod, "RESIDENT", False)) and all(
        hasattr(mod, a) for a in ("resident_slabs", "resident_find")
    )


def partitionable(name: str) -> bool:
    """True when the backend supports slot-range radix partitioning of its
    resident slabs (``partition_assign``/``partition_slabs``), which the
    fused kernel's radix mode runs on."""
    mod = get(name)
    return (
        resident(name)
        and bool(getattr(mod, "PARTITIONABLE", False))
        and all(hasattr(mod, a) for a in ("partition_assign", "partition_slabs"))
    )


def accumulates_resident(name: str) -> bool:
    """True when terminals accumulate in the backend's own layout inside the
    kernel; sort-family terminals accumulate in ``ht_linear`` scratch and
    finalize through their ``build``."""
    mod = get(name)
    return bool(getattr(mod, "RESIDENT_ACCUMULATE", False)) and hasattr(
        mod, "resident_accumulate"
    )


register("ht_linear", ht_linear)
register("ht_twochoice", ht_twochoice)
register("st_sorted", st_sorted)
register("st_blocked", st_blocked)
