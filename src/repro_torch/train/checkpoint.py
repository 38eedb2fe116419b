"""Checkpointing: atomic, retained, restorable onto any device (the twin of
``repro.train.checkpoint``).

* a checkpoint is a directory ``step_<n>/`` holding ``shard0.npz`` (every
  leaf keyed by its tree path, ``params/layers/0/attn/wq``) and a
  ``meta.json`` (step, data-stream state, whatever the caller adds);
* writes go to ``step_<n>.tmp<shard>/`` then ``os.replace``: a crashed
  writer never corrupts the latest checkpoint, and only directories with the
  ``COMMIT`` marker count;
* retention keeps the last ``keep`` committed checkpoints;
* ``restore`` reads only the keys its ``like`` tree has (serving restores
  ``params`` from a ``params`` + ``opt`` checkpoint) and puts each leaf on
  the named device, or, with ``shardings=``, places it on a mesh as a
  ``sharding.partition.Sharded`` of its per-shard blocks (the elastic-mesh
  path);
* ``AsyncSaver`` copies the tree to host memory synchronously and writes it
  from a thread, overlapping the write with the next steps.

numpy has no bfloat16: a bfloat16 leaf is stored losslessly as its int16
bits, and ``meta.json``'s ``_dtypes`` names it.  The keys follow the port's
tree (layers a list, projections ``[d_out, d_in]``), so a checkpoint of the
reference does not load here (ROADMAP.md §3).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.data.table import resolve_device
from repro_torch.models.common import tree_items, tree_leaves, tree_map
from repro_torch.sharding import partition

Pytree = Any

COMMIT_MARKER = "COMMIT"
_DTYPES_KEY = "_dtypes"
_STEP_DIR = re.compile(r"^step_(\d{8})$")


def _host(tree: Pytree) -> Pytree:
    """A host copy of every tensor leaf (a copy also of CPU tensors, which
    the next steps update in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True) if torch.is_tensor(t) else t, tree)


def save(directory: str, step: int, tree: Pytree, meta: Optional[Dict[str, Any]] = None,
         keep: int = 3, shard_id: int = 0) -> str:
    """Atomic checkpoint write; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{shard_id}"
    os.makedirs(tmp, exist_ok=True)
    arrays, dtypes = {}, {}
    for key, leaf in tree_items(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            t, dtypes[key] = t.view(torch.int16), "bfloat16"
        arrays[key] = t.numpy()
    np.savez(os.path.join(tmp, f"shard{shard_id}.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, **(meta or {}), _DTYPES_KEY: dtypes}, f)
    with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
        f.write(str(time.time()))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retain(directory, keep)
    return final


class AsyncSaver:
    """Snapshot synchronously (device → host copy), write in the background."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def save(self, directory: str, step: int, tree: Pytree, meta=None, keep=3):
        snapshot = _host(tree)  # host copy now
        self.wait()

        def work():
            try:
                self.last_path = save(directory, step, snapshot, meta, keep)
            except BaseException as e:  # pragma: no cover
                self.error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:  # pragma: no cover
            raise self.error


def _committed(directory: str):
    """The committed checkpoints' steps, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_DIR.match(d)
        if m and os.path.exists(os.path.join(directory, d, COMMIT_MARKER)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _retain(directory: str, keep: int) -> None:
    for step in _committed(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{step:08d}"), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = _committed(directory)
    return steps[-1] if steps else None


def restore(directory: str, like: Pytree, step: Optional[int] = None, device=None,
            shardings: Optional[Pytree] = None) -> Tuple[Pytree, Dict[str, Any]]:
    """Restore into the structure of ``like`` (tensors, ``meta`` ones too):
    each leaf read by its path, its shape checked, put on ``device`` (the
    card unless another is named).  Keys the checkpoint holds and ``like``
    lacks are not read.

    ``shardings`` (one ``NamedSharding`` or a tree of them shaped as
    ``like``, e.g. ``sharding.params.param_shardings``) places each leaf on
    its mesh instead: the leaf comes back as a ``partition.Sharded``, its
    shards' blocks, each on its shard's device, in mesh order, beside its
    sharding (``.unshard()`` gives the saved array back).  It cannot be
    combined with ``device``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {directory}")
    if shardings is not None and device is not None:
        raise ValueError("restore takes device= or shardings=, not both")
    if isinstance(shardings, partition.NamedSharding):
        shardings = tree_map(lambda _: shardings, like)
    dev = resolve_device(device) if shardings is None else None
    shard_list = None if shardings is None else tree_leaves(shardings)
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    dtypes = meta.pop(_DTYPES_KEY, {})
    leaves = []
    with np.load(os.path.join(path, "shard0.npz")) as blob:
        for key, leaf in tree_items(like):
            t = torch.from_numpy(blob[key])
            if dtypes.get(key) == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint {path}: {key} has shape {tuple(t.shape)}, expected {tuple(leaf.shape)}")
            leaves.append(t.to(dev) if shard_list is None else partition.Sharded.place(t, shard_list[len(leaves)]))
    it = iter(leaves)
    return tree_map(lambda _: next(it), like), meta
