"""Out-of-core compressed columnar storage (the PyTorch twin of
``repro.data.storage``).

A ``ChunkedTable`` keeps a relation in host memory as fixed-size row chunks
whose columns are each compressed with one of four chunk encodings —
dictionary, run-length, bit-packing, frame-of-reference — chosen per column
and chunk by the storage cost model.  The encoders are numpy and are the
reference's, unchanged: the same column gives the same payload bytes in
both packages.  Decode is exact, so streamed execution sees the same rows
as resident execution.

The torch side streams chunks to the table's device.  On the card the
payloads are pinned once, when the table is bound to the device
(``ChunkedTable.to``); ``upload_chunk`` copies one chunk's encoded columns
with ``non_blocking=True`` on a dedicated copy stream and records an event,
and ``chunk_device`` makes the compute stream wait on that event, then
decodes each column with the decode kernel (``kernels.decode``).  Only
encoded bytes cross the link.

Representation invariants (shared with ``kernels.decode``):

* every encoded payload is tile-aligned to ``block`` rows: bit-packed words
  never straddle a tile, RLE run tables are per tile;
* bit widths are powers of two ≤ 16, so a value never straddles a word;
* the padded final chunk repeats its last row and carries a live mask.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import cost as C
from repro_torch.core.cardinality import RelStats
from repro_torch.data.table import Table, collect_stats, table_stats, to_numpy
from repro_torch.kernels import decode as DK
from repro_torch.testing import faults as _faults

#: tile size every encoded payload is aligned to
BLOCK = 1024

#: default rows per chunk (multiple of BLOCK; 64Ki rows ≈ 256 KiB/column)
CHUNK_ROWS = 1 << 16

_POW2_BITS = (1, 2, 4, 8, 16)


def _width_for(span: int) -> Optional[int]:
    """Smallest power-of-two bit width (≤16) representing [0, span]."""
    if span < 0:
        return None
    bits = max(1, int(span).bit_length())
    for w in _POW2_BITS:
        if bits <= w:
            return w
    return None


def _n_tiles(n: int, block: int) -> int:
    return max(1, -(-n // block))


# ---------------------------------------------------------------------------
# bit packing: values < 2**bits into int32 words, vpw = 32 // bits per word
# ---------------------------------------------------------------------------


def pack_bits(vals: np.ndarray, bits: int, block: int = BLOCK) -> np.ndarray:
    """Pack non-negative ints < 2**bits into int32 words, tile-aligned.

    Input is padded to a multiple of ``block`` with zeros; output is one
    int32 word stream of ``n_tiles * block // (32 // bits)`` words — each
    tile owns a fixed, whole-word slice.
    """
    assert bits in _POW2_BITS, bits
    vpw = 32 // bits
    n = len(vals)
    npad = _n_tiles(n, block) * block
    v = np.zeros((npad,), np.uint32)
    v[:n] = vals.astype(np.int64).astype(np.uint32)
    v = v.reshape(-1, vpw)
    shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(bits))
    words = np.bitwise_or.reduce(v << shifts, axis=1)
    return words.astype(np.uint32).view(np.int32)


def unpack_bits(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of ``pack_bits`` — returns int32 values in [0, 2**bits)."""
    vpw = 32 // bits
    w = np.asarray(words).view(np.uint32)
    shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(bits))
    mask = np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
    vals = ((w[:, None] >> shifts) & mask).reshape(-1)
    return vals[:n].astype(np.int32)


# ---------------------------------------------------------------------------
# one encoded column chunk
# ---------------------------------------------------------------------------


@dataclass
class EncodedColumn:
    """One column of one chunk under one encoding.

    kinds / payloads:
      ``plain``    {"data": dtype[n]}
      ``bitpack``  {"words": int32[nt*W]}          meta: bits (ref == 0)
      ``for``      {"words": int32[nt*W]}          meta: bits, ref (frame lo)
      ``dict``     {"words": int32[nt*W], "values": dtype[d]}  meta: bits, d
      ``rle``      {"values": dtype[nt, R], "ends": int32[nt, R]}  meta: runs
    """

    kind: str
    dtype: str  # decoded dtype name: "int32" | "float32"
    n: int
    block: int
    payload: Dict[str, np.ndarray]
    meta: Dict[str, int] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.payload.values()))

    @property
    def decoded_nbytes(self) -> int:
        return 4 * self.n

    def decode(self) -> np.ndarray:
        """Exact reconstruction of the original column values."""
        if self.kind == "plain":
            return self.payload["data"]
        if self.kind in ("bitpack", "for"):
            vals = unpack_bits(self.payload["words"], self.meta["bits"], self.n)
            ref = self.meta.get("ref", 0)
            if ref:
                vals = (vals.astype(np.int64) + ref).astype(np.int32)
            return vals
        if self.kind == "dict":
            codes = unpack_bits(self.payload["words"], self.meta["bits"], self.n)
            return self.payload["values"][codes]
        if self.kind == "rle":
            values, ends = self.payload["values"], self.payload["ends"]
            lengths = np.diff(ends, axis=1, prepend=0)
            out = np.concatenate(
                [np.repeat(values[t], lengths[t]) for t in range(len(values))]
            )
            return out[: self.n]
        raise ValueError(f"unknown encoding {self.kind!r}")


def _rle_tile_tables(
    a: np.ndarray, block: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-tile RLE run tables: (values [nt, R], ends [nt, R], R).

    ``ends`` are cumulative within-tile end offsets (strictly increasing to
    ``block``); rows are padded by repeating the final (value, block) entry,
    i.e. zero-length runs, so decode is padding-oblivious.
    """
    n = len(a)
    nt = _n_tiles(n, block)
    npad = nt * block
    ap = np.concatenate([a, np.repeat(a[-1:], npad - n)]) if npad > n else a
    change = np.nonzero(ap[1:] != ap[:-1])[0] + 1
    starts = np.union1d(
        np.concatenate([[0], change]), np.arange(0, npad, block)
    ).astype(np.int64)
    tile_of = starts // block
    counts = np.bincount(tile_of, minlength=nt)
    R = int(counts.max())
    values = np.empty((nt, R), ap.dtype)
    ends = np.empty((nt, R), np.int32)
    bounds = np.append(starts, npad)
    pos = 0
    for t in range(nt):
        k = counts[t]
        sl = slice(pos, pos + k)
        values[t, :k] = ap[starts[sl]]
        ends[t, :k] = bounds[pos + 1 : pos + 1 + k] - t * block
        values[t, k:] = values[t, k - 1]
        ends[t, k:] = block
        pos += k
    return values, ends, R


def encode_column(
    a: np.ndarray,
    block: int = BLOCK,
    model: Optional[C.StorageCostModel] = None,
    mode: str = "auto",
) -> EncodedColumn:
    """Encode one column chunk, choosing the cheapest encoding under the
    storage cost model (``mode="auto"``) or forcing a specific kind."""
    a = np.asarray(a)
    assert a.ndim == 1 and a.dtype in (np.int32, np.float32), (a.dtype, a.shape)
    n = len(a)
    is_float = a.dtype == np.float32
    model = model or C.StorageCostModel()

    candidates: Dict[str, Tuple[int, Dict[str, np.ndarray], Dict[str, int]]] = {}
    candidates["plain"] = (a.nbytes, {"data": a}, {})
    nt = _n_tiles(n, block)

    # run-length: per-tile tables (exact tile-form bytes, padding included)
    if n:
        changes = int(np.count_nonzero(a[1:] != a[:-1])) + 1
        est_rle = (changes + nt) * 8.0  # runs + one boundary split per tile
        if mode == "rle" or (mode == "auto" and est_rle < a.nbytes):
            values, ends, R = _rle_tile_tables(a, block)
            candidates["rle"] = (
                values.nbytes + ends.nbytes,
                {"values": values, "ends": ends},
                {"runs": R},
            )

    def _packed_nbytes(bits: int) -> int:
        return nt * (block // (32 // bits)) * 4

    if not is_float and n:
        lo, hi = int(a.min()), int(a.max())
        w = _width_for(hi) if lo >= 0 else None
        if w is not None:
            candidates["bitpack"] = (
                _packed_nbytes(w),
                {},  # packed lazily below if chosen
                {"bits": w, "ref": 0},
            )
        wf = _width_for(int(hi) - int(lo))
        if wf is not None and lo != 0:
            candidates["for"] = (
                _packed_nbytes(wf) + 4,
                {},
                {"bits": wf, "ref": lo},
            )

    if n:
        values = np.unique(a)
        d = len(values)
        wd = _width_for(d - 1)
        if wd is not None:
            candidates["dict"] = (
                values.nbytes + _packed_nbytes(wd),
                {"values": values},
                {"bits": wd, "d": d},
            )

    if mode != "auto":
        if mode not in candidates:
            raise ValueError(f"encoding {mode!r} inapplicable to this column")
        kind = mode
    else:
        kind, best_s = "plain", model.encoding_seconds("plain", a.nbytes, n)
        for k, (nbytes, _, _) in candidates.items():
            if k == "plain" or nbytes >= a.nbytes:
                continue
            s = model.encoding_seconds(k, nbytes, n)
            if s < best_s:
                kind, best_s = k, s

    nbytes, payload, meta = candidates[kind]
    if kind in ("bitpack", "for"):
        base = a if kind == "bitpack" else (a - np.int32(meta["ref"]))
        payload = {"words": pack_bits(base, meta["bits"], block)}
    elif kind == "dict":
        codes = np.searchsorted(payload["values"], a).astype(np.int32)
        payload = {"values": payload["values"], "words": pack_bits(codes, meta["bits"], block)}
    return EncodedColumn(kind, str(a.dtype), n, block, payload, dict(meta))


# ---------------------------------------------------------------------------
# host ↔ device movement
# ---------------------------------------------------------------------------


class Payloads(dict):
    """``{column: {name: tensor}}`` of one uploaded chunk.  ``event`` marks
    the end of its copy on the copy stream (``None`` off the card)."""

    event = None


_COPY_STREAMS: Dict[torch.device, object] = {}


def copy_stream(device: torch.device):
    """The device's dedicated host→device copy stream."""
    s = _COPY_STREAMS.get(device)
    if s is None:
        s = _COPY_STREAMS[device] = torch.cuda.Stream(device=device)
    return s


def _upload(host: Dict[str, Dict[str, torch.Tensor]], device: torch.device) -> Payloads:
    """Start copying ``host`` (pinned on the card's side) to ``device``."""
    if device.type != "cuda":
        return Payloads({c: {k: v.to(device) for k, v in p.items()} for c, p in host.items()})
    stream = copy_stream(device)
    with torch.cuda.stream(stream):
        out = Payloads({c: {k: v.to(device, non_blocking=True) for k, v in p.items()} for c, p in host.items()})
        out.event = torch.cuda.Event()
        out.event.record(stream)
    return out


def _consume(up: Payloads, device: torch.device) -> None:
    """Make the compute stream wait for ``up``'s copy and keep its tensors
    from being reused by the allocator until the compute stream is done."""
    if up.event is None:
        return
    cur = torch.cuda.current_stream(device)
    cur.wait_event(up.event)
    for p in up.values():
        for t in p.values():
            t.record_stream(cur)


def host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """A host copy of ``t``: pinned and copied without blocking when
    ``pin`` (the caller synchronizes before the host reads it)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    out.copy_(t, non_blocking=pin)
    return out


def _pinned_views(chunks: List[Dict[str, "EncodedColumn"]]) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Every chunk's payload arrays as views into ONE pinned host buffer
    (one allocation instead of one per array).  Every payload dtype is 4
    bytes wide, so each view starts 4-byte aligned."""
    total = sum(a.nbytes for ch in chunks for e in ch.values() for a in e.payload.values())
    buf = torch.empty((max(total, 4),), dtype=torch.uint8, pin_memory=True)
    out, off = [], 0
    for ch in chunks:
        views = {}
        for c, e in ch.items():
            views[c] = {}
            for k, a in e.payload.items():
                src = torch.from_numpy(np.ascontiguousarray(a))
                v = buf[off: off + a.nbytes].view(src.dtype).view(src.shape)
                v.copy_(src)
                views[c][k] = v
                off += a.nbytes
        out.append(views)
    return out


# ---------------------------------------------------------------------------
# chunked host-resident tables
# ---------------------------------------------------------------------------


@dataclass
class ChunkedTable:
    """A relation stored host-side as per-chunk encoded columns, streamed
    to ``device``.

    Presents the ``Table`` metadata surface the planner and executor read
    (``nrows``, ``sorted_on``, ``names``, Σ stats, ``device``) without
    materializing any decoded column; ``chunk(i)`` decodes one chunk on the
    host, ``chunk_device(i)`` on the device, ``decode()`` the whole relation
    (tests and the index-terminal fallback).
    """

    chunks: List[Dict[str, EncodedColumn]]
    chunk_rows: int
    nrows: int
    schema: Dict[str, str]  # column -> decoded dtype name
    sorted_on: Tuple[str, ...] = ()
    stats: Optional[RelStats] = None
    mask: None = None  # interface parity with Table (always all-live)
    device: torch.device = torch.device("cpu")
    _host: Optional[list] = field(default=None, repr=False, compare=False)

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def names(self) -> Tuple[str, ...]:
        return tuple(self.schema)

    @property
    def columns(self) -> Dict[str, str]:
        # schema-shaped stand-in: consumers needing arrays must decode
        return self.schema

    def chunk_nrows(self, i: int) -> int:
        return next(iter(self.chunks[i].values())).n

    def to(self, device) -> "ChunkedTable":
        """The same chunks bound to stream to ``device``; on the card every
        payload is pinned here, once."""
        device = torch.device(device)
        host = _pinned_views(self.chunks) if device.type == "cuda" else None
        return dataclasses.replace(self, device=device, _host=host)

    def _host_payload(self, i: int, names) -> Dict[str, Dict[str, torch.Tensor]]:
        if self._host is not None:
            return {c: self._host[i][c] for c in names}
        enc = self.chunks[i]
        return {c: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in enc[c].payload.items()} for c in names}

    def chunk(self, i: int, cols: Optional[Sequence[str]] = None, pad: bool = False) -> Table:
        """Decode chunk ``i`` (only ``cols`` if given) on the host into a
        ``Table`` on the table's device.  ``pad=True`` pads the final short
        chunk to ``chunk_rows`` with the last row repeated and a live mask
        marking the tail dead."""
        enc = self.chunks[i]
        names = tuple(cols) if cols is not None else tuple(enc)
        out: Dict[str, np.ndarray] = {c: enc[c].decode() for c in names}
        n = self.chunk_nrows(i)
        mask = None
        if pad and n < self.chunk_rows:
            tail = self.chunk_rows - n
            out = {c: np.concatenate([a, np.repeat(a[-1:], tail)]) for c, a in out.items()}
            mask = np.zeros((self.chunk_rows,), bool)
            mask[:n] = True
            n = self.chunk_rows
        return Table(
            {c: torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for c, a in out.items()},
            n,
            mask=None if mask is None else torch.from_numpy(mask).to(self.device),
            sorted_on=self.sorted_on,
        )

    def decode(self, cols: Optional[Sequence[str]] = None) -> Table:
        names = tuple(cols) if cols is not None else tuple(self.schema)
        parts = {
            c: np.concatenate([ch[c].decode() for ch in self.chunks])
            for c in names
        }
        return Table(
            {c: torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for c, a in parts.items()},
            self.nrows,
            sorted_on=self.sorted_on,
        )

    @property
    def encoded_nbytes(self) -> int:
        return sum(e.nbytes for ch in self.chunks for e in ch.values())

    @property
    def decoded_nbytes(self) -> int:
        return 4 * self.nrows * len(self.schema)

    def encodings(self) -> Dict[str, Tuple[str, ...]]:
        """Per-column tuple of chunk encodings (diagnostics / signatures)."""
        return {
            c: tuple(ch[c].kind for ch in self.chunks) for c in self.schema
        }

    def signature(self) -> tuple:
        return (
            self.nrows,
            self.chunk_rows,
            self.sorted_on,
            tuple(sorted(self.schema.items())),
            str(self.device),
        )

    # -- device streaming -------------------------------------------------

    def upload_chunk(self, i: int, cols: Optional[Sequence[str]] = None):
        """Start the host→device transfer of chunk ``i``'s **encoded**
        payloads (asynchronous on the card: calling this for chunk ``i+1``
        before computing on chunk ``i`` overlaps the transfer with the
        compute).  Returns ``(payloads, h2d_bytes)``."""
        _faults.check("h2d", detail=f"chunk {i}")
        enc = self.chunks[i]
        names = tuple(cols) if cols is not None else tuple(enc)
        nbytes = sum(enc[c].nbytes for c in names)
        return _upload(self._host_payload(i, names), self.device), nbytes

    def chunk_device(
        self,
        i: int,
        cols: Optional[Sequence[str]] = None,
        pad: bool = False,
        uploaded=None,
    ) -> Table:
        """Chunk ``i`` as a device ``Table``, decoded ON the device from the
        uploaded encoded payload (``kernels.decode.decode_device`` — bitwise
        equal to host ``decode()``).  ``pad=True`` gives every chunk the
        same shape (``chunk_rows``) and an explicit live mask (all-true
        when full)."""
        _faults.check("chunk-decode", detail=f"chunk {i}")
        enc = self.chunks[i]
        names = tuple(cols) if cols is not None else tuple(enc)
        if uploaded is None:
            uploaded, _ = self.upload_chunk(i, names)
        _consume(uploaded, self.device)
        n = self.chunk_nrows(i)
        rows = self.chunk_rows if pad else n
        out = {c: DK.decode_device(enc[c], uploaded[c], rows) for c in names}
        mask = None
        if pad:
            mask = torch.arange(self.chunk_rows, device=self.device) < n
            n = self.chunk_rows
        return Table(out, n, mask=mask, sorted_on=self.sorted_on)


@dataclass
class HostChunkedTable:
    """A *decoded* host-resident chunked relation — the spill target for
    streamed Project-terminal regions.  Chunks are host tensors (pinned on
    the card's side) padded to ``chunk_rows`` with an explicit per-chunk
    live mask; downstream pipelines stream it like a ``ChunkedTable`` (same
    metadata surface and ``upload_chunk``/``chunk_device`` protocol)."""

    chunks: List[Dict[str, torch.Tensor]]
    masks: List[torch.Tensor]  # [chunk_rows] bool, live rows per chunk
    chunk_rows: int
    nrows: int  # logical (source) row count
    schema: Dict[str, str]
    sorted_on: Tuple[str, ...] = ()
    stats: Optional[RelStats] = None
    mask: None = None  # interface parity with Table
    device: torch.device = torch.device("cpu")

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def names(self) -> Tuple[str, ...]:
        return tuple(self.schema)

    @property
    def columns(self) -> Dict[str, str]:
        return self.schema

    def chunk_nrows(self, i: int) -> int:
        return int(self.masks[i].sum())

    @property
    def encoded_nbytes(self) -> int:  # stored decoded: raw bytes
        return sum(
            a.numel() * a.element_size() for ch in self.chunks for a in ch.values()
        ) + sum(m.numel() for m in self.masks)

    @property
    def decoded_nbytes(self) -> int:
        return 4 * self.n_chunks * self.chunk_rows * len(self.schema)

    def upload_chunk(self, i: int, cols: Optional[Sequence[str]] = None):
        _faults.check("h2d", detail=f"spill chunk {i}")
        ch = self.chunks[i]
        names = tuple(cols) if cols is not None else tuple(ch)
        nbytes = sum(ch[c].numel() * ch[c].element_size() for c in names) + self.masks[i].numel()
        host = {c: {"data": ch[c]} for c in names}
        host["__mask__"] = {"data": self.masks[i]}
        return _upload(host, self.device), nbytes

    def chunk_device(
        self,
        i: int,
        cols: Optional[Sequence[str]] = None,
        pad: bool = True,
        uploaded=None,
    ) -> Table:
        """Spill chunks are stored decoded and padded: the uploaded arrays
        are the chunk, and the live mask comes with them."""
        _faults.check("chunk-decode", detail=f"spill chunk {i}")
        ch = self.chunks[i]
        names = tuple(cols) if cols is not None else tuple(ch)
        if uploaded is None:
            uploaded, _ = self.upload_chunk(i, names)
        _consume(uploaded, self.device)
        return Table(
            {c: uploaded[c]["data"] for c in names},
            self.chunk_rows,
            mask=uploaded["__mask__"]["data"],
            sorted_on=self.sorted_on,
        )

    def decode(self, cols: Optional[Sequence[str]] = None) -> Table:
        # structural pad rows only ever occupy the final chunk's tail (every
        # chunk but the last is full), so trimming to ``nrows`` reproduces
        # the resident table's exact shape
        names = tuple(cols) if cols is not None else tuple(self.schema)
        parts = {
            c: torch.cat([ch[c] for ch in self.chunks])[: self.nrows].to(self.device)
            for c in names
        }
        mask = torch.cat(self.masks)[: self.nrows].to(self.device)
        return Table(parts, self.nrows, mask=mask, sorted_on=self.sorted_on)


def is_chunked(x) -> bool:
    """True for host-resident chunked relations (either encoded fact
    storage or decoded spill intermediates) that must be streamed."""
    return isinstance(x, (ChunkedTable, HostChunkedTable))


def chunk_table(
    t: Table,
    chunk_rows: int = CHUNK_ROWS,
    block: int = BLOCK,
    model: Optional[C.StorageCostModel] = None,
    stats: Optional[RelStats] = None,
) -> ChunkedTable:
    """Encode a fully-materialized ``Table`` into a host-resident
    ``ChunkedTable`` (bound to the CPU; ``.to(device)`` streams it
    elsewhere) — per-chunk, per-column encoding choice, exact Σ stats
    captured once from the decoded data (or taken from ``stats``).  The
    chunks are encoded by a pool of threads (numpy releases the GIL in the
    encoders' array passes), each chunk by one thread, in chunk order."""
    assert t.mask is None, "cannot chunk a masked table"
    assert chunk_rows % block == 0, (chunk_rows, block)
    cols = {c: to_numpy(a) for c, a in t.columns.items()}
    stats = stats if stats is not None else table_stats(t)

    def encode_chunk(start: int) -> Dict[str, EncodedColumn]:
        stop = min(start + chunk_rows, t.nrows)
        return {c: encode_column(a[start:stop], block, model) for c, a in cols.items()}

    starts = range(0, max(t.nrows, 1), chunk_rows)
    with ThreadPoolExecutor(min(len(starts), os.cpu_count() or 1, 8)) as pool:
        chunks: List[Dict[str, EncodedColumn]] = list(pool.map(encode_chunk, starts))
    schema = {c: str(a.dtype) for c, a in cols.items()}
    return ChunkedTable(
        chunks, chunk_rows, t.nrows, schema, tuple(t.sorted_on), stats
    )


def chunk_db(
    db: Dict[str, Table],
    memory_budget_bytes: Optional[int] = None,
    chunk_rows: int = CHUNK_ROWS,
    block: int = BLOCK,
    model: Optional[C.StorageCostModel] = None,
    sigma=None,
) -> Dict[str, object]:
    """Apply the storage plan to a database dict: relations the budget
    cannot keep decoded-resident become ``ChunkedTable``s (largest first),
    the rest stay as-is.  With no budget every relation stays resident —
    the out-of-core layer is strictly opt-in.  ``sigma`` (Σ of ``db``)
    saves recollecting the statistics."""
    if memory_budget_bytes is None:
        return dict(db)
    sigma = sigma if sigma is not None else collect_stats(db)
    decisions = C.storage_plan(
        sigma, memory_budget_bytes, model, block=block, chunk_rows=chunk_rows
    )
    out: Dict[str, object] = {}
    for rel, t in db.items():
        if decisions[rel].mode == "streamed":
            out[rel] = chunk_table(t, chunk_rows, block, model, stats=sigma.rels.get(rel))
        else:
            out[rel] = t
    return out
