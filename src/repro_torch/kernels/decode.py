"""Device-side decode of compressed column chunks, as a hand-written Hopper
kernel (``csrc/decode.cu``).

Replaces ``repro/kernels/decode.py:pallas_decode`` (and its jitted twin
``decode_device``).  The host keeps out-of-core relations as per-chunk
encoded columns (``repro_torch.data.storage``); only the encoded payload
crosses the host→device link, and this kernel rebuilds the column on the
card, four rows a thread with one 16-byte store: shift and mask for
bit-packed and frame-of-reference words (one word a step, 32-bit shifts),
a gather for dictionary codes, and for RLE an upper bound over the tile's
run ends staged in shared memory.  Every step is exact, so the result is
bitwise equal to the host's ``EncodedColumn.decode()``.

:func:`decode_plain` is the same function in PyTorch (shifts and masks, a
gather, ``searchsorted`` for RLE); :func:`decode` launches the kernel on CUDA
tensors and takes the plain version only for CPU tensors;
:func:`decode_device` is the storage layer's dispatch (the payload itself for
``plain`` columns).  Rows ``n .. out_rows-1`` repeat row ``n - 1``, the
padded final chunk of a stream.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from . import build

KINDS = {"bitpack": 0, "for": 1, "dict": 2, "rle": 3}
DTYPES = {"int32": torch.int32, "float32": torch.float32}


class ColumnCode(NamedTuple):
    """The static decode recipe of one encoded column chunk: its encoding,
    decoded dtype name, row count and the encoding's parameters."""

    kind: str  # "bitpack" | "for" | "dict" | "rle"
    dtype: str  # "int32" | "float32"
    n: int
    bits: int = 0
    ref: int = 0
    block: int = 1024


def column_code(enc) -> ColumnCode:
    """The recipe of a ``storage.EncodedColumn``."""
    return ColumnCode(enc.kind, enc.dtype, enc.n, enc.meta.get("bits", 0), enc.meta.get("ref", 0), enc.block)


def decode_plain(code: ColumnCode, payload: Dict[str, torch.Tensor], out_rows: int) -> torch.Tensor:
    """``[out_rows]`` decoded rows of one encoded column (any device)."""
    dev = next(iter(payload.values())).device
    dtype = DTYPES[code.dtype]
    if out_rows <= 0:
        return torch.empty((0,), dtype=dtype, device=dev)
    src = torch.clamp(torch.arange(out_rows, dtype=torch.int64, device=dev), max=code.n - 1)
    if code.kind == "rle":
        values, ends = payload["values"], payload["ends"]
        nt = values.shape[0]
        off = torch.arange(code.block, dtype=torch.int32, device=dev).expand(nt, code.block).contiguous()
        run = torch.searchsorted(ends.contiguous(), off, right=True)
        return torch.gather(values, 1, run).reshape(-1)[src]
    vpw = 32 // code.bits
    words = payload["words"].to(torch.int64) & 0xFFFFFFFF  # the uint32 bit pattern
    shift = (src % vpw) * code.bits
    v = (words[src // vpw] >> shift) & ((1 << code.bits) - 1)
    if code.kind == "dict":
        return payload["values"][v]
    return (v + code.ref).to(torch.int32)  # in range by construction


class EncodedStream(NamedTuple):
    """One encoded column's device payload, read by the fused pipeline's
    kernel row by row (``fused_pipeline(..., encoded=...)``): ``words`` is
    the tile-aligned packed stream (bitpack / FOR / dict), ``values`` the
    dictionary slab ``[d]`` or the RLE run values ``[nt, R]``, ``ends`` the
    RLE cumulative within-tile run ends ``[nt, R]``.  ``n`` (an addition to
    the reference's fields) is the encoded row count: a row past it reads
    row ``n - 1``, as the decode kernel pads a short final chunk."""

    kind: str  # "bitpack" | "for" | "dict" | "rle"
    dtype: str  # decoded dtype name
    words: Optional[torch.Tensor] = None
    values: Optional[torch.Tensor] = None
    ends: Optional[torch.Tensor] = None
    bits: int = 0
    ref: int = 0
    block: int = 1024
    n: int = 0


def words_per_tile(bits: int, block: int) -> int:
    return block // (32 // bits)


def encoded_stream(enc, payload: Optional[Dict[str, torch.Tensor]] = None) -> EncodedStream:
    """The kernel-facing :class:`EncodedStream` of one ``storage.EncodedColumn``
    (``payload``: its uploaded tensors; by default the host payload)."""
    p = payload if payload is not None else {k: torch.from_numpy(v) for k, v in enc.payload.items()}
    if enc.kind == "rle":
        return EncodedStream("rle", enc.dtype, values=p["values"], ends=p["ends"], block=enc.block, n=enc.n)
    if enc.kind not in ("bitpack", "for", "dict"):
        raise ValueError(f"no encoded stream for a {enc.kind!r} column")
    return EncodedStream(
        enc.kind, enc.dtype, words=p["words"], values=p.get("values"),
        bits=enc.meta["bits"], ref=enc.meta.get("ref", 0), block=enc.block, n=enc.n,
    )


def stream_code(es: EncodedStream) -> ColumnCode:
    """The decode recipe of an encoded stream."""
    return ColumnCode(es.kind, es.dtype, es.n, es.bits, es.ref, es.block)


def stream_payload(es: EncodedStream) -> Dict[str, torch.Tensor]:
    """An encoded stream's tensors under their payload names."""
    return {k: getattr(es, k) for k in ("words", "values", "ends") if getattr(es, k) is not None}


#: rows a launch writes: the kernel's indices are 32-bit
MAX_ROWS = 2**31
#: runs a tile the RLE kernel stages (ends and values, 8 bytes a run, in 48 KB)
MAX_RUNS = 6144

_LIB = {}


def _launcher():
    if "fn" not in _LIB:
        src = (build.CSRC / "decode.cu").read_text()
        _LIB["fn"] = build.launcher(build.load("decode", src), "decode_launch")
    return _LIB["fn"]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"decode: {msg}")


def launch_args(code: ColumnCode, payload: Dict[str, torch.Tensor], out_rows: int):
    """``(a, b, ints)``: the kernel's two input tensors and integer
    arguments for one chunk, once the checks that it takes them pass (any
    device; the wrapper calls it for CUDA payloads)."""
    tensors = list(payload.values())
    dev = tensors[0].device
    _check(code.kind in KINDS, f"no kernel for encoding {code.kind!r}")
    _check(code.dtype in DTYPES, f"decoded dtype must be int32 or float32, got {code.dtype}")
    _check(all(t.device == dev and t.is_contiguous() for t in tensors), "payload must be contiguous on one device")
    _check(code.n >= 1 and out_rows >= code.n, f"need 1 <= n <= out_rows, got n={code.n}, out_rows={out_rows}")
    _check(out_rows < MAX_ROWS, f"the kernel indexes rows in 32 bits, got out_rows={out_rows} >= 2^31")
    _check(code.block >= 32 and code.block & (code.block - 1) == 0,
           f"tiles must be a power of two of at least 32 rows, got block={code.block}")
    nt = -(-code.n // code.block)
    runs = 0
    if code.kind == "rle":
        a, b = payload["values"], payload["ends"]
        runs = a.shape[1] if a.dim() == 2 else 0
        _check(a.dtype == DTYPES[code.dtype] and b.dtype == torch.int32
               and a.shape == b.shape == (nt, runs) and runs >= 1,
               f"RLE tables must be [{nt}, R>=1]: values {code.dtype}, ends int32")
        _check(runs <= MAX_RUNS, f"a tile's {runs} runs do not fit the kernel's stage ({MAX_RUNS})")
    else:
        _check(code.bits in (1, 2, 4, 8, 16), f"bit width must be 1/2/4/8/16, got {code.bits}")
        a = payload["words"]
        _check(a.dtype == torch.int32 and a.shape == (nt * code.block // (32 // code.bits),),
               "packed words must be int32, whole tiles")
        if code.kind == "dict":
            b = payload["values"]
            _check(b.dtype == DTYPES[code.dtype] and b.dim() == 1 and b.shape[0] >= 1,
                   f"dictionary values must be [d>=1] {code.dtype}")
        else:
            _check(code.dtype == "int32", "bitpack and FOR decode to int32")
            b = a
    ints = [KINDS[code.kind], code.n, out_rows, code.bits, code.ref, code.block.bit_length() - 1, runs]
    return a, b, ints


def decode(code: ColumnCode, payload: Dict[str, torch.Tensor], out_rows: int) -> torch.Tensor:
    """``[out_rows]`` decoded rows of one encoded column chunk.  CPU payloads
    take :func:`decode_plain`; CUDA payloads launch the kernel or raise."""
    first = next(iter(payload.values()))
    if not first.is_cuda:
        return decode_plain(code, payload, out_rows)
    a, b, ints = launch_args(code, payload, out_rows)
    out = torch.empty((out_rows,), dtype=DTYPES[code.dtype], device=first.device)
    build.launch(_launcher(), [a.data_ptr(), b.data_ptr(), out.data_ptr()], ints,
                 torch.cuda.current_stream(first.device).cuda_stream)
    _DECODE.launches += 1
    return out


# the launch count lives on the wrapper itself, also when a caller replaces
# the module attribute with a wrapper of its own
decode.launches = 0
_DECODE = decode


def decode_device(enc, payload: Dict[str, torch.Tensor], out_rows: Optional[int] = None) -> torch.Tensor:
    """Decode one ``storage.EncodedColumn`` from its payload tensors (the
    uploaded encoded bytes) to ``[out_rows]`` rows (default ``enc.n``),
    bitwise equal to ``enc.decode()`` on the live rows: the payload itself
    for a ``plain`` column, else :func:`decode` (the kernel on the card)."""
    out_rows = enc.n if out_rows is None else out_rows
    if enc.kind == "plain":
        a = payload["data"]
        if out_rows == enc.n:
            return a
        tail = a[-1:] if enc.n else torch.zeros((1,), dtype=a.dtype, device=a.device)
        return torch.cat([a, tail.expand(out_rows - enc.n)])
    return decode(column_code(enc), payload, out_rows)
